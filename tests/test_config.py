"""PlanConfig: the knobs that stay, and clear errors for the retired ones."""

import dataclasses

import pytest

import tpufft
from tpufft import PlanConfig
from tpufft.config import REMOVED_KNOBS

_REMOVED_VALUES = {
    "backend": "pallas",
    "lane_block": 128,
    "interpret": True,
    "vmem_budget_bytes": 12 * 1024 * 1024,
    "precision": "bf16x3",
}


def test_removed_table_is_complete():
    assert set(REMOVED_KNOBS) == set(_REMOVED_VALUES)


@pytest.mark.parametrize("knob", sorted(_REMOVED_VALUES))
def test_removed_knob_raises(knob):
    with pytest.raises(TypeError, match=f"no longer takes {knob}"):
        PlanConfig(**{knob: _REMOVED_VALUES[knob]})


@pytest.mark.parametrize("knob", sorted(_REMOVED_VALUES))
def test_removed_knob_raises_through_the_api(knob, rng):
    """The error surfaces where users build configs for a transform."""
    with pytest.raises(TypeError, match="Pallas kernel tier"):
        tpufft.fft(rng.standard_normal(8),
                   config=PlanConfig(**{knob: _REMOVED_VALUES[knob]}))


def test_several_removed_knobs_named_together():
    with pytest.raises(TypeError, match="interpret, lane_block"):
        PlanConfig(interpret=True, lane_block=128)


def test_unknown_keyword_is_a_plain_type_error():
    with pytest.raises(TypeError, match="unexpected keyword") as e:
        PlanConfig(max_radixx=8)
    assert "no longer" not in str(e.value)


@pytest.mark.parametrize("profile,plane", [("accurate", "float32"),
                                           ("fast", "bfloat16")])
def test_profile_resolves_plane_dtype(profile, plane):
    assert PlanConfig(profile=profile).plane_dtype == plane


@pytest.mark.parametrize("profile", ["accurate", "fast"])
def test_explicit_plane_dtype_wins(profile):
    assert PlanConfig(profile=profile,
                      plane_dtype="float32").plane_dtype == "float32"


@pytest.mark.parametrize("kw,match", [
    ({"profile": "turbo"}, "profile"),
    ({"plane_dtype": "float16"}, "plane_dtype"),
    ({"plane_dtype": "bfloat16", "profile": "exact"}, "profile"),
])
def test_bad_values_raise_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        PlanConfig(**kw)


def test_frozen_hashable_and_equal():
    a = PlanConfig(max_radix=8)
    b = PlanConfig(max_radix=8)
    assert a == b and hash(a) == hash(b)
    assert a != PlanConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.max_radix = 4
    assert {f.name for f in dataclasses.fields(PlanConfig)} == {
        "max_radix", "plane_dtype", "profile"}


def test_max_radix_reaches_the_planner():
    plan = tpufft.plan_fft((2, 1024), axes=(-1,),
                           config=PlanConfig(max_radix=4))
    assert max(plan.bases[0]) <= 4
    assert tpufft.plan_fft((2, 1024), axes=(-1,)).bases[0] == (16, 16, 4)
