"""bf16-plane storage mode (PlanConfig(plane_dtype="bfloat16")).

Planes are stored as bfloat16 between transforms (halving the bytes each
pass moves); every transform upcasts to f32, so the compute path is
unchanged. The error budget is dominated by the ~2^-8 relative storage
rounding: the tolerance here is 3e-2 normalized, vs the reference f32
contract's 1e-3 (BASELINE.md).

Mirrors the reference's tolerance-tiering idea (fft/tests.mojo uses looser
tolerances for lower-precision paths).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import tpufft
from tpufft import PlanConfig, SplitComplex

CFG = PlanConfig(plane_dtype="bfloat16")


def _x(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _check(got, expected, tol=3e-2):
    got = np.asarray(got)
    scale = max(1.0, float(np.max(np.abs(expected))))
    err = np.max(np.abs(got - expected)) / scale
    assert err < tol, f"normalized error {err:.3e} >= {tol}"


def test_plane_dtype_validation():
    with pytest.raises(ValueError, match="plane_dtype"):
        PlanConfig(plane_dtype="float16")


@pytest.mark.parametrize("n", [93, 128, 1024])
def test_minor_axis_bf16(n, rng):
    x = _x(rng, (130, n))
    _check(tpufft.fft(x, config=CFG), np.fft.fft(x))


def test_inner_axis_bf16(rng):
    x = _x(rng, (2, 64, 130))
    _check(tpufft.fftn(x, axes=(1,), config=CFG), np.fft.fft(x, axis=1))


def test_nd_inner_axis_bf16(rng):
    x = _x(rng, (1, 25, 9, 48))
    _check(tpufft.fftn(x, axes=(1,), config=CFG), np.fft.fft(x, axis=1))


def test_pair_bf16(rng):
    x = _x(rng, (2, 64, 128))
    _check(tpufft.fftn(x, axes=(1, 2), config=CFG),
           np.fft.fft2(x, axes=(1, 2)))


def test_full_3d_pipeline_bf16(rng):
    x = _x(rng, (2, 16, 32, 128))
    _check(tpufft.fftn(x, axes=(1, 2, 3), config=CFG),
           np.fft.fftn(x, axes=(1, 2, 3)))


def test_split_io_returns_bf16_planes(rng):
    """SplitComplex callers stay bf16 end-to-end (no hidden f32 staging)."""
    x = _x(rng, (8, 128))
    xs = SplitComplex(jnp.asarray(x.real), jnp.asarray(x.imag))
    out = tpufft.fft(xs, config=CFG)
    assert out.re.dtype == jnp.bfloat16
    assert out.im.dtype == jnp.bfloat16
    _check(out.numpy(), np.fft.fft(x))


def test_combined_output_upcasts_to_complex64(rng):
    x = _x(rng, (8, 128))
    out = tpufft.fft(x, config=CFG)
    assert np.asarray(out).dtype == np.complex64


def test_roundtrip_bf16(rng):
    x = _x(rng, (4, 32, 128))
    y = tpufft.ifftn(tpufft.fftn(x, axes=(1, 2), config=CFG),
                     axes=(1, 2), config=CFG)
    _check(y, x)


def test_grad_through_bf16_planes(rng):
    """jax.grad flows through the bf16-storage kernels (custom VJP = the
    conjugate transform, storage dtype included)."""
    import jax

    re = jnp.asarray(rng.standard_normal((4, 128)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((4, 128)), jnp.float32)
    plan = tpufft.plan_fft((4, 128), jnp.complex64, axes=(-1,), config=CFG)

    def loss(re, im):
        out = plan(SplitComplex(re, im))
        return (jnp.sum(out.re.astype(jnp.float32) ** 2)
                + 2.0 * jnp.sum(out.im.astype(jnp.float32) ** 2))

    def loss_ref(re, im):
        z = jnp.fft.fft(re + 1j * im, axis=-1)
        return jnp.sum(z.real ** 2) + 2.0 * jnp.sum(z.imag ** 2)

    g = jax.grad(loss, argnums=(0, 1))(re, im)
    g_ref = jax.grad(loss_ref, argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        scale = max(1.0, float(np.max(np.abs(np.asarray(b)))))
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) / scale < 3e-2


def test_ignored_for_f64(rng):
    """f64 plans run the XLA/CPU path in full precision regardless."""
    x = (rng.standard_normal((4, 64))
         + 1j * rng.standard_normal((4, 64))).astype(np.complex128)
    got = np.asarray(tpufft.fft(x, config=PlanConfig(plane_dtype="bfloat16")))
    scale = max(1.0, float(np.max(np.abs(np.fft.fft(x)))))
    assert np.max(np.abs(got - np.fft.fft(x))) / scale < 1e-6


class TestFastProfile:
    """PlanConfig(profile="fast"): the documented one-switch speed tier
    (bf16 planes + one-pass bf16 matmuls, ~8e-3 worst-case rel error)."""

    def test_profile_fills_defaults_only(self):
        c = PlanConfig(profile="fast")
        assert c.plane_dtype == "bfloat16"
        c = PlanConfig(profile="fast", plane_dtype="float32")
        assert c.plane_dtype == "float32"
        c = PlanConfig()
        assert c.plane_dtype == "float32"
        with pytest.raises(TypeError, match="no longer takes precision"):
            PlanConfig(profile="fast", precision="highest")
        with pytest.raises(ValueError, match="profile"):
            PlanConfig(profile="turbo")

    @pytest.mark.parametrize("n", [128, 256, 1024])
    def test_minor_axis_fast_profile(self, n, rng):
        cfg = PlanConfig(profile="fast")
        x = (rng.standard_normal((16, n))
             + 1j * rng.standard_normal((16, n))).astype(np.complex64)
        got = np.asarray(tpufft.fft(x, config=cfg))
        ref = np.fft.fft(x)
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(got - ref)) / scale < 3e-2

    def test_nd_fast_profile(self, rng):
        cfg = PlanConfig(profile="fast")
        x = (rng.standard_normal((4, 64, 128))
             + 1j * rng.standard_normal((4, 64, 128))).astype(np.complex64)
        got = np.asarray(tpufft.fftn(x, axes=(1, 2), config=cfg))
        ref = np.fft.fftn(x, axes=(1, 2))
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(got - ref)) / scale < 3e-2

    def test_f64_plan_ignores_profile(self, rng):
        cfg = PlanConfig(profile="fast")
        x = (rng.standard_normal((8, 64))
             + 1j * rng.standard_normal((8, 64))).astype(np.complex128)
        got = np.asarray(tpufft.fft(x, config=cfg))
        ref = np.fft.fft(x)
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(got - ref)) / scale < 1e-12
