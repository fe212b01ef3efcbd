"""The entry scripts' shared set-up (harness.py): the compile-cache rule,
the GPU check and the timing helper."""

import os

import pytest

import jax
import jax.numpy as jnp

import harness

ENTRY_SCRIPTS = ["bench.py", "bench_suite.py", "profile.py",
                 "chip_smoke.py"]


@pytest.mark.parametrize("value", ["/some/cache", "relative/cache"])
def test_cache_dir_follows_environment(value):
    assert harness.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": value}) \
        == value


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}],
                         ids=["unset", "empty"])
def test_cache_dir_defaults_to_checkout(env):
    path = harness.compile_cache_dir(env)
    assert path == os.path.join(harness.ROOT, ".jax_cache")
    assert os.path.dirname(path) == os.path.dirname(
        os.path.abspath(harness.__file__))


def test_default_cache_dir_is_ignored_by_git():
    with open(os.path.join(harness.ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored
    assert "chiprun_out/" in ignored


def _recorded_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_enable_sets_checkout_cache_when_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _recorded_updates(monkeypatch)
    path = harness.enable_compile_cache()
    assert path == os.path.join(harness.ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_enable_sets_nothing_when_environment_names_a_dir(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    calls = _recorded_updates(monkeypatch)
    assert harness.enable_compile_cache() == "/elsewhere"
    assert calls == []


@pytest.mark.parametrize("script", ENTRY_SCRIPTS)
def test_entry_scripts_use_the_shared_cache_rule(script):
    """Every entry script goes through harness.enable_compile_cache and
    sets no cache path of its own."""
    with open(os.path.join(harness.ROOT, script)) as f:
        src = f.read()
    assert "harness.enable_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
    assert "harness.require_gpu()" in src


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        harness.require_gpu()


def test_device_record_fields():
    rec = harness.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_time_ms_blocks_and_reports():
    f = jax.jit(lambda a: (a * 2.0, {"b": a + 1.0}))
    t = harness.time_ms(f, jnp.ones((8, 8)), iters=3, warmup=1)
    assert set(t) == {"min_ms", "median_ms"}
    assert 0 < t["min_ms"] <= t["median_ms"]
