"""Set-up shared by the entry scripts (bench.py, bench_suite.py, profile.py,
chip_smoke.py): the compile cache, the GPU check, the card's name and
power limit, and timing with ``block_until_ready``.

Import this before anything compiles.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=None) -> str:
    """Where compiled programs are cached: ``$JAX_COMPILATION_CACHE_DIR``
    when it is set, else ``.jax_cache/`` at the checkout root (a fixed
    path, so one checkout's runs find each other's entries)."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or os.path.join(ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache. When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    else is set here."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The JAX devices, or SystemExit when the default backend is no GPU:
    a measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {devices[0].platform!r}; "
            "this script measures the card and has no CPU fallback")
    return devices


def device_record(devices=None) -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    import jax

    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def block(out):
    """block_until_ready on every array leaf of ``out``."""
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        leaf.block_until_ready()
    return out


def time_ms(fn, *args, iters: int = 20, warmup: int = 2) -> dict:
    """Host-clock time of ``fn(*args)`` ending in block_until_ready, after
    ``warmup`` calls (the first compiles). Returns min and median in ms."""
    for _ in range(warmup):
        block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"min_ms": min(times), "median_ms": statistics.median(times)}
