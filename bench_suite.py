"""Benchmark suite over the reference's published shape table.

Covers the roles of the reference's three harnesses:
* fft/bench.mojo         -> --device gpu   (this framework on the GPU)
* cufft-benchmark-main/  -> the jnp.fft column of the GPU table (XLA's FFT
  op, which is cuFFT on the card), timed in the same process, in turns
* benchmark-cpu-others/  -> --device cpu   (NumPy / SciPy-PocketFFT
  baselines; an explicitly labelled CPU table, no device numbers)

``--decisions`` times the dense-DFT GEMM against both transforms and the
two dispatch crossovers (plan_filter dense vs composed, dense prime stage
vs Bluestein) — the numbers the kernel and threshold choices rest on.

Prints markdown tables (ms, min and median of iters, host clock around
block_until_ready). The GPU modes print the card's name and power limit
and fail when no GPU is present. Shapes from the reference README tables
(BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import harness

SHAPES = [
    (1_000_000, 93),
    (500_000, 128),
    (100_000, 1024),
    (100, 16384),
    (100, 640, 480),
    (10, 1920, 1080),
    (1, 3840, 2160),
    (1, 7680, 4320),
    (100, 64, 64, 64),
    (10, 128, 128, 128),
    (1, 256, 256, 256),
    (1, 512, 512, 512),
    (1, 64, 64, 64, 64),
    (1, 25, 160, 160, 48),
]


def _bench_host(fn, x, iters):
    # Two warm calls, not one: a library's first allocations at a new
    # high-water mark can cost far more than steady state; the second warm
    # call runs with the allocator's freed pages recycled.
    fn(x)
    fn(x)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(x)
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def run_cpu(iters: int, with_native: bool, shapes=SHAPES) -> None:
    import scipy.fft as sfft
    from tpufft import native

    # PyFFTW column (reference benchmark-cpu-others/benchmark.py:52-57 plans
    # with FFTW_MEASURE). Emitted only when pyfftw is importable — it is not
    # part of this image's baked-in package set.
    try:
        import pyfftw  # type: ignore
    except ImportError:
        pyfftw = None
        print("(pyfftw not installed; FFTW column omitted)", file=sys.stderr)

    native_ok = with_native and native.available()
    print("CPU baseline (host numbers, not device metrics)")
    hdr = "| shape | NumPy (ms) | SciPy/PocketFFT (ms) |"
    if pyfftw is not None:
        hdr += " PyFFTW (ms) |"
    if native_ok:
        hdr += " tpufft-native (ms) |"
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    rng = np.random.default_rng(0)
    for shape in shapes:
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        axes = tuple(range(1, len(shape)))
        t_np = _bench_host(lambda a: np.fft.fftn(a, axes=axes), x, iters)
        t_sp = _bench_host(lambda a: sfft.fftn(a, axes=axes), x, iters)
        row = f"| {shape} | {t_np:.1f} | {t_sp:.1f} |"
        if pyfftw is not None:
            fftw_fftn = pyfftw.builders.fftn(
                x, axes=axes, planner_effort="FFTW_MEASURE")
            t_fw = _bench_host(lambda a: fftw_fftn(a), x, iters)
            row += f" {t_fw:.1f} |"
        if native_ok:
            # complex in / complex out for every column — the engine's
            # de/re-interleave is fused into its gather/scatter
            # (tpufft_fft_c64 / tpufft_fft_c2p), so the same numpy-facing
            # contract as SciPy costs no extra passes
            def run_nat(a):
                if len(shape) > 2:
                    return native.fftn(a)
                return native.fft(a)
            t_nat = _bench_host(run_nat, x, iters)
            row += f" {t_nat:.1f} |"
        print(row, flush=True)


def _header():
    devices = harness.require_gpu()
    print(f"card: {harness.card_line()}")
    print(f"device: {json.dumps(harness.device_record(devices))}")


def _fmt(t: dict) -> str:
    return f"{t['min_ms']:.3f} / {t['median_ms']:.3f}"


def run_gpu(iters: int, shapes=SHAPES) -> None:
    """tpufft's default path against jnp.fft (cuFFT) per shape, c64."""
    import jax
    import jax.numpy as jnp

    import tpufft

    print("| shape | tpufft min / median (ms) | jnp.fft min / median (ms) |")
    print("|---|---|---|")
    key = jax.random.PRNGKey(0)
    for shape in shapes:
        kr, ki = jax.random.split(jax.random.fold_in(key, len(shape)))
        x = jax.lax.complex(jax.random.normal(kr, shape, jnp.float32),
                            jax.random.normal(ki, shape, jnp.float32))
        axes = tuple(range(1, len(shape)))
        plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes)
        ref = jax.jit(lambda a, axes=axes: jnp.fft.fftn(a, axes=axes))
        t_ours = harness.time_ms(plan, x, iters=iters)
        t_ref = harness.time_ms(ref, x, iters=iters)
        print(f"| {shape} | {_fmt(t_ours)} | {_fmt(t_ref)} |", flush=True)
        del x


def _rel_err(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _dft_gemm_matrix(n: int) -> np.ndarray:
    """(2n, 2n) real matrix M with [re | im] @ M = [Re X | Im X] for the
    forward length-n DFT X = x @ W (W symmetric)."""
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return np.block([[w.real, w.imag], [-w.imag, w.real]])


def run_decisions(iters: int, scale: float = 1.0) -> None:
    """The section-2 measurements of the kernel retirement, in one
    process, in turns: (i) tpufft's default path, (ii) jnp.fft, (iii) the
    dense-DFT algorithm of the retired small-n kernel family as one
    [re|im] GEMM; then the plan_filter and Bluestein crossovers. ``scale``
    shrinks every batch (rehearsal on the CPU)."""
    import jax
    import jax.numpy as jnp

    import tpufft
    from tpufft import execute, signal

    def rows(b):
        return max(2, int(b * scale))

    def cplx(shape, seed):
        kr, ki = jax.random.split(jax.random.PRNGKey(seed))
        return jax.lax.complex(jax.random.normal(kr, shape, jnp.float32),
                               jax.random.normal(ki, shape, jnp.float32))

    def check(got, x, fn, sample=64):
        xs = np.asarray(x[:sample], np.complex128)
        return _rel_err(np.asarray(got[:sample]), fn(xs))

    print("## (i) tpufft default vs (ii) jnp.fft, c64")
    print("| shape | path | min / median (ms) | rel err |")
    print("|---|---|---|---|")
    for b, n in ((500_000, 128), (100_000, 1024)):
        shape = (rows(b), n)
        x = cplx(shape, n)
        plan = tpufft.plan_fft(shape, jnp.complex64, axes=(-1,))
        planes = tpufft.SplitComplex(jnp.real(x), jnp.imag(x))
        ref = jax.jit(jnp.fft.fft)
        for name, fn, arg in (
                ("tpufft, complex array", plan, x),
                ("tpufft, SplitComplex", plan, planes),
                ("jnp.fft (cuFFT)", ref, x),
                ("tpufft, complex array", plan, x),
                ("jnp.fft (cuFFT)", ref, x)):
            t = harness.time_ms(fn, arg, iters=iters)
            out = fn(arg)
            if isinstance(out, tpufft.SplitComplex):
                out = jax.lax.complex(out.re, out.im)
            err = check(out, x, lambda a: np.fft.fft(a, axis=-1))
            print(f"| {shape} | {name} | {_fmt(t)} | {err:.2e} |",
                  flush=True)
        del x, planes

    print("## (iii) dense DFT as one [re|im] GEMM, n = 128")
    print("| shape | precision | min / median (ms) | rel err |")
    print("|---|---|---|---|")
    n = 128
    shape = (rows(500_000), n)
    x = cplx(shape, 7)
    st = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=-1)
    m = jnp.asarray(_dft_gemm_matrix(n), jnp.float32)
    for prec in ("HIGHEST", "DEFAULT", "HIGHEST", "DEFAULT"):
        p = getattr(jax.lax.Precision, prec)
        fn = jax.jit(lambda a, p=p: jnp.dot(a, m, precision=p))
        t = harness.time_ms(fn, st, iters=iters)
        y = np.asarray(fn(st)[:64], np.float64)
        err = _rel_err(y[:, :n] + 1j * y[:, n:],
                       np.fft.fft(np.asarray(x[:64], np.complex128), axis=-1))
        print(f"| {shape} | {prec} | {_fmt(t)} | {err:.2e} |", flush=True)
    del x, st

    print("## plan_filter: dense circulant vs composed fft*H*ifft, c64")
    print("| n | batch | dense min / median (ms) | composed min / median "
          "(ms) |")
    print("|---|---|---|---|")
    saved = signal.FILTER_DENSE_MAX_N
    try:
        for n in (128, 256, 512, 1024):
            b = rows(64 * 1024 * 1024 // n)
            x = cplx((b, n), n + 1)
            planes = tpufft.SplitComplex(jnp.real(x), jnp.imag(x))
            resp = np.exp(2j * np.pi * np.random.default_rng(n).random(n))
            res = {}
            for name, limit in (("dense", n), ("composed", 1),
                                ("dense", n), ("composed", 1)):
                signal.FILTER_DENSE_MAX_N = limit
                fp = tpufft.plan_filter(n, response=resp)
                res[name] = harness.time_ms(fp, planes, iters=iters)
            print(f"| {n} | {b} | {_fmt(res['dense'])} | "
                  f"{_fmt(res['composed'])} |", flush=True)
            del x, planes
    finally:
        signal.FILTER_DENSE_MAX_N = saved

    print("## prime p: dense Stockham stage vs Bluestein, c64, ~13M elements")
    print("| p | batch | dense stage min / median (ms) | Bluestein min / "
          "median (ms) | err dense | err Bluestein |")
    print("|---|---|---|---|---|---|")
    saved = execute.BLUESTEIN_MIN_PRIME
    try:
        for p in (1021, 2053, 4099):
            b = rows(13_000_000 // p)
            x = cplx((b, p), p)
            res, errs = {}, {}
            for name, limit in (("dense", 10 ** 9), ("bluestein", 1),
                                ("dense", 10 ** 9), ("bluestein", 1)):
                execute.BLUESTEIN_MIN_PRIME = limit
                tpufft.api._cached_plan.cache_clear()
                plan = tpufft.plan_fft((b, p), jnp.complex64, axes=(-1,))
                res[name] = harness.time_ms(plan, x, iters=iters)
                errs[name] = check(plan(x), x,
                                   lambda a: np.fft.fft(a, axis=-1))
            print(f"| {p} | {b} | {_fmt(res['dense'])} | "
                  f"{_fmt(res['bluestein'])} | {errs['dense']:.2e} | "
                  f"{errs['bluestein']:.2e} |", flush=True)
            del x
    finally:
        execute.BLUESTEIN_MIN_PRIME = saved
        tpufft.api._cached_plan.cache_clear()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--native", action="store_true",
                    help="include the native C++ engine in the CPU table")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated indices into the shape table "
                         "(e.g. 0,2,11), default all")
    ap.add_argument("--decisions", action="store_true",
                    help="dense-DFT GEMM vs tpufft vs jnp.fft, and the "
                         "plan_filter and Bluestein crossovers (GPU)")
    args = ap.parse_args()
    shapes = SHAPES
    if args.shapes is not None:
        shapes = [SHAPES[int(i)] for i in args.shapes.split(",")]
    if args.device == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        run_cpu(args.iters, args.native, shapes)
        return
    _header()
    harness.enable_compile_cache()
    if args.decisions:
        run_decisions(args.iters)
    else:
        run_gpu(args.iters, shapes)


if __name__ == "__main__":
    main()
