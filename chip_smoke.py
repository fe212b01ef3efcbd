"""Smoke run of tpufft's main path on one GPU, at real sizes, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the distributed phase only

Every phase compares tpufft with a plain NumPy/SciPy float64 reference and
reports the normalized max error, max|got - ref| / max|ref|. Bounds: 1e-4
for c64/f32 paths (HIGHEST-precision f32 gives ~1e-6; a silent TF32 matmul
gives ~1e-3), 1e-9 for c128. Phases:

1. the card's name and power limit;
2. headline C2C (100000, 1024) c64, forward and inverse, every row;
3. the reference's shape table (bench_suite.SHAPES) through plan_fft,
   checked on sampled batch entries, with jnp.fft (cuFFT) timed beside;
4. rfft/irfft (500000, 128), prime radix (1000000, 93), the prime 4099
   (one dense stage: below the measured Bluestein crossover), Bluestein at
   n = 8191 and 65537, c128 at (1000, 4096);
5. jax.grad through fft and rfftn against the adjoint identity;
6. stft, istft, welch against scipy.signal and plan_filter against NumPy;
7. chip-marked tests: there are none (no card-only code remains).

x64 is enabled at start and every array has an explicit dtype, so the
c128 phase runs in the same process. With no GPU the script exits
non-zero before any phase. The last line of a passing run is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

C64_TOL = 1e-4
C128_TOL = 1e-9


@dataclasses.dataclass
class Check:
    phase: str
    name: str
    err: float
    tol: float
    ms: float | None = None        # tpufft, min over a few calls
    ref_ms: float | None = None    # jnp.fft on the same input

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.err) and self.err <= self.tol)

    def line(self) -> str:
        t = "" if self.ms is None else f"  tpufft {self.ms:.3f} ms"
        if self.ref_ms is not None:
            t += f"  jnp.fft {self.ref_ms:.3f} ms"
        flag = "ok" if self.ok else "FAIL"
        return (f"[{self.phase}] {self.name}: err {self.err:.3e} "
                f"(bound {self.tol:.0e}) {flag}{t}")


def rel_err(got, ref) -> float:
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _host(a) -> np.ndarray:
    """Device result -> host complex128/float64 (SplitComplex combined)."""
    import tpufft

    if isinstance(a, tpufft.SplitComplex):
        a = a.numpy()
    a = np.asarray(a)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _normal(shape, seed, dtype):
    import jax

    return jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)


def _complex(shape, seed, dtype="complex64"):
    """Random complex device array of ``dtype`` (parts made on device)."""
    import jax
    import jax.numpy as jnp

    rdt = jnp.float64 if np.dtype(dtype) == np.complex128 else jnp.float32
    return jax.lax.complex(_normal(shape, 2 * seed, rdt),
                           _normal(shape, 2 * seed + 1, rdt))


def _time(fn, *args, iters=3):
    import harness

    return harness.time_ms(fn, *args, iters=iters, warmup=1)["min_ms"]


def _tol(dtype) -> float:
    return C128_TOL if np.dtype(dtype) == np.complex128 else C64_TOL


# ---------------------------------------------------------------- phases


def phase_headline(batch=100_000, n=1024, chunk=10_000, timed=True):
    """(batch, n) c64 fft and ifft, compared on every row."""
    import jax
    import jax.numpy as jnp

    import tpufft

    x = _complex((batch, n), 1)
    out = []
    for inverse in (False, True):
        plan = tpufft.plan_fft((batch, n), jnp.complex64, axes=(-1,),
                               inverse=inverse)
        y = plan(x)
        ref_fn = np.fft.ifft if inverse else np.fft.fft
        num = den = 0.0
        for lo in range(0, batch, chunk):
            ref = ref_fn(_host(x[lo:lo + chunk]), axis=-1)
            num = max(num, float(np.max(np.abs(_host(y[lo:lo + chunk])
                                               - ref))))
            den = max(den, float(np.max(np.abs(ref))))
        err = num / den if np.isfinite(num) else float("inf")
        name = f"{'ifft' if inverse else 'fft'} {(batch, n)} c64"
        chk = Check("2 headline", name, err, C64_TOL)
        if timed:
            jfn = jax.jit(jnp.fft.ifft if inverse else jnp.fft.fft)
            chk.ms, chk.ref_ms = _time(plan, x), _time(jfn, x)
        out.append(chk)
        del y
    return out


def phase_reference_shapes(shapes=None, sample=(0, -1), timed=True):
    """Each shape's transform over all axes but the batch axis, checked
    on the sampled batch entries."""
    import jax
    import jax.numpy as jnp

    import bench_suite
    import tpufft

    out = []
    for i, shape in enumerate(shapes or bench_suite.SHAPES):
        axes = tuple(range(1, len(shape)))
        x = _complex(shape, 10 + i)
        plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes)
        y = plan(x)
        idx = sorted({s % shape[0] for s in sample})
        ref = np.fft.fftn(_host(x[np.asarray(idx)]), axes=axes)
        chk = Check("3 shapes", f"fftn {shape} c64",
                    rel_err(_host(y[np.asarray(idx)]), ref), C64_TOL)
        if timed:
            jfn = jax.jit(lambda a, axes=axes: jnp.fft.fftn(a, axes=axes))
            chk.ms, chk.ref_ms = _time(plan, x), _time(jfn, x)
        out.append(chk)
        del x, y
    return out


def phase_other_transforms(rfft_shape=(500_000, 128),
                           prime_shape=(1_000_000, 93),
                           dense_prime_shape=(3000, 4099),
                           bluestein=((1500, 8191), (200, 65537)),
                           c128_shape=(1000, 4096), rows=256):
    """rfft/irfft, prime radices (a dense stage each), Bluestein lengths
    and c128."""
    import jax.numpy as jnp

    import tpufft
    from tpufft import execute

    out = []
    sl = slice(0, rows)
    xr = _normal(rfft_shape, 30, jnp.float32)
    X = tpufft.rfft(xr)
    out.append(Check("4 other", f"rfft {rfft_shape} f32",
                     rel_err(_host(X[sl]),
                             np.fft.rfft(_host(xr[sl]), axis=-1)), C64_TOL))
    back = tpufft.irfft(X, n=rfft_shape[-1])
    out.append(Check("4 other", f"irfft {rfft_shape} f32",
                     rel_err(_host(back[sl]),
                             np.fft.irfft(_host(X[sl]), n=rfft_shape[-1],
                                          axis=-1)), C64_TOL))
    del xr, X, back

    cases = [(prime_shape, "complex64", "prime radix"),
             (dense_prime_shape, "complex64", "dense prime stage")]
    cases += [(s, "complex64", "Bluestein") for s in bluestein]
    cases.append((c128_shape, "complex128", "c128"))
    for k, (shape, dtype, label) in enumerate(cases):
        if (label == "Bluestein") != execute.bluestein_ok(shape[-1]):
            raise AssertionError(f"n={shape[-1]} is not on the {label} route")
        x = _complex(shape, 40 + k, dtype)
        y = tpufft.fft(x)
        out.append(Check("4 other", f"fft {shape} {dtype} ({label})",
                         rel_err(_host(y[sl]),
                                 np.fft.fft(_host(x[sl]), axis=-1)),
                         _tol(dtype)))
        del x, y
    return out


def phase_gradients(fft_shape=(256, 1024), rfftn_shape=(8, 64, 256)):
    """jax.grad of L = sum(Re(y) c_r + Im(y) c_i) against the adjoint:
    dL/dx = F^H c for fft, Re(F^H pad(c)) for rfftn."""
    import jax
    import jax.numpy as jnp

    import tpufft

    out = []
    xr = _normal(fft_shape, 50, jnp.float32)
    xi = _normal(fft_shape, 51, jnp.float32)
    cr = _normal(fft_shape, 52, jnp.float32)
    ci = _normal(fft_shape, 53, jnp.float32)

    def loss(a, b):
        y = tpufft.fft(jax.lax.complex(a, b))
        return jnp.sum(jnp.real(y) * cr + jnp.imag(y) * ci)

    gr, gi = jax.grad(loss, argnums=(0, 1))(xr, xi)
    c = _host(cr) + 1j * _host(ci)
    want = fft_shape[-1] * np.fft.ifft(c, axis=-1)
    out.append(Check("5 grad", f"grad fft {fft_shape} c64",
                     rel_err(_host(gr) + 1j * _host(gi), want), C64_TOL))

    axes = tuple(range(1, len(rfftn_shape)))
    half = rfftn_shape[:-1] + (rfftn_shape[-1] // 2 + 1,)
    x = _normal(rfftn_shape, 54, jnp.float32)
    dr = _normal(half, 55, jnp.float32)
    di = _normal(half, 56, jnp.float32)

    def loss_r(a):
        y = tpufft.rfftn(a, axes=axes)
        return jnp.sum(jnp.real(y) * dr + jnp.imag(y) * di)

    g = jax.grad(loss_r)(x)
    pad = np.zeros(rfftn_shape, np.complex128)
    pad[..., :half[-1]] = _host(dr) + 1j * _host(di)
    n_tot = int(np.prod([rfftn_shape[a] for a in axes]))
    want = np.real(n_tot * np.fft.ifftn(pad, axes=axes))
    out.append(Check("5 grad", f"grad rfftn {rfftn_shape} f32",
                     rel_err(_host(g), want), C64_TOL))
    return out


def phase_signal(stft_shape=(64, 65536), stft_nperseg=512, stft_hop=128,
                 istft_shape=(8, 513, 4093), istft_nperseg=1024,
                 welch_shape=(64, 65536), welch_nperseg=512,
                 filter_shape=(500_000, 128), rows=256):
    """stft / istft / welch against scipy.signal, plan_filter against
    NumPy's fft * H * ifft."""
    import jax.numpy as jnp
    import scipy.signal as ss

    import tpufft

    out = []
    x = _normal(stft_shape, 60, jnp.float32)
    nov = stft_nperseg - stft_hop
    _, _, Z = tpufft.stft(x, nperseg=stft_nperseg, noverlap=nov)
    _, _, Zref = ss.stft(_host(x), nperseg=stft_nperseg, noverlap=nov)
    out.append(Check("6 signal", f"stft {stft_shape} nperseg "
                     f"{stft_nperseg} hop {stft_hop}",
                     rel_err(_host(Z), Zref), C64_TOL))
    del x, Z

    S = _complex(istft_shape, 61)
    _, xo = tpufft.istft(S, nperseg=istft_nperseg)
    _, xref = ss.istft(_host(S), nperseg=istft_nperseg)
    out.append(Check("6 signal", f"istft {istft_shape} nperseg "
                     f"{istft_nperseg}", rel_err(_host(xo), xref), C64_TOL))
    del S, xo

    x = _normal(welch_shape, 62, jnp.float32)
    _, P = tpufft.welch(x, nperseg=welch_nperseg)
    _, Pref = ss.welch(_host(x), nperseg=welch_nperseg)
    out.append(Check("6 signal", f"welch {welch_shape} nperseg "
                     f"{welch_nperseg}", rel_err(_host(P), Pref), C64_TOL))
    del x, P

    n = filter_shape[-1]
    H = np.exp(2j * np.pi * np.random.default_rng(63).random(n))
    fp = tpufft.plan_filter(n, response=H)
    x = _complex(filter_shape, 64)
    y = fp(x)
    ref = np.fft.ifft(np.fft.fft(_host(x[:rows]), axis=-1) * H, axis=-1)
    out.append(Check("6 signal", f"plan_filter {filter_shape} c64",
                     rel_err(_host(y[:rows]), ref), C64_TOL))
    return out


def phase_multi(n_devices=4, fft_shape=(64, 1 << 22),
                cube_shape=(1, 512, 512, 512), rows=(0, 33)):
    """The distributed transforms on a 1-D mesh ``sp`` over the cards,
    each compared with the same transform on one card and with NumPy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import tpufft
    from tpufft.parallel import (fft_distributed, fftn_distributed,
                                 filter_distributed)

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise SystemExit(f"--multi needs {n_devices} devices, "
                         f"found {len(jax.devices())}")
    mesh = Mesh(np.array(devs), ("sp",))
    out = []

    def shard(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    def one_card(a):
        return jax.device_put(a, devs[0])

    def pair(got, single, ref_fn, idx, name):
        idx = np.asarray(idx)
        g = _host(got)[idx] if got.ndim > 1 else _host(got)
        out.append(Check("multi", f"{name} vs one card",
                         rel_err(_host(got), _host(single)), C64_TOL))
        out.append(Check("multi", f"{name} vs NumPy",
                         rel_err(g, ref_fn(idx)), C64_TOL))

    spec = P(None, "sp")
    x = _complex(fft_shape, 70)
    xs = tpufft.SplitComplex(shard(jnp.real(x), spec),
                             shard(jnp.imag(x), spec))
    y = fft_distributed(xs, mesh, axis_name="sp")
    single = tpufft.fft(one_card(x))
    xh = _host(x)
    pair(jax.lax.complex(y.re, y.im), single,
         lambda i: np.fft.fft(xh[i], axis=-1), rows,
         f"fft_distributed {fft_shape} sp={n_devices}")
    del y, single

    H = np.exp(2j * np.pi * np.random.default_rng(71).random(fft_shape[-1]))
    yf = filter_distributed(xs, mesh, axis_name="sp", response=H)
    single = tpufft.ifft(tpufft.fft(one_card(x)) * jnp.asarray(
        H, jnp.complex64))
    pair(jax.lax.complex(yf.re, yf.im), single,
         lambda i: np.fft.ifft(np.fft.fft(xh[i], axis=-1) * H, axis=-1),
         rows, f"filter_distributed {fft_shape} sp={n_devices}")
    del x, xs, yf, single, xh

    axes = tuple(range(1, len(cube_shape)))
    c = _complex(cube_shape, 72)
    cspec = P(*([None] * (len(cube_shape) - 1) + ["sp"]))
    cs = tpufft.SplitComplex(shard(jnp.real(c), cspec),
                             shard(jnp.imag(c), cspec))
    yc = fftn_distributed(cs, mesh, axis_name="sp", axes=axes)
    single = tpufft.fftn(one_card(c), axes=axes)
    ch = _host(c)
    pair(jax.lax.complex(yc.re, yc.im), single,
         lambda i: np.fft.fftn(ch[i], axes=axes), [0],
         f"fftn_distributed {cube_shape} sp={n_devices}")
    return out


# ------------------------------------------------------------------ main


def _run(phases) -> list[Check]:
    checks, failed = [], []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            got = fn()
        except Exception as e:  # a phase that raises is a failed phase
            failed.append(name)
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        for chk in got:
            print(chk.line(), flush=True)
        checks.extend(got)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    bad = [c for c in checks if not c.ok]
    if failed or bad:
        raise SystemExit(f"chip_smoke FAILED: phases {failed}, checks "
                         f"{[f'{c.phase}: {c.name}' for c in bad]}")
    return checks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card distributed phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import harness

    devices = harness.require_gpu()
    harness.enable_compile_cache()
    print(f"card: {harness.card_line()}", flush=True)

    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [
            ("2 headline", phase_headline),
            ("3 shapes", phase_reference_shapes),
            ("4 other", phase_other_transforms),
            ("5 grad", phase_gradients),
            ("6 signal", phase_signal),
        ]
        print("[7 chip tests] no chip-marked tests: no card-only code "
              "remains", flush=True)
    _run(phases)
    stats = devices[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"peak_bytes_in_use (device 0): {stats['peak_bytes_in_use']}")
    print(json.dumps({"ok": True, "device": harness.device_record(devices)}))


if __name__ == "__main__":
    main()
