"""Per-axis dispatch (split-plane contract).

The counterpart of the reference's per-dim scheduling (``_run_gpu_nd_fft``
orchestration, fft/fft/_ndim_fft_gpu.mojo:462-642). Every transformed axis
takes one of two routes, on every backend:

  * the mixed-radix jnp Stockham of ``core.py`` — every length; a prime
    factor p becomes one dense p-point stage, O(p) work per element;
  * Bluestein's chirp-z over the same Stockham at a smooth padded length,
    when the largest prime factor exceeds ``BLUESTEIN_MIN_PRIME`` — two
    smooth transforms instead of one dense stage that grows with p.

Data moves through this layer as split real/imag float planes (see
core.SplitComplex). Both routes are plain jnp, so ``jax.grad`` follows them
by ordinary autodiff.
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from . import core
from .planner import default_bases, factorize, next_fast_len

__all__ = ["fft_axis", "bluestein_ok", "BLUESTEIN_MIN_PRIME"]

# Largest prime factor that still runs as one dense Stockham stage. Above
# it, Bluestein pays two transforms at a smooth length m >= 2n - 1 instead.
# ``bench_suite.py --decisions`` times both at ~13M c64 elements: on an
# H100 80GB HBM3 at a 400 W power limit the dense stage won at p = 1021,
# 2053 and 4099 (11.8 vs 16.8 ms at 4099); above 4099 it is not measured,
# and the dense stage's host table grows as 16 p^2 bytes (270 MB at 4099).
BLUESTEIN_MIN_PRIME = 4099


def bluestein_ok(n: int) -> bool:
    """Does an axis of length ``n`` run through Bluestein?"""
    return n >= 8 and max(factorize(n)) > BLUESTEIN_MIN_PRIME


@functools.lru_cache(maxsize=None)
def _bluestein_tables(n: int, m: int, inverse: bool, scale: float):
    """Host float64 chirp constants for the Bluestein (chirp-z) path.

    Angles use the exact integer reduction k^2 mod 2n so f64 precision
    holds for any k (pi * (k^2 mod 2n) / n == pi * k^2 / n mod 2*pi).
    Returns (cr, ci, c_out_r, c_out_i, Br, Bi): the input chirp c[k],
    the output chirp (user scale folded), and FFT_m of the wrapped
    conjugate chirp. The caller casts them to the plane dtype, so f64
    plans get f64 chirps.
    """
    k = np.arange(n, dtype=np.int64)
    sq = (k * k) % (2 * n)
    ang = np.pi * sq.astype(np.float64) / n
    s = 1.0 if inverse else -1.0
    cr = np.cos(ang)
    ci = s * np.sin(ang)                      # c[k] = exp(s*i*pi*k^2/n)
    b = np.zeros(m, np.complex128)
    conj_c = cr - 1j * ci
    b[:n] = conj_c
    b[m - n + 1:] = conj_c[1:][::-1]          # b[m-j] = conj(c[j])
    B = np.fft.fft(b)
    # host numpy only: jnp conversion happens per trace (a cached device
    # constant created inside one jit trace would leak its tracer into the
    # next)
    return cr, ci, cr * scale, ci * scale, B.real, B.imag


def _fft_axis_bluestein(ar, ai, axis, *, inverse, scale):
    """Bluestein (chirp-z): any length as a circular convolution.

    The DFT is re-expressed as a circular convolution of chirp-premultiplied
    input with a fixed chirp, evaluated as fft_m -> pointwise -> ifft_m at a
    smooth length m >= 2n - 1. The convolution direction is always
    forward/inverse-m; the USER direction lives in the chirp's sign.

    Covers the same any-length contract as the reference's prime-greedy
    planner fallback (fft/fft/fft.mojo:83-104) at O(m log m) per row.
    """
    n = ar.shape[axis]
    m = next_fast_len(2 * n - 1)
    ndim = ar.ndim
    axis = axis % ndim
    if ai is None:
        ai = jnp.zeros_like(ar)
    # bf16 planes compute in f32 and are stored back as bf16 (the
    # bf16-plane contract: bf16 in -> bf16 out).
    in_dtype = ar.dtype
    rdt = jnp.promote_types(in_dtype, jnp.float32)
    cr, ci, por, poi, Br, Bi = (
        jnp.asarray(t, rdt) for t in _bluestein_tables(
            n, m, bool(inverse), float(scale)))

    moved = axis != ndim - 1
    if moved:
        ar = jnp.moveaxis(ar, axis, -1)
        ai = jnp.moveaxis(ai, axis, -1)
    shape = ar.shape
    ar = ar.reshape(-1, n).astype(rdt)
    ai = ai.reshape(-1, n).astype(rdt)
    # a[j] = x[j] * c[j], zero-padded to m
    pr = ar * cr - ai * ci
    pi = ar * ci + ai * cr
    pad = ((0, 0), (0, m - n))
    pr = jnp.pad(pr, pad)
    pi = jnp.pad(pi, pad)
    # A = FFT_m(a);  C = A * B;  y = IFFT_m(C)  (1/m folded into the ifft)
    bases_m = default_bases(m)
    pr, pi = core.fft_along_axis(pr, pi, 1, bases_m, inverse=False)
    pr, pi = pr * Br - pi * Bi, pr * Bi + pi * Br
    pr, pi = core.fft_along_axis(pr, pi, 1, bases_m, inverse=True,
                                 scale=1.0 / m)
    pr = pr[:, :n]
    pi = pi[:, :n]
    outr = (pr * por - pi * poi).astype(in_dtype).reshape(shape)
    outi = (pr * poi + pi * por).astype(in_dtype).reshape(shape)
    if moved:
        outr = jnp.moveaxis(outr, -1, axis)
        outi = jnp.moveaxis(outi, -1, axis)
    return outr, outi


def fft_axis(
    ar: jnp.ndarray,
    ai: jnp.ndarray | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool,
    scale: float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transform one axis of the split planes (``ai=None``: real input).

    Bluestein when the largest prime factor is above the crossover, the
    Stockham with ``bases`` otherwise. bf16 planes (plane_dtype mode) are
    upcast around the Stockham: in bf16 it would lose ~all mantissa over
    log(n) stages, and the point of bf16 planes is storage traffic.
    """
    if bluestein_ok(ar.shape[axis]):
        return _fft_axis_bluestein(ar, ai, axis, inverse=inverse, scale=scale)
    bf16 = jnp.dtype(ar.dtype) == jnp.dtype(jnp.bfloat16)
    if bf16:
        ar = ar.astype(jnp.float32)
        ai = None if ai is None else ai.astype(jnp.float32)
    outr, outi = core.fft_along_axis(
        ar, ai, axis, bases, inverse=inverse, scale=scale
    )
    if bf16:
        outr = outr.astype(jnp.bfloat16)
        outi = outi.astype(jnp.bfloat16)
    return outr, outi
