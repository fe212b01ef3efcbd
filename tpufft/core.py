"""Split-complex Stockham execution core (pure jnp / XLA path).

Complex data on the device path is represented as **split real/imag float
planes**. Each Stockham stage is a pair-of-real-einsums realization of the
complex contraction, which XLA hands to its matrix-multiply emitters.

This module plays the role the reference's CPU backend plays for its GPU
backend (``fft/fft/_ndim_fft_cpu.mojo``): a portable implementation of the
same stage schedule. It is the transform of every backend (execute.py adds
only the Bluestein route for large primes).

The stage loop is a Python loop over a statically known schedule (the analog
of the reference's comptime-unrolled stages, fft/fft/_fft.mojo:190-297), so
XLA sees a flat chain of dot/multiply/reshape ops and constant-folds the
embedded twiddle tables. Real-valued radix matrices (e.g. W_2) and all-ones
twiddle rows are detected on the host at trace time and their multiplies
skipped — the analog of the reference's phasor specializations
(fft/fft/_utils.mojo:291-372).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .twiddle import stage_tables

__all__ = [
    "SplitComplex",
    "complex_dtype_for",
    "real_dtype_for",
    "stockham_split_last_axis",
    "fft_along_axis",
]

# einsum precision: a float32 contraction with no precision may run in TF32
# on the GPU (~1e-3 relative per stage); FFT accuracy (1e-3 rel for c64,
# per BASELINE.md, after log(n) stages) needs full f32, so force HIGHEST.
_PRECISION = jax.lax.Precision.HIGHEST


class SplitComplex(NamedTuple):
    """A complex array as split real/imag planes.

    A NamedTuple, hence a pytree: passes through ``jax.jit``/``shard_map``
    transparently. This is the framework's internal complex representation
    — the analog of the reference's interleaved last-axis-of-2 layout
    (fft/fft/fft.mojo:20-47) as two separate real planes.
    """

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def conj(self) -> "SplitComplex":
        return SplitComplex(self.re, -self.im)

    def numpy(self) -> np.ndarray:
        """Combine to a host numpy complex array."""
        re = np.asarray(self.re)
        im = np.asarray(self.im)
        cdt = np.complex128 if re.dtype == np.float64 else np.complex64
        out = np.empty(re.shape, cdt)
        out.real = re
        out.imag = im
        return out

    def __array__(self, dtype=None, copy=None):
        """numpy conversion protocol: ``np.asarray(sc)`` is the COMPLEX
        array. Without this, NamedTuple sequence semantics silently give
        the stacked (2, ...) float planes — a footgun, not a layout."""
        if copy is False:
            # the re/im -> complex combine always materializes
            raise ValueError(
                "SplitComplex -> numpy conversion always copies; "
                "np.array(..., copy=False) cannot be honored")
        arr = self.numpy()
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return arr

    @staticmethod
    def from_array(x) -> "SplitComplex":
        """Split any array-like (complex or real) into planes."""
        if isinstance(x, SplitComplex):
            return x
        xn = np.asarray(x) if not isinstance(x, jax.Array) else x
        if np.issubdtype(np.dtype(xn.dtype), np.complexfloating):
            if isinstance(xn, jax.Array):
                return SplitComplex(xn.real, xn.imag)
            return SplitComplex(
                jnp.asarray(np.ascontiguousarray(xn.real)),
                jnp.asarray(np.ascontiguousarray(xn.imag)),
            )
        xj = jnp.asarray(xn)
        if not jnp.issubdtype(xj.dtype, jnp.floating):
            xj = xj.astype(jnp.float32)
        return SplitComplex(xj, jnp.zeros_like(xj))


def complex_dtype_for(dtype) -> jnp.dtype:
    """Complex result dtype for a given input dtype (f32->c64, f64->c128)."""
    d = jnp.dtype(dtype)
    if d in (jnp.dtype(jnp.complex64), jnp.dtype(jnp.complex128)):
        return d
    if d == jnp.dtype(jnp.float64):
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def real_dtype_for(dtype) -> jnp.dtype:
    d = jnp.dtype(dtype)
    if d in (jnp.dtype(jnp.complex128), jnp.dtype(jnp.float64)):
        if jax.config.jax_enable_x64:
            return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def _maybe_const(table: np.ndarray, rdt) -> jnp.ndarray | None:
    """Host table -> device constant, or None if it is exactly zero."""
    if not np.any(table):
        return None
    return jnp.asarray(table, rdt)


def _einsum(w, a):
    # out[..., j, p, q] = sum_b w[j, b] * a[..., b, p, q]
    return jnp.einsum("jb,...bpq->...jpq", w, a, precision=_PRECISION)


def stockham_split_last_axis(
    ar: jnp.ndarray,
    ai: jnp.ndarray | None,
    bases: tuple[int, ...],
    *,
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mixed-radix Stockham FFT over the last axis, split-plane arithmetic.

    ``ar``/``ai``: (..., N) real planes; ``ai=None`` means a pure-real input
    — the first stage then skips all imaginary-input work, the analog of the
    reference's ``do_rfft`` scalar-read first stage (fft/fft/_fft.mojo:
    115-118, 254-257).

    Per stage (radix r, m twiddle groups, cumulative product s):
    view (..., r, m, s); complex contraction with the radix DFT matrix W_r
    realized as up to four real einsums; twiddle as elementwise multiplies;
    swap (r, m) -> (m, r) and flatten. After the last stage the planes hold
    the DFT in natural order (autosort — no digit reversal).
    """
    n = ar.shape[-1]
    rdt = ar.dtype
    tables = stage_tables(n, bases, inverse, scale)
    if not tables:
        s = None if scale == 1.0 else jnp.asarray(scale, rdt)
        if ai is None:
            ai = jnp.zeros_like(ar)
        if s is not None:
            ar, ai = ar * s, ai * s
        return ar, ai

    pre = ar.shape[:-1]
    for st, w, tw in tables:
        r, m, s = st.radix, st.m, st.s
        wr = _maybe_const(np.ascontiguousarray(w.real), rdt)
        wi = _maybe_const(np.ascontiguousarray(w.imag), rdt)
        a_r = ar.reshape(pre + (r, m, s))
        a_i = None if ai is None else ai.reshape(pre + (r, m, s))
        # c = W @ a (complex) as real einsums, skipping zero factors.
        cr = _einsum(wr, a_r) if wr is not None else None
        ci = _einsum(wi, a_r) if wi is not None else None
        if a_i is not None:
            if wi is not None:
                cr = cr - _einsum(wi, a_i) if cr is not None else -_einsum(wi, a_i)
            if wr is not None:
                ci = ci + _einsum(wr, a_i) if ci is not None else _einsum(wr, a_i)
        zeros = lambda: jnp.zeros(pre + (r, m, s), rdt)  # noqa: E731
        cr = cr if cr is not None else zeros()
        ci = ci if ci is not None else zeros()
        # Twiddle multiply tw[j, p] (skip when the whole table is 1+0i,
        # e.g. the last stage with m == 1 and no fused scale).
        twr_h = np.ascontiguousarray(tw.real)
        twi_h = np.ascontiguousarray(tw.imag)
        if np.any(twi_h) or not np.allclose(twr_h, 1.0):
            twr = jnp.asarray(twr_h, rdt)[:, :, None]
            twi_c = _maybe_const(twi_h, rdt)
            if twi_c is None:
                cr, ci = twr * cr, twr * ci
            else:
                twi = twi_c[:, :, None]
                cr, ci = twr * cr - twi * ci, twr * ci + twi * cr
        ar = jnp.swapaxes(cr, -3, -2).reshape(pre + (n,))
        ai = jnp.swapaxes(ci, -3, -2).reshape(pre + (n,))
    return ar, ai


def fft_along_axis(
    ar: jnp.ndarray,
    ai: jnp.ndarray | None,
    axis: int,
    bases: tuple[int, ...],
    *,
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stockham FFT along an arbitrary axis (XLA path, split planes).

    Uses moveaxis to bring the transform axis minor; XLA chooses layouts and
    fuses the transposes with adjacent stages.
    """
    from .planner import stage_schedule

    n = ar.shape[axis]
    stage_schedule(n, tuple(bases))  # validate early with a clear error
    mr = jnp.moveaxis(ar, axis, -1)
    mi = None if ai is None else jnp.moveaxis(ai, axis, -1)
    outr, outi = stockham_split_last_axis(
        mr, mi, tuple(bases), inverse=inverse, scale=scale
    )
    return jnp.moveaxis(outr, -1, axis), jnp.moveaxis(outi, -1, axis)
