"""Fourier-domain image filters (scipy.ndimage parity — beyond reference
parity; the reference stops at raw transforms, see SURVEY.md §2).

These operate on ALREADY-TRANSFORMED arrays: the user computes
``fftn``/``rfftn`` (with this package), multiplies by a filter transfer
function here, and inverse-transforms. The transfer functions are
separable (gaussian/uniform/shift) or radially symmetric (ellipsoid)
host-side float64 constants — per-axis 1D vectors broadcast-multiplied on
the device, so under ``jit`` the whole multiply fuses into the
surrounding transform passes as one elementwise expression on split
planes (the same discipline as ``signal.hilbert2``'s mask).

Input flavors follow the house contract: numpy in -> numpy out (host
compute), ``jax.Array`` in -> device compute, ``SplitComplex`` planes in
-> ``SplitComplex`` out.

Semantics verified numerically against scipy.ndimage (fourier_gaussian:
exp(-2 pi^2 s^2 f^2) per axis; fourier_uniform: sinc(size*f) — the
CONTINUOUS box transform, not the DFT of a discrete box;
fourier_ellipsoid: sinc / 2 J1(R)/R / 3 (sin R - R cos R)/R^3 for rank
1/2/3; fourier_shift: exp(-2 pi i f shift); the ``n >= 0`` rfft
convention uses arange(m)/n frequencies on ``axis``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core import SplitComplex

__all__ = ["fourier_gaussian", "fourier_uniform", "fourier_ellipsoid",
           "fourier_shift"]


def _per_axis(param, ndim: int, name: str) -> list[float]:
    if np.isscalar(param):
        return [float(param)] * ndim
    seq = [float(p) for p in param]
    if len(seq) != ndim:
        raise RuntimeError(f"{name} sequence length {len(seq)} does not "
                           f"match input rank {ndim}")
    return seq


def _axis_freqs(shape, n: int, axis: int) -> list[np.ndarray]:
    """Per-axis frequency grids (f64). ``n >= 0`` marks ``axis`` as the
    half-spectrum axis of an rfft of a length-``n`` real array."""
    ndim = len(shape)
    axis = axis % ndim
    out = []
    for j, m in enumerate(shape):
        if j == axis and n >= 0:
            out.append(np.arange(m, dtype=np.float64) / max(n, 1))
        else:
            out.append(np.fft.fftfreq(m))
    return out


def _bshape(v: np.ndarray, j: int, ndim: int):
    shape = [1] * ndim
    shape[j] = v.shape[0]
    return v.reshape(shape)


def _apply_real(x, hs: list[np.ndarray], output=None):
    """Multiply by a separable REAL transfer function given as per-axis
    f64 vectors; preserves the input flavor."""
    if isinstance(x, SplitComplex):
        re, im = x.re, x.im
        for j, h in enumerate(hs):
            hj = jnp.asarray(_bshape(h, j, re.ndim), re.dtype)
            re, im = re * hj, im * hj
        return SplitComplex(re, im)
    if isinstance(x, jax.Array):
        y = x
        for j, h in enumerate(hs):
            y = y * jnp.asarray(_bshape(h, j, y.ndim), y.dtype)
        return y
    a = np.asarray(x)
    y = a.astype(np.promote_types(a.dtype, np.float64), copy=True)
    for j, h in enumerate(hs):
        y *= _bshape(h, j, y.ndim)
    y = y.astype(np.promote_types(a.dtype, np.float32), copy=False)
    if output is not None:
        output[...] = y
        return output
    return y


def _apply_real_grid(x, H: np.ndarray, output=None):
    """Multiply by a full (non-separable) REAL f64 transfer grid."""
    if isinstance(x, SplitComplex):
        hj = jnp.asarray(H, x.re.dtype)
        return SplitComplex(x.re * hj, x.im * hj)
    if isinstance(x, jax.Array):
        return x * jnp.asarray(H, x.dtype)
    a = np.asarray(x)
    y = (a * H).astype(np.promote_types(a.dtype, np.float32), copy=False)
    if output is not None:
        output[...] = y
        return output
    return y


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1,
                     output=None):
    """Multiply a Fourier-transformed array by a Gaussian transfer
    function (scipy.ndimage.fourier_gaussian-compatible).

    ``sigma`` is the real-space standard deviation, scalar or per-axis.
    ``n >= 0`` declares ``axis`` to hold the half spectrum of an rfft of
    a length-``n`` real array.
    """
    ndim = np.ndim(input) if not isinstance(input, SplitComplex) \
        else input.re.ndim
    shape = np.shape(input) if not isinstance(input, SplitComplex) \
        else input.re.shape
    sigmas = _per_axis(sigma, ndim, "sigma")
    freqs = _axis_freqs(shape, n, axis)
    hs = [np.exp(-2.0 * np.pi ** 2 * s * s * f * f)
          for s, f in zip(sigmas, freqs)]
    return _apply_real(input, hs, output)


def fourier_uniform(input, size, n: int = -1, axis: int = -1, output=None):
    """Multiply a Fourier-transformed array by the transfer function of a
    (continuous) box of the given size — sinc(size * f) per axis
    (scipy.ndimage.fourier_uniform-compatible)."""
    ndim = np.ndim(input) if not isinstance(input, SplitComplex) \
        else input.re.ndim
    shape = np.shape(input) if not isinstance(input, SplitComplex) \
        else input.re.shape
    sizes = _per_axis(size, ndim, "size")
    freqs = _axis_freqs(shape, n, axis)
    hs = [np.sinc(s * f) for s, f in zip(sizes, freqs)]
    return _apply_real(input, hs, output)


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1,
                      output=None):
    """Multiply a Fourier-transformed array by the transfer function of an
    ellipsoid of the given size (scipy.ndimage.fourier_ellipsoid-
    compatible; rank 1-3 only, like scipy): sinc for rank 1, the circular
    aperture 2 J1(R)/R for rank 2, the sphere
    3 (sin R - R cos R)/R^3 for rank 3, with R = pi |size .* f|."""
    ndim = np.ndim(input) if not isinstance(input, SplitComplex) \
        else input.re.ndim
    shape = np.shape(input) if not isinstance(input, SplitComplex) \
        else input.re.shape
    if ndim > 3:
        raise NotImplementedError(
            "fourier_ellipsoid only supports rank 1-3 input (scipy parity)")
    sizes = _per_axis(size, ndim, "size")
    freqs = _axis_freqs(shape, n, axis)
    if ndim == 1:
        return _apply_real(input, [np.sinc(sizes[0] * freqs[0])], output)
    R2 = np.zeros((1,) * ndim, np.float64)
    for j, (s, f) in enumerate(zip(sizes, freqs)):
        R2 = R2 + _bshape((s * f) ** 2, j, ndim)
    R = np.pi * np.sqrt(R2)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ndim == 2:
            from scipy.special import j1
            H = np.where(R == 0.0, 1.0, 2.0 * j1(R) / R)
        else:
            H = np.where(R == 0.0, 1.0,
                         3.0 * (np.sin(R) - R * np.cos(R)) / R ** 3)
    return _apply_real_grid(input, H, output)


def fourier_shift(input, shift, n: int = -1, axis: int = -1, output=None):
    """Multiply a Fourier-transformed array by the phase ramp
    exp(-2 pi i f . shift) — a real-space translation
    (scipy.ndimage.fourier_shift-compatible).

    The transfer function is complex: numpy input promotes to complex,
    a ``jax.Array`` returns a complex ``jax.Array``, ``SplitComplex``
    stays ``SplitComplex``.
    """
    is_split = isinstance(input, SplitComplex)
    ndim = input.re.ndim if is_split else np.ndim(input)
    shape = input.re.shape if is_split else np.shape(input)
    shifts = _per_axis(shift, ndim, "shift")
    freqs = _axis_freqs(shape, n, axis)
    # separable per-axis accumulation keeps everything rank-1 until the
    # broadcasted multiply on the target device
    if is_split or isinstance(input, jax.Array):
        if is_split:
            re, im = input.re, input.im
        elif jnp.issubdtype(input.dtype, jnp.complexfloating):
            re, im = jnp.real(input), jnp.imag(input)
        else:
            re, im = input, jnp.zeros_like(input)
        for j, (s, f) in enumerate(zip(shifts, freqs)):
            hr = jnp.asarray(_bshape(np.cos(2 * np.pi * s * f), j, ndim),
                             re.dtype)
            hi = jnp.asarray(_bshape(np.sin(-2 * np.pi * s * f), j, ndim),
                             re.dtype)
            re, im = re * hr - im * hi, re * hi + im * hr
        if is_split:
            return SplitComplex(re, im)
        return jax.lax.complex(re, im)
    a = np.asarray(input)
    y = a.astype(np.promote_types(a.dtype, np.complex128), copy=True)
    for j, (s, f) in enumerate(zip(shifts, freqs)):
        y *= _bshape(np.exp(-2j * np.pi * s * f), j, ndim)
    y = y.astype(np.promote_types(a.dtype, np.complex64), copy=False)
    if output is not None:
        output[...] = y
        return output
    return y
