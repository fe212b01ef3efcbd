"""Fast Hankel transform (FFTLog) on the tpufft real-FFT path.

Completes the ``scipy.fft`` surface beyond the reference library (the
reference has no Hankel transforms; this module exists for drop-in
``scipy.fft`` parity — see PARITY.md). Algorithm: Talman (1978) /
Hamilton (2000, astro-ph/9905191) FFTLog, behavior-matched to
``scipy.fft.fht``/``ifht``/``fhtoffset``:

    A = flip(irfft(u * rfft(a)))        (forward; inverse divides by u*)

The u-coefficients are loggamma-based and computed on the HOST in float64
(like every twiddle table in this library), cached as NUMPY arrays (jnp
values must never be lru-cached: they leak tracers across jit traces,
CLAUDE.md). The rfft/irfft are the library's own packed real transforms,
so a batched fht is one rfft, a diagonal u-multiply and one irfft.

Input may be a numpy array (numpy out), a jax array (jax out), or real
``SplitComplex`` planes are NOT accepted — the transform is real-to-real.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from .core import SplitComplex

_LN2 = math.log(2.0)

__all__ = ["fht", "ifht", "fhtoffset"]


@functools.lru_cache(maxsize=64)
def _fht_coeff_cached(n: int, dln: float, mu: float, offset: float,
                      bias: float, inverse: bool):
    """FFTLog u-coefficients as (re, im) float64 NUMPY planes.

    u_m = (k_c r_c)^{-2pi i m/(n dln)} U_mu(q + 2pi i m/(n dln)),
    U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2)  (m = 0..n//2).
    """
    from scipy.special import loggamma, poch

    lnkr, q = offset, bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    # log u = q ln2 + loggamma(xp + iy) - loggamma(xm - iy) + 2iy(ln2 - lnkr)
    v = loggamma(xp + 1j * y) - loggamma(xm - 1j * y)
    u = np.exp(v.real + _LN2 * q
               + 1j * (v.imag + 2 * (_LN2 - lnkr) * y))
    if n % 2 == 0:
        u.imag[-1] = 0.0  # Nyquist coefficient of a real transform is real
    if not np.isfinite(u[0]):
        # poles of the two loggammas cancel at m=0; poch() evaluates the
        # ratio Gamma(xp)/Gamma(xm) = poch(xm, xp - xm) through them
        u[0] = 2**q * poch(xm, xp - xm)
    singular = False
    if np.isinf(u[0].real) and not inverse:
        singular = True
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        singular = True
        u[0] = np.inf
    return np.ascontiguousarray(u.real), np.ascontiguousarray(u.imag), \
        singular


def _fht_coeff(n, dln, mu, offset, bias, inverse):
    ur, ui, singular = _fht_coeff_cached(n, dln, mu, offset, bias, inverse)
    if singular:  # warn per call, like scipy (the table itself is cached)
        kind = "singular inverse transform" if inverse else \
            "singular transform"
        warnings.warn(f"{kind}; consider changing the bias", stacklevel=3)
    return ur, ui


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Offset near ``initial`` satisfying Hamilton's low-ringing condition
    (scipy.fft.fhtoffset-compatible)."""
    from scipy.special import loggamma

    lnkr, q = float(initial), float(bias)
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * dln)
    zp = loggamma(xp + 1j * y)
    zm = loggamma(xm + 1j * y)
    arg = (_LN2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)


def _apply_u(spec, ur, ui, inverse: bool):
    """Diagonal coefficient multiply on an rfft spectrum (complex array or
    SplitComplex planes). Inverse divides by conj(u)."""
    if inverse:
        # 1 / conj(u) = u / |u|^2; guard the intentional inf (singular
        # inverse warning) which must map to 0
        den = ur * ur + ui * ui
        with np.errstate(invalid="ignore"):
            wr = np.where(np.isfinite(den), ur / den, 0.0)
            wi = np.where(np.isfinite(den), ui / den, 0.0)
    else:
        wr, wi = ur, ui
    if isinstance(spec, SplitComplex):
        dt = spec.re.dtype
        wr = jnp.asarray(wr, dt)
        wi = jnp.asarray(wi, dt)
        return SplitComplex(spec.re * wr - spec.im * wi,
                            spec.re * wi + spec.im * wr)
    w = (wr + 1j * wi).astype(np.result_type(spec.dtype, np.complex64))
    return spec * w

def _fhtq(a, n: int, ur, ui, inverse: bool, config):
    from . import api

    spec = api.rfft(a, axis=-1, config=config)
    spec = _apply_u(spec, ur, ui, inverse)
    out = api.irfft(spec, n=n, axis=-1, config=config)
    if isinstance(out, jax.Array):
        return jnp.flip(out, axis=-1)
    return np.flip(np.asarray(out), axis=-1)


def _bias_factors(n: int, dln: float, bias: float, offset: float):
    j = np.arange(n) - (n - 1) / 2
    pre = np.exp(-bias * j * dln)
    post = np.exp(-bias * (j * dln + offset))
    return pre, post


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
        *, config=None):
    """Discrete Hankel transform of a log-spaced periodic sequence
    (scipy.fft.fht-compatible; last axis)."""
    dln, mu, offset, bias = map(float, (dln, mu, offset, bias))
    n = int(np.shape(a)[-1])
    is_jax = isinstance(a, jax.Array)
    if bias != 0:
        pre, post = _bias_factors(n, dln, bias, offset)
        a = a * (jnp.asarray(pre, a.dtype) if is_jax else pre)
    ur, ui = _fht_coeff(n, dln, mu, offset, bias, False)
    out = _fhtq(a, n, ur, ui, False, config)
    if bias != 0:
        out = out * (jnp.asarray(post, out.dtype)
                     if isinstance(out, jax.Array) else post)
    return out


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
         *, config=None):
    """Inverse of :func:`fht` (scipy.fft.ifht-compatible; last axis)."""
    dln, mu, offset, bias = map(float, (dln, mu, offset, bias))
    n = int(np.shape(A)[-1])
    is_jax = isinstance(A, jax.Array)
    if bias != 0:
        pre, post = _bias_factors(n, dln, bias, offset)
        A = A * (jnp.asarray(1.0 / post, A.dtype) if is_jax else 1.0 / post)
    ur, ui = _fht_coeff(n, dln, mu, offset, bias, True)
    out = _fhtq(A, n, ur, ui, True, config)
    if bias != 0:
        out = out * (jnp.asarray(1.0 / pre, out.dtype)
                     if isinstance(out, jax.Array) else 1.0 / pre)
    return out
