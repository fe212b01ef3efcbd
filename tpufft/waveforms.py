"""Waveform generators: chirps, pulses, and test sequences.

Beyond reference parity (the reference, martinvuyk/hackathon-fft, stops
at raw transforms); scipy parity targets are scipy/signal/_waveforms.py
(chirp, sweep_poly, gausspulse, square, sawtooth, unit_impulse) and
scipy/signal/_max_len_seq.py (max_len_seq).

Notes: the samplers (`chirp`, `sweep_poly`, `gausspulse`,
`square`, `sawtooth`) are xp-generic — a ``jax.Array`` time vector
returns a ``jax.Array`` computed with jnp (traceable, differentiable,
usable inside ``jax.jit``); numpy input stays on the host in float64.
Phase polynomials are integrated exactly on the host (np.polyint) at
trace time. ``max_len_seq`` is an inherently sequential LFSR recurrence
and runs as a host loop — its output is test DATA, not device compute.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["chirp", "sweep_poly", "gausspulse", "square", "sawtooth",
           "unit_impulse", "max_len_seq"]


def _xp(t):
    return (jnp, True) if isinstance(t, jax.Array) else (np, False)


def sawtooth(t, width=1.0):
    """Periodic sawtooth/triangle wave with period 2*pi
    (scipy.signal.sawtooth-compatible): rises 0 -> width of each period,
    falls width -> 1; width=1 is the classic sawtooth, width=0.5 a
    triangle. Out-of-range width yields NaN like scipy."""
    xp, is_jax = _xp(t)
    t = xp.asarray(t)
    w = xp.asarray(width)
    tmod = xp.mod(t, 2 * math.pi)
    # broadcast-safe branches (array-valued width broadcasts per
    # sample, like scipy); guard the w==0 / w==1 divisions
    w_safe = xp.where(w > 0, w, 1.0)
    rising = tmod / (math.pi * w_safe) - 1.0
    wm1 = xp.where(w < 1, 1.0 - w, 1.0)
    falling = (math.pi * (w + 1) - tmod) / (math.pi * wm1)
    out = xp.where(tmod < w * 2 * math.pi, rising, falling)
    bad = (w < 0) | (w > 1)
    return xp.where(bad, xp.nan, out)


def square(t, duty=0.5):
    """Periodic square wave with period 2*pi
    (scipy.signal.square-compatible): +1 for the first ``duty`` fraction
    of each period, -1 for the rest."""
    xp, _ = _xp(t)
    t = xp.asarray(t)
    d = xp.asarray(duty)
    tmod = xp.mod(t, 2 * math.pi)
    out = xp.where(tmod < d * 2 * math.pi, 1.0, -1.0)
    bad = (d < 0) | (d > 1)
    return xp.where(bad, xp.nan, out)


def _chirp_phase(t, f0: float, t1: float, f1: float, method: str,
                 vertex_zero: bool):
    """Integrated instantaneous frequency, in cycles (not radians)."""
    xp, _ = _xp(t)
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        return f0 * t + 0.5 * beta * t * t
    if method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 ** 2)
        if vertex_zero:
            return f0 * t + beta * t ** 3 / 3.0
        return f1 * t + beta * ((t1 - t) ** 3 - t1 ** 3) / 3.0
    if method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0:
            raise ValueError("logarithmic chirp needs f0 and f1 nonzero "
                             "with the same sign")
        if f0 == f1:
            return f0 * t
        ratio = f1 / f0
        return f0 * t1 / math.log(ratio) * (ratio ** (t / t1) - 1.0)
    if method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic chirp needs nonzero f0 and f1")
        if f0 == f1:
            return f0 * t
        sing = -f1 * t1 / (f0 - f1)   # the 1/f singularity location
        return -sing * f0 * xp.log(xp.abs(1.0 - t / sing))
    raise ValueError(f"unknown chirp method {method!r}")


def chirp(t, f0, t1, f1, method="linear", phi=0, vertex_zero=True, *,
          complex=False):
    """Frequency-swept cosine (scipy.signal.chirp-compatible):
    linear / quadratic / logarithmic / hyperbolic sweeps from f0 at t=0
    to f1 at t=t1; ``complex=True`` returns the analytic exp(j*...)
    form like modern scipy."""
    xp, is_jax = _xp(t)
    t = xp.asarray(t, jnp.float32 if is_jax else np.float64)
    phase = 2 * math.pi * _chirp_phase(t, float(f0), float(t1), float(f1),
                                       method, vertex_zero)
    phi_r = float(phi) * math.pi / 180.0
    if complex:
        # exp(-j(phase+phi)) conjugate convention? scipy uses
        # exp(1j*(phase+phi)) mapped so real part equals the real chirp
        return xp.exp(1j * (phase + phi_r)) if not is_jax else (
            xp.cos(phase + phi_r) + 1j * xp.sin(phase + phi_r))
    return xp.cos(phase + phi_r)


def sweep_poly(t, poly, phi=0):
    """Cosine with polynomial instantaneous frequency
    (scipy.signal.sweep_poly-compatible): ``poly`` gives f(t) (highest
    power first or np.poly1d); the phase is its exact antiderivative."""
    xp, is_jax = _xp(t)
    coefs = np.asarray(np.poly1d(poly).coefficients, np.float64)
    intp = np.polyint(coefs)
    t = xp.asarray(t, jnp.float32 if is_jax else np.float64)
    phase = xp.polyval(xp.asarray(intp), t)
    return xp.cos(2 * math.pi * phase + float(phi) * math.pi / 180.0)


def gausspulse(t, fc=1000, bw=0.5, bwr=-6, tpr=-60, retquad=False,
               retenv=False):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse-compatible).

    ``t='cutoff'`` returns the time where the envelope falls to ``tpr``
    dB. Otherwise returns yI (in-phase), optionally yQ (quadrature)
    and/or yenv, in scipy's order."""
    fc, bw, bwr, tpr = float(fc), float(bw), float(bwr), float(tpr)
    if fc < 0:
        raise ValueError("fc must be >= 0")
    if bw <= 0:
        raise ValueError("bw must be > 0")
    if bwr >= 0:
        raise ValueError("bwr must be < 0 dB")
    ref = 10.0 ** (bwr / 20.0)
    # envelope exp(-a t^2) whose spectrum is ref at fc*bw/2 off-center
    a = -(math.pi * fc * bw) ** 2 / (4.0 * math.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError("t must be an array or the string 'cutoff'")
        if tpr >= 0:
            raise ValueError("tpr must be < 0 dB")
        eref = 10.0 ** (tpr / 20.0)
        return math.sqrt(-math.log(eref) / a)
    xp, is_jax = _xp(t)
    t = xp.asarray(t, jnp.float32 if is_jax else np.float64)
    yenv = xp.exp(-a * t * t)
    yI = yenv * xp.cos(2 * math.pi * fc * t)
    out = [yI]
    if retquad:
        out.append(yenv * xp.sin(2 * math.pi * fc * t))
    if retenv:
        out.append(yenv)
    return out[0] if len(out) == 1 else tuple(out)


def unit_impulse(shape, idx=None, dtype=float):
    """Unit impulse delta[n - idx] (scipy.signal.unit_impulse-compatible;
    ``idx='mid'`` centers it)."""
    out = np.zeros(shape, dtype)
    if idx is None:
        idx = (0,) * out.ndim
    elif idx == "mid":
        idx = tuple(s // 2 for s in out.shape)
    elif np.ndim(idx) == 0 and out.ndim == 1:
        idx = (int(idx),)
    out[tuple(idx)] = 1
    return out


# Primitive-polynomial feedback taps for maximal-length LFSRs, one known
# primitive polynomial per register size (published tables, e.g.
# Zierler/Peterson; the same standard choices scipy documents).
_MLS_TAPS = {
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
    9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
    14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14],
    18: [11], 19: [18, 17, 14], 20: [17], 21: [19], 22: [21],
    23: [18], 24: [23, 22, 17], 25: [22], 26: [25, 24, 20],
    27: [26, 25, 22], 28: [25], 29: [27], 30: [29, 28, 7],
    31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits: int, state=None, length=None, taps=None):
    """Maximal-length (pseudo-random) binary sequence from an LFSR
    (scipy.signal.max_len_seq-compatible): period 2**nbits - 1; returns
    (seq, final_state) so calls can be chained."""
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError("nbits must be between 2 and 32 when taps "
                             "is not given")
        taps = _MLS_TAPS[nbits]
    taps = np.unique(np.asarray(taps, np.intp))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits) or taps.size == 0:
        raise ValueError("taps must be integers in [0, nbits]")
    n_max = (1 << nbits) - 1
    if length is None:
        length = n_max
    length = int(length)
    if length < 0:
        raise ValueError("length must be >= 0")
    if state is None:
        state = np.ones(nbits, np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
        if state.ndim != 1 or state.shape[0] != nbits:
            raise ValueError("state must be a 1-D array of length nbits")
        if not np.any(state):
            raise ValueError("state must not be all zeros")
    state = state.copy()
    seq = np.empty(length, np.int8)
    # Galois-style circular-buffer LFSR (no shifting: the register is a
    # ring and idx walks it): output = state[idx]; the tapped cells XOR
    # into that slot; the final state is reported in canonical order
    # (rolled so idx is first) — bit-exact with scipy's recurrence
    idx = 0
    for i in range(length):
        fb = state[idx]
        seq[i] = fb
        for t in taps:
            fb ^= state[(t + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx)
