"""Polyphase multirate resampling (the scipy.signal multirate surface:
upfirdn, resample_poly, decimate).

Beyond reference parity: the reference (martinvuyk/hackathon-fft) stops at
raw transforms; resampling is the standard consumer of batched convolution
and rides this package's fused FFT-convolution path.

Design:
* ``upfirdn`` = zero-stuff -> linear convolution -> stride. The
  convolution runs through :func:`tpufft.signal.fftconvolve`, i.e. the
  batched packed r2c/c2r transforms with fast-length padding — one
  batched transform per call instead of scipy's O(N/P)-per-sample
  polyphase C loop (which is a CPU idiom: its inner gather defeats
  vectorization on wide machines).
* Boundary modes are applied by materializing a small host/device edge
  extension (the virtual extension only ever reaches
  ceil((len(h)-1)/up) input samples past each edge), then cropping the
  equivalent constant-mode output — the extension length is rounded so
  the output realigns on an integer stride offset.
* Filter design (firwin windows) is a host-side f64 plan constant,
  same discipline as twiddle tables (delegated to scipy.signal at plan
  time, never traced).

IO contract follows the package convention: numpy in -> numpy out (f64
on the x64 CPU tier, ~1e-12 parity with scipy), jax in -> device-resident
out.

Reference coverage: the reference has no resampling layer; scipy parity
targets are scipy/signal/_upfirdn.py (upfirdn semantics, output length,
pad modes) and scipy/signal/_signaltools.py (resample_poly window design
and edge cropping, decimate's FIR order and zero-phase group-delay
alignment).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .config import PlanConfig
from .signal import fftconvolve

__all__ = ["upfirdn", "resample_poly", "decimate"]


_UPFIRDN_MODES = ("constant", "wrap", "edge", "smooth", "symmetric",
                  "reflect", "antisymmetric", "antireflect", "line")


def _output_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """scipy.signal._upfirdn._output_len: samples the strided output
    keeps from the full upsampled convolution."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _edge_blocks(x, n_ext: int, mode: str, cval, xp, axis: int):
    """(left, right) extension blocks of length n_ext along ``axis``
    (scipy _upfirdn boundary semantics)."""
    n = x.shape[axis]

    def take(sl):
        idx = [slice(None)] * x.ndim
        idx[axis] = sl
        return x[tuple(idx)]

    def flip(a):
        return xp.flip(a, axis=axis)

    if mode == "constant":
        shape = list(x.shape)
        shape[axis] = n_ext
        blk = xp.full(shape, cval, dtype=x.dtype)
        return blk, blk
    if n_ext >= n and mode in ("symmetric", "reflect", "antisymmetric",
                               "antireflect"):
        raise ValueError(
            f"upfirdn mode {mode!r} needs the signal to be longer than "
            f"the boundary extension ({n_ext} samples); got length {n}")
    if mode == "edge":
        reps = [1] * x.ndim
        reps[axis] = n_ext
        return (xp.tile(take(slice(0, 1)), reps),
                xp.tile(take(slice(n - 1, n)), reps))
    if mode == "wrap":
        return take(slice(n - n_ext, n)), take(slice(0, n_ext))
    if mode == "symmetric":
        return flip(take(slice(0, n_ext))), flip(take(slice(n - n_ext, n)))
    if mode == "reflect":
        return (flip(take(slice(1, n_ext + 1))),
                flip(take(slice(n - n_ext - 1, n - 1))))
    if mode == "antisymmetric":
        return (-flip(take(slice(0, n_ext))),
                -flip(take(slice(n - n_ext, n))))
    if mode == "antireflect":
        first = take(slice(0, 1))
        last = take(slice(n - 1, n))
        return (2 * first - flip(take(slice(1, n_ext + 1))),
                2 * last - flip(take(slice(n - n_ext - 1, n - 1))))
    if mode in ("line", "smooth"):
        first = take(slice(0, 1))
        last = take(slice(n - 1, n))
        if mode == "line":
            # linear trend through the FIRST and LAST points
            slope_l = slope_r = (last - first) / max(n - 1, 1)
        else:
            # smooth: per-edge slope from the last TWO points
            slope_l = take(slice(1, 2)) - first if n > 1 else 0 * first
            slope_r = last - take(slice(n - 2, n - 1)) if n > 1 \
                else 0 * last
        shape = [1] * x.ndim
        shape[axis] = n_ext
        if xp is np:
            kl = np.arange(n_ext, 0, -1).reshape(shape)
            kr = np.arange(1, n_ext + 1).reshape(shape)
        else:
            kl = jnp.arange(n_ext, 0, -1).reshape(shape)
            kr = jnp.arange(1, n_ext + 1).reshape(shape)
        return ((first - kl * slope_l).astype(x.dtype),
                (last + kr * slope_r).astype(x.dtype))
    raise ValueError(f"mode must be one of {list(_UPFIRDN_MODES)}, "
                     f"got {mode!r}")


def _zero_stuff(x, up: int, axis: int, xp):
    """Insert up-1 zeros between samples along ``axis`` (length n*up)."""
    if up == 1:
        return x
    shape = list(x.shape)
    # expand a trailing unit dim next to `axis`, pad it to `up`, re-merge
    ax = axis % x.ndim
    xe = xp.expand_dims(x, ax + 1)
    pad = [(0, 0)] * xe.ndim
    pad[ax + 1] = (0, up - 1)
    xz = xp.pad(xe, pad)
    shape[ax] = shape[ax] * up
    return xz.reshape(shape)


def upfirdn(h, x, up: int = 1, down: int = 1, axis: int = -1,
            mode: str = "constant", cval: float = 0, *,
            config: PlanConfig | None = None):
    """Upsample by ``up`` (zero insertion), FIR filter with ``h``,
    downsample by ``down`` — scipy.signal.upfirdn-compatible, including
    output length and the boundary ``mode``/``cval`` semantics.

    Runs as ONE batched FFT convolution through the packed real-FFT path
    (see module docstring) instead of a per-sample polyphase loop."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    h_arr = np.asarray(h)
    if h_arr.ndim != 1 or h_arr.size == 0:
        raise ValueError("h must be 1-D with non-zero length")
    if mode not in _UPFIRDN_MODES:
        raise ValueError(f"mode must be one of {list(_UPFIRDN_MODES)}, "
                         f"got {mode!r}")
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    if not np.issubdtype(np.dtype(x.dtype), np.inexact):
        x = x.astype(np.float64 if is_np else jnp.float32)
    axis = axis % x.ndim
    n_in = x.shape[axis]
    if n_in == 0:
        raise ValueError("input must have at least one sample along axis")
    len_h = h_arr.size
    L = _output_len(len_h, n_in, up, down)

    need_ext = not (mode == "constant" and cval == 0)
    shift = 0
    if need_ext:
        # the filter reaches ceil((len_h-1)/up) input samples past each
        # edge; round the extension up so the cropped output realigns on
        # an integer stride offset ((E*up) % down == 0)
        E = -(-(len_h - 1) // up) if len_h > 1 else 0
        while E and (E * up) % down:
            E += 1
        if E:
            left, right = _edge_blocks(x, E, mode, cval, xp, axis)
            x = xp.concatenate([left, x, right], axis=axis)
            shift = (E * up) // down

    if np.issubdtype(h_arr.dtype, np.complexfloating) or \
            np.issubdtype(np.dtype(x.dtype), np.complexfloating):
        want = np.result_type(h_arr.dtype, x.dtype, np.complex64)
    else:
        want = np.result_type(h_arr.dtype, x.dtype, np.float32)
    if is_np:
        hx = np.asarray(
            h_arr, np.complex128
            if np.issubdtype(want, np.complexfloating) else np.float64)
    else:
        hx = jnp.asarray(
            h_arr.astype(np.complex64 if np.issubdtype(
                want, np.complexfloating) else np.float32))
    hshape = [1] * x.ndim
    hshape[axis] = len_h
    hx = hx.reshape(hshape)

    xz = _zero_stuff(x, up, axis, xp)
    y = fftconvolve(xz, hx, mode="full", axes=(axis,), config=config)
    sl = [slice(None)] * y.ndim
    sl[axis] = slice(shift * down, shift * down + (L - 1) * down + 1, down)
    out = y[tuple(sl)]
    if is_np and out.dtype != want:
        out = out.astype(want)
    return out


def resample_poly(x, up: int, down: int, axis: int = 0,
                  window=("kaiser", 5.0), padtype: str = "constant",
                  cval: float | None = None, *,
                  config: PlanConfig | None = None):
    """Polyphase resampling by the rational factor up/down
    (scipy.signal.resample_poly-compatible: same firwin kaiser design,
    group-delay centering, padtype background handling)."""
    if up != int(up) or down != int(down):
        raise ValueError("up and down must be integers")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    if cval is not None and padtype != "constant":
        raise ValueError("cval has no effect when padtype is " + padtype)
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    axis = axis % x.ndim

    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == down == 1:
        return xp.array(x, copy=True)
    n_in = x.shape[axis]
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    if isinstance(window, (list, np.ndarray, jax.Array)):
        h = np.asarray(window, np.float64).copy()
        if h.ndim > 1:
            raise ValueError("window must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        # linear-phase lowpass at the tighter of the two rates
        # (host-side f64 design, same discipline as get_window)
        from .design import firwin

        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = np.asarray(firwin(2 * half_len + 1, 1.0 / max_rate,
                              window=window), np.float64)
    h = h * up

    # zero-pad the filter so output samples land centered on the input
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (_output_len(h.size + n_pre_pad + n_post_pad, n_in, up, down)
           < n_out + n_pre_remove):
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])

    funcs = {"mean": xp.mean, "median": xp.median,
             "minimum": xp.min, "maximum": xp.max}
    kwargs = {"mode": "constant", "cval": 0.0}
    background = None
    if padtype in funcs:
        background = funcs[padtype](x, axis=axis, keepdims=True)
        x = x - background.astype(x.dtype)
    elif padtype in _UPFIRDN_MODES:
        kwargs = {"mode": padtype,
                  "cval": 0.0 if cval is None else cval}
    else:
        raise ValueError(
            "padtype must be one of: maximum, mean, median, minimum, "
            + ", ".join(_UPFIRDN_MODES))

    y = upfirdn(h, x, up, down, axis=axis, config=config, **kwargs)
    keep = [slice(None)] * y.ndim
    keep[axis] = slice(n_pre_remove, n_pre_remove + n_out)
    y = y[tuple(keep)]
    if background is not None:
        y = y + background.astype(y.dtype)
    return y


def decimate(x, q: int, n: int | None = None, ftype: str = "iir",
             axis: int = -1, zero_phase: bool = True, *,
             config: PlanConfig | None = None):
    """Downsample after an anti-aliasing filter
    (scipy.signal.decimate-compatible).

    ftype='fir': order-20q hamming firwin; zero_phase aligns the group
    delay via the resample_poly path (scipy's own definition). ftype='iir':
    order-8 Chebyshev-I, run through :func:`tpufft.iir.sosfiltfilt`
    (zero_phase) or :func:`tpufft.iir.sosfilt` — the IIR recurrence runs
    as a parallel associative scan on device (see tpufft/iir.py)."""
    import operator

    q = operator.index(q)
    if q < 1:
        raise ValueError("q must be a positive integer")
    if n is not None:
        n = operator.index(n)
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    axis = axis % x.ndim

    if ftype == "fir":
        from .design import firwin

        if n is None:
            n = 2 * (10 * q)
        b = np.asarray(firwin(n + 1, 1.0 / q, window="hamming"),
                       np.float64)
        if zero_phase:
            return resample_poly(x, 1, q, axis=axis, window=b,
                                 config=config)
        n_out = x.shape[axis] // q + bool(x.shape[axis] % q)
        y = upfirdn(b, x, up=1, down=q, axis=axis, config=config)
        sl = [slice(None)] * y.ndim
        sl[axis] = slice(None, n_out)
        return y[tuple(sl)]
    if ftype == "iir":
        from .design import cheby1

        from .iir import sosfilt, sosfiltfilt

        if n is None:
            n = 8
        sos = np.asarray(cheby1(n, 0.05, 0.8 / q, output="sos"),
                         np.float64)
        if zero_phase:
            y = sosfiltfilt(sos, x, axis=axis)
        else:
            y = sosfilt(sos, x, axis=axis)
        sl = [slice(None)] * y.ndim
        sl[axis] = slice(None, None, q)
        return y[tuple(sl)]
    raise ValueError("invalid ftype (expected 'fir' or 'iir')")
