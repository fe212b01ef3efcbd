"""Short-time / averaged spectral analysis (the scipy.signal spectral
surface: stft, istft, spectrogram, periodogram, welch, csd, coherence,
get_window).

Beyond reference parity: the reference (martinvuyk/hackathon-fft) stops at
raw transforms; this layer is the standard consumer of batched FFTs and is
where the framework's batching story pays off.

Design:
* Framing is ONE batched gather — segments become an axis of a
  (..., n_seg, nperseg) array, so the whole STFT is a single batched
  transform.
* Complex math runs on split re/im float planes (`core.SplitComplex`),
  and pointwise spectral ops (conj-multiply for csd, |X|^2 for PSD) are
  two elementwise expressions XLA fuses into the surrounding passes.
* Windows / frequency / time vectors are float64 host precomputes (same
  discipline as twiddle.py); window resolution delegates to
  scipy.signal.get_window at plan time (host-only, never traced).

IO contract follows the package convention: numpy in -> numpy out (f64
callers under x64 keep 1e-12 parity with scipy), jax in -> device-resident
complex out (never a hidden device->host transfer).
"""

from __future__ import annotations

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np

import functools

from .config import PlanConfig
from .core import SplitComplex
from . import api

__all__ = ["get_window", "stft", "istft", "spectrogram", "periodogram",
           "welch", "csd", "coherence", "check_NOLA", "check_COLA",
           "lombscargle"]


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window vector by name/tuple (scipy.signal.get_window-compatible —
    windows are host-side f64 plan constants). The common window set is
    implemented natively (windows.py) so default spectral arguments work
    on a jax+numpy-only install; exotic windows (chebwin, dpss, taylor)
    use scipy when installed."""
    from .windows import get_window as _gw

    return _gw(window, Nx, fftbins=fftbins)


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Nonzero-overlap-add check (scipy.signal.check_NOLA-compatible):
    istft can invert an stft iff the squared-window OLA never vanishes."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if noverlap < 0:
        raise ValueError("noverlap must be a nonnegative integer")
    win = _resolve_window(window, nperseg)
    step = nperseg - noverlap
    binsums = np.sum(
        [win[ii * step:(ii + 1) * step] ** 2 for ii in
         range(nperseg // step)], axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += win[-(nperseg % step):] ** 2
    return bool(np.min(binsums) > tol * np.median(binsums))


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Constant-overlap-add check (scipy.signal.check_COLA-compatible)."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if noverlap < 0:
        raise ValueError("noverlap must be a nonnegative integer")
    win = _resolve_window(window, nperseg)
    step = nperseg - noverlap
    binsums = np.sum(
        [win[ii * step:(ii + 1) * step] for ii in range(nperseg // step)],
        axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += win[-(nperseg % step):]
    deviation = binsums - np.median(binsums)
    return bool(np.max(np.abs(deviation)) < tol)


# ----------------------------------------------------------------------------
# plumbing: windows, framing, plane-based complex views


def _resolve_window(window, nperseg: int) -> np.ndarray:
    if isinstance(window, (str, tuple)):
        return get_window(window, int(nperseg))
    win = np.asarray(window, np.float64)
    if win.ndim != 1:
        raise ValueError("window must be 1-D")
    if win.shape[0] != nperseg:
        raise ValueError("window length does not match nperseg")
    return win


def _triage_segments(window, nperseg, input_length: int):
    """scipy._spectral_py._triage_segments semantics: window arrays pin
    nperseg; over-long nperseg shrinks to the input with a warning."""
    if isinstance(window, (str, tuple)):
        nperseg = 256 if nperseg is None else int(nperseg)
        if nperseg > input_length:
            warnings.warn(
                f"nperseg = {nperseg} is greater than input length "
                f"= {input_length}, using nperseg = {input_length}")
            nperseg = input_length
        win = get_window(window, nperseg)
    else:
        win = np.asarray(window, np.float64)
        if win.ndim != 1:
            raise ValueError("window must be 1-D")
        if input_length < win.shape[0]:
            raise ValueError("window is longer than input signal")
        if nperseg is None:
            nperseg = win.shape[0]
        elif int(nperseg) != win.shape[0]:
            raise ValueError("value specified for nperseg is different"
                             " from length of window")
        nperseg = win.shape[0]
    return win, nperseg


def _is_jax(x) -> bool:
    return isinstance(x, (jax.Array, SplitComplex))


def _split(x, xp):
    """-> (re, im|None) planes in xp from numpy/jax/SplitComplex input."""
    if isinstance(x, SplitComplex):
        return x.re, x.im
    a = xp.asarray(x)
    if np.issubdtype(np.dtype(a.dtype), np.complexfloating):
        if xp is np:
            return (np.ascontiguousarray(a.real),
                    np.ascontiguousarray(a.imag))
        return jnp.real(a), jnp.imag(a)
    return a, None


def _pack_complex(re, im, xp, want_np: bool):
    """Planes -> the caller-facing complex flavor."""
    if xp is np:
        return re + 1j * im
    out = jax.lax.complex(re, im)
    return np.asarray(out) if want_np else out


_EXT_KINDS = ("even", "odd", "constant", "zeros", None)


def _extend(re, im, n_ext: int, boundary, xp):
    """Boundary extension by n_ext samples on both ends of the last axis
    (scipy's even/odd/constant/zero extensions)."""
    if boundary is None or n_ext == 0:
        return re, im

    def ext(a):
        if boundary == "zeros":
            pad = [(0, 0)] * (a.ndim - 1) + [(n_ext, n_ext)]
            return xp.pad(a, pad)
        if boundary == "constant":
            pad = [(0, 0)] * (a.ndim - 1) + [(n_ext, n_ext)]
            return xp.pad(a, pad, mode="edge")
        head = a[..., 1:n_ext + 1][..., ::-1]
        tail = a[..., -(n_ext + 1):-1][..., ::-1]
        if boundary == "even":
            return xp.concatenate([head, a, tail], axis=-1)
        # odd: point-reflect about the edge samples
        return xp.concatenate(
            [2 * a[..., :1] - head, a, 2 * a[..., -1:] - tail], axis=-1)

    return ext(re), None if im is None else ext(im)


def _frame(a, nperseg: int, step: int, xp):
    """(..., n) -> (..., n_seg, nperseg): one batched gather."""
    n = a.shape[-1]
    nseg = 1 + (n - nperseg) // step
    if xp is np:
        idx = (np.arange(nperseg)[None, :]
               + step * np.arange(nseg)[:, None])
        return a[..., idx]
    idx = (jnp.arange(nperseg)[None, :]
           + step * jnp.arange(nseg)[:, None])
    return a[..., idx]


def _detrend_seg(re, im, detrend, xp):
    """Per-segment detrend along the last axis (linear ops -> applied to
    each plane independently)."""
    if detrend is False or detrend is None:
        return re, im
    if callable(detrend):
        return detrend(re), None if im is None else detrend(im)
    if detrend == "constant":
        f = lambda a: a - xp.mean(a, axis=-1, keepdims=True)
    elif detrend == "linear":
        n = re.shape[-1]
        t = xp.arange(n, dtype=re.dtype) - (n - 1) / 2.0

        def f(a):
            mean = xp.mean(a, axis=-1, keepdims=True)
            slope = (xp.sum(a * t, axis=-1, keepdims=True)
                     / xp.sum(t * t))
            return a - mean - slope * t
    else:
        raise ValueError(f"unknown detrend {detrend!r}")
    return f(re), None if im is None else f(im)


def _transform_segments(re, im, nfft: int, onesided: bool,
                        config: PlanConfig | None, xp):
    """Batched per-segment DFT of the last axis -> spectrum planes.

    One call = one batched transform over every segment of every batch
    row."""
    if onesided:
        assert im is None
        X = api.rfft(re, n=nfft, axis=-1, config=config)
    elif xp is np:
        X = api.fft(re if im is None else re + 1j * im, n=nfft, axis=-1,
                    config=config)
    else:
        x = SplitComplex(re, jnp.zeros_like(re) if im is None else im)
        X = api.fft(x, n=nfft, axis=-1, config=config)
    return _split(X, xp)


def _spectral_helper(x, y, fs, window, nperseg, noverlap, nfft, detrend,
                     return_onesided, scaling, axis, mode, boundary,
                     padded, config):
    """The shared stft/psd engine (scipy._spectral_helper semantics,
    split-plane execution). Returns (freqs, t, (re, im|None), xp,
    want_np, onesided)."""
    if boundary not in _EXT_KINDS:
        raise ValueError(
            f"Unknown boundary option '{boundary}', must be one of "
            f"{list(_EXT_KINDS)}")
    same_data = y is x
    axis = int(axis)

    is_np_x = not _is_jax(x)
    xp = np if is_np_x and (same_data or not _is_jax(y)) else jnp
    want_np = xp is np

    xre, xim = _split(x, xp)
    if not same_data:
        yre, yim = _split(y, xp)
        # scipy zero-pads the shorter signal along axis
        ax = axis % max(xre.ndim, yre.ndim)
        nx, ny = xre.shape[ax], yre.shape[ax]
        if nx != ny:
            def padto(a, n_to, ax_):
                pad = [(0, 0)] * a.ndim
                pad[ax_] = (0, n_to - a.shape[ax_])
                return xp.pad(a, pad)
            if nx < ny:
                xre = padto(xre, ny, ax)
                xim = None if xim is None else padto(xim, ny, ax)
            else:
                yre = padto(yre, nx, ax)
                yim = None if yim is None else padto(yim, nx, ax)
    else:
        yre = yim = None

    complex_in = xim is not None or (not same_data and yim is not None)
    onesided = bool(return_onesided)
    if onesided and complex_in:
        warnings.warn("Input data is complex, switching to "
                      "return_onesided=False")
        onesided = False

    ndim = xre.ndim
    axis = axis % ndim
    moved = axis != ndim - 1
    if moved:
        xre = xp.moveaxis(xre, axis, -1)
        xim = None if xim is None else xp.moveaxis(xim, axis, -1)
        if not same_data:
            yre = xp.moveaxis(yre, axis, -1)
            yim = None if yim is None else xp.moveaxis(yim, axis, -1)

    n_in = xre.shape[-1]
    win, nperseg = _triage_segments(window, nperseg, n_in)
    if noverlap is None:
        noverlap = nperseg // 2
    else:
        noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be greater than or equal to nperseg.")
    step = nperseg - noverlap

    if scaling == "density":
        scale = 1.0 / (fs * (win * win).sum())
    elif scaling == "spectrum":
        scale = 1.0 / win.sum() ** 2
    else:
        raise ValueError(f"Unknown scaling: {scaling!r}")
    if mode == "stft":
        scale = math.sqrt(scale)

    def run(re, im):
        re, im = _extend(re, im, nperseg // 2, boundary, xp)
        n_ext = re.shape[-1]
        if padded:
            nadd = (-(n_ext - nperseg) % step) % nperseg
            if nadd:
                pad = [(0, 0)] * (re.ndim - 1) + [(0, nadd)]
                re = xp.pad(re, pad)
                im = None if im is None else xp.pad(im, pad)
        re = _frame(re, nperseg, step, xp)
        im = None if im is None else _frame(im, nperseg, step, xp)
        re, im = _detrend_seg(re, im, detrend, xp)
        if xp is np:
            w = win.astype(re.dtype)
        else:
            w = jnp.asarray(win).astype(re.dtype)
        re = re * w
        im = None if im is None else im * w
        return _transform_segments(re, im, nfft, onesided and im is None,
                                   config, xp)

    Xr, Xi = run(xre, xim)
    if same_data:
        Yr, Yi = Xr, Xi
    else:
        Yr, Yi = run(yre, yim)

    if mode == "stft":
        Rr, Ri = Xr * scale, (None if Xi is None else Xi * scale)
        if Ri is None:
            Ri = xp.zeros_like(Rr)
    else:  # psd: conj(X) * Y
        if Xi is None:
            Xi = xp.zeros_like(Xr)
        if Yi is None:
            Yi = xp.zeros_like(Yr)
        Rr = (Xr * Yr + Xi * Yi) * scale
        Ri = None if same_data else (Xr * Yi - Xi * Yr) * scale
    if mode != "stft" and onesided:
        # double the interior bins (the energy of the dropped
        # conjugate half); DC and (even-nfft) Nyquist stay single
        hi = Rr.shape[-1] - (1 if nfft % 2 == 0 else 0)

        def dbl(a):
            head = a[..., :1]
            mid = a[..., 1:hi] * 2
            tail = a[..., hi:]
            return xp.concatenate([head, mid, tail], axis=-1)
        Rr = dbl(Rr)
        Ri = None if Ri is None else dbl(Ri)

    nseg = Rr.shape[-2]
    if onesided:
        freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    else:
        freqs = np.fft.fftfreq(nfft, 1.0 / fs)
    t = (np.arange(nseg) * step + nperseg / 2.0) / fs
    if boundary is not None:
        t -= (nperseg / 2.0) / fs

    # (..., nseg, nfreq) -> freq back on the data axis, time trailing
    def place(a):
        a = xp.swapaxes(a, -1, -2)
        if moved:
            a = xp.moveaxis(a, -2, axis)
        return a

    Rr = place(Rr)
    Ri = None if Ri is None else place(Ri)
    return freqs, t, (Rr, Ri), xp, want_np, onesided


# ----------------------------------------------------------------------------
# public surface


def stft(x, fs: float = 1.0, window="hann", nperseg: int | None = 256,
         noverlap: int | None = None, nfft: int | None = None,
         detrend=False, return_onesided: bool = True, boundary="zeros",
         padded: bool = True, axis: int = -1, scaling: str = "spectrum",
         *, config: PlanConfig | None = None):
    """Short-time Fourier transform (scipy.signal.stft-compatible):
    returns (f, t, Zxx) with the frequency axis at ``axis`` and segment
    times trailing. The whole STFT is ONE batched transform."""
    if scaling == "psd":
        sc = "density"
    elif scaling == "spectrum":
        sc = "spectrum"
    else:
        raise ValueError(f"Parameter scaling={scaling!r} not in "
                         "['spectrum', 'psd']")
    freqs, t, (Rr, Ri), xp, want_np, _ = _spectral_helper(
        x, x, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, sc, axis, "stft", boundary, padded, config)
    Z = _pack_complex(Rr, Ri, xp, want_np)
    return freqs, t, Z


def istft(Zxx, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          input_onesided: bool = True, boundary: bool = True,
          time_axis: int = -1, freq_axis: int = -2,
          scaling: str = "spectrum", *,
          config: PlanConfig | None = None):
    """Inverse STFT via windowed overlap-add
    (scipy.signal.istft-compatible): returns (t, x). The batched inverse
    transform is one batched call; the overlap-add is one scatter-add."""
    xp = jnp if _is_jax(Zxx) else np
    want_np = xp is np
    Zr, Zi = _split(Zxx, xp)
    if Zi is None:
        Zi = xp.zeros_like(Zr)
    if Zr.ndim < 2:
        raise ValueError("Input stft must be at least 2d!")
    ndim = Zr.ndim
    time_axis = time_axis % ndim
    freq_axis = freq_axis % ndim
    if time_axis == freq_axis:
        raise ValueError("Must specify differing time and frequency axes!")

    n_freq = Zr.shape[freq_axis]
    if input_onesided:
        n_default = 2 * (n_freq - 1)
    else:
        n_default = n_freq
    if nperseg is None:
        nperseg = n_default
    else:
        nperseg = int(nperseg)
        if nperseg < 1:
            raise ValueError("nperseg must be a positive integer")
    if nfft is None:
        if input_onesided and nperseg == n_default + 1:
            nfft = nperseg  # odd nperseg, onesided
        else:
            nfft = n_default
    elif int(nfft) < nperseg:
        raise ValueError("nfft must be greater than or equal to nperseg.")
    else:
        nfft = int(nfft)
    if noverlap is None:
        noverlap = nperseg // 2
    else:
        noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    step = nperseg - noverlap

    win = _resolve_window(window, nperseg)
    if not check_NOLA(win, nperseg, noverlap):
        # scipy >= 1.15 warns (it used to raise): the division below
        # substitutes 1 for the vanished OLA bins
        warnings.warn("NOLA condition failed, STFT may not be invertible")

    if scaling == "spectrum":
        unscale = win.sum()
    elif scaling == "psd":
        unscale = math.sqrt(fs * (win * win).sum())
    else:
        raise ValueError(f"Parameter scaling={scaling!r} not in "
                         "['spectrum', 'psd']")

    # -> (..., nseg, nfreq)
    Zr = xp.moveaxis(Zr, (freq_axis, time_axis), (-1, -2))
    Zi = xp.moveaxis(Zi, (freq_axis, time_axis), (-1, -2))
    nseg = Zr.shape[-2]

    if input_onesided:
        if want_np:
            xsub = api.irfft(Zr + 1j * Zi, n=nfft, axis=-1, config=config)
        else:
            xsub = api.irfft(SplitComplex(Zr, Zi), n=nfft, axis=-1,
                             config=config).re
        xsub_i = None
    else:
        if want_np:
            z = api.ifft(Zr + 1j * Zi, n=nfft, axis=-1, config=config)
            xsub, xsub_i = np.ascontiguousarray(z.real), \
                np.ascontiguousarray(z.imag)
        else:
            out = api.ifft(SplitComplex(Zr, Zi), n=nfft, axis=-1,
                           config=config)
            xsub, xsub_i = out.re, out.im
    xsub = xsub[..., :nperseg] * unscale
    if xsub_i is not None:
        xsub_i = xsub_i[..., :nperseg] * unscale

    n_out = nperseg + (nseg - 1) * step
    wj = win if xp is np else xp.asarray(win.astype(np.float32))
    lead = xsub.shape[:-2]

    def ola(seg):
        seg = seg * (wj.astype(seg.dtype) if xp is np else wj)
        if xp is np:
            out = np.zeros(lead + (n_out,), seg.dtype)
            idx = (np.arange(nperseg)[None, :]
                   + step * np.arange(nseg)[:, None])
            np.add.at(out, (..., idx.reshape(-1)),
                      seg.reshape(lead + (-1,)))
            return out
        idx = (jnp.arange(nperseg)[None, :]
               + step * jnp.arange(nseg)[:, None]).reshape(-1)
        out = jnp.zeros(lead + (n_out,), seg.dtype)
        return out.at[..., idx].add(seg.reshape(lead + (-1,)))

    xout = ola(xsub)
    xout_i = None if xsub_i is None else ola(xsub_i)
    normw = np.zeros(n_out)
    idxh = (np.arange(nperseg)[None, :]
            + step * np.arange(nseg)[:, None]).reshape(-1)
    np.add.at(normw, idxh, np.tile(win ** 2, nseg))
    norm = np.where(normw > 1e-10, normw, 1.0)
    normj = norm if xp is np else xp.asarray(norm.astype(np.float32))
    xout = xout / (normj.astype(xout.dtype) if xp is np else normj)
    if xout_i is not None:
        xout_i = xout_i / (normj.astype(xout_i.dtype) if xp is np
                           else normj)

    if boundary:
        half = nperseg // 2
        xout = xout[..., half:n_out - half]
        if xout_i is not None:
            xout_i = xout_i[..., half:n_out - half]

    t = np.arange(xout.shape[-1]) / fs
    # put the reconstructed axis back at the (freq-axis-consumed-adjusted)
    # time-axis position — scipy.istft axis contract
    if xout.ndim > 0 and Zr.ndim - 2 > 0 and time_axis != ndim - 1:
        ta = time_axis - 1 if freq_axis < time_axis else time_axis
        xout = xp.moveaxis(xout, -1, ta)
        if xout_i is not None:
            xout_i = xp.moveaxis(xout_i, -1, ta)
    if xout_i is not None:
        xres = _pack_complex(xout, xout_i, xp, want_np)
    else:
        xres = xout
    return t, xres


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: int | None = None, noverlap: int | None = None,
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, mode: str = "psd", *,
                config: PlanConfig | None = None):
    """Spectrogram (scipy.signal.spectrogram-compatible): returns
    (f, t, Sxx) with segment times on the last axis."""
    modelist = ["psd", "complex", "magnitude", "angle", "phase"]
    if mode not in modelist:
        raise ValueError(f"unknown value for mode {mode}, must be one of "
                         f"{modelist}")
    if mode == "psd":
        helper_mode = "psd"
    else:
        helper_mode = "stft"
    # scipy: nperseg defaults via triage, noverlap = nperseg // 8
    if noverlap is None:
        n_in = np.shape(x)[axis] if not isinstance(x, SplitComplex) \
            else x.re.shape[axis]
        _, nperseg_r = _triage_segments(window, nperseg, n_in)
        noverlap = nperseg_r // 8
    freqs, t, (Rr, Ri), xp, want_np, _ = _spectral_helper(
        x, x, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, helper_mode, None, False, config)
    if mode == "psd":
        S = np.asarray(Rr) if want_np else Rr
        return freqs, t, S
    if mode == "complex":
        return freqs, t, _pack_complex(Rr, Ri, xp, want_np)
    if mode == "magnitude":
        S = xp.sqrt(Rr * Rr + Ri * Ri)
        return freqs, t, (np.asarray(S) if want_np and xp is not np else S)
    # angle / phase
    ang = xp.arctan2(Ri, Rr)
    if mode == "phase":
        # unwrap along the time (last) axis
        ang = xp.unwrap(ang, axis=-1)
    return freqs, t, (np.asarray(ang) if want_np and xp is not np else ang)


def _median_bias(n: int) -> float:
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def csd(x, y, fs: float = 1.0, window="hann", nperseg: int | None = None,
        noverlap: int | None = None, nfft: int | None = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", axis: int = -1, average: str = "mean",
        *, config: PlanConfig | None = None):
    """Cross power spectral density Pxy by Welch's method
    (scipy.signal.csd-compatible)."""
    if average not in ("mean", "median"):
        raise ValueError(f"average must be 'mean' or 'median', got "
                         f"{average!r}")
    same = y is x
    freqs, _, (Rr, Ri), xp, want_np, _ = _spectral_helper(
        x, y, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, "psd", None, False, config)
    # average over the trailing (segment-time) axis
    if Rr.ndim >= 2 and Rr.shape[-1] > 1:
        if average == "median":
            bias = _median_bias(Rr.shape[-1])
            Rr = xp.median(Rr, axis=-1) / bias
            Ri = None if Ri is None else xp.median(Ri, axis=-1) / bias
        else:
            Rr = xp.mean(Rr, axis=-1)
            Ri = None if Ri is None else xp.mean(Ri, axis=-1)
    else:
        Rr = Rr.reshape(Rr.shape[:-1])
        Ri = None if Ri is None else Ri.reshape(Ri.shape[:-1])
    if same and Ri is None:
        P = np.asarray(Rr) if want_np and xp is not np else Rr
        return freqs, P
    if Ri is None:
        Ri = xp.zeros_like(Rr)
    return freqs, _pack_complex(Rr, Ri, xp, want_np)


def welch(x, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", axis: int = -1,
          average: str = "mean", *, config: PlanConfig | None = None):
    """Power spectral density by Welch's method
    (scipy.signal.welch-compatible): returns (f, Pxx)."""
    freqs, Pxx = csd(x, x, fs=fs, window=window, nperseg=nperseg,
                     noverlap=noverlap, nfft=nfft, detrend=detrend,
                     return_onesided=return_onesided, scaling=scaling,
                     axis=axis, average=average, config=config)
    if isinstance(Pxx, SplitComplex):
        return freqs, Pxx.re
    xp = np if isinstance(Pxx, np.ndarray) else jnp
    if np.issubdtype(np.dtype(Pxx.dtype), np.complexfloating):
        Pxx = xp.real(Pxx)
    return freqs, Pxx


def periodogram(x, fs: float = 1.0, window="boxcar",
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, *, config: PlanConfig | None = None):
    """Periodogram PSD estimate (scipy.signal.periodogram-compatible):
    one full-length segment through welch."""
    if window is None:
        window = "boxcar"
    n = (x.re.shape[axis] if isinstance(x, SplitComplex)
         else np.shape(x)[axis])
    if nfft is None:
        nperseg = n
    elif nfft == n:
        nperseg = nfft
    elif nfft > n:
        nperseg = n
    else:  # nfft < n: crop (scipy semantics)
        if isinstance(x, SplitComplex):
            sl = [slice(None)] * x.re.ndim
            sl[axis % x.re.ndim] = slice(0, nfft)
            x = SplitComplex(x.re[tuple(sl)], x.im[tuple(sl)])
        else:
            sl = [slice(None)] * np.ndim(x)
            sl[axis % np.ndim(x)] = slice(0, nfft)
            x = x[tuple(sl)]
        nperseg = nfft
        nfft = None
    return welch(x, fs=fs, window=window, nperseg=nperseg, noverlap=0,
                 nfft=nfft, detrend=detrend,
                 return_onesided=return_onesided, scaling=scaling,
                 axis=axis, config=config)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: int | None = None, noverlap: int | None = None,
              nfft: int | None = None, detrend="constant", axis: int = -1,
              *, config: PlanConfig | None = None):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy)
    (scipy.signal.coherence-compatible)."""
    freqs, Pxx = welch(x, fs=fs, window=window, nperseg=nperseg,
                       noverlap=noverlap, nfft=nfft, detrend=detrend,
                       axis=axis, config=config)
    _, Pyy = welch(y, fs=fs, window=window, nperseg=nperseg,
                   noverlap=noverlap, nfft=nfft, detrend=detrend,
                   axis=axis, config=config)
    _, Pxy = csd(x, y, fs=fs, window=window, nperseg=nperseg,
                 noverlap=noverlap, nfft=nfft, detrend=detrend, axis=axis,
                 config=config)
    if isinstance(Pxy, SplitComplex):
        mag2 = Pxy.re * Pxy.re + Pxy.im * Pxy.im
    else:
        xp = np if isinstance(Pxy, np.ndarray) else jnp
        mag2 = xp.abs(Pxy) ** 2
    Cxy = mag2 / Pxx / Pyy
    return freqs, Cxy


# ---------------------------------------------------------------------------
# Lomb-Scargle periodogram (unevenly sampled data)
# ---------------------------------------------------------------------------

_NOVALUE = object()


def _ls_core(xv, yv, wv, freqs, floating_mean: bool, mode: str, xp):
    """Generalized Lomb-Scargle (Zechmeister & Kuerster 2009) sums.

    One (N, F) trig tile + weighted matvecs; the tau rotation reuses the
    first trig tile (cos(t - tau) via the angle-difference identity)
    instead of a second transcendental pass.  Returns (a, b, tau,
    pgram_power, YY).
    """
    def mv(v, m):
        if xp is np:
            return v @ m
        return jnp.matmul(v, m, precision=jax.lax.Precision.HIGHEST)

    w = wv / xp.sum(wv)
    wy = w * yv
    theta = xv[:, None] * freqs[None, :]          # (N, F)
    cos = xp.cos(theta)
    sin = xp.sin(theta)
    CC = mv(w, cos * cos)
    CS = mv(w, cos * sin)
    SS = 1.0 - CC
    Y = xp.sum(wy)
    if floating_mean:
        C = mv(w, cos)
        S = mv(w, sin)
        CC = CC - C * C
        SS = SS - S * S
        CS = CS - C * S
    tau = 0.5 * xp.arctan2(2.0 * CS, CC - SS)
    ct, st = xp.cos(tau), xp.sin(tau)
    cos_t = cos * ct[None, :] + sin * st[None, :]  # cos(theta - tau)
    sin_t = sin * ct[None, :] - cos * st[None, :]
    YC = mv(wy, cos_t)
    YS = mv(wy, sin_t)
    CC = mv(w, cos_t * cos_t)
    SS = 1.0 - CC
    if floating_mean:
        C = mv(w, cos_t)
        S = mv(w, sin_t)
        YC = YC - Y * C
        YS = YS - Y * S
        CC = CC - C * C
        SS = SS - S * S
    eps = xp.finfo(yv.dtype).epsneg if xp is np else float(
        np.finfo(np.dtype(yv.dtype)).epsneg)
    CC = xp.maximum(CC, eps)
    SS = xp.maximum(SS, eps)
    a = YC / CC
    b = YS / SS
    power = 2.0 * (a * YC + b * YS)
    YY = xp.sum(wy * yv)
    if floating_mean:
        YY = YY - Y * Y
    return a, b, tau, power, YY


@functools.partial(jax.jit, static_argnames=("floating_mean", "mode"))
def _ls_device(xv, yv, wv, freqs, floating_mean: bool, mode: str):
    a, b, tau, power, YY = _ls_core(xv, yv, wv, freqs, floating_mean,
                                    mode, jnp)
    if mode == "power":
        return power * (xv.shape[0] / 4.0)
    if mode == "normalize":
        return power * (0.5 / YY)
    # amplitude: (a + ib) e^{i tau}, as planes
    ct, st = jnp.cos(tau), jnp.sin(tau)
    return a * ct - b * st, a * st + b * ct


def lombscargle(x, y, freqs, *, precenter=_NOVALUE, normalize=False,
                weights=None, floating_mean: bool = False):
    """Lomb-Scargle periodogram for unevenly sampled data
    (scipy.signal.lombscargle-compatible, incl. the generalized
    floating-mean / weighted form and the 'power'/'normalize'/'amplitude'
    output modes).

    numpy in -> host f64 numpy out (scipy-exact); jax in -> the whole
    O(N*F) trig tile and its weighted reductions run jitted on device,
    returning a device array.  No counterpart in the
    reference (martinvuyk/hackathon-fft); parity target is
    scipy/signal/_spectral_py.py:lombscargle.
    """
    device = _is_jax(x) or _is_jax(y) or _is_jax(freqs)
    xp = jnp if device else np
    if isinstance(normalize, bool):
        mode = "normalize" if normalize else "power"
    else:
        mode = normalize
    if mode not in ("power", "normalize", "amplitude"):
        raise ValueError("normalize must be False ('power'), True "
                         "('normalize'), or 'amplitude'")
    if weights is None:
        wv = np.ones(np.shape(y), np.float64)
    else:
        wv = np.asarray(weights, np.float64) if not _is_jax(weights) \
            else weights
        if not _is_jax(wv) and not (np.all(wv >= 0) and np.sum(wv) > 0):
            # validate host-side whenever the weights themselves are host
            # data — even when x/y are device arrays (the common mixed
            # case); jax-array weights cannot be value-checked without a
            # device sync and remain the caller's contract
            raise ValueError("weights must be non-negative and sum to a "
                             "positive value")
    xv = xp.asarray(x)
    yv = xp.asarray(y)
    fv = xp.asarray(freqs)
    if not device:
        xv = xv.astype(np.float64)
        yv = yv.astype(np.float64)
        fv = fv.astype(np.float64)
    wv = xp.asarray(wv)
    if not (xv.ndim == 1 and xv.size > 0
            and xv.shape == yv.shape == wv.shape):
        raise ValueError("x, y, weights must be 1-D arrays of equal "
                         "non-zero length")
    if not (fv.ndim == 1 and fv.size > 0):
        raise ValueError("freqs must be a 1-D array of non-zero length")
    if precenter is not _NOVALUE:
        warnings.warn("'precenter' is deprecated (scipy 1.17): pass "
                      "y - y.mean() or use floating_mean=True",
                      DeprecationWarning, stacklevel=2)
        if precenter:
            yv = yv - yv.mean()

    if device:
        out = _ls_device(xv, yv, wv, fv, bool(floating_mean), mode)
        if mode != "amplitude":
            return out
        re, im = out
        return re + 1j * im

    a, b, tau, power, YY = _ls_core(xv, yv, wv, fv, bool(floating_mean),
                                    mode, np)
    if mode == "power":
        return power * (xv.shape[0] / 4.0)
    if mode == "normalize":
        return power * (0.5 / YY)
    return (a + 1j * b) * np.exp(1j * tau)
