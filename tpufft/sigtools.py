"""scipy.signal utility surface: detrend, deconvolve, wiener,
correlation_lags, choose_conv_method.

Beyond reference parity (the reference stops at raw transforms); these
are the small scipy.signal companions users of the convolution/spectral
layers expect. Notes: ``wiener``'s local moments run through this
package's FFT convolution (one convolution per moment);
``detrend``'s piecewise fits are tiny host/XLA least-squares per
breakpoint segment (segment count is static); ``deconvolve`` is an
inherently sequential polynomial long division — it runs as a host
recurrence and is documented as such (scipy semantics: quotient =
lfilter(num, den, impulse)).

scipy parity targets: scipy/signal/_signaltools.py (deconvolve's
lfilter identity, wiener's moment/threshold schedule,
correlation_lags index math, choose_conv_method contract) and
scipy/signal/_signaltools.py detrend (per-segment lstsq design matrix
[arange(1, N+1)/N, 1]).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .config import PlanConfig

__all__ = ["detrend", "deconvolve", "wiener", "correlation_lags",
           "choose_conv_method", "savgol_filter", "savgol_coeffs",
           "convolve", "convolve2d", "correlate2d",
           "order_filter", "medfilt", "medfilt2d", "vectorstrength"]


def detrend(data, axis: int = -1, type: str = "linear", bp=0,
            overwrite_data: bool = False):
    """Remove a constant or piecewise-linear trend
    (scipy.signal.detrend-compatible, including breakpoints ``bp``)."""
    if type not in ("linear", "l", "constant", "c"):
        raise ValueError("Trend type must be 'linear' or 'constant'.")
    is_np = not isinstance(data, jax.Array)
    xp = np if is_np else jnp
    data = xp.asarray(data)
    if not np.issubdtype(np.dtype(data.dtype), np.inexact):
        data = data.astype(np.float64 if is_np else jnp.float32)
    if type in ("constant", "c"):
        return data - xp.mean(data, axis=axis, keepdims=True)

    shape = data.shape
    ndim = data.ndim
    axis = axis % ndim
    N = shape[axis]
    bp = np.sort(np.unique(np.concatenate(
        [np.atleast_1d(np.asarray(v, np.intp)) for v in (0, bp, N)])))
    if np.any(bp > N):
        raise ValueError("Breakpoints must be less than length of data "
                         "along given axis.")

    newdata = xp.moveaxis(data, axis, 0).reshape(N, -1)
    fdt = np.float64 if is_np else np.dtype(data.dtype)
    pieces = []
    for m in range(len(bp) - 1):
        npts = int(bp[m + 1] - bp[m])
        # scipy's design matrix: [arange(1, Npts+1)/Npts, 1]
        A = np.ones((npts, 2), fdt)
        A[:, 0] = np.arange(1, npts + 1, dtype=np.float64) / npts
        seg = newdata[int(bp[m]):int(bp[m + 1])]
        if xp is np:
            coef, *_ = np.linalg.lstsq(A, seg, rcond=None)
            pieces.append(seg - A @ coef)
        else:
            # the projector A @ pinv(A) is a host f64 plan constant; the
            # two device matmuls run at HIGHEST precision (a default-
            # precision f32 dot may run in TF32 on the GPU and cost
            # ~3 decimal digits on the fitted trend)
            pinv = np.linalg.pinv(A.astype(np.float64))
            Aj = jnp.asarray(A.astype(np.float32))
            pj = jnp.asarray(pinv.astype(np.float32))
            coef = jnp.dot(pj, seg, precision=jax.lax.Precision.HIGHEST)
            pieces.append(seg - jnp.dot(
                Aj, coef, precision=jax.lax.Precision.HIGHEST))
    out = xp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
    return xp.moveaxis(out.reshape((N,) + shape[:axis]
                                   + shape[axis + 1:]), 0, axis)


def deconvolve(signal, divisor):
    """Polynomial deconvolution: ``signal = convolve(divisor, quotient)
    + remainder`` (scipy.signal.deconvolve-compatible).

    Inherently sequential long division — runs as a host f64 recurrence
    (the quotient is lfilter(num, den, impulse) in scipy's own
    definition); the remainder check is a direct convolution."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if num.ndim != 1 or num.size == 0:
        raise ValueError("Parameter signal must be non-empty 1d array, "
                         f"but its shape is {np.shape(signal)}!")
    if den.ndim != 1 or den.size == 0:
        raise ValueError("Parameter divisor must be non-empty 1d array, "
                         f"but its shape is {np.shape(divisor)}!")
    if den[0] == 0:
        raise ValueError("divisor cannot have a leading zero")
    N, D = num.size, den.size
    if D > N:
        return np.array([]), num.copy()
    n_out = N - D + 1
    quot = np.empty(n_out)
    a = den / den[0]
    for n in range(n_out):
        k = min(n, D - 1)
        acc = num[n] / den[0]
        if k:
            acc -= a[1:k + 1] @ quot[n - 1::-1][:k]
        quot[n] = acc
    rem = num - np.convolve(den, quot, mode="full")
    return quot, rem


def wiener(im, mysize=None, noise=None, *,
           config: PlanConfig | None = None):
    """Adaptive Wiener filter (scipy.signal.wiener-compatible): local
    mean/variance from box sums — each moment is ONE fused FFT
    convolution through the framework's transforms — then the
    noise-thresholded gain."""
    from .signal import fftconvolve

    is_np = not isinstance(im, jax.Array)
    xp = np if is_np else jnp
    im = xp.asarray(im)
    if np.issubdtype(np.dtype(im.dtype), np.complexfloating):
        raise NotImplementedError(
            "complex wiener is not supported (filter re/im separately)")
    if not np.issubdtype(np.dtype(im.dtype), np.inexact):
        im = im.astype(np.float64 if is_np else jnp.float32)
    if mysize is None:
        mysize = [3] * im.ndim
    mysize = np.atleast_1d(np.asarray(mysize, np.intp))
    if mysize.size == 1:
        mysize = np.full(im.ndim, int(mysize[0]), np.intp)
    if mysize.size != im.ndim:
        raise ValueError("mysize must match the input rank")
    size = float(np.prod(mysize))
    box = xp.ones(tuple(int(s) for s in mysize), im.dtype)
    lmean = fftconvolve(im, box, mode="same", config=config) / size
    lvar = (fftconvolve(im * im, box, mode="same", config=config) / size
            - lmean * lmean)
    if noise is None:
        noise = xp.mean(lvar)
    res = (im - lmean) * (1 - noise / lvar) + lmean
    return xp.where(lvar < noise, lmean, res)


@functools.lru_cache(maxsize=64)
def _savgol_edge_projector(window_length: int, polyorder: int,
                           deriv: int, delta: float, halflen: int):
    """The scipy 'interp' edge fit is a LINEAR map window -> values:
    P = polyval(eval_pts) @ D^deriv @ pinv(vander) / delta^deriv — a
    host f64 plan constant (one (halflen, window_length) matrix per
    edge; the right edge uses the same P at mirrored positions)."""
    # fit in the centered/normalized variable t' = (t - c0)/s — the raw
    # Vandermonde at window 31 costs ~1e-9 (cond ~1e8); centered it is
    # ~1e-14. Chain rule: each derivative picks up a 1/s factor.
    t = np.arange(window_length, dtype=np.float64)
    c0 = (window_length - 1) / 2.0
    s = max(c0, 1.0)
    V = np.vander((t - c0) / s, polyorder + 1, increasing=True)
    pinvV = np.linalg.pinv(V)
    # derivative operator on increasing-power coefficients
    coeffs = np.eye(polyorder + 1)
    for _ in range(deriv):
        coeffs = coeffs[1:] * np.arange(1, coeffs.shape[0])[:, None]
    left_pts = np.arange(halflen, dtype=np.float64)
    right_pts = np.arange(window_length - halflen, window_length,
                          dtype=np.float64)

    def proj(pts):
        if coeffs.shape[0] == 0:
            return np.zeros((pts.size, window_length))
        E = np.vander((pts - c0) / s, coeffs.shape[0], increasing=True)
        return (E @ coeffs @ pinvV) / ((delta * s) ** deriv)

    return proj(left_pts), proj(right_pts)


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1,
                  mode: str = "interp", cval: float = 0.0, *,
                  config: PlanConfig | None = None):
    """Savitzky-Golay smoothing/differentiation
    (scipy.signal.savgol_filter-compatible). The FIR core runs as ONE
    batched FFT convolution (coefficients are a host f64 design via
    scipy.signal.savgol_coeffs); 'interp' edge fits are host-f64
    projection matrices applied as two tiny matmuls at HIGHEST device
    precision."""
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError("mode must be 'mirror', 'constant', 'nearest' "
                         "'wrap' or 'interp'.")
    window_length = int(window_length)
    w = savgol_coeffs(window_length, int(polyorder),
                      deriv=int(deriv), delta=float(delta))
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    if not np.issubdtype(np.dtype(x.dtype), np.inexact):
        x = x.astype(np.float64 if is_np else jnp.float32)
    axis = axis % x.ndim
    n = x.shape[axis]
    c = (window_length - 1) // 2
    cr = window_length - 1 - c

    xm = xp.moveaxis(x, axis, -1)

    def pad(a, mode_):
        p = [(0, 0)] * a.ndim
        p[-1] = (c, cr)
        if mode_ == "constant":
            return xp.pad(a, p, constant_values=cval)
        np_mode = {"mirror": "reflect", "nearest": "edge",
                   "wrap": "wrap"}[mode_]
        return xp.pad(a, p, mode=np_mode)

    from .signal import fftconvolve

    shape = [1] * xm.ndim
    shape[-1] = window_length
    wv = (w if is_np else jnp.asarray(w.astype(np.float32))).reshape(
        shape)
    if mode == "interp":
        if window_length > n:
            raise ValueError("If mode is 'interp', window_length must "
                             "be less than or equal to the size of x.")
        # scipy's interp core always zero-pads (cval applies only to
        # the explicit 'constant' mode); the padded-region outputs are
        # overwritten by the edge fits below anyway
        xe = xp.pad(xm, [(0, 0)] * (xm.ndim - 1) + [(c, cr)])
        yc = fftconvolve(xe, wv, mode="full", axes=(-1,), config=config)
        y = yc[..., window_length - 1:window_length - 1 + n]
        halflen = window_length // 2
        Pl, Pr = _savgol_edge_projector(window_length, int(polyorder),
                                        int(deriv), float(delta),
                                        halflen)
        if is_np:
            left = xm[..., :window_length] @ Pl.T
            right = xm[..., n - window_length:] @ Pr.T
        else:
            hp = jax.lax.Precision.HIGHEST
            left = jnp.dot(xm[..., :window_length],
                           jnp.asarray(Pl.T, xm.dtype), precision=hp)
            right = jnp.dot(xm[..., n - window_length:],
                            jnp.asarray(Pr.T, xm.dtype), precision=hp)
        y = xp.concatenate([left.astype(y.dtype),
                            y[..., halflen:n - halflen],
                            right.astype(y.dtype)], axis=-1)
    else:
        xe = pad(xm, mode)
        yc = fftconvolve(xe, wv, mode="full", axes=(-1,), config=config)
        y = yc[..., window_length - 1:window_length - 1 + n]
    return xp.moveaxis(y, -1, axis)


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices for the output of ``correlate``
    (scipy.signal.correlation_lags-compatible)."""
    in1_len, in2_len = int(in1_len), int(in2_len)
    if in1_len < 1 or in2_len < 1:
        raise ValueError("input lengths must be positive")
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - lag_bound:mid + lag_bound]
        return lags[mid - lag_bound:mid + lag_bound + 1]
    if mode == "valid":
        lag_bound = in1_len - in2_len
        if lag_bound >= 0:
            return np.arange(lag_bound + 1)
        return np.arange(lag_bound, 1)
    raise ValueError(f"mode must be full/same/valid, got {mode!r}")


def choose_conv_method(in1, in2, mode: str = "full",
                       measure: bool = False):
    """Advise 'fft' or 'direct' convolution
    (scipy.signal.choose_conv_method-compatible contract: exact-integer
    inputs force 'direct' when the products stay representable;
    ``measure=True`` times both on the actual inputs)."""
    a = np.asarray(in1)
    b = np.asarray(in2)

    def _ints_exact():
        if not (np.issubdtype(a.dtype, np.integer)
                and np.issubdtype(b.dtype, np.integer)):
            return False
        if a.size == 0 or b.size == 0:
            return True
        max_val = int(np.abs(a).max()) * int(np.abs(b).max())
        max_val *= int(min(a.size, b.size))
        return max_val < 2 ** 52  # f64 mantissa: fft stays exact below

    if measure and a.ndim == 1 and b.ndim == 1:
        import timeit

        from .signal import fftconvolve

        times = {}
        times["direct"] = min(timeit.repeat(
            lambda: np.convolve(a, b, mode), number=1, repeat=3))
        times["fft"] = min(timeit.repeat(
            lambda: fftconvolve(a.astype(np.float64),
                                b.astype(np.float64), mode),
            number=1, repeat=3))
        chosen = "fft" if times["fft"] < times["direct"] else "direct"
        return chosen, times
    if measure:
        # N-D measurement falls back to the heuristic (this package has
        # no direct N-D convolver to time; the answer stays advisory)
        choice = choose_conv_method(in1, in2, mode, measure=False)
        return choice, {}
    if (np.issubdtype(a.dtype, np.integer)
            or np.issubdtype(b.dtype, np.integer)):
        return "direct" if not _ints_exact() else (
            "fft" if max(a.size, b.size) > 500 else "direct")
    # float heuristic: direct only for tiny operands
    return "fft" if min(a.size, b.size) > 32 or \
        max(a.size, b.size) > 4096 else "direct"


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv"):
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs-
    compatible): the least-squares polynomial fit over the window is a
    LINEAR map, so the deriv-th derivative at `pos` is one row of the
    Vandermonde pseudo-inverse scaled by deriv!/delta^deriv. Host f64."""
    window_length = int(window_length)
    polyorder = int(polyorder)
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen if rem else halflen - 0.5
    if not 0 <= pos <= window_length - 1:
        raise ValueError("pos must be nonnegative and less than "
                         "window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if int(deriv) > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x ** order
    import math as _math
    y = np.zeros(polyorder + 1)
    y[int(deriv)] = _math.factorial(int(deriv)) / (float(delta) ** int(deriv))
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


# ---------------------------------------------------------------------------
# General convolution dispatchers (scipy parity target:
# scipy/signal/_signaltools.py convolve / convolve2d / correlate2d).
# Note: the fft method rides this package's padded-plan FFT convolution
# (signal.fftconvolve) — on device input that is the
# fast path; the direct method is an exact host computation (integer
# inputs stay integers) via a zero-copy sliding-window view.


def _direct_convolve_nd(vol: np.ndarray, ker: np.ndarray,
                        mode: str) -> np.ndarray:
    """Exact direct N-D convolution: one tensordot over a zero-copy
    sliding-window view (memory transient is out_size x kernel_size, so
    the auto dispatcher only routes small operands here — same contract
    as scipy's direct method)."""
    from numpy.lib.stride_tricks import sliding_window_view

    nd = vol.ndim
    flip = ker[(slice(None, None, -1),) * nd]
    if mode == "valid":
        win = sliding_window_view(vol, ker.shape)
        return np.tensordot(win, flip, axes=nd)
    pad = [(k - 1, k - 1) for k in ker.shape]
    full = np.tensordot(
        sliding_window_view(np.pad(vol, pad), ker.shape), flip, axes=nd)
    if mode == "full":
        return full
    # mode == "same": centered crop to vol's shape (np.convolve contract)
    sl = tuple(slice((k - 1) // 2, (k - 1) // 2 + n)
               for n, k in zip(vol.shape, ker.shape))
    return full[sl]


def _valid_swap(mode: str, s1, s2):
    """scipy's operand-swap rule: 'valid' needs one operand to dominate
    the other in every dimension; convolution commutes, so the bigger
    one leads."""
    if mode != "valid":
        return False
    ok1 = all(a >= b for a, b in zip(s1, s2))
    ok2 = all(b >= a for a, b in zip(s1, s2))
    if not (ok1 or ok2):
        raise ValueError("For 'valid' mode, one input must be at least "
                         "as large as the other in every dimension")
    return ok2 and not ok1


def convolve(in1, in2, mode: str = "full", method: str = "auto"):
    """N-D convolution (scipy.signal.convolve-compatible).

    ``method='auto'`` picks via :func:`choose_conv_method` (exact-integer
    inputs go direct unless the FFT stays exact); ``'fft'`` runs this
    package's fused FFT convolution — the device path for jax input —
    with integer/bool results rounded back like scipy; ``'direct'`` is
    an exact host computation."""
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"invalid mode {mode!r}")
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    is_jax = isinstance(in1, jax.Array) or isinstance(in2, jax.Array)
    a = np.asarray(in1) if not isinstance(in1, jax.Array) else in1
    b = np.asarray(in2) if not isinstance(in2, jax.Array) else in2
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if a.size == 0 or b.size == 0:
        raise ValueError("empty inputs are not supported")
    if method == "auto":
        method = choose_conv_method(np.asarray(a), np.asarray(b), mode)
    if method == "direct":
        vol = np.asarray(a)
        ker = np.asarray(b)
        if _valid_swap(mode, vol.shape, ker.shape):
            vol, ker = ker, vol
        out = _direct_convolve_nd(vol, ker, mode)
        return jnp.asarray(out) if is_jax else out
    from .signal import fftconvolve
    if mode == "valid":
        _valid_swap(mode, np.shape(a), np.shape(b))  # validate only
    if is_jax:
        return fftconvolve(a, b, mode=mode)
    rt = np.result_type(a, b)
    if rt.kind in "uib":
        # exact-count semantics: round the FFT result back to the
        # integer lattice (for bool that is the OR-convolution, which is
        # what scipy's direct method computes; scipy's bool-fft output
        # is an unrounded cast and therefore FP-noise-dependent)
        out = fftconvolve(np.asarray(a, np.float64),
                          np.asarray(b, np.float64), mode=mode)
        return np.around(out).astype(rt)
    return np.asarray(fftconvolve(a, b, mode=mode)).astype(rt, copy=False)


_BOUNDARY_PAD = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


def _conv2d_args(in1, in2, mode: str, boundary: str):
    a = np.asarray(in1)
    k = np.asarray(in2)
    if a.ndim != 2 or k.ndim != 2:
        raise ValueError("convolve2d/correlate2d inputs must be 2-D")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"invalid mode {mode!r}")
    if boundary not in _BOUNDARY_PAD:
        raise ValueError(f"invalid boundary {boundary!r}")
    return a, k


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0):
    """2-D convolution with boundary handling
    (scipy.signal.convolve2d-compatible).

    Non-zero boundaries extend the INPUT by kernel-1 samples with the
    boundary rule (constant fill / periodic wrap / symmetric
    reflection), so the window math is identical to the zero-pad case;
    'valid' mode never reaches the boundary and skips the extension."""
    a, k = _conv2d_args(in1, in2, mode, boundary)
    if (boundary == "fill" and fillvalue == 0) or mode == "valid":
        return convolve(a, k, mode=mode)
    if boundary in ("wrap", "symm") and any(
            p > s for p, s in zip((k.shape[0] - 1, k.shape[1] - 1), a.shape)):
        raise ValueError("kernel must not be larger than the input for "
                         "wrap/symm boundaries")
    pad = [(k.shape[0] - 1,) * 2, (k.shape[1] - 1,) * 2]
    kwargs = {"constant_values": fillvalue} if boundary == "fill" else {}
    ext = np.pad(a, pad, mode=_BOUNDARY_PAD[boundary], **kwargs)
    full = convolve(ext, k, mode="valid")
    if mode == "full":
        return full
    sl = tuple(slice((kk - 1) // 2, (kk - 1) // 2 + n)
               for n, kk in zip(a.shape, k.shape))
    return full[sl]


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0):
    """2-D cross-correlation with boundary handling
    (scipy.signal.correlate2d-compatible):
    correlate2d(a, k) = convolve2d(a, conj(k[::-1, ::-1])).

    'same' mode crops the full correlation starting at K//2 per axis —
    scipy's correlate2d centering, which differs from the 1-D
    correlate's (K-1)//2 for even kernel lengths."""
    a, k = _conv2d_args(in1, in2, mode, boundary)
    kf = k[::-1, ::-1]
    if np.issubdtype(kf.dtype, np.complexfloating):
        kf = np.conj(kf)
    kf = np.ascontiguousarray(kf)
    if mode == "same":
        full = convolve2d(a, kf, mode="full", boundary=boundary,
                          fillvalue=fillvalue)
        sl = tuple(slice(kk // 2, kk // 2 + n)
                   for n, kk in zip(a.shape, k.shape))
        return full[sl]
    return convolve2d(a, kf, mode=mode, boundary=boundary,
                      fillvalue=fillvalue)


# ---------------------------------------------------------------------------
# Rank-order filters and event-phase statistics (scipy parity targets:
# scipy/signal/_signaltools.py medfilt/medfilt2d/order_filter and
# vectorstrength). Rank filters are exact host computations over a
# zero-copy sliding-window view (zero-padded borders, scipy semantics).


# transient budget for the rank filters: the selected-window copy is
# out_block_size * kernel_size elements; blocks over the leading axis
# keep it near this many bytes (the sliding view itself is zero-copy)
_RANK_CHUNK_BYTES = 64 << 20


def _rank_filter(a: np.ndarray, domain: np.ndarray, rank: int) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    pad = [((k - 1) // 2, k - 1 - (k - 1) // 2) for k in domain.shape]
    padded = np.pad(a, pad)
    win = sliding_window_view(padded, domain.shape)
    mask = domain.ravel() != 0
    ksel = int(np.count_nonzero(mask))
    out = np.empty(a.shape, a.dtype)
    row_bytes = max(1, int(np.prod(a.shape[1:], dtype=np.int64))
                    * ksel * a.dtype.itemsize)
    step = max(1, _RANK_CHUNK_BYTES // row_bytes)
    for lo in range(0, a.shape[0], step):
        blk = win[lo:lo + step]
        sel = blk.reshape(blk.shape[:a.ndim] + (-1,))[..., mask]
        out[lo:lo + step] = np.partition(sel, rank, axis=-1)[..., rank]
    return out


def order_filter(a, domain, rank: int):
    """Rank-order filter (scipy.signal.order_filter-compatible): sort
    the neighborhood selected by the nonzero cells of ``domain`` and
    keep element ``rank``; borders are zero-padded."""
    a = np.asarray(a)
    domain = np.asarray(domain)
    if a.ndim != domain.ndim:
        raise ValueError("domain must have the same rank as the input")
    if any(k % 2 != 1 for k in domain.shape):
        raise ValueError("every domain dimension must be odd")
    size = int(np.count_nonzero(domain))
    if not 0 <= rank < size:
        raise ValueError(f"rank must be in [0, {size})")
    return _rank_filter(a, domain, rank)


def medfilt(volume, kernel_size=None):
    """Median filter (scipy.signal.medfilt-compatible): the median over
    an odd kernel window per axis, zero-padded borders."""
    a = np.asarray(volume)
    if kernel_size is None:
        kernel_size = [3] * a.ndim
    ks = np.atleast_1d(np.asarray(kernel_size, np.intp))
    if ks.size == 1:
        ks = np.full(a.ndim, ks[0])
    if ks.size != a.ndim:
        raise ValueError("kernel_size must match the input rank")
    if np.any(ks % 2 != 1):
        raise ValueError("every kernel_size must be odd")
    domain = np.ones(tuple(ks), np.int8)
    return _rank_filter(a, domain, int(np.prod(ks)) // 2)


def medfilt2d(input, kernel_size=3):
    """2-D median filter (scipy.signal.medfilt2d-compatible)."""
    a = np.asarray(input)
    if a.ndim != 2:
        raise ValueError("medfilt2d needs a 2-D input")
    return medfilt(a, kernel_size)


def vectorstrength(events, period):
    """Vector strength and mean phase of events against a period
    (scipy.signal.vectorstrength-compatible): magnitude and angle of
    the mean unit phasor exp(2*pi*j*events/period); an array of periods
    returns one row per period."""
    events = np.asarray(events)
    period = np.asarray(period)
    if events.ndim > 1:
        raise ValueError("events must be a 1-D array")
    if period.ndim > 1:
        raise ValueError("period must be a scalar or 1-D array")
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    scalar = period.ndim == 0
    p = np.atleast_1d(period).astype(np.float64)
    ang = 2 * np.pi * events[None, :] / p[:, None]
    ph = np.exp(1j * ang).mean(axis=-1)
    strength = np.abs(ph)
    phase = np.angle(ph)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase
