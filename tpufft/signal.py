"""Fused spectral filtering and FFT convolution (the scipy.signal usage
layer on top of the plan machinery — beyond reference parity; the
reference stops at raw transforms).

Design: a circular filter ``y = ifft(fft(x) * H)`` along one axis is a
LINEAR map, so for short axes the whole three-pass pipeline collapses at
plan time into one circulant matrix ``C[j, m] = c[(m - j) mod n]`` (``c``
the impulse response) and executes as a SINGLE dense matmul — one pass
over the data instead of three. The classic composition (transform,
pointwise multiply, inverse) serves long axes and the float64 host path.

``fftconvolve`` follows scipy.signal.fftconvolve semantics (modes
full/same/valid, axes subsets, broadcasting on non-convolved axes) and
runs through the framework's padded fast-length plans.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .config import PlanConfig
from .core import SplitComplex
from .planner import next_fast_len

__all__ = ["plan_filter", "FilterPlan", "fftconvolve", "oaconvolve",
           "hilbert", "hilbert2", "resample", "correlate", "envelope"]

# Largest axis run as a dense circulant matmul; beyond it the plan
# composes fft -> multiply -> ifft. The dense matmul is O(n^2) work against
# the composed transforms' O(n log n) and three passes over the data.
# ``bench_suite.py --decisions`` times both at 64M c64 elements: on an H100
# 80GB HBM3 at a 400 W power limit the dense form won at every n measured,
# 128 to 1024 (12.4 vs 19.0 ms at 1024); above 1024 it is not measured.
FILTER_DENSE_MAX_N = 1024

_HIGHEST = jax.lax.Precision.HIGHEST


# ----------------------------------------------------------------------------
# Fused circular filter


def _circulant(c: np.ndarray) -> np.ndarray:
    """C[j, m] = c[(m - j) mod n] so that (x @ C) is circular convolution
    of x with c."""
    n = c.shape[0]
    idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
    return c[idx]


class FilterPlan:
    """One-axis circular filter, callable like a transform plan.

    Accepts complex numpy/jax arrays, real arrays, or SplitComplex planes;
    returns the matching flavor. Differentiable by ordinary autodiff.
    """

    def __init__(self, n: int, c_time: np.ndarray, axis: int,
                 config: PlanConfig):
        self.n = int(n)
        self.axis = int(axis)
        self.config = config
        c = np.asarray(c_time, np.complex128)
        self._c = c
        H = np.fft.fft(c)
        self._hr = np.ascontiguousarray(H.real, np.float64)
        self._hi = np.ascontiguousarray(H.imag, np.float64)
        self._real_matrix = bool(np.max(np.abs(c.imag)) < 1e-12 * max(
            1.0, float(np.max(np.abs(c)))))
        # The O(n^2) circulant exists ONLY on the dense path: a long-axis
        # plan (e.g. hilbert over a 100k-sample signal) must not
        # materialize — or hold for its lifetime — an n x n float64
        # matrix it never uses.
        self._cr = self._ci = None
        if self._use_dense():
            C = _circulant(c)
            self._cr = np.ascontiguousarray(C.real, np.float64)
            self._ci = np.ascontiguousarray(C.imag, np.float64)
        self._diff = self._make_diff()
        self._diff_real = (self._make_diff_real()
                           if self._real_matrix and self._use_dense()
                           else None)
        # jit the whole plane application (moveaxis + reshape + matmul):
        # eager dispatch pays per-op host->device round-trips
        self._apply_jit = jax.jit(self._apply_planes_impl)
        self._apply_real_jit = jax.jit(self._apply_real_impl)

    def _use_dense(self) -> bool:
        return 2 <= self.n <= FILTER_DENSE_MAX_N

    def _make_diff(self):
        if self._use_dense():
            cr32 = jnp.asarray(self._cr, jnp.float32)
            ci32 = jnp.asarray(self._ci, jnp.float32)

            def f(xr, xi):
                def dot(a, b):
                    return jnp.dot(a, b, precision=_HIGHEST)

                yr = dot(xr, cr32) - dot(xi, ci32)
                yi = dot(xr, ci32) + dot(xi, cr32)
                return yr, yi

            return f

        # long axes: compose fft -> pointwise H -> ifft on planes (each
        # stage differentiable; runs inside this plan's jit as one program)
        from .execute import fft_axis
        from .planner import default_bases

        bases = tuple(default_bases(self.n))
        hr = jnp.asarray(self._hr, jnp.float32)
        hi = jnp.asarray(self._hi, jnp.float32)
        inv_scale = 1.0 / self.n

        def f(xr, xi):
            Xr, Xi = fft_axis(xr, xi, 1, bases, inverse=False, scale=1.0)
            Yr = Xr * hr - Xi * hi
            Yi = Xr * hi + Xi * hr
            return fft_axis(Yr, Yi, 1, bases, inverse=True, scale=inv_scale)

        return f

    def _make_diff_real(self):
        # Hermitian response on real input: the circulant is real, so the
        # whole filter is ONE real matmul — half the work and half the
        # input traffic of the complex form.
        cr32 = jnp.asarray(self._cr, jnp.float32)

        def f(x):
            return jnp.dot(x, cr32, precision=_HIGHEST)

        return f

    # -- application ---------------------------------------------------------

    def _apply_real_impl(self, x):
        axis = self.axis % x.ndim
        moved = axis != x.ndim - 1
        if moved:
            x = jnp.moveaxis(x, axis, -1)
        lead = x.shape[:-1]
        flat = math.prod(lead) if lead else 1
        y = self._diff_real(x.reshape(flat, self.n).astype(jnp.float32))
        y = y.reshape(lead + (self.n,))
        if moved:
            y = jnp.moveaxis(y, -1, axis)
        return y

    def _apply_planes(self, re, im):
        if re.shape[self.axis % re.ndim] != self.n:
            raise ValueError(
                f"filter length {self.n} != axis length "
                f"{re.shape[self.axis % re.ndim]}")
        return self._apply_jit(re, im)

    def _apply_planes_impl(self, re, im):
        axis = self.axis % re.ndim
        moved = axis != re.ndim - 1
        if moved:
            re = jnp.moveaxis(re, axis, -1)
            im = jnp.moveaxis(im, axis, -1)
        if re.shape[-1] != self.n:
            raise ValueError(
                f"filter length {self.n} != axis length {re.shape[-1]}")
        lead = re.shape[:-1]
        flat = math.prod(lead) if lead else 1
        yr, yi = self._diff(re.reshape(flat, self.n).astype(jnp.float32),
                            im.reshape(flat, self.n).astype(jnp.float32))
        yr = yr.reshape(lead + (self.n,))
        yi = yi.reshape(lead + (self.n,))
        if moved:
            yr = jnp.moveaxis(yr, -1, axis)
            yi = jnp.moveaxis(yi, -1, axis)
        return yr, yi

    def __call__(self, x):
        if isinstance(x, SplitComplex):
            yr, yi = self._apply_planes(x.re, x.im)
            return SplitComplex(yr, yi)
        is_np = not isinstance(x, jax.Array)
        f64_host = jax.config.jax_enable_x64

        def _f64_pipeline(xn):
            # f64 tier (1e-12): host numpy fft*H*ifft — exact for any n,
            # no O(n^2) matrix needed
            Hc = self._hr + 1j * self._hi
            shape = [1] * xn.ndim
            shape[self.axis % xn.ndim] = self.n
            return np.fft.ifft(
                np.fft.fft(xn, axis=self.axis) * Hc.reshape(shape),
                axis=self.axis)

        if is_np and np.iscomplexobj(x):
            xn = np.asarray(x)
            if xn.dtype == np.complex128 and f64_host:
                return _f64_pipeline(xn)
            yr, yi = self._apply_planes(
                jnp.asarray(np.ascontiguousarray(xn.real), jnp.float32),
                jnp.asarray(np.ascontiguousarray(xn.imag), jnp.float32))
            return (np.asarray(yr).astype(np.complex64)
                    + 1j * np.asarray(yi))
        xj = jnp.asarray(x)
        if jnp.issubdtype(xj.dtype, jnp.complexfloating):
            yr, yi = self._apply_planes(jnp.real(xj), jnp.imag(xj))
            return yr.astype(jnp.complex64) + 1j * yi.astype(jnp.complex64)
        # real input: if the filter matrix is real the output is real
        if self._real_matrix:
            if xj.shape[self.axis % xj.ndim] != self.n:
                raise ValueError(
                    f"filter length {self.n} != axis length "
                    f"{xj.shape[self.axis % xj.ndim]}")
            if is_np and np.dtype(np.asarray(x).dtype) == np.float64 \
                    and f64_host:
                # keep the f64 tier for float64 input like the c128 path
                # (the jitted planes are the f32 tier)
                return np.real(_f64_pipeline(np.asarray(x)))
            if self._diff_real is not None:
                # single REAL matmul — no imaginary plane at all
                yr = self._apply_real_jit(xj.astype(jnp.float32))
            else:
                yr, _ = self._apply_planes(xj, jnp.zeros_like(xj))
            out = yr.astype(xj.dtype if jnp.issubdtype(xj.dtype,
                                                       jnp.floating)
                            else jnp.float32)
            return np.asarray(out) if is_np else out
        yr, yi = self._apply_planes(xj, jnp.zeros_like(xj))
        if is_np:
            return (np.asarray(yr).astype(np.complex64)
                    + 1j * np.asarray(yi))
        return yr.astype(jnp.complex64) + 1j * yi.astype(jnp.complex64)


def plan_filter(n: int, response=None, *, impulse=None, axis: int = -1,
                config: PlanConfig | None = None) -> FilterPlan:
    """Plan a circular filter along one axis: y = ifft(fft(x, axis) * H).

    Exactly one of ``response`` (frequency response H, length n) or
    ``impulse`` (time-domain circular kernel c = ifft(H), length n) must
    be given. A Hermitian-symmetric response (real impulse) applied to a
    real array returns a real array.

    The pipeline is folded into one circulant matrix at plan time and runs
    as a single dense matmul for n <= FILTER_DENSE_MAX_N (vs three passes
    for fft -> multiply -> ifft); past the crossover it composes the
    transforms instead.
    """
    if (response is None) == (impulse is None):
        raise ValueError("give exactly one of response= or impulse=")
    n = int(n)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if impulse is not None:
        c = np.asarray(impulse, np.complex128)
        if c.shape != (n,):
            raise ValueError(f"impulse must have shape ({n},)")
    else:
        H = np.asarray(response, np.complex128)
        if H.shape != (n,):
            raise ValueError(f"response must have shape ({n},)")
        c = np.fft.ifft(H)
    return FilterPlan(n, c, axis, config or PlanConfig())


# ----------------------------------------------------------------------------
# fftconvolve (scipy.signal semantics)


def _conv_axes(s1, s2, axes):
    ndim = len(s1)
    if axes is None:
        axes = tuple(range(ndim))
    elif np.isscalar(axes):
        axes = (int(axes),)
    axes = tuple(sorted(a % ndim for a in axes))
    if not axes:
        raise ValueError("when provided, axes cannot be empty")
    if len(set(axes)) != len(axes):
        raise ValueError("duplicate axes")
    for a in range(ndim):
        if a not in axes and s1[a] != s2[a] and 1 not in (s1[a], s2[a]):
            raise ValueError(
                f"incompatible shapes on non-convolved axis {a}: "
                f"{s1[a]} vs {s2[a]}")
    return axes


def _centered(arr, newshape):
    slices = []
    for cur, new in zip(arr.shape, newshape):
        start = (cur - new) // 2
        slices.append(slice(start, start + new))
    return arr[tuple(slices)]


def fftconvolve(in1, in2, mode: str = "full", axes=None, *,
                config: PlanConfig | None = None):
    """N-D convolution via FFT — scipy.signal.fftconvolve-compatible
    (modes "full"/"same"/"valid", axes subsets, broadcasting on
    non-convolved axes). Real inputs run the packed r2c path; lengths pad
    to 7-smooth sizes (`next_fast_len`)."""
    from . import api

    is_np = not (isinstance(in1, jax.Array) or isinstance(in2, jax.Array))
    # numpy callers stay numpy end-to-end; jax callers keep device
    # residency.
    xp = np if is_np else jnp
    a = xp.asarray(in1)
    b = xp.asarray(in2)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if a.ndim == 0:
        return a * b
    if a.size == 0 or b.size == 0:
        # scipy returns an empty array, not a 0-d scalar
        return xp.zeros((0,), np.result_type(a.dtype, b.dtype))
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    axes = _conv_axes(a.shape, b.shape, axes)
    s1 = a.shape
    s2 = b.shape
    if mode == "valid":
        ok1 = all(s1[ax] >= s2[ax] for ax in axes)
        ok2 = all(s2[ax] >= s1[ax] for ax in axes)
        if not (ok1 or ok2):
            raise ValueError(
                "for mode='valid' one input must be at least as large as "
                "the other in every convolved axis")
        if not ok1:
            a, b = b, a
            s1, s2 = s2, s1
    full = [s1[ax] + s2[ax] - 1 for ax in axes]
    fast = [next_fast_len(f) for f in full]
    real = not (np.issubdtype(np.dtype(a.dtype), np.complexfloating)
                or np.issubdtype(np.dtype(b.dtype), np.complexfloating))
    kw = dict(s=tuple(fast), axes=axes, config=config)
    if real:
        conv = api.irfftn(api.rfftn(a, **kw) * api.rfftn(b, **kw), **kw)
    else:
        conv = api.ifftn(api.fftn(a, **kw) * api.fftn(b, **kw), **kw)
    conv = xp.asarray(conv)
    # crop the fast-length padding back to the full linear-conv shape
    sl = [slice(None)] * conv.ndim
    for ax, f in zip(axes, full):
        sl[ax] = slice(0, f)
    conv = conv[tuple(sl)]
    if mode == "full":
        out = conv
    elif mode == "same":
        # scipy crops to in1's shape on EVERY axis (broadcast non-conv
        # axes included — scipy's _apply_conv_mode does _centered(ret, s1))
        out = _centered(conv, s1)
    else:  # valid: conv axes crop to s1-s2+1; non-conv axes keep the
        # broadcast result (scipy keeps ret's shape there)
        shape = list(conv.shape)
        for ax in axes:
            shape[ax] = s1[ax] - s2[ax] + 1
        out = _centered(conv, shape)
    if real:
        want = np.result_type(a.dtype, b.dtype)
        if out.dtype != want and np.issubdtype(want, np.floating):
            out = out.astype(want)
    return out


# ----------------------------------------------------------------------------
# hilbert / resample / correlate (the FFT-adjacent scipy.signal surface)


@functools.lru_cache(maxsize=64)
def _hilbert_plan(n: int, axis: int, config: PlanConfig | None):
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return plan_filter(n, response=h, axis=axis, config=config)


def hilbert(x, N: int | None = None, axis: int = -1, *,
            config: PlanConfig | None = None):
    """Analytic signal via the Hilbert transform
    (scipy.signal.hilbert-compatible): real input -> complex output whose
    real part is x and imaginary part its Hilbert transform.

    The whole ifft(fft(x) * h) pipeline runs through ``plan_filter`` —
    one dense matmul for N <= FILTER_DENSE_MAX_N. Numpy input returns
    numpy complex; a device array returns a complex device array."""
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    xj = xp.asarray(x)
    if np.issubdtype(np.dtype(xj.dtype), np.complexfloating):
        raise ValueError("x must be real")
    n0 = xj.shape[axis % xj.ndim]
    N = n0 if N is None else int(N)
    if N < 1:
        raise ValueError("N must be positive")
    if N != n0:
        ax = axis % xj.ndim
        if N < n0:
            sl = [slice(None)] * xj.ndim
            sl[ax] = slice(0, N)
            xj = xj[tuple(sl)]
        else:
            pad = [(0, 0)] * xj.ndim
            pad[ax] = (0, N - n0)
            xj = xp.pad(xj, pad)
    # numpy stays numpy end-to-end: the plan combines on the host
    return _hilbert_plan(N, axis % xj.ndim, config)(xj)


def hilbert2(x, N=None, axes=(-2, -1), *,
             config: PlanConfig | None = None):
    """2-D analytic signal (scipy.signal.hilbert2-compatible): real
    input -> complex output via fft2, the separable h1 (x) h2 one-sided
    doubling mask, and ifft2 — the mask multiply fuses into the
    surrounding passes as one elementwise expression.
    Numpy in -> numpy complex out; a device array in -> a complex device
    array out."""
    from . import api

    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    xj = xp.atleast_2d(xp.asarray(x))
    if np.issubdtype(np.dtype(xj.dtype), np.complexfloating):
        raise ValueError("x must be real.")
    if len(axes) != 2:
        raise ValueError("axes must be a tuple of length 2")
    ax0, ax1 = (a % xj.ndim for a in axes)
    if ax0 == ax1:
        raise ValueError("axes must contain 2 distinct axes")
    if N is None:
        N = (xj.shape[ax0], xj.shape[ax1])
    elif isinstance(N, int):
        if N <= 0:
            raise ValueError("N must be positive.")
        N = (N, N)
    elif len(N) != 2 or any(int(n) <= 0 for n in N):
        raise ValueError("When given as a tuple, N must hold exactly "
                         "two positive integers")
    N = (int(N[0]), int(N[1]))

    def mask1(n):
        h = np.zeros(n)
        k = (n + 1) // 2
        h[0] = 1.0
        h[1:k] = 2.0
        return h

    h = np.outer(mask1(N[0]), mask1(N[1]))
    X = api.fft2(xj, s=N, axes=(ax0, ax1), config=config)
    shape = [1] * xj.ndim
    shape[ax0], shape[ax1] = N
    Y = X * xp.asarray(h.reshape(shape)).astype(X.dtype)
    return api.ifft2(Y, axes=(ax0, ax1), config=config)


def resample(x, num: int, axis: int = 0, *,
             config: PlanConfig | None = None):
    """Fourier-domain resampling (scipy.signal.resample semantics,
    window=None): keep the ``min(num, N)`` lowest-frequency bins with
    scipy's exact Nyquist-bin split/fold, inverse-transform at the new
    length, scale by num/N. Real input -> real output."""
    from . import api

    host = not isinstance(x, jax.Array)
    xn = np.asarray(x) if host else x
    real = not np.issubdtype(np.dtype(xn.dtype), np.complexfloating)
    ax = axis % xn.ndim
    N = xn.shape[ax]
    num = int(num)
    if num < 1:
        raise ValueError("num must be positive")
    # the transforms run through tpufft (device); the O(num) spectrum
    # surgery happens on the host for numpy callers
    X = np.asarray(api.fft(xn, axis=ax, config=config)) if host \
        else jnp.asarray(api.fft(xn, axis=ax, config=config))
    xp = np if host else jnp
    nsl = [slice(None)] * xn.ndim
    newshape = list(X.shape)
    newshape[ax] = num
    n_min = min(num, N)
    nyq = n_min // 2 + 1
    if host:
        Y = np.zeros(newshape, X.dtype)

        def setidx(dst_idx, val):
            Y[tuple(dst_idx)] = val

        def addidx(dst_idx, val):
            Y[tuple(dst_idx)] += val
    else:
        Y = jnp.zeros(newshape, X.dtype)

        def setidx(dst_idx, val):
            nonlocal Y
            Y = Y.at[tuple(dst_idx)].set(val)

        def addidx(dst_idx, val):
            nonlocal Y
            Y = Y.at[tuple(dst_idx)].add(val)

    sl = list(nsl)
    sl[ax] = slice(0, nyq)
    setidx(sl, X[tuple(sl)])
    if n_min > 2:
        neg = n_min - nyq
        sl_dst = list(nsl)
        sl_dst[ax] = slice(num - neg, num)
        sl_src = list(nsl)
        sl_src[ax] = slice(N - neg, N)
        setidx(sl_dst, X[tuple(sl_src)])
    if n_min % 2 == 0:
        half = list(nsl)
        half[ax] = n_min // 2
        if num < N:  # downsampling: fold the split Nyquist energy back
            src = list(nsl)
            src[ax] = N - num // 2
            addidx(half, X[tuple(src)])
        elif num > N:  # upsampling: split the Nyquist bin symmetrically
            setidx(half, Y[tuple(half)] * 0.5)
            dst = list(nsl)
            dst[ax] = num - n_min // 2
            setidx(dst, Y[tuple(half)])
    y = api.ifft(Y, axis=ax, config=config)
    y = (np.asarray(y) if host else jnp.asarray(y)) * (num / N)
    if real:
        want = xn.dtype if np.issubdtype(np.dtype(xn.dtype),
                                         np.floating) else np.float32
        y = xp.real(y).astype(want)
    return y


def correlate(in1, in2, mode: str = "full", *, axes=None,
              config: PlanConfig | None = None):
    """FFT-method cross-correlation
    (scipy.signal.correlate(..., method="fft")-compatible):
    correlate(a, b) = convolve(a, conj(b reversed))."""
    xp = jnp if isinstance(in2, jax.Array) else np
    b = xp.asarray(in2)
    a_shape = np.shape(in1)
    if len(a_shape) != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    # reverse (and conjugate) ONLY the correlated axes — flipping a
    # non-correlated batch axis would silently pair row i with row B-1-i
    caxes = _conv_axes(a_shape, b.shape, axes) if b.ndim else ()
    rev = tuple(slice(None, None, -1) if i in caxes else slice(None)
                for i in range(b.ndim))
    b = b[rev]
    if np.issubdtype(np.dtype(b.dtype), np.complexfloating):
        b = xp.conj(b)
    if xp is np:
        b = np.ascontiguousarray(b)
    return fftconvolve(in1, b, mode=mode, axes=axes, config=config)


def oaconvolve(in1, in2, mode: str = "full", axes=None, *,
               config: PlanConfig | None = None):
    """Overlap-add convolution (scipy.signal.oaconvolve-compatible
    results). For a single convolution axis with a large length ratio —
    the canonical long-signal/short-kernel case — the signal runs in
    fast-length blocks through ONE batched r2c plan (every block
    transforms in a single kernel launch; the kernel spectrum is
    computed once), so the cost scales with N1 log N2 instead of
    N1 log N1. Other configurations delegate to fftconvolve (identical
    results by linearity)."""
    is_np = not (isinstance(in1, jax.Array) or isinstance(in2, jax.Array))
    xp = np if is_np else jnp
    a = xp.asarray(in1)
    b = xp.asarray(in2)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if a.ndim == 0 or a.size == 0 or b.size == 0:
        return fftconvolve(in1, in2, mode=mode, axes=axes, config=config)
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    caxes = _conv_axes(a.shape, b.shape, axes)
    real = not (np.issubdtype(np.dtype(a.dtype), np.complexfloating)
                or np.issubdtype(np.dtype(b.dtype), np.complexfloating))
    # non-convolved-axes compatibility was already validated by _conv_axes
    oa_ok = (len(caxes) == 1
             and max(a.shape[caxes[0]], b.shape[caxes[0]])
             >= 8 * min(a.shape[caxes[0]], b.shape[caxes[0]])
             and min(a.shape[caxes[0]], b.shape[caxes[0]]) >= 2)
    if not oa_ok:
        return fftconvolve(in1, in2, mode=mode, axes=axes, config=config)
    from . import api

    ax = caxes[0]
    s1_len, s2_len = a.shape[ax], b.shape[ax]
    sig, ker = (a, b) if s1_len >= s2_len else (b, a)
    n_sig = sig.shape[ax]
    n_ker = ker.shape[ax]
    full = n_sig + n_ker - 1
    L = next_fast_len(max(8 * n_ker, 64))
    step = L - (n_ker - 1)
    nblocks = -(-n_sig // step)
    pad_sig = nblocks * step - n_sig
    sigm = xp.moveaxis(sig, ax, -1)
    kerm = xp.moveaxis(ker, ax, -1)
    if pad_sig:
        pad = [(0, 0)] * sigm.ndim
        pad[-1] = (0, pad_sig)
        sigm = xp.pad(sigm, pad)
    blocks = sigm.reshape(sigm.shape[:-1] + (nblocks, step))
    if real:
        FA = api.rfft(blocks, n=L, config=config)
        FB = api.rfft(kerm, n=L, config=config)
    else:
        FA = api.fft(blocks, n=L, config=config)
        FB = api.fft(kerm, n=L, config=config)
    prod = xp.asarray(FA) * xp.asarray(FB)[..., None, :]
    YB = api.irfft(prod, n=L, config=config) if real \
        else api.ifft(prod, config=config)
    YB = xp.asarray(YB)
    # overlap-add, fully vectorized: heads lay out contiguously; the
    # (n_ker - 1)-long tails shift one block right and accumulate
    lead = YB.shape[:-2]
    heads = YB[..., :step].reshape(lead + (nblocks * step,))
    tails = YB[..., step:]                    # (..., nblocks, n_ker - 1)
    tpad = [(0, 0)] * tails.ndim
    tpad[-1] = (0, step - (n_ker - 1))
    tails = xp.pad(tails, tpad).reshape(lead + (nblocks * step,))
    out_len = nblocks * step + step
    out = xp.zeros(lead + (out_len,), YB.dtype)
    if xp is np:
        out[..., :nblocks * step] = heads
        out[..., step:step + nblocks * step] += tails
    else:
        out = out.at[..., :nblocks * step].set(heads)
        out = out.at[..., step:step + nblocks * step].add(tails)
    out = out[..., :full]
    conv = xp.moveaxis(out, -1, ax)
    # mode cropping relative to the ORIGINAL in1/in2 roles
    s1 = a.shape
    s2 = b.shape
    if mode == "valid":
        ok1 = s1[ax] >= s2[ax]
        lo, hi = (s1, s2) if ok1 else (s2, s1)
        shape = list(conv.shape)
        shape[ax] = lo[ax] - hi[ax] + 1
        conv = _centered(conv, shape)
    elif mode == "same":
        # scipy crops to in1's shape on EVERY axis (broadcast included)
        conv = _centered(conv, s1)
    if real:
        want = np.result_type(a.dtype, b.dtype)
        if conv.dtype != want and np.issubdtype(want, np.floating):
            conv = conv.astype(want)
    return conv


def envelope(z, bp_in: tuple = (1, None), *, n_out: int | None = None,
             squared: bool = False, residual: str | None = "lowpass",
             axis: int = -1, config: PlanConfig | None = None):
    """Envelope of a real/complex signal (scipy.signal.envelope-compatible,
    scipy >= 1.16): bandpass in Fourier space, analytic-signal magnitude
    out, plus the filtered-away residual. The transforms run through the
    framework's plans; the O(n) spectrum surgery happens on the host for
    numpy callers, mirroring ``resample``."""
    from . import api

    host = not isinstance(z, jax.Array)
    xn = np.asarray(z) if host else z
    xp = np if host else jnp
    if not (-xn.ndim <= axis < xn.ndim):
        raise ValueError(f"Invalid parameter {axis=} for {xn.shape=}!")
    n = xn.shape[axis]
    if n <= 0:
        raise ValueError(f"z.shape[axis] not > 0 for {xn.shape=}, {axis=}!")
    if len(bp_in) != 2 or not all(isinstance(b_, int) or b_ is None
                                  for b_ in bp_in):
        raise ValueError(f"{bp_in=} isn't a 2-tuple of type "
                         "(int | None, int | None)!")
    if not ((isinstance(n_out, int) and n_out > 0) or n_out is None):
        raise ValueError(f"{n_out=} is not a positive integer or None!")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"{residual=} not in ['lowpass', 'all', None]!")
    n_out = n if n_out is None else n_out
    fak = n_out / n
    bp = slice(bp_in[0] if bp_in[0] is not None else -(n // 2),
               bp_in[1] if bp_in[1] is not None else (n + 1) // 2)
    if not (-n // 2 <= bp.start < bp.stop <= (n + 1) // 2):
        raise ValueError("`-n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2` does "
                         f"not hold for n={n} and {bp_in=}!")

    zm = xp.moveaxis(xn, axis, -1)
    complex_in = np.issubdtype(np.dtype(zm.dtype), np.complexfloating)
    if complex_in:
        Z = api.fft(zm, axis=-1, config=config)
        # host surgery mutates in place; jax->numpy buffers are read-only
        Z = np.array(Z) if host else jnp.asarray(Z)
    else:
        R = api.rfft(zm, axis=-1, config=config)
        R = np.asarray(R) if host else jnp.asarray(R)
        Z = xp.zeros(zm.shape[:-1] + (n,), R.dtype)
        if host:
            Z[..., :n // 2 + 1] = R
            if bp.start > 0:  # make the bp band analytic
                Z[..., bp] *= 2
            elif bp.stop > 0:
                Z[..., 1:bp.stop] *= 2
        else:
            Z = Z.at[..., :n // 2 + 1].set(R)
            if bp.start > 0:
                Z = Z.at[..., bp].multiply(2)
            elif bp.stop > 0:
                Z = Z.at[..., 1:bp.stop].multiply(2)

    # envelope: baseband the bp band (envelopes are shift-invariant)
    if not (bp.start <= 0 < bp.stop):
        Zbb = Z[..., bp]
    else:
        shifted = xp.roll(Z, n // 2, axis=-1)
        Zbb = shifted[..., bp.start + n // 2:bp.stop + n // 2]
    z_bb = api.ifft(Zbb, n=n_out, axis=-1, config=config)
    z_bb = (np.asarray(z_bb) if host else jnp.asarray(z_bb)) * fak
    env = (xp.real(z_bb) ** 2 + xp.imag(z_bb) ** 2 if squared
           else xp.abs(z_bb))
    z_env = xp.moveaxis(env, -1, axis)

    if residual is None:
        return z_env

    # zero the bp band; 'lowpass' keeps only frequencies below it
    def zero(a, sl):
        if host:
            a[..., sl] = 0
            return a
        return a.at[..., sl].set(0)

    if not (bp.start <= 0 < bp.stop):
        Z = zero(Z, bp)
    else:
        Z = zero(Z, slice(None, bp.stop))
        Z = zero(Z, slice(bp.start, None))
    if residual == "lowpass":
        if bp.stop > 0:
            Z = zero(Z, slice(bp.stop, (n + 1) // 2))
        else:
            Z = zero(Z, slice(bp.start, None))
            Z = zero(Z, slice(0, (n + 1) // 2))

    if complex_in:
        if n_out == n:
            z_res = api.ifft(Z, axis=-1, config=config)
            z_res = np.asarray(z_res) if host else jnp.asarray(z_res)
        else:
            # freq-domain resample == time-domain resample of ifft(Z)
            zt = api.ifft(Z, axis=-1, config=config)
            zt = np.asarray(zt) if host else jnp.asarray(zt)
            z_res = resample(zt, n_out, axis=-1, config=config)
            z_res = np.asarray(z_res) if host else jnp.asarray(z_res)
    else:
        if n_out != n and (m := min(n, n_out)) % 2 == 0:
            if host:
                Z[..., m // 2] *= 2 if n_out < n else 0.5
            else:
                Z = Z.at[..., m // 2].multiply(2 if n_out < n else 0.5)
        z_res = api.irfft(Z[..., :n_out // 2 + 1], n=n_out, axis=-1,
                          config=config)
        z_res = (np.asarray(z_res) if host else jnp.asarray(z_res)) * fak
    z_res = xp.moveaxis(z_res, -1, axis)
    out = xp.stack((xp.asarray(z_env, z_res.dtype)
                    if np.issubdtype(np.dtype(z_res.dtype),
                                     np.complexfloating)
                    else z_env.astype(z_res.dtype), z_res), axis=0)
    return out
