"""IIR filtering as a parallel associative scan (sosfilt / sosfiltfilt,
scipy.signal-compatible), plus the zero-phase machinery decimate's
default Chebyshev path needs.

Beyond reference parity: the reference (martinvuyk/hackathon-fft) has no
filtering layer at all; scipy's sosfilt is a C loop that is inherently
sequential per sample. Design: each biquad section in
transposed direct form II is an AFFINE map on its 2-dim state,

    z[n] = M z[n-1] + v x[n],   y[n] = b0 x[n] + z0[n-1]
    M = [[-a1, 1], [-a2, 0]],   v = [b1 - a1 b0, b2 - a2 b0]

and affine maps compose associatively ((A2,c2)∘(A1,c1) =
(A2 A1, A2 c1 + c2)), so the whole recurrence runs as ONE
``lax.associative_scan`` — O(log n) depth instead of O(n), entirely
XLA-fusable, exact (same recurrence, reassociated fp order only;
~1e-12 vs scipy in f64). Sections cascade sequentially (their count is
tiny). The f64 host path rides the same code under the x64 CPU tier.

Filter *design* (sosfilt_zi steady-state, cheby1 in multirate.decimate)
stays a host-side scipy f64 plan constant, the same discipline as
window/twiddle tables — compute never delegates.

scipy parity targets: scipy/signal/_signaltools.py (sosfilt zi contract,
sosfiltfilt's odd-extension + zi*x0 forward/backward schedule and
default padlen).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sosfilt", "sosfiltfilt", "lfilter", "filtfilt"]


def _validate_sos(sos) -> np.ndarray:
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    if not np.all(sos[:, 3] != 0):
        raise ValueError("sos[:, 3] (a0) must be nonzero")
    return sos / sos[:, 3:4]


@functools.lru_cache(maxsize=32)
def _scan_runner(sos_bytes: bytes, ns: int, dtype_str: str):
    """Jitted cascade runner: (x (B, n), zi (ns, B, 2)) ->
    (y (B, n), zf (ns, B, 2)). Cached per (sos, dtype)."""
    sos = np.frombuffer(sos_bytes, np.float64).reshape(ns, 6)
    dt = jnp.dtype(dtype_str)
    b0 = sos[:, 0]
    Ms = np.stack([np.array([[-s[4], 1.0], [-s[5], 0.0]]) for s in sos])
    vs = np.stack([np.array([s[1] - s[4] * s[0], s[2] - s[5] * s[0]])
                   for s in sos])

    def combine(a, b):
        # b is the LATER block: (Ab@Aa, Ab@ca + cb). The 2x2 algebra is
        # UNROLLED into elementwise ops: an einsum/dot_general at default
        # precision may run in reduced precision (TF32 on the GPU) and
        # wreck the recurrence; elementwise f32 ops keep it at the f32
        # tier.
        a00, a01, a10, a11, c0, c1 = a
        b00, b01, b10, b11, d0, d1 = b
        return (b00 * a00 + b01 * a10, b00 * a01 + b01 * a11,
                b10 * a00 + b11 * a10, b10 * a01 + b11 * a11,
                b00 * c0 + b01 * c1 + d0,
                b10 * c0 + b11 * c1 + d1)

    @jax.jit
    def run(x, zi):
        # x: (B, n); zi: (ns, B, 2)
        n = x.shape[1]
        xt = x.T  # (n, B)
        one = jnp.ones((n, 1), dt)
        zf = []
        for s in range(ns):
            m00, m01 = dt.type(Ms[s][0, 0]), dt.type(Ms[s][0, 1])
            m10, m11 = dt.type(Ms[s][1, 0]), dt.type(Ms[s][1, 1])
            v0, v1 = dt.type(vs[s][0]), dt.type(vs[s][1])
            elems = (m00 * one, m01 * one, m10 * one, m11 * one,
                     v0 * xt, v1 * xt)
            a00, a01, a10, a11, c0, c1 = jax.lax.associative_scan(
                combine, elems, axis=0)
            # z[k] = Acum[k] @ zi + ccum[k]; y needs z[k-1]
            zi0, zi1 = zi[s, :, 0], zi[s, :, 1]  # (B,)
            z0 = a00 * zi0 + a01 * zi1 + c0  # (n, B)
            z1 = a10 * zi0 + a11 * zi1 + c1
            z0_prev = jnp.concatenate([zi0[None], z0[:-1]], axis=0)
            xt = dt.type(b0[s]) * xt + z0_prev
            zf.append(jnp.stack([z0[-1], z1[-1]], axis=-1))  # (B, 2)
        return xt.T, jnp.stack(zf)

    return run


def sosfilt(sos, x, axis: int = -1, zi=None):
    """Cascaded second-order-section filtering
    (scipy.signal.sosfilt-compatible, including the ``zi``/``zf`` state
    contract). The recurrence runs as a parallel associative scan —
    see the module docstring."""
    sos = _validate_sos(sos)
    ns = sos.shape[0]
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    if x.ndim == 0:
        raise ValueError("x must be at least 1-D")
    axis = axis % x.ndim
    n = x.shape[axis]

    if is_np:
        dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if np.issubdtype(x.dtype, np.complexfloating):
            raise NotImplementedError(
                "complex sosfilt is not supported (split the planes: the "
                "filter is real, so filter re and im independently)")
    else:
        dt = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) \
            else jnp.float32

    zi_shape = (ns,) + tuple(2 if a == axis else d
                             for a, d in enumerate(x.shape))
    return_zf = zi is not None
    if zi is not None:
        zi = xp.asarray(zi)
        if zi.shape != zi_shape:
            raise ValueError(
                f"Invalid zi shape {zi.shape}; expected {zi_shape}")

    # internal layout: (B, n) with the filter axis last
    xm = xp.moveaxis(x, axis, -1)
    lead = xm.shape[:-1]
    B = int(np.prod(lead)) if lead else 1
    x2 = jnp.asarray(xm.reshape(B, n), dt)
    if zi is None:
        z2 = jnp.zeros((ns, B, 2), dt)
    else:
        # (ns, ..., 2 at axis) -> (ns, B, 2)
        zm = xp.moveaxis(zi, axis + 1, -1)
        z2 = jnp.asarray(zm.reshape(ns, B, 2), dt)

    run = _scan_runner(sos.tobytes(), ns, str(jnp.dtype(dt)))
    y2, zf2 = run(x2, z2)

    y = jnp.moveaxis(y2.reshape(lead + (n,)), -1, axis)
    if is_np:
        y = np.asarray(y)
    if not return_zf:
        return y
    zf = jnp.moveaxis(zf2.reshape((ns,) + lead + (2,)), -1, axis + 1)
    return y, (np.asarray(zf) if is_np else zf)


_LFILTER_MAX_ORDER = 16


@functools.lru_cache(maxsize=32)
def _tf_scan_runner(b_bytes: bytes, a_bytes: bytes, D: int,
                    dtype_str: str):
    """Jitted direct-form-II-transposed runner for one (b, a) transfer
    function: (x (B, n), zi (B, S)) -> (y (B, n), zf (B, S)), S = D-1.

    The companion state matrix M (M[i,0] = -a[i+1], M[i,i+1] = 1) is
    CONSTANT per step, so the affine prefix scan collapses to a
    Hillis-Steele doubling loop whose level-o multiplier is the host-f64
    constant M^o: f[i] += M^o @ f[i-o] — one large (n*B, S) x (S, S)
    matmul per level (log2 n levels) instead of n tiny per-element
    matrix products. The matmuls run at HIGHEST precision — a default
    f32 dot may run in TF32 on the GPU and wreck the recurrence. Row 0 of the scan array carries zi, so the same loop
    yields z[k] = M^(k+1) zi + sum M^(k-j) v x[j] and zf for free."""
    b = np.frombuffer(b_bytes, np.float64)
    a = np.frombuffer(a_bytes, np.float64)
    dt = jnp.dtype(dtype_str)
    S = D - 1
    M = np.zeros((S, S))
    M[:, 0] = -a[1:]
    for i in range(S - 1):
        M[i, i + 1] = 1.0
    v = b[1:] - a[1:] * b[0]
    hp = jax.lax.Precision.HIGHEST

    @jax.jit
    def run(x, zi):
        # x: (B, n); zi: (B, S)
        n = x.shape[1]
        xt = x.T  # (n, B)
        u = xt[:, :, None] * jnp.asarray(v, dt)  # (n, B, S)
        f = jnp.concatenate([zi[None], u], axis=0)  # (n+1, B, S)
        o = 1
        while o < n + 1:
            Mo = jnp.asarray(np.linalg.matrix_power(M, o).T, dt)
            shifted = jnp.einsum("nbj,ji->nbi", f[:-o], Mo,
                                 precision=hp)
            f = jnp.concatenate([f[:o], f[o:] + shifted], axis=0)
            o *= 2
        # f[k+1] = z[k]; f[k] = z[k-1] (z[-1] = zi)
        y = dt.type(b[0]) * xt + f[:-1, :, 0]
        return y.T, f[-1]

    return run


def lfilter(b, a, x, axis: int = -1, zi=None):
    """IIR/FIR filtering with a rational transfer function
    (scipy.signal.lfilter-compatible, direct form II transposed,
    including the ``zi``/``zf`` contract).

    Design: an FIR (len(a) == 1) runs as ONE batched FFT
    convolution (the causal truncation of conv(b, x), with the zi
    transient added and zf read from the full-convolution tail); an IIR
    runs the state recurrence as a parallel associative scan over the
    (D-1)-dim companion affine maps — exact scipy semantics, O(log n)
    depth. Zero-state IIRs of order 3+ route through the
    second-order-section cascade instead (identical response; the
    full-order companion product is numerically unstable for repeated
    poles near the unit circle, while each biquad stage is perfectly
    conditioned). Orders above 16 with a ``zi`` state must be factored
    to ``sosfilt`` by the caller: the scan materializes (D-1)^2 floats
    per sample, and high-order direct forms are unstable anyway."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1 or b.size == 0 or a.size == 0:
        raise ValueError("b and a must be non-empty 1-D")
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    D = max(b.size, a.size)
    S = D - 1

    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    if x.ndim == 0:
        raise ValueError("x must be at least 1-D")
    axis = axis % x.ndim
    n = x.shape[axis]
    if is_np:
        dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if np.issubdtype(x.dtype, np.complexfloating):
            raise NotImplementedError(
                "complex lfilter is not supported (the filter is real: "
                "filter re and im planes independently)")
    else:
        dt = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) \
            else jnp.float32

    zi_shape = tuple(S if ax == axis else d
                     for ax, d in enumerate(x.shape))
    return_zf = zi is not None
    if zi is not None:
        zi = xp.asarray(zi)
        if zi.shape != zi_shape:
            raise ValueError(
                f"Invalid zi shape {zi.shape}; expected {zi_shape}")

    if S == 0:
        y = x * float(b[0])
        return y if zi is None else (y, xp.zeros(zi_shape, y.dtype))

    if a.size == 1:
        return _lfilter_fir(b, x, axis, zi, S, xp, is_np, return_zf)

    if D > _LFILTER_MAX_ORDER + 1:
        if zi is None and a.size <= _LFILTER_MAX_ORDER + 1:
            # long-b ARMA: exact cascade of the FIR stage (one FFT
            # convolution) and the low-order AR stage (transfer
            # functions commute with zero initial state)
            y = _lfilter_fir(b, x, axis, None, b.size - 1, xp, is_np,
                             False) if b.size > 1 else x * float(b[0])
            return lfilter(np.ones(1), a, y, axis=axis)
        raise ValueError(
            f"filter order {D - 1} > {_LFILTER_MAX_ORDER}: factor into "
            "second-order sections (scipy.signal.tf2sos) and use sosfilt "
            "— high-order direct forms are numerically unstable")
    if S > 2 and zi is None:
        # high-order zero-state IIR: run as the cascade of second-order
        # sections instead of the full-order companion scan. The
        # responses are identical; the SOS scan is numerically stable
        # where the (D-1)-dim companion product is not (repeated poles
        # near the unit circle — e.g. an order-8 gammatone at pole
        # radius 0.98 overflows the direct scan while each biquad stage
        # is perfectly conditioned). A numerator longer than the
        # denominator first splits into FIR o AR (transfer functions
        # commute at zero initial state), so the AR part takes the same
        # stable route.
        if b.size > a.size:
            y = _lfilter_fir(b, x, axis, None, b.size - 1, xp, is_np,
                             False)
            return lfilter(np.ones(1), a, y, axis=axis)
        from .design import tf2sos
        return sosfilt(tf2sos(b, a), x, axis=axis)

    b = np.concatenate([b, np.zeros(D - b.size)])
    a = np.concatenate([a, np.zeros(D - a.size)])

    xm = xp.moveaxis(x, axis, -1)
    lead = xm.shape[:-1]
    B = int(np.prod(lead)) if lead else 1
    x2 = jnp.asarray(xm.reshape(B, n), dt)
    if zi is None:
        z2 = jnp.zeros((B, S), dt)
    else:
        z2 = jnp.asarray(
            xp.moveaxis(zi, axis, -1).reshape(B, S), dt)

    run = _tf_scan_runner(b.tobytes(), a.tobytes(), D,
                          str(jnp.dtype(dt)))
    y2, zf2 = run(x2, z2)

    y = jnp.moveaxis(y2.reshape(lead + (n,)), -1, axis)
    if is_np:
        y = np.asarray(y)
    if not return_zf:
        return y
    zf = xp.moveaxis(
        (np.asarray(zf2) if is_np else zf2).reshape(lead + (S,)),
        -1, axis)
    return y, zf


def _lfilter_fir(b, x, axis, zi, S, xp, is_np, return_zf):
    """FIR branch of lfilter: ONE batched FFT convolution. y is the
    causal truncation of conv(b, x); the zi transient adds to the first
    S outputs; zf is the full-convolution tail (plus any unshifted zi
    when the signal is shorter than the filter)."""
    from .signal import fftconvolve

    x = x if np.issubdtype(np.dtype(x.dtype), np.inexact) else \
        x.astype(np.float64 if is_np else jnp.float32)
    xm = xp.moveaxis(x, axis, -1)
    n = xm.shape[-1]
    shape = [1] * xm.ndim
    shape[-1] = b.size
    bb = (b if is_np else jnp.asarray(b.astype(np.float32))).reshape(
        shape)
    yc = fftconvolve(xm, bb, mode="full", axes=(-1,))
    y = yc[..., :n]
    zim = None if zi is None else xp.moveaxis(zi, axis, -1)
    if zim is not None and S > 0:
        k = min(S, n)
        y = xp.concatenate(
            [y[..., :k] + zim[..., :k].astype(y.dtype), y[..., k:]],
            axis=-1)
    y_out = xp.moveaxis(y, -1, axis)
    if not return_zf:
        return y_out
    zf = yc[..., n:n + S]
    if zim is not None and S > n:
        # initial states not yet shifted out: zf_i += zi_{i+n}
        tail = zim[..., n:]
        pad = [(0, 0)] * tail.ndim
        pad[-1] = (0, S - tail.shape[-1])
        zf = zf + xp.pad(tail, pad).astype(zf.dtype)
    return y_out, xp.moveaxis(zf, -1, axis)


def filtfilt(b, a, x, axis: int = -1, padtype: str = "odd",
             padlen: int | None = None, method: str = "pad",
             irlen: int | None = None):
    """Zero-phase forward-backward (b, a) filtering
    (scipy.signal.filtfilt-compatible for method='pad': same default
    padlen = 3*max(len(a), len(b)), boundary extensions, and
    lfilter_zi-scaled initial conditions). method='gust' (Gustafsson) is
    not implemented — use method='pad' (the default)."""
    if method != "pad":
        raise NotImplementedError(
            "only method='pad' is implemented (Gustafsson edges are "
            "not); scipy.signal.filtfilt covers method='gust'")
    if irlen is not None:
        raise NotImplementedError("irlen only applies to method='gust'")
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if padtype not in ("even", "odd", "constant", None):
        raise ValueError(
            f"Unknown value '{padtype}' given to padtype. padtype must "
            "be 'even', 'odd', 'constant', or None.")
    if len(a) > 3 and len(b) <= len(a):
        # high-order IIR: the lfilter-with-zi dance below would run the
        # full-order companion scan, which overflows for repeated poles
        # near the unit circle (e.g. the order-8 gammatone). Run the
        # zero-phase pass through the SOS cascade instead, preserving
        # filtfilt's default padlen (sosfiltfilt's default differs).
        from .design import tf2sos
        eff_padlen = padlen if padtype is None or padlen is not None \
            else 3 * max(len(a), len(b))
        return sosfiltfilt(tf2sos(b, a), x, axis=axis, padtype=padtype,
                           padlen=eff_padlen)
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    axis = axis % x.ndim

    if padtype is None:
        edge = 0
    elif padlen is None:
        edge = 3 * max(len(a), len(b))
    else:
        edge = int(padlen)
    if x.shape[axis] <= edge:
        raise ValueError(
            "The length of the input vector x must be greater than "
            f"padlen, which is {edge}.")
    ext = _ext(x, edge, axis,
               {"constant": "const"}.get(padtype, padtype), xp)

    from .design import lfilter_zi

    zi = np.asarray(lfilter_zi(b, a), np.float64)  # (S,)
    zi_shape = [1] * x.ndim
    zi_shape[axis] = zi.size
    ziv = zi.reshape(zi_shape)
    ziv = ziv if is_np else jnp.asarray(ziv)

    def first(v):
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(0, 1)
        return v[tuple(idx)]

    def last(v):
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(v.shape[axis] - 1, v.shape[axis])
        return v[tuple(idx)]

    y, _ = lfilter(b, a, ext, axis=axis, zi=ziv * first(ext))
    y, _ = lfilter(b, a, xp.flip(y, axis=axis), axis=axis,
                   zi=ziv * last(y))
    y = xp.flip(y, axis=axis)
    if edge > 0:
        idx = [slice(None)] * y.ndim
        idx[axis] = slice(edge, y.shape[axis] - edge)
        y = y[tuple(idx)]
    return y


def _ext(x, edge: int, axis: int, padtype: str, xp):
    """scipy._arraytools odd/even/const extension by ``edge`` samples."""
    if padtype is None or edge == 0:
        return x
    n = x.shape[axis]

    def take(sl):
        idx = [slice(None)] * x.ndim
        idx[axis] = sl
        return x[tuple(idx)]

    def flip(a):
        return xp.flip(a, axis=axis)

    if padtype == "const":
        reps = [1] * x.ndim
        reps[axis] = edge
        return xp.concatenate([xp.tile(take(slice(0, 1)), reps), x,
                               xp.tile(take(slice(n - 1, n)), reps)],
                              axis=axis)
    left = flip(take(slice(1, edge + 1)))
    right = flip(take(slice(n - edge - 1, n - 1)))
    if padtype == "even":
        return xp.concatenate([left, x, right], axis=axis)
    # odd: 180-degree rotation about the end points
    first = take(slice(0, 1))
    last = take(slice(n - 1, n))
    return xp.concatenate([2 * first - left, x, 2 * last - right],
                          axis=axis)


def sosfiltfilt(sos, x, axis: int = -1, padtype: str = "odd",
                padlen: int | None = None):
    """Zero-phase forward-backward SOS filtering
    (scipy.signal.sosfiltfilt-compatible: same default padlen, odd
    boundary extension, and sosfilt_zi-scaled initial conditions)."""
    sos = _validate_sos(sos)
    ns = sos.shape[0]
    if padtype not in ("even", "odd", "constant", None):
        raise ValueError(
            f"Unknown value '{padtype}' given to padtype. padtype must "
            "be 'even', 'odd', 'constant', or None.")
    is_np = not isinstance(x, jax.Array)
    xp = np if is_np else jnp
    x = xp.asarray(x)
    axis = axis % x.ndim

    ntaps = 2 * ns + 1
    ntaps -= int(min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
    if padtype is None:
        edge = 0
    elif padlen is None:
        edge = ntaps * 3
    else:
        edge = int(padlen)
    if x.shape[axis] <= edge:
        raise ValueError(
            "The length of the input vector x must be greater than "
            f"padlen, which is {edge}.")
    ext = _ext(x, edge, axis,
               {"constant": "const"}.get(padtype, padtype), xp)

    # steady-state step-response initial conditions (host f64 design
    # constant, same discipline as window/twiddle tables)
    from .design import sosfilt_zi

    zi = np.asarray(sosfilt_zi(sos), np.float64)  # (ns, 2)
    zi_shape = [1] * x.ndim
    zi_shape[axis] = 2
    zi = zi.reshape([ns] + zi_shape)
    zi = zi if is_np else jnp.asarray(zi)

    def first(a):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(0, 1)
        return a[tuple(idx)]

    def last(a):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(a.shape[axis] - 1, a.shape[axis])
        return a[tuple(idx)]

    y, _ = sosfilt(sos, ext, axis=axis, zi=zi * first(ext))
    y, _ = sosfilt(sos, xp.flip(y, axis=axis), axis=axis,
                   zi=zi * last(y))
    y = xp.flip(y, axis=axis)
    if edge > 0:
        idx = [slice(None)] * y.ndim
        idx[axis] = slice(edge, y.shape[axis] - edge)
        y = y[tuple(idx)]
    return y
