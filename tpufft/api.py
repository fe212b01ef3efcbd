"""Public API: scipy.fft-like surface plus explicit plan objects.

The role of the reference's ``fft/fft/fft.mojo`` public layer (``plan_fft``
CPU/GPU overloads at :123-210 and ``fft`` entry points at :213-323), rebuilt
around JAX idioms: plans are lightweight frozen descriptors, execution is a
jitted function cached per (shape, dtype, axes, direction, norm, backend),
and validation happens in Python at plan time (the analog of the comptime
layout contract ``_check_layout_conditions_nd``, fft.mojo:20-47).

Complex data crosses this boundary in either of two forms:

* ordinary complex (or real) arrays — convenience form; split into re/im
  float planes on entry and recombined on the device on exit;
* ``SplitComplex(re, im)`` float-plane pairs — the plane form the transforms
  compute in; stays on device end-to-end.

Unlike the reference — whose "rfft" reads real input but always emits the
full-length spectrum (``do_rfft``, fft/fft/_fft.mojo:115-118) — this library
offers both: ``fft(real_array)`` gives the full spectrum, while
``rfft``/``irfft`` use proper Hermitian N//2+1 packing per scipy semantics.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from .config import PlanConfig
from .core import SplitComplex, real_dtype_for
from .planner import default_bases, validate_bases
from . import execute as _execute

__all__ = [
    "Plan",
    "PrecisionDowngradeWarning",
    "SplitComplex",
    "plan_fft",
    "fft", "ifft", "rfft", "irfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = (None, "backward", "ortho", "forward")


class PrecisionDowngradeWarning(UserWarning):
    """A float64/complex128 plan will compute in float32.

    Raised at plan time when ``jax_enable_x64`` is off (JAX's default).
    The reference runs f64 through its GPU tests (fft/tests.mojo:374-390);
    without x64 JAX has no f64 arrays, and the honest answer is to say so
    instead of silently returning the 1e-3 tier where 1e-6 was requested.
    Precision tiers: c64 (~1e-6 typical, 1e-3 contract), c128 under x64,
    or bf16 planes (~4e-3, opt-in via PlanConfig).
    """


def _check_x64_downgrade(dtype) -> None:
    d = jnp.dtype(dtype)
    if d in (jnp.dtype(jnp.complex128), jnp.dtype(jnp.float64)) and (
            not jax.config.jax_enable_x64):
        import warnings

        warnings.warn(
            f"plan dtype {d} requested but jax_enable_x64 is off: the "
            "transform will compute and return in the float32/complex64 "
            "tier (~1e-3, not ~1e-6). Enable x64 "
            "(jax.config.update('jax_enable_x64', True)) for true f64, or "
            "cast the input to complex64 to silence this warning.",
            PrecisionDowngradeWarning,
            stacklevel=3,
        )


def _norm_scale(norm, n_total: int, inverse: bool) -> float:
    """Total scaling for a transform over n_total points (numpy conventions)."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    norm = norm or "backward"
    if norm == "ortho":
        return 1.0 / math.sqrt(n_total)
    if (norm == "backward" and inverse) or (norm == "forward" and not inverse):
        return 1.0 / n_total
    return 1.0


def _canon_axes(ndim: int, axes) -> tuple[int, ...]:
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    for a in axes:
        # range-check BEFORE wrapping: a bare modulo silently maps any
        # negative axis (e.g. -5 on a 2D array) into range
        if not -ndim <= a < ndim:
            raise ValueError(f"axis {a} out of range for ndim {ndim}")
    axes = tuple(a % ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"repeated axes in {axes}")
    return axes


def _resize_axis(x, n: int, axis: int):
    """Crop or zero-pad ``x`` to length ``n`` along ``axis`` (scipy semantics)."""
    if x is None:
        return None
    cur = x.shape[axis]
    if cur == n:
        return x
    if cur > n:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, n)
        return x[tuple(idx)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - cur)
    return jnp.pad(x, pad)


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable FFT plan.

    Holds the static description (shapes, per-axis radix schedules, direction,
    normalization, backend choice); twiddle tables are materialized as jit-time
    constants when the cached executable first traces. The analog of the
    reference's ``_CPUPlan``/``_GPUPlan`` twiddle+scratch holders
    (fft/fft/_ndim_fft_cpu.mojo:28-60, _ndim_fft_gpu.mojo:153-207) — except
    scratch lives in XLA temp allocations and the JAX compilation cache plays
    the role of the precompiled ``.mojopkg``.
    """

    shape: tuple[int, ...]
    dtype: str
    axes: tuple[int, ...]
    lengths: tuple[int, ...]          # transform length per axis (after resize)
    bases: tuple[tuple[int, ...], ...]
    inverse: bool
    norm: str | None
    kind: str                          # "c2c" | "r2c" | "c2r"
    config: PlanConfig
    # layout="transform-major" plans (see plan_fft): ``shape``/``axes``
    # above describe the PHYSICAL plane layout (single-axis: transform
    # axis first; ND: axes permuted so the most lane-aligned transform
    # axis is minor); these record the user's logical view for
    # pack()/unpack(). ``logical_perm`` (ND) maps physical dim i to
    # logical dim logical_perm[i], i.e. physical = transpose(logical,
    # logical_perm).
    layout: str = "natural"
    logical_shape: tuple[int, ...] | None = None
    logical_axis: int | None = None
    logical_perm: tuple[int, ...] | None = None

    @functools.cached_property
    def _fn(self):
        """Jitted split-plane executable: (re, im|None) -> (re, im|None)."""
        return jax.jit(functools.partial(_apply_plan_split, plan=self))

    @functools.cached_property
    def _fn_fused(self):
        """Jitted lane-fused executable: st -> st (layout='lane-fused')."""
        return jax.jit(functools.partial(_apply_plan_fused, plan=self))

    def __call__(self, x):
        """Execute the plan.

        Output form follows the input form:
        * ``SplitComplex`` in -> ``SplitComplex`` out (planes);
        * any other array in -> a complex jax.Array (combined on the
          device by ``lax.complex``);
        * ``c2r`` returns the real plane.
        """
        if self.layout == "lane-fused":
            xn = x if isinstance(x, jax.Array) else jnp.asarray(np.asarray(x))
            expect = self.shape[:-1] + (2 * self.shape[-1],)
            if tuple(xn.shape) != expect:
                raise ValueError(
                    f"lane-fused plan expects fused shape {expect} "
                    f"(lanes [re|im]), got {tuple(xn.shape)}; use "
                    "Plan.pack() to convert")
            rdt = real_dtype_for(self.dtype)
            if (self.config.plane_dtype == "bfloat16"
                    and jnp.dtype(rdt) == jnp.dtype(jnp.float32)):
                rdt = jnp.bfloat16
            return self._fn_fused(xn.astype(rdt))
        split_io = isinstance(x, SplitComplex)
        ar, ai = self._split_input(x)
        rdt = real_dtype_for(self.dtype)
        if (self.config.plane_dtype == "bfloat16"
                and jnp.dtype(rdt) == jnp.dtype(jnp.float32)):
            # bf16-plane mode: planes live in bf16 end-to-end (the point is
            # halved memory traffic, so no f32 staging pass is inserted);
            # SplitComplex callers get bf16 planes back.
            rdt = jnp.bfloat16
        ar = ar.astype(rdt)
        ai = None if ai is None else ai.astype(rdt)
        outr, outi = self._fn(ar, ai)
        if self.kind == "c2r":
            if split_io:
                return SplitComplex(outr, jnp.zeros_like(outr))
            if jnp.dtype(outr.dtype) == jnp.dtype(jnp.bfloat16):
                outr = outr.astype(jnp.float32)
            return outr
        if split_io:
            return SplitComplex(outr, outi)
        if jnp.dtype(outr.dtype) == jnp.dtype(jnp.bfloat16):
            outr = outr.astype(jnp.float32)
            outi = outi.astype(jnp.float32)
        return jax.lax.complex(outr, outi)

    def _split_input(self, x):
        if isinstance(x, SplitComplex):
            if self.kind == "r2c":
                raise TypeError("rfft requires real input, got SplitComplex")
            ar, ai = x.re, x.im
        elif isinstance(x, tuple):
            raise TypeError(
                "pass plane pairs as SplitComplex(re, im), not a bare tuple"
            )
        else:
            is_np = not isinstance(x, jax.Array)
            xn = np.asarray(x) if is_np else x
            if np.issubdtype(np.dtype(xn.dtype), np.complexfloating):
                if self.kind == "r2c":
                    raise TypeError(
                        f"rfft requires real input, got dtype {xn.dtype}"
                    )
                if is_np:
                    ar = jnp.asarray(np.ascontiguousarray(xn.real))
                    ai = jnp.asarray(np.ascontiguousarray(xn.imag))
                else:
                    ar, ai = xn.real, xn.imag
            else:
                ar, ai = jnp.asarray(xn), None
        if tuple(ar.shape) != self.shape:
            raise ValueError(
                f"plan was built for shape {self.shape}, got {tuple(ar.shape)}"
            )
        return ar, ai

    @property
    def out_shape(self) -> tuple[int, ...]:
        shape = list(self.shape)
        for a, n in zip(self.axes, self.lengths):
            shape[a] = n
        if self.kind == "r2c":
            shape[self.axes[-1]] = self.lengths[-1] // 2 + 1
        elif self.kind == "c2r":
            shape[self.axes[-1]] = self.lengths[-1]
        return tuple(shape)

    # -- transform-major layout conversion ---------------------------------
    # The conversion is the expensive repack the layout exists to avoid;
    # pack once at pipeline entry (host-side when the data starts on host),
    # keep planes in plan layout across every call, unpack once at exit.

    def pack(self, x):
        """Convert a LOGICAL-layout array to this plan's physical layout.

        Host numpy input converts on host (the device never sees the
        unfavourable layout); device input pays one on-device repack.
        transform-major -> SplitComplex with the transform axis first;
        lane-fused -> ONE real array (..., n1, n2, 2*n3), lanes [re|im]."""
        if self.layout == "lane-fused":
            if isinstance(x, SplitComplex):
                return jnp.concatenate([x.re, x.im], axis=-1)
            if isinstance(x, jax.Array):
                re = jnp.real(x)
                im = (jnp.imag(x) if jnp.iscomplexobj(x)
                      else jnp.zeros_like(re))
                return jnp.concatenate([re, im], axis=-1)
            xn = np.asarray(x)
            rdt = np.float64 if xn.dtype in (np.complex128, np.float64) \
                else np.float32
            re = np.asarray(xn.real, rdt)
            im = (np.asarray(xn.imag, rdt) if np.iscomplexobj(xn)
                  else np.zeros_like(re))
            return jnp.asarray(np.concatenate([re, im], axis=-1))
        if self.layout != "transform-major":
            return SplitComplex.from_array(x)
        if self.logical_perm is not None:       # ND: full permutation
            def to_phys(a, xp):
                return xp.transpose(a, self.logical_perm)
        else:                                   # single axis: axis first
            def to_phys(a, xp):
                return xp.moveaxis(a, self.logical_axis, 0)
        if isinstance(x, SplitComplex):
            return SplitComplex(to_phys(x.re, jnp), to_phys(x.im, jnp))
        if isinstance(x, jax.Array):
            re, im = jnp.real(x), (jnp.imag(x) if jnp.iscomplexobj(x)
                                   else jnp.zeros_like(jnp.real(x)))
            return SplitComplex(to_phys(re, jnp), to_phys(im, jnp))
        xn = np.asarray(x)
        rdt = np.float64 if xn.dtype in (np.complex128, np.float64) \
            else np.float32
        re = np.ascontiguousarray(to_phys(xn.real, np), dtype=rdt)
        im = np.ascontiguousarray(
            to_phys(xn.imag, np) if np.iscomplexobj(xn)
            else np.zeros_like(re), dtype=rdt)
        return SplitComplex(jnp.asarray(re), jnp.asarray(im))

    def unpack(self, y):
        """Convert a plan-layout result back to the LOGICAL layout.

        transform-major: ``SplitComplex`` in -> ``SplitComplex`` out (one
        on-device moveaxis); numpy complex otherwise (combined on host).
        lane-fused: fused array -> ``SplitComplex`` (device, two lane
        slices) or numpy complex (host)."""
        if self.layout == "lane-fused":
            n3 = self.lengths[-1]
            if isinstance(y, jax.Array):
                re, im = y[..., :n3], y[..., n3:]
                if jnp.dtype(re.dtype) == jnp.dtype(jnp.bfloat16):
                    re, im = (re.astype(jnp.float32),
                              im.astype(jnp.float32))
                return SplitComplex(re, im)
            yn = np.asarray(y)
            return yn[..., :n3] + 1j * yn[..., n3:]
        if self.layout != "transform-major":
            return y
        if self.logical_perm is not None:
            inv = tuple(np.argsort(self.logical_perm))

            def to_log(a, xp):
                return xp.transpose(a, inv)
        else:
            def to_log(a, xp):
                return xp.moveaxis(a, 0, self.logical_axis)
        if isinstance(y, SplitComplex):
            return SplitComplex(to_log(y.re, jnp), to_log(y.im, jnp))
        yn = y if isinstance(y, np.ndarray) else np.asarray(y)
        return np.ascontiguousarray(to_log(yn, np))


def _apply_plan_fused(st, *, plan: "Plan"):
    """Trace-time body for layout='lane-fused' plans: one array whose
    minor axis holds [re(k) | im(k)] for the minor transform axis. The
    transform runs on the two lane halves as split planes and concatenates
    them back."""
    n3 = plan.lengths[-1]
    outr, outi = _apply_plan_split(st[..., :n3], st[..., n3:], plan=plan)
    return jnp.concatenate([outr, outi], axis=-1)


def _apply_plan_split(ar, ai, *, plan: Plan):
    """Trace-time body shared by every plan executable (split planes)."""
    axes, lengths = plan.axes, plan.lengths
    n_total = math.prod(lengths)
    scale = _norm_scale(plan.norm, n_total, plan.inverse)

    if plan.kind == "r2c":
        return _apply_r2c(ar, ai, plan, scale)
    if plan.kind == "c2r":
        return _apply_c2r(ar, ai, plan, scale)

    for a, n in zip(axes, lengths):
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    # the whole normalization is fused into the last axis's transform
    for i, a in enumerate(axes):
        ar, ai = _execute.fft_axis(
            ar, ai, a, plan.bases[i], inverse=plan.inverse,
            scale=scale if i == len(axes) - 1 else 1.0,
        )
    return ar, ai


def _apply_r2c(ar, ai, plan: Plan, scale: float):
    """rfft[n]: packed transform of the last axis, then plain C2C over the
    remaining axes on the (n//2+1)-packed data (numpy semantics and cost).

    For even lengths the last axis uses the classic half-length trick —
    the N real samples become N/2 complex points (even samples as the real
    plane, odd as the imaginary plane: no zero plane is ever read), one
    length-N/2 C2C, and an O(N) Hermitian untangle. This is the packed-rfft
    speed the reference never implements (its do_rfft only skips imaginary
    reads in stage one, fft/fft/_fft.mojo:115-118).
    """
    axes, lengths = plan.axes, plan.lengths
    for a, n in zip(axes, lengths):
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    n_last = lengths[-1]
    s_last = scale if len(axes) == 1 else 1.0
    if n_last % 2 == 0 and ai is None and n_last >= 2:
        ar, ai = _rfft_packed_last(ar, axes[-1], n_last, s_last)
    else:
        ar, ai = _execute.fft_axis(
            ar, ai, axes[-1], plan.bases[-1], inverse=False, scale=s_last,
        )
        sl = [slice(None)] * ar.ndim
        sl[axes[-1]] = slice(0, n_last // 2 + 1)
        ar, ai = ar[tuple(sl)], ai[tuple(sl)]
    for i, (a, n) in enumerate(zip(axes[:-1], lengths[:-1])):
        axis_scale = scale if i == len(axes) - 2 else 1.0
        ar, ai = _execute.fft_axis(
            ar, ai, a, plan.bases[i], inverse=False, scale=axis_scale,
        )
    return ar, ai


def _apply_c2r(ar, ai, plan: Plan, scale: float):
    """irfft[n]: inverse C2C over the leading axes on packed data, then a
    packed half-length inverse of the last axis (even lengths) or the
    legacy full-length Hermitian-extend path (odd lengths)."""
    axes, lengths = plan.axes, plan.lengths
    n_last = lengths[-1]
    for a, n in zip(axes[:-1], lengths[:-1]):
        ar, ai = _resize_axis(ar, n, a), _resize_axis(ai, n, a)
    if n_last % 2 == 0 and n_last >= 2:
        if ai is None:
            ai = jnp.zeros_like(ar)
        ar, ai = _resize_axis(ar, n_last // 2 + 1, axes[-1]), _resize_axis(
            ai, n_last // 2 + 1, axes[-1])
        for i, a in enumerate(axes[:-1]):
            ar, ai = _execute.fft_axis(
                ar, ai, a, plan.bases[i], inverse=True, scale=1.0,
            )
        out = _irfft_packed_last(ar, ai, axes[-1], n_last, 2.0 * scale)
        return out, None
    # legacy: Hermitian-extend to full length, inverse C2C everywhere
    ar, ai = _hermitian_extend(
        ar, ai, n_last, axes[-1], other_axes=axes[:-1]
    )
    for i, (a, n) in enumerate(zip(axes, lengths)):
        axis_scale = scale if i == len(axes) - 1 else 1.0
        ar, ai = _execute.fft_axis(
            ar, ai, a, plan.bases[i], inverse=True, scale=axis_scale,
        )
    return ar, None


def _half_twiddle(m: int, n: int):
    """Host W[k] = exp(-2*pi*i*k/n) for k in [0, m] (f64 -> f32 planes)."""
    k = np.arange(m + 1, dtype=np.float64)
    theta = -2.0 * np.pi * k / n
    return np.cos(theta), np.sin(theta)


def _rfft_packed_last(ar, axis, n, scale):
    """Half-length packed rfft along ``axis`` (n even, real input plane)."""
    from .planner import default_bases

    m = n // 2
    ar = jnp.moveaxis(ar, axis, -1)
    pre = ar.shape[:-1]
    x2 = ar.reshape(pre + (m, 2))
    ze, zo = x2[..., 0], x2[..., 1]
    zr, zi = _execute.fft_axis(
        ze, zo, ar.ndim - 1, default_bases(m), inverse=False, scale=scale,
    )
    # k-indexed (length m+1) views: Z[k % m] and Z[(m - k) % m]
    zk_r = jnp.concatenate([zr, zr[..., :1]], -1)
    zk_i = jnp.concatenate([zi, zi[..., :1]], -1)
    zj_r = jnp.concatenate([zr[..., :1], jnp.flip(zr[..., 1:], -1),
                            zr[..., :1]], -1)
    zj_i = jnp.concatenate([zi[..., :1], jnp.flip(zi[..., 1:], -1),
                            zi[..., :1]], -1)
    # Xe = (Z + conj(Zj))/2 ; Xo = -i (Z - conj(Zj))/2
    ae = (zk_r + zj_r) * 0.5
    be = (zk_i - zj_i) * 0.5
    ao = (zk_i + zj_i) * 0.5
    bo = (zj_r - zk_r) * 0.5
    wr_h, wi_h = _half_twiddle(m, n)
    wr = jnp.asarray(wr_h, ar.dtype)
    wi = jnp.asarray(wi_h, ar.dtype)
    xr = ae + wr * ao - wi * bo
    xi = be + wr * bo + wi * ao
    return jnp.moveaxis(xr, -1, axis), jnp.moveaxis(xi, -1, axis)


def _irfft_packed_last(ar, ai, axis, n, inner_scale):
    """Half-length packed irfft along ``axis`` (n even). ``inner_scale`` is
    2 * user_scale (the pipeline's inherent 1/2 folded in); returns the real
    output plane."""
    from .planner import default_bases

    m = n // 2
    ar = jnp.moveaxis(ar, axis, -1)
    ai = jnp.moveaxis(ai, axis, -1)
    pre = ar.shape[:-1]
    # numpy convention: the imaginary parts of the DC and Nyquist bins are
    # inert (irfft == ifft(hermitian_mirror).real); zeroing them makes the
    # packed spectrum exactly Hermitian, where this reconstruction is exact.
    ai = ai.at[..., 0].set(0.0).at[..., m].set(0.0)
    # Xc[k] = conj(X[m-k]) for k in [0, m)
    xc_r = jnp.flip(ar[..., 1:], -1)
    xc_i = -jnp.flip(ai[..., 1:], -1)
    xr, xi = ar[..., :m], ai[..., :m]
    # Xe = (X + Xc)/2 ; (W Xo) = (X - Xc)/2 ; Xo = conj(W) * (W Xo)
    er = (xr + xc_r) * 0.5
    ei = (xi + xc_i) * 0.5
    ur = (xr - xc_r) * 0.5
    ui = (xi - xc_i) * 0.5
    wr_h, wi_h = _half_twiddle(m - 1, n)  # k in [0, m)
    wr = jnp.asarray(wr_h, ar.dtype)
    wi = jnp.asarray(wi_h, ar.dtype)
    # conj(W) = (wr, -wi)
    or_ = wr * ur + wi * ui
    oi = wr * ui - wi * ur
    # Z = Xe + i Xo
    zr = er - oi
    zi = ei + or_
    zr, zi = _execute.fft_axis(
        zr, zi, ar.ndim - 1, default_bases(m), inverse=True,
        scale=inner_scale,
    )
    out = jnp.stack([zr, zi], -1).reshape(pre + (n,))
    return jnp.moveaxis(out, -1, axis)


def _hermitian_extend(ar, ai, n: int, axis: int, other_axes: tuple[int, ...]):
    """Rebuild the full spectrum from N//2+1 Hermitian-packed coefficients.

    Multi-axis Hermitian symmetry is X[-k1, ..., -kd] = conj(X[k1, ..., kd]),
    so the mirrored half must be conjugate-*and*-index-negated along every
    other transformed axis, not just flipped along the packed one. Conjugation
    in split planes is a sign flip on the imaginary plane.
    """
    if ai is None:
        ai = jnp.zeros_like(ar)
    m = ar.shape[axis]
    expected = n // 2 + 1
    if m != expected:
        ar, ai = _resize_axis(ar, expected, axis), _resize_axis(ai, expected, axis)
    idx = [slice(None)] * ar.ndim
    idx[axis] = slice(1, (n + 1) // 2)
    mir_r = jnp.flip(ar[tuple(idx)], axis=axis)
    mir_i = -jnp.flip(ai[tuple(idx)], axis=axis)
    for a in other_axes:
        # index negation mod n_a: k -> (-k) % n_a  ==  roll(flip, 1)
        mir_r = jnp.roll(jnp.flip(mir_r, axis=a), 1, axis=a)
        mir_i = jnp.roll(jnp.flip(mir_i, axis=a), 1, axis=a)
    head = [slice(None)] * ar.ndim
    head[axis] = slice(0, n // 2 + 1)
    return (
        jnp.concatenate([ar[tuple(head)], mir_r], axis=axis),
        jnp.concatenate([ai[tuple(head)], mir_i], axis=axis),
    )


def _resolve_bases(lengths, bases, cfg: PlanConfig):
    if bases is None:
        return tuple(default_bases(n, cfg.max_radix) for n in lengths)
    if bases and isinstance(bases[0], (int, np.integer)):
        bases = [bases]
    if len(bases) != len(lengths):
        raise ValueError(
            f"need one radix list per transformed axis ({len(lengths)}), "
            f"got {len(bases)}"
        )
    return tuple(validate_bases(n, b) for n, b in zip(lengths, bases))


@functools.lru_cache(maxsize=1024)
def _cached_plan(shape, dtype, axes, lengths, bases, inverse, norm, kind,
                 config, layout="natural", logical_shape=None,
                 logical_axis=None, logical_perm=None):
    return Plan(
        shape=shape, dtype=dtype, axes=axes, lengths=lengths, bases=bases,
        inverse=inverse, norm=norm, kind=kind, config=config, layout=layout,
        logical_shape=logical_shape, logical_axis=logical_axis,
        logical_perm=logical_perm,
    )


def _lane_util(n: int) -> float:
    """Share of whole 128-element rows a length fills:
    n / (ceil(n/128)*128). 1.0 = a multiple of 128; 93 gives 0.73."""
    return n / (-(-n // 128) * 128)


def _resolve_fast_length(v, current: int) -> int:
    """Resolve one ``s``/``n`` entry: an int, or the auto-pad conveniences
    "fast" (next 7-smooth length) / "fast-aligned" (additionally a
    multiple of 128); see planner.next_fast_len."""
    if isinstance(v, str):
        from .planner import next_fast_len

        if v == "fast":
            return next_fast_len(current)
        if v == "fast-aligned":
            return next_fast_len(current, aligned=True)
        raise ValueError(
            f"length spec must be an int, 'fast' or 'fast-aligned', got {v!r}"
        )
    return int(v)


def _axes_from_s(s, axes):
    """scipy semantics: ``s`` given with ``axes=None`` applies to the LAST
    len(s) axes."""
    if axes is None and s is not None and not isinstance(s, str):
        return tuple(range(-len(s), 0))
    return axes


def plan_fft(
    shape: Sequence[int],
    dtype=jnp.complex64,
    *,
    axes=None,
    s: Sequence[int] | None = None,
    inverse: bool = False,
    norm: str | None = None,
    kind: str = "c2c",
    bases=None,
    config: PlanConfig | None = None,
    layout: str = "natural",
) -> Plan:
    """Build (and cache) an FFT plan. Analog of the reference ``plan_fft``
    overloads (fft/fft/fft.mojo:123-210) with the GPU knobs replaced by
    ``PlanConfig``.

    ``layout="transform-major"`` (c2c only): the plan's device planes
    store another axis order, with the same logical semantics. Single
    axis: the transform axis FIRST — ``moveaxis(x, axis, 0)``. Multiple
    axes: the transform axes are permuted so the length that fills whole
    128-element rows best is MINOR. Convert once at the pipeline edges
    with ``Plan.pack`` / ``Plan.unpack`` (host numpy converts on the host
    side) and keep planes in plan layout between calls. Whether either
    order is faster on the GPU is not measured yet."""
    cfg = config or PlanConfig()
    shape = tuple(int(d) for d in shape)
    _check_x64_downgrade(dtype)
    if norm not in _NORMS:  # fail at plan time, not first execution
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    axes = _axes_from_s(s, axes)
    axes = _canon_axes(len(shape), axes)
    if isinstance(s, str):
        s = (s,) * len(axes)
    if layout not in ("natural", "transform-major", "lane-fused"):
        raise ValueError(
            "layout must be 'natural', 'transform-major' or 'lane-fused', "
            f"got {layout!r}")
    if layout == "lane-fused":
        if kind != "c2c" or len(axes) < 3 or s is not None:
            raise ValueError(
                "layout='lane-fused' supports >=3-axis c2c plans without "
                "resize (s)")
        if (len(shape) - 3 not in axes or len(shape) - 2 not in axes
                or len(shape) - 1 not in axes):
            raise ValueError(
                "layout='lane-fused' requires the transform axes to "
                f"include the last three, got {axes}")
        # canonicalize to ascending order (a multi-axis c2c FFT is
        # order-independent): _apply_plan_fused peels axes[:-3] as
        # leading passes and treats axes[-3:] as the cube, so an
        # unsorted tuple would transform the wrong dims
        axes = tuple(sorted(axes))
        lengths = tuple(shape[a] for a in axes)
        bases = _resolve_bases(lengths, bases, cfg)
        return _cached_plan(
            shape, str(jnp.dtype(dtype)), axes, lengths, bases, inverse,
            norm, kind, cfg, layout, shape, None,
        )
    if layout == "transform-major":
        if kind != "c2c":
            raise ValueError(
                "layout='transform-major' supports c2c plans")
        if len(axes) == 1:
            ax = axes[0]
            logical_shape = shape
            phys = (shape[ax],) + tuple(d for i, d in enumerate(shape)
                                        if i != ax)
            n = (shape[ax] if s is None
                 else _resolve_fast_length(s[0], shape[ax]))
            bases = _resolve_bases((n,), bases, cfg)
            return _cached_plan(
                phys, str(jnp.dtype(dtype)), (0,), (n,), bases, inverse,
                norm, kind, cfg, layout, logical_shape, ax,
            )
        # ND: permute so the most row-aligned transform axis is MINOR. A
        # multi-axis c2c FFT is a separable product — execution order is
        # free — so the permutation only changes the physical plane
        # layout, never the semantics.
        if s is not None:
            raise ValueError(
                "layout='transform-major' with multiple axes does not "
                "support resize (s)")
        batch = tuple(i for i in range(len(shape)) if i not in axes)
        order = sorted(axes, key=lambda a: (_lane_util(shape[a]), shape[a]))
        perm = batch + tuple(order)
        phys = tuple(shape[p] for p in perm)
        k = len(axes)
        phys_axes = tuple(range(len(shape) - k, len(shape)))
        lengths = tuple(phys[a] for a in phys_axes)
        bases = _resolve_bases(lengths, bases, cfg)
        return _cached_plan(
            phys, str(jnp.dtype(dtype)), phys_axes, lengths, bases,
            inverse, norm, kind, cfg, layout, shape, None, perm,
        )
    if s is None:
        lengths = tuple(shape[a] for a in axes)
        if kind == "c2r":
            lengths = lengths[:-1] + (2 * (shape[axes[-1]] - 1),)
    else:
        if len(s) != len(axes):
            raise ValueError(f"len(s)={len(s)} must equal len(axes)={len(axes)}")
        lengths = tuple(
            _resolve_fast_length(v, shape[a]) for v, a in zip(s, axes)
        )
    bases = _resolve_bases(lengths, bases, cfg)
    return _cached_plan(
        shape, str(jnp.dtype(dtype)), axes, lengths, bases, inverse, norm,
        kind, cfg,
    )


def _logical_dtype(x):
    """The plan dtype for an input: its own dtype, or c64/c128 for planes."""
    if isinstance(x, SplitComplex):
        d = jnp.dtype(x.dtype)
        return jnp.complex128 if d == jnp.dtype(jnp.float64) else jnp.complex64
    xn = x if isinstance(x, jax.Array) else np.asarray(x)
    return xn.dtype


def _plan_for(x, axes, s, inverse, norm, kind, bases, config):
    shape = tuple(x.shape) if isinstance(x, SplitComplex) else np.shape(x)
    plan = plan_fft(
        shape, _logical_dtype(x), axes=axes, s=s, inverse=inverse,
        norm=norm, kind=kind, bases=bases, config=config,
    )
    return plan


# ----------------------------------------------------------------------------
# scipy.fft-like functional surface
# ----------------------------------------------------------------------------

def fft(x, n=None, axis=-1, norm=None, *, bases=None, config=None):
    """1D complex FFT (real input allowed; full spectrum out)."""
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, False, norm, "c2c", bases, config)(x)


def ifft(x, n=None, axis=-1, norm=None, *, bases=None, config=None):
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, True, norm, "c2c", bases, config)(x)


def rfft(x, n=None, axis=-1, norm=None, *, bases=None, config=None):
    s = None if n is None else (n,)
    return _plan_for(x, (axis,), s, False, norm, "r2c", bases, config)(x)


def irfft(x, n=None, axis=-1, norm=None, *, bases=None, config=None):
    if n is None:
        n = 2 * (np.shape(x)[axis] - 1)
    return _plan_for(x, (axis,), (n,), True, norm, "c2r", bases, config)(x)


def fftn(x, s=None, axes=None, norm=None, *, bases=None, config=None):
    return _plan_for(x, axes, s, False, norm, "c2c", bases, config)(x)


def ifftn(x, s=None, axes=None, norm=None, *, bases=None, config=None):
    return _plan_for(x, axes, s, True, norm, "c2c", bases, config)(x)


def rfftn(x, s=None, axes=None, norm=None, *, bases=None, config=None):
    return _plan_for(x, axes, s, False, norm, "r2c", bases, config)(x)


def irfftn(x, s=None, axes=None, norm=None, *, bases=None, config=None):
    shape = tuple(x.shape) if isinstance(x, SplitComplex) else np.shape(x)
    axes = _axes_from_s(s, axes)
    axes_c = _canon_axes(len(shape), axes)
    if s is None:
        s = tuple(shape[a] for a in axes_c[:-1]) + (
            2 * (shape[axes_c[-1]] - 1),
        )
    return _plan_for(x, axes_c, s, True, norm, "c2r", bases, config)(x)


def fft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return fftn(x, s=s, axes=axes, norm=norm, **kw)


def ifft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return ifftn(x, s=s, axes=axes, norm=norm, **kw)


def rfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return rfftn(x, s=s, axes=axes, norm=norm, **kw)


def irfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return irfftn(x, s=s, axes=axes, norm=norm, **kw)


def _conj_any(x):
    if isinstance(x, SplitComplex):
        return x.conj()
    xn = x if isinstance(x, jax.Array) else np.asarray(x)
    return np.conj(xn) if isinstance(xn, np.ndarray) else jnp.conj(xn)


def hfft(x, n=None, axis=-1, norm=None, **kw):
    """FFT of Hermitian-symmetric input (real spectrum out).

    hfft(x, n) == irfft(conj(x), n) * n under backward norm; other norms
    follow from the forward/backward scale identity.
    """
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if n is None:
        n = 2 * (np.shape(x)[axis] - 1)
    res = irfft(_conj_any(x), n=n, axis=axis, norm=None, **kw)
    scale = {None: float(n), "backward": float(n),
             "ortho": math.sqrt(n), "forward": 1.0}[norm]
    if isinstance(res, SplitComplex):
        s = jnp.asarray(scale, res.dtype)
        return SplitComplex(res.re * s, res.im * s)
    return res * jnp.asarray(scale, res.dtype)


def ihfft(x, n=None, axis=-1, norm=None, **kw):
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if n is None:
        n = np.shape(x)[axis]
    res = rfft(x, n=n, axis=axis, norm=None, **kw)
    scale = {None: 1.0 / n, "backward": 1.0 / n,
             "ortho": 1.0 / math.sqrt(n), "forward": 1.0}[norm]
    res = _conj_any(res)
    if isinstance(res, SplitComplex):
        s = jnp.asarray(scale, res.dtype)
        return SplitComplex(res.re * s, res.im * s)
    return res * scale


def _hfft_scale(res, n_total, norm, inverse):
    """Apply the hfft/ihfft norm-rescale over the product of the
    transformed lengths (scipy's norm convention for the
    Hermitian-transform family)."""
    if inverse:
        scale = {None: 1.0 / n_total, "backward": 1.0 / n_total,
                 "ortho": 1.0 / math.sqrt(n_total), "forward": 1.0}[norm]
    else:
        scale = {None: float(n_total), "backward": float(n_total),
                 "ortho": math.sqrt(n_total), "forward": 1.0}[norm]
    if isinstance(res, SplitComplex):
        s = jnp.asarray(scale, res.dtype)
        return SplitComplex(res.re * s, res.im * s)
    return res * jnp.asarray(scale, res.dtype)


def hfftn(x, s=None, axes=None, norm=None, **kw):
    """ND FFT of an array Hermitian-symmetric in its last transformed axis
    (real spectrum out): hfftn(x, s, axes) == irfftn(conj(x), s, axes) * N
    under backward norm, N = prod of transformed output lengths
    (scipy.fft.hfftn semantics)."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    res = irfftn(_conj_any(x), s=s, axes=axes, norm=None, **kw)
    # output of irfftn carries the full (real) transform lengths
    shape = res.shape
    ax = _canon_axes(len(shape), _axes_from_s(s, axes))
    n_total = math.prod(shape[a] for a in ax)
    return _hfft_scale(res, n_total, norm, inverse=False)


def hfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return hfftn(x, s=s, axes=axes, norm=norm, **kw)


def ihfftn(x, s=None, axes=None, norm=None, **kw):
    """Inverse of hfftn: real input, Hermitian half-spectrum out
    (scipy.fft.ihfftn semantics)."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    in_shape = np.shape(x)
    ax = _canon_axes(len(in_shape), _axes_from_s(s, axes))
    # transform lengths come from s (or the INPUT shape — the rfftn output
    # packs the last transformed axis to n//2+1, which must not enter the
    # norm scale); "fast"/"fast-aligned" string specs resolve per axis
    if s is not None:
        s_seq = (s,) * len(ax) if isinstance(s, str) else s
        lengths = tuple(_resolve_fast_length(v, in_shape[a])
                        for v, a in zip(s_seq, ax))
    else:
        lengths = tuple(in_shape[a] for a in ax)
    n_total = math.prod(lengths)
    res = _conj_any(rfftn(x, s=s, axes=axes, norm=None, **kw))
    return _hfft_scale(res, n_total, norm, inverse=True)


def ihfft2(x, s=None, axes=(-2, -1), norm=None, **kw):
    return ihfftn(x, s=s, axes=axes, norm=norm, **kw)


# ----------------------------------------------------------------------------
# Helper functions (host-side, numpy semantics)
# ----------------------------------------------------------------------------

def fftfreq(n, d=1.0, *, dtype=None):
    dtype = dtype or jnp.float32
    results = jnp.empty(n, dtype)
    m = (n - 1) // 2 + 1
    results = results.at[:m].set(jnp.arange(0, m, dtype=dtype))
    results = results.at[m:].set(jnp.arange(-(n // 2), 0, dtype=dtype))
    return results / (n * d)


def rfftfreq(n, d=1.0, *, dtype=None):
    dtype = dtype or jnp.float32
    return jnp.arange(0, n // 2 + 1, dtype=dtype) / (n * d)


def _shift(x, axes, sign):
    if isinstance(x, SplitComplex):
        return SplitComplex(_shift(x.re, axes, sign), _shift(x.im, axes, sign))
    # numpy in -> numpy out
    xp = jnp if isinstance(x, jax.Array) else np
    x = xp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return xp.roll(x, [sign * (x.shape[a] // 2) for a in axes], axes)


def fftshift(x, axes=None):
    return _shift(x, axes, 1)


def ifftshift(x, axes=None):
    return _shift(x, axes, -1)
