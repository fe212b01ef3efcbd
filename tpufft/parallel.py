"""Multi-chip execution: sharded batches and distributed transforms.

The reference is single-device (SURVEY.md §2 parallelism checklist: no
DP/TP/PP/SP and no communication backend at all) — its only parallelism is
threads within a chip. This framework goes beyond parity with a
``jax.sharding.Mesh`` over the devices with

* **batch sharding** (the DP analog): leading batch axes sharded across a
  mesh axis; every device runs the ordinary local plan — XLA inserts no
  collectives;
* **distributed transform axis** (the SP/TP analog): a 1D FFT along an axis
  block-sharded over a mesh axis, via the Bailey/four-step factorization
  N = A * B with the flat index n = a*B + b (a slow) and k = kb*A + ka:

      X[kb*A + ka] = sum_b e^{-2pi i b kb/B}
                       ( e^{-2pi i b ka/N}
                         sum_a e^{-2pi i a ka/A} x[a*B + b] )

  realized as: all_to_all (rows->columns), local length-A FFTs, sharded
  twiddle multiply, all_to_all (columns->rows), local length-B FFTs, and —
  only when natural output order is requested — a third all_to_all plus a
  local transpose. ``permuted_out=True`` skips that last exchange and
  returns the spectrum in (ka, kb)-major order (FFTW MPI's TRANSPOSED_OUT);
  ``permuted_in=True`` consumes exactly that order, so an
  fft->pointwise->ifft pipeline pays 2 exchanges per direction instead of 3.

All exchanges are ``lax.all_to_all`` (NCCL over NVLink on a GPU host).
Everything moves as split re/im float planes (core.SplitComplex), the
representation the local transforms compute in.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from .config import PlanConfig
from .core import SplitComplex
from .execute import fft_axis
from .planner import default_bases, factorize

__all__ = [
    "split_n",
    "fft_distributed",
    "fftn_distributed",
    "rfft_distributed",
    "irfft_distributed",
    "fft_batch_sharded",
    "filter_distributed",
]


def split_n(n: int, d: int) -> tuple[int, int]:
    """Factor n = A * B with d | A and d | B, A as close to sqrt(n) as the
    factorization allows.

    The four-step decomposition needs the slow factor divisible by the
    device count (row-block sharding of a) and the fast factor divisible too
    (the all_to_all splits b into d blocks). Lengths with d | n but
    d^2 ∤ n cannot use this exchange pattern; ``fft_distributed`` falls
    back to the all_gather body for those (see ``_body_gather``).
    """
    if n % (d * d) != 0:
        raise ValueError(
            f"distributed FFT needs d^2 | n (n={n}, d={d}); pad the axis or "
            "use batch sharding instead"
        )
    a = d
    for f in sorted(factorize(n // (d * d)), reverse=True):
        if a * f <= math.isqrt(n):
            a *= f
    b = n // a
    assert a % d == 0 and b % d == 0
    return a, b


@functools.lru_cache(maxsize=None)
def _interfactor_twiddle(a: int, b: int, inverse: bool):
    """Host f64 twiddle planes T[ka, b] = e^{-+2pi i b ka / (a*b)}, shape
    (a, b) (cast to the plane dtype at the use site so f64 meshes keep the
    f64 tier)."""
    sign = 1.0 if inverse else -1.0
    k = np.outer(np.arange(a, dtype=np.float64),
                 np.arange(b, dtype=np.float64))
    theta = (sign * 2.0 * np.pi / (a * b)) * k
    return np.cos(theta), np.sin(theta)


def _a2a(x, axis_name: str, split_axis: int, concat_axis: int):
    return jax.lax.all_to_all(
        x, axis_name, split_axis=split_axis, concat_axis=concat_axis
    )


def _twiddle_mul(ar, ai, twr, twi):
    return ar * twr - ai * twi, ar * twi + ai * twr


def _body_natural_in(
    ar, ai, twr, twi, *, A, B, d, axis_name, inverse, scale,
    bases_a, bases_b, natural_out,
):
    """Device-local pipeline for block-natural input along the last axis.

    Local input: (..., N/d) = rows a in [my_block], all b.
    """
    pre = ar.shape[:-1]
    k = len(pre)
    rows, bloc = A // d, B // d

    def e1(x):  # (rows, B) -> (A, bloc): gather a, scatter b
        x = x.reshape(pre + (rows, d, bloc))
        x = _a2a(x, axis_name, k + 1, k)
        return x.reshape(pre + (A, bloc))

    def e2(x):  # (A, bloc) -> (rows, B): scatter ka, gather b
        x = x.reshape(pre + (d, rows, bloc))
        x = _a2a(x, axis_name, k, k + 1)
        return x.reshape(pre + (rows, B))

    def e3(x):  # (rows, B) -> natural (bloc_k * A,): scatter kb, gather ka
        x = x.reshape(pre + (rows, d, bloc))
        x = _a2a(x, axis_name, k + 1, k)
        x = x.reshape(pre + (A, bloc))
        return jnp.swapaxes(x, -2, -1).reshape(pre + (bloc * A,))

    ar = ar.reshape(pre + (A // d, B))
    ai = ai.reshape(pre + (A // d, B))
    ar, ai = e1(ar), e1(ai)
    # FFT over a (length A) for every local b column.
    ar, ai = fft_axis(ar, ai, ar.ndim - 2, bases_a, inverse=inverse,
                      scale=1.0)
    ar, ai = _twiddle_mul(ar, ai, twr, twi)   # T[ka, b], b-sharded slice
    ar, ai = e2(ar), e2(ai)
    # FFT over b (length B) for every local ka row; fold the norm scale here.
    ar, ai = fft_axis(ar, ai, ar.ndim - 1, bases_b, inverse=inverse,
                      scale=scale)
    if natural_out:
        return e3(ar), e3(ai)
    return ar.reshape(pre + (rows * B,)), ai.reshape(pre + (rows * B,))


def _body_permuted_in(
    ar, ai, twr, twi, *, A, B, d, axis_name, inverse, scale,
    bases_a, bases_b,
):
    """Device-local pipeline for (ka, kb)-major ("transposed") input: the
    exact mirror of ``_body_natural_in`` without the final exchange. Output
    is always block-natural.

    Local input: (..., N/d) viewed as (rows of ka in [my_block], all kb).
    """
    pre = ar.shape[:-1]
    k = len(pre)
    rows, bloc = A // d, B // d
    ar = ar.reshape(pre + (rows, B))
    ai = ai.reshape(pre + (rows, B))
    # FFT over kb (length B, local fast axis).
    ar, ai = fft_axis(ar, ai, ar.ndim - 1, bases_b, inverse=inverse,
                      scale=1.0)
    ar, ai = _twiddle_mul(ar, ai, twr, twi)   # T[ka, b], ka-sharded slice

    def gather_a(x):  # (rows, B) -> (A, bloc)
        x = x.reshape(pre + (rows, d, bloc))
        x = _a2a(x, axis_name, k + 1, k)
        return x.reshape(pre + (A, bloc))

    ar, ai = gather_a(ar), gather_a(ai)
    ar, ai = fft_axis(ar, ai, ar.ndim - 2, bases_a, inverse=inverse,
                      scale=scale)

    def scatter_a(x):  # (A, bloc) -> natural local block (rows_a * B,)
        x = x.reshape(pre + (d, rows, bloc))
        x = _a2a(x, axis_name, k, k + 1)
        return x.reshape(pre + (rows * B,))

    return scatter_a(ar), scatter_a(ai)


def _body_gather(
    ar, ai, *, n, d, axis_name, inverse, scale, bases,
):
    """Fallback for lengths with d | n but d^2 ∤ n (no four-step exchange
    pattern exists): all_gather the axis, transform locally, keep this
    device's output block.

    Communication is (d-1)/d of the axis per device (vs ~2/d for the
    four-step) and every device computes the full transform — correct for
    any d | n, at a bandwidth/compute premium. Natural order in and out."""
    n_loc = n // d
    ar = jax.lax.all_gather(ar, axis_name, axis=ar.ndim - 1, tiled=True)
    ai = jax.lax.all_gather(ai, axis_name, axis=ai.ndim - 1, tiled=True)
    ar, ai = fft_axis(ar, ai, ar.ndim - 1, bases,
                      inverse=inverse, scale=scale)
    idx = jax.lax.axis_index(axis_name)
    ar = jax.lax.dynamic_slice_in_dim(ar, idx * n_loc, n_loc, ar.ndim - 1)
    ai = jax.lax.dynamic_slice_in_dim(ai, idx * n_loc, n_loc, ai.ndim - 1)
    return ar, ai


def _norm_scale(norm, n_total: int, inverse: bool) -> float:
    from .api import _norm_scale as _ns

    return _ns(norm, n_total, inverse)


@functools.lru_cache(maxsize=256)
def _build_distributed_fn(
    mesh: Mesh, axis_name: str, axis: int, ndim: int, n: int,
    inverse: bool, scale: float, batch_axis_name: str | None,
    permuted_in: bool, permuted_out: bool, config: PlanConfig,
):
    """Jitted (re, im, twr, twi) -> (re, im) four-step executable, cached per
    static configuration (the plan-cache analog for the distributed path)."""
    d = mesh.shape[axis_name]
    gather_fallback = d > 1 and n % (d * d) != 0
    if gather_fallback:
        if n % d != 0:
            raise ValueError(
                f"distributed FFT needs d | n for even shards (n={n}, d={d})"
            )
        if permuted_in or permuted_out:
            raise ValueError(
                "permuted order requires the four-step exchange pattern "
                f"(d^2 | n); n={n}, d={d} uses the all_gather fallback"
            )
        import logging

        logging.getLogger("tpufft").info(
            "distributed FFT n=%d d=%d: d^2 does not divide n — using the "
            "all_gather fallback ((d-1)/d of the axis exchanged, full "
            "transform per device). A length with d^2 | n runs the "
            "four-step exchange instead.", n, d)
        A, B = 1, n
    else:
        A, B = split_n(n, d) if d > 1 else (1, n)
    bases_a = default_bases(A, config.max_radix) if A > 1 else (1,)
    bases_b = default_bases(B, config.max_radix)

    def body(ar, ai, twr, twi):
        ar = jnp.moveaxis(ar, axis, -1)
        ai = jnp.moveaxis(ai, axis, -1)
        if d == 1:
            outr, outi = fft_axis(
                ar, ai, ar.ndim - 1, bases_b, inverse=inverse, scale=scale,
            )
        elif gather_fallback:
            outr, outi = _body_gather(
                ar, ai, n=n, d=d, axis_name=axis_name, inverse=inverse,
                scale=scale, bases=bases_b,
            )
        elif permuted_in:
            outr, outi = _body_permuted_in(
                ar, ai, twr, twi, A=A, B=B, d=d, axis_name=axis_name,
                inverse=inverse, scale=scale, bases_a=bases_a,
                bases_b=bases_b,
            )
        else:
            outr, outi = _body_natural_in(
                ar, ai, twr, twi, A=A, B=B, d=d, axis_name=axis_name,
                inverse=inverse, scale=scale, bases_a=bases_a,
                bases_b=bases_b, natural_out=not permuted_out,
            )
        return jnp.moveaxis(outr, -1, axis), jnp.moveaxis(outi, -1, axis)

    data_spec = [None] * ndim
    data_spec[axis] = axis_name if d > 1 else None
    if batch_axis_name is not None:
        if ndim < 2:
            raise ValueError(
                "batch_axis_name requires a batch dimension: the input is "
                f"{ndim}-dimensional and the transform axis is the only one")
        b_ax = 0 if axis != 0 else 1
        data_spec[b_ax] = batch_axis_name
    data_p = P(*data_spec)
    # T[ka, b]: the natural-in body consumes it b-sharded, the permuted-in
    # body ka-sharded.
    tw_p = P(None, axis_name) if not permuted_in else P(axis_name, None)
    if d == 1:
        tw_p = P(None, None)

    if d == 1:
        # No collectives in the d==1 branch, so shard_map adds nothing:
        # plain jit with sharding annotations lets the partitioner handle
        # any batch sharding.
        d_sh = NamedSharding(mesh, data_p)
        t_sh = NamedSharding(mesh, tw_p)
        return (
            jax.jit(body, in_shardings=(d_sh, d_sh, t_sh, t_sh),
                    out_shardings=(d_sh, d_sh)),
            A, B,
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(data_p, data_p, tw_p, tw_p),
        out_specs=(data_p, data_p),
        check_vma=False,
    )
    return jax.jit(fn), A, B


def fft_distributed(
    x: SplitComplex,
    mesh: Mesh,
    *,
    axis_name: str,
    axis: int = -1,
    inverse: bool = False,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    permuted_in: bool = False,
    permuted_out: bool = False,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """1D FFT along ``axis`` block-sharded over mesh axis ``axis_name``.

    ``x`` planes may be global arrays or already-sharded; the result is
    block-sharded the same way. ``permuted_out`` returns the spectrum in
    (ka, kb)-major order, saving one all_to_all; feed it back through
    ``permuted_in=True`` (e.g. for the inverse of an fft->filter->ifft
    pipeline). If ``batch_axis_name`` is given, the leading batch axis is
    additionally sharded over it (DP x SP over one 2D mesh in one step).
    """
    if permuted_in and permuted_out:
        raise ValueError("permuted_in and permuted_out are mutually exclusive")
    ndim = x.re.ndim
    axis = axis % ndim
    n = x.re.shape[axis]
    scale = _norm_scale(norm, n, inverse)
    fn, A, B = _build_distributed_fn(
        mesh, axis_name, axis, ndim, n, inverse, scale, batch_axis_name,
        permuted_in, permuted_out, config or PlanConfig(),
    )
    twr_h, twi_h = _interfactor_twiddle(A, B, inverse)
    outr, outi = fn(x.re, x.im, jnp.asarray(twr_h, x.re.dtype),
                    jnp.asarray(twi_h, x.re.dtype))
    return SplitComplex(outr, outi)


def fftn_distributed(
    x: SplitComplex,
    mesh: Mesh,
    *,
    axis_name: str,
    axes=None,
    dist_axis: int = -1,
    inverse: bool = False,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """ND FFT where ``dist_axis`` is block-sharded over ``axis_name`` and
    the remaining transformed axes are local to each device.

    The local axes run as an ordinary (sharding-propagated) plan — XLA
    inserts no collectives for them — and the sharded axis runs the
    four-step distributed transform. Norms compose multiplicatively, so
    ``norm`` is simply passed to both steps.
    """
    from . import api as _api

    ndim = x.re.ndim
    axes_c = _api._canon_axes(ndim, axes)
    dist_axis = dist_axis % ndim
    if dist_axis not in axes_c:
        raise ValueError(f"dist_axis {dist_axis} not in axes {axes_c}")
    local_axes = tuple(a for a in axes_c if a != dist_axis)
    if local_axes:
        plan = _api.plan_fft(
            tuple(x.re.shape),
            jnp.complex64 if x.re.dtype == jnp.float32 else jnp.complex128,
            axes=local_axes, inverse=inverse, norm=norm, config=config,
        )
        x = plan(x)
    return fft_distributed(
        x, mesh, axis_name=axis_name, axis=dist_axis, inverse=inverse,
        norm=norm, batch_axis_name=batch_axis_name, config=config,
    )


def rfft_distributed(
    x,
    mesh: Mesh,
    *,
    axis_name: str,
    axis: int = -1,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """Real-input FFT along a block-sharded ``axis``: returns the n//2+1
    non-redundant bins as SplitComplex.

    Runs the C2C four-step with a zero imaginary plane and slices the
    Hermitian half afterwards — the XLA partitioner reshards the
    (no-longer-even) output axis. The half-length packing trick would halve
    the exchange payload; whether it pays on the GPU is not measured."""
    xr = jnp.asarray(x)
    n = xr.shape[axis % xr.ndim]
    out = fft_distributed(
        SplitComplex(xr, jnp.zeros_like(xr)), mesh, axis_name=axis_name,
        axis=axis, norm=norm, batch_axis_name=batch_axis_name, config=config,
    )
    sl = [slice(None)] * xr.ndim
    sl[axis % xr.ndim] = slice(0, n // 2 + 1)
    return SplitComplex(out.re[tuple(sl)], out.im[tuple(sl)])


def irfft_distributed(
    x: SplitComplex,
    mesh: Mesh,
    *,
    n: int | None = None,
    axis_name: str,
    axis: int = -1,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
):
    """Inverse of ``rfft_distributed``: Hermitian input (n//2+1 bins along
    ``axis``) -> real output of length ``n``. The full spectrum is rebuilt
    by conjugate mirroring before the distributed C2C inverse."""
    ax = axis % x.re.ndim
    m = x.re.shape[ax]
    if n is None:
        n = 2 * (m - 1)
    m1 = n // 2 + 1
    if m < m1:  # numpy semantics: zero-pad the spectrum to n//2+1 bins
        pad = [(0, 0)] * x.re.ndim
        pad[ax] = (0, m1 - m)
        x = SplitComplex(jnp.pad(x.re, pad), jnp.pad(x.im, pad))
    sl = [slice(None)] * x.re.ndim

    def mirror(re, im):
        lo = n - n // 2 - 1  # count of mirrored bins
        sl[ax] = slice(1, 1 + lo)
        rev = [slice(None)] * re.ndim
        rev[ax] = slice(None, None, -1)
        mr = re[tuple(sl)][tuple(rev)]
        mi = -im[tuple(sl)][tuple(rev)]
        sl[ax] = slice(0, n - lo)
        return (jnp.concatenate([re[tuple(sl)], mr], axis=ax),
                jnp.concatenate([im[tuple(sl)], mi], axis=ax))

    fr, fi = mirror(x.re, x.im)
    out = fft_distributed(
        SplitComplex(fr, fi), mesh, axis_name=axis_name, axis=axis,
        inverse=True, norm=norm, batch_axis_name=batch_axis_name,
        config=config,
    )
    return out.re


def fft_batch_sharded(
    x: SplitComplex,
    mesh: Mesh,
    *,
    batch_axis_name: str,
    axes=None,
    inverse: bool = False,
    norm: str | None = None,
    batch_dim: int = 0,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """ND FFT with the batch dimension sharded across the mesh (DP analog).

    Pure sharding annotation — every device runs the ordinary local plan on
    its batch shard; XLA inserts no collectives. The transform axes must not
    include ``batch_dim``.
    """
    from . import api as _api

    ndim = x.re.ndim
    if not -ndim <= batch_dim < ndim:
        raise ValueError(f"batch_dim {batch_dim} out of range for "
                         f"{ndim}-dim input")
    batch_dim %= ndim
    axes_c = _api._canon_axes(ndim, axes) if axes is not None else tuple(
        a for a in range(ndim) if a != batch_dim
    )
    if batch_dim in axes_c:
        raise ValueError("batch_dim cannot be a transformed axis")
    plan = _api.plan_fft(
        tuple(x.re.shape), jnp.complex64 if x.re.dtype == jnp.float32
        else jnp.complex128,
        axes=axes_c, inverse=inverse, norm=norm, config=config,
    )
    spec = [None] * ndim
    spec[batch_dim] = batch_axis_name
    sh = NamedSharding(mesh, P(*spec))
    re = jax.device_put(x.re, sh)
    im = jax.device_put(x.im, sh)
    return plan(SplitComplex(re, im))


def filter_distributed(
    x: SplitComplex,
    mesh: Mesh,
    *,
    axis_name: str,
    response=None,
    impulse=None,
    axis: int = -1,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """Sharded circular filter ``ifft(fft(x) * H)`` along a distributed
    axis — the fft->pointwise->ifft spectral pipeline in FOUR all_to_all
    exchanges instead of six.

    The forward runs ``permuted_out`` (the spectrum stays in (ka, kb)-major
    four-step order, skipping the reorder exchange), H is applied
    pre-permuted to match, and the inverse consumes the permuted order
    directly (``permuted_in``). This is the FFTW-MPI TRANSPOSED_OUT/IN
    trick applied to a whole filtering step. Lengths whose factorization
    cannot use the exchange pattern (d^2 not dividing n) fall back to the
    natural-order pipeline (all_gather body, no permuted saving).
    """
    if (response is None) == (impulse is None):
        raise ValueError("give exactly one of response= or impulse=")
    ndim = x.re.ndim
    ax = axis % ndim
    n = x.re.shape[ax]
    if impulse is not None:
        H = np.fft.fft(np.asarray(impulse, np.complex128))
    else:
        H = np.asarray(response, np.complex128)
    if H.shape != (n,):
        raise ValueError(f"response/impulse must have shape ({n},)")
    d = int(mesh.shape[axis_name])
    # d == 1 runs the plain local executable (natural order, no exchange
    # pattern) — split_n would still return a nontrivial (A, B) and a
    # permuted H would be applied to natural-order data (silently wrong)
    permuted = False
    if d > 1:
        try:
            A, B = split_n(n, d)
            permuted = True
        except ValueError:
            pass
    spec = fft_distributed(
        x, mesh, axis_name=axis_name, axis=ax, permuted_out=permuted,
        batch_axis_name=batch_axis_name, config=config,
    )
    if permuted:
        # permuted position (ka, kb) holds frequency kb*A + ka
        Hp = H.reshape(B, A).T.reshape(-1)
    else:
        Hp = H
    shape = [1] * ndim
    shape[ax] = n
    hr = jnp.asarray(Hp.real, x.re.dtype).reshape(shape)
    hi = jnp.asarray(Hp.imag, x.re.dtype).reshape(shape)
    yr = spec.re * hr - spec.im * hi
    yi = spec.re * hi + spec.im * hr
    return fft_distributed(
        SplitComplex(yr, yi), mesh, axis_name=axis_name, axis=ax,
        inverse=True, norm="backward", permuted_in=permuted,
        batch_axis_name=batch_axis_name, config=config,
    )
