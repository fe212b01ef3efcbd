"""Real-to-real transforms: DCT/DST types 1-4 (the rest of the scipy.fft
surface; the reference is FFT-only — this is a beyond-parity family).

Design: every DCT/DST is ``y = x @ M`` for a host-precomputed (n, n) real
matrix — ONE dense matmul, which XLA hands to the GPU's GEMM library, for
any n (odd and prime included), at HIGHEST precision (a float32 matmul with
no precision may run in TF32, ~1e-3 relative).

Matrices are built with float64 trig and match scipy.fft.dct/dst/idct/idst
bit-for-bit in convention (types 1-4, norm backward/ortho/forward; the
inverse matrices use the classic partner identities, e.g.
idct_backward(type 2) = dct_backward(type 3) / (2N), and orthonormal
inverses are transposes).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from .core import SplitComplex

__all__ = [
    "dct", "idct", "dst", "idst",
    "dctn", "idctn", "dstn", "idstn",
]

_NORMS = (None, "backward", "ortho", "forward")


@functools.lru_cache(maxsize=None)
def _mat(kind: str, type_: int, n: int, norm: str, inverse: bool):
    """(n, n) float64 matrix with y = x @ M == scipy.fft.{kind}{type_}."""
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"norm must be in {_NORMS}, got {norm!r}")
    if type_ not in (1, 2, 3, 4):
        raise ValueError(f"type must be 1, 2, 3 or 4, got {type_}")
    if kind == "dct" and type_ == 1 and n < 2:
        # only DCT-I divides by n-1; DST-I is well-defined at n=1 (scipy
        # accepts it)
        raise ValueError(f"dct type 1 needs n > 1, got {n}")
    if inverse:
        partner = {1: 1, 2: 3, 3: 2, 4: 4}[type_]
        if norm == "ortho":
            return np.ascontiguousarray(_mat(kind, type_, n, "ortho",
                                             False).T)
        base = _mat(kind, partner, n, "backward", False)
        if norm == "backward":
            c = {1: 2.0 * (n - 1) if kind == "dct" else 2.0 * (n + 1),
                 2: 2.0 * n, 3: 2.0 * n, 4: 2.0 * n}[type_]
            return base / c
        return base  # forward: the forward transform carried the 1/c

    j = np.arange(n, dtype=np.float64)[:, None]   # input index
    k = np.arange(n, dtype=np.float64)[None, :]   # output index
    if kind == "dct":
        if type_ == 1:
            if norm == "ortho":
                # orthonormal basis: sqrt(2/(N-1)) * cos, endpoints / sqrt2
                # on both the row and column index
                m = np.cos(np.pi * j * k / (n - 1)) * np.sqrt(2.0 / (n - 1))
                s = np.ones(n)
                s[0] = s[n - 1] = 1.0 / np.sqrt(2.0)
                m = m * s[:, None] * s[None, :]
            else:
                m = 2.0 * np.cos(np.pi * j * k / (n - 1))
                m[0, :] = 1.0
                m[n - 1, :] = (-1.0) ** np.arange(n)
                if norm == "forward":
                    m = m / (2.0 * (n - 1))
        elif type_ == 2:
            m = 2.0 * np.cos(np.pi * (2 * j + 1) * k / (2 * n))
            if norm == "ortho":
                col = np.full(n, np.sqrt(1.0 / (2 * n)))
                col[0] = np.sqrt(1.0 / (4 * n))
                m = m * col[None, :]
            elif norm == "forward":
                m = m / (2.0 * n)
        elif type_ == 3:
            if norm == "ortho":
                m = (np.cos(np.pi * j * (2 * k + 1) / (2 * n))
                     * np.sqrt(2.0 / n))
                m[0, :] = np.sqrt(1.0 / n)
            else:
                m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
                m[0, :] = 1.0
                if norm == "forward":
                    m = m / (2.0 * n)
        else:  # type 4
            m = 2.0 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * n)
            elif norm == "forward":
                m = m / (2.0 * n)
    else:  # dst
        if type_ == 1:
            m = 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * (n + 1))
            elif norm == "forward":
                m = m / (2.0 * (n + 1))
        elif type_ == 2:
            m = 2.0 * np.sin(np.pi * (2 * j + 1) * (k + 1) / (2 * n))
            if norm == "ortho":
                col = np.full(n, np.sqrt(1.0 / (2 * n)))
                col[n - 1] = np.sqrt(1.0 / (4 * n))
                m = m * col[None, :]
            elif norm == "forward":
                m = m / (2.0 * n)
        elif type_ == 3:
            if norm == "ortho":
                m = (np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
                     * np.sqrt(2.0 / n))
                m[n - 1, :] = ((-1.0) ** np.arange(n)) * np.sqrt(1.0 / n)
            else:
                m = 2.0 * np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
                m[n - 1, :] = (-1.0) ** np.arange(n)
                if norm == "forward":
                    m = m / (2.0 * n)
        else:  # type 4
            m = 2.0 * np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
            if norm == "ortho":
                m = m / np.sqrt(2.0 * n)
            elif norm == "forward":
                m = m / (2.0 * n)
    return np.ascontiguousarray(m)


def _resize_minor(x, n):
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - cur)]
    return jnp.pad(x, pad)


def _apply_r2r(x, kind, type_, n, axis, norm, inverse):
    norm = "backward" if norm is None else norm
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if isinstance(x, SplitComplex):
        # transform the planes by linearity (the matrices are real)
        re = _apply_r2r(x.re, kind, type_, n, axis, norm, inverse)
        im = _apply_r2r(x.im, kind, type_, n, axis, norm, inverse)
        return SplitComplex(re, im)
    is_np = not isinstance(x, jax.Array)
    xj = jnp.asarray(x)
    if jnp.issubdtype(xj.dtype, jnp.complexfloating):
        # scipy transforms complex input by linearity
        re = _apply_r2r(xj.real, kind, type_, n, axis, norm, inverse)
        im = _apply_r2r(xj.imag, kind, type_, n, axis, norm, inverse)
        out = jnp.asarray(re) + 1j * jnp.asarray(im)
        return np.asarray(out) if is_np else out
    in_dt = xj.dtype
    f64 = in_dt == jnp.dtype(jnp.float64)
    axis = axis % xj.ndim
    if n is None:
        n = xj.shape[axis]
    n = int(n)
    _mat(kind, type_, n, norm, inverse)  # validate type/n combination early
    moved = axis != xj.ndim - 1
    if moved:
        xj = jnp.moveaxis(xj, axis, -1)
    xj = _resize_minor(xj, n)
    lead = xj.shape[:-1]
    flat = xj.reshape(math.prod(lead) if lead else 1, n)
    m = jnp.asarray(_mat(kind, type_, n, norm, inverse),
                    jnp.float64 if f64 else jnp.float32)
    out = jnp.dot(flat.astype(m.dtype), m,
                  precision=jax.lax.Precision.HIGHEST)
    out = out.reshape(lead + (n,)).astype(
        in_dt if jnp.issubdtype(in_dt, jnp.floating) else jnp.float32)
    if moved:
        out = jnp.moveaxis(out, -1, axis)
    return np.asarray(out) if is_np else out


def dct(x, type=2, n=None, axis=-1, norm=None):
    """Discrete cosine transform (scipy.fft.dct-compatible, types 1-4)."""
    return _apply_r2r(x, "dct", int(type), n, axis, norm, False)


def idct(x, type=2, n=None, axis=-1, norm=None):
    return _apply_r2r(x, "dct", int(type), n, axis, norm, True)


def dst(x, type=2, n=None, axis=-1, norm=None):
    """Discrete sine transform (scipy.fft.dst-compatible, types 1-4)."""
    return _apply_r2r(x, "dst", int(type), n, axis, norm, False)


def idst(x, type=2, n=None, axis=-1, norm=None):
    return _apply_r2r(x, "dst", int(type), n, axis, norm, True)


def _apply_nd(fn, x, type, s, axes, norm):
    shape = np.shape(x)
    ndim = len(shape)
    if axes is None:
        axes = (tuple(range(-len(s), 0)) if s is not None
                else tuple(range(ndim)))
    axes = tuple(a % ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"all axes must be unique, got {axes}")
    if s is None:
        s = tuple(shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError(f"len(s)={len(s)} must equal len(axes)={len(axes)}")
    out = x
    for a, n in zip(axes, s):
        out = fn(out, type=type, n=n, axis=a, norm=norm)
    return out


def dctn(x, type=2, s=None, axes=None, norm=None):
    """N-dimensional DCT (scipy.fft.dctn-compatible)."""
    return _apply_nd(dct, x, type, s, axes, norm)


def idctn(x, type=2, s=None, axes=None, norm=None):
    return _apply_nd(idct, x, type, s, axes, norm)


def dstn(x, type=2, s=None, axes=None, norm=None):
    """N-dimensional DST (scipy.fft.dstn-compatible)."""
    return _apply_nd(dst, x, type, s, axes, norm)


def idstn(x, type=2, s=None, axes=None, norm=None):
    return _apply_nd(idst, x, type, s, axes, norm)