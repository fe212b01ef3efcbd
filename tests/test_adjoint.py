"""Gradients of the plain path: vector-Jacobian products against the
adjoint identity and against jnp.fft's own autodiff.

Every transform is real-linear in the (re, im) parameterization, so its
VJP is the transpose: sum(A(x) * g) == sum(x * A^T(g)) for any x and
cotangent g (the dot-product test), and A^T(g) must equal the VJP of the
same transform through jnp.fft — an independent implementation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpufft

NORMS = [None, "backward", "ortho", "forward"]
DTYPES = {"c64": (jnp.float32, 2e-3), "c128": (jnp.float64, 1e-9)}

# name: (input kind, output kind, shape, kwargs)
TRANSFORMS = {
    "fft": ("c", "c", (3, 24), {}),
    "ifft": ("c", "c", (3, 24), {}),
    "fftn": ("c", "c", (2, 6, 10), {"axes": (1, 2)}),
    "ifftn": ("c", "c", (2, 6, 10), {"axes": (1, 2)}),
    "fft2": ("c", "c", (2, 8, 6), {}),
    "rfft": ("r", "c", (3, 20), {}),
    "rfftn": ("r", "c", (2, 6, 10), {"axes": (1, 2)}),
    "irfft": ("c", "r", (3, 11), {"n": 20}),
    "irfftn": ("c", "r", (2, 6, 6), {"axes": (1, 2), "s": (6, 10)}),
    "hfft": ("c", "r", (3, 11), {"n": 20}),
    "ihfft": ("r", "c", (3, 20), {}),
}


def _planes(shape, seed, rdt):
    r = np.random.default_rng(seed)
    return (jnp.asarray(r.standard_normal(shape), rdt),
            jnp.asarray(r.standard_normal(shape), rdt))


def _as_real_map(fn, kind_in, kind_out):
    """fn over complex/real arrays -> a map between tuples of real planes."""
    def f(*xs):
        x = jax.lax.complex(*xs) if kind_in == "c" else xs[0]
        y = fn(x)
        if kind_out == "c":
            return jnp.real(y), jnp.imag(y)
        return (y,)
    return f


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("norm", NORMS, ids=lambda n: str(n))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_vjp_is_adjoint(name, norm, dtype):
    rdt, tol = DTYPES[dtype]
    kind_in, kind_out, shape, kw = TRANSFORMS[name]
    ours = _as_real_map(
        lambda x: getattr(tpufft, name)(x, norm=norm, **kw), kind_in,
        kind_out)
    ref = _as_real_map(
        lambda x: getattr(jnp.fft, name)(x, norm=norm, **kw), kind_in,
        kind_out)
    xs = _planes(shape, 1, rdt)[:2 if kind_in == "c" else 1]
    ys, vjp = jax.vjp(ours, *xs)
    gs = tuple(jnp.asarray(np.random.default_rng(2 + i).standard_normal(
        y.shape), rdt) for i, y in enumerate(ys))
    back = vjp(gs)
    _, vjp_ref = jax.vjp(ref, *xs)
    back_ref = vjp_ref(gs)

    # dot-product test: <A x, g> == <x, A^T g>
    lhs = sum(float(jnp.sum(y * g)) for y, g in zip(ys, gs))
    rhs = sum(float(jnp.sum(x * b)) for x, b in zip(xs, back))
    assert abs(lhs - rhs) <= tol * max(1.0, abs(lhs))

    # the transpose agrees with jnp.fft's autodiff
    for b, br in zip(back, back_ref):
        b, br = np.asarray(b), np.asarray(br)
        scale = max(1.0, float(np.max(np.abs(br))))
        assert np.max(np.abs(b - br)) / scale < tol, name


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: str(n))
def test_grad_through_plan_of_splitcomplex(norm):
    """jax.grad with SplitComplex planes in and out of a plan."""
    re, im = _planes((4, 30), 3, jnp.float32)
    plan = tpufft.plan_fft((4, 30), jnp.complex64, axes=(-1,), norm=norm)

    def loss(a, b):
        out = plan(tpufft.SplitComplex(a, b))
        return jnp.sum(out.re ** 3) + jnp.sum(out.im * out.re)

    def loss_ref(a, b):
        z = jnp.fft.fft(jax.lax.complex(a, b), norm=norm)
        return jnp.sum(z.real ** 3) + jnp.sum(z.imag * z.real)

    g = jax.grad(loss, argnums=(0, 1))(re, im)
    g_ref = jax.grad(loss_ref, argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 2e-3
