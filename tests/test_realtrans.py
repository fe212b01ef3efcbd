"""DCT/DST types 1-4 vs the scipy.fft oracle (beyond-parity family; the
reference is FFT-only). Every transform is a host-built real matrix
right-multiply, one dense matmul at HIGHEST precision
(tpufft/realtrans.py)."""

import numpy as np
import pytest

import tpufft

sfft = pytest.importorskip("scipy.fft")



@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho", "forward", "backward"])
def test_matches_scipy(kind, type_, norm, rng):
    fwd = getattr(tpufft, kind)
    inv = getattr(tpufft, "i" + kind)
    sfwd = getattr(sfft, kind)
    sinv = getattr(sfft, "i" + kind)
    for n in (8, 9, 31):
        x = rng.standard_normal((5, n))
        ref = sfwd(x, type=type_, norm=norm)
        got = np.asarray(fwd(x, type=type_, norm=norm))
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
        refi = sinv(x, type=type_, norm=norm)
        goti = np.asarray(inv(x, type=type_, norm=norm))
        np.testing.assert_allclose(goti, refi, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
def test_roundtrip(kind, type_, rng):
    fwd = getattr(tpufft, kind)
    inv = getattr(tpufft, "i" + kind)
    x = rng.standard_normal((3, 24))
    for norm in (None, "ortho", "forward"):
        back = np.asarray(inv(fwd(x, type=type_, norm=norm),
                              type=type_, norm=norm))
        np.testing.assert_allclose(back, x, rtol=1e-8, atol=1e-8)


def test_axis_n_and_nd(rng):
    x = rng.standard_normal((4, 6, 10))
    np.testing.assert_allclose(
        np.asarray(tpufft.dct(x, axis=1)), sfft.dct(x, axis=1), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(tpufft.dct(x, n=16)), sfft.dct(x, n=16), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(tpufft.dct(x, n=6)), sfft.dct(x, n=6), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(tpufft.dctn(x, type=3, norm="ortho")),
        sfft.dctn(x, type=3, norm="ortho"), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(tpufft.idstn(x, s=(8, 12), axes=(1, 2))),
        sfft.idstn(x, s=(8, 12), axes=(1, 2)), atol=1e-9)
    # s with axes=None maps to the last len(s) axes (scipy semantics)
    np.testing.assert_allclose(
        np.asarray(tpufft.dstn(x, s=(8, 12))),
        sfft.dstn(x, s=(8, 12)), atol=1e-9)


@pytest.mark.parametrize("kind,type_", [("dct", 2), ("dct", 3), ("dst", 2),
                                        ("dst", 4)])
def test_kernel_path(kind, type_, rng):
    """The f32 r2r matmul matches scipy far inside the f32 tier, and its
    dot carries an explicit HIGHEST precision (no silent TF32 on a GPU)."""
    import jax
    import jax.numpy as jnp

    fwd = getattr(tpufft, kind)
    sfwd = getattr(sfft, kind)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    got = np.asarray(fwd(x, type=type_, norm="ortho"))
    ref = sfwd(x.astype(np.float64), type=type_, norm="ortho")
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert np.max(np.abs(got - ref)) / scale < 1e-5
    jaxpr = str(jax.make_jaxpr(
        lambda v: fwd(v, type=type_, norm="ortho"))(jnp.asarray(x)))
    assert "dot_general" in jaxpr and "HIGHEST" in jaxpr


def test_kernel_grad(rng):
    """jax.grad through the r2r matmul: VJP is the transposed matmul."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(rng.standard_normal((6, 32)), jnp.float32)
    g = jax.grad(lambda v: jnp.sum(tpufft.dct(v) ** 2))(x)
    m = sfft.dct(np.eye(32), axis=-1)
    gref = 2.0 * (np.asarray(x) @ m) @ m.T
    scale = max(1.0, float(np.max(np.abs(gref))))
    assert float(jnp.max(jnp.abs(g - jnp.asarray(gref, jnp.float32)))) \
        / scale < 2e-3


def test_errors():
    x = np.zeros((4, 8))
    with pytest.raises(ValueError, match="type"):
        tpufft.dct(x, type=5)
    with pytest.raises(ValueError, match="norm"):
        tpufft.dct(x, norm="bogus")
    with pytest.raises(ValueError, match="n > 1"):
        tpufft.dct(np.zeros((2, 1)), type=1)  # only DCT-I needs n > 1
    with pytest.raises(ValueError, match="unique"):
        tpufft.dctn(x, axes=(1, 1))  # scipy raises on duplicate axes too


def test_scipy_edge_compat(rng):
    """Edge behaviors scipy supports that round-3 review flagged: DST-I at
    n=1, and complex input transformed by linearity."""
    one = rng.standard_normal((3, 1))
    np.testing.assert_allclose(np.asarray(tpufft.dst(one, type=1)),
                               sfft.dst(one, type=1), atol=1e-12)
    z = (rng.standard_normal((4, 12))
         + 1j * rng.standard_normal((4, 12)))
    np.testing.assert_allclose(np.asarray(tpufft.dct(z, norm="ortho")),
                               sfft.dct(z, norm="ortho"), atol=1e-10)
    np.testing.assert_allclose(np.asarray(tpufft.idst(z, type=3)),
                               sfft.idst(z, type=3), atol=1e-10)


def test_f64_precision(rng):
    """float64 input stays f64 through the XLA matmul path (1e-12 tier)."""
    x = rng.standard_normal((3, 50))
    got = np.asarray(tpufft.dct(x, type=2))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, sfft.dct(x, type=2), rtol=1e-12,
                               atol=1e-12)
