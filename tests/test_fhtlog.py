"""Fast Hankel transform (FFTLog), prev_fast_len, workers, and the
scipy.fft backend protocol.

Beyond-parity scipy.fft surface (the reference library has no Hankel
transforms or backend machinery); behavior-matched to scipy.fft so a
scipy user can switch without relearning semantics.
"""

import numpy as np
import pytest
import scipy.fft as sfft

import jax.numpy as jnp

import tpufft
from tpufft.config import PlanConfig


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("mu", [0.0, 0.5, 2.0, -0.5])
@pytest.mark.parametrize("bias", [0.0, 0.3, -0.2])
def test_fht_matches_scipy(rng, mu, bias):
    r = np.logspace(-4, 4, 64)
    dln = np.log(r[1] / r[0])
    off = tpufft.fhtoffset(dln, mu, initial=0.1, bias=bias)
    assert off == pytest.approx(sfft.fhtoffset(dln, mu, initial=0.1,
                                               bias=bias), abs=1e-12)
    a = rng.standard_normal((3, 64))
    got = np.asarray(tpufft.fht(a, dln, mu, offset=off, bias=bias))
    ref = sfft.fht(a, dln, mu, offset=off, bias=bias)
    np.testing.assert_allclose(got, ref, atol=1e-11 * np.max(np.abs(ref)))


@pytest.mark.parametrize("n", [63, 64, 101])
def test_ifht_roundtrip(rng, n):
    dln = 0.08
    a = rng.standard_normal((2, n))
    A = tpufft.fht(a, dln, mu=1.0, offset=0.2)
    back = tpufft.ifht(np.asarray(A), dln, mu=1.0, offset=0.2)
    np.testing.assert_allclose(np.asarray(back), a, atol=1e-10)
    ref = sfft.ifht(sfft.fht(a, dln, 1.0, offset=0.2), dln, 1.0, offset=0.2)
    np.testing.assert_allclose(np.asarray(back), ref, atol=1e-10)


def test_fht_analytical(rng):
    """fftlogtest.f case: r^{mu+1} e^{-r^2/2} is self-reciprocal under the
    Hankel transform (Hamilton 2000)."""
    mu = 0.0
    r = np.logspace(-7, 1, 128)
    dln = np.log(r[1] / r[0])
    offset = tpufft.fhtoffset(dln, mu, initial=-6 * np.log(10))
    k = np.exp(offset) / r[::-1]
    a_r = r ** (mu + 1) * np.exp(-r**2 / 2)
    A = np.asarray(tpufft.fht(a_r, dln, mu=mu, offset=offset))
    a_k = k ** (mu + 1) * np.exp(-k**2 / 2)
    # the discrete transform rings at the edges of support (scipy's own
    # result is ~1e0 relative there); the analytic identity holds in the
    # bulk of the peak
    sel = a_k > 0.05 * a_k.max()
    np.testing.assert_allclose(A[sel], a_k[sel], rtol=1e-3)
    # and we match scipy's discrete answer everywhere, exactly
    ref = sfft.fht(a_r, dln, mu=mu, offset=offset)
    np.testing.assert_allclose(A, ref, atol=1e-12 * np.max(np.abs(ref)))


def test_fht_jax_input_kernel_path(rng):
    """jax input stays jax and agrees with scipy through the packed
    r2c/c2r route, under a non-default plan config."""
    a = rng.standard_normal((4, 96)).astype(np.float32)
    dln = 0.05
    got = tpufft.fht(jnp.asarray(a), dln, mu=0.5,
                     config=PlanConfig(max_radix=4))
    assert isinstance(got, jnp.ndarray)
    ref = sfft.fht(a.astype(np.float64), dln, mu=0.5)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=2e-4 * np.max(np.abs(ref)))


def test_fht_singular_warns():
    # xp = (mu+1+bias)/2 = -1 hits a Gamma pole while xm = 2 stays finite
    with pytest.warns(UserWarning, match="singular transform"):
        tpufft.fht(np.ones(16), 0.1, mu=0.0, bias=-3.0)


def test_prev_fast_len():
    from tpufft import next_fast_len, prev_fast_len

    for n in (1, 2, 93, 1000, 4096, 16385):
        p = prev_fast_len(n)
        assert p <= n <= next_fast_len(n)
    assert prev_fast_len(16384, aligned=True) == 16384
    assert prev_fast_len(16511, aligned=True) == 16384
    assert prev_fast_len(1, aligned=True) == 1


def test_workers_context():
    assert tpufft.get_workers() == 0
    with tpufft.set_workers(3):
        assert tpufft.get_workers() == 3
        with tpufft.set_workers(-1):  # scipy's "all cores"
            assert tpufft.get_workers() == 0
        assert tpufft.get_workers() == 3
    assert tpufft.get_workers() == 0


def test_scipy_set_backend(rng):
    """tpufft serves scipy.fft calls through the uarray backend protocol."""
    x = rng.standard_normal((4, 93)) + 1j * rng.standard_normal((4, 93))
    xr = rng.standard_normal((4, 50))
    with sfft.set_backend(tpufft.scipy_backend()):
        y = sfft.fft(x, workers=2)        # workers maps to set_workers
        yr = sfft.rfft(xr, n=64)
        yd = sfft.dct(xr, type=3, norm="ortho")
        yh = sfft.fht(xr, 0.1, mu=1.0)
    np.testing.assert_allclose(np.asarray(y), np.fft.fft(x), atol=1e-10)
    np.testing.assert_allclose(np.asarray(yr), np.fft.rfft(xr, n=64),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(yd),
                               sfft.dct(xr, type=3, norm="ortho"),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(yh), sfft.fht(xr, 0.1, mu=1.0),
                               atol=1e-10)


def test_scipy_backend_falls_back(rng):
    """Names tpufft doesn't implement and semantics-changing kwargs fall
    back to scipy's own implementation instead of erroring."""
    x = rng.standard_normal(32)
    with sfft.set_backend(tpufft.scipy_backend()):
        # orthogonalize is semantics-changing -> served by scipy
        y = sfft.dct(x, type=1, norm="ortho", orthogonalize=False)
    np.testing.assert_allclose(
        y, sfft.dct(x, type=1, norm="ortho", orthogonalize=False),
        atol=1e-12)
