"""Chirp-z transform / zoom FFT tests — parity with scipy.signal.czt,
zoom_fft, czt_points, CZT, ZoomFFT (scipy is the spec; the reference has
no counterpart — tpufft.czt is a beyond-parity surface built on the
Bluestein convolution machinery)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps

import tpufft
from tpufft import CZT, PlanConfig, SplitComplex, ZoomFFT, czt, zoom_fft
from tpufft.czt import czt_points


def _rel_err(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    return float(np.max(np.abs(got - want))) / scale


@pytest.mark.parametrize("n", [1, 2, 7, 16, 50, 128, 365])
def test_czt_default_is_fft(rng, n):
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    assert _rel_err(czt(x), np.fft.fft(x)) < 1e-10


@pytest.mark.parametrize("n,m", [(16, 16), (16, 8), (16, 37), (50, 50),
                                 (31, 64), (1, 5)])
@pytest.mark.parametrize("w,a", [
    (None, 1 + 0j),
    (np.exp(-2j * np.pi * 0.123), 1 + 0j),
    (np.exp(-2j * np.pi / 20), np.exp(0.7j)),
])
def test_czt_matches_scipy_f64(rng, n, m, w, a):
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = sps.czt(x, m, w, a)
    assert _rel_err(czt(x, m, w, a), want) < 1e-9


@pytest.mark.parametrize("n,m", [(12, 12), (16, 10)])
def test_czt_off_circle_spiral(rng, n, m):
    # |w| != 1 walks a decaying spiral; the chirp dynamic range grows as
    # |w|**(k^2/2), so (like scipy) only modest sizes are well-conditioned
    w, a = 0.98 * np.exp(-0.4j), 1.5 + 0j
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = sps.czt(x, m, w, a)
    assert _rel_err(czt(x, m, w, a), want) < 1e-8


def test_czt_real_input_f64(rng):
    x = rng.standard_normal(48)
    want = sps.czt(x, 30, np.exp(-0.11j), 1 + 0j)
    got = czt(x, 30, np.exp(-0.11j), 1 + 0j)
    assert _rel_err(got, want) < 1e-9


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_czt_batched_axes(rng, axis):
    x = rng.standard_normal((3, 24, 4)) + 1j * rng.standard_normal((3, 24, 4))
    n = x.shape[axis]
    want = sps.czt(x, n + 5, axis=axis)
    assert _rel_err(czt(x, n + 5, axis=axis), want) < 1e-9


def test_czt_f32_device_path(rng):
    # jax input -> the split-plane device pipeline (XLA on the CPU backend)
    x = rng.standard_normal(96).astype(np.float32)
    want = sps.czt(x.astype(np.float64), 64, np.exp(-0.2j))
    got = czt(jnp.asarray(x), 64, np.exp(-0.2j))
    assert isinstance(got, jax.Array)
    assert _rel_err(np.asarray(got), want) < 2e-4


def test_czt_kernel_interpret_path(rng):
    # a non-default plan config (radix-4 planner) reaches the transforms
    cfg = PlanConfig(max_radix=4)
    x = rng.standard_normal((4, 63)).astype(np.float32)
    want = sps.czt(x.astype(np.float64), 40)
    got = czt(jnp.asarray(x), 40, config=cfg)
    assert _rel_err(np.asarray(got), want) < 2e-4


def test_czt_splitcomplex_io(rng):
    xr = rng.standard_normal((2, 32)).astype(np.float32)
    xi = rng.standard_normal((2, 32)).astype(np.float32)
    plan = CZT(32, 32)
    out = plan(SplitComplex(jnp.asarray(xr), jnp.asarray(xi)))
    assert isinstance(out, SplitComplex)
    want = np.fft.fft(xr + 1j * xi)
    got = np.asarray(out.re) + 1j * np.asarray(out.im)
    assert _rel_err(got, want) < 2e-4
    # module-level czt() must read the length off the planes, not the tuple
    out2 = czt(SplitComplex(jnp.asarray(xr), jnp.asarray(xi)))
    got2 = np.asarray(out2.re) + 1j * np.asarray(out2.im)
    assert _rel_err(got2, want) < 2e-4


def test_czt_plan_reuse_and_points(rng):
    plan = CZT(20, 15, np.exp(-0.3j), np.exp(0.2j))
    np.testing.assert_allclose(
        plan.points(), sps.CZT(20, 15, np.exp(-0.3j), np.exp(0.2j)).points(),
        rtol=1e-12)
    for _ in range(2):
        x = rng.standard_normal(20) + 1j * rng.standard_normal(20)
        assert _rel_err(plan(x), sps.czt(x, 15, np.exp(-0.3j),
                                         np.exp(0.2j))) < 1e-9


def test_czt_length_mismatch_raises():
    plan = CZT(16)
    with pytest.raises(ValueError, match="length"):
        plan(np.zeros(17, np.complex128))


def test_czt_invalid_sizes():
    with pytest.raises(ValueError):
        CZT(0)
    with pytest.raises(ValueError):
        CZT(8, m=0)
    with pytest.raises(ValueError):
        CZT(8, w=0)


@pytest.mark.parametrize("m", [1, 7, 16])
@pytest.mark.parametrize("w,a", [(None, 1 + 0j),
                                 (np.exp(-0.37j), 0.5 + 0.1j)])
def test_czt_points_matches_scipy(m, w, a):
    np.testing.assert_allclose(czt_points(m, w, a), sps.czt_points(m, w, a),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", [0.6, (0.1, 0.4)])
@pytest.mark.parametrize("m", [None, 25])
@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_matches_scipy(rng, fn, m, endpoint):
    x = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    want = sps.zoom_fft(x, fn, m=m, endpoint=endpoint)
    got = zoom_fft(x, fn, m=m, endpoint=endpoint)
    assert _rel_err(got, want) < 1e-9


def test_zoom_fft_fs(rng):
    x = rng.standard_normal(64)
    want = sps.zoom_fft(x, (10.0, 40.0), m=33, fs=100.0)
    got = zoom_fft(x, (10.0, 40.0), m=33, fs=100.0)
    assert _rel_err(got, want) < 1e-9


def test_zoom_fft_full_band_is_fft(rng):
    # fn=[0, fs) with m=n reproduces the FFT (scipy doc contract)
    x = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    got = zoom_fft(x, 2)  # fs=2 default, fn=2 -> full band
    assert _rel_err(got, np.fft.fft(x)) < 1e-9


def test_zoom_fft_class(rng):
    plan = ZoomFFT(30, (0.2, 0.8), m=12)
    x = rng.standard_normal((5, 30))
    want = sps.zoom_fft(x, (0.2, 0.8), m=12)
    assert _rel_err(plan(x), want) < 1e-9


def test_czt_linearity_and_grad(rng):
    x = jnp.asarray(rng.standard_normal(32).astype(np.float32))
    plan = CZT(32, 20, np.exp(-0.15j))
    y1 = plan(2.0 * x)
    y2 = plan(x)
    assert _rel_err(np.asarray(y1), 2.0 * np.asarray(y2)) < 1e-5

    def loss(v):
        out = plan(v)
        return jnp.sum(jnp.real(out) ** 2)

    g = jax.grad(loss)(x)
    assert np.all(np.isfinite(np.asarray(g)))
    # directional-derivative check against finite differences
    d = jnp.asarray(rng.standard_normal(32).astype(np.float32))
    eps = 1e-3
    fd = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
    an = jnp.vdot(g, d)
    assert abs(float(fd) - float(an)) < 5e-2 * max(1.0, abs(float(an)))


def test_czt_exported():
    for name in ("czt", "zoom_fft", "czt_points", "CZT", "ZoomFFT"):
        assert name in tpufft.__all__
        assert hasattr(tpufft, name)
