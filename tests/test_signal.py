"""signal module: fused circular filters and scipy-compatible fftconvolve.

The filter plan folds fft -> diag(H) -> ifft into ONE circulant-matrix
matmul for short axes; these tests pin it against the explicit three-step
numpy pipeline under two plan configs (the default planner and one capped
at radix 4), plus scipy.signal oracles for fftconvolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss

import tpufft
from tpufft import PlanConfig, SplitComplex

CFG_KERNEL = PlanConfig()
CFG_XLA = PlanConfig(max_radix=4)


@pytest.mark.parametrize("cfg", [CFG_KERNEL, CFG_XLA],
                         ids=["default", "radix4"])
@pytest.mark.parametrize("n", [16, 93, 128, 480])
def test_filter_matches_fft_pipeline(rng, cfg, n):
    x = rng.standard_normal((7, n)) + 1j * rng.standard_normal((7, n))
    H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    plan = tpufft.plan_filter(n, response=H, config=cfg)
    got = plan(x.astype(np.complex64))
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-3, n


def test_filter_impulse_equals_response(rng):
    n = 64
    h = rng.standard_normal(n)
    x = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    p1 = tpufft.plan_filter(n, impulse=h, config=CFG_XLA)
    p2 = tpufft.plan_filter(n, response=np.fft.fft(h), config=CFG_XLA)
    a = np.asarray(p1(x.astype(np.complex64)))
    b = np.asarray(p2(x.astype(np.complex64)))
    assert np.max(np.abs(a - b)) < 1e-3


@pytest.mark.parametrize("cfg", [CFG_KERNEL, CFG_XLA],
                         ids=["default", "radix4"])
def test_filter_real_hermitian_returns_real(rng, cfg):
    n = 128
    h = rng.standard_normal(n)          # real impulse -> Hermitian H
    x = rng.standard_normal((6, n)).astype(np.float32)
    plan = tpufft.plan_filter(n, impulse=h, config=cfg)
    got = plan(x)
    assert not np.iscomplexobj(np.asarray(got))
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * np.fft.fft(h), axis=-1).real
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(np.asarray(got) - ref)) / scale < 1e-3


def test_filter_middle_axis(rng):
    n = 32
    H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = rng.standard_normal((4, n, 9)) + 1j * rng.standard_normal((4, n, 9))
    plan = tpufft.plan_filter(n, response=H, axis=1, config=CFG_XLA)
    got = np.asarray(plan(x.astype(np.complex64)))
    ref = np.fft.ifft(np.fft.fft(x, axis=1) * H[None, :, None], axis=1)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-3


def test_filter_splitcomplex_and_c128(rng):
    n = 64
    H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    plan = tpufft.plan_filter(n, response=H, config=CFG_XLA)
    sc = plan(SplitComplex(jnp.asarray(x.real, jnp.float32),
                           jnp.asarray(x.imag, jnp.float32)))
    assert isinstance(sc, SplitComplex)
    got = np.asarray(sc.re) + 1j * np.asarray(sc.im)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-3
    # complex128 keeps the f64 tier on CPU
    got128 = np.asarray(plan(x))
    assert np.max(np.abs(got128 - ref)) / scale < 1e-10


def test_filter_grad(rng):
    n = 32
    H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    plan = tpufft.plan_filter(n, response=H, config=CFG_KERNEL)
    xr = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
    xi = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)

    def loss(re, im):
        out = plan(SplitComplex(re, im))
        return jnp.sum(out.re ** 2 + out.im ** 2)

    gr, gi = jax.grad(loss, argnums=(0, 1))(xr, xi)
    # finite-difference check on one coordinate
    eps = 1e-3
    bumped = xr.at[0, 3].add(eps)
    fd = (loss(bumped, xi) - loss(xr, xi)) / eps
    assert abs(float(gr[0, 3]) - float(fd)) < 5e-2 * max(
        1.0, abs(float(fd)))


def test_filter_errors(rng):
    with pytest.raises(ValueError):
        tpufft.plan_filter(8)                        # neither given
    with pytest.raises(ValueError):
        tpufft.plan_filter(8, response=np.ones(8), impulse=np.ones(8))
    with pytest.raises(ValueError):
        tpufft.plan_filter(8, response=np.ones(7))   # wrong length
    plan = tpufft.plan_filter(8, response=np.ones(8), config=CFG_XLA)
    with pytest.raises(ValueError):
        plan(np.ones((3, 9), np.complex64))          # axis length mismatch


# ----------------------------------------------------------------------------
# fftconvolve


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_1d(rng, mode):
    a = rng.standard_normal(57)
    b = rng.standard_normal(12)
    ref = ss.fftconvolve(a, b, mode=mode)
    got = tpufft.fftconvolve(a, b, mode=mode)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_2d(rng, mode):
    a = rng.standard_normal((23, 17))
    b = rng.standard_normal((5, 4))
    ref = ss.fftconvolve(a, b, mode=mode)
    got = tpufft.fftconvolve(a, b, mode=mode)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_fftconvolve_complex(rng):
    a = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    b = rng.standard_normal(9) + 1j * rng.standard_normal(9)
    ref = ss.fftconvolve(a, b)
    got = tpufft.fftconvolve(a, b)
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_fftconvolve_axes_batch(rng):
    # batch axis excluded from convolution (scipy axes semantics)
    a = rng.standard_normal((3, 50))
    b = rng.standard_normal((3, 7))
    ref = ss.fftconvolve(a, b, mode="same", axes=[1])
    got = tpufft.fftconvolve(a, b, mode="same", axes=[1])
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))
    # broadcasting: one batch dim of 1
    b1 = rng.standard_normal((1, 7))
    ref = ss.fftconvolve(a, b1, mode="full", axes=[1])
    got = tpufft.fftconvolve(a, b1, mode="full", axes=[1])
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_fftconvolve_valid_swapped(rng):
    # in2 larger than in1: scipy swaps internally for valid
    a = rng.standard_normal(6)
    b = rng.standard_normal(20)
    ref = ss.fftconvolve(a, b, mode="valid")
    got = tpufft.fftconvolve(a, b, mode="valid")
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_fftconvolve_errors(rng):
    with pytest.raises(ValueError):
        tpufft.fftconvolve(np.ones((3, 3)), np.ones(3))   # ndim mismatch
    with pytest.raises(ValueError):
        tpufft.fftconvolve(np.ones(4), np.ones(4), mode="bogus")
    with pytest.raises(ValueError):
        # non-convolved axis lengths incompatible
        tpufft.fftconvolve(np.ones((3, 5)), np.ones((2, 5)), axes=[1])


@pytest.mark.parametrize("cfg", [CFG_KERNEL, CFG_XLA],
                         ids=["default", "radix4"])
def test_filter_long_axis_composed_path(rng, cfg):
    """Axes past FILTER_DENSE_MAX_N compose fft -> H -> ifft inside the
    plan's jit instead of the O(n^2) dense matmul."""
    from tpufft.signal import FILTER_DENSE_MAX_N
    n = 2048
    assert n > FILTER_DENSE_MAX_N
    H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    plan = tpufft.plan_filter(n, response=H, config=cfg)
    assert plan._cr is None  # no O(n^2) matrix for long axes
    got = np.asarray(plan(x.astype(np.complex64)))
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-3
    # composed path is differentiable end-to-end
    xr = jnp.asarray(x.real[:2], jnp.float32)
    xi = jnp.asarray(x.imag[:2], jnp.float32)

    def loss(re, im):
        out = plan(SplitComplex(re, im))
        return jnp.sum(out.re ** 2 + out.im ** 2)

    gr, gi = jax.grad(loss, argnums=(0, 1))(xr, xi)
    assert np.all(np.isfinite(np.asarray(gr)))
    assert np.all(np.isfinite(np.asarray(gi)))


def test_filter_real_kernel_grad(rng):
    """The real-matrix dense path (single real matmul) is differentiable
    with the transposed-matrix VJP."""
    n = 64
    h = rng.standard_normal(n)
    plan = tpufft.plan_filter(n, impulse=h, config=CFG_KERNEL)
    assert plan._diff_real is not None
    x = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)

    def loss(v):
        return jnp.sum(plan(v) ** 2)

    g = jax.grad(loss)(x)
    # dense reference: y = x @ C  ->  dL/dx = 2 y C^T (finite differences
    # are useless here — the f32 loss is too large for a 1e-3 step)
    C = plan._cr
    y = np.asarray(x) @ C
    gref = 2.0 * y @ C.T
    assert np.max(np.abs(np.asarray(g) - gref)) < 1e-2 * max(
        1.0, float(np.max(np.abs(gref))))


# ----------------------------------------------------------------------------
# hilbert / resample / correlate


@pytest.mark.parametrize("n", [64, 93, 128, 255])
def test_hilbert_matches_scipy(rng, n):
    x = rng.standard_normal((4, n)).astype(np.float64)
    ref = ss.hilbert(x, axis=-1)
    got = tpufft.hilbert(x, axis=-1, config=CFG_XLA)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(np.asarray(got) - ref)) / scale < 1e-3


def test_hilbert_padded_and_kernel_path(rng):
    x = rng.standard_normal((3, 100))
    ref = ss.hilbert(x, N=128, axis=-1)
    for cfg in (CFG_KERNEL, CFG_XLA):
        got = tpufft.hilbert(x, N=128, axis=-1, config=cfg)
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(np.asarray(got) - ref)) / scale < 1e-3
    with pytest.raises(ValueError):
        tpufft.hilbert(x.astype(np.complex128))


@pytest.mark.parametrize("n,num", [(100, 50), (100, 75), (100, 200),
                                   (101, 50), (101, 64), (100, 101),
                                   (64, 64), (101, 202)])
def test_resample_matches_scipy(rng, n, num):
    x = rng.standard_normal((3, n))
    ref = ss.resample(x, num, axis=-1)
    got = tpufft.resample(x, num, axis=-1, config=CFG_XLA)
    assert np.asarray(got).shape == ref.shape
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(np.asarray(got) - ref)) / scale < 1e-3, (n, num)


def test_resample_complex_and_axis(rng):
    x = (rng.standard_normal((40, 5))
         + 1j * rng.standard_normal((40, 5)))
    ref = ss.resample(x, 64, axis=0)
    got = tpufft.resample(x, 64, axis=0, config=CFG_XLA)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(np.asarray(got) - ref)) / scale < 1e-3


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_matches_scipy(rng, mode):
    a = rng.standard_normal(50)
    b = rng.standard_normal(11)
    ref = ss.correlate(a, b, mode=mode, method="fft")
    got = tpufft.correlate(a, b, mode=mode)
    assert got.shape == ref.shape
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6


def test_correlate_complex_2d(rng):
    a = rng.standard_normal((20, 14)) + 1j * rng.standard_normal((20, 14))
    b = rng.standard_normal((4, 5)) + 1j * rng.standard_normal((4, 5))
    ref = ss.correlate(a, b, mode="full", method="fft")
    got = tpufft.correlate(a, b, mode="full")
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6


# ----------------------------------------------------------------------------
# oaconvolve


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(1000, 17), (999, 16), (64, 1000)])
def test_oaconvolve_matches_scipy(rng, mode, n1, n2):
    a = rng.standard_normal(n1)
    b = rng.standard_normal(n2)
    ref = ss.oaconvolve(a, b, mode=mode)
    got = tpufft.oaconvolve(a, b, mode=mode)
    assert got.shape == ref.shape, (mode, n1, n2)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6, (mode, n1, n2)


def test_oaconvolve_batched_and_complex(rng):
    # batch axis + OA axis (scipy axes semantics)
    a = rng.standard_normal((3, 2000))
    b = rng.standard_normal((3, 21))
    ref = ss.oaconvolve(a, b, mode="same", axes=[1])
    got = tpufft.oaconvolve(a, b, mode="same", axes=[1])
    assert got.shape == ref.shape
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6
    # complex
    z1 = rng.standard_normal(1500) + 1j * rng.standard_normal(1500)
    z2 = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    ref = ss.oaconvolve(z1, z2)
    got = tpufft.oaconvolve(z1, z2)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6


def test_oaconvolve_delegates_small_ratio(rng):
    # comparable lengths: falls back to fftconvolve (identical results)
    a = rng.standard_normal(50)
    b = rng.standard_normal(40)
    ref = ss.oaconvolve(a, b)
    got = tpufft.oaconvolve(a, b)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-6


# ----------------------------------------------------------------------------
# review regressions


def test_correlate_batched_axes_pairing(rng):
    """Reversing in2 must flip ONLY the correlated axes: batch row i pairs
    with row i, not row B-1-i."""
    a = rng.standard_normal((3, 50))
    b = rng.standard_normal((3, 6))
    got = tpufft.correlate(a, b, mode="full", axes=[1])
    for i in range(3):
        ref = ss.correlate(a[i], b[i], mode="full", method="fft")
        assert np.max(np.abs(got[i] - ref)) < 1e-6 * max(
            1.0, np.max(np.abs(ref))), i


def test_plan_filter_long_axis_no_dense_matrix():
    """Non-dense plans must not materialize (or hold) the O(n^2)
    circulant — hilbert over a long signal would need hundreds of GB."""
    plan = tpufft.plan_filter(8192, impulse=np.ones(8192) / 8192,
                              config=CFG_XLA)
    assert plan._cr is None and plan._ci is None
    # and hilbert on a long axis goes through without building matrices
    x = np.random.default_rng(0).standard_normal(100_000)
    out = tpufft.hilbert(x, config=CFG_XLA)
    ref = ss.hilbert(x)
    assert np.max(np.abs(np.asarray(out) - ref)) < 1e-3 * max(
        1.0, np.max(np.abs(ref)))


def test_fftconvolve_same_crops_broadcast_axes(rng):
    """mode='same' crops to in1's shape on EVERY axis (scipy's
    _apply_conv_mode), including broadcast non-convolved ones."""
    a = rng.standard_normal((1, 20))
    b = rng.standard_normal((5, 4))
    ref = ss.fftconvolve(a, b, mode="same", axes=[1])
    got = tpufft.fftconvolve(a, b, mode="same", axes=[1])
    assert got.shape == ref.shape == (1, 20)
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))
    ref = ss.oaconvolve(a, b, mode="same", axes=[1])
    got = tpufft.oaconvolve(a, b, mode="same", axes=[1])
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-8 * max(1.0, np.max(np.abs(ref)))


def test_filter_f64_real_keeps_f64_tier(rng):
    """float64 real input on CPU+x64 gets the 1e-12 tier like complex128
    (it used to silently compute in f32 while returning float64)."""
    n = 64
    h = rng.standard_normal(n)
    plan = tpufft.plan_filter(n, impulse=h, config=CFG_XLA)
    x = rng.standard_normal((4, n))  # float64
    got = np.asarray(plan(x))
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * np.fft.fft(h), axis=-1).real
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-10


def test_fftconvolve_empty_and_bad_axes(rng):
    out = tpufft.fftconvolve(np.array([]), np.array([1.0]))
    assert out.shape == (0,)
    with pytest.raises(ValueError):
        tpufft.fftconvolve(np.ones(3), np.ones(3), axes=())


# ----------------------------------------------------------------------------
# envelope (scipy.signal.envelope parity, scipy >= 1.16)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(bp_in=(5, 40)), dict(bp_in=(None, 30)),
    dict(bp_in=(-20, 30)), dict(n_out=150), dict(n_out=450),
    dict(n_out=151), dict(squared=True), dict(residual="all"),
    dict(residual=None), dict(bp_in=(5, 40), n_out=100, residual="all"),
    dict(bp_in=(-30, -5)), dict(bp_in=(0, 50)),
])
def test_envelope_matches_scipy(rng, kwargs):
    import scipy.signal as sps

    x = rng.standard_normal(300)
    z = x + 1j * rng.standard_normal(300)
    for sig in (x, z):
        got = np.asarray(tpufft.envelope(sig, **kwargs))
        want = np.asarray(sps.envelope(sig, **kwargs))
        scale = max(1.0, float(np.max(np.abs(want))))
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) / scale < 1e-10


def test_envelope_axis_and_jax(rng):
    import jax.numpy as jnp
    import scipy.signal as sps

    X = rng.standard_normal((4, 201, 3))
    got = np.asarray(tpufft.envelope(X, axis=1))
    want = sps.envelope(X, axis=1)
    assert np.max(np.abs(got - want)) < 1e-10
    # jax f32 caller -> device path
    xj = jnp.asarray(X[0, :, 0].astype(np.float32))
    got = np.asarray(tpufft.envelope(xj, bp_in=(3, 50)))
    want = sps.envelope(X[0, :, 0], bp_in=(3, 50))
    assert np.max(np.abs(got - want)) / max(
        1.0, float(np.max(np.abs(want)))) < 1e-5


def test_envelope_errors(rng):
    x = rng.standard_normal(64)
    with pytest.raises(ValueError, match="bp_in"):
        tpufft.envelope(x, bp_in=(1.5, None))
    with pytest.raises(ValueError, match="does not hold"):
        tpufft.envelope(x, bp_in=(40, 10))
    with pytest.raises(ValueError, match="n_out"):
        tpufft.envelope(x, n_out=-3)
    with pytest.raises(ValueError, match="residual"):
        tpufft.envelope(x, residual="bogus")
