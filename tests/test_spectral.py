"""Spectral-analysis layer tests — parity with scipy.signal's stft, istft,
spectrogram, periodogram, welch, csd, coherence, check_NOLA/check_COLA
(scipy is the spec; the reference has no counterpart — tpufft.spectral is
a beyond-parity surface where the framework's batched transforms are the
engine)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps

import tpufft
from tpufft import PlanConfig, SplitComplex
from tpufft import spectral as tsp


def _cmp(got, want, tol=1e-11):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) / scale < tol


# ----------------------------------------------------------------------------
# stft / istft


@pytest.mark.parametrize("nperseg,noverlap,nfft", [
    (128, None, None), (99, 33, None), (64, 48, 100), (100, 50, 128)])
def test_stft_matches_scipy(rng, nperseg, noverlap, nfft):
    x = rng.standard_normal(900)
    f1, t1, Z1 = tsp.stft(x, fs=7.5, nperseg=nperseg, noverlap=noverlap,
                          nfft=nfft)
    f2, t2, Z2 = sps.stft(x, fs=7.5, nperseg=nperseg, noverlap=noverlap,
                          nfft=nfft)
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(t1, t2)
    _cmp(Z1, Z2)


@pytest.mark.parametrize("boundary", ["zeros", "even", "odd", "constant",
                                      None])
@pytest.mark.parametrize("padded", [True, False])
def test_stft_boundary_padded(rng, boundary, padded):
    x = rng.standard_normal(777)
    f1, t1, Z1 = tsp.stft(x, nperseg=99, boundary=boundary, padded=padded)
    f2, t2, Z2 = sps.stft(x, nperseg=99, boundary=boundary, padded=padded)
    np.testing.assert_allclose(t1, t2)
    _cmp(Z1, Z2)


def test_stft_complex_twosided(rng):
    z = rng.standard_normal(400) + 1j * rng.standard_normal(400)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f1, t1, Z1 = tsp.stft(z, nperseg=64, return_onesided=False)
        f2, t2, Z2 = sps.stft(z, nperseg=64, return_onesided=False)
    np.testing.assert_allclose(f1, f2)
    _cmp(Z1, Z2)


def test_stft_complex_warns_onesided(rng):
    z = rng.standard_normal(128) + 1j * rng.standard_normal(128)
    with pytest.warns(UserWarning, match="complex"):
        tsp.stft(z, nperseg=32)


@pytest.mark.parametrize("scaling", ["spectrum", "psd"])
def test_stft_istft_roundtrip(rng, scaling):
    x = rng.standard_normal(1000)
    f, t, Z = tsp.stft(x, nperseg=120, scaling=scaling)
    f2, t2, Z2 = sps.stft(x, nperseg=120, scaling=scaling)
    _cmp(Z, Z2)
    t1, x1 = tsp.istft(Z, nperseg=120, scaling=scaling)
    t2, x2 = sps.istft(Z2, nperseg=120, scaling=scaling)
    _cmp(x1, x2)
    _cmp(x1[:1000], x, tol=1e-10)


def test_istft_twosided_complex(rng):
    z = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, _, Zc = sps.stft(z, nperseg=64, return_onesided=False)
    t1, x1 = tsp.istft(Zc, input_onesided=False)
    t2, x2 = sps.istft(Zc, input_onesided=False)
    assert np.iscomplexobj(x1)
    _cmp(x1, x2)


def test_istft_axes_multidim(rng):
    X = rng.standard_normal((3, 500, 2))
    f, t, Z = sps.stft(X, nperseg=64, axis=1)
    t1, x1 = tsp.istft(Z, nperseg=64, time_axis=-1, freq_axis=1)
    t2, x2 = sps.istft(Z, nperseg=64, time_axis=-1, freq_axis=1)
    _cmp(x1, x2)


def test_istft_nola_warns():
    # hann endpoints are zero: with no overlap the squared-window OLA has
    # zero bins -> NOLA fails; scipy (>=1.15) warns rather than raises
    assert not sps.check_NOLA("hann", 64, 0)
    Z = np.zeros((33, 10), np.complex128)
    with pytest.warns(UserWarning, match="NOLA"):
        tsp.istft(Z, window="hann", nperseg=64, noverlap=0,
                  boundary=False)


def test_check_nola_cola():
    for win, nperseg, noverlap in [("hann", 128, 64), ("boxcar", 64, 0),
                                   ("hann", 100, 13)]:
        assert (tsp.check_NOLA(win, nperseg, noverlap)
                == sps.check_NOLA(win, nperseg, noverlap))
        assert (tsp.check_COLA(win, nperseg, noverlap)
                == sps.check_COLA(win, nperseg, noverlap))


# ----------------------------------------------------------------------------
# welch / csd / periodogram / coherence


@pytest.mark.parametrize("detrend", ["constant", "linear", False])
@pytest.mark.parametrize("scaling", ["density", "spectrum"])
def test_welch_matches_scipy(rng, detrend, scaling):
    x = rng.standard_normal(777)
    f1, P1 = tsp.welch(x, fs=3.0, nperseg=100, detrend=detrend,
                       scaling=scaling)
    f2, P2 = sps.welch(x, fs=3.0, nperseg=100, detrend=detrend,
                       scaling=scaling)
    np.testing.assert_allclose(f1, f2)
    _cmp(P1, P2)


def test_welch_median_and_odd(rng):
    x = rng.standard_normal(900)
    f1, P1 = tsp.welch(x, nperseg=101, nfft=160, average="median")
    f2, P2 = sps.welch(x, nperseg=101, nfft=160, average="median")
    _cmp(P1, P2)


def test_welch_window_array_and_shrink(rng):
    x = rng.standard_normal(500)
    w = sps.get_window(("kaiser", 8.0), 96)
    f1, P1 = tsp.welch(x, window=w)
    f2, P2 = sps.welch(x, window=w)
    _cmp(P1, P2)
    with pytest.warns(UserWarning, match="nperseg"):
        f1, P1 = tsp.welch(x[:100], nperseg=256)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f2, P2 = sps.welch(x[:100], nperseg=256)
    _cmp(P1, P2)


def test_welch_complex_twosided(rng):
    z = rng.standard_normal(600) + 1j * rng.standard_normal(600)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f1, P1 = tsp.welch(z, nperseg=128)
        f2, P2 = sps.welch(z, nperseg=128)
    np.testing.assert_allclose(f1, f2)
    _cmp(P1, P2)


def test_welch_axis_multidim(rng):
    X = rng.standard_normal((3, 500, 2))
    f1, P1 = tsp.welch(X, nperseg=64, axis=1)
    f2, P2 = sps.welch(X, nperseg=64, axis=1)
    _cmp(P1, P2)


def test_csd_matches_scipy(rng):
    x = rng.standard_normal(777)
    y = rng.standard_normal(600)  # different length: zero-pad semantics
    f1, P1 = tsp.csd(x, y, nperseg=128)
    f2, P2 = sps.csd(x, y, nperseg=128)
    _cmp(P1, P2)


def test_csd_median_complex_bias(rng):
    x = rng.standard_normal(777)
    y = rng.standard_normal(777)
    f1, P1 = tsp.csd(x, y, nperseg=128, average="median")
    f2, P2 = sps.csd(x, y, nperseg=128, average="median")
    _cmp(P1, P2)


@pytest.mark.parametrize("nfft", [None, 512, 1024])
def test_periodogram_matches_scipy(rng, nfft):
    x = rng.standard_normal(777)
    f1, P1 = tsp.periodogram(x, fs=2.5, nfft=nfft)
    f2, P2 = sps.periodogram(x, fs=2.5, nfft=nfft)
    np.testing.assert_allclose(f1, f2)
    _cmp(P1, P2)


def test_coherence_matches_scipy(rng):
    x = rng.standard_normal(800)
    y = x + 0.5 * rng.standard_normal(800)
    f1, C1 = tsp.coherence(x, y, nperseg=128)
    f2, C2 = sps.coherence(x, y, nperseg=128)
    _cmp(C1, C2)


# ----------------------------------------------------------------------------
# spectrogram


@pytest.mark.parametrize("mode", ["psd", "complex", "magnitude"])
def test_spectrogram_matches_scipy(rng, mode):
    x = rng.standard_normal(777)
    f1, t1, S1 = tsp.spectrogram(x, fs=5.0, nperseg=80, mode=mode)
    f2, t2, S2 = sps.spectrogram(x, fs=5.0, nperseg=80, mode=mode)
    np.testing.assert_allclose(t1, t2)
    _cmp(S1, S2)


@pytest.mark.parametrize("mode", ["angle", "phase"])
def test_spectrogram_angle_modes(rng, mode):
    # angles agree up to the +-pi branch cut (imag parts ~1e-17 flip the
    # sign of the cut in either implementation) -> compare on the circle
    x = rng.standard_normal(777)
    f1, t1, S1 = tsp.spectrogram(x, nperseg=80, mode=mode)
    f2, t2, S2 = sps.spectrogram(x, nperseg=80, mode=mode)
    assert S1.shape == S2.shape
    np.testing.assert_allclose(np.exp(1j * S1), np.exp(1j * S2),
                               atol=1e-9)


def test_spectrogram_default_window(rng):
    x = rng.standard_normal(1500)
    f1, t1, S1 = tsp.spectrogram(x)
    f2, t2, S2 = sps.spectrogram(x)
    np.testing.assert_allclose(t1, t2)
    _cmp(S1, S2)


# ----------------------------------------------------------------------------
# device paths (jax arrays, SplitComplex planes)


def test_stft_jax_input_f32(rng):
    x = rng.standard_normal(800).astype(np.float32)
    f1, t1, Z1 = tsp.stft(jnp.asarray(x), nperseg=128)
    f2, t2, Z2 = sps.stft(x.astype(np.float64), nperseg=128)
    assert isinstance(Z1, jax.Array)
    _cmp(np.asarray(Z1), Z2, tol=1e-5)


def test_welch_jax_and_interpret_kernel(rng):
    x = rng.standard_normal(800).astype(np.float32)
    f2, P2 = sps.welch(x.astype(np.float64), nperseg=128)
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=128)
    assert isinstance(P1, jax.Array)
    _cmp(np.asarray(P1), P2, tol=1e-5)
    cfg = PlanConfig()
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=128, config=cfg)
    _cmp(np.asarray(P1), P2, tol=1e-4)


def test_istft_jax_roundtrip(rng):
    x = rng.standard_normal(800).astype(np.float32)
    _, _, Z = tsp.stft(jnp.asarray(x), nperseg=128)
    _, xr = tsp.istft(Z, nperseg=128)
    assert isinstance(xr, jax.Array)
    _cmp(np.asarray(xr)[:800], x, tol=1e-5)


def test_welch_splitcomplex_input(rng):
    zr = rng.standard_normal(512).astype(np.float32)
    zi = rng.standard_normal(512).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f1, P1 = tsp.welch(SplitComplex(jnp.asarray(zr), jnp.asarray(zi)),
                           nperseg=64)
        f2, P2 = sps.welch(zr.astype(np.float64)
                           + 1j * zi.astype(np.float64), nperseg=64)
    _cmp(np.asarray(P1), P2, tol=1e-5)


def test_get_window_passthrough():
    np.testing.assert_allclose(tsp.get_window("hann", 64),
                               sps.get_window("hann", 64))
    np.testing.assert_allclose(tsp.get_window(("tukey", 0.3), 50),
                               sps.get_window(("tukey", 0.3), 50))


def test_spectral_exported():
    for name in ("stft", "istft", "spectrogram", "periodogram", "welch",
                 "csd", "coherence", "get_window", "check_NOLA",
                 "check_COLA"):
        assert hasattr(tpufft, name), name
        assert name in tpufft.__all__


def test_spectral_errors(rng):
    x = rng.standard_normal(256)
    with pytest.raises(ValueError, match="noverlap"):
        tsp.welch(x, nperseg=64, noverlap=64)
    with pytest.raises(ValueError, match="nfft"):
        tsp.welch(x, nperseg=64, nfft=32)
    with pytest.raises(ValueError, match="scaling|Unknown"):
        tsp.welch(x, scaling="bogus")
    with pytest.raises(ValueError, match="average"):
        tsp.welch(x, average="bogus")
    with pytest.raises(ValueError, match="boundary"):
        tsp.stft(x, boundary="bogus")
    with pytest.raises(ValueError, match="2d"):
        tsp.istft(np.zeros(8, np.complex128))


# ----------------------------------------------------------------------------
# short-time geometries of the retired fused kernels, on the plain path:
# values against scipy.signal, gradients against jax.scipy.signal


@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
def test_stft_fused_overlap_dispatch_and_values(rng, detrend):
    """stft at a 75%-overlap geometry matches scipy, folded detrend
    included."""
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    f1, t1, Z1 = tsp.stft(jnp.asarray(x), fs=2.0, nperseg=512,
                          noverlap=384, detrend=detrend)
    f2, t2, Z2 = sps.stft(x.astype(np.float64), fs=2.0, nperseg=512,
                          noverlap=384, detrend=detrend)
    assert isinstance(Z1, jax.Array)
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(t1, t2)
    _cmp(np.asarray(Z1), Z2, tol=1e-5)


def test_stft_fused_overlap_grad(rng):
    """jax.grad of the stft power equals the grad through
    jax.scipy.signal.stft (an independent jnp.fft composition)."""
    import jax.scipy.signal as jss

    x = jnp.asarray(rng.standard_normal((2, 2048)).astype(np.float32))

    def ours(v):
        _, _, Z = tsp.stft(v, nperseg=256, noverlap=128, boundary=None,
                           padded=False)
        return jnp.sum(jnp.abs(Z) ** 2)

    def ref(v):
        _, _, Z = jss.stft(v, nperseg=256, noverlap=128, boundary=None,
                           padded=False)
        return jnp.sum(jnp.abs(Z) ** 2)

    np.testing.assert_allclose(np.asarray(jax.grad(ours)(x)),
                               np.asarray(jax.grad(ref)(x)),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("nperseg,noverlap", [(512, 384), (256, 128)])
def test_istft_fused_ola_dispatch_and_roundtrip(rng, nperseg, noverlap):
    """istft inverts stft to the input signal."""
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    _, _, Z = tsp.stft(jnp.asarray(x), nperseg=nperseg, noverlap=noverlap)
    _, xr = tsp.istft(Z, nperseg=nperseg, noverlap=noverlap)
    np.testing.assert_allclose(np.asarray(xr)[:, :4096], x,
                               rtol=1e-4, atol=1e-4)


def test_istft_fused_ola_matches_scipy(rng):
    """istft on an arbitrary (non-roundtrip) spectrum matches
    scipy.signal.istft, including the window-sum normalization edges."""
    Z = (rng.standard_normal((2, 129, 31))
         + 1j * rng.standard_normal((2, 129, 31)))
    zr = jnp.asarray(Z.real.astype(np.float32))
    zi = jnp.asarray(Z.imag.astype(np.float32))
    _, x1 = tsp.istft(SplitComplex(zr, zi), nperseg=256, noverlap=128)
    _, x2 = sps.istft(Z, nperseg=256, noverlap=128)
    _cmp(np.asarray(x1), x2, tol=1e-4)


def test_istft_fused_ola_grad(rng):
    """jax.grad through istft equals the grad through
    jax.scipy.signal.istft."""
    import jax.scipy.signal as jss

    Z = (rng.standard_normal((2, 17, 129))
         + 1j * rng.standard_normal((2, 17, 129))).astype(np.complex64)
    zr = jnp.asarray(np.ascontiguousarray(Z.real))
    zi = jnp.asarray(np.ascontiguousarray(Z.imag))

    def ours(a, b):
        _, out = tsp.istft(SplitComplex(a, b), nperseg=256, noverlap=128,
                           time_axis=-2, freq_axis=-1)
        return jnp.sum(out ** 2)

    def ref(a, b):
        _, out = jss.istft(jax.lax.complex(a, b), nperseg=256,
                           noverlap=128, time_axis=-2, freq_axis=-1)
        return jnp.sum(out ** 2)

    g1 = jax.grad(ours, argnums=(0, 1))(zr, zi)
    g2 = jax.grad(ref, argnums=(0, 1))(zr, zi)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("detrend", ["constant", "linear", False])
def test_welch_fused_accum_dispatch_and_values(rng, detrend):
    """welch matches scipy.signal.welch including detrend and PSD
    scaling."""
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=512, noverlap=384,
                       detrend=detrend)
    f2, P2 = sps.welch(x.astype(np.float64), nperseg=512, noverlap=384,
                       detrend=detrend)
    np.testing.assert_allclose(f1, f2)
    _cmp(np.asarray(P1), P2, tol=1e-4)


def test_csd_fused_accum_cross(rng):
    """Cross-spectral density conj(Zx)·Zy matches scipy.signal.csd."""
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y = rng.standard_normal((2, 4096)).astype(np.float32)
    f1, C1 = tsp.csd(jnp.asarray(x), jnp.asarray(y), nperseg=512,
                     noverlap=384)
    f2, C2 = sps.csd(x.astype(np.float64), y.astype(np.float64),
                     nperseg=512, noverlap=384)
    assert isinstance(C1, jax.Array)
    _cmp(np.asarray(C1), C2, tol=1e-4)


def test_welch_fused_median_not_fused(rng):
    """average='median' matches scipy."""
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=512, noverlap=384,
                       average="median")
    f2, P2 = sps.welch(x.astype(np.float64), nperseg=512, noverlap=384,
                       average="median")
    _cmp(np.asarray(P1), P2, tol=1e-4)


def test_welch_fused_grad(rng):
    """jax.grad through welch equals the grad through
    jax.scipy.signal.welch."""
    import jax.scipy.signal as jss

    x = jnp.asarray(rng.standard_normal((2, 2048)).astype(np.float32))

    def ours(v):
        return jnp.sum(tsp.welch(v, nperseg=256, noverlap=128)[1])

    def ref(v):
        return jnp.sum(jss.welch(v, nperseg=256, noverlap=128)[1])

    np.testing.assert_allclose(np.asarray(jax.grad(ours)(x)),
                               np.asarray(jax.grad(ref)(x)),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("batch,n", [(3, 4096), (5, 3000)])
def test_welch_fused_segment_group(rng, batch, n):
    """Small batches, including nseg not a multiple of any block size,
    match scipy."""
    x = rng.standard_normal((batch, n)).astype(np.float32)
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=256, noverlap=128)
    f2, P2 = sps.welch(x.astype(np.float64), nperseg=256, noverlap=128)
    _cmp(np.asarray(P1), P2, tol=1e-4)


def test_welch_fused_group_one_for_big_batch(rng):
    """A batch of 130 rows matches scipy."""
    x = rng.standard_normal((130, 1024)).astype(np.float32)
    f1, P1 = tsp.welch(jnp.asarray(x), nperseg=256, noverlap=128)
    f2, P2 = sps.welch(x.astype(np.float64), nperseg=256, noverlap=128)
    _cmp(np.asarray(P1), P2, tol=1e-4)


def test_stft_fused_segment_group(rng):
    """Small-batch stft with a segment count of no special size matches
    scipy."""
    x = rng.standard_normal((5, 3000)).astype(np.float32)
    f1, t1, Z1 = tsp.stft(jnp.asarray(x), nperseg=256, noverlap=128)
    f2, t2, Z2 = sps.stft(x.astype(np.float64), nperseg=256, noverlap=128)
    _cmp(np.asarray(Z1), Z2, tol=1e-5)


def test_istft_fused_segment_group(rng):
    """Small-batch istft inverts the stft exactly."""
    x = rng.standard_normal((5, 3000)).astype(np.float32)
    _, _, Z = tsp.stft(jnp.asarray(x), nperseg=256, noverlap=128)
    _, xr = tsp.istft(Z, nperseg=256, noverlap=128)
    np.testing.assert_allclose(np.asarray(xr)[:, :3000], x,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# lombscargle
# ---------------------------------------------------------------------------

def _ls_data(n=300, nf=257, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(2.3 * x) + 0.5 * rng.standard_normal(n) + 2.0
    f = np.linspace(0.1, 5, nf)
    w = rng.uniform(0.5, 2.0, n)
    return x, y, f, w


@pytest.mark.parametrize("kwargs", [
    {},
    {"normalize": True},
    {"normalize": "amplitude"},
    {"floating_mean": True},
    {"weights": "w"},
    {"weights": "w", "floating_mean": True},
    {"weights": "w", "normalize": "amplitude", "floating_mean": True},
    {"weights": "w", "normalize": True, "floating_mean": True},
])
def test_lombscargle_matches_scipy(kwargs):
    x, y, f, w = _ls_data()
    kwargs = dict(kwargs)
    if kwargs.get("weights") == "w":
        kwargs["weights"] = w
    mine = tpufft.lombscargle(x, y, f, **kwargs)
    ref = sps.lombscargle(x, y, f, **kwargs)
    assert isinstance(mine, np.ndarray)
    np.testing.assert_allclose(mine, ref, rtol=1e-10, atol=1e-12)


def test_lombscargle_device_path():
    x, y, f, _ = _ls_data()
    mine = tpufft.lombscargle(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(f), floating_mean=True)
    assert isinstance(mine, jax.Array)
    ref = sps.lombscargle(x, y, f, floating_mean=True)
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=1e-8)
    amp = tpufft.lombscargle(jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(f), normalize="amplitude")
    np.testing.assert_allclose(np.asarray(amp),
                               sps.lombscargle(x, y, f,
                                              normalize="amplitude"),
                               rtol=0, atol=1e-10)


def test_lombscargle_peak_detection():
    # physical sanity: the strongest peak sits at the injected frequency
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 200, 500))
    y = np.cos(1.7 * x)
    f = np.linspace(0.5, 3.0, 2001)
    p = tpufft.lombscargle(x, y, f)
    assert abs(f[np.argmax(p)] - 1.7) < 0.01


def test_lombscargle_validation_and_deprecation():
    x, y, f, w = _ls_data(50, 16)
    with pytest.raises(ValueError):
        tpufft.lombscargle(x, y[:-1], f)
    with pytest.raises(ValueError):
        tpufft.lombscargle(x, y, f, normalize="nope")
    with pytest.raises(ValueError):
        tpufft.lombscargle(x, y, f, weights=-w)
    with pytest.raises(ValueError):
        tpufft.lombscargle(x, y, np.zeros((2, 2)))
    with pytest.warns(DeprecationWarning):
        a = tpufft.lombscargle(x, y, f, precenter=True)
    with pytest.warns(DeprecationWarning):
        b = sps.lombscargle(x, y, f, precenter=True)
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_lombscargle_numpy_weights_validated_with_jax_data():
    """Host-side weights must be validated even when x/y are device
    arrays (the old check only ran on the all-numpy path)."""
    import jax.numpy as jnp
    from tpufft.spectral import lombscargle

    x = jnp.linspace(0.0, 10.0, 50)
    y = jnp.sin(x)
    freqs = jnp.linspace(0.1, 3.0, 16)
    bad = np.ones(50)
    bad[3] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        lombscargle(x, y, freqs, weights=bad)
    with pytest.raises(ValueError, match="non-negative"):
        lombscargle(np.asarray(x), np.asarray(y), np.asarray(freqs),
                    weights=np.zeros(50))
