"""ShortTimeFFT parity battery vs scipy.signal.ShortTimeFFT.

The reference (martinvuyk/hackathon-fft) has no short-time layer; the
parity target is scipy/signal/_short_time_fft.py (scipy >= 1.12 class
API). numpy input runs the host x64 tier, so parity is 1e-10-class;
jax input is checked against the same scipy values at f32 tolerance.
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp

import tpufft
from tpufft import ShortTimeFFT, SplitComplex


def _mk(fft_mode="onesided", win_len=16, hop=4, fs=8.0, mfft=None,
        phase_shift=0, scale_to=None, win=None):
    """Matching (tpufft, scipy) instance pair."""
    if win is None:
        win = sps.get_window("hann", win_len)
    ours = ShortTimeFFT(win, hop, fs, fft_mode=fft_mode, mfft=mfft,
                        phase_shift=phase_shift, scale_to=scale_to)
    theirs = sps.ShortTimeFFT(win, hop, fs, fft_mode=fft_mode, mfft=mfft,
                              phase_shift=phase_shift, scale_to=scale_to)
    return ours, theirs


def _sig(n=100, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
    return x


def _np(X):
    if isinstance(X, SplitComplex):
        return X.numpy()
    return np.asarray(X)


# ---------------------------------------------------------------------------
# stft / istft value parity


@pytest.mark.parametrize("fft_mode", ["twosided", "centered", "onesided",
                                      "onesided2X"])
@pytest.mark.parametrize("mfft_pad", [0, 5])
def test_stft_parity_modes(fft_mode, mfft_pad):
    win_len, hop = 16, 4
    scale = "magnitude" if fft_mode == "onesided2X" else None
    ours, theirs = _mk(fft_mode, win_len, hop, mfft=win_len + mfft_pad,
                       scale_to=scale)
    x = _sig(120)
    got, want = _np(ours.stft(x)), theirs.stft(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("phase_shift", [None, 0, 2, -5])
def test_stft_parity_phase_shift(phase_shift):
    ours, theirs = _mk("onesided", 17, 5, mfft=23, phase_shift=phase_shift)
    x = _sig(97, seed=3)
    np.testing.assert_allclose(_np(ours.stft(x)), theirs.stft(x),
                               atol=1e-10)


@pytest.mark.parametrize("fft_mode", ["twosided", "centered"])
def test_stft_parity_complex_input(fft_mode):
    ours, theirs = _mk(fft_mode, 16, 4)
    x = _sig(90, seed=5, complex_=True)
    np.testing.assert_allclose(_np(ours.stft(x)), theirs.stft(x),
                               atol=1e-10)


def test_stft_parity_complex_window():
    win = sps.get_window("hann", 16) * np.exp(1j * np.linspace(0, 1, 16))
    ours = ShortTimeFFT(win, 4, 2.0, fft_mode="twosided")
    theirs = sps.ShortTimeFFT(win, 4, 2.0, fft_mode="twosided")
    x = _sig(80, seed=7)
    np.testing.assert_allclose(_np(ours.stft(x)), theirs.stft(x),
                               atol=1e-10)


@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_stft_parity_padding(padding):
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(60, seed=11)
    np.testing.assert_allclose(_np(ours.stft(x, padding=padding)),
                               theirs.stft(x, padding=padding), atol=1e-10)


def test_stft_parity_p0_p1_k_offset():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=13)
    np.testing.assert_allclose(
        _np(ours.stft(x, p0=2, p1=12, k_offset=3)),
        theirs.stft(x, p0=2, p1=12, k_offset=3), atol=1e-10)


def test_stft_parity_axis_and_batch():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(3 * 90, seed=17).reshape(3, 90)
    np.testing.assert_allclose(_np(ours.stft(x, axis=-1)),
                               theirs.stft(x, axis=-1), atol=1e-10)
    xt = x.T  # transform axis 0
    np.testing.assert_allclose(_np(ours.stft(xt, axis=0)),
                               theirs.stft(xt, axis=0), atol=1e-10)


@pytest.mark.parametrize("detr", ["constant", "linear"])
def test_stft_detrend_parity(detr):
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=19) + np.linspace(0, 4, 100)
    np.testing.assert_allclose(_np(ours.stft_detrend(x, detr)),
                               theirs.stft_detrend(x, detr), atol=1e-10)


def test_stft_detrend_callable():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=23)
    f = lambda fr: fr - np.mean(fr, axis=-1, keepdims=True)  # noqa: E731
    np.testing.assert_allclose(_np(ours.stft_detrend(x, f)),
                               theirs.stft_detrend(x, f), atol=1e-10)


@pytest.mark.parametrize("fft_mode", ["twosided", "centered", "onesided",
                                      "onesided2X"])
@pytest.mark.parametrize("scaling", ["magnitude", "psd"])
def test_istft_roundtrip_modes(fft_mode, scaling):
    ours, theirs = _mk(fft_mode, 16, 4, mfft=20, scale_to=scaling)
    x = _sig(100, seed=29)
    S = ours.stft(x)
    got = _np(ours.istft(S, k1=100))
    want = theirs.istft(theirs.stft(x), k1=100)
    np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(got, x, atol=1e-9)


def test_istft_k0_k1_window():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=31)
    S_o, S_t = ours.stft(x), theirs.stft(x)
    np.testing.assert_allclose(_np(ours.istft(S_o, k0=8, k1=72)),
                               theirs.istft(S_t, k0=8, k1=72), atol=1e-10)


def test_istft_axis_placement():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(2 * 90, seed=37).reshape(2, 90)
    S_o, S_t = _np(ours.stft(x)), theirs.stft(x)
    # move f/t axes around
    S_om = np.moveaxis(S_o, (-2, -1), (0, 1))
    S_tm = np.moveaxis(S_t, (-2, -1), (0, 1))
    np.testing.assert_allclose(
        _np(ours.istft(S_om, k1=90, f_axis=0, t_axis=1)),
        theirs.istft(S_tm, k1=90, f_axis=0, t_axis=1), atol=1e-10)


def test_spectrogram_parity_auto_and_cross():
    ours, theirs = _mk("onesided", 16, 4)
    x, y = _sig(100, seed=41), _sig(100, seed=43)
    np.testing.assert_allclose(_np(ours.spectrogram(x)),
                               theirs.spectrogram(x), atol=1e-10)
    np.testing.assert_allclose(_np(ours.spectrogram(x, y)),
                               theirs.spectrogram(x, y), atol=1e-10)


# ---------------------------------------------------------------------------
# constructors, scaling, dual windows


def test_from_window_parity():
    for sym in (False, True):
        ours = ShortTimeFFT.from_window("hamming", 8.0, 20, 15,
                                        symmetric_win=sym)
        theirs = sps.ShortTimeFFT.from_window(
            "hamming", 8.0, 20, 15, symmetric_win=sym)
        np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
        assert ours.hop == theirs.hop and ours.fs == theirs.fs


def test_from_dual_parity():
    dual = sps.get_window("hann", 16) + 0.1
    ours = ShortTimeFFT.from_dual(dual, 4, 2.0)
    theirs = sps.ShortTimeFFT.from_dual(dual, 4, 2.0)
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
    np.testing.assert_allclose(ours.dual_win, theirs.dual_win, atol=1e-12)
    x = _sig(80, seed=47)
    np.testing.assert_allclose(_np(ours.istft(ours.stft(x), k1=80)), x,
                               atol=1e-9)


def test_from_win_equals_dual():
    ours = ShortTimeFFT.from_win_equals_dual(np.ones(16), 4, 1.0)
    theirs = sps.ShortTimeFFT.from_win_equals_dual(np.ones(16), 4, 1.0)
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
    np.testing.assert_allclose(ours.win, ours.dual_win, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(scale_to="unitary"),
    dict(scale_to="unitary", fft_mode="twosided"),
    dict(scale_to="unitary", mfft=32),
    dict(scale_to="psd"),
])
def test_from_win_equals_dual_scalings(kw):
    win = sps.windows.gaussian(24, 5, sym=True)
    ours = ShortTimeFFT.from_win_equals_dual(win, 6, 1.0, **kw)
    theirs = sps.ShortTimeFFT.from_win_equals_dual(win, 6, 1.0, **kw)
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
    np.testing.assert_allclose(ours.dual_win, theirs.dual_win, atol=1e-12)
    assert ours.scaling == theirs.scaling


def test_from_win_equals_dual_unitary_energy():
    # a unitary STFT preserves the signal's energy (scipy's doc example)
    win = sps.windows.gaussian(36, 5, sym=True)
    sft = ShortTimeFFT.from_win_equals_dual(
        win, 8, fs=1 / 36, fft_mode="twosided", scale_to="unitary")
    x = np.tile([-1.0, -1.0, 1.0, 1.0], 5)
    Sx = np.asarray(sft.stft(x))
    assert np.isclose(np.sum(np.abs(Sx) ** 2), np.sum(x ** 2))
    np.testing.assert_allclose(
        np.asarray(sft.istft(Sx, 0, len(x))).real, x, atol=1e-9)


def test_from_win_equals_dual_errors_match_scipy():
    for args, kw in [
        ((np.ones(16, int), 8, 1.0), {}),              # integer dtype
        ((np.ones(16), 20, 1.0), {}),                  # hop > len(win)
        ((np.ones(16), 8, 1.0),
         dict(fft_mode="onesided2X", scale_to="unitary")),
        ((np.ones(16), 8, 1.0), dict(scale_to="bogus")),
    ]:
        with pytest.raises(ValueError):
            ShortTimeFFT.from_win_equals_dual(*args, **kw)
        with pytest.raises(ValueError):
            sps.ShortTimeFFT.from_win_equals_dual(*args, **kw)
    # scale_to() itself still rejects 'unitary' (scipy parity: only this
    # constructor can set it)
    with pytest.raises(ValueError):
        ShortTimeFFT(np.ones(16), 8, 1.0).scale_to("unitary")


def test_scale_to_and_factors():
    ours, theirs = _mk("onesided", 16, 4, fs=13.0)
    assert ours.scaling is None and theirs.scaling is None
    np.testing.assert_allclose(ours.fac_magnitude, theirs.fac_magnitude)
    np.testing.assert_allclose(ours.fac_psd, theirs.fac_psd)
    _ = ours.dual_win  # force lazy dual before scaling
    _ = theirs.dual_win
    ours.scale_to("psd")
    theirs.scale_to("psd")
    assert ours.scaling == "psd"
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
    np.testing.assert_allclose(ours.dual_win, theirs.dual_win, atol=1e-12)
    # idempotent
    ours.scale_to("psd")
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)
    ours.scale_to("magnitude")
    theirs.scale_to("magnitude")
    np.testing.assert_allclose(ours.win, theirs.win, atol=1e-12)


def test_invertible_false_on_gappy_window():
    win = np.zeros(16)
    win[:2] = 1.0  # hop 4 leaves uncovered samples
    ours = ShortTimeFFT(win, 4, 1.0)
    theirs = sps.ShortTimeFFT(win, 4, 1.0)
    assert ours.invertible == theirs.invertible == False  # noqa: E712


# ---------------------------------------------------------------------------
# index bookkeeping parity


@pytest.mark.parametrize("win_len,hop,mfft", [(16, 4, 16), (17, 5, 23),
                                              (16, 16, 20), (7, 2, 7),
                                              (32, 7, 37)])
def test_index_surface_parity(win_len, hop, mfft):
    ours, theirs = _mk("onesided", win_len, hop, fs=3.0, mfft=mfft)
    assert ours.m_num == theirs.m_num
    assert ours.m_num_mid == theirs.m_num_mid
    assert ours.p_min == theirs.p_min
    assert ours.k_min == theirs.k_min
    assert ours.f_pts == theirs.f_pts
    assert ours.onesided_fft == theirs.onesided_fft
    np.testing.assert_allclose(ours.delta_t, theirs.delta_t)
    np.testing.assert_allclose(ours.delta_f, theirs.delta_f)
    np.testing.assert_allclose(ours.T, theirs.T)
    np.testing.assert_allclose(ours.f, theirs.f, atol=1e-12)
    assert ours.lower_border_end == theirs.lower_border_end
    for n in (40, 53, 100):
        assert ours.p_max(n) == theirs.p_max(n)
        assert ours.k_max(n) == theirs.k_max(n)
        assert ours.p_num(n) == theirs.p_num(n)
        assert ours.upper_border_begin(n) == theirs.upper_border_begin(n)
        np.testing.assert_allclose(ours.t(n), theirs.t(n))


@pytest.mark.parametrize("fft_mode", ["twosided", "centered", "onesided"])
def test_f_and_extent_parity(fft_mode):
    ours, theirs = _mk(fft_mode, 16, 4, fs=7.0, mfft=21)
    np.testing.assert_allclose(ours.f, theirs.f, atol=1e-12)
    if fft_mode == "twosided":  # scipy: no contiguous frequency extent
        with pytest.raises(ValueError):
            ours.extent(100)
        with pytest.raises(ValueError):
            theirs.extent(100)
        return
    for axes_seq in ("tf", "ft"):
        for cb in (False, True):
            np.testing.assert_allclose(
                ours.extent(100, axes_seq, cb),
                theirs.extent(100, axes_seq, cb), atol=1e-12)


def test_nearest_k_p_parity():
    ours, theirs = _mk("onesided", 16, 5)
    for k in (-7, 0, 3, 5, 23, 100):
        for left in (True, False):
            assert ours.nearest_k_p(k, left) == theirs.nearest_k_p(k, left)


def test_t_with_slice_bounds_parity():
    ours, theirs = _mk("onesided", 16, 4)
    np.testing.assert_allclose(ours.t(100, 2, 10, k_offset=3),
                               theirs.t(100, 2, 10, k_offset=3))


# ---------------------------------------------------------------------------
# validation / error surface


def test_init_validation_errors():
    win = sps.get_window("hann", 16)
    with pytest.raises(ValueError):
        ShortTimeFFT(np.ones((4, 4)), 4, 1.0)          # 2-D win
    with pytest.raises(ValueError):
        ShortTimeFFT(np.array([1.0, np.nan]), 1, 1.0)  # non-finite
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 0, 1.0)                      # hop < 1
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, -1.0)                     # fs <= 0
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0, mfft=8)              # mfft < len(win)
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0, fft_mode="bogus")
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0, phase_shift=16)      # out of (-mfft, mfft)
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0, fft_mode="onesided2X")  # needs scaling
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0, dual_win=np.ones(8))  # shape mismatch
    with pytest.raises(ValueError):
        ShortTimeFFT(win, 4, 1.0).scale_to("loudness")


def test_stft_istft_errors():
    ours, _ = _mk("onesided", 16, 4)
    x = _sig(100)
    with pytest.raises(ValueError):
        ours.stft(x.astype(complex))        # complex needs twosided
    with pytest.raises(ValueError):
        ours.stft(x, padding="wrap")
    with pytest.raises(ValueError):
        ours.stft(x[:4])                    # too short
    with pytest.raises(ValueError):
        ours.p_range(100, -100, 5)
    S = _np(ours.stft(x))
    with pytest.raises(ValueError):
        ours.istft(S[..., :5, :], k1=100)   # wrong f_pts
    with pytest.raises(ValueError):
        ours.istft(S, f_axis=-1, t_axis=-1)
    with pytest.raises(ValueError):
        ours.istft(S, k0=-1000, k1=100)
    with pytest.raises(ValueError):
        ours.istft(S[..., :2])              # too few slices


def test_numpy_in_numpy_out():
    for mode, sc in [("onesided", None), ("onesided2X", "magnitude"),
                     ("twosided", None), ("centered", None)]:
        ours, _ = _mk(mode, 16, 4, scale_to=sc)
        x = _sig(80)
        S = ours.stft(x)
        assert isinstance(S, np.ndarray), mode
        xr = ours.istft(S, k1=80)
        assert isinstance(xr, np.ndarray), mode
        if mode in ("onesided", "onesided2X"):
            # scipy contract: real for onesided, complex otherwise
            assert not np.iscomplexobj(xr)
        np.testing.assert_allclose(xr, x, atol=1e-9)


# ---------------------------------------------------------------------------
# jax / device path


def test_jax_input_stft_istft_roundtrip():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=53).astype(np.float32)
    xj = jnp.asarray(x)
    S = ours.stft(xj)
    want = theirs.stft(np.asarray(x, np.float64))
    assert _np(S).shape == want.shape
    np.testing.assert_allclose(_np(S), want, atol=1e-4)
    xr = ours.istft(S, k1=100)
    got = xr.re if isinstance(xr, SplitComplex) else np.asarray(xr)
    np.testing.assert_allclose(np.asarray(got), x, atol=1e-4)


def test_jax_input_onesided2X():
    ours, theirs = _mk("onesided2X", 16, 4, scale_to="psd")
    x = _sig(100, seed=59).astype(np.float32)
    S = ours.stft(jnp.asarray(x))
    want = theirs.stft(np.asarray(x, np.float64))
    np.testing.assert_allclose(_np(S), want, atol=1e-4)


def test_jax_input_centered_batch():
    ours, theirs = _mk("centered", 16, 4)
    x = _sig(2 * 90, seed=61).reshape(2, 90).astype(np.float32)
    S = ours.stft(jnp.asarray(x))
    np.testing.assert_allclose(_np(S), theirs.stft(x.astype(np.float64)),
                               atol=1e-4)


def test_jax_spectrogram_real():
    ours, theirs = _mk("onesided", 16, 4)
    x = _sig(100, seed=67).astype(np.float32)
    got = ours.spectrogram(jnp.asarray(x))
    got = np.asarray(got.re if isinstance(got, SplitComplex) else got)
    np.testing.assert_allclose(got, theirs.spectrogram(x.astype(np.float64)),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# device input at the geometries of the retired fused kernels (hop a
# multiple of 128), with a PlanConfig passed through to the transforms


def _mk_fused(fft_mode="onesided", mfft=None, phase_shift=0,
              scale_to=None, win_len=256, hop=128):
    from tpufft import PlanConfig
    win = sps.get_window("hann", win_len)
    cfg = PlanConfig()
    ours = ShortTimeFFT(win, hop, 1.0, fft_mode=fft_mode, mfft=mfft,
                        phase_shift=phase_shift, scale_to=scale_to,
                        config=cfg)
    theirs = sps.ShortTimeFFT(win, hop, 1.0, fft_mode=fft_mode, mfft=mfft,
                              phase_shift=phase_shift, scale_to=scale_to)
    return ours, theirs


@pytest.mark.parametrize("fft_mode,scale", [("onesided", None),
                                            ("onesided2X", "magnitude"),
                                            ("onesided2X", "psd")])
@pytest.mark.parametrize("phase_shift", [None, 0, 7])
def test_fused_stft_parity(fft_mode, scale, phase_shift):
    ours, theirs = _mk_fused(fft_mode, phase_shift=phase_shift,
                             scale_to=scale)
    x = _sig(2 * 1500, seed=71).reshape(2, 1500).astype(np.float32)
    xj = jnp.asarray(x)
    S = ours.stft(xj)
    assert isinstance(S, jax.Array)        # device in -> device out
    want = theirs.stft(x.astype(np.float64))
    np.testing.assert_allclose(_np(S), want, atol=3e-4)


def test_fused_stft_mfft_pad_and_detrend():
    ours, theirs = _mk_fused(mfft=320)
    x = (_sig(1400, seed=73) + np.linspace(0, 3, 1400)).astype(np.float32)
    S = ours.stft_detrend(jnp.asarray(x), "linear")
    want = theirs.stft_detrend(x.astype(np.float64), "linear")
    np.testing.assert_allclose(_np(S), want, atol=3e-4)


@pytest.mark.parametrize("fft_mode,scale", [("onesided", None),
                                            ("onesided2X", "psd")])
def test_fused_istft_roundtrip(fft_mode, scale):
    ours, theirs = _mk_fused(fft_mode, scale_to=scale, phase_shift=3)
    x = _sig(2 * 1500, seed=79).reshape(2, 1500).astype(np.float32)
    S = ours.stft(jnp.asarray(x))
    xr = ours.istft(S, k1=1500)
    got = np.asarray(xr.re if isinstance(xr, SplitComplex) else xr)
    np.testing.assert_allclose(got, x, atol=2e-3)
    want = theirs.istft(theirs.stft(x.astype(np.float64)), k1=1500)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_fused_gate_rejects_unsupported():
    from tpufft import PlanConfig
    win = sps.get_window("hann", 256)
    cfg = PlanConfig()
    # a hop off the 128 grid and a twosided mode run like any other
    for s in (ShortTimeFFT(win, 64, 1.0, config=cfg),
              ShortTimeFFT(win, 128, 1.0, fft_mode="twosided", config=cfg)):
        x = _sig(1000, seed=89)
        np.testing.assert_allclose(
            _np(s.stft(jnp.asarray(x.astype(np.float32)))), s.stft(x),
            atol=3e-4)
    # numpy and device input must agree on the same object
    s3 = ShortTimeFFT(win, 128, 1.0, config=cfg)
    S_np = s3.stft(_sig(1000, seed=83))
    S_j = s3.stft(jnp.asarray(_sig(1000, seed=83).astype(np.float32)))
    np.testing.assert_allclose(_np(S_j), S_np, atol=3e-4)


# ---------------------------------------------------------------------------
# closest_STFT_dual_window (round 5)


class TestClosestDualWindow:
    @pytest.mark.parametrize("m,hop", [(64, 16), (63, 9), (48, 12),
                                       (32, 32), (17, 5), (24, 1)])
    @pytest.mark.parametrize("scaled", [True, False])
    def test_scipy_parity(self, m, hop, scaled):
        sps = pytest.importorskip("scipy.signal")
        if not hasattr(sps, "closest_STFT_dual_window"):
            pytest.skip("scipy too old for closest_STFT_dual_window")
        w = tpufft.get_window("hann", m) + 0.01
        rng = np.random.default_rng(m * 100 + hop)
        for desired in (None, rng.standard_normal(m)):
            dm, am = tpufft.closest_STFT_dual_window(
                w, hop, desired, scaled=scaled)
            dr, ar = sps.closest_STFT_dual_window(
                w, hop, desired, scaled=scaled)
            np.testing.assert_allclose(dm, dr, atol=1e-12)
            np.testing.assert_allclose(am, ar, atol=1e-12)

    def test_complex_window(self):
        sps = pytest.importorskip("scipy.signal")
        if not hasattr(sps, "closest_STFT_dual_window"):
            pytest.skip("scipy too old for closest_STFT_dual_window")
        m, hop = 48, 12
        w = tpufft.get_window("hann", m) * np.exp(1j * np.linspace(0, 2, m))
        rng = np.random.default_rng(0)
        u = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        for scaled in (True, False):
            dm, am = tpufft.closest_STFT_dual_window(w, hop, u,
                                                     scaled=scaled)
            dr, ar = sps.closest_STFT_dual_window(w, hop, u, scaled=scaled)
            np.testing.assert_allclose(dm, dr, atol=1e-12)
            np.testing.assert_allclose(am, ar, atol=1e-12)

    def test_dual_property_and_cola(self):
        # the result is an exact dual of alpha*win: per-residue-class
        # <win, d> == 1 regardless of the desired target
        m, hop = 64, 16
        w = tpufft.get_window("hamming", m)
        d, alpha = tpufft.closest_STFT_dual_window(w, hop)
        con = np.zeros(hop)
        np.add.at(con, np.arange(m) % hop, w * d)
        np.testing.assert_allclose(con, 1.0, atol=1e-12)
        # hann at 50% overlap is COLA: its closest dual to the
        # rectangular window IS (a multiple of) the rectangular window
        w = tpufft.get_window("hann", m)
        d, alpha = tpufft.closest_STFT_dual_window(w, m // 2)
        np.testing.assert_allclose(d, d[0], atol=1e-12)

    def test_errors(self):
        w = np.zeros(32)
        w[::16] = 1.0
        with pytest.raises(ValueError):
            tpufft.closest_STFT_dual_window(w, 8)   # empty residue class
        with pytest.raises(ValueError):
            tpufft.closest_STFT_dual_window(np.ones(16), 0)
        with pytest.raises(ValueError):
            tpufft.closest_STFT_dual_window(np.ones(16), 17)
        with pytest.raises(ValueError):
            tpufft.closest_STFT_dual_window(np.ones(16), 4,
                                            np.ones(8))  # length mismatch
        with pytest.raises(ValueError):
            # desired orthogonal to the window in every class
            w = np.zeros(8); w[0] = 1.0
            u = np.zeros(8); u[1] = 1.0
            tpufft.closest_STFT_dual_window(w, 1, u, scaled=True)
