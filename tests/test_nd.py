"""ND transform tests, mirroring the reference's 2D/3D golden coverage
(fft/tests.mojo:422-1071: 2D 6x4 and 3D 6x4x8 tensors, CPU+GPU) and
extending to the 4D/5D shapes of the benchmark table."""

import numpy as np
import pytest

import tpufft
from conftest import assert_spectrum_close


def _rand_complex(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def test_fft2_reference_shape_6x4(rng):
    """Reference 2D test geometry: batch of 6x4 tensors (tests.mojo:422-458),
    with integer-valued input like the golden corpus."""
    x = rng.integers(-30, 30, size=(3, 6, 4)).astype(np.complex128)
    got = tpufft.fft2(x)
    assert_spectrum_close(got, np.fft.fft2(x), np.complex128)
    back = tpufft.ifft2(got)
    assert_spectrum_close(back, x, np.complex128)


def test_fftn_reference_shape_6x4x8(rng):
    """Reference 3D test geometry: 6x4x8 (tests.mojo:613-905)."""
    x = rng.integers(-30, 30, size=(2, 6, 4, 8)).astype(np.complex128)
    got = tpufft.fftn(x, axes=(1, 2, 3))
    assert_spectrum_close(got, np.fft.fftn(x, axes=(1, 2, 3)), np.complex128)
    back = tpufft.ifftn(got, axes=(1, 2, 3))
    assert_spectrum_close(back, x, np.complex128)


@pytest.mark.parametrize("shape,axes", [
    ((8, 12), None),
    ((4, 6, 10), (1, 2)),
    ((3, 5, 7, 4), (1, 2, 3)),          # odd/prime dims
    ((2, 4, 4, 4, 4), None),            # 5D, all axes
    ((2, 6, 8), (2, 1)),                # axis order permuted
])
def test_fftn_random(shape, axes, rng):
    x = _rand_complex(rng, shape)
    assert_spectrum_close(
        tpufft.fftn(x, axes=axes), np.fft.fftn(x, axes=axes), np.complex128
    )


def test_fftn_s_padding(rng):
    x = _rand_complex(rng, (4, 6))
    got = tpufft.fftn(x, s=(8, 4))
    assert got.shape == (8, 4)
    assert_spectrum_close(got, np.fft.fftn(x, s=(8, 4), axes=(0, 1)),
                          np.complex128)


def test_rfftn_irfftn(rng):
    x = rng.standard_normal((5, 6, 8)).astype(np.float64)
    got = tpufft.rfftn(x, axes=(1, 2))
    assert got.shape == (5, 6, 5)
    assert_spectrum_close(got, np.fft.rfftn(x, axes=(1, 2)), np.complex128)
    back = tpufft.irfftn(got, s=(6, 8), axes=(1, 2))
    assert back.shape == x.shape
    assert_spectrum_close(back, x, np.complex128)


def test_rfft2(rng):
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    got = tpufft.rfft2(x)
    assert got.shape == (2, 6, 3)
    assert_spectrum_close(
        got, np.fft.rfft2(x.astype(np.float64)), np.complex64
    )


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fftn_norms(norm, rng):
    x = _rand_complex(rng, (4, 6, 10))
    assert_spectrum_close(
        tpufft.fftn(x, norm=norm), np.fft.fftn(x, norm=norm), np.complex128
    )
    assert_spectrum_close(
        tpufft.ifftn(x, norm=norm), np.fft.ifftn(x, norm=norm), np.complex128
    )


def test_large_prime_axis_nd(rng):
    """ND with a prime-radix axis (the (batch, 93) flagship case, batched)."""
    x = _rand_complex(rng, (2, 31, 6))
    assert_spectrum_close(
        tpufft.fftn(x, axes=(1, 2)), np.fft.fftn(x, axes=(1, 2)), np.complex128
    )


def test_irfftn_odd_last_length(rng):
    """Odd last length exercises the legacy Hermitian-extend ND path."""
    x = rng.standard_normal((3, 6, 7))
    spec = np.fft.rfftn(x, axes=(1, 2))
    back = tpufft.irfftn(spec, s=(6, 7), axes=(1, 2))
    assert back.shape == (3, 6, 7)
    assert_spectrum_close(back, x, np.complex128)


def test_rfftn_with_s_padding(rng):
    x = rng.standard_normal((2, 6, 6))
    got = tpufft.rfftn(x, s=(8, 10), axes=(1, 2))
    assert got.shape == (2, 8, 6)
    assert_spectrum_close(got, np.fft.rfftn(x, s=(8, 10), axes=(1, 2)),
                          np.complex128)


def test_irfftn_with_s_crop(rng):
    x = rng.standard_normal((2, 8, 12))
    spec = np.fft.rfftn(x, axes=(1, 2))
    got = tpufft.irfftn(spec, s=(6, 8), axes=(1, 2))
    assert got.shape == (2, 6, 8)
    assert_spectrum_close(got, np.fft.irfftn(spec, s=(6, 8), axes=(1, 2)),
                          np.complex128)


def test_hfft_split_input(rng):
    import jax.numpy as jnp
    from tpufft import SplitComplex
    spec = (rng.standard_normal(9) + 1j * rng.standard_normal(9)).astype(
        np.complex64)
    sc = SplitComplex(jnp.asarray(spec.real.copy()),
                      jnp.asarray(spec.imag.copy()))
    got = tpufft.hfft(sc)
    assert hasattr(got, "re")  # SplitComplex in -> SplitComplex out
    assert_spectrum_close(got.numpy(), np.fft.hfft(spec), np.complex64)


def test_ifft_real_input(rng):
    x = rng.standard_normal((3, 12))
    assert_spectrum_close(tpufft.ifft(x), np.fft.ifft(x), np.complex128)


class TestMidPair:
    """Middle axes (ndim-3, ndim-2) with the minor dim untransformed (the
    channels-last spectral-conv layout)."""

    def test_matches_oracle_and_dispatches(self, rng):
        cfg = tpufft.PlanConfig()
        x = (rng.standard_normal((2, 24, 16, 128))
             + 1j * rng.standard_normal((2, 24, 16, 128))
             ).astype(np.complex64)
        got = np.asarray(tpufft.fftn(x, axes=(1, 2), config=cfg))
        ref = np.fft.fftn(x, axes=(1, 2))
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(got - ref)) / scale < 1e-3

    def test_norms_and_inverse(self, rng):
        cfg = tpufft.PlanConfig()
        x = (rng.standard_normal((3, 40, 64, 256))
             + 1j * rng.standard_normal((3, 40, 64, 256))
             ).astype(np.complex64)
        for norm in (None, "ortho", "forward"):
            got = np.asarray(tpufft.ifftn(x, axes=(1, 2), norm=norm,
                                          config=cfg))
            ref = np.fft.ifftn(x, axes=(1, 2), norm=norm)
            scale = max(1.0, np.max(np.abs(ref)))
            assert np.max(np.abs(got - ref)) / scale < 1e-3, norm

    def test_misaligned_minor_stays_per_axis(self, rng, caplog):
        """A non-128-multiple minor dim must NOT take the fused view (the
        flatten would physically repack the padded layout)."""
        import logging
        cfg = tpufft.PlanConfig()
        x = (rng.standard_normal((2, 24, 16, 48))
             + 1j * rng.standard_normal((2, 24, 16, 48))
             ).astype(np.complex64)
        with caplog.at_level(logging.DEBUG, logger="tpufft"):
            got = np.asarray(tpufft.fftn(x, axes=(1, 2), config=cfg))
        assert not any("mid-pair" in r.message for r in caplog.records)
        ref = np.fft.fftn(x, axes=(1, 2))
        scale = max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(got - ref)) / scale < 1e-3

    def test_grad(self, rng):
        import jax
        import jax.numpy as jnp
        cfg = tpufft.PlanConfig()
        plan = tpufft.plan_fft((1, 8, 16, 128), jnp.complex64, axes=(1, 2),
                               config=cfg)
        xr = jnp.asarray(rng.standard_normal((1, 8, 16, 128)), jnp.float32)
        xi = jnp.zeros_like(xr)

        def loss(re):
            out = plan(tpufft.SplitComplex(re, xi))
            return jnp.sum(out.re ** 2 + out.im ** 2)

        g = jax.grad(loss)(xr)
        assert np.all(np.isfinite(np.asarray(g)))
        # Parseval: d/dx sum|FFT x|^2 = 2 N x for unnormalized forward
        n_tot = 8 * 16
        ref = 2.0 * n_tot * np.asarray(xr)
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(np.asarray(g) - ref)) / scale < 1e-3


def test_mid_pair_real_input(rng):
    """Real-input ND FFTs hitting the mid-pair fusion must embed the
    missing imaginary plane (it used to crash on ai=None)."""
    cfg = tpufft.PlanConfig()
    x = rng.standard_normal((16, 16, 256)).astype(np.float32)
    got = np.asarray(tpufft.fftn(x, axes=(0, 1), config=cfg))
    ref = np.fft.fftn(x, axes=(0, 1))
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(got - ref)) / scale < 1e-3
