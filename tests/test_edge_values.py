"""Numerical edge-value behavior through the transform paths.

The reference's tests only use well-scaled integer series; production
pipelines see zeros, huge magnitudes, denormals, and non-finite values.
These pin the library's behavior: linear scaling (no internal overflow for
representable inputs), exact-zero propagation, and NaN/Inf propagating
rather than corrupting neighbors (each batch row is independent).
"""

import numpy as np
import pytest

import tpufft
from tpufft import PlanConfig
from conftest import assert_spectrum_close

CFG = PlanConfig()


def test_zero_input_is_zero_output():
    x = np.zeros((4, 256), np.complex64)
    got = np.asarray(tpufft.fft(x, config=CFG))
    assert got.shape == x.shape
    assert np.all(got == 0)


@pytest.mark.parametrize("mag", [1e-20, 1e18])
def test_extreme_magnitudes_scale_linearly(mag, rng):
    """F(c*x) == c*F(x): tiny/huge inputs transform without internal
    over/underflow beyond dtype limits (the bf16x3 split handles the
    exponent range; only the mantissa is split)."""
    x = (rng.standard_normal((4, 128))
         + 1j * rng.standard_normal((4, 128))).astype(np.complex64)
    big = (x * mag).astype(np.complex64)
    got = np.asarray(tpufft.fft(big, config=CFG)) / mag
    assert_spectrum_close(got, np.fft.fft(x), np.complex64)


def test_nan_propagates_within_row_only(rng):
    """A NaN in one batch row poisons that row's spectrum, not others
    (rows are independent transforms — the analog of the reference's
    NaN-prefill discipline, fft/tests.mojo:175)."""
    x = (rng.standard_normal((4, 128))
         + 1j * rng.standard_normal((4, 128))).astype(np.complex64)
    x[1, 7] = np.nan
    got = np.asarray(tpufft.fft(x, config=CFG))
    assert np.isnan(got[1]).any()
    for r in (0, 2, 3):
        assert np.isfinite(got[r]).all()
        assert_spectrum_close(got[r], np.fft.fft(x[r]), np.complex64)


def test_inf_propagates_within_row_only(rng):
    x = (rng.standard_normal((3, 64))
         + 1j * rng.standard_normal((3, 64))).astype(np.complex64)
    x[0, 0] = np.inf
    got = np.asarray(tpufft.fft(x, config=CFG))
    assert not np.isfinite(got[0]).all()
    assert np.isfinite(got[1:]).all()


def test_single_element_transforms():
    """n=1 transforms are the identity (with norm scaling)."""
    x = np.array([[3.0 + 4.0j]], np.complex64)
    got = np.asarray(tpufft.fft(x))
    np.testing.assert_allclose(got, x, rtol=1e-6)
    got = np.asarray(tpufft.ifft(x, norm="ortho"))
    np.testing.assert_allclose(got, x, rtol=1e-6)
