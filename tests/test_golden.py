"""Reference-parity golden tests.

Mirrors the reference test strategy (fft/tests.mojo): golden integer series
per length, run under every interesting radix decomposition (the reference's
key correctness lever — same answer regardless of factorization, tests.mojo
:274-371), forward and inverse, across dtypes. Expected spectra come from a
float64 numpy DFT oracle.
"""

import numpy as np
import pytest

import tpufft
from tpufft.planner import default_bases

from conftest import assert_spectrum_close
from golden_data import GOLDEN_SERIES

# The same corpus runs through both input forms of the public API: an
# ordinary complex array, and SplitComplex planes (the form jitted and
# sharded pipelines pass along).
PATHS = [("default", "array"), ("split-planes", "split")]


def _call(fn, x, form, **kw):
    """fn(x) with x as an array or as SplitComplex planes; numpy out."""
    if form == "split":
        out = fn(tpufft.SplitComplex.from_array(x), **kw)
        assert isinstance(out, tpufft.SplitComplex)
        return out.numpy()
    return np.asarray(fn(x, **kw))

# Decomposition sweep, after the reference's per-length base lists
# (fft/tests.mojo:274-371): every length is tested under multiple orderings.
DECOMPOSITIONS = {
    4: [(4,), (2, 2)],
    6: [(6,), (3, 2), (2, 3)],
    8: [(8,), (4, 2), (2, 4), (2, 2, 2)],
    10: [(10,), (5, 2), (2, 5)],
    16: [(16,), (8, 2), (4, 4), (4, 2, 2), (2, 2, 2, 2)],
    20: [(20,), (10, 2), (5, 4), (4, 5), (5, 2, 2)],
    21: [(21,), (7, 3), (3, 7)],
    30: [(30,), (15, 2), (10, 3), (6, 5), (5, 3, 2), (2, 3, 5)],
    32: [(32,), (16, 2), (8, 4), (4, 8), (8, 2, 2), (4, 4, 2), (2, 2, 2, 2, 2)],
    35: [(35,), (7, 5), (5, 7)],
    48: [(48,), (16, 3), (12, 4), (8, 6), (6, 8), (4, 4, 3), (3, 4, 4)],
    60: [(60,), (10, 6), (6, 5, 2), (5, 4, 3), (3, 4, 5), (5, 3, 2, 2)],
    64: [(64,), (16, 4), (8, 8), (4, 4, 4), (16, 2, 2), (2, 4, 8)],
    100: [(100,), (10, 10), (25, 4), (5, 5, 4), (4, 5, 5), (2, 50)],
    128: [(16, 8), (8, 16), (16, 4, 2), (8, 8, 2), (8, 4, 4), (4, 4, 4, 2),
          (2, 8, 8), (4, 2, 16), (2, 2, 2, 2, 2, 2, 2), (32, 4), (64, 2)],
}


def _series(n):
    return [np.asarray(s, np.float64) for s in GOLDEN_SERIES[n]]


@pytest.mark.parametrize("path,form", PATHS, ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("n", sorted(GOLDEN_SERIES))
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fft_1d_golden(n, dtype, path, form):
    """Forward FFT of every golden series matches the float64 DFT oracle."""
    for series in _series(n):
        expected = np.fft.fft(series)
        got = _call(tpufft.fft, series.astype(dtype), form)
        assert got.dtype == np.dtype(dtype)
        assert_spectrum_close(got, expected, dtype)


@pytest.mark.parametrize("path,form", PATHS, ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("n", sorted(GOLDEN_SERIES))
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_ifft_1d_golden(n, dtype, path, form):
    """Inverse of the golden spectrum recovers the original real series
    (reference: _eval inverse branch, fft/tests.mojo:129-138)."""
    for series in _series(n):
        spectrum = np.fft.fft(series).astype(dtype)
        got = _call(tpufft.ifft, spectrum, form)
        assert_spectrum_close(got, series.astype(np.complex128), dtype)


@pytest.mark.parametrize("path,form", PATHS, ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("n", sorted(DECOMPOSITIONS))
def test_fft_decomposition_sweep(n, path, form):
    """Same spectrum out of every radix factorization of the same length."""
    for series in _series(n):
        expected = np.fft.fft(series)
        for bases in DECOMPOSITIONS[n]:
            for dtype in (np.complex128, np.complex64):
                got = _call(tpufft.fft, series.astype(dtype), form,
                            bases=[bases])
                assert_spectrum_close(got, expected, dtype)


@pytest.mark.parametrize("n", [2, 3, 7, 31, 93, 97, 101, 127])
def test_prime_lengths(n, rng):
    """Any prime length runs as a dense-DFT stage (no Bluestein, like ref)."""
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    assert_spectrum_close(
        tpufft.fft(x.astype(np.complex128)), np.fft.fft(x), np.complex128
    )


@pytest.mark.parametrize("n", [93, 186, 35 * 31])
def test_prime_radix_composites(n, rng):
    """Shapes like 93 = 3 x 31 exercise the generic mixed-radix planner."""
    bases = default_bases(n)
    assert np.prod(bases) == n
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    assert_spectrum_close(
        tpufft.fft(x.astype(np.complex128)), np.fft.fft(x), np.complex128
    )


def test_real_input_full_spectrum():
    """fft() on real input emits the full-length spectrum — the reference's
    'rfft' semantics (do_rfft reads real, output is full complex,
    fft/fft/_fft.mojo:115-118)."""
    series = np.asarray(GOLDEN_SERIES[8][3], np.float32)
    got = tpufft.fft(series)
    assert got.shape == (8,)
    assert got.dtype == np.complex64
    assert_spectrum_close(got, np.fft.fft(series.astype(np.float64)),
                          np.complex64)
