"""SplitComplex (plane pair) API path.

The transforms compute on a pair of float planes; these tests exercise
that input/output form end-to-end (it must agree with the combined-complex
path bit-for-bit in float32).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpufft
from tpufft import SplitComplex
from conftest import assert_spectrum_close


def _split(x):
    return SplitComplex(
        jnp.asarray(np.ascontiguousarray(x.real)),
        jnp.asarray(np.ascontiguousarray(x.imag)),
    )


def test_split_fft_matches_numpy(rng):
    x = (rng.standard_normal((4, 96)) + 1j * rng.standard_normal((4, 96)))
    out = tpufft.fft(_split(x))
    assert isinstance(out, SplitComplex)
    assert_spectrum_close(out.numpy(), np.fft.fft(x), np.complex128)


def test_split_roundtrip(rng):
    x = (rng.standard_normal((2, 60)) + 1j * rng.standard_normal((2, 60)))
    back = tpufft.ifft(tpufft.fft(_split(x)))
    assert_spectrum_close(back.numpy(), x, np.complex128)


def test_split_fftn(rng):
    x = (rng.standard_normal((2, 6, 8)) + 1j * rng.standard_normal((2, 6, 8)))
    out = tpufft.fftn(_split(x), axes=(1, 2))
    assert_spectrum_close(out.numpy(), np.fft.fftn(x, axes=(1, 2)), np.complex128)


def test_split_irfft_returns_planes(rng):
    x = rng.standard_normal((3, 16))
    spec = np.fft.rfft(x)
    out = tpufft.irfft(_split(spec), n=16)
    assert isinstance(out, SplitComplex)
    np.testing.assert_allclose(out.numpy().real, x, atol=1e-6)
    np.testing.assert_allclose(out.numpy().imag, 0, atol=1e-12)


def test_split_is_jittable(rng):
    """SplitComplex flows through jax.jit as a pytree."""
    x = (rng.standard_normal((2, 32)) + 1j * rng.standard_normal((2, 32)))
    plan = tpufft.plan_fft((2, 32), axes=(-1,))

    @jax.jit
    def step(sc):
        out = plan(sc)
        return SplitComplex(out.re * 2.0, out.im * 2.0)

    out = step(_split(x.astype(np.complex64)))
    assert_spectrum_close(out.numpy(), 2.0 * np.fft.fft(x), np.complex64)


def test_split_conj_shift():
    x = np.arange(8.0) + 1j * np.arange(8.0)[::-1].copy()
    sc = _split(x)
    np.testing.assert_allclose(sc.conj().numpy(), np.conj(x))
    np.testing.assert_allclose(
        tpufft.fftshift(sc).numpy(), np.fft.fftshift(x)
    )


def test_rfft_rejects_split_input(rng):
    sc = _split(rng.standard_normal((2, 8)) + 0j)
    with pytest.raises(TypeError):
        tpufft.rfft(sc)


def test_real_input_fast_path_matches(rng):
    """Real input (im plane elided) gives the same full spectrum."""
    x = rng.standard_normal((3, 48))
    got = tpufft.fft(x)
    assert_spectrum_close(got, np.fft.fft(x), np.complex128)


def test_device_input_stays_on_device(rng, monkeypatch):
    """jax.Array (device) input never round-trips the host: the plan
    combines the planes on the device into a complex jax.Array, and
    SplitComplex input gets SplitComplex planes back."""
    import jax
    import jax.numpy as jnp
    from tpufft import SplitComplex

    x = rng.standard_normal((4, 64)).astype(np.float32)
    ref = np.fft.rfft(x)
    out = tpufft.rfft(jnp.asarray(x))
    assert isinstance(out, jax.Array) and out.dtype == jnp.complex64
    assert_spectrum_close(np.asarray(out), ref, np.complex64)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    sc = tpufft.fft(SplitComplex(jnp.asarray(z.real), jnp.asarray(z.imag)))
    assert isinstance(sc, SplitComplex)
    assert_spectrum_close(sc.numpy(), np.fft.fft(z), np.complex64)


def test_splitcomplex_numpy_conversion_protocol(rng):
    """np.asarray(SplitComplex) must be the COMPLEX array — NamedTuple
    sequence semantics would silently give the stacked (2, ...) float
    planes instead (regression: a fuzz comparison read garbage)."""
    import jax.numpy as jnp
    from tpufft import SplitComplex

    x = (rng.standard_normal((5, 12))
         + 1j * rng.standard_normal((5, 12))).astype(np.complex64)
    sc = SplitComplex(jnp.asarray(x.real), jnp.asarray(x.imag))
    arr = np.asarray(sc)
    assert arr.shape == (5, 12) and arr.dtype == np.complex64
    np.testing.assert_array_equal(arr, sc.numpy())
    # dtype coercion path
    arr128 = np.asarray(sc, dtype=np.complex128)
    assert arr128.dtype == np.complex128
