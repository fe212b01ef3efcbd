"""Bluestein (chirp-z) route: any-length transforms over the jnp Stockham.

An axis whose largest prime factor exceeds execute.BLUESTEIN_MIN_PRIME
runs as a circular convolution at a 7-smooth length m >= 2n - 1 instead
of one dense p-point Stockham stage. The reference's planner stops at
prime 97 (fft/fft/fft.mojo:83-104); this keeps such lengths O(m log m).

Tests marked with the ``forced`` fixture lower the threshold so short
primes take the route too (cheap coverage of the same code); the rest run
the default dispatch at lengths above the measured crossover.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpufft
from tpufft import PlanConfig, SplitComplex, execute
from tpufft.execute import bluestein_ok
from conftest import assert_spectrum_close

CFG = PlanConfig()


@pytest.fixture
def forced(monkeypatch):
    """Route every prime factor > 100 through Bluestein (plans traced
    under another threshold must not be reused, hence the cache clears)."""
    tpufft.api._cached_plan.cache_clear()
    monkeypatch.setattr(execute, "BLUESTEIN_MIN_PRIME", 100)
    yield
    tpufft.api._cached_plan.cache_clear()


def _x(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("n", [131, 257, 262, 1031])
def test_prime_lengths_forward(n, rng, forced):
    """Prime (or prime-heavy) lengths through Bluestein match NumPy."""
    assert bluestein_ok(n)
    x = _x(rng, (4, n))
    got = np.asarray(tpufft.fft(x, config=CFG))
    assert_spectrum_close(got, np.fft.fft(x), np.complex64)


def test_auto_mode_threshold():
    """The default keeps primes up to the measured crossover (4099) on the
    dense-stage path and routes bigger prime factors through Bluestein."""
    assert execute.BLUESTEIN_MIN_PRIME == 4099
    assert not bluestein_ok(131)
    assert not bluestein_ok(1021)
    assert not bluestein_ok(4099)
    assert not bluestein_ok(4)
    assert bluestein_ok(4111)
    assert bluestein_ok(2 * 4111)
    assert bluestein_ok(65537)


def test_prime_length_inverse_norm(rng, forced):
    x = _x(rng, (3, 131))
    got = np.asarray(tpufft.ifft(x, norm="ortho", config=CFG))
    assert_spectrum_close(got, np.fft.ifft(x, norm="ortho"), np.complex64)


def test_prime_length_non_minor_axis(rng, forced):
    x = _x(rng, (2, 131, 16))
    got = np.asarray(tpufft.fftn(x, axes=(1,), config=CFG))
    assert_spectrum_close(got, np.fft.fft(x, axis=1), np.complex64)


def test_prime_roundtrip(rng, forced):
    x = _x(rng, (2, 257))
    y = np.asarray(tpufft.ifft(tpufft.fft(x, config=CFG), config=CFG))
    assert_spectrum_close(y, x, np.complex64)


def test_prime_backend_pallas_no_error(rng):
    """A prime above the crossover runs with the default config: no
    backend option is needed (or accepted) to reach Bluestein."""
    x = _x(rng, (2, 4111))
    got = np.asarray(tpufft.fft(x))
    assert_spectrum_close(got, np.fft.fft(x), np.complex64)
    with pytest.raises(TypeError, match="no longer takes backend"):
        PlanConfig(backend="pallas")


def test_grad_through_bluestein(rng, forced):
    re = jnp.asarray(rng.standard_normal((2, 131)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((2, 131)), jnp.float32)
    plan = tpufft.plan_fft((2, 131), jnp.complex64, axes=(-1,), config=CFG)

    def loss(re, im):
        out = plan(SplitComplex(re, im))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)

    def loss_ref(re, im):
        z = jnp.fft.fft(re + 1j * im, axis=-1)
        return jnp.sum(z.real ** 2) + 2.0 * jnp.sum(z.imag ** 2)

    g = jax.grad(loss, argnums=(0, 1))(re, im)
    g_ref = jax.grad(loss_ref, argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-3)


def test_kronecker_cofactor_falls_back(rng, forced):
    """1859 = 11 * 13^2: a composite whose factors stay below the forced
    threshold runs the plain Stockham, not Bluestein."""
    assert not bluestein_ok(1859)
    x = _x(rng, (2, 3, 1859))
    got = np.asarray(tpufft.fft(x, config=CFG))
    assert_spectrum_close(got, np.fft.fft(x), np.complex64)


def test_bluestein_preserves_bf16_planes(rng, forced):
    """bf16-plane contract holds through Bluestein: bf16 in -> bf16 out."""
    cfg = PlanConfig(plane_dtype="bfloat16")
    x = _x(rng, (2, 131))
    sc = SplitComplex(jnp.asarray(x.real, jnp.bfloat16),
                      jnp.asarray(x.imag, jnp.bfloat16))
    plan = tpufft.plan_fft((2, 131), np.complex64, axes=(-1,), config=cfg)
    out = plan(sc)
    assert out.re.dtype == jnp.bfloat16
    assert out.im.dtype == jnp.bfloat16
    ref = np.fft.fft(x)
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert np.max(np.abs(out.numpy() - ref)) / scale < 3e-2


def test_chirp_tables_follow_plane_dtype():
    """The chirps are float64 on the host and cast to the plane dtype at
    the use site, so c128 plans keep f64 chirps (they used to be f32)."""
    tables = execute._bluestein_tables(4111, 8232, False, 1.0)
    assert all(t.dtype == np.float64 for t in tables)
    jaxpr = jax.make_jaxpr(lambda a, b: execute.fft_axis(
        a, b, 1, (4111,), inverse=False, scale=1.0))(
        jnp.zeros((1, 4111), jnp.float64), jnp.zeros((1, 4111), jnp.float64))
    assert "f32" not in str(jaxpr)


# ---------------------------------------------------------------------------
# Default dispatch above the crossover: fft / ifft / rfft / irfft x c64 /
# c128. Tolerances are the suite's contract (1e-3 c64, 1e-6 c128).

_LONG = [4111, 8191, 2 * 4111, 3 * 4111, 65537]
_KINDS = ["fft", "ifft", "rfft", "irfft"]
_DTYPES = [np.complex64, np.complex128]


@pytest.mark.parametrize("dtype", _DTYPES, ids=["c64", "c128"])
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n", _LONG)
def test_default_route_matches_numpy(n, kind, dtype, rng):
    assert bluestein_ok(n if kind != "irfft" else n)
    rdt = np.float32 if dtype == np.complex64 else np.float64
    if kind in ("fft", "ifft"):
        x = _x(rng, (2, n), dtype)
        got = getattr(tpufft, kind)(x)
        ref = getattr(np.fft, kind)(x.astype(np.complex128))
    elif kind == "rfft":
        x = rng.standard_normal((2, n)).astype(rdt)
        got = tpufft.rfft(x)
        ref = np.fft.rfft(x.astype(np.float64))
    else:
        spec = np.fft.rfft(rng.standard_normal((2, n)))
        got = tpufft.irfft(spec.astype(dtype), n=n)
        ref = np.fft.irfft(spec, n=n)
    assert np.asarray(got).shape == ref.shape
    assert_spectrum_close(got, ref, dtype)


# ---------------------------------------------------------------------------
# The same route at short lengths (forced threshold): lengths x transforms
# x dtypes x norms.

_SHORT = [131, 257, 262, 3 * 137, 1031]


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("dtype", _DTYPES, ids=["c64", "c128"])
@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft"])
@pytest.mark.parametrize("n", _SHORT)
def test_forced_route_matches_numpy(n, kind, dtype, norm, rng, forced):
    assert bluestein_ok(n)
    rdt = np.float32 if dtype == np.complex64 else np.float64
    if kind == "rfft":
        x = rng.standard_normal((3, n)).astype(rdt)
    else:
        x = _x(rng, (3, n), dtype)
    got = getattr(tpufft, kind)(x, norm=norm)
    ref = getattr(np.fft, kind)(x.astype(np.complex128 if kind != "rfft"
                                         else np.float64), norm=norm)
    assert_spectrum_close(got, ref, dtype)
