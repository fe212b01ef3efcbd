"""Seeded random-configuration fuzz: arbitrary shapes/axes/kinds/norms
against the numpy oracle, through the public API (c64 and c128)."""

import numpy as np
import pytest

import tpufft
from tpufft import PlanConfig
from conftest import assert_spectrum_close

DTYPES = {
    "c64": (np.complex64, np.float32),
    "c128": (np.complex128, np.float64),
}


def _random_case(rng):
    ndim = int(rng.integers(1, 5))
    shape = tuple(int(rng.integers(2, 13)) for _ in range(ndim))
    n_axes = int(rng.integers(1, ndim + 1))
    axes = tuple(sorted(rng.choice(ndim, size=n_axes, replace=False).tolist()))
    norm = rng.choice([None, "ortho", "forward", "backward"])
    kind = rng.choice(["c2c", "c2c", "r2c", "c2r"])
    return shape, axes, None if norm is None else str(norm), str(kind)


@pytest.mark.parametrize("backend", sorted(DTYPES))
@pytest.mark.parametrize("case", range(25))
def test_fuzz_against_numpy(case, backend, rng):
    crng = np.random.default_rng(9000 + case)
    shape, axes, norm, kind = _random_case(crng)
    cdt, rdt = DTYPES[backend]
    if kind == "c2c":
        x = (crng.standard_normal(shape)
             + 1j * crng.standard_normal(shape)).astype(cdt)
        got = tpufft.fftn(x, axes=axes, norm=norm)
        ref = np.fft.fftn(x, axes=axes, norm=norm)
    elif kind == "r2c":
        x = crng.standard_normal(shape).astype(rdt)
        got = tpufft.rfftn(x, axes=axes, norm=norm)
        ref = np.fft.rfftn(x.astype(np.float64), axes=axes, norm=norm)
    else:  # c2r: build a packed spectrum of a real signal
        real = crng.standard_normal(shape)
        spec = np.fft.rfftn(real, axes=axes)
        s = tuple(shape[a] for a in axes)
        got = tpufft.irfftn(spec.astype(cdt), s=s, axes=axes, norm=norm)
        ref = np.fft.irfftn(spec, s=s, axes=axes, norm=norm)
    assert np.asarray(got).shape == ref.shape, (shape, axes, kind)
    assert_spectrum_close(got, ref, cdt)


@pytest.mark.parametrize("case", range(15))
def test_fuzz_split_roundtrip(case, rng):
    """SplitComplex I/O: plan reuse + fwd/inv roundtrip on random configs."""
    import jax.numpy as jnp
    import tpufft as tp
    from tpufft import SplitComplex

    crng = np.random.default_rng(7000 + case)
    shape, axes, norm, _ = _random_case(crng)
    cfg = PlanConfig()
    x = (crng.standard_normal(shape)
         + 1j * crng.standard_normal(shape)).astype(np.complex64)
    sc = SplitComplex(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))
    fwd = tp.plan_fft(shape, jnp.complex64, axes=axes, norm=norm, config=cfg)
    inv = tp.plan_fft(shape, jnp.complex64, axes=axes, norm=norm,
                      inverse=True, config=cfg)
    spec = fwd(sc)
    assert isinstance(spec, SplitComplex)
    # norms: fwd(norm) o inv(norm) == identity for backward/ortho/forward
    back = inv(spec)
    assert_spectrum_close(back.numpy(), x, np.complex64)
    # plan reuse with fresh data
    y = (crng.standard_normal(shape)
         + 1j * crng.standard_normal(shape)).astype(np.complex64)
    sy = SplitComplex(jnp.asarray(y.real.copy()), jnp.asarray(y.imag.copy()))
    assert_spectrum_close(fwd(sy).numpy(),
                          np.fft.fftn(y, axes=axes, norm=norm), np.complex64)


# Dispatch-diverse length pool: every fuzz case lands on a prime stage, a
# smooth Stockham, or the Bluestein route rather than only tiny lengths.
_LENGTH_POOL = [
    93,      # small prime-composite (dense 31-point stage)
    131,     # prime, one dense stage
    262,     # 2*131
    384,     # smooth
    48, 64,  # short smooth axes
    4111,    # prime above execute.BLUESTEIN_MIN_PRIME (Bluestein)
]


@pytest.mark.parametrize("case", range(12))
def test_fuzz_dispatch_paths(case, rng):
    """Random shapes drawn from dispatch-critical lengths against the
    numpy oracle."""
    crng = np.random.default_rng(4000 + case)
    ndim = int(crng.integers(2, 4))
    shape = tuple(int(crng.choice(_LENGTH_POOL)) for _ in range(ndim))
    # keep the array small
    while np.prod(shape) > 2_000_000:
        shape = shape[1:]
    axes = tuple(range(1, len(shape))) if len(shape) > 1 else (0,)
    x = (crng.standard_normal(shape)
         + 1j * crng.standard_normal(shape)).astype(np.complex64)
    got = tpufft.fftn(x, axes=axes)
    ref = np.fft.fftn(x, axes=axes)
    assert_spectrum_close(got, ref, np.complex64)


@pytest.mark.parametrize("case", range(8))
def test_fuzz_bf16_roundtrip(case, rng):
    """bf16-plane storage: random shapes, fwd o inv ~ identity within the
    storage-rounding budget."""
    import jax.numpy as jnp
    from tpufft import SplitComplex

    crng = np.random.default_rng(5000 + case)
    cfg = PlanConfig(plane_dtype="bfloat16")
    shape, axes, norm, _ = _random_case(crng)
    x = (crng.standard_normal(shape)
         + 1j * crng.standard_normal(shape)).astype(np.complex64)
    sc = SplitComplex(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))
    fwd = tpufft.plan_fft(shape, jnp.complex64, axes=axes, norm=norm,
                          config=cfg)
    inv = tpufft.plan_fft(shape, jnp.complex64, axes=axes, norm=norm,
                          inverse=True, config=cfg)
    back = inv(fwd(sc)).numpy()
    scale = max(1.0, float(np.max(np.abs(x))))
    assert np.max(np.abs(back - x)) / scale < 3e-2
