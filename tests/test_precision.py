"""Every device matmul states its precision.

On a GPU a float32 dot_general with no precision may run in TF32 (~1e-3
relative), which breaks the 1e-3 c64 contract once errors compound. Each
public entry point is run on device (jax) input while every dot_general
bind is recorded: each must carry an explicit precision, HIGHEST for
floating-point operands. A library must not change its caller's matmuls,
so nothing here relies on a process-wide default.
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp

import tpufft
from tpufft import SplitComplex

HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture
def dots(monkeypatch):
    """Record (precision, operand dtypes) of every dot_general traced while
    the test runs. Caches are cleared so cached executables retrace."""
    seen = []
    orig = jax.lax.dot_general_p.bind

    def bind(*args, **params):
        seen.append((params.get("precision"),
                     tuple(str(getattr(a, "dtype", "?")) for a in args)))
        return orig(*args, **params)

    jax.clear_caches()
    tpufft.api._cached_plan.cache_clear()
    monkeypatch.setattr(jax.lax.dot_general_p, "bind", bind)
    yield seen
    jax.clear_caches()
    tpufft.api._cached_plan.cache_clear()


def _c(shape, seed=0):
    r = np.random.default_rng(seed)
    return jnp.asarray((r.standard_normal(shape)
                        + 1j * r.standard_normal(shape)).astype(np.complex64))


def _r(shape, seed=1):
    r = np.random.default_rng(seed)
    return jnp.asarray(r.standard_normal(shape).astype(np.float32))


def _filter_dense():
    return tpufft.plan_filter(64, response=np.exp(
        1j * np.linspace(0, 3, 64)))(_c((4, 64)))


def _filter_real():
    return tpufft.plan_filter(64, impulse=np.hanning(64))(_r((4, 64)))


def _filter_composed():
    return tpufft.plan_filter(2048, response=np.exp(
        1j * np.linspace(0, 3, 2048)))(_c((2, 2048)))


def _stft_roundtrip():
    _, _, Z = tpufft.stft(_r((2, 1024)), nperseg=128)
    return tpufft.istft(Z, nperseg=128)[1]


def _short_time():
    s = tpufft.ShortTimeFFT(sps.get_window("hann", 64), 16, 1.0)
    S = s.stft(_r((2, 512)))
    return s.istft(S, k1=512)


_SOS = sps.butter(4, 0.2, output="sos")
_BA = sps.butter(3, 0.3)

ENTRY_POINTS = {
    "fft": lambda: tpufft.fft(_c((4, 96))),
    "ifft": lambda: tpufft.ifft(_c((4, 96))),
    "fft_bluestein": lambda: tpufft.fft(_c((2, 4111))),
    "rfft": lambda: tpufft.rfft(_r((4, 96))),
    "irfft": lambda: tpufft.irfft(_c((4, 49)), n=96),
    "fftn": lambda: tpufft.fftn(_c((2, 12, 20))),
    "ifftn": lambda: tpufft.ifftn(_c((2, 12, 20))),
    "rfftn": lambda: tpufft.rfftn(_r((2, 12, 20))),
    "irfftn": lambda: tpufft.irfftn(_c((2, 12, 11))),
    "fft2": lambda: tpufft.fft2(_c((3, 16, 24))),
    "hfft": lambda: tpufft.hfft(_c((4, 17))),
    "ihfft": lambda: tpufft.ihfft(_r((4, 32))),
    "plan_fft_split": lambda: tpufft.plan_fft((4, 96), jnp.complex64)(
        SplitComplex(_r((4, 96)), _r((4, 96), 2))),
    "plan_fft_bf16": lambda: tpufft.plan_fft(
        (4, 96), jnp.complex64,
        config=tpufft.PlanConfig(plane_dtype="bfloat16"))(_c((4, 96))),
    "dct": lambda: tpufft.dct(_r((4, 40))),
    "idct": lambda: tpufft.idct(_r((4, 40)), type=3),
    "dst": lambda: tpufft.dst(_r((4, 40)), type=4),
    "dctn": lambda: tpufft.dctn(_r((6, 10))),
    "plan_filter_dense": _filter_dense,
    "plan_filter_real": _filter_real,
    "plan_filter_composed": _filter_composed,
    "hilbert": lambda: tpufft.hilbert(_r((3, 100))),
    "fftconvolve": lambda: tpufft.fftconvolve(_r((3, 100)), _r((3, 9))),
    "oaconvolve": lambda: tpufft.oaconvolve(_r((400,)), _r((9,))),
    "resample": lambda: tpufft.resample(_r((3, 100)), 150, axis=-1),
    "stft_istft": _stft_roundtrip,
    "welch": lambda: tpufft.welch(_r((2, 2048)), nperseg=256)[1],
    "csd": lambda: tpufft.csd(_r((2, 2048)), _r((2, 2048), 3),
                              nperseg=256)[1],
    "ShortTimeFFT": _short_time,
    "czt": lambda: tpufft.czt(_r((3, 60)), 40),
    "zoom_fft": lambda: tpufft.zoom_fft(_r((3, 64)), [0.1, 0.4], 32),
    "fht": lambda: tpufft.fht(_r((2, 64)), 0.05, 0.5),
    # with a zi state the IIR runs the companion-matrix scan (matmuls)
    "lfilter": lambda: tpufft.lfilter(_BA[0], _BA[1], _r((2, 300)),
                                      zi=_r((2, 3), 5)),
    "detrend": lambda: tpufft.detrend(_r((2, 200)), bp=[50, 120]),
    "lombscargle": lambda: tpufft.lombscargle(
        jnp.sort(_r((100,))) + 5.0, _r((100,), 4),
        jnp.linspace(0.1, 3.0, 30, dtype=jnp.float32)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_dot_general_states_precision(name, dots):
    out = ENTRY_POINTS[name]()
    for leaf in jax.tree_util.tree_leaves(out):
        if isinstance(leaf, jax.Array):
            leaf.block_until_ready()
    assert dots, f"{name}: no dot_general traced — the check saw nothing"
    for precision, dtypes in dots:
        assert precision is not None, f"{name}: dot {dtypes} has none"
        if any("float" in d for d in dtypes):
            assert tuple(precision) == (HIGHEST, HIGHEST), (
                f"{name}: float dot {dtypes} at {precision}")


def test_no_process_wide_default_is_set():
    """Importing and running the library leaves JAX's default matmul
    precision alone."""
    before = jax.config.jax_default_matmul_precision
    tpufft.fft(_c((2, 64)))
    assert jax.config.jax_default_matmul_precision == before


def test_sosfilt_scan_has_no_matmul(dots):
    """sosfilt unrolls its 2x2 section algebra into elementwise f32 ops,
    so no dot_general (and no precision question) arises at all."""
    jax.block_until_ready(tpufft.sosfilt(_SOS, _r((2, 300))))
    assert dots == []
