"""Twiddle-factor tables and radix DFT matrices.

The analog of the reference's twiddle machinery
(``fft/fft/_utils.mojo:63-123`` ``_get_twiddle_factor[s][_inline]`` and the
phasor-specialized complex ops at ``_utils.mojo:291-372``): all tables are
precomputed on the host in NumPy float64 — exactly like the reference's
``_GPUPlan.__init__`` uploads host-computed tables
(``fft/fft/_ndim_fft_gpu.mojo:196-207``) — then cast to the compute dtype.
Exact values at the quarter-circle points (n/N in {0, 1/4, 1/2, 3/4}) come
out of float64 trig to < 1e-16, so the reference's special-cased exact
+-1 / +-i entries (``_utils.mojo:73-100``) are preserved numerically; the
branch-free phasor specializations fold into trace-time constant folding of
the DFT-matrix entries instead.

All functions return NumPy arrays (host constants). They are embedded into
jitted computations as literals, so each (n, bases, inverse) specialization
carries its own constant-folded tables — the analog of the reference's
comptime-inlined twiddles (``_fft.mojo:300-391``).
"""

from __future__ import annotations

import functools

import numpy as np

from .planner import Stage, stage_schedule

__all__ = [
    "dft_matrix",
    "stage_twiddle",
    "stage_tables",
    "exact_quarter_cleanup",
]


def _cis(num: np.ndarray, den: float, inverse: bool) -> np.ndarray:
    """exp(sign * 2*pi*i * num / den) in float64, with exact quarter points."""
    sign = 1.0 if inverse else -1.0
    theta = (sign * 2.0 * np.pi / den) * num
    table = np.cos(theta) + 1j * np.sin(theta)
    return exact_quarter_cleanup(table, num, den)


def exact_quarter_cleanup(
    table: np.ndarray, num: np.ndarray, den: float
) -> np.ndarray:
    """Snap entries at multiples of a quarter turn to exact +-1 / +-i.

    Reference computes these cases exactly in its comptime interpreter
    (fft/fft/_utils.mojo:73-100); float64 trig already gets within 1e-16 but
    snapping makes the radix-2/4 matrices exactly {+-1, +-i} so trace-time
    constant folding turns those multiplies into adds/negations/plane swaps.
    """
    frac = np.mod(np.asarray(num, np.float64) / den, 1.0)
    quarter = np.round(frac * 4.0)
    is_quarter = np.abs(frac * 4.0 - quarter) < 1e-12
    exact = np.choose(
        (quarter.astype(np.int64) % 4),
        [1.0 + 0.0j, -1.0j, -1.0 + 0.0j, 1.0j],
    )
    # For inverse transforms the sign of the imaginary part flips; detect by
    # comparing against the computed value rather than re-deriving direction.
    exact_conj = np.conj(exact)
    use_conj = np.abs(table - exact_conj) < np.abs(table - exact)
    snapped = np.where(use_conj, exact_conj, exact)
    return np.where(is_quarter, snapped, table)


@functools.lru_cache(maxsize=None)
def dft_matrix(r: int, inverse: bool = False) -> np.ndarray:
    """Dense radix-r DFT matrix W[j, b] = exp(-+2*pi*i*j*b/r), complex128."""
    jb = np.outer(np.arange(r), np.arange(r))
    return _cis(jb, float(r), inverse)


@functools.lru_cache(maxsize=None)
def stage_twiddle(stage: Stage, inverse: bool = False) -> np.ndarray:
    """Per-stage twiddle table tw[j, p] = exp(-+2*pi*i*j*p/(r*m)), (r, m)."""
    jp = np.outer(np.arange(stage.radix), np.arange(stage.m))
    return _cis(jp, float(stage.radix * stage.m), inverse)


@functools.lru_cache(maxsize=None)
def stage_tables(
    n: int,
    bases: tuple[int, ...],
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[tuple[Stage, np.ndarray, np.ndarray], ...]:
    """(stage, W_r, twiddle) triples for every stage of a length-n transform.

    ``scale`` (e.g. 1/N for the backward-normalized inverse) is fused into the
    last stage's twiddle table, the same trick as the reference's fused 1/N
    in the final Stockham stage (fft/fft/_fft.mojo:292-295).
    """
    stages = stage_schedule(n, bases)
    out = []
    for i, st in enumerate(stages):
        tw = stage_twiddle(st, inverse)
        if scale != 1.0 and i == len(stages) - 1:
            tw = tw * scale
        out.append((st, dft_matrix(st.radix, inverse), tw))
    if not stages and scale != 1.0:
        # n == 1: no stages; caller must apply scale directly.
        pass
    return tuple(out)
