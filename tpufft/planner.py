"""Radix-decomposition planner.

Factorizes transform lengths into ordered radix stage schedules for the
Stockham autosort FFT. This is the analog of the reference's
compile-time planner (``fft/fft/fft.mojo:49-119`` ``_estimate_best_bases[_nd]``
and the stage-schedule math in ``fft/fft/_utils.mojo:132-221``): everything the
reference computes with Mojo ``comptime`` happens here in ordinary Python at
plan/trace time, and ``jax.jit`` specializes per (shape, bases) the same way
Mojo parameterization does.

Stage model (batch-minor Stockham, see core.stockham_split_last_axis):

    state vector of length N, stage t with radix r and cumulative product s
    ("processed", s_0 = 1) views the state as (r, m, s) with m = N/(r*s) and
    computes

        out[p, j, q] = tw[j, p] * sum_b W_r[j, b] * in[b, p, q]

    with W_r the radix-r DFT matrix and tw[j, p] = exp(-2*pi*i*j*p/(r*m)).
    After the stage the new s is s*r. After all stages the state holds the
    DFT in natural order (autosort — no digit-reversal pass).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

__all__ = [
    "Stage",
    "factorize",
    "default_bases",
    "digit_reverse",
    "next_fast_len",
    "stage_schedule",
    "validate_bases",
]

# Largest radix the default planner will synthesize by merging prime factors.
# Mirrors the role of ``max_radix_number = 32`` in the reference GPU heuristic
# (fft/fft/fft.mojo:54): each radix-r stage costs O(r) multiply-adds per
# element (an (r x r) contraction), while the stage count, and with it the
# number of full passes over the planes, falls like log_r(N).
DEFAULT_MAX_RADIX = 16


@dataclasses.dataclass(frozen=True)
class Stage:
    """One Stockham butterfly stage.

    Attributes:
      radix: r, the small-DFT size of this stage.
      m: number of twiddle groups, N / (radix * s).
      s: cumulative product of radices of all previous stages ("processed").
      n: full transform length (constant across stages).
    """

    radix: int
    m: int
    s: int
    n: int


def factorize(n: int) -> list[int]:
    """Prime factorization of ``n`` in ascending order.

    Trial division like the reference's greedy prime loop
    (fft/fft/fft.mojo:83-104), but unbounded: any prime is supported (a
    prime factor becomes a single dense-DFT stage, or the whole axis runs
    through Bluestein above execute.BLUESTEIN_MIN_PRIME).
    """
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    factors: list[int] = []
    rem = n
    d = 2
    while d * d <= rem:
        while rem % d == 0:
            factors.append(d)
            rem //= d
        d += 1 if d == 2 else 2
    if rem > 1:
        factors.append(rem)
    return factors


@functools.lru_cache(maxsize=None)
def default_bases(n: int, max_radix: int = DEFAULT_MAX_RADIX) -> tuple[int, ...]:
    """Choose a radix decomposition of ``n``.

    Strategy: factorize into primes, then greedily merge the two smallest
    factors while their product stays <= ``max_radix``. This packs runs of
    2s into 8/16 (power-of-two lengths become e.g. 1024 -> (16, 16, 4)),
    merges 2*3 -> 6, 3*3 -> 9, etc., and leaves large primes (31, 97, ...)
    as single dense-DFT stages. Result is sorted descending so the largest
    radix runs first (matching the reference's reversed base order,
    fft/fft/fft.mojo:79,102).
    """
    if n == 1:
        return (1,)
    factors = sorted(factorize(n))
    while len(factors) >= 2 and factors[0] * factors[1] <= max_radix:
        merged = factors[0] * factors[1]
        factors = sorted(factors[2:] + [merged])
    return tuple(sorted(factors, reverse=True))


def validate_bases(n: int, bases: Sequence[int]) -> tuple[int, ...]:
    """Check that ``bases`` is a valid decomposition of ``n``.

    Analog of the reference's comptime product assertion
    (``_get_ordered_bases_processed_list``, fft/fft/_utils.mojo:186-221).
    """
    bases = tuple(int(b) for b in bases)
    if any(b < 1 for b in bases):
        raise ValueError(f"radices must be positive, got {bases}")
    if math.prod(bases) != n:
        raise ValueError(
            f"product of bases {bases} is {math.prod(bases)}, expected {n}"
        )
    return bases


# Largest prime the "fast" lengths may contain: radix 2, 3, 5 and 7 stages
# merge into the planner's small radices (<= 16), so a 7-smooth length never
# runs a dense prime stage.
FAST_MAX_PRIME = 7


def _is_fast(m: int) -> bool:
    for p in (2, 3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def next_fast_len(n: int, *, aligned: bool = False) -> int:
    """Smallest length >= n whose prime factors are all <= FAST_MAX_PRIME
    (scipy.fft.next_fast_len analog for the Stockham planner).

    With ``aligned=True`` the result is additionally a multiple of 128, so
    a padded minor axis keeps whole 128-element rows.
    """
    if n <= 1:
        return max(n, 1)
    step = 128 if aligned else 1
    m = ((n + step - 1) // step) * step
    while not _is_fast(m):
        m += step
    return m


def prev_fast_len(n: int, *, aligned: bool = False) -> int:
    """Largest length <= n whose prime factors are all <= FAST_MAX_PRIME —
    the scipy.fft.prev_fast_len analog of :func:`next_fast_len`
    (``aligned=True`` additionally requires a multiple of 128)."""
    if n <= 1:
        return max(n, 1)
    step = 128 if aligned else 1
    m = (n // step) * step
    while m >= step and not _is_fast(m):
        m -= step
    return max(m, 1)


def digit_reverse(index: int, bases: Sequence[int]) -> int:
    """Mixed-radix digit reversal of ``index`` over the ordered base list.

    The input-reordering permutation a decimation-in-time (Cooley-Tukey)
    formulation would need (reference: ``_mixed_radix_digit_reverse``,
    fft/fft/_utils.mojo:24-60). The library's execution paths are all
    autosort (Stockham / four-step) and never permute, so this is provided
    as the documented reference algorithm and for interop with DIT-ordered
    data, not used internally.

    With index = sum_i d_i * prod(bases[i+1:]) (d_i the digit for bases[i]),
    returns sum_i d_i * prod(bases[:i]).
    """
    bases = tuple(int(b) for b in bases)
    digits = []
    rem = index
    for b in reversed(bases):
        digits.append(rem % b)
        rem //= b
    # digits[0] is the least-significant (last-base) digit
    out = 0
    for b, d in zip(reversed(bases), digits):
        out = out * b + d
    return out


@functools.lru_cache(maxsize=None)
def stage_schedule(n: int, bases: tuple[int, ...]) -> tuple[Stage, ...]:
    """Build the ordered Stockham stage list for length ``n``.

    Analog of the (base, processed) bookkeeping in the reference
    (fft/fft/_utils.mojo:186-221). ``s`` plays the role of ``processed``.
    """
    bases = validate_bases(n, bases)
    if n == 1:
        return ()
    stages = []
    s = 1
    for r in bases:
        if r == 1:
            continue
        m = n // (r * s)
        stages.append(Stage(radix=r, m=m, s=s, n=n))
        s *= r
    return tuple(stages)
