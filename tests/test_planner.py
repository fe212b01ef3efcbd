import math

import pytest

from tpufft.planner import (
    default_bases,
    factorize,
    stage_schedule,
    validate_bases,
)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 12, 60, 93, 97, 128, 1024, 16384,
                               100, 35, 48, 21, 1000000])
def test_factorize_product(n):
    fs = factorize(n)
    assert math.prod(fs) == n
    for f in fs:
        # each factor is prime
        assert all(f % d for d in range(2, int(f**0.5) + 1))


@pytest.mark.parametrize("n", [2, 3, 8, 60, 93, 97, 128, 1024, 16384, 93 * 93])
def test_default_bases(n):
    bases = default_bases(n)
    assert math.prod(bases) == n
    assert list(bases) == sorted(bases, reverse=True)
    # composite radices stay within the merge limit; large primes pass through
    for b in bases:
        assert b <= 16 or all(b % d for d in range(2, int(b**0.5) + 1))


def test_default_bases_merges_twos():
    assert math.prod(default_bases(1024)) == 1024
    assert all(b in (16, 8, 4, 2) for b in default_bases(1024))
    assert len(default_bases(1024)) <= 3


def test_stage_schedule_invariants():
    for n, bases in [(128, (16, 8)), (60, (5, 4, 3)), (93, (31, 3)),
                     (97, (97,)), (1024, (16, 16, 4))]:
        stages = stage_schedule(n, bases)
        s = 1
        for st, r in zip(stages, bases):
            assert st.radix == r
            assert st.s == s
            assert st.radix * st.m * st.s == n
            s *= r
        assert s == n


def test_validate_bases_errors():
    with pytest.raises(ValueError):
        validate_bases(8, (3, 3))
    with pytest.raises(ValueError):
        validate_bases(8, (8, 0))
    assert validate_bases(8, (2, 4)) == (2, 4)


def test_digit_reverse():
    from tpufft.planner import digit_reverse
    # radix-2 case degenerates to bit reversal
    assert [digit_reverse(i, (2, 2, 2)) for i in range(8)] == \
        [0, 4, 2, 6, 1, 5, 3, 7]
    # mixed radix: a valid permutation, inverted by the reversed base list
    bases = (2, 3, 4)
    perm = [digit_reverse(i, bases) for i in range(24)]
    assert sorted(perm) == list(range(24))
    for i in range(24):
        assert digit_reverse(digit_reverse(i, bases), bases[::-1]) == i


def test_next_fast_len():
    from tpufft.planner import FAST_MAX_PRIME, factorize, next_fast_len
    assert next_fast_len(1) == 1
    assert next_fast_len(93) == 96          # 3 * 31 -> 2^5 * 3
    assert next_fast_len(1024) == 1024
    for n in (129, 1000, 5000, 16385, 100000):
        m = next_fast_len(n)
        assert m >= n
        assert next_fast_len(m) == m      # idempotent: m itself is fast
        assert max(factorize(m)) <= FAST_MAX_PRIME
    assert next_fast_len(1000) == 1000
    m = next_fast_len(93, aligned=True)
    assert m == 128
    assert next_fast_len(1024, aligned=True) == 1024
