"""chip_smoke.py's phases at tiny shapes on the CPU, against NumPy/SciPy.

The script itself refuses to run without a GPU; its phase functions take
their sizes as arguments, so each runs here at a size the CPU handles in
a blink, with the same references and bounds as on the card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench_suite
import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One tiny stand-in per reference-shape class (bench_suite.SHAPES): same
# rank, and each long axis shortened while keeping its factor structure
# (93 = 3 * 31, 480 = 2^5 * 3 * 5, 1080 = 2^3 * 3^3 * 5, ...).
TINY = {
    (1_000_000, 93): (3, 93),
    (500_000, 128): (3, 128),
    (100_000, 1024): (2, 1024),
    (100, 16384): (2, 16384),
    (100, 640, 480): (2, 40, 30),
    (10, 1920, 1080): (2, 60, 54),
    (1, 3840, 2160): (1, 120, 45),
    (1, 7680, 4320): (1, 240, 135),
    (100, 64, 64, 64): (2, 16, 16, 16),
    (10, 128, 128, 128): (2, 32, 16, 8),
    (1, 256, 256, 256): (1, 16, 32, 16),
    (1, 512, 512, 512): (1, 32, 32, 32),
    (1, 64, 64, 64, 64): (1, 8, 8, 8, 8),
    (1, 25, 160, 160, 48): (1, 5, 10, 10, 48),
}


def _assert_ok(checks, n):
    assert len(checks) == n
    for c in checks:
        assert c.ok, c.line()


def test_tiny_table_covers_every_reference_shape():
    assert sorted(TINY) == sorted(bench_suite.SHAPES)


@pytest.mark.parametrize("shape", bench_suite.SHAPES, ids=str)
def test_reference_shape_class(shape):
    tiny = TINY[shape]
    assert len(tiny) == len(shape)
    _assert_ok(cs.phase_reference_shapes([tiny], timed=False), 1)


def test_headline_every_row():
    _assert_ok(cs.phase_headline(batch=40, n=1024, chunk=16, timed=False), 2)


def test_headline_timed_fields():
    checks = cs.phase_headline(batch=4, n=64, chunk=4, timed=True)
    assert all(c.ms > 0 and c.ref_ms > 0 for c in checks)
    assert "jnp.fft" in checks[0].line()


def test_other_transforms():
    checks = cs.phase_other_transforms(
        rfft_shape=(16, 128), prime_shape=(16, 93),
        dense_prime_shape=(2, 1031), bluestein=((2, 8191), (1, 65537)),
        c128_shape=(4, 4096), rows=8)
    _assert_ok(checks, 7)
    c128 = [c for c in checks if "complex128" in c.name]
    assert c128 and c128[0].tol == cs.C128_TOL


def test_other_transforms_checks_the_route(monkeypatch):
    """A Bluestein row that would not take the Bluestein route fails."""
    from tpufft import execute
    monkeypatch.setattr(execute, "BLUESTEIN_MIN_PRIME", 10 ** 6)
    with pytest.raises(AssertionError, match="Bluestein route"):
        cs.phase_other_transforms(
            rfft_shape=(4, 16), prime_shape=(4, 93),
            dense_prime_shape=(2, 131), bluestein=((1, 8191),),
            c128_shape=(2, 64), rows=2)


def test_gradients_adjoint_identity():
    _assert_ok(cs.phase_gradients(fft_shape=(4, 64),
                                  rfftn_shape=(2, 8, 16)), 2)


def test_signal_pipelines():
    _assert_ok(cs.phase_signal(
        stft_shape=(2, 4096), istft_shape=(2, 513, 20),
        welch_shape=(2, 4096), filter_shape=(64, 128), rows=8), 4)


def test_multi_card_phase_on_virtual_devices():
    checks = cs.phase_multi(4, fft_shape=(2, 1 << 10),
                            cube_shape=(1, 8, 8, 16), rows=(0, 1))
    _assert_ok(checks, 6)


def test_rel_err_contract():
    ref = np.array([1.0, -2.0, 4.0])
    assert cs.rel_err(ref, ref) == 0.0
    assert cs.rel_err(ref + np.array([0, 0, 0.4]), ref) == pytest.approx(0.1)
    assert cs.rel_err(np.array([1.0, np.nan, 4.0]), ref) == float("inf")
    with pytest.raises(ValueError, match="shape"):
        cs.rel_err(ref[:2], ref)


def test_check_bounds():
    assert cs.Check("p", "n", 1e-5, cs.C64_TOL).ok
    assert not cs.Check("p", "n", 2e-4, cs.C64_TOL).ok
    assert not cs.Check("p", "n", float("nan"), cs.C64_TOL).ok
    assert not cs.Check("p", "n", 1e-8, cs.C128_TOL).ok
    assert "FAIL" in cs.Check("p", "n", 1.0, cs.C64_TOL).line()


def test_run_fails_on_a_failed_phase(capsys):
    def boom():
        raise RuntimeError("phase broke")

    with pytest.raises(SystemExit, match="FAILED"):
        cs._run([("x", boom)])
    assert "phase broke" in capsys.readouterr().out


def test_run_fails_on_a_check_over_its_bound():
    bad = cs.Check("x", "too far", 1.0, cs.C64_TOL)
    with pytest.raises(SystemExit, match="too far"):
        cs._run([("x", lambda: [bad])])


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
