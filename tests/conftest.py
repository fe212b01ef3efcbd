"""Test environment: CPU with 8 virtual devices, x64 enabled.

The suite runs on the CPU: every transform is plain jnp, and sharding
tests use a virtual 8-device CPU mesh. What only a GPU can show is checked
by ``python chip_smoke.py`` on a GPU host (see README.md). Tests that need
the card carry the ``chip`` marker and skip here; the ``_chip_gate``
fixture decides at run time, never at import.
"""

import os

# Pin the CPU before JAX starts; the config update below makes it stick
# even where JAX_PLATFORMS was set otherwise by the caller.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _chip_gate(request):
    """Skip ``chip``-marked tests unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("chip") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")


def assert_spectrum_close(got, expected, dtype):
    """Tolerance contract from BASELINE.md: 1e-6 for c128-path, 1e-3 for c64.

    Normalized by the spectrum magnitude so large integer series don't turn
    absolute tolerance into a no-op.
    """
    got = np.asarray(got)
    expected = np.asarray(expected)
    scale = max(1.0, float(np.max(np.abs(expected))))
    tol = 1e-6 if np.dtype(dtype) in (np.complex128, np.float64) else 1e-3
    err = np.max(np.abs(got - expected)) / scale
    assert err < tol, f"normalized error {err:.3e} >= {tol} (dtype={dtype})"
