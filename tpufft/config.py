"""Plan configuration.

The reference exposes its knobs as compile-time plan parameters
(``plan_fft[inverse, bases, runtime_twfs, max_cluster_size, _test]``,
``fft/fft/fft.mojo:123-210``) plus the runtime ``cpu_workers``. Here they are
an ordinary dataclass consumed at trace time; ``jax.jit`` specialization plays
the role of Mojo comptime instantiation.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PlanConfig", "REMOVED_KNOBS"]

# Knobs of the retired Pallas kernel tier. Passing one is an error, not a
# silent no-op: each of them used to change what ran.
REMOVED_KNOBS = ("backend", "lane_block", "interpret", "vmem_budget_bytes",
                 "precision")


@dataclasses.dataclass(frozen=True, init=False)
class PlanConfig:
    """Tuning knobs for an FFT plan.

    Attributes:
      max_radix: largest synthesized radix for the default planner.
      plane_dtype: storage dtype for the split re/im planes — "float32"
        (default) or "bfloat16". bf16 planes halve the bytes each pass
        moves; every transform computes in f32 and rounds its result to
        bf16, so the error is dominated by the ~3.9e-3 relative storage
        rounding (~1e-2 worst case after an ND pipeline). Opt-in for
        tolerance-insensitive pipelines; f64 plans ignore it.
      profile: one-switch storage tier.
        * "accurate" (default): f32 planes — the contract every test in
          the suite runs at.
        * "fast": bf16 planes, unless ``plane_dtype`` is given explicitly.
          f64 plans ignore it (x64 stays exact).
    """

    max_radix: int = 16
    plane_dtype: str | None = None   # resolved from profile when unset
    profile: str = "accurate"

    def __init__(self, max_radix: int = 16, plane_dtype: str | None = None,
                 profile: str = "accurate", **removed):
        unknown = sorted(set(removed) - set(REMOVED_KNOBS))
        if unknown:
            raise TypeError(
                f"PlanConfig got unexpected keyword argument(s) {unknown}")
        if removed:
            names = ", ".join(sorted(removed))
            raise TypeError(
                f"PlanConfig no longer takes {names}: the Pallas kernel "
                "tier these knobs steered was removed, and every axis runs "
                "the jnp Stockham (or Bluestein for large primes)")
        if profile not in ("accurate", "fast"):
            raise ValueError(
                f"profile must be accurate|fast, got {profile!r}"
            )
        # fill only an unset knob: an explicit plane_dtype= wins
        if plane_dtype is None:
            plane_dtype = "bfloat16" if profile == "fast" else "float32"
        if plane_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"plane_dtype must be float32|bfloat16, got {plane_dtype!r}"
            )
        object.__setattr__(self, "max_radix", int(max_radix))
        object.__setattr__(self, "plane_dtype", plane_dtype)
        object.__setattr__(self, "profile", profile)
