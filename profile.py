"""Profiler harness (role of the reference's fft/profile.mojo + nsys/ncu
pixi tasks): capture a jax.profiler trace of one device-saturating
workload, or print a timing breakdown of its variants on the GPU.

Usage:
  python profile.py               # timing per variant (block_until_ready)
  python profile.py --trace DIR   # jax.profiler trace into DIR

Fails when no GPU is present.
"""

from __future__ import annotations

import argparse
import json
import sys

import harness

SHAPE = (100_000, 1024)  # saturating workload, headline shape


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="directory for a jax.profiler trace")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    devices = harness.require_gpu()
    harness.enable_compile_cache()
    print(f"card: {harness.card_line()}", file=sys.stderr)
    print(f"device: {json.dumps(harness.device_record(devices))}",
          file=sys.stderr)

    import tpufft
    from tpufft import PlanConfig, SplitComplex

    kr, ki = jax.random.split(jax.random.PRNGKey(0))
    re = jax.random.normal(kr, SHAPE, jnp.float32)
    im = jax.random.normal(ki, SHAPE, jnp.float32)
    x = jax.lax.complex(re, im)
    planes = SplitComplex(re, im)

    def plan(cfg=None):
        return tpufft.plan_fft(SHAPE, jnp.complex64, axes=(-1,), config=cfg)

    variants = {
        "tpufft complex array": (plan(), x),
        "tpufft SplitComplex": (plan(), planes),
        "tpufft bf16 planes": (plan(PlanConfig(plane_dtype="bfloat16")),
                               planes),
        "jnp.fft (cuFFT)": (jax.jit(jnp.fft.fft), x),
    }
    for fn, arg in variants.values():
        harness.block(fn(arg))  # compile + warm

    if args.trace:
        with jax.profiler.trace(args.trace):
            for fn, arg in variants.values():
                harness.block(fn(arg))
        print(f"trace written to {args.trace}", file=sys.stderr)
        return

    for name, (fn, arg) in variants.items():
        t = harness.time_ms(fn, arg, iters=args.iters)
        gbps = (2 * 8 * SHAPE[0] * SHAPE[1]) / (t["min_ms"] * 1e-3) / 1e9
        print(f"{name:22s}: min {t['min_ms']:8.3f} ms  median "
              f"{t['median_ms']:8.3f} ms  {gbps:5.0f} GB/s (one read + "
              "one write)")


if __name__ == "__main__":
    main()
