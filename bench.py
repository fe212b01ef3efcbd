"""Headline benchmark: batched 1D C2C FFT on the GPU.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <ratio>,
   "jnp_fft_ms": <ms>, "device": {"platform", "kind", "count"}}

Headline config from BASELINE.json: c64 C2C at (100000, 1024), complex
jax.Array in and out; the baseline is the reference's published GPU number
for that shape (1.432 ms Mojo on an RTX 5090, BASELINE.md). vs_baseline =
baseline_ms / ours (>1 means faster than the reference). jnp.fft (cuFFT on
the card) is timed in the same process, in turns with ours.

Method mirrors fft/bench.mojo (plan once, time execute + sync): host clock
around each call, ending in block_until_ready, after a warm-up call that
compiles; the min over the timed calls is reported. Fails when no GPU is
present.
"""

from __future__ import annotations

import json
import sys

import numpy as np

import harness

BATCH, N = 100_000, 1024
BASELINE_MS = 1.432  # reference Mojo GPU, same shape (BASELINE.md)
ITERS = 20


def main() -> None:
    import jax
    import jax.numpy as jnp

    devices = harness.require_gpu()
    harness.enable_compile_cache()
    print(f"card: {harness.card_line()}", file=sys.stderr)

    import tpufft

    kr, ki = jax.random.split(jax.random.PRNGKey(0))
    x = jax.lax.complex(jax.random.normal(kr, (BATCH, N), jnp.float32),
                        jax.random.normal(ki, (BATCH, N), jnp.float32))
    plan = tpufft.plan_fft((BATCH, N), jnp.complex64, axes=(-1,))
    ref = jax.jit(jnp.fft.fft)

    # correctness spot-check against the host oracle on a few rows
    got = np.asarray(plan(x)[:4])
    want = np.fft.fft(np.asarray(x[:4], np.complex128))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    if err > 1e-4:
        raise AssertionError(f"bench correctness check failed: err={err:.3e}")
    print(f"correctness err: {err:.3e}", file=sys.stderr)

    ours, theirs = [], []
    for _ in range(2):  # in turns: ours, cuFFT, ours, cuFFT
        ours.append(harness.time_ms(plan, x, iters=ITERS)["min_ms"])
        theirs.append(harness.time_ms(ref, x, iters=ITERS)["min_ms"])
    ms, ref_ms = min(ours), min(theirs)
    gbps = (2 * 8 * BATCH * N) / (ms * 1e-3) / 1e9  # c64 in + out
    print(f"{ms:.3f} ms/iter  {gbps:.0f} GB/s (one read + one write)",
          file=sys.stderr)

    print(json.dumps({
        "metric": f"1D C2C c64 ({BATCH}, {N}) plan-execute",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / ms, 3),
        "jnp_fft_ms": round(ref_ms, 3),
        "device": harness.device_record(devices),
    }))


if __name__ == "__main__":
    main()
