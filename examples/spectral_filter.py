"""End-to-end example: differentiable spectral low-pass filtering.

Shows the four API styles:
1. scipy-like (complex arrays at the boundary),
2. the filter plan (fft -> H -> ifft collapsed into ONE dense matmul),
3. SplitComplex planes inside jax.jit,
4. multi-device (batch-sharded + distributed transform axis).

Run:  python examples/spectral_filter.py          (uses default backend)
      On the CPU, give it 8 virtual devices for the multi-device part:
      XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""

import numpy as np

import jax
import jax.numpy as jnp

import tpufft
from tpufft import SplitComplex


def scipy_style():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 1024, endpoint=False)
    signal = (np.sin(2 * np.pi * 5 * t)
              + 0.3 * rng.standard_normal(1024)).astype(np.float32)
    spec = tpufft.rfft(signal)                    # (513,) complex
    spec = np.array(spec)                          # host copy, writable
    spec[50:] = 0                                  # low-pass
    clean = tpufft.irfft(spec.astype(np.complex64), n=1024)
    print("scipy-style: residual noise power "
          f"{float(np.var(np.asarray(clean) - np.sin(2*np.pi*5*t))):.4f}")


def fused_filter_plan():
    """The whole circular filter as ONE fused matmul pass
    (tpufft.plan_filter folds fft -> diag(H) -> ifft into a circulant
    matrix at plan time; measured 2.9x the composed pipeline on-chip for
    n=128)."""
    n = 256
    H = np.r_[np.ones(32), np.zeros(n - 63), np.ones(31)]  # Hermitian
    plan = tpufft.plan_filter(n, response=H)
    rng = np.random.default_rng(3)
    t = np.arange(n) / n
    x = (np.sin(2 * np.pi * 4 * t)
         + 0.3 * rng.standard_normal(n)).astype(np.float32)
    clean = plan(np.tile(x, (8, 1)))       # real in -> real out
    print("fused filter: residual noise power "
          f"{float(np.var(np.asarray(clean)[0] - np.sin(2*np.pi*4*t))):.4f}")


def device_native_jit():
    """A jitted, differentiable spectral filter (planes stay on device)."""
    n = 1024
    plan_f = tpufft.plan_fft((8, n), jnp.complex64, axes=(-1,))
    plan_b = tpufft.plan_fft((8, n), jnp.complex64, axes=(-1,),
                             inverse=True, norm="backward")
    keep = jnp.asarray(np.r_[np.ones(64), np.zeros(n - 128), np.ones(64)],
                       jnp.float32)

    @jax.jit
    def filt(re, im):
        spec = plan_f(SplitComplex(re, im))
        spec = SplitComplex(spec.re * keep, spec.im * keep)
        out = plan_b(spec)
        return out.re, out.im

    rng = np.random.default_rng(1)
    re = jnp.asarray(rng.standard_normal((8, n)), jnp.float32)
    im = jnp.zeros_like(re)
    outr, outi = filt(re, im)

    # it's differentiable end-to-end (plain jnp, ordinary autodiff)
    def loss(re):
        r, i = filt(re, im)
        return jnp.sum(r ** 2 + i ** 2)

    g = jax.grad(loss)(re)
    print(f"device-native: out[0,0]={float(outr[0,0]):.4f}, "
          f"grad norm={float(jnp.linalg.norm(g)):.2f}")


def multichip():
    if len(jax.devices()) < 2:
        print("multichip: skipped (single device)")
        return
    from jax.sharding import Mesh
    from tpufft.parallel import fft_distributed

    d = len(jax.devices())
    sp = 2 if d % 2 == 0 else 1
    mesh = Mesh(np.array(jax.devices()[: (d // sp) * sp]).reshape(-1, sp),
                ("dp", "sp"))
    rng = np.random.default_rng(2)
    x = SplitComplex(
        jnp.asarray(rng.standard_normal((8, 256)), jnp.float32),
        jnp.asarray(rng.standard_normal((8, 256)), jnp.float32),
    )
    spec = fft_distributed(x, mesh, axis_name="sp", batch_axis_name="dp",
                           permuted_out=sp > 1)
    back = fft_distributed(spec, mesh, axis_name="sp", batch_axis_name="dp",
                           inverse=True, norm="backward",
                           permuted_in=sp > 1)
    err = np.max(np.abs(back.numpy() - x.numpy()))
    print(f"multichip ({mesh.shape}): roundtrip err {err:.2e}")


if __name__ == "__main__":
    scipy_style()
    fused_filter_plan()
    device_native_jit()
    multichip()
