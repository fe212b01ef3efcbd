"""End-to-end example: short-time spectral analysis on the device.

Shows the spectral surface on one pipeline:
1. `tpufft.get_window` — native window set (no scipy needed),
2. `ShortTimeFFT` — the scipy-modern class API, stft/istft on device,
3. `welch` — Welch's averaged periodogram,
4. layout / profile options of the plan-level FFT API
   (`layout="transform-major"`, `PlanConfig(profile="fast")`).

Run:  python examples/shorttime_pipeline.py   (any backend)
"""

import numpy as np

import jax
import jax.numpy as jnp

import tpufft
from tpufft import PlanConfig, ShortTimeFFT, SplitComplex

fs = 8192.0
t = np.arange(0, 4.0, 1 / fs)
# a chirp plus a fixed tone, float32 for the device path
x_host = (np.sin(2 * np.pi * (200 + 150 * t) * t)
          + 0.5 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)

# -- 1/2. class-based STFT on device input ---------------------------------
win = tpufft.get_window("hann", 512)           # native host-f64 window
sft = ShortTimeFFT(win, hop=128, fs=fs, scale_to="magnitude")
x = jnp.asarray(x_host)
S = sft.stft(x)                                # (f_pts, n_slices)
mag = (jnp.sqrt(S.re**2 + S.im**2) if isinstance(S, SplitComplex)
       else jnp.abs(S))
peak_bin = int(jnp.argmax(mag.sum(axis=-1)))
print(f"stft: {mag.shape} slices, strongest bin {peak_bin} "
      f"≈ {peak_bin * sft.delta_f:.0f} Hz")

# round-trip through the overlap-add inverse
xr = sft.istft(S, k1=x.shape[-1])
print("istft round-trip max err:",
      float(jnp.max(jnp.abs(xr - x))))

# -- 3. Welch PSD ----------------------------------------------------------
f, p = tpufft.welch(x, fs=fs, nperseg=512)
print(f"welch: tone at {float(f[int(jnp.argmax(jnp.asarray(p)))]):.0f} Hz")

# -- 4. plan-level escapes -------------------------------------------------
# a misaligned-minor batch: exact-semantics transform-major layout
plan = tpufft.plan_fft((4096, 93), np.complex64, axes=(-1,),
                       layout="transform-major")
z = plan.pack(np.random.default_rng(0)
              .standard_normal((4096, 93)).astype(np.complex64))
Z = plan(z)
print("transform-major plan ok:", type(Z).__name__)

# the bf16-plane tier (~1e-2) for tolerance-insensitive pipelines
fast = tpufft.plan_fft((4096, 1024), np.complex64, axes=(-1,),
                       config=PlanConfig(profile="fast"))
Xf = fast(jnp.zeros((4096, 1024), jnp.float32))
print("fast-profile plan ok:", type(Xf).__name__)
