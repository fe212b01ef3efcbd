"""Differentiability of the transform paths.

Every route is plain jnp, so jax.grad follows it by ordinary autodiff.
These tests check jax.grad through the library against grads through
jnp.fft, under the default planner and one capped at radix 4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tpufft
from tpufft import PlanConfig, SplitComplex

CFG_KERNEL = PlanConfig(max_radix=4)
CFG_XLA = PlanConfig()


def _loss_tpufft(plan):
    def loss(re, im):
        out = plan(SplitComplex(re, im))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)
    return loss


def _loss_jnp(fn):
    def loss(re, im):
        out = fn(re + 1j * im)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)
    return loss


@pytest.mark.parametrize("cfg", [CFG_XLA, CFG_KERNEL],
                         ids=["default", "radix4"])
def test_grad_fft_matches_jnp(cfg, rng):
    re = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)
    plan = tpufft.plan_fft((4, 64), jnp.complex64, axes=(-1,), config=cfg)
    g = jax.grad(_loss_tpufft(plan), argnums=(0, 1))(re, im)
    g_ref = jax.grad(_loss_jnp(lambda z: jnp.fft.fft(z, axis=-1)),
                     argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("cfg", [CFG_XLA, CFG_KERNEL],
                         ids=["default", "radix4"])
def test_grad_ifft_norm(cfg, rng):
    re = jnp.asarray(rng.standard_normal((2, 32)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((2, 32)), jnp.float32)
    plan = tpufft.plan_fft((2, 32), jnp.complex64, axes=(-1,), inverse=True,
                           norm="ortho", config=cfg)
    g = jax.grad(_loss_tpufft(plan), argnums=(0, 1))(re, im)
    g_ref = jax.grad(
        _loss_jnp(lambda z: jnp.fft.ifft(z, axis=-1, norm="ortho")),
        argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)


def test_grad_fused_pair(rng):
    cfg = PlanConfig()
    re = jnp.asarray(rng.standard_normal((2, 64, 128)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((2, 64, 128)), jnp.float32)
    plan = tpufft.plan_fft((2, 64, 128), jnp.complex64, axes=(1, 2),
                           config=cfg)
    g = jax.grad(_loss_tpufft(plan), argnums=(0, 1))(re, im)
    g_ref = jax.grad(_loss_jnp(lambda z: jnp.fft.fft2(z)),
                     argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        # f32 rounding through two transforms + quadratic loss: compare
        # normalized to the gradient magnitude
        err = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert err < 1e-3, f"normalized grad err {err:.3e}"


def test_grad_rfft_direct_kernel(rng):
    """jax.grad through the packed r2c path matches jnp.fft.rfft's."""
    x = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)

    def loss(v):
        out = tpufft.rfft(v, config=CFG_KERNEL)
        if isinstance(out, SplitComplex):
            return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)

    def loss_ref(v):
        out = jnp.fft.rfft(v, axis=-1)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)

    g = jax.grad(loss)(x)
    g_ref = jax.grad(loss_ref)(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=2e-3, atol=2e-3)


def test_grad_irfft_direct_kernel(rng):
    """jax.grad through the packed c2r path matches jnp.fft.irfft's."""
    re = jnp.asarray(rng.standard_normal((4, 33)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((4, 33)), jnp.float32)

    def loss(a, b):
        out = tpufft.irfft(SplitComplex(a, b), n=64, config=CFG_KERNEL)
        if isinstance(out, SplitComplex):
            out = out.re
        return jnp.sum(out ** 2)

    def loss_ref(a, b):
        out = jnp.fft.irfft(a + 1j * b, n=64, axis=-1)
        return jnp.sum(out ** 2)

    g = jax.grad(loss, argnums=(0, 1))(re, im)
    g_ref = jax.grad(loss_ref, argnums=(0, 1))(re, im)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)


def test_grad_real_input(rng):
    """Real-input path (elided imag plane): grad w.r.t. the real plane."""
    cfg = CFG_KERNEL
    x = jnp.asarray(rng.standard_normal((3, 64)), jnp.float32)
    plan = tpufft.plan_fft((3, 64), jnp.float32, axes=(-1,), config=cfg)

    def loss(v):
        out = plan(SplitComplex(v, jnp.zeros_like(v)))
        return jnp.sum(out.re ** 2 + out.im ** 2)

    def loss_elided(v):
        # the functional API takes the real array directly (ai elided)
        outr, outi = plan._fn(v, None)
        return jnp.sum(outr ** 2 + outi ** 2)

    g1 = jax.grad(loss)(x)
    g2 = jax.grad(loss_elided)(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=2e-3, atol=2e-3)
