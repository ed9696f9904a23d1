"""Analytic test fields.

The reference exercises its solver on sin/x*y*z fields
(code/cuda/test/test_compact.py:19-59) and benchmarks on
f = x cos(xy) + sin(z) y (perf-test/multi-GPU/PyCUDA/run.py:34-41); the
BASELINE configs add the Taylor–Green vortex gradient pipeline. These
builders produce those fields (plus exact derivatives where useful) on
either numpy or jax arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "benchmark_field",
    "broadband_field",
    "taylor_green",
    "taylor_green_2d",
    "sine_field",
]


def _meshgrid3(z, y, x):
    return z[:, None, None], y[None, :, None], x[None, None, :]


def benchmark_field(z, y, x):
    """f = x cos(xy) + sin(z) y and its exact gradient."""
    Z, Y, X = _meshgrid3(z, y, x)
    f = X * jnp.cos(X * Y) + jnp.sin(Z) * Y
    dfdx = jnp.cos(X * Y) - X * Y * jnp.sin(X * Y) + 0 * f
    dfdy = -(X**2) * jnp.sin(X * Y) + jnp.sin(Z) + 0 * f
    dfdz = jnp.cos(Z) * Y + 0 * f
    return f, (dfdx, dfdy, dfdz)


def taylor_green(z, y, x, t: float = 0.0, nu: float = 0.0):
    """Taylor–Green vortex velocity field (ux, uy, uz) on a periodic box.

    u =  cos(x) sin(y) sin(z) * F(t)
    v = -sin(x) cos(y) sin(z) * F(t)
    w =  0
    with F(t) = exp(-2 nu t). Divergence-free by construction — the standard
    correctness probe for gradient/divergence/curl pipelines.
    """
    import math

    Z, Y, X = _meshgrid3(z, y, x)
    F = jnp.asarray(math.exp(-2.0 * nu * t), X.dtype)
    u = jnp.cos(X) * jnp.sin(Y) * jnp.sin(Z) * F
    v = -jnp.sin(X) * jnp.cos(Y) * jnp.sin(Z) * F
    w = jnp.zeros_like(u)
    return u, v, w


def taylor_green_2d(z, y, x, t: float = 0.0, nu: float = 0.0):
    """z-independent Taylor–Green vortex — an EXACT Navier–Stokes solution.

    u =  cos(x) sin(y) F(t),  v = -sin(x) cos(y) F(t),  w = 0,
    F(t) = exp(-2 nu t), p = -(cos 2x + cos 2y) F^2 / 4.

    Unlike the 3-D field (``taylor_green``, which transitions toward
    turbulence), this one stays exactly TG-shaped forever — the
    incompressible-solver validation case (models/navier_stokes.py).
    Returns ((u, v, w), p).
    """
    import math

    Z, Y, X = _meshgrid3(z, y, x)
    F = jnp.asarray(math.exp(-2.0 * nu * t), X.dtype)
    u = jnp.cos(X) * jnp.sin(Y) * F + 0 * Z
    v = -jnp.sin(X) * jnp.cos(Y) * F + 0 * Z
    w = jnp.zeros_like(u)
    p = -(jnp.cos(2 * X) + jnp.cos(2 * Y)) * F * F / 4 + 0 * Z
    return (u, v, w), p


def sine_field(z, y, x, k: float = 1.0):
    """f = sin(k x) broadcast over (z, y); exact d/dx = k cos(k x)."""
    Z, Y, X = _meshgrid3(z, y, x)
    f = jnp.sin(k * X) + 0 * Z + 0 * Y
    return f, k * jnp.cos(k * X) + 0 * f


def broadband_field(n: int, seed: int = 0, dtype=jnp.float32):
    """Seeded random (n, n, n) field with a broad spectrum, made on device.

    White noise under a 1 / (1 + (|k| / k0)^2) envelope, k0 = n / 8: every
    wavenumber up to Nyquist carries energy, so a derivative check sees the
    whole transfer function, not one mode. Normalised to max |f| = 1.
    """
    import jax

    w = jax.random.normal(jax.random.PRNGKey(seed), (n, n, n), dtype)
    k = jnp.fft.fftfreq(n, 1.0 / n).astype(dtype)
    kr = jnp.fft.rfftfreq(n, 1.0 / n).astype(dtype)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kr[None, None, :] ** 2
    env = 1.0 / (1.0 + k2 / (n / 8.0) ** 2)
    f = jnp.fft.irfftn(jnp.fft.rfftn(w) * env, s=(n, n, n)).astype(dtype)
    return f / jnp.max(jnp.abs(f))
