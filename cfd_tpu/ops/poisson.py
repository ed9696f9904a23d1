"""Spectral Poisson solver and Helmholtz projection, scheme-consistent.

Periodic compact operators are circulant, so the DFT diagonalizes them
EXACTLY: applying a derivative_order=1 scheme to ``exp(i k x)`` on an
n-point periodic grid multiplies it by ``i k'(k dx) / dx`` and a
derivative_order=2 scheme by ``-k''(k dx) / dx**2``, with k'/k'' the
scheme's transfer function (schemes.transfer_function, Lele 1992). This
module exploits that to solve elliptic problems *in the discrete sense of
the compact schemes themselves*:

- ``solve_poisson``: p such that ``laplacian(p) == rhs`` where the
  Laplacian is the compact one this package evaluates — either the
  second-derivative schemes' (derivative_order=2 scheme) or the repeated
  first-derivative div(grad(.)) form (derivative_order=1 scheme). The
  residual of the round trip is machine precision, not truncation.
- ``project``: the discrete Helmholtz projection — removes exactly the
  component a compact ``divergence`` sees, so
  ``divergence(project(u)) == 0`` to rounding. This is the pressure
  projection an incompressible Navier-Stokes fractional step needs
  (models/navier_stokes.py).

Eigenvalue tables are built once per (scheme, shape, spacing) in float64
numpy at trace time — the same precompute-at-setup discipline as every
other backend in this package. The FFTs are XLA's (cuFFT on the GPU);
everything is jit/grad-compatible.

Periodic schemes only: non-periodic closures break circulant structure,
so there is no exact DFT diagonalization — those geometries keep
iterative/banded routes and are rejected here.

Reference lineage: the reference has no elliptic solver at all (its
surface is first derivatives, SURVEY.md §0); this subsystem is
beyond-reference, motivated by what its CFD users (LANL CFDNS lineage)
run compact schemes *for*.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..schemes import CompactScheme, transfer_function

__all__ = [
    "spectral_multipliers",
    "laplacian_eigenvalues",
    "solve_poisson",
    "project",
]


def _check_periodic(scheme: CompactScheme, who: str):
    if not scheme.periodic:
        raise ValueError(
            f"{who} requires a periodic scheme (non-periodic closures are "
            f"not circulant, so the DFT does not diagonalize them); got "
            f"{scheme.name!r}"
        )


@functools.lru_cache(maxsize=64)
def _kprime_1d(scheme: CompactScheme, n: int, rfft: bool) -> np.ndarray:
    """Signed scaled transfer values over this axis's DFT frequencies.

    d1 schemes: odd k'(k) evaluated at k_j = 2*pi*j/n with j the (r)fft
    frequency order. d2 schemes: even k''(k) >= 0.
    """
    j = np.fft.rfftfreq(n) if rfft else np.fft.fftfreq(n)
    k = 2.0 * np.pi * j  # scaled wavenumber in (-pi, pi]
    t = transfer_function(scheme, np.abs(k))
    if scheme.derivative_order == 1:
        t = t * np.sign(k)
    # snap float noise (sin(j*pi) ~ 1e-16 at the Nyquist mode of central d1
    # schemes) to exact zeros: these are TRUE null modes of the discrete
    # operator — k'(pi) = 0 is the classic collocated-grid odd-even
    # decoupling — and downstream inverses must see them as such rather
    # than divide by (1e-16)^2
    t[np.abs(t) < 1e-12 * np.abs(t).max()] = 0.0
    return t


def spectral_multipliers(scheme: CompactScheme, shape, spacing):
    """Per-axis DFT multiplier tables for the trailing-3-axes operators.

    Returns ``(mz, my, mx)`` float64 arrays broadcastable over an rfftn
    (over the last three axes) of a ``shape``-d field: for d1 schemes the
    derivative along axis a is ``ifft(i * m_a * fft(f))``; for d2 schemes
    it is ``ifft(-m_a * fft(f))`` (m = k''/d**2 >= 0).
    """
    _check_periodic(scheme, "spectral_multipliers")
    nz, ny, nx = shape[-3], shape[-2], shape[-1]
    dz, dy, dx = spacing
    p = scheme.derivative_order
    if p not in (1, 2):
        raise ValueError(
            f"spectral_multipliers needs a derivative scheme, got "
            f"derivative_order={p} ({scheme.name!r})"
        )
    mz = _kprime_1d(scheme, nz, False) / float(dz) ** p
    my = _kprime_1d(scheme, ny, False) / float(dy) ** p
    mx = _kprime_1d(scheme, nx, True) / float(dx) ** p
    return (
        mz.reshape(-1, 1, 1),
        my.reshape(1, -1, 1),
        mx.reshape(1, 1, -1),
    )


def laplacian_eigenvalues(scheme: CompactScheme, shape, spacing) -> np.ndarray:
    """DFT eigenvalues (all <= 0) of the compact Laplacian on ``shape``.

    derivative_order=2 scheme: eigenvalues of d2x + d2y + d2z (the form
    ``ops.laplacian`` evaluates). derivative_order=1 scheme: eigenvalues
    of div(grad(.)) = -(k'x^2 + k'y^2 + k'z^2), the repeated-first-
    derivative form — use this one when consistency with ``divergence``/
    ``gradient`` round trips matters (pressure projection).
    """
    mz, my, mx = spectral_multipliers(scheme, shape, spacing)
    if scheme.derivative_order == 1:
        return -(mz**2 + my**2 + mx**2)
    return -(mz + my + mx)


def _fft_dtypes(dtype):
    if dtype == jnp.float64:
        return jnp.float64, jnp.complex128
    return jnp.float32, jnp.complex64


@functools.partial(jax.jit, static_argnames=("scheme", "spacing", "mean"))
def _solve_poisson(rhs, scheme, spacing, mean):
    rdt, cdt = _fft_dtypes(rhs.dtype)
    lam = laplacian_eigenvalues(scheme, rhs.shape, spacing)
    inv = np.zeros_like(lam)
    nonzero = lam != 0.0
    inv[nonzero] = 1.0 / lam[nonzero]
    npts = rhs.shape[-3] * rhs.shape[-2] * rhs.shape[-1]
    p_hat = jnp.fft.rfftn(rhs, axes=(-3, -2, -1)) * jnp.asarray(inv, rdt)
    if mean != 0.0:
        p_hat = p_hat.at[..., 0, 0, 0].set(mean * npts)
    return jnp.fft.irfftn(
        p_hat.astype(cdt), s=rhs.shape[-3:], axes=(-3, -2, -1)
    ).astype(rhs.dtype)


def solve_poisson(
    rhs: jax.Array,
    spacing,
    scheme: CompactScheme,
    *,
    mean: float = 0.0,
) -> jax.Array:
    """p with ``compact_laplacian(p) == rhs`` on a periodic box.

    ``scheme`` selects which discrete Laplacian is inverted: a
    derivative_order=2 scheme inverts ``ops.laplacian``'s operator; a
    derivative_order=1 scheme inverts the div(grad(.)) repeated-first-
    derivative form. ``rhs`` is ``[..., nz, ny, nx]``; ``spacing`` is
    (dz, dy, dx) or a scalar. The rhs's zero mode is annihilated by any
    Laplacian, so solvability requires mean(rhs) == 0 — the solver
    projects it out — and the solution's own mean is the free constant
    ``mean`` (default 0).

    The derivative_order=1 form has a larger null space than just the
    constant: central d1 schemes have k'(pi) = 0, so every mode that is 0
    or Nyquist along ALL three axes (the collocated-grid odd-even modes)
    is annihilated by div(grad(.)). The solver returns the minimum-norm
    solution; the round trip recovers rhs with those modes projected out.
    The derivative_order=2 schemes have k''(pi) > 0 — no such null space,
    and the exact round trip is the reason ``ops.laplacian`` pairs with
    them for diffusion.
    """
    from .derivatives import _spacings3

    _check_periodic(scheme, "solve_poisson")
    if rhs.ndim < 3:
        raise ValueError(f"solve_poisson needs [..., nz, ny, nx], got {rhs.shape}")
    return _solve_poisson(
        rhs, scheme, tuple(float(s) for s in _spacings3(spacing)), float(mean)
    )


@functools.partial(jax.jit, static_argnames=("scheme", "spacing"))
def _project(ux, uy, uz, scheme, spacing):
    rdt, cdt = _fft_dtypes(ux.dtype)
    mz, my, mx = spectral_multipliers(scheme, ux.shape, spacing)
    k2 = mz**2 + my**2 + mx**2
    inv = np.zeros_like(k2)
    nonzero = k2 != 0.0
    inv[nonzero] = 1.0 / k2[nonzero]
    axes = (-3, -2, -1)
    uh = [jnp.fft.rfftn(c, axes=axes) for c in (uz, uy, ux)]
    m = [jnp.asarray(a, rdt) for a in (mz, my, mx)]
    div_over_k2 = (m[0] * uh[0] + m[1] * uh[1] + m[2] * uh[2]) * jnp.asarray(
        inv, rdt
    )
    out = [
        jnp.fft.irfftn(
            (c - mi * div_over_k2).astype(cdt), s=ux.shape[-3:], axes=axes
        ).astype(ux.dtype)
        for c, mi in zip(uh, m)
    ]
    return out[2], out[1], out[0]


def project(u, spacing, scheme: CompactScheme, *, method: str = "auto"):
    """Discrete Helmholtz projection of ``u = (ux, uy, uz)``.

    Returns the divergence-free part of u in the exact discrete sense:
    ``divergence(project(u), spacing, scheme)`` vanishes to rounding,
    where ``divergence`` is this package's compact one. Idempotent;
    leaves already-divergence-free fields untouched. ``scheme`` must be a
    periodic derivative_order=1 scheme (the one ``divergence`` uses).

    Two algebraically identical forms (``method``):

    * ``'spectral'`` (``'auto'``) — per-mode vector projection
      ``u_hat - k'(k'.u_hat)/|k'|^2``: six scalar FFTs (3 forward +
      3 inverse). No derivative backend in the loop, so it is exact to
      rounding in f64.
    * ``'compact'`` — ``u - grad(solve_poisson(div u))`` with div/grad
      evaluated in physical space by the compact derivatives: two scalar
      FFTs plus the divergence and gradient.
    """
    from .derivatives import _spacings3

    _check_periodic(scheme, "project")
    if scheme.derivative_order != 1:
        raise ValueError(
            "project needs the derivative_order=1 scheme divergence uses, "
            f"got derivative_order={scheme.derivative_order}"
        )
    ux, uy, uz = u
    if not (ux.shape == uy.shape == uz.shape) or ux.ndim < 3:
        raise ValueError(
            f"project needs three equal-shape [..., nz, ny, nx] components, "
            f"got {[c.shape for c in (ux, uy, uz)]}"
        )
    if method not in ("auto", "spectral", "compact"):
        raise ValueError(f"unknown project method {method!r}")
    sp = tuple(float(s) for s in _spacings3(spacing))
    if method == "compact":
        from .derivatives import divergence, gradient

        d = divergence((ux, uy, uz), sp, scheme)
        phi = _solve_poisson(d, scheme, sp, 0.0)
        gx, gy, gz = gradient(phi, sp, scheme)
        return (ux - gx, uy - gy, uz - gz)
    return _project(ux, uy, uz, scheme, sp)
