"""Spectral Poisson solver + Helmholtz projection (ops/poisson.py).

Periodic compact operators are circulant, so these are EXACT inverses —
the gates are rounding-level (f64), not truncation-level.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.ops.poisson import (
    laplacian_eigenvalues,
    project,
    solve_poisson,
    spectral_multipliers,
)
from cfd_tpu.schemes import SCHEME4, get_filter, get_scheme

SP = (0.11, 0.07, 0.05)
SHAPE = (24, 20, 16)


def _zero_mean_rhs(rng, shape):
    rhs = rng.standard_normal(shape)
    return jnp.asarray(rhs - rhs.mean())


@pytest.mark.parametrize("order", [4, 6])
def test_poisson_d2_roundtrip_exact(rng, order):
    """laplacian(solve_poisson(rhs)) == rhs to rounding (d2 schemes have
    no Nyquist null space)."""
    d2 = get_scheme(order, True, 2)
    rhs = _zero_mean_rhs(rng, SHAPE)
    p = solve_poisson(rhs, SP, d2)
    back = cfd_tpu.laplacian(p, SP, d2, method="matmul")
    assert float(jnp.max(jnp.abs(back - rhs))) < 1e-11
    assert abs(float(jnp.mean(p))) < 1e-13


@pytest.mark.parametrize("order", [4, 6])
def test_poisson_d1_divgrad_roundtrip(rng, order):
    """div(grad(solve_poisson(rhs))) recovers rhs projected onto the
    operator's range (central d1 schemes annihilate the odd-even modes
    that are 0-or-Nyquist along every axis)."""
    d1 = get_scheme(order, True, 1)
    rhs = _zero_mean_rhs(rng, SHAPE)
    p = solve_poisson(rhs, SP, d1)
    back = cfd_tpu.divergence(
        cfd_tpu.gradient(p, SP, d1, method="matmul"), SP, d1, method="matmul"
    )
    lam = laplacian_eigenvalues(d1, SHAPE, SP)
    rhs_range = np.fft.irfftn(
        np.fft.rfftn(np.asarray(rhs)) * (lam != 0), s=SHAPE, axes=(0, 1, 2)
    )
    assert float(jnp.max(jnp.abs(back - rhs_range))) < 1e-11


def test_poisson_mean_is_free_constant(rng):
    d2 = get_scheme(4, True, 2)
    rhs = _zero_mean_rhs(rng, SHAPE)
    p0 = solve_poisson(rhs, SP, d2)
    p5 = solve_poisson(rhs, SP, d2, mean=5.0)
    assert abs(float(jnp.mean(p5)) - 5.0) < 1e-12
    assert float(jnp.max(jnp.abs((p5 - p0) - 5.0))) < 1e-12


def test_poisson_analytic_sine(rng):
    """-(k'^2 amplification) checks sign/scaling: for f = sin(k x) the d2
    solve returns -sin(k x)/k''(k dx)*dx^2 exactly."""
    d2 = get_scheme(4, True, 2)
    n = 32
    dx = 2 * np.pi / n
    x = np.arange(n) * dx
    from cfd_tpu.schemes import transfer_function

    rhs3 = jnp.asarray(np.broadcast_to(np.sin(x), (8, 8, n)).copy())
    p = solve_poisson(rhs3, (dx, dx, dx), d2)
    kpp = float(transfer_function(d2, np.array([dx]))[0])  # k'' at k=1*dx
    expect = -np.sin(x) * dx**2 / kpp
    assert np.abs(np.asarray(p) - expect).max() < 1e-12


def test_project_kills_compact_divergence(rng):
    d1 = get_scheme(4, True, 1)
    u = tuple(jnp.asarray(rng.standard_normal(SHAPE)) for _ in range(3))
    up = project(u, SP, d1)
    div = cfd_tpu.divergence(up, SP, d1, method="matmul")
    assert float(jnp.max(jnp.abs(div))) < 1e-12


def test_project_compact_form_matches_spectral(rng):
    """u - grad(solve_poisson(div u)) is the same projection — 2 FFTs
    instead of 6 (ops/poisson.project, method='compact')."""
    d1 = get_scheme(4, True, 1)
    u = tuple(jnp.asarray(rng.standard_normal(SHAPE)) for _ in range(3))
    us = project(u, SP, d1, method="spectral")
    uc = project(u, SP, d1, method="compact")
    for a, b in zip(us, uc):
        assert float(jnp.max(jnp.abs(a - b))) < 1e-9
    div = cfd_tpu.divergence(uc, SP, d1, method="matmul")
    assert float(jnp.max(jnp.abs(div))) < 1e-9


def test_project_idempotent_and_preserves_solenoidal(rng):
    d1 = get_scheme(4, True, 1)
    u = tuple(jnp.asarray(rng.standard_normal(SHAPE)) for _ in range(3))
    up = project(u, SP, d1)
    upp = project(up, SP, d1)
    for a, b in zip(up, upp):
        assert float(jnp.max(jnp.abs(a - b))) < 1e-13


def test_project_taylor_green_fixed_point():
    """The Taylor-Green field is divergence-free for the compact scheme
    too (its divergence cancels mode-by-mode), so project() is identity
    on it."""
    from cfd_tpu.models import taylor_green

    n = 16
    dx = 2 * np.pi / n
    c = np.arange(n) * dx
    u = taylor_green(jnp.asarray(c), jnp.asarray(c), jnp.asarray(c))
    u = tuple(jnp.asarray(a, jnp.float64) for a in u)
    up = project(u, (dx, dx, dx), get_scheme(4, True, 1))
    for a, b in zip(u, up):
        assert float(jnp.max(jnp.abs(a - b))) < 1e-13


def test_spectral_multipliers_match_matmul_derivative(rng):
    """ifft(i m fft(f)) along x == dfdx by the dense operator, exactly."""
    d1 = get_scheme(6, True, 1)
    f = jnp.asarray(rng.standard_normal(SHAPE))
    _, _, mx = spectral_multipliers(d1, SHAPE, SP)
    got = np.fft.irfft(
        1j * mx * np.fft.rfft(np.asarray(f), axis=-1), n=SHAPE[-1], axis=-1
    )
    ref = cfd_tpu.dfdx(f, SP[2], d1, method="matmul")
    assert np.abs(got - np.asarray(ref)).max() < 1e-11


def test_poisson_rejects_bad_schemes():
    with pytest.raises(ValueError):
        solve_poisson(jnp.zeros(SHAPE), SP, SCHEME4)  # non-periodic
    with pytest.raises(ValueError):
        project((jnp.zeros(SHAPE),) * 3, SP, get_scheme(4, True, 2))  # d2
    with pytest.raises(ValueError):
        solve_poisson(jnp.zeros(SHAPE), SP, get_filter())  # filter
    with pytest.raises(ValueError):
        solve_poisson(jnp.zeros((4, 4)), SP, get_scheme(4, True, 2))  # 2-D


@pytest.mark.parametrize("order", [4, 6])
def test_solve_poisson_f32_vs_host_f64_fft(rng, order):
    """The f32 solve (jnp.fft; cuFFT on the GPU) against the same inverse
    taken with numpy's float64 FFT: f32 FFT roundoff, relative to max|p|."""
    d2 = get_scheme(order, True, 2)
    rhs = np.asarray(_zero_mean_rhs(rng, SHAPE))
    lam = laplacian_eigenvalues(d2, SHAPE, SP)
    inv = np.zeros_like(lam)
    inv[lam != 0] = 1.0 / lam[lam != 0]
    ref = np.fft.irfftn(np.fft.rfftn(rhs) * inv, s=SHAPE, axes=(0, 1, 2))
    got = np.asarray(solve_poisson(jnp.asarray(rhs, jnp.float32), SP, d2))
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) < 1e-5 * np.max(np.abs(ref))


def test_project_auto_is_spectral(rng):
    d1 = get_scheme(4, True, 1)
    u = tuple(jnp.asarray(rng.standard_normal(SHAPE), jnp.float32) for _ in range(3))
    for a, b in zip(project(u, SP, d1), project(u, SP, d1, method="spectral")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
