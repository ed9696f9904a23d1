"""Model-layer tests: analytic fields and the advection-diffusion stepper."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.models import (
    AdvectionDiffusion,
    Burgers,
    Derivs,
    benchmark_field,
    sine_field,
    taylor_green,
)
from cfd_tpu.schemes import SCHEME4_PERIODIC


def _coords(n):
    L = 2 * math.pi
    d = L / n
    c = jnp.arange(n) * d
    return c, d


def test_taylor_green_divergence_free():
    n = 32
    c, d = _coords(n)
    u = taylor_green(c, c, c)
    div = cfd_tpu.divergence(u, d, SCHEME4_PERIODIC)
    assert float(jnp.max(jnp.abs(div))) < 1e-7


def test_benchmark_field_gradient():
    n = 48
    z = jnp.linspace(0.1, 1.0, n)
    f, exact = benchmark_field(z, z, z)
    d = float(z[1] - z[0])
    gx, gy, gz = cfd_tpu.gradient(f, d)
    for got, ref in zip((gx, gy, gz), exact):
        assert float(jnp.max(jnp.abs(got - ref))) < 5e-5


def test_sine_field():
    n = 64
    c, d = _coords(n)
    f, df = sine_field(c, c, c, k=2.0)
    got = cfd_tpu.dfdx(f, d, SCHEME4_PERIODIC)
    # 4th-order truncation at k*dx = 0.2
    assert float(jnp.max(jnp.abs(got - df))) < 5e-5


def test_advection_diffusion_step_and_run():
    n = 16
    c, d = _coords(n)
    u = taylor_green(c, c, c)
    f0 = jnp.sin(c)[None, None, :] * jnp.ones((n, n, 1))
    model = AdvectionDiffusion(Derivs.single_device(d, SCHEME4_PERIODIC), nu=1e-3)
    f1 = model.step(f0, u, 1e-3)
    assert f1.shape == f0.shape and bool(jnp.all(jnp.isfinite(f1)))
    # pure diffusion shrinks the L2 norm; advection by a divergence-free
    # field approximately conserves it -> norm must not grow
    f5 = jax.jit(lambda g: model.run(g, u, 1e-3, 5))(f0)
    assert float(jnp.linalg.norm(f5)) <= float(jnp.linalg.norm(f0)) * (1 + 1e-6)


def test_advection_diffusion_distributed_matches_single():
    import os

    from cfd_tpu.parallel import Grid, make_mesh

    n = 16
    c, d = _coords(n)
    u = taylor_green(c, c, c)
    f0 = jnp.sin(c)[None, None, :] * jnp.ones((n, n, 1))
    single = AdvectionDiffusion(
        Derivs.single_device(d, SCHEME4_PERIODIC, method="pcr"), nu=1e-3
    )
    mesh = make_mesh((2, 2, 2))
    grid = Grid(mesh, (n, n, n), (d, d, d), SCHEME4_PERIODIC)
    solver = cfd_tpu.DistributedCompactSolver(grid, method="pcr")
    dist = AdvectionDiffusion(Derivs.distributed(solver), nu=1e-3)
    ud = tuple(grid.distribute(a) for a in u)
    got = np.asarray(dist.step(grid.distribute(f0), ud, 1e-3))
    expect = np.asarray(single.step(f0, u, 1e-3))
    np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-10)


def test_checkpoint_roundtrip(tmp_path):
    from cfd_tpu.utils import restore_state, save_state

    state = {"f": jnp.arange(12.0).reshape(3, 4), "step": np.asarray(7)}
    p = str(tmp_path / "ckpt")
    save_state(p, state)
    back = restore_state(p)
    np.testing.assert_array_equal(back["f"], np.asarray(state["f"]))
    assert int(back["step"]) == 7
    # resharding hook
    back2 = restore_state(p, distribute=jnp.asarray)
    assert isinstance(back2["f"], jax.Array)


def test_burgers_taylor_green_decay():
    """Taylor-Green vortex under viscous Burgers: energy must decay and the
    flow stays finite (the BASELINE 'Taylor-Green gradient pipeline' config)."""
    from cfd_tpu.models import Burgers

    n = 16
    c, d = _coords(n)
    u0 = taylor_green(c, c, c)
    model = Burgers(Derivs.single_device(d, SCHEME4_PERIODIC, method="pcr"), nu=0.05)
    e0 = float(model.kinetic_energy(u0))
    u5 = jax.jit(lambda u: model.run(u, 5e-3, 5))(u0)
    e5 = float(model.kinetic_energy(u5))
    assert np.isfinite(e5) and e5 < e0
    # viscous decay rate of the pure TG mode ~ exp(-4 nu t) early on
    t = 5 * 5e-3
    expected = e0 * np.exp(-4 * 0.05 * t)
    assert abs(e5 - expected) / e0 < 0.05


def test_compact_laplacian_diffusion_matches_chained():
    """Diffusion via the compact-d2 laplacian tracks the chained-first-
    derivative form on a resolved field, and the two models agree to
    truncation error after a step."""
    n = 32
    c, d = _coords(n)
    u = taylor_green(c, c, c)
    f0 = jnp.sin(c)[None, None, :] * jnp.ones((n, n, 1))
    base = AdvectionDiffusion(
        Derivs.single_device(d, SCHEME4_PERIODIC, method="pcr"), nu=1e-2
    )
    d2 = Derivs.single_device(
        d, SCHEME4_PERIODIC, method="pcr", second_derivative=True
    )
    assert d2.laplacian is not None
    model2 = AdvectionDiffusion(d2, nu=1e-2)
    f_a = np.asarray(base.step(f0, u, 1e-3))
    f_b = np.asarray(model2.step(f0, u, 1e-3))
    # both are 4th-order discretisations of the same PDE step
    assert np.abs(f_a - f_b).max() < 1e-6
    # and the d2 laplacian of the sine mode is spectrally cleaner
    lap = np.asarray(d2.laplacian(f0))
    ex = -np.asarray(f0)
    assert np.abs(lap - ex).max() < 2e-4


def test_distributed_d2_laplacian_bundle():
    from cfd_tpu.parallel import Grid, make_mesh
    from cfd_tpu.schemes import SCHEME4_D2_PERIODIC

    n = 16
    c, d = _coords(n)
    mesh = make_mesh((2, 2, 2))
    grid = Grid(mesh, (n, n, n), (d, d, d), SCHEME4_PERIODIC)
    grid2 = Grid(mesh, (n, n, n), (d, d, d), SCHEME4_D2_PERIODIC)
    solver = cfd_tpu.DistributedCompactSolver(grid, method="pcr")
    d2_solver = cfd_tpu.DistributedCompactSolver(grid2, method="pcr")
    bundle = Derivs.distributed(solver, d2_solver=d2_solver)
    f0 = jnp.sin(c)[None, None, :] * jnp.ones((n, n, 1))
    lap = np.asarray(grid.gather(bundle.laplacian(grid.distribute(f0))))
    np.testing.assert_allclose(lap, -np.asarray(f0), atol=5e-3)
    # wrong-order solver is rejected
    import pytest as _pytest

    with _pytest.raises(ValueError, match="derivative_order=2"):
        Derivs.distributed(solver, d2_solver=solver)
