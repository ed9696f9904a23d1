"""Compact low-pass filters (derivative_order=0 schemes).

Lele 1992 §C / Gaitonde–Visbal F4/F6 tridiagonal filters, built by
``schemes.get_filter`` from the transfer-function order conditions and
applied through the same solver machinery as the derivatives. The
reference library has no filtering; this is capability beyond its surface.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.oracle import derivative_np
from cfd_tpu.parallel import Grid, make_mesh
from cfd_tpu.schemes import get_filter


@pytest.mark.parametrize("order", [4, 6])
@pytest.mark.parametrize("periodic", [True, False])
def test_constants_preserved_exactly(order, periodic):
    sch = get_filter(order, 0.45, periodic)
    out = np.asarray(cfd_tpu.filter_field(jnp.full((4, 4, 64), 3.7), sch, axis=-1))
    np.testing.assert_allclose(out, 3.7, atol=1e-12)


@pytest.mark.parametrize("order", [4, 6])
def test_nyquist_annihilated(order):
    n = 128
    saw = jnp.asarray((-1.0) ** np.arange(n)[None, None, :] * np.ones((2, 2, 1)))
    # periodic: exact annihilation everywhere
    fs = np.asarray(cfd_tpu.filter_field(saw, get_filter(order, 0.45, True), axis=-1))
    assert np.abs(fs).max() < 1e-12
    # closed: the unfiltered (identity-row) boundary values decay into the
    # interior at the LHS recurrence rate |r| ~ 0.63 — annihilation holds
    # away from the walls
    fs = np.asarray(cfd_tpu.filter_field(saw, get_filter(order, 0.45, False), axis=-1))
    assert np.abs(fs[..., n // 2 - 6 : n // 2 + 6]).max() < 1e-9


@pytest.mark.parametrize("order,tol", [(4, 3e-8), (6, 2e-11)])
def test_resolved_mode_preserved(order, tol):
    """G(k) = 1 - O(k^order): the lowest sine mode passes at truncation."""
    n = 128
    x = 2 * math.pi * np.arange(n) / n
    f = jnp.asarray(np.sin(x)[None, None, :] * np.ones((2, 2, 1)))
    ff = np.asarray(cfd_tpu.filter_field(f, get_filter(order, 0.45, True), axis=-1))
    assert np.abs(ff - np.asarray(f)).max() < tol


def test_transfer_function_monotone_damping():
    """Higher wavenumbers are damped more; everything stays in [0, 1]."""
    n = 64
    sch = get_filter(6, 0.4, True)
    x = 2 * math.pi * np.arange(n) / n
    gains = []
    for m in (1, 8, 16, 24, 31):
        f = jnp.asarray(np.sin(m * x)[None, None, :] * np.ones((1, 1, 1)))
        ff = np.asarray(cfd_tpu.filter_field(f, sch, axis=-1))
        gains.append(np.abs(ff).max())
    assert all(g1 >= g2 - 1e-12 for g1, g2 in zip(gains, gains[1:])), gains
    assert gains[0] > 1 - 1e-5 and gains[-1] < 0.15
    assert all(0 <= g <= 1 + 1e-12 for g in gains)


@pytest.mark.parametrize("method", ["pcr", "thomas", "matmul", "stencil"])
def test_backends_match_oracle(rng, method):
    # stencil explicitizes T^{-1}B, whose tail decays at the LHS recurrence
    # rate |r(alpha)| — sharp (large-alpha) filters decay too slowly for a
    # practical band, so exercise it with a soft filter
    alpha = 0.2 if method == "stencil" else 0.45
    sch = get_filter(6, alpha, False)
    g = rng.standard_normal((8, 128))
    ex = derivative_np(sch, g.T, 1.0).T
    got = np.asarray(cfd_tpu.filter_field(jnp.asarray(g), sch, axis=-1, method=method))
    tol = 5e-8 if method == "stencil" else 1e-11
    assert np.abs(got - ex).max() < tol


def test_all_axes_sweep(rng):
    f = rng.standard_normal((32, 32, 32))
    sch = get_filter(4, 0.45, True)
    got = np.asarray(cfd_tpu.filter_field(jnp.asarray(f), sch))
    ex = f
    for ax in (-1, -2, -3):
        ex = np.moveaxis(derivative_np(sch, np.moveaxis(ex, ax, 0), 1.0), 0, ax)
    np.testing.assert_allclose(got, ex, atol=1e-11)


def test_filter_field_rejects_non_filter_scheme():
    with pytest.raises(ValueError, match="not a filter"):
        cfd_tpu.filter_field(jnp.zeros((4, 4, 32)), cfd_tpu.SCHEME4)


def test_get_filter_validates():
    with pytest.raises(ValueError, match="alpha"):
        get_filter(6, 0.6, True)
    with pytest.raises(ValueError, match="order"):
        get_filter(8, 0.4, True)


@pytest.mark.parametrize("periodic", [True, False])
def test_distributed_filter(rng, periodic):
    """Filters ride the distributed substructuring path unchanged."""
    n = 64
    sch = get_filter(6, 0.45, periodic)
    f = rng.standard_normal((n, n, n))
    mesh = make_mesh((1, 1, 8))
    grid = Grid(mesh, (n, n, n), (1.0, 1.0, 1.0), sch)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    got = np.asarray(grid.gather(solver.dfdx(grid.distribute(jnp.asarray(f)))))
    ex = np.moveaxis(derivative_np(sch, np.moveaxis(f, -1, 0), 1.0), 0, -1)
    assert np.abs(got - ex).max() < 1e-10


def test_filter_routing():
    """auto: filters (derivative order 0) take PCR on the CPU and the
    measured order-0 route of each axis class on the GPU."""
    from cfd_tpu.ops.derivatives import _GPU_ROUTES, AXIS_CLASSES, resolve_method

    for cls in AXIS_CLASSES:
        rm = lambda platform: resolve_method(
            "auto", jnp.float32, 256, platform=platform, axis_class=cls,
            scheme=get_filter(),
        )
        assert rm("cpu") == "pcr"
        assert rm("gpu") == _GPU_ROUTES[(cls, "float32", 0)][0]


def test_distributed_filter_field_all_axes(rng):
    from cfd_tpu.parallel import Grid, make_mesh

    n = 32
    sch = get_filter(4, 0.45, True)
    f = rng.standard_normal((n, n, n))
    mesh = make_mesh((2, 2, 2))
    grid = Grid(mesh, (n, n, n), (1.0, 1.0, 1.0), sch)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    got = np.asarray(grid.gather(solver.filter_field(grid.distribute(jnp.asarray(f)))))
    ex = np.asarray(cfd_tpu.filter_field(jnp.asarray(f), sch))
    np.testing.assert_allclose(got, ex, atol=1e-10)
    # apply() is the generic per-axis entry
    got1 = np.asarray(grid.gather(solver.apply(grid.distribute(jnp.asarray(f)), 1)))
    ex1 = np.asarray(cfd_tpu.filter_field(jnp.asarray(f), sch, axis=-2))
    np.testing.assert_allclose(got1, ex1, atol=1e-10)
    # non-filter grids refuse filter_field
    grid_d = Grid(mesh, (n, n, n), (1.0, 1.0, 1.0), cfd_tpu.SCHEME4_PERIODIC)
    sd = cfd_tpu.DistributedCompactSolver(grid_d)
    with pytest.raises(ValueError, match="not a filter"):
        sd.filter_field(grid_d.distribute(jnp.asarray(f)))
