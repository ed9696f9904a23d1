"""Second-derivative schemes (derivative_order=2) across every layer.

The reference library ships first derivatives only; cfd_tpu extends the
same scheme-table machinery to compact second derivatives (Lele 1992 §2.2
interiors, one-sided wall closures solved from the Taylor order
conditions). These tests anchor each backend and the distributed path to a
scipy second-derivative solve at oracle tolerance, and assert the schemes'
convergence orders.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.oracle import derivative_np
from cfd_tpu.parallel import Grid, make_mesh
from cfd_tpu.schemes import (
    SCHEME4_D2,
    SCHEME4_D2_PERIODIC,
    SCHEME6_D2,
    SCHEME6_D2_PERIODIC,
    lhs_bands,
    rhs_matrix,
)

D2_SCHEMES = [SCHEME4_D2, SCHEME6_D2, SCHEME4_D2_PERIODIC, SCHEME6_D2_PERIODIC]
IDS = [s.name for s in D2_SCHEMES]


def _oracle_direct(scheme, f, dx, axis=0):
    """Independent dense solve of T x = B f / dx^2 (numpy only)."""
    f = np.moveaxis(np.asarray(f, np.float64), axis, 0)
    n = f.shape[0]
    dl, d, du = lhs_bands(scheme, n)
    T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    if scheme.periodic:
        T[0, -1] = scheme.alpha
        T[-1, 0] = scheme.alpha
    rhs = rhs_matrix(scheme, n) @ f.reshape(n, -1) / dx**2
    x = np.linalg.solve(T, rhs).reshape(f.shape)
    return np.moveaxis(x, 0, axis)


@pytest.mark.parametrize("scheme", D2_SCHEMES, ids=IDS)
def test_oracle_matches_direct_solve(rng, scheme):
    f = rng.standard_normal((24, 40))
    got = derivative_np(scheme, f, 0.05)
    ex = _oracle_direct(scheme, f, 0.05)
    np.testing.assert_allclose(got, ex, atol=1e-10)


@pytest.mark.parametrize("scheme", D2_SCHEMES, ids=IDS)
@pytest.mark.parametrize("method", ["pcr", "thomas", "matmul"])
def test_backends_match_oracle(rng, scheme, method):
    f = rng.standard_normal((6, 8, 48))
    dx = 0.04
    ex = derivative_np(scheme, f, dx, axis=-1)
    got = np.asarray(cfd_tpu.derivative(jnp.asarray(f), dx, scheme, axis=-1, method=method))
    np.testing.assert_allclose(got, ex, atol=1e-9)


@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_axis_aware(rng, axis):
    f = rng.standard_normal((16, 20, 24))
    dx = 0.07
    ex = derivative_np(SCHEME6_D2, f, dx, axis=axis)
    got = np.asarray(
        cfd_tpu.derivative(jnp.asarray(f), dx, SCHEME6_D2, axis=axis, method="pcr")
    )
    np.testing.assert_allclose(got, ex, atol=1e-9)


def test_stencil_backend(rng):
    f = rng.standard_normal((4, 6, 96))
    dx = 0.04
    for scheme in (SCHEME4_D2, SCHEME4_D2_PERIODIC, SCHEME6_D2_PERIODIC):
        ex = derivative_np(scheme, f, dx, axis=-1)
        got = np.asarray(
            cfd_tpu.derivative(jnp.asarray(f), dx, scheme, axis=-1, method="stencil")
        )
        # banded truncation of the dense operator bounds this path at ~tol
        assert np.abs(got - ex).max() / np.abs(ex).max() < 5e-8


@pytest.mark.parametrize(
    "scheme,min_rate",
    [
        (SCHEME4_D2, 2.8),
        (SCHEME6_D2, 4.7),
        (SCHEME4_D2_PERIODIC, 3.9),
        (SCHEME6_D2_PERIODIC, 5.7),
    ],
    ids=IDS,
)
def test_convergence_order(scheme, min_rate):
    """d2/dx2 sin = -sin under grid refinement, through the device path.

    Periodic interiors converge at the nominal order (4/6); wall-closed
    schemes are boundary-row limited in max norm (3rd/5th-order one-sided
    rows), matching the standard compact-closure behaviour."""
    errs = []
    for n in (32, 64, 128):
        if scheme.periodic:
            dx = 2 * math.pi / n
        else:
            dx = 2 * math.pi / (n - 1)
        x = np.arange(n) * dx
        got = np.asarray(
            cfd_tpu.d2fdx2(jnp.asarray(np.sin(x)[None, None, :]), dx, scheme)
        )[0, 0]
        errs.append(np.abs(got + np.sin(x)).max())
    rates = [math.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(rates) > min_rate, (errs, rates)


def test_laplacian_periodic():
    n = 32
    dx = 2 * math.pi / n
    x = np.arange(n) * dx
    f = (
        np.sin(x)[None, None, :]
        + np.cos(x)[None, :, None]
        + np.sin(2 * x)[:, None, None]
    ) * np.ones((n, n, n))
    ex = -(
        np.sin(x)[None, None, :]
        + np.cos(x)[None, :, None]
        + 4 * np.sin(2 * x)[:, None, None]
    )
    lap = np.asarray(
        cfd_tpu.laplacian(jnp.asarray(f), dx, cfd_tpu.SCHEME4_D2_PERIODIC)
    )
    assert np.abs(lap - ex).max() / np.abs(ex).max() < 1e-4  # truncation
    lap6 = np.asarray(
        cfd_tpu.laplacian(jnp.asarray(f), dx, cfd_tpu.SCHEME6_D2_PERIODIC)
    )
    assert np.abs(lap6 - ex).max() / np.abs(ex).max() < 2e-6


def test_d2_rejects_first_derivative_scheme():
    f = jnp.zeros((4, 4, 32))
    with pytest.raises(ValueError, match="derivative_order"):
        cfd_tpu.d2fdx2(f, 0.1, cfd_tpu.SCHEME4)
    with pytest.raises(ValueError, match="derivative_order"):
        cfd_tpu.laplacian(f, 0.1, cfd_tpu.SCHEME6)


def test_d2_routing():
    """auto: the CPU takes PCR; the GPU takes the measured d2 route of each
    axis class, and the dense operator below the measured line lengths."""
    from cfd_tpu.ops.derivatives import _GPU_ROUTES, AXIS_CLASSES, resolve_method

    for cls in AXIS_CLASSES:
        rm = lambda platform, n=256: resolve_method(
            "auto", jnp.float32, n, platform=platform, axis_class=cls,
            scheme=cfd_tpu.SCHEME4_D2,
        )
        assert rm("cpu") == "pcr"
        assert rm("gpu") == _GPU_ROUTES[(cls, "float32", 2)][0]
        assert rm("gpu", n=64) == "matmul"


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 1, 8)])
@pytest.mark.parametrize("scheme", D2_SCHEMES, ids=IDS)
def test_distributed_d2(rng, scheme, mesh_shape):
    """Distributed second derivatives: halo + substructuring are RHS-form
    agnostic, so the d2 schemes ride the same collective path at 1e-10."""
    n = 64
    dx = 2 * math.pi / n
    f = rng.standard_normal((n, n, n))
    mesh = make_mesh(mesh_shape)
    grid = Grid(mesh, (n, n, n), (dx, dx, dx), scheme)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    fd = grid.distribute(jnp.asarray(f))
    for fn, ax in [(solver.dfdx, 2), (solver.dfdz, 0)]:
        got = np.asarray(grid.gather(fn(fd)))
        ex = derivative_np(scheme, f, dx, axis=ax)
        assert np.abs(got - ex).max() / np.abs(ex).max() < 1e-9


def test_autodiff_through_d2():
    n = 32
    dx = 2 * math.pi / n
    x = np.arange(n) * dx
    f = jnp.asarray(np.sin(x)[None, None, :] * np.ones((4, 4, 1)))

    # d2/dx2 is linear: grad of sum(d2f) == d2 of ones' adjoint — just check
    # it differentiates cleanly and the JVP equals the op on the tangent
    g = jax.grad(lambda a: cfd_tpu.d2fdx2(a, dx, SCHEME4_D2_PERIODIC).sum())(f)
    assert np.isfinite(np.asarray(g)).all()
    t = jnp.ones_like(f)
    _, jvp = jax.jvp(
        lambda a: cfd_tpu.d2fdx2(a, dx, SCHEME4_D2_PERIODIC), (f,), (t,)
    )
    ex = cfd_tpu.d2fdx2(t, dx, SCHEME4_D2_PERIODIC)
    np.testing.assert_allclose(np.asarray(jvp), np.asarray(ex), atol=1e-10)
