"""Distributed-layer tests on the virtual 8-device CPU mesh.

The honest analogue of the reference's real-MPI-rank tests
(code/cuda/test/test_gpuDA/*, test_compact.py on 2x2x2 ranks): every test
here runs real multi-device programs with real collectives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import cfd_tpu
from cfd_tpu.oracle import derivative_np
from cfd_tpu.parallel import Grid, exchange_1d, halo_slices, make_mesh
from cfd_tpu.schemes import (
    SCHEME4,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_PERIODIC,
)

ALL_SCHEMES = [SCHEME4, SCHEME6, SCHEME4_PERIODIC, SCHEME6_PERIODIC]
IDS = [s.name for s in ALL_SCHEMES]


def _mesh(shape):
    return make_mesh(shape)


# ---------------------------------------------------------------------------
# halo exchange (reference: test_gpuDA/test_1d.py, test_3d.py, test_sw.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_exchange_1d(width, periodic):
    mesh = _mesh((1, 1, 8))
    n = 32
    f = jnp.arange(n, dtype=jnp.float64)

    def body(fl):
        left, right = halo_slices(fl, "x", width, periodic)
        return jnp.concatenate([left, right])

    out = shard_map(
        body, mesh=mesh, in_specs=P("x"), out_specs=P("x")
    )(f)
    out = np.asarray(out).reshape(8, 2 * width)
    nl = n // 8
    for r in range(8):
        left, right = out[r, :width], out[r, width:]
        if r > 0:
            np.testing.assert_array_equal(left, np.arange(r * nl - width, r * nl))
        elif periodic:
            np.testing.assert_array_equal(left, np.arange(n - width, n))
        else:
            np.testing.assert_array_equal(left, 0)  # untouched edge
        if r < 7:
            np.testing.assert_array_equal(
                right, np.arange((r + 1) * nl, (r + 1) * nl + width)
            )
        elif periodic:
            np.testing.assert_array_equal(right, np.arange(width))
        else:
            np.testing.assert_array_equal(right, 0)


def test_exchange_1d_extends():
    mesh = _mesh((1, 1, 4))
    f = jnp.arange(16, dtype=jnp.float64)

    def body(fl):
        return exchange_1d(fl, "x", 1, True)

    out = shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))(f)
    # each shard contributes 1+4+1 = 6 rows
    out = np.asarray(out).reshape(4, 6)
    np.testing.assert_array_equal(out[1], [3, 4, 5, 6, 7, 8])
    np.testing.assert_array_equal(out[0], [15, 0, 1, 2, 3, 4])


# ---------------------------------------------------------------------------
# Grid / mesh plumbing
# ---------------------------------------------------------------------------


def test_grid_properties():
    mesh = _mesh((2, 2, 2))
    g = Grid(mesh, (16, 32, 64), (0.1, 0.2, 0.3))
    assert g.local_shape == (8, 16, 32)
    assert g.proc_shape == (2, 2, 2)
    z, y, x = g.coordinates()
    assert x.shape == (64,) and float(x[1] - x[0]) == pytest.approx(0.3)


def test_grid_divisibility_error():
    mesh = _mesh((2, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        Grid(mesh, (15, 32, 64), (0.1, 0.2, 0.3))


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError, match="devices"):
        make_mesh((4, 4, 4))


# ---------------------------------------------------------------------------
# distributed derivative vs float64 oracle
# ---------------------------------------------------------------------------


def _dist_check(scheme, mesh_shape, shape=(16, 16, 32), tol=1e-10):
    mesh = _mesh(mesh_shape)
    spacing = (0.11, 0.07, 0.05)
    grid = Grid(mesh, shape, spacing, scheme)
    rng = np.random.default_rng(7)
    f = rng.standard_normal(shape)
    fj = grid.distribute(jnp.asarray(f))
    solver = cfd_tpu.DistributedCompactSolver(grid)
    for axis, fn in ((2, solver.dfdx), (1, solver.dfdy), (0, solver.dfdz)):
        got = np.asarray(fn(fj))
        expect = derivative_np(scheme, f, spacing[axis], axis=axis)
        np.testing.assert_allclose(
            got, expect, rtol=tol, atol=tol, err_msg=f"axis={axis}"
        )


@pytest.mark.parametrize("scheme", ALL_SCHEMES, ids=IDS)
def test_distributed_vs_oracle_2x2x2(scheme):
    _dist_check(scheme, (2, 2, 2))


@pytest.mark.parametrize("scheme", [SCHEME4, SCHEME4_PERIODIC], ids=["p4", "p4per"])
def test_distributed_vs_oracle_1x1x8(scheme):
    # deep line decomposition: 8 shards over a 64-point line
    _dist_check(scheme, (1, 1, 8), shape=(4, 4, 64))


def test_distributed_vs_oracle_1x8x1():
    _dist_check(SCHEME6, (1, 8, 1), shape=(8, 64, 8))


def test_distributed_vs_oracle_8x1x1():
    _dist_check(SCHEME4, (8, 1, 1), shape=(64, 4, 8))


def test_distributed_irregular_local_blocks():
    # reference tests 64x32x32 local blocks on 2x2x2 (test_compact.py:33-59)
    _dist_check(SCHEME4, (2, 2, 2), shape=(8, 16, 64))


def test_distributed_sin_cos_analytic():
    mesh = _mesh((2, 2, 2))
    n = 64
    L = 2 * np.pi
    dx = L / n
    grid = Grid(mesh, (n, n, n), (dx, dx, dx), SCHEME4_PERIODIC)
    z, y, x = np.meshgrid(
        np.arange(n) * dx, np.arange(n) * dx, np.arange(n) * dx, indexing="ij"
    )
    f = np.sin(x)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    got = np.asarray(solver.dfdx(grid.distribute(jnp.asarray(f))))
    assert np.max(np.abs(got - np.cos(x))) < 1e-6


def test_distributed_gradient_divergence_curl():
    mesh = _mesh((2, 2, 2))
    shape = (16, 16, 16)
    grid = Grid(mesh, shape, (0.1, 0.1, 0.1), SCHEME4)
    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.standard_normal(shape))
    fj = grid.distribute(f)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    gx, gy, gz = solver.gradient(fj)
    # compare against the single-device path
    np.testing.assert_allclose(
        np.asarray(gx), np.asarray(cfd_tpu.dfdx(f, 0.1)), rtol=1e-10, atol=1e-11
    )
    div = solver.divergence((fj, fj, fj))
    np.testing.assert_allclose(
        np.asarray(div),
        np.asarray(gx) + np.asarray(gy) + np.asarray(gz),
        rtol=1e-10,
        atol=1e-11,
    )
    cx, cy, cz = solver.curl((fj, fj, fj))
    np.testing.assert_allclose(
        np.asarray(cx), np.asarray(gy) - np.asarray(gz), rtol=1e-10, atol=1e-10
    )


def test_distributed_jit_end_to_end():
    mesh = _mesh((1, 2, 4))
    shape = (4, 16, 32)
    grid = Grid(mesh, shape, (0.1, 0.1, 0.1), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    rng = np.random.default_rng(5)
    f = rng.standard_normal(shape)
    fj = grid.distribute(jnp.asarray(f))
    fn = jax.jit(lambda g: solver.dfdx(g) + solver.dfdy(g))
    got = np.asarray(fn(fj))
    expect = derivative_np(SCHEME4, f, 0.1, axis=2) + derivative_np(
        SCHEME4, f, 0.1, axis=1
    )
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("scheme", [SCHEME4, SCHEME6_PERIODIC], ids=["p4", "p6per"])
def test_distributed_matmul_method(scheme):
    # the dense-operator local solve, forced on the CPU mesh
    mesh = _mesh((1, 1, 4))
    shape = (8, 8, 32)
    spacing = (0.1, 0.1, 0.05)
    grid = Grid(mesh, shape, spacing, scheme)
    solver = cfd_tpu.DistributedCompactSolver(grid, method="matmul")
    rng = np.random.default_rng(13)
    f = rng.standard_normal(shape)
    got = np.asarray(solver.dfdx(grid.distribute(jnp.asarray(f))))
    expect = derivative_np(scheme, f, spacing[2], axis=2)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)


def test_exchange_3d_corners():
    from cfd_tpu.parallel.halo import exchange_3d

    mesh = _mesh((2, 2, 2))
    g = Grid(mesh, (8, 8, 8), (1.0, 1.0, 1.0))
    f = np.arange(512, dtype=np.float64).reshape(8, 8, 8)
    fj = g.distribute(jnp.asarray(f))
    out = np.asarray(
        shard_map(
            lambda fl: exchange_3d(fl, 1, (True, True, True)),
            mesh=mesh,
            in_specs=P("z", "y", "x"),
            out_specs=P("z", "y", "x"),
        )(fj)
    )
    blk = out[:6, :6, :6]  # shard (0,0,0) extended block
    np.testing.assert_array_equal(blk[1:5, 1:5, 1:5], f[0:4, 0:4, 0:4])
    np.testing.assert_array_equal(blk[1:5, 1:5, 0], f[0:4, 0:4, 7])  # x wrap
    assert blk[0, 0, 0] == f[7, 7, 7]  # corner wrap, all three axes


def test_exchange_3d_open_edges_zero():
    from cfd_tpu.parallel.halo import exchange_3d

    mesh = _mesh((2, 2, 2))
    g = Grid(mesh, (8, 8, 8), (1.0, 1.0, 1.0))
    f = jnp.ones((8, 8, 8), jnp.float64)
    out = np.asarray(
        shard_map(
            lambda fl: exchange_3d(fl, 1, (False, False, False)),
            mesh=mesh,
            in_specs=P("z", "y", "x"),
            out_specs=P("z", "y", "x"),
        )(g.distribute(f))
    )
    assert out[0, 1, 1] == 0.0  # open z edge ghost untouched (zero)
    assert out[1, 1, 1] == 1.0


def test_grid_gather_roundtrip(rng):
    mesh = _mesh((2, 2, 2))
    g = Grid(mesh, (8, 8, 8), (1.0, 1.0, 1.0))
    f = rng.standard_normal((8, 8, 8))
    np.testing.assert_array_equal(g.gather(g.distribute(jnp.asarray(f))), f)


def test_direction_tables_rejects_tiny_blocks():
    from cfd_tpu.parallel.compact import direction_tables

    with pytest.raises(ValueError, match="closure stencil|too small"):
        direction_tables(SCHEME6, 32, 8)  # nl=4 < 6-point closure
    with pytest.raises(ValueError, match="not divisible"):
        direction_tables(SCHEME4, 30, 4)


def test_profile_dfdx_phases():
    mesh = _mesh((1, 1, 4))
    grid = Grid(mesh, (4, 8, 32), (0.1, 0.1, 0.05), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    f = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8, 32)))
    t = solver.profile_dfdx(f, verbose=False)
    assert {"rhs_and_primary_solve", "reduced_system", "sum_solutions", "full_derivative"} <= set(t)
    assert all(v > 0 for v in t.values())


def test_distributed_large_grid_f32():
    """256^3 distributed derivative on the full 8-device mesh (f32) — the
    scaled-up honest analogue of the reference's multi-GPU benchmark runs."""
    n = 256
    dx = 2 * np.pi / n
    mesh = _mesh((2, 2, 2))
    grid = Grid(mesh, (n, n, n), (dx, dx, dx), SCHEME4_PERIODIC)
    x = (np.arange(n) * dx).astype(np.float32)
    f = grid.distribute(jnp.asarray(np.broadcast_to(np.sin(x), (n, n, n)).copy()))
    solver = cfd_tpu.DistributedCompactSolver(grid)
    err = float(jnp.max(jnp.abs(solver.dfdx(f) - jnp.cos(jnp.asarray(x)))))
    assert err < 5e-5, err


def test_distributed_bf16_field():
    """bf16 fields are upcast internally; distributed result ~bf16 accuracy
    and consistent between p=1 and p>1 paths (review finding)."""
    mesh = _mesh((1, 1, 4))
    shape = (4, 8, 64)
    grid = Grid(mesh, shape, (0.1, 0.1, 0.05), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid, method="pcr")
    rng = np.random.default_rng(17)
    f64 = rng.standard_normal(shape)
    f = jnp.asarray(f64, jnp.bfloat16)
    got = solver.dfdx(grid.distribute(f))
    assert got.dtype == jnp.bfloat16
    ref = derivative_np(SCHEME4, np.asarray(f, np.float64), 0.05, axis=2)
    rel = np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref))
    assert rel < 0.05, rel


def test_exchange_3d_width2():
    from cfd_tpu.parallel.halo import exchange_3d

    mesh = _mesh((2, 2, 2))
    g = Grid(mesh, (8, 8, 8), (1.0, 1.0, 1.0))
    f = np.arange(512, dtype=np.float64).reshape(8, 8, 8)
    out = np.asarray(
        shard_map(
            lambda fl: exchange_3d(fl, 2, (True, True, True)),
            mesh=mesh,
            in_specs=P("z", "y", "x"),
            out_specs=P("z", "y", "x"),
        )(g.distribute(jnp.asarray(f)))
    )
    blk = out[:8, :8, :8]  # shard (0,0,0): local 4 + 2 halo each side
    np.testing.assert_array_equal(blk[2:6, 2:6, 2:6], f[0:4, 0:4, 0:4])
    np.testing.assert_array_equal(blk[2:6, 2:6, 0], f[0:4, 0:4, 6])  # x wrap -2


def test_distributed_shape_mismatch():
    mesh = _mesh((1, 1, 2))
    grid = Grid(mesh, (4, 4, 16), (0.1, 0.1, 0.1), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    with pytest.raises(ValueError, match="grid shape"):
        solver.dfdx(jnp.zeros((4, 4, 8)))


def test_profile_dfdx_unsharded_x():
    # regression: profile_dfdx crashed with KeyError when x was unsharded
    mesh = _mesh((2, 2, 1))
    grid = Grid(mesh, (8, 8, 16), (0.1, 0.1, 0.05), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    f = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8, 16)))
    t = solver.profile_dfdx(f, verbose=False)
    assert t["full_derivative"] > 0


def test_distributed_bf16_unsharded_axis():
    # bf16 upcast applies on the p==1 branch too (accuracy must not depend
    # on which mesh axis the derivative crosses)
    rng = np.random.default_rng(21)
    f64 = rng.standard_normal((8, 8, 64))
    ref = derivative_np(SCHEME4, f64, 0.05, axis=2)

    def run(mesh_shape):
        mesh = _mesh(mesh_shape)
        grid = Grid(mesh, (8, 8, 64), (0.1, 0.1, 0.05), SCHEME4)
        s = cfd_tpu.DistributedCompactSolver(grid, method="pcr")
        got = s.dfdx(grid.distribute(jnp.asarray(f64, jnp.bfloat16)))
        return np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref))

    rel_sharded = run((1, 1, 8))
    rel_unsharded = run((8, 1, 1))
    assert rel_unsharded < 2 * rel_sharded + 1e-3, (rel_unsharded, rel_sharded)


def test_distributed_thomas_method():
    mesh = _mesh((1, 1, 4))
    grid = Grid(mesh, (4, 8, 32), (0.1, 0.1, 0.05), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid, method="thomas")
    rng = np.random.default_rng(23)
    f = rng.standard_normal((4, 8, 32))
    got = np.asarray(solver.dfdx(grid.distribute(jnp.asarray(f))))
    np.testing.assert_allclose(
        got, derivative_np(SCHEME4, f, 0.05, axis=2), rtol=1e-10, atol=1e-11
    )


def test_distributed_batched_field_rejected():
    mesh = _mesh((1, 1, 2))
    grid = Grid(mesh, (4, 4, 16), (0.1, 0.1, 0.1), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    with pytest.raises(ValueError, match="grid shape"):
        solver.dfdx(jnp.zeros((2, 4, 4, 16)))  # leading batch dim unsupported


def test_distributed_xyz_field_like_reference():
    """The reference's second integration case: f = x*y*z on 2x2x2 ranks,
    dfdx must equal y*z (code/cuda/test/test_compact.py:33-59) — here at
    1e-10 instead of decimal=2."""
    n = 32
    mesh = _mesh((2, 2, 2))
    spacing = (1.0 / (n - 1), 1.0 / (n - 1), 1.0 / (n - 1))
    grid = Grid(mesh, (n, n, n), spacing, SCHEME4)
    z, y, x = np.meshgrid(
        np.linspace(0, 1, n), np.linspace(0, 1, n), np.linspace(0, 1, n),
        indexing="ij",
    )
    f = x * y * z
    solver = cfd_tpu.DistributedCompactSolver(grid)
    got = np.asarray(solver.dfdx(grid.distribute(jnp.asarray(f))))
    np.testing.assert_allclose(got, y * z, rtol=1e-9, atol=1e-10)
    got_y = np.asarray(solver.dfdy(grid.distribute(jnp.asarray(f))))
    np.testing.assert_allclose(got_y, x * z, rtol=1e-9, atol=1e-10)


def test_distributed_thomas_aliases_pcr():
    # method='thomas' has no distributed scan variant; it must run the PCR
    # tables and stay oracle-exact rather than silently diverging
    n = 32
    grid = Grid(_mesh((2, 2, 2)), (n, n, n), (0.1, 0.1, 0.1), SCHEME4)
    f = jnp.sin(jnp.arange(n) * 0.1)
    f = grid.distribute(jnp.broadcast_to(f, (n, n, n)))
    got = cfd_tpu.DistributedCompactSolver(grid, method="thomas").dfdx(f)
    ref = cfd_tpu.DistributedCompactSolver(grid, method="pcr").dfdx(f)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_profile_derivative_all_axes(axis, capsys):
    # the per-phase profiler must work for every direction (round 1's was
    # x-only with a hardcoded output spec)
    n = 32
    d = 2 * np.pi / n
    grid = Grid(_mesh((2, 2, 2)), (n, n, n), (d, d, d), SCHEME4)
    c = jnp.arange(n, dtype=jnp.float32) * d
    f = grid.distribute(jnp.broadcast_to(jnp.sin(c), (n, n, n)))
    solver = cfd_tpu.DistributedCompactSolver(grid)
    timings = solver.profile_derivative(f, axis=axis, verbose=False)
    assert set(timings) == {
        "rhs_and_primary_solve",
        "reduced_system",
        "sum_solutions",
        "full_derivative",
    }
    assert all(v >= 0 for v in timings.values())


# ---------------------------------------------------------------------------
# phi/psi distributed algorithm (the reference's second method, npts.c)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 1, 8)])
@pytest.mark.parametrize("scheme", [SCHEME4, SCHEME6], ids=["pade4", "lele6"])
def test_phipsi_matches_oracle_f64(mesh_shape, scheme):
    n = 64  # 8 shards of lele6 need nl >= its 6-point closure stencil
    d = 0.07
    grid = Grid(_mesh(mesh_shape), (n, n, n), (d, d, d), scheme)
    f = np.random.default_rng(3).standard_normal((n, n, n))
    fj = grid.distribute(jnp.asarray(f))
    solver = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    got = np.asarray(solver.dfdx(fj))
    expect = derivative_np(scheme, f, d, axis=-1)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)
    # cross-validate the two distributed algorithms against each other
    sub = np.asarray(cfd_tpu.DistributedCompactSolver(grid, method="pcr").dfdx(fj))
    np.testing.assert_allclose(got, sub, rtol=1e-10, atol=1e-11)


def test_phipsi_dfdy_dfdz_f32():
    n = 32
    d = 2 * np.pi / n
    grid = Grid(_mesh((2, 2, 2)), (n, n, n), (d, d, d), SCHEME4)
    c = np.arange(n) * d
    f = np.broadcast_to(np.sin(c)[None, :, None], (n, n, n)).astype(np.float32)
    fj = grid.distribute(jnp.asarray(f))
    solver = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    got = np.asarray(solver.dfdy(fj))
    expect = derivative_np(SCHEME4, np.asarray(f, np.float64), d, axis=-2)
    assert np.abs(got - expect).max() / np.abs(expect).max() < 1e-5


def test_phipsi_rejects_periodic():
    n = 32
    d = 0.1
    grid = Grid(_mesh((2, 2, 2)), (n, n, n), (d, d, d), SCHEME4_PERIODIC)
    f = grid.distribute(jnp.zeros((n, n, n)))
    solver = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    with pytest.raises(ValueError, match="non-periodic"):
        solver.dfdx(f)


def test_phipsi_single_shard_axis():
    # p == 1 along the differentiated axis falls back to the local solver
    n = 32
    d = 0.05
    grid = Grid(_mesh((8, 1, 1)), (n, n, n), (d, d, d), SCHEME4)
    f = np.random.default_rng(4).standard_normal((n, n, n))
    fj = grid.distribute(jnp.asarray(f))
    solver = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    got = np.asarray(solver.dfdx(fj))
    expect = derivative_np(SCHEME4, f, d, axis=-1)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)


def test_solver_reuses_compiled_program():
    """Eager calls reuse one jitted program per (axis, dtype)."""
    n = 16
    grid = Grid(_mesh((2, 2, 2)), (n, n, n), (0.1, 0.1, 0.1), SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    f = grid.distribute(jnp.ones((n, n, n)))
    a = solver.dfdx(f)
    b = solver.dfdx(2.0 * f)
    assert len(solver._programs) == 1
    np.testing.assert_allclose(np.asarray(b), 2.0 * np.asarray(a), rtol=1e-12)
    solver.dfdz(f)
    solver.dfdx(f.astype(jnp.float32))
    assert len(solver._programs) == 3


@pytest.mark.parametrize(
    "platform,n_local,expected",
    [("cpu", 256, "pcr"), ("gpu", 64, "matmul"), ("gpu", 256, None)],
)
def test_distributed_local_route(monkeypatch, platform, n_local, expected):
    """'auto' on a sharded line: PCR on the CPU; on the GPU the dense block
    inverse where the whole-line table picks a dense or stencil route."""
    from cfd_tpu.ops.derivatives import _GPU_ROUTES

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    grid = Grid(_mesh((1, 1, 2)), (8, 8, 2 * n_local), (0.1,) * 3, SCHEME4)
    got = cfd_tpu.DistributedCompactSolver(grid)._local_method("float32", n_local)
    if expected is None:
        table = _GPU_ROUTES[("leading", "float32", 1)][0]
        expected = "matmul" if table in ("matmul", "stencil") else "pcr"
    assert got == expected
    # sharded lines have no scan-based local solve: 'thomas' runs PCR there
    assert (
        cfd_tpu.DistributedCompactSolver(grid, method="thomas")._local_method(
            "float32", n_local
        )
        == "pcr"
    )
