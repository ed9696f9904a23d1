"""Pencil-decomposed spectral solves over the device mesh.

The single-device spectral Poisson/projection (ops/poisson.py) calls
``jnp.fft.rfftn`` on the whole box; under GSPMD a sharded rfftn lowers to
gather-heavy all-to-one data movement. This module implements the classic
**pencil FFT**: per data axis, one ``all_to_all`` over the mesh axes
currently sharding it makes the axis whole (further splitting another
local axis), a local batched 1-D FFT runs at full speed, and the layout is
carried forward — at most three all_to_alls forward, three back, every
collective a balanced exchange of exactly the local block size.

Ordering invariant: when axis ``a`` is gathered over the mesh-axis group
``G`` (ordered coarsest-split first), the lex-ordered concat enumerates
the global coordinates contiguously, because each earlier split subdivided
the shard's contiguous range hierarchically. The plan below tracks
``shards_of[axis]`` as an ordered list to preserve exactly that.

In the final "spectral pencil" layout the z and x frequency axes are whole
and y is sharded over every device; the diagonal multiplier stage slices
its per-axis float64 eigenvalue tables with the shard's lex rank. The
halved (rfft) x axis is never re-split on the forward path — it returns
through the inverse transform where ``irfft`` has already restored ``nx``
— so the usual ``(nx/2+1) % px`` divisibility trap never arises.

Requirements (checked): periodic scheme; ny % (pz*py*px) == 0,
(nz/pz) % (py*px) == 0, (ny/py) % px == 0 for the sharded passes.

Reference lineage: beyond the reference (it has no elliptic solver); the
decomposition mirrors what its LANL CFDNS consumers do with MPI pencil
transposes (npts.c's blktri pencils), rebuilt as shard_map + all_to_all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..ops.poisson import _check_periodic, _kprime_1d
from ..schemes import CompactScheme
from .mesh import Grid

__all__ = ["solve_poisson_sharded", "project_sharded", "pencil_fft3"]


def _fft_plan(proc_shape):
    """Forward pass list ``[(axis, split_axis, group)]`` (x, y, z order)
    plus the final spectral-layout sharding map ``shards_of``."""
    pz, py, px = proc_shape
    shards_of = {
        0: ["z"] if pz > 1 else [],
        1: ["y"] if py > 1 else [],
        2: ["x"] if px > 1 else [],
    }
    plan = []
    for axis, split in ((2, 1), (1, 0), (0, 1)):
        g = tuple(shards_of[axis])
        plan.append((axis, split, g))
        if g:
            shards_of[split] = shards_of[split] + list(g)
            shards_of[axis] = []
    return plan, shards_of


def _fft3_fwd(fl, plan):
    f = fl
    for axis, split, g in plan:
        if g:
            f = lax.all_to_all(
                f, g, split_axis=split, concat_axis=axis, tiled=True
            )
        f = jnp.fft.rfft(f, axis=2) if axis == 2 else jnp.fft.fft(f, axis=axis)
    return f


def _fft3_inv(fh, plan, nx_full):
    f = fh
    for axis, split, g in reversed(plan):
        if axis == 2:
            f = jnp.fft.irfft(f, n=nx_full, axis=2)
        else:
            f = jnp.fft.ifft(f, axis=axis)
        if g:
            f = lax.all_to_all(
                f, g, split_axis=axis, concat_axis=split, tiled=True
            )
    return f


def _lex_rank(group):
    """Lex rank of this shard within the ordered mesh-axis ``group``."""
    r = jnp.int32(0)
    for name in group:
        r = r * lax.axis_size(name) + lax.axis_index(name)
    return r


def _check_divisibility(shape, proc_shape):
    nz, ny, nx = shape
    pz, py, px = proc_shape
    ptot = pz * py * px
    if px > 1 and (ny // py) % px:
        raise ValueError(
            f"pencil FFT needs (ny/py) % px == 0; got ny={ny}, py={py}, px={px}"
        )
    if py * px > 1 and (nz // pz) % (py * px):
        raise ValueError(
            f"pencil FFT needs (nz/pz) % (py*px) == 0; got shape {shape}, "
            f"mesh {proc_shape}"
        )
    if ptot > 1 and ny % ptot:
        raise ValueError(
            f"pencil FFT needs ny % (pz*py*px) == 0; got ny={ny}, mesh "
            f"{proc_shape}"
        )


def pencil_fft3(f: jax.Array, grid: Grid) -> jax.Array:
    """Forward+inverse pencil-FFT round trip of a pencil-sharded field —
    the correctness/diagnostic surface (production paths fuse a multiplier
    stage between the transforms)."""
    _check_divisibility(grid.shape, grid.proc_shape)
    plan, _ = _fft_plan(grid.proc_shape)
    spec = grid.spec()

    def body(fl):
        fh = _fft3_fwd(fl, plan)
        return _fft3_inv(fh, plan, grid.shape[-1]).real.astype(fl.dtype)

    return shard_map(
        body, mesh=grid.mesh, in_specs=(spec,), out_specs=spec,
        check_vma=False,
    )(f)


def _axis_tables(scheme: CompactScheme, shape, spacing):
    """Per-axis float64 multiplier tables (mz (nz,), my (ny,), mx (nxf,))."""
    nz, ny, nx = shape
    dz, dy, dx = spacing
    pw = scheme.derivative_order
    mz = _kprime_1d(scheme, nz, False) / float(dz) ** pw
    my = _kprime_1d(scheme, ny, False) / float(dy) ** pw
    mx = _kprime_1d(scheme, nx, True) / float(dx) ** pw
    return mz, my, mx


def _pencil_slice(table, axis, local_len, shards_of):
    """This shard's slice of a replicated 1-D frequency table in the
    spectral-pencil layout."""
    g = tuple(shards_of[axis])
    if not g:
        return table
    return lax.dynamic_slice_in_dim(
        table, _lex_rank(g) * local_len, local_len, axis=0
    )


def solve_poisson_sharded(
    rhs: jax.Array,
    grid: Grid,
    scheme: CompactScheme = None,
    *,
    mean: float = 0.0,
) -> jax.Array:
    """Sharded-native ``ops.poisson.solve_poisson``: the same discrete
    compact-Laplacian inverse (machine-zero round trip, minimum-norm on
    the d1 null modes), with pencil FFTs + all_to_all transposes instead
    of a GSPMD-partitioned rfftn. ``scheme`` defaults to the grid's."""
    scheme = scheme if scheme is not None else grid.scheme
    _check_periodic(scheme, "solve_poisson_sharded")
    _check_divisibility(grid.shape, grid.proc_shape)
    if rhs.ndim != 3:
        raise ValueError(f"needs a (nz, ny, nx) field, got {rhs.shape}")
    mz, my, mx = _axis_tables(scheme, grid.shape, grid.spacing)
    if scheme.derivative_order == 1:
        lamz, lamy, lamx = -(mz**2), -(my**2), -(mx**2)
    else:
        lamz, lamy, lamx = -mz, -my, -mx
    rdt = jnp.float64 if rhs.dtype == jnp.float64 else jnp.float32
    tz, ty, tx = (jnp.asarray(a, rdt) for a in (lamz, lamy, lamx))
    plan, shards_of = _fft_plan(grid.proc_shape)
    npts = float(np.prod(grid.shape))
    mean = float(mean)
    spec = grid.spec()

    def _owns_zero_mode():
        """Whether this shard's spectral pencil starts at frequency 0 on
        every axis (only such a shard holds the (0,0,0) mode)."""
        own = jnp.bool_(True)
        for axis in (0, 1, 2):
            g = tuple(shards_of[axis])
            if g:
                own = own & (_lex_rank(g) == 0)
        return own

    def body(fl, tz, ty, tx):
        fh = _fft3_fwd(fl, plan)
        lz = _pencil_slice(tz, 0, fh.shape[0], shards_of)
        ly = _pencil_slice(ty, 1, fh.shape[1], shards_of)
        lx = _pencil_slice(tx, 2, fh.shape[2], shards_of)
        lam = (
            lz.reshape(-1, 1, 1) + ly.reshape(1, -1, 1) + lx.reshape(1, 1, -1)
        )
        inv = jnp.where(
            lam != 0.0, 1.0 / jnp.where(lam != 0.0, lam, 1.0), 0.0
        )
        ph = fh * inv.astype(fh.dtype)
        if mean != 0.0:
            mask = jnp.zeros(ph.shape, bool).at[0, 0, 0].set(_owns_zero_mode())
            ph = jnp.where(mask, jnp.asarray(mean * npts, ph.dtype), ph)
        return _fft3_inv(ph, plan, grid.shape[-1]).real.astype(fl.dtype)

    return shard_map(
        body,
        mesh=grid.mesh,
        in_specs=(spec, P(), P(), P()),
        out_specs=spec,
        check_vma=False,
    )(rhs, tz, ty, tx)


def project_sharded(u, grid: Grid, scheme: CompactScheme = None):
    """Sharded-native Helmholtz projection:
    ``u - grad(solve_poisson(div u))`` with the distributed compact
    divergence/gradient and the pencil-FFT Poisson inverse — the
    two-FFT 'compact' form of ops.poisson.project, which needs two
    pencil transforms where the per-mode form needs six.
    ``divergence(project_sharded(u))`` vanishes to rounding, same as the
    single-device projection."""
    from .compact import DistributedCompactSolver

    scheme = scheme if scheme is not None else grid.scheme
    _check_periodic(scheme, "project_sharded")
    if scheme.derivative_order != 1:
        raise ValueError(
            "project needs the derivative_order=1 scheme divergence uses"
        )
    solver = DistributedCompactSolver(grid)
    div = solver.divergence(u)
    p = solve_poisson_sharded(div, grid, scheme)
    gx, gy, gz = solver.gradient(p)
    ux, uy, uz = u
    return ux - gx, uy - gy, uz - gz
