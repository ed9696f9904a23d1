"""Distributed compact derivatives: substructuring over a device mesh.

A rebuild of the reference's distributed tridiagonal algorithm
(/root/reference/code/cuda/compact.py:29-154): each shard solves its local
truncated block system, two precomputed unit-load ("upper/lower halo")
solutions carry the inter-shard couplings, and a small reduced interface
system determines the per-shard combination weights

    x = x_R + alpha * x_UH + beta * x_LH        (compact.py:53-61)

Differences from the reference, by design:

* The reduced system is solved **redundantly on every shard** from an
  ``all_gather`` of interface faces over the line's mesh axis — no
  gather-to-rank-0 + compute + scatter hop (compact.py:77-122), which their
  own 64-rank logs show serializing (`solve_reduced_system` dominating,
  SURVEY.md §3.2).
* The reduced solve is a dense (2, 2p) x (2p, batch) matmul against
  precomputed rows of the reduced-matrix inverse — pivoted at setup time in
  float64, and each shard only ever computes its own (alpha, beta) rows.
* Secondary (unit-load) systems are solved once at setup in float64 numpy
  (the reference re-solves them on the host with scipy every call,
  compact.py:128-154).
* Boundary closures ride in ghost rows, so the RHS stencil is uniform
  across shards; halo faces move with one ``ppermute`` per direction.
* Periodic lines need no special casing beyond a cyclic reduced matrix —
  the corner couplings close the ring of blocks.
"""

from __future__ import annotations

import dataclasses
import functools


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops import tridiag
from ..ops.rhs import closure_ghosts, stencil_rhs
from ..schemes import CompactScheme, lhs_bands
from .halo import halo_slices
from .mesh import AXIS_NAMES, Grid

__all__ = ["DistributedCompactSolver", "direction_tables", "DirectionTables"]


@dataclasses.dataclass(frozen=True)
class DirectionTables:
    """Host-precomputed per-rank tables for one decomposed direction.

    All arrays are numpy float64, stacked over the p shards of the line:

    * ``k1, k2, invb``   — PCR tables of each rank's local block, (p, L, nl)
                           and (p, nl)
    * ``tinv``           — dense inverses of the local blocks, (p, nl, nl)
                           (consumed by the 'matmul' path)
    * ``uh, lh``         — unit-load secondary solutions, (p, nl)
    * ``rinv_rows``      — own rows of the reduced-matrix inverse, (p, 2, 2p)
    """

    k1: np.ndarray
    k2: np.ndarray
    invb: np.ndarray
    tinv: np.ndarray
    uh: np.ndarray
    lh: np.ndarray
    rinv_rows: np.ndarray

    @staticmethod
    def fields_for(method: str):
        """Field names a given local-solve method actually consumes —
        shipping the rest (e.g. the (p, nl, nl) dense inverses on the PCR
        path) would waste transfer and device memory."""
        common = ("uh", "lh", "rinv_rows")
        per_method = {
            "pcr": ("k1", "k2", "invb"),
            "matmul": ("tinv",),
        }
        return per_method[method] + common


@functools.lru_cache(maxsize=None)
def direction_tables(scheme: CompactScheme, n: int, p: int) -> DirectionTables:
    """Precompute all rank-dependent tables for a line of global length
    ``n`` split over ``p`` shards."""
    if n % p:
        raise ValueError(f"global extent {n} not divisible by mesh axis {p}")
    nl = n // p
    if not scheme.periodic and scheme.left_rows:
        widest = max(len(r.rhs_stencil) for r in scheme.left_rows)
        if nl < widest:
            raise ValueError(
                f"local extent {nl} shorter than the closure stencil "
                f"({widest} points) of scheme {scheme.name}; use fewer shards"
            )
    if nl < 2 * scheme.stencil_width + 1:
        raise ValueError(
            f"local extent {nl} too small for stencil width "
            f"{scheme.stencil_width} (need >= {2 * scheme.stencil_width + 1})"
        )
    periodic = scheme.periodic
    alpha = scheme.alpha

    k1s, k2s, invbs, tinvs, uhs, lhs_ = [], [], [], [], [], []
    for r in range(p):
        first = (r == 0) and not periodic
        last = (r == p - 1) and not periodic
        bands = lhs_bands(scheme, nl, first_block=first, last_block=last)
        pf = tridiag.pcr_factor(*bands)
        k1s.append(pf.k1)
        k2s.append(pf.k2)
        invbs.append(pf.invb)
        dl_, d_, du_ = bands
        T = np.diag(d_) + np.diag(dl_[1:], -1) + np.diag(du_[:-1], 1)
        tinvs.append(np.linalg.inv(T))
        # unit-load secondary systems (compact.py:128-154): the coupling of
        # this block's first/last row to its neighbours is the interior
        # off-diagonal alpha; closure rows at physical ends have none.
        # p == 1 periodic is the single-block case (one block cyclically
        # coupled to ITSELF): the self-coupling solutions and the 2x2 cyclic reduced system are
        # real there, so only non-periodic physical ends zero them.
        e = np.zeros(nl)
        if periodic or r > 0:
            e[0] = -alpha
            uhs.append(tridiag._thomas_solve_np(*bands, e))
            e[0] = 0.0
        else:
            uhs.append(np.zeros(nl))
        if periodic or r < p - 1:
            e[-1] = -alpha
            lhs_.append(tridiag._thomas_solve_np(*bands, e))
        else:
            lhs_.append(np.zeros(nl))

    uh = np.stack(uhs)
    lh = np.stack(lhs_)

    # reduced interface matrix over unknowns [alpha_0, beta_0, ..., beta_{p-1}]
    m = 2 * p
    R = np.zeros((m, m))
    for r in range(p):
        er, orow = 2 * r, 2 * r + 1
        # entries ACCUMULATE: at p == 1 periodic the cyclic neighbour is
        # the block itself, so the -1 coupling terms land on the same
        # entries as the uh/lh terms (plain assignment would overwrite)
        # even row: -t_r + UH_r^f alpha_r + LH_r^f beta_r = -x_R^f,
        # where t_r = beta_{r-1} = u[2r-1] (cyclically for periodic)
        R[er, er] += uh[r, 0]
        R[er, orow] += lh[r, 0]
        if r > 0:
            R[er, er - 1] += -1.0
        elif periodic:
            R[er, m - 1] += -1.0
        # odd row: UH_r^l alpha_r + LH_r^l beta_r - t_{r+1} = -x_R^l,
        # where t_{r+1} = alpha_{r+1} = u[2r+2]
        R[orow, er] += uh[r, -1]
        R[orow, orow] += lh[r, -1]
        if r < p - 1:
            R[orow, orow + 1] += -1.0
        elif periodic:
            R[orow, 0] += -1.0
    if not periodic:
        # physical ends: alpha_0 = 0, beta_{p-1} = 0 (identity rows, the
        # analogue of the reference's kernels.cu:106-111)
        R[0, :] = 0.0
        R[0, 0] = 1.0
        R[m - 1, :] = 0.0
        R[m - 1, m - 1] = 1.0
    if p == 1 and not periodic:
        rinv_rows = np.zeros((1, 2, 2))
    else:
        rinv = np.linalg.inv(R)
        rinv_rows = np.stack([rinv[2 * r : 2 * r + 2, :] for r in range(p)])

    return DirectionTables(
        k1=np.stack(k1s),
        k2=np.stack(k2s),
        invb=np.stack(invbs),
        tinv=np.stack(tinvs),
        uh=uh,
        lh=lh,
        rinv_rows=rinv_rows,
    )


def _local_solve_pcr(k1, k2, invb, rhs):
    """PCR with traced per-rank tables; rhs (nl, *batch)."""
    return tridiag.pcr_solve(tridiag.PCRFactors(k1=k1, k2=k2, invb=invb), rhs)


def _dist_lines(
    fl,
    tables,
    *,
    scheme: CompactScheme,
    axis_name: str,
    p: int,
    inv_dx,
    method: str,
):
    """Distributed derivative of shard-local lines ``fl`` (nl, *batch).

    Runs inside shard_map; ``tables`` is a dict of the shard's (1, ...)
    slices of the stacked DirectionTables arrays (see ``fields_for``).
    """
    # the recurrence/matmul paths need at least f32 internally; bf16 fields
    # are upcast here (on every branch, so accuracy does not depend on which
    # mesh axis the derivative crosses) and cast back at the end
    orig_dtype = fl.dtype
    if orig_dtype == jnp.bfloat16:
        fl = fl.astype(jnp.float32)

    if p == 1:
        # the line is whole on this shard: take the single-device path,
        # which installs closures / cyclic corners directly
        from ..ops.derivatives import _derivative_lines, derivative

        if method == "matmul":
            out = derivative(fl, 1.0 / inv_dx, scheme, axis=0, method=method)
        else:
            if method == "phipsi":  # whole line: any direct solver is exact
                method = "pcr"
            out = _derivative_lines(fl, 1.0 / inv_dx, scheme, method)
        return out.astype(orig_dtype)

    if method == "phipsi":
        from .phipsi import phipsi_lines

        rhs = _assemble_rhs(
            fl, tables=None, scheme=scheme, axis_name=axis_name, p=p,
            inv_dx=inv_dx,
        )
        return phipsi_lines(
            rhs, tables, axis_name=axis_name, p=p
        ).astype(orig_dtype)

    x_r = _phase_local_solve(
        fl,
        tables,
        scheme=scheme,
        axis_name=axis_name,
        p=p,
        inv_dx=inv_dx,
        method=method,
    )
    ab = _phase_reduced(x_r, tables, scheme=scheme, axis_name=axis_name, p=p)
    return _phase_update(x_r, ab, tables).astype(orig_dtype)


def _halo_ghosts(fl, *, scheme, axis_name, p):
    """Halo rows from neighbours, closure ghosts at physical ends."""
    w = scheme.stencil_width
    left, right = halo_slices(fl, axis_name, w, scheme.periodic)
    if not scheme.periodic:
        gl, gr = closure_ghosts(fl, scheme)
        ridx = lax.axis_index(axis_name)
        left = jnp.where(ridx == 0, gl, left)
        right = jnp.where(ridx == p - 1, gr, right)
    return left, right


def _assemble_rhs(fl, *, tables, scheme, axis_name, p, inv_dx):
    """Shard-local compact RHS with halo/ghost rows folded in."""
    left, right = _halo_ghosts(fl, scheme=scheme, axis_name=axis_name, p=p)
    f_ext = jnp.concatenate([left, fl, right], axis=0)
    return stencil_rhs(f_ext, inv_dx, scheme)


def _phase_local_solve(fl, tables, *, scheme, axis_name, p, inv_dx, method):
    """Halo/ghost assembly + RHS + local primary solve -> x_R.

    Covers the reference phases ``compute_RHS`` + ``solve_primary_system``
    (+ the host-side ``solve_secondary_systems``, which here is setup-time)."""
    dtype = fl.dtype
    left, right = _halo_ghosts(fl, scheme=scheme, axis_name=axis_name, p=p)
    f_ext = jnp.concatenate([left, fl, right], axis=0)
    rhs = stencil_rhs(f_ext, inv_dx, scheme)
    if method == "matmul":
        return jnp.tensordot(
            tables["tinv"][0].astype(dtype),
            rhs,
            axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )
    return _local_solve_pcr(
        tables["k1"][0], tables["k2"][0], tables["invb"][0], rhs
    )


def _reduced_from_faces(face_f, face_l, rinv_rows, *, scheme, axis_name, p):
    """Negate/zero interface faces, all_gather, and solve for (alpha, beta).

    The reference's ``solve_reduced_system`` (compact.py:66-126) without the
    rank-0 round trip: faces are negated/zeroed (negateAndCopyFaces
    semantics, kernels.cu:76-113), gathered over the line axis, and hit with
    this shard's two rows of the precomputed reduced-matrix inverse."""
    dtype = face_f.dtype
    bshape = face_f.shape
    face_f = -face_f
    face_l = -face_l
    if not scheme.periodic:
        ridx = lax.axis_index(axis_name)
        zero = jnp.zeros_like(face_f)
        face_f = jnp.where(ridx == 0, zero, face_f)
        face_l = jnp.where(ridx == p - 1, zero, face_l)
    faces = jnp.stack([face_f, face_l])  # (2, *batch)
    all_faces = lax.all_gather(faces, axis_name, axis=0, tiled=True)  # (2p, *b)
    flat = all_faces.reshape(2 * p, -1)
    # HIGHEST keeps the f32 interface weights at f32 accuracy; at default
    # precision this matmul may run in TF32 and corrupt every shard boundary
    return jnp.dot(
        rinv_rows.astype(dtype),
        flat,
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape((2,) + bshape)


def _phase_reduced(x_r, tables, *, scheme, axis_name, p):
    """Interface all_gather + redundant reduced solve from the local solve."""
    return _reduced_from_faces(
        x_r[0],
        x_r[-1],
        tables["rinv_rows"][0],
        scheme=scheme,
        axis_name=axis_name,
        p=p,
    )


def _phase_update(x_r, ab, tables):
    """Rank-2 update x = x_R + alpha x_UH + beta x_LH (``sum_solutions``,
    kernels.cu:49-74)."""
    uh, lh = tables["uh"], tables["lh"]
    dtype = x_r.dtype
    expand = (x_r.shape[0],) + (1,) * (x_r.ndim - 1)
    return (
        x_r
        + ab[0] * uh[0].astype(dtype).reshape(expand)
        + ab[1] * lh[0].astype(dtype).reshape(expand)
    )


class DistributedCompactSolver:
    """Compact derivatives of pencil-sharded 3-D fields on a device mesh.

    The counterpart of ``CompactFiniteDifferenceSolver``
    (code/cuda/compact.py:16) plus the OCL variant's dfdy/dfdz
    (code/ocl/compact.py:41-61) — all three directions are first-class, with
    shard-local axis moves instead of host transposes.

    ``method``: 'auto' (per platform/dtype/size, ``ops.derivatives.
    resolve_method``), 'pcr', 'thomas' (whole lines only; sharded lines
    use PCR), 'matmul' (dense block inverses), or 'phipsi' (the reference's
    second distributed algorithm — parameterized-LU sweeps, non-periodic
    only; see parallel/phipsi.py).
    """

    _METHODS = ("auto", "pcr", "thomas", "matmul", "phipsi")

    def __init__(self, grid: Grid, *, method: str = "auto"):
        if method not in self._METHODS:
            raise ValueError(
                f"method {method!r} is not supported on the distributed path"
            )
        self.grid = grid
        self.method = method
        # jitted per-(axis, dtype) programs: a fresh shard_map closure per
        # call would recompile every eager call
        self._programs = {}

    def _local_method(self, dtype, n_local: int) -> str:
        """Local-solve route of a sharded line: 'pcr', 'matmul' or 'phipsi'.

        The shard-local block system is solved from precomputed tables, so
        only PCR and the dense block inverse apply. 'auto' takes the dense
        inverse where ``resolve_method`` picks a dense or stencil route for
        a line of the local length on this platform, and PCR otherwise.
        """
        if self.method == "phipsi":
            return "phipsi"
        from ..ops.derivatives import resolve_method

        m = resolve_method(
            self.method,
            dtype,
            n_local,
            platform=jax.default_backend(),
            scheme=self.grid.scheme,
        )
        return "matmul" if m in ("matmul", "stencil") else "pcr"

    def _derivative(self, f: jax.Array, axis: int) -> jax.Array:
        if f.shape != self.grid.shape:
            raise ValueError(
                f"field shape {f.shape} != grid shape {self.grid.shape}"
            )
        key = (axis % 3, jnp.dtype(f.dtype).name)
        if key not in self._programs:
            self._programs[key] = self._build(*key)
        fn, arrays = self._programs[key]
        return fn(f, *arrays)

    def _build(self, axis3: int, dtype_name: str):
        """(jitted fn(f, *tables), tables) for one axis and field dtype."""
        grid = self.grid
        scheme = grid.scheme
        axis_name = AXIS_NAMES[axis3]
        n = grid.shape[axis3]
        p = grid.proc_shape[axis3]
        inv_dx = 1.0 / grid.spacing[axis3]
        spec = grid.spec()

        if p == 1:
            # the line axis is unsharded: take the axis-aware single-device
            # path shard-locally, with the single-device route choice
            from ..ops.derivatives import derivative

            method1 = "pcr" if self.method == "phipsi" else self.method
            dx_val = grid.spacing[axis3]

            def body1(fl):
                # bf16 upcasts on every branch so accuracy does not depend
                # on which mesh axis the derivative crosses (_dist_lines
                # does the same on the sharded branches)
                orig = fl.dtype
                if orig == jnp.bfloat16:
                    fl = fl.astype(jnp.float32)
                out = derivative(
                    fl, dx_val, scheme, axis=axis3 - 3, method=method1
                )
                return out.astype(orig)

            fn1 = shard_map(
                body1,
                mesh=grid.mesh,
                in_specs=(spec,),
                out_specs=spec,
                check_vma=False,
            )
            return jax.jit(fn1), ()

        method = self._local_method(dtype_name, n // p)
        dtype = np.float64 if dtype_name == "float64" else np.float32
        if method == "phipsi":
            from .phipsi import PHIPSI_FIELDS, phipsi_tables

            tables = phipsi_tables(scheme, n, p)  # raises for periodic
            names = PHIPSI_FIELDS
        else:
            tables = direction_tables(scheme, n, p)
            # ship only the table arrays this method consumes
            names = tables.fields_for(method)
        # numpy, not device arrays: a build inside an outer trace must not
        # cache anything tied to that trace
        arrays = tuple(np.asarray(getattr(tables, nm), dtype) for nm in names)
        tab_specs = tuple(P(axis_name) for _ in arrays)

        def body(fl, *tabs):
            fl0 = jnp.moveaxis(fl, axis3 - 3, 0)
            x = _dist_lines(
                fl0,
                dict(zip(names, tabs)),
                scheme=scheme,
                axis_name=axis_name,
                p=p,
                inv_dx=inv_dx,
                method=method,
            )
            return jnp.moveaxis(x, 0, axis3 - 3)

        fn = shard_map(
            body,
            mesh=grid.mesh,
            in_specs=(spec,) + tab_specs,
            out_specs=spec,
            check_vma=False,
        )
        return jax.jit(fn), arrays

    def apply(self, f: jax.Array, axis: int = 2) -> jax.Array:
        """Apply the grid's scheme along ``axis`` (0=z, 1=y, 2=x).

        The generic entry point: for first-derivative schemes this is
        dfdx/dfdy/dfdz; for derivative_order=2 schemes it is the second
        derivative; for filter schemes (schemes.get_filter) it applies the
        distributed compact filter — same halo exchange and substructured
        solve in every case.
        """
        return self._derivative(f, axis)

    def filter_field(self, f: jax.Array) -> jax.Array:
        """Filter along all three axes (requires a filter-scheme grid)."""
        if self.grid.scheme.derivative_order != 0:
            raise ValueError(
                f"grid scheme {self.grid.scheme.name!r} is not a filter; "
                "build the Grid with schemes.get_filter(...)"
            )
        for axis in (2, 1, 0):
            f = self._derivative(f, axis)
        return f

    def dfdx(self, f: jax.Array) -> jax.Array:
        return self._derivative(f, 2)

    def dfdy(self, f: jax.Array) -> jax.Array:
        return self._derivative(f, 1)

    def dfdz(self, f: jax.Array) -> jax.Array:
        return self._derivative(f, 0)

    def gradient(self, f: jax.Array):
        return (self.dfdx(f), self.dfdy(f), self.dfdz(f))

    def divergence(self, u) -> jax.Array:
        ux, uy, uz = u
        return self.dfdx(ux) + self.dfdy(uy) + self.dfdz(uz)

    def curl(self, u):
        ux, uy, uz = u
        return (
            self.dfdy(uz) - self.dfdz(uy),
            self.dfdz(ux) - self.dfdx(uz),
            self.dfdx(uy) - self.dfdy(ux),
        )

    def profile_derivative(self, f, axis: int = 2, verbose: bool = True):
        """Per-phase wall-clock breakdown of one derivative, reference-style.

        Works for any of the three directions (``axis`` 0=z, 1=y, 2=x over
        the trailing dims, like ``_derivative``). The analogue of the
        @timeit phase report the reference prints for compute_RHS /
        primary / reduced / sum (code/cuda/timer.py:4-16, compact.py:46-65).
        Each phase is dispatched and synced separately, so the numbers
        include one dispatch each; time the full op for benchmark figures.
        """
        import numpy as np

        from ..utils.timing import phase_timer

        grid = self.grid
        scheme = grid.scheme
        axis3 = axis % 3
        axis_name = AXIS_NAMES[axis3]
        p = grid.proc_shape[axis3]
        n = grid.shape[axis3]
        inv_dx = 1.0 / grid.spacing[axis3]
        method = self._local_method(f.dtype, n // p)
        tables = direction_tables(scheme, n, p)
        dtype = jnp.float64 if f.dtype == jnp.float64 else jnp.float32
        names = tables.fields_for(method) if p > 1 else ()
        arrays = tuple(jnp.asarray(getattr(tables, nm), dtype) for nm in names)
        spec = grid.spec()
        tab_specs = tuple(P(axis_name) for _ in arrays)
        src = axis3 - 3  # the differentiated axis, negative indexing
        timings = {}

        def run(name, fn, *args):
            jfn = jax.jit(fn)
            out = jfn(*args)  # compile outside the timed region
            np.asarray(jax.tree_util.tree_leaves(out)[0])
            with phase_timer(name, verbose=verbose) as t:
                out = jfn(*args)
                np.asarray(jax.tree_util.tree_leaves(out)[0])  # force sync
            timings[name] = t.elapsed
            return out

        def smap(body, in_specs, out_specs):
            return shard_map(
                body,
                mesh=grid.mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )

        local = smap(
            lambda fl, *tabs: jnp.moveaxis(
                (_dist_lines if p == 1 else _phase_local_solve)(
                    jnp.moveaxis(fl, src, 0),
                    dict(zip(names, tabs)),
                    scheme=scheme,
                    axis_name=axis_name,
                    p=p,
                    inv_dx=inv_dx,
                    method=method,
                ),
                0,
                src,
            ),
            (spec,) + tab_specs,
            spec,
        )
        x_r = run("rhs_and_primary_solve", local, f, *arrays)
        if p > 1:
            # interface weights: shard-singleton over the line axis, local
            # batch dims in their original order, (alpha, beta) trailing
            others = tuple(nm for nm in AXIS_NAMES if nm != axis_name)
            ab_spec = P(axis_name, *others, None)

            def reduced_body(xr, *tabs):
                ab = _phase_reduced(
                    jnp.moveaxis(xr, src, 0),
                    dict(zip(names, tabs)),
                    scheme=scheme,
                    axis_name=axis_name,
                    p=p,
                )  # (2, *batch)
                return jnp.moveaxis(ab, 0, -1)[None]  # (1, *batch, 2)

            reduced = smap(reduced_body, (spec,) + tab_specs, ab_spec)
            ab = run("reduced_system", reduced, x_r, *arrays)

            def update_body(xr, abg, *tabs):
                ab_local = jnp.moveaxis(abg[0], -1, 0)  # (2, *batch)
                out = _phase_update(
                    jnp.moveaxis(xr, src, 0), ab_local, dict(zip(names, tabs))
                )
                return jnp.moveaxis(out, 0, src)

            update = smap(update_body, (spec, ab_spec) + tab_specs, spec)
            run("sum_solutions", update, x_r, ab, *arrays)
        run("full_derivative", lambda g: self._derivative(g, axis3), f)
        return timings

    def profile_dfdx(self, f, verbose: bool = True):
        return self.profile_derivative(f, axis=2, verbose=verbose)

    def profile_dfdy(self, f, verbose: bool = True):
        return self.profile_derivative(f, axis=1, verbose=verbose)

    def profile_dfdz(self, f, verbose: bool = True):
        return self.profile_derivative(f, axis=0, verbose=verbose)
