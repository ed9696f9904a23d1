"""Single-device compact derivative API (jit/vmap-clean).

The counterpart of the reference's ``CompactFiniteDifferenceSolver.dfdx``
(/root/reference/code/cuda/compact.py:29-44) and the OpenCL variant's
``dfdy``/``dfdz`` (code/ocl/compact.py:41-61) — but with on-device axis
handling (XLA transposes) instead of host round-trip transposes, and with all
RHS-independent solver tables precomputed at trace time instead of per-call
scipy solves on the host (compact.py:150-153).

Array convention follows the reference: fields are ``[..., nz, ny, nx]`` with
x the fastest axis; ``dfdx`` differentiates the last axis.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..schemes import SCHEME4, SCHEME4_D2, CompactScheme, lhs_bands
from . import tridiag
from .rhs import compact_rhs

__all__ = [
    "line_factors",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "gradient",
    "divergence",
    "curl",
    "laplacian",
    "filter_field",
]

_METHODS = ("auto", "pcr", "thomas", "matmul", "stencil")

AXIS_CLASSES = ("minor", "second_minor", "leading")

# Line lengths the GPU routes were measured at. Shorter lines take the
# dense operator (one small matmul, O(n) FLOPs per point).
_GPU_LINES = (256, 512)

# Route of method='auto' on the GPU for non-periodic lines, keyed by (axis
# class, dtype name, derivative order; 0 is a filter). Each value holds the
# route for lines of 256 to 511 points and the route for 512 or more: the
# fastest route that passed the float64-oracle gate on an H100 at 256^3
# and at 512^3 (benchmarks/route_table.py; the measured table and the card
# are in CHANGES.md). bf16 always takes the single-pass dense operator on
# the tensor cores.
_GPU_ROUTES = {
    ("minor", "float32", 0): ("matmul", "stencil"),
    ("minor", "float32", 1): ("stencil", "stencil"),
    ("minor", "float32", 2): ("stencil", "stencil"),
    ("second_minor", "float32", 0): ("matmul", "stencil"),
    ("second_minor", "float32", 1): ("stencil", "stencil"),
    ("second_minor", "float32", 2): ("stencil", "stencil"),
    ("leading", "float32", 0): ("matmul", "matmul"),
    ("leading", "float32", 1): ("stencil", "stencil"),
    ("leading", "float32", 2): ("stencil", "stencil"),
    ("minor", "float64", 0): ("matmul", "matmul"),
    ("minor", "float64", 1): ("matmul", "stencil"),
    ("minor", "float64", 2): ("stencil", "stencil"),
    ("second_minor", "float64", 0): ("matmul", "matmul"),
    ("second_minor", "float64", 1): ("matmul", "matmul"),
    ("second_minor", "float64", 2): ("stencil", "stencil"),
    ("leading", "float64", 0): ("matmul", "matmul"),
    ("leading", "float64", 1): ("matmul", "matmul"),
    ("leading", "float64", 2): ("matmul", "matmul"),
    **{
        (axis, "bfloat16", order): ("matmul", "matmul")
        for axis in AXIS_CLASSES
        for order in (0, 1, 2)
    },
}

# Half-width of the widest explicit stencil that won its key on the card:
# the f32 alpha=0.45 filter (73 taps). A filter's stencil widens without
# bound as its alpha nears 1/2; at alpha=0.48 and 0.49 it ran 9-39x
# slower than the dense operator on the H100 (CHANGES.md), so wider
# stencils take the dense operator.
_GPU_STENCIL_MAX_BW = 36


def axis_class(ndim: int, axis: int) -> str:
    """'minor' (last axis), 'second_minor', or 'leading' (any deeper axis)."""
    depth = ndim - 1 - axis % ndim
    return AXIS_CLASSES[min(depth, 2)]


def resolve_method(
    method: str,
    dtype,
    n: int,
    *,
    platform: str,
    axis_class: str = "leading",
    scheme: CompactScheme = SCHEME4,
) -> str:
    """Resolve 'auto' to a concrete backend; other methods pass through.

    ``platform`` is ``jax.default_backend()`` of the caller. The CPU takes
    the portable ``pcr`` path for every dtype. The GPU looks non-periodic
    lines up in the measured ``_GPU_ROUTES`` table by axis class, dtype,
    the scheme's derivative order and line length. Periodic lines and lines
    shorter than the measured range take ``matmul``: the periodic explicit
    stencil shifts cyclically, and inside a whole Navier–Stokes step on the
    H100 it ran 7x slower than the dense operator (CHANGES.md). So does a
    ``stencil`` entry whose stencil for this scheme is wider than any that
    won on the card, or too wide for the line. This is the only place in the
    package where the platform selects a route.
    """
    if method not in _METHODS:
        raise ValueError(f"unknown solver method {method!r}; expected {_METHODS}")
    if method != "auto":
        return method
    if platform == "cpu":
        return "pcr"
    if platform != "gpu":
        raise ValueError(f"no measured routes for platform {platform!r}")
    if scheme.periodic or n < _GPU_LINES[0]:
        return "matmul"
    short, long = _GPU_ROUTES[
        (axis_class, jnp.dtype(dtype).name, scheme.derivative_order)
    ]
    route = long if n >= _GPU_LINES[1] else short
    if route == "stencil":
        c, _, _, m = banded_operator(scheme, n, _stencil_tol(dtype))
        bw = (len(c) - 1) // 2
        if bw > _GPU_STENCIL_MAX_BW or n < 2 * (m + bw):
            return "matmul"
    return route


# Block length for the blocked dense path; lines longer than this are split
# into equal blocks coupled through the reduced interface system, exactly the
# distributed substructuring math run shard-locally with zero collectives.
_MATMUL_BLOCK = 512


@functools.lru_cache(maxsize=None)
def _blocked_tables(scheme: CompactScheme, n: int, nb: int):
    """(tinv (nb,m,m), uh (nb,m), lh (nb,m), rinv (2nb,2nb)) float64."""
    from ..parallel.compact import direction_tables

    t = direction_tables(scheme, n, nb)
    rinv = t.rinv_rows.reshape(2 * nb, 2 * nb)
    return t.tinv, t.uh, t.lh, rinv


def _pick_blocks(n: int) -> int:
    """Block count nb such that n/nb is an integer block length in
    [64, _MATMUL_BLOCK], preferring ~256; returns 1 (whole-line dense
    operator) when no such divisor exists (e.g. prime n)."""
    for target in (256, 128, 512, 64):
        if n % target == 0:
            return n // target
    for nb in range(2, n // 64 + 1):
        if n % nb == 0 and 64 <= n // nb <= _MATMUL_BLOCK:
            return nb
    import warnings

    warnings.warn(
        f"line length {n} has no divisor in [64, {_MATMUL_BLOCK}]; the "
        "'matmul' backend falls back to the full dense (n, n) operator — "
        "O(n) FLOPs/point and an O(n^2) table. Consider method='pcr' or "
        "method='stencil' (any n).",
        stacklevel=3,
    )
    return 1


def _letters(k):
    return "abcdefghmnopqrstuvw"[:k]


def _blocked_matmul_derivative(f, dx, scheme, axis, precision):
    """Blocked dense substructuring along ``axis`` (single device).

    The same math as the distributed solve (parallel/compact.py) with the
    "shards" being contiguous blocks of the local line: per-block dense
    inverses (a batched matmul), a (2nb, 2nb) reduced interface matmul,
    and a rank-2 update. FLOPs/point stay O(block) for any n.
    """
    n = f.shape[axis]
    nb = _pick_blocks(n)
    if nb == 1:
        M = jnp.asarray(dense_operator(scheme, n), f.dtype)
        out = jnp.tensordot(f, M, axes=([axis], [1]), precision=precision)
        dxp = jnp.asarray(dx, f.dtype) ** scheme.derivative_order
        return jnp.moveaxis(out, -1, axis) / dxp
    m = n // nb
    dtype = f.dtype
    tinv, uh, lh, rinv = _blocked_tables(scheme, n, nb)
    tinv = jnp.asarray(tinv, dtype)
    uh = jnp.asarray(uh, dtype)
    lh = jnp.asarray(lh, dtype)
    rinv = jnp.asarray(rinv, dtype)

    # full-line RHS (closures included), then split the axis into (nb, m)
    rhs = compact_rhs(f, dx, scheme, axis=axis)
    shape2 = f.shape[:axis] + (nb, m) + f.shape[axis + 1 :]
    r2 = rhs.reshape(shape2)

    nd = r2.ndim
    subs = _letters(nd)
    b, i = subs[axis], subs[axis + 1]
    j = "z"
    # x_R = T_b^{-1} r_b : batched over the block index
    xr = jnp.einsum(
        f"{subs},{b}{j}{i}->{subs.replace(i, j)}", r2, tinv, precision=precision
    )

    # interface faces, negated; identity rows at the physical ends demand
    # zeros there (periodic lines keep all faces)
    face_f = -jax.lax.index_in_dim(xr, 0, axis=axis + 1, keepdims=False)
    face_l = -jax.lax.index_in_dim(xr, m - 1, axis=axis + 1, keepdims=False)
    faces = jnp.stack([face_f, face_l], axis=axis + 1)  # (..., nb, 2, ...)
    fshape = faces.shape[:axis] + (2 * nb,) + faces.shape[axis + 2 :]
    faces = faces.reshape(fshape)
    if not scheme.periodic:
        mask = np.ones(2 * nb)
        mask[0] = 0.0
        mask[-1] = 0.0
        mshape = [1] * faces.ndim
        mshape[axis] = 2 * nb
        faces = faces * jnp.asarray(mask, dtype).reshape(mshape)

    # reduced solve: u = Rinv @ faces over the 2nb dim
    fsubs = _letters(faces.ndim)
    e = fsubs[axis]
    u = jnp.einsum(
        f"{fsubs},y{e}->{fsubs.replace(e, 'y')}", faces, rinv, precision=precision
    )
    ushape = u.shape[:axis] + (nb, 2) + u.shape[axis + 1 :]
    u = u.reshape(ushape)
    alpha = jax.lax.index_in_dim(u, 0, axis=axis + 1, keepdims=True)
    beta = jax.lax.index_in_dim(u, 1, axis=axis + 1, keepdims=True)

    # rank-2 update; uh/lh broadcast over everything but (nb, m)
    tshape = [1] * nd
    tshape[axis] = nb
    tshape[axis + 1] = m
    x = xr + alpha * uh.reshape(tshape) + beta * lh.reshape(tshape)
    return x.reshape(f.shape)


@functools.lru_cache(maxsize=None)
def dense_operator(scheme: CompactScheme, n: int):
    """Dense derivative operator M = T^{-1} B (float64 numpy, (n, n)).

    The compact derivative is linear in f: f' = T^{-1} B f / dx. Applying M
    as one matmul reads f once and writes f' once, with no recurrence and
    no layout change, at the price of O(n) FLOPs per point. Precomputed
    once per (scheme, n) in float64.
    """
    from ..schemes import rhs_matrix

    B = rhs_matrix(scheme, n)
    dl, d, du = lhs_bands(scheme, n)
    T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    if scheme.periodic:
        T[0, -1] = scheme.alpha
        T[-1, 0] = scheme.alpha
    return np.linalg.solve(T, B)


@functools.lru_cache(maxsize=None)
def banded_operator(scheme: CompactScheme, n: int, tol: float = 1e-8):
    """Truncated-banded form of the dense operator M = T^{-1} B.

    Rows of M decay geometrically away from the diagonal (the tridiagonal
    inverse decays like r^|i-j| with r ~ 0.27 for alpha=1/4), so M is a
    constant-coefficient banded matrix up to ``tol`` — i.e. the implicit
    compact scheme equals an *explicit* wide stencil to working precision.

    Returns (c, E_top, E_bot, m):
      c      — (2*bw+1,) interior stencil coefficients (center at bw)
      E_top  — (m, m+bw) dense correction rows at the left edge
      E_bot  — (m, m+bw) dense correction rows at the right edge (natural
               orientation: applied to f[n-(m+bw):])
      m      — number of corrected rows per edge (0 for periodic schemes,
               whose M is circulant so the stencil alone is exact)
    """
    M = dense_operator(scheme, n)
    mid = n // 2
    row = M[mid]
    rel = np.abs(row) / np.abs(row).max()
    idx = np.nonzero(rel > tol)[0]
    bw = int(max(mid - idx.min(), idx.max() - mid))
    c = row[mid - bw : mid + bw + 1].copy()
    if scheme.periodic:
        # circulant: wrap-around stencil is exact everywhere
        return c, None, None, 0
    m = bw + scheme.n_closure
    E_top = M[:m, : m + bw].copy()
    E_bot = M[n - m :, n - (m + bw) :].copy()
    return c, E_top, E_bot, m


def _stencil_tol(dtype) -> float:
    """Relative truncation of the explicit stencil: below f32 roundoff for
    f32 and bf16 fields, below the 1e-10 oracle gate for float64 ones."""
    return 1e-13 if dtype == jnp.float64 else 1e-8


def _stencil_derivative(f, dx, scheme, axis):
    """Explicit wide-stencil evaluation of the compact derivative.

    O(bandwidth) fused multiply-adds per point with truncation below the
    field dtype's roundoff, independent of line length — one loop fusion
    along any axis."""
    import jax.lax as lax

    n = f.shape[axis]
    c, E_top, E_bot, m = banded_operator(scheme, n, _stencil_tol(f.dtype))
    bw = (len(c) - 1) // 2
    if n < 2 * (m + bw):
        raise ValueError(f"line length {n} too short for stencil method")
    dtype = f.dtype

    dxp = jnp.asarray(dx, dtype) ** scheme.derivative_order

    if scheme.periodic:
        out = jnp.zeros_like(f)
        for k, ck in enumerate(c):
            if ck != 0.0:
                out = out + jnp.asarray(ck, dtype) * jnp.roll(f, bw - k, axis=axis)
        return out / dxp

    out = jnp.zeros_like(f)
    for k, ck in enumerate(c):
        off = k - bw  # contribution of f[i+off]
        if ck == 0.0:
            continue
        pad = [(0, 0)] * f.ndim
        if off >= 0:
            pad[axis] = (0, off)
            piece = jnp.pad(lax.slice_in_dim(f, off, n, axis=axis), pad)
        else:
            pad[axis] = (-off, 0)
            piece = jnp.pad(lax.slice_in_dim(f, 0, n + off, axis=axis), pad)
        out = out + jnp.asarray(ck, dtype) * piece
    # dense edge corrections (small matmuls; HIGHEST so f32 edges are not
    # contracted in TF32)
    prec = jax.lax.Precision.HIGHEST if dtype != jnp.bfloat16 else None
    top = jnp.tensordot(
        jnp.asarray(E_top, dtype),
        lax.slice_in_dim(f, 0, m + bw, axis=axis),
        axes=(1, axis),
        precision=prec,
    )
    bot = jnp.tensordot(
        jnp.asarray(E_bot, dtype),
        lax.slice_in_dim(f, n - (m + bw), n, axis=axis),
        axes=(1, axis),
        precision=prec,
    )
    # tensordot puts the new row dim first; move it to ``axis``
    top = jnp.moveaxis(top, 0, axis)
    bot = jnp.moveaxis(bot, 0, axis)
    mid = lax.slice_in_dim(out, m, n - m, axis=axis)
    out = jnp.concatenate([top, mid, bot], axis=axis)
    return out / dxp


@functools.lru_cache(maxsize=None)
def line_factors(
    scheme: CompactScheme,
    n: int,
    method: str = "auto",
    first_block: bool = True,
    last_block: bool = True,
):
    """Precomputed solver tables for an ``n``-point line of ``scheme``.

    Cached per (scheme, n, method, block position); the numpy tables become
    trace-time constants, so jitted derivative calls carry zero setup cost —
    the counterpart of the reference's per-solver coefficient precompute
    (templated/near_toeplitz.py:109-184) without its host round trips.
    """
    core_method = "thomas" if method == "thomas" else "pcr"
    if method not in _METHODS:
        raise ValueError(f"unknown solver method {method!r}; expected {_METHODS}")
    bands = lhs_bands(scheme, n, first_block=first_block, last_block=last_block)
    if scheme.periodic:
        if not (first_block and last_block):
            raise ValueError("periodic factors are only defined for a full line")
        return tridiag.cyclic_factor(
            *bands, scheme.alpha, scheme.alpha, method=core_method
        )
    return tridiag.factor(*bands, method=core_method)


def _derivative_lines(f, dx, scheme, method):
    """Derivative along axis 0 of ``f`` (n, *batch) by 'pcr' or 'thomas'."""
    rhs = compact_rhs(f, dx, scheme)
    fac = line_factors(scheme, f.shape[0], method)
    return tridiag.solve(fac, rhs)


def derivative(
    f: jax.Array,
    dx,
    scheme: CompactScheme = SCHEME4,
    *,
    axis: int = -1,
    method: str = "auto",
) -> jax.Array:
    """Compact derivative of ``f`` along ``axis`` with spacing ``dx``.

    The scheme's ``derivative_order`` selects first (default schemes) or
    second derivative (``get_scheme(..., derivative=2)`` / SCHEME*_D2), or
    a filter (``derivative_order=0``, ``schemes.get_filter``).

    ``method`` selects the backend: 'auto' (default; picks per platform,
    dtype, axis and line length, see ``resolve_method``), 'stencil' (the
    implicit scheme as an explicit wide stencil, exact to below the dtype's
    roundoff), 'matmul' (the dense operator, blocked above 512 points),
    'pcr' (table-driven parallel cyclic reduction along the axis) or
    'thomas' (scan-based LU). f32 contractions run at HIGHEST precision;
    bf16 fields take a single bf16 pass.
    """
    axis = axis % f.ndim
    method = resolve_method(
        method,
        f.dtype,
        f.shape[axis],
        platform=jax.default_backend(),
        axis_class=axis_class(f.ndim, axis),
        scheme=scheme,
    )
    if method == "matmul":
        prec = "highest" if f.dtype != jnp.bfloat16 else None
        n = f.shape[axis]
        if n > _MATMUL_BLOCK:
            # long lines: blocked substructuring keeps FLOPs/point O(block)
            return _blocked_matmul_derivative(f, dx, scheme, axis, prec)
        M = jnp.asarray(dense_operator(scheme, n), f.dtype)
        out = jnp.tensordot(f, M, axes=([axis], [1]), precision=prec)
        # tensordot appends M's free dim at the end; restore the axis position
        out = jnp.moveaxis(out, -1, axis)
        return out / jnp.asarray(dx, f.dtype) ** scheme.derivative_order
    if method == "stencil":
        # materialize the result: left free, XLA fuses the wide stencil into
        # its consumers and recomputes it per use (an advection-diffusion
        # step on the H100 ran 2.3x slower without the barrier, CHANGES.md)
        return jax.lax.optimization_barrier(
            _stencil_derivative(f, dx, scheme, axis)
        )
    if method == "pcr":
        # fully axis-aware: stencil and PCR shifts run in the field's native
        # layout — no transposes, every op is a fused shifted multiply-add
        rhs = compact_rhs(f, dx, scheme, axis=axis)
        fac = line_factors(scheme, f.shape[axis], method)
        return tridiag.solve(fac, rhs, axis=axis)
    ft = jnp.moveaxis(f, axis, 0)
    x = _derivative_lines(ft, dx, scheme, method)
    return jnp.moveaxis(x, 0, axis)


def dfdx(f, dx, scheme: CompactScheme = SCHEME4, *, method: str = "auto", **kw):
    """d/dx — derivative along the last axis of ``[..., nz, ny, nx]``."""
    return derivative(f, dx, scheme, axis=-1, method=method, **kw)


def dfdy(f, dy, scheme: CompactScheme = SCHEME4, *, method: str = "auto", **kw):
    """d/dy — derivative along the second-to-last axis."""
    return derivative(f, dy, scheme, axis=-2, method=method, **kw)


def dfdz(f, dz, scheme: CompactScheme = SCHEME4, *, method: str = "auto", **kw):
    """d/dz — derivative along the third-to-last axis."""
    return derivative(f, dz, scheme, axis=-3, method=method, **kw)


def filter_field(
    f: jax.Array,
    scheme: CompactScheme = None,
    *,
    axis=None,
    method: str = "auto",
) -> jax.Array:
    """Apply a compact low-pass filter (schemes.get_filter) to ``f``.

    ``axis=None`` filters all three trailing axes sequentially (the standard
    per-direction sweep); an int filters one axis. The filter is the same
    tridiagonal solve as a derivative with ``derivative_order=0`` — no
    spacing scale — so every backend applies.
    """
    if scheme is None:
        from ..schemes import get_filter

        scheme = get_filter()
    if scheme.derivative_order != 0:
        raise ValueError(
            f"scheme {scheme.name!r} is not a filter (derivative_order="
            f"{scheme.derivative_order}); build one with schemes.get_filter"
        )
    axes = (-1, -2, -3) if axis is None else (axis,)
    for ax in axes:
        f = derivative(f, 1.0, scheme, axis=ax, method=method)
    return f


def _d2_scheme(scheme: CompactScheme) -> CompactScheme:
    if scheme.derivative_order != 2:
        raise ValueError(
            f"scheme {scheme.name!r} is a derivative_order="
            f"{scheme.derivative_order} scheme; second-derivative ops need a "
            "derivative_order=2 scheme (e.g. get_scheme(4, derivative=2))"
        )
    return scheme


def d2fdx2(f, dx, scheme: CompactScheme = None, *, method: str = "auto", **kw):
    """d²/dx² — compact second derivative along the last axis."""
    scheme = _d2_scheme(scheme if scheme is not None else SCHEME4_D2)
    return derivative(f, dx, scheme, axis=-1, method=method, **kw)


def d2fdy2(f, dy, scheme: CompactScheme = None, *, method: str = "auto", **kw):
    """d²/dy² — compact second derivative along the second-to-last axis."""
    scheme = _d2_scheme(scheme if scheme is not None else SCHEME4_D2)
    return derivative(f, dy, scheme, axis=-2, method=method, **kw)


def d2fdz2(f, dz, scheme: CompactScheme = None, *, method: str = "auto", **kw):
    """d²/dz² — compact second derivative along the third-to-last axis."""
    scheme = _d2_scheme(scheme if scheme is not None else SCHEME4_D2)
    return derivative(f, dz, scheme, axis=-3, method=method, **kw)


def _spacings3(spacing):
    if isinstance(spacing, (tuple, list)):
        dz, dy, dx = spacing
        return (dz, dy, dx)
    if getattr(spacing, "ndim", 0) == 1:  # array of 3 spacings
        return (spacing[0], spacing[1], spacing[2])
    return (spacing, spacing, spacing)


def gradient(
    f: jax.Array,
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(df/dx, df/dy, df/dz) of a scalar field ``[..., nz, ny, nx]``.

    ``spacing`` is a scalar or (dz, dy, dx).
    """
    dz, dy, dx = _spacings3(spacing)
    return (
        dfdx(f, dx, scheme, method=method),
        dfdy(f, dy, scheme, method=method),
        dfdz(f, dz, scheme, method=method),
    )


def divergence(
    u: Sequence[jax.Array],
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> jax.Array:
    """div(u) for a 3-component vector field (ux, uy, uz)."""
    ux, uy, uz = u
    dz, dy, dx = _spacings3(spacing)
    return (
        dfdx(ux, dx, scheme, method=method)
        + dfdy(uy, dy, scheme, method=method)
        + dfdz(uz, dz, scheme, method=method)
    )


def curl(
    u: Sequence[jax.Array],
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """curl(u) for a 3-component vector field (ux, uy, uz)."""
    ux, uy, uz = u
    dz, dy, dx = _spacings3(spacing)
    duz_dy = dfdy(uz, dy, scheme, method=method)
    duz_dx = dfdx(uz, dx, scheme, method=method)
    duy_dz = dfdz(uy, dz, scheme, method=method)
    dux_dz = dfdz(ux, dz, scheme, method=method)
    duy_dx = dfdx(uy, dx, scheme, method=method)
    dux_dy = dfdy(ux, dy, scheme, method=method)
    return (duz_dy - duy_dz, dux_dz - duz_dx, duy_dx - dux_dy)


def laplacian(
    f: jax.Array,
    spacing,
    scheme: CompactScheme = None,
    *,
    method: str = "auto",
) -> jax.Array:
    """Laplacian of a scalar field via compact *second*-derivative schemes.

    One tridiagonal solve per direction — half the derivative evaluations
    (and better high-wavenumber resolution) than the repeated-first-
    derivative form div(grad(f)). ``scheme`` must be a derivative_order=2
    scheme; defaults to the 4th-order Padé d² (``SCHEME4_D2``).
    """
    scheme = _d2_scheme(scheme if scheme is not None else SCHEME4_D2)
    dz, dy, dx = _spacings3(spacing)
    return (
        d2fdx2(f, dx, scheme, method=method)
        + d2fdy2(f, dy, scheme, method=method)
        + d2fdz2(f, dz, scheme, method=method)
    )
