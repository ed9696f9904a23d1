"""Compact-scheme RHS assembly (JAX level).

Equivalent of the reference's ``computeRHS`` CUDA kernel
(/root/reference/code/cuda/kernels.cu:4-47): interior antisymmetric stencil
plus one-sided closure rows at physical boundaries. Here it is a handful of
shifted adds that XLA fuses into the surrounding computation.

Convention: the derivative axis is the *leading* axis — shape (n, *batch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..schemes import CompactScheme

__all__ = ["compact_rhs", "closure_ghosts", "stencil_rhs"]

# Closure rows are contracted at full f32 precision: a default-precision f32
# dot may run in TF32 on the GPU (about three decimal digits), which would
# corrupt every non-periodic boundary row.
_HIGHEST = jax.lax.Precision.HIGHEST


def stencil_rhs(f_ext: jnp.ndarray, inv_dx, scheme: CompactScheme) -> jnp.ndarray:
    """Uniform interior stencil over an extended array (ghosts included).

    ``f_ext`` has shape (n + 2w, *batch) with w = scheme.stencil_width rows
    of ghost/halo data on each side; returns (n, *batch). Boundary closures
    are assumed to be encoded in the ghost rows (see ``closure_ghosts``).
    """
    w = scheme.stencil_width
    n = f_ext.shape[0] - 2 * w
    dtype = f_ext.dtype
    s = jnp.asarray(scheme.rhs_sign, dtype)
    r = jnp.zeros_like(f_ext, shape=(n,) + f_ext.shape[1:])
    for k, wk in zip(scheme.rhs_offsets, scheme.rhs_weights):
        r = r + jnp.asarray(wk, dtype) * (
            f_ext[w + k : w + k + n] + s * f_ext[w - k : w - k + n]
        )
    if scheme.rhs_center:
        r = r + jnp.asarray(scheme.rhs_center, dtype) * f_ext[w : w + n]
    return r * jnp.asarray(inv_dx, dtype) ** scheme.derivative_order


def compact_rhs(f: jnp.ndarray, dx, scheme: CompactScheme, axis: int = 0):
    """RHS of the compact system for ``f`` along ``axis``.

    Returns sum_k w_k (f[i+k] - f[i-k]) / dx (first derivatives) or
    sum_k w_k (f[i+k] - 2 f[i] + f[i-k]) / dx**2 (second derivatives) with
    closure rows installed at both ends for non-periodic schemes. Axis-aware
    so pencil-major fields never need a transpose.
    """
    import jax.lax as lax

    dtype = f.dtype
    axis = axis % f.ndim
    n = f.shape[axis]
    sgn = jnp.asarray(scheme.rhs_sign, dtype)
    inv_dxp = jnp.asarray(1.0 / dx, dtype) ** scheme.derivative_order

    def sl(lo, hi):
        return lax.slice_in_dim(f, lo, hi, axis=axis)

    def shift(k):
        if k == 0:
            return f
        pad = [(0, 0)] * f.ndim
        if k > 0:
            pad[axis] = (0, k)
            return jnp.pad(sl(k, n), pad)
        pad[axis] = (-k, 0)
        return jnp.pad(sl(0, n + k), pad)

    def center(r):
        if scheme.rhs_center:
            r = r + jnp.asarray(scheme.rhs_center, dtype) * f
        return r

    if scheme.periodic:
        r = jnp.zeros_like(f)
        for k, w in zip(scheme.rhs_offsets, scheme.rhs_weights):
            r = r + jnp.asarray(w, dtype) * (
                jnp.roll(f, -k, axis=axis) + sgn * jnp.roll(f, k, axis=axis)
            )
        return center(r) * inv_dxp

    r = jnp.zeros_like(f)
    for k, w in zip(scheme.rhs_offsets, scheme.rhs_weights):
        r = r + jnp.asarray(w, dtype) * (shift(k) + sgn * shift(-k))
    r = center(r)
    # closure rows (nb >= stencil_width for all shipped schemes, so exactly
    # the rows whose interior stencil poked outside get overwritten)
    nb = scheme.n_closure
    assert nb >= scheme.stencil_width, scheme.name
    top = []
    for row in scheme.left_rows:
        s = jnp.asarray(np.asarray(row.rhs_stencil), dtype)
        top.append(
            jnp.tensordot(
                s, sl(0, len(row.rhs_stencil)), axes=(0, axis), precision=_HIGHEST
            )
        )
    bot = []
    for row in scheme.right_rows:
        s = jnp.asarray(np.asarray(row.rhs_stencil[::-1]), dtype)
        bot.append(
            jnp.tensordot(
                s,
                sl(n - len(row.rhs_stencil), n),
                axes=(0, axis),
                precision=_HIGHEST,
            )
        )
    # tensordot removes ``axis``; re-insert it for stacking
    top = [jnp.expand_dims(t, axis) for t in top]
    bot = [jnp.expand_dims(b, axis) for b in bot]
    r = jnp.concatenate(
        top + [lax.slice_in_dim(r, nb, n - nb, axis=axis)] + bot[::-1],
        axis=axis,
    )
    return r * inv_dxp


def closure_ghosts(f: jnp.ndarray, scheme: CompactScheme):
    """Ghost rows that make the *interior* stencil reproduce the closure RHS.

    For the distributed solve the RHS must be a uniform interior stencil
    over an extended array ``f_ext = [ghost_left; f; ghost_right]``. At a
    physical boundary we choose the ghost values so that applying the
    interior stencil at rows 0..nb-1 yields exactly the closure rows'
    one-sided RHS — solving for the ghosts row by row, innermost first.

    Returns (ghost_left, ghost_right), each of shape (w, *batch), where
    w = scheme.stencil_width. Requires nb == w (true for shipped schemes).
    """
    if scheme.periodic:
        w = scheme.stencil_width
        return f[-w:], f[:w]
    w = scheme.stencil_width
    nb = scheme.n_closure
    assert nb == w, "ghost construction assumes one closure row per halo row"
    dtype = f.dtype
    offsets = scheme.rhs_offsets
    weights = scheme.rhs_weights
    sgn = jnp.asarray(scheme.rhs_sign, dtype)
    c0 = scheme.rhs_center

    def solve_ghosts(g, targets):
        """Left-edge ghost construction on field ``g`` with per-row targets.

        Row j's interior stencil sum_k w_k (g[j+k] + sgn*g[j-k]) + c0*g[j]
        must equal targets[j]; out-of-range g[j-k] (j-k < 0) are the unknown
        ghosts gh[m-1] = g[-m]. Rows are processed from j = nb-1 downward so
        each row introduces exactly one *new* (outermost) unknown.
        """
        gh = [None] * w
        for j in range(nb - 1, -1, -1):
            m_outer = max(k - j for k in offsets)
            acc = jnp.asarray(c0, dtype) * g[j] if c0 else jnp.zeros_like(targets[j])
            w_outer = None
            for k, wk in zip(offsets, weights):
                wk = jnp.asarray(wk, dtype)
                if k - j == m_outer:
                    w_outer = wk
                    acc = acc + wk * g[j + k]
                    continue
                gm = gh[k - j - 1] if j - k < 0 else g[j - k]
                acc = acc + wk * (g[j + k] + sgn * gm)
            # targets[j] = acc + sgn * w_outer * gh[m_outer-1]
            gh[m_outer - 1] = sgn * (targets[j] - acc) / w_outer
        return gh

    def targets_for(g):
        out = []
        for row in scheme.left_rows:
            s = np.asarray(row.rhs_stencil)
            out.append(
                jnp.tensordot(
                    jnp.asarray(s, dtype),
                    g[: len(s)],
                    axes=(0, 0),
                    precision=_HIGHEST,
                )
            )
        return out

    ghosts_l = solve_ghosts(f, targets_for(f))
    # Right edge by mirror symmetry: for odd derivative orders the reversed-
    # field stencil flips sign AND the right closure rows are the negated
    # mirror of the left ones — the two flips cancel; for even orders
    # neither flips. Either way the reversed-field construction uses the
    # left-row targets unchanged.
    fr = f[::-1]
    ghosts_r = solve_ghosts(fr, targets_for(fr))

    g_left = jnp.stack(ghosts_l[::-1])  # (w, *batch): rows f[-w] .. f[-1]
    g_right = jnp.stack(ghosts_r)  # rows f[n] .. f[n+w-1]
    return g_left, g_right
