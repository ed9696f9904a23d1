"""Batched tridiagonal solvers (JAX/XLA level).

The systems arising from compact schemes are *near-Toeplitz*: one set of
bands (dl, d, du) of length ``n`` shared by every line in the batch; only the
right-hand side varies per line. All RHS-independent work is therefore done
once at setup time in float64 numpy ("factor"), leaving a solve that is pure
axpy traffic over the batch — the device-side counterpart of the
reference's precomputed cyclic-reduction coefficient tables
(/root/reference/code/cuda/solvers/templated/near_toeplitz.py:109-184).

Three solver families:

* ``thomas_factor`` / ``thomas_solve`` — LU (Thomas) with precomputed
  multipliers, applied with two ``lax.scan`` sweeps. Works for any n;
  numerically the strongest; O(n) work, O(n) sequential depth.
* ``pcr_factor`` / ``pcr_solve`` — parallel cyclic reduction with
  precomputed per-level RHS-update coefficients. O(n log n) work but only
  ceil(log2 n) fused full-batch vector steps — no scan, XLA-friendly.
  Any n (zero-fill shifts).
* ``cyclic_factor`` / ``cyclic_solve`` — periodic (cyclic) tridiagonal via
  Sherman–Morrison over either core solver: one core solve plus a rank-1
  correction whose vector ``q`` is precomputed.

Solve convention: RHS has shape ``(n, *batch)`` — the solve axis leading,
the batch contiguous.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ThomasFactors",
    "PCRFactors",
    "CyclicFactors",
    "thomas_factor",
    "thomas_solve",
    "pcr_factor",
    "pcr_solve",
    "cyclic_factor",
    "cyclic_solve",
    "solve",
]


class ThomasFactors(NamedTuple):
    """Precomputed LU multipliers; all shape (n,).

    ``w[i]``   — forward multiplier dl[i]/dhat[i-1] (w[0] = 0)
    ``invd[i]``— 1/dhat[i]
    ``du[i]``  — original superdiagonal (du[n-1] = 0)
    """

    w: np.ndarray
    invd: np.ndarray
    du: np.ndarray


class PCRFactors(NamedTuple):
    """Per-level RHS-update coefficients; k1/k2 shape (L, n), invb (n,).

    Level l eliminates stride ``2**l`` couplings:
        d <- d - k1[l]*shift_down(d, 2**l) - k2[l]*shift_up(d, 2**l)
    and finally x = invb * d.
    """

    k1: np.ndarray
    k2: np.ndarray
    invb: np.ndarray


class CyclicFactors(NamedTuple):
    """Sherman–Morrison data for a cyclic system A = A' + u v^T.

    ``core``  — factors of the modified (acyclic) A'
    ``q``     — A'^{-1} u, shape (n,)
    ``v0, vn``— components of v (v = v0*e0 + vn*e_{n-1})
    ``inv_denom`` — 1/(1 + v·q)
    """

    core: NamedTuple
    q: np.ndarray
    v0: float
    vn: float
    inv_denom: float


def _as_f64(*arrs):
    return [np.asarray(a, dtype=np.float64) for a in arrs]


def _thomas_solve_np(dl, d, du, rhs):
    """Plain float64 numpy Thomas solve (setup-time only)."""
    dl, d, du, rhs = _as_f64(dl, d, du, rhs)
    n = d.shape[0]
    dhat = d.copy()
    y = rhs.copy()
    for i in range(1, n):
        w = dl[i] / dhat[i - 1]
        dhat[i] = d[i] - w * du[i - 1]
        y[i] = y[i] - w * y[i - 1]
    x = np.empty_like(y)
    x[n - 1] = y[n - 1] / dhat[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (y[i] - du[i] * x[i + 1]) / dhat[i]
    return x


# ---------------------------------------------------------------------------
# Thomas
# ---------------------------------------------------------------------------


def thomas_factor(dl, d, du) -> ThomasFactors:
    """Precompute LU multipliers for bands (dl, d, du), each shape (n,).

    dl[0] and du[n-1] are ignored (treated as 0).
    """
    dl, d, du = _as_f64(dl, d, du)
    n = d.shape[0]
    w = np.zeros(n)
    dhat = np.empty(n)
    dhat[0] = d[0]
    for i in range(1, n):
        w[i] = dl[i] / dhat[i - 1]
        dhat[i] = d[i] - w[i] * du[i - 1]
    du = du.copy()
    du[-1] = 0.0
    return ThomasFactors(w=w, invd=1.0 / dhat, du=du)


def thomas_solve(factors: ThomasFactors, rhs: jax.Array) -> jax.Array:
    """Solve for every column of ``rhs`` (shape (n, *batch))."""
    dtype = rhs.dtype
    w = jnp.asarray(factors.w, dtype)
    invd = jnp.asarray(factors.invd, dtype)
    du = jnp.asarray(factors.du, dtype)
    bshape = rhs.shape[1:]

    def bcast(x):
        return x.reshape(x.shape[:1] + (1,) * len(bshape))

    zero = jnp.zeros(bshape, dtype)

    def fwd(carry, inp):
        w_i, r_i = inp
        y = r_i - w_i * carry
        return y, y

    _, ys = jax.lax.scan(fwd, zero, (bcast(w), rhs))

    def bwd(carry, inp):
        invd_i, du_i, y_i = inp
        x = (y_i - du_i * carry) * invd_i
        return x, x

    _, xs = jax.lax.scan(bwd, zero, (bcast(invd), bcast(du), ys), reverse=True)
    return xs


# ---------------------------------------------------------------------------
# PCR with precomputed RHS-update tables
# ---------------------------------------------------------------------------


def pcr_factor(dl, d, du) -> PCRFactors:
    """Precompute PCR elimination tables for bands (dl, d, du)."""
    a, b, c = _as_f64(dl, d, du)
    a = a.copy()
    b = b.copy()
    c = c.copy()
    n = b.shape[0]
    a[0] = 0.0
    c[-1] = 0.0
    levels = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    k1s = np.zeros((levels, n))
    k2s = np.zeros((levels, n))
    idx = np.arange(n)
    for l in range(levels):
        s = 1 << l
        im = idx - s
        ip = idx + s
        b_im = np.where(im >= 0, b[np.clip(im, 0, n - 1)], 1.0)
        b_ip = np.where(ip < n, b[np.clip(ip, 0, n - 1)], 1.0)
        a_im = np.where(im >= 0, a[np.clip(im, 0, n - 1)], 0.0)
        c_im = np.where(im >= 0, c[np.clip(im, 0, n - 1)], 0.0)
        a_ip = np.where(ip < n, a[np.clip(ip, 0, n - 1)], 0.0)
        c_ip = np.where(ip < n, c[np.clip(ip, 0, n - 1)], 0.0)
        k1 = a / b_im
        k2 = c / b_ip
        k1s[l] = k1
        k2s[l] = k2
        b = b - k1 * c_im - k2 * a_ip
        a = -k1 * a_im
        c = -k2 * c_ip
    return PCRFactors(k1=k1s, k2=k2s, invb=1.0 / b)


def pcr_solve(factors: PCRFactors, rhs: jax.Array, axis: int = 0) -> jax.Array:
    """Apply precomputed PCR tables to ``rhs`` along ``axis``.

    Axis-aware so the solve can run along the minor (lane) dimension of a
    pencil-major field with no transposes — every level is a shifted fused
    multiply-add over the whole batch.
    """
    dtype = rhs.dtype
    axis = axis % rhs.ndim
    k1 = jnp.asarray(factors.k1, dtype)
    k2 = jnp.asarray(factors.k2, dtype)
    invb = jnp.asarray(factors.invb, dtype)
    n = rhs.shape[axis]

    def bcast(x):
        shape = [1] * rhs.ndim
        shape[axis] = n
        return x.reshape(shape)

    def shift_down(d, s):  # d[i-s] along axis, zero-filled at the start
        pad = [(0, 0)] * rhs.ndim
        pad[axis] = (s, 0)
        return jnp.pad(jax.lax.slice_in_dim(d, 0, n - s, axis=axis), pad)

    def shift_up(d, s):  # d[i+s], zero-filled at the end
        pad = [(0, 0)] * rhs.ndim
        pad[axis] = (0, s)
        return jnp.pad(jax.lax.slice_in_dim(d, s, n, axis=axis), pad)

    d = rhs
    levels = k1.shape[0]
    for l in range(levels):
        s = 1 << l
        d = d - bcast(k1[l]) * shift_down(d, s) - bcast(k2[l]) * shift_up(d, s)
    return bcast(invb) * d


# ---------------------------------------------------------------------------
# Cyclic (periodic) via Sherman–Morrison
# ---------------------------------------------------------------------------


def cyclic_factor(
    dl, d, du, corner_top: float, corner_bot: float, method: str = "pcr"
) -> CyclicFactors:
    """Factor a cyclic tridiagonal system.

    ``corner_top`` couples row 0 to x[n-1]; ``corner_bot`` couples row n-1 to
    x[0] (both equal alpha for periodic compact schemes).
    """
    dl, d, du = _as_f64(dl, d, du)
    n = d.shape[0]
    gamma = -d[0]
    d_mod = d.copy()
    d_mod[0] = d[0] - gamma
    d_mod[-1] = d[-1] - corner_top * corner_bot / gamma
    factor_fn = {"pcr": pcr_factor, "thomas": thomas_factor}[method]
    core = factor_fn(dl, d_mod, du)
    u = np.zeros(n)
    u[0] = gamma
    u[-1] = corner_bot
    # q is computed in full-precision numpy so setup never depends on the
    # runtime x64 mode.
    q = _thomas_solve_np(dl, d_mod, du, u)
    v0 = 1.0
    vn = corner_top / gamma
    denom = 1.0 + v0 * q[0] + vn * q[-1]
    return CyclicFactors(core=core, q=q, v0=v0, vn=vn, inv_denom=1.0 / denom)


def cyclic_solve(factors: CyclicFactors, rhs: jax.Array, axis: int = 0) -> jax.Array:
    """Solve the cyclic system against ``rhs`` along ``axis``."""
    dtype = rhs.dtype
    axis = axis % rhs.ndim
    core = factors.core
    if isinstance(core, PCRFactors):
        y = pcr_solve(core, rhs, axis=axis)
    elif axis == 0:
        y = thomas_solve(core, rhs)
    else:
        y = jnp.moveaxis(thomas_solve(core, jnp.moveaxis(rhs, axis, 0)), 0, axis)
    q = jnp.asarray(factors.q, dtype)
    shape = [1] * rhs.ndim
    shape[axis] = q.shape[0]
    q = q.reshape(shape)
    y0 = jax.lax.index_in_dim(y, 0, axis=axis, keepdims=True)
    yn = jax.lax.index_in_dim(y, y.shape[axis] - 1, axis=axis, keepdims=True)
    # v0/vn/inv_denom are numpy float64 scalars; cast so f32 inputs stay f32
    vy = jnp.asarray(factors.v0, dtype) * y0 + jnp.asarray(factors.vn, dtype) * yn
    return y - q * (jnp.asarray(factors.inv_denom, dtype) * vy)


def solve(factors, rhs: jax.Array, axis: int = 0) -> jax.Array:
    """Dispatch on factor type; solves along ``axis``."""
    if isinstance(factors, ThomasFactors):
        if axis % rhs.ndim == 0:
            return thomas_solve(factors, rhs)
        return jnp.moveaxis(
            thomas_solve(factors, jnp.moveaxis(rhs, axis, 0)), 0, axis % rhs.ndim
        )
    if isinstance(factors, PCRFactors):
        return pcr_solve(factors, rhs, axis=axis)
    if isinstance(factors, CyclicFactors):
        return cyclic_solve(factors, rhs, axis=axis)
    raise TypeError(f"unknown factor type {type(factors)}")


def factor(dl, d, du, method: str = "pcr"):
    """Factor acyclic bands with the chosen method ('pcr' | 'thomas')."""
    return {"pcr": pcr_factor, "thomas": thomas_factor}[method](dl, d, du)
