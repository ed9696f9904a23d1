"""Serial CPU reference ("oracle") for compact derivatives.

Builds the full-line tridiagonal system for a scheme and solves it with
scipy, exactly as the reference's tests do against
``scipy.linalg.solve_banded`` (/root/reference/code/cuda/compact.py:189-203,
code/cuda/test/test_kernels.py:29-53). Periodic schemes are solved with a
dense numpy solve (oracle only — O(n^2), never on the hot path).

Everything here is float64 numpy; this module is the correctness anchor for
every JAX path in the package.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solve_banded

from ..schemes import CompactScheme, lhs_bands, rhs_matrix

__all__ = ["compact_rhs_np", "solve_line_np", "derivative_np"]


def compact_rhs_np(scheme: CompactScheme, f: np.ndarray, dx: float) -> np.ndarray:
    """RHS of the compact system along the leading axis of ``f``: (n, *batch)."""
    f = np.asarray(f, dtype=np.float64)
    n = f.shape[0]
    B = rhs_matrix(scheme, n)
    return np.tensordot(B, f, axes=(1, 0)) / dx**scheme.derivative_order


def solve_line_np(scheme: CompactScheme, rhs: np.ndarray) -> np.ndarray:
    """Solve the scheme's LHS against ``rhs`` of shape (n, *batch)."""
    rhs = np.asarray(rhs, dtype=np.float64)
    n = rhs.shape[0]
    dl, d, du = lhs_bands(scheme, n)
    if scheme.periodic:
        A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
        A[0, -1] = scheme.alpha
        A[-1, 0] = scheme.alpha
        flat = rhs.reshape(n, -1)
        x = np.linalg.solve(A, flat)
        return x.reshape(rhs.shape)
    ab = np.zeros((3, n))
    ab[0, 1:] = du[:-1]
    ab[1, :] = d
    ab[2, :-1] = dl[1:]
    flat = rhs.reshape(n, -1)
    x = solve_banded((1, 1), ab, flat)
    return x.reshape(rhs.shape)


def derivative_np(
    scheme: CompactScheme, f: np.ndarray, dx: float, axis: int = 0
) -> np.ndarray:
    """Full compact derivative of ``f`` along ``axis`` (float64; the
    scheme's ``derivative_order`` selects first or second derivative)."""
    f = np.moveaxis(np.asarray(f, dtype=np.float64), axis, 0)
    x = solve_line_np(scheme, compact_rhs_np(scheme, f, dx))
    return np.moveaxis(x, 0, axis)
