"""CPU numerical oracles (float64 numpy/scipy) for the device compute paths."""

from .banded import compact_rhs_np, derivative_np, solve_line_np
from .lanl import lanl_derivative_np, lanl_solve_np, precompute_beta

__all__ = [
    "compact_rhs_np",
    "derivative_np",
    "solve_line_np",
    "lanl_derivative_np",
    "lanl_solve_np",
    "precompute_beta",
]
