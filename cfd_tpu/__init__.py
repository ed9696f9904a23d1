"""cfd_tpu — a compact finite-difference framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
CUDA/OpenCL + MPI library ``ashwinsrnth/compact-finite-differences``:
4th/6th-order compact (Padé) first and second derivatives of 3-D scalar
fields (second derivatives are beyond the reference's surface), batched
near-Toeplitz tridiagonal solves with precomputed coefficient tables, pencil
domain decomposition over a ``jax.sharding.Mesh`` with ``ppermute`` halo
exchange, and a distributed reduced-interface (substructuring) tridiagonal
solve closed with an ``all_gather`` over the line axis.

See SURVEY.md for the structural map of the reference and BASELINE.md for the
performance baselines this package is measured against.
"""

from . import models, oracle, ops, parallel, schemes, utils
from .parallel import DistributedCompactSolver, Grid, make_mesh
from .ops import (
    curl,
    d2fdx2,
    d2fdy2,
    d2fdz2,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    divergence,
    filter_field,
    gradient,
    laplacian,
    project,
    solve_poisson,
)
from .schemes import (
    SCHEME4,
    SCHEME4_D2,
    SCHEME4_D2_PERIODIC,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_D2,
    SCHEME6_D2_PERIODIC,
    SCHEME6_PERIODIC,
    CompactScheme,
    get_filter,
    get_scheme,
)

__version__ = "0.1.0"

__all__ = [
    "oracle",
    "ops",
    "parallel",
    "schemes",
    "utils",
    "DistributedCompactSolver",
    "Grid",
    "make_mesh",
    "curl",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "divergence",
    "filter_field",
    "gradient",
    "laplacian",
    "project",
    "solve_poisson",
    "CompactScheme",
    "get_filter",
    "get_scheme",
    "SCHEME4",
    "SCHEME4_PERIODIC",
    "SCHEME6",
    "SCHEME6_PERIODIC",
    "SCHEME4_D2",
    "SCHEME4_D2_PERIODIC",
    "SCHEME6_D2",
    "SCHEME6_D2_PERIODIC",
]
