"""Device-side phi/psi (parameterized-LU) distributed tridiagonal solve.

The device-side rebuild of the reference's *second* distributed algorithm — the
CFDNS/Roadrunner NPTS sweeps of /root/reference/lanl-implementation/
npts.c:275-576 (python port lanl-implementation/python/npts.py), which
round 1 carried only as the CPU oracle (cfd_tpu/oracle/lanl.py). Exposed as
``DistributedCompactSolver(..., method='phipsi')``; non-periodic schemes
only, matching the reference.

Algorithm, reshaped for accelerators:

* The global LU pivots ``beta`` and everything RHS-independent (``psi``,
  ``eta``, the per-shard bidiagonal-inverse operators, the chain-closure
  coefficient rows) are precomputed in float64 at trace time — the
  analogue of ``precompute_beta_gam`` (npts.c:580-655) without its
  rank-to-rank pipeline.
* Each shard's forward substitution ``phi_i = rhs_i - k_i phi_{i-1}`` is a
  dense matmul against the precomputed inverse of its unit-lower-bidiagonal
  block (the inverse decays geometrically, so it is well-conditioned) —
  sequential work becomes one matmul, exactly like the substructuring
  path's block solves.
* The reference's serial rank-to-rank closure of the affine face chain
  ``Y_r = phi^last_r + psi^last_r Y_{r-1}`` (npts.c:314-447) is replaced by
  one ``all_gather`` of faces plus a redundant dot with this shard's
  precomputed row of the chain matrix — O(log p) instead of O(p) critical
  path, and no pipeline bubbles.
* The backward sweep mirrors with ``theta``/``eta`` and a second
  gather+dot (npts.c:449-569).

Cost per line point vs the default substructuring method: two dense block
passes and two gathers instead of one pass and one gather, so the
structural count favours substructuring as the default. Kept as a
first-class method, for algorithm parity, and for on-device
cross-validation (1e-10 agreement asserted in tests).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..oracle.lanl import precompute_beta
from ..schemes import CompactScheme, lhs_bands

__all__ = ["phipsi_tables", "PhiPsiTables", "phipsi_lines"]


@dataclasses.dataclass(frozen=True)
class PhiPsiTables:
    """Per-shard phi/psi tables, float64 numpy, stacked over the p shards.

    * ``linv``  — (p, nl, nl) inverses of the unit-lower-bidiagonal forward
                  blocks (phi = linv @ rhs)
    * ``uinv``  — (p, nl, nl) inverses of the upper-bidiagonal backward
                  blocks (theta = uinv @ y)
    * ``psi``   — (p, nl) forward homogeneous solutions
    * ``eta``   — (p, nl) backward homogeneous solutions
    * ``yrow``  — (p, p) row r = coefficients of Y_{r-1} over the gathered
                  forward faces (row 0 is zero)
    * ``xrow``  — (p, p) row r = coefficients of X_{r+1} over the gathered
                  backward faces (row p-1 is zero)
    """

    linv: np.ndarray
    uinv: np.ndarray
    psi: np.ndarray
    eta: np.ndarray
    yrow: np.ndarray
    xrow: np.ndarray


@functools.lru_cache(maxsize=None)
def phipsi_tables(scheme: CompactScheme, n: int, p: int) -> PhiPsiTables:
    if scheme.periodic:
        raise ValueError(
            "method='phipsi' implements non-periodic lines only (reference "
            "npts.c parity); use the default substructuring method"
        )
    if n % p:
        raise ValueError(f"global extent {n} not divisible by mesh axis {p}")
    nl = n // p
    widest = max(
        [len(r.rhs_stencil) for r in scheme.left_rows]
        + [2 * scheme.stencil_width + 1]
    )
    if nl < widest:
        raise ValueError(
            f"local extent {nl} shorter than the closure/interior stencil "
            f"({widest} points) of scheme {scheme.name}; use fewer shards"
        )
    dl, d, du = lhs_bands(scheme, n)
    beta = precompute_beta(dl, d, du)
    k = np.zeros(n)
    k[1:] = dl[1:] / beta[:-1]

    linv = np.zeros((p, nl, nl))
    uinv = np.zeros((p, nl, nl))
    psi = np.zeros((p, nl))
    eta = np.zeros((p, nl))
    for r in range(p):
        s = r * nl
        # forward block: unit lower bidiagonal with subdiagonal k[s+1:s+nl]
        L = np.eye(nl)
        for i in range(1, nl):
            L[i, i - 1] = k[s + i]
        linv[r] = np.linalg.inv(L)
        # homogeneous forward solution: psi[0] = -k[s] (0 for shard 0)
        if r > 0:
            psi[r, 0] = -k[s]
            for i in range(1, nl):
                psi[r, i] = -k[s + i] * psi[r, i - 1]
        # backward block: diag beta, superdiagonal du
        U = np.diag(beta[s : s + nl])
        for i in range(nl - 1):
            U[i, i + 1] = du[s + i]
        uinv[r] = np.linalg.inv(U)
        # homogeneous backward solution: eta[nl-1] = -du/beta (0 for last)
        if r < p - 1:
            eta[r, nl - 1] = -du[s + nl - 1] / beta[s + nl - 1]
            for i in range(nl - 2, -1, -1):
                eta[r, i] = -(du[s + i] / beta[s + i]) * eta[r, i + 1]

    # chain closures as dense coefficient rows over the gathered faces:
    #   Y_r = sum_{j<=r} (prod_{t=j+1..r} psi_last_t) phi_last_j
    psi_last = psi[:, -1]
    CY = np.zeros((p, p))
    for r in range(p):
        acc = 1.0
        for j in range(r, -1, -1):
            CY[r, j] = acc
            acc *= psi_last[j]
    eta_first = eta[:, 0]
    CX = np.zeros((p, p))
    for r in range(p - 1, -1, -1):
        acc = 1.0
        for j in range(r, p):
            CX[r, j] = acc
            acc *= eta_first[j]
    yrow = np.zeros((p, p))
    yrow[1:] = CY[:-1]  # shard r consumes Y_{r-1}
    xrow = np.zeros((p, p))
    xrow[:-1] = CX[1:]  # shard r consumes X_{r+1}
    return PhiPsiTables(
        linv=linv, uinv=uinv, psi=psi, eta=eta, yrow=yrow, xrow=xrow
    )


# fields shipped into shard_map, selected by name like
# DirectionTables.fields_for; each shard receives its own (1, ...) slice
PHIPSI_FIELDS = ("linv", "uinv", "psi", "eta", "yrow", "xrow")


def phipsi_lines(rhs, tables, *, axis_name: str, p: int):
    """Distributed phi/psi solve of shard-local lines ``rhs`` (nl, *batch).

    Runs inside shard_map; ``tables`` maps PHIPSI_FIELDS to this shard's
    (1, ...) slices of the stacked arrays.
    """
    dtype = rhs.dtype
    prec = (
        jax.lax.Precision.HIGHEST if dtype != jnp.float64 else None
    )
    bshape = rhs.shape[1:]
    flat = rhs.reshape(rhs.shape[0], -1)

    def tab(name):
        return tables[name][0].astype(dtype)

    # forward sweep: phi = L^{-1} rhs, then close the face chain with this
    # shard's precomputed coefficient row over the gathered faces
    phi = jnp.dot(tab("linv"), flat, precision=prec)
    faces = lax.all_gather(phi[-1:], axis_name, axis=0, tiled=True)  # (p, B)
    y_in = jnp.dot(tab("yrow"), faces, precision=prec)  # (B,)
    y = phi + tab("psi")[:, None] * y_in[None, :]

    # backward sweep: theta = U^{-1} y, then close the mirror chain
    theta = jnp.dot(tab("uinv"), y, precision=prec)
    faces_b = lax.all_gather(theta[:1], axis_name, axis=0, tiled=True)
    x_in = jnp.dot(tab("xrow"), faces_b, precision=prec)
    x = theta + tab("eta")[:, None] * x_in[None, :]
    return x.reshape(rhs.shape[:1] + bshape)
