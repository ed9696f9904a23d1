"""Compact finite-difference scheme definitions.

A compact (Padé) scheme couples unknown derivatives through a tridiagonal
left-hand side. For the first derivative,

    alpha * f'[i-1] + f'[i] + alpha * f'[i+1] = RHS(f)[i] / dx

with an antisymmetric interior RHS stencil

    RHS(f)[i] = sum_k  w_k * (f[i+k] - f[i-k])

and, for non-periodic boundaries, one-sided closure rows near each edge.
Second-derivative schemes (``derivative_order == 2``) use the same
tridiagonal structure with a *symmetric* interior stencil

    RHS(f)[i] = sum_k  w_k * (f[i+k] - 2 f[i] + f[i-k])

scaled by 1/dx**2; right-edge closures mirror without the sign flip (d²/dx²
is invariant under x -> -x). Every solver, kernel, and oracle in the package
is scheme-table-driven, so both derivative orders ride the same machinery.

The reference implementation hard-codes the 4th-order interior scheme with a
3rd-order closure (see /root/reference/code/cuda/solvers/templated/
near_toeplitz.py:8-32 and kernels.cu:34-46, paraphrased in SURVEY.md §0).
This module generalises it into data: each scheme is a table of interior
weights plus explicit boundary rows, so solvers and kernels are
scheme-agnostic.

Schemes provided:

* ``SCHEME4``  — classic 4th-order Padé: alpha = 1/4, w1 = 3/4, with the
  reference's 3rd-order one-sided closure row at each end
  (kernels.cu:36-46).
* ``SCHEME6``  — 6th-order tridiagonal (Lele 1992, eq. 2.1.7): alpha = 1/3,
  w1 = 7/9, w2 = 1/36, closed with a 5th-order one-sided row at the wall and
  the 4th-order Padé row at the first interior point.
* periodic variants of both (no closure rows; cyclic tridiagonal LHS).

The right-edge closures are generated from the left ones by the mirror
antisymmetry of the first derivative (x -> -x flips the sign of f').
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

__all__ = [
    "BoundaryRow",
    "CompactScheme",
    "SCHEME4",
    "SCHEME6",
    "SCHEME4_PERIODIC",
    "SCHEME6_PERIODIC",
    "SCHEME4_D2",
    "SCHEME6_D2",
    "SCHEME4_D2_PERIODIC",
    "SCHEME6_D2_PERIODIC",
    "get_scheme",
    "get_filter",
    "transfer_function",
    "modified_wavenumber",
    "resolving_efficiency",
    "lhs_bands",
    "rhs_matrix",
]


@dataclasses.dataclass(frozen=True)
class BoundaryRow:
    """One closure row of the scheme, expressed from the *left* edge.

    ``lhs`` is the (sub, diag, super) entry of the tridiagonal LHS for this
    row; ``rhs_stencil`` are dense weights over the first ``len(rhs_stencil)``
    grid values, so the equation for row j is

        lhs[0]*f'[j-1] + lhs[1]*f'[j] + lhs[2]*f'[j+1]
            = sum_m rhs_stencil[m] * f[m] / dx
    """

    lhs: Tuple[float, float, float]
    rhs_stencil: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class CompactScheme:
    """A compact derivative scheme (interior + closures).

    ``derivative_order`` is 1 (antisymmetric RHS, 1/dx scaling) or 2
    (symmetric RHS with a -2 f[i] centre term, 1/dx**2 scaling).
    """

    name: str
    order: int
    periodic: bool
    alpha: float
    rhs_offsets: Tuple[int, ...]
    rhs_weights: Tuple[float, ...]
    left_rows: Tuple[BoundaryRow, ...] = ()
    derivative_order: int = 1
    rhs_center_weight: float = None

    @property
    def rhs_sign(self) -> float:
        """Sign of the f[i-k] term: -1 (odd derivative) or +1 (even)."""
        return -1.0 if self.derivative_order % 2 else 1.0

    @property
    def rhs_center(self) -> float:
        """Weight of the f[i] centre term.

        0 for first derivatives, -2*sum(w) for second derivatives (the
        (f[i+k] - 2 f[i] + f[i-k]) form), and an explicit free coefficient
        for filters (derivative_order=0), where it is an independent
        parameter of the transfer function.
        """
        if self.rhs_center_weight is not None:
            return self.rhs_center_weight
        if self.derivative_order % 2:
            return 0.0
        if self.derivative_order == 0:
            raise ValueError(
                f"scheme {self.name}: derivative_order=0 (filter) requires "
                "an explicit rhs_center_weight"
            )
        return -2.0 * sum(self.rhs_weights)

    @property
    def stencil_width(self) -> int:
        """Halo width required by the interior RHS stencil."""
        return max(self.rhs_offsets)

    @property
    def n_closure(self) -> int:
        return len(self.left_rows)

    @property
    def right_rows(self) -> Tuple[BoundaryRow, ...]:
        """Closure rows at the right edge, mirrored from the left ones.

        Row j from the right: lhs reversed, RHS stencil reversed and — for
        odd derivative orders — negated (x -> -x flips the sign of f' but
        not of f''), indexing f from the right edge inward. Matches the
        reference's explicit right closure (kernels.cu:42-46: the negated
        mirror of the left row).
        """
        s = self.rhs_sign
        out = []
        for row in self.left_rows:
            a, b, c = row.lhs
            out.append(
                BoundaryRow(
                    lhs=(c, b, a),
                    rhs_stencil=tuple(s * w for w in row.rhs_stencil),
                )
            )
        return tuple(out)

    def min_points(self) -> int:
        if self.periodic:
            return 2 * self.stencil_width + 1
        widest = max(
            [len(r.rhs_stencil) for r in self.left_rows] + [2 * self.stencil_width + 1]
        )
        return max(widest, 2 * self.n_closure + 1)


# ---------------------------------------------------------------------------
# Scheme tables
# ---------------------------------------------------------------------------

# 4th-order Padé interior:  (1/4, 1, 1/4) f' = (3/4)(f[i+1]-f[i-1])/dx
# 3rd-order closure:        f'[0] + 2 f'[1] = (-5 f0 + 4 f1 + f2) / (2 dx)
SCHEME4 = CompactScheme(
    name="pade4",
    order=4,
    periodic=False,
    alpha=0.25,
    rhs_offsets=(1,),
    rhs_weights=(0.75,),
    left_rows=(BoundaryRow(lhs=(0.0, 1.0, 2.0), rhs_stencil=(-2.5, 2.0, 0.5)),),
)

SCHEME4_PERIODIC = dataclasses.replace(
    SCHEME4, name="pade4_periodic", periodic=True, left_rows=()
)

# 6th-order tridiagonal interior (Lele 1992 eq. 2.1.7):
#   (1/3, 1, 1/3) f' = (14/9)(f[i+1]-f[i-1])/(2dx) + (1/9)(f[i+2]-f[i-2])/(4dx)
# Wall closure (5th-order, Lele eq. 4.1.4 family):
#   f'[0] + 5 f'[1] = (-197/60 f0 - 5/12 f1 + 5 f2 - 5/3 f3 + 5/12 f4 - 1/20 f5)/dx
# Next-to-wall row: the 4th-order Padé interior row (only needs f[0..2]).
SCHEME6 = CompactScheme(
    name="lele6",
    order=6,
    periodic=False,
    alpha=1.0 / 3.0,
    rhs_offsets=(1, 2),
    rhs_weights=(7.0 / 9.0, 1.0 / 36.0),
    left_rows=(
        BoundaryRow(
            lhs=(0.0, 1.0, 5.0),
            rhs_stencil=(
                -197.0 / 60.0,
                -5.0 / 12.0,
                5.0,
                -5.0 / 3.0,
                5.0 / 12.0,
                -1.0 / 20.0,
            ),
        ),
        BoundaryRow(lhs=(0.25, 1.0, 0.25), rhs_stencil=(-0.75, 0.0, 0.75)),
    ),
)

SCHEME6_PERIODIC = dataclasses.replace(
    SCHEME6, name="lele6_periodic", periodic=True, left_rows=()
)

# ---------------------------------------------------------------------------
# Second-derivative schemes (derivative_order = 2; Lele 1992 §2.2/§4.3).
# Interior RHS form: sum_k w_k (f[i+k] - 2 f[i] + f[i-k]) / dx^2.
# ---------------------------------------------------------------------------

# 4th-order Padé d2: (1/10, 1, 1/10) f'' = (6/5)(f[i+1]-2f[i]+f[i-1])/dx^2
# (Lele eq. 2.2.7 with alpha=1/10). Wall closure, 4th-order exact
# (verified on x^p, p<=4):
#   f''[0] + 11 f''[1] = (13 f0 - 27 f1 + 15 f2 - f3) / dx^2
SCHEME4_D2 = CompactScheme(
    name="pade4_d2",
    order=4,
    periodic=False,
    alpha=0.1,
    rhs_offsets=(1,),
    rhs_weights=(1.2,),
    left_rows=(BoundaryRow(lhs=(0.0, 1.0, 11.0), rhs_stencil=(13.0, -27.0, 15.0, -1.0)),),
    derivative_order=2,
)

SCHEME4_D2_PERIODIC = dataclasses.replace(
    SCHEME4_D2, name="pade4_d2_periodic", periodic=True, left_rows=()
)

# 6th-order tridiagonal d2 (Lele eq. 2.2.7, alpha=2/11):
#   (2/11, 1, 2/11) f'' = (12/11)(f[i+1]-2f[i]+f[i-1])/dx^2
#                        + (3/44)(f[i+2]-2f[i]+f[i-2])/dx^2
# Wall closure: the unique 6-point one-sided row exact on x^p, p<=6
# (solved from the order conditions; the textbook 5-point row has LHS
# weight 10, which makes the leading 2x2 block against the next row's
# alpha=1/10 exactly singular — LU without pivoting breaks down):
#   f''[0] + (137/13) f''[1] = (1955/156 f0 - 4057/156 f1 + 1117/78 f2
#                               - 55/78 f3 - 29/156 f4 + 7/156 f5) / dx^2
# Next-to-wall row: the 4th-order Padé d2 interior row (needs f[0..2] only).
SCHEME6_D2 = CompactScheme(
    name="lele6_d2",
    order=6,
    periodic=False,
    alpha=2.0 / 11.0,
    rhs_offsets=(1, 2),
    rhs_weights=(12.0 / 11.0, 3.0 / 44.0),
    left_rows=(
        BoundaryRow(
            lhs=(0.0, 1.0, 137.0 / 13.0),
            rhs_stencil=(
                1955.0 / 156.0,
                -4057.0 / 156.0,
                1117.0 / 78.0,
                -55.0 / 78.0,
                -29.0 / 156.0,
                7.0 / 156.0,
            ),
        ),
        BoundaryRow(lhs=(0.1, 1.0, 0.1), rhs_stencil=(1.2, -2.4, 1.2)),
    ),
    derivative_order=2,
)

SCHEME6_D2_PERIODIC = dataclasses.replace(
    SCHEME6_D2, name="lele6_d2_periodic", periodic=True, left_rows=()
)

_SCHEMES = {
    (4, False, 1): SCHEME4,
    (4, True, 1): SCHEME4_PERIODIC,
    (6, False, 1): SCHEME6,
    (6, True, 1): SCHEME6_PERIODIC,
    (4, False, 2): SCHEME4_D2,
    (4, True, 2): SCHEME4_D2_PERIODIC,
    (6, False, 2): SCHEME6_D2,
    (6, True, 2): SCHEME6_D2_PERIODIC,
}


@functools.lru_cache(maxsize=None)
def get_filter(
    order: int = 6, alpha: float = 0.45, periodic: bool = False
) -> CompactScheme:
    """Compact (Padé-type) low-pass filter scheme of the given order.

    Lele 1992 §C tridiagonal filters (the Gaitonde–Visbal F4/F6 family):

        alpha fh[i-1] + fh[i] + alpha fh[i+1]
            = c0 f[i] + sum_k w_k (f[i+k] + f[i-k])

    with coefficients solved from the transfer-function order conditions:
    G(0) = 1 (constants exact), G(pi) = 0 (the Nyquist sawtooth is
    annihilated exactly), and G(k) = 1 - O(k^order). ``alpha`` in
    (-0.5, 0.5) tunes sharpness: larger alpha keeps more of the resolved
    band (alpha=0.5 is the identity). Non-periodic boundaries leave the
    outermost ``order/2`` points unfiltered (identity rows), the standard
    practice for boundary filter closures.

    Filters are ``derivative_order=0`` schemes: no spacing scale, the
    symmetric RHS form, and every solver backend/oracle/distributed path of
    this package applies unchanged.
    """
    if not -0.5 < alpha < 0.5:
        raise ValueError(f"filter alpha must be in (-0.5, 0.5), got {alpha}")
    if order == 4:
        # w1, w2 solved from G(0)=1, sum w_k k^2 = alpha, G(pi)=0
        weights = ((1.0 + 2.0 * alpha) / 4.0, -(1.0 - 2.0 * alpha) / 16.0)
        center = (5.0 + 6.0 * alpha) / 8.0
        offsets = (1, 2)
    elif order == 6:
        # additionally sum w_k k^4 = alpha (6th-order flatness at k=0)
        weights = (
            15.0 / 64.0 + 17.0 * alpha / 32.0,
            -3.0 * (1.0 - 2.0 * alpha) / 32.0,
            (1.0 - 2.0 * alpha) / 64.0,
        )
        center = (11.0 + 10.0 * alpha) / 16.0
        offsets = (1, 2, 3)
    else:
        raise ValueError(f"no compact filter of order {order}; available: 4, 6")
    width = max(offsets)
    rows = tuple(
        BoundaryRow(lhs=(0.0, 1.0, 0.0), rhs_stencil=(0.0,) * j + (1.0,))
        for j in range(width)
    )
    return CompactScheme(
        name=f"filter{order}_a{alpha:g}" + ("_periodic" if periodic else ""),
        order=order,
        periodic=periodic,
        alpha=alpha,
        rhs_offsets=offsets,
        rhs_weights=weights,
        left_rows=() if periodic else rows,
        derivative_order=0,
        rhs_center_weight=center,
    )


def get_scheme(
    order: int = 4, periodic: bool = False, derivative: int = 1
) -> CompactScheme:
    """Scheme of accuracy ``order`` for the ``derivative``-th derivative."""
    try:
        return _SCHEMES[(order, periodic, derivative)]
    except KeyError:
        raise ValueError(
            f"no compact scheme of order {order} (periodic={periodic}, "
            f"derivative={derivative}); available: {sorted(_SCHEMES)}"
        ) from None


def transfer_function(scheme: CompactScheme, k) -> np.ndarray:
    """Periodic-interior spectral response of the scheme at wavenumber ``k``.

    ``k`` is the scaled wavenumber (k_phys * dx, in [0, pi]). Returns, per
    Lele 1992's analysis conventions:

    * derivative_order 1 — the **modified wavenumber** k'(k): applying the
      scheme to exp(i k x / dx) multiplies it by i k' / dx (exact scheme:
      k' = k). Real, since the stencil is antisymmetric.
    * derivative_order 2 — the modified squared wavenumber k''(k):
      the scheme multiplies exp(ikx/dx) by -k'' / dx^2 (exact: k'' = k^2).
    * derivative_order 0 (filters) — the filter gain G(k) (G(0) = 1,
      G(pi) = 0 by construction).

    numpy-level helper (scheme design/analysis and the spectral tests);
    never traced.
    """
    k = np.asarray(k, np.float64)
    lhs = 1.0 + 2.0 * scheme.alpha * np.cos(k)
    w = np.asarray(scheme.rhs_weights)
    j = np.asarray(scheme.rhs_offsets)
    if scheme.derivative_order == 1:
        num = 2.0 * (w[:, None] * np.sin(np.outer(j, k))).sum(0)
        return num / lhs
    num = scheme.rhs_center + 2.0 * (w[:, None] * np.cos(np.outer(j, k))).sum(0)
    if scheme.derivative_order == 2:
        return -num / lhs
    return num / lhs


def modified_wavenumber(scheme: CompactScheme, k) -> np.ndarray:
    """Alias of ``transfer_function`` for derivative schemes (Lele's k')."""
    if scheme.derivative_order == 0:
        raise ValueError("filters have a gain G(k), not a modified wavenumber")
    return transfer_function(scheme, k)


def resolving_efficiency(scheme: CompactScheme, tol: float = 0.01) -> float:
    """Fraction of [0, pi] over which the scheme's modified wavenumber
    tracks the exact one within ``tol`` relative error (Lele's resolving-
    efficiency metric; e.g. ~0.57 for the 6th-order tridiagonal first
    derivative at tol=0.01)."""
    if scheme.derivative_order == 0:
        raise ValueError(
            "filters have a gain G(k), not a modified wavenumber; "
            "resolving_efficiency applies to derivative schemes only"
        )
    k = np.linspace(1e-6, np.pi, 4096)
    got = transfer_function(scheme, k)
    exact = k if scheme.derivative_order == 1 else k**2
    ok = np.abs(got - exact) <= tol * exact
    bad = np.nonzero(~ok)[0]
    edge = np.pi if bad.size == 0 else k[bad[0]]
    return float(edge / np.pi)


# ---------------------------------------------------------------------------
# Dense/banded assembly helpers (numpy; used by oracles, factor precompute
# and tests — never inside jit-traced code)
# ---------------------------------------------------------------------------


def lhs_bands(
    scheme: CompactScheme,
    n: int,
    *,
    first_block: bool = True,
    last_block: bool = True,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return the (dl, d, du) bands of the scheme's LHS for an ``n``-row block.

    ``first_block`` / ``last_block`` control whether boundary-closure rows are
    installed at the top/bottom. For a distributed line split into blocks,
    interior blocks take plain interior rows (the coupling to neighbouring
    blocks is carried by the substructuring method, mirroring the per-rank
    patching in the reference at code/cuda/compact.py:159-166).

    Convention: dl[i] multiplies x[i-1] (dl[0] unused = 0), du[i] multiplies
    x[i+1] (du[n-1] unused = 0). For periodic schemes the cyclic corner
    couplings (row 0 -> x[n-1], row n-1 -> x[0]) are *not* representable in
    the bands; the cyclic solver accounts for them via alpha corners.
    """
    if n < scheme.min_points():
        raise ValueError(f"n={n} too small for scheme {scheme.name}")
    dl = np.full(n, scheme.alpha, dtype=dtype)
    d = np.ones(n, dtype=dtype)
    du = np.full(n, scheme.alpha, dtype=dtype)
    dl[0] = 0.0
    du[-1] = 0.0
    if not scheme.periodic:
        if first_block:
            for j, row in enumerate(scheme.left_rows):
                a, b, c = row.lhs
                if j > 0:
                    dl[j] = a
                d[j] = b
                if j < n - 1:
                    du[j] = c
        if last_block:
            for j, row in enumerate(scheme.right_rows):
                i = n - 1 - j
                a, b, c = row.lhs
                if i > 0:
                    dl[i] = a
                d[i] = b
                if i < n - 1:
                    du[i] = c
    return dl, d, du


def rhs_matrix(scheme: CompactScheme, n: int, dtype=np.float64) -> np.ndarray:
    """Dense (n, n) matrix B with RHS = B @ f / dx (single full line).

    Oracle/test helper — O(n^2) storage, never used on the hot path.
    """
    B = np.zeros((n, n), dtype=dtype)
    s = scheme.rhs_sign
    c0 = scheme.rhs_center
    for k, w in zip(scheme.rhs_offsets, scheme.rhs_weights):
        for i in range(n):
            ip = (i + k) % n if scheme.periodic else i + k
            im = (i - k) % n if scheme.periodic else i - k
            if scheme.periodic or (0 <= ip < n and 0 <= im < n):
                B[i, ip] += w
                B[i, im] += s * w
    if c0:
        B[np.arange(n), np.arange(n)] += c0
    if not scheme.periodic:
        # zero out and install closure rows
        for j, row in enumerate(scheme.left_rows):
            B[j, :] = 0.0
            B[j, : len(row.rhs_stencil)] = row.rhs_stencil
        for j, row in enumerate(scheme.right_rows):
            i = n - 1 - j
            B[i, :] = 0.0
            m = len(row.rhs_stencil)
            B[i, n - m :] = row.rhs_stencil[::-1]
        # interior rows whose symmetric stencil would poke outside the domain
        # do not exist for valid n (guarded by min_points), except rows within
        # stencil_width of a closure region when n_closure < stencil_width.
        for i in range(scheme.n_closure, scheme.stencil_width):
            raise ValueError(
                f"scheme {scheme.name}: row {i} needs offsets beyond the "
                "boundary but has no closure row"
            )
    return B
