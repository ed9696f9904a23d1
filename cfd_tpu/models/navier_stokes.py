"""Incompressible Navier–Stokes on a periodic box — third model family.

    du/dt + (u . grad) u = -grad p + nu * laplacian(u),   div u = 0

advanced by a fractional-step (pressure projection) method: each
Williamson RK3 stage advances the momentum equation without the pressure
term — exactly one viscous Burgers stage per component — then the stage
velocity is made discretely divergence-free by the
spectral Helmholtz projection (ops/poisson.project). Because periodic
compact operators are circulant, the projection annihilates *the compact
divergence this package computes* to rounding, not to truncation — after
every stage, ``divergence(u)`` is machine zero.

The classic validation is the 2-D Taylor–Green vortex embedded in 3-D
(z-independent): an exact Navier–Stokes solution decaying as
exp(-2 nu t), reproduced by the model to the schemes' truncation order
(tests/test_navier_stokes.py asserts the 4th-order convergence rate).

Reference lineage: the reference library stops at derivative evaluation —
its CFD consumer (the LANL CFDNS lineage its oracle comes from,
/root/reference/lanl-implementation/npts.c:1-7) is exactly this kind of
solver. The model family is beyond the reference's surface; every spatial
operator in it is this package's compact one.

Works single-device out of the box, and distributed via
``NavierStokes.distributed(grid)``: the momentum stages run the
distributed compact solver (parallel/compact.py), and the projection runs
the pencil-FFT sharded Poisson (parallel/spectral.py — all_to_all
transposes, no GSPMD gathers). ``divergence(step(u))`` is machine zero in
both modes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import derivatives as single
from ..ops.poisson import project, solve_poisson
from ..schemes import SCHEME4_PERIODIC, CompactScheme, get_scheme
from .advection_diffusion import Derivs
from .burgers import Burgers

__all__ = ["NavierStokes"]


@dataclasses.dataclass(frozen=True)
class NavierStokes:
    """RK3 fractional-step solver for incompressible Navier–Stokes.

    ``derivs`` supplies the momentum-stage operators (advection gradient,
    viscous Laplacian); ``scheme`` is the
    periodic derivative_order=1 scheme whose divergence the projection
    annihilates; ``spacing`` is (dz, dy, dx).
    """

    derivs: Derivs
    spacing: Tuple[float, float, float]
    scheme: CompactScheme = SCHEME4_PERIODIC
    nu: float = 1e-3
    # distributed overrides (None = the single-device ops): the Helmholtz
    # projector, the compact divergence it annihilates, and the Poisson
    # inverse the pressure diagnostic uses
    projector: "Callable" = None
    div_fn: "Callable" = None
    poisson_fn: "Callable" = None

    def __post_init__(self):
        if not self.scheme.periodic or self.scheme.derivative_order != 1:
            raise ValueError(
                "NavierStokes needs a periodic derivative_order=1 scheme "
                f"for the projection; got {self.scheme.name!r}"
            )

    @classmethod
    def single_device(
        cls,
        spacing,
        scheme: CompactScheme = SCHEME4_PERIODIC,
        nu: float = 1e-3,
        method: str = "auto",
    ) -> "NavierStokes":
        """Build with the single-device operator bundle (compact-d2
        viscous Laplacian)."""
        d = Derivs.single_device(
            spacing, scheme, method=method, second_derivative=True
        )
        sp = (
            (spacing, spacing, spacing)
            if isinstance(spacing, (int, float))
            else tuple(spacing)
        )
        return cls(derivs=d, spacing=sp, scheme=scheme, nu=nu)

    @classmethod
    def distributed(
        cls,
        grid,
        nu: float = 1e-3,
        *,
        method: str = "auto",
    ) -> "NavierStokes":
        """Build over a ``parallel.Grid`` (periodic d1 scheme): momentum
        stages through the distributed compact solver, projection/pressure
        through the pencil-FFT sharded spectral solves."""
        import dataclasses as _dc

        from ..parallel.compact import DistributedCompactSolver
        from ..parallel.spectral import project_sharded, solve_poisson_sharded

        scheme = grid.scheme
        if not scheme.periodic or scheme.derivative_order != 1:
            raise ValueError(
                "NavierStokes.distributed needs a grid with a periodic "
                f"derivative_order=1 scheme; got {scheme.name!r}"
            )
        d2 = get_scheme(scheme.order, True, 2)
        g2 = _dc.replace(grid, scheme=d2)
        s1 = DistributedCompactSolver(grid, method=method)
        s2 = DistributedCompactSolver(g2, method=method)
        derivs = Derivs.distributed(s1, s2)
        return cls(
            derivs=derivs,
            spacing=tuple(grid.spacing),
            scheme=scheme,
            nu=nu,
            projector=lambda u: project_sharded(u, grid, scheme),
            div_fn=s1.divergence,
            poisson_fn=lambda rhs: solve_poisson_sharded(rhs, grid, scheme),
        )

    # -- operators ----------------------------------------------------------

    def _burgers(self) -> Burgers:
        return Burgers(derivs=self.derivs, nu=self.nu)

    def project(self, u):
        """Discrete Helmholtz projection of a velocity field."""
        if self.projector is not None:
            return self.projector(u)
        return project(u, self.spacing, self.scheme)

    def divergence(self, u) -> jax.Array:
        """The compact divergence the projection annihilates."""
        if self.div_fn is not None:
            return self.div_fn(u)
        return single.divergence(u, self.spacing, self.scheme)

    def pressure(self, u) -> jax.Array:
        """Diagnostic pressure: solve div(grad p) = -div((u . grad) u).

        For solenoidal u the viscous term is divergence-free discretely
        (the circulant operators commute), so only the advection term
        sources pressure. Returned with zero mean.
        """
        ux, uy, uz = u
        d = self.derivs
        adv = []
        for comp in (ux, uy, uz):
            cx, cy, cz = d.dfdx(comp), d.dfdy(comp), d.dfdz(comp)
            adv.append(ux * cx + uy * cy + uz * cz)
        rhs = -self.divergence(tuple(adv))
        rhs = rhs - jnp.mean(rhs)
        if self.poisson_fn is not None:
            return self.poisson_fn(rhs)
        return solve_poisson(rhs, self.spacing, self.scheme)

    def kinetic_energy(self, u) -> jax.Array:
        return 0.5 * sum(jnp.mean(c * c) for c in u)

    # -- time stepping ------------------------------------------------------

    def step(self, u, dt):
        """One RK3 step: three (momentum stage -> projection) pairs.

        The momentum stage is exactly ``Burgers.step``'s stage body;
        projecting the stage velocity is
        the fractional-step pressure correction — projection is linear
        and idempotent, so the projected field feeds the next stage's
        advection operator, which is what keeps the splitting error at
        the RK stage level rather than the step level.
        """
        A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
        B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)
        q = tuple(jnp.zeros_like(c) for c in u)
        rhs = self._burgers().rhs
        for a, b in zip(A, B):
            r = rhs(u)
            q = tuple(a * qi + dt * ri for qi, ri in zip(q, r))
            u = self.project(tuple(ui + b * qi for ui, qi in zip(u, q)))
        return u

    def run(self, u0, dt, n_steps: int):
        """n_steps of RK3 under lax.scan (jit-friendly, static trip count)."""

        def body(u, _):
            return self.step(u, dt), None

        u, _ = jax.lax.scan(body, tuple(u0), None, length=n_steps)
        return u
