"""3-D viscous Burgers system — second PDE model family.

    du/dt + (u . grad) u = nu * laplacian(u)

for a 3-component velocity field, with every spatial derivative a compact
derivative from this package (Laplacian via the compact second-derivative
schemes when the Derivs bundle provides one, else as repeated first
derivative).
Nonlinear counterpart of the advection–diffusion model: the advecting field
is the solution itself, so each RK stage re-evaluates all nine first
derivatives — a heavier, production-shaped pipeline (the Taylor–Green
vortex decay configuration from BASELINE.json's config list runs on this).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .advection_diffusion import Derivs

__all__ = ["Burgers"]


@dataclasses.dataclass(frozen=True)
class Burgers:
    """Low-storage RK3 stepper for the viscous Burgers system."""

    derivs: Derivs
    nu: float = 1e-2

    def rhs(self, u) -> Tuple[jax.Array, jax.Array, jax.Array]:
        ux, uy, uz = u
        d = self.derivs
        out = []
        for comp in (ux, uy, uz):
            cx, cy, cz = d.dfdx(comp), d.dfdy(comp), d.dfdz(comp)
            adv = ux * cx + uy * cy + uz * cz
            if d.laplacian is not None:
                lap = d.laplacian(comp)
            else:
                lap = d.dfdx(cx) + d.dfdy(cy) + d.dfdz(cz)
            out.append(-adv + self.nu * lap)
        return tuple(out)

    def step(self, u, dt):
        A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
        B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)
        q = tuple(jnp.zeros_like(c) for c in u)
        for a, b in zip(A, B):
            r = self.rhs(u)
            q = tuple(a * qi + dt * ri for qi, ri in zip(q, r))
            u = tuple(ui + b * qi for ui, qi in zip(u, q))
        return u

    def run(self, u0, dt, n_steps: int):
        def body(u, _):
            return self.step(u, dt), None

        u, _ = jax.lax.scan(body, u0, None, length=n_steps)
        return u

    def kinetic_energy(self, u) -> jax.Array:
        return 0.5 * sum(jnp.mean(c * c) for c in u)
