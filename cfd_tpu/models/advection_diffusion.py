"""Scalar advection–diffusion stepper — the framework's flagship pipeline.

A compact-FD "model" in the PDE sense: advances

    df/dt = -(u . grad f) + nu * laplacian(f)

with RK3 (Williamson low-storage) time stepping, where every spatial
derivative is a compact derivative from this package. The diffusion term
uses the compact second-derivative ``laplacian`` when the ``Derivs``
bundle carries one (the default in the entry points — beyond the
reference, whose library only provides first derivatives) and falls back
to a repeated first derivative otherwise, which is the reference-parity
form. This is the end-to-end workload used by ``__graft_entry__``
and the benchmarks: it chains many derivative evaluations per step, which
is exactly the production shape (CFD RHS evaluations) the reference's
multi-GPU harness approximates with repeated dfdx calls
(perf-test/multi-GPU/PyCUDA/run.py:47-58).

Works identically on a single device (ops layer) or sharded over a mesh
(parallel layer) depending on the ``derivs`` bundle passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops import derivatives as single
from ..schemes import SCHEME4_PERIODIC, CompactScheme

__all__ = ["AdvectionDiffusion", "Derivs"]


@dataclasses.dataclass(frozen=True)
class Derivs:
    """A (dfdx, dfdy, dfdz) bundle; single-device or distributed.

    ``laplacian``, when set, is used by the models for diffusion terms
    (compact second-derivative schemes: one solve per axis and no
    high-wavenumber damping from chaining two first derivatives). When
    None, models fall back to the repeated-first-derivative form — the
    only option the reference's first-derivative-only surface allows.
    """

    dfdx: Callable
    dfdy: Callable
    dfdz: Callable
    laplacian: Callable = None

    @classmethod
    def single_device(
        cls,
        spacing,
        scheme: CompactScheme = SCHEME4_PERIODIC,
        method: str = "auto",
        second_derivative: bool = False,
    ):
        """``second_derivative=True`` adds a compact-d2 ``laplacian`` of the
        same order/periodicity as ``scheme``."""
        dz, dy, dx = (
            (spacing, spacing, spacing)
            if isinstance(spacing, (int, float))
            else spacing
        )
        lap = None
        if second_derivative:
            from ..schemes import get_scheme

            d2 = get_scheme(scheme.order, scheme.periodic, derivative=2)
            lap = lambda f: single.laplacian(f, (dz, dy, dx), d2, method=method)
        return cls(
            dfdx=lambda f: single.dfdx(f, dx, scheme, method=method),
            dfdy=lambda f: single.dfdy(f, dy, scheme, method=method),
            dfdz=lambda f: single.dfdz(f, dz, scheme, method=method),
            laplacian=lap,
        )

    @classmethod
    def distributed(cls, solver, d2_solver=None):
        """``d2_solver``: a DistributedCompactSolver over the same grid
        geometry with a derivative_order=2 scheme; its axis ops *are*
        second derivatives, so their sum is the sharded Laplacian."""
        lap = None
        if d2_solver is not None:
            if d2_solver.grid.scheme.derivative_order != 2:
                raise ValueError(
                    "d2_solver must carry a derivative_order=2 scheme"
                )
            lap = lambda f: (
                d2_solver.dfdx(f) + d2_solver.dfdy(f) + d2_solver.dfdz(f)
            )
        return cls(
            dfdx=solver.dfdx,
            dfdy=solver.dfdy,
            dfdz=solver.dfdz,
            laplacian=lap,
        )


@dataclasses.dataclass(frozen=True)
class AdvectionDiffusion:
    """RK3 advection–diffusion of a scalar by a frozen velocity field."""

    derivs: Derivs
    nu: float = 1e-3

    def rhs(self, f, u) -> jax.Array:
        ux, uy, uz = u
        d = self.derivs
        fx, fy, fz = d.dfdx(f), d.dfdy(f), d.dfdz(f)
        adv = ux * fx + uy * fy + uz * fz
        if d.laplacian is not None:
            lap = d.laplacian(f)
        else:
            lap = d.dfdx(fx) + d.dfdy(fy) + d.dfdz(fz)
        return -adv + self.nu * lap

    def step(self, f, u, dt) -> jax.Array:
        """One low-storage RK3 step (Williamson coefficients)."""
        A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
        B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)
        q = jnp.zeros_like(f)
        for a, b in zip(A, B):
            q = a * q + dt * self.rhs(f, u)
            f = f + b * q
        return f

    def run(self, f0, u, dt, n_steps: int) -> jax.Array:
        """n_steps of RK3 under lax.scan (jit-friendly, static trip count)."""

        def body(f, _):
            return self.step(f, u, dt), None

        f, _ = jax.lax.scan(body, f0, None, length=n_steps)
        return f
