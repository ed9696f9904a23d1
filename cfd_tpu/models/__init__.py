"""Model layer: analytic fields and PDE steppers built on compact derivatives."""

from .advection_diffusion import AdvectionDiffusion, Derivs
from .burgers import Burgers
from .fields import (
    benchmark_field,
    broadband_field,
    sine_field,
    taylor_green,
    taylor_green_2d,
)
from .navier_stokes import NavierStokes

__all__ = [
    "AdvectionDiffusion",
    "Burgers",
    "Derivs",
    "NavierStokes",
    "benchmark_field",
    "broadband_field",
    "sine_field",
    "taylor_green",
    "taylor_green_2d",
]
