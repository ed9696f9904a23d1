"""Framework configuration.

The reference passes positional ``sys.argv`` everywhere and hard-codes the
rest (SURVEY.md §5: demo.py:9-11, run.py:15-18, options.h); this replaces
that with one validated dataclass covering scheme order, boundary type,
dtype, mesh shape and solver backend, with env-var overrides for scripted
sweeps.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from .schemes import CompactScheme, get_scheme

__all__ = ["Config"]


@dataclasses.dataclass(frozen=True)
class Config:
    """End-to-end run configuration."""

    order: int = 4
    periodic: bool = False
    dtype: str = "float32"  # 'float32' | 'bfloat16' | 'float64'
    method: str = "auto"  # 'auto' | 'matmul' | 'pcr' | 'thomas' | 'stencil' | 'phipsi'
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)
    grid_shape: Tuple[int, int, int] = (256, 256, 256)
    spacing: Tuple[float, float, float] = (1e-2, 1e-2, 1e-2)

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16", "float64"):
            raise ValueError(f"bad dtype {self.dtype}")
        if self.method not in (
            "auto", "matmul", "pcr", "thomas", "stencil", "phipsi"
        ):  # phipsi: the distributed-algorithm choice (parallel/phipsi.py)
            raise ValueError(f"bad method {self.method}")
        self.scheme  # validates order/periodic

    @property
    def scheme(self) -> CompactScheme:
        return get_scheme(self.order, self.periodic)

    @property
    def jax_dtype(self):
        import jax.numpy as jnp

        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}[
            self.dtype
        ]

    @classmethod
    def from_env(cls, prefix: str = "CFD_", **overrides) -> "Config":
        """Build from CFD_* environment variables plus explicit overrides."""

        def get(name, cast, default):
            raw = os.environ.get(prefix + name)
            return cast(raw) if raw is not None else default

        def triple(raw):
            z, y, x = (int(v) for v in raw.split(","))
            return (z, y, x)

        def ftriple(raw):
            parts = [float(v) for v in raw.split(",")]
            if len(parts) == 1:  # CFD_SPACING=0.01 means isotropic
                parts = parts * 3
            dz, dy, dx = parts
            return (dz, dy, dx)

        base = dict(
            order=get("ORDER", int, cls.order),
            periodic=get("PERIODIC", lambda s: s.lower() in ("1", "true"), cls.periodic),
            dtype=get("DTYPE", str, cls.dtype),
            method=get("METHOD", str, cls.method),
            mesh_shape=get("MESH", triple, cls.mesh_shape),
            grid_shape=get("GRID", triple, cls.grid_shape),
            spacing=get("SPACING", ftriple, cls.spacing),
        )
        base.update(overrides)
        return cls(**base)

    def make_grid(self):
        from .parallel import Grid, make_mesh

        mesh = make_mesh(self.mesh_shape)
        return Grid(mesh, self.grid_shape, self.spacing, self.scheme)
