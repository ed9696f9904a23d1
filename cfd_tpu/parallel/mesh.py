"""Device-mesh grid descriptor — the JAX counterpart of the
reference's PETSc-DMDA-like ``DA`` class (/root/reference/code/cuda/
gpuDA.py:7-39, code/ocl/mpi_util.py).

Where the reference builds an MPI Cartesian communicator
(``comm.Create_cart``, gpuDA.py:26) and per-direction line
sub-communicators (``get_line_DA``, gpuDA.py:154-180), this version
names the axes of a ``jax.sharding.Mesh`` — collectives scoped to one
mesh-axis name *are* the line communicators, so no sub-communicator
machinery is needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..schemes import SCHEME4, CompactScheme

__all__ = ["Grid", "make_mesh", "AXIS_NAMES"]

AXIS_NAMES = ("z", "y", "x")


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = AXIS_NAMES,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build an (npz, npy, npx) device mesh with named axes ('z','y','x')."""
    shape = tuple(shape)
    if devices is None:
        devices = jax.devices()
    need = math.prod(shape)
    if need > len(devices):
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devices)}")
    devs = np.asarray(devices[:need]).reshape(shape)
    return Mesh(devs, tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Grid:
    """A structured 3-D grid distributed over a device mesh.

    Plays the role of the reference's ``DA`` + solver-config: global shape
    ``(nz, ny, nx)``, grid spacing ``(dz, dy, dx)``, per-axis periodicity
    (from the scheme), and the mesh over which fields are pencil-decomposed
    with PartitionSpec('z','y','x').
    """

    mesh: Mesh
    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    scheme: CompactScheme = SCHEME4

    def __post_init__(self):
        for g, m, name in zip(self.shape, self.mesh.devices.shape, AXIS_NAMES):
            if g % m:
                raise ValueError(
                    f"global {name}-extent {g} not divisible by mesh axis {m}"
                )

    @property
    def proc_shape(self) -> Tuple[int, int, int]:
        return tuple(self.mesh.devices.shape)

    @property
    def local_shape(self) -> Tuple[int, int, int]:
        return tuple(g // m for g, m in zip(self.shape, self.proc_shape))

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(*AXIS_NAMES))

    def spec(self, *extra_leading) -> P:
        return P(*extra_leading, *AXIS_NAMES)

    def coordinates(self, origin=(0.0, 0.0, 0.0)):
        """Sharded 1-D coordinate arrays (z, y, x), like the reference's
        ``DA_arange`` helper (gpuDA.py:402-432) but lazily sharded by XLA."""
        out = []
        for g, d, o, name in zip(self.shape, self.spacing, origin, AXIS_NAMES):
            c = jax.numpy.arange(g) * d + o
            sh = NamedSharding(self.mesh, P(name))
            out.append(jax.device_put(c, sh))
        return tuple(out)

    def distribute(self, f):
        """Place a global field [nz, ny, nx] with the pencil sharding.

        The counterpart of the reference's root-IO block scatter
        (``DA_scatter_blocks``, gpuDA.py:434-460): XLA moves each pencil to
        its owning device."""
        if f.shape[-3:] != self.shape:
            raise ValueError(f"field shape {f.shape} != grid {self.shape}")
        return jax.device_put(f, self.sharding)

    def gather(self, f) -> np.ndarray:
        """Fetch a sharded field to a host numpy array (``DA_gather_blocks``
        analogue, gpuDA.py:462-488)."""
        return np.asarray(f)
