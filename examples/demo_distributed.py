"""Distributed demo on a virtual CPU mesh (runs anywhere, no GPU needed).

The analogue of the reference's mpiexec demos, with the MPI ranks replaced
by an 8-device ('z','y','x') mesh:

    python examples/demo_distributed.py
"""

import math
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import cfd_tpu
from cfd_tpu.parallel import Grid, make_mesh


def main():
    n = 64
    L = 2 * math.pi
    dx = L / n
    mesh = make_mesh((2, 2, 2))
    grid = Grid(mesh, (n, n, n), (dx, dx, dx), cfd_tpu.get_scheme(4, periodic=True))
    x = np.arange(n) * dx
    f = grid.distribute(jnp.asarray(np.broadcast_to(np.sin(x), (n, n, n)).copy()))
    solver = cfd_tpu.DistributedCompactSolver(grid)
    df = solver.dfdx(f)
    err = float(jnp.max(jnp.abs(df - jnp.cos(jnp.asarray(x)))))
    print(f"mesh 2x2x2, {n}^3 periodic d/dx sin: max abs error = {err:.3e}")


if __name__ == "__main__":
    main()
