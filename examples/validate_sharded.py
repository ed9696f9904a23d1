"""Large sharded-solve validation (BASELINE.json config 4).

A sharded 1024^3 solve matching reference tolerance. This script runs the
multi-device code path — pencil decomposition, ppermute halos, distributed
reduced system — on an 8-device virtual CPU mesh at the full 1024^3 size:

* the field is built **per shard on device** (jit with sharded output from
  the grid's sharded coordinate arrays) — no 4 GiB host->device transfer;
* the error norm is a jitted reduction over the sharded arrays — no
  gather back to one host.

    python examples/validate_sharded.py [N=1024] [Z_CHUNKS=1]

The optional Z_CHUNKS argument validates grids whose full-size solve
exceeds host RAM (2048^3 f32 peaks at ~130 GiB — four 32 GiB live
buffers — and the reference itself needed 64 GPUs' aggregate memory for
that config, perf-test/multi-GPU/PyCUDA/ref-results/2048-64.txt). d/dx
does not couple z, so the N^3 point set is validated in Z_CHUNKS
independent z-slab solves, each still running the full N-long
distributed lines over the sharded x axis; a per-chunk phase offset in
the field makes every slab numerically distinct. `2048 8` covers all
2048^3 points in (256, 2048, 2048) solves (~20 GiB peak).
"""

import functools
import math
import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import cfd_tpu
from cfd_tpu.parallel import Grid, make_mesh


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    chunks = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    assert n % (2 * chunks) == 0, (n, chunks)
    dx = 2 * math.pi / n
    mesh = make_mesh((2, 2, 2))
    grid = Grid(
        mesh, (n // chunks, n, n), (dx, dx, dx), cfd_tpu.get_scheme(4, periodic=True)
    )
    _, _, x = grid.coordinates()  # sharded 1-D coordinates

    @functools.partial(jax.jit, out_shardings=grid.sharding, donate_argnums=1)
    def build(xc, buf, phase):
        # each device materialises only its own pencil; the dead previous
        # chunk's buffer is donated so chunks don't accumulate
        del buf
        return jnp.broadcast_to(
            jnp.sin(xc.astype(jnp.float32) + phase)[None, None, :], grid.shape
        )

    solver = cfd_tpu.DistributedCompactSolver(grid)
    dfdx = jax.jit(solver.dfdx, donate_argnums=0)

    @jax.jit
    def max_err(d, xc, phase):
        return jnp.max(
            jnp.abs(d - jnp.cos(xc.astype(jnp.float32) + phase)[None, None, :])
        )

    t0 = time.time()
    err, df = 0.0, None
    for c in range(chunks):
        # a per-chunk phase keeps every z-slab solve numerically distinct
        phase = jnp.float32(c * (2 * math.pi / max(chunks, 1)) / 3.0)
        f = build(x, df, phase)
        # donate f: it is dead after the solve, and at large n the freed
        # 4n^3-byte buffer is the difference between fitting in host RAM
        # and the OOM killer on the virtual CPU mesh
        df = dfdx(f)
        del f
        err = max(err, float(max_err(df, x, phase)))
    dt = time.time() - t0
    chunk_note = f", {chunks} z-slab solves" if chunks > 1 else ""
    print(
        f"sharded {n}^3 dfdx on 2x2x2 mesh: max abs err = {err:.3e} "
        f"({dt:.1f}s incl. compile, gather-free{chunk_note})"
    )
    assert err < 5e-5, err


if __name__ == "__main__":
    main()
