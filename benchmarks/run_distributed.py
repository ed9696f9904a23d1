"""Distributed benchmark — the port of perf-test/multi-GPU/PyCUDA/run.py.

Times the full distributed dfdx pipeline (halo exchange + local solves +
reduced interface system + rank-2 update) on an (npz, npy, npx) device mesh.
On one card it runs the same code path with a (1,1,1) mesh; on a CPU
host set XLA_FLAGS=--xla_force_host_platform_device_count=8 CFD_MESH=2,2,2
for a functional 8-way run (numbers are then CPU numbers — the reference's
committed logs in perf-test/multi-GPU/ref-results are the comparison for
real multi-card runs). Every row names the platform, device kind and
device count it ran on.

    CFD_MESH=1,1,1 CFD_GRID=256,256,256 CFD_SPACING=0.0245 \\
        python benchmarks/run_distributed.py

Before timing, the computed dfdx is checked against the exact analytic
gradient of the benchmark field (CFD_SPACING sets the physical grid, so the
check is meaningful at any CFD_GRID).
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from cfd_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache(ROOT)
import numpy as np

import cfd_tpu
from cfd_tpu.config import Config
from cfd_tpu.models import benchmark_field
from cfd_tpu.utils.timing import chain_time


def main():
    cfg = Config.from_env()  # method defaults to "auto"; CFD_METHOD overrides
    grid = cfg.make_grid()
    nz, ny, nx = cfg.grid_shape
    z, y, x = (jnp.arange(n, dtype=jnp.float32) * d for n, d in
               zip(cfg.grid_shape, cfg.spacing))
    f, (gx, _, _) = benchmark_field(z, y, x)  # the reference harness field
    fj = grid.distribute(f.astype(cfg.jax_dtype))
    solver = cfd_tpu.DistributedCompactSolver(grid, method=cfg.method)

    # accuracy gate: the analytic df/dx of the benchmark field, to a
    # tolerance covering scheme truncation at this spacing plus the dtype
    got = np.asarray(solver.dfdx(fj), np.float64)
    ex = np.asarray(gx, np.float64)
    rel = np.abs(got - ex).max() / np.abs(ex).max()
    kmax = float(np.max(np.abs(np.asarray(y))))  # d/dx wavenumber ~ y
    trunc = (kmax * cfg.spacing[2]) ** cfg.order
    tol = 5.0 * trunc + {"float64": 1e-10, "float32": 5e-4, "bfloat16": 5e-2}[cfg.dtype]
    dev = jax.devices()[0]
    row = {
        "bench": "distributed_dfdx",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "mesh": "x".join(map(str, cfg.mesh_shape)),
        "grid": f"{nz}x{ny}x{nx}",
        "method": cfg.method,
        "dtype": cfg.dtype,
        "rel_err_vs_analytic": round(float(rel), 9),
    }
    if not np.isfinite(rel) or rel > tol:
        row["gate"] = "failed"
        row["tol"] = tol
        print(json.dumps(row))
        sys.exit(1)

    t = chain_time(solver.dfdx, fj, k_small=2, k_big=18, repeats=3)
    npts = nz * ny * nx
    row["ms"] = round(t * 1e3, 4)
    row["gpts_per_s"] = round(npts / t / 1e9, 3)
    row["mpts_per_s_per_device"] = round(
        npts / t / 1e6 / math.prod(cfg.mesh_shape), 2
    )
    print(json.dumps(row))


if __name__ == "__main__":
    main()
