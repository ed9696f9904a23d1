"""Multi-device functional-scaling sweep on the virtual CPU mesh.

A functional stand-in for the reference's 15-config multi-GPU table
(perf-test/multi-GPU/PyCUDA/ref-results/, tabulated in BASELINE.md): runs the full distributed
derivative pipeline for all three directions over 8 virtual CPU devices,
records the per-phase breakdown (halo+RHS+local solve / reduced interface
system / rank-2 update — the same phase split the reference logs) and an
analytic accuracy check for every configuration. Demonstrates that the
collective path (ppermute halos, all_gather reduced solve) scales across
mesh shapes and stays exact; absolute times are CPU times.

    python benchmarks/run_scaling.py [--sizes 128,256] [--out results.json]
"""

import argparse
import json
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
from cfd_tpu.models import benchmark_field
from cfd_tpu.parallel import Grid, make_mesh
from cfd_tpu.schemes import SCHEME4
from cfd_tpu.utils.timing import chain_time

MESHES = [(2, 2, 2), (1, 1, 8), (1, 8, 1), (8, 1, 1)]
AXES = [("dfdx", 2), ("dfdy", 1), ("dfdz", 0)]


def run_config(mesh_shape, n, results):
    d = 2 * math.pi / n
    mesh = make_mesh(mesh_shape)
    grid = Grid(mesh, (n, n, n), (d, d, d), SCHEME4)
    c = jnp.arange(n, dtype=jnp.float32) * d
    f, exact = benchmark_field(c, c, c)
    fj = grid.distribute(f.astype(jnp.float32))
    solver = cfd_tpu.DistributedCompactSolver(grid)
    kmax = 2 * math.pi  # benchmark-field wavenumbers reach the domain length
    trunc_tol = 5.0 * (kmax * d) ** 4 + 5e-4

    # the substructuring solver (the default) plus, on axes where the line
    # dimension is actually sharded, the reference's second distributed
    # algorithm (phi/psi parameterized-LU sweeps) for a measured comparison
    # — the analogue of lanl-implementation/time_npts.c:89-99
    phipsi = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    # backend-matched substructuring: phipsi's local compute is dense
    # matmuls (linv/uinv rows, parallel/phipsi.py:181-189), while 'auto'
    # resolves the substructuring local solve to PCR on CPU — log(n)
    # full-array passes that the round-3 sweep conflated with the
    # algorithm (docs/DESIGN.md). method='matmul' runs the substructuring
    # local solve through the same dense-operator class, so the
    # substructuring-vs-phipsi delta in these rows is the ALGORITHM
    # (collective pattern + closure work), not the backend.
    sub_mm = cfd_tpu.DistributedCompactSolver(grid, method="matmul")

    for name, axis in AXES:
        solvers = [("substructuring", solver)]
        if mesh_shape[axis] > 1:
            solvers.append(("substructuring-matmul", sub_mm))
            solvers.append(("phipsi", phipsi))
        for method_name, sv in solvers:
            got = np.asarray(sv._derivative(fj, axis), np.float64)
            # exact = (dfdx, dfdy, dfdz); axis 2 is x, 1 is y, 0 is z
            ex = np.asarray(exact[2 - axis], np.float64)
            rel = float(np.abs(got - ex).max() / np.abs(ex).max())
            row = {
                "bench": "distributed_scaling",
                "mesh": "x".join(map(str, mesh_shape)),
                "grid": f"{n}^3",
                "op": name,
                "method": method_name,
                "rel_err_vs_analytic": round(rel, 9),
                "gate": "passed" if rel < trunc_tol else "failed",
            }
            if row["gate"] == "passed":
                t = chain_time(
                    lambda g, axis=axis, sv=sv: sv._derivative(g, axis),
                    fj,
                    k_small=1,
                    k_big=5,
                    repeats=2,
                )
                row["ms"] = round(t * 1e3, 3)
                row["mpts_per_s_per_device"] = round(n**3 / t / 1e6 / 8, 2)
                if method_name == "substructuring":
                    phases = sv.profile_derivative(fj, axis=axis, verbose=False)
                    row["phases_ms"] = {
                        k: round(v * 1e3, 3) for k, v in phases.items()
                    }
                    # per-dispatch timing: each phase is dispatched + synced
                    # separately, so every entry carries the full dispatch
                    # overhead and per-phase resharding cost. NOT comparable
                    # to the chain-slope 'ms' column (the number of record);
                    # read for relative phase structure only.
                    row["phases_timing"] = (
                        "per-dispatch; relative structure only — "
                        "not comparable to 'ms'"
                    )
            results.append(row)
            print(json.dumps(row), flush=True)
            if OUT_PATH:  # incremental: a killed sweep still leaves valid data
                with open(OUT_PATH, "w") as fh:
                    json.dump(_payload(results), fh, indent=1)


OUT_PATH = None


def _payload(results):
    return {
        "platform": jax.default_backend(),
        "n_devices": jax.device_count(),
        "note": (
            "functional scaling on 8 virtual CPU devices — "
            "correctness + phase structure, not device speed. 'ms' is the "
            "chain-slope time (the number of record); 'phases_ms' is a "
            "per-dispatch profile whose entries include dispatch overhead "
            "and per-phase resharding, so its total exceeds 'ms' by orders "
            "of magnitude on this runtime — use it for relative phase "
            "structure only"
        ),
        "results": results,
    }


def main():
    global OUT_PATH
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="128,256")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    OUT_PATH = args.out
    results = []
    for n in (int(s) for s in args.sizes.split(",")):
        for mesh_shape in MESHES:
            run_config(mesh_shape, n, results)
    if OUT_PATH:
        with open(OUT_PATH, "w") as fh:
            json.dump(_payload(results), fh, indent=1)


if __name__ == "__main__":
    main()
