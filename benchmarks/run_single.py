"""Single-device benchmark sweep — the port of the reference's perf-test tree.

Covers the analogues of:
* perf-test/single-GPU/PyCUDA/run.py — solve-only batched tridiagonal sweep
* perf-test/multi-GPU/PyCUDA/run.py at 1 rank — full derivative pipeline
* perf-test/single-GPU/cusparse-dgtsv — comparison against the library
  solver (here: jax.lax.linalg.tridiagonal_solve) and the XLA-level PCR path

Writes one JSON object per line to stdout and (optionally) a results file:
    python benchmarks/run_single.py [--sizes 32,64,256] [--out results.json]

All timings use chain-slope measurement (cfd_tpu.utils.timing.chain_time).
Every row passes an accuracy gate before it is timed: solve-only rows check
the tridiagonal residual ||Tx - rhs||, derivative rows check against the
float64 oracle; a row that fails is recorded with ``"gate": "failed"`` and
no timing. Rows whose chain delta is below the dispatch noise floor are
marked ``"suspect": true``.
"""

import argparse
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
from cfd_tpu.ops import tridiag
from cfd_tpu.schemes import SCHEME4, lhs_bands
from cfd_tpu.utils.timing import chain_time

NOISE_FLOOR_MS = 0.02  # chain deltas below this are dispatch noise


def _emit(results, row, t=None, npts=None):
    if t is not None:
        row["ms"] = round(t * 1e3, 4)
        row["gpts_per_s"] = round(npts / t / 1e9, 3)
        if t * 1e3 < NOISE_FLOOR_MS:
            row["suspect"] = True
            row["suspect_reason"] = "chain delta below dispatch noise floor"
    results.append(row)
    print(json.dumps(row), flush=True)


def _residual(x, rhs, n):
    """max |T x - rhs| / max |rhs| for the SCHEME4 LHS, numpy f64."""
    dl, d, du = lhs_bands(SCHEME4, n)
    x = np.asarray(x, np.float64)
    r = d[:, None] * x
    r[1:] += dl[1:, None] * x[:-1]
    r[:-1] += du[:-1, None] * x[1:]
    return float(np.abs(r - np.asarray(rhs, np.float64)).max() / np.abs(rhs).max())


def bench_solve_only(n, results):
    """Batched near-Toeplitz solve of n^2 lines of length n (solve only)."""
    rng = np.random.default_rng(0)
    rhs_t = jnp.asarray(rng.random((n, n * n), np.float32))  # lines leading

    fac_pcr = tridiag.pcr_factor(*lhs_bands(SCHEME4, n))

    steps = {"pcr": lambda r: tridiag.pcr_solve(fac_pcr, r)}
    for name, step in steps.items():
        row = {"bench": "solve_only", "solver": name, "grid": f"{n}^3"}
        target = np.asarray(rhs_t, np.float64)[:, :1024]
        res = _residual(np.asarray(step(rhs_t))[:, :1024], target, n)
        if res > 1e-4:
            row["gate"] = "failed"
            row["residual"] = res
            _emit(results, row)
            continue
        t = chain_time(step, rhs_t, k_small=2, k_big=14, repeats=2)
        _emit(results, row, t, n**3)

    # library comparison: XLA's tridiagonal_solve (cusparse-gtsv analogue)
    try:
        dl, d, du = (jnp.asarray(b, jnp.float32) for b in lhs_bands(SCHEME4, n))
        rhs_b = jnp.asarray(rng.random((n * n, n, 1), np.float32))
        dlb = jnp.broadcast_to(dl, (n * n, n))
        db = jnp.broadcast_to(d, (n * n, n))
        dub = jnp.broadcast_to(du, (n * n, n))

        def lib_step(r):
            return jax.lax.linalg.tridiagonal_solve(dlb, db, dub, r)

        row = {"bench": "solve_only", "solver": "lax.tridiagonal_solve", "grid": f"{n}^3"}
        x_lib = np.asarray(lib_step(rhs_b))[:1024, :, 0].T
        res = _residual(x_lib, np.asarray(rhs_b)[:1024, :, 0].T, n)
        if res > 1e-4:
            row["gate"] = "failed"
            row["residual"] = res
            _emit(results, row)
        else:
            t = chain_time(lib_step, rhs_b, k_small=2, k_big=6, repeats=2)
            _emit(results, row, t, n**3)
    except Exception as e:  # pragma: no cover - library path may be missing
        print(json.dumps({"bench": "solve_only", "solver": "lax", "error": str(e)}))


def bench_full_derivative(n, results):
    """Full dfdx/dfdy/dfdz pipeline on the reference's analytic field.

    Gate: each op is checked against the float64 scipy-banded oracle on the
    same (f32-cast) field before timing — this isolates backend arithmetic
    from the scheme's truncation error.
    """
    from cfd_tpu.models import benchmark_field
    from cfd_tpu.oracle import derivative_np

    d = 2 * math.pi / n
    c = jnp.arange(n, dtype=jnp.float32) * d
    f, _ = benchmark_field(c, c, c)
    f = f.astype(jnp.float32)
    f_host = np.asarray(f, np.float64)
    method = "auto"
    for name, axis, step in (
        ("dfdx", -1, lambda g: cfd_tpu.dfdx(g, d, SCHEME4, method=method)),
        ("dfdy", -2, lambda g: cfd_tpu.dfdy(g, d, SCHEME4, method=method)),
        ("dfdz", -3, lambda g: cfd_tpu.dfdz(g, d, SCHEME4, method=method)),
    ):
        row = {"bench": "full_derivative", "op": name, "method": method, "grid": f"{n}^3"}
        got = np.asarray(step(f))
        ex = derivative_np(SCHEME4, f_host, d, axis=axis)
        err = np.abs(got - ex).max() / np.abs(ex).max()
        if not np.isfinite(err) or err > 5e-4:
            row["gate"] = "failed"
            row["rel_err"] = float(err)
            _emit(results, row)
            continue
        row["rel_err"] = round(float(err), 9)
        t = chain_time(step, f, k_small=2, k_big=14, repeats=2)
        _emit(results, row, t, n**3)


def bench_d2_and_filter(n, results):
    """Second-derivative and compact-filter throughput (beyond-reference ops).

    Gates: d2 rows against the f64 oracle on the f32-cast field at 5e-3 rel
    (f32 roundoff amplified by 1/dx^2); filter rows at 1e-4.
    """
    from cfd_tpu.oracle import derivative_np
    from cfd_tpu.schemes import get_filter

    d = 2 * math.pi / n
    c = np.arange(n) * d
    f64 = (
        np.sin(c)[None, None, :] * np.cos(2 * c)[None, :, None] * np.ones((n, 1, 1))
        + 0.3 * np.cos(3 * c)[:, None, None]
    )
    f = jnp.asarray(f64, jnp.float32)
    f_host = np.asarray(f, np.float64)
    d2 = cfd_tpu.SCHEME4_D2_PERIODIC
    filt = get_filter(6, 0.45, periodic=True)
    cases = [
        ("d2fdx2", lambda g: cfd_tpu.d2fdx2(g, d, d2), -1, d2, 5e-3),
        ("d2fdz2", lambda g: cfd_tpu.d2fdz2(g, d, d2), -3, d2, 5e-3),
        ("filter_x", lambda g: cfd_tpu.filter_field(g, filt, axis=-1), -1, filt, 1e-4),
    ]
    for name, step, axis, scheme, tol in cases:
        row = {"bench": "d2_filter", "op": name, "method": "auto", "grid": f"{n}^3"}
        got = np.asarray(step(f))
        ex = derivative_np(scheme, f_host, 1.0 if scheme is filt else d, axis=axis)
        err = np.abs(got - ex).max() / np.abs(ex).max()
        if not np.isfinite(err) or err > tol:
            row["gate"] = "failed"
            row["rel_err"] = float(err)
            _emit(results, row)
            continue
        row["rel_err"] = round(float(err), 9)
        t = chain_time(step, f, k_small=2, k_big=14, repeats=2)
        _emit(results, row, t, n**3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,128,256")
    ap.add_argument("--out", default=None)
    ap.add_argument("--solve-only", action="store_true")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    results = []
    for n in sizes:
        bench_solve_only(n, results)
        if not args.solve_only:
            bench_full_derivative(n, results)
            bench_d2_and_filter(n, results)
    if args.out:
        with open(args.out, "w") as fh:
            dev = jax.devices()[0]
            device = {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            }
            json.dump({"device": device, "results": results}, fh, indent=1)


if __name__ == "__main__":
    main()
