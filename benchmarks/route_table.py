"""Time every plain-JAX derivative route against the card's copy floor.

For each axis class (minor, second-minor, leading), dtype (f32, bf16, f64),
derivative order (0 = filter, 1, 2) and line length, every candidate route
of ``cfd_tpu.derivative`` (``pcr``, ``thomas``, ``stencil``, ``matmul``) is
first gated against the float64 oracle on 64 sampled lines, then timed on a
cubic field. The copy floor is one fused ``x * 1.000001`` over the same
bytes, timed in the same process. The fastest route that passes the gate is
what ``resolve_method`` should return for ``platform="gpu"``.

Gates, relative to max|f'| of the oracle on the sampled lines:
  f32  1e-5   f32 roundoff carried through a line solve (~2^-23 * O(10))
  bf16 5e-2   bf16 keeps 8 mantissa bits (~4e-3 per rounding), compounded
  f64  1e-10  the oracle parity gate of the test suite

Line lengths are those the router keys on (``derivatives._GPU_LINES``).
Usage, on the card (it refuses to run without one); rows and winners go to
``chiprun_out/route_table.json``:
    python benchmarks/route_table.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GATES = {"float32": 1e-5, "bfloat16": 5e-2, "float64": 1e-10}
METHODS = ("pcr", "thomas", "stencil", "matmul")
AXES = {"minor": -1, "second_minor": -2, "leading": -3}


def sample_lines(a, axis, idx):
    """(64, n) lines of the 3-D array ``a`` along ``axis`` at ``idx``."""
    i, j = idx
    if axis == -1:
        return a[i, j, :]
    if axis == -2:
        return a[i, :, j]
    return a[:, i, j].T


def time_ms(fn, x, reps=5, iters=8):
    """Median and min over ``reps`` of the per-call time of ``iters``
    back-to-back calls that end in ``block_until_ready``."""
    fn(x).block_until_ready()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(x)
        y.block_until_ready()
        samples.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(samples), min(samples)


OUT = os.path.join(ROOT, "chiprun_out", "route_table.json")


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    from cfd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    import jax.numpy as jnp
    import numpy as np

    import cfd_tpu
    from cfd_tpu.models import broadband_field
    from cfd_tpu.ops.derivatives import _GPU_LINES
    from cfd_tpu.oracle import derivative_np
    from cfd_tpu.schemes import SCHEME4, SCHEME4_D2, get_filter

    if jax.default_backend() != "gpu":
        sys.exit(f"route_table: no GPU (JAX backend is {jax.default_backend()!r})")
    schemes = {0: get_filter(), 1: SCHEME4, 2: SCHEME4_D2}
    rows = []
    for n in _GPU_LINES:
        dx = 2 * np.pi / n
        base = broadband_field(n, seed=n)
        rs = np.random.default_rng(n)
        idx = (rs.integers(0, n, 64), rs.integers(0, n, 64))
        for dname in GATES:
            dtype = jnp.dtype(dname)
            f = base.astype(dtype)
            f_host = np.asarray(f.astype(jnp.float64))
            floor_med, floor_min = time_ms(jax.jit(lambda x: x * 1.000001), f)
            for aname, axis in AXES.items():
                lines = sample_lines(f_host, axis, idx)
                for order, sch in schemes.items():
                    ref = derivative_np(sch, lines, dx, axis=-1)
                    scale = float(np.max(np.abs(ref)))
                    for m in METHODS:
                        fn = jax.jit(
                            lambda x, sch=sch, axis=axis, m=m: cfd_tpu.derivative(
                                x, dx, sch, axis=axis, method=m
                            )
                        )
                        row = dict(
                            n=n, dtype=dname, axis=aname, order=order,
                            scheme=sch.name, method=m,
                            copy_floor_ms=floor_med, copy_floor_min_ms=floor_min,
                        )
                        try:
                            out = fn(f)
                            got = np.asarray(
                                sample_lines(out, axis, idx).astype(jnp.float64)
                            )
                            err = float(np.max(np.abs(got - ref))) / scale
                            med, mn = time_ms(fn, f)
                            row.update(
                                rel_err=err, passes=err < GATES[dname],
                                ms=med, min_ms=mn, x_floor=med / floor_med,
                            )
                        except Exception as e:  # one route's failure is a row, not the run's end
                            row.update(error=f"{type(e).__name__}: {e}"[:300], passes=False)
                        rows.append(row)
                        print(json.dumps(row), flush=True)
            del f
    best = {}
    for r in rows:
        if not r.get("passes"):
            continue
        key = f"{r['n']}/{r['dtype']}/{r['axis']}/d{r['order']}"
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    summary = {k: (v["method"], round(v["x_floor"], 3)) for k, v in sorted(best.items())}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump({"rows": rows, "best": summary}, fh, indent=1)
    print(json.dumps({"best": summary}))


if __name__ == "__main__":
    main()
