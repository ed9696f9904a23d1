"""Navier–Stokes step: correctness gates, then the step and its pieces timed.

Gates (before any timing): the compact divergence after one step is at
rounding level, and the f32 Poisson solve (jnp.fft, cuFFT on the GPU)
matches the same inverse taken with numpy's float64 FFT on the host.
Then the step, one projection and one Poisson solve are timed with the host
clock over repeated calls that end in ``block_until_ready``.

    python benchmarks/diag_ns.py [n=256] [--out chiprun_out/ns.json]

Every result names the device it ran on; without a GPU it refuses to run.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def time_ms(fn, *args, reps=5, iters=4):
    jax = sys.modules["jax"]
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(samples)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=256)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ns.json"))
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"diag_ns: no GPU (JAX backend is {jax.default_backend()!r})")
    from cfd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    import jax.numpy as jnp
    import numpy as np

    from cfd_tpu.models import NavierStokes, taylor_green
    from cfd_tpu.ops.poisson import laplacian_eigenvalues, solve_poisson
    from cfd_tpu.schemes import SCHEME4_PERIODIC

    n = args.n
    dx = 2 * math.pi / n
    c = jnp.arange(n, dtype=jnp.float32) * dx
    u = taylor_green(c, c, c)
    dt = 1e-3
    sch = SCHEME4_PERIODIC
    ns = NavierStokes.single_device(dx, sch, nu=1e-3)
    gates = {}

    step = jax.jit(lambda uu: ns.step(uu, dt))
    u1 = step(u)
    speed = float(jnp.max(jnp.sqrt(sum(ci * ci for ci in u1))))
    div = float(jnp.max(jnp.abs(ns.divergence(u1)))) / speed
    print(f"post-step |div u|/|u| (compact, projected): {div:.2e}")
    gates["post_step_rel_divergence"] = div
    assert div < 1e-4, div

    rng = np.random.default_rng(0)
    rhs_np = rng.standard_normal((n, n, n))
    rhs_np -= rhs_np.mean()
    rhs = jnp.asarray(rhs_np, jnp.float32)
    lam = laplacian_eigenvalues(sch, rhs.shape, (dx, dx, dx))
    inv = np.zeros_like(lam)
    inv[lam != 0.0] = 1.0 / lam[lam != 0.0]
    p_ref = np.fft.irfftn(np.fft.rfftn(rhs_np) * inv, s=rhs_np.shape, axes=(0, 1, 2))
    poisson = jax.jit(lambda r: solve_poisson(r, dx, sch))
    perr = float(np.max(np.abs(np.asarray(poisson(rhs)) - p_ref)) / np.max(np.abs(p_ref)))
    print(f"f32 Poisson vs host f64 FFT rel err: {perr:.2e}")
    gates["poisson_vs_f64_rel"] = perr
    assert perr < 1e-5, perr

    rows = {
        "ns_step_ms": time_ms(step, u),
        "projection_ms": time_ms(jax.jit(ns.project), u),
        "poisson_ms": time_ms(poisson, rhs),
        "copy_floor_ms": time_ms(jax.jit(lambda x: x * 1.000001), rhs),
    }
    for k, v in rows.items():
        print(f"{k:<16} {v:.4f}")
    dev = jax.devices()[0]
    payload = {
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
        "config": {"n": n, "dtype": "float32", "scheme": sch.name, "nu": 1e-3, "dt": dt},
        "gates": gates,
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
