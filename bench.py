"""Headline benchmark: single-card d/dx throughput (grid points/s) at 256^3.

Mirrors the reference's multi-GPU dfdx harness
(/root/reference/perf-test/multi-GPU/PyCUDA/run.py) at its 256^3
configuration: ``cfd_tpu.dfdx(f, dx, SCHEME4, method="auto")`` on an f32
field, jitted, gated against d/dx sin = cos, then timed with the host clock
over repeated calls that end in ``block_until_ready``. Baseline datum:
191 Mpt/s per GPU (256^3 on 8 GPUs, BASELINE.md); ``vs_baseline`` is
points/s per card relative to that.

    python bench.py                   # on the GPU; refuses to run without one
    python bench.py --platform cpu    # CPU smoke run (BENCH_N sets the size)

Prints exactly one JSON line on stdout; the card's name and power limit and
the raw timings go to stderr.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-card dfdx throughput")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != args.platform:
        sys.exit(
            f"bench: JAX backend is {jax.default_backend()!r}, not "
            f"{args.platform!r} (pass --platform cpu for a CPU smoke run)"
        )
    sys.path.insert(0, ROOT)
    from cfd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    import jax.numpy as jnp
    import numpy as np

    import cfd_tpu
    from cfd_tpu.schemes import SCHEME4

    dev = jax.devices()[0]
    if args.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(f"[bench] card: {card}", file=sys.stderr)

    n = int(os.environ.get("BENCH_N", "256"))
    dx = 2 * math.pi / n
    x = np.arange(n) * dx
    f = jnp.asarray((np.sin(x)[None, None, :] * np.ones((n, n, 1))).astype(np.float32))
    step = jax.jit(lambda g: cfd_tpu.dfdx(g, dx, SCHEME4, method="auto"))

    # accuracy gate before timing: d/dx sin = cos to f32 truncation level
    err = float(jnp.max(jnp.abs(step(f) - jnp.cos(jnp.asarray(x, jnp.float32)))))
    assert err < 5e-4, f"accuracy gate failed: {err}"

    iters = 20
    samples = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = step(f)
        y.block_until_ready()
        samples.append((time.perf_counter() - t0) / iters)
    dt = statistics.median(samples)
    print(
        f"[bench] {dev.platform} {dev.device_kind} x{len(jax.devices())}: "
        f"n={n} median {dt * 1e3:.4f} ms/call, min {min(samples) * 1e3:.4f} ms",
        file=sys.stderr,
    )
    pts_per_s = n**3 / dt
    baseline = 191e6  # points/s per GPU, 256^3 on 8 GPUs (BASELINE.md)
    print(
        json.dumps(
            {
                "metric": "dfdx_2563_points_per_sec_per_chip",
                "value": round(pts_per_s, 1),
                "unit": "points/s",
                "vs_baseline": round(pts_per_s / baseline, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
