"""Smoke test of cfd_tpu on NVIDIA GPUs, through the public API.

    python chip_smoke.py           # one card: derivatives and Navier–Stokes
    python chip_smoke.py --four    # four cards: the distributed path only

One card, at 512^3 (the reference's per-GPU share of its largest run,
2048^3 on 64 GPUs):

  phase 1  dfdx, dfdy, dfdz, laplacian and filter_field (method='auto') for
           SCHEME4, SCHEME4_PERIODIC and SCHEME6 on a seeded broadband f32
           field, against the float64 host oracle on 64 sampled lines per
           axis; then one float64 pass with jax_enable_x64.
  phase 2  NavierStokes.single_device, 2-D Taylor–Green vortex embedded in
           3-D: one jitted step, 3 steps, against the exact decay
           exp(-2 nu t); the compact divergence stays at rounding level.

Four cards (``--four``), at 512^3 over the mesh:

  phase 3  DistributedCompactSolver (method='auto') on meshes (1,2,2),
           (4,1,1) and (1,1,4), periodic and non-periodic, and 'phipsi'
           once, against the single-device result on card 0;
           NavierStokes.distributed on (1,2,2) for 3 steps against
           NavierStokes.single_device; the npz checkpoint round trip.

Tolerances, each relative to the max of the reference:
  f32 derivatives  1e-5   f32 roundoff carried through a line solve
  f64 derivatives  1e-10  the test suite's oracle parity gate
  NS velocity      2e-5   the nine f32 spectral projections of 3 steps
                          (one per RK stage) move the field by 3.9e-6
                          on an H100 at 512^3; the same steps in f64
                          miss the exact solution by ~1e-14
  NS decay factor  3e-6   each f32 projection scales the Taylor-Green
                          mode by 1 - 1.1e-7, so nine take 1e-6 off the
                          factor (H100, 512^3); the decay it checks is
                          6e-5
  divergence       1e-5   of max|u|/dx: rounding level after projection

Every phase must pass; any failure raises and exits non-zero. The last line
of standard output is one JSON object, printed only on success:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N = 512
F32_TOL = 1e-5
F64_TOL = 1e-10
NS_TOL = 2e-5
NS_DECAY_TOL = 3e-6
DIV_TOL = 1e-5
DIST_TOL = 1e-5
N_LINES = 64


def log(*a):
    print(*a, flush=True)


def _sample_idx(n, seed):
    import numpy as np

    rs = np.random.default_rng(seed)
    return tuple(rs.integers(0, n, N_LINES) for _ in range(3))


def _lines(a, axis, idx):
    """(N_LINES, n) lines of the 3-D array ``a`` along ``axis``, through the
    sample points ``idx = (iz, iy, ix)``."""
    iz, iy, ix = idx
    if axis == -1:
        return a[iz, iy, :]
    if axis == -2:
        return a[iz, :, ix]
    return a[:, iy, ix].T


def _at_points(a, idx):
    iz, iy, ix = idx
    return a[iz, iy, ix]


def _host(a):
    import numpy as np

    return np.asarray(a).astype(np.float64)


def derivative_gates(n, dtype, schemes, tol, seed=0):
    """Gate dfdx/dfdy/dfdz, laplacian and filter_field (method='auto') at
    n^3 against the float64 oracle on sampled lines. Returns
    ``{check: rel_err}``; raises AssertionError on the first failure."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cfd_tpu
    from cfd_tpu.models import broadband_field
    from cfd_tpu.oracle import derivative_np

    dx = 2 * math.pi / n
    f = broadband_field(n, seed=seed, dtype=dtype)
    idx = _sample_idx(n, seed)
    f_lines = {ax: _host(_lines(f, ax, idx)) for ax in (-1, -2, -3)}
    mid = np.arange(N_LINES)
    errs = {}

    def check(name, got, ref, scale):
        err = float(np.max(np.abs(got - ref))) / scale
        errs[name] = err
        log(f"  {name:<40} rel err {err:.3e}  (tol {tol:g})")
        assert err < tol, f"{name}: rel err {err:.3e} >= {tol:g}"

    ops = {
        -1: jax.jit(lambda g, s: cfd_tpu.dfdx(g, dx, s), static_argnums=1),
        -2: jax.jit(lambda g, s: cfd_tpu.dfdy(g, dx, s), static_argnums=1),
        -3: jax.jit(lambda g, s: cfd_tpu.dfdz(g, dx, s), static_argnums=1),
    }
    lap = jax.jit(lambda g, s: cfd_tpu.laplacian(g, dx, s), static_argnums=1)
    filt = jax.jit(
        lambda g, s, ax: cfd_tpu.filter_field(g, s, axis=ax), static_argnums=(1, 2)
    )
    for sch in schemes:
        for ax, op in ops.items():
            ref = derivative_np(sch, f_lines[ax], dx, axis=-1)
            got = _host(_lines(op(f, sch), ax, idx))
            check(f"{sch.name} d/d{'xyz'[ax]}", got, ref, np.max(np.abs(ref)))
        d2 = cfd_tpu.get_scheme(sch.order, sch.periodic, derivative=2)
        refs = [derivative_np(d2, f_lines[ax], dx, axis=-1) for ax in (-1, -2, -3)]
        # the sampled point sits at index iz/iy/ix of its z/y/x line
        iz, iy, ix = idx
        ref = refs[0][mid, ix] + refs[1][mid, iy] + refs[2][mid, iz]
        got = _host(_at_points(lap(f, d2), idx))
        check(f"{sch.name} laplacian", got, ref, sum(np.max(np.abs(r)) for r in refs))
        flt = cfd_tpu.get_filter(6, periodic=sch.periodic)
        for ax in (-1, -2, -3):
            ref = derivative_np(flt, f_lines[ax], 1.0, axis=-1)
            got = _host(_lines(filt(f, flt, ax), ax, idx))
            check(f"{sch.name} {flt.name} axis {ax}", got, ref, np.max(np.abs(ref)))
    return errs


def navier_stokes_gate(n, steps=3, nu=1e-2, dt=1e-3, dtype=None):
    """3 steps of NavierStokes.single_device on the z-independent Taylor–
    Green vortex against the exact solution. Returns metrics; raises
    AssertionError on failure."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfd_tpu.models import NavierStokes, taylor_green_2d
    from cfd_tpu.schemes import SCHEME4_PERIODIC

    dtype = dtype or jnp.float32
    d = 2 * math.pi / n
    c = jnp.arange(n, dtype=dtype) * d
    (u0, v0, w0), _ = taylor_green_2d(c, c, c)
    ns = NavierStokes.single_device(d, SCHEME4_PERIODIC, nu=nu)
    step = jax.jit(lambda u: ns.step(u, dt))
    t0 = time.perf_counter()
    compiled = step.lower((u0, v0, w0)).compile()
    compile_s = time.perf_counter() - t0
    u = (u0, v0, w0)
    jax.block_until_ready(u)
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        u = jax.block_until_ready(compiled(u))
        step_s.append(time.perf_counter() - t0)
    decay = math.exp(-2.0 * nu * dt * steps)
    umax = float(jnp.max(jnp.abs(u0)))
    err = max(
        float(jnp.max(jnp.abs(a - decay * b))) for a, b in zip(u, (u0, v0, w0))
    ) / umax
    # decay factor read off a projection onto the initial mode; per-plane
    # partial sums on the device, the rest in float64 on the host
    def inner(a, b):
        return float(np.sum(np.asarray(jnp.sum(a * b, axis=(-2, -1)), np.float64)))

    f_num = sum(inner(a, b) for a, b in zip(u, (u0, v0, w0))) / sum(
        inner(b, b) for b in (u0, v0, w0)
    )
    div = float(jnp.max(jnp.abs(ns.divergence(u)))) / (umax / d)
    out = dict(
        compile_s=compile_s,
        step_ms=[1e3 * s for s in step_s],
        rel_err=err,
        decay_expected=decay,
        decay_measured=f_num,
        rel_divergence=div,
    )
    log(f"  NS {n}^3: compile {compile_s:.2f} s, steps "
        + ", ".join(f"{1e3 * s:.2f} ms" for s in step_s))
    log(f"  NS velocity rel err {err:.3e} (tol {NS_TOL:g}); decay factor "
        f"{f_num:.8f} vs exact {decay:.8f} (tol {NS_DECAY_TOL:g}); "
        f"divergence {div:.3e} of max|u|/dx (tol {DIV_TOL:g})")
    assert np.isfinite(err) and err < NS_TOL, f"NS velocity rel err {err:.3e}"
    assert abs(f_num - decay) < NS_DECAY_TOL, (
        f"NS decay factor {f_num:.8f} vs {decay:.8f}"
    )
    assert div < DIV_TOL, f"NS divergence {div:.3e}"
    return out


def four_card_gates(n, ckpt_dir):
    """Distributed solver, distributed Navier–Stokes and the checkpoint
    round trip on four devices, each against one device. Raises
    AssertionError on failure."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cfd_tpu
    from cfd_tpu.models import NavierStokes, broadband_field, taylor_green_2d
    from cfd_tpu.parallel import Grid, make_mesh
    from cfd_tpu.schemes import SCHEME4, SCHEME4_PERIODIC
    from cfd_tpu.utils.checkpointing import restore_state, save_state

    devs = jax.devices()
    assert len(devs) >= 4, f"needs 4 devices, have {len(devs)}"
    card0 = devs[0]
    d = 2 * math.pi / n
    f = broadband_field(n, seed=1)
    f0 = jax.device_put(f, card0)
    errs = {}

    def rel(a, b):
        b = np.asarray(b)
        return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))

    ops = {2: cfd_tpu.dfdx, 1: cfd_tpu.dfdy, 0: cfd_tpu.dfdz}
    for sch in (SCHEME4_PERIODIC, SCHEME4):
        single = {
            ax: jax.jit(lambda g, op=op: op(g, d, sch))(f0) for ax, op in ops.items()
        }
        for shape in ((1, 2, 2), (4, 1, 1), (1, 1, 4)):
            grid = Grid(make_mesh(shape, devices=devs[:4]), (n, n, n), (d, d, d), sch)
            solver = cfd_tpu.DistributedCompactSolver(grid)
            fd = grid.distribute(f)
            for ax in (2, 1, 0):
                e = rel(solver.apply(fd, ax), single[ax])
                name = f"{sch.name} mesh {shape} axis {'zyx'[ax]}"
                errs[name] = e
                log(f"  {name:<40} rel err {e:.3e} (tol {DIST_TOL:g})")
                assert e < DIST_TOL, f"{name}: {e:.3e}"
    grid = Grid(make_mesh((1, 1, 4), devices=devs[:4]), (n, n, n), (d, d, d), SCHEME4)
    pp = cfd_tpu.DistributedCompactSolver(grid, method="phipsi")
    e = rel(pp.dfdx(grid.distribute(f)), jax.jit(lambda g: cfd_tpu.dfdx(g, d, SCHEME4))(f0))
    errs["phipsi mesh (1, 1, 4) axis x"] = e
    log(f"  {'phipsi mesh (1, 1, 4) axis x':<40} rel err {e:.3e} (tol {DIST_TOL:g})")
    assert e < DIST_TOL, f"phipsi: {e:.3e}"

    grid = Grid(make_mesh((1, 2, 2), devices=devs[:4]), (n, n, n), (d, d, d), SCHEME4_PERIODIC)
    c = jnp.arange(n, dtype=jnp.float32) * d
    u0, _ = taylor_green_2d(c, c, c)
    ns_d = NavierStokes.distributed(grid, nu=1e-2)
    ns_s = NavierStokes.single_device(d, SCHEME4_PERIODIC, nu=1e-2)
    step_d = jax.jit(lambda u: ns_d.step(u, 1e-3))
    step_s = jax.jit(lambda u: ns_s.step(u, 1e-3))
    ud = tuple(grid.distribute(a) for a in u0)
    us = tuple(jax.device_put(a, card0) for a in u0)
    for _ in range(3):
        ud = step_d(ud)
        us = step_s(us)
    umax = max(float(jnp.max(jnp.abs(a))) for a in us)
    e = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) for a, b in zip(ud, us)) / umax
    errs["NavierStokes.distributed (1, 2, 2) 3 steps"] = e
    log(f"  NavierStokes.distributed (1,2,2), 3 steps: rel err {e:.3e} (tol {NS_TOL:g})")
    assert e < NS_TOL, f"distributed NS: {e:.3e}"

    names = ("ux", "uy", "uz")
    path = os.path.join(ckpt_dir, "ns_state")
    save_state(path, dict(zip(names, ud)), backend="npz")
    st = restore_state(path, distribute=grid.distribute, backend="npz")
    ur = tuple(st[k] for k in names)
    same = all(
        bool(jnp.array_equal(a, b)) for a, b in zip(step_d(ud), step_d(ur))
    )
    log(f"  checkpoint round trip: restored state steps identically: {same}")
    assert same, "checkpoint round trip changed the next step"
    return errs


def card_description():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description="cfd_tpu smoke test on NVIDIA GPUs")
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card distributed phase",
    )
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX backend is {jax.default_backend()!r})")
    sys.path.insert(0, ROOT)
    from cfd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    devs = jax.devices()
    log(card_description())
    log(f"device {devs[0].device_kind}, count {len(devs)}")
    t_start = time.perf_counter()
    if args.four:
        if len(devs) != 4:
            sys.exit(f"chip_smoke --four: needs 4 GPUs, have {len(devs)}")
        log(f"phase 3: four cards, {N}^3")
        ckpt_dir = os.path.join(ROOT, "chiprun_out", "smoke_ckpt")
        os.makedirs(ckpt_dir, exist_ok=True)
        try:
            four_card_gates(N, ckpt_dir)
        finally:
            import shutil

            shutil.rmtree(ckpt_dir, ignore_errors=True)
    else:
        import jax.numpy as jnp

        from cfd_tpu.schemes import SCHEME4, SCHEME4_PERIODIC, SCHEME6

        log(f"phase 1: derivatives at {N}^3 f32")
        derivative_gates(N, jnp.float32, (SCHEME4, SCHEME4_PERIODIC, SCHEME6), F32_TOL)
        log(f"phase 2: NavierStokes.single_device at {N}^3 f32")
        navier_stokes_gate(N)
        jax.config.update("jax_enable_x64", True)
        log(f"phase 1b: derivatives at {N}^3 f64")
        derivative_gates(N, jnp.float64, (SCHEME4,), F64_TOL, seed=1)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
