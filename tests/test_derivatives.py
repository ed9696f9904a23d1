"""Single-device derivative API vs the float64 oracle and analytic fields.

Mirrors the reference's integration tests (code/cuda/test/test_compact.py,
code/ocl/test/test_compact.py: sin -> cos and x*y*z fields, dfdx/dfdy/dfdz)
but asserts at 1e-10 in float64 instead of decimal=2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.oracle import derivative_np
from cfd_tpu.ops.rhs import closure_ghosts, compact_rhs
from cfd_tpu.schemes import (
    SCHEME4,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_PERIODIC,
)

ALL_SCHEMES = [SCHEME4, SCHEME6, SCHEME4_PERIODIC, SCHEME6_PERIODIC]
IDS = [s.name for s in ALL_SCHEMES]


def _field(nz=6, ny=8, nx=32):
    z = np.linspace(0.1, 1.2, nz)[:, None, None]
    y = np.linspace(0.2, 1.4, ny)[None, :, None]
    x = np.linspace(0.3, 1.6, nx)[None, None, :]
    return x * np.cos(x * y) + np.sin(z) * y, (z, y, x)


@pytest.mark.parametrize("scheme", ALL_SCHEMES, ids=IDS)
@pytest.mark.parametrize("method", ["pcr", "thomas", "matmul"])
def test_rhs_and_solve_vs_oracle(rng, scheme, method):
    n = 32
    f = rng.standard_normal((n, 5, 3))
    dx = 0.013
    got = np.asarray(
        cfd_tpu.derivative(jnp.asarray(f), dx, scheme, axis=0, method=method)
    )
    expect = derivative_np(scheme, f, dx, axis=0)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_axis_handling_vs_oracle(rng, axis):
    f = rng.standard_normal((6, 8, 16))
    dx = 0.05
    got = np.asarray(cfd_tpu.derivative(jnp.asarray(f), dx, SCHEME4, axis=axis))
    expect = derivative_np(SCHEME4, f, dx, axis=axis)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-11)


def test_dfdx_dfdy_dfdz_analytic():
    # the reference's multi-GPU benchmark field f = x cos(xy) + sin(z) y
    f, (z, y, x) = _field(32, 32, 64)
    dz = float(z[1, 0, 0] - z[0, 0, 0])
    dy = float(y[0, 1, 0] - y[0, 0, 0])
    dx = float(x[0, 0, 1] - x[0, 0, 0])
    fj = jnp.asarray(f)
    dfdx_exact = np.cos(x * y) - x * y * np.sin(x * y) + 0 * f
    dfdy_exact = -(x**2) * np.sin(x * y) + np.sin(z) + 0 * f
    dfdz_exact = np.cos(z) * y + 0 * f
    assert np.max(np.abs(np.asarray(cfd_tpu.dfdx(fj, dx)) - dfdx_exact)) < 2e-4
    assert np.max(np.abs(np.asarray(cfd_tpu.dfdy(fj, dy)) - dfdy_exact)) < 2e-4
    assert np.max(np.abs(np.asarray(cfd_tpu.dfdz(fj, dz)) - dfdz_exact)) < 2e-4


def test_jit_and_vmap_clean():
    f, _ = _field()
    fj = jnp.asarray(f)
    jitted = jax.jit(lambda g: cfd_tpu.dfdx(g, 0.05))
    np.testing.assert_allclose(
        np.asarray(jitted(fj)), np.asarray(cfd_tpu.dfdx(fj, 0.05)), rtol=1e-12
    )
    batched = jax.vmap(lambda g: cfd_tpu.dfdx(g, 0.05))(jnp.stack([fj, 2 * fj]))
    np.testing.assert_allclose(
        np.asarray(batched[1]), 2 * np.asarray(batched[0]), rtol=1e-12
    )


def test_gradient_divergence_curl():
    f, (z, y, x) = _field(12, 12, 32)
    spacing = (
        float(z[1, 0, 0] - z[0, 0, 0]),
        float(y[0, 1, 0] - y[0, 0, 0]),
        float(x[0, 0, 1] - x[0, 0, 0]),
    )
    fj = jnp.asarray(f)
    gx, gy, gz = cfd_tpu.gradient(fj, spacing)
    assert gx.shape == f.shape and gy.shape == f.shape and gz.shape == f.shape
    # curl(grad f) = 0 up to truncation error
    cx, cy, cz = cfd_tpu.curl((gx, gy, gz), spacing)
    for c in (cx, cy, cz):
        assert float(jnp.max(jnp.abs(c))) < 5e-2
    # divergence of (f, 0, 0) equals dfdx
    div = cfd_tpu.divergence((fj, jnp.zeros_like(fj), jnp.zeros_like(fj)), spacing)
    np.testing.assert_allclose(
        np.asarray(div), np.asarray(cfd_tpu.dfdx(fj, spacing[2])), rtol=1e-12
    )


def test_unknown_method():
    with pytest.raises(ValueError, match="unknown solver method"):
        cfd_tpu.derivative(jnp.zeros((8, 2)), 0.1, SCHEME4, method="magic")


@pytest.mark.parametrize("scheme", [SCHEME4, SCHEME6], ids=["pade4", "lele6"])
def test_closure_ghosts_reproduce_closure_rhs(rng, scheme):
    # interior stencil applied over [ghosts; f; ghosts] must equal compact_rhs
    n = 24
    f = jnp.asarray(rng.standard_normal((n, 7)))
    gl, gr = closure_ghosts(f, scheme)
    f_ext = jnp.concatenate([gl, f, gr], axis=0)
    w = scheme.stencil_width
    r = jnp.zeros_like(f)
    for k, wt in zip(scheme.rhs_offsets, scheme.rhs_weights):
        r = r + wt * (f_ext[w + k : w + k + n] - f_ext[w - k : w - k + n])
    np.testing.assert_allclose(
        np.asarray(r), np.asarray(compact_rhs(f, 1.0, scheme)), rtol=1e-12, atol=1e-12
    )


def test_matmul_method_f32(rng):
    # the dense-operator path at f32 (HIGHEST): roundoff-level agreement
    f = rng.standard_normal((6, 4, 64)).astype(np.float32)
    got = np.asarray(
        cfd_tpu.derivative(jnp.asarray(f), 0.05, SCHEME4, axis=-1, method="matmul")
    )
    ref = derivative_np(SCHEME4, f, 0.05, axis=-1)
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel < 5e-6, rel


@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_matmul_axis_handling(rng, axis):
    f = rng.standard_normal((8, 12, 16))
    got = np.asarray(
        cfd_tpu.derivative(jnp.asarray(f), 0.1, SCHEME6, axis=axis, method="matmul")
    )
    ref = derivative_np(SCHEME6, f, 0.1, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("scheme", ALL_SCHEMES, ids=IDS)
@pytest.mark.parametrize("axis", [-1, -3])
def test_blocked_matmul_long_lines(rng, scheme, axis):
    # lines longer than the whole-operator cutoff take the blocked
    # substructuring path (per-block inverses + reduced interface matmul)
    from cfd_tpu.ops.derivatives import _blocked_matmul_derivative

    shape = [3, 4]
    shape.insert({-1: 2, -3: 0}[axis], 1024)
    f = rng.standard_normal(tuple(shape))
    got = np.asarray(
        _blocked_matmul_derivative(jnp.asarray(f), 0.01, scheme, axis % 3, None)
    )
    ref = derivative_np(scheme, f, 0.01, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


def test_blocked_matmul_odd_length(rng):
    # non-power-of-two long line: block picker falls back to any divisor
    from cfd_tpu.ops.derivatives import _blocked_matmul_derivative

    f = rng.standard_normal((2, 3, 1000))
    got = np.asarray(
        _blocked_matmul_derivative(jnp.asarray(f), 0.02, SCHEME4, 2, None)
    )
    ref = derivative_np(SCHEME4, f, 0.02, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


def test_bfloat16_inputs(rng):
    # bf16 fields are accepted on every path and keep their dtype
    f = jnp.asarray(rng.standard_normal((4, 4, 64)), jnp.bfloat16)
    for method in ("matmul", "pcr"):
        out = cfd_tpu.derivative(f, 0.05, SCHEME4, axis=-1, method=method)
        assert out.dtype == jnp.bfloat16
        ref = derivative_np(SCHEME4, np.asarray(f, np.float64), 0.05, axis=-1)
        rel = np.max(np.abs(np.asarray(out, np.float64) - ref)) / np.max(np.abs(ref))
        assert rel < 0.05, (method, rel)  # bf16 has ~3 decimal digits


@pytest.mark.parametrize("scheme", ALL_SCHEMES, ids=IDS)
@pytest.mark.parametrize("axis", [0, 2])
def test_stencil_method_vs_oracle(rng, scheme, axis):
    # explicit wide-stencil form of the implicit scheme (banded_operator)
    shape = [4, 5]
    shape.insert(axis if axis == 0 else 2, 128)
    f = rng.standard_normal(tuple(shape))
    got = np.asarray(
        cfd_tpu.derivative(jnp.asarray(f), 0.01, scheme, axis=axis, method="stencil")
    )
    ref = derivative_np(scheme, f, 0.01, axis=axis)
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel < 2e-7, rel


def test_stencil_rejects_short_lines():
    with pytest.raises(ValueError, match="too short"):
        cfd_tpu.derivative(jnp.zeros((32, 4)), 0.1, SCHEME4, axis=0, method="stencil")


@pytest.mark.parametrize("method", ["pcr", "thomas", "matmul"])
def test_autodiff_through_derivative(rng, method):
    """The derivative is linear, so jax.grad of sum(dfdx(f)) must equal the
    operator's column sums (adjoint applied to ones) — AD works through all
    XLA-level backends."""
    from cfd_tpu.ops.derivatives import dense_operator

    n = 32
    dx = 0.07
    f = jnp.asarray(rng.standard_normal((4, n)))
    g = jax.grad(lambda h: jnp.sum(cfd_tpu.derivative(h, dx, SCHEME4, axis=-1, method=method)))(f)
    M = dense_operator(SCHEME4, n)
    expect = np.broadcast_to(M.sum(axis=0) / dx, (4, n))
    np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-9, atol=1e-10)


def test_jvp_matches_linearity(rng):
    n = 32
    f = jnp.asarray(rng.standard_normal((n,)))
    v = jnp.asarray(rng.standard_normal((n,)))
    fn = lambda h: cfd_tpu.derivative(h, 0.1, SCHEME6, axis=0)
    _, jv = jax.jvp(fn, (f,), (v,))
    np.testing.assert_allclose(np.asarray(jv), np.asarray(fn(v)), rtol=1e-11)


@pytest.mark.parametrize(
    "scheme,order",
    [
        (SCHEME4, 4),
        (SCHEME6, 5),
        (SCHEME4_PERIODIC, 4),
        (SCHEME6_PERIODIC, 6),
    ],
    ids=["pade4", "lele6", "pade4_periodic", "lele6_periodic"],
)
def test_device_path_convergence_order(scheme, order):
    """Refinement sweep through the device API (f64 PCR path), with
    asserted rates — the reference's test_convergence.py only prints
    (code/cuda/test/test_convergence.py:23-52)."""
    errs = []
    for n in (32, 64, 128, 256):
        if scheme.periodic:
            dx = 2 * np.pi / n
            x = np.arange(n) * dx
        else:
            x = np.linspace(0.0, 1.0, n)
            dx = x[1] - x[0]
        f = jnp.asarray(np.sin(4 * x))
        df = np.asarray(cfd_tpu.derivative(f, dx, scheme, axis=-1, method="pcr"))
        errs.append(np.max(np.abs(df - 4 * np.cos(4 * x))))
    rates = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    # non-periodic global order is limited by the closure at the wall, but
    # boundary-layer weighting keeps observed rates near the interior order
    assert np.all(rates > order - 1.2), (errs, rates)
