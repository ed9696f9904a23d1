"""Route selection (ops.derivatives.resolve_method) and the GPU routes.

resolve_method takes the platform as an input, so the GPU table is tested
here on the CPU; the GPU routes themselves are plain JAX and run here
against the float64 oracle. Tracing with ``jax.default_backend`` patched to
"gpu" checks what the card would compile without needing the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cfd_tpu
from cfd_tpu.oracle import derivative_np
from cfd_tpu.ops import derivatives as D
from cfd_tpu.schemes import (
    SCHEME4,
    SCHEME4_D2,
    SCHEME4_D2_PERIODIC,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_D2_PERIODIC,
    get_filter,
)

ROUTES = {"pcr", "thomas", "stencil", "matmul"}
DTYPES = ("float32", "bfloat16", "float64")
ORDERS = (0, 1, 2)
# one scheme per (derivative order, periodic)
SCHEMES = {
    (0, False): get_filter(),
    (1, False): SCHEME4,
    (2, False): SCHEME4_D2,
    (0, True): get_filter(periodic=True),
    (1, True): SCHEME4_PERIODIC,
    (2, True): SCHEME4_D2_PERIODIC,
}


@pytest.mark.parametrize("n", D._GPU_LINES)
@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
@pytest.mark.parametrize(
    "platform,dtype,cls,order",
    list(itertools.product(("cpu", "gpu"), DTYPES, D.AXIS_CLASSES, ORDERS)),
)
def test_resolve_auto(platform, dtype, cls, order, periodic, n):
    got = D.resolve_method(
        "auto", jnp.dtype(dtype), n, platform=platform, axis_class=cls,
        scheme=SCHEMES[(order, periodic)],
    )
    assert got in ROUTES
    if platform == "cpu":
        assert got == "pcr"
    elif periodic:
        assert got == "matmul"
    else:
        # every measured scheme's stencil fits: the table entry stands
        assert got == D._GPU_ROUTES[(cls, dtype, order)][D._GPU_LINES.index(n)]


def test_gpu_table_is_complete_and_plain():
    keys = set(itertools.product(D.AXIS_CLASSES, DTYPES, ORDERS))
    assert set(D._GPU_ROUTES) == keys
    assert all(len(v) == len(D._GPU_LINES) for v in D._GPU_ROUTES.values())
    assert {r for v in D._GPU_ROUTES.values() for r in v} <= ROUTES


@pytest.mark.parametrize("n", [256, 384, 511, 512, 1024])
def test_gpu_route_follows_line_length(n):
    """Lines of 256-511 points take the 256^3 winner, longer ones the
    512^3 winner: the f32 minor-axis filter changes route between them."""
    got = D.resolve_method(
        "auto", jnp.float32, n, platform="gpu", axis_class="minor",
        scheme=get_filter(),
    )
    assert got == ("matmul" if n < 512 else "stencil")


WIDE_FILTERS = [0.48, 0.49, 0.499]


@pytest.mark.parametrize("n", D._GPU_LINES)
@pytest.mark.parametrize("alpha", WIDE_FILTERS)
@pytest.mark.parametrize("cls", ["minor", "second_minor"])
def test_wide_stencil_takes_dense_operator(cls, alpha, n):
    """A filter whose alpha nears 1/2 has a stencil wider than any timed
    on the card (and at 256 points wider than the line): 'auto' takes the
    dense operator where the table says stencil."""
    sch = get_filter(alpha=alpha)
    c = D.banded_operator(sch, n, D._stencil_tol(jnp.float32))[0]
    assert (len(c) - 1) // 2 > D._GPU_STENCIL_MAX_BW
    got = D.resolve_method(
        "auto", jnp.float32, n, platform="gpu", axis_class=cls, scheme=sch
    )
    assert got == "matmul"


def test_measured_filter_width_keeps_stencil():
    """The alpha=0.45 filter is the widest stencil that won on the card."""
    sch = get_filter()
    c = D.banded_operator(sch, 512, D._stencil_tol(jnp.float32))[0]
    assert (len(c) - 1) // 2 == D._GPU_STENCIL_MAX_BW
    assert D.resolve_method(
        "auto", jnp.float32, 512, platform="gpu", axis_class="minor", scheme=sch
    ) == "stencil"


@pytest.mark.parametrize("alpha", WIDE_FILTERS)
def test_wide_filter_gpu_route_vs_oracle(rng, alpha):
    """filter_field with a near-1/2 alpha on 256-point lines: the GPU route
    runs (the stencil would not fit) and matches the float64 oracle."""
    sch = get_filter(alpha=alpha)
    n = 256
    f = rng.standard_normal((2, 3, n)).astype(np.float32)
    method = D.resolve_method(
        "auto", jnp.float32, n, platform="gpu", axis_class="minor", scheme=sch
    )
    got = np.asarray(
        cfd_tpu.filter_field(jnp.asarray(f), sch, axis=-1, method=method),
        np.float64,
    )
    ref = derivative_np(sch, f.astype(np.float64), 1.0, axis=-1)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < TOLS["float32"]


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("method", sorted(ROUTES))
def test_explicit_method_passes_through(platform, method):
    assert D.resolve_method(method, jnp.float32, 64, platform=platform) == method


@pytest.mark.parametrize("method", ["pallas", "magic"])
def test_removed_or_unknown_method_rejected(method):
    with pytest.raises(ValueError, match="unknown solver method"):
        D.resolve_method(method, jnp.float32, 256, platform="gpu")
    with pytest.raises(ValueError, match="unknown solver method"):
        cfd_tpu.derivative(jnp.zeros((8, 256)), 0.1, SCHEME4, method=method)


def test_unmeasured_platform_rejected():
    with pytest.raises(ValueError, match="no measured routes"):
        D.resolve_method("auto", jnp.float32, 256, platform="rocm")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gpu_short_lines_take_dense_operator(dtype):
    for cls in D.AXIS_CLASSES:
        got = D.resolve_method(
            "auto", jnp.dtype(dtype), D._GPU_LINES[0] - 1, platform="gpu",
            axis_class=cls,
        )
        assert got == "matmul"


@pytest.mark.parametrize(
    "ndim,axis,expected",
    [
        (1, 0, "minor"),
        (2, 1, "minor"),
        (2, 0, "second_minor"),
        (3, -2, "second_minor"),
        (3, 0, "leading"),
        (4, 1, "leading"),
    ],
)
def test_axis_class(ndim, axis, expected):
    assert D.axis_class(ndim, axis) == expected


# --- the GPU routes, run here against the float64 oracle -------------------

ROUTE_SCHEMES = [SCHEME4, SCHEME6, SCHEME4_PERIODIC, SCHEME4_D2,
                 SCHEME6_D2_PERIODIC, get_filter()]
AXES = {"minor": -1, "second_minor": -2, "leading": -3}
# f32: roundoff through the line solve, relative to max|f'|; f64: the
# oracle parity gate
TOLS = {"float32": 1e-5, "float64": 1e-10}


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("cls", D.AXIS_CLASSES)
@pytest.mark.parametrize("scheme", ROUTE_SCHEMES, ids=lambda s: s.name)
def test_gpu_route_vs_oracle(rng, scheme, cls, dtype):
    """The route the GPU picks for this scheme, axis class and dtype, at the
    shortest measured line length, against the float64 oracle."""
    n = D._GPU_LINES[0]
    method = D.resolve_method(
        "auto", jnp.dtype(dtype), n, platform="gpu", axis_class=cls,
        scheme=scheme,
    )
    shape = [3, 2, 2]
    shape[AXES[cls]] = n
    f = rng.standard_normal(shape).astype(dtype)
    dx = 2 * np.pi / n
    got = np.asarray(
        cfd_tpu.derivative(
            jnp.asarray(f), dx, scheme, axis=AXES[cls], method=method
        ),
        np.float64,
    )
    ref = derivative_np(scheme, f.astype(np.float64), dx, axis=AXES[cls])
    rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert rel < TOLS[dtype], (method, rel)


@pytest.mark.parametrize("scheme", [SCHEME4, get_filter()], ids=lambda s: s.name)
def test_stencil_tolerance_follows_dtype(scheme):
    """float64 fields get a wider stencil (truncation below the 1e-10 gate);
    f32 and bf16 keep the narrow one."""
    c32 = D.banded_operator(scheme, 512, D._stencil_tol(jnp.float32))[0]
    c64 = D.banded_operator(scheme, 512, D._stencil_tol(jnp.float64))[0]
    assert D._stencil_tol(jnp.bfloat16) == D._stencil_tol(jnp.float32)
    assert len(c64) > len(c32)


# --- precision of every contraction on the accuracy path -------------------


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a closed jaxpr, recursively."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _is_highest(p):
    h = jax.lax.Precision.HIGHEST
    return p == h or (isinstance(p, tuple) and all(q == h for q in p))


def _f32(shape=(8, 8, 256)):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


PRECISION_CASES = {
    "compact_rhs": lambda: (
        lambda f: cfd_tpu.ops.compact_rhs(f, 0.1, SCHEME4, axis=-1), _f32()
    ),
    "derivative_matmul": lambda: (
        lambda f: cfd_tpu.derivative(f, 0.1, SCHEME4, method="matmul"), _f32()
    ),
    "derivative_blocked_matmul": lambda: (
        lambda f: cfd_tpu.derivative(f, 0.1, SCHEME4, method="matmul"),
        _f32((2, 2, 1024)),
    ),
    "derivative_stencil": lambda: (
        lambda f: cfd_tpu.derivative(f, 0.1, SCHEME4, axis=0, method="stencil"),
        _f32((256, 4, 4)),
    ),
    "derivative_pcr": lambda: (
        lambda f: cfd_tpu.derivative(f, 0.1, SCHEME6, method="pcr"), _f32()
    ),
    "derivative_auto": lambda: (
        lambda f: cfd_tpu.derivative(f, 0.1, SCHEME4), _f32()
    ),
    "laplacian": lambda: (lambda f: cfd_tpu.laplacian(f, 0.1), _f32((256,) * 3)),
    "filter_field": lambda: (lambda f: cfd_tpu.filter_field(f), _f32((256,) * 3)),
    "project": lambda: (
        lambda f: cfd_tpu.project((f, f, f), 0.1, SCHEME4_PERIODIC, method="compact"),
        _f32((256,) * 3),
    ),
}


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("case", sorted(PRECISION_CASES))
def test_f32_contractions_ask_for_highest(monkeypatch, case, platform):
    """Every f32 dot_general on the accuracy path asks for HIGHEST: at
    default precision the GPU may contract f32 in TF32 (~3 digits)."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    fn, arg = PRECISION_CASES[case]()
    precs = _dot_precisions(jax.make_jaxpr(fn)(arg))
    assert all(_is_highest(p) for p in precs), precs


def test_distributed_contractions_ask_for_highest(monkeypatch):
    """The substructured solve's local dense inverse and reduced-system
    matmul (the GPU 'auto' local route) at f32."""
    from cfd_tpu.parallel import Grid, make_mesh

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    grid = Grid(make_mesh((1, 2, 4)), (256, 512, 1024), (0.1,) * 3, SCHEME4)
    solver = cfd_tpu.DistributedCompactSolver(grid)
    assert solver._local_method("float32", 256) == "matmul"
    precs = _dot_precisions(
        jax.make_jaxpr(solver.dfdx)(jax.ShapeDtypeStruct(grid.shape, jnp.float32))
    )
    assert precs and all(_is_highest(p) for p in precs), precs
