"""chip_smoke.py and bench.py: refusal without a GPU, and the gates at small n.

The gates run on the card at 512^3 through ``python chip_smoke.py``; here
the same functions run at n=32 on the CPU (and the four-card phase on four
of the suite's virtual CPU devices).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, env=None):
    return subprocess.run(
        [sys.executable, *args],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(cwd),
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )


def test_chip_smoke_refuses_without_gpu():
    out = _run([str(REPO / "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_without_gpu():
    out = _run([str(REPO / "bench.py")], REPO)
    assert out.returncode != 0
    assert "--platform cpu" in out.stderr
    assert not out.stdout.strip()


@pytest.fixture
def smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke

        yield chip_smoke
    finally:
        sys.path.remove(str(REPO))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.float64, 1e-10)])
def test_derivative_gates_small(smoke, dtype, tol):
    from cfd_tpu.schemes import SCHEME4, SCHEME4_PERIODIC, SCHEME6

    errs = smoke.derivative_gates(32, dtype, (SCHEME4, SCHEME4_PERIODIC, SCHEME6), tol)
    # 3 schemes x (3 axes + laplacian + 3 filter axes)
    assert len(errs) == 21 and max(errs.values()) < tol


def test_derivative_gates_bite(smoke):
    from cfd_tpu.schemes import SCHEME4

    with pytest.raises(AssertionError, match="rel err"):
        smoke.derivative_gates(32, jnp.float32, (SCHEME4,), 1e-12)


def test_navier_stokes_gate_small(smoke):
    out = smoke.navier_stokes_gate(32)
    assert len(out["step_ms"]) == 3
    assert out["rel_err"] < smoke.NS_TOL


def test_four_card_gates_small(smoke, tmp_path):
    errs = smoke.four_card_gates(32, str(tmp_path))
    assert max(errs.values()) < smoke.NS_TOL

