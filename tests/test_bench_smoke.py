"""bench.py must stay runnable: exercise it at a tiny size in-process."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_bench_runs_and_emits_json():
    env = dict(os.environ, BENCH_N="64")
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--platform", "cpu"],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
        cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.strip().splitlines() if l.startswith("{")][-1]
    rec = json.loads(line)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["value"] > 0
