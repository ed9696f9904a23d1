"""Checkpoint/restore for simulation state.

The reference has no persistence at all (SURVEY.md §5 — its only outputs are
demo plots and benchmark stdout); production time-stepping needs restartable
state, so this provides a sharded-aware checkpoint with two backends:

* ``orbax`` — orbax.checkpoint PyTree save/restore (optional, imported
  lazily). Arrays are written per-shard without a host gather, so this is
  the backend for states larger than host memory comfortably holds;
  restore can re-shard directly via a ``distribute`` callback.
* ``npz``  — a dependency-free numpy fallback. Gathers every array to the
  host on save: fine for small/medium states, unusable for multi-GiB
  sharded fields.

``backend='auto'`` (default) picks orbax when importable, else npz.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

__all__ = ["save_state", "restore_state"]


def _orbax():
    try:
        import orbax.checkpoint as ocp

        return ocp
    except Exception:
        return None


def _resolve(backend: str):
    if backend == "auto":
        return "orbax" if _orbax() is not None else "npz"
    if backend not in ("orbax", "npz"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    if backend == "orbax" and _orbax() is None:
        raise RuntimeError("orbax backend requested but orbax is not importable")
    return backend


def save_state(path: str, state: dict, *, backend: str = "auto") -> None:
    """Save a flat dict of arrays (device or host) at ``path``.

    orbax writes a checkpoint directory (sharded arrays saved per-shard, no
    host gather); npz writes ``path``.npz via a full host gather.
    """
    backend = _resolve(backend)
    if backend == "orbax":
        ocp = _orbax()
        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(os.path.abspath(path), dict(state), force=True)
        return
    host = {k: np.asarray(v) for k, v in state.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **host)


def restore_state(
    path: str,
    distribute: Optional[Callable] = None,
    *,
    backend: str = "auto",
) -> dict:
    """Load a dict of arrays; optionally re-shard each via ``distribute``."""
    backend = _resolve(backend)
    if backend == "orbax" and os.path.isdir(os.path.abspath(path)):
        ocp = _orbax()
        ckptr = ocp.PyTreeCheckpointer()
        state = dict(ckptr.restore(os.path.abspath(path)))
    else:
        p = path if path.endswith(".npz") else path + ".npz"
        with np.load(p) as data:
            state = {k: data[k] for k in data.files}
    if distribute is not None:
        state = {k: distribute(v) for k, v in state.items()}
    return state
