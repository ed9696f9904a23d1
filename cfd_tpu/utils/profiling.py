"""Profiler integration: trace capture.

The reference ships one nvprof capture and compiles kernels with
-lineinfo (SURVEY.md §5); the JAX equivalent is an XLA trace viewable in
TensorBoard/Perfetto. ``trace`` wraps ``jax.profiler.trace``; the
captured ``*.xplane.pb`` is read back by ``utils/xplane.py``.
"""

from __future__ import annotations

import contextlib

import jax

__all__ = ["trace"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace of the enclosed computation.

    Example:
        with cfd_tpu.utils.trace("/tmp/cfd_trace"):
            df = jax.block_until_ready(cfd_tpu.dfdx(f, dx))
    """
    with jax.profiler.trace(logdir):
        yield
