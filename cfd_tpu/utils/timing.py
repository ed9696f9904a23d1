"""Host-clock timing helpers.

The reference times phases with MPI barriers + ``cuda.Context.synchronize``
around each call (/root/reference/code/cuda/timer.py:4-16); the JAX
analogue is a host clock around work that ends in ``block_until_ready``.

``chain_time`` times a *data-dependent chain* of k applications of an op
inside one jitted computation for two values of k and reports the slope:
the fixed per-dispatch cost cancels, and the data dependence forces the
applications to run one after another on the device.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["chain_time", "phase_timer"]


def _build_chain(step: Callable, k: int):
    """jit(x -> step applied k times), with a data dependence between steps."""

    @jax.jit
    def run(x):
        def body(_, y):
            out = step(y)
            if jax.tree.structure(out) == jax.tree.structure(y) and all(
                o.shape == i.shape
                for o, i in zip(jax.tree.leaves(out), jax.tree.leaves(y))
            ):
                return out
            # force the next iteration to depend on this one even if step's
            # output shape differs from its input. The folded-in summary
            # must not be provably zero (XLA simplifies 0*x away and would
            # dead-code-eliminate the step): scale by a tiny constant that
            # underflows in the addition but survives simplification.
            s = jnp.mean(jax.tree.leaves(out)[0])
            return jax.tree.map(
                lambda a: a
                * (1 + jnp.asarray(1e-38, a.dtype) * s.astype(a.dtype)),
                y,
            )

        return jax.lax.fori_loop(0, k, body, x)

    return run


def chain_time(
    step: Callable,
    x: jax.Array,
    *,
    k_small: int = 2,
    k_big: int = 34,
    repeats: int = 3,
) -> float:
    """Seconds per application of ``step`` measured by chain-slope timing.

    ``step`` must map an array — or a pytree of arrays, e.g. a vector field
    as a (ux, uy, uz) tuple — to an output of the same structure and leaf
    shapes/dtypes (so the chain is a genuine sequential dependence; a
    mismatched output is folded into the carry instead). The slope is
    taken between the best of ``repeats`` timings of each chain.
    """
    small = _build_chain(step, k_small)
    big = _build_chain(step, k_big)
    jax.block_until_ready(small(x))  # compile + warm both
    jax.block_until_ready(big(x))

    def best_of(fn):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x))
            best = min(best, time.perf_counter() - t0)
        return best

    slope = (best_of(big) - best_of(small)) / (k_big - k_small)
    return max(slope, 1e-12)


class phase_timer:
    """Named phase timer (host wall clock), rank-0 print.

    The lightweight analogue of the reference's ``@timeit`` phase decorator;
    the timed block must end in ``block_until_ready`` (or a host readback)
    for the figure to include the device work.
    """

    def __init__(self, name: str, *, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose and jax.process_index() == 0:
            print(f"[cfd_tpu] {self.name}: {self.elapsed * 1e3:.3f} ms")
        return False
