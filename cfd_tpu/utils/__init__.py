"""Utilities: timing, profiling, checkpointing, compile-cache placement."""

from .checkpointing import restore_state, save_state
from .compile_cache import compile_cache_dir, enable_compile_cache
from .profiling import trace
from .timing import chain_time, phase_timer

__all__ = [
    "chain_time",
    "phase_timer",
    "save_state",
    "restore_state",
    "trace",
    "compile_cache_dir",
    "enable_compile_cache",
]
