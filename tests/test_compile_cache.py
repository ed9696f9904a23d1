"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

import os

import jax
import pytest

from cfd_tpu.utils.compile_cache import ENV_VAR, compile_cache_dir, enable_compile_cache


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_unset_uses_checkout_dir(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.delenv(ENV_VAR, raising=False)
    want = os.path.join(str(tmp_path), ".jax_cache")
    assert compile_cache_dir(str(tmp_path)) == want
    assert enable_compile_cache(str(tmp_path)) == want
    assert jax.config.jax_compilation_cache_dir == want


def test_set_is_honoured_and_nothing_else_configured(
    monkeypatch, tmp_path, restore_cache_config
):
    mine = str(tmp_path / "elsewhere")
    monkeypatch.setenv(ENV_VAR, mine)
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache_dir(str(tmp_path)) == mine
    assert enable_compile_cache(str(tmp_path)) == mine
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir is None


def test_path_is_fixed_per_checkout(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert compile_cache_dir("a/b") == compile_cache_dir("a/b")
    assert compile_cache_dir("a/b").endswith(os.path.join("a", "b", ".jax_cache"))
