"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

import os

import jax
import pytest

from navier_stokes_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured_and_not_overridden(restore_cache_dir,
                                                monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_default_is_one_fixed_directory_in_the_checkout(restore_cache_dir,
                                                        monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_compile_cache() == path


def test_default_directory_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert os.path.basename(compile_cache.DEFAULT_DIR) + "/" in ignored
