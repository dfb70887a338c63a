"""Compile-cache placement (utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR
wins and the code sets nothing; otherwise a fixed in-checkout directory."""

import os

import jax
import pytest

from regex_fpga_tpu.utils.compile_cache import (
    CHECKOUT_CACHE_DIR,
    enable_compile_cache,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_placement(env_set, monkeypatch, tmp_path,
                             restore_cache_dir):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        # left to JAX: the code set nothing
        assert jax.config.jax_compilation_cache_dir == restore_cache_dir
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert enable_compile_cache() == CHECKOUT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE_DIR
        # fixed, at the checkout root — never a temp/pid/time path
        assert CHECKOUT_CACHE_DIR == os.path.join(_ROOT, ".jax_cache")
