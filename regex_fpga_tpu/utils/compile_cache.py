"""Where JAX keeps its persistent compilation cache.

Entry points (``python -m regex_fpga_tpu``, ``chip_smoke.py``, ``bench.py``)
call ``enable_compile_cache`` once before their first compile; importing
the package sets nothing.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

#: fixed in-checkout cache directory (listed in ``.gitignore``): the path is
#: part of the cache key, so it must not move between runs
CHECKOUT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache`` at the
    root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
