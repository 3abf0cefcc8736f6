"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI runners, ``bench.py``,
``chip_smoke.py`` and the test suite): where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and no other directory is configured here;
otherwise the cache is ``.jax_cache/`` at the root of the checkout (listed
in ``.gitignore``), so the program writes nothing outside its checkout.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the rule selects."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Apply the rule and return the cache directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir()
