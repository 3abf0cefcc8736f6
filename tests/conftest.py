"""Test configuration: the suite runs on the CPU, on 8 virtual devices.

Tests run on the CPU backend (the card is exercised by ``chip_smoke.py``),
so these config lines come before any backend use:

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

Sharding semantics are validated on the 8 virtual devices (SURVEY.md §4
"Distributed" strategy).  The GPU rollout kernel runs here in Pallas
interpret mode (tests/test_rollout_kernel.py).

The persistent compilation cache follows the package's one rule
(``utils/compile_cache.py``): ``JAX_COMPILATION_CACHE_DIR`` where set, else
``.jax_cache/`` at the checkout root.  The suite is compile-dominated, so
warm re-runs of unchanged tests skip XLA compilation.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)

from rnnwavefunctions.utils import compile_cache  # noqa: E402

compile_cache.enable()
