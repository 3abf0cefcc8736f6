"""Compensated (Kahan) accumulation: f64-grade log-prob sums at f32 speed.

The reference promotes the per-site log-probability sum to float64
(``/root/reference/1DTFIM/RNNwavefunction.py:113-116``) because a plain f32
running sum of N ~ 1000 site terms drifts by ~1e-3 (sequential rounding on a
|logp| ~ 0.7 N magnitude accumulator).  Float64 runs far slower than float32
on accelerators, so the rebuild reproduces the reference's f64-sum
semantics with a Kahan compensated pair carried in two f32 registers: the
running error of each add is captured and fed back, bounding the total
accumulation error at ~2 eps |logp| independent of N
(tests/test_accum_precision.py checks it against a float64 oracle).

Used by the rollout kernel (``ops/rollout.py``) and by the models' jnp scan
paths when ``accum_dtype`` is float32 (``accum_dtype=jnp.float64`` keeps a
plain sum — it is already exact to eps).  Gradients are unaffected: the
compensated sum is linear with per-term coefficient exactly 1
(``dc/dx = (1 - 1) = 0`` term by term), so autodiff through the jnp path
stays correct.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def kadd(s, c, x):
    """One compensated add: returns the updated (sum, compensation) pair.

    All three operands are same-shape f32 arrays (kernel rows or scan
    carries).  Not safe under reassociation — XLA and Triton both preserve
    float add order by default, verified against a float64 oracle in
    tests/test_accum_precision.py.
    """
    y = x - c
    t = s + y
    c = (t - s) - y
    return t, c


def kfinal(s, c):
    """Final corrected value of a compensated pair."""
    return s - c


def accum_sum(xs, accum_dtype, axis: int = 0):
    """Site-log-prob sum with the reference's f64-sum semantics
    (``1DTFIM/RNNwavefunction.py:113-116``): a plain sum when
    ``accum_dtype`` is float64 (already exact to eps), a Kahan-compensated
    f32 sum otherwise.  A float64 *request* with jax x64 disabled would
    silently execute as an uncompensated f32 sum — exactly the error class
    this module exists to prevent — so it falls through to the compensated
    sum unless x64 is actually on (cli/run_loop.resolve_dtype enables it
    for the ``--dtype float64`` runners)."""
    if jnp.dtype(accum_dtype) == jnp.float64 and jax.config.jax_enable_x64:
        return jnp.sum(xs, axis=axis)
    return compensated_sum(xs, axis=axis)


def compensated_sum(xs, axis: int = 0):
    """Kahan sum of a stacked array along ``axis`` (sequential order — the
    same order the rollout kernel accumulates in).

    Infinity-safe: a -inf term (the jnp cRNN path's masked-class log-prob,
    ``models/crnn_u1.py``) must propagate as -inf, but the raw compensation
    update would turn it into NaN (``(t - s) - y`` with both infinite); the
    compensation is zeroed whenever the running sum is non-finite.  The
    rollout kernel's site terms are always finite, so it keeps the raw
    ``kadd``.
    """
    xs = jnp.moveaxis(xs, axis, 0)
    zero = jnp.zeros_like(xs[0])

    def step(carry, x):
        s, c = carry
        s, c = kadd(s, c, x)
        c = jnp.where(jnp.isfinite(s), c, jnp.zeros_like(c))
        return (s, c), None

    (s, c), _ = lax.scan(step, (zero, zero), xs)
    return kfinal(s, c)
