"""Compensated (Kahan) log-prob accumulation vs a float64 oracle.

The reference promotes the per-site log-prob sum to float64
(``1DTFIM/RNNwavefunction.py:113-116``); the rebuild
reproduces that error class with a Kahan pair carried in f32
(``ops/compsum.py``, used by the rollout kernel's accumulator and the
models' f32 jnp paths).  These tests pin the guarantee against float64
oracles — and would fail with a plain f32 running sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.models.prnn1d import PRNN1D
from rnnwavefunctions.ops.compsum import compensated_sum


def test_compensated_sum_matches_f64():
    """Kahan f32 sum of N=4096 site-logp-scale terms lands in the f64-sum
    error class; the naive sequential f32 sum does not."""
    rng = np.random.default_rng(0)
    xs64 = -rng.normal(0.7, 0.3, size=(4096, 8))
    xs32 = xs64.astype(np.float32)
    want = np.sum(xs32.astype(np.float64), axis=0)

    naive = np.zeros(8, np.float32)
    for row in xs32:  # sequential f32: the pre-compensation kernel order
        naive = naive + row
    comp = np.asarray(compensated_sum(jnp.asarray(xs32)))

    err_naive = np.max(np.abs(naive.astype(np.float64) - want))
    err_comp = np.max(np.abs(comp.astype(np.float64) - want))
    assert err_comp < 2e-4
    assert err_comp < err_naive / 5


def test_compensated_sum_inf_safe():
    """-inf terms (the jnp cRNN path's masked classes) propagate as -inf,
    not NaN."""
    xs = jnp.array([[1.0, 1.0], [-jnp.inf, 2.0], [3.0, 3.0]], jnp.float32)
    out = np.asarray(compensated_sum(xs))
    assert np.isneginf(out[0])
    assert out[1] == pytest.approx(6.0)


def _f32_and_f64_models(n, units, seed=0):
    wf64 = PRNN1D(
        num_sites=n, units=units, dtype=jnp.float64,
        accum_dtype=jnp.float64,
    )
    params64 = wf64.init(jax.random.PRNGKey(seed))
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), params64)
    wf32 = PRNN1D(num_sites=n, units=units)
    return wf64, params64, wf32, params32


def test_prnn1d_logp_matches_f64_oracle():
    """f32 jnp path (compensated sum) at N=2048 stays within ~2 eps |logp|
    of the float64 end-to-end oracle.  A plain f32 sum drifts ~3e-4 at this
    length and fails the bound."""
    n, s = 2048, 4
    with jax.enable_x64(True):
        wf64, params64, wf32, params32 = _f32_and_f64_models(n, (4,))
        samples = jax.random.bernoulli(
            jax.random.PRNGKey(1), 0.5, (s, n)
        ).astype(jnp.int32)
        lp64 = np.asarray(wf64.log_prob(params64, samples))
        lp32 = np.asarray(wf32.log_prob(params32, samples))
    assert np.mean(-lp64) > 500.0  # a genuinely long-chain magnitude
    assert np.max(np.abs(lp32.astype(np.float64) - lp64)) < 1.2e-4


def test_fused_logp_kernel_matches_f64_oracle():
    """The GPU rollout kernel's in-kernel Kahan accumulator (interpret
    mode) lands in the same f64-oracle error class as the compensated jnp
    path."""
    from rnnwavefunctions.ops import rollout

    n, s = 1024, 4
    with jax.enable_x64(True):
        wf64, params64, wf32, params32 = _f32_and_f64_models(n, (4,), seed=2)
        samples = jax.random.bernoulli(
            jax.random.PRNGKey(3), 0.5, (s, n)
        ).astype(jnp.int32)
        lp64 = np.asarray(wf64.log_prob(params64, samples))
    lp_k = np.asarray(rollout.log_prob(
        params32, samples, wf32._log_prob_plain_jnp, interpret=True))
    assert np.max(np.abs(lp_k.astype(np.float64) - lp64)) < 1.2e-4
