"""Arbitrary-cell injection (the reference constructor accepts any TF
RNNCell class, ``1DTFIM/RNNwavefunction.py:13``; here any object with the
init/apply/zero_state protocol of ``models/cells.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions import CRNNU1, PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.models.cells import ElmanCell


def _all_configs(n):
    idx = np.arange(2**n)
    return jnp.asarray(((idx[:, None] >> np.arange(n)[None, :]) & 1), jnp.int32)


def test_custom_cell_prnn1d_normalized_and_consistent():
    n = 6
    ansatz = PRNN1D(num_sites=n, units=(12, 12), cell=ElmanCell())
    params = ansatz.init(jax.random.PRNGKey(0))
    # autoregressive density normalizes over the full Hilbert space
    lp = ansatz.log_prob(params, _all_configs(n))
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(lp))), 1.0, atol=1e-5)
    # the sampling scan's by-product log-prob == teacher-forced log-prob
    draws, lp_s = ansatz.sample_with_log_prob(params, jax.random.PRNGKey(1), 64)
    np.testing.assert_allclose(
        np.asarray(lp_s), np.asarray(ansatz.log_prob(params, draws)), atol=1e-5
    )


@pytest.mark.slow
def test_custom_cell_trains_vmc():
    n = 6
    trainer = VMCTrainer(
        PRNN1D(num_sites=n, units=(12,), cell=ElmanCell()),
        TFIM1D(num_sites=n, bx=1.0),
        TrainConfig(num_samples=64, learning_rate=5e-3),
    )
    state = trainer.init()
    key = jax.random.PRNGKey(0)
    state, m0 = trainer.step(state, key)
    for _ in range(60):
        state, m = trainer.step(state, key)
    assert float(m["mean_energy"]) < float(m0["mean_energy"])


def test_custom_cell_crnn_trunk_sector_and_normalization():
    n = 6
    ansatz = CRNNU1(num_sites=n, units=(10,), cell=ElmanCell())
    params = ansatz.init(jax.random.PRNGKey(0))
    draws = ansatz.sample(params, jax.random.PRNGKey(1), 128)
    assert (np.asarray(draws).sum(axis=1) == n // 2).all()
    # |psi|^2 over the full space sums to 1 (the U(1) mask renormalizes)
    lp = ansatz.log_prob(params, _all_configs(n))
    total = float(jnp.sum(jnp.exp(lp)))
    np.testing.assert_allclose(total, 1.0, atol=1e-5)
