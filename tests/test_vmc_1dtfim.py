"""End-to-end VMC integration test: N=6 TFIM vs exact diagonalization.

Automates the reference's notebook acceptance procedure
(``Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` cells 6-18: train small N,
compare mean of trailing energies against ED within the error bar).
"""

import jax
import numpy as np
import pytest

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact


@pytest.mark.slow
def test_vmc_converges_to_ed_energy():
    n, bx = 6, 1.0
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, bx))

    ansatz = PRNN1D(num_sites=n, units=(16,))
    ham = TFIM1D(num_sites=n, bx=bx)
    config = TrainConfig(num_samples=256, learning_rate=5e-3, seed=111)
    trainer = VMCTrainer(ansatz, ham, config)

    state, mean_e, var_e = trainer.fit(400, key=jax.random.PRNGKey(0))

    tail = np.asarray(mean_e[-100:], dtype=np.float64)
    est = tail.mean()
    err_bar = np.sqrt(np.max(var_e[-100:]) / (config.num_samples * 100))
    # Reference convention (Tutorial_1DTFIM.ipynb cell 18) plus slack for the
    # short run length.
    assert abs(est - e_exact) < max(5 * err_bar, 5e-2 * abs(e_exact)), (
        f"VMC energy {est:.6f} vs exact {e_exact:.6f} (err bar {err_bar:.2e})"
    )


def test_single_step_runs_and_is_finite():
    ansatz = PRNN1D(num_sites=10, units=(12,))
    ham = TFIM1D(num_sites=10, bx=1.0)
    trainer = VMCTrainer(ansatz, ham, TrainConfig(num_samples=64))
    state = trainer.init()
    state, metrics = trainer.step(state, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["mean_energy"]))
    assert np.isfinite(float(metrics["var_energy"]))
    assert int(state.step) == 1
