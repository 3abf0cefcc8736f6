"""Local-energy estimator: Hamiltonian consistency and the generic path
across ansatz variants."""

import jax
import jax.numpy as jnp
import numpy as np

from rnnwavefunctions import CRNNU1, J1J2, PRNN1D, TFIM1D, TFIM2D
from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn


def test_tfim_diagonal_matches_connected():
    for ham, sigma in [
        (TFIM1D(num_sites=7, bx=1.3),
         jnp.asarray([0, 1, 1, 0, 1, 0, 0], jnp.int32)),
        (TFIM2D(nx=3, ny=2, bx=0.7, encoding="flat"),
         jnp.asarray([1, 0, 1, 1, 0, 0], jnp.int32)),
    ]:
        diag, *_ = ham.connected(sigma)
        np.testing.assert_allclose(
            float(ham.diagonal(sigma)), float(diag), rtol=1e-6
        )


def test_j1j2_diagonal_matches_connected():
    ham = J1J2(num_sites=8, j1=1.0, j2=0.4, bz=0.2)
    sigma = jnp.asarray([0, 1, 1, 0, 1, 0, 0, 1], jnp.int32)
    diag, *_ = ham.connected(sigma)
    np.testing.assert_allclose(float(ham.diagonal(sigma)), float(diag),
                               rtol=1e-6)


def test_fused_paths_fall_back_cleanly():
    """Every ansatz variant produces finite local energies through the one
    generic estimator, on any backend."""
    cases = [
        (PRNN1D(num_sites=6, units=(8, 8)), TFIM1D(num_sites=6, bx=1.0)),
        (PRNN1D(num_sites=6, units=(8,), parity=True), TFIM1D(num_sites=6)),
        (CRNNU1(num_sites=6, units=(8,)),
         J1J2(num_sites=6, j2=0.2, periodic=True)),
        (PRNNSnake2D(nx=3, ny=2, units=(8,)),
         TFIM2D(nx=3, ny=2, bx=1.0, encoding="flat")),
    ]
    for ansatz, ham in cases:
        params = ansatz.init(jax.random.PRNGKey(0))
        samples = ansatz.sample(params, jax.random.PRNGKey(1), 8)
        le = make_local_energy_fn(ansatz, ham)
        if getattr(ansatz, "is_complex", False):
            la = ansatz.log_amp_parts(params, samples)
        else:
            la = ansatz.log_amp(params, samples)
        e_re, e_im, _ = le(params, samples, la)
        assert np.isfinite(np.asarray(e_re)).all()
