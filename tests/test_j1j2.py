"""Tests for the complex path: cRNN with U(1) masking and the J1-J2 chain."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.ed import exact
from rnnwavefunctions.hamiltonians.j1j2 import J1J2
from rnnwavefunctions.models.crnn_u1 import CRNNU1
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions import TrainConfig, VMCTrainer


def all_configs(n):
    return jnp.asarray(list(itertools.product([0, 1], repeat=n)), jnp.int32)


def code_basis(n):
    return jnp.asarray(
        [[(c >> i) & 1 for i in range(n)] for c in range(1 << n)], jnp.int32
    )


# -- cRNN U(1) --------------------------------------------------------------

@pytest.mark.parametrize("u1", [True, False])
def test_crnn_normalization(u1):
    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,), u1=u1)
    params = ansatz.init(jax.random.PRNGKey(0))
    lp = ansatz.log_prob(params, all_configs(n))
    total = float(jnp.sum(jnp.exp(lp)))
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_u1_sampler_zero_magnetization():
    n = 8
    ansatz = CRNNU1(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(1))
    samples = ansatz.sample(params, jax.random.PRNGKey(2), 256)
    ups = np.asarray(jnp.sum(samples, axis=1))
    assert (ups == n // 2).all(), f"magnetization violated: {np.unique(ups)}"


def test_u1_density_zero_outside_sector():
    """log_amp masking must agree with the sampler: any config with nonzero
    magnetization has zero probability."""
    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(3))
    sigma = all_configs(n)
    lp = np.asarray(ansatz.log_prob(params, sigma))
    mags = np.asarray(jnp.sum(sigma, axis=1))
    assert np.all(np.isneginf(lp[mags != n // 2]))
    assert np.all(np.isfinite(lp[mags == n // 2]))


def test_crnn_sampling_consistency():
    ansatz = CRNNU1(num_sites=8, units=(10,))
    params = ansatz.init(jax.random.PRNGKey(4))
    samples, lp_sampling = ansatz.sample_with_log_prob(
        params, jax.random.PRNGKey(5), 64
    )
    lp = ansatz.log_prob(params, samples)
    np.testing.assert_allclose(np.asarray(lp_sampling), np.asarray(lp), atol=1e-4)
    la = ansatz.log_amp(params, samples)
    assert la.dtype == jnp.complex64
    np.testing.assert_allclose(
        np.asarray(2 * jnp.real(la)), np.asarray(lp), atol=1e-5
    )


# -- J1J2 Hamiltonian -------------------------------------------------------

@pytest.mark.parametrize("marshall", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_j1j2_connected_matches_dense(marshall, periodic):
    n = 6
    ham = J1J2(num_sites=n, j1=1.0, j2=0.4, bz=0.3, periodic=periodic,
               marshall_sign=marshall)
    h = exact.j1j2_dense(n, 1.0, 0.4, 0.3, periodic=periodic,
                         marshall_sign=marshall)
    weights = 2 ** np.arange(n)
    for code in [0, 11, 21, 42, 63, 37]:
        sigma = jnp.asarray([(code >> i) & 1 for i in range(n)], jnp.int32)
        diag, flips, elements, mask = ham.connected(sigma)
        np.testing.assert_allclose(float(diag), h[code, code], rtol=1e-6,
                                   atol=1e-7)
        # accumulate masked elements per target config and compare columns
        col = np.zeros(1 << n)
        for k in range(ham.n_offdiag):
            if bool(mask[k]):
                code_k = int(np.asarray(flips[k]) @ weights)
                assert code_k != code
                col[code_k] += float(elements[k])
        offdiag_col = np.array(h[:, code])
        offdiag_col[code] = 0.0
        np.testing.assert_allclose(col, offdiag_col, atol=1e-6)


def test_j1j2_local_energy_matches_dense():
    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,))
    ham = J1J2(num_sites=n, j1=1.0, j2=0.3, marshall_sign=True)
    params = ansatz.init(jax.random.PRNGKey(6))
    samples = ansatz.sample(params, jax.random.PRNGKey(7), 24)
    le = make_local_energy_fn(ansatz, ham)
    e_re, e_im, _ = le(params, samples, ansatz.log_amp_parts(params, samples))
    got = np.asarray(e_re) + 1j * np.asarray(e_im)

    h = exact.j1j2_dense(n, 1.0, 0.3, marshall_sign=True)
    la = np.asarray(ansatz.log_amp(params, code_basis(n)))
    weights = 2 ** np.arange(n)
    want = []
    for s in np.asarray(samples):
        code = int(s @ weights)
        col = h[:, code]
        nz = np.nonzero(col)[0]
        want.append(np.sum(col[nz] * np.exp(la[nz] - la[code])))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=1e-5)


# -- integration ------------------------------------------------------------

@pytest.mark.slow
def test_vmc_j1j2_converges_to_ed():
    n, j2 = 6, 0.2
    e_exact = exact.ground_state_energy(
        exact.j1j2_dense(n, 1.0, j2, marshall_sign=True)
    )
    ansatz = CRNNU1(num_sites=n, units=(16,))
    ham = J1J2(num_sites=n, j1=1.0, j2=j2, marshall_sign=True)
    trainer = VMCTrainer(
        ansatz, ham, TrainConfig(num_samples=256, learning_rate=2e-3)
    )
    state, mean_e, var_e = trainer.fit(500, key=jax.random.PRNGKey(0))
    est = float(np.real(np.mean(mean_e[-50:])))
    assert abs(est - e_exact) < 5e-2 * abs(e_exact), (
        f"J1J2 VMC {est:.5f} vs exact {e_exact:.5f}"
    )
    # imaginary part of the energy must vanish statistically
    assert abs(float(np.imag(np.mean(mean_e[-50:])))) < 0.05
