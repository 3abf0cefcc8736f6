"""Unit tests for the 1D pRNN ansatz (SURVEY.md §4 unit-test plan)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.models.prnn1d import PRNN1D


def all_configs(n):
    return jnp.asarray(list(itertools.product([0, 1], repeat=n)), jnp.int32)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("units", [(10,), (8, 6)])
def test_autoregressive_normalization(parity, units):
    """exp(log p) over all 2^N configs must sum to 1."""
    n = 6
    ansatz = PRNN1D(num_sites=n, units=units, parity=parity)
    params = ansatz.init(jax.random.PRNGKey(0))
    lp = ansatz.log_prob(params, all_configs(n))
    total = jnp.sum(jnp.exp(lp))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-4)


def test_sampling_log_prob_matches_teacher_forced():
    """The log-density returned by the sampling scan must equal the
    teacher-forced log_prob of the drawn samples."""
    ansatz = PRNN1D(num_sites=9, units=(12,))
    params = ansatz.init(jax.random.PRNGKey(1))
    samples, lp_sampling = ansatz.sample_with_log_prob(
        params, jax.random.PRNGKey(2), 64
    )
    lp = ansatz.log_prob(params, samples)
    np.testing.assert_allclose(np.asarray(lp_sampling), np.asarray(lp), atol=1e-5)
    assert samples.shape == (64, 9)
    assert samples.dtype == jnp.int32
    assert set(np.unique(np.asarray(samples))) <= {0, 1}


def test_parity_symmetry():
    """Symmetrized density must be invariant under spatial reflection
    (RNNwavefunction_paritysym.py:145 semantics)."""
    n = 7
    ansatz = PRNN1D(num_sites=n, units=(10,), parity=True)
    params = ansatz.init(jax.random.PRNGKey(3))
    sigma = jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, (32, n)).astype(
        jnp.int32
    )
    lp = ansatz.log_prob(params, sigma)
    lp_rev = ansatz.log_prob(params, sigma[:, ::-1])
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lp_rev), atol=1e-6)


def test_parity_log_prob_is_mean_of_both_directions():
    n = 5
    plain = PRNN1D(num_sites=n, units=(10,), parity=False)
    sym = PRNN1D(num_sites=n, units=(10,), parity=True)
    params = plain.init(jax.random.PRNGKey(5))
    sigma = all_configs(n)
    lp1 = plain.log_prob(params, sigma)
    lp2 = plain.log_prob(params, sigma[:, ::-1])
    expected = np.log(0.5 * (np.exp(np.asarray(lp1)) + np.exp(np.asarray(lp2))))
    got = sym.log_prob(params, sigma)
    np.testing.assert_allclose(np.asarray(got), expected, atol=1e-4)


def test_sampling_distribution_matches_density():
    """Empirical frequencies of a tiny chain track exp(log_prob)."""
    n = 3
    ansatz = PRNN1D(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(6))
    num = 40000
    samples = ansatz.sample(params, jax.random.PRNGKey(7), num)
    codes = np.asarray(samples) @ (2 ** np.arange(n))
    freq = np.bincount(codes, minlength=2**n) / num
    probs = np.exp(np.asarray(ansatz.log_prob(params, all_configs(n))))
    # config codes: all_configs enumerates in lexicographic order of bits
    codes_ref = np.asarray(all_configs(n)) @ (2 ** np.arange(n))
    probs_by_code = np.zeros(2**n)
    probs_by_code[codes_ref] = probs
    np.testing.assert_allclose(freq, probs_by_code, atol=0.01)


def test_log_amp_is_half_log_prob():
    ansatz = PRNN1D(num_sites=6, units=(10,))
    params = ansatz.init(jax.random.PRNGKey(8))
    sigma = all_configs(6)[:17]
    np.testing.assert_allclose(
        np.asarray(ansatz.log_amp(params, sigma)),
        0.5 * np.asarray(ansatz.log_prob(params, sigma)),
        atol=1e-7,
    )
