"""Local-energy estimator vs brute-force dense-Hamiltonian contraction."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.ed import exact
from rnnwavefunctions.hamiltonians.tfim1d import TFIM1D
from rnnwavefunctions.models.prnn1d import PRNN1D
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn


def brute_force_local_energy(h_dense, log_amp_fn, samples, n):
    """E_loc(s) = sum_s' H[s', s] * psi(s') / psi(s) over the full basis."""
    dim = 1 << n
    basis = np.asarray(
        [[(c >> i) & 1 for i in range(n)] for c in range(dim)], np.int32
    )
    la = np.asarray(log_amp_fn(jnp.asarray(basis)))
    out = []
    for s in np.asarray(samples):
        code = int(np.dot(s, 2 ** np.arange(n)))
        col = h_dense[:, code]
        nz = np.nonzero(col)[0]
        out.append(np.sum(col[nz] * np.exp(la[nz] - la[code])))
    return np.asarray(out)


@pytest.mark.parametrize("chunk_size", [None, 16])
def test_tfim1d_local_energy_matches_dense(chunk_size):
    n = 6
    bx = 0.7
    ansatz = PRNN1D(num_sites=n, units=(10,))
    ham = TFIM1D(num_sites=n, bx=bx)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(1), 32)

    le = make_local_energy_fn(ansatz, ham, chunk_size)
    log_amp_s = ansatz.log_amp(params, samples)
    got = np.asarray(le(params, samples, log_amp_s)[0])

    h = exact.tfim1d_dense(n, bx)
    want = brute_force_local_energy(
        h, lambda s: ansatz.log_amp(params, s), samples, n
    )
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_tfim1d_connected_matches_dense_column():
    """connected() must enumerate exactly the nonzeros of a dense H column."""
    n = 5
    bx = 1.3
    ham = TFIM1D(num_sites=n, bx=bx)
    h = exact.tfim1d_dense(n, bx)
    for code in [0, 7, 19, 31]:
        sigma = jnp.asarray([(code >> i) & 1 for i in range(n)], jnp.int32)
        diag, flips, elements, mask = ham.connected(sigma)
        np.testing.assert_allclose(float(diag), h[code, code], rtol=1e-6)
        for k in range(ham.n_offdiag):
            if not bool(mask[k]):
                continue
            code_k = int(np.dot(np.asarray(flips[k]), 2 ** np.arange(n)))
            np.testing.assert_allclose(
                float(elements[k]), h[code_k, code], rtol=1e-6
            )


def test_zero_field_local_energy_is_diagonal():
    n = 8
    ansatz = PRNN1D(num_sites=n, units=(6,))
    ham = TFIM1D(num_sites=n, bx=0.0)
    params = ansatz.init(jax.random.PRNGKey(2))
    samples = ansatz.sample(params, jax.random.PRNGKey(3), 16)
    le = make_local_energy_fn(ansatz, ham)
    got = np.asarray(le(params, samples, ansatz.log_amp(params, samples))[0])
    z = 2 * np.asarray(samples) - 1
    want = -np.sum(z[:, :-1] * z[:, 1:], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
