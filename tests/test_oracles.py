"""Independent oracles for the jnp paths, at sizes where the full 2^N basis
is enumerable.

* local energies against ``H psi / psi`` from the dense ED Hamiltonians, for
  every family and Hamiltonian variant;
* normalization and sample / log-prob consistency of LSTM and stacked
  trunks;
* the surrogate-loss gradient with exactly enumerated weights against the
  gradient of <H> = psi^T H psi / psi^T psi;
* per-sample jacobian rows against vmap(grad) across cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions import CRNNU1, J1J2, MDRNN2D, PRNN1D, TFIM1D, TFIM2D
from rnnwavefunctions.ed import exact
from rnnwavefunctions.ed.fidelity import basis_configs
from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D
from rnnwavefunctions.vmc import jacobian
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions.vmc.loss import surrogate_loss

N = 6


def _case(name):
    """(ansatz, hamiltonian, dense H) for a named variant, all on 6 sites."""
    tfim = (TFIM1D(num_sites=N, bx=0.7), exact.tfim1d_dense(N, 0.7))

    def j1j2(**kw):
        return (J1J2(num_sites=N, j1=1.0, j2=0.3, **kw),
                exact.j1j2_dense(N, 1.0, 0.3, **kw))

    def tfim2d(nx, ny, encoding):
        return (TFIM2D(nx=nx, ny=ny, bx=0.9, encoding=encoding),
                exact.tfim2d_dense(nx, ny, 0.9))

    cases = {
        "gru": (PRNN1D(num_sites=N, units=(10,)),) + tfim,
        "lstm": (PRNN1D(num_sites=N, units=(8,), cell="lstm"),) + tfim,
        "gru-2layer": (PRNN1D(num_sites=N, units=(8, 8)),) + tfim,
        "lstm-2layer": (PRNN1D(num_sites=N, units=(8, 8), cell="lstm"),) + tfim,
        "parity": (PRNN1D(num_sites=N, units=(8,), parity=True),) + tfim,
        "snake-3x2": (PRNNSnake2D(nx=3, ny=2, units=(8,)),)
        + tfim2d(3, 2, "flat"),
        "mdrnn-2x3": (MDRNN2D(nx=2, ny=3, units=6),) + tfim2d(2, 3, "grid"),
        "mdrnn-3x2": (MDRNN2D(nx=3, ny=2, units=6),) + tfim2d(3, 2, "grid"),
        "crnn-open": (CRNNU1(num_sites=N, units=(8,)),) + j1j2(),
        "crnn-periodic": (CRNNU1(num_sites=N, units=(8,)),)
        + j1j2(periodic=True),
        "crnn-marshall": (CRNNU1(num_sites=N, units=(8,)),)
        + j1j2(marshall_sign=True),
        "crnn-periodic-marshall": (CRNNU1(num_sites=N, units=(8,)),)
        + j1j2(periodic=True, marshall_sign=True),
        "crnn-lstm": (CRNNU1(num_sites=N, units=(8,), cell="lstm"),) + j1j2(),
    }
    return cases[name]


def _basis(ansatz):
    """All 2^N configurations in the ED basis order, in the ansatz's
    encoding (grid ansatze take [x, y] grids of the y-major flat index)."""
    b = jnp.asarray(basis_configs(N))
    if isinstance(ansatz, MDRNN2D):
        b = jnp.transpose(b.reshape(-1, ansatz.ny, ansatz.nx), (0, 2, 1))
    return b


def _log_amp_pair(ansatz, params, samples):
    if getattr(ansatz, "is_complex", False):
        return ansatz.log_amp_parts(params, samples)
    return ansatz.log_amp(params, samples), None


def _dense_local_energy(h, la_re, la_im, codes):
    la = np.asarray(la_re, np.float64) + 1j * (
        0.0 if la_im is None else np.asarray(la_im, np.float64))
    psi = np.exp(la)
    h_psi = h @ psi
    return h_psi[codes] / psi[codes]


def _codes(ansatz, samples):
    s = np.asarray(samples)
    if isinstance(ansatz, MDRNN2D):
        s = np.transpose(s, (0, 2, 1)).reshape(len(s), -1)
    return s @ (2 ** np.arange(N))


ALL = ["gru", "lstm", "gru-2layer", "lstm-2layer", "parity", "snake-3x2",
       "mdrnn-2x3", "mdrnn-3x2", "crnn-open", "crnn-periodic",
       "crnn-marshall", "crnn-periodic-marshall", "crnn-lstm"]


@pytest.mark.parametrize("name", ALL)
def test_local_energy_matches_dense_h_psi(name):
    ansatz, ham, h = _case(name)
    params = ansatz.init(jax.random.PRNGKey(4))
    samples = ansatz.sample(params, jax.random.PRNGKey(5), 24)
    la_s = _log_amp_pair(ansatz, params, samples)
    la_arg = la_s if la_s[1] is not None else la_s[0]
    e_re, e_im, _ = make_local_energy_fn(ansatz, ham)(params, samples, la_arg)
    got = np.asarray(e_re) + (0.0 if e_im is None else 1j * np.asarray(e_im))
    want = _dense_local_energy(
        h, *_log_amp_pair(ansatz, params, _basis(ansatz)),
        _codes(ansatz, samples))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


NORMALIZED = ["lstm", "lstm-2layer", "gru-2layer", "parity", "snake-3x2",
              "crnn-lstm", "mdrnn-2x3"]


@pytest.mark.parametrize("name", NORMALIZED)
def test_density_is_normalized(name):
    ansatz, _, _ = _case(name)
    params = ansatz.init(jax.random.PRNGKey(1))
    lp = ansatz.log_prob(params, _basis(ansatz))
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(lp))), 1.0, rtol=1e-4)


CONSISTENT = ["lstm", "lstm-2layer", "gru-2layer", "snake-3x2", "crnn-lstm",
              "mdrnn-2x3"]


@pytest.mark.parametrize("name", CONSISTENT)
def test_sampler_log_prob_matches_teacher_forced(name):
    """The sampler's by-product log-density equals the teacher-forced
    log-prob of the drawn samples."""
    ansatz, _, _ = _case(name)
    params = ansatz.init(jax.random.PRNGKey(2))
    samples, lp = ansatz.sample_with_log_prob(
        params, jax.random.PRNGKey(3), 64)
    np.testing.assert_allclose(np.asarray(lp),
                               np.asarray(ansatz.log_prob(params, samples)),
                               rtol=1e-5, atol=1e-5)


GRADIENT = ["gru", "lstm", "parity", "snake-3x2", "mdrnn-2x3", "crnn-open",
            "crnn-periodic-marshall"]


@pytest.mark.parametrize("name", GRADIENT)
def test_surrogate_gradient_with_exact_weights_is_grad_energy(name):
    """Sum over the whole basis, weighted by |psi|^2, of the surrogate loss
    equals d<H>/dtheta; <H> here is psi^T H psi / psi^T psi from the dense
    Hamiltonian."""
    ansatz, ham, h = _case(name)
    params = ansatz.init(jax.random.PRNGKey(6))
    basis = _basis(ansatz)
    la_re, la_im = _log_amp_pair(ansatz, params, basis)
    # psi vanishes outside the cRNN's U(1) sector, which H conserves
    keep = np.isfinite(np.asarray(la_re))
    rows = basis[keep]
    hj = jnp.asarray(h[np.ix_(keep, keep)], jnp.float32)

    def energy(p):
        re, im = _log_amp_pair(ansatz, p, rows)
        im = jnp.zeros_like(re) if im is None else im
        mag = jnp.exp(re - jnp.max(re))
        psi_re, psi_im = mag * jnp.cos(im), mag * jnp.sin(im)
        num = psi_re @ hj @ psi_re + psi_im @ hj @ psi_im
        return num / (psi_re @ psi_re + psi_im @ psi_im)

    want = jax.grad(energy)(params)

    weights = np.exp(2.0 * np.asarray(la_re, np.float64)[keep])
    weights /= weights.sum()
    la_arg = ((la_re[keep], la_im[keep]) if la_im is not None
              else la_re[keep])
    e_re, e_im, _ = make_local_energy_fn(ansatz, ham)(params, rows, la_arg)
    e_mean = float(np.sum(weights * np.asarray(e_re)))
    scale = jnp.asarray(len(weights) * weights, jnp.float32)

    def weighted_surrogate(p):
        re, im = _log_amp_pair(ansatz, p, rows)
        # mean over the basis of scale * (...) = the |psi|^2-weighted sum
        return surrogate_loss(
            re, im, scale * (e_re - e_mean), None if e_im is None
            else scale * e_im, 0.0, None if e_im is None else 0.0)

    got = jax.grad(weighted_surrogate)(params)
    norm = max(float(jnp.max(jnp.abs(w))) for w in jax.tree.leaves(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=2e-3 * norm)


ROWS = ["gru", "lstm", "gru-2layer", "lstm-2layer", "parity", "snake-3x2",
        "mdrnn-2x3", "crnn-open", "crnn-lstm"]


@pytest.mark.parametrize("name", ROWS)
def test_jacobian_rows_match_vmap_grad(name):
    """The stash-and-contract per-sample rows equal vmap of autodiff of
    the log-amplitude, Re and Im parts alike."""
    ansatz, _, _ = _case(name)
    params = ansatz.init(jax.random.PRNGKey(8))
    samples = ansatz.sample(params, jax.random.PRNGKey(9), 16)
    if getattr(ansatz, "is_complex", False):
        got_re, got_im = jacobian.crnn_log_amp_rows(ansatz, params, samples)

        def part(i):
            return jax.vmap(jax.grad(
                lambda p, s: ansatz.log_amp_parts(p, s[None])[i][0]),
                in_axes=(None, 0))(params, samples)

        pairs = [(got_re, part(0)), (got_im, part(1))]
    else:
        got = jacobian.log_amp_rows(ansatz, params, samples)
        want = jax.vmap(jax.grad(
            lambda p, s: ansatz.log_amp(p, s[None])[0]),
            in_axes=(None, 0))(params, samples)
        pairs = [(got, want)]
    for got, want in pairs:
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
