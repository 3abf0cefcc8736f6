"""ed.fidelity: overlap-squared diagnostics against dense-ED eigenvectors.

The reference validates only energies (Tutorial_1DTFIM.ipynb cell 18);
fidelity is the sharper check and must therefore be exactly right about
the ED basis convention — pinned here three ways: a table-state identity,
a completeness sum, and an energy projection that cross-checks the 2D
grid mapping against the (independently dense-validated) local-energy
estimator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions import PRNN1D, TFIM1D, TFIM2D, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact
from rnnwavefunctions.ed.fidelity import basis_configs, fidelities, fidelity
from rnnwavefunctions.models.mdrnn2d import MDRNN2D
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn


class _TableAnsatz:
    """Stub whose amplitudes are read from a vector in ED basis order."""

    def __init__(self, vec):
        self.vec = np.asarray(vec)

    def log_amp(self, params, samples):
        s = np.asarray(samples)
        codes = s @ (1 << np.arange(s.shape[1]))
        return jnp.asarray(np.log(np.abs(self.vec[codes]) + 1e-300))


def test_fidelity_identity_and_orthogonality():
    h = exact.tfim1d_dense(6, 1.0)
    w, v = np.linalg.eigh(h)
    gs = v[:, 0]
    gs = gs * np.sign(gs[np.argmax(np.abs(gs))])
    assert (gs > -1e-12).all()  # Perron-Frobenius: TFIM GS is non-negative

    table = _TableAnsatz(gs)
    assert fidelity(table, None, gs) == pytest.approx(1.0, abs=1e-6)
    assert fidelity(table, None, v[:, 1]) == pytest.approx(0.0, abs=1e-6)


def test_fidelity_completeness_sum():
    """Sum of fidelities against a full eigenbasis is exactly 1 for any
    normalized state, whatever the basis mapping — and each term matches
    the direct projection."""
    h = exact.tfim1d_dense(4, 0.7)
    w, v = np.linalg.eigh(h)
    rng = np.random.default_rng(0)
    vec = rng.normal(size=16) + 0.5
    vec = np.abs(vec)  # positive table state
    vec /= np.linalg.norm(vec)
    table = _TableAnsatz(vec)
    fids = [fidelity(table, None, v[:, k]) for k in range(16)]
    assert sum(fids) == pytest.approx(1.0, abs=1e-6)
    # log_amp is evaluated in float32: ~1e-6 on squared overlaps
    np.testing.assert_allclose(fids, (v.T @ vec) ** 2, atol=1e-5)


def test_fidelity_grid_mapping_energy_projection():
    """Cross-checks the 2D [x, y] grid mapping: sum_k E_k * F_k must equal
    the exhaustive estimator expectation sum_sigma p(sigma) E_loc(sigma),
    which is validated against the dense H independently of any basis
    ordering (tests/test_2d.py)."""
    nx, ny, bx = 2, 3, 0.9
    n = nx * ny
    ansatz = MDRNN2D(nx=nx, ny=ny, units=6)
    params = ansatz.init(jax.random.PRNGKey(3))
    h = exact.tfim2d_dense(nx, ny, bx)
    w, v = np.linalg.eigh(h)

    e_proj = float(np.sum(w * fidelities(ansatz, params, v)))

    ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding="grid")
    grids = jnp.transpose(
        jnp.asarray(basis_configs(n)).reshape(-1, ny, nx), (0, 2, 1)
    )
    p = np.exp(np.asarray(ansatz.log_prob(params, grids), np.float64))
    assert p.sum() == pytest.approx(1.0, rel=1e-6)
    le = make_local_energy_fn(ansatz, ham)
    e_loc = np.asarray(le(params, grids, ansatz.log_amp(params, grids))[0])
    e_exp = float(np.sum(p * np.real(e_loc)))

    assert e_proj == pytest.approx(e_exp, rel=1e-5)


@pytest.mark.slow
def test_trained_prnn_reaches_high_fidelity():
    n = 8
    e0, gs = exact.ground_state(exact.tfim1d_dense(n, 1.0))
    ansatz = PRNN1D(num_sites=n, units=(24,))
    trainer = VMCTrainer(
        ansatz, TFIM1D(num_sites=n, bx=1.0), TrainConfig(num_samples=256)
    )
    state = trainer.init()
    f_init = fidelity(ansatz, state.params, gs)
    key = jax.random.PRNGKey(0)
    for _ in range(300):
        state, m = trainer.step(state, key)
    f_trained = fidelity(ansatz, state.params, gs)
    assert f_trained > 0.98
    assert f_trained > f_init


@pytest.mark.slow
def test_fidelity_complex_u1_energy_projection():
    """The complex path: CRNNU1 phases must survive the basis mapping.
    J1-J2 conserves magnetization, so (a) fidelity against any eigenvector
    outside the Sz=0 sector is exactly 0, (b) completeness sums to 1, and
    (c) sum_k E_k F_k equals the exhaustive in-sector estimator expectation."""
    from rnnwavefunctions import CRNNU1, J1J2

    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,))
    ham = J1J2(num_sites=n, j1=1.0, j2=0.3, marshall_sign=True)
    params = ansatz.init(jax.random.PRNGKey(11))
    h = exact.j1j2_dense(n, 1.0, 0.3, marshall_sign=True)
    w, v = np.linalg.eigh(h)

    fids = np.array([fidelity(ansatz, params, v[:, k]) for k in range(1 << n)])
    assert fids.sum() == pytest.approx(1.0, abs=1e-5)

    # eigenvectors with no Sz=0-sector weight at all carry zero fidelity
    # (degenerate eigh vectors may mix sectors, so test only the pure ones)
    counts = basis_configs(n).sum(axis=1)
    pure_off = np.abs(v[counts == n // 2]).sum(axis=0) < 1e-12
    assert pure_off.any()
    assert np.all(fids[pure_off] < 1e-10)

    e_proj = float(np.sum(w * fids))

    sector = jnp.asarray(basis_configs(n)[counts == n // 2])
    p = np.exp(np.asarray(ansatz.log_prob(params, sector), np.float64))
    assert p.sum() == pytest.approx(1.0, rel=1e-5)
    le = make_local_energy_fn(ansatz, ham)
    e_re, _, _ = le(params, sector, ansatz.log_amp_parts(params, sector))
    e_exp = float(np.sum(p * np.asarray(e_re)))
    assert e_proj == pytest.approx(e_exp, rel=1e-4)


@pytest.mark.slow
def test_fidelity_snake2d_flat_mapping():
    """PRNNSnake2D samples are y-major flat vectors — the exact row order
    of tfim2d_dense (idx = y*nx + x) — so the 1D flat mapping applies;
    pinned by the same energy-projection identity as the grid case."""
    from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D

    nx, ny, bx = 3, 2, 1.1
    n = nx * ny
    ansatz = PRNNSnake2D(nx=nx, ny=ny, units=(6,))
    params = ansatz.init(jax.random.PRNGKey(5))
    h = exact.tfim2d_dense(nx, ny, bx)
    w, v = np.linalg.eigh(h)

    e_proj = float(np.sum(w * fidelities(ansatz, params, v)))

    ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding="flat")
    flat = jnp.asarray(basis_configs(n))
    p = np.exp(np.asarray(ansatz.log_prob(params, flat), np.float64))
    assert p.sum() == pytest.approx(1.0, rel=1e-6)
    le = make_local_energy_fn(ansatz, ham)
    e_loc = np.asarray(le(params, flat, ansatz.log_amp(params, flat))[0])
    e_exp = float(np.sum(p * np.real(e_loc)))

    assert e_proj == pytest.approx(e_exp, rel=1e-5)
