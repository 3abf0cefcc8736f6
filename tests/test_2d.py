"""Tests for the 2D workloads: snake-ordered pRNN, MDRNN2D, TFIM2D."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.ed import exact
from rnnwavefunctions.hamiltonians.tfim2d import TFIM2D
from rnnwavefunctions.models.mdrnn2d import MDRNN2D
from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions import TrainConfig, VMCTrainer


def all_flat_configs(n):
    return jnp.asarray(list(itertools.product([0, 1], repeat=n)), jnp.int32)


def flat_to_grid(flat, nx, ny):
    """flat y-major (S, nx*ny) -> grid (S, nx, ny) indexed [s, x, y]."""
    return jnp.transpose(flat.reshape(-1, ny, nx), (0, 2, 1))


# -- MDRNN2D ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3), (3, 2), (2, 2)])
def test_mdrnn_normalization(shape):
    """Autoregressive density over the full 2^(Nx*Ny) basis sums to 1 —
    non-square shapes exercise the odd-row (right-to-left) wiring."""
    nx, ny = shape
    ansatz = MDRNN2D(nx=nx, ny=ny, units=6)
    params = ansatz.init(jax.random.PRNGKey(0))
    grids = flat_to_grid(all_flat_configs(nx * ny), nx, ny)
    lp = ansatz.log_prob(params, grids)
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(lp))), 1.0, rtol=1e-4)


def test_mdrnn_sampling_consistency():
    ansatz = MDRNN2D(nx=3, ny=3, units=8)
    params = ansatz.init(jax.random.PRNGKey(1))
    samples, lp_sampling = ansatz.sample_with_log_prob(
        params, jax.random.PRNGKey(2), 48
    )
    assert samples.shape == (48, 3, 3)
    lp = ansatz.log_prob(params, samples)
    np.testing.assert_allclose(
        np.asarray(lp_sampling), np.asarray(lp), atol=1e-5
    )


# -- snake ansatz -----------------------------------------------------------

def test_snake_normalization():
    ansatz = PRNNSnake2D(nx=3, ny=2, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(3))
    lp = ansatz.log_prob(params, all_flat_configs(6))
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(lp))), 1.0, rtol=1e-4)
    assert ansatz.lattice == (3, 2)


# -- TFIM2D -----------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["flat", "grid"])
def test_tfim2d_connected_matches_dense(encoding):
    nx, ny, bx = 3, 2, 1.7
    ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding=encoding)
    h = exact.tfim2d_dense(nx, ny, bx)
    n = nx * ny
    for code in [0, 5, 21, 63, 38]:
        flat = jnp.asarray([(code >> i) & 1 for i in range(n)], jnp.int32)
        sigma = flat if encoding == "flat" else flat_to_grid(flat[None], nx, ny)[0]
        diag, flips, elements, mask = ham.connected(sigma)
        np.testing.assert_allclose(float(diag), h[code, code], rtol=1e-6)
        for k in range(ham.n_offdiag):
            if not bool(mask[k]):
                continue
            fk = np.asarray(flips[k])
            if encoding == "grid":
                fk = np.asarray(jnp.transpose(jnp.asarray(fk), (1, 0))).reshape(-1)
            code_k = int(np.dot(fk.reshape(-1), 2 ** np.arange(n)))
            np.testing.assert_allclose(
                float(elements[k]), h[code_k, code], rtol=1e-6
            )


def test_mdrnn_local_energy_matches_dense():
    nx, ny, bx = 2, 3, 0.9
    n = nx * ny
    ansatz = MDRNN2D(nx=nx, ny=ny, units=6)
    ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding="grid")
    params = ansatz.init(jax.random.PRNGKey(4))
    samples = ansatz.sample(params, jax.random.PRNGKey(5), 16)

    le = make_local_energy_fn(ansatz, ham)
    got = np.asarray(le(params, samples, ansatz.log_amp(params, samples))[0])

    # brute force via dense H over the flat (y-major) basis, in code order
    h = exact.tfim2d_dense(nx, ny, bx)
    basis_flat = jnp.asarray(
        [[(c >> i) & 1 for i in range(n)] for c in range(1 << n)], jnp.int32
    )
    basis_grids = flat_to_grid(basis_flat, nx, ny)
    la = np.asarray(ansatz.log_amp(params, basis_grids))
    want = []
    for s in np.asarray(samples):
        flat = np.transpose(s, (1, 0)).reshape(-1)  # grid [x,y] -> y-major flat
        code = int(np.dot(flat, 2 ** np.arange(n)))
        col = h[:, code]
        nz = np.nonzero(col)[0]
        want.append(np.sum(col[nz] * np.exp(la[nz] - la[code])))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4)


# -- integration ------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["snake", "mdrnn"])
def test_vmc_2dtfim_converges(kind):
    nx, ny, bx = 2, 2, 1.0
    e_exact = exact.ground_state_energy(exact.tfim2d_dense(nx, ny, bx))
    if kind == "snake":
        ansatz = PRNNSnake2D(nx=nx, ny=ny, units=(12,))
        ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding="flat")
    else:
        ansatz = MDRNN2D(nx=nx, ny=ny, units=12)
        ham = TFIM2D(nx=nx, ny=ny, bx=bx, encoding="grid")
    trainer = VMCTrainer(
        ansatz, ham, TrainConfig(num_samples=256, learning_rate=5e-3)
    )
    state, mean_e, var_e = trainer.fit(300, key=jax.random.PRNGKey(0))
    est = float(np.mean(mean_e[-50:]))
    assert abs(est - e_exact) < 5e-2 * abs(e_exact), (
        f"{kind}: {est:.5f} vs exact {e_exact:.5f}"
    )


def test_tfim2d_per_bond_couplings():
    """Per-site Jz arrays weight the bonds as the reference estimator does
    (Jz[i,j] on both (i,j)-(i+1,j) and (i,j)-(i,j+1),
    Training1DRNN_2DTFIM.py:33-49); a ones-array reduces to the scalar."""
    nx, ny = 3, 2
    rng = np.random.default_rng(0)
    jz = rng.uniform(0.5, 1.5, size=(nx, ny))
    ham = TFIM2D(nx=nx, ny=ny, bx=0.7, jz=jz, encoding="grid")
    ham_uniform = TFIM2D(nx=nx, ny=ny, bx=0.7, encoding="grid")
    ham_ones = TFIM2D(nx=nx, ny=ny, bx=0.7, jz=np.ones((nx, ny)),
                      encoding="grid")
    sigma = jnp.asarray([[1, 0], [0, 0], [1, 1]], jnp.int32)  # (nx, ny)

    z = 2.0 * np.asarray(sigma) - 1.0
    want = 0.0
    for i in range(nx - 1):
        for j in range(ny):
            want += -jz[i, j] * z[i, j] * z[i + 1, j]
    for i in range(nx):
        for j in range(ny - 1):
            want += -jz[i, j] * z[i, j] * z[i, j + 1]
    np.testing.assert_allclose(float(ham.diagonal(sigma)), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(ham_ones.diagonal(sigma)), float(ham_uniform.diagonal(sigma)),
        rtol=1e-6,
    )
    # flat (snake) encoding agrees with grid encoding on the same lattice
    flat = np.zeros(nx * ny, np.int32)
    for y in range(ny):
        for x in range(nx):
            flat[y * nx + x] = int(sigma[x, y])
    ham_flat = TFIM2D(nx=nx, ny=ny, bx=0.7, jz=jz, encoding="flat")
    np.testing.assert_allclose(
        float(ham_flat.diagonal(jnp.asarray(flat))), want, rtol=1e-6
    )
