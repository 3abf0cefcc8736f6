"""Native C++ Lanczos ED oracle vs the dense Python oracle."""

import numpy as np
import pytest

from rnnwavefunctions.ed import exact

native = pytest.importorskip("rnnwavefunctions.ed.native")


def test_tfim_lanczos_matches_dense():
    for n, bx in [(6, 1.0), (10, 0.7), (11, 2.0)]:
        want = exact.ground_state_energy(exact.tfim1d_dense(n, bx))
        got = native.tfim1d_ground_energy(n, bx)
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_tfim_lanczos_custom_couplings():
    n = 8
    jz = np.linspace(0.5, 1.5, n - 1)
    want = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0, jz))
    got = native.tfim1d_ground_energy(n, 1.0, jz)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("marshall", [False, True])
def test_j1j2_lanczos_matches_dense(periodic, marshall):
    n = 8
    want = exact.ground_state_energy(
        exact.j1j2_dense(n, 1.0, 0.3, 0.1, periodic=periodic,
                         marshall_sign=marshall)
    )
    got = native.j1j2_ground_energy(
        n, 1.0, 0.3, 0.1, periodic=periodic, marshall_sign=marshall
    )
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_lanczos_beyond_dense_reach():
    """N=18 TFIM — far past practical dense eigh — runs in seconds and lands
    between the (monotonic in N) neighbouring known values."""
    e18 = native.tfim1d_ground_energy(18, 1.0)
    # per-site energy must be bracketed by the N=16 and N->inf values
    e16 = native.tfim1d_ground_energy(16, 1.0)
    assert e18 < e16  # more sites -> lower total energy
    assert -1.30 < e18 / 18 < -1.20  # thermodynamic limit is -4/pi = -1.273


def test_tfim2d_lanczos_matches_dense():
    for nx, ny, bx in [(3, 2, 1.0), (2, 4, 2.5), (3, 3, 3.0)]:
        want = exact.ground_state_energy(exact.tfim2d_dense(nx, ny, bx))
        got = native.tfim2d_ground_energy(nx, ny, bx)
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_tfim_lanczos_ground_vector_matches_dense():
    for n, bx in [(8, 1.0), (10, 0.7)]:
        e_want, v_want = exact.ground_state(exact.tfim1d_dense(n, bx))
        e, vec, resid = native.tfim1d_ground_state(n, bx)
        np.testing.assert_allclose(e, e_want, rtol=1e-9)
        assert resid < 1e-5
        assert abs(np.dot(v_want, vec)) > 1.0 - 1e-8  # overlap up to sign


def test_tfim2d_lanczos_ground_vector_matches_dense():
    e_want, v_want = exact.ground_state(exact.tfim2d_dense(3, 3, 3.0))
    e, vec, resid = native.tfim2d_ground_state(3, 3, 3.0)
    np.testing.assert_allclose(e, e_want, rtol=1e-9)
    assert resid < 1e-5 and abs(np.dot(v_want, vec)) > 1.0 - 1e-8


def test_j1j2_lanczos_ground_vector_matches_dense():
    n = 8
    e_want, v_want = exact.ground_state(
        exact.j1j2_dense(n, 1.0, 0.3, marshall_sign=True)
    )
    e, vec, resid = native.j1j2_ground_state(n, 1.0, 0.3, marshall_sign=True)
    np.testing.assert_allclose(e, e_want, rtol=1e-9)
    assert resid < 1e-5 and abs(np.dot(v_want, vec)) > 1.0 - 1e-8


@pytest.mark.slow
def test_fidelity_against_lanczos_vector_beyond_dense():
    """The Lanczos vector plugs straight into ed.fidelity: a table ansatz
    holding |gs| reaches F ~= 1 at N=18 — past any dense eigh."""
    from rnnwavefunctions.ed.fidelity import fidelity

    n = 18
    e, vec, resid = native.tfim1d_ground_state(n, 1.0)
    assert resid < 1e-4

    class _Table:
        def log_amp(self, params, samples):
            import jax.numpy as jnp
            s = np.asarray(samples)
            codes = s @ (1 << np.arange(n, dtype=np.int64))
            return jnp.asarray(np.log(np.abs(vec[codes]) + 1e-300))

    # TFIM GS is non-negative (Perron-Frobenius), so |gs| == gs up to sign
    f = fidelity(_Table(), None, vec, chunk=1 << 15)
    assert f > 1.0 - 1e-5


def test_lanczos_vector_degenerate_ground_level():
    """With a near-degenerate ground doublet (TFIM at small Bx, gap ~
    exp(-N)) the returned vector is an arbitrary member of the ground
    subspace — the contract is the residual and the subspace weight, not
    a specific eigh column."""
    n, bx = 8, 0.05
    e, vec, resid = native.tfim1d_ground_state(n, bx)
    w, v = np.linalg.eigh(exact.tfim1d_dense(n, bx))
    np.testing.assert_allclose(e, w[0], rtol=1e-9)
    assert resid < 1e-6
    subspace_weight = sum(float(np.dot(v[:, k], vec)) ** 2 for k in range(2))
    assert subspace_weight > 1.0 - 1e-8
