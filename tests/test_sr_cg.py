"""Conjugate-gradient SR solver tests (``vmc/minsr.cg_solve``).

The solver must reach the exact (Cholesky) solution on SPD systems of
realistic SR conditioning, freeze at exact convergence instead of NaNing,
and keep float64 systems in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions.vmc.minsr import cg_solve


def _spd(s, seed, cond_boost=0.0):
    a = jax.random.normal(jax.random.PRNGKey(seed), (s, 2 * s), jnp.float32)
    t = (a @ a.T) / (2 * s) + 1e-2 * jnp.eye(s)
    if cond_boost:
        # one dominant eigendirection, like a real SR Gram
        v = jax.random.normal(jax.random.PRNGKey(seed + 1), (s, 1))
        v = v / jnp.linalg.norm(v)
        t = t + cond_boost * (v @ v.T)
    return t


@pytest.mark.parametrize("s", [24, 128, 200])
def test_jnp_cg_reaches_exact_solution(s):
    t = _spd(s, 0, cond_boost=30.0)
    c = jax.random.normal(jax.random.PRNGKey(9), (s,), jnp.float32)
    want = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(t, lower=True), c
    )
    got = cg_solve(t, c, iters=2 * s)
    err = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert err < 1e-3, err


def test_kernel_exact_convergence_guard():
    """c in the span of a tiny system: CG converges in <= s iterations and
    the 0/0 guards freeze the iterate instead of NaNing."""
    t = jnp.eye(8, dtype=jnp.float32) * 2.0
    c = jnp.ones((8,), jnp.float32)
    got = cg_solve(t, c, iters=64)
    np.testing.assert_allclose(np.asarray(got), 0.5 * np.ones(8), rtol=1e-6)
    assert np.isfinite(np.asarray(got)).all()


def test_direction_tree_cg_matches_chol():
    """minsr_direction_tree(solver='cg') vs the exact Cholesky solve on a
    real ansatz jacobian: agreement far inside the SR noise floor."""
    from rnnwavefunctions import PRNN1D
    from rnnwavefunctions.vmc import minsr

    ansatz = PRNN1D(num_sites=6, units=(6,))
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (32, 6)
    ).astype(jnp.int32)
    e = jax.random.normal(jax.random.PRNGKey(2), (32,))
    rows, _ = minsr.per_sample_log_amp_grad_trees(ansatz, params, samples)
    kw = dict(damping=0.05)
    want = minsr.minsr_direction_tree(
        rows, None, e, None, e.mean(), None, solver="chol", **kw
    )
    got = minsr.minsr_direction_tree(
        rows, None, e, None, e.mean(), None, solver="cg", cg_iters=64, **kw
    )
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w),
            atol=1e-3 * max(float(jnp.abs(w).max()), 1e-6),
        )


def test_trainer_converges_with_cg_solver():
    """Public-API minSR training with the default sr_solver='cg' reaches
    the same sub-1% N=8 TFIM accuracy as the Cholesky path."""
    from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
    from rnnwavefunctions.ed import exact

    n = 8
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
    cfg = TrainConfig(
        num_samples=256, learning_rate=5e-2, optimizer="minsr", seed=7,
        sr_solver="cg", sr_cg_iters=64,
    )
    trainer = VMCTrainer(
        PRNN1D(num_sites=n, units=(16,)), TFIM1D(num_sites=n, bx=1.0), cfg
    )
    state, ms = trainer.run_steps(trainer.init(), jax.random.PRNGKey(0), 30)
    es = np.asarray(ms["mean_energy"])
    assert np.isfinite(es).all()
    rel = abs((es[-5:].mean() - e_exact) / e_exact)
    assert rel < 5e-3, rel


def test_trainer_rejects_bad_solver():
    from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer

    with pytest.raises(ValueError, match="sr_solver"):
        VMCTrainer(
            PRNN1D(num_sites=4, units=(8,)), TFIM1D(num_sites=4, bx=1.0),
            TrainConfig(num_samples=8, optimizer="minsr", sr_solver="qr"),
        )
    with pytest.raises(ValueError, match="sr_cg_iters"):
        VMCTrainer(
            PRNN1D(num_sites=4, units=(8,)), TFIM1D(num_sites=4, bx=1.0),
            TrainConfig(num_samples=8, optimizer="minsr", sr_cg_iters=0),
        )


def test_sr_cg_solve_float64_routes_to_jnp():
    """float64 systems (--dtype float64 minSR runs) are solved in float64
    to float64 accuracy."""
    jax.config.update("jax_enable_x64", True)
    try:
        s = 24
        a = jax.random.normal(
            jax.random.PRNGKey(0), (s, 2 * s)
        ).astype(jnp.float64)
        t = (a @ a.T) / (2 * s) + 1e-2 * jnp.eye(s, dtype=jnp.float64)
        c = jax.random.normal(jax.random.PRNGKey(1), (s,)).astype(jnp.float64)
        got = cg_solve(t, c, iters=2 * s)
        assert got.dtype == jnp.float64
        want = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(t, lower=True), c
        )
        err = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
        assert err < 1e-6, err
    finally:
        jax.config.update("jax_enable_x64", False)
