"""minSR (stochastic reconfiguration) optimizer tests.

Beyond-reference subsystem (the reference trains Adam only,
``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:113``): ``vmc/minsr.py``
solves the SR/natural-gradient system in sample space via the push-through
identity.  Pinned here:

* the sample-space solve EQUALS the explicit param-space
  ``(S + lam I)^{-1} F`` solve (real and complex ansatze);
* the large-damping limit recovers the surrogate-loss gradient (the Adam
  path's direction) scaled by 1/lam — tying the two optimizers together;
* trainer integration: converges through the public API, works on the
  8-device dp mesh, and out-scopes tensor parallelism with a clear error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from rnnwavefunctions import (
    CRNNU1,
    J1J2,
    PRNN1D,
    TFIM1D,
    TrainConfig,
    VMCTrainer,
    make_mesh,
)
from rnnwavefunctions.ed import exact
from rnnwavefunctions.vmc import minsr
from rnnwavefunctions.vmc.loss import surrogate_loss

LAM = 0.05


def _param_space_direction(o_re, o_im, e_re, e_im, lam):
    """Explicit dense (S + lam I)^{-1} F in parameter space (the definition
    minsr_direction must reproduce)."""
    s = o_re.shape[0]
    blocks_a = [(o_re - o_re.mean(0)) / jnp.sqrt(float(s))]
    blocks_c = [(e_re - e_re.mean()) / jnp.sqrt(float(s))]
    if o_im is not None:
        blocks_a.append((o_im - o_im.mean(0)) / jnp.sqrt(float(s)))
        blocks_c.append((e_im - e_im.mean()) / jnp.sqrt(float(s)))
    a = jnp.concatenate(blocks_a, 0)
    c = jnp.concatenate(blocks_c, 0)
    s_mat = a.T @ a + lam * jnp.eye(a.shape[1])
    return jnp.linalg.solve(s_mat, 2.0 * a.T @ c)


def test_minsr_matches_param_space_sr_real():
    ansatz = PRNN1D(num_sites=6, units=(6,))
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (24, 6)
    ).astype(jnp.int32)
    e = jax.random.normal(jax.random.PRNGKey(2), (24,))
    o_re, o_im, _ = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    assert o_im is None
    got = minsr.minsr_direction(o_re, None, e, None, e.mean(), None, LAM)
    want = _param_space_direction(o_re, None, e, None, LAM)
    np.testing.assert_allclose(got, want, atol=1e-4 * float(jnp.abs(want).max()))


def test_minsr_matches_param_space_sr_complex():
    ansatz = CRNNU1(num_sites=6, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(3))
    samples = ansatz.sample(params, jax.random.PRNGKey(4), 16)
    e_re = jax.random.normal(jax.random.PRNGKey(5), (16,))
    e_im = jax.random.normal(jax.random.PRNGKey(6), (16,))
    o_re, o_im, _ = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    assert o_im is not None
    got = minsr.minsr_direction(
        o_re, o_im, e_re, e_im, e_re.mean(), e_im.mean(), LAM
    )
    want = _param_space_direction(o_re, o_im, e_re, e_im, LAM)
    np.testing.assert_allclose(got, want, atol=1e-4 * float(jnp.abs(want).max()))


def test_tree_direction_matches_flat_real():
    """The per-leaf Gram/back-contraction path (minsr_direction_tree, the
    trainer's production form) equals the flat (S, P) solve leaf-for-leaf."""
    ansatz = PRNN1D(num_sites=6, units=(6,))
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (24, 6)
    ).astype(jnp.int32)
    e = jax.random.normal(jax.random.PRNGKey(2), (24,))
    o_re, _, unravel = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    want = unravel(
        minsr.minsr_direction(o_re, None, e, None, e.mean(), None, LAM)
    )
    rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(
        ansatz, params, samples
    )
    assert rows_im is None
    got = minsr.minsr_direction_tree(
        rows_re, None, e, None, e.mean(), None, LAM
    )
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(
            g, w, atol=1e-5 * max(float(jnp.abs(w).max()), 1e-6)
        ),
        got, want,
    )


def test_tree_direction_matches_flat_complex():
    ansatz = CRNNU1(num_sites=6, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(3))
    samples = ansatz.sample(params, jax.random.PRNGKey(4), 16)
    e_re = jax.random.normal(jax.random.PRNGKey(5), (16,))
    e_im = jax.random.normal(jax.random.PRNGKey(6), (16,))
    o_re, o_im, unravel = minsr.per_sample_log_amp_grads(
        ansatz, params, samples
    )
    want = unravel(minsr.minsr_direction(
        o_re, o_im, e_re, e_im, e_re.mean(), e_im.mean(), LAM
    ))
    rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(
        ansatz, params, samples
    )
    assert rows_im is not None
    got = minsr.minsr_direction_tree(
        rows_re, rows_im, e_re, e_im, e_re.mean(), e_im.mean(), LAM
    )
    # f32 tolerance: the rank-1 centering correction cancels large
    # uncentered-Gram terms (the cRNN head rows carry O(1) means), leaving
    # ~1e-5 absolute noise at this scale.  The identity is exact — in
    # float64 the two paths agree to 1e-13 — and the residual is far below
    # the lam >= 1e-3 diagonal shift and the 1/sqrt(S) gradient noise.
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(
            g, w, atol=2e-4 * max(float(jnp.abs(w).max()), 1e-6)
        ),
        got, want,
    )


def test_minsr_large_damping_limit_is_surrogate_gradient():
    """lam -> inf: (S + lam)^{-1} F -> F / lam, and F is exactly the
    surrogate-loss gradient the Adam path descends (vmc/loss.py) — the
    in-sample baseline centering makes the O-centering immaterial."""
    ansatz = PRNN1D(num_sites=6, units=(6,), parity=True)  # non-trivial log_amp
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (16, 6)
    ).astype(jnp.int32)
    e = jax.random.normal(jax.random.PRNGKey(2), (16,))
    o_re, _, unravel = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    lam = 1e6
    d = lam * minsr.minsr_direction(o_re, None, e, None, e.mean(), None, lam)

    jnp_ansatz = dataclasses.replace(ansatz)
    grad = jax.grad(
        lambda p: surrogate_loss(
            jnp_ansatz.log_amp(p, samples), None, e, None, e.mean(), None
        )
    )(params)
    flat_grad, _ = ravel_pytree(grad)
    np.testing.assert_allclose(
        d, flat_grad, atol=2e-3 * float(jnp.abs(flat_grad).max())
    )


def _vmap_grad_rows(ansatz, params, samples):
    """The definitional per-sample jacobian (what vmc/jacobian.py must
    reproduce): vmap of grad over the jnp scan path."""
    a = dataclasses.replace(ansatz)

    def f(p, s):
        return a.log_amp(p, s[None])[0]

    jac = jax.vmap(jax.grad(f), in_axes=(None, 0))(params, samples)
    leaves = jax.tree.leaves(jac)
    return jnp.concatenate([l.reshape(l.shape[0], -1) for l in leaves], -1)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"units": (6,)},
        {"units": (6, 4)},  # non-uniform stack
        pytest.param({"units": (5,), "parity": True},
                     marks=pytest.mark.slow),
        {"units": (6,), "cell": "lstm"},
        pytest.param({"units": (4, 4), "cell": "lstm", "parity": True},
                     marks=pytest.mark.slow),
    ],
    ids=["gru", "gru-stack", "gru-parity", "lstm", "lstm-stack-parity"],
)
def test_fast_jacobian_rows_match_vmap_grad(kwargs):
    """The stash-and-contract BPTT jacobian (vmc/jacobian.py) is row-for-row
    the vmap-of-grad jacobian on every PRNN1D variant it claims."""
    from rnnwavefunctions.vmc import jacobian

    ansatz = PRNN1D(num_sites=7, **kwargs)
    assert jacobian.supports(ansatz)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (9, 7)
    ).astype(jnp.int32)
    got, o_im, _ = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    assert o_im is None
    want = _vmap_grad_rows(ansatz, params, samples)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, atol=1e-5 * float(jnp.abs(want).max())
    )


def _vmap_jacrev_rows_complex(ansatz, params, samples):
    """Definitional complex jacobian: vmap of jacrev over (Re, Im) log psi
    on the jnp scan path (the generic path in vmc/minsr.py)."""
    a = dataclasses.replace(ansatz)

    def f2(p, s):
        re, im = a.log_amp_parts(p, s[None])
        return jnp.stack([re[0], im[0]])

    jac = jax.vmap(jax.jacrev(f2), in_axes=(None, 0))(params, samples)
    leaves = jax.tree.leaves(jac)
    o = jnp.concatenate([l.reshape(l.shape[0], 2, -1) for l in leaves], -1)
    return o[:, 0, :], o[:, 1, :]


@pytest.mark.parametrize(
    "kwargs",
    [
        {"units": (8,)},
        pytest.param({"units": (6, 5), "u1": False},
                     marks=pytest.mark.slow),
        {"units": (6,), "cell": "lstm"},
    ],
    ids=["gru-u1", "gru-stack-nou1", "lstm-u1"],
)
def test_fast_jacobian_crnn_rows_match_vmap_jacrev(kwargs):
    """The cRNN fast jacobian (two-head seeding through the shared trunk)
    is row-for-row the vmap-of-jacrev jacobian, Re and Im parts, on
    in-sector samples."""
    from rnnwavefunctions.vmc import jacobian

    ansatz = CRNNU1(num_sites=6, **kwargs)
    assert jacobian.supports(ansatz)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(1), 10)
    got_re, got_im, _ = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    want_re, want_im = _vmap_jacrev_rows_complex(ansatz, params, samples)
    scale = float(jnp.abs(want_re).max())
    np.testing.assert_allclose(got_re, want_re, atol=1e-5 * scale)
    np.testing.assert_allclose(got_im, want_im, atol=1e-5 * scale)


@pytest.mark.parametrize(
    "nx,ny",
    [
        (3, 3),
        pytest.param(2, 4, marks=pytest.mark.slow),
        pytest.param(4, 3, marks=pytest.mark.slow),
    ],
    ids=["3x3", "2x4-even", "4x3-odd"],
)
def test_fast_jacobian_mdrnn2d_rows_match_vmap_grad(nx, ny):
    """The 2D fast jacobian (reverse boustrophedon sweep) is row-for-row
    the vmap-of-grad jacobian on square and non-square lattices, even and
    odd row counts (exercising the visit-order flips)."""
    from rnnwavefunctions import MDRNN2D
    from rnnwavefunctions.vmc import jacobian

    ansatz = MDRNN2D(nx=nx, ny=ny, units=7)
    assert jacobian.supports(ansatz)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (9, nx, ny)
    ).astype(jnp.int32)
    got, o_im, _ = minsr.per_sample_log_amp_grads(ansatz, params, samples)
    assert o_im is None
    want = _vmap_grad_rows(ansatz, params, samples)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, atol=1e-5 * float(jnp.abs(want).max())
    )


def test_fast_jacobian_declines_custom_cells():
    from rnnwavefunctions.models.cells import ElmanCell
    from rnnwavefunctions.vmc import jacobian

    assert not jacobian.supports(PRNN1D(num_sites=4, cell=ElmanCell()))
    assert not jacobian.supports(CRNNU1(num_sites=4, cell=ElmanCell()))


def test_minsr_trainer_converges_tfim():
    """Public-API training with optimizer='minsr' on the 8-device mesh:
    N=8 TFIM reaches well under 1% relative error in 30 steps (Adam needs
    hundreds; the slow test pins the head-to-head comparison)."""
    n = 8
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
    cfg = TrainConfig(
        num_samples=256, learning_rate=5e-2, optimizer="minsr", seed=7
    )
    trainer = VMCTrainer(
        PRNN1D(num_sites=n, units=(16,)), TFIM1D(num_sites=n, bx=1.0), cfg,
        mesh=make_mesh(8),
    )
    state = trainer.init()
    state, ms = trainer.run_steps(state, jax.random.PRNGKey(0), 30)
    es = np.asarray(ms["mean_energy"])
    assert np.isfinite(es).all()
    rel = abs((es[-5:].mean() - e_exact) / e_exact)
    assert rel < 5e-3, (rel, es[-5:])


def test_minsr_trainer_converges_mdrnn2d():
    """The 2D family: per-sample jacobians vmap over grid-shaped samples
    (S, nx, ny) and the boustrophedon scan-of-scans; 2x3 TFIM reaches
    ~1e-4 in 40 steps."""
    from rnnwavefunctions import MDRNN2D, TFIM2D

    e_exact = exact.ground_state_energy(exact.tfim2d_dense(2, 3, 3.0))
    cfg = TrainConfig(
        num_samples=128, learning_rate=5e-2, optimizer="minsr", seed=7
    )
    trainer = VMCTrainer(
        MDRNN2D(nx=2, ny=3, units=12),
        TFIM2D(nx=2, ny=3, bx=3.0, encoding="grid"), cfg,
        mesh=make_mesh(1),
    )
    state, ms = trainer.run_steps(trainer.init(), jax.random.PRNGKey(0), 40)
    es = np.asarray(ms["mean_energy"])
    assert np.isfinite(es).all()
    rel = abs((es[-5:].mean() - e_exact) / e_exact)
    assert rel < 2e-3, rel


def test_minsr_validation_errors():
    with pytest.raises(ValueError, match="unknown optimizer"):
        VMCTrainer(
            PRNN1D(num_sites=4, units=(8,)), TFIM1D(num_sites=4, bx=1.0),
            TrainConfig(num_samples=8, optimizer="nope"),
        )
    # tp + minsr is now a supported combination (round 4) — its parity
    # tests live in tests/test_tensor_parallel.py::test_trainer_tp_minsr_*
    with pytest.raises(ValueError, match="sr_damping"):
        VMCTrainer(
            PRNN1D(num_sites=4, units=(8,)), TFIM1D(num_sites=4, bx=1.0),
            TrainConfig(num_samples=8, optimizer="minsr", sr_damping=0.0),
        )


@pytest.mark.slow
def test_minsr_beats_adam_step_for_step():
    """The headline claim, pinned: same ansatz, same budget of 60 VMC steps
    — minSR lands an order of magnitude closer to the exact ground state
    than Adam (measured margins ~5e-3 vs ~6e-4; asserted with slack)."""
    n = 8
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))

    def run(opt, lr):
        cfg = TrainConfig(
            num_samples=256, learning_rate=lr, optimizer=opt, seed=7
        )
        tr = VMCTrainer(
            PRNN1D(num_sites=n, units=(16,)), TFIM1D(num_sites=n, bx=1.0),
            cfg, mesh=make_mesh(1),
        )
        st, ms = tr.run_steps(tr.init(), jax.random.PRNGKey(0), 60)
        es = np.asarray(ms["mean_energy"])
        return abs((es[-10:].mean() - e_exact) / e_exact)

    err_adam = run("adam", 5e-3)  # the reference's optimizer + lr
    err_minsr = run("minsr", 5e-2)
    assert err_minsr < 2e-3, err_minsr
    assert err_minsr < 0.5 * err_adam, (err_minsr, err_adam)


@pytest.mark.slow
def test_minsr_complex_j1j2_converges():
    """Complex-ansatz minSR (stacked Re/Im sample space): J1J2 N=8 reaches
    ~1% in 80 steps where Adam at the reference lr is still at ~100%."""
    n = 8
    e_exact = exact.ground_state_energy(exact.j1j2_dense(n, 1.0, 0.2))
    cfg = TrainConfig(
        num_samples=256, learning_rate=5e-2, optimizer="minsr", seed=7
    )
    tr = VMCTrainer(
        CRNNU1(num_sites=n, units=(12,)), J1J2(num_sites=n, j2=0.2), cfg,
        mesh=make_mesh(1),
    )
    st, ms = tr.run_steps(tr.init(), jax.random.PRNGKey(0), 80)
    es = np.asarray(ms["mean_energy"])
    assert np.isfinite(es).all()
    rel = abs((es[-10:].mean() - e_exact) / e_exact)
    assert rel < 3e-2, rel
