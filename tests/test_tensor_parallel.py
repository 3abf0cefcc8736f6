"""Hidden-dimension (tensor-parallel) sharding tests on the simulated mesh.

A ("dp", "tp") mesh splits Monte-Carlo chains over dp and the GRU hidden
dimension over tp (Megatron-style column sharding; one all-gather of h per
site step, psum'd head logits).  The sharded trunk must reproduce the
unsharded log-probabilities, sampler draws, and parameter gradients exactly,
and a full tp-sharded VMC step must train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from rnnwavefunctions import PRNN1D, TFIM1D
from rnnwavefunctions.parallel import tensor as tp
from rnnwavefunctions.parallel.mesh import DP_AXIS
from rnnwavefunctions.vmc.loss import surrogate_loss

UNITS = (16,)
K = 4  # tp shards


def _mesh():
    return tp.make_dp_tp_mesh(2, K)


def _setup(n=8, s=16):
    ansatz = PRNN1D(num_sites=n, units=UNITS)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(1), s)
    return ansatz, params, samples


def test_tp_log_prob_matches_unsharded():
    ansatz, params, samples = _setup()
    mesh = _mesh()

    def fn(params, samples):
        idx = jax.lax.axis_index(tp.TP_AXIS)
        shard = tp.shard_params(params, K, idx)
        return tp.tp_log_prob(shard, samples, UNITS, K)

    lp = jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=(P(), P(DP_AXIS)),
                      out_specs=P(DP_AXIS), check_vma=False)
    )(params, samples)
    want = ansatz._log_prob_plain_jnp(params, samples)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(want), atol=1e-5)


def test_tp_sampler_matches_unsharded():
    """With the key folded over dp only, all tp members draw the identical
    chains — and they equal the unsharded jnp sampler's draws."""
    ansatz, params, _ = _setup()
    mesh = _mesh()
    key = jax.random.PRNGKey(3)

    def fn(params):
        idx = jax.lax.axis_index(tp.TP_AXIS)
        shard = tp.shard_params(params, K, idx)
        draws, lp = tp.tp_sample_with_log_prob(
            shard, key, 8, ansatz.num_sites, UNITS, K
        )
        return draws, lp

    draws, lp = jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=(P(),), out_specs=P(),
                      check_vma=False)
    )(params)
    want_draws, want_lp = ansatz.sample_with_log_prob(params, key, 8)
    np.testing.assert_array_equal(np.asarray(draws), np.asarray(want_draws))
    np.testing.assert_allclose(np.asarray(lp), np.asarray(want_lp), atol=1e-5)


@pytest.mark.slow
def test_tp_gradient_matches_unsharded():
    """d mean(log p)/d params through the sharded trunk == unsharded grad
    (shard_map + dynamic_slice transpose reassembles the full cotangent)."""
    ansatz, params, samples = _setup()
    mesh = _mesh()

    def fn(p, s):
        shard = tp.shard_params(p, K, jax.lax.axis_index(tp.TP_AXIS))
        lp = tp.tp_log_prob(shard, s, UNITS, K)
        # batch mean, replicated on every device (lp is tp-replicated)
        return jax.lax.psum(jnp.sum(lp), DP_AXIS) / samples.shape[0]

    sharded = jax.shard_map(
        fn, mesh=mesh, in_specs=(P(), P(DP_AXIS)), out_specs=P(),
        check_vma=False,
    )

    def loss_tp(p):
        return sharded(p, samples)

    def loss_ref(p):
        return jnp.mean(ansatz._log_prob_plain_jnp(p, samples))

    g1 = jax.grad(loss_tp)(params)
    g2 = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_tp_inner_grad_pmean_matches_unsharded():
    """The training-step pattern — jax.grad *inside* shard_map, then
    pmean over BOTH axes — must reassemble the exact reference gradient for
    every leaf.  (The inner head-psum transposes to a psum, so each member's
    local grad is already K x its slice contribution; pmean-over-tp both
    assembles the disjoint slices and removes the K, and the b/k in-shard
    scaling makes the replicated bias behave identically.)"""
    ansatz, params, samples = _setup()
    mesh = _mesh()

    def device_fn(p, s):
        def loss_fn(pp):
            sh = tp.shard_params(pp, K, jax.lax.axis_index(tp.TP_AXIS))
            return jnp.mean(tp.tp_log_prob(sh, s, UNITS, K))

        g = jax.grad(loss_fn)(p)
        return jax.tree.map(
            lambda x: jax.lax.pmean(jax.lax.pmean(x, tp.TP_AXIS), DP_AXIS), g
        )

    g1 = jax.jit(
        jax.shard_map(device_fn, mesh=mesh, in_specs=(P(), P(DP_AXIS)),
                      out_specs=P(), check_vma=False)
    )(params, samples)
    g2 = jax.grad(
        lambda p: jnp.mean(ansatz._log_prob_plain_jnp(p, samples))
    )(params)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_trainer_tp_matches_dp():
    """The PRODUCT path: ``VMCTrainer(config.tp=4)`` on a (2, 4) mesh must
    reproduce the dp-only trainer exactly — same drawn samples (tp members
    share the dp-folded key), same energies, same post-Adam parameters."""
    from rnnwavefunctions import TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = PRNN1D(num_sites=n, units=UNITS)
    ham = TFIM1D(num_sites=n, bx=1.0)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=K),
                       mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(11)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for a, b in zip(jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for it in range(3):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5,
        )
    for a, b in zip(jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )
    # evaluate() also routes through the sharded trunk
    out = tr_tp.evaluate(st_tp, key)
    assert np.isfinite(float(out["mean_energy"]))


def test_trainer_tp_validation():
    from rnnwavefunctions import CRNNU1, MDRNN2D, TFIM2D, TrainConfig, VMCTrainer
    from rnnwavefunctions.hamiltonians.j1j2 import J1J2
    import pytest

    # CRNNU1 with a GRU trunk is tp-supported since round 4 — construction
    # must NOT raise
    VMCTrainer(
        CRNNU1(num_sites=8, units=(16,)),
        J1J2(num_sites=8, j2=0.2),
        TrainConfig(num_samples=16, tp=K),
        mesh=_mesh(),
    )
    with pytest.raises(ValueError, match="GRU-trunk"):
        VMCTrainer(
            CRNNU1(num_sites=8, units=(16,), cell="lstm"),
            J1J2(num_sites=8, j2=0.2),
            TrainConfig(num_samples=16, tp=K),
            mesh=_mesh(),
        )
    # MDRNN2D on grid TFIM2D is tp-supported since round 4 — construction
    # must NOT raise...
    VMCTrainer(
        MDRNN2D(nx=4, ny=4, units=16),
        TFIM2D(nx=4, ny=4, bx=3.0, encoding="grid"),
        TrainConfig(num_samples=16, tp=K),
        mesh=_mesh(),
    )
    # ...but only with the grid encoding (the 2D family consumes grids)
    with pytest.raises(ValueError, match="grid"):
        VMCTrainer(
            MDRNN2D(nx=4, ny=4, units=16),
            TFIM2D(nx=4, ny=4, bx=3.0, encoding="flat"),
            TrainConfig(num_samples=16, tp=K),
            mesh=_mesh(),
        )
    with pytest.raises(ValueError, match="divisible"):
        VMCTrainer(
            PRNN1D(num_sites=8, units=(10,)),
            TFIM1D(num_sites=8, bx=1.0),
            TrainConfig(num_samples=16, tp=K),
            mesh=_mesh(),
        )


@pytest.mark.slow
def test_tp_vmc_step_trains():
    """Full dp x tp VMC step: sample, TFIM local energies, surrogate grad,
    SGD — energy decreases."""
    n, s_global = 6, 16
    ansatz, params, _ = _setup(n=n)
    ham = TFIM1D(num_sites=n, bx=1.0)
    mesh = _mesh()
    s_local = s_global // mesh.shape[DP_AXIS]

    def device_step(params, key):
        idx = jax.lax.axis_index(tp.TP_AXIS)
        key = jax.random.fold_in(key, jax.lax.axis_index(DP_AXIS))
        shard = tp.shard_params(params, K, idx)
        samples, logp = tp.tp_sample_with_log_prob(
            shard, key, s_local, n, UNITS, K
        )
        samples = jax.lax.stop_gradient(samples)
        # generic flip estimator through the sharded trunk
        eye = jnp.eye(n, dtype=samples.dtype)
        flips = jnp.where(
            eye[None] == 1, 1 - samples[:, None, :], samples[:, None, :]
        ).reshape(s_local * n, n)
        la = 0.5 * tp.tp_log_prob(shard, flips, UNITS, K).reshape(s_local, n)
        ratio = jnp.exp(la - 0.5 * logp[:, None])
        diag = jax.vmap(ham.diagonal)(samples)
        e = jax.lax.stop_gradient(diag - ham.bx * jnp.sum(ratio, axis=1))
        e_mean = jax.lax.pmean(jnp.mean(e), DP_AXIS)

        def loss_fn(p):
            sh = tp.shard_params(p, K, jax.lax.axis_index(tp.TP_AXIS))
            la_s = 0.5 * tp.tp_log_prob(sh, samples, UNITS, K)
            return surrogate_loss(la_s, None, e, None, e_mean, None)

        grads = jax.grad(loss_fn)(params)
        # pmean over tp assembles the slice grads at 1x (see the
        # inner-grad test); pmean over dp averages the chain shards
        grads = jax.tree.map(
            lambda g: jax.lax.pmean(jax.lax.pmean(g, tp.TP_AXIS), DP_AXIS),
            grads,
        )
        params = jax.tree.map(lambda p, g: p - 0.05 * g, params, grads)
        return params, e_mean

    step = jax.jit(
        jax.shard_map(device_step, mesh=mesh, in_specs=(P(), P()),
                      out_specs=(P(), P()), check_vma=False)
    )
    key = jax.random.PRNGKey(7)
    energies = []
    for it in range(40):
        params, e = step(params, jax.random.fold_in(key, it))
        energies.append(float(e))
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.5
    assert np.isfinite(energies).all()


# -- complex U(1) cRNN on the sharded trunk (round 4) -------------------------


def _setup_crnn(n=8, s=16):
    from rnnwavefunctions import CRNNU1

    ansatz = CRNNU1(num_sites=n, units=UNITS)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(1), s)
    return ansatz, params, samples


def test_tp_crnn_log_amp_matches_unsharded():
    """(Re, Im) log psi through the sharded trunk + both row-sharded heads
    == the unsharded CRNNU1 (U(1) mask/renorm applied on the tp-replicated
    psum'd logits)."""
    ansatz, params, samples = _setup_crnn()
    mesh = _mesh()

    def fn(params, samples):
        idx = jax.lax.axis_index(tp.TP_AXIS)
        shard = tp.shard_params_crnn(params, K, idx)
        return tp.tp_crnn_log_amp_parts(ansatz, shard, samples, K)

    re, im = jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=(P(), P(DP_AXIS)),
                      out_specs=P(DP_AXIS), check_vma=False)
    )(params, samples)
    want_re, want_im = ansatz.log_amp_parts(params, samples)
    np.testing.assert_allclose(np.asarray(re), np.asarray(want_re), atol=1e-5)
    np.testing.assert_allclose(np.asarray(im), np.asarray(want_im), atol=1e-5)


def test_tp_crnn_sampler_matches_unsharded():
    """tp members draw identical U(1)-sector chains equal to the unsharded
    sampler's (same dp-folded key -> same psum'd conditionals)."""
    ansatz, params, _ = _setup_crnn()
    mesh = _mesh()
    key = jax.random.PRNGKey(3)

    def fn(params):
        idx = jax.lax.axis_index(tp.TP_AXIS)
        shard = tp.shard_params_crnn(params, K, idx)
        return tp.tp_crnn_sample_with_log_prob(ansatz, shard, key, 8, K)

    draws, lp = jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=(P(),), out_specs=P(),
                      check_vma=False)
    )(params)
    want_draws, want_lp = ansatz.sample_with_log_prob(params, key, 8)
    np.testing.assert_array_equal(np.asarray(draws), np.asarray(want_draws))
    np.testing.assert_allclose(np.asarray(lp), np.asarray(want_lp), atol=1e-5)
    # every draw is in the zero-magnetization sector
    assert np.all(np.asarray(draws).sum(axis=1) == ansatz.num_sites // 2)


def test_tp_crnn_inner_grad_pmean_matches_unsharded():
    """The cRNN training-step pattern — grad of a Re/Im-weighted surrogate
    inside shard_map, pmean over both axes — reassembles the unsharded
    gradient for every leaf (both heads included)."""
    ansatz, params, samples = _setup_crnn()
    mesh = _mesh()
    s = samples.shape[0]
    w_re = jnp.linspace(0.5, 1.5, s)
    w_im = jnp.linspace(-1.0, 1.0, s)

    def device_fn(p, smp, wr, wi):
        def loss_fn(pp):
            sh = tp.shard_params_crnn(pp, K, jax.lax.axis_index(tp.TP_AXIS))
            re, im = tp.tp_crnn_log_amp_parts(ansatz, sh, smp, K)
            return jnp.mean(re * wr + im * wi)

        g = jax.grad(loss_fn)(p)
        return jax.tree.map(
            lambda x: jax.lax.pmean(jax.lax.pmean(x, tp.TP_AXIS), DP_AXIS), g
        )

    g1 = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P(), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS)),
                      out_specs=P(), check_vma=False)
    )(params, samples, w_re, w_im)

    def loss_ref(p):
        re, im = ansatz.log_amp_parts(p, samples)
        return jnp.mean(re * w_re + im * w_im)

    g2 = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.slow
def test_trainer_tp_crnn_matches_dp():
    """The PRODUCT path for the complex family: ``VMCTrainer(tp=4)`` with
    CRNNU1/J1J2 on a (2, 4) mesh reproduces the dp-only trainer — same
    energies (Re and Im), same post-Adam parameters."""
    from rnnwavefunctions import CRNNU1, TrainConfig, VMCTrainer
    from rnnwavefunctions.hamiltonians.j1j2 import J1J2
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = CRNNU1(num_sites=n, units=UNITS)
    ham = J1J2(num_sites=n, j2=0.2)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=K),
                       mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(11)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for it in range(3):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            float(m_tp["mean_energy_im"]), float(m_dp["mean_energy_im"]),
            rtol=1e-4, atol=1e-5,
        )
    for a, b in zip(jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )
    out = tr_tp.evaluate(st_tp, key)
    assert np.isfinite(float(out["mean_energy"]))


def test_trainer_tp_minsr_matches_dp():
    """minSR under tensor parallelism (round 4): the per-sample rows
    assemble through the same pmean-over-tp contract as the loss gradient
    (linearity), so the tp trainer with optimizer='minsr' must reproduce
    the dp-only minSR trainer — same energies, same post-SGD parameters."""
    from rnnwavefunctions import TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = PRNN1D(num_sites=n, units=UNITS)
    ham = TFIM1D(num_sites=n, bx=1.0)
    kw = dict(num_samples=s, optimizer="minsr", learning_rate=5e-2)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(tp=K, **kw), mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(**kw),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(13)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for _ in range(3):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5, atol=1e-6,
        )
    for a, b in zip(
        jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )


@pytest.mark.slow
def test_trainer_tp_minsr_crnn_matches_dp():
    """The complex family: tp minSR rows come from vmap(jacrev) through the
    two tp-sharded heads; parity vs the dp-only complex minSR trainer."""
    from rnnwavefunctions import CRNNU1, TrainConfig, VMCTrainer
    from rnnwavefunctions.hamiltonians.j1j2 import J1J2
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = CRNNU1(num_sites=n, units=UNITS)
    ham = J1J2(num_sites=n, j2=0.2)
    kw = dict(num_samples=s, optimizer="minsr", learning_rate=5e-2)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(tp=K, **kw), mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(**kw),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(13)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for _ in range(2):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5, atol=1e-6,
        )
    for a, b in zip(
        jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=2e-5
        )


def test_trainer_tp_stack_matches_dp():
    """Multi-layer GRU stacks under tp: the sharded trunk loops layers with
    deeper layers consuming the all-gathered previous-layer output
    (parallel/tensor._tp_trunk_step) — parity vs dp-only on units=(8, 8)."""
    from rnnwavefunctions import TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = PRNN1D(num_sites=n, units=(8, 8))
    ham = TFIM1D(num_sites=n, bx=1.0)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=K),
                       mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(17)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for _ in range(3):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5, atol=1e-6,
        )
    for a, b in zip(
        jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )


def test_tp_mdrnn_log_prob_matches_unsharded():
    """tp-sharded boustrophedon sweep == the unsharded MDRNN2D log_prob
    (same flip wiring, psum'd head logits)."""
    from functools import partial

    from rnnwavefunctions import MDRNN2D
    from rnnwavefunctions.parallel import tensor as tpl

    nx, ny, u = 2, 3, 8
    ansatz = MDRNN2D(nx=nx, ny=ny, units=u)
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(1), 10)
    want = ansatz.log_prob(params, samples)

    mesh = _mesh()

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(jax.sharding.PartitionSpec(),) * 2,
        out_specs=jax.sharding.PartitionSpec(),
        check_vma=False,
    )
    def run(p, s):
        idx = jax.lax.axis_index(tpl.TP_AXIS)
        shard = tpl.shard_params_mdrnn(p, K, idx)
        return tpl.tp_mdrnn_log_prob(shard, s, nx, ny, u, K)[None]

    got = run(params, samples)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_trainer_tp_mdrnn_matches_dp():
    """The PRODUCT path for the 2D family: VMCTrainer(tp=4) with
    MDRNN2D/TFIM2D-grid on a (2, 4) mesh reproduces the dp-only trainer —
    same drawn grids, same energies, same post-update parameters — for
    BOTH optimizers (adam and minsr)."""
    from rnnwavefunctions import MDRNN2D, TFIM2D, TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    s = 16
    ansatz = MDRNN2D(nx=2, ny=3, units=8)
    ham = TFIM2D(nx=2, ny=3, bx=3.0, encoding="grid")
    key = jax.random.PRNGKey(11)
    for opt_kw, tol in [
        (dict(), dict(rtol=2e-4, atol=1e-6)),
        (dict(optimizer="minsr", learning_rate=5e-2),
         dict(rtol=5e-4, atol=2e-5)),
    ]:
        tr_tp = VMCTrainer(
            ansatz, ham, TrainConfig(num_samples=s, tp=K, **opt_kw),
            mesh=_mesh(),
        )
        tr_dp = VMCTrainer(
            ansatz, ham, TrainConfig(num_samples=s, **opt_kw),
            mesh=mesh_lib.make_mesh(2),
        )
        st_tp = tr_tp.init(key)
        st_dp = tr_dp.init(key)
        for _ in range(2):
            st_tp, m_tp = tr_tp.step(st_tp, key)
            st_dp, m_dp = tr_dp.step(st_dp, key)
            np.testing.assert_allclose(
                float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
                rtol=1e-5, atol=1e-6,
            )
        for a, b in zip(
            jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)
        out = tr_tp.evaluate(st_tp, key)
        assert np.isfinite(float(out["mean_energy"]))


def test_trainer_tp_lstm_matches_dp():
    """LSTM trunks under tp: 4 packed gate blocks column-sharded, the cell
    state c purely shard-local (parallel/tensor._tp_lstm_apply) — parity vs
    dp-only for a 2-layer LSTM stack."""
    from rnnwavefunctions import TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = PRNN1D(num_sites=n, units=(8, 8), cell="lstm")
    ham = TFIM1D(num_sites=n, bx=1.0)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=K),
                       mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(19)
    st_tp = tr_tp.init(key)
    st_dp = tr_dp.init(key)
    for _ in range(3):
        st_tp, m_tp = tr_tp.step(st_tp, key)
        st_dp, m_dp = tr_dp.step(st_dp, key)
        np.testing.assert_allclose(
            float(m_tp["mean_energy"]), float(m_dp["mean_energy"]),
            rtol=1e-5, atol=1e-6,
        )
    for a, b in zip(
        jax.tree.leaves(st_tp.params), jax.tree.leaves(st_dp.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )


def test_trainer_tp_evaluate_observables_matches_dp():
    """Extra observables on a tp mesh (round 5): ``evaluate(observables=…)``
    rides the PLAIN ansatz path with the replicated params — tp-group
    members redundantly compute the identical measurement (same dp-folded
    key), so the result must equal the dp-only trainer's on a same-dp-size
    mesh."""
    from rnnwavefunctions import TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib

    n, s = 8, 16
    ansatz = PRNN1D(num_sites=n, units=UNITS)
    ham = TFIM1D(num_sites=n, bx=1.0)
    tr_tp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=K),
                       mesh=_mesh())
    tr_dp = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                       mesh=mesh_lib.make_mesh(2))
    key = jax.random.PRNGKey(7)
    obs = ("sigma_x", "structure_factor", "renyi2")
    out_tp = tr_tp.evaluate(tr_tp.init(key), key, observables=obs)
    out_dp = tr_dp.evaluate(tr_dp.init(key), key, observables=obs)
    assert set(out_tp) == set(out_dp)
    for name in sorted(out_dp):
        np.testing.assert_allclose(
            np.asarray(out_tp[name]), np.asarray(out_dp[name]),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
