"""Distributed semantics on the simulated 8-device CPU mesh (SURVEY.md §4):

* psum'd gradient on a k-device mesh == single-device gradient on the
  identical global sample batch;
* a full sharded train step runs, keeps params replicated and identical on
  every device, and produces finite energy statistics;
* mesh-size divisibility validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer, make_mesh
from rnnwavefunctions.parallel import mesh as mesh_lib
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions.vmc.loss import surrogate_loss


def test_simulated_mesh_has_8_devices():
    assert jax.device_count() == 8


def test_sharded_gradient_matches_single_device():
    n, s = 6, 64
    ansatz = PRNN1D(num_sites=n, units=(8,))
    ham = TFIM1D(num_sites=n, bx=1.0)
    params = ansatz.init(jax.random.PRNGKey(0))
    le = make_local_energy_fn(ansatz, ham)

    samples = ansatz.sample(params, jax.random.PRNGKey(1), s)
    la = ansatz.log_amp(params, samples)
    e_loc, _, _ = le(params, samples, la)
    e_mean = jnp.mean(e_loc)

    def loss_single(p):
        return surrogate_loss(
            ansatz.log_amp(p, samples), None, e_loc, None, e_mean, None
        )

    g_single = jax.grad(loss_single)(params)

    mesh = make_mesh()

    def device_grad(p, sigma, e):
        em = mesh_lib.pmean(jnp.mean(e))

        def loss_local(q):
            return surrogate_loss(ansatz.log_amp(q, sigma), None, e, None, em, None)

        return jax.tree.map(mesh_lib.pmean, jax.grad(loss_local)(p))

    g_sharded = jax.jit(
        jax.shard_map(
            device_grad,
            mesh=mesh,
            in_specs=(P(), P("dp"), P("dp")),
            out_specs=P(),
            check_vma=False,
        )
    )(params, samples, e_loc)

    for a, b in zip(jax.tree.leaves(g_single), jax.tree.leaves(g_sharded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_sharded_train_step_runs_and_replicates():
    mesh = make_mesh()
    assert mesh.shape["dp"] == 8
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)),
        TFIM1D(num_sites=6, bx=1.0),
        TrainConfig(num_samples=128),
        mesh=mesh,
    )
    assert trainer.local_samples == 16
    state = trainer.init()
    state, metrics = trainer.step(state, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["mean_energy"]))

    # params must be bitwise identical on every device after the update
    for leaf in jax.tree.leaves(state.params):
        shards = [np.asarray(x.data) for x in leaf.addressable_shards]
        for sh in shards[1:]:
            np.testing.assert_array_equal(shards[0], sh)

    # and a second step must keep improving state without error
    state, metrics2 = trainer.step(state, jax.random.PRNGKey(0))
    assert int(state.step) == 2
    assert float(metrics2["var_energy"]) >= 0.0


def test_divisibility_validation():
    mesh = make_mesh()
    with pytest.raises(ValueError, match="divisible"):
        VMCTrainer(
            PRNN1D(num_sites=6, units=(8,)),
            TFIM1D(num_sites=6),
            TrainConfig(num_samples=100),
            mesh=mesh,
        )


def test_mesh_energy_statistics_match_single_device_estimator():
    """Same params: mesh-pmean'd mean/var of E_loc over 8 shards equals the
    single-device computation on the concatenated batch."""
    n, s = 6, 64
    ansatz = PRNN1D(num_sites=n, units=(8,))
    ham = TFIM1D(num_sites=n, bx=0.8)
    params = ansatz.init(jax.random.PRNGKey(4))
    le = make_local_energy_fn(ansatz, ham)
    samples = ansatz.sample(params, jax.random.PRNGKey(5), s)
    e, _, _ = le(params, samples, ansatz.log_amp(params, samples))

    mesh = make_mesh()

    def stats(sigma, e_loc):
        em = mesh_lib.pmean(jnp.mean(e_loc))
        var = mesh_lib.pmean(jnp.mean((e_loc - em) ** 2))
        return em, var

    em, var = jax.jit(
        jax.shard_map(
            stats, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P(), P()),
            check_vma=False,
        )
    )(samples, e)
    np.testing.assert_allclose(float(em), float(jnp.mean(e)), rtol=1e-6)
    np.testing.assert_allclose(
        float(var), float(jnp.mean((e - jnp.mean(e)) ** 2)), rtol=1e-5
    )


def test_sharded_multi_step_runs(tmp_path):
    """run_steps (device-side lax.scan of full updates) on the 8-device mesh."""
    mesh = make_mesh()
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)),
        TFIM1D(num_sites=6, bx=1.0),
        TrainConfig(num_samples=128),
        mesh=mesh,
    )
    state = trainer.init()
    state, ms = trainer.run_steps(state, jax.random.PRNGKey(0), 5)
    assert ms["mean_energy"].shape == (5,)
    assert np.isfinite(np.asarray(ms["mean_energy"])).all()
    assert int(state.step) == 5
    # params stay replicated and identical across devices
    for leaf in jax.tree.leaves(state.params):
        shards = [np.asarray(x.data) for x in leaf.addressable_shards]
        for sh in shards[1:]:
            np.testing.assert_array_equal(shards[0], sh)
