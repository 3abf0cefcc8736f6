"""The GPU rollout kernel (``ops/rollout.py``) in Pallas interpret mode
against the jnp scans, and the choice of path.

On the CPU the kernel runs through the Pallas interpreter, which executes
the same kernel body in float32; the jnp scans of ``models/prnn1d.py`` are
the reference.  The ``kernel_on`` fixture makes the ansatz take the kernel
as it does on a GPU (the platform query answers "gpu", the kernel entry
points run interpreted), so the parity, snake, estimator and trainer paths
are exercised through it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.models import cells
from rnnwavefunctions.models.prnn1d import site_uniforms
from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D
from rnnwavefunctions.hamiltonians.tfim2d import TFIM2D
from rnnwavefunctions.ops import rollout
from rnnwavefunctions.vmc.local_energy import make_local_energy_fn

N_SITES = 6
NUM_SAMPLES = 37  # not a multiple of any block size


@pytest.fixture
def kernel_on(monkeypatch):
    monkeypatch.setattr(rollout, "_platform", lambda: "gpu")
    monkeypatch.setattr(
        rollout, "log_prob", functools.partial(rollout.log_prob, interpret=True))
    monkeypatch.setattr(
        rollout, "sample", functools.partial(rollout.sample, interpret=True))


def _setup(cell, depth, width, n=N_SITES, s=NUM_SAMPLES, seed=0):
    ansatz = PRNN1D(num_sites=n, units=(width,) * depth, cell=cell)
    params = ansatz.init(jax.random.PRNGKey(seed))
    u = site_uniforms(jax.random.PRNGKey(seed + 1), n, s)
    return ansatz, params, u


STACKS = [
    pytest.param(cell, depth, width, id=f"{cell}-{depth}x{width}")
    for cell in ("gru", "lstm") for depth in (1, 2) for width in (8, 50)
]


@pytest.mark.parametrize("cell,depth,width", STACKS)
def test_log_prob_matches_scan(cell, depth, width):
    ansatz, params, u = _setup(cell, depth, width)
    samples, _ = ansatz._sample_jnp(params, u)
    got = rollout.log_prob(params, samples, ansatz._log_prob_plain_jnp,
                           interpret=True)
    want = ansatz._log_prob_plain_jnp(params, samples)
    assert got.shape == (NUM_SAMPLES,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,depth,width", STACKS)
def test_sampler_draws_the_scan_spins(cell, depth, width):
    """With the same uniforms the kernel draws the jnp sampler's spins and
    their log-density."""
    ansatz, params, u = _setup(cell, depth, width, seed=3)
    got_s, got_lp = rollout.sample(params, u, interpret=True)
    want_s, want_lp = ansatz._sample_jnp(params, u)
    assert got_s.shape == (NUM_SAMPLES, N_SITES) and got_s.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))
    np.testing.assert_allclose(np.asarray(got_lp), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,depth,width", STACKS)
def test_custom_vjp_gradient_matches_scan(cell, depth, width):
    ansatz, params, u = _setup(cell, depth, width, seed=5)
    samples, _ = ansatz._sample_jnp(params, u)
    weights = jax.random.normal(jax.random.PRNGKey(9), (NUM_SAMPLES,))

    def loss(fn):
        return lambda p: jnp.sum(weights * fn(p, samples))

    got = jax.grad(loss(functools.partial(
        rollout.log_prob, reference=ansatz._log_prob_plain_jnp,
        interpret=True)))(params)
    want = jax.grad(loss(ansatz._log_prob_plain_jnp))(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def test_parity_log_prob_through_kernel(kernel_on):
    ansatz = PRNN1D(num_sites=N_SITES, units=(8,), parity=True)
    params = ansatz.init(jax.random.PRNGKey(2))
    samples = jax.random.bernoulli(
        jax.random.PRNGKey(4), 0.5, (NUM_SAMPLES, N_SITES)).astype(jnp.int32)
    got = ansatz.log_prob(params, samples)
    lp = ansatz._log_prob_plain_jnp(params, samples)
    lp_rev = ansatz._log_prob_plain_jnp(params, samples[:, ::-1])
    want = jnp.logaddexp(lp, lp_rev) - jnp.log(2.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_snake_sample_and_log_prob_through_kernel(kernel_on):
    ansatz = PRNNSnake2D(nx=3, ny=2, units=(8,), cell="lstm")
    params = ansatz.init(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    samples, lp = ansatz.sample_with_log_prob(params, key, NUM_SAMPLES)
    want_s, want_lp = ansatz._sample_jnp(
        params, site_uniforms(key, 6, NUM_SAMPLES))
    np.testing.assert_array_equal(np.asarray(samples), np.asarray(want_s))
    np.testing.assert_allclose(np.asarray(lp), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ansatz.log_prob(params, samples)),
        np.asarray(ansatz._log_prob_plain_jnp(params, samples)),
        rtol=1e-5, atol=1e-5)


def test_local_energy_through_kernel(kernel_on, monkeypatch):
    ansatz = PRNNSnake2D(nx=2, ny=3, units=(8,))
    ham = TFIM2D(nx=2, ny=3, bx=2.0, encoding="flat")
    params = ansatz.init(jax.random.PRNGKey(8))
    samples = ansatz.sample(params, jax.random.PRNGKey(9), NUM_SAMPLES)
    le = make_local_energy_fn(ansatz, ham)
    got = le(params, samples, ansatz.log_amp(params, samples))[0]
    monkeypatch.setattr(rollout, "_platform", lambda: "cpu")
    want = le(params, samples, ansatz.log_amp(params, samples))[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_trainer_steps_through_kernel(kernel_on, monkeypatch):
    """The jitted, sharded trainer step takes the kernel (sampler, log-prob
    and its custom_vjp) and reproduces the scan's step."""
    ansatz = PRNN1D(num_sites=N_SITES, units=(8,))
    ham = TFIM1D(num_sites=N_SITES, bx=1.0)
    config = TrainConfig(num_samples=32)
    key = jax.random.PRNGKey(0)
    tr = VMCTrainer(ansatz, ham, config)
    st, m = tr.run_steps(tr.init(), key, 2)
    monkeypatch.setattr(rollout, "_platform", lambda: "cpu")
    tr_ref = VMCTrainer(ansatz, ham, config)
    st_ref, m_ref = tr_ref.run_steps(tr_ref.init(), key, 2)
    np.testing.assert_allclose(np.asarray(m["mean_energy"]),
                               np.asarray(m_ref["mean_energy"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(st.params), jax.tree.leaves(st_ref.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_highest_precision_in_interpret_mode():
    """Under ``default_matmul_precision("highest")`` the interpreter keeps
    float32 products (the card's three-pass TF32 has no CPU lowering)."""
    ansatz, params, u = _setup("gru", 1, 8)
    samples, _ = ansatz._sample_jnp(params, u)
    with jax.default_matmul_precision("highest"):
        got = rollout.log_prob(params, samples, ansatz._log_prob_plain_jnp,
                               interpret=True)
        want = ansatz._log_prob_plain_jnp(params, samples)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_dot_precision_follows_the_ambient_setting():
    assert rollout._dot_precision(False) is None
    with jax.default_matmul_precision("highest"):
        assert (rollout._dot_precision(False)
                == jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
        assert rollout._dot_precision(True) == jax.lax.Precision.HIGHEST
    with jax.default_matmul_precision("high"):
        assert rollout._dot_precision(False) is None


# ---------------------------------------------------------------------------
# choice of path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,taken", [
    ({}, True),
    ({"cell": "lstm"}, True),
    ({"units": (50, 50, 50)}, True),
    ({"parity": True}, True),
    ({"units": (8, 16)}, False),            # non-uniform stack
    ({"cell": cells.ElmanCell()}, False),   # custom cell
    ({"local_dim": 3}, False),
    ({"dtype": jnp.float64}, False),
    ({"accum_dtype": jnp.float64}, False),
])
def test_kernel_choice_on_gpu(monkeypatch, kwargs, taken):
    monkeypatch.setattr(rollout, "_platform", lambda: "gpu")
    kwargs = {"num_sites": 4, "units": (8,), **kwargs}
    assert PRNN1D(**kwargs)._use_kernel() is taken


@pytest.mark.parametrize("platform", ["cpu", "neuron", "METAL"])
def test_kernel_only_on_gpu(monkeypatch, platform):
    monkeypatch.setattr(rollout, "_platform", lambda: platform)
    assert PRNN1D(num_sites=4, units=(8,))._use_kernel() is False


def test_platform_follows_default_device():
    assert rollout._platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert rollout._platform() == "cpu"


@pytest.mark.parametrize("batch,up,gates,rows", [
    (37, 64, 3, 16),       # few rows: the smallest block
    (500, 64, 3, 16),      # the sampler's batch: many small blocks
    (50000, 64, 3, 32),    # the estimator's batch: the register cap
    (50000, 64, 4, 16),    # LSTM gates halve the cap
    (64000, 16, 3, 128),   # narrow units allow taller blocks
])
def test_block_rows(batch, up, gates, rows):
    assert rollout.block_rows(batch, up, gates) == rows


@pytest.mark.parametrize("units,up", [(2, 16), (8, 16), (16, 16), (50, 64),
                                      (64, 64), (100, 128)])
def test_padded_units(units, up):
    assert rollout.padded_units(units) == up


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pack_weights_layout(cell):
    """Gate g of layer l lands at [l, g] with zero padding; LSTM's single
    bias is the input bias and its recurrent bias is zero."""
    ansatz = PRNN1D(num_sites=4, units=(5, 5), cell=cell)
    params = ansatz.init(jax.random.PRNGKey(1))
    params = jax.tree.map(lambda x: x + 0.5, params)  # nonzero biases
    g = rollout.GATES[cell]
    wx, wh, b, hw, hb = rollout.pack_weights(params, 16)
    assert wx.shape == wh.shape == (2, g, 16, 16)
    assert b.shape == (2, 2, g, 16) and hw.shape == (2, 16) and hb.shape == (2,)
    layer1 = params["rnn"][1]
    np.testing.assert_array_equal(np.asarray(wh[1, 2, :5, :5]),
                                  np.asarray(layer1["wh"][:, 10:15]))
    np.testing.assert_array_equal(np.asarray(wx[0, 1, :2, :5]),
                                  np.asarray(params["rnn"][0]["wx"][:, 5:10]))
    for arr in (wx[:, :, 5:], wx[:, :, :, 5:], wh[:, :, 5:], b[..., 5:],
                hw[:, 5:], wx[0, :, 2:]):
        assert not np.any(np.asarray(arr))
    if cell == "lstm":
        assert not np.any(np.asarray(b[:, 1]))
        np.testing.assert_array_equal(np.asarray(b[0, 0, 3, :5]),
                                      np.asarray(params["rnn"][0]["b"][15:20]))
    else:
        np.testing.assert_array_equal(np.asarray(b[0, 1, 0, :5]),
                                      np.asarray(params["rnn"][0]["bh"][:5]))
