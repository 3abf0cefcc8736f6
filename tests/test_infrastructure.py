"""Checks that need no card: the smoke script refuses to run without a GPU,
the compile-cache rule, checkpoints on numpy alone, and the mesh guards."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.utils import compile_cache
from rnnwavefunctions.utils.checkpoints import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in-checkout", "script-alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """No GPU (and, for the lone copy, no package beside it): a non-zero
    exit and no "ok" line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "FAIL" in r.stderr


def test_bench_row_refuses_the_cpu():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench._device()


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is configured;
    without it the cache is .jax_cache/ at the checkout root."""
    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "untouched")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_dir is None:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            assert compile_cache.enable() == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(
                REPO, ".jax_cache")
        else:
            given = str(tmp_path / env_dir)
            monkeypatch.setenv(compile_cache.ENV_VAR, given)
            assert compile_cache.enable() == given
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_package_runs_without_orbax():
    """The CLI path imports no checkpointing library beyond numpy."""
    code = ("import sys; import rnnwavefunctions.cli.run_1dtfim, "
            "rnnwavefunctions.cli.evaluate; "
            "sys.exit(any(m.startswith('orbax') for m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


def _trainer(optimizer="adam", mesh=None):
    return VMCTrainer(PRNN1D(num_sites=5, units=(6,)), TFIM1D(num_sites=5),
                      TrainConfig(num_samples=16, optimizer=optimizer),
                      mesh=mesh)


def test_checkpoint_keeps_the_newest_files_atomically(tmp_path):
    trainer = _trainer()
    state = trainer.init()
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for _ in range(4):
        state, _ = trainer.step(state, jax.random.PRNGKey(0))
        ckpt.save(state)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000003.npz", "step_00000004.npz"]
    assert ckpt.latest_step() == 4
    restored = ckpt.restore(trainer.init(), step=3)
    assert int(restored.step) == 3


def test_checkpoint_restores_onto_the_mesh(tmp_path):
    from rnnwavefunctions import make_mesh

    trainer = _trainer(mesh=make_mesh(4))
    state, _ = trainer.run_steps(trainer.init(), jax.random.PRNGKey(1), 2)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state)
    restored = ckpt.restore(trainer.init())
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.sharding == b.sharding
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_optimizer_change_keeps_params(tmp_path):
    """An Adam checkpoint does not restore into a minSR template (the
    optimizer state differs), but its params and step do."""
    adam = _trainer()
    state, _ = adam.step(adam.init(), jax.random.PRNGKey(2))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state)
    template = _trainer("minsr").init()
    with pytest.raises(ValueError):
        ckpt.restore(template)
    params, step = ckpt.restore_params_and_step(template)
    assert int(step) == 1
    for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_rejects_a_different_ansatz(tmp_path):
    trainer = _trainer()
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(trainer.init())
    wider = VMCTrainer(PRNN1D(num_sites=5, units=(7,)), TFIM1D(num_sites=5),
                       TrainConfig(num_samples=16))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(wider.init())
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(trainer.init())


def test_evaluate_rejects_tp_not_dividing_devices():
    """``--tp 3`` over the 8 test devices would leave two idle: refused, as
    ``make_mesh`` refuses more devices than exist."""
    from rnnwavefunctions.cli import evaluate

    with pytest.raises(ValueError, match="does not divide"):
        evaluate.main(["/nonexistent-ckpt", "--workload", "1dtfim",
                       "--systemsize", "6", "--num-units", "6", "--tp", "3"])
