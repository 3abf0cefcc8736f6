"""CLI entry points, metrics artifacts, checkpoint/resume round-trip."""

import json
import os

import jax
import numpy as np
import pytest

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.cli import run_1dtfim, run_j1j2
from rnnwavefunctions.utils.checkpoints import Checkpointer


def test_cli_1dtfim_writes_reference_artifacts(tmp_path):
    args = [
        "--numsteps", "12", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path), "--num-devices", "1",
    ]
    mean_e, var_e = run_1dtfim.main(args)
    assert len(mean_e) == 13  # inclusive range, reference-style
    npys = [f for f in os.listdir(tmp_path) if f.endswith(".npy")]
    assert any(f.startswith("meanEnergy_") for f in npys)
    assert any(f.startswith("varEnergy_") for f in npys)
    mean_file = [f for f in npys if f.startswith("meanEnergy_")][0]
    series = np.load(tmp_path / mean_file)
    assert len(series) == 13 and np.isfinite(series).all()
    jsonl = [f for f in os.listdir(tmp_path) if f.endswith(".jsonl")]
    assert jsonl, "structured metrics log missing"
    lines = [json.loads(l) for l in open(tmp_path / jsonl[0])]
    assert {"step", "wall_time_s", "mean_energy", "var_energy"} <= set(lines[0])


def test_cli_resume_continues_from_checkpoint(tmp_path):
    base = [
        "--systemsize", "6", "--num-units", "8", "--numsamples", "32",
        "--workdir", str(tmp_path), "--num-devices", "1",
    ]
    run_1dtfim.main(base + ["--numsteps", "10"])
    mean_e, _ = run_1dtfim.main(base + ["--numsteps", "20", "--resume"])
    # resumed run appends 10 more records onto the restored 11
    assert len(mean_e) == 21


def test_cli_j1j2_runs_complex(tmp_path):
    mean_e, var_e = run_j1j2.main([
        "--numsteps", "5", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path), "--num-devices", "1",
    ])
    assert isinstance(mean_e[-1], complex)
    series = np.load(
        tmp_path / [f for f in os.listdir(tmp_path) if f.startswith("meanEnergy_")][0]
    )
    assert np.iscomplexobj(series)


def test_cli_2d_float64_end_to_end(tmp_path):
    """--dtype float64 on the 2D runners trains in f64 end-to-end (the
    reference's 2D graph dtype, ``2DTFIM_2DRNN/RNNwavefunction.py:32``)."""
    from rnnwavefunctions.cli import run_2dtfim_1drnn, run_2dtfim_2drnn

    base = [
        "--numsteps", "4", "--systemsize-x", "2", "--systemsize-y", "2",
        "--num-units", "6", "--numsamples", "16", "--dtype", "float64",
        "--num-devices", "1",
    ]
    try:
        mean_e, _ = run_2dtfim_2drnn.main(
            base + ["--workdir", str(tmp_path / "mdrnn")]
        )
        assert np.isfinite(mean_e).all()
        mean_e, _ = run_2dtfim_1drnn.main(
            base + ["--workdir", str(tmp_path / "snake")]
        )
        assert np.isfinite(mean_e).all()
    finally:
        jax.config.update("jax_enable_x64", False)


def test_checkpoint_roundtrip(tmp_path):
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6),
        TrainConfig(num_samples=32),
    )
    state = trainer.init()
    state, _ = trainer.step(state, jax.random.PRNGKey(0))
    state, _ = trainer.step(state, jax.random.PRNGKey(0))

    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state)
    ckpt.wait()
    assert ckpt.latest_step() == 2

    template = trainer.init()
    restored = ckpt.restore(template)
    assert int(restored.step) == 2
    for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # restored state must be usable for further training
    restored, m = trainer.step(restored, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["mean_energy"]))
    ckpt.close()


@pytest.mark.slow
def test_cli_evaluate_restores_and_measures(tmp_path):
    """Train briefly via the CLI, then measure the checkpoint with the
    evaluate entry point (restore plumbing + JSON output)."""
    from rnnwavefunctions.cli import evaluate

    run_1dtfim.main([
        "--numsteps", "10", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path), "--num-devices", "1",
    ])
    ckpt_dir = [d for d in os.listdir(tmp_path) if d.startswith("ckpt_")][0]
    result = evaluate.main([
        str(tmp_path / ckpt_dir), "--workload", "1dtfim",
        "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--num-batches", "3", "--num-devices", "1",
        "--observables", "sigma_x", "structure_factor", "renyi2",
        "--fidelity",
    ])
    assert result["step"] == 11
    assert np.isfinite(result["energy"]) and result["energy"] < 0.0
    assert result["err_bar"] > 0.0
    assert result["num_samples_total"] == 96
    assert len(result["sigma_x"]) == 6
    assert np.isfinite(result["sigma_x_total"])
    sk = np.asarray(result["structure_factor"])
    assert sk.shape == (6,) and np.all(np.isfinite(sk))
    assert np.isfinite(result["renyi2"]) and result["renyi2"] > -1e-6
    assert result["renyi2_err"] >= 0.0  # 3 batches -> scatter available
    assert 0.0 < result["fidelity"] <= 1.0 + 1e-9
    assert result["energy_exact"] < 0.0


@pytest.mark.slow
def test_cli_evaluate_restores_lstm_checkpoint(tmp_path):
    """evaluate --cell lstm rebuilds the LSTM-shaped pytree so checkpoints
    from ``run_1dtfim --cell lstm`` restore (review finding: the evaluate
    CLI used to hardwire the GRU/f32 ansatz and mismatch on restore)."""
    from rnnwavefunctions.cli import evaluate

    run_1dtfim.main([
        "--numsteps", "6", "--systemsize", "6", "--num-units", "8",
        "--cell", "lstm", "--numsamples", "32",
        "--workdir", str(tmp_path), "--num-devices", "1",
    ])
    ckpt_dir = [d for d in os.listdir(tmp_path) if d.startswith("ckpt_")][0]
    result = evaluate.main([
        str(tmp_path / ckpt_dir), "--workload", "1dtfim",
        "--systemsize", "6", "--num-units", "8", "--cell", "lstm",
        "--numsamples", "32", "--num-batches", "2", "--num-devices", "1",
    ])
    assert result["step"] == 7
    assert np.isfinite(result["energy"]) and result["energy"] < 0.0


@pytest.mark.slow
def test_profile_trace_capture(tmp_path):
    """--profile-dir captures exactly one traced block and always closes the
    trace (ADVICE r1: a short run used to leak an open profiler session)."""
    from rnnwavefunctions.cli.run_loop import run_training

    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6),
        TrainConfig(num_samples=32),
    )
    prof = tmp_path / "prof"
    run_training(
        trainer, num_steps=12, workdir=str(tmp_path), tag="prof",
        profile_dir=str(prof),
    )
    traces = [
        os.path.join(root, f)
        for root, _, files in os.walk(prof)
        for f in files
        if f.endswith((".xplane.pb", ".trace.json.gz"))
    ]
    assert traces, f"no trace artifacts under {prof}"
    # a second profiled run must not raise (the trace was properly closed)
    run_training(
        trainer, num_steps=3, workdir=str(tmp_path), tag="prof2",
        profile_dir=str(tmp_path / "prof2"),
    )


@pytest.mark.slow
def test_ckpt_cadence_saves_exact_step(tmp_path):
    """With ckpt_every not a multiple of log_every, the saved checkpoint
    must carry exactly the ckpt_every-step state (blocks stop at checkpoint
    steps rather than saving the block-end state)."""
    from rnnwavefunctions.cli.run_loop import run_training

    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)),
        TFIM1D(num_sites=6, bx=1.0),
        TrainConfig(num_samples=32),
    )
    run_training(
        trainer, num_steps=27, workdir=str(tmp_path), tag="cadence",
        log_every=10, save_every=10, ckpt_every=25,
    )
    ckpt = Checkpointer(os.path.join(str(tmp_path), "ckpt_cadence"))
    steps = ckpt._steps()
    # loop indices are reference-style 0..num_steps inclusive and the state
    # counter counts updates, so cadence index 25 saves as update-count 26
    # (pre-fix the block ran through index 30's boundary and saved 28+ only)
    assert 26 in steps, steps
    assert int(ckpt.restore(trainer.init()).step) == 28  # final save, idx 27


def test_cli_matmul_precision_flag(tmp_path):
    """--matmul-precision highest threads through TrainConfig into the
    jitted step (the ambient context is read at trace time) and still
    trains; equality with default is not expected — only finiteness and
    artifact parity."""
    mean_e, _ = run_1dtfim.main([
        "--numsteps", "4", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path),
        "--num-devices", "1", "--matmul-precision", "highest",
    ])
    assert len(mean_e) == 5 and np.isfinite(np.asarray(mean_e)).all()


def test_cli_optimizer_minsr_flag(tmp_path):
    """--optimizer minsr threads through TrainConfig into the jitted step
    (sample-space SR direction + sgd apply, vmc/minsr.py) and trains
    through the full CLI artifact pipeline."""
    mean_e, _ = run_1dtfim.main([
        "--numsteps", "4", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path),
        "--num-devices", "1", "--optimizer", "minsr",
        "--learningrate", "5e-2", "--sr-damping", "0.02",
    ])
    assert len(mean_e) == 5 and np.isfinite(np.asarray(mean_e)).all()


def test_cli_evaluate_restores_minsr_checkpoint(tmp_path):
    """evaluate on a checkpoint trained with --optimizer minsr: the trainer
    template's opt_state is Adam-shaped, so restore must fall back to the
    params+step path (review finding: evaluate crashed on minSR runs)."""
    from rnnwavefunctions.cli import evaluate

    run_1dtfim.main([
        "--numsteps", "6", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path),
        "--num-devices", "1", "--optimizer", "minsr",
        "--learningrate", "5e-2",
    ])
    ckpt_dir = [d for d in os.listdir(tmp_path) if d.startswith("ckpt_")][0]
    result = evaluate.main([
        str(tmp_path / ckpt_dir), "--workload", "1dtfim",
        "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--num-batches", "2", "--num-devices", "1",
    ])
    assert result["step"] == 7
    assert np.isfinite(result["energy"]) and result["energy"] < 0.0


def test_cli_resume_across_optimizers(tmp_path):
    """Refining an Adam-trained wavefunction with minSR: --resume over a
    checkpoint whose opt_state layout differs keeps params + step and
    re-initializes the optimizer state (utils/checkpoints.py
    restore_params_and_step)."""
    base = [
        "--systemsize", "6", "--num-units", "8", "--numsamples", "32",
        "--workdir", str(tmp_path), "--num-devices", "1",
    ]
    run_1dtfim.main(base + ["--numsteps", "10"])
    mean_e, _ = run_1dtfim.main(base + [
        "--numsteps", "20", "--resume",
        "--optimizer", "minsr", "--learningrate", "5e-2",
    ])
    assert len(mean_e) == 21 and np.isfinite(np.asarray(mean_e)).all()


def test_cli_evaluate_fidelity_rejects_large_n_fast():
    """--fidelity with N>24 must exit BEFORE any 2^N allocation or
    measurement work (review finding: the guard used to sit after both);
    16 < N <= 24 is served by the native Lanczos vector instead."""
    from rnnwavefunctions.cli import evaluate

    with pytest.raises(SystemExit, match="N=26 > 24"):
        evaluate.main([
            "/nonexistent-ckpt", "--workload", "1dtfim",
            "--systemsize", "26", "--fidelity",
        ])


def test_module_dispatcher(capsys):
    """``python -m rnnwavefunctions`` subcommand dispatch: usage on no
    args, exit code 2 + usage on an unknown command, and real wiring into
    each runner's argparse (--help must reach the command's own parser)."""
    from rnnwavefunctions import __main__ as dispatcher

    assert dispatcher.main([]) == 0
    assert "commands:" in capsys.readouterr().out

    assert dispatcher.main(["not-a-command"]) == 2
    assert "unknown command" in capsys.readouterr().err

    for cmd in dispatcher.COMMANDS:
        with pytest.raises(SystemExit) as e:
            dispatcher.main([cmd, "--help"])
        assert e.value.code == 0
        assert "--help" not in capsys.readouterr().err


def test_module_dispatcher_exit_status_on_success(tmp_path, capsys):
    """A successful training run through the dispatcher must return exit
    STATUS 0 — the runner mains return a (mean, var) tuple for in-process
    callers, which must NOT leak into sys.exit (a truthy tuple would exit
    1 and print the series to stderr, breaking `... && next` pipelines)."""
    from rnnwavefunctions import __main__ as dispatcher

    rc = dispatcher.main([
        "1dtfim", "--numsteps", "2", "--systemsize", "4",
        "--num-units", "4", "--numsamples", "8", "--num-devices", "1",
        "--workdir", str(tmp_path / "d"),
    ])
    assert rc == 0


def test_cli_1d_float64_end_to_end(tmp_path):
    """--dtype float64 on the 1D runners (1DTFIM + J1J2) trains in f64
    end-to-end — the provable-parity escape hatch for the reference's f64
    log-prob accumulation (1DTFIM/RNNwavefunction.py:113-116)."""
    try:
        mean_e, _ = run_1dtfim.main([
            "--numsteps", "4", "--systemsize", "6", "--num-units", "6",
            "--numsamples", "16", "--dtype", "float64",
            "--num-devices", "1", "--workdir", str(tmp_path / "tfim"),
        ])
        assert np.isfinite(mean_e).all()
        mean_e, _ = run_j1j2.main([
            "--numsteps", "4", "--systemsize", "6", "--num-units", "6",
            "--numsamples", "16", "--dtype", "float64",
            "--num-devices", "1", "--workdir", str(tmp_path / "j1j2"),
        ])
        assert np.isfinite(mean_e).all()
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.slow
def test_cli_evaluate_tp_checkpoint_with_observables(tmp_path):
    """VERDICT r4 item 10 end-to-end: train with --tp 2, then measure the
    checkpoint with observables in ONE evaluate command.  tp params are
    replicated full trees, so the evaluate CLI's dp-only trainer restores
    them unchanged; the trainer-level tp evaluate path is covered by
    tests/test_tensor_parallel.py."""
    from rnnwavefunctions.cli import evaluate

    run_1dtfim.main([
        "--numsteps", "6", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path), "--tp", "2",
    ])
    ckpt_dir = [d for d in os.listdir(tmp_path) if d.startswith("ckpt_")][0]
    result = evaluate.main([
        str(tmp_path / ckpt_dir), "--workload", "1dtfim",
        "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--num-batches", "2", "--num-devices", "1",
        "--observables", "sigma_x", "structure_factor", "renyi2",
    ])
    assert result["step"] == 7
    assert np.isfinite(result["energy"]) and result["energy"] < 0.0
    assert len(result["sigma_x"]) == 6
    assert np.isfinite(result["renyi2"])
    # and on a tp measurement mesh (sharded-trunk eval for the energy,
    # plain replicated path once observables are requested)
    result_tp = evaluate.main([
        str(tmp_path / ckpt_dir), "--workload", "1dtfim",
        "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--num-batches", "2",
        "--num-devices", "4", "--tp", "2",
        "--observables", "sigma_x",
    ])
    assert np.isfinite(result_tp["energy"]) and result_tp["energy"] < 0.0
    assert len(result_tp["sigma_x"]) == 6


def test_cli_staged_schedule(tmp_path):
    """--schedule staged with bounds/scales runs through the 1D runner (the
    round-5 record recipe's CLI form); default stays the reference's
    constant schedule."""
    mean_e, _ = run_1dtfim.main([
        "--numsteps", "8", "--systemsize", "6", "--num-units", "8",
        "--numsamples", "32", "--workdir", str(tmp_path),
        "--num-devices", "1", "--optimizer", "minsr",
        "--learningrate", "5e-2",
        "--schedule", "staged",
        "--lr-stage-bounds", "4", "--lr-stage-scales", "0.1",
    ])
    assert len(mean_e) == 9 and np.isfinite(mean_e).all()
