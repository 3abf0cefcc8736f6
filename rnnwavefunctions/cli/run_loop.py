"""Shared training-loop driver for the CLI entry points.

Replicates the reference's L3 run_X loop behavior (SURVEY.md §2.3/§3.1):
sample + local energies + update per step (all fused in the trainer),
record mean/var energy, print every ``log_every`` steps, persist the .npy
series every ``save_every`` steps and a checkpoint every ``ckpt_every``
steps, with cold-restart resume (``TrainingRNN_1DTFIM.py:199-227``; the loop
range is ``range(start, numsteps + 1)`` inclusive, as in the reference).

Dispatch granularity: metrics are only *consumed* on the ``log_every``
cadence — the reference itself prints/saves on a 10-step cadence
(``TrainingRNN_1DTFIM.py:213-227``) — so the loop runs ``log_every`` steps
per device dispatch through ``VMCTrainer.run_steps`` (one jitted
``lax.scan``), not one dispatch per step.  The per-step metrics series is
preserved exactly (``run_steps`` returns full per-step arrays); what is
elided is the host<->device round-trip per step.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from ..utils.checkpoints import Checkpointer
from ..utils.metrics import MetricsSeries
from ..vmc.trainer import VMCTrainer


def add_schedule_flags(parser, default: str = "constant") -> None:
    """LR-schedule flags shared by the 1D runners.  ``default`` follows
    each runner's reference trainer; "staged" (piecewise-constant phases)
    is the recipe for deep-accuracy runs with ``--optimizer minsr``."""
    parser.add_argument(
        "--schedule", type=str, default=default,
        choices=["constant", "inverse", "harmonic", "exponential",
                 "staged"],
        help=f"learning-rate schedule (default: {default}, the reference "
             "trainer's choice; 'staged' multiplies the lr by "
             "--lr-stage-scales[i] once step >= --lr-stage-bounds[i])",
    )
    parser.add_argument("--lr-stage-bounds", type=int, nargs="*",
                        default=[],
                        help="staged-schedule step bounds (ascending); the "
                             "J1-J2 record recipe: 10000 13000")
    parser.add_argument("--lr-stage-scales", type=float, nargs="*",
                        default=[],
                        help="staged-schedule lr multipliers (compounding); "
                             "the record recipe: 0.1 0.2")


def schedule_kwargs(args) -> dict:
    """TrainConfig kwargs from ``add_schedule_flags``'s namespace."""
    return {
        "schedule": args.schedule,
        "lr_stage_bounds": tuple(args.lr_stage_bounds),
        "lr_stage_scales": tuple(args.lr_stage_scales),
    }


def resolve_dtype(name: str):
    """CLI ``--dtype`` -> jnp dtype, enabling the x64 mode float64 needs.
    The reference's 2D families build their whole graph in float64
    (``2DTFIM_1DRNN/RNNwavefunction.py:38``,
    ``2DTFIM_2DRNN/RNNwavefunction.py:32``); float64 runs the jnp scan
    paths (the rollout kernel is f32 + Kahan) and must be opted into
    before any tracing."""
    import jax.numpy as jnp

    if name == "float64":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def _append_block(metrics: MetricsSeries, ms) -> None:
    """Append one ``run_steps`` metrics block (leading axis = steps)."""
    from ..vmc.trainer import decode_metrics_block

    for m, v in decode_metrics_block(ms):
        metrics.append(m, v)


def run_training(
    trainer: VMCTrainer,
    num_steps: int,
    workdir: str,
    tag: str,
    resume: bool = False,
    log_every: int = 10,
    save_every: int = 10,
    ckpt_every: int = 500,
    profile_dir: Optional[str] = None,
):
    """Returns (final_state, mean_energy list, var_energy list)."""
    from ..parallel.multihost import is_primary

    # Multi-host: every process trains (collectives are cooperative) and
    # every process calls ckpt.save (Orbax saves are collective), but only
    # the primary touches the metrics artifacts on disk (write=primary —
    # unguarded jsonl removal/rewrites from every process would race on a
    # shared filesystem).
    primary = is_primary()
    metrics = MetricsSeries(workdir, tag, resume=resume, write=primary)
    ckpt_dir = os.path.join(workdir, f"ckpt_{tag}")
    if not resume and primary and os.path.isdir(ckpt_dir):
        # Orbax's should_save refuses steps <= the directory's latest, so a
        # fresh (non-resume) run over an old checkpoint dir would silently
        # persist NOTHING while overwriting the metrics series — clear it,
        # matching the metrics-artifact overwrite semantics.
        import shutil

        shutil.rmtree(ckpt_dir)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("ckpt_dir_cleared")
    ckpt = Checkpointer(ckpt_dir)

    state = trainer.init()
    if resume and ckpt.latest_step() is not None:
        try:
            state = ckpt.restore(state)
        except ValueError:
            # optimizer-state layout changed (e.g. an Adam run resumed with
            # --optimizer minsr): keep params + step, re-init the optimizer
            from ..vmc.trainer import TrainState

            params, step_arr = ckpt.restore_params_and_step(state)
            opt_state = trainer.optimizer.init(params)
            try:
                # fast-forward the transform counts so LR SCHEDULES resume
                # at the restored step instead of re-applying the full base
                # rate to a converged wavefunction (Adam's bias correction
                # also reads count; with zero moments that only makes the
                # first resumed updates gentler)
                import optax.tree_utils as otu

                opt_state = otu.tree_set(
                    opt_state, count=step_arr.astype(step_arr.dtype)
                )
            except (KeyError, ValueError):
                pass  # no count field (e.g. constant-schedule sgd)
            state = TrainState(
                params=params, opt_state=opt_state, step=step_arr
            )
            if primary:
                print(
                    "checkpoint optimizer state layout differs from the "
                    "configured optimizer; restored params + step, "
                    "re-initialized the optimizer state (moments zeroed, "
                    "schedule count fast-forwarded to the restored step)"
                )
    key = jax.random.PRNGKey(trainer.config.seed)

    start = int(state.step)
    if resume:
        # The checkpoint step counter is the source of truth; the .npy series
        # flushes more often than checkpoints save, so on an interrupted run
        # it can be ahead — drop the already-recorded steps we will re-train.
        metrics.truncate(start)

    # parameter printout, as the reference does at startup
    # (TrainingRNN_1DTFIM.py:127-136)
    from ..utils.summary import summarize_params

    if primary:
        print(summarize_params(state.params))

    trace_started = False
    try:
        it = start
        while it <= num_steps:
            # block ends at the next log_every multiple (so the freshest
            # metrics entry at block end is exactly the logging step) and
            # never runs past a checkpoint step (the saved state must be
            # exactly the ckpt_every-step state, not the block-end state)
            stop = ((it + log_every - 1) // log_every) * log_every
            if ckpt_every:
                stop = min(
                    stop, ((it + ckpt_every - 1) // ckpt_every) * ckpt_every
                )
            block = min(stop, num_steps) - it + 1

            if profile_dir is not None and not trace_started and it > start:
                jax.profiler.start_trace(profile_dir)
                trace_started = True
            state, ms = trainer.run_steps(state, key, block)
            _append_block(metrics, ms)
            if trace_started:
                jax.profiler.stop_trace()
                trace_started = False
                profile_dir = None  # one traced block is enough

            last = it + block - 1
            if primary and last % log_every == 0:
                metrics.print_line(last, trainer.config.num_samples)
                metrics.log_jsonl(last)
            if primary and any(
                (it + j) % save_every == 0 for j in range(block)
            ):
                metrics.flush_npy()
            if ckpt_every and last % ckpt_every == 0 and last > start:
                ckpt.save(state)
            it += block
    finally:
        if trace_started:
            jax.profiler.stop_trace()

    ckpt.save(state)
    ckpt.wait()
    if primary:
        metrics.flush_npy()
    return state, metrics.mean_energy, metrics.var_energy
