"""CLI: VMC with a 1D pRNN on the 1D TFIM.

Defaults reproduce the reference runner
(``/root/reference/1DTFIM/run_1dTFIM.py:9``: numsteps 10^3, N=20, Bx=1,
50 units x 1 layer, 500 samples, lr 5e-3, seed 111), upgraded with a real
flag system (the reference has none; SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import argparse

from .. import PRNN1D, TFIM1D, TrainConfig, VMCTrainer, make_mesh
from ..utils import compile_cache
from .run_loop import (
    add_schedule_flags,
    resolve_dtype,
    run_training,
    schedule_kwargs,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--numsteps", type=int, default=10**3)
    p.add_argument("--systemsize", type=int, default=20)
    p.add_argument("--bx", type=float, default=1.0)
    p.add_argument("--num-units", type=int, default=50)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--cell", type=str, default="gru",
                   choices=["gru", "lstm"],
                   help="recurrent cell (both ride the rollout kernel on "
                        "a GPU)")
    p.add_argument("--numsamples", type=int, default=500)
    p.add_argument("--learningrate", type=float, default=5e-3)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "minsr"],
                   help="parameter update rule: the reference's Adam, or "
                        "minSR — stochastic reconfiguration / natural "
                        "gradient solved in sample space (vmc/minsr.py; "
                        "typically 10-50x fewer steps per error decade at "
                        "a higher per-step cost)")
    p.add_argument("--sr-damping", type=float, default=1e-2,
                   help="SR diagonal shift (only with --optimizer minsr)")
    p.add_argument("--sr-solver", type=str, default="cg",
                   choices=["cg", "chol"],
                   help="SR sample-space solver: conjugate gradient "
                        "(default) or exact Cholesky")
    p.add_argument("--sr-cg-iters", type=int, default=64,
                   help="CG iterations for --sr-solver cg")
    p.add_argument("--matmul-precision", type=str, default="default",
                   choices=["default", "high", "highest"],
                   help="matmul precision for the whole jitted step "
                        "('highest' keeps float32 products out of TF32 on a "
                        "GPU)")
    p.add_argument("--parity", action="store_true",
                   help="parity-symmetrized density (RNNwavefunction_paritysym)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="end-to-end compute dtype.  The reference "
                        "accumulates this family's log-probs in float64 "
                        "(1DTFIM/RNNwavefunction.py:113-116); float32 + "
                        "Kahan-compensated accumulation is the "
                        "default and meets the published anchors — float64 "
                        "runs the jnp scans (no kernel) for "
                        "bit-level reference semantics")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel mesh size (default: all devices)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: shard the GRU hidden "
                        "dimension over a second mesh axis (Megatron-style; "
                        "devices used = dp x tp)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="max rows per log-amplitude evaluation batch")
    p.add_argument("--workdir", type=str, default="Check_Points/1DTFIM")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None)
    add_schedule_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    dtype = resolve_dtype(args.dtype)
    ansatz = PRNN1D(
        num_sites=args.systemsize,
        units=(args.num_units,) * args.num_layers,
        parity=args.parity,
        cell=args.cell,
        dtype=dtype,
        accum_dtype=dtype,
    )
    ham = TFIM1D(num_sites=args.systemsize, bx=args.bx)
    config = TrainConfig(
        num_samples=args.numsamples,
        learning_rate=args.learningrate,
        **schedule_kwargs(args),
        chunk_size=args.chunk_size,
        tp=args.tp,
        seed=args.seed,
        optimizer=args.optimizer,
        sr_damping=args.sr_damping,
        sr_solver=args.sr_solver,
        sr_cg_iters=args.sr_cg_iters,
        matmul_precision=args.matmul_precision,
    )
    if args.tp > 1:
        from ..parallel.tensor import make_tp_mesh_over

        mesh = make_tp_mesh_over(args.num_devices, args.tp)
    else:
        mesh = make_mesh(args.num_devices)
    trainer = VMCTrainer(ansatz, ham, config, mesh=mesh)
    sym = "_paritysym" if args.parity else ""
    # reference filename parity for the default GRU (TrainingRNN_1DTFIM.py:146);
    # non-default cells get their own artifact namespace so an --cell lstm
    # run cannot collide with a GRU run's checkpoints/series
    cellname = "GRURNN" if args.cell == "gru" else f"{args.cell.upper()}RNN"
    tag = (
        f"N{args.systemsize}_samp{args.numsamples}_Jz1Bx{args.bx}"
        f"_{cellname}_OBC_TFIM_units_{args.num_units}x{args.num_layers}{sym}"
    )
    _, mean_e, var_e = run_training(
        trainer, args.numsteps, args.workdir, tag,
        resume=args.resume, profile_dir=args.profile_dir,
    )
    return mean_e, var_e


if __name__ == "__main__":
    main()
