"""CLI: VMC with a snake-ordered 1D pRNN on the 2D TFIM.

Defaults reproduce ``/root/reference/2DTFIM_1DRNN/run_2dTFIM.py:10``
(numsteps 2*10^4, 4x4 lattice, Bx=3, 50 units, 500 samples, lr 1e-3, seed
333) including the ``lr/(1+it/10)`` host schedule
(``Training1DRNN_2DTFIM.py:229``).
"""

from __future__ import annotations

import argparse

from .. import PRNNSnake2D, TFIM2D, TrainConfig, VMCTrainer, make_mesh
from ..utils import compile_cache
from .run_loop import (
    resolve_dtype,
    run_training,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--numsteps", type=int, default=2 * 10**4)
    p.add_argument("--systemsize-x", type=int, default=4)
    p.add_argument("--systemsize-y", type=int, default=4)
    p.add_argument("--bx", type=float, default=3.0)
    p.add_argument("--num-units", type=int, default=50)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--cell", type=str, default="gru",
                   choices=["gru", "lstm"],
                   help="recurrent cell (the reference signature defaults "
                        "this family to LSTM; its shipped runner passes "
                        "GRU — both ride the rollout kernel on a GPU)")
    p.add_argument("--numsamples", type=int, default=500)
    p.add_argument("--learningrate", type=float, default=1e-3)
    p.add_argument("--decay-scale", type=float, default=10.0,
                   help="1/((1/lr)+(step/scale)) harmonic schedule scale")
    p.add_argument("--seed", type=int, default=333)
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
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="end-to-end compute dtype.  The reference runs this "
                        "family in float64 (2DTFIM_1DRNN/RNNwavefunction.py:"
                        "38); float32 + Kahan-compensated accumulation is "
                        "the default and meets the published "
                        "anchors — float64 runs the jnp scans (no kernel) "
                        "for bit-level reference semantics")
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--workdir", type=str, default="Check_Points/2DTFIM")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    dtype = resolve_dtype(args.dtype)
    ansatz = PRNNSnake2D(
        nx=args.systemsize_x,
        ny=args.systemsize_y,
        units=(args.num_units,) * args.num_layers,
        cell=args.cell,
        dtype=dtype,
        accum_dtype=dtype,
    )
    ham = TFIM2D(
        nx=args.systemsize_x, ny=args.systemsize_y, bx=args.bx, encoding="flat"
    )
    config = TrainConfig(
        num_samples=args.numsamples,
        learning_rate=args.learningrate,
        schedule="harmonic",
        decay_scale=args.decay_scale,
        chunk_size=args.chunk_size,
        seed=args.seed,
        optimizer=args.optimizer,
        sr_damping=args.sr_damping,
        sr_solver=args.sr_solver,
        sr_cg_iters=args.sr_cg_iters,
        matmul_precision=args.matmul_precision,
    )
    trainer = VMCTrainer(ansatz, ham, config, mesh=make_mesh(args.num_devices))
    tag = (
        f"N{args.systemsize_x}x{args.systemsize_y}_samp{args.numsamples}"
        f"_Bx{args.bx}_GRURNN1D_OBC_2DTFIM_units_{args.num_units}x{args.num_layers}"
    )
    _, mean_e, var_e = run_training(
        trainer, args.numsteps, args.workdir, tag,
        resume=args.resume, profile_dir=args.profile_dir,
    )
    return mean_e, var_e


if __name__ == "__main__":
    main()
