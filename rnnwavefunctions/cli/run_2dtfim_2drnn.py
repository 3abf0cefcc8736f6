"""CLI: VMC with the 2D MDRNN wavefunction on the 2D TFIM.

Defaults reproduce ``/root/reference/2DTFIM_2DRNN/run_2dTFIM.py:10``
(numsteps 2*10^4, 4x4 lattice, Bx=3, 50 units, 500 samples, lr 5e-3, seed
111) including the ``lr/(1+it/5000)`` host schedule
(``Training2DRNN_2DTFIM.py:228``).  One RNN layer only, as in the reference
(``Training2DRNN_2DTFIM.py:97``).
"""

from __future__ import annotations

import argparse

from .. import MDRNN2D, TFIM2D, TrainConfig, VMCTrainer, make_mesh
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
    p.add_argument("--numsamples", type=int, default=500)
    p.add_argument("--learningrate", type=float, default=5e-3)
    p.add_argument("--decay-scale", type=float, default=5000.0)
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
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="end-to-end compute dtype.  The reference runs this "
                        "family in float64 (2DTFIM_2DRNN/RNNwavefunction.py:"
                        "32); float32 + Kahan-compensated accumulation is "
                        "the default and meets the published "
                        "anchors — float64 runs the jnp scans (no kernel) "
                        "for bit-level reference semantics")
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: shard the MDRNN hidden "
                        "dimension over a second mesh axis (all four cell "
                        "matrices column-sharded; devices used = dp x tp)")
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--workdir", type=str, default="Check_Points/2DTFIM")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    dtype = resolve_dtype(args.dtype)
    ansatz = MDRNN2D(
        nx=args.systemsize_x, ny=args.systemsize_y, units=args.num_units,
        dtype=dtype, accum_dtype=dtype,
    )
    ham = TFIM2D(
        nx=args.systemsize_x, ny=args.systemsize_y, bx=args.bx, encoding="grid"
    )
    config = TrainConfig(
        num_samples=args.numsamples,
        learning_rate=args.learningrate,
        schedule="inverse",
        decay_scale=args.decay_scale,
        chunk_size=args.chunk_size,
        seed=args.seed,
        optimizer=args.optimizer,
        sr_damping=args.sr_damping,
        sr_solver=args.sr_solver,
        sr_cg_iters=args.sr_cg_iters,
        tp=args.tp,
        matmul_precision=args.matmul_precision,
    )
    if args.tp > 1:
        from ..parallel.tensor import make_tp_mesh_over

        mesh = make_tp_mesh_over(args.num_devices, args.tp)
    else:
        mesh = make_mesh(args.num_devices)
    trainer = VMCTrainer(ansatz, ham, config, mesh=mesh)
    tag = (
        f"N{args.systemsize_x}x{args.systemsize_y}_samp{args.numsamples}"
        f"_Bx{args.bx}_MDRNN_OBC_2DTFIM_units_{args.num_units}"
    )
    _, mean_e, var_e = run_training(
        trainer, args.numsteps, args.workdir, tag,
        resume=args.resume, profile_dir=args.profile_dir,
    )
    return mean_e, var_e


if __name__ == "__main__":
    main()
