"""CLI: VMC with the complex U(1) cRNN on the 1D J1-J2 chain.

Defaults reproduce ``/root/reference/J1J2/run_j1j2.py:11`` (numsteps 3000,
N=10, J1=1, J2=0.2, Marshall off, 10 units, 200 samples, lr 5e-4, seed 111).
Unlike the reference, the ``--marshall-sign`` and ``--periodic`` flags are
wired correctly (the reference call swaps them, ``TrainingRNN_J1J2.py:118``;
SURVEY.md §2.2 quirk 1).
"""

from __future__ import annotations

import argparse

from .. import CRNNU1, J1J2, TrainConfig, VMCTrainer, make_mesh
from ..utils import compile_cache
from .run_loop import (
    add_schedule_flags,
    resolve_dtype,
    run_training,
    schedule_kwargs,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--numsteps", type=int, default=3000)
    p.add_argument("--systemsize", type=int, default=10)
    p.add_argument("--j1", type=float, default=1.0)
    p.add_argument("--j2", type=float, default=0.2)
    p.add_argument("--bz", type=float, default=0.0)
    p.add_argument("--marshall-sign", action="store_true")
    p.add_argument("--periodic", action="store_true")
    p.add_argument("--num-units", type=int, default=10)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--numsamples", type=int, default=200)
    p.add_argument("--learningrate", type=float, default=5e-4)
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
                   help="end-to-end compute dtype.  The reference runs "
                        "this family in complex64 over float32 trunks but "
                        "accumulates log-amps through float64-promoted "
                        "sums in the 1DTFIM sibling; float32 + Kahan-"
                        "compensated accumulation is the "
                        "default — float64 runs the jnp scans (no kernel) "
                        "for provable-parity runs")
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: shard the GRU trunk's "
                        "hidden dimension and both heads over a second "
                        "mesh axis (Megatron-style; devices used = dp x tp)")
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--workdir", type=str, default="Check_Points/J1J2")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None)
    add_schedule_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    if args.systemsize % 2:
        import warnings

        warnings.warn(
            "U(1) zero magnetization is impossible on an odd chain; the "
            "reference's mask semantics (baseline N//2-1, "
            "ComplexRNNwavefunction.py:85-93) pin the sampler to one "
            "arbitrary near-balanced sector and most configurations are "
            "out of support — odd --systemsize runs are not physically "
            "meaningful",
            stacklevel=1,
        )
    dtype = resolve_dtype(args.dtype)
    ansatz = CRNNU1(
        num_sites=args.systemsize,
        units=(args.num_units,) * args.num_layers,
        dtype=dtype,
        accum_dtype=dtype,
    )
    ham = J1J2(
        num_sites=args.systemsize,
        j1=args.j1,
        j2=args.j2,
        bz=args.bz,
        periodic=args.periodic,
        marshall_sign=args.marshall_sign,
    )
    config = TrainConfig(
        num_samples=args.numsamples,
        learning_rate=args.learningrate,
        **schedule_kwargs(args),
        chunk_size=args.chunk_size,
        seed=args.seed,
        optimizer=args.optimizer,
        sr_damping=args.sr_damping,
        sr_solver=args.sr_solver,
        sr_cg_iters=args.sr_cg_iters,
        matmul_precision=args.matmul_precision,
        tp=args.tp,
    )
    if args.tp > 1:
        from ..parallel.tensor import make_tp_mesh_over

        mesh = make_tp_mesh_over(args.num_devices, args.tp)
    else:
        mesh = make_mesh(args.num_devices)
    trainer = VMCTrainer(ansatz, ham, config, mesh=mesh)
    tag = (
        f"N{args.systemsize}_samp{args.numsamples}_lr{args.learningrate}"
        f"_complexGRURNN_J1J2{args.j2}_units_{args.num_units}x{args.num_layers}"
        f"_zeromag"
    )
    _, mean_e, var_e = run_training(
        trainer, args.numsteps, args.workdir, tag,
        resume=args.resume, profile_dir=args.profile_dir,
    )
    return mean_e, var_e


if __name__ == "__main__":
    main()
