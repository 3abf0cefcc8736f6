"""CLI: evaluate a trained checkpoint — energies, variance, magnetization.

The measurement/serving story: restore a checkpoint saved by any of the
training CLIs, draw fresh Monte-Carlo batches, and report the energy
estimate with the notebook error-bar convention plus magnetization — the
reference's equivalent is rerunning the trainer with the "Loading previous
trainings" block uncommented (``TrainingRNN_1DTFIM.py:172-183``) just to
measure.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import jax
import numpy as np

from .. import (
    CRNNU1, J1J2, MDRNN2D, PRNN1D, PRNNSnake2D, TFIM1D, TFIM2D,
    TrainConfig, VMCTrainer, make_mesh,
)
from ..utils.checkpoints import Checkpointer
from ..vmc.observables import energy_estimate
from ..utils import compile_cache
from .run_loop import resolve_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", help="checkpoint directory (ckpt_<tag>)")
    p.add_argument("--workload", required=True,
                   choices=["1dtfim", "2dtfim-1drnn", "2dtfim-2drnn", "j1j2"])
    p.add_argument("--systemsize", type=int, default=20)
    p.add_argument("--systemsize-x", type=int, default=4)
    p.add_argument("--systemsize-y", type=int, default=4)
    # default follows the TRAINING runner of the chosen workload (1.0 for
    # the 1D chain, 3.0 for both 2D runners — run_2dtfim_*.py): a single
    # flat default silently evaluated 2D checkpoints against the wrong
    # Hamiltonian.
    p.add_argument("--bx", type=float, default=None)
    p.add_argument("--j1", type=float, default=1.0)
    p.add_argument("--j2", type=float, default=0.2)
    p.add_argument("--bz", type=float, default=0.0)
    p.add_argument("--marshall-sign", action="store_true")
    p.add_argument("--periodic", action="store_true")
    p.add_argument("--num-units", type=int, default=50)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--parity", action="store_true")
    p.add_argument("--cell", type=str, default="gru",
                   choices=["gru", "lstm"],
                   help="recurrent cell the checkpoint was trained with "
                        "(must match, or the restore tree mismatches)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="compute dtype the checkpoint was trained with")
    p.add_argument("--matmul-precision", type=str, default="default",
                   choices=["default", "high", "highest"],
                   help="matmul precision for the measurement step "
                        "(match the training run's setting)")
    p.add_argument("--fidelity", action="store_true",
                   help="also report |<psi_theta|psi_0>|^2 against the exact "
                        "ground state (dense eigh to N=16, C++ Lanczos "
                        "vector to N=24)")
    p.add_argument("--numsamples", type=int, default=1024)
    p.add_argument("--chunk-size", type=int, default=None,
                   help="cap device-resident flip batches for the "
                        "off-diagonal observables (long chains: the "
                        "sigma_x flip batch is S*N x N without it)")
    p.add_argument("--num-batches", type=int, default=10)
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width for the measurement mesh "
                        "(same meaning as the training runners' --tp; "
                        "checkpoints restore across any dp/tp layout since "
                        "params are replicated full trees, so this is a "
                        "speed knob for wide models, not a restore "
                        "requirement.  With --observables the measurement "
                        "rides the plain per-device path on the replicated "
                        "params either way)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--observables", nargs="*", default=[],
                   choices=["sigma_x", "structure_factor", "renyi2"],
                   help="extra estimators: per-site <sigma^x_i> via "
                        "single-flip amplitude ratios, the static "
                        "structure factor at commensurate momenta (S(k) "
                        "for chains, the S(kx, ky) momentum grid for the "
                        "2D workloads), and/or the half-chain second Renyi "
                        "entanglement entropy (two-replica swap estimator)")
    return p


def build_problem(args):
    """Rebuild the (ansatz, hamiltonian) pair the checkpoint was trained
    with — the flags mirror the training CLIs' model-shaping options
    (``--cell``/``--dtype``/``--periodic``) so every run configuration the
    runners can produce restores without a pytree mismatch."""
    units = (args.num_units,) * args.num_layers
    dtype = resolve_dtype(args.dtype)
    if args.workload == "1dtfim":
        return (PRNN1D(num_sites=args.systemsize, units=units,
                       parity=args.parity, cell=args.cell,
                       dtype=dtype, accum_dtype=dtype),
                TFIM1D(num_sites=args.systemsize, bx=args.bx))
    if args.workload == "2dtfim-1drnn":
        return (PRNNSnake2D(nx=args.systemsize_x, ny=args.systemsize_y,
                            units=units, cell=args.cell,
                            dtype=dtype, accum_dtype=dtype),
                TFIM2D(nx=args.systemsize_x, ny=args.systemsize_y,
                       bx=args.bx, encoding="flat"))
    if args.workload == "2dtfim-2drnn":
        return (MDRNN2D(nx=args.systemsize_x, ny=args.systemsize_y,
                        units=args.num_units,
                        dtype=dtype, accum_dtype=dtype),
                TFIM2D(nx=args.systemsize_x, ny=args.systemsize_y,
                       bx=args.bx, encoding="grid"))
    return (CRNNU1(num_sites=args.systemsize, units=units,
                   cell=args.cell, dtype=dtype, accum_dtype=dtype),
            J1J2(num_sites=args.systemsize, j1=args.j1, j2=args.j2,
                 bz=args.bz, marshall_sign=args.marshall_sign,
                 periodic=args.periodic))


def _num_sites(args) -> int:
    if args.workload in ("2dtfim-1drnn", "2dtfim-2drnn"):
        return args.systemsize_x * args.systemsize_y
    return args.systemsize


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.bx is None:
        args.bx = 1.0 if args.workload == "1dtfim" else 3.0
    compile_cache.enable()
    if args.fidelity and _num_sites(args) > 24:
        # fail fast, BEFORE the measurement loop and before any 2^N
        # allocation could be attempted (dense eigh to N=16, the C++
        # two-pass Lanczos beyond)
        raise SystemExit(
            f"--fidelity needs an exact 2^N ground vector; "
            f"N={_num_sites(args)} > 24 (Lanczos bound)"
        )
    ansatz, ham = build_problem(args)
    if args.tp > 1:
        from ..parallel.tensor import make_tp_mesh_over

        mesh = make_tp_mesh_over(args.num_devices, args.tp)
    else:
        mesh = make_mesh(args.num_devices)
    trainer = VMCTrainer(
        ansatz, ham,
        TrainConfig(num_samples=args.numsamples,
                    chunk_size=args.chunk_size,
                    tp=args.tp,
                    matmul_precision=args.matmul_precision),
        mesh=mesh,
    )
    ckpt = Checkpointer(args.checkpoint)
    state = trainer.init()
    try:
        state = ckpt.restore(state)
    except ValueError:
        # checkpoint trained with a different optimizer than this
        # trainer's default template (e.g. --optimizer minsr): evaluation
        # only needs params + step
        params, step_arr = ckpt.restore_params_and_step(state)
        state = state._replace(params=params, step=step_arr)

    key = jax.random.PRNGKey(args.seed)
    extra = tuple(args.observables)
    means, varis, mags = [], [], []
    e_ims, sxs, sks, purities = [], [], [], []
    for b in range(args.num_batches):
        out = trainer.evaluate(state, jax.random.fold_in(key, b),
                               observables=extra)
        means.append(float(out["mean_energy"]))
        varis.append(float(out["var_energy"]))
        mags.append(float(out["magnetization"]))
        if "mean_energy_im" in out:
            e_ims.append(float(out["mean_energy_im"]))
        if "sigma_x" in out:
            sxs.append(np.asarray(out["sigma_x"]))
        if "structure_factor" in out:
            sks.append(np.asarray(out["structure_factor"]))
        if "renyi2_purity" in out:
            purities.append(float(out["renyi2_purity"]))
    est, err = energy_estimate(means, varis, args.numsamples,
                               window=args.num_batches)
    result = {
        "checkpoint": args.checkpoint,
        "step": int(state.step),
        "energy": est,
        "err_bar": err,
        "var_energy": float(np.mean(varis)),
        "magnetization": float(np.mean(mags)),
        "num_samples_total": args.numsamples * args.num_batches,
    }
    if e_ims:
        result["energy_im"] = float(np.mean(e_ims))
    if sxs:
        sx = np.mean(sxs, axis=0)
        result["sigma_x"] = [float(v) for v in sx]
        result["sigma_x_total"] = float(np.sum(sx))
    if sks:
        # 1D workloads: S(k) list over the N commensurate momenta;
        # 2D workloads: S(kx, ky) nested (Nx, Ny) momentum-grid lists
        result["structure_factor"] = np.mean(sks, axis=0).tolist()
    if purities:
        # average the purities across batches, -log once (S2 is a log of a
        # mean, not a mean of logs); scatter of per-batch purities -> error
        pur = np.asarray(purities)
        result["renyi2"] = float(-np.log(np.mean(pur)))
        if len(pur) > 1:
            result["renyi2_err"] = float(
                np.std(pur, ddof=1) / (np.sqrt(len(pur)) * np.mean(pur))
            )
    if args.fidelity:
        result.update(_ed_fidelity(args, ansatz, state.params))
    print(json.dumps(result))
    return result


def _ed_fidelity(args, ansatz, params):
    """Exact-diagonalization fidelity block: |<psi_theta|psi_0>|^2 plus the
    exact ground energy.  Dense eigh to N=16; 17..24 uses the C++ two-pass
    Lanczos ground vector (ed/native.py).  A validation surface the
    reference's tutorials approximate with an energy comparison only
    (Tutorial_1DTFIM.ipynb cell 18).  The N <= 24 bound is enforced in
    ``main`` before anything is measured or allocated."""
    from ..ed import exact
    from ..ed.fidelity import fidelity

    if _num_sites(args) <= 16:
        if args.workload == "1dtfim":
            h = exact.tfim1d_dense(args.systemsize, args.bx)
        elif args.workload in ("2dtfim-1drnn", "2dtfim-2drnn"):
            h = exact.tfim2d_dense(args.systemsize_x, args.systemsize_y,
                                   args.bx)
        else:
            h = exact.j1j2_dense(args.systemsize, j1=args.j1, j2=args.j2,
                                 periodic=args.periodic,
                                 marshall_sign=args.marshall_sign)
        e0, gs = exact.ground_state(h)
    else:
        try:
            from ..ed import native
        except ImportError as e:
            raise SystemExit(
                f"--fidelity at N>16 needs the native Lanczos oracle: {e}"
            )
        if args.workload == "1dtfim":
            e0, gs, _ = native.tfim1d_ground_state(args.systemsize, args.bx)
        elif args.workload in ("2dtfim-1drnn", "2dtfim-2drnn"):
            e0, gs, _ = native.tfim2d_ground_state(
                args.systemsize_x, args.systemsize_y, args.bx)
        else:
            e0, gs, _ = native.j1j2_ground_state(
                args.systemsize, j1=args.j1, j2=args.j2,
                periodic=args.periodic, marshall_sign=args.marshall_sign)
    return {
        # 16k-row chunks: at the default 2048 the 2^N basis sweep is 8192
        # dispatches at N=24; same chunk validate_anchors uses
        "fidelity": fidelity(ansatz, params, gs, chunk=1 << 14),
        "energy_exact": e0,
    }


if __name__ == "__main__":
    main()
