"""Tutorial: 2D TFIM ground state with snake-pRNN and 2D-MDRNN wavefunctions.

Covers the reference's two 2D workloads (``2DTFIM_1DRNN/`` and
``2DTFIM_2DRNN/``) on a small lattice, validated against exact
diagonalization.

Run:  python examples/tutorial_2dtfim.py [--nx 3 --ny 3] [--numsteps 800]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rnnwavefunctions import (
    MDRNN2D, PRNNSnake2D, TFIM2D, TrainConfig, VMCTrainer,
)
from rnnwavefunctions.ed import exact


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--numsteps", type=int, default=800)
    p.add_argument("--nx", type=int, default=3)
    p.add_argument("--ny", type=int, default=3)
    p.add_argument("--bx", type=float, default=2.0)
    p.add_argument("--num-units", type=int, default=24)
    p.add_argument("--numsamples", type=int, default=256)
    p.add_argument("--seed", type=int, default=111)
    args = p.parse_args(argv)

    nx, ny = args.nx, args.ny
    assert nx * ny <= 16, "dense ED is 2^(Nx*Ny) — keep the lattice small"
    print(f"ED of the {nx}x{ny} TFIM (Bx={args.bx})...")
    e_exact = exact.ground_state_energy(exact.tfim2d_dense(nx, ny, args.bx))
    print(f"  E_exact = {e_exact:.8f}")

    results = {}
    for name, ansatz, enc in [
        ("snake-pRNN", PRNNSnake2D(nx=nx, ny=ny, units=(args.num_units,)),
         "flat"),
        ("2D-MDRNN", MDRNN2D(nx=nx, ny=ny, units=args.num_units), "grid"),
    ]:
        trainer = VMCTrainer(
            ansatz,
            TFIM2D(nx=nx, ny=ny, bx=args.bx, encoding=enc),
            TrainConfig(num_samples=args.numsamples, learning_rate=5e-3,
                        seed=args.seed),
        )
        state = trainer.init()
        key = jax.random.PRNGKey(args.seed)
        means, varis = [], []
        for _ in range(max(args.numsteps // 100, 1)):
            state, ms = trainer.run_steps(state, key, 100)
            means.extend(np.asarray(ms["mean_energy"]).tolist())
            varis.extend(np.asarray(ms["var_energy"]).tolist())
        w = min(100, len(means))
        est = float(np.mean(means[-w:]))
        err = float(np.sqrt(max(varis[-w:]) / (args.numsamples * w)))
        rel = abs(est - e_exact) / abs(e_exact)
        print(f"{name:12s}: E = {est:.6f} +- {err:.2e}  (rel err {rel:.2e})")
        results[name] = (est, err)
    return results, e_exact


if __name__ == "__main__":
    main()
