"""Tutorial: 1D J1-J2 ground state with a complex U(1) cRNN, validated vs ED.

Script equivalent of ``Tutorials/J1J2/Tutorial_1DJ1J2.ipynb`` (cells 6-18):
exact-diagonalize a small chain (optionally Marshall-rotated), train the
cRNN wavefunction by VMC in the zero-magnetization sector, compare energies.

Run:  python examples/tutorial_j1j2.py [--numsteps 1500] [--systemsize 10]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rnnwavefunctions import CRNNU1, J1J2, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--numsteps", type=int, default=1500)
    p.add_argument("--systemsize", type=int, default=10)
    p.add_argument("--j2", type=float, default=0.2)
    p.add_argument("--marshall-sign", action="store_true", default=True)
    p.add_argument("--num-units", type=int, default=20)
    p.add_argument("--numsamples", type=int, default=256)
    p.add_argument("--seed", type=int, default=111)
    args = p.parse_args(argv)

    n = args.systemsize
    assert n % 2 == 0, "U(1) zero-magnetization sector needs even N"
    assert n <= 14, "exact diagonalization is dense 2^N — keep N <= 14"
    print(f"ED of the {n}-site J1-J2 chain (J2={args.j2}, "
          f"Marshall={args.marshall_sign})...")
    e_exact = exact.ground_state_energy(
        exact.j1j2_dense(n, 1.0, args.j2, marshall_sign=args.marshall_sign)
    )
    print(f"  E_exact = {e_exact:.8f}")

    trainer = VMCTrainer(
        CRNNU1(num_sites=n, units=(args.num_units,)),
        J1J2(num_sites=n, j1=1.0, j2=args.j2,
             marshall_sign=args.marshall_sign),
        TrainConfig(num_samples=args.numsamples, learning_rate=2e-3,
                    seed=args.seed),
    )
    state = trainer.init()
    key = jax.random.PRNGKey(args.seed)
    means, varis = [], []
    chunk = 50
    for start in range(0, args.numsteps, chunk):
        state, ms = trainer.run_steps(state, key, chunk)
        means.extend(np.asarray(ms["mean_energy"]).tolist())
        varis.extend(np.asarray(ms["var_energy"]).tolist())
        im = float(np.asarray(ms["mean_energy_im"])[-1])
        print(f"step {len(means):5d}: mean(E)={means[-1]:+.6f}{im:+.5f}i "
              f"var(E)={varis[-1]:.5f}")

    w = min(100, len(means))
    est = float(np.mean(means[-w:]))
    err = float(np.sqrt(max(varis[-w:]) / (args.numsamples * w)))
    rel = abs(est - e_exact) / abs(e_exact)
    print(f"\ncRNN energy estimate: {est:.8f} +- {err:.2e}")
    print(f"Exact energy:         {e_exact:.8f}")
    print(f"Relative error:       {rel:.2e}")
    return est, err, e_exact


if __name__ == "__main__":
    main()
