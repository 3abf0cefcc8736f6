"""Tutorial: 1D TFIM ground state with a pRNN wavefunction, validated vs ED.

Script equivalent of the reference's
``Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` acceptance flow (cells 6-18):
exact-diagonalize a small chain, train the RNN wavefunction by VMC, and
compare using the notebook's estimator convention
``mean(E[-100:]) +- sqrt(max(varE[-100:]) / (numsamples * 100))``.

Run:  python examples/tutorial_1dtfim.py [--numsteps 1000] [--systemsize 10]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact
from rnnwavefunctions.utils.summary import summarize_params


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--numsteps", type=int, default=1000)
    p.add_argument("--systemsize", type=int, default=10)
    p.add_argument("--bx", type=float, default=1.0)
    p.add_argument("--num-units", type=int, default=20)
    p.add_argument("--numsamples", type=int, default=256)
    p.add_argument("--seed", type=int, default=111)
    args = p.parse_args(argv)

    n = args.systemsize
    assert n <= 16, "exact diagonalization is dense 2^N — keep N <= 16"
    print(f"Exact diagonalization of the {n}-site TFIM (Bx={args.bx})...")
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, args.bx))
    print(f"  E_exact = {e_exact:.8f}")

    ansatz = PRNN1D(num_sites=n, units=(args.num_units,))
    trainer = VMCTrainer(
        ansatz,
        TFIM1D(num_sites=n, bx=args.bx),
        TrainConfig(num_samples=args.numsamples, learning_rate=5e-3,
                    seed=args.seed),
    )
    state = trainer.init()
    print(summarize_params(state.params))

    key = jax.random.PRNGKey(args.seed)
    means, varis = [], []
    chunk = 50
    for start in range(0, args.numsteps, chunk):
        state, ms = trainer.run_steps(state, key, chunk)
        means.extend(np.asarray(ms["mean_energy"]).tolist())
        varis.extend(np.asarray(ms["var_energy"]).tolist())
        print(f"step {len(means):5d}: mean(E)={means[-1]:+.6f} "
              f"var(E)={varis[-1]:.5f}")

    w = min(100, len(means))
    est = float(np.mean(means[-w:]))
    err = float(np.sqrt(max(varis[-w:]) / (args.numsamples * w)))
    rel = abs(est - e_exact) / abs(e_exact)
    print(f"\nRNN energy estimate: {est:.8f} +- {err:.2e}")
    print(f"Exact energy:        {e_exact:.8f}")
    print(f"Relative error:      {rel:.2e}")
    return est, err, e_exact


if __name__ == "__main__":
    main()
