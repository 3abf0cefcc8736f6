"""Generate the tutorial notebooks (the reference L5 deliverable format:
``Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` and
``Tutorials/J1J2/Tutorial_1DJ1J2.ipynb`` are runnable 25/26-cell guided
Colab documents; these mirror their full narrative arc — pedagogical
introduction, ED oracle with the 2^N caveat, a "representing the ground
state" amplitude plot with the sign-structure discussion that motivates the
ansatz choice, small-N VMC training, comparison with the notebook error-bar
convention, energy/variance convergence plots, and an Explorations section
with the DMRG anchors — on this package's API).  Run this script to
(re)emit ``examples/Tutorial_1DTFIM.ipynb`` and
``examples/Tutorial_1DJ1J2.ipynb``; tests/test_tutorials.py executes every
code cell.
"""

import json
import os

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")


def md(source: str):
    return {"cell_type": "markdown", "metadata": {},
            "source": source.splitlines(keepends=True)}


def code(source: str):
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "outputs": [], "source": source.splitlines(keepends=True)}


def notebook(cells):
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


COMMON_SETUP = """\
import os, sys
if os.path.exists(os.path.join("..", "rnnwavefunctions")):
    sys.path.insert(0, "..")  # running from examples/

import jax
import jax.numpy as jnp
import numpy as np
import matplotlib
import matplotlib.pyplot as plt
"""

TFIM_CELLS = [
    md("""\
# Tutorial: 1D TFIM ground state with an RNN wavefunction
"""),
    md("""\
**This notebook walks through the full workflow of finding a quantum
many-body ground state with an RNN wavefunction trained by Variational
Monte Carlo (VMC), validated against Exact Diagonalization (ED).**  It is
the JAX counterpart of the reference tutorial
(`Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`, Hibat-Allah et al., Phys. Rev.
Research 2, 023358 (2020)).

The model is the open-boundary **transverse-field Ising chain**

$$H = -\\sum_{i=1}^{N-1} \\sigma^z_i \\sigma^z_{i+1}
      - B_x \\sum_{i=1}^{N} \\sigma^x_i ,$$

a paradigmatic quantum phase transition: at $B_x = 0$ the ground state is a
classical ferromagnet, at $B_x \\to \\infty$ it is a product state polarized
along $x$, and at the critical point $B_x = 1$ quantum fluctuations make the
state genuinely entangled — the interesting regime for a variational method.

You will:

1. compute the exact ground state for small $N$ by dense diagonalization,
2. look at its amplitudes to understand *why* a **positive** wavefunction
   ansatz suffices here,
3. train a positive RNN wavefunction $\\psi(\\sigma) = \\sqrt{p(\\sigma)}$
   by VMC and compare against ED,
4. see where the DMRG anchors for large $N$ live for production runs.

The whole VMC step (autoregressive sampling, all $N$ spin-flip amplitude
ratios, gradient, Adam update) runs inside one jitted program; on a GPU
the GRU rollouts take a Pallas kernel, on the CPU the very same API runs
the `lax.scan` reference path — this notebook runs anywhere.
"""),
    code(COMMON_SETUP + """\
from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact
from rnnwavefunctions.vmc.observables import energy_estimate

N = 10           # sites (keep <= 16: the ED oracle is dense 2^N)
BX = 1.0         # transverse field (the critical point)
NUM_UNITS = 20
NUM_SAMPLES = 256
NUM_STEPS = 800
"""),
    md("""\
## Calculating the ground state energy using Exact Diagonalization

For small systems we can write $H$ as a dense $2^N \\times 2^N$ matrix in
the $\\sigma^z$ product basis and diagonalize it exactly.  Each basis state
is a bit-string $\\sigma = (\\sigma_1, \\dots, \\sigma_N)$; the
$\\sigma^z\\sigma^z$ bonds are diagonal (each aligned/anti-aligned
neighbor pair contributes $\\mp 1$), while each $\\sigma^x_i$ connects
$\\sigma$ to the configuration with spin $i$ flipped, with matrix element
$-B_x$.  This is the same construction as the reference notebook's
`ED_1DTFIM` cell.
"""),
    code("""\
H = exact.tfim1d_dense(N, BX)
e_exact, gs = exact.ground_state(H)
print(f"E_exact = {e_exact:.8f}")
"""),
    md("""\
Exact diagonalization is exponential: the matrix has $4^N$ entries, so the
dense oracle is practical up to $N \\approx 14$–16.  This repo also ships a
matrix-free C++ Lanczos oracle (`ed/native.py`) that reaches $N \\sim 24$ —
beyond that, only variational methods (VMC, DMRG) survive, which is the
whole point of the RNN wavefunction.
"""),
    md("""\
## Representing the ground state

It is instructive to look at the exact ground-state vector itself: the
amplitude $\\langle \\sigma | \\Psi_0 \\rangle$ of every one of the $2^N$
basis configurations.
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.plot(gs * np.sign(gs.sum()), lw=0.8)
ax.set_xlabel(r"configuration index (bit-string $\\sigma$)")
ax.set_ylabel(r"$\\langle\\sigma|\\Psi_0\\rangle$")
ax.set_title("Ground-state amplitudes in the $z$-basis")
print(f"min amplitude = {(gs * np.sign(gs.sum())).min():.3e}")
"""),
    md("""\
**All the amplitudes have the same sign.**  That is not an accident: $H$
has non-positive off-diagonal elements in this basis, so by the
Perron-Frobenius theorem its ground state can be chosen with strictly
positive amplitudes (the model is *stoquastic*).  We can therefore write

$$\\Psi_0(\\sigma) = \\sqrt{p(\\sigma)}$$

for a probability distribution $p$ — a **positive RNN wavefunction**
(pRNN), where an autoregressive RNN models
$p(\\sigma) = \\prod_n p(\\sigma_n \\mid \\sigma_{<n})$.  Compare the J1-J2
companion tutorial, where the amplitudes change sign and the ansatz must
be complex.
"""),
    md("""\
## Calculating the ground state energy using an RNN wavefunction

The pRNN is a GRU that sweeps the chain once: at site $n$ it consumes the
one-hot of the previous spin, updates its hidden state, and emits a softmax
over $\\sigma_n \\in \\{\\uparrow,\\downarrow\\}$.  Because the density is
autoregressive and normalized by construction, we can draw **exact,
uncorrelated** samples in a single sweep — no Markov chain, no
autocorrelation time.

Training is standard VMC: the energy estimator

$$E_{loc}(\\sigma) = \\sum_{\\sigma'}
  H_{\\sigma\\sigma'}\\,\\frac{\\psi(\\sigma')}{\\psi(\\sigma)}$$

is averaged over samples, and the gradient uses the REINFORCE-style
surrogate $\\mathrm{mean}(\\log p \\cdot E_{loc}) -
\\mathrm{mean}(E_{loc})\\,\\mathrm{mean}(\\log p)$, whose baseline term
kills the gradient variance.  For the TFIM, $\\sigma'$ ranges over
$\\sigma$ itself (diagonal bonds) plus the $N$ single-spin flips.

Everything below — sampling, the $N{+}1$ amplitude evaluations, the
gradient, the Adam update — is **one jitted program per
`run_steps` block**; the reference round-tripped every batch through host
NumPy and chunked `sess.run` feeds.
"""),
    code("""\
trainer = VMCTrainer(
    PRNN1D(num_sites=N, units=(NUM_UNITS,)),
    TFIM1D(num_sites=N, bx=BX),
    TrainConfig(num_samples=NUM_SAMPLES, learning_rate=5e-3, seed=111),
)
state = trainer.init()
key = jax.random.PRNGKey(111)

mean_energy, var_energy = [], []
block = 50  # steps per device dispatch (one lax.scan)
for it in range(0, NUM_STEPS, block):
    state, ms = trainer.run_steps(state, key, block)
    mean_energy.extend(np.asarray(ms["mean_energy"]).tolist())
    var_energy.extend(np.asarray(ms["var_energy"]).tolist())
    print(f"step {it + block:5d}  mean(E) = {mean_energy[-1]:+.6f}  "
          f"var(E) = {var_energy[-1]:.4f}")
"""),
    md("""\
## Comparison of RNN results with ED

The reference notebook's estimator convention (its cell 18): average the
last 100 recorded steps, with the statistical error bar

$$E \\approx \\mathrm{mean}(E_{[-100:]}) \\pm
\\sqrt{\\max(\\mathrm{var}E_{[-100:]}) / (100\\,S)} .$$
"""),
    code("""\
est, err = energy_estimate(mean_energy, var_energy, NUM_SAMPLES, window=100)
rel = abs(est - e_exact) / abs(e_exact)
print(f"VMC estimate : {est:.8f} +- {err:.1e}")
print(f"ED reference : {e_exact:.8f}")
print(f"rel. error   : {rel:.2e}")
assert rel < 5e-3, "training did not converge to the ED energy"
"""),
    md("""\
The variational energies converge from **above** — the variational
principle guarantees $\\langle H \\rangle_\\theta \\ge E_0$ at every step,
so the training curve is also a rigorous upper bound:
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.plot(mean_energy, lw=0.8, label="VMC energy")
ax.axhline(e_exact, ls="--", c="k", label="ED")
ax.set_xlabel("VMC step")
ax.set_ylabel(r"$\\langle H \\rangle$")
ax.legend()
"""),
    md("""\
### Energy variance

The variance $\\mathrm{var}(E_{loc})$ is the sharper convergence
diagnostic: an *exact* eigenstate has $E_{loc}(\\sigma) = E_0$ for every
$\\sigma$, hence **zero variance** — unlike the energy, it needs no
reference value to interpret.
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.semilogy(np.maximum(np.asarray(var_energy), 1e-12), lw=0.8)
ax.set_xlabel("VMC step")
ax.set_ylabel(r"$\\mathrm{var}(E_{loc})$")
"""),
    md("""\
### Wavefunction fidelity

An energy match can hide errors on low-weight configurations; the overlap
with the exact ground state,
$F = |\\langle \\psi_\\theta | \\psi_0 \\rangle|^2$, checks the **whole**
wavefunction at once (dense $2^N$ basis, so small $N$ only — the reference
notebooks stop at the energy comparison):
"""),
    code("""\
from rnnwavefunctions.ed.fidelity import fidelity

F = fidelity(trainer.ansatz, state.params, gs)
print(f"fidelity |<psi_theta|psi_0>|^2 = {F:.6f}")
assert 0.5 < F <= 1.0 + 1e-9
"""),
    md("""\
### Entanglement: the second Rényi entropy

At the critical point the ground state is genuinely entangled, and the RNN
wavefunction gives direct access to that too.  The **swap trick** (the
replica estimator used for Fig. 5 of the reference paper) needs only
*amplitude ratios* of pairs of independent samples: with
$\\sigma, \\tau \\sim |\\psi|^2$ and $\\sigma', \\tau'$ obtained by swapping
the subsystem-$A$ spins between them,

$$\\mathrm{Tr}\\,\\rho_A^2 =
  \\mathbb{E}\\!\\left[\\frac{\\psi(\\sigma')\\,\\psi(\\tau')}
                        {\\psi(\\sigma)\\,\\psi(\\tau)}\\right],
  \\qquad S_2 = -\\log \\mathrm{Tr}\\,\\rho_A^2 .$$

For small $N$ we can check the estimator against the exact reduced density
matrix of the ED ground state:
"""),
    code("""\
from rnnwavefunctions.vmc.observables import renyi2_entropy
from rnnwavefunctions.ed.exact import renyi2_exact

region = list(range(N // 2))          # half-chain cut
ka, kb = jax.random.split(jax.random.PRNGKey(7))
SA = trainer.ansatz.sample(state.params, ka, 2048)
SB = trainer.ansatz.sample(state.params, kb, 2048)
s2_mc = float(renyi2_entropy(trainer.ansatz, state.params, SA, SB, region))
s2_ed = renyi2_exact(gs, N, region)
print(f"S2 (swap estimator) = {s2_mc:.4f}")
print(f"S2 (exact)          = {s2_ed:.4f}")
assert abs(s2_mc - s2_ed) < 0.15, "swap estimator far from the exact S2"
"""),
    md("""\
(The estimator variance grows as $e^{S_2}$, so near-maximal entropies need
large batches; at a half-chain cut of a critical chain this size is cheap.
From a trained checkpoint the same measurement is
`python -m rnnwavefunctions.cli.evaluate --observables renyi2`.)
"""),
    md("""\
### Faster convergence: stochastic reconfiguration (minSR)

Everything above used Adam, like the reference.  This framework also ships
**stochastic reconfiguration** (natural-gradient VMC): precondition the
energy gradient with the quantum geometric tensor
$S_{kl} = \\mathrm{Re}\\langle \\bar O_k^* \\bar O_l \\rangle$,
$O_k = \\partial_{\\theta_k} \\log\\psi$, which follows imaginary-time
projection instead of raw gradient flow.  The solve is recast into *sample
space* (an $S\\times S$ Cholesky instead of a parameter-space inverse —
`vmc/minsr.py`), so it stays cheap for large networks.  Same step budget,
head-to-head:
"""),
    code("""\
curves = {}
for opt, lr in [("adam", 5e-3), ("minsr", 5e-2)]:
    tr = VMCTrainer(
        PRNN1D(num_sites=N, units=(NUM_UNITS,)),
        TFIM1D(num_sites=N, bx=BX),
        TrainConfig(num_samples=NUM_SAMPLES, learning_rate=lr,
                    optimizer=opt, seed=111),
    )
    st, ms = tr.run_steps(tr.init(), jax.random.PRNGKey(111), 60)
    curves[opt] = np.asarray(ms["mean_energy"])

fig, ax = plt.subplots(figsize=(10, 4))
for opt, es in curves.items():
    ax.semilogy(np.abs((es - e_exact) / e_exact), lw=1.0, label=opt)
ax.set_xlabel("VMC step")
ax.set_ylabel("relative energy error")
ax.legend()
err_adam = abs(curves["adam"][-10:].mean() - e_exact) / abs(e_exact)
err_minsr = abs(curves["minsr"][-10:].mean() - e_exact) / abs(e_exact)
print(f"after 60 steps: adam {err_adam:.2e}  minsr {err_minsr:.2e}")
assert err_minsr < err_adam, "minSR should outpace Adam step-for-step"
"""),
    md("""\
(minSR typically buys an order of magnitude fewer steps per error decade;
per-step cost is higher — the per-sample jacobian — so compare
wall-clock too before choosing it.  From the CLI: `--optimizer minsr`.)
"""),
    md("""\
## Explorations

- **Parity symmetry.**  The TFIM ground state is reflection-symmetric, but
  an autoregressive density has a left-to-right bias.
  `PRNN1D(..., parity=True)` symmetrizes the density —
  $\\log \\tfrac12\\!\\left(p(\\sigma) + p(\\tilde\\sigma)\\right)$ with
  $\\tilde\\sigma$ the reflected configuration — which measurably improves
  the energy at fixed network size.  Try it.
- **Sweep the field.**  Repeat at $B_x = 0.5$ and $B_x = 2$; away from the
  critical point convergence is much faster.  Plot the final energy vs
  $B_x$.
- **Large systems.**  The pRNN cost is linear in $N$.  DMRG ground-state
  energies for validating production runs
  (`python -m rnnwavefunctions.cli.run_1dtfim --systemsize 100 ...`):

| N | E(DMRG) |
|---|---------|
| 20 | -25.1077971081 |
| 30 | -37.8380982304 |
| 40 | -50.5694337844 |
| 50 | -63.3011891370 |
| 60 | -76.0331561023 |
| 70 | -88.7652446334 |
| 80 | -101.4974094169 |
| 90 | -114.2296251736 |
| 100 | -126.9618766964 |
| 1000 | -1272.8762945220 |

- **Scale out.**  `--tp` shards the hidden dimension (Megatron-style) and
  the trainer data-parallelizes chains over any `jax.sharding.Mesh` —
  see `parallel/` and the "Parallelism" paragraph of the README.
"""),
]

J1J2_CELLS = [
    md("""\
# Tutorial: 1D J1-J2 ground state with a complex RNN wavefunction
"""),
    md("""\
**This notebook extends the TFIM tutorial to a *frustrated* spin model
whose ground state has a non-trivial sign structure**, requiring a
*complex* RNN wavefunction (cRNN).  It is the JAX counterpart of the
reference tutorial (`Tutorials/J1J2/Tutorial_1DJ1J2.ipynb`).

The model is the spin-$\\tfrac12$ **J1-J2 Heisenberg chain**

$$H = J_1 \\sum_i \\mathbf{S}_i \\cdot \\mathbf{S}_{i+1}
    + J_2 \\sum_i \\mathbf{S}_i \\cdot \\mathbf{S}_{i+2},$$

with antiferromagnetic nearest- and next-nearest-neighbor couplings that
*compete*: no spin arrangement satisfies both, which is what "frustration"
means.  The phase diagram is rich — at $J_2/J_1 = 0.5$ (the
Majumdar-Ghosh point) the ground state is an exact dimer product with
energy $-\\tfrac{3}{8} N J_1$, and beyond $J_2/J_1 \\approx 0.2411$ the
chain spontaneously dimerizes.

You will:

1. diagonalize small chains exactly,
2. inspect the ground-state amplitudes — they **change sign**, so a
   positive ansatz cannot represent them,
3. train a complex RNN wavefunction with an exact U(1) symmetry
   constraint and compare against ED.
"""),
    code(COMMON_SETUP + """\
from rnnwavefunctions import CRNNU1, J1J2, TrainConfig, VMCTrainer
from rnnwavefunctions.ed import exact
from rnnwavefunctions.vmc.observables import energy_estimate

N = 10
J2 = 0.2
NUM_UNITS = 16
NUM_SAMPLES = 256
NUM_STEPS = 1000
"""),
    md("""\
## Calculating the ground state energy using Exact Diagonalization

In the $\\sigma^z$ basis the Ising parts
$S^z_i S^z_j = \\tfrac14 \\sigma^z_i \\sigma^z_j$ are diagonal, while the
transverse parts $\\tfrac12(S^+_i S^-_j + S^-_i S^+_j)$ **exchange** every
anti-aligned spin pair — each configuration connects to at most $2N$
others (NN and NNN exchanges).  Small chains diagonalize densely, exactly
as in the reference notebook's `ED_j1j2` cell.
"""),
    code("""\
H = exact.j1j2_dense(N, 1.0, J2)
e_exact, gs = exact.ground_state(H)
print(f"E_exact = {e_exact:.8f}")
"""),
    md("""\
## Representing the ground state

Plot the exact amplitudes over the $2^N$ basis configurations:
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.plot(gs * np.sign(gs[np.abs(gs).argmax()]), lw=0.8)
ax.set_xlabel(r"configuration index (bit-string $\\sigma$)")
ax.set_ylabel(r"$\\langle\\sigma|\\Psi_0\\rangle$")
ax.set_title("Ground-state amplitudes in the $z$-basis")
neg = (gs * np.sign(gs[np.abs(gs).argmax()]) < -1e-12).sum()
print(f"{neg} of {gs.size} amplitudes are negative")
"""),
    md("""\
**The amplitudes change sign** — the antiferromagnetic exchange has
*positive* off-diagonal matrix elements, so Perron-Frobenius does not
apply and the ground state is not expressible as $\\sqrt{p(\\sigma)}$.
Two standard remedies, both used here:

- a **Marshall sign rule** gauge transformation (exact at $J_2 = 0$,
  helpful for small $J_2$) that rotates away the *known* part of the sign
  structure — note the reference code's `Marshall_sign` flag silently
  landed in its `periodic` parameter (`TrainingRNN_J1J2.py:118`); both
  flags are wired correctly in this package and the divergence is
  documented;
- a genuinely **complex wavefunction**
  $\\psi(\\sigma) = \\sqrt{p(\\sigma)}\\, e^{i\\phi(\\sigma)}$ — the cRNN:
  a shared GRU trunk with two heads, one for the modulus (square-root
  softmax) and one for the phase ($\\pi \\cdot \\mathrm{softsign}$).

The Heisenberg model also conserves total $S^z$ (U(1) symmetry) and the
ground state lives in the zero-magnetization sector.  The cRNN builds this
in **exactly**: once a sample has used up its budget of up or down spins,
the offending conditional probabilities are masked to zero and
renormalized (the reference's heavyside masking, preserved bit-for-bit).
Every sample the ansatz ever draws has $\\sum_i \\sigma_i = N/2$.
"""),
    md("""\
## Calculating the ground state energy using an RNN wavefunction

For a complex ansatz the surrogate loss becomes
$2\\,\\mathrm{Re}\\!\\left[\\mathrm{mean}(\\overline{\\log\\psi}\\,E_{loc})
- \\overline{\\mathrm{mean}(\\log\\psi)}\\,\\mathrm{mean}(E_{loc})\\right]$
with $E_{loc}$ held out of the differentiation.  The local energies
contract all $\\le 2N$ spin-exchange configurations per sample in-graph —
padded to a static bound with validity masks, so every array has a static
shape.  The entire hot path carries log psi as (Re, Im) pairs of reals
instead of complex numbers — mathematically identical.
"""),
    code("""\
trainer = VMCTrainer(
    CRNNU1(num_sites=N, units=(NUM_UNITS,)),
    J1J2(num_sites=N, j1=1.0, j2=J2),
    TrainConfig(num_samples=NUM_SAMPLES, learning_rate=2e-3, seed=111),
)
state = trainer.init()
key = jax.random.PRNGKey(111)

mean_energy, var_energy = [], []
block = 50
for it in range(0, NUM_STEPS, block):
    state, ms = trainer.run_steps(state, key, block)
    mean_energy.extend(np.asarray(ms["mean_energy"]).tolist())
    var_energy.extend(np.asarray(ms["var_energy"]).tolist())
    print(f"step {it + block:5d}  mean(E) = {mean_energy[-1]:+.6f}  "
          f"var(E) = {var_energy[-1]:.4f}")
"""),
    md("""\
## Comparison of RNN results with ED

Same estimator convention as the TFIM tutorial (mean of the last 100
steps, $\\pm\\sqrt{\\max(\\mathrm{var}E)/(100 S)}$):
"""),
    code("""\
est, err = energy_estimate(mean_energy, var_energy, NUM_SAMPLES, window=100)
rel = abs(est - e_exact) / abs(e_exact)
print(f"VMC estimate : {est:.8f} +- {err:.1e}")
print(f"ED reference : {e_exact:.8f}")
print(f"rel. error   : {rel:.2e}")
# smoke threshold for short runs; the 30k-step schedule reaches ~1e-4
assert rel < 5e-2, "training did not move toward the ED energy"
"""),
    code("""\
# every drawn configuration obeys the U(1) zero-magnetization constraint
samples = trainer.ansatz.sample(state.params, jax.random.PRNGKey(7), 512)
assert (np.asarray(samples).sum(axis=1) == N // 2).all()
print("all samples have zero magnetization")
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.plot(mean_energy, lw=0.8, label="VMC energy")
ax.axhline(e_exact, ls="--", c="k", label="ED")
ax.set_xlabel("VMC step")
ax.set_ylabel(r"$\\langle H \\rangle$")
ax.legend()
"""),
    md("""\
### Energy variance
"""),
    code("""\
fig, ax = plt.subplots(figsize=(10, 4))
ax.semilogy(np.maximum(np.asarray(var_energy), 1e-12), lw=0.8)
ax.set_xlabel("VMC step")
ax.set_ylabel(r"$\\mathrm{var}(E_{loc})$")
"""),
    md("""\
Early in training the variance can look deceptively small while the energy
is still wrong: the cRNN starts near a *local* minimum (an
almost-product state on which $E_{loc}$ is nearly constant) and the
variance only grows as the optimizer moves through genuinely quantum
territory before both collapse toward the ground state.  Watch energy and
variance **together** — a small variance alone does not certify
convergence for sign-structured models.
"""),
    md("""\
### Wavefunction fidelity

For a sign-structured model the fidelity
$F = |\\langle \\psi_\\theta | \\psi_0 \\rangle|^2$ is the decisive check:
it sees the **phases**, which the energy estimate only samples indirectly.
(The U(1) constraint means $\\psi_\\theta$ lives entirely in the $S_z=0$
sector, like the exact ground state.)
"""),
    code("""\
from rnnwavefunctions.ed.fidelity import fidelity

F = fidelity(trainer.ansatz, state.params, gs)
print(f"fidelity |<psi_theta|psi_0>|^2 = {F:.6f}")
assert 0.0 < F <= 1.0 + 1e-9
"""),
    md("""\
## Explorations

- **The Majumdar-Ghosh point.**  Set $J_2 = 0.5$: the exact ground-state
  energy is $-\\tfrac{3}{8} N J_1 = -3.75$ for $N=10$ (PBC) — a rare
  exactly-solvable frustrated point.  How close does the cRNN get, and how
  does the *variance* behave on an exactly-representable state?
- **Marshall sign.**  At $J_2 = 0$ compare `J1J2(..., marshall_sign=True)`
  against the plain cRNN: with the sign rule absorbed into the gauge, the
  wavefunction is positive and training converges markedly faster.
- **Large systems.**  DMRG anchors at N=100 (reference notebook cell 25);
  production runs via `python -m rnnwavefunctions.cli.run_j1j2`:

| J2 | E(DMRG) |
|----|---------|
| 0.0 | -44.127739860 |
| 0.2 | -40.73881897 |
| 0.5 | -37.5 (exact, Majumdar-Ghosh) |
| 0.8 | -42.07006 |

- **Periodic boundaries.**  `J1J2(..., periodic=True)` adds the wrap
  bonds (`bench.py`'s `j1j2_n100_pbc` row).
"""),
]


def main():
    for name, cells in [
        ("Tutorial_1DTFIM.ipynb", TFIM_CELLS),
        ("Tutorial_1DJ1J2.ipynb", J1J2_CELLS),
    ]:
        path = os.path.join(OUT_DIR, name)
        with open(path, "w") as f:
            json.dump(notebook(cells), f, indent=1)
            f.write("\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
