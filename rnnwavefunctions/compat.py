"""Drop-in function API matching the reference repository's entry points.

The reference's public Python API is four training functions, one per
workload directory, each returning ``(meanEnergy, varEnergy)`` series and
persisting ``.npy`` artifacts + checkpoints under ``Check_Points/``:

- ``run_1DTFIM``  (``1DTFIM/TrainingRNN_1DTFIM.py:79``)
- ``run_J1J2``    (``J1J2/TrainingRNN_J1J2.py:131``)
- ``run_2DTFIM``  (snake 1D-RNN variant, ``2DTFIM_1DRNN/Training1DRNN_2DTFIM.py:85``)
- ``run_2DTFIM``  (true 2D MDRNN variant, ``2DTFIM_2DRNN/Training2DRNN_2DTFIM.py:88``)

This module re-exposes them with the reference's exact keyword names and
defaults (including the J1J2 trailing-underscore kwargs ``J1_``/``J2_``
and the per-family learning-rate schedules), delegating to the CLI
drivers so artifact formats, checkpoint cadence, and the inclusive
``range(start, numsteps + 1)`` loop convention are byte-identical to the
``python -m rnnwavefunctions.cli.run_*`` entry points.  The two
same-named 2D functions are disambiguated as ``run_2DTFIM_1DRNN`` /
``run_2DTFIM_2DRNN``; see ``docs/MIGRATION.md`` for the full mapping.

Intentional deviations (documented, not silent):

- Returns are ``np.ndarray`` rather than Python lists (length
  ``numsteps + 1``, one entry per step including step 0, matching the
  reference's inclusive loop).
- ``seed`` feeds a JAX threefry key, not TF1 graph seeds — per-run
  distributions match (chi-square-validated samplers), bit-for-bit
  trajectories cannot (SURVEY.md §7 hard part (e)).
- The 2D families default to float32 + Kahan-compensated accumulation
  (the ``chip_smoke.py`` physics phase checks the N=10 TFIM anchor); pass
  ``dtype="float64"`` for the reference's end-to-end f64 graphs
  (``2DTFIM_1DRNN/RNNwavefunction.py:38``, ``2DTFIM_2DRNN/RNNwavefunction.py:32``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "run_1DTFIM",
    "run_J1J2",
    "run_2DTFIM_1DRNN",
    "run_2DTFIM_2DRNN",
]


def _as_arrays(pair):
    # dtype inferred: J1J2 mean energies are complex, as in the reference
    # (np.mean over complex local energies, TrainingRNN_J1J2.py:281).
    mean_e, var_e = pair
    return np.asarray(mean_e), np.asarray(var_e)


def run_1DTFIM(
    numsteps=10**4,
    systemsize=20,
    num_units=50,
    Bx=1,
    num_layers=1,
    numsamples=500,
    learningrate=5e-3,
    seed=111,
    workdir="Check_Points/1DTFIM",
    resume=False,
):
    """1D TFIM ground search with a positive GRU pRNN.

    Signature parity: ``1DTFIM/TrainingRNN_1DTFIM.py:79`` (same names,
    same defaults, constant learning rate).  Returns
    ``(RNNEnergy, varRNNEnergy)`` per-step series as numpy arrays.
    """
    from .cli.run_1dtfim import main

    argv = [
        "--numsteps", str(numsteps),
        "--systemsize", str(systemsize),
        "--bx", repr(float(Bx)),
        "--num-units", str(num_units),
        "--num-layers", str(num_layers),
        "--numsamples", str(numsamples),
        "--learningrate", repr(float(learningrate)),
        "--seed", str(seed),
        "--workdir", workdir,
    ]
    if resume:
        argv.append("--resume")
    return _as_arrays(main(argv))


def run_J1J2(
    numsteps=10**5,
    systemsize=20,
    J1_=1.0,
    J2_=0.0,
    Marshall_sign=False,
    num_units=50,
    num_layers=1,
    numsamples=500,
    learningrate=2.5e-4,
    seed=111,
    workdir="Check_Points/J1J2",
    resume=False,
):
    """J1-J2 chain with the complex two-head U(1) cRNN.

    Signature parity: ``J1J2/TrainingRNN_J1J2.py:131`` — including the
    trailing-underscore ``J1_``/``J2_`` kwargs and the ``Marshall_sign``
    flag (wired to the Hamiltonian's sign rule; the reference's call site
    swaps the periodic/Marshall arguments — see ``hamiltonians/j1j2.py``).
    Returns ``(meanEnergy, varEnergy)``.
    """
    from .cli.run_j1j2 import main

    argv = [
        "--numsteps", str(numsteps),
        "--systemsize", str(systemsize),
        "--j1", repr(float(J1_)),
        "--j2", repr(float(J2_)),
        "--num-units", str(num_units),
        "--num-layers", str(num_layers),
        "--numsamples", str(numsamples),
        "--learningrate", repr(float(learningrate)),
        "--seed", str(seed),
        "--workdir", workdir,
    ]
    if Marshall_sign:
        argv.append("--marshall-sign")
    if resume:
        argv.append("--resume")
    return _as_arrays(main(argv))


def run_2DTFIM_1DRNN(
    numsteps=2 * 10**4,
    systemsize_x=5,
    systemsize_y=5,
    Bx=+2,
    num_units=50,
    num_layers=1,
    numsamples=500,
    learningrate=1e-3,
    seed=333,
    workdir="Check_Points/2DTFIM",
    resume=False,
    dtype="float32",
):
    """2D TFIM with the snake-ordered 1D RNN (``run_2DTFIM`` of
    ``2DTFIM_1DRNN/Training1DRNN_2DTFIM.py:85``; harmonic lr decay
    ``1/((1/lr)+(it/10))``, ``:229``).  Returns ``(meanEnergy, varEnergy)``.
    """
    from .cli.run_2dtfim_1drnn import main

    argv = [
        "--numsteps", str(numsteps),
        "--systemsize-x", str(systemsize_x),
        "--systemsize-y", str(systemsize_y),
        "--bx", repr(float(Bx)),
        "--num-units", str(num_units),
        "--num-layers", str(num_layers),
        "--numsamples", str(numsamples),
        "--learningrate", repr(float(learningrate)),
        "--seed", str(seed),
        "--workdir", workdir,
        "--dtype", dtype,
    ]
    if resume:
        argv.append("--resume")
    return _as_arrays(main(argv))


def run_2DTFIM_2DRNN(
    numsteps=2 * 10**4,
    systemsize_x=5,
    systemsize_y=5,
    Bx=+2,
    num_units=50,
    numsamples=500,
    learningrate=5e-3,
    seed=111,
    workdir="Check_Points/2DTFIM",
    resume=False,
    dtype="float32",
):
    """2D TFIM with the true 2D MDRNN (``run_2DTFIM`` of
    ``2DTFIM_2DRNN/Training2DRNN_2DTFIM.py:88``; inverse lr decay
    ``lr*(1+it/5000)**(-1)``, ``:228``; no ``num_layers`` — the reference
    MDRNN is single-layer).  Returns ``(meanEnergy, varEnergy)``.
    """
    from .cli.run_2dtfim_2drnn import main

    argv = [
        "--numsteps", str(numsteps),
        "--systemsize-x", str(systemsize_x),
        "--systemsize-y", str(systemsize_y),
        "--bx", repr(float(Bx)),
        "--num-units", str(num_units),
        "--numsamples", str(numsamples),
        "--learningrate", repr(float(learningrate)),
        "--seed", str(seed),
        "--workdir", workdir,
        "--dtype", dtype,
    ]
    if resume:
        argv.append("--resume")
    return _as_arrays(main(argv))
