"""Drop-in compat API: reference function signatures and return contract.

The reference's public Python API is the four ``run_*`` training functions
(``1DTFIM/TrainingRNN_1DTFIM.py:79``, ``J1J2/TrainingRNN_J1J2.py:131``,
``2DTFIM_1DRNN/Training1DRNN_2DTFIM.py:85``,
``2DTFIM_2DRNN/Training2DRNN_2DTFIM.py:88``); ``rnnwavefunctions.compat``
re-exposes them name-for-name and default-for-default.
"""

import inspect
import os

import numpy as np
import pytest

from rnnwavefunctions import compat


def _params(fn):
    return {
        k: p.default
        for k, p in inspect.signature(fn).parameters.items()
        if k not in ("workdir", "resume", "dtype")  # rebuild-only passthroughs
    }


def test_run_1dtfim_signature_matches_reference():
    # TrainingRNN_1DTFIM.py:79
    assert _params(compat.run_1DTFIM) == {
        "numsteps": 10**4, "systemsize": 20, "num_units": 50, "Bx": 1,
        "num_layers": 1, "numsamples": 500, "learningrate": 5e-3, "seed": 111,
    }


def test_run_j1j2_signature_matches_reference():
    # TrainingRNN_J1J2.py:131 — incl. the trailing-underscore kwargs
    assert _params(compat.run_J1J2) == {
        "numsteps": 10**5, "systemsize": 20, "J1_": 1.0, "J2_": 0.0,
        "Marshall_sign": False, "num_units": 50, "num_layers": 1,
        "numsamples": 500, "learningrate": 2.5e-4, "seed": 111,
    }


def test_run_2dtfim_signatures_match_reference():
    # Training1DRNN_2DTFIM.py:85 and Training2DRNN_2DTFIM.py:88 (the
    # MDRNN variant has no num_layers — single-layer in the reference too)
    assert _params(compat.run_2DTFIM_1DRNN) == {
        "numsteps": 2 * 10**4, "systemsize_x": 5, "systemsize_y": 5,
        "Bx": 2, "num_units": 50, "num_layers": 1, "numsamples": 500,
        "learningrate": 1e-3, "seed": 333,
    }
    assert _params(compat.run_2DTFIM_2DRNN) == {
        "numsteps": 2 * 10**4, "systemsize_x": 5, "systemsize_y": 5,
        "Bx": 2, "num_units": 50, "numsamples": 500,
        "learningrate": 5e-3, "seed": 111,
    }


def test_run_1dtfim_returns_reference_series(tmp_path):
    mean_e, var_e = compat.run_1DTFIM(
        numsteps=8, systemsize=6, num_units=8, numsamples=32,
        workdir=str(tmp_path),
    )
    # inclusive loop: numsteps + 1 records, reference-style
    assert mean_e.shape == var_e.shape == (9,)
    assert np.isfinite(mean_e).all() and (var_e >= 0).all()
    npys = [f for f in os.listdir(tmp_path) if f.endswith(".npy")]
    assert any(f.startswith("meanEnergy_") for f in npys)
    assert any(f.startswith("varEnergy_") for f in npys)


@pytest.mark.slow
def test_run_j1j2_returns_complex_series(tmp_path):
    mean_e, var_e = compat.run_J1J2(
        numsteps=4, systemsize=6, J2_=0.2, Marshall_sign=True,
        num_units=8, numsamples=32, workdir=str(tmp_path),
    )
    assert np.iscomplexobj(mean_e)  # reference: mean of complex Eloc
    assert mean_e.shape == (5,) and np.isfinite(var_e).all()


@pytest.mark.slow
def test_run_2dtfim_both_variants(tmp_path):
    m1, v1 = compat.run_2DTFIM_1DRNN(
        numsteps=4, systemsize_x=2, systemsize_y=3, num_units=8,
        numsamples=32, workdir=str(tmp_path / "snake"),
    )
    m2, v2 = compat.run_2DTFIM_2DRNN(
        numsteps=4, systemsize_x=2, systemsize_y=3, num_units=8,
        numsamples=32, workdir=str(tmp_path / "mdrnn"),
    )
    for m, v in ((m1, v1), (m2, v2)):
        assert m.shape == v.shape == (5,) and np.isfinite(m).all()
