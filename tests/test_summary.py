"""utils/summary.py — the reference's trainable-variable printout
(TrainingRNN_1DTFIM.py:127-136) as a utility; printed by every CLI via
run_loop."""

import jax
import numpy as np

from rnnwavefunctions import CRNNU1, MDRNN2D, PRNN1D
from rnnwavefunctions.utils.summary import param_count, summarize_params


def test_param_count_flagship_shapes():
    """Pin the flagship parameter counts — a silent change here means the
    ansatz parameterization changed (and every perf/accuracy record with
    it).  PRNN1D U=50: wx (2,3U)+wh (U,3U)+bx+bh (3U each)+head (U,2)+2 =
    8202; the separate bx/bh pair is +150 vs the reference's single
    fused-gate bias (GRUCell), documented in models/cells.py."""
    cases = [
        (PRNN1D(num_sites=100, units=(50,)), 8202),
        (CRNNU1(num_sites=100, units=(50,)), 8304),
        (MDRNN2D(nx=4, ny=4, units=50), 5352),
    ]
    for ansatz, want in cases:
        params = ansatz.init(jax.random.PRNGKey(0))
        assert param_count(params) == want, type(ansatz).__name__


def test_param_count_matches_leaves():
    params = PRNN1D(num_sites=10, units=(8,)).init(jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(params))
    assert param_count(params) == want


def test_summarize_params_table():
    params = PRNN1D(num_sites=10, units=(8,)).init(jax.random.PRNGKey(0))
    text = summarize_params(params)
    # one line per leaf + the reference-style total line
    assert len(text.splitlines()) == len(jax.tree.leaves(params)) + 1
    assert text.splitlines()[-1] == "The number of params is 306"
    assert "rnn/[0]/wh" in text and "(8, 24)" in text
