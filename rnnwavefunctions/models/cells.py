"""Recurrent cells as pure functions over parameter pytrees.

Design notes
------------
Each cell is a stateless namespace of ``init``/``apply`` functions operating on
a dict-of-arrays parameter pytree.  The per-step compute is a small number of
batched matmuls followed by elementwise gates, which XLA fuses into the
matmul epilogues.  The site loop lives *outside*
the cell in ``lax.scan`` (constant program size in the number of lattice
sites), unlike the reference's Python-unrolled TF1 graphs
(``/root/reference/1DTFIM/RNNwavefunction.py:65-70`` builds N copies of the
cell subgraph).

Cell variants mirror the reference's capability surface:

* ``gru``    — cuDNN-compatible ("reset-after") GRU, the stand-in for
  ``tf.contrib.cudnn_rnn.CudnnCompatibleGRUCell``
  (``/root/reference/1DTFIM/RNNwavefunction.py:8``).
* ``mdrnn``  — the two-neighbour vanilla 2D cell
  ``h' = elu(xh·Uh + xv·Uv + hh·Wh + hv·Wv + b)``
  (``/root/reference/2DTFIM_2DRNN/MDRNNcell.py:51-66``).

Weights are stored with the contraction dim first, i.e. ``x @ Wx`` with
``Wx: (in, 3*units)``, so the batched matmul has the batch dimension as
rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]


def _glorot(key: jax.Array, shape: Tuple[int, ...], dtype) -> jax.Array:
    """Xavier/Glorot uniform, matching TF's default dense/xavier initializers."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype=dtype, minval=-limit, maxval=limit)


# ---------------------------------------------------------------------------
# GRU (cuDNN-compatible, "reset-after" candidate)
# ---------------------------------------------------------------------------

def gru_init(key: jax.Array, input_dim: int, units: int, dtype=jnp.float32) -> Params:
    """Parameters for one GRU layer.

    Layout: gates are packed [reset | update | candidate] along the last axis
    so a single (B, in) x (in, 3U) matmul feeds all three gates.
    """
    k1, k2 = jax.random.split(key)
    return {
        "wx": _glorot(k1, (input_dim, 3 * units), dtype),
        "wh": _glorot(k2, (units, 3 * units), dtype),
        "bx": jnp.zeros((3 * units,), dtype),
        "bh": jnp.zeros((3 * units,), dtype),
    }


def gru_apply(p: Params, x: jax.Array, h: jax.Array) -> jax.Array:
    """One GRU step: (B, in), (B, U) -> new hidden (B, U).

    cuDNN semantics (reset-after):
      r = sigmoid(x Wr + br_x + h Ur + br_h)
      z = sigmoid(x Wz + bz_x + h Uz + bz_h)
      c = tanh  (x Wc + bc_x + r * (h Uc + bc_h))
      h' = z * h + (1 - z) * c
    """
    u = h.shape[-1]
    gx = jnp.dot(x, p["wx"], preferred_element_type=h.dtype) + p["bx"]
    gh = jnp.dot(h, p["wh"], preferred_element_type=h.dtype) + p["bh"]
    rx, zx, cx = gx[..., :u], gx[..., u : 2 * u], gx[..., 2 * u :]
    rh, zh, ch = gh[..., :u], gh[..., u : 2 * u], gh[..., 2 * u :]
    r = jax.nn.sigmoid(rx + rh)
    z = jax.nn.sigmoid(zx + zh)
    c = jnp.tanh(cx + r * ch)
    return z * h + (1.0 - z) * c


# ---------------------------------------------------------------------------
# LSTM (the reference snake-2D ansatz's default cell argument,
# ``/root/reference/2DTFIM_1DRNN/RNNwavefunction.py:9`` —
# ``tf.contrib.rnn.LSTMCell``).  ``lstm_apply`` below is the semantics
# oracle for the LSTM rollout kernel (ops/rollout.py), which replicates its
# [i | j | f | o] gate packing and forget_bias=1.0 — keep them in sync
# ---------------------------------------------------------------------------

def lstm_init(key: jax.Array, input_dim: int, units: int, dtype=jnp.float32) -> Params:
    """Parameters for one LSTM layer; gates packed [i | j | f | o] along the
    last axis (TF BasicLSTMCell/LSTMCell packing)."""
    k1, k2 = jax.random.split(key)
    return {
        "wx": _glorot(k1, (input_dim, 4 * units), dtype),
        "wh": _glorot(k2, (units, 4 * units), dtype),
        "b": jnp.zeros((4 * units,), dtype),
    }


def lstm_apply(p: Params, x: jax.Array, state) -> Tuple[jax.Array, Any]:
    """One LSTM step: (B, in), ((B, U) h, (B, U) c) -> (h', (h', c')).

    TF LSTMCell semantics with forget_bias = 1.0:
      i, j, f, o = split(x W + h U + b)
      c' = c * sigmoid(f + 1) + sigmoid(i) * tanh(j)
      h' = tanh(c') * sigmoid(o)
    """
    h, c = state
    u = h.shape[-1]
    g = (
        jnp.dot(x, p["wx"], preferred_element_type=h.dtype)
        + jnp.dot(h, p["wh"], preferred_element_type=h.dtype)
        + p["b"]
    )
    i, j = g[..., :u], g[..., u : 2 * u]
    f, o = g[..., 2 * u : 3 * u], g[..., 3 * u :]
    c_new = c * jax.nn.sigmoid(f + 1.0) + jax.nn.sigmoid(i) * jnp.tanh(j)
    h_new = jnp.tanh(c_new) * jax.nn.sigmoid(o)
    return h_new, (h_new, c_new)


# ---------------------------------------------------------------------------
# Custom-cell protocol — the analogue of the reference constructor accepting
# any TF RNNCell class (``/root/reference/1DTFIM/RNNwavefunction.py:13``
# takes ``cell=tf.contrib.cudnn_rnn.CudnnCompatibleGRUCell`` by default and
# any compatible class as an argument).  Here a custom cell is any object
# with three pure methods:
#
#   init(key, input_dim, units, dtype) -> params           (one layer)
#   apply(params, x, state)            -> (out, new_state)
#   zero_state(batch, units, dtype)    -> state
#
# Pass the instance as ``PRNN1D(cell=MyCell())`` (or to ``PRNNSnake2D``).
# Custom cells run the jnp ``lax.scan`` path; the rollout kernel covers the
# built-in uniform GRU/LSTM stacks (``ops/rollout.covers``).
# ---------------------------------------------------------------------------


class ElmanCell:
    """Minimal example of the custom-cell protocol: a vanilla tanh RNN
    (also serves as the test fixture for cell injection)."""

    def init(self, key: jax.Array, input_dim: int, units: int, dtype=jnp.float32) -> Params:
        k1, k2 = jax.random.split(key)
        return {
            "wx": _glorot(k1, (input_dim, units), dtype),
            "wh": _glorot(k2, (units, units), dtype),
            "b": jnp.zeros((units,), dtype),
        }

    def apply(self, p: Params, x: jax.Array, state: jax.Array):
        h = jnp.tanh(
            jnp.dot(x, p["wx"], preferred_element_type=state.dtype)
            + jnp.dot(state, p["wh"], preferred_element_type=state.dtype)
            + p["b"]
        )
        return h, h

    def zero_state(self, batch: int, units: int, dtype=jnp.float32):
        return jnp.zeros((batch, units), dtype)


def cell_name(cell) -> str:
    """Display name for a cell spec (string kind or custom-cell object)."""
    return cell if isinstance(cell, str) else type(cell).__name__


# ---------------------------------------------------------------------------
# Stacked (multi-layer) recurrent trunk, the MultiRNNCell analogue —
# cell selectable: "gru" | "lstm" | a custom-cell protocol object
# ---------------------------------------------------------------------------

def stacked_rnn_init(
    key: jax.Array, input_dim: int, units: Sequence[int],
    dtype=jnp.float32, cell="gru",
) -> List[Params]:
    if isinstance(cell, str):
        init = {"gru": gru_init, "lstm": lstm_init}[cell]
    else:
        init = cell.init
    params = []
    in_dim = input_dim
    for u in units:
        key, sub = jax.random.split(key)
        params.append(init(sub, in_dim, u, dtype))
        in_dim = u
    return params


def stacked_rnn_apply(params: List[Params], x: jax.Array, states, cell="gru"):
    """Apply the stack; returns (top output, new per-layer states tuple)."""
    new_states = []
    inp = x
    for p, st in zip(params, states):
        if cell == "gru":
            out = gru_apply(p, inp, st)
            new_states.append(out)
        elif cell == "lstm":
            out, st_new = lstm_apply(p, inp, st)
            new_states.append(st_new)
        else:
            out, st_new = cell.apply(p, inp, st)
            new_states.append(st_new)
        inp = out
    return inp, tuple(new_states)


def stacked_rnn_zero_state(batch: int, units: Sequence[int], dtype=jnp.float32,
                           cell="gru"):
    if cell == "gru":
        return tuple(jnp.zeros((batch, u), dtype) for u in units)
    if cell == "lstm":
        return tuple(
            (jnp.zeros((batch, u), dtype), jnp.zeros((batch, u), dtype))
            for u in units
        )
    return tuple(cell.zero_state(batch, u, dtype) for u in units)


# ---------------------------------------------------------------------------
# Stacked GRU aliases (the original single-kind API)
# ---------------------------------------------------------------------------

def stacked_gru_init(
    key: jax.Array, input_dim: int, units: Sequence[int], dtype=jnp.float32
) -> List[Params]:
    """Stack of GRU layers (``tf.nn.rnn_cell.MultiRNNCell`` analogue,
    ``/root/reference/1DTFIM/RNNwavefunction.py:32``)."""
    return stacked_rnn_init(key, input_dim, units, dtype, cell="gru")


def stacked_gru_apply(
    params: List[Params], x: jax.Array, hs: Tuple[jax.Array, ...]
) -> Tuple[jax.Array, Tuple[jax.Array, ...]]:
    """Apply the stack; returns (top output, new states tuple)."""
    return stacked_rnn_apply(params, x, hs, cell="gru")


def stacked_gru_zero_state(
    batch: int, units: Sequence[int], dtype=jnp.float32
) -> Tuple[jax.Array, ...]:
    return stacked_rnn_zero_state(batch, units, dtype, cell="gru")


# ---------------------------------------------------------------------------
# 2D MDRNN cell (two-neighbour vanilla RNN)
# ---------------------------------------------------------------------------

def mdrnn_init(key: jax.Array, input_dim: int, units: int, dtype=jnp.float32) -> Params:
    """Parameters for the 2D cell (5 tensors Wh, Uh, Wv, Uv, b; the reference
    Xavier-inits all five incl. the bias, ``MDRNNcell.py:21-35`` — we use
    zeros for the bias, a deliberate, documented divergence with no effect on
    expressivity)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {
        "uh": _glorot(k1, (input_dim, units), dtype),  # horizontal input
        "uv": _glorot(k2, (input_dim, units), dtype),  # vertical input
        "wh": _glorot(k3, (units, units), dtype),      # horizontal state
        "wv": _glorot(k4, (units, units), dtype),      # vertical state
        "b": jnp.zeros((units,), dtype),
    }


def mdrnn_apply(
    p: Params,
    xs: Tuple[jax.Array, jax.Array],
    hs: Tuple[jax.Array, jax.Array],
) -> jax.Array:
    """One 2D-cell step.

    ``xs = (x_horizontal, x_vertical)`` one-hot neighbour spins,
    ``hs = (h_horizontal, h_vertical)`` neighbour hidden states; returns the
    new hidden state (output == state, ``MDRNNcell.py:62-66``).
    """
    xh, xv = xs
    hh, hv = hs
    acc = (
        jnp.dot(xh, p["uh"], preferred_element_type=hh.dtype)
        + jnp.dot(xv, p["uv"], preferred_element_type=hh.dtype)
        + jnp.dot(hh, p["wh"], preferred_element_type=hh.dtype)
        + jnp.dot(hv, p["wv"], preferred_element_type=hh.dtype)
        + p["b"]
    )
    return jax.nn.elu(acc)


# ---------------------------------------------------------------------------
# Dense output heads
# ---------------------------------------------------------------------------

def dense_init(key: jax.Array, input_dim: int, out_dim: int, dtype=jnp.float32) -> Params:
    return {
        "w": _glorot(key, (input_dim, out_dim), dtype),
        "b": jnp.zeros((out_dim,), dtype),
    }


def dense_apply(p: Params, x: jax.Array) -> jax.Array:
    return jnp.dot(x, p["w"], preferred_element_type=x.dtype) + p["b"]
