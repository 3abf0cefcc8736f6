"""Hidden-dimension (tensor-parallel) model sharding for the pRNN trunk.

SURVEY.md §2.4's optional rebuild component: the reference has no model
parallelism (50-unit GRUs fit anywhere), but very large hidden sizes
eventually outgrow one device.  The recipe is Megatron-style sharding of
the recurrent weights over a second mesh axis ``tp`` orthogonal to the
Monte-Carlo ``dp`` axis:

* every GRU gate block's *output* columns are split over ``tp`` — device d
  holds ``wx[:, gate, d-th slice]`` / ``wh[:, gate, d-th slice]`` and its
  slice of the biases and of the hidden state ``h``;
* one ``all_gather(h)`` across ``tp`` per site step reassembles the full
  hidden input for the ``h @ wh`` contraction (the only cross-shard
  dependency);
* the softmax head's rows are split the same way and its logits are
  ``psum``'d, so every tp member sees identical conditionals — with the
  per-site PRNG key folded over ``dp`` only, all tp members draw identical
  spins and the Monte-Carlo chains stay consistent without communication.

Per-site comms: one (B, U) all-gather + one (B, 2) psum over ``tp``.
Gradients of the sharded parameters are local to their shard (only the
``dp`` mean is psum'd), exactly like any Megatron column-parallel layer.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from .mesh import DP_AXIS

TP_AXIS = "tp"


def make_dp_tp_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """2D mesh: Monte-Carlo chains over ``dp``, hidden dimension over ``tp``."""
    if devices is None:
        devices = jax.devices()
    if dp * tp > len(devices):
        raise ValueError(f"need {dp * tp} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[: dp * tp]).reshape(dp, tp), (DP_AXIS, TP_AXIS))


def make_tp_mesh_over(num_devices, tp: int) -> Mesh:
    """The (num_devices // tp, tp) mesh over the first ``num_devices``
    devices (all of them when None).  Raises when ``tp`` does not divide
    the device count: a floor would silently leave devices idle."""
    n_dev = num_devices or len(jax.devices())
    if n_dev % tp:
        raise ValueError(
            f"--tp {tp} does not divide the device count {n_dev}"
        )
    return make_dp_tp_mesh(n_dev // tp, tp)


# ---------------------------------------------------------------------------
# Parameter sharding
# ---------------------------------------------------------------------------

def _gate_cols(w: jax.Array, num_gates: int, k: int, idx) -> jax.Array:
    """Slice each of the ``num_gates`` packed gate blocks' output columns to
    tp-shard ``idx`` (static python int or traced index)."""
    u = w.shape[-1] // num_gates
    us = u // k
    parts = [
        jax.lax.dynamic_slice_in_dim(w, g * u + idx * us, us, axis=-1)
        for g in range(num_gates)
    ]
    return jnp.concatenate(parts, axis=-1)


def shard_params(params: Any, k: int, idx, kind: str = "gru") -> Any:
    """Shard a PRNN1D parameter pytree for tp-shard ``idx`` of ``k``.

    Layer weights keep full input rows and take 1/k of every gate's output
    columns (3 packed gates for GRU, 4 for LSTM); the head takes 1/k of
    its input rows.  For layers above the first, the input rows are the
    previous layer's *full* hidden (the all-gathered activation), so rows
    stay full there too.
    """
    _shard_trunk(params["rnn"], k)
    if kind == "lstm":
        rnn = [
            {
                "wx": _gate_cols(cell["wx"], 4, k, idx),
                "wh": _gate_cols(cell["wh"], 4, k, idx),
                "b": _gate_cols(cell["b"][None], 4, k, idx)[0],
            }
            for cell in params["rnn"]
        ]
        return {"rnn": rnn, "head": _shard_head(params["head"], k, idx)}
    rnn = [
        {
            "wx": _gate_cols(cell["wx"], 3, k, idx),
            "wh": _gate_cols(cell["wh"], 3, k, idx),
            "bx": _gate_cols(cell["bx"][None], 3, k, idx)[0],
            "bh": _gate_cols(cell["bh"][None], 3, k, idx)[0],
        }
        for cell in params["rnn"]
    ]
    # b/k folded inside the head psum: the forward value is unchanged, and
    # because the in-trunk psum transposes to a psum, every member's local
    # gradient comes out k x its disjoint slice — so pmean-over-tp (NOT a
    # plain psum; see trainer._device_step_tp and
    # tests/test_tensor_parallel.py::test_tp_inner_grad_pmean_matches_
    # unsharded) assembles ALL parameter gradients uniformly at 1x, the
    # bias included via the folded 1/k.
    return {"rnn": rnn, "head": _shard_head(params["head"], k, idx)}


def shard_params_crnn(params: Any, k: int, idx) -> Any:
    """Shard a CRNNU1 parameter pytree for tp-shard ``idx`` of ``k``: the
    shared GRU trunk exactly as ``shard_params``, and BOTH dense heads
    (amplitude + phase) row-sharded with the same folded-b/k psum/pmean
    gradient contract."""
    _shard_trunk(params["rnn"], k)
    rnn = [
        {
            "wx": _gate_cols(cell["wx"], 3, k, idx),
            "wh": _gate_cols(cell["wh"], 3, k, idx),
            "bx": _gate_cols(cell["bx"][None], 3, k, idx)[0],
            "bh": _gate_cols(cell["bh"][None], 3, k, idx)[0],
        }
        for cell in params["rnn"]
    ]
    return {
        "rnn": rnn,
        "head_ampl": _shard_head(params["head_ampl"], k, idx),
        "head_phase": _shard_head(params["head_phase"], k, idx),
    }


# ---------------------------------------------------------------------------
# Sharded trunk (runs inside shard_map over a ("dp", "tp") mesh)
# ---------------------------------------------------------------------------

def _shard_head(head: Any, k: int, idx) -> Any:
    """Row-shard a dense head for tp-shard ``idx`` of ``k``: 1/k of its
    input rows, with b/k folded into the head psum (see ``shard_params``'s
    gradient note — pmean over tp assembles every gradient at 1x)."""
    u_top = head["w"].shape[0]
    us = u_top // k
    return {
        "w": jax.lax.dynamic_slice_in_dim(head["w"], idx * us, us, axis=0),
        "b": head["b"] / k,
    }


def _shard_trunk(rnn: Sequence[Any], k: int) -> None:
    for i, cell in enumerate(rnn):
        u = cell["wh"].shape[0]
        if u % k != 0:
            raise ValueError(
                f"hidden width {u} of layer {i} is not divisible by "
                f"tp={k}; pick units that shard evenly"
            )


def _tp_gru_apply(p, x, h_shard):
    """One tp-sharded GRU step: ``h_shard`` (B, U/k) -> new (B, U/k) shard.
    The recurrent contraction consumes the all-gathered full hidden."""
    h_full = jax.lax.all_gather(h_shard, TP_AXIS, axis=-1, tiled=True)
    us = h_shard.shape[-1]
    gx = jnp.dot(x, p["wx"], preferred_element_type=h_shard.dtype) + p["bx"]
    gh = jnp.dot(h_full, p["wh"], preferred_element_type=h_shard.dtype) + p["bh"]
    r = jax.nn.sigmoid(gx[..., :us] + gh[..., :us])
    z = jax.nn.sigmoid(gx[..., us : 2 * us] + gh[..., us : 2 * us])
    c = jnp.tanh(gx[..., 2 * us :] + r * gh[..., 2 * us :])
    return z * h_shard + (1.0 - z) * c


def _tp_lstm_apply(p, x, state):
    """One tp-sharded LSTM step (TF forget_bias=1.0 semantics): the cell
    state ``c`` is purely elementwise so its shard never communicates; only
    ``h`` is all-gathered for the recurrent contraction."""
    h, c = state
    h_full = jax.lax.all_gather(h, TP_AXIS, axis=-1, tiled=True)
    us = h.shape[-1]
    g = (
        jnp.dot(x, p["wx"], preferred_element_type=h.dtype)
        + jnp.dot(h_full, p["wh"], preferred_element_type=h.dtype)
        + p["b"]
    )
    i, j = g[..., :us], g[..., us : 2 * us]
    f, o = g[..., 2 * us : 3 * us], g[..., 3 * us :]
    c_new = c * jax.nn.sigmoid(f + 1.0) + jax.nn.sigmoid(i) * jnp.tanh(j)
    h_new = jnp.tanh(c_new) * jax.nn.sigmoid(o)
    return h_new, (h_new, c_new)


def _tp_trunk_step(rnn_params, x, hs, kind: str = "gru"):
    """Sharded stacked trunk step.  ``hs``: per-layer (B, U/k) shards for
    GRU, per-layer ((B, U/k) h, (B, U/k) c) pairs for LSTM.  Returns the
    new states tuple."""
    new_hs = []
    inp = x
    for p, h in zip(rnn_params, hs):
        if kind == "lstm":
            out, h_new = _tp_lstm_apply(p, inp, h)
        else:
            out = h_new = _tp_gru_apply(p, inp, h)
        new_hs.append(h_new)
        # deeper layers consume the full previous-layer output
        inp = jax.lax.all_gather(out, TP_AXIS, axis=-1, tiled=True)
    return tuple(new_hs)


def _tp_head(head, h_shard):
    """Row-sharded dense head: partial products (+ b/k) psum'd over the tp
    group — every member sees identical full logits."""
    return jax.lax.psum(
        jnp.dot(h_shard, head["w"], preferred_element_type=h_shard.dtype)
        + head["b"],
        TP_AXIS,
    )


def _tp_step_logits(params, x, hs, kind: str = "gru"):
    """Sharded stacked trunk + head step.  Returns ((B, d) tp-replicated
    logits, new states)."""
    new_hs = _tp_trunk_step(params["rnn"], x, hs, kind)
    top = new_hs[-1][0] if kind == "lstm" else new_hs[-1]
    return _tp_head(params["head"], top), new_hs


def tp_zero_state(batch: int, units: Sequence[int], k: int, dtype=jnp.float32,
                  kind: str = "gru"):
    if kind == "lstm":
        return tuple(
            (jnp.zeros((batch, u // k), dtype),
             jnp.zeros((batch, u // k), dtype))
            for u in units
        )
    return tuple(jnp.zeros((batch, u // k), dtype) for u in units)


def tp_log_prob(params_shard, samples: jax.Array, units: Sequence[int],
                k: int, dtype=jnp.float32, kind: str = "gru") -> jax.Array:
    """Teacher-forced joint log p(sigma) with tp-sharded parameters;
    (B, N) int -> (B,) replicated across the tp group."""
    d = 2
    s = samples.shape[0]
    onehot = jax.nn.one_hot(samples.T, d, dtype=dtype)
    inputs = jnp.concatenate(
        [jnp.zeros((1, s, d), dtype), onehot[:-1]], axis=0
    )
    targets = samples.T

    def step(hs, xs_t):
        x, tgt = xs_t
        logits, hs = _tp_step_logits(params_shard, x, hs, kind)
        logp = jax.nn.log_softmax(logits, axis=-1)
        site_logp = jnp.take_along_axis(logp, tgt[:, None], axis=-1)[:, 0]
        return hs, site_logp

    hs0 = tp_zero_state(s, units, k, dtype, kind)
    _, site_logps = jax.lax.scan(step, hs0, (inputs, targets))
    return jnp.sum(site_logps, axis=0)


def tp_sample_with_log_prob(params_shard, key: jax.Array, num_samples: int,
                            num_sites: int, units: Sequence[int], k: int,
                            dtype=jnp.float32, kind: str = "gru"):
    """Autoregressive sampling with tp-sharded parameters.  ``key`` must be
    identical across the tp group (fold only the dp index into it) so every
    shard draws the same spins from the identical psum'd conditionals."""
    from ..models.prnn1d import inverse_cdf_sample

    d = 2

    def step(carry, site_key):
        x, hs = carry
        logits, hs = _tp_step_logits(params_shard, x, hs, kind)
        logp = jax.nn.log_softmax(logits, axis=-1)
        draw = inverse_cdf_sample(site_key, jnp.exp(logp))
        x_next = jax.nn.one_hot(draw, d, dtype=dtype)
        site_logp = jnp.take_along_axis(logp, draw[:, None], axis=-1)[:, 0]
        return (x_next, hs), (draw, site_logp)

    x0 = jnp.zeros((num_samples, d), dtype)
    hs0 = tp_zero_state(num_samples, units, k, dtype, kind)
    keys = jax.random.split(key, num_sites)
    _, (draws, site_logps) = jax.lax.scan(step, (x0, hs0), keys)
    return draws.T, jnp.sum(site_logps, axis=0)


# ---------------------------------------------------------------------------
# Complex U(1) cRNN on the sharded trunk (reference semantics via the
# ansatz's own _masked_ampl — heavyside mask, eps=1e-30 L2 renorm,
# ComplexRNNwavefunction.py:85-93/147-155)
# ---------------------------------------------------------------------------


def tp_crnn_sample_with_log_prob(ansatz, params_shard, key: jax.Array,
                                 num_samples: int, k: int):
    """Autoregressive U(1) cRNN sampling with a tp-sharded trunk; the
    psum'd amplitude-head logits are tp-replicated, so the mask/renorm/draw
    arithmetic is identical on every member (``key`` must fold dp only).
    Mirrors ``models/crnn_u1.CRNNU1.sample_with_log_prob``'s jnp path."""
    from ..models.crnn_u1 import CRNNU1  # noqa: F401  (semantics source)
    from ..models.prnn1d import inverse_cdf_sample
    from ..ops.compsum import accum_sum

    d = ansatz.local_dim
    dtype = ansatz.dtype
    units = tuple(ansatz.units)

    def step(carry, xs):
        x, hs, num_up = carry
        n, site_key = xs
        hs = _tp_trunk_step(params_shard["rnn"], x, hs)
        logits = _tp_head(params_shard["head_ampl"], hs[-1])
        ampl = jnp.sqrt(jax.nn.softmax(logits, axis=-1))  # sqsoftmax
        ampl = ansatz._masked_ampl(ampl, n, num_up)
        probs = ampl**2
        draw = inverse_cdf_sample(site_key, probs)
        site_logp = jnp.log(
            jnp.take_along_axis(probs, draw[:, None], axis=-1)[:, 0]
        )
        x_next = jax.nn.one_hot(draw, d, dtype=dtype)
        return (x_next, hs, num_up + draw), (
            draw, site_logp.astype(ansatz.accum_dtype),
        )

    x0 = jnp.zeros((num_samples, d), dtype)
    hs0 = tp_zero_state(num_samples, units, k, dtype)
    up0 = jnp.zeros((num_samples,), jnp.int32)
    ns = jnp.arange(ansatz.num_sites)
    keys = jax.random.split(key, ansatz.num_sites)
    _, (draws, site_logps) = jax.lax.scan(step, (x0, hs0, up0), (ns, keys))
    return draws.T, accum_sum(site_logps, ansatz.accum_dtype)


def tp_crnn_log_amp_parts(ansatz, params_shard, samples: jax.Array, k: int):
    """Teacher-forced (Re, Im) log psi with a tp-sharded trunk, both (B,)
    tp-replicated.  Mirrors ``CRNNU1.log_amp_parts``."""
    from ..ops.compsum import accum_sum

    d = ansatz.local_dim
    dtype = ansatz.dtype
    units = tuple(ansatz.units)
    s = samples.shape[0]
    onehot = jax.nn.one_hot(samples.T, d, dtype=dtype)
    inputs = jnp.concatenate(
        [jnp.zeros((1, s, d), dtype), onehot[:-1]], axis=0
    )
    targets = samples.T
    cum_up = jnp.concatenate(
        [jnp.zeros((1, s), jnp.int32), jnp.cumsum(targets, axis=0)[:-1]],
        axis=0,
    )

    def step(hs, xs_t):
        x, tgt, n, num_up = xs_t
        hs = _tp_trunk_step(params_shard["rnn"], x, hs)
        logits_a = _tp_head(params_shard["head_ampl"], hs[-1])
        ampl = ansatz._masked_ampl(
            jnp.sqrt(jax.nn.softmax(logits_a, axis=-1)), n, num_up
        )
        phase = jnp.pi * jax.nn.soft_sign(
            _tp_head(params_shard["head_phase"], hs[-1])
        )
        a = jnp.take_along_axis(ampl, tgt[:, None], axis=-1)[:, 0]
        ph = jnp.take_along_axis(phase, tgt[:, None], axis=-1)[:, 0]
        return hs, (
            jnp.log(a).astype(ansatz.accum_dtype),
            ph.astype(ansatz.accum_dtype),
        )

    hs0 = tp_zero_state(s, units, k, dtype)
    ns = jnp.arange(ansatz.num_sites)
    _, (log_ampls, phases) = jax.lax.scan(
        step, hs0, (inputs, targets, ns, cum_up)
    )
    return (
        accum_sum(log_ampls, ansatz.accum_dtype),
        accum_sum(phases, ansatz.accum_dtype),
    )


# ---------------------------------------------------------------------------
# 2D MDRNN family (boustrophedon sweep with a tp-sharded cell)
# ---------------------------------------------------------------------------

def shard_params_mdrnn(params: Any, k: int, idx) -> Any:
    """Shard an MDRNN2D parameter pytree for tp-shard ``idx`` of ``k``: all
    four cell matrices (uh/uv input, wh/wv state) take 1/k of their output
    columns (state matrices keep FULL input rows — they consume the
    all-gathered neighbour hiddens), the bias is column-sliced, and the
    head is row-sharded with the same folded-b/k psum/pmean gradient
    contract as the 1D families."""
    c = params["cell"]
    u = c["wh"].shape[-1]
    if u % k != 0:
        raise ValueError(
            f"hidden width {u} is not divisible by tp={k}"
        )
    us = u // k

    def cols(w):
        return jax.lax.dynamic_slice_in_dim(w, idx * us, us, axis=-1)

    cell = {
        "uh": cols(c["uh"]),
        "uv": cols(c["uv"]),
        "wh": cols(c["wh"]),
        "wv": cols(c["wv"]),
        "b": cols(c["b"][None])[0],
    }
    return {"cell": cell, "head": _shard_head(params["head"], k, idx)}


def _tp_mdrnn_apply(pc, xs, h_shards):
    """One tp-sharded 2D-cell step: (B, U/k) neighbour shards -> new shard.
    Both neighbour hiddens are all-gathered for the state contractions
    (two (B, U) gathers per site — the 2D analogue of the 1D trunk's one)."""
    xh, xv = xs
    hh, hv = h_shards
    hh_full = jax.lax.all_gather(hh, TP_AXIS, axis=-1, tiled=True)
    hv_full = jax.lax.all_gather(hv, TP_AXIS, axis=-1, tiled=True)
    acc = (
        jnp.dot(xh, pc["uh"], preferred_element_type=hh.dtype)
        + jnp.dot(xv, pc["uv"], preferred_element_type=hh.dtype)
        + jnp.dot(hh_full, pc["wh"], preferred_element_type=hh.dtype)
        + jnp.dot(hv_full, pc["wv"], preferred_element_type=hh.dtype)
        + pc["b"]
    )
    return jax.nn.elu(acc)


def _tp_mdrnn_sweep(params_shard, batch, nx, ny, units, k, row_xs, site_fn,
                    dtype=jnp.float32, local_dim=2):
    """Boustrophedon sweep with the sharded cell — mirrors
    ``models/mdrnn2d.MDRNN2D._sweep`` / ``._row_scan`` exactly (same flip
    wiring, same scan structure) with (B, Nx, U/k) vertical state carries.
    ``site_fn(logits, col_x) -> (draw, site_logp)`` sees tp-replicated
    psum'd logits, so all members realize identical draws."""
    us = units // k

    def row_scan(v_states, v_inputs, col_xs):
        def step(carry, xs_t):
            h_prev, x_prev = carry
            h_up, x_up, col_x = xs_t
            h = _tp_mdrnn_apply(
                params_shard["cell"], (x_prev, x_up), (h_prev, h_up)
            )
            logits = _tp_head(params_shard["head"], h)
            draw, site_logp = site_fn(logits, col_x)
            x_new = jax.nn.one_hot(draw, local_dim, dtype=dtype)
            return (h, x_new), (h, x_new, draw, site_logp)

        h0 = jnp.zeros((batch, us), dtype)
        x0 = jnp.zeros((batch, local_dim), dtype)
        xs = (
            jnp.moveaxis(v_states, 1, 0),
            jnp.moveaxis(v_inputs, 1, 0),
            col_xs,
        )
        _, (hs, xnews, draws, site_logps) = jax.lax.scan(step, (h0, x0), xs)
        return (
            jnp.moveaxis(hs, 0, 1),
            jnp.moveaxis(xnews, 0, 1),
            draws,
            site_logps,
        )

    from ..models.mdrnn2d import _flip_if as flip_if

    flags = (jnp.arange(ny) % 2).astype(bool)

    def row_step(carry, xs_t):
        v_states, v_inputs = carry
        col_xs, flag = xs_t
        vs = flip_if(flag, v_states, axis=1)
        vi = flip_if(flag, v_inputs, axis=1)
        cx = flip_if(flag, col_xs, axis=0)
        vs_new, vi_new, draws, logps = row_scan(vs, vi, cx)
        return (
            flip_if(flag, vs_new, axis=1),
            flip_if(flag, vi_new, axis=1),
        ), (flip_if(flag, draws, axis=0), flip_if(flag, logps, axis=0))

    v_states0 = jnp.zeros((batch, nx, us), dtype)
    v_inputs0 = jnp.zeros((batch, nx, local_dim), dtype)
    _, (draws, logps) = jax.lax.scan(
        row_step, (v_states0, v_inputs0), (row_xs, flags)
    )
    return draws, logps  # (Ny, Nx, S) each


def tp_mdrnn_log_prob(params_shard, samples: jax.Array, nx: int, ny: int,
                      units: int, k: int, dtype=jnp.float32) -> jax.Array:
    """Teacher-forced joint log p over (B, Nx, Ny) int grids with the
    tp-sharded 2D cell; (B,) tp-replicated."""
    from ..ops.compsum import accum_sum

    batch = samples.shape[0]
    targets = jnp.transpose(samples, (2, 1, 0))  # (Ny, Nx, S)

    def site_fn(logits, target):
        logp = jax.nn.log_softmax(logits, axis=-1)
        site_logp = jnp.take_along_axis(logp, target[:, None], axis=-1)[:, 0]
        return target, site_logp

    _, logps = _tp_mdrnn_sweep(
        params_shard, batch, nx, ny, units, k, targets, site_fn, dtype
    )
    return accum_sum(logps.reshape(-1, logps.shape[-1]), jnp.float32)


def tp_mdrnn_sample_with_log_prob(params_shard, key: jax.Array,
                                  num_samples: int, nx: int, ny: int,
                                  units: int, k: int, dtype=jnp.float32):
    """Autoregressive grid sampling with the tp-sharded 2D cell.  ``key``
    must be identical across the tp group (fold only the dp index) so all
    members draw the same grids.  Returns ((S, Nx, Ny) int32, (S,) logp)."""
    from ..models.prnn1d import inverse_cdf_sample
    from ..ops.compsum import accum_sum

    site_ids = jnp.arange(ny * nx, dtype=jnp.uint32).reshape(ny, nx)

    def site_fn(logits, site_id):
        site_key = jax.random.fold_in(key, site_id)
        logp = jax.nn.log_softmax(logits, axis=-1)
        draw = inverse_cdf_sample(site_key, jnp.exp(logp))
        site_logp = jnp.take_along_axis(logp, draw[:, None], axis=-1)[:, 0]
        return draw, site_logp

    draws, logps = _tp_mdrnn_sweep(
        params_shard, num_samples, nx, ny, units, k, site_ids, site_fn, dtype
    )
    samples = jnp.transpose(draws, (2, 1, 0)).astype(jnp.int32)
    return samples, accum_sum(
        logps.reshape(-1, logps.shape[-1]), jnp.float32
    )
