"""Per-sample log-derivative rows (the minSR ``O`` matrix), restructured
for device-memory traffic.

``vmap(grad(log_amp))`` — the generic path in ``vmc/minsr.py`` — is
mathematically right but XLA schedules it as a backward ``lax.scan`` whose
carry holds the per-sample weight-gradient accumulator: an (S, P) block
(16 MB at the flagship N=100, U=50, S=500, P~8k) read and written on every
one of the N backward steps — ~3 GB of device-memory round trips per jacobian, which
is why a minSR step ran ~4x slower than an Adam step (PARITY.md "known
bounds").

This module computes the same rows with the standard stash-and-contract
BPTT factorization.  A recurrent layer's per-sample weight gradients
factorize through its per-step gate cotangents:

    O_Wx[s] = sum_t x_t[s] (x) dgate_t[s],
    O_Wh[s] = sum_t h_{t-1}[s] (x) dgate_t[s],

so the backward scan only needs to emit ``dgate_t`` per step (its carry is
the (S, U) recurrence cotangent — 100 kB, not 16 MB), and the per-sample
weight rows come from ONE batched time-axis matmul per weight tensor
(``einsum('tsi,tsg->sig')`` — matrix-unit work, ~0.4 GFLOP at the
flagship shape).

The cell's nonlinear step ``F`` is differentiated with ``jax.vjp`` inside
the backward scan body — no hand-derived gate math; only the
linear/nonlinear split is written per cell kind, mirroring
``models/cells.py`` (``gru_apply``/``lstm_apply`` are the semantics
oracles).  ``vmap(grad)`` on the jnp scan path remains the equality oracle
(``tests/test_minsr.py``).

Reference context: the reference has no natural-gradient method at all
(Adam only, ``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:113``); this
file exists to make the beyond-reference minSR optimizer's per-step cost
competitive with an Adam step.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# cell nonlinearities, split from their linear pre-activations
# (semantics oracles: cells.gru_apply / cells.lstm_apply)
# ---------------------------------------------------------------------------


def _gru_f(gx: jax.Array, gh: jax.Array, h: jax.Array) -> jax.Array:
    """cells.gru_apply with the two matmul pre-activations factored out."""
    u = h.shape[-1]
    rx, zx, cx = gx[..., :u], gx[..., u : 2 * u], gx[..., 2 * u :]
    rh, zh, ch = gh[..., :u], gh[..., u : 2 * u], gh[..., 2 * u :]
    r = jax.nn.sigmoid(rx + rh)
    z = jax.nn.sigmoid(zx + zh)
    c = jnp.tanh(cx + r * ch)
    return z * h + (1.0 - z) * c


def _lstm_f(glin: jax.Array, c: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """cells.lstm_apply past the single fused matmul: (glin, c) -> (h', c')."""
    u = c.shape[-1]
    i, j = glin[..., :u], glin[..., u : 2 * u]
    f, o = glin[..., 2 * u : 3 * u], glin[..., 3 * u :]
    c_new = c * jax.nn.sigmoid(f + 1.0) + jax.nn.sigmoid(i) * jnp.tanh(j)
    h_new = jnp.tanh(c_new) * jax.nn.sigmoid(o)
    return h_new, c_new


# ---------------------------------------------------------------------------
# forward rollout with stashed pre-step states
# ---------------------------------------------------------------------------


def _rollout(
    rnn_params: Sequence[Any], cell: str, inputs: jax.Array
) -> Tuple[List[Any], List[Any], jax.Array]:
    """Teacher-forced stack rollout over ``inputs`` (N, S, d).

    Returns ``(prevs, finals, top_out)``:
      prevs:   per layer, the PRE-step state at every step — (N, S, U)
               arrays for GRU, ((N,S,U) h, (N,S,U) c) pairs for LSTM;
      finals:  per layer, the state after the last step;
      top_out: (N, S, U_top) top-layer outputs (the head inputs).
    """
    from ..models import cells

    s = inputs.shape[1]
    units = [p["wh"].shape[0] for p in rnn_params]
    dtype = inputs.dtype

    def body(states, x_t):
        new_states = []
        inp = x_t
        for p, st in zip(rnn_params, states):
            if cell == "gru":
                inp = cells.gru_apply(p, inp, st)
                new_states.append(inp)
            else:
                inp, st_new = cells.lstm_apply(p, inp, st)
                new_states.append(st_new)
        return tuple(new_states), (states, inp)

    init = cells.stacked_rnn_zero_state(s, units, dtype, cell)
    finals, (prevs, top_out) = jax.lax.scan(body, init, inputs)
    return list(prevs), list(finals), top_out


def _layer_inputs(
    inputs: jax.Array, prevs: List[Any], finals: List[Any], cell: str
) -> List[jax.Array]:
    """Per-layer input sequence x^l_t: the one-hot feed for layer 0, the
    layer-below POST-step output for l>0 (= its pre-step state shifted one
    step, closed with the final state)."""
    xs = [inputs]
    for prev, fin in zip(prevs[:-1], finals[:-1]):
        h_prev = prev[0] if cell == "lstm" else prev
        h_fin = fin[0] if cell == "lstm" else fin
        xs.append(jnp.concatenate([h_prev[1:], h_fin[None]], axis=0))
    return xs


# ---------------------------------------------------------------------------
# backward sweep: emit per-step gate cotangents
# ---------------------------------------------------------------------------


def _bptt(
    rnn_params: Sequence[Any],
    cell: str,
    xs: List[jax.Array],
    prevs: List[Any],
    dout: jax.Array,
) -> List[Any]:
    """Reverse-time sweep producing the stacked gate cotangents.

    ``dout`` (N, S, U_top) is the cotangent on the top-layer output at each
    step (head seeds), or (P, N, S, U_top) for P independent seed sets that
    share one primal linearization (the cRNN's Re/Im heads): the per-step
    pre-activations and the ``jax.vjp`` of the gate nonlinearity are
    computed ONCE, with the cotangent-linear half vmapped over the P axis —
    one N-step serial scan instead of P.

    Returns, per layer, ``(dgx, dgh)`` (N, S, 3U) for GRU or ``dglin``
    (N, S, 4U) for LSTM; with a parts axis the shapes gain a leading
    (N, P, ...) pair in scan-emission order.
    """
    multi = dout.ndim == 4
    dparts = dout if multi else dout[None]
    n_parts = dparts.shape[0]
    n_layers = len(rnn_params)
    s = dparts.shape[2]
    dtype = dparts.dtype

    def body(carry, xs_t):
        x_ts, prev_ts, dout_t = xs_t  # dout_t: (P, S, U_top)
        new_carry = [None] * n_layers
        emitted = [None] * n_layers
        d_above = dout_t  # cotangent on layer l's output at this step
        for l in reversed(range(n_layers)):
            p = rnn_params[l]
            if cell == "gru":
                h_prev = prev_ts[l]
                gx = jnp.dot(x_ts[l], p["wx"]) + p["bx"]
                gh = jnp.dot(h_prev, p["wh"]) + p["bh"]
                _, f_vjp = jax.vjp(_gru_f, gx, gh, h_prev)
                dgx, dgh, dh_direct = jax.vmap(f_vjp)(d_above + carry[l])
                new_carry[l] = dh_direct + jnp.dot(dgh, p["wh"].T)
                emitted[l] = (dgx, dgh)
                if l:
                    d_above = jnp.dot(dgx, p["wx"].T)
            else:
                h_prev, c_prev = prev_ts[l]
                glin = (
                    jnp.dot(x_ts[l], p["wx"])
                    + jnp.dot(h_prev, p["wh"])
                    + p["b"]
                )
                dh_in, dc_in = carry[l]
                _, f_vjp = jax.vjp(_lstm_f, glin, c_prev)
                dglin, dc_prev = jax.vmap(f_vjp)((d_above + dh_in, dc_in))
                new_carry[l] = (jnp.dot(dglin, p["wh"].T), dc_prev)
                emitted[l] = dglin
                if l:
                    d_above = jnp.dot(dglin, p["wx"].T)
        return tuple(new_carry), tuple(emitted)

    def zero(u):
        z = jnp.zeros((n_parts, s, u), dtype)
        return (z, z) if cell == "lstm" else z

    init = tuple(zero(p["wh"].shape[0]) for p in rnn_params)
    _, dgates = jax.lax.scan(
        body, init,
        (tuple(xs), tuple(prevs), jnp.moveaxis(dparts, 0, 1)),
        reverse=True,
    )
    if multi:
        return list(dgates)
    return [
        jax.tree.map(lambda a: a[:, 0], dg) for dg in dgates
    ]


# ---------------------------------------------------------------------------
# contraction: gate cotangents -> per-sample weight rows (batched einsums)
# ---------------------------------------------------------------------------


def _contract_layer(cell: str, x: jax.Array, prev: Any, dg: Any) -> Any:
    if cell == "gru":
        dgx, dgh = dg
        return {
            "wx": jnp.einsum("tsi,tsg->sig", x, dgx),
            "wh": jnp.einsum("tsu,tsg->sug", prev, dgh),
            "bx": jnp.sum(dgx, axis=0),
            "bh": jnp.sum(dgh, axis=0),
        }
    h_prev = prev[0]
    return {
        "wx": jnp.einsum("tsi,tsg->sig", x, dg),
        "wh": jnp.einsum("tsu,tsg->sug", h_prev, dg),
        "b": jnp.sum(dg, axis=0),
    }


# ---------------------------------------------------------------------------
# PRNN1D (plain / parity / snake-2D): per-sample rows of log p
# ---------------------------------------------------------------------------


def _prnn1d_log_prob_rows(
    ansatz: Any, params: Any, samples: jax.Array
) -> Tuple[jax.Array, Any]:
    """(log p(sigma), per-sample grad-of-log-p pytree with (S, ...) leaves)
    for the plain (non-symmetrized) autoregressive density
    (``models/prnn1d.PRNN1D._log_prob_plain_jnp`` is the primal twin)."""
    d = ansatz.local_dim
    s = samples.shape[0]
    dtype = ansatz.dtype
    onehot = jax.nn.one_hot(samples.T, d, dtype=dtype)  # (N, S, d)
    inputs = jnp.concatenate(
        [jnp.zeros((1, s, d), dtype), onehot[:-1]], axis=0
    )

    prevs, finals, top_out = _rollout(params["rnn"], ansatz.cell, inputs)
    xs = _layer_inputs(inputs, prevs, finals, ansatz.cell)

    # head: site_logp_t = log_softmax(out_t W + b)[target_t]
    logits = jnp.dot(top_out, params["head"]["w"]) + params["head"]["b"]
    logp_site = jax.nn.log_softmax(logits, axis=-1)
    picked = jnp.take_along_axis(
        logp_site, samples.T[..., None], axis=-1
    )[..., 0]
    log_prob = jnp.sum(picked.astype(ansatz.accum_dtype), axis=0).astype(dtype)

    # d site_logp / d logits = onehot(target) - softmax(logits)
    dlogits = onehot - jnp.exp(logp_site)  # (N, S, d); onehot == one_hot(tgt)
    dout = jnp.dot(dlogits, params["head"]["w"].T)

    dgates = _bptt(params["rnn"], ansatz.cell, xs, prevs, dout)
    rows = {
        "rnn": [
            _contract_layer(ansatz.cell, x, pv, dg)
            for x, pv, dg in zip(xs, prevs, dgates)
        ],
        "head": {
            "w": jnp.einsum("tsu,tsd->sud", top_out, dlogits),
            "b": jnp.sum(dlogits, axis=0),
        },
    }
    return log_prob, rows


def prnn1d_log_amp_rows(ansatz: Any, params: Any, samples: jax.Array) -> Any:
    """Per-sample grad rows of log psi = 0.5 log p for a PRNN1D (plain,
    parity-symmetrized, or snake-2D flat), as a pytree of (S, ...) leaves
    matching the params structure."""
    lp1, g1 = _prnn1d_log_prob_rows(ansatz, params, samples)
    if not ansatz.parity:
        return jax.tree.map(lambda g: 0.5 * g, g1)
    # d log((p + p_rev)/2) = w d log p + (1-w) d log p_rev,
    # w = p/(p + p_rev) = sigmoid(lp - lp_rev)
    # (primal twin: models/prnn1d.PRNN1D.log_prob's logaddexp form)
    lp2, g2 = _prnn1d_log_prob_rows(ansatz, params, samples[:, ::-1])
    w = jax.nn.sigmoid(lp1 - lp2)

    def mix(a, b):
        wv = w.reshape((-1,) + (1,) * (a.ndim - 1)).astype(a.dtype)
        return 0.5 * (wv * a + (1.0 - wv) * b)

    return jax.tree.map(mix, g1, g2)


# ---------------------------------------------------------------------------
# MDRNN2D (boustrophedon 2D sweep): per-sample rows of log psi
# ---------------------------------------------------------------------------


def _flip_if(flag, x, axis):
    return jnp.where(flag, jnp.flip(x, axis=axis), x)


def mdrnn2d_log_amp_rows(ansatz: Any, params: Any, samples: jax.Array) -> Any:
    """Per-sample grad rows of log psi = 0.5 log p for an MDRNN2D, as a
    pytree of (S, ...) leaves (``models/mdrnn2d.MDRNN2D.log_prob`` is
    the primal twin).

    The cell is linear + elu (``cells.mdrnn_apply``), so the per-sample
    weight rows factorize through the per-site pre-activation cotangent
    ``dacc``:  O_Wh[s] = sum_sites hh (x) dacc  etc.  The backward is a
    reverse boustrophedon sweep: within a row the cotangent flows to the
    visit-order predecessor through Wh, across rows to the same column
    through Wv; elu' is recovered from the stashed hidden state
    (elu'(acc) = 1 for h > 0 else h + 1 — exact for alpha = 1).
    """
    from ..models import cells

    d = ansatz.local_dim
    u = ansatz.units
    s = samples.shape[0]
    dtype = ansatz.dtype
    targets = jnp.transpose(samples, (2, 1, 0))  # (S,Nx,Ny) -> (Ny,Nx,S)
    onehot = jax.nn.one_hot(targets, d, dtype=dtype)  # (Ny, Nx, S, d)
    flags = (jnp.arange(ansatz.ny) % 2).astype(bool)

    # ---- forward sweep, stashing every site's hidden state --------------
    def fwd_row(carry, xs):
        v_states, v_inputs = carry  # (S, Nx, U), (S, Nx, d) lattice order
        x_row, flag = xs  # (Nx, S, d) one-hots of this row's spins
        vs = _flip_if(flag, v_states, 1)
        vi = _flip_if(flag, v_inputs, 1)
        xr = _flip_if(flag, x_row, 0)

        def step(c, xs_c):
            h_prev, x_prev = c
            h_up, x_up, x_self = xs_c
            h = cells.mdrnn_apply(
                params["cell"], (x_prev, x_up), (h_prev, h_up)
            )
            return (h, x_self), h

        h0 = jnp.zeros((s, u), dtype)
        x0 = jnp.zeros((s, d), dtype)
        _, hs = jax.lax.scan(
            step, (h0, x0),
            (jnp.moveaxis(vs, 1, 0), jnp.moveaxis(vi, 1, 0), xr),
        )
        hs_lat = _flip_if(flag, hs, 0)  # (Nx, S, U) lattice order
        return (jnp.moveaxis(hs_lat, 0, 1), jnp.moveaxis(x_row, 0, 1)), hs_lat

    carry0 = (
        jnp.zeros((s, ansatz.nx, u), dtype),
        jnp.zeros((s, ansatz.nx, d), dtype),
    )
    _, h_all = jax.lax.scan(fwd_row, carry0, (onehot, flags))
    # h_all: (Ny, Nx, S, U)

    # ---- head seeds ------------------------------------------------------
    logits = jnp.dot(h_all, params["head"]["w"]) + params["head"]["b"]
    dlogits = onehot - jax.nn.softmax(logits, axis=-1)
    dhead = jnp.dot(dlogits, params["head"]["w"].T)  # (Ny, Nx, S, U)

    # ---- reverse boustrophedon sweep: emit per-site dacc ------------------
    wh_t = params["cell"]["wh"].T
    wv_t = params["cell"]["wv"].T

    def bwd_row(dvert, xs):
        dhead_row, h_row, flag = xs  # (Nx, S, U) lattice order
        db = _flip_if(flag, dhead_row + dvert, 0)
        hv_row = _flip_if(flag, h_row, 0)

        def col_step(c, xs_c):
            db_t, h_t = xs_c
            dh = db_t + c
            dacc = dh * jnp.where(h_t > 0, 1.0, h_t + 1.0)
            return jnp.dot(dacc, wh_t), dacc

        _, dacc_v = jax.lax.scan(
            col_step, jnp.zeros((s, u), dtype), (db, hv_row), reverse=True
        )
        dacc_row = _flip_if(flag, dacc_v, 0)  # lattice order
        return jnp.dot(dacc_row, wv_t), dacc_row

    _, dacc = jax.lax.scan(
        bwd_row, jnp.zeros((ansatz.nx, s, u), dtype),
        (dhead, h_all, flags), reverse=True,
    )  # (Ny, Nx, S, U)

    # ---- neighbour arrays (lattice order) and the contraction -------------
    def shift_h(a):  # horizontal visit-order predecessor
        right = jnp.pad(a[:, :-1], ((0, 0), (1, 0)) + ((0, 0),) * (a.ndim - 2))
        left = jnp.pad(a[:, 1:], ((0, 0), (0, 1)) + ((0, 0),) * (a.ndim - 2))
        f = flags.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(f, left, right)

    def shift_v(a):  # vertical neighbour = previous row, same column
        return jnp.pad(a[:-1], ((1, 0),) + ((0, 0),) * (a.ndim - 1))

    def con(a, dg):
        return jnp.einsum("yxsi,yxsg->sig", a, dg)

    rows = {
        "cell": {
            "uh": con(shift_h(onehot), dacc),
            "uv": con(shift_v(onehot), dacc),
            "wh": con(shift_h(h_all), dacc),
            "wv": con(shift_v(h_all), dacc),
            "b": jnp.sum(dacc, axis=(0, 1)),
        },
        "head": {
            "w": jnp.einsum("yxsu,yxsd->sud", h_all, dlogits),
            "b": jnp.sum(dlogits, axis=(0, 1)),
        },
    }
    return jax.tree.map(lambda g: 0.5 * g, rows)  # log psi = 0.5 log p


# ---------------------------------------------------------------------------
# CRNNU1 (complex, U(1)-masked two-head): per-sample rows of (Re, Im) log psi
# ---------------------------------------------------------------------------


def crnn_head_seeds(
    ansatz: Any, params: Any, top_out: jax.Array,
    targets: jax.Array, cum_up: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Per-site logit cotangents ``(dlogits_a, dlogits_p)``, each (N, S, 2),
    of Re/Im log psi w.r.t. the two heads' logits — the U(1)-masked
    sqsoftmax amplitude head and the pi*softsign phase head
    (``models/crnn_u1.CRNNU1`` semantics)."""
    n, s = targets.shape
    dtype = top_out.dtype
    ns = jnp.arange(n)
    logits_a = jnp.dot(top_out, params["head_ampl"]["w"]) + params["head_ampl"]["b"]
    logits_p = jnp.dot(top_out, params["head_phase"]["w"]) + params["head_phase"]["b"]

    def re_from_logits(la):
        ampl = jnp.sqrt(jax.nn.softmax(la, axis=-1))  # sqsoftmax
        masked = jax.vmap(ansatz._masked_ampl)(ampl, ns, cum_up)
        a = jnp.take_along_axis(masked, targets[..., None], axis=-1)[..., 0]
        return jnp.log(a)

    def im_from_logits(lp):
        phase = jnp.pi * jax.nn.soft_sign(lp)
        return jnp.take_along_axis(phase, targets[..., None], axis=-1)[..., 0]

    ones = jnp.ones((n, s), dtype)
    _, vjp_a = jax.vjp(re_from_logits, logits_a)
    (dlogits_a,) = vjp_a(ones)
    _, vjp_p = jax.vjp(im_from_logits, logits_p)
    (dlogits_p,) = vjp_p(ones)
    return dlogits_a, dlogits_p


def _crnn_zero_head_rows(p: Any, s: int) -> Any:
    return jax.tree.map(lambda w: jnp.zeros((s,) + w.shape, w.dtype), p)


def crnn_log_amp_rows(
    ansatz: Any, params: Any, samples: jax.Array
) -> Tuple[Any, Any]:
    """Per-sample grad rows of (Re log psi, Im log psi) for a CRNNU1, as two
    pytrees of (S, ...) leaves matching the params structure
    (``models/crnn_u1.CRNNU1.log_amp_parts`` is the primal twin).

    The two heads are independent functions of the trunk output (Re flows
    only through the sqsoftmax+U(1)-mask amplitude head, Im only through
    the pi*softsign phase head), so each part seeds its own trunk backward
    sweep.  Like the jnp VJP, gradients are only defined for in-sector
    configurations (the off-sector forward is the log of a masked, zero
    amplitude) — the sampler never draws those.
    """
    d = ansatz.local_dim
    s = samples.shape[0]
    n = ansatz.num_sites
    dtype = ansatz.dtype
    targets = samples.T  # (N, S)
    onehot = jax.nn.one_hot(targets, d, dtype=dtype)
    inputs = jnp.concatenate(
        [jnp.zeros((1, s, d), dtype), onehot[:-1]], axis=0
    )
    cum_up = jnp.concatenate(
        [jnp.zeros((1, s), jnp.int32), jnp.cumsum(targets, axis=0)[:-1]],
        axis=0,
    )

    prevs, finals, top_out = _rollout(params["rnn"], ansatz.cell, inputs)
    xs = _layer_inputs(inputs, prevs, finals, ansatz.cell)

    dlogits_a, dlogits_p = crnn_head_seeds(
        ansatz, params, top_out, targets, cum_up
    )

    # Both head seeds share the trunk primal: one joint backward sweep
    # (parts axis in _bptt) instead of two N-step serial scans.
    dout = jnp.stack(
        [
            jnp.dot(dlogits_a, params["head_ampl"]["w"].T),
            jnp.dot(dlogits_p, params["head_phase"]["w"].T),
        ]
    )  # (2, N, S, U_top)
    dgates = _bptt(params["rnn"], ansatz.cell, xs, prevs, dout)

    def part(idx, dlogits):
        rnn_rows = [
            _contract_layer(
                ansatz.cell, x, pv, jax.tree.map(lambda a: a[:, idx], dg)
            )
            for x, pv, dg in zip(xs, prevs, dgates)
        ]
        head_rows = {
            "w": jnp.einsum("tsu,tsd->sud", top_out, dlogits),
            "b": jnp.sum(dlogits, axis=0),
        }
        return rnn_rows, head_rows

    rnn_re, head_re = part(0, dlogits_a)
    rnn_im, head_im = part(1, dlogits_p)
    rows_re = {
        "rnn": rnn_re,
        "head_ampl": head_re,
        "head_phase": _crnn_zero_head_rows(params["head_phase"], s),
    }
    rows_im = {
        "rnn": rnn_im,
        "head_ampl": _crnn_zero_head_rows(params["head_ampl"], s),
        "head_phase": head_im,
    }
    return rows_re, rows_im


def log_amp_rows(ansatz: Any, params: Any, samples: jax.Array) -> Any:
    """Per-sample grad rows of (real) log psi for any supported real
    ansatz, as a params-shaped pytree of (S, ...) leaves."""
    from ..models.mdrnn2d import MDRNN2D

    if type(ansatz) is MDRNN2D:
        return mdrnn2d_log_amp_rows(ansatz, params, samples)
    return prnn1d_log_amp_rows(ansatz, params, samples)


def supports(ansatz: Any) -> bool:
    """Fast-jacobian coverage: built-in GRU/LSTM stacked PRNN1D ansatze
    (incl. parity and snake-2D), CRNNU1, and MDRNN2D.  Everything else
    keeps the generic vmap-of-grad path in ``vmc/minsr.py``."""
    from ..models.crnn_u1 import CRNNU1
    from ..models.mdrnn2d import MDRNN2D
    from ..models.prnn1d import PRNN1D

    if type(ansatz) is MDRNN2D:
        return ansatz.local_dim == 2
    return (
        type(ansatz) in (PRNN1D, CRNNU1)
        and ansatz.cell in ("gru", "lstm")
        and ansatz.local_dim == 2
    )
