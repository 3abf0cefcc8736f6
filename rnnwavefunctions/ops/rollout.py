"""Persistent autoregressive rollout of a GRU/LSTM stack, Pallas Triton route.

The jnp path (``lax.scan`` over sites, ``models/prnn1d.py``) launches a few
kernels per site and moves the hidden state and gate activations through
device memory at each of the N dependent sites; XLA does not fuse across
loop iterations.  Here one program owns a block of sample rows and walks
all N sites inside the kernel (a ``fori_loop``), so the recurrent weights
are loaded once per program, the hidden state never leaves the block, and
device-memory traffic is "read the spins once, write the log-probs once".

Two kernels share one site step:

* ``log_prob`` -- teacher-forced joint log-probability of given spin rows,
  the inner loop of the connected-configuration local-energy estimator and
  the forward of the surrogate loss.  A ``jax.custom_vjp`` whose backward
  is the VJP of the jnp scan (the backward runs over the S drawn rows only).
* ``sample``   -- autoregressive sampling from (N, S) uniforms drawn by
  ``jax.random`` outside the kernel; with the same uniforms the jnp sampler
  draws the same spins (``models/prnn1d.inverse_cdf_draw``).

Coverage: uniform-width GRU or LSTM stacks with on-site dimension 2 in
float32 (``covers``).  ``use_kernel`` takes the kernel on a GPU within that
coverage; every other configuration, and every other platform, runs the
jnp scan.

Layout: sample-major blocks.  Hidden widths are zero-padded to a power of
two ``UP`` (>= 16, the smallest ``tl.dot`` operand); padded hidden units
stay exactly zero through both cells, so padding changes no value.  Gates
are split into separate (UP, UP) matrices because a register tensor cannot
be sliced along non-power-of-two boundaries.  The two-class one-hot input
of layer 0 is a select between two rows of W_x, not a product.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .compsum import kadd, kfinal

GATES = {"gru": 3, "lstm": 4}
_MIN_DOT = 16  # smallest operand dimension of a tensor-core product
# Register budget of one program, in float32 gate elements (rows x UP x G):
# on an H100, 32 rows of a 64-wide GRU (6144) ran fastest, and 64 rows of
# it, or 32 of a 64-wide LSTM, spilled and ran 1.1-2x slower.
_GATE_ELEMENTS = 32 * 64 * 3
_TARGET_PROGRAMS = 264  # two blocks for each of an H100's 132 SMs


def _platform() -> str:
    """Platform the computation is placed on: the ambient default device
    when one is set (``jax.default_device``), else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def covers(units, cell, local_dim, dtype, accum_dtype) -> bool:
    """Configurations the kernels implement."""
    return (
        isinstance(cell, str)
        and cell in GATES
        and len(set(units)) == 1
        and local_dim == 2
        and jnp.dtype(dtype) == jnp.float32
        and jnp.dtype(accum_dtype) == jnp.float32
    )


def use_kernel(units, cell, local_dim, dtype, accum_dtype) -> bool:
    """The kernels run on a GPU within coverage; the jnp scan elsewhere."""
    return _platform() == "gpu" and covers(
        units, cell, local_dim, dtype, accum_dtype
    )


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def block_rows(batch: int, up: int, num_gates: int) -> int:
    """Rows per program: enough programs to fill the card, within the
    register budget of the (rows, UP) gates, at least ``_MIN_DOT``."""
    cap = _MIN_DOT
    while 2 * cap * up * num_gates <= _GATE_ELEMENTS:
        cap *= 2
    want = -(-batch // _TARGET_PROGRAMS)
    return min(cap, _pow2_at_least(want, _MIN_DOT))


def _dot_precision(interpret: bool):
    """Precision of the kernel's products under the ambient
    ``jax.default_matmul_precision``: "highest" (or "float32") takes three
    TF32 passes, which keep float32 accuracy on the tensor cores (Triton's
    exact-float32 product runs without them, ~10x slower than the scan on
    an H100); anything else takes one TF32 pass, as XLA's default does.
    The CPU interpreter has no TF32 and computes in float32 throughout."""
    prec = jax.config.jax_default_matmul_precision
    if prec is None or str(prec).lower() not in ("highest", "float32"):
        return None
    if interpret:
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def padded_units(units: int) -> int:
    return _pow2_at_least(units, _MIN_DOT)


def _cell_kind(params) -> str:
    """LSTM layers carry one fused bias ``b``; GRU layers ``bx``/``bh``
    (``models/cells.py``)."""
    return "lstm" if "b" in params["rnn"][0] else "gru"


def pack_weights(params, up: int):
    """Kernel operands from a PRNN1D parameter pytree.

    Returns ``(wx, wh, b, hw, hb)``: ``wx``/``wh`` of shape (L, G, UP, UP)
    with gate g of layer l at ``[l, g]`` (layer 0's ``wx`` holds the two
    one-hot rows in rows 0 and 1); ``b`` of shape (L, 2, G, UP) holding
    the input and recurrent biases (an LSTM's single bias as the input
    bias, zeros as the recurrent one); ``hw`` (2, UP) the head's two logit
    rows and ``hb`` (2,) its bias.  Zero padding everywhere."""
    kind = _cell_kind(params)
    g = GATES[kind]
    wx, wh, b = [], [], []
    for cell in params["rnn"]:
        u = cell["wh"].shape[0]

        def gates(m):  # (in, G*u) -> (G, UP, UP)
            m = m.reshape(m.shape[0], g, u).transpose(1, 0, 2)
            return jnp.pad(m, ((0, 0), (0, up - m.shape[1]), (0, up - u)))

        def gate_bias(v):  # (G*u,) -> (G, UP)
            return jnp.pad(v.reshape(g, u), ((0, 0), (0, up - u)))

        wx.append(gates(cell["wx"]))
        wh.append(gates(cell["wh"]))
        if kind == "lstm":
            bias = gate_bias(cell["b"])
            b.append(jnp.stack([bias, jnp.zeros_like(bias)]))
        else:
            b.append(jnp.stack([gate_bias(cell["bx"]), gate_bias(cell["bh"])]))
    head = params["head"]
    u = head["w"].shape[0]
    hw = jnp.pad(head["w"].T, ((0, 0), (0, up - u)))
    return (jnp.stack(wx), jnp.stack(wh), jnp.stack(b), hw, head["b"])


# ---------------------------------------------------------------------------
# the site step (shared by both kernels)
# ---------------------------------------------------------------------------


def _load_weights(wx_ref, wh_ref, b_ref, num_layers, num_gates):
    """Loop-invariant operands, loaded once per program."""
    layers = []
    for l in range(num_layers):
        if l == 0:
            wx = [(wx_ref[0, k, 0, :][None, :], wx_ref[0, k, 1, :][None, :])
                  for k in range(num_gates)]
        else:
            wx = [wx_ref[l, k, :, :] for k in range(num_gates)]
        wh = [wh_ref[l, k, :, :] for k in range(num_gates)]
        bx = [b_ref[l, 0, k, :][None, :] for k in range(num_gates)]
        bh = [b_ref[l, 1, k, :][None, :] for k in range(num_gates)]
        layers.append((wx, wh, bx, bh))
    return layers


def _site(x0, x1, states, layers, hw0, hw1, hb0, hb1, kind, precision):
    """One site of the stack and its head.

    ``(x0, x1)`` (T, 1) each: the previous spin's one-hot components, both
    zero on the first site (the chain starts from the zero vector).
    ``states``: per layer ``h`` (GRU) or ``(h, c)`` (LSTM), each (T, UP).
    Returns (new states, logit 0, logit 1), the logits of shape (T,)."""
    def dot(a, b):
        return pl.dot(a, b, precision=precision)

    new_states = []
    inp = None
    for l, (wx, wh, bx, bh) in enumerate(layers):
        if l == 0:
            gx = [x0 * w0 + x1 * w1 + b for (w0, w1), b in zip(wx, bx)]
        else:
            gx = [dot(inp, w) + b for w, b in zip(wx, bx)]
        if kind == "gru":
            h = states[l]
            gh = [dot(h, w) + b for w, b in zip(wh, bh)]
            r = jax.nn.sigmoid(gx[0] + gh[0])
            z = jax.nn.sigmoid(gx[1] + gh[1])
            c = jnp.tanh(gx[2] + r * gh[2])
            h = z * h + (1.0 - z) * c
            new_states.append(h)
        else:
            h, c = states[l]
            g = [a + dot(h, w) + b for a, w, b in zip(gx, wh, bh)]
            c = c * jax.nn.sigmoid(g[2] + 1.0) + jax.nn.sigmoid(g[0]) * jnp.tanh(g[1])
            h = jnp.tanh(c) * jax.nn.sigmoid(g[3])
            new_states.append((h, c))
        inp = h
    l0 = jnp.sum(inp * hw0, axis=1) + hb0
    l1 = jnp.sum(inp * hw1, axis=1) + hb1
    return tuple(new_states), l0, l1


def _log_softmax2(l0, l1):
    """(log p0, log p1) with ``jax.nn.log_softmax``'s arithmetic."""
    m = jnp.maximum(l0, l1)
    lse = jnp.log(jnp.exp(l0 - m) + jnp.exp(l1 - m))
    return l0 - m - lse, l1 - m - lse


def _zero_states(rows, up, num_layers, kind):
    z = jnp.zeros((rows, up), jnp.float32)
    return tuple(z if kind == "gru" else (z, z) for _ in range(num_layers))


def _make_kernel(num_layers: int, kind: str, sampling: bool, precision):
    num_gates = GATES[kind]

    def kernel(seq_ref, wx_ref, wh_ref, b_ref, hw_ref, hb_ref, *out_refs):
        n_sites, rows = seq_ref.shape
        up = hw_ref.shape[1]
        layers = _load_weights(wx_ref, wh_ref, b_ref, num_layers, num_gates)
        hw0, hw1 = hw_ref[0, :][None, :], hw_ref[1, :][None, :]
        hb0, hb1 = hb_ref[0], hb_ref[1]

        def body(n, carry):
            states, x0, x1, acc, cmp = carry
            states, l0, l1 = _site(
                x0[:, None], x1[:, None], states, layers, hw0, hw1, hb0, hb1,
                kind, precision,
            )
            lp0, lp1 = _log_softmax2(l0, l1)
            if sampling:
                # inverse-CDF draw over two classes: spin 1 iff u >= p0
                s = jnp.where(seq_ref[n, :] >= jnp.exp(lp0), 1.0, 0.0)
                out_refs[0][n, :] = s.astype(jnp.int32)
            else:
                s = seq_ref[n, :].astype(jnp.float32)
            acc, cmp = kadd(acc, cmp, jnp.where(s > 0.5, lp1, lp0))
            return states, 1.0 - s, s, acc, cmp

        z = jnp.zeros((rows,), jnp.float32)
        carry = (_zero_states(rows, up, num_layers, kind), z, z, z, z)
        _, _, _, acc, cmp = jax.lax.fori_loop(0, n_sites, body, carry)
        out_refs[-1][:] = kfinal(acc, cmp)

    return kernel


def _call(params, seq: jax.Array, sampling: bool, interpret: bool):
    """Run a kernel over ``seq`` (N, B): spins for ``log_prob``, uniforms
    for ``sample``.  Returns (samples (N, B) int32 or None, logp (B,))."""
    n, batch = seq.shape
    kind = _cell_kind(params)
    num_layers = len(params["rnn"])
    up = padded_units(params["rnn"][0]["wh"].shape[0])
    rows = block_rows(batch, up, GATES[kind])
    padded = -(-batch // rows) * rows
    seq = jnp.pad(seq, ((0, 0), (0, padded - batch)))
    operands = pack_weights(params, up)

    def full(a):
        return pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)

    logp_shape = jax.ShapeDtypeStruct((padded,), jnp.float32)
    logp_spec = pl.BlockSpec((rows,), lambda i: (i,))
    seq_spec = pl.BlockSpec((n, rows), lambda i: (0, i))
    if sampling:
        out_shape = (jax.ShapeDtypeStruct((n, padded), jnp.int32), logp_shape)
        out_specs = (seq_spec, logp_spec)
    else:
        out_shape, out_specs = (logp_shape,), (logp_spec,)
    outs = pl.pallas_call(
        _make_kernel(num_layers, kind, sampling, _dot_precision(interpret)),
        grid=(padded // rows,),
        in_specs=[seq_spec] + [full(a) for a in operands],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=f"prnn_{'sample' if sampling else 'log_prob'}_{kind}",
    )(seq, *operands)
    logp = outs[-1][:batch]
    return (outs[0][:, :batch] if sampling else None), logp


def sample(params, uniforms: jax.Array, interpret: bool = False
           ) -> Tuple[jax.Array, jax.Array]:
    """Autoregressive draw from (N, S) uniforms in [0, 1).  Returns
    (samples (S, N) int32, log p of each drawn row (S,))."""
    samples, logp = _call(params, uniforms, True, interpret)
    return samples.T, logp


def log_prob(params, samples: jax.Array, reference: Callable,
             interpret: bool = False) -> jax.Array:
    """Teacher-forced log p of (S, N) spin rows.  ``reference(params,
    samples)`` is the jnp scan whose VJP is the gradient."""
    return _log_prob(reference, interpret, params, samples)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _log_prob(reference, interpret, params, samples):
    return _call(params, samples.T.astype(jnp.int32), False, interpret)[1]


def _log_prob_fwd(reference, interpret, params, samples):
    return _log_prob(reference, interpret, params, samples), (params, samples)


def _log_prob_bwd(reference, interpret, res, g):
    params, samples = res
    _, vjp = jax.vjp(lambda p: reference(p, samples), params)
    return vjp(g)[0], None


_log_prob.defvjp(_log_prob_fwd, _log_prob_bwd)
