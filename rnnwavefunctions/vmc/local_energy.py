"""In-graph local-energy estimation.

The reference evaluates off-diagonal amplitude ratios by round-tripping every
training step through the host: build flip configurations in NumPy, feed them
back through ``sess.run`` in <=25k/30k-row chunks, contract on the host
(``1DTFIM/TrainingRNN_1DTFIM.py:42-74``,
``J1J2/TrainingRNN_J1J2.py:255-279``).  Here the whole estimator is one traced
function: vmapped connected-config expansion, one large batched log-amplitude
evaluation (optionally chunked with ``lax.map`` to bound device memory — the
in-graph analogue of the reference's host-side chunk loop), and a masked
contraction.  It runs under ``stop_gradient``: local energies are data for the
surrogate loss, exactly like the reference's ``Eloc`` placeholder.

Complex wavefunctions are handled **without complex dtypes**: log psi is a
real pair (Re, Im) and the ratio contraction uses
``exp(dRe) * (cos(dIm), sin(dIm))``.  Local energies are returned as
``(e_re, e_im, log_amp)``; ``e_im`` is ``None`` for real ansatze.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp


def _chunked_apply(fn: Callable, flat: jax.Array, chunk_size: Optional[int]):
    """Apply ``fn`` (returning an array or tuple of arrays with the same
    leading axis) over the leading axis of ``flat`` in fixed-size chunks via
    ``lax.map`` (static chunk count; tail padded with row 0 and discarded)."""
    total = flat.shape[0]
    if chunk_size is None or chunk_size >= total:
        return fn(flat)
    num_chunks = -(-total // chunk_size)
    padded = num_chunks * chunk_size
    if padded != total:
        pad = jnp.broadcast_to(flat[:1], (padded - total,) + flat.shape[1:])
        flat = jnp.concatenate([flat, pad], axis=0)
    chunks = flat.reshape((num_chunks, chunk_size) + flat.shape[1:])
    out = jax.lax.map(fn, chunks)
    return jax.tree.map(
        lambda o: o.reshape((padded,) + o.shape[2:])[:total], out
    )


def make_local_energy_fn(
    ansatz: Any,
    hamiltonian: Any,
    chunk_size: Optional[int] = None,
) -> Callable:
    """Returns ``local_energy(params, samples, log_amp_samples) ->
    (e_re, e_im | None, log_amp_samples)``.

    ``log_amp_samples`` is log psi of the drawn samples (the denominator of
    every amplitude ratio, ``TrainingRNN_1DTFIM.py:74`` /
    ``TrainingRNN_J1J2.py:279``) — a real array for positive ansatze, an
    ``(Re, Im)`` pair for complex ones.  It is passed through as the third
    output.
    """
    is_complex = getattr(ansatz, "is_complex", False)

    def local_energy(params, samples, log_amp_samples):
        diag, flips, elements, mask = jax.vmap(hamiltonian.connected)(samples)
        s, k = flips.shape[0], flips.shape[1]
        flat = flips.reshape((s * k,) + flips.shape[2:])

        if is_complex:
            la_re, la_im = _chunked_apply(
                lambda c: ansatz.log_amp_parts(params, c), flat, chunk_size
            )
            la_re = la_re.reshape(s, k)
            la_im = la_im.reshape(s, k)
            s_re, s_im = log_amp_samples
            d_re = la_re - s_re[:, None]
            d_im = la_im - s_im[:, None]
            mag = jnp.exp(d_re)
            el = elements.astype(mag.dtype)
            w = jnp.where(mask, el * mag, 0.0)
            off_re = jnp.sum(w * jnp.cos(d_im), axis=1)
            off_im = jnp.sum(w * jnp.sin(d_im), axis=1)
            return (
                diag.astype(off_re.dtype) + off_re,
                off_im,
                log_amp_samples,
            )

        la = _chunked_apply(
            lambda c: ansatz.log_amp(params, c), flat, chunk_size
        ).reshape(s, k)
        ratios = jnp.exp(la - log_amp_samples[:, None])
        contrib = elements.astype(ratios.dtype) * ratios
        offdiag = jnp.sum(jnp.where(mask, contrib, 0.0), axis=1)
        return diag.astype(offdiag.dtype) + offdiag, None, log_amp_samples

    return local_energy
