"""True 2D RNN wavefunction: MDRNN cell, boustrophedon autoregressive sweep.

Capability parity with ``/root/reference/2DTFIM_2DRNN/RNNwavefunction.py``:

* sites visited left-to-right on even rows, right-to-left on odd rows
  (``:90-113``); each site's cell consumes the (input, state) pair of its
  horizontal predecessor *in visit order* and of its vertical neighbour in
  the previous row (``:96,108``);
* zero states and zero one-hot inputs are injected on the lattice boundary
  (``:70-87``);
* one shared cell for all sites (``:32``), softmax dense head, exact
  categorical site draws (``:99``).

Structure: the reference's dict-of-tensors per site
(``rnn_states[str(nx)+str(ny)]``) and doubly-unrolled Python loops become a
``lax.scan`` over rows carrying a row-of-states/(row-of-inputs), with an
inner ``lax.scan`` over columns — O(1) program size in lattice area.  The
boustrophedon direction alternation is handled by flipping the carried row
arrays (and per-row targets/keys) into visit order for odd rows and flipping
results back to lattice order, which reproduces the reference's neighbour
wiring exactly.

Samples are ``(S, Nx, Ny)`` int32 grids indexed [sample, x, y]
(``:116``), consumed by ``TFIM2D(encoding="grid")``.  The reference runs this
ansatz in float64 (``:32``); compute dtype is configurable, float32 default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from . import cells
from ..ops.compsum import accum_sum
from .prnn1d import inverse_cdf_sample


def _flip_if(flag, x, axis):
    """Reverse ``x`` along ``axis`` when ``flag`` (scalar bool) is set."""
    return jnp.where(flag, jnp.flip(x, axis=axis), x)


@dataclasses.dataclass(frozen=True)
class MDRNN2D:
    """Positive 2D RNN wavefunction psi = sqrt(p) over an Nx x Ny lattice."""

    nx: int
    ny: int
    units: int = 50
    local_dim: int = 2
    dtype: Any = jnp.float32
    accum_dtype: Any = jnp.float32

    is_complex: bool = dataclasses.field(default=False, init=False, repr=False)

    @property
    def plain_positive(self) -> bool:
        return True

    def init(self, key: jax.Array) -> Any:
        k_cell, k_head = jax.random.split(key)
        return {
            "cell": cells.mdrnn_init(k_cell, self.local_dim, self.units, self.dtype),
            "head": cells.dense_init(k_head, self.units, self.local_dim, self.dtype),
        }

    # -- shared row sweep ---------------------------------------------------

    def _row_scan(self, params, batch, v_states, v_inputs, col_xs, site_fn):
        """Scan one row left-to-right (visit order).

        ``v_states``/``v_inputs``: (S, Nx, U) / (S, Nx, d) vertical carries in
        visit order.  ``col_xs``: per-column extra scan inputs (keys or
        targets), leading axis Nx.  ``site_fn(logits, col_x) -> (draw,
        site_logp)`` where ``draw`` is the spin realized at the site.
        Returns (new_v_states, new_v_inputs, draws, site_logps), leading axis
        Nx for the scanned outputs.
        """
        d = self.local_dim

        def step(carry, xs):
            h_prev, x_prev = carry
            h_up, x_up, col_x = xs
            h = cells.mdrnn_apply(
                params["cell"], (x_prev, x_up), (h_prev, h_up)
            )
            logits = cells.dense_apply(params["head"], h)
            draw, site_logp = site_fn(logits, col_x)
            x_new = jax.nn.one_hot(draw, d, dtype=self.dtype)
            return (h, x_new), (h, x_new, draw, site_logp)

        h0 = jnp.zeros((batch, self.units), self.dtype)
        x0 = jnp.zeros((batch, d), self.dtype)
        # scan over columns: v_states (S, Nx, U) -> xs (Nx, S, U)
        xs = (
            jnp.moveaxis(v_states, 1, 0),
            jnp.moveaxis(v_inputs, 1, 0),
            col_xs,
        )
        _, (hs, xnews, draws, site_logps) = jax.lax.scan(step, (h0, x0), xs)
        return (
            jnp.moveaxis(hs, 0, 1),     # (S, Nx, U)
            jnp.moveaxis(xnews, 0, 1),  # (S, Nx, d)
            draws,                      # (Nx, S)
            site_logps,                 # (Nx, S)
        )

    def _sweep(self, params, batch, row_xs, site_fn):
        """Boustrophedon sweep over all rows.

        ``row_xs``: per-row extra inputs with leading axes (Ny, Nx, ...).
        Returns (draws, logps) with shapes (Ny, Nx, S) in lattice order.
        """
        flags = (jnp.arange(self.ny) % 2).astype(bool)

        def row_step(carry, xs):
            v_states, v_inputs = carry
            col_xs, flag = xs
            # into visit order for this row
            vs = _flip_if(flag, v_states, axis=1)
            vi = _flip_if(flag, v_inputs, axis=1)
            cx = _flip_if(flag, col_xs, axis=0)
            vs_new, vi_new, draws, logps = self._row_scan(
                params, batch, vs, vi, cx, site_fn
            )
            # back to lattice order
            vs_new = _flip_if(flag, vs_new, axis=1)
            vi_new = _flip_if(flag, vi_new, axis=1)
            draws = _flip_if(flag, draws, axis=0)
            logps = _flip_if(flag, logps, axis=0)
            return (vs_new, vi_new), (draws, logps)

        v_states0 = jnp.zeros((batch, self.nx, self.units), self.dtype)
        v_inputs0 = jnp.zeros((batch, self.nx, self.local_dim), self.dtype)
        _, (draws, logps) = jax.lax.scan(
            row_step, (v_states0, v_inputs0), (row_xs, flags)
        )
        return draws, logps  # (Ny, Nx, S) each

    # -- sampling -----------------------------------------------------------

    def sample_with_log_prob(
        self, params: Any, key: jax.Array, num_samples: int
    ) -> Tuple[jax.Array, jax.Array]:
        # integer site ids (not key arrays) thread through the flip logic;
        # each site derives its key by folding its id into the base key.
        site_ids = jnp.arange(self.ny * self.nx, dtype=jnp.uint32).reshape(
            self.ny, self.nx
        )

        def site_fn(logits, site_id):
            site_key = jax.random.fold_in(key, site_id)
            logp = jax.nn.log_softmax(logits, axis=-1)
            draw = inverse_cdf_sample(site_key, jnp.exp(logp))
            site_logp = jnp.take_along_axis(logp, draw[:, None], axis=-1)[:, 0]
            return draw, site_logp.astype(self.accum_dtype)

        draws, logps = self._sweep(params, num_samples, site_ids, site_fn)
        samples = jnp.transpose(draws, (2, 1, 0))  # (Ny, Nx, S) -> (S, Nx, Ny)
        return samples.astype(jnp.int32), accum_sum(
            logps.reshape(-1, logps.shape[-1]), self.accum_dtype
        )

    def sample(self, params: Any, key: jax.Array, num_samples: int) -> jax.Array:
        return self.sample_with_log_prob(params, key, num_samples)[0]

    # -- densities ----------------------------------------------------------

    def log_prob(self, params: Any, samples: jax.Array) -> jax.Array:
        batch = samples.shape[0]
        targets = jnp.transpose(samples, (2, 1, 0))  # (S, Nx, Ny) -> (Ny, Nx, S)

        def site_fn(logits, target):
            logp = jax.nn.log_softmax(logits, axis=-1)
            site_logp = jnp.take_along_axis(logp, target[:, None], axis=-1)[:, 0]
            return target, site_logp.astype(self.accum_dtype)

        _, logps = self._sweep(params, batch, targets, site_fn)
        return accum_sum(
            logps.reshape(-1, logps.shape[-1]), self.accum_dtype
        )

    def log_amp(self, params: Any, samples: jax.Array) -> jax.Array:
        return 0.5 * self.log_prob(params, samples)
