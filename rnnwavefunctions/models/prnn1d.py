"""1D positive RNN wavefunction (pRNN), optionally parity-symmetrized.

Capability parity with the reference's ``1DTFIM/RNNwavefunction.py`` (plain)
and ``1DTFIM/RNNwavefunction_paritysym.py`` (``parity=True``):

* The site loop is a single ``lax.scan`` body — O(1) compiled program size in
  the number of sites, vs the reference's Python-unrolled O(N) graph
  (``1DTFIM/RNNwavefunction.py:65-70``).
* Sampling uses exact inverse-CDF draws from per-site conditionals (the
  reference's ``tf.multinomial(tf.log(softmax))``,
  ``1DTFIM/RNNwavefunction.py:68``) with one fresh PRNG key per site.
* On a GPU, uniform-width GRU/LSTM stacks in float32 run both rollouts in
  one persistent Pallas kernel (``ops/rollout.py``); the jnp scans below
  are its reference and its gradient.
* ``sample_with_log_prob`` returns the joint log-density as a free by-product
  of the sampling scan (the reference re-runs a separate teacher-forced graph
  for this).
* Log-probabilities are accumulated with ``log_softmax`` directly (never
  ``log(softmax(x))``) in ``accum_dtype`` — the reference promotes to float64
  for this sum (``1DTFIM/RNNwavefunction.py:113-116``); float32 +
  log-softmax meets the 1e-4 energy anchors (verified in tests).
* Parity symmetrization computes ``log(0.5 (p(s) + p(rev s)))``
  (``RNNwavefunction_paritysym.py:145``) as a numerically-stable
  ``logaddexp`` — mathematically identical, overflow-free.  As in the
  reference, only the *density* is symmetrized; sampling stays plain
  autoregressive (``RNNwavefunction_paritysym.py`` sampler is the plain one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from . import cells
from ..ops import rollout
from ..ops.compsum import accum_sum


def inverse_cdf_sample(key: jax.Array, probs: jax.Array) -> jax.Array:
    """Exact categorical draw via inverse CDF. probs: (..., d) -> int32 (...)."""
    u = jax.random.uniform(key, probs.shape[:-1] + (1,), dtype=probs.dtype)
    return inverse_cdf_draw(u[..., 0], probs)


def inverse_cdf_draw(u: jax.Array, probs: jax.Array) -> jax.Array:
    """The draw of ``inverse_cdf_sample`` for given uniforms u: (...)."""
    cdf = jnp.cumsum(probs, axis=-1)
    draw = jnp.sum(u[..., None] >= cdf, axis=-1)
    return jnp.clip(draw, 0, probs.shape[-1] - 1).astype(jnp.int32)


def site_uniforms(key: jax.Array, num_sites: int, num_samples: int,
                  dtype=jnp.float32) -> jax.Array:
    """(N, S) uniforms, row n drawn from the n-th of ``num_sites`` split keys
    exactly as ``inverse_cdf_sample`` draws them site by site."""
    keys = jax.random.split(key, num_sites)
    return jax.vmap(
        lambda k: jax.random.uniform(k, (num_samples, 1), dtype=dtype)[:, 0]
    )(keys)


@dataclasses.dataclass(frozen=True)
class PRNN1D:
    """Positive wavefunction psi(sigma) = sqrt(p(sigma)) with p autoregressive.

    Args:
      num_sites: chain length N.
      units: hidden widths per stacked GRU layer (MultiRNNCell analogue).
      local_dim: on-site Hilbert dimension (2 throughout the reference,
        ``TrainingRNN_1DTFIM.py:100``).
      parity: if True, the density (not the sampler) is symmetrized under
        spatial reflection, as in ``RNNwavefunction_paritysym.py:80-145``.
      dtype: compute dtype for the recurrence.
      accum_dtype: dtype of the log-probability accumulation.
    """

    num_sites: int
    units: Tuple[int, ...] = (50,)
    local_dim: int = 2
    parity: bool = False
    dtype: Any = jnp.float32
    accum_dtype: Any = jnp.float32
    # recurrent cell: "gru" (every reference runner), "lstm" (the snake-2D
    # ansatz signature's default argument,
    # ``2DTFIM_1DRNN/RNNwavefunction.py:9``), or any custom-cell protocol
    # object (init/apply/zero_state — see ``models/cells.py``), mirroring
    # the reference constructor's acceptance of arbitrary TF RNNCell
    # classes (``1DTFIM/RNNwavefunction.py:13``).  GRU and LSTM ride the
    # rollout kernel on a GPU; custom cells run the jnp scan path.
    cell: Any = "gru"

    is_complex: bool = dataclasses.field(default=False, init=False, repr=False)

    @property
    def plain_positive(self) -> bool:
        """True when the sampling density equals the wavefunction density, so
        log psi = 0.5 * (sampling log-prob) without a second pass."""
        return not self.parity

    def _use_kernel(self) -> bool:
        return rollout.use_kernel(
            self.units, self.cell, self.local_dim, self.dtype, self.accum_dtype
        )

    # -- parameters ---------------------------------------------------------

    def init(self, key: jax.Array) -> Any:
        k_rnn, k_head = jax.random.split(key)
        return {
            "rnn": cells.stacked_rnn_init(
                k_rnn, self.local_dim, self.units, self.dtype, self.cell
            ),
            "head": cells.dense_init(k_head, self.units[-1], self.local_dim, self.dtype),
        }

    # -- internals ----------------------------------------------------------

    def _step_logits(self, params, x, hs):
        out, hs = cells.stacked_rnn_apply(params["rnn"], x, hs, self.cell)
        return cells.dense_apply(params["head"], out), hs

    # -- sampling -----------------------------------------------------------

    def sample_with_log_prob(
        self, params: Any, key: jax.Array, num_samples: int
    ) -> Tuple[jax.Array, jax.Array]:
        """Draw ``(num_samples, N)`` int32 spins and their plain (non-
        symmetrized) autoregressive log-density."""
        uniforms = site_uniforms(key, self.num_sites, num_samples, self.dtype)
        if self._use_kernel():
            return rollout.sample(params, uniforms)
        return self._sample_jnp(params, uniforms)

    def _sample_jnp(self, params: Any, uniforms: jax.Array
                    ) -> Tuple[jax.Array, jax.Array]:
        """The sampling scan over given (N, S) uniforms."""
        d = self.local_dim
        num_samples = uniforms.shape[1]

        def step(carry, u):
            x, hs = carry
            logits, hs = self._step_logits(params, x, hs)
            logp = jax.nn.log_softmax(logits, axis=-1)
            draw = inverse_cdf_draw(u, jnp.exp(logp))
            x_next = jax.nn.one_hot(draw, d, dtype=self.dtype)
            site_logp = jnp.take_along_axis(logp, draw[:, None], axis=-1)[:, 0]
            return (x_next, hs), (draw, site_logp.astype(self.accum_dtype))

        x0 = jnp.zeros((num_samples, d), self.dtype)  # the zero "sigma_0" input
        hs0 = cells.stacked_rnn_zero_state(
            num_samples, self.units, self.dtype, self.cell
        )
        _, (draws, site_logps) = jax.lax.scan(step, (x0, hs0), uniforms)
        samples = draws.T  # (N, S) -> (S, N)
        return samples, accum_sum(site_logps, self.accum_dtype)

    def sample(self, params: Any, key: jax.Array, num_samples: int) -> jax.Array:
        return self.sample_with_log_prob(params, key, num_samples)[0]

    # -- densities ----------------------------------------------------------

    def _log_prob_plain(self, params: Any, samples: jax.Array) -> jax.Array:
        """Teacher-forced log p(sigma), through the rollout kernel where it
        applies (the jnp scan is its gradient, see ops/rollout.py)."""
        if self._use_kernel():
            return rollout.log_prob(params, samples, self._log_prob_plain_jnp)
        return self._log_prob_plain_jnp(params, samples)

    def _log_prob_plain_jnp(self, params: Any, samples: jax.Array) -> jax.Array:
        """Teacher-forced log p(sigma) for (S, N) int samples."""
        d = self.local_dim
        s = samples.shape[0]
        onehot = jax.nn.one_hot(samples.T, d, dtype=self.dtype)  # (N, S, d)
        inputs = jnp.concatenate(
            [jnp.zeros((1, s, d), self.dtype), onehot[:-1]], axis=0
        )
        targets = samples.T  # (N, S)

        def step(hs, xs_t):
            x, tgt = xs_t
            logits, hs = self._step_logits(params, x, hs)
            logp = jax.nn.log_softmax(logits, axis=-1)
            site_logp = jnp.take_along_axis(logp, tgt[:, None], axis=-1)[:, 0]
            return hs, site_logp.astype(self.accum_dtype)

        hs0 = cells.stacked_rnn_zero_state(s, self.units, self.dtype, self.cell)
        _, site_logps = jax.lax.scan(step, hs0, (inputs, targets))
        return accum_sum(site_logps, self.accum_dtype)

    def log_prob(self, params: Any, samples: jax.Array) -> jax.Array:
        """log p(sigma); parity-symmetrized when ``parity=True``."""
        lp = self._log_prob_plain(params, samples)
        if not self.parity:
            return lp
        lp_rev = self._log_prob_plain(params, samples[:, ::-1])
        return jnp.logaddexp(lp, lp_rev) - jnp.log(
            jnp.asarray(2.0, dtype=self.accum_dtype)
        )

    def log_amp(self, params: Any, samples: jax.Array) -> jax.Array:
        """log psi = 0.5 log p (positive wavefunction)."""
        return 0.5 * self.log_prob(params, samples)
