"""Complex RNN wavefunction with built-in U(1) zero-magnetization symmetry.

Capability parity with ``/root/reference/J1J2/ComplexRNNwavefunction.py``:
psi(sigma) = prod_n ampl_n(sigma_n) * exp(i phase_n(sigma_n)) with a shared
GRU trunk and two heads:

* amplitude head with ``sqsoftmax = sqrt(softmax)`` activation (``:5-6,42``);
* phase head with ``pi * softsign`` activation (``:8-9,43``).

U(1) constraint (exact semantics of ``:85-93`` / ``:147-155``): for sites
``n >= N/2`` the amplitude vector is multiplied by
``[H(b - num_down), H(b - num_up)]`` with baseline ``b = N//2 - 1``,
``num_up``/``num_down`` the counts among already-fixed spins, and
``H = heavyside with H(0) = 1`` (the reference's ``sign(sign(x)+0.1)`` trick,
``:11-13``), then L2-renormalized with epsilon 1e-30.  This zeroes any choice
that would push either spin count past N/2, so every sample has exactly zero
magnetization (even N).  Sampling draws from ``ampl**2`` (``:95``); the phase
head is only evaluated in ``log_amp`` (the sampler never computes it, as in
the reference).

The site loop is one ``lax.scan`` whose carry holds (hidden states, previous
one-hot, running up-count); log amplitude accumulates as separate real (log
ampl) and imaginary (phase) float32 sums, combined into a complex64 only at
the end — no complex arithmetic inside the scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from . import cells
from ..ops.compsum import accum_sum
from .prnn1d import inverse_cdf_sample


def _heavyside(x: jax.Array) -> jax.Array:
    """Reference ``heavyside`` with H(0) = 1 (ComplexRNNwavefunction.py:11-13)."""
    return jnp.where(x >= 0, 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class CRNNU1:
    num_sites: int
    units: Tuple[int, ...] = (10,)
    local_dim: int = 2
    u1: bool = True  # enforce zero magnetization
    # recurrent trunk: "gru" (the reference's cudnn-GRU trunk), "lstm", or a
    # custom-cell protocol object (models/cells.py ``ElmanCell`` docs) — the
    # reference constructor takes any TF RNNCell
    # (``J1J2/ComplexRNNwavefunction.py:16``).
    cell: Any = "gru"
    dtype: Any = jnp.float32
    accum_dtype: Any = jnp.float32

    is_complex: bool = dataclasses.field(default=True, init=False, repr=False)

    @property
    def plain_positive(self) -> bool:
        return False

    def init(self, key: jax.Array) -> Any:
        k_rnn, k_a, k_p = jax.random.split(key, 3)
        return {
            "rnn": cells.stacked_rnn_init(k_rnn, self.local_dim, self.units, self.dtype, self.cell),
            "head_ampl": cells.dense_init(k_a, self.units[-1], self.local_dim, self.dtype),
            "head_phase": cells.dense_init(k_p, self.units[-1], self.local_dim, self.dtype),
        }

    # -- internals ----------------------------------------------------------

    def _masked_ampl(self, ampl, n, num_up):
        """Apply the U(1) mask + L2 renormalization at site index ``n``."""
        nf = n.astype(ampl.dtype)
        baseline = jnp.asarray(self.num_sites // 2 - 1, ampl.dtype)
        num_up = num_up.astype(ampl.dtype)
        num_down = nf - num_up
        act_up = _heavyside(baseline - num_up)
        act_down = _heavyside(baseline - num_down)
        masked = ampl * jnp.stack([act_down, act_up], axis=-1)
        norm = jnp.sqrt(
            jnp.maximum(jnp.sum(masked**2, axis=-1, keepdims=True), 1e-30)
        )
        masked = masked / norm
        active = (2 * n >= self.num_sites) & jnp.asarray(self.u1)
        return jnp.where(active, masked, ampl)

    def _site_ampl(self, params, x, hs, n, num_up):
        """One trunk step; returns (masked amplitude vector, trunk out, hs)."""
        out, hs = cells.stacked_rnn_apply(params["rnn"], x, hs, self.cell)
        logits = cells.dense_apply(params["head_ampl"], out)
        ampl = jnp.sqrt(jax.nn.softmax(logits, axis=-1))  # sqsoftmax
        ampl = self._masked_ampl(ampl, n, num_up)
        return ampl, out, hs

    # -- sampling -----------------------------------------------------------

    def sample_with_log_prob(
        self, params: Any, key: jax.Array, num_samples: int
    ) -> Tuple[jax.Array, jax.Array]:
        d = self.local_dim

        def step(carry, xs):
            x, hs, num_up = carry
            n, site_key = xs
            ampl, _, hs = self._site_ampl(params, x, hs, n, num_up)
            probs = ampl**2
            draw = inverse_cdf_sample(site_key, probs)
            site_logp = jnp.log(
                jnp.take_along_axis(probs, draw[:, None], axis=-1)[:, 0]
            )
            x_next = jax.nn.one_hot(draw, d, dtype=self.dtype)
            return (x_next, hs, num_up + draw), (
                draw,
                site_logp.astype(self.accum_dtype),
            )

        x0 = jnp.zeros((num_samples, d), self.dtype)
        hs0 = cells.stacked_rnn_zero_state(num_samples, self.units, self.dtype, self.cell)
        up0 = jnp.zeros((num_samples,), jnp.int32)
        ns = jnp.arange(self.num_sites)
        keys = jax.random.split(key, self.num_sites)
        _, (draws, site_logps) = jax.lax.scan(step, (x0, hs0, up0), (ns, keys))
        return draws.T, accum_sum(site_logps, self.accum_dtype)

    def sample(self, params: Any, key: jax.Array, num_samples: int) -> jax.Array:
        return self.sample_with_log_prob(params, key, num_samples)[0]

    # -- densities ----------------------------------------------------------

    def log_amp_parts(self, params: Any, samples: jax.Array):
        """Teacher-forced log psi as a real pair ``(Re, Im)`` — the hot path
        never materializes a complex dtype.
        Semantics: ``ComplexRNNwavefunction.py:105-169``."""
        d = self.local_dim
        s = samples.shape[0]
        onehot = jax.nn.one_hot(samples.T, d, dtype=self.dtype)  # (N, S, d)
        inputs = jnp.concatenate(
            [jnp.zeros((1, s, d), self.dtype), onehot[:-1]], axis=0
        )
        targets = samples.T
        # up-counts among already-fixed spins, per site: (N, S)
        cum_up = jnp.concatenate(
            [jnp.zeros((1, s), jnp.int32), jnp.cumsum(targets, axis=0)[:-1]],
            axis=0,
        )

        def step(hs, xs_t):
            x, tgt, n, num_up = xs_t
            ampl, out, hs = self._site_ampl(params, x, hs, n, num_up)
            phase = jnp.pi * jax.nn.soft_sign(
                cells.dense_apply(params["head_phase"], out)
            )
            a = jnp.take_along_axis(ampl, tgt[:, None], axis=-1)[:, 0]
            ph = jnp.take_along_axis(phase, tgt[:, None], axis=-1)[:, 0]
            return hs, (
                jnp.log(a).astype(self.accum_dtype),
                ph.astype(self.accum_dtype),
            )

        hs0 = cells.stacked_rnn_zero_state(s, self.units, self.dtype, self.cell)
        ns = jnp.arange(self.num_sites)
        _, (log_ampls, phases) = jax.lax.scan(
            step, hs0, (inputs, targets, ns, cum_up)
        )
        return (
            accum_sum(log_ampls, self.accum_dtype),
            accum_sum(phases, self.accum_dtype),
        )

    def log_amp(self, params: Any, samples: jax.Array) -> jax.Array:
        """Complex log psi, (S,) complex64.  Convenience view over
        ``log_amp_parts`` for analysis/tests; the training path stays real."""
        re, im = self.log_amp_parts(params, samples)
        return jax.lax.complex(re, im)

    def log_prob(self, params: Any, samples: jax.Array) -> jax.Array:
        """log |psi|^2 = 2 Re log psi (the sampling density)."""
        return 2.0 * self.log_amp_parts(params, samples)[0]
