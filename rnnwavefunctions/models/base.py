"""The Ansatz protocol: pure-functional wavefunction modules.

The reference's five ``RNNwavefunction`` classes each own a private TF1 graph
and build unrolled sample / log-probability subgraphs on demand
(``/root/reference/1DTFIM/RNNwavefunction.py:20,35,76``).  Here an ansatz is a
frozen dataclass of *static* configuration; all state lives in an explicit
parameter pytree, so the same object works under ``jit``, ``vmap``, ``grad``,
and ``shard_map`` without graph bookkeeping.

Protocol (duck-typed; see ``PRNN1D`` for the canonical implementation):

* ``init(key) -> params``                       — parameter pytree
* ``sample(params, key, num_samples) -> sigma`` — autoregressive exact
  sampling; integer encoding ``0 = down, 1 = up`` as in the reference.
* ``sample_with_log_prob(params, key, n)``      — same, plus the log of the
  density the samples were drawn from (free by-product of the scan).
* ``log_amp(params, sigma) -> (S,)``            — log wavefunction amplitude
  log psi(sigma).  Real-valued for positive ansatze (= 0.5 * log p), complex64
  for the cRNN.  This is the single interface the Hamiltonian/local-energy
  machinery consumes, unifying the reference's ``log_probability`` /
  ``log_amplitude`` split (``1DTFIM/RNNwavefunction.py:76``,
  ``J1J2/ComplexRNNwavefunction.py:105``).
* ``log_prob(params, sigma) -> (S,)``           — log of the *sampling/
  gradient* density.  For positive ansatze this is the (optionally parity-
  symmetrized) log p; for the cRNN it is ``2 * Re(log_amp)``.
* ``is_complex: bool``                          — head type marker.
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

import jax


@runtime_checkable
class Ansatz(Protocol):
    is_complex: bool

    def init(self, key: jax.Array) -> Any: ...

    def sample(self, params: Any, key: jax.Array, num_samples: int) -> jax.Array: ...

    def sample_with_log_prob(
        self, params: Any, key: jax.Array, num_samples: int
    ) -> Tuple[jax.Array, jax.Array]: ...

    def log_amp(self, params: Any, samples: jax.Array) -> jax.Array: ...

    def log_prob(self, params: Any, samples: jax.Array) -> jax.Array: ...
