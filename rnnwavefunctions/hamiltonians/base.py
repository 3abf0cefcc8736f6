"""Hamiltonian protocol: static-shape connected-configuration expansion.

The reference computes local energies on the *host* with NumPy, queuing
flipped configurations into scratch arrays and calling ``sess.run`` per chunk
(``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:13-75``,
``J1J2/TrainingRNN_J1J2.py:95-127``).  This protocol instead
describes, for a *single* configuration ``sigma``, all configurations
connected to it by the Hamiltonian, with a **static** connectivity bound so
the whole expansion lives in-graph (vmapped over the Monte-Carlo batch, XLA
static shapes):

    connected(sigma) -> (diag, flips, elements, mask)

* ``diag``:      scalar <sigma|H|sigma>.
* ``flips``:     (K, *sigma.shape) int array of connected configurations
                 sigma' (padded rows arbitrary).
* ``elements``:  (K,) matrix elements <sigma'|H|sigma> for the off-diagonal
                 terms.
* ``mask``:      (K,) bool; False rows are padding (the J1-J2 chain has
                 per-sample variable connectivity, which the reference handles
                 with Python ``slice`` objects — here it becomes a mask over
                 the fixed 2N bound, ``TrainingRNN_J1J2.py:234-239``).

The local energy then is
``E_loc = diag + sum_k mask_k * elements_k * psi(sigma'_k)/psi(sigma)``
with the amplitude ratios evaluated in one large batched pass,
see ``vmc/local_energy.py``.
"""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import jax


@runtime_checkable
class Hamiltonian(Protocol):
    #: static off-diagonal connectivity bound K
    n_offdiag: int

    def connected(
        self, sigma: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]: ...
