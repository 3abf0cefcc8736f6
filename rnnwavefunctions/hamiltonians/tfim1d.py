"""1D transverse-field Ising model, open boundary conditions.

    H = -sum_i Jz_i sigma^z_i sigma^z_{i+1}  -  Bx sum_i sigma^x_i

Semantics match ``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:13-75``:
the diagonal part contributes ``-Jz_i * (+1 if neighbours agree else -1)``
per bond (``:31-38``), and each of the N single-spin flips contributes matrix
element ``-Bx`` (``:74``, where the ``exp(0.5*dlogp)`` amplitude ratio is the
pRNN's ``psi'/psi``).  Spins are integer-encoded 0=down, 1=up.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TFIM1D:
    num_sites: int
    bx: float = 1.0
    jz: Optional[Tuple[float, ...]] = None  # per-bond couplings; default all 1

    @property
    def n_offdiag(self) -> int:
        return self.num_sites

    def _jz(self) -> jax.Array:
        if self.jz is None:
            return jnp.ones((self.num_sites - 1,), jnp.float32)
        return jnp.asarray(self.jz, jnp.float32)[: self.num_sites - 1]

    def diagonal(self, sigma: jax.Array) -> jax.Array:
        z = (2 * sigma - 1).astype(jnp.float32)  # ±1
        return -jnp.sum(self._jz() * z[:-1] * z[1:])

    def connected(self, sigma: jax.Array):
        """sigma: (N,) int -> (diag, flips (N, N), elements (N,), mask (N,))."""
        n = self.num_sites
        diag = self.diagonal(sigma)

        eye = jnp.eye(n, dtype=sigma.dtype)
        flips = jnp.where(eye == 1, 1 - sigma[None, :], sigma[None, :])
        elements = jnp.full((n,), -self.bx, jnp.float32)
        mask = jnp.full((n,), self.bx != 0.0)
        return diag, flips, elements, mask
