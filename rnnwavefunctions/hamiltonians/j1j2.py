"""J1-J2 Heisenberg chain with optional Marshall sign rotation.

    H = sum_i J1_i S_i.S_{i+1} + J2_i S_i.S_{i+2} + Bz_i S^z_i

Matrix-element semantics follow ``J1J2MatrixElements``
(``/root/reference/J1J2/TrainingRNN_J1J2.py:12-93``):

* diagonal: ``Bz.(sigma - 1/2)`` plus ``±J/4`` per (anti)aligned NN/NNN pair
  (minus when anti-aligned, ``:46-57``);
* off-diagonal: spin-exchange of each *anti-aligned* NN pair with element
  ``-J1/2`` under the Marshall sign rotation else ``+J1/2`` (``:68-81``),
  and of each anti-aligned NNN pair with ``+J2/2`` (``:83-92``).

The reference's variable per-sample connectivity (``slice`` bookkeeping,
``:113-127``) becomes a *static* bound of 2N off-diagonal slots with a
validity mask — slot ``i`` is the NN exchange at bond ``i``; slot ``N+i`` the
NNN exchange at ``i`` — so the whole expansion is XLA-shape-stable.

Bug fixed, not copied: the reference call site passes ``Marshall_sign`` into
the ``periodic`` parameter slot (``TrainingRNN_J1J2.py:118``; SURVEY.md §2.2
quirk 1), so its Marshall sign was never applied and PBC was silently toggled
instead.  Here both flags are explicit keywords wired correctly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class J1J2:
    num_sites: int
    j1: float = 1.0
    j2: float = 0.0
    bz: float = 0.0
    periodic: bool = False
    marshall_sign: bool = False

    @property
    def n_offdiag(self) -> int:
        return 2 * self.num_sites

    def diagonal(self, sigma: jax.Array) -> jax.Array:
        n = self.num_sites
        valid_nn, valid_nnn = self._pair_masks()
        neq1 = sigma != jnp.roll(sigma, -1)
        neq2 = sigma != jnp.roll(sigma, -2)
        sgn1 = jnp.where(neq1, -1.0, 1.0)
        sgn2 = jnp.where(neq2, -1.0, 1.0)
        return (
            jnp.sum(self.bz * (sigma.astype(jnp.float32) - 0.5))
            + 0.25 * self.j1 * jnp.sum(jnp.where(valid_nn, sgn1, 0.0))
            + 0.25 * self.j2 * jnp.sum(jnp.where(valid_nnn, sgn2, 0.0))
        )

    def _pair_masks(self):
        """Static per-bond validity: (valid_nn, valid_nnn) boolean (N,)."""
        n = self.num_sites
        lim1 = n if self.periodic else n - 1
        lim2 = n if self.periodic else n - 2
        idx = np.arange(n)
        return jnp.asarray(idx < lim1), jnp.asarray(idx < lim2)

    def connected(self, sigma: jax.Array):
        n = self.num_sites
        valid_nn, valid_nnn = self._pair_masks()
        neq1 = sigma != jnp.roll(sigma, -1)
        neq2 = sigma != jnp.roll(sigma, -2)
        diag = self.diagonal(sigma)

        # exchange configurations: flip both members of each pair
        # (equivalent to swapping them when they are anti-aligned, which is
        # the only case that survives the mask)
        eye = np.eye(n, dtype=np.int32)
        pair1 = jnp.asarray(eye + np.roll(eye, 1, axis=1))  # row i: sites i, (i+1)%n
        pair2 = jnp.asarray(eye + np.roll(eye, 2, axis=1))  # row i: sites i, (i+2)%n
        flips_nn = jnp.where(pair1 == 1, 1 - sigma[None, :], sigma[None, :])
        flips_nnn = jnp.where(pair2 == 1, 1 - sigma[None, :], sigma[None, :])
        flips = jnp.concatenate([flips_nn, flips_nnn], axis=0)  # (2N, N)

        el_nn = jnp.full((n,), (-self.j1 / 2) if self.marshall_sign else (self.j1 / 2), jnp.float32)
        el_nnn = jnp.full((n,), self.j2 / 2, jnp.float32)
        elements = jnp.concatenate([el_nn, el_nnn], axis=0)

        mask_nn = valid_nn & neq1 & (self.j1 != 0.0)
        mask_nnn = valid_nnn & neq2 & (self.j2 != 0.0)
        mask = jnp.concatenate([mask_nn, mask_nnn], axis=0)
        return diag, flips, elements, mask
