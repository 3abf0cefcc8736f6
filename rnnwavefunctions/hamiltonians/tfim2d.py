"""2D transverse-field Ising model, open boundaries, on an Nx x Ny lattice.

    H = -Jz sum_<ij> sigma^z_i sigma^z_j  -  Bx sum_i sigma^x_i

Two sample encodings, matching the two reference 2D workloads:

* ``encoding="flat"``  — samples are (Nx*Ny,) vectors in autoregressive scan
  order (y-major: flat index i = y*Nx + x), as produced by the snake-ordered
  1D ansatz (``/root/reference/2DTFIM_1DRNN/RNNwavefunction.py:74-75``).
  Note the reference's estimator reshapes the flat vector as [Nx, Ny]
  (``Training1DRNN_2DTFIM.py:28``) which only agrees with its own sampler's
  y-major order for square lattices (where the transposed lattice is
  isomorphic); here layout and estimator are consistent for any Nx, Ny.
* ``encoding="grid"``  — samples are (Nx, Ny) grids indexed [x, y], as
  produced by the 2D MDRNN ansatz
  (``/root/reference/2DTFIM_2DRNN/RNNwavefunction.py:116``, estimator
  ``Training2DRNN_2DTFIM.py:33-61``).

Diagonal: ``-Jz * (+1 if neighbours agree else -1)`` per lattice bond, both
directions; off-diagonal: Nx*Ny single-spin flips with element ``-Bx`` and
the pRNN amplitude-ratio contraction (``Training1DRNN_2DTFIM.py:79``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TFIM2D:
    """``jz`` is either a scalar (uniform couplings) or an (Nx, Ny) array —
    the reference estimator's signature takes a per-site coupling array
    where ``Jz[i, j]`` weights both the (i,j)-(i+1,j) and (i,j)-(i,j+1)
    bonds (``Training1DRNN_2DTFIM.py:13,33-49``: row bonds use ``Jz[i, :]``,
    column bonds ``Jz[:, i]``)."""

    nx: int
    ny: int
    bx: float = 2.0
    jz: Union[float, tuple] = 1.0
    encoding: str = "flat"  # "flat" (y-major vector) or "grid" ((nx, ny) array)

    def __post_init__(self):
        if self.encoding not in ("flat", "grid"):
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if not np.isscalar(self.jz):
            arr = np.asarray(self.jz, np.float32)
            if arr.shape != (self.nx, self.ny):
                raise ValueError(
                    f"per-bond jz must be ({self.nx}, {self.ny}); "
                    f"got {arr.shape}"
                )
            # store hashable (frozen dataclasses are used as static config)
            object.__setattr__(
                self, "jz", tuple(tuple(float(v) for v in row) for row in arr)
            )

    @property
    def n_sites(self) -> int:
        return self.nx * self.ny

    @property
    def n_offdiag(self) -> int:
        return self.n_sites

    def _grid(self, sigma: jax.Array) -> jax.Array:
        """Return the sample as a (ny, nx) array indexed [y, x]."""
        if self.encoding == "flat":
            return sigma.reshape(self.ny, self.nx)
        return sigma.T  # (nx, ny) -> (ny, nx)

    def _jz_yx(self):
        """Per-site couplings as a (ny, nx) array ([y, x] indexing, matching
        ``_grid``), or None for the uniform-scalar case."""
        if np.isscalar(self.jz):
            return None
        return jnp.asarray(np.asarray(self.jz, np.float32).T)

    def diagonal(self, sigma: jax.Array) -> jax.Array:
        g = self._grid(sigma)
        z = (2 * g - 1).astype(jnp.float32)
        jzt = self._jz_yx()
        if jzt is None:
            return -self.jz * (
                jnp.sum(z[:, :-1] * z[:, 1:]) + jnp.sum(z[:-1, :] * z[1:, :])
            )
        # bond (x,y)-(x+1,y) weighted by Jz[x,y]; (x,y)-(x,y+1) by Jz[x,y]
        return -(
            jnp.sum(jzt[:, :-1] * z[:, :-1] * z[:, 1:])
            + jnp.sum(jzt[:-1, :] * z[:-1, :] * z[1:, :])
        )

    def connected(self, sigma: jax.Array):
        n = self.n_sites
        diag = self.diagonal(sigma)

        flat = sigma.reshape(-1)
        eye = jnp.eye(n, dtype=sigma.dtype)
        flips = jnp.where(eye == 1, 1 - flat[None, :], flat[None, :])
        flips = flips.reshape((n,) + sigma.shape)
        elements = jnp.full((n,), -self.bx, jnp.float32)
        mask = jnp.full((n,), self.bx != 0.0)
        return diag, flips, elements, mask
