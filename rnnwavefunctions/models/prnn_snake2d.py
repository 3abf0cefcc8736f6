"""Snake-ordered 1D pRNN over a 2D lattice.

Capability parity with ``/root/reference/2DTFIM_1DRNN/RNNwavefunction.py``:
the same 1D GRU ansatz, iterated over the Nx x Ny lattice in row-major
(y-major) order — the reference's nested ``for ny: for nx:`` loops
(``:74-75,118-119``) are exactly a 1D chain over flat index ``y*Nx + x``, so
this module *is* a ``PRNN1D`` over ``Nx*Ny`` sites plus lattice metadata.
Samples are flat ``(S, Nx*Ny)`` vectors in scan order, consumed by
``TFIM2D(encoding="flat")``.  (The reference defaults this ansatz to float64,
``2DTFIM_1DRNN/RNNwavefunction.py:38`` — here the compute dtype is
configurable, float32 by default.)
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp

from .prnn1d import PRNN1D


def PRNNSnake2D(
    nx: int,
    ny: int,
    units: Tuple[int, ...] = (50,),
    local_dim: int = 2,
    dtype: Any = jnp.float32,
    accum_dtype: Any = jnp.float32,
    cell: Any = "gru",
) -> PRNN1D:
    """A PRNN1D over the flattened (y-major) Nx x Ny lattice.

    ``cell`` mirrors the reference signature's cell argument (default LSTM
    there, ``2DTFIM_1DRNN/RNNwavefunction.py:9``, though every shipped
    runner passes GRU — GRU stays the default); like
    the reference it also accepts any custom-cell protocol object
    (``models/cells.py``)."""
    ansatz = PRNN1D(
        num_sites=nx * ny,
        units=units,
        local_dim=local_dim,
        dtype=dtype,
        accum_dtype=accum_dtype,
        cell=cell,
    )
    # attach lattice metadata without breaking dataclass frozen-ness
    object.__setattr__(ansatz, "lattice", (nx, ny))
    return ansatz
