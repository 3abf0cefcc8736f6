"""Multi-host initialization.

The reference has no distributed backend at all (single ``tf.Session``;
SURVEY.md §2.4).  The recipe here: every process calls
``jax.distributed.initialize`` with the coordinator's address, the process
count and its own id, then builds the same global 1D ``dp`` mesh over *all*
devices; ``shard_map`` + ``psum`` collectives span the processes.
Monte-Carlo VMC is pure data parallelism, so no
tensor/pipeline sharding is required — chains shard over the global device
count and the psum'd gradient/statistics reductions are the only
communication (a few hundred KB per step for 50-unit models).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import DP_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime.  With no arguments, relies on
    the cluster environment's auto-detection (e.g. SLURM); elsewhere pass
    all three arguments."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh() -> Mesh:
    """1D data-parallel mesh over every device in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (DP_AXIS,))


def is_primary() -> bool:
    """True on the process that should write checkpoints/metrics."""
    return jax.process_index() == 0
