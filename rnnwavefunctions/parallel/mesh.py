"""Device mesh and collective utilities for data-parallel VMC.

The reference is strictly single-device (one ``tf.Session`` on one GPU,
``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:119-122``; SURVEY.md §2.4).
The scaling story: Monte-Carlo chains are embarrassingly parallel, so we
shard the sample axis over a 1D ``Mesh`` axis ``"dp"`` and reduce energy
statistics and gradients with ``psum``/``pmean`` across devices (NCCL on
GPUs).  Parameters and optimizer state are replicated; every device applies
the identical psum'd update.  Multi-host runs use the same code path after
``jax.distributed.initialize()``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DP_AXIS = "dp"


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1D data-parallel mesh over (a prefix of) the available devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            # silently truncating would double every per-device batch and
            # quietly break throughput/memory assumptions sized for the
            # requested mesh
            raise ValueError(
                f"make_mesh: requested {num_devices} devices but only "
                f"{len(devices)} are available"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DP_AXIS,))


def local_batch(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DP_AXIS]
    if global_batch % n:
        raise ValueError(
            f"num_samples={global_batch} must be divisible by mesh size {n}"
        )
    return global_batch // n


def device_key(key: jax.Array) -> jax.Array:
    """Fold the mesh position into a (replicated) PRNG key so every device
    draws an independent Monte-Carlo chain stream."""
    return jax.random.fold_in(key, jax.lax.axis_index(DP_AXIS))


def pmean(x):
    return jax.lax.pmean(x, DP_AXIS)
