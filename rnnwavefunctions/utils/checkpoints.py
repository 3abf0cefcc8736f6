"""Checkpoint / resume of a ``TrainState`` on numpy and the standard library.

Replacement for the reference's ``tf.train.Saver`` flow: the reference
creates a Saver per trainer (``TrainingRNN_1DTFIM.py:166``), saves every 500
steps (``:217-219``) under ``Check_Points/<workload>/`` and resumes by
restoring the ckpt and continuing from ``len(meanEnergy)`` (commented
blocks, ``TrainingRNN_1DTFIM.py:172-183``; SURVEY.md §5).

Here the full ``TrainState`` (params + optimizer state + step counter) is
saved as one ``step_<n>.npz`` whose entries are named by each leaf's key
path (``params/rnn/0/wx``, ``opt_state/0/mu/head/b``, ``step``).  A save
writes a temporary file in the same directory and renames it into place,
so a reader never sees a partial checkpoint; the oldest files beyond
``max_to_keep`` are deleted.  The step counter lives *in* the state, not
implicitly in the metrics-history length.  In a multi-process run the
state is replicated, so process 0 writes and every process reads.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import DictKey, GetAttrKey, SequenceKey, tree_flatten_with_path

from ..vmc.trainer import TrainState

_FILE = re.compile(r"^step_(\d+)\.npz$")


def _path_name(path) -> Optional[str]:
    """``a/b/0`` name of a key path; None for a custom node's opaque key."""
    out = []
    for k in path:
        if isinstance(k, DictKey):
            out.append(str(k.key))
        elif isinstance(k, SequenceKey):
            out.append(str(k.idx))
        elif isinstance(k, GetAttrKey):
            out.append(str(k.name))
        else:
            return None
    return "/".join(out)


def _host_value(x) -> np.ndarray:
    """Host copy of a (replicated) array, also when other processes hold
    shards of it."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        x = x.addressable_data(0)
    return np.asarray(x)


class Checkpointer:
    """Saves and restores TrainState pytrees under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _file(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def _steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, state: TrainState, step: Optional[int] = None) -> None:
        if step is None:
            step = int(_host_value(state.step))
        entries: Dict[str, np.ndarray] = {}
        for path, leaf in tree_flatten_with_path(state)[0]:
            name = _path_name(path)
            if name is None:
                raise ValueError(f"cannot name checkpoint leaf at {path}")
            entries[name] = _host_value(leaf)
        if jax.process_index() != 0:
            return
        fd, tmp = tempfile.mkstemp(
            dir=self.directory, prefix=".tmp_", suffix=".npz"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **entries)
            os.replace(tmp, self._file(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self._steps()[: -self.max_to_keep or None]:
            os.unlink(self._file(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]) -> Dict[str, np.ndarray]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        with np.load(self._file(step)) as data:
            return {k: data[k] for k in data.files}

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into the structure and shardings of ``template`` (obtain
        one from ``trainer.init()``).  Raises ``ValueError`` when the saved
        leaves do not match the template's (a changed optimizer)."""
        raw = self._load(step)
        items, treedef = tree_flatten_with_path(template)
        if len(items) != len(raw):
            raise ValueError(
                f"checkpoint holds {len(raw)} leaves, the template {len(items)}"
            )
        leaves = [_restore_leaf(raw, path, t) for path, t in items]
        return jax.tree.unflatten(treedef, leaves)

    def restore_params_and_step(
        self, template: TrainState, step: Optional[int] = None
    ):
        """Cross-optimizer resume: restore only the parameters and the step
        counter, ignoring the optimizer state — for resuming a run whose
        ``TrainConfig.optimizer`` (and hence opt_state layout) changed, e.g.
        refining an Adam-trained wavefunction with minSR.  Returns
        ``(params, step_array)``; the caller re-initializes the optimizer
        state.  Leaves are matched by key path and their shapes checked
        against ``template``."""
        raw = self._load(step)
        items, treedef = tree_flatten_with_path(template.params)
        leaves = [
            _restore_leaf(raw, path, t, prefix="params/") for path, t in items
        ]
        params = jax.tree.unflatten(treedef, leaves)
        return params, jnp.asarray(raw["step"], jnp.int32)

    def wait(self) -> None:
        """Saves are synchronous; kept for callers that wait on them."""

    def close(self) -> None:
        """Nothing is held open between calls."""


def _restore_leaf(raw: Dict[str, np.ndarray], path, template: Any,
                  prefix: str = ""):
    name = _path_name(path)
    if name is None:
        raise ValueError(
            "cannot key-match a custom pytree container (path "
            f"{path}); resume with the optimizer the checkpoint was "
            "trained with instead"
        )
    key = prefix + name
    if key not in raw:
        raise ValueError(
            f"checkpoint has no leaf '{key}' (saved leaves: {sorted(raw)})"
        )
    value = raw[key]
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(
            f"checkpoint leaf '{key}' has shape {tuple(value.shape)} "
            f"but the configured ansatz expects {tuple(template.shape)}"
        )
    value = value.astype(template.dtype)
    sharding = getattr(template, "sharding", None)
    if sharding is not None:
        return jax.device_put(value, sharding)
    return jnp.asarray(value)
