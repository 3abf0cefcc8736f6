"""Multi-host (multi-process) initialization and training-path tests.

Two local processes coordinate through ``jax.distributed.initialize`` (the
cross-host role), build the global 1D dp mesh over all processes' CPU devices, run
a psum collective across the process boundary, and execute the full sharded
VMC multi-step program (sample -> E_loc -> grad -> psum -> Adam) with the
per-step metrics fetched on every host.  Checkpoint saves are written by
process 0 into a directory every process reads — they are exercised
single-process in test_cli_io; here the primary-only gating of the CLI
metrics writers is verified directly by faking a non-primary host.
"""

import pytest

pytestmark = pytest.mark.slow
import os
import socket
import subprocess
import sys

import jax
import numpy as np

_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

pid = int(sys.argv[1])
port = sys.argv[2]

from rnnwavefunctions.parallel import multihost

multihost.initialize(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert multihost.is_primary() == (pid == 0)

import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

mesh = multihost.global_mesh()
assert mesh.shape["dp"] == 4, mesh.shape  # 2 processes x 2 local devices

# collective across the process boundary
def body():
    return jnp.full((1,), jax.lax.psum(jax.lax.axis_index("dp") + 1, "dp"))

out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(), out_specs=P("dp")))()
local = [int(s.data[0]) for s in out.addressable_shards]
assert local == [10, 10], local  # 1 + 2 + 3 + 4 on every device

# full sharded VMC training over the global mesh: chains split across both
# processes, psum'd statistics and gradients over the (simulated) cross-host link
from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer

trainer = VMCTrainer(
    PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6, bx=1.0),
    TrainConfig(num_samples=8), mesh=mesh,
)
state = trainer.init()
state, ms = trainer.run_steps(state, jax.random.PRNGKey(0), 4)
energies = np.asarray(jax.device_get(ms["mean_energy"]))  # replicated
assert energies.shape == (4,) and np.isfinite(energies).all()
print(f"proc {pid}: ok {energies[-1]:.4f}")

# minSR over the same global mesh: the centered O-row all_gather crosses
# the process boundary and the sample-space solve must replicate
trainer_sr = VMCTrainer(
    PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6, bx=1.0),
    TrainConfig(num_samples=8, learning_rate=5e-2, optimizer="minsr"),
    mesh=mesh,
)
st_sr = trainer_sr.init()
st_sr, ms_sr = trainer_sr.run_steps(st_sr, jax.random.PRNGKey(1), 2)
e_sr = np.asarray(jax.device_get(ms_sr["mean_energy"]))
assert e_sr.shape == (2,) and np.isfinite(e_sr).all()
print(f"proc {pid}: minsr ok {e_sr[-1]:.4f}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_init_and_sharded_step(tmp_path):
    import numpy as np  # noqa: F811 (used in worker scope too)

    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i}: ok" in out
        assert f"proc {i}: minsr ok" in out
    # both processes computed identical replicated energy statistics, for
    # the Adam step (psum'd grads) AND the minSR step (gathered solve)
    tail0 = [l.split()[-1] for l in outs[0].strip().splitlines()[-2:]]
    tail1 = [l.split()[-1] for l in outs[1].strip().splitlines()[-2:]]
    assert tail0 == tail1, (tail0, tail1)


def test_non_primary_host_writes_no_metrics(tmp_path, monkeypatch):
    """is_primary() gating of the CLI writer path: a non-primary host trains
    but must not emit metrics artifacts or prints."""
    from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
    from rnnwavefunctions.cli import run_loop
    from rnnwavefunctions.parallel import multihost

    monkeypatch.setattr(multihost, "is_primary", lambda: False)
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6, bx=1.0),
        TrainConfig(num_samples=16),
    )
    state, mean_e, _ = run_loop.run_training(
        trainer, num_steps=4, workdir=str(tmp_path), tag="np", ckpt_every=0
    )
    assert len(mean_e) == 5  # training itself ran on this host
    files = os.listdir(tmp_path)
    assert not any(f.endswith(".npy") for f in files), files
    assert not any(f.endswith(".jsonl") for f in files), files
