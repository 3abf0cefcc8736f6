"""Benchmark harness: VMC throughput on the reference workloads.

Flagship: 1D TFIM, N=100 sites, 1x50 GRU units, 500 Monte-Carlo samples per
step — the reference's largest published 1DTFIM configuration
(``/root/reference/1DTFIM/run_1dTFIM.py:9`` scaled to the N=100 DMRG anchor,
``Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` cell 24).  One full VMC step =
autoregressive sampling + (N+1)*S off-diagonal log-prob evaluations + policy
gradient + optimizer update, all in one jitted program.  The other rows
cover the parity-symmetrized chain, the complex J1-J2 chain, the 2D MDRNN
and snake ansatze, LSTM and stacked trunks, long chains, large batches and
the minSR optimizer.

Every row runs in its own subprocess (``python bench.py --row NAME``),
one at a time, under a hard time limit; the parent never imports jax, so
only one process holds the card at a time.  A row times ``run_steps``
(K VMC steps in one device-side ``lax.scan``) with ``block_until_ready``
after a compile-and-warm-up call, and reports the median of its trials.
Rows share the persistent compilation cache (``utils/compile_cache.py``).

Every record names the device it ran on: ``platform``, ``device_kind`` and
the device count as JAX reports them, and the card's name and power limit
as ``nvidia-smi`` reports them.  A row that finds no GPU fails; nothing
falls back to the CPU.  The last stdout line is a compact headline; the
full record is the line before it.

Baseline: the reference publishes no throughput numbers (BASELINE.md).  TF1
1.13 on a Colab-class GPU runs the flagship config at roughly 1-2 s/step
(unrolled 100-step graph sampling + three chunked 25k-row session feeds +
BPTT), i.e. ~250-500 samples/s.  We use 500 samples/s as the reference
estimate, so ``vs_baseline`` is a conservative speedup multiplier.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REFERENCE_SAMPLES_PER_SEC_EST = 500.0

NUM_SAMPLES = 500
STEPS_PER_TRIAL = 100
SLOW_STEPS_PER_TRIAL = 20
NUM_TRIALS = 5
ROW_TIMEOUT_S = int(os.environ.get("BENCH_ROW_TIMEOUT_S", "420"))
# Global wall budget: once exhausted, remaining rows are marked skipped and
# the record (with every row measured so far) still prints.
TOTAL_BUDGET_S = int(os.environ.get("BENCH_TOTAL_BUDGET_S", "5400"))

# ---------------------------------------------------------------------------
# Workload table.  Static metadata only — the parent process reads this
# without importing jax; the trainer is built in the row subprocess
# (``_build_trainer``).  Row schema:
#   (name, num_samples, steps_per_trial, cfg_overrides)
# ---------------------------------------------------------------------------
_MINSR = {"optimizer": "minsr", "learning_rate": 5e-2}
WORKLOADS = [
    ("1dtfim_n100", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("parity_n100", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("j1j2_n100", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("mdrnn_6x6", NUM_SAMPLES, 4 * STEPS_PER_TRIAL, None),
    ("1dtfim_lstm_n100", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("1dtfim_2layer_n100", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("snake2d_4x4", NUM_SAMPLES, 4 * STEPS_PER_TRIAL, None),
    ("snake2d_10x10", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("mdrnn_16x16", NUM_SAMPLES, SLOW_STEPS_PER_TRIAL, None),
    ("mdrnn_32x32_s128", 128, SLOW_STEPS_PER_TRIAL, None),
    ("mdrnn_24x24_s128", 128, SLOW_STEPS_PER_TRIAL, None),
    ("mdrnn_48x48_s64", 64, SLOW_STEPS_PER_TRIAL, None),
    ("j1j2_n100_pbc", NUM_SAMPLES, STEPS_PER_TRIAL, None),
    ("1dtfim_n100_u256", NUM_SAMPLES, SLOW_STEPS_PER_TRIAL, None),
    ("1dtfim_n1000_s64", 64, SLOW_STEPS_PER_TRIAL, None),
    ("parity_n1000_s64", 64, SLOW_STEPS_PER_TRIAL, None),
    ("j1j2_n1000_s64", 64, SLOW_STEPS_PER_TRIAL, None),
    ("1dtfim_n100_minsr", NUM_SAMPLES, SLOW_STEPS_PER_TRIAL, _MINSR),
    ("j1j2_n100_minsr", NUM_SAMPLES, SLOW_STEPS_PER_TRIAL, _MINSR),
    ("mdrnn_8x8_minsr", NUM_SAMPLES, SLOW_STEPS_PER_TRIAL, _MINSR),
    ("1dtfim_n1000_minsr", 64, SLOW_STEPS_PER_TRIAL, _MINSR),
    ("1dtfim_n100_s4096", 4096, SLOW_STEPS_PER_TRIAL, None),
    ("j1j2_n100_s2048", 2048, SLOW_STEPS_PER_TRIAL, None),
]

# Accuracy probe: a physics number in the headline record.  N=20 TFIM,
# minSR, trained in 50-step device blocks until the trailing-50 mean energy
# is within 1e-3 relative of the DMRG anchor (Tutorial_1DTFIM.ipynb
# cell 24).
ACCURACY_ANCHOR_N20 = -25.1077971081
ACCURACY_MAX_STEPS = 600
ACCURACY_BLOCK = 50
ACCURACY_RTOL = 1e-3


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them, or a
    note saying why there is none."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"


def _build_trainer(name, num_samples, cfg_overrides):
    """Construct the trainer for a named row.  Imports the package —
    subprocess side only."""
    from rnnwavefunctions import (
        CRNNU1, J1J2, MDRNN2D, PRNN1D, TFIM1D, TFIM2D, TrainConfig,
        VMCTrainer,
    )
    from rnnwavefunctions.models.prnn_snake2d import PRNNSnake2D

    def tfim(n, **kw):
        return PRNN1D(num_sites=n, **kw), TFIM1D(num_sites=n, bx=1.0)

    def mdrnn(l):
        return (MDRNN2D(nx=l, ny=l, units=50),
                TFIM2D(nx=l, ny=l, bx=3.0, encoding="grid"))

    def snake(l):
        return (PRNNSnake2D(nx=l, ny=l, units=(50,)),
                TFIM2D(nx=l, ny=l, bx=3.0, encoding="flat"))

    def j1j2(n, **kw):
        return CRNNU1(num_sites=n, units=(50,)), J1J2(num_sites=n, j2=0.2, **kw)

    builders = {
        "1dtfim_n100": lambda: tfim(100, units=(50,)),
        "parity_n100": lambda: tfim(100, units=(50,), parity=True),
        "j1j2_n100": lambda: j1j2(100),
        "mdrnn_6x6": lambda: mdrnn(6),
        "1dtfim_lstm_n100": lambda: tfim(100, units=(50,), cell="lstm"),
        "1dtfim_2layer_n100": lambda: tfim(100, units=(50, 50)),
        "snake2d_4x4": lambda: snake(4),
        "snake2d_10x10": lambda: snake(10),
        "mdrnn_16x16": lambda: mdrnn(16),
        "mdrnn_32x32_s128": lambda: mdrnn(32),
        "mdrnn_24x24_s128": lambda: mdrnn(24),
        "mdrnn_48x48_s64": lambda: mdrnn(48),
        "j1j2_n100_pbc": lambda: j1j2(100, periodic=True),
        "1dtfim_n100_u256": lambda: tfim(100, units=(256,)),
        "1dtfim_n1000_s64": lambda: tfim(1000, units=(50,)),
        "parity_n1000_s64": lambda: tfim(1000, units=(50,), parity=True),
        "j1j2_n1000_s64": lambda: j1j2(1000),
        "1dtfim_n100_minsr": lambda: tfim(100, units=(50,)),
        "j1j2_n100_minsr": lambda: j1j2(100),
        "mdrnn_8x8_minsr": lambda: mdrnn(8),
        "1dtfim_n1000_minsr": lambda: tfim(1000, units=(50,)),
        "1dtfim_n100_s4096": lambda: tfim(100, units=(50,)),
        "j1j2_n100_s2048": lambda: j1j2(100),
    }
    ansatz, ham = builders[name]()
    cfg_kw = {"num_samples": num_samples, "learning_rate": 5e-3}
    cfg_kw.update(cfg_overrides or {})
    return VMCTrainer(ansatz, ham, TrainConfig(**cfg_kw))


def _device():
    """The device JAX reports; raises when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def measure(trainer, steps=STEPS_PER_TRIAL):
    """Median steps/s of ``NUM_TRIALS`` timed ``run_steps`` calls, after
    one compile-and-warm-up call; also the compile seconds."""
    import jax

    state = trainer.init()
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    state, metrics = trainer.run_steps(state, key, steps)
    jax.block_until_ready((state, metrics))
    compile_s = time.perf_counter() - t0
    rates = []
    for _ in range(NUM_TRIALS):
        t0 = time.perf_counter()
        state, metrics = trainer.run_steps(state, key, steps)
        jax.block_until_ready((state, metrics))
        rates.append(steps / (time.perf_counter() - t0))
    energy = float(metrics["mean_energy"][-1])
    if not energy < 0.0:
        raise RuntimeError(f"non-negative or non-finite energy {energy}")
    return sorted(rates)[len(rates) // 2], compile_s


def run_accuracy_probe():
    """Train the N=20 TFIM chain with minSR until the trailing-block mean
    energy is within ``ACCURACY_RTOL`` relative of the DMRG anchor; print
    one JSON line with the step count and final relative error."""
    try:
        import numpy as np
        import jax

        from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
        from rnnwavefunctions.utils import compile_cache

        compile_cache.enable()
        device = _device()
        trainer = VMCTrainer(
            PRNN1D(num_sites=20, units=(50,)),
            TFIM1D(num_sites=20, bx=1.0),
            TrainConfig(num_samples=NUM_SAMPLES, learning_rate=5e-2,
                        optimizer="minsr"),
        )
        state = trainer.init()
        key = jax.random.PRNGKey(0)
        steps_done, rel = 0, float("inf")
        while steps_done < ACCURACY_MAX_STEPS and rel > ACCURACY_RTOL:
            state, ms = trainer.run_steps(state, key, ACCURACY_BLOCK)
            steps_done += ACCURACY_BLOCK
            est = float(np.asarray(ms["mean_energy"]).mean())
            rel = abs(est - ACCURACY_ANCHOR_N20) / abs(ACCURACY_ANCHOR_N20)
    except Exception as e:
        print(json.dumps(
            {"ok": False, "error": f"{type(e).__name__}: {e}"[:200]}))
        return 1
    print(json.dumps({
        "ok": True,
        "device": device,
        "steps_to_rtol": steps_done,
        "rel_error": float(rel),
        "converged": bool(rel <= ACCURACY_RTOL),
    }))
    return 0


def run_row(name):
    """Subprocess entry for one workload row: build the trainer, measure,
    and print one JSON line."""
    if name == "accuracy_n20_minsr":
        return run_accuracy_probe()
    spec = next((w for w in WORKLOADS if w[0] == name), None)
    if spec is None:
        print(json.dumps({"ok": False, "error": f"unknown row {name!r}"}))
        return 2
    _, num_samples, steps, cfg_overrides = spec
    try:
        import jax

        from rnnwavefunctions.utils import compile_cache

        compile_cache.enable()
        device = _device()
        trainer = _build_trainer(name, num_samples, cfg_overrides)
        steps_per_sec, compile_s = measure(trainer, steps=steps)
        peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    except Exception as e:
        print(json.dumps(
            {"ok": False, "error": f"{type(e).__name__}: {e}"[:200]}))
        return 1
    print(json.dumps({
        "ok": True,
        "device": device,
        "steps_per_sec": steps_per_sec,
        "samples_per_sec": steps_per_sec * num_samples,
        "compile_s": compile_s,
        "peak_bytes_in_use": peak,
    }))
    return 0


def _spawn_row(name, timeout_s):
    """Run one row in a subprocess with a hard kill.  Returns the row's
    record, or {"error": "..."}."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--row", name],
            timeout=timeout_s, capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired:
        return {"error": f"timeout: row killed after {timeout_s}s"}
    if r.stderr:
        sys.stderr.write(r.stderr[-2000:])
    lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    if not lines:
        return {"error": f"row subprocess rc={r.returncode}, no output"}
    try:
        out = json.loads(lines[-1])
    except json.JSONDecodeError:
        return {"error": f"row subprocess rc={r.returncode}, bad output"}
    if not out.get("ok"):
        return {"error": out.get("error", "unknown row failure")[:200]}
    out.pop("ok", None)
    return out


def main():
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    t_start = time.monotonic()
    rows = {}
    accuracy = {"error": "probe never ran"}
    device = None
    for name, _num_samples, _steps, _cfg in WORKLOADS:
        if time.monotonic() - t_start > TOTAL_BUDGET_S:
            rows[name] = {"error": "skipped: global wall budget exhausted"}
            continue
        row = _spawn_row(name, ROW_TIMEOUT_S)
        device = row.pop("device", device)
        rows[name] = row
        print(f"{name}: {row}", file=sys.stderr)
        if name == "1dtfim_n100":
            if "error" in row:
                break  # no device answered the flagship: fail, do not go on
            accuracy = _spawn_row("accuracy_n20_minsr", ROW_TIMEOUT_S)
            accuracy.pop("device", None)
            print(f"accuracy_n20_minsr: {accuracy}", file=sys.stderr)

    flag = rows.get("1dtfim_n100", {"error": "row never ran"})
    full_record = {
        "metric": "1dtfim_n100_vmc_samples_per_sec",
        "value": flag.get("samples_per_sec", 0.0),
        "unit": "samples/s",
        "vs_baseline": round(
            flag.get("samples_per_sec", 0.0) / REFERENCE_SAMPLES_PER_SEC_EST, 2
        ),
        "device": device,
        "card": card,
        "accuracy_n20_minsr": accuracy,
        "workloads": rows,
    }
    print(json.dumps(full_record))
    measured = sum(1 for r in rows.values() if "steps_per_sec" in r)
    print(json.dumps(_headline(full_record, flag, accuracy, measured)))
    return 1 if "error" in flag else 0


def _headline(full_record, flag, accuracy, measured):
    """Compact final-line record (the full one is the line before it);
    its size is pinned by tests/test_bench_headline.py."""
    headline = {
        "metric": full_record["metric"],
        "value": full_record["value"],
        "unit": full_record["unit"],
        # vs_baseline divides by the 500 samples/s ESTIMATE of the TF1-GPU
        # reference rate (no published number; BASELINE.md:26-29)
        "vs_baseline": full_record["vs_baseline"],
        "baseline_est_samples_per_sec": REFERENCE_SAMPLES_PER_SEC_EST,
        "steps_per_sec": flag.get("steps_per_sec", 0.0),
        "device": full_record["device"],
        "card": str(full_record["card"])[:120],
        "rows_measured": measured,
        "rows_total": len(WORKLOADS),
        "accuracy_n20_minsr": accuracy,
    }
    if "error" in flag:
        # error strings are subprocess-tail captures — cap them
        headline["error"] = str(flag["error"])[:200]
    return headline


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--row", default=None,
                        help="run a single workload row (subprocess mode)")
    cli = parser.parse_args()
    if cli.row:
        sys.exit(run_row(cli.row))
    sys.exit(main())
