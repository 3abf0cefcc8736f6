"""Smoke test of the VMC trainer on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --four-cards  # four GPUs of one host: the
                                       # data-parallel phase only

Phases (one process, which opens the card once):

1. Device: JAX must run on a GPU; prints its kind, the card's
   ``nvidia-smi`` name and power limit, and the jax/jaxlib versions.
2. Flagship through the CLI: ``1dtfim`` at N=100, 50 units, S=500 trains
   20 steps, then resumes from its checkpoint to step 30.
3. Each family through its CLI at the reference runner defaults
   (``2dtfim-1drnn``, ``2dtfim-2drnn``, ``j1j2``), the flagship with
   ``--optimizer minsr``, and the longest chain (N=1000, S=64).
4. Against the plain reference: the CPU backend of the same process runs
   the jnp scans on the same parameters and samples at real widths, under
   ``jax.default_matmul_precision("highest")`` and the default precision;
   the GPU rollout kernel is also compared with the jnp scan on the card.
5. Physics: the N=10 TFIM trains 300 steps to within 1e-3 of exact
   diagonalization.

Phases 2 and 3 print each run's step time (a compiled
``VMCTrainer.run_steps`` call timed to ``block_until_ready``), its compile
seconds (what its calls took beyond that) and ``peak_bytes_in_use`` (the
process's maximum so far).  A failed phase makes the script exit
non-zero without its last line; so does a machine without a GPU, and a
directory without the package.  The last stdout line on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Deviation bounds of phase 4, as max_i |a_i - b_i| / max(|b_i|, mean|b|)
# (the floor keeps a local energy that happens to sit near zero from
# reading as a large relative error).
# "highest": float32 everywhere, and a compensated sum of <= 100 log-prob
# terms taken in another order on each side.
BOUND_HIGHEST = 1e-5
# default: a float32 product on the card may run in TF32 (10-bit mantissa,
# ~5e-4 relative per operand); local energies exponentiate differences of
# two log-amplitudes of size ~N/2, which amplifies it.
BOUND_DEFAULT = 1e-2


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def rel_dev(a, b) -> float:
    """max_i |a_i - b_i| / max(|b_i|, mean |b|); complex values compare as
    complex numbers."""
    a = np.asarray(a).astype(np.complex128).ravel()
    b = np.asarray(b).astype(np.complex128).ravel()
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
        return float("inf")
    floor = max(float(np.mean(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


class StepClock:
    """Times every ``VMCTrainer.run_steps`` call made inside ``watch()``
    (wall seconds to ``block_until_ready``), then times the last call once
    more: that call's program is compiled by then, so it reads the steady
    step time.  Compile seconds are what the calls took beyond
    steps x steady step time: tracing, compiling or loading from the
    persistent cache, and the first run."""

    def __init__(self):
        self.calls = []
        self._last = None

    @contextlib.contextmanager
    def watch(self):
        import jax

        from rnnwavefunctions.vmc.trainer import VMCTrainer

        original = VMCTrainer.run_steps

        def timed(trainer, state, key, num_steps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(original(trainer, state, key, num_steps))
            self.calls.append((num_steps, time.perf_counter() - t0))
            self._last = (original, trainer, state, key, num_steps)
            return out

        VMCTrainer.run_steps = timed
        try:
            yield self
        finally:
            VMCTrainer.run_steps = original

    def summary(self) -> str:
        import jax

        original, trainer, state, key, n = self._last
        t0 = time.perf_counter()
        jax.block_until_ready(original(trainer, state, key, n))
        step_s = (time.perf_counter() - t0) / n
        compile_s = sum(t - k * step_s for k, t in self.calls)
        return f"step_s={step_s:.6f}, compile_s={compile_s:.2f}"


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_cli(label, module, argv):
    """Train through a CLI runner's ``main``; print its timings and return
    its (mean energy, var energy) series."""
    import importlib

    main = importlib.import_module(f"rnnwavefunctions.cli.{module}").main
    clock = StepClock()
    t0 = time.perf_counter()
    with clock.watch():
        mean_e, var_e = main(argv)
    wall = time.perf_counter() - t0
    energies = np.asarray(mean_e)
    if not np.all(np.isfinite(energies)):
        raise AssertionError(f"{label}: non-finite energies {energies}")
    print(f"  {label}: {len(mean_e)} steps recorded, E[-1]={energies[-1]}, "
          f"{clock.summary()}, wall_s={wall:.2f}, "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)
    return mean_e, var_e


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_flagship(workdir):
    from rnnwavefunctions.utils.checkpoints import Checkpointer

    argv = ["--systemsize", "100", "--num-units", "50", "--numsamples", "500",
            "--workdir", workdir]
    mean_e, _ = run_cli("1dtfim N=100 S=500, 20 steps", "run_1dtfim",
                        argv + ["--numsteps", "20"])
    [ckpt_dir] = glob.glob(os.path.join(workdir, "ckpt_*"))
    first = Checkpointer(ckpt_dir).latest_step()
    mean_r, _ = run_cli("1dtfim resumed to step 30", "run_1dtfim",
                        argv + ["--numsteps", "30", "--resume"])
    resumed = Checkpointer(ckpt_dir).latest_step()
    # the runner's loop is inclusive (range(start, numsteps + 1)), so the
    # step counter after training to step k is k + 1
    if (first, resumed, len(mean_e), len(mean_r)) != (21, 31, 21, 31):
        raise AssertionError(
            f"step counters: checkpoint {first} -> {resumed}, series "
            f"{len(mean_e)} -> {len(mean_r)}; expected 21 -> 31 both")
    if not np.allclose(mean_r[:21], mean_e, rtol=0, atol=0):
        raise AssertionError("resume rewrote the first 21 recorded energies")
    print(f"  resume: step counter {first} -> {resumed}", flush=True)


def phase_families(workdir):
    runs = [
        ("2dtfim-1drnn 4x4 defaults", "run_2dtfim_1drnn", ["--numsteps", "20"]),
        ("2dtfim-2drnn 4x4 defaults", "run_2dtfim_2drnn", ["--numsteps", "20"]),
        ("j1j2 N=10 defaults", "run_j1j2", ["--numsteps", "20"]),
        ("1dtfim N=100 S=500 minsr", "run_1dtfim",
         ["--systemsize", "100", "--optimizer", "minsr", "--numsteps", "5"]),
        ("1dtfim N=1000 S=64", "run_1dtfim",
         ["--systemsize", "1000", "--numsamples", "64", "--numsteps", "1"]),
    ]
    for i, (label, module, argv) in enumerate(runs):
        run_cli(label, module,
                argv + ["--workdir", os.path.join(workdir, str(i))])


def _compare_family(label, ansatz, ham, num_samples, cpu):
    """log-amplitudes and local energies on the card against the jnp
    scans on the CPU, same parameters and samples; returns the worst
    deviation per precision."""
    import jax

    from rnnwavefunctions.vmc.local_energy import make_local_energy_fn

    params = ansatz.init(jax.random.PRNGKey(7))
    samples = jax.jit(ansatz.sample, static_argnums=2)(
        params, jax.random.PRNGKey(8), num_samples)
    energy_fn = make_local_energy_fn(ansatz, ham)
    is_complex = getattr(ansatz, "is_complex", False)

    def evaluate(p, s):
        la = ansatz.log_amp_parts(p, s) if is_complex else ansatz.log_amp(p, s)
        e_re, e_im, _ = energy_fn(p, s, la)
        if not is_complex:
            return {"log_amp": la, "e_loc": e_re}
        return {"log_amp": la[0], "phase": la[1],
                "e_loc": jax.lax.complex(e_re, e_im)}

    worst = {}
    for prec, bound in (("highest", BOUND_HIGHEST), (None, BOUND_DEFAULT)):
        with jax.default_matmul_precision(prec):
            got = jax.jit(evaluate)(params, samples)
            with jax.default_device(cpu):
                ref = jax.jit(evaluate)(jax.device_put(params, cpu),
                                        jax.device_put(samples, cpu))
        devs = {k: rel_dev(got[k], ref[k]) for k in got}
        name = prec or "default"
        worst[name] = max(devs.values())
        print(f"  {label} [{name}] " + ", ".join(
            f"{k} {v:.2e}" for k, v in devs.items()) + f" (bound {bound:g})",
            flush=True)
        if worst[name] > bound:
            raise AssertionError(f"{label} [{name}]: deviation {worst[name]:.3e} "
                                 f"> {bound:g}")
    return worst


def _compare_kernel(n, s, cell):
    """The rollout kernel against the jnp scan, both on the card."""
    import jax

    from rnnwavefunctions import PRNN1D
    from rnnwavefunctions.models.prnn1d import site_uniforms
    from rnnwavefunctions.ops import rollout

    ansatz = PRNN1D(num_sites=n, units=(50,), cell=cell)
    if not ansatz._use_kernel():
        raise AssertionError(f"the rollout kernel does not cover {ansatz}")
    params = ansatz.init(jax.random.PRNGKey(3))
    u = site_uniforms(jax.random.PRNGKey(4), n, s)
    for prec, bound, min_equal in (("highest", BOUND_HIGHEST, 0.99),
                                   (None, BOUND_DEFAULT, 0.95)):
        with jax.default_matmul_precision(prec):
            sk, lpk = jax.jit(rollout.sample)(params, u)
            sj, lpj = jax.jit(ansatz._sample_jnp)(params, u)
            lk = jax.jit(ansatz.log_prob)(params, sj)
            lj = jax.jit(ansatz._log_prob_plain_jnp)(params, sj)
        rows = np.all(np.asarray(sk) == np.asarray(sj), axis=1)
        equal = float(np.mean(rows))
        d_lp = rel_dev(lk, lj)
        d_draw = rel_dev(np.asarray(lpk)[rows], np.asarray(lpj)[rows])
        name = prec or "default"
        print(f"  kernel vs scan {cell} N={n} S={s} [{name}]: log_prob "
              f"{d_lp:.2e}, sampler rows equal {equal:.4f}, their log_prob "
              f"{d_draw:.2e} (bound {bound:g}, rows >= {min_equal})",
              flush=True)
        if d_lp > bound or d_draw > bound or equal < min_equal:
            raise AssertionError(f"kernel vs scan {cell} N={n} [{name}]")


def phase_reference():
    import jax

    from rnnwavefunctions import CRNNU1, J1J2, MDRNN2D, PRNN1D, TFIM1D, TFIM2D

    cpu = jax.devices("cpu")[0]
    cases = [
        ("PRNN1D gru N=100 U=50 S=500",
         PRNN1D(num_sites=100, units=(50,)), TFIM1D(num_sites=100, bx=1.0), 500),
        ("PRNN1D lstm N=100 U=50 S=500",
         PRNN1D(num_sites=100, units=(50,), cell="lstm"),
         TFIM1D(num_sites=100, bx=1.0), 500),
        ("CRNNU1 J1J2 N=100 U=50 S=200",
         CRNNU1(num_sites=100, units=(50,)), J1J2(num_sites=100, j2=0.2), 200),
        ("MDRNN2D 6x6 U=50 S=500",
         MDRNN2D(nx=6, ny=6, units=50),
         TFIM2D(nx=6, ny=6, bx=3.0, encoding="grid"), 500),
    ]
    for label, ansatz, ham, s in cases:
        _compare_family(label, ansatz, ham, s, cpu)
    for n, s in ((100, 500), (1000, 64)):
        for cell in ("gru", "lstm"):
            _compare_kernel(n, s, cell)


def phase_physics(num_steps=300):
    import jax

    from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
    from rnnwavefunctions.ed import exact

    n = 10
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
    trainer = VMCTrainer(PRNN1D(num_sites=n, units=(50,)),
                         TFIM1D(num_sites=n, bx=1.0),
                         TrainConfig(num_samples=512))
    state = trainer.init()
    state, ms = trainer.run_steps(state, jax.random.PRNGKey(0), num_steps)
    energies = np.asarray(ms["mean_energy"])
    estimate = float(np.mean(energies[-20:]))
    rel = abs(estimate - e_exact) / abs(e_exact)
    print(f"  N=10 TFIM after {num_steps} steps: E={estimate:.6f} exact "
          f"{e_exact:.6f} rel {rel:.2e} (bound 1e-3)", flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"relative error {rel:.3e} > 1e-3")


def phase_four_cards(workdir, n=100, s=2000, steps=10):
    """Data parallelism over all visible cards: the sharded loss gradient
    and energy statistics against one card's, training and a checkpoint
    round trip on the mesh, and the (dp=2, tp=2) product mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rnnwavefunctions import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
    from rnnwavefunctions.parallel import mesh as mesh_lib
    from rnnwavefunctions.parallel import tensor as tp_lib
    from rnnwavefunctions.utils.checkpoints import Checkpointer
    from rnnwavefunctions.vmc.local_energy import make_local_energy_fn
    from rnnwavefunctions.vmc.loss import surrogate_loss

    count = len(jax.devices())
    ansatz = PRNN1D(num_sites=n, units=(50,))
    ham = TFIM1D(num_sites=n, bx=1.0)
    params = ansatz.init(jax.random.PRNGKey(5))
    samples = jax.jit(ansatz.sample, static_argnums=2)(
        params, jax.random.PRNGKey(6), s)
    energy_fn = make_local_energy_fn(ansatz, ham)

    def stats_and_grad(p, x):
        la = ansatz.log_amp(p, x)
        e, _, _ = energy_fn(p, x, la)
        e = jax.lax.stop_gradient(e)
        mean = mesh_lib.pmean(jnp.mean(e))
        var = mesh_lib.pmean(jnp.mean((e - mean) ** 2))
        g = jax.grad(lambda q: surrogate_loss(
            ansatz.log_amp(q, x), None, e, None, mean, None))(p)
        return mean, var, jax.tree.map(mesh_lib.pmean, g)

    def on_mesh(mesh):
        fn = jax.shard_map(stats_and_grad, mesh=mesh,
                           in_specs=(P(), P(mesh_lib.DP_AXIS)),
                           out_specs=P(), check_vma=False)
        return jax.jit(fn)(params, samples)

    with jax.default_matmul_precision("highest"):
        one = on_mesh(mesh_lib.make_mesh(1))
        many = on_mesh(mesh_lib.make_mesh(count))
    d_mean, d_var = rel_dev(many[0], one[0]), rel_dev(many[1], one[1])
    d_grad = max(rel_dev(a, b) for a, b in
                 zip(jax.tree.leaves(many[2]), jax.tree.leaves(one[2])))
    print(f"  sharded vs one card, S={s} over {count} cards: mean energy "
          f"{d_mean:.2e}, variance {d_var:.2e}, gradient {d_grad:.2e} "
          f"(bounds 1e-6, 1e-5, 1e-4, 'highest': float32 sums in another "
          f"order)",
          flush=True)
    if d_mean > 1e-6 or d_var > 1e-5 or d_grad > 1e-4:
        raise AssertionError("sharded statistics or gradient disagree")

    # training across the cards, then a checkpoint round trip on the mesh
    trainer = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s),
                         mesh=mesh_lib.make_mesh(count))
    key = jax.random.PRNGKey(0)
    clock = StepClock()
    with clock.watch():
        state, ms = trainer.run_steps(trainer.init(), key, steps)
    energies = np.asarray(ms["mean_energy"])
    if not np.all(np.isfinite(energies)):
        raise AssertionError(f"non-finite energies {energies}")
    ckpt = Checkpointer(os.path.join(workdir, "ckpt"))
    ckpt.save(state)
    restored = ckpt.restore(trainer.init())
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        if a.sharding != b.sharding or not np.array_equal(a, b):
            raise AssertionError("checkpoint round trip changed a leaf")
    cont, _ = trainer.run_steps(state, key, 1)
    again, _ = trainer.run_steps(restored, key, 1)
    for a, b in zip(jax.tree.leaves(cont), jax.tree.leaves(again)):
        if not np.array_equal(a, b):
            raise AssertionError("the restored state trains differently")
    print(f"  run_steps S={s} ({s // count} per card): E[-1]={energies[-1]:.4f}, "
          f"{clock.summary()}, restore at step "
          f"{int(restored.step)} on {restored.params['head']['w'].sharding}, "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)

    # the product mesh: one trainer step, and its gradient against dp only
    tp = 2
    tp_mesh = tp_lib.make_dp_tp_mesh(count // tp, tp)
    tp_trainer = VMCTrainer(ansatz, ham, TrainConfig(num_samples=s, tp=tp),
                            mesh=tp_mesh)
    tp_state, tp_ms = tp_trainer.step(tp_trainer.init(), key)
    if not np.isfinite(float(tp_ms["mean_energy"])):
        raise AssertionError("tp step energy is not finite")
    e_loc = energy_fn(params, samples, ansatz.log_amp(params, samples))[0]
    e_mean = jnp.mean(e_loc)

    def tp_grad(p, x, e):
        def loss(q):
            sh = tp_lib.shard_params(q, tp, jax.lax.axis_index(tp_lib.TP_AXIS))
            la = 0.5 * tp_lib.tp_log_prob(sh, x, ansatz.units, tp)
            return surrogate_loss(la, None, e, None, e_mean, None)

        g = jax.grad(loss)(p)
        return jax.tree.map(
            lambda v: mesh_lib.pmean(jax.lax.pmean(v, tp_lib.TP_AXIS)), g)

    def dp_grad(p, x, e):
        g = jax.grad(lambda q: surrogate_loss(
            ansatz.log_amp(q, x), None, e, None, e_mean, None))(p)
        return jax.tree.map(mesh_lib.pmean, g)

    spec = (P(), P(mesh_lib.DP_AXIS), P(mesh_lib.DP_AXIS))
    with jax.default_matmul_precision("highest"):
        g_tp = jax.jit(jax.shard_map(tp_grad, mesh=tp_mesh, in_specs=spec,
                                     out_specs=P(), check_vma=False))(
            params, samples, e_loc)
        g_dp = jax.jit(jax.shard_map(
            dp_grad, mesh=mesh_lib.make_mesh(count // tp), in_specs=spec,
            out_specs=P(), check_vma=False))(params, samples, e_loc)
    d_tp = max(rel_dev(a, b) for a, b in
               zip(jax.tree.leaves(g_tp), jax.tree.leaves(g_dp)))
    print(f"  (dp={count // tp}, tp={tp}) step E={float(tp_ms['mean_energy']):.4f}; "
          f"gradient vs dp only {d_tp:.2e} (bound 1e-4, 'highest')", flush=True)
    if d_tp > 1e-4:
        raise AssertionError("tp gradient disagrees with the dp gradient")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the data-parallel phase on 4 cards")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"FAIL device: JAX found no GPU (platform "
              f"{devices[0].platform})", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"FAIL device: {len(devices)} GPU(s), need {want}",
              file=sys.stderr)
        return 1
    try:
        from rnnwavefunctions.utils import compile_cache
    except ImportError as e:
        print(f"FAIL: the rnnwavefunctions package is not importable "
              f"beside this script ({e})", file=sys.stderr)
        return 1
    import jaxlib

    print(f"cache: {compile_cache.enable()}")
    card = card_line()
    print(f"device: {devices[0].device_kind} x{len(devices)}; card: {card}; "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            phases = [("four cards", lambda: phase_four_cards(tmp))]
        else:
            phases = [
                ("flagship", lambda: phase_flagship(os.path.join(tmp, "f"))),
                ("families", lambda: phase_families(os.path.join(tmp, "m"))),
                ("reference", phase_reference),
                ("physics", phase_physics),
            ]
        failed = []
        for name, run in phases:
            print(f"phase {name}", flush=True)
            t0 = time.perf_counter()
            try:
                run()
            except Exception:
                traceback.print_exc()
                failed.append(name)
                print(f"FAIL {name}", flush=True)
                continue
            print(f"PASS {name} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
