"""Accuracy-anchor validation harness (run it on a GPU).

Trains the flagship configurations against the published ground-truth
energies from the reference tutorials (BASELINE.md): DMRG values for the 1D
TFIM at several system sizes and for the J1-J2 chain at N=100, plus exact
values from the ED oracles for small systems.  Prints one JSON line per
anchor with the relative error and wall-clock.

Usage:  python scripts/validate_anchors.py [--quick]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rnnwavefunctions import (
    CRNNU1, J1J2, PRNN1D, TFIM1D, TrainConfig, VMCTrainer,
)
from rnnwavefunctions.vmc.observables import energy_estimate

# DMRG anchors from Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb cell 24 and
# Tutorials/J1J2/Tutorial_1DJ1J2.ipynb cell 25 (BASELINE.md).
TFIM_DMRG = {
    20: -25.1077971081,
    40: -50.5694337844,
    100: -126.9618766964,
}
J1J2_DMRG_N100 = {0.0: -44.127739860, 0.2: -40.73881897}


def _train_chunked(trainer, steps, chunk=500):
    """Run ``steps`` training steps in device-side chunks; returns
    (state, mean series, var series).  One loop shared by every anchor
    harness (a fix here must not be re-applied in three places)."""
    state = trainer.init()
    key = jax.random.PRNGKey(0)
    means, varis = [], []
    left = steps
    while left > 0:
        block = min(chunk, left)
        state, ms = trainer.run_steps(state, key, block)
        means.extend(np.asarray(ms["mean_energy"]).tolist())
        varis.extend(np.asarray(ms["var_energy"]).tolist())
        left -= block
    return state, means, varis


def run_tfim(n, steps, num_samples=500):
    trainer = VMCTrainer(
        PRNN1D(num_sites=n, units=(50,)),
        TFIM1D(num_sites=n, bx=1.0),
        TrainConfig(num_samples=num_samples, learning_rate=5e-3),
    )
    _, means, varis = _train_chunked(trainer, steps)
    return energy_estimate(means, varis, num_samples)


def run_j1j2(n, j2, steps, num_samples=512):
    trainer = VMCTrainer(
        CRNNU1(num_sites=n, units=(50,)),
        J1J2(num_sites=n, j1=1.0, j2=j2, marshall_sign=True),
        TrainConfig(num_samples=num_samples, learning_rate=2e-3),
    )
    _, means, varis = _train_chunked(trainer, steps)
    return energy_estimate(means, varis, num_samples)


def fidelity_check(n=20, steps=3000, num_samples=500):
    """Train the N-site TFIM chain and report |<psi_theta|psi_0>|^2 against
    the exact ground vector (dense eigh to N=16, the C++ two-pass Lanczos
    beyond) — the whole-wavefunction counterpart to the energy anchors."""
    from rnnwavefunctions.ed.fidelity import fidelity

    if n <= 16:
        from rnnwavefunctions.ed import exact
        e0, gs = exact.ground_state(exact.tfim1d_dense(n, 1.0))
    else:
        from rnnwavefunctions.ed import native
        e0, gs, _resid = native.tfim1d_ground_state(n, 1.0)

    ansatz = PRNN1D(num_sites=n, units=(50,))
    trainer = VMCTrainer(
        ansatz, TFIM1D(num_sites=n, bx=1.0),
        TrainConfig(num_samples=num_samples, learning_rate=5e-3),
    )
    t0 = time.time()
    state, means, varis = _train_chunked(trainer, steps)
    # trailing-window estimate, same convention as the energy anchors —
    # a single final-step MC mean fluctuates by as much as the tolerance
    est, _err = energy_estimate(means, varis, num_samples)
    f = fidelity(ansatz, state.params, gs, chunk=1 << 14)
    out = {
        "check": f"tfim_n{n}_fidelity",
        "fidelity": f,
        "energy_exact": e0,
        "energy_final": est,
        "rel_error": abs(est - e0) / abs(e0),
        "steps": steps,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def entanglement_check(n=16, steps=3000, num_samples=512, rounds=16):
    """Train the N-site critical TFIM chain on the device, then validate the
    swap-trick Renyi-2 estimator at every left-block cut against (a) the
    exact S2 of the ansatz's own state (estimator correctness, via the
    renormalized ``amplitude_table``) and (b) the exact ground state's S2
    (physics convergence).  The entanglement capability of the reference
    paper (Hibat-Allah et al., PRResearch 2, 023358, Fig. 5) — its
    repository ships no estimator.  One JSON line per cut."""
    import jax.numpy as jnp

    from rnnwavefunctions.ed import exact
    from rnnwavefunctions.ed.fidelity import amplitude_table
    from rnnwavefunctions.vmc import observables

    if n <= 14:
        _e0, gs = exact.ground_state(exact.tfim1d_dense(n, 1.0))
    else:
        from rnnwavefunctions.ed import native

        _e0, gs, _resid = native.tfim1d_ground_state(n, 1.0)

    ansatz = PRNN1D(num_sites=n, units=(50,))
    trainer = VMCTrainer(
        ansatz, TFIM1D(num_sites=n, bx=1.0),
        TrainConfig(num_samples=num_samples, learning_rate=5e-3),
    )
    t0 = time.time()
    state, means, varis = _train_chunked(trainer, steps)
    vec = amplitude_table(ansatz, state.params, n)

    def make_round(region):
        @jax.jit
        def round_purity(params, key):
            ka, kb = jax.random.split(key)
            sa = ansatz.sample(params, ka, num_samples)
            sb = ansatz.sample(params, kb, num_samples)
            return jnp.mean(observables.renyi2_swap_terms(
                ansatz, params, sa, sb, region))

        return round_purity

    key = jax.random.PRNGKey(11)
    results = []
    for cut in range(1, n // 2 + 1):
        region = tuple(range(cut))
        fn = make_round(region)
        purs = np.asarray([
            float(fn(state.params, jax.random.fold_in(key, 64 * cut + r)))
            for r in range(rounds)
        ])
        s2_mc = float(-np.log(purs.mean()))
        err = float(purs.std(ddof=1) / (np.sqrt(rounds) * purs.mean()))
        s2_self = exact.renyi2_exact(vec, n, region)
        s2_gs = exact.renyi2_exact(gs, n, region)
        out = {
            "check": f"tfim_n{n}_renyi2_cut{cut}",
            "s2_mc": round(s2_mc, 5),
            "s2_mc_err": round(err, 5),
            "s2_exact_ansatz": round(s2_self, 5),
            "s2_exact_ground": round(s2_gs, 5),
            "pairs": rounds * num_samples,
            "wall_s": round(time.time() - t0, 1),
        }
        print(json.dumps(out), flush=True)
        results.append(out)
    return results


def _all_configs(n):
    """(2^N, N) int32 matrix of every spin configuration."""
    idx = np.arange(2**n, dtype=np.int64)
    return ((idx[:, None] >> np.arange(n)[None, :]) & 1).astype(np.int32)


def _chisq_pvalue(stat, dof):
    from scipy.stats import chi2

    return float(chi2.sf(stat, dof))


def sampler_gof(draws_per_round=4096, rounds=32, seed=7):
    """Goodness-of-fit of the samplers as they run on the device: empirical
    frequencies of ALL 2^N configurations against the ansatz's exact
    autoregressive probabilities (chi-square).  On a GPU the GRU and LSTM
    draws come from the rollout kernel (``ops/rollout.py``).
    Reference sampling semantics: ``tf.multinomial`` draws
    (``1DTFIM/RNNwavefunction.py:68`` of the reference).

    Covers the GRU sampler (N=8), the LSTM sampler (N=8), the U(1)-masked
    cRNN (N=8 — includes the zero-magnetization sector check) and the 3x3
    MDRNN."""
    from rnnwavefunctions import CRNNU1, MDRNN2D, PRNN1D

    results = []
    cases = [
        ("gru_n8", PRNN1D(num_sites=8, units=(16,)), 8, None),
        ("lstm_n8", PRNN1D(num_sites=8, units=(16,), cell="lstm"), 8, None),
        ("crnn_u1_n8", CRNNU1(num_sites=8, units=(16,)), 8, "u1"),
        ("mdrnn_3x3", MDRNN2D(nx=3, ny=3, units=12), 9, "grid"),
    ]
    for name, ansatz, n, kind in cases:
        total = draws_per_round * rounds
        params = ansatz.init(jax.random.PRNGKey(seed))
        counts = np.zeros(2**n, dtype=np.int64)
        key = jax.random.PRNGKey(seed + 1)
        for r in range(rounds):
            key, sub = jax.random.split(key)
            draws = np.asarray(ansatz.sample(params, sub, draws_per_round))
            flat = draws.reshape(draws_per_round, n)
            code = (flat.astype(np.int64) << np.arange(n)[None, :]).sum(1)
            counts += np.bincount(code, minlength=2**n)

        configs = _all_configs(n)
        if kind == "grid":
            lat = configs.reshape(-1, ansatz.nx, ansatz.ny)
            logp = np.asarray(ansatz.log_prob(params, lat))
        else:
            logp = np.asarray(ansatz.log_prob(params, configs))
        probs = np.exp(np.float64(logp))
        if kind == "u1":
            sector = configs.sum(1) == n // 2
            # sector check: every device draw obeys the U(1) constraint
            assert counts[~sector].sum() == 0, "off-sector draws!"
            probs = np.where(sector, probs, 0.0)
        # normalization sanity: exact autoregressive probs sum to 1
        assert abs(probs.sum() - 1.0) < 1e-3, probs.sum()
        probs = probs / probs.sum()

        # chi-square over cells with adequate expectation; pool the rest
        exp = probs * total
        big = exp >= 5.0
        obs_pool = counts[~big].sum()
        exp_pool = exp[~big].sum()
        stat = float(((counts[big] - exp[big]) ** 2 / exp[big]).sum())
        dof = int(big.sum()) - 1
        if exp_pool > 0:
            stat += (obs_pool - exp_pool) ** 2 / exp_pool
            dof += 1
        pval = _chisq_pvalue(stat, dof)
        results.append({
            "sampler": name,
            "draws": int(total),
            "chi2": round(stat, 1),
            "dof": dof,
            "p_value": round(pval, 4),
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def _race_problem(family, n):
    """(ansatz, hamiltonian, anchor, adam_lr) for a race family.  Anchors:
    TFIM from the reference DMRG table; J1-J2 N=100/J2=0.2 DMRG
    (BASELINE.md); MDRNN 4x4/Bx=3 from the native Lanczos oracle
    (``ed/native.py``)."""
    if family == "tfim":
        return (PRNN1D(num_sites=n, units=(50,)),
                TFIM1D(num_sites=n, bx=1.0), TFIM_DMRG[n], 5e-3, 500)
    if family == "j1j2":
        assert n == 100, "J1-J2 race anchor is published for N=100 only"
        return (CRNNU1(num_sites=n, units=(50,)),
                J1J2(num_sites=n, j1=1.0, j2=0.2, marshall_sign=True),
                J1J2_DMRG_N100[0.2], 2e-3, 512)
    if family == "mdrnn":
        from rnnwavefunctions import MDRNN2D, TFIM2D

        assert n == 16, "2D race runs the reference-default 4x4 lattice"
        return (MDRNN2D(nx=4, ny=4, units=50),
                TFIM2D(nx=4, ny=4, bx=3.0, encoding="grid"),
                -50.1866238828, 5e-3, 500)
    raise ValueError(f"unknown race family {family!r}")


def minsr_race(n=100, threshold=1e-4, num_samples=None, seeds=(0,),
               block=250, family="tfim"):
    """Wall-clock-to-threshold head-to-head: Adam (reference optimizer/lr)
    vs minSR (stash-and-contract rows, sample-space Gram, CG solve), on
    any of the three ansatz families.  Trains each in
    ``block``-step device-side blocks until the trailing-block mean energy
    is within ``threshold`` relative of the anchor, and reports steps +
    wall seconds.  The claim under test: minSR needs fewer steps than Adam
    and wins wall-clock despite its per-step premium.

    ``seeds`` varies BOTH the parameter init and the Monte-Carlo stream;
    steps-to-threshold is a noisy race statistic, so the honest headline is
    the median +- spread over >= 5 seeds, not a single run at the default
    seed."""
    ansatz, ham, ref, adam_lr, family_samples = _race_problem(family, n)
    if num_samples is None:
        num_samples = family_samples  # the published tables' batch sizes
    out = {"check": f"{family}_n{n}_minsr_race", "threshold": threshold,
           "block": block, "seeds": list(seeds)}
    for tag, cfg in [
        ("adam", TrainConfig(num_samples=num_samples,
                             learning_rate=adam_lr)),
        ("minsr", TrainConfig(num_samples=num_samples, learning_rate=5e-2,
                              optimizer="minsr")),
    ]:
        trainer = VMCTrainer(ansatz, ham, cfg)
        # compile the block program outside the clocks (a throwaway state —
        # run_steps compiles once per distinct K)
        trainer.run_steps(trainer.init(), jax.random.PRNGKey(0), block)
        runs = []
        for seed in seeds:
            key = jax.random.PRNGKey(seed)
            state = trainer.init(jax.random.fold_in(key, 0xA5))
            t0 = time.time()
            steps_done, rel = 0, float("inf")
            while steps_done < 20000 and rel > threshold:
                state, ms = trainer.run_steps(state, key, block)
                steps_done += block
                # trailing-100 window: the block mean would drag the early
                # transient through every later check
                est = float(np.asarray(ms["mean_energy"])[-100:].mean())
                rel = abs(est - ref) / abs(ref)
            runs.append({
                "seed": seed,
                "steps_to_threshold": steps_done,
                "wall_s": round(time.time() - t0, 1),
                "final_rel_error": rel,
                # a capped (20000-step) run records the cap, not a
                # threshold crossing — flag it so capped values can't
                # silently bias the medians below
                "converged": rel <= threshold,
            })
            print(json.dumps({tag: runs[-1]}), flush=True)
        steps_arr = np.asarray([r["steps_to_threshold"] for r in runs])
        wall_arr = np.asarray([r["wall_s"] for r in runs])
        out[tag] = {
            "runs": runs,
            "all_converged": all(r["converged"] for r in runs),
            "steps_median": float(np.median(steps_arr)),
            "steps_min": int(steps_arr.min()),
            "steps_max": int(steps_arr.max()),
            "wall_median_s": float(np.median(wall_arr)),
            "wall_min_s": float(wall_arr.min()),
            "wall_max_s": float(wall_arr.max()),
        }
    out["steps_ratio_median"] = (
        out["adam"]["steps_median"] / out["minsr"]["steps_median"]
    )
    out["wall_ratio_median"] = (
        out["adam"]["wall_median_s"] / out["minsr"]["wall_median_s"]
    )
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="fewer steps / fewer anchors")
    p.add_argument("--minsr-race", action="store_true",
                   help="wall-clock-to-threshold Adam vs minSR on the "
                        "N=100 flagship anchor")
    p.add_argument("--race-family", type=str, default="tfim",
                   choices=["tfim", "j1j2", "mdrnn"],
                   help="ansatz family for --minsr-race: tfim (PRNN1D, any "
                        "anchored N), j1j2 (CRNNU1, N=100 J2=0.2 to 1e-3), "
                        "mdrnn (4x4 grid, pass --race-n 16, 50-step "
                        "blocks)")
    p.add_argument("--race-n", type=int, default=100,
                   help="system size for --minsr-race (20 pairs with "
                        "--race-threshold 1e-3 and --race-block 25)")
    p.add_argument("--race-threshold", type=float, default=1e-4)
    p.add_argument("--race-block", type=int, default=250,
                   help="steps per device dispatch / check cadence")
    p.add_argument("--seeds", type=int, default=1,
                   help="number of seeds for --minsr-race (median +- "
                        "spread over seeds 0..K-1)")
    p.add_argument("--gof", action="store_true",
                   help="sampler goodness-of-fit only (chi-square of the "
                        "device samplers vs exact probabilities)")
    p.add_argument("--fidelity", type=int, metavar="N", default=None,
                   help="train the N-site TFIM and report the exact-ground-"
                        "state fidelity (dense to N=16, Lanczos to N=24)")
    p.add_argument("--renyi2", type=int, metavar="N", default=None,
                   help="train the N-site TFIM and validate the swap-trick "
                        "Renyi-2 entropy at every left-block cut against "
                        "the exact oracles (N <= 24)")
    args = p.parse_args(argv)

    if args.minsr_race:
        return minsr_race(n=args.race_n, threshold=args.race_threshold,
                          seeds=tuple(range(args.seeds)),
                          block=args.race_block, family=args.race_family)
    if args.gof:
        return sampler_gof()
    if args.fidelity is not None:
        return fidelity_check(n=args.fidelity,
                              steps=3000 if args.quick else 8000)
    if args.renyi2 is not None:
        return entanglement_check(n=args.renyi2,
                                  steps=1500 if args.quick else 3000)

    anchors = []
    tfim_ns = [20, 100] if args.quick else [20, 40, 100]
    steps = 3000 if args.quick else 8000
    for n in tfim_ns:
        t0 = time.time()
        est, err = run_tfim(n, steps)
        ref = TFIM_DMRG[n]
        anchors.append({
            "anchor": f"1dtfim_n{n}_dmrg",
            "reference": ref,
            "estimate": est,
            "err_bar": err,
            "rel_error": abs(est - ref) / abs(ref),
            "steps": steps,
            "wall_s": round(time.time() - t0, 1),
        })
        print(json.dumps(anchors[-1]), flush=True)

    if not args.quick:
        for j2, ref in J1J2_DMRG_N100.items():
            t0 = time.time()
            est, err = run_j1j2(100, j2, steps)
            anchors.append({
                "anchor": f"j1j2_n100_j2_{j2}_dmrg",
                "reference": ref,
                "estimate": est,
                "err_bar": err,
                "rel_error": abs(est - ref) / abs(ref),
                "steps": steps,
                "wall_s": round(time.time() - t0, 1),
            })
            print(json.dumps(anchors[-1]), flush=True)

    worst = max(a["rel_error"] for a in anchors)
    print(json.dumps({"worst_rel_error": worst, "n_anchors": len(anchors)}))
    return anchors


if __name__ == "__main__":
    main()
