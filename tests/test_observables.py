"""Observables and the evaluation-only API."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnnwavefunctions import (
    CRNNU1, J1J2, PRNN1D, TFIM1D, TrainConfig, VMCTrainer,
)
from rnnwavefunctions.ed import exact
from rnnwavefunctions.vmc import observables


def test_magnetization_and_correlations():
    samples = jnp.asarray([[0, 0, 1, 1], [1, 1, 0, 0]], jnp.int32)
    np.testing.assert_allclose(float(observables.magnetization(samples)), 0.0)
    c = np.asarray(observables.zz_correlations(samples))
    # site 0 and site 1 always agree -> connected correlation 1
    np.testing.assert_allclose(c[0, 1], 1.0, atol=1e-6)
    # site 0 and site 2 always disagree -> -1
    np.testing.assert_allclose(c[0, 2], -1.0, atol=1e-6)


def test_energy_estimate_convention():
    mean_e = [-1.0] * 50 + [-2.0] * 100
    var_e = [0.25] * 150
    est, err = observables.energy_estimate(mean_e, var_e, num_samples=100)
    np.testing.assert_allclose(est, -2.0)
    np.testing.assert_allclose(err, np.sqrt(0.25 / (100 * 100)))


def test_trainer_evaluate_real():
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6),
        TrainConfig(num_samples=64),
    )
    state = trainer.init()
    out = trainer.evaluate(state, jax.random.PRNGKey(0))
    assert np.isfinite(float(out["mean_energy"]))
    assert float(out["var_energy"]) >= 0.0
    assert -1.0 <= float(out["magnetization"]) <= 1.0


def test_trainer_evaluate_complex_zero_mag():
    trainer = VMCTrainer(
        CRNNU1(num_sites=6, units=(8,)),
        J1J2(num_sites=6, j2=0.2, marshall_sign=True),
        TrainConfig(num_samples=64),
    )
    state = trainer.init()
    out = trainer.evaluate(state, jax.random.PRNGKey(0))
    assert "mean_energy_im" in out
    # U(1) sampler: exactly zero magnetization
    np.testing.assert_allclose(float(out["magnetization"]), 0.0, atol=1e-6)


def test_schedules():
    from rnnwavefunctions.vmc.trainer import TrainConfig, make_schedule
    import jax.numpy as jnp

    s = make_schedule(TrainConfig(learning_rate=1e-2, schedule="constant"))
    np.testing.assert_allclose(float(s(jnp.int32(500))), 1e-2)
    s = make_schedule(TrainConfig(learning_rate=1e-2, schedule="inverse",
                                  decay_scale=10.0))
    np.testing.assert_allclose(float(s(jnp.int32(10))), 1e-2 / 2)
    s = make_schedule(TrainConfig(learning_rate=1e-2, schedule="harmonic",
                                  decay_scale=10.0))
    # 1/((1/lr)+(step/10)): at step 1000 -> 1/(100+100) = 5e-3
    np.testing.assert_allclose(float(s(jnp.int32(1000))), 5e-3, rtol=1e-6)
    s = make_schedule(TrainConfig(learning_rate=1e-2, schedule="exponential",
                                  decay_rate=0.5, decay_steps=100,
                                  staircase=True))
    np.testing.assert_allclose(float(s(jnp.int32(199))), 5e-3)
    np.testing.assert_allclose(float(s(jnp.int32(200))), 2.5e-3)
    # staged: piecewise-constant phases (the J1-J2 minSR record recipe),
    # scales compounding at each bound
    s = make_schedule(TrainConfig(learning_rate=5e-2, schedule="staged",
                                  lr_stage_bounds=(10000, 13000),
                                  lr_stage_scales=(0.1, 0.2)))
    np.testing.assert_allclose(float(s(jnp.int32(9999))), 5e-2, rtol=1e-6)
    np.testing.assert_allclose(float(s(jnp.int32(10000))), 5e-3, rtol=1e-6)
    np.testing.assert_allclose(float(s(jnp.int32(13000))), 1e-3, rtol=1e-6)
    import pytest
    with pytest.raises(ValueError, match="matching"):
        make_schedule(TrainConfig(schedule="staged",
                                  lr_stage_bounds=(10,),
                                  lr_stage_scales=()))
    with pytest.raises(ValueError, match="ascend"):
        make_schedule(TrainConfig(schedule="staged",
                                  lr_stage_bounds=(20, 10),
                                  lr_stage_scales=(0.1, 0.1)))


# -- off-diagonal estimators ------------------------------------------------


def _all_configs(n):
    return jnp.asarray(list(itertools.product([0, 1], repeat=n)), jnp.int32)


def test_structure_factor_neel_and_uniform():
    n = 6
    neel = jnp.asarray([[0, 1] * (n // 2)], jnp.int32)
    sk = np.asarray(observables.structure_factor(neel))
    # Neel: <z_i z_j> = (-1)^(i-j) -> S(pi) = N, S(0) = 0
    k = 2 * np.pi * np.arange(n) / n
    np.testing.assert_allclose(sk[np.argmin(np.abs(k - np.pi))], n, atol=1e-4)
    np.testing.assert_allclose(sk[0], 0.0, atol=1e-4)
    up = jnp.ones((3, n), jnp.int32)
    sk = np.asarray(observables.structure_factor(up))
    np.testing.assert_allclose(sk[0], n, atol=1e-4)  # Bragg peak at k=0
    sk_c = np.asarray(observables.structure_factor(up, connected=True))
    np.testing.assert_allclose(sk_c, 0.0, atol=1e-4)  # subtracted


def test_structure_factor_matches_double_sum():
    """The O(SK) cos/sin projection form == the explicit double sum
    (1/N) sum_ij cos(k(i-j)) <z_i z_j> on random samples."""
    rng = np.random.default_rng(3)
    n, s = 7, 40
    samples = jnp.asarray(rng.integers(0, 2, (s, n)), jnp.int32)
    z = 2.0 * np.asarray(samples, np.float64) - 1.0
    k = 2 * np.pi * np.arange(n) / n
    for connected in (False, True):
        corr = z.T @ z / s
        if connected:
            mz = z.mean(axis=0)
            corr = corr - np.outer(mz, mz)
        dist = np.arange(n)[:, None] - np.arange(n)[None, :]
        want = np.array(
            [np.sum(np.cos(kk * dist) * corr) / n for kk in k]
        )
        got = np.asarray(
            observables.structure_factor(samples, connected=connected)
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sigma_x_matches_hand_ratios_real():
    n = 5
    ansatz = PRNN1D(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(1))
    batch = _all_configs(n)[7:23]
    la = np.asarray(ansatz.log_amp(params, batch), np.float64)
    want = np.zeros(n)
    for i in range(n):
        flipped = np.asarray(batch).copy()
        flipped[:, i] ^= 1
        laf = np.asarray(ansatz.log_amp(params, jnp.asarray(flipped)),
                         np.float64)
        want[i] = np.mean(np.exp(laf - la))
    got = np.asarray(observables.sigma_x(ansatz, params, batch, chunk_size=8))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    # passing the precomputed log-amps gives the same answer
    got2 = np.asarray(observables.sigma_x(
        ansatz, params, batch, log_amp_samples=ansatz.log_amp(params, batch)))
    np.testing.assert_allclose(got2, got, rtol=1e-6)


@pytest.mark.slow
def test_sigma_x_u1_sector_is_zero():
    ansatz = CRNNU1(num_sites=6, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(0))
    samples = ansatz.sample(params, jax.random.PRNGKey(2), 32)
    sx = np.asarray(observables.sigma_x(ansatz, params, samples))
    # every single flip leaves the U(1) sector -> psi(s^i) = 0
    assert np.max(np.abs(sx)) < 1e-6, sx


@pytest.mark.slow
def test_spin_spin_matches_hand_ratios_complex():
    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(3))
    samples = ansatz.sample(params, jax.random.PRNGKey(4), 24)
    pairs = np.asarray([[0, 1], [1, 3], [2, 5], [0, 5]], np.int32)
    re_s, im_s = ansatz.log_amp_parts(params, samples)
    re_s, im_s = np.asarray(re_s, np.float64), np.asarray(im_s, np.float64)
    flat = np.asarray(samples)
    want = np.zeros(len(pairs))
    for pi, (i, j) in enumerate(pairs):
        sw = flat.copy()
        sw[:, [i, j]] ^= 1
        re_f, im_f = ansatz.log_amp_parts(params, jnp.asarray(sw))
        ratio = np.exp(np.asarray(re_f, np.float64) - re_s) * np.cos(
            np.asarray(im_f, np.float64) - im_s)
        differ = (flat[:, i] != flat[:, j]).astype(np.float64)
        zz = (2.0 * flat[:, i] - 1) * (2.0 * flat[:, j] - 1) / 4.0
        want[pi] = np.mean(zz + 0.5 * differ * ratio)
    got = np.asarray(observables.spin_spin_correlations(
        ansatz, params, samples, pairs, chunk_size=16))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.slow
def test_sigma_x_converges_to_ed():
    """Train tiny TFIM, then the off-diagonal <sum_i sigma^x_i> estimator
    must match the dense-ED ground-state value (the same flip machinery the
    energy uses, so this anchors the estimator end-to-end)."""
    n, bx = 6, 1.0
    h = exact.tfim1d_dense(n, bx)
    _, gs = np.linalg.eigh(h)
    psi0 = gs[:, 0]
    # total sigma^x via the ED bit convention (exact._bits): flip bit i
    sx_ed = 0.0
    for s in range(1 << n):
        for i in range(n):
            sx_ed += psi0[s ^ (1 << i)] * psi0[s]
    ansatz = PRNN1D(num_sites=n, units=(16,))
    trainer = VMCTrainer(ansatz, TFIM1D(num_sites=n, bx=bx),
                         TrainConfig(num_samples=256, learning_rate=5e-3))
    state, mean_e, _ = trainer.fit(400, key=jax.random.PRNGKey(0))
    samples = ansatz.sample(state.params, jax.random.PRNGKey(9), 4096)
    sx = float(np.sum(np.asarray(
        observables.sigma_x(ansatz, state.params, samples))))
    assert abs(sx - sx_ed) < 0.05 * abs(sx_ed), (sx, sx_ed)


def test_trainer_evaluate_extra_observables():
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6),
        TrainConfig(num_samples=64),
    )
    state = trainer.init()
    out = trainer.evaluate(state, jax.random.PRNGKey(0),
                           observables=("sigma_x", "structure_factor"))
    sx = np.asarray(out["sigma_x"])
    sk = np.asarray(out["structure_factor"])
    assert sx.shape == (6,) and np.all(np.isfinite(sx))
    assert sk.shape == (6,) and np.all(sk >= -1e-5)
    # matches the standalone estimator on the same draw (the eval fn and
    # the library function must be the same computation)
    with pytest.raises(ValueError):
        trainer.evaluate(state, jax.random.PRNGKey(0), observables=("nope",))


# -- Renyi-2 entanglement entropy (swap trick) --------------------------------


def test_renyi2_exact_product_and_bell():
    """Oracle sanity: product states have S2 = 0 across every cut; a Bell
    pair across the cut has S2 = log 2 (basis: bit i of the index = site i,
    ed/exact.py convention)."""
    rng = np.random.default_rng(0)
    n = 4
    sites = [rng.normal(size=2) for _ in range(n)]
    vec = np.ones(1)
    for i in reversed(range(n)):  # site n-1 slowest: s = sum_i b_i 2^i
        vec = np.kron(vec, sites[i] / np.linalg.norm(sites[i]))
    for region in ([0], [1, 3], [0, 2, 3]):
        np.testing.assert_allclose(
            exact.renyi2_exact(vec, n, region), 0.0, atol=1e-12)
    # Bell pair between sites 0 and 2; sites 1, 3 pinned to |0>
    bell = np.zeros(1 << n)
    for b in (0, 1):
        bell[b * (1 << 0) + b * (1 << 2)] = 1.0 / np.sqrt(2.0)
    np.testing.assert_allclose(
        exact.renyi2_exact(bell, n, [0]), np.log(2.0), atol=1e-12)
    np.testing.assert_allclose(
        exact.renyi2_exact(bell, n, [0, 1]), np.log(2.0), atol=1e-12)
    np.testing.assert_allclose(  # both Bell partners inside A: pure
        exact.renyi2_exact(bell, n, [0, 2]), 0.0, atol=1e-12)
    with pytest.raises(ValueError):
        exact.renyi2_exact(bell, n, [])
    with pytest.raises(ValueError):
        exact.renyi2_exact(bell, n, [0, 1, 2, 3])


def test_renyi2_swap_enumeration_matches_exact_real():
    """Exhaustive-pair expectation of the swap terms == the dense oracle
    on the ansatz's own amplitude table (no MC noise: every (sigma, tau)
    pair weighted by p(sigma) p(tau))."""
    from rnnwavefunctions.ed.fidelity import amplitude_table, basis_configs

    n = 6
    ansatz = PRNN1D(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(7))
    vec = amplitude_table(ansatz, params, n)
    p = np.abs(vec) ** 2
    cfgs = jnp.asarray(basis_configs(n))
    dim = 1 << n
    sa = jnp.repeat(cfgs, dim, axis=0)
    sb = jnp.tile(cfgs, (dim, 1))
    w = np.repeat(p, dim) * np.tile(p, dim)
    for region in ([0, 1, 2], [1, 4]):
        terms = np.asarray(observables.renyi2_swap_terms(
            ansatz, params, sa, sb, region, chunk_size=512), np.float64)
        got = -np.log(np.sum(w * terms))
        want = exact.renyi2_exact(vec, n, region)
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.slow
def test_renyi2_u1_complex_enumeration():
    """Complex U(1) head: enumeration over the zero-magnetization sector
    matches the dense oracle, and swaps that leave the sector contribute
    exactly ~0 (psi = 0 on the swapped configuration)."""
    from rnnwavefunctions.ed.fidelity import amplitude_table, basis_configs

    n = 6
    ansatz = CRNNU1(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(8))
    vec = amplitude_table(ansatz, params, n)
    p = np.abs(vec) ** 2
    cfgs = basis_configs(n)
    sector = np.where(cfgs.sum(axis=1) == n // 2)[0]
    assert p[np.setdiff1d(np.arange(1 << n), sector)].max() < 1e-20
    sc = jnp.asarray(cfgs[sector])
    m = len(sector)
    sa = jnp.repeat(sc, m, axis=0)
    sb = jnp.tile(sc, (m, 1))
    ps = p[sector]
    w = np.repeat(ps, m) * np.tile(ps, m)
    region = [0, 1]
    terms = np.asarray(observables.renyi2_swap_terms(
        ansatz, params, sa, sb, region, chunk_size=128), np.float64)
    got = -np.log(np.sum(w * terms) / np.sum(w))
    want = exact.renyi2_exact(vec, n, region)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # an explicitly sector-breaking swap: sigma = 000111, tau = 111000,
    # A = {0}: sigma' carries 4 up spins -> psi(sigma') = 0
    sig = jnp.asarray([[0, 0, 0, 1, 1, 1]], jnp.int32)
    tau = jnp.asarray([[1, 1, 1, 0, 0, 0]], jnp.int32)
    t0 = float(observables.renyi2_swap_terms(
        ansatz, params, sig, tau, [0])[0])
    assert abs(t0) < 1e-10, t0


def test_renyi2_entropy_region_validation():
    n = 6
    ansatz = PRNN1D(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(9))
    samples = ansatz.sample(params, jax.random.PRNGKey(10), 8)
    for bad in ([], list(range(n)), [0, 0], [-1], [n]):
        with pytest.raises(ValueError):
            observables.renyi2_entropy(
                ansatz, params, samples, samples[::-1], bad)
    with pytest.raises(ValueError):  # replica shape mismatch
        observables.renyi2_entropy(
            ansatz, params, samples, samples[:4], [0])


def test_trainer_evaluate_renyi2():
    trainer = VMCTrainer(
        PRNN1D(num_sites=6, units=(8,)), TFIM1D(num_sites=6),
        TrainConfig(num_samples=128),
    )
    state = trainer.init()
    out = trainer.evaluate(state, jax.random.PRNGKey(0),
                           observables=("renyi2",))
    purity = float(out["renyi2_purity"])
    s2 = float(out["renyi2"])
    assert 0.0 < purity <= 1.0 + 1e-4
    np.testing.assert_allclose(s2, -np.log(purity), rtol=1e-6)


def test_spin_spin_same_site_identity():
    """<S_i . S_i> = 3/4 for spin-1/2; equal pairs must also not build
    out-of-alphabet flip configs (the XOR'd mask is all-zero for them)."""
    n = 6
    ansatz = PRNN1D(num_sites=n, units=(8,))
    params = ansatz.init(jax.random.PRNGKey(5))
    samples = ansatz.sample(params, jax.random.PRNGKey(6), 16)
    pairs = np.asarray([[2, 2], [0, 3], [5, 5]], np.int32)
    got = np.asarray(observables.spin_spin_correlations(
        ansatz, params, samples, pairs, chunk_size=8))
    assert got[0] == 0.75 and got[2] == 0.75
    assert np.isfinite(got[1]) and abs(got[1]) <= 0.75 + 1e-6


def test_structure_factor_2d_matches_double_sum():
    """The O(SK) 2D projection form == the explicit double sum
    (1/N) sum_ij cos(k.(ri-rj)) <z_i z_j>, for both sample encodings
    (grid [x, y] batches and the snake family's y-major flat batches)."""
    rng = np.random.default_rng(5)
    nx, ny, s = 3, 4, 40
    grid = jnp.asarray(rng.integers(0, 2, (s, nx, ny)), jnp.int32)
    z = 2.0 * np.asarray(grid, np.float64).reshape(s, nx * ny) - 1.0
    xs = np.arange(nx * ny) // ny
    ys = np.arange(nx * ny) % ny
    kxs = 2 * np.pi * np.arange(nx) / nx
    kys = 2 * np.pi * np.arange(ny) / ny
    for connected in (False, True):
        corr = z.T @ z / s
        if connected:
            mz = z.mean(axis=0)
            corr = corr - np.outer(mz, mz)
        want = np.zeros((nx, ny))
        for a, kx in enumerate(kxs):
            for b, ky in enumerate(kys):
                phase = kx * (xs[:, None] - xs[None, :]) + ky * (
                    ys[:, None] - ys[None, :]
                )
                want[a, b] = np.sum(np.cos(phase) * corr) / (nx * ny)
        got = np.asarray(
            observables.structure_factor_2d(grid, connected=connected)
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # flat y-major encoding (TFIM2D "flat": i = y*Nx + x) of the SAME
    # configurations gives the SAME S(kx, ky)
    flat = jnp.asarray(
        np.asarray(grid).transpose(0, 2, 1).reshape(s, nx * ny)
    )
    got_flat = np.asarray(observables.structure_factor_2d(flat, nx=nx, ny=ny))
    got_grid = np.asarray(observables.structure_factor_2d(grid))
    np.testing.assert_allclose(got_flat, got_grid, rtol=1e-5, atol=1e-6)


def test_trainer_evaluate_structure_factor_2d():
    """2D workloads report the S(kx, ky) momentum grid from evaluate()
    (the round-3 CLI fail-fast is gone) — both the MDRNN grid family and
    the snake flat family."""
    from rnnwavefunctions import MDRNN2D, PRNNSnake2D, TFIM2D

    tr = VMCTrainer(
        MDRNN2D(nx=3, ny=4, units=8),
        TFIM2D(nx=3, ny=4, bx=3.0, encoding="grid"),
        TrainConfig(num_samples=64),
    )
    out = tr.evaluate(tr.init(), jax.random.PRNGKey(0),
                      observables=("structure_factor",))
    sk = np.asarray(out["structure_factor"])
    assert sk.shape == (3, 4) and np.all(sk >= -1e-5)

    tr2 = VMCTrainer(
        PRNNSnake2D(nx=3, ny=4, units=(8,)),
        TFIM2D(nx=3, ny=4, bx=3.0, encoding="flat"),
        TrainConfig(num_samples=64),
    )
    out2 = tr2.evaluate(tr2.init(), jax.random.PRNGKey(1),
                        observables=("structure_factor",))
    sk2 = np.asarray(out2["structure_factor"])
    assert sk2.shape == (3, 4) and np.all(sk2 >= -1e-5)
