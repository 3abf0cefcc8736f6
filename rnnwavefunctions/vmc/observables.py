"""Observables measured on Monte-Carlo samples.

The reference's measurement surface is the per-step energy statistics plus a
commented magnetization print (``/root/reference/J1J2/TrainingRNN_J1J2.py:252``)
and the notebook estimator convention
``mean(E[-w:]) +- sqrt(max(varE[-w:]) / (numsamples * w))``
(``Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` cell 18).  This module provides
those as first-class, jit-friendly functions, plus sigma^z correlation
functions and *off-diagonal* estimators (``sigma_x``,
``spin_spin_correlations``) built on the same amplitude-ratio machinery as
the local energies: for an operator with matrix elements <s|O|s'>, the VMC
estimator is ``mean_s sum_s' <s|O|s'> psi(s')/psi(s)`` with s drawn from
|psi|^2.  Ratios are evaluated through the ansatz's ``log_amp`` /
``log_amp_parts`` (real (Re, Im) pairs throughout), chunked via the shared
``_chunked_apply`` lax.map helper.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def magnetization(samples: jax.Array) -> jax.Array:
    """Mean magnetization <sigma^z> per site over the batch; samples are
    {0,1}-encoded of any lattice shape (``2*samples - 1`` as in the
    reference's print)."""
    z = 2.0 * samples.astype(jnp.float32) - 1.0
    return jnp.mean(z)


def zz_correlations(samples: jax.Array) -> jax.Array:
    """Connected <z_i z_j> - <z_i><z_j> over a flat (S, N) sample batch."""
    z = 2.0 * samples.reshape(samples.shape[0], -1).astype(jnp.float32) - 1.0
    mean_z = jnp.mean(z, axis=0)
    return z.T @ z / z.shape[0] - jnp.outer(mean_z, mean_z)


def structure_factor(
    samples: jax.Array,
    k: Optional[jax.Array] = None,
    connected: bool = False,
) -> jax.Array:
    """Static spin structure factor ``S(k) = (1/N) sum_ij cos(k (i-j))
    <z_i z_j>`` over a flat (S, N) {0,1} sample batch (z = 2s-1; sites on a
    unit-spaced chain; the sine part cancels by ij symmetry, so the whole
    computation stays real).

    ``k`` defaults to the N commensurate momenta ``2 pi m / N``.  With
    ``connected=True`` the disconnected ``<z_i><z_j>`` piece is subtracted
    (removes the Bragg peak from a net magnetization).
    """
    z = 2.0 * samples.reshape(samples.shape[0], -1).astype(jnp.float32) - 1.0
    n = z.shape[1]
    if k is None:
        k = 2.0 * jnp.pi * jnp.arange(n, dtype=jnp.float32) / n
    k = jnp.asarray(k, jnp.float32)
    # cos(k(i-j)) = cos(ki)cos(kj) + sin(ki)sin(kj), so S(k) reduces to two
    # (S, N) @ (N, K) projections — O(SK) memory instead of the (K, N, N)
    # phase tensor (which is ~4 GB at the N=1000 workloads).
    sites = jnp.arange(n, dtype=jnp.float32)
    ck = jnp.cos(sites[:, None] * k[None, :])
    sk = jnp.sin(sites[:, None] * k[None, :])
    pc, ps = z @ ck, z @ sk
    s_k = jnp.mean(pc * pc, axis=0) + jnp.mean(ps * ps, axis=0)
    if connected:
        mean_z = jnp.mean(z, axis=0)
        s_k = s_k - (mean_z @ ck) ** 2 - (mean_z @ sk) ** 2
    return s_k / n


def structure_factor_2d(
    samples: jax.Array,
    nx: Optional[int] = None,
    ny: Optional[int] = None,
    kx: Optional[jax.Array] = None,
    ky: Optional[jax.Array] = None,
    connected: bool = False,
) -> jax.Array:
    """Static structure factor ``S(kx, ky) = (1/N) sum_ij
    cos(k . (r_i - r_j)) <z_i z_j>`` on an Nx x Ny lattice (z = 2s-1,
    unit lattice spacing).

    Accepts the two 2D sample encodings of ``hamiltonians/tfim2d.TFIM2D``:
    grid batches shaped (S, Nx, Ny) indexed [x, y] (the MDRNN family), or
    flat (S, Nx*Ny) batches in the snake ansatz's y-major order
    (flat index i = y*Nx + x) with ``nx``/``ny`` given.  Same O(S*K)
    two-projection form as the 1D ``structure_factor`` (cos(k.(ri-rj)) =
    cos(k.ri)cos(k.rj) + sin(k.ri)sin(k.rj); everything stays real), never
    materializing the (K, N, N) phase tensor.  ``kx``/``ky`` default to the commensurate momenta
    ``2 pi m / Nx`` x ``2 pi m / Ny``; the result is a (len(kx), len(ky))
    grid.  With ``connected=True`` the ``<z_i><z_j>`` piece is subtracted.
    Reference context: the 2D TFIM study's physics
    (``/root/reference/2DTFIM_2DRNN/Training2DRNN_2DTFIM.py:13-83``) — the
    reference itself measures only energies.
    """
    if samples.ndim == 3:
        s, nx, ny = samples.shape
        z = 2.0 * samples.reshape(s, nx * ny).astype(jnp.float32) - 1.0
        i = jnp.arange(nx * ny)
        xs = (i // ny).astype(jnp.float32)  # [x, y] row-major flatten
        ys = (i % ny).astype(jnp.float32)
    else:
        if nx is None or ny is None:
            raise ValueError("flat 2D samples need nx and ny")
        if samples.shape[1] != nx * ny:
            raise ValueError(
                f"flat samples have {samples.shape[1]} sites, "
                f"expected nx*ny = {nx * ny}"
            )
        z = 2.0 * samples.astype(jnp.float32) - 1.0
        i = jnp.arange(nx * ny)
        xs = (i % nx).astype(jnp.float32)  # y-major flat order (TFIM2D flat)
        ys = (i // nx).astype(jnp.float32)
    n = nx * ny
    if kx is None:
        kx = 2.0 * jnp.pi * jnp.arange(nx, dtype=jnp.float32) / nx
    if ky is None:
        ky = 2.0 * jnp.pi * jnp.arange(ny, dtype=jnp.float32) / ny
    kx = jnp.atleast_1d(jnp.asarray(kx, jnp.float32))
    ky = jnp.atleast_1d(jnp.asarray(ky, jnp.float32))
    kxg = jnp.repeat(kx, ky.shape[0])
    kyg = jnp.tile(ky, kx.shape[0])
    phase = xs[:, None] * kxg[None, :] + ys[:, None] * kyg[None, :]
    ck, sk = jnp.cos(phase), jnp.sin(phase)
    pc, ps = z @ ck, z @ sk
    s_k = jnp.mean(pc * pc, axis=0) + jnp.mean(ps * ps, axis=0)
    if connected:
        mean_z = jnp.mean(z, axis=0)
        s_k = s_k - (mean_z @ ck) ** 2 - (mean_z @ sk) ** 2
    return (s_k / n).reshape(kx.shape[0], ky.shape[0])


def _log_amp_of(ansatz: Any, params: Any, samples: jax.Array):
    """(Re, Im) log-amplitude pair for any ansatz head (Im None if real)."""
    if getattr(ansatz, "is_complex", False):
        return ansatz.log_amp_parts(params, samples)
    return ansatz.log_amp(params, samples), None


def _ratio_re(la_f, la_s, im_f, im_s):
    """Re[psi(s')/psi(s)] from log-amplitude (Re, Im) pairs."""
    if im_f is None:
        return jnp.exp(la_f - la_s)
    return jnp.exp(la_f - la_s) * jnp.cos(im_f - im_s)


def sigma_x(
    ansatz: Any,
    params: Any,
    samples: jax.Array,
    log_amp_samples=None,
    chunk_size: Optional[int] = None,
) -> jax.Array:
    """Per-site transverse magnetization ``<sigma^x_i>`` (off-diagonal).

    ``<s|sigma^x_i|s'> = 1`` for s' = s with site i flipped, so the
    estimator is ``mean_s Re[psi(s^i)/psi(s)]`` — the same single-flip
    ratios the TFIM local energy uses (the reference only ever prints
    energies; this extends the measurement surface).  Returns an (N,) array
    over flattened lattice sites.  For a U(1)-projected complex ansatz every
    single flip leaves the magnetization sector, psi(s^i) = 0, and the
    estimator is identically ~0 — physically correct.

    ``log_amp_samples`` is log psi of the drawn batch (pass it when already
    available to skip one forward); for complex heads pass the (Re, Im)
    tuple from ``log_amp_parts``.
    """
    from .local_energy import _chunked_apply

    s = samples.shape[0]
    lat = samples.shape[1:]
    n = int(np.prod(lat))
    flat = samples.reshape(s, n)
    # chunk over (sample, site) indices and materialize each chunk's flipped
    # configs inside the mapped fn: peak memory O(chunk * N), not the full
    # (S*N, N) flip matrix (~2 GB at the N=1000, S=500 workload)
    idx = jnp.arange(s * n, dtype=jnp.int32)

    def _flips_of(ix):
        cfg = flat[ix // n] ^ jax.nn.one_hot(ix % n, n, dtype=flat.dtype)
        return cfg.reshape(ix.shape[:1] + lat)

    if log_amp_samples is None:
        log_amp_samples = _log_amp_of(ansatz, params, samples)
    elif not isinstance(log_amp_samples, tuple):
        log_amp_samples = (log_amp_samples, None)
    la_s, im_s = log_amp_samples
    la_f, im_f = _chunked_apply(
        lambda ix: _log_amp_of(ansatz, params, _flips_of(ix)), idx, chunk_size
    )
    la_f = la_f.reshape(s, n)
    im_f = None if im_f is None else im_f.reshape(s, n)
    ratios = _ratio_re(
        la_f, la_s[:, None], im_f, None if im_s is None else im_s[:, None]
    )
    return jnp.mean(ratios, axis=0)


def spin_spin_correlations(
    ansatz: Any,
    params: Any,
    samples: jax.Array,
    pairs: jax.Array,
    log_amp_samples=None,
    chunk_size: Optional[int] = None,
) -> jax.Array:
    """Spin-1/2 correlator ``<S_i . S_j>`` for the given (P, 2) site pairs
    (flat indices), including the off-diagonal exchange part:

    ``S_i.S_j = S^z_i S^z_j + (S^+_i S^-_j + S^-_i S^+_j)/2`` with estimator
    ``z_i z_j / 4 + (1/2) 1{s_i != s_j} Re[psi(s^{ij})/psi(s)]`` where
    s^{ij} has both sites flipped — the same exchange configurations the
    J1-J2 local energy evaluates (``hamiltonians/j1j2.py``;
    reference matrix elements ``/root/reference/J1J2/TrainingRNN_J1J2.py`` /
    ``MatrixElements``).  U(1)-safe: the exchange keeps the sector.
    Returns a (P,) array.
    """
    from .local_energy import _chunked_apply

    s = samples.shape[0]
    lat = samples.shape[1:]
    n = int(np.prod(lat))
    flat = samples.reshape(s, n)
    pairs = jnp.asarray(pairs, jnp.int32)
    p = pairs.shape[0]
    si = flat[:, pairs[:, 0]]
    sj = flat[:, pairs[:, 1]]
    z = lambda b: 2.0 * b.astype(jnp.float32) - 1.0
    diag = z(si) * z(sj) / 4.0
    differ = (si != sj).astype(jnp.float32)
    same_site = pairs[:, 0] == pairs[:, 1]  # (P,) — <S_i.S_i> = 3/4
    flip_mask = (
        jax.nn.one_hot(pairs[:, 0], n, dtype=flat.dtype)
        ^ jax.nn.one_hot(pairs[:, 1], n, dtype=flat.dtype)
    )
    # chunk over (sample, pair) indices; each chunk's exchange configs are
    # built inside the mapped fn (see sigma_x)
    idx = jnp.arange(s * p, dtype=jnp.int32)

    def _swaps_of(ix):
        cfg = flat[ix // p] ^ flip_mask[ix % p]
        return cfg.reshape(ix.shape[:1] + lat)

    if log_amp_samples is None:
        log_amp_samples = _log_amp_of(ansatz, params, samples)
    elif not isinstance(log_amp_samples, tuple):
        log_amp_samples = (log_amp_samples, None)
    la_s, im_s = log_amp_samples
    la_f, im_f = _chunked_apply(
        lambda ix: _log_amp_of(ansatz, params, _swaps_of(ix)), idx, chunk_size
    )
    la_f = la_f.reshape(s, p)
    im_f = None if im_f is None else im_f.reshape(s, p)
    ratios = _ratio_re(
        la_f, la_s[:, None], im_f, None if im_s is None else im_s[:, None]
    )
    # where, not multiply: a masked pair's double-flip config can be
    # arbitrarily improbable (or exactly off-sector under U(1)) and its
    # ratio must never reach the sum, even as inf/NaN
    ratios = jnp.where(differ > 0, ratios, 0.0)
    out = jnp.mean(diag + 0.5 * ratios, axis=0)
    # i == j pairs: the XOR'd flip mask is all-zero (valid configs) but the
    # estimator above gives z_i^2/4 = 1/4; the spin-1/2 identity is 3/4
    return jnp.where(same_site, 0.75, out)


def _region_mask(region, n: int) -> np.ndarray:
    """{0,1} site mask for a subsystem given as flat site indices."""
    region = np.asarray(region, np.int64).ravel()
    if region.size == 0 or region.size >= n:
        raise ValueError(
            f"subsystem must be a proper nonempty subset of the {n} sites")
    if np.unique(region).size != region.size:
        raise ValueError("subsystem indices must be distinct")
    if region.min() < 0 or region.max() >= n:
        raise ValueError(f"subsystem indices out of range [0, {n})")
    mask = np.zeros((n,), np.int32)
    mask[region] = 1
    return mask


def renyi2_swap_terms(
    ansatz: Any,
    params: Any,
    samples_a: jax.Array,
    samples_b: jax.Array,
    region,
    log_amp_a=None,
    log_amp_b=None,
    chunk_size: Optional[int] = None,
) -> jax.Array:
    """Per-pair terms of the two-replica SWAP estimator of ``Tr rho_A^2``.

    With two independent batches sigma, tau ~ |psi|^2 and the swapped
    configurations sigma' = (tau_A, sigma_B), tau' = (sigma_A, tau_B),

        Tr rho_A^2 = E[ psi(sigma') psi(tau') / (psi(sigma) psi(tau)) ]

    — the replica trick the reference paper uses for its entanglement
    entropies (Hibat-Allah et al., PRResearch 2, 023358, Fig. 5; the
    reference repository itself ships no estimator — README.md claims the
    capability, this provides it).  Returns the (S,) real per-pair terms;
    ``jnp.mean`` of them estimates the purity and
    ``-log`` of that is the second Renyi entropy (``renyi2_entropy``).

    ``region`` is a static sequence of flat site indices for subsystem A.
    U(1)-projected ansatze are handled naturally: a swap that leaves the
    magnetization sector has psi(sigma') = 0 and contributes exactly 0.
    ``log_amp_a``/``log_amp_b`` are the batches' log-amplitudes (pass the
    (Re, Im) tuple for complex heads) when already available.
    """
    from .local_energy import _chunked_apply

    s = samples_a.shape[0]
    lat = samples_a.shape[1:]
    n = int(np.prod(lat))
    if samples_b.shape != samples_a.shape:
        raise ValueError("the two replica batches must have equal shapes")
    mask = jnp.asarray(_region_mask(region, n))[None, :]
    fa = samples_a.reshape(s, n)
    fb = samples_b.reshape(s, n)
    swapped_a = jnp.where(mask > 0, fb, fa).reshape(samples_a.shape)
    swapped_b = jnp.where(mask > 0, fa, fb).reshape(samples_a.shape)

    def _norm(la):
        if la is None:
            return None
        return la if isinstance(la, tuple) else (la, None)

    log_amp_a, log_amp_b = _norm(log_amp_a), _norm(log_amp_b)
    if log_amp_a is None:
        log_amp_a = _log_amp_of(ansatz, params, samples_a)
    if log_amp_b is None:
        log_amp_b = _log_amp_of(ansatz, params, samples_b)
    la_sw, im_sw = _chunked_apply(
        lambda cfg: _log_amp_of(ansatz, params, cfg),
        jnp.concatenate([swapped_a, swapped_b], axis=0),
        chunk_size,
    )
    # Tr rho_A^2 is real; _ratio_re keeps Re[.] of the product ratio (the
    # imaginary parts of the terms average to zero)
    if im_sw is None:
        im_f = im_s = None
    else:
        im_a = log_amp_a[1] if log_amp_a[1] is not None else 0.0
        im_b = log_amp_b[1] if log_amp_b[1] is not None else 0.0
        im_f, im_s = im_sw[:s] + im_sw[s:], im_a + im_b
    return _ratio_re(
        la_sw[:s] + la_sw[s:], log_amp_a[0] + log_amp_b[0], im_f, im_s
    )


def renyi2_entropy(
    ansatz: Any,
    params: Any,
    samples_a: jax.Array,
    samples_b: jax.Array,
    region,
    log_amp_a=None,
    log_amp_b=None,
    chunk_size: Optional[int] = None,
) -> jax.Array:
    """Second Renyi entanglement entropy ``S_2 = -log Tr rho_A^2`` of the
    subsystem ``region``, via the two-replica swap estimator
    (``renyi2_swap_terms``).  Exact oracle for validation:
    ``ed.exact.renyi2_exact``.  Note the estimator variance grows as
    ``exp(S_2)``; near-maximal entropies need large batches (the MC mean
    can even dip nonpositive, yielding NaN — enlarge the batch)."""
    terms = renyi2_swap_terms(
        ansatz, params, samples_a, samples_b, region,
        log_amp_a=log_amp_a, log_amp_b=log_amp_b, chunk_size=chunk_size,
    )
    return -jnp.log(jnp.mean(terms))


def energy_estimate(
    mean_energy: Sequence[float],
    var_energy: Sequence[float],
    num_samples: int,
    window: int = 100,
) -> Tuple[float, float]:
    """The notebook convention: (mean of trailing window, error bar)."""
    w = min(window, len(mean_energy))
    est = float(np.mean(np.real(np.asarray(mean_energy[-w:]))))
    err = math.sqrt(max(var_energy[-w:]) / (num_samples * w))
    return est, err
