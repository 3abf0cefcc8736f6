"""Exact-diagonalization oracles (test/validation ground truth).

NumPy ports of the tutorial-notebook ED cells — the reference's de-facto
integration test (``/root/reference/Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb``
cell 6 ``ED_1DTFIM``; ``Tutorials/J1J2/Tutorial_1DJ1J2.ipynb`` cell 6
``ED_j1j2``) — built from matrix-element enumeration over the full 2^N basis,
independent of any code under ``rnnwavefunctions`` so they can serve as
an oracle for both the Hamiltonian modules and the trained energies.

Basis convention: state ``s`` in [0, 2^N); bit i of s = spin at site i
(0=down, 1=up), matching the integer sample encoding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _bits(s: int, n: int) -> np.ndarray:
    return (s >> np.arange(n)) & 1


def tfim1d_dense(n: int, bx: float, jz: Optional[np.ndarray] = None) -> np.ndarray:
    """Dense H for the 1D TFIM, OBC:  H = -sum Jz_i z_i z_{i+1} - Bx sum x_i."""
    if jz is None:
        jz = np.ones(n - 1)
    dim = 1 << n
    h = np.zeros((dim, dim))
    for s in range(dim):
        b = _bits(s, n)
        z = 2 * b - 1
        h[s, s] = -np.sum(jz * z[:-1] * z[1:])
        for i in range(n):
            h[s ^ (1 << i), s] += -bx
    return h


def tfim2d_dense(nx: int, ny: int, bx: float, jz: float = 1.0) -> np.ndarray:
    """Dense H for the 2D TFIM on an nx x ny OBC lattice (site index
    ny_major: idx = y*nx + x, matching the snake/2DRNN sample layouts)."""
    n = nx * ny
    dim = 1 << n
    h = np.zeros((dim, dim))
    for s in range(dim):
        b = _bits(s, n).reshape(ny, nx)  # [y, x]
        z = 2 * b - 1
        diag = -jz * (np.sum(z[:, :-1] * z[:, 1:]) + np.sum(z[:-1, :] * z[1:, :]))
        h[s, s] = diag
        for i in range(n):
            h[s ^ (1 << i), s] += -bx
    return h


def j1j2_dense(
    n: int,
    j1: float = 1.0,
    j2: float = 0.0,
    bz: float = 0.0,
    periodic: bool = False,
    marshall_sign: bool = False,
) -> np.ndarray:
    """Dense H for the J1-J2 Heisenberg chain.

    H = sum_i J1 S_i.S_{i+1} + J2 S_i.S_{i+2} + Bz S^z_i with S = sigma/2;
    matrix elements follow ``J1J2MatrixElements``
    (``/root/reference/J1J2/TrainingRNN_J1J2.py:12-93``): diagonal ±J/4 per
    (anti)aligned pair + Bz(sigma-1/2); spin-exchange off-diagonals -J1/2
    (Marshall-rotated) or +J1/2, and +J2/2.  Note the reference *call site*
    swaps the periodic/Marshall flags (``TrainingRNN_J1J2.py:118``; SURVEY.md
    §2.2 quirk 1) — here both are wired correctly.
    """
    dim = 1 << n
    h = np.zeros((dim, dim))
    lim1 = n if periodic else n - 1
    lim2 = n if periodic else n - 2
    for s in range(dim):
        b = _bits(s, n)
        diag = np.sum(bz * (b - 0.5))
        for i in range(lim1):
            j = (i + 1) % n
            diag += 0.25 * j1 if b[i] == b[j] else -0.25 * j1
            if b[i] != b[j]:
                sp = s ^ (1 << i) ^ (1 << j)  # exchange the two spins
                h[sp, s] += (-j1 / 2) if marshall_sign else (+j1 / 2)
        for i in range(lim2):
            j = (i + 2) % n
            if j2 != 0.0:
                diag += 0.25 * j2 if b[i] == b[j] else -0.25 * j2
                if b[i] != b[j]:
                    sp = s ^ (1 << i) ^ (1 << j)
                    h[sp, s] += +j2 / 2
        h[s, s] += diag
    return h


def ground_state_energy(h: np.ndarray) -> float:
    return float(np.linalg.eigvalsh(h)[0])


def ground_state(h: np.ndarray):
    w, v = np.linalg.eigh(h)
    return float(w[0]), v[:, 0]


def renyi2_exact(state_vector: np.ndarray, num_sites: int, region) -> float:
    """Exact second Renyi entanglement entropy ``S_2 = -log Tr rho_A^2`` of
    the pure state over subsystem ``region`` (flat site indices, this
    module's bit-i-is-site-i basis convention — the order
    ``ed.fidelity.amplitude_table`` produces).  Oracle for the swap-trick
    MC estimator ``vmc.observables.renyi2_entropy``."""
    # same region validation as the paired MC estimator (duplicate or
    # out-of-range indices otherwise surface as opaque reshape/transpose
    # errors below)
    from ..vmc.observables import _region_mask

    _region_mask(region, num_sites)
    region = np.asarray(region, np.int64).ravel()
    n = num_sites
    rest = np.array([i for i in range(n) if i not in set(region.tolist())],
                    np.int64)
    vec = np.asarray(state_vector)
    vec = vec / np.linalg.norm(vec)
    # reshape axis k corresponds to site n-1-k (bit i of the basis index is
    # site i, and the first reshape axis is the most significant bit)
    axes = [n - 1 - int(i) for i in region] + [n - 1 - int(i) for i in rest]
    psi = vec.reshape((2,) * n).transpose(axes).reshape(
        1 << region.size, 1 << rest.size
    )
    sv = np.linalg.svd(psi, compute_uv=False)
    p = sv * sv  # Schmidt weights = eigenvalues of rho_A
    return float(-np.log(np.sum(p * p)))
