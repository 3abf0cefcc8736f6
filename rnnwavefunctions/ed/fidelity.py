"""Wavefunction fidelity against dense-ED ground states.

``F = |<psi_theta/||psi_theta||, psi_0>|^2`` over the full 2^N basis — a
small-N validation diagnostic with no reference counterpart: the reference
tutorials compare energies only
(``/root/reference/Tutorials/1DTFIM/Tutorial_1DTFIM.ipynb`` cell 18), but
fidelity also detects sign and phase errors that an energy estimate can
hide inside its variance (a state can sit 1e-4 above E0 in energy while
carrying a wrong phase pattern on low-weight configurations).

Basis convention matches ``ed/exact.py``'s dense builders: configuration
index ``c`` encodes site ``i`` as bit ``i`` (LSB-first), and 2D lattices
use the y-major flat order of ``tfim2d_dense`` (``idx = y*nx + x``),
reshaped here to the MDRNN's ``[x, y]`` grid sample layout.
"""

from __future__ import annotations

import functools

import numpy as np


def basis_configs(n: int, lo: int = 0, hi: int = None) -> np.ndarray:
    """Spin configurations for basis indices ``[lo, hi)`` (default: all
    2^n), row ``c`` holding site ``i`` = bit ``i`` of ``c`` — the exact row
    order of the ``ed/exact.py`` dense builders.  The single definition of
    the basis convention; ``amplitude_table`` chunks through it."""
    idx = np.arange(lo, (1 << n) if hi is None else hi, dtype=np.int64)
    return ((idx[:, None] >> np.arange(n)[None, :]) & 1).astype(np.int32)


def _make_jitted(ansatz):
    import jax

    has_parts = hasattr(ansatz, "log_amp_parts")
    raw = ansatz.log_amp_parts if has_parts else ansatz.log_amp
    return jax.jit(lambda p, b: raw(p, b))


@functools.lru_cache(maxsize=32)
def _jitted_eval(ansatz):
    """One cached jitted log-amplitude evaluator per (hashable, frozen)
    ansatz — repeated ``fidelity`` calls must not re-trace the scan."""
    return _make_jitted(ansatz)


def amplitude_table(ansatz, params, n: int, chunk: int = 2048) -> np.ndarray:
    """The renormalized wavefunction over the full 2^n basis, as a
    complex128 vector in the dense-ED basis order.  Chunked: the full
    (2^N, N) basis table is ~1.6 GB at N=24, but any one chunk is tiny."""
    import jax
    import jax.numpy as jnp

    dim = 1 << n
    is_grid = hasattr(ansatz, "nx")  # grid-encoded 2D ansatz: [x, y] layout

    def _block(lo, hi):
        b = basis_configs(n, lo, hi)
        if is_grid:
            b = b.reshape(-1, ansatz.ny, ansatz.nx).transpose(0, 2, 1)
        return b

    # prefer log_amp_parts: complex ansaetze expose (Re, Im) real pairs as
    # their device-native form
    has_parts = hasattr(ansatz, "log_amp_parts")
    raw = ansatz.log_amp_parts if has_parts else ansatz.log_amp
    rows = min(chunk, dim)
    block_shape = (rows, ansatz.nx, ansatz.ny) if is_grid else (rows, n)
    try:  # host-side table oracles (tests) are not traceable — stay eager;
        # eval_shape probes traceability without evaluating anything
        try:  # unhashable ansatz (e.g. injected custom-cell objects):
            jitted = _jitted_eval(ansatz)  # skip the cross-call cache
        except TypeError:
            jitted = _make_jitted(ansatz)
        jax.eval_shape(jitted, params,
                       jax.ShapeDtypeStruct(block_shape, np.int32))
        eval_chunk = jitted
    except (TypeError, jax.errors.JAXTypeError):
        # only the untraceable-oracle class of failures; a genuine shape or
        # lowering bug in a model's log_amp must surface, not silently
        # degrade to per-chunk eager retracing
        eval_chunk = raw
    parts = []
    for lo in range(0, dim, chunk):
        block = jnp.asarray(_block(lo, min(lo + chunk, dim)))
        if has_parts:
            re, im = eval_chunk(params, block)
            parts.append(np.asarray(re).astype(np.complex128)
                         + 1j * np.asarray(im, np.float64))
        else:
            parts.append(np.asarray(eval_chunk(params, block)))
    log_amp = np.concatenate(parts).astype(np.complex128)

    # subtract the max before exponentiating, then renormalize: fidelity is
    # well-defined for unnormalized amplitude tables too
    log_amp -= log_amp.real.max()
    psi = np.exp(log_amp)
    psi /= np.linalg.norm(psi)
    return psi


def fidelity(ansatz, params, state_vector, chunk: int = 2048) -> float:
    """Overlap-squared of the (explicitly renormalized) ansatz wavefunction
    with ``state_vector`` (a dense-ED eigenvector from
    ``ed.exact.ground_state``, or a two-pass-Lanczos vector from
    ``ed.native.*_ground_state`` which extends the reach to N ~ 24)."""
    v0 = np.asarray(state_vector)
    dim = v0.shape[0]
    n = int(dim).bit_length() - 1
    if (1 << n) != dim:
        raise ValueError(f"state vector length {dim} is not a power of two")
    psi = amplitude_table(ansatz, params, n, chunk)
    return float(np.abs(np.vdot(psi, v0.astype(np.complex128))) ** 2)


def fidelities(ansatz, params, state_vectors, chunk: int = 2048) -> np.ndarray:
    """``fidelity`` against every column of ``state_vectors`` (dim, K) with
    the amplitude table evaluated ONCE — e.g. an energy-projection check
    over a full dense eigenbasis."""
    v = np.asarray(state_vectors)
    dim = v.shape[0]
    n = int(dim).bit_length() - 1
    if (1 << n) != dim:
        raise ValueError(f"state vectors length {dim} is not a power of two")
    psi = amplitude_table(ansatz, params, n, chunk)
    return np.abs(psi.conj() @ v.astype(np.complex128)) ** 2
