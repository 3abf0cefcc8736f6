"""minSR: stochastic reconfiguration (natural-gradient VMC) solved in
sample space.

Beyond-reference feature: the reference trains plain Adam on the REINFORCE
surrogate (``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:113,156``) and has
no second-order method anywhere.  Stochastic reconfiguration preconditions
the energy gradient with the quantum geometric tensor,

    (S + lam*I) dtheta = F,      S_kl = Re<conj(O_k - <O_k>)(O_l - <O_l>)>,
                                 F_k  = 2 Re<conj(O_k - <O_k>)(E_loc - <E>)>,

with O_k = d log psi / d theta_k per sample — the imaginary-time-projection
update that typically reaches a given relative error in 10-50x fewer VMC
steps than Adam on these ansatze.

Formulation (minSR): never materialize the P x P matrix ``S``.
With A = [Re Obar; Im Obar] / sqrt(S_glob) (rows = samples, stacked real and
imaginary parts) and c = [Re eps; Im eps] / sqrt(S_glob), the push-through
identity

    (A^T A + lam I_P)^{-1} A^T c  ==  A^T (A A^T + lam I_{2S})^{-1} c

(exact for any lam > 0) moves the solve into the (2S x 2S) sample space
[Chen & Heyl, arXiv:2302.01941; Rende et al., arXiv:2310.05715].  The
heavy work is then two large matmuls (``A A^T`` and ``A^T x``, both
O(S^2 P) FLOPs batched over the full parameter dimension) plus one tiny
SPD solve — instead of an O(P^3) or iterative param-space solve.  The
Gram/back-contraction precision is configurable (flat
:func:`minsr_direction` keeps ``Precision.HIGHEST``; the production
:func:`minsr_direction_tree` takes ``precision``, and the trainer default
is ``TrainConfig.sr_precision = "high"``), and the solve is either an
exact Cholesky or a fixed number of conjugate-gradient steps
(:func:`cg_solve`, the trainer default — see ``TrainConfig.sr_solver``).

Data parallelism: each device computes its local O rows, the row mean is
``pmean``'d, the centered rows are ``all_gather``'d over the ``dp`` axis
(S x P floats), and every device
performs the identical gather/solve, so the update stays replicated without
a gradient psum.

Per-sample jacobian rows dispatch through ``vmc/jacobian.py``'s
stash-and-contract BPTT sweeps for the built-in families.  Ansatze outside
jacobian.py's coverage (custom cells, other on-site dimensions) fall back
to vmap-of-grad over their jnp scans, which XLA turns into one batched BPTT
with per-sample outputs.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def _flatten_rows(tree: Any, lead: int) -> jax.Array:
    """Flatten a pytree of (lead-dims, *param-shape) leaves to a
    (lead-dims, P) matrix in ``ravel_pytree`` leaf/ravel order, so
    ``unravel`` from the params pytree inverts the row layout."""
    leaves = jax.tree.leaves(tree)
    return jnp.concatenate(
        [l.reshape(l.shape[:lead] + (-1,)) for l in leaves], axis=-1
    )


def per_sample_log_amp_grads(
    ansatz: Any, params: Any, samples: jax.Array
) -> Tuple[jax.Array, Optional[jax.Array], Any]:
    """The log-derivative matrix O: one row per sample, one column per
    (flattened) parameter.

    Returns ``(o_re, o_im, unravel)`` with ``o_re/o_im`` of shape (S, P)
    (``o_im`` None for real-valued log psi) and ``unravel`` mapping a flat
    (P,) vector back to the params pytree.

    A thin flattening wrapper over :func:`per_sample_log_amp_grad_trees` —
    ONE dispatch for both forms, so the flat oracle the tests compare
    against (tests/test_minsr.py) always exercises the same row source as
    the production tree path.
    """
    _, unravel = ravel_pytree(params)
    rows_re, rows_im = per_sample_log_amp_grad_trees(ansatz, params, samples)
    o_im = None if rows_im is None else _flatten_rows(rows_im, 1)
    return _flatten_rows(rows_re, 1), o_im, unravel


def per_sample_log_amp_grad_trees(
    ansatz: Any, params: Any, samples: jax.Array
) -> Tuple[Any, Optional[Any]]:
    """Per-sample log-derivative rows as params-shaped pytrees: each leaf is
    (S, *param-shape).  This is the production form — the flattened (S, P)
    matrix of :func:`per_sample_log_amp_grads` costs an extra full-matrix
    copy (measured 0.43 ms at the flagship shape) that the per-leaf solve
    (:func:`minsr_direction_tree`) never needs."""
    a = ansatz

    from . import jacobian

    if jacobian.supports(a):
        # stash-and-contract BPTT rows (vmc/jacobian.py): same values,
        # ~N-fold less memory traffic than the vmap-of-grad scans below
        # (whose backward carries the (S, P) accumulator through every
        # step).
        if getattr(a, "is_complex", False):
            rows_re, rows_im = jacobian.crnn_log_amp_rows(
                ansatz, params, samples
            )
            return rows_re, rows_im
        return jacobian.log_amp_rows(ansatz, params, samples), None

    if getattr(a, "is_complex", False):

        def f2(p, s):
            re, im = a.log_amp_parts(p, s[None])
            return jnp.stack([re[0], im[0]])

        jac = jax.vmap(jax.jacrev(f2), in_axes=(None, 0))(params, samples)
        return (
            jax.tree.map(lambda l: l[:, 0], jac),
            jax.tree.map(lambda l: l[:, 1], jac),
        )

    def f(p, s):
        return a.log_amp(p, s[None])[0]

    return jax.vmap(jax.grad(f), in_axes=(None, 0))(params, samples), None


def _cg_step(t, x, r, p, rs, precision):
    """One CG iteration on (1, S) row vectors; ``t`` symmetric."""
    tp = jax.lax.dot_general(
        p, t, (((1,), (0,)), ((), ())),
        preferred_element_type=t.dtype, precision=precision,
    )
    ptp = jnp.sum(p * tp)
    # floors: at exact convergence r = p = 0 and both quotients are 0/0;
    # the floors turn them into 0/tiny = 0, freezing the iterate
    tiny = jnp.asarray(1e-30, t.dtype)
    alpha = rs / jnp.maximum(ptp, tiny)
    x = x + alpha * p
    r = r - alpha * tp
    rs_new = jnp.sum(r * r)
    p = r + (rs_new / jnp.maximum(rs, tiny)) * p
    return x, r, p, rs_new


def cg_solve(t: jax.Array, c: jax.Array, iters: int,
             precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """``iters`` conjugate-gradient steps on the SPD system ``t @ x = c``
    (the damped SR Gram).  The count is static — no data-dependent early
    exit, so the program shape is fixed."""
    c_row = c[None, :]
    carry = (jnp.zeros_like(c_row), c_row, c_row, jnp.sum(c_row * c_row))
    x, _, _, _ = jax.lax.fori_loop(
        0, iters, lambda _, cr: _cg_step(t, *cr, precision=precision), carry
    )
    return x[0]


def minsr_direction_tree(
    rows_re: Any,
    rows_im: Optional[Any],
    e_re: jax.Array,
    e_im: Optional[jax.Array],
    e_mean_re: jax.Array,
    e_mean_im: Optional[jax.Array],
    damping: float,
    axis_name: Optional[str] = None,
    precision=jax.lax.Precision.HIGHEST,
    solver: str = "chol",
    cg_iters: int = 64,
) -> Any:
    """The SR direction of :func:`minsr_direction`, computed leaf-by-leaf on
    the params-shaped row trees of :func:`per_sample_log_amp_grad_trees` and
    returned as a params pytree (same values — pinned by
    tests/test_minsr.py::test_tree_direction_matches_flat).

    ``solver``: "chol" (exact Cholesky) or "cg" (``cg_iters``
    conjugate-gradient steps, :func:`cg_solve`).

    Restructure of the flat form: the Gram ``T = A A^T`` is a sum
    of per-leaf blocks ``T = sum_l A_l A_l^T`` and the back-contraction
    ``A^T x`` splits per leaf, so the (S, P) flatten/concat copies (a pure
    memory round trip over the full jacobian, ~92 MB at the flagship shape
    for the complex stack) disappear entirely; the centering subtraction
    fuses into each leaf's matmul operand read (XLA operand fusion), where
    an exact rank-1 Gram-space centering correction would re-read the full
    jacobian.  The
    complex [Re; Im] row stacking is likewise never materialized — the
    (2S, 2S) Gram is assembled from its three (S, S) blocks.
    """
    n_dev = 1 if axis_name is None else jax.lax.psum(1, axis_name)
    s_loc = jax.tree.leaves(rows_re)[0].shape[0]
    dtype = jax.tree.leaves(rows_re)[0].dtype
    s_glob = s_loc * n_dev
    inv_sqrt = 1.0 / jnp.sqrt(jnp.asarray(s_glob, dtype))

    def prep(tree):
        mats = []
        for leaf in jax.tree.leaves(tree):
            mat = leaf.reshape(s_loc, -1)
            mean = jnp.mean(mat, axis=0)
            if axis_name is not None:
                mean = jax.lax.pmean(mean, axis_name)
            mat = (mat - mean) * inv_sqrt
            if axis_name is not None:
                mat = jax.lax.all_gather(mat, axis_name, axis=0, tiled=True)
            mats.append(mat)
        return mats

    def gram(x, y):
        return jax.lax.dot_general(
            x, y, (((1,), (1,)), ((), ())), precision=precision
        )

    def c_of(e, e_mean):
        c = (e - e_mean) * inv_sqrt
        if axis_name is not None:
            c = jax.lax.all_gather(c, axis_name, axis=0, tiled=True)
        return c

    def solve(t, c):
        if solver == "cg":
            return cg_solve(t, c, iters=cg_iters)
        return jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(t, lower=True), c
        )

    a_re = prep(rows_re)
    t_rr = sum(gram(m, m) for m in a_re)

    if rows_im is None:
        t = t_rr + damping * jnp.eye(t_rr.shape[0], dtype=dtype)
        x = solve(t, c_of(e_re, e_mean_re))
        x_parts = [x]
        a_parts = [a_re]
    else:
        a_im = prep(rows_im)
        t_ri = sum(gram(mr, mi) for mr, mi in zip(a_re, a_im))
        t_ii = sum(gram(m, m) for m in a_im)
        t = jnp.block([[t_rr, t_ri], [t_ri.T, t_ii]])
        t = t + damping * jnp.eye(t.shape[0], dtype=dtype)
        x = solve(
            t,
            jnp.concatenate(
                [c_of(e_re, e_mean_re), c_of(e_im, e_mean_im)], axis=0
            ),
        )
        s_tot = t_rr.shape[0]
        x_parts = [x[:s_tot], x[s_tot:]]
        a_parts = [a_re, a_im]

    def back(i):
        out = jax.lax.dot_general(
            a_parts[0][i], x_parts[0], (((0,), (0,)), ((), ())),
            precision=precision,
        )
        if len(a_parts) > 1:
            out = out + jax.lax.dot_general(
                a_parts[1][i], x_parts[1], (((0,), (0,)), ((), ())),
                precision=precision,
            )
        return 2.0 * out

    leaves_re, treedef = jax.tree.flatten(rows_re)
    flat = [
        back(i).reshape(l.shape[1:]) for i, l in enumerate(leaves_re)
    ]
    return jax.tree.unflatten(treedef, flat)


def minsr_direction(
    o_re: jax.Array,
    o_im: Optional[jax.Array],
    e_re: jax.Array,
    e_im: Optional[jax.Array],
    e_mean_re: jax.Array,
    e_mean_im: Optional[jax.Array],
    damping: float,
    axis_name: Optional[str] = None,
) -> jax.Array:
    """The SR/natural-gradient direction ``(S + damping*I)^{-1} F`` as a flat
    (P,) vector, computed in sample space (module docstring).  Feed it to a
    descent-direction optimizer (the trainer uses ``optax.sgd`` so the LR
    schedules apply unchanged); the large-damping limit recovers ``F/damping``
    — the plain surrogate gradient, scaled.

    ``e_mean_re/_im`` must be the GLOBAL means (the caller pmean's them);
    ``axis_name`` names the data-parallel mesh axis when the (S, P) blocks
    are row-sharded across devices.
    """
    n_dev = 1 if axis_name is None else jax.lax.psum(1, axis_name)
    s_glob = o_re.shape[0] * n_dev
    inv_sqrt = 1.0 / jnp.sqrt(jnp.asarray(s_glob, o_re.dtype))

    def center_rows(o):
        mean = jnp.mean(o, axis=0)
        if axis_name is not None:
            mean = jax.lax.pmean(mean, axis_name)
        return (o - mean) * inv_sqrt

    def gather(x):
        if axis_name is None:
            return x
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    a_blocks = [gather(center_rows(o_re))]
    c_blocks = [gather((e_re - e_mean_re) * inv_sqrt)]
    if o_im is not None:
        a_blocks.append(gather(center_rows(o_im)))
        c_blocks.append(gather((e_im - e_mean_im) * inv_sqrt))
    a = jnp.concatenate(a_blocks, axis=0)  # (2S or S, P), replicated
    c = jnp.concatenate(c_blocks, axis=0)

    t = jax.lax.dot_general(
        a, a, (((1,), (1,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    )
    t = t + damping * jnp.eye(t.shape[0], dtype=t.dtype)
    x = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(t, lower=True), c
    )
    return 2.0 * jax.lax.dot_general(
        a, x, (((0,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    )
