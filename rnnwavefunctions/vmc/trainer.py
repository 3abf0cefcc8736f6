"""The VMC trainer: sampling, local energies, gradient, and Adam update as a
single jitted, mesh-sharded program.

Reference call stack being replaced (SURVEY.md §3.1): per step the TF1 code
does ``sess.run(samples)`` -> host NumPy local energies (with chunked
``sess.run`` amplitude evaluations) -> ``sess.run(optstep, feed_dict=...)``,
i.e. 3 + ceil((N+1)S/25000) host<->device transitions
(``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:199-227``).  Here one
``jit(shard_map(...))`` program does sample -> E_loc -> grad -> psum -> Adam
with zero host round-trips; Monte-Carlo chains are sharded over the ``dp``
mesh axis and statistics/gradients reduced across devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..parallel import mesh as mesh_lib
from . import observables as observables_mod
from .local_energy import make_local_energy_fn
from .loss import surrogate_loss


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters; defaults mirror the reference trainer signature
    (``TrainingRNN_1DTFIM.py:79``: 500 samples, lr 5e-3, Adam)."""

    num_samples: int = 500
    learning_rate: float = 5e-3
    # "constant"    (1DTFIM/J1J2, TrainingRNN_1DTFIM.py:221);
    # "inverse"     lr/(1+step/decay_scale) (2DRNN trainer,
    #               Training2DRNN_2DTFIM.py:228 with scale 5000);
    # "harmonic"    1/((1/lr)+(step/decay_scale)) = lr/(1+lr*step/scale)
    #               (snake-2D trainer, Training1DRNN_2DTFIM.py:229 with
    #               scale 10; J1J2's commented variant,
    #               TrainingRNN_J1J2.py:302);
    # "exponential" lr * decay_rate^(step/decay_steps)
    #               (tf.train.exponential_decay wrapper the reference builds
    #               with decay_rate=1.0, TrainingRNN_1DTFIM.py:111);
    # "staged"      piecewise-constant: lr multiplied by
    #               lr_stage_scales[i] once step >= lr_stage_bounds[i]
    #               (cumulative).  No reference analog; this is the
    #               schedule that takes the J1-J2 deep-accuracy record
    #               with minSR (constant phases converge where both
    #               smooth-decay and single-constant forms fail), in
    #               ONE compiled program instead of per-phase trainer
    #               rebuilds.
    schedule: str = "constant"
    decay_scale: float = 10.0
    decay_rate: float = 1.0
    decay_steps: int = 100
    staircase: bool = True
    # "staged" knobs: after lr_stage_bounds[i] steps, multiply the lr by
    # lr_stage_scales[i] (scales compound).  The record recipe:
    # lr=5e-2, bounds=(10000, 13000), scales=(0.1, 0.2) -> 5e-2/5e-3/1e-3.
    lr_stage_bounds: tuple = ()
    lr_stage_scales: tuple = ()
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8  # TrainingRNN_J1J2.py:164
    # cap on rows per log-amplitude evaluation batch; the in-graph analogue of
    # the reference's 25k/30k host-side chunking (TrainingRNN_1DTFIM.py:57).
    chunk_size: Optional[int] = None
    # tensor-parallel width: >1 shards the GRU hidden dimension over a
    # second mesh axis "tp" (Megatron-style column sharding,
    # parallel/tensor.py) orthogonal to the Monte-Carlo "dp" axis.  No
    # reference analog (single GPU); this is the rebuild's very-large-units
    # scaling path.  Covers the 1D families — the plain positive PRNN1D
    # (GRU or LSTM trunk; incl. snake-2D flat and multi-layer stacks) and
    # the GRU-trunk complex U(1) CRNNU1 (both heads row-sharded, per-sample
    # mask tp-replicated) on flat Hamiltonians — and the 2D MDRNN2D (all four
    # cell matrices column-sharded, both neighbour hiddens gathered) on
    # grid TFIM2D.  Hidden widths must be tp-divisible; composes with
    # optimizer="minsr".
    tp: int = 1
    # parameter update rule: "adam" (the reference optimizer,
    # TrainingRNN_1DTFIM.py:113) or "minsr" — stochastic reconfiguration /
    # natural gradient solved in sample space (vmc/minsr.py; beyond the
    # reference, which has no second-order method).  minSR preconditions
    # with the quantum geometric tensor and typically needs far fewer VMC
    # steps per relative-error decade at a higher per-step cost.  Applied
    # through optax.sgd, so the LR schedules above work unchanged.
    optimizer: str = "adam"
    # SR diagonal shift lam in (S + lam I)^{-1} F (absolute, the NetKet
    # convention); larger = closer to the plain gradient, smaller = closer
    # to pure imaginary-time projection but noisier solves.
    sr_damping: float = 1e-2
    # matmul precision of the SR sample-space Gram + back-contraction
    # (minsr.minsr_direction_tree); a lax.Precision name.  The Gram's
    # rounding error at "high" sits far below the lam >= 1e-3 diagonal
    # shift; "highest" is one flag away for conditioning-critical studies.
    sr_precision: str = "high"
    # SR sample-space solver: "chol" (exact Cholesky) or "cg" (sr_cg_iters
    # conjugate-gradient steps, minsr.cg_solve).  CG at 64 iterations sits
    # ~1e-4 relative off the exact solve on the hardest published
    # conditioning — far below the O(1/sqrt(S)) stochastic noise in the SR
    # right-hand side.
    sr_solver: str = "cg"
    sr_cg_iters: int = 64
    # matmul precision for the whole jitted step, kernels included (the
    # jax.default_matmul_precision context is read at trace time).  On a
    # GPU "default" lets float32 products run in TF32 (about three decimal
    # digits per product); "highest" keeps them in full float32.
    matmul_precision: str = "default"
    seed: int = 111


def make_schedule(config: TrainConfig) -> Callable[[jax.Array], jax.Array]:
    if config.schedule == "constant":
        return lambda step: jnp.asarray(config.learning_rate, jnp.float32)
    if config.schedule == "inverse":
        return lambda step: config.learning_rate / (
            1.0 + step.astype(jnp.float32) / config.decay_scale
        )
    if config.schedule == "harmonic":
        return lambda step: 1.0 / (
            1.0 / config.learning_rate
            + step.astype(jnp.float32) / config.decay_scale
        )
    if config.schedule == "exponential":

        def exp_schedule(step):
            p = step.astype(jnp.float32) / config.decay_steps
            if config.staircase:
                p = jnp.floor(p)
            return config.learning_rate * config.decay_rate**p

        return exp_schedule
    if config.schedule == "staged":
        bounds = tuple(config.lr_stage_bounds)
        scales = tuple(config.lr_stage_scales)
        if len(bounds) != len(scales):
            raise ValueError(
                f"staged schedule needs matching lr_stage_bounds/"
                f"lr_stage_scales; got {len(bounds)} vs {len(scales)}"
            )
        if list(bounds) != sorted(bounds):
            raise ValueError(f"lr_stage_bounds must ascend; got {bounds}")

        def staged_schedule(step):
            f = jnp.asarray(config.learning_rate, jnp.float32)
            for b, s in zip(bounds, scales):
                f = f * jnp.where(step >= b, jnp.float32(s), 1.0)
            return f

        return staged_schedule
    raise ValueError(f"unknown schedule {config.schedule!r}")


class VMCTrainer:
    """Builds and drives the jitted VMC step for (ansatz, hamiltonian)."""

    def __init__(
        self,
        ansatz: Any,
        hamiltonian: Any,
        config: TrainConfig = TrainConfig(),
        mesh=None,
    ):
        self.ansatz = ansatz
        self.hamiltonian = hamiltonian
        self.config = config
        self.tp = config.tp
        if mesh is not None:
            self.mesh = mesh
        elif self.tp > 1:
            from ..parallel import tensor as tensor_lib

            self.mesh = tensor_lib.make_tp_mesh_over(None, self.tp)
        else:
            self.mesh = mesh_lib.make_mesh(1)
        if self.tp > 1:
            self._validate_tp()
        self.local_samples = mesh_lib.local_batch(config.num_samples, self.mesh)
        if config.optimizer == "adam":
            self.optimizer = optax.adam(
                learning_rate=make_schedule(config),
                b1=config.b1,
                b2=config.b2,
                eps=config.eps,
            )
        elif config.optimizer == "minsr":
            if not config.sr_damping > 0.0:
                raise ValueError(
                    "sr_damping must be > 0 (the push-through identity "
                    f"needs a positive diagonal shift); got {config.sr_damping}"
                )
            if config.sr_solver not in ("chol", "cg"):
                raise ValueError(
                    f"unknown sr_solver {config.sr_solver!r} "
                    "(expected 'chol' or 'cg')"
                )
            if config.sr_solver == "cg" and config.sr_cg_iters < 1:
                raise ValueError(
                    f"sr_cg_iters must be >= 1; got {config.sr_cg_iters}"
                )
            # the SR solve produces a descent direction; sgd applies it so
            # every LR schedule works unchanged
            self.optimizer = optax.sgd(learning_rate=make_schedule(config))
        else:
            raise ValueError(
                f"unknown optimizer {config.optimizer!r} "
                "(expected 'adam' or 'minsr')"
            )
        self.local_energy = make_local_energy_fn(
            ansatz, hamiltonian, config.chunk_size
        )
        self._device_step_impl = self._with_matmul_precision(
            self._device_step_tp if self.tp > 1 else self._device_step
        )
        self._step_fn = self._build_step()
        self._multi_step_cache = {}
        self._eval_fns = {}

    def _with_matmul_precision(self, fn):
        """Pin the ambient matmul precision while the step traces — every
        dot in the program (jnp paths and kernel bodies alike)
        resolves its default precision against this context at trace
        time."""
        prec = self.config.matmul_precision
        if prec == "default":
            return fn

        def wrapped(*args, **kwargs):
            with jax.default_matmul_precision(prec):
                return fn(*args, **kwargs)

        return wrapped

    def _validate_tp(self):
        """The tensor-parallel trunk (parallel/tensor.py) covers the
        GRU-trunk 1D families — the plain positive PRNN1D on flat real
        Hamiltonians and the complex U(1) CRNNU1 on the J1-J2 chain."""
        from ..parallel.tensor import TP_AXIS

        if (
            TP_AXIS not in self.mesh.shape
            or self.mesh.shape[TP_AXIS] != self.tp
        ):
            raise ValueError(
                f"config.tp={self.tp} needs a mesh with a '{TP_AXIS}' axis "
                f"of that size; got {dict(self.mesh.shape)}"
            )
        a = self.ansatz
        plain_prnn = (
            getattr(a, "plain_positive", False)
            # the snake-2D factory returns a PRNN1D instance, so this one
            # name covers both families
            and type(a).__name__ == "PRNN1D"
        )
        crnn = type(a).__name__ == "CRNNU1"
        mdrnn = type(a).__name__ == "MDRNN2D"
        # one resolution, consumed by the tp step/eval paths
        self._tp_family = "mdrnn" if mdrnn else ("crnn" if crnn else "prnn")
        if not (
            mdrnn
            or (plain_prnn and getattr(a, "cell", "gru") in ("gru", "lstm"))
            or (crnn and getattr(a, "cell", "gru") == "gru")
        ):
            raise ValueError(
                "tensor parallelism supports the 1D families — the plain "
                "positive PRNN1D (GRU or LSTM trunk) and the GRU-trunk "
                "complex U(1) CRNNU1 — and the 2D MDRNN2D; got "
                f"{type(a).__name__} with cell="
                f"{getattr(a, 'cell', 'gru')!r}"
            )
        if getattr(a, "local_dim", 2) != 2:
            raise ValueError(
                "tensor parallelism assumes on-site dimension 2 "
                f"(parallel/tensor.py hardcodes the one-hot width); got "
                f"local_dim={a.local_dim}"
            )
        units = (a.units,) if mdrnn else tuple(a.units)
        if any(u % self.tp for u in units):
            raise ValueError(
                f"hidden widths {units} must be divisible by tp={self.tp}"
            )
        if mdrnn:
            # the 2D family consumes (S, Nx, Ny) grids; the generic
            # ham.connected estimator is shape-agnostic, so grid encoding
            # is the natural pairing
            if getattr(self.hamiltonian, "encoding", "grid") != "grid":
                raise ValueError(
                    "tensor-parallel MDRNN2D needs a grid-encoded "
                    "Hamiltonian (TFIM2D(encoding='grid'))"
                )
        elif getattr(self.hamiltonian, "encoding", "flat") != "flat":
            raise ValueError(
                "tensor parallelism needs a flat-encoded Hamiltonian"
            )

    # -- state --------------------------------------------------------------

    def init(self, key: Optional[jax.Array] = None) -> TrainState:
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        params = self.ansatz.init(key)
        state = TrainState(
            params=params,
            opt_state=self.optimizer.init(params),
            step=jnp.zeros((), jnp.int32),
        )
        # Pin the replicated NamedSharding the jitted step emits.  Freshly
        # created arrays carry SingleDeviceSharding; feeding them to the
        # step compiles one program, and feeding the step's OWN output back
        # (run_steps loops, fit) would compile a SECOND under the
        # mesh sharding — measured 22 s of duplicate compile on the minSR
        # flagship program.  One device_put here means one compile ever.
        return jax.device_put(state, NamedSharding(self.mesh, P()))

    # -- the tensor-parallel step --------------------------------------------

    def _tp_sample_and_energy(self, params, key):
        """Sample + local energies through the tp-sharded trunk (runs inside
        shard_map on the (dp, tp) mesh; ``params`` replicated).  Returns
        (samples, la_s, e_re, e_im) — all tp-replicated.  ``la_s`` is the
        base log psi: 0.5*logp for the positive family, the (Re, Im) pair
        for the complex one; ``e_im`` is None when real."""
        from ..parallel import tensor as tp_lib
        from .local_energy import _chunked_apply

        ansatz, ham = self.ansatz, self.hamiltonian
        k = self.tp
        idx = jax.lax.axis_index(tp_lib.TP_AXIS)

        def positive_energy(la_fn, samples, logp):
            """Generic positive-family local energies from a tp la
            callable (shared by the PRNN and MDRNN branches)."""
            with jax.named_scope("vmc_local_energy"):
                diag, flips, elements, mask = jax.vmap(ham.connected)(samples)
                s, kk = flips.shape[0], flips.shape[1]
                flat = flips.reshape((s * kk,) + flips.shape[2:])
                la = _chunked_apply(
                    la_fn, flat, self.config.chunk_size
                ).reshape(s, kk)
                ratios = jnp.exp(la - 0.5 * logp[:, None])
                contrib = elements.astype(ratios.dtype) * ratios
                e_re = diag.astype(ratios.dtype) + jnp.sum(
                    jnp.where(mask, contrib, 0.0), axis=1
                )
            return jax.lax.stop_gradient(e_re)

        if self._tp_family == "mdrnn":
            shard = tp_lib.shard_params_mdrnn(params, k, idx)
            nx, ny, u = ansatz.nx, ansatz.ny, ansatz.units
            with jax.named_scope("vmc_sample"):
                samples, logp = tp_lib.tp_mdrnn_sample_with_log_prob(
                    shard, key, self.local_samples, nx, ny, u, k,
                    dtype=ansatz.dtype,
                )
            samples = jax.lax.stop_gradient(samples)
            e_re = positive_energy(
                lambda c: 0.5 * tp_lib.tp_mdrnn_log_prob(
                    shard, c, nx, ny, u, k, dtype=ansatz.dtype
                ),
                samples, logp,
            )
            return samples, 0.5 * logp, e_re, None

        units = tuple(ansatz.units)

        if self._tp_family == "crnn":
            shard = tp_lib.shard_params_crnn(params, k, idx)
            with jax.named_scope("vmc_sample"):
                samples, _ = tp_lib.tp_crnn_sample_with_log_prob(
                    ansatz, shard, key, self.local_samples, k
                )
            samples = jax.lax.stop_gradient(samples)
            with jax.named_scope("vmc_local_energy"):
                s_re, s_im = tp_lib.tp_crnn_log_amp_parts(
                    ansatz, shard, samples, k
                )
                diag, flips, elements, mask = jax.vmap(ham.connected)(samples)
                s, kk = flips.shape[0], flips.shape[1]
                flat = flips.reshape((s * kk,) + flips.shape[2:])
                la_re, la_im = _chunked_apply(
                    lambda c: tp_lib.tp_crnn_log_amp_parts(
                        ansatz, shard, c, k
                    ),
                    flat,
                    self.config.chunk_size,
                )
                d_re = la_re.reshape(s, kk) - s_re[:, None]
                d_im = la_im.reshape(s, kk) - s_im[:, None]
                mag = jnp.exp(d_re)
                w = jnp.where(mask, elements.astype(mag.dtype) * mag, 0.0)
                e_re = diag.astype(w.dtype) + jnp.sum(
                    w * jnp.cos(d_im), axis=1
                )
                e_im = jnp.sum(w * jnp.sin(d_im), axis=1)
            return (
                samples, (s_re, s_im),
                jax.lax.stop_gradient(e_re), jax.lax.stop_gradient(e_im),
            )

        kind = getattr(ansatz, "cell", "gru")
        shard = tp_lib.shard_params(params, k, idx, kind)
        with jax.named_scope("vmc_sample"):
            samples, logp = tp_lib.tp_sample_with_log_prob(
                shard, key, self.local_samples, ansatz.num_sites, units, k,
                kind=kind,
            )
        samples = jax.lax.stop_gradient(samples)
        e_re = positive_energy(
            lambda c: 0.5 * tp_lib.tp_log_prob(shard, c, units, k, kind=kind),
            samples, logp,
        )
        return samples, 0.5 * logp, e_re, None

    def _device_step_tp(self, params, opt_state, step, key):
        """Tensor-parallel device step: the GRU hidden dimension is sharded
        over the mesh's "tp" axis (parallel/tensor.py); params and optimizer
        state stay replicated (each member slices its shard in-graph, so the
        dynamic_slice transpose scatters shard gradients back into
        full-shaped cotangents).  pmean over tp assembles the disjoint slice
        gradients at 1x (the in-trunk head psum transposes to a psum — see
        tests/test_tensor_parallel.py::test_tp_inner_grad_pmean_matches_
        unsharded), so the Adam update is identical on every device."""
        from ..parallel import tensor as tp_lib

        key = mesh_lib.device_key(jax.random.fold_in(key, step))
        samples, _, e_re, e_im = self._tp_sample_and_energy(params, key)
        e_mean = mesh_lib.pmean(jnp.mean(e_re))
        var_e = mesh_lib.pmean(jnp.mean((e_re - e_mean) ** 2))
        e_im_mean = (
            None if e_im is None else mesh_lib.pmean(jnp.mean(e_im))
        )
        is_mdrnn = self._tp_family == "mdrnn"
        units = None if is_mdrnn else tuple(self.ansatz.units)
        is_complex = getattr(self.ansatz, "is_complex", False)

        def tp_log_amp(p, batch):
            """Base log psi of ``batch`` through the tp-sharded forward;
            (B,) for positive families, an (re, im) pair for the complex
            one.  Shared by the loss and the per-sample minSR rows."""
            idx = jax.lax.axis_index(tp_lib.TP_AXIS)
            if is_mdrnn:
                sh = tp_lib.shard_params_mdrnn(p, self.tp, idx)
                a = self.ansatz
                return 0.5 * tp_lib.tp_mdrnn_log_prob(
                    sh, batch, a.nx, a.ny, a.units, self.tp, dtype=a.dtype
                )
            if is_complex:
                sh = tp_lib.shard_params_crnn(p, self.tp, idx)
                return tp_lib.tp_crnn_log_amp_parts(
                    self.ansatz, sh, batch, self.tp
                )
            kind = getattr(self.ansatz, "cell", "gru")
            sh = tp_lib.shard_params(p, self.tp, idx, kind)
            return 0.5 * tp_lib.tp_log_prob(
                sh, batch, units, self.tp, kind=kind
            )

        def loss_fn(p):
            if is_complex:
                la_re, la_im = tp_log_amp(p, samples)
                return surrogate_loss(
                    la_re, la_im, e_re, e_im, e_mean, e_im_mean
                )
            return surrogate_loss(
                tp_log_amp(p, samples), None, e_re, None, e_mean, None
            )

        if self.config.optimizer == "minsr":
            # minSR under tensor parallelism: the tp gradient contract —
            # pmean over tp of the through-the-shard cotangents equals the
            # unsharded gradient (test_tp_inner_grad_pmean_matches_unsharded)
            # — holds PER SAMPLE by linearity, so the per-sample
            # log-derivative rows assemble the same way.  The rows are then
            # tp-replicated full-parameter trees and the sample-space solve
            # proceeds exactly as on the dp mesh (one S x P pmean across
            # devices per step; the solve itself is replicated).  Rows ride the
            # generic vmap-of-grad through the sharded forward — the fast
            # stash-and-contract sweeps assume the unsharded layout.
            from . import minsr

            def one_log_amp(p, s):
                if is_complex:
                    re, im = tp_log_amp(p, s[None])
                    return jnp.stack([re[0], im[0]])
                return tp_log_amp(p, s[None])[0]

            with jax.named_scope("vmc_minsr_tp"):
                if is_complex:
                    jac = jax.vmap(
                        jax.jacrev(one_log_amp), in_axes=(None, 0)
                    )(params, samples)
                    jac = jax.tree.map(
                        lambda g: jax.lax.pmean(g, tp_lib.TP_AXIS), jac
                    )
                    rows_re = jax.tree.map(lambda l: l[:, 0], jac)
                    rows_im = jax.tree.map(lambda l: l[:, 1], jac)
                else:
                    rows_re = jax.vmap(
                        jax.grad(one_log_amp), in_axes=(None, 0)
                    )(params, samples)
                    rows_re = jax.tree.map(
                        lambda g: jax.lax.pmean(g, tp_lib.TP_AXIS), rows_re
                    )
                    rows_im = None
                grads = minsr.minsr_direction_tree(
                    rows_re, rows_im, e_re, e_im, e_mean, e_im_mean,
                    self.config.sr_damping, axis_name=mesh_lib.DP_AXIS,
                    precision=self.config.sr_precision,
                    solver=self.config.sr_solver,
                    cg_iters=self.config.sr_cg_iters,
                )
        else:
            with jax.named_scope("vmc_grad"):
                grads = jax.grad(loss_fn)(params)
            grads = jax.tree.map(
                lambda g: mesh_lib.pmean(jax.lax.pmean(g, tp_lib.TP_AXIS)),
                grads,
            )
        with jax.named_scope("vmc_update"):
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        metrics = {"mean_energy": e_mean, "var_energy": var_e}
        if e_im_mean is not None:
            metrics["mean_energy_im"] = e_im_mean
        return params, opt_state, step + 1, metrics

    # -- the data-parallel step ---------------------------------------------

    def _log_amp_of_batch(self, params, samples, logp_sampling):
        """log psi of a drawn batch.  For a plain positive ansatz the
        sampling density *is* the wavefunction density, so 0.5*logp is
        free; parity (plain-direction sampler) and complex ansatze pay the
        full teacher-forced pass."""
        ansatz = self.ansatz
        if getattr(ansatz, "plain_positive", False):
            return 0.5 * logp_sampling
        if getattr(ansatz, "is_complex", False):
            return ansatz.log_amp_parts(params, samples)
        return ansatz.log_amp(params, samples)

    def _device_step(self, params, opt_state, step, key):
        """Runs per-device inside shard_map; params/opt_state replicated."""
        ansatz = self.ansatz
        key = mesh_lib.device_key(jax.random.fold_in(key, step))

        is_complex = getattr(ansatz, "is_complex", False)
        with jax.named_scope("vmc_sample"):
            samples, logp_sampling = ansatz.sample_with_log_prob(
                params, key, self.local_samples
            )
        samples = jax.lax.stop_gradient(samples)
        log_amp_s = self._log_amp_of_batch(params, samples, logp_sampling)
        with jax.named_scope("vmc_local_energy"):
            e_re, e_im, _ = self.local_energy(params, samples, log_amp_s)
        e_re = jax.lax.stop_gradient(e_re)
        e_im = jax.lax.stop_gradient(e_im) if e_im is not None else None

        # Global (mesh-wide) statistics.
        e_mean_re = mesh_lib.pmean(jnp.mean(e_re))
        e_mean_im = mesh_lib.pmean(jnp.mean(e_im)) if e_im is not None else None
        # Reference records np.var of (the real part of) the local energies
        # (TrainingRNN_1DTFIM.py:207, TrainingRNN_J1J2.py:282).
        var_e = mesh_lib.pmean(jnp.mean((e_re - e_mean_re) ** 2))

        if self.config.optimizer == "minsr":
            # natural-gradient direction (vmc/minsr.py): per-sample
            # log-derivatives, sample-space SR solve on the all-gathered
            # rows — replicated across dp by construction, so no grad psum
            from . import minsr

            with jax.named_scope("vmc_minsr"):
                rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(
                    ansatz, params, samples
                )
                grads = minsr.minsr_direction_tree(
                    rows_re, rows_im, e_re, e_im, e_mean_re, e_mean_im,
                    self.config.sr_damping, axis_name=mesh_lib.DP_AXIS,
                    precision=self.config.sr_precision,
                    solver=self.config.sr_solver,
                    cg_iters=self.config.sr_cg_iters,
                )
        else:
            # The differentiable log-amp pass routes through the ansatz's
            # custom_vjp where its rollout kernel applies (kernel forward,
            # jnp scan backward).
            def loss_fn(p):
                if is_complex:
                    la_re, la_im = ansatz.log_amp_parts(p, samples)
                else:
                    la_re, la_im = ansatz.log_amp(p, samples), None
                return surrogate_loss(
                    la_re, la_im, e_re, e_im, e_mean_re, e_mean_im
                )

            with jax.named_scope("vmc_grad"):
                grads = jax.grad(loss_fn)(params)
            grads = jax.tree.map(mesh_lib.pmean, grads)

        with jax.named_scope("vmc_update"):
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)

        metrics = {
            "mean_energy": e_mean_re,
            "var_energy": var_e,
        }
        if e_mean_im is not None:
            metrics["mean_energy_im"] = e_mean_im
        return params, opt_state, step + 1, metrics

    def _build_step(self):
        sharded = jax.shard_map(
            self._device_step_impl,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )

        @jax.jit
        def step_fn(state: TrainState, key: jax.Array):
            params, opt_state, step, metrics = sharded(
                state.params, state.opt_state, state.step, key
            )
            return TrainState(params, opt_state, step), metrics

        return step_fn

    def step(self, state: TrainState, key: jax.Array):
        """One VMC update. Returns (new_state, metrics dict of scalars)."""
        return self._step_fn(state, key)

    # -- compiled multi-step -------------------------------------------------

    def _build_multi_step(self, num_steps: int):
        def scanned(params, opt_state, step, key):
            def body(carry, _):
                p, o, s = carry
                p, o, s, m = self._device_step_impl(p, o, s, key)
                return (p, o, s), m

            (params, opt_state, step), ms = jax.lax.scan(
                body, (params, opt_state, step), None, length=num_steps
            )
            return params, opt_state, step, ms

        sharded = jax.shard_map(
            scanned,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )

        @jax.jit
        def multi_fn(state: TrainState, key: jax.Array):
            params, opt_state, step, ms = sharded(
                state.params, state.opt_state, state.step, key
            )
            return TrainState(params, opt_state, step), ms

        return multi_fn

    def run_steps(self, state: TrainState, key: jax.Array, num_steps: int):
        """Run ``num_steps`` VMC updates in a single device-side ``lax.scan``
        (one host dispatch — no per-step host round-trips; the reference pays
        3+ host<->device transitions per step, SURVEY.md §3.1).  Returns
        (state, metrics with a leading ``num_steps`` axis)."""
        if num_steps not in self._multi_step_cache:
            self._multi_step_cache[num_steps] = self._build_multi_step(num_steps)
        return self._multi_step_cache[num_steps](state, key)

    # -- evaluation (no parameter update) ------------------------------------

    def _build_evaluate(self, extra: tuple = ()):
        def device_eval_tp(params, key):
            key = mesh_lib.device_key(key)
            samples, _, e_re, e_im = self._tp_sample_and_energy(params, key)
            e_mean = mesh_lib.pmean(jnp.mean(e_re))
            var_e = mesh_lib.pmean(jnp.mean((e_re - e_mean) ** 2))
            mag = mesh_lib.pmean(
                jnp.mean(2.0 * samples.astype(jnp.float32) - 1.0)
            )
            out = {"mean_energy": e_mean, "var_energy": var_e,
                   "magnetization": mag}
            if e_im is not None:
                out["mean_energy_im"] = mesh_lib.pmean(jnp.mean(e_im))
            return out

        def device_eval(params, key):
            ansatz = self.ansatz
            key = mesh_lib.device_key(key)
            samples, logp_sampling = ansatz.sample_with_log_prob(
                params, key, self.local_samples
            )
            log_amp_s = self._log_amp_of_batch(params, samples, logp_sampling)
            e_re, e_im, _ = self.local_energy(params, samples, log_amp_s)
            e_mean = mesh_lib.pmean(jnp.mean(e_re))
            var_e = mesh_lib.pmean(jnp.mean((e_re - e_mean) ** 2))
            mag = mesh_lib.pmean(
                jnp.mean(2.0 * samples.astype(jnp.float32) - 1.0)
            )
            out = {"mean_energy": e_mean, "var_energy": var_e,
                   "magnetization": mag}
            if e_im is not None:
                out["mean_energy_im"] = mesh_lib.pmean(jnp.mean(e_im))
            if "sigma_x" in extra:
                out["sigma_x"] = mesh_lib.pmean(observables_mod.sigma_x(
                    ansatz, params, samples, log_amp_samples=log_amp_s,
                    chunk_size=self.config.chunk_size))
            if "structure_factor" in extra:
                # 2D lattices get S(kx, ky) on the commensurate momentum
                # grid (grid batches carry their shape; the snake family's
                # flat y-major batches take it from the ansatz); chains
                # keep the 1D S(k)
                lattice = getattr(ansatz, "lattice", None)
                if samples.ndim == 3:
                    sf = observables_mod.structure_factor_2d(samples)
                elif lattice is not None:
                    sf = observables_mod.structure_factor_2d(
                        samples, nx=lattice[0], ny=lattice[1])
                else:
                    sf = observables_mod.structure_factor(samples)
                out["structure_factor"] = mesh_lib.pmean(sf)
            if "renyi2" in extra:
                # half-chain second Renyi entropy via the two-replica swap
                # estimator: an independent second batch per device, purity
                # pmean'd across the mesh BEFORE the -log
                n = int(np.prod(samples.shape[1:]))
                samples_b, logp_b = ansatz.sample_with_log_prob(
                    params, jax.random.fold_in(key, 0x52454e59),
                    self.local_samples,
                )
                la_b = self._log_amp_of_batch(params, samples_b, logp_b)
                terms = observables_mod.renyi2_swap_terms(
                    ansatz, params, samples, samples_b,
                    np.arange(n // 2), log_amp_a=log_amp_s, log_amp_b=la_b,
                    chunk_size=self.config.chunk_size,
                )
                purity = mesh_lib.pmean(jnp.mean(terms))
                out["renyi2_purity"] = purity
                out["renyi2"] = -jnp.log(purity)
            return out

        # Extra observables ride the PLAIN ansatz path even on a tp mesh:
        # params are replicated (tp sharding is an in-graph compute strategy,
        # parallel/tensor.py), so the unsharded log_amp applies directly —
        # each tp-group member redundantly computes the identical
        # measurement (same dp-folded key), matching the tp step's own
        # sampling replication.  Slower than the sharded trunk for wide
        # models, but it makes tp-trained states measurable in one call.
        use_plain = self.tp == 1 or extra
        sharded = jax.shard_map(
            device_eval if use_plain else device_eval_tp,
            mesh=self.mesh, in_specs=(P(), P()),
            out_specs=P(), check_vma=False,
        )
        # same ambient matmul precision as the training step, so
        # post-training measurement agrees with the numerics trained at
        return jax.jit(
            self._with_matmul_precision(lambda params, key: sharded(params, key))
        )

    def evaluate(self, state: TrainState, key: jax.Array,
                 observables: tuple = ()):
        """Measure energy statistics and magnetization on a fresh sample
        batch without updating parameters (post-training measurement).

        ``observables`` optionally adds off-diagonal / correlation
        estimators to the jitted measurement: ``"sigma_x"`` (per-site
        transverse magnetization via single-flip amplitude ratios),
        ``"structure_factor"`` (S(k) at the commensurate momenta for
        chains; the S(kx, ky) momentum grid for 2D lattices), and
        ``"renyi2"`` (half-chain second Renyi entanglement entropy via the
        two-replica swap estimator — also returns ``"renyi2_purity"``, the
        mesh-averaged ``Tr rho_A^2``, which is the quantity to average over
        repeated batches before taking ``-log``).  See
        ``vmc/observables.py``; ``spin_spin_correlations`` and custom-region
        ``renyi2_entropy`` take explicit sites and stay standalone functions.
        """
        extra = tuple(sorted(observables))
        unknown = set(extra) - {"sigma_x", "structure_factor", "renyi2"}
        if unknown:
            raise ValueError(f"unknown observables: {sorted(unknown)}")
        if extra not in self._eval_fns:
            self._eval_fns[extra] = self._build_evaluate(extra)
        return self._eval_fns[extra](state.params, key)

    # -- training loop (the run_X equivalent) -------------------------------

    def fit(
        self,
        num_steps: int,
        state: Optional[TrainState] = None,
        key: Optional[jax.Array] = None,
        log_every: int = 10,
        callback: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ):
        """Train for ``num_steps``; returns (state, meanE list, varE list) —
        the reference ``run_X`` contract (``TrainingRNN_1DTFIM.py:229``).

        Runs ``log_every`` steps per device dispatch (``run_steps``' device-
        side ``lax.scan``) — metrics are only consumed on the log cadence, so
        per-step host round-trips would buy nothing but link latency."""
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        if state is None:
            state = self.init(jax.random.fold_in(key, 0))
        mean_energy, var_energy = [], []
        it = 0
        while it < num_steps:
            block = min(log_every, num_steps - it)
            state, ms = self.run_steps(state, key, block)
            for j, (me, ve) in enumerate(decode_metrics_block(ms)):
                mean_energy.append(me)
                var_energy.append(ve)
                if callback is not None and (it + j) % log_every == 0:
                    callback(it + j, {"mean_energy": me, "var_energy": ve})
            it += block
        return state, mean_energy, var_energy


def decode_metrics_block(ms) -> list:
    """Decode one ``run_steps`` metrics block (leading axis = steps) into a
    host-side list of (mean_energy, var_energy) pairs, reassembling complex
    means from the (Re, Im) real-pair form the device carries.  The single
    decode shared by ``fit`` and the CLI loop (cli/run_loop.py)."""
    me_arr = jax.device_get(ms["mean_energy"])
    ve_arr = jax.device_get(ms["var_energy"])
    im_arr = (
        jax.device_get(ms["mean_energy_im"]) if "mean_energy_im" in ms
        else None
    )
    out = []
    for j in range(len(me_arr)):
        me = float(me_arr[j])
        if im_arr is not None:
            me = complex(me, float(im_arr[j]))
        out.append((me, float(ve_arr[j])))
    return out
