"""Block-ADMM solver for kernel machines (the port of
libskylark_tpu/ml/admm.py): consensus ADMM over feature-block
partitions. Per iteration: prox of the loss on the predictions, prox of
the regularizer on the consensus weights, then a per-block ridge solve
against a cached factor of (ZⱼᵀZⱼ + I), with consensus by averaging.

As in the reference there is one logical program, so the data-partition
consensus is exact (P = 1 rank) and the feature-block consensus keeps its
(NumPartitions + 1) factors. The feature maps are regenerated from their
(seed, counter) in every iteration unless ``cache_transforms`` is set;
the eight-array carry stays on X's device between iterations, and the
host reads a device value in an iteration only where the reference does:
``reldel`` when ``tol > 0``, the objective when telemetry is on or
``verbose``.

X may be a DTensor whose rows (examples) are split over a mesh
(parallel/mesh.py), the reference's sharded data. The consensus state
(Wbar, mu, the per-block weights) is whole on every rank, as the
reference replicates it on X's devices (``_on_data_devices``); the
per-example state (O, Obar, nu) stays on each rank's examples. Each
partition's map runs on the rank's rows (B1-cos on the card); every sum
over examples (ZⱼᵀZⱼ, Zⱼᵀ·dsum, Zⱼᵀ·o, the loss) is the rank's local sum
and one all_reduce. Every rank so computes the same consensus iterate,
and the model's coefficients are whole on every rank. An X whose
features are split is first laid out split on its examples by one
all-to-all at the start of training (``mesh._rows_layout``), then takes
that route.

``train(checkpoint=...)`` saves the carry through a
:class:`~libskylark_tpu_torch.utility.TrainCheckpointer` every
``checkpoint_every`` iterations and at the end, and stops at an
iteration boundary once a preemption signal has arrived. A rerun over
the same checkpoint resumes after the saved iteration and ends
``torch.equal`` to the uninterrupted run; it refuses a checkpoint of
another run (data, maps, losses or hyper-parameters), one past
``maxiter``, and a converged one under another ``tol``. A DTensor X
does not checkpoint (its per-example state lies on every rank; ROADMAP
C23).
"""

from __future__ import annotations

import math
import sys
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from libskylark_tpu_torch.algorithms.prox import Loss, Regularizer
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.ml.coding import host_array
from libskylark_tpu_torch.ml.kernels import Kernel
from libskylark_tpu_torch.ml.model import HilbertModel
from libskylark_tpu_torch.parallel import mesh as pmesh
from libskylark_tpu_torch.resilience.preemption import (
    preemption_requested as _preemption_requested)
from libskylark_tpu_torch.sketch import ROWWISE, SketchTransform
from libskylark_tpu_torch.telemetry import metrics as _telemetry_metrics
from libskylark_tpu_torch.utility.timer import get_timer, timers_enabled

# Per-iteration training telemetry, read only when telemetry is on:
# reading the objective waits for the device.
_ADMM_ITERS = _telemetry_metrics.counter(
    "ml.admm.iterations", "BlockADMM training iterations executed")
_ADMM_OBJECTIVE = _telemetry_metrics.gauge(
    "ml.admm.objective", "Most recent BlockADMM training objective")
_ADMM_RELDEL = _telemetry_metrics.gauge(
    "ml.admm.reldel",
    "Most recent relative consensus-iterate change (convergence signal)")

# Resume-identity scheme, the reference's: bumped whenever the identity's
# inputs change meaning. A checkpoint of another scheme refuses with a
# format diagnosis.
_IDENTITY_SCHEME = 4


def _partition(num_features: int, num_partitions: int) -> list[int]:
    """Equal split with the remainder spread forward."""
    sizes, nf, np_ = [], num_features, num_partitions
    for _ in range(num_partitions):
        sj = nf // np_
        sizes.append(sj)
        nf -= sj
        np_ -= 1
    return sizes


class BlockADMMSolver:
    """Consensus block-ADMM trainer producing a :class:`HilbertModel`.

    - ``BlockADMMSolver(loss, regularizer, lam, num_features,
      num_partitions)``: linear, blocks are column slices of X;
    - ``BlockADMMSolver.from_kernel(context, loss, regularizer, lam,
      num_features, kernel, tag, num_partitions)``: kernel random
      features per block;
    - ``BlockADMMSolver.with_maps(loss, regularizer, maps, lam,
      scale_maps)``: explicit transforms.
    """

    def __init__(
        self,
        loss: Loss,
        regularizer: Regularizer,
        lam: float,
        num_features: int,
        num_partitions: int = 1,
        feature_maps: Optional[Sequence[SketchTransform]] = None,
        scale_maps: bool = False,
    ):
        self.loss = loss
        self.regularizer = regularizer
        self.lam = float(lam)
        self.num_features = int(num_features)
        self.feature_maps = list(feature_maps) if feature_maps else []
        self.scale_maps = bool(scale_maps)
        if self.feature_maps:
            self.block_sizes = [m.sketch_dim for m in self.feature_maps]
            if sum(self.block_sizes) != self.num_features:
                raise errors.InvalidParametersError(
                    "feature maps do not cover num_features")
        else:
            self.block_sizes = _partition(num_features, num_partitions)
        self.starts = list(np.cumsum([0] + self.block_sizes[:-1]))
        # tol drives the relative-change stop (the reference's own TOL
        # is never read), hence the tight default
        self.rho = 1.0
        self.maxiter = 1000
        self.tol = 1e-6
        self.cache_transforms = False

    @classmethod
    def from_kernel(cls, context: Context, loss: Loss,
                    regularizer: Regularizer, lam: float, num_features: int,
                    kernel: Kernel, tag: str = "regular",
                    num_partitions: int = 1) -> "BlockADMMSolver":
        sizes = _partition(num_features, num_partitions)
        maps = [kernel.create_rft(sj, context, tag) for sj in sizes]
        return cls(loss, regularizer, lam, num_features,
                   feature_maps=maps, scale_maps=True)

    @classmethod
    def with_maps(cls, loss: Loss, regularizer: Regularizer,
                  maps: Sequence[SketchTransform], lam: float,
                  scale_maps: bool = True) -> "BlockADMMSolver":
        nf = sum(m.sketch_dim for m in maps)
        return cls(loss, regularizer, lam, nf,
                   feature_maps=maps, scale_maps=scale_maps)

    # -- internals --

    def _block_features(self, X: torch.Tensor, j: int) -> torch.Tensor:
        """Zⱼ (n, sⱼ): the feature map's apply, or a column slice."""
        if self.feature_maps:
            Z = self.feature_maps[j].apply(X, ROWWISE, device=X.device)
            if self.scale_maps:
                Z = Z * math.sqrt(self.block_sizes[j] / X.shape[1])
            return Z
        start = self.starts[j]
        return X[:, start:start + self.block_sizes[j]]

    # ``train`` composes the iteration from these three parts.

    def init_carry(self, n: int, k: int, dt, device=None) -> tuple:
        """The zero consensus carry: (Wbar, O, Obar, nu, mu, mu_ij,
        ZtObar_ij, del_o)."""
        D = self.num_features

        def z(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        return (z(D, k), z(k, n), z(k, n), z(k, n), z(D, k), z(D, k),
                z(D, k), z(k, n))

    def build_caches(self, X, dt, timer=None, total=None):
        """Per-block Cholesky factors of (ZⱼᵀZⱼ + I). Returns
        ``(cache_mats, cache_lowers, Zs)``: the factors, their lower
        flags, and the Zⱼ themselves when ``cache_transforms`` is on.
        ``total`` sums a product over examples across the ranks that hold
        X's rows (None: X is whole)."""
        total = total or (lambda t: t)
        cache_mats, cache_lowers, Zs = [], [], []
        for j, sj in enumerate(self.block_sizes):
            with timer.phase("TRANSFORM") if timer else nullcontext():
                Z = self._block_features(X, j)
            with timer.phase("FACTORIZATION") if timer else nullcontext():
                L = torch.linalg.cholesky(
                    total(Z.T @ Z) + torch.eye(sj, dtype=dt, device=Z.device))
            cache_mats.append(L)
            cache_lowers.append(True)
            if self.cache_transforms:
                Zs.append(Z)
        return cache_mats, tuple(cache_lowers), Zs

    def make_step(self, n: int, k: int, dt, cache_lowers: tuple,
                  total=None):
        """One consensus-ADMM iteration as a function ``(carry, X, Y,
        cache_mats, Zs) -> (carry, (objective, reldel))``, both scalars
        left on the device. ``total`` sums over the ranks that hold X's
        rows (n: this rank's examples), as in :meth:`build_caches`."""
        total = total or (lambda t: t)
        loss, reg = self.loss, self.regularizer
        lam, rho = self.lam, self.rho
        starts, sizes = self.starts, self.block_sizes
        P = len(self.block_sizes)

        def step(carry, X, Y, cache_mats, Zs):
            Wbar, O, Obar, nu, mu, mu_ij, ZtObar_ij, del_o = carry

            mu_ij = mu_ij - Wbar
            Obar = Obar - nu
            O = loss.prox(Obar, 1.0 / rho, Y)
            W = reg.prox(Wbar, lam / rho, mu)

            sum_o = torch.zeros((k, n), dtype=dt, device=X.device)
            wbar_output = torch.zeros((k, n), dtype=dt, device=X.device)
            Wi = torch.zeros_like(Wbar)
            new_ZtObar = ZtObar_ij.clone()

            dsum = (del_o / (P + 1.0) + nu).T        # (n, k)

            for j in range(P):
                sl = slice(starts[j], starts[j] + sizes[j])
                Z = Zs[j] if self.cache_transforms else \
                    self._block_features(X, j)
                wbar_output = wbar_output + (Z @ Wbar[sl]).T
                rhs = Wbar[sl] - mu_ij[sl] + ZtObar_ij[sl] + total(Z.T @ dsum)
                Wi_J = torch.cholesky_solve(rhs, cache_mats[j],
                                            upper=not cache_lowers[j])
                o = (Z @ Wi_J).T                     # (k, n)
                mu_ij[sl] += Wi_J
                new_ZtObar[sl] = total(Z.T @ o.T)
                Wi[sl] = Wi_J
                sum_o = sum_o + o

            sum_o = O - sum_o
            del_o = sum_o
            objective = (total(loss.evaluate(wbar_output, Y))
                         + lam * reg.evaluate(Wbar))

            Obar = O - sum_o / (P + 1.0)
            nu = nu + O - Obar

            # consensus over one logical rank: exactly (W + Wi)/2
            Wbar_new = (Wi + W) / 2.0
            mu = mu + W - Wbar_new

            reldel = torch.linalg.norm(Wbar_new - Wbar) / torch.clamp_min(
                torch.linalg.norm(Wbar_new), torch.finfo(dt).tiny)
            return ((Wbar_new, O, Obar, nu, mu, mu_ij, new_ZtObar, del_o),
                    (objective, reldel))

        return step

    @with_solver_precision
    def train(self, X, Y, Xv=None, Yv=None, regression: bool = False,
              num_targets: Optional[int] = None, verbose: bool = False,
              checkpoint=None, checkpoint_every: int = 10,
              device=None) -> HilbertModel:
        """Run ADMM. X is (n, d), rows are examples; Y is (n,): real
        targets for regression, integer class labels 0..k−1 for
        classification. Returns the trained model, on X's device; with
        ``verbose``, prints the objective per iteration and, given (Xv,
        Yv), the validation error or accuracy."""
        total = None
        if pmesh._is_sharded(X):
            if checkpoint is not None:
                raise errors.UnsupportedError(
                    "BlockADMMSolver.train(checkpoint=...) on a DTensor: "
                    "the per-example state lies on every rank (ROADMAP C23)")
            # each rank trains on its examples; sums over examples are
            # all-reduced (module docstring)
            B = pmesh._Blocks(pmesh._rows_layout(X))
            X, Y, total = B.local, B.row_block(Y).reshape(-1), B.rows.sum
        else:
            X = as_tensor(X, device)
            Y = as_tensor(Y, X.device).reshape(-1)
        n, d = X.shape
        if regression:
            k = 1
        else:
            # the labels' range over every rank's examples
            lo_hi = torch.stack([-Y.min(), Y.max()]) if n else torch.full(
                (2,), torch.iinfo(torch.int64).min, device=X.device)
            lo_hi = lo_hi.to(torch.int64)
            if total is not None:
                pmesh._reduce_partial(lo_hi, B.mesh, B.rows.split, op="max")
            if int(-lo_hi[0]) < 0:
                raise errors.InvalidParametersError(
                    "classification labels must be integers in 0..k-1 "
                    "(recode ±1 labels to 0/1)")
            k = (int(num_targets) if num_targets is not None
                 else int(lo_hi[1]) + 1)
        dt = X.dtype
        model = HilbertModel(self.feature_maps, self.scale_maps,
                             self.num_features, k, regression,
                             input_size=d, device=X.device)

        timer = get_timer("admm")
        timer.reset()
        carry = self.init_carry(n, k, dt, X.device)

        ckpt, ident = None, None
        ckpt_owned = False
        start_it = 1
        resume_finished = False
        if checkpoint is not None:
            from libskylark_tpu_torch.utility.checkpoint import (
                TrainCheckpointer, as_checkpointer)

            ident = self._identity(X, Y, k, regression)
            # a path means this train() owns the checkpointer: it finishes
            # the writes before returning
            ckpt_owned = not isinstance(checkpoint, TrainCheckpointer)
            ckpt = as_checkpointer(checkpoint)
            try:
                carry, start_it, resume_finished = self._resume(
                    ckpt, checkpoint, ident, carry)
            except BaseException:
                if ckpt_owned:
                    ckpt.close()
                raise

        # the factors are built only when iterations will run: resuming a
        # finished run returns without them
        cache_mats, cache_lowers, Zs = [], (), []
        if not resume_finished and start_it <= self.maxiter:
            cache_mats, cache_lowers, Zs = self.build_caches(
                X, dt, timer=timer, total=total)
        step = self.make_step(n, k, dt, cache_lowers, total=total)

        def _save(it, carry, converged=False):
            with timer.phase("CHECKPOINT"):
                ckpt.save(it, list(carry),
                          {"identity": ident,
                           "identity_scheme": _IDENTITY_SCHEME,
                           "iteration": int(it),
                           "converged": bool(converged),
                           "tol": float(self.tol)})

        it = start_it - 1
        converged = False
        try:
            for it in [] if resume_finished else range(start_it,
                                                       self.maxiter + 1):
                carry, converged = self._iterate(
                    it, step, carry, X, Y, Zs, cache_mats, model, timer,
                    verbose, Xv, Yv, regression)
                if converged:
                    break
                if ckpt is not None and _preemption_requested():
                    # stop at this iteration boundary: the final save below
                    # and the close make it durable; a rerun resumes at it+1
                    break
                if ckpt is not None and checkpoint_every > 0 \
                        and it % int(checkpoint_every) == 0 \
                        and it < self.maxiter:
                    _save(it, carry)
            if ckpt is not None and it >= start_it:
                _save(it, carry, converged)
        finally:
            if ckpt is not None and ckpt_owned:
                ckpt.close()

        model.coef = carry[0]
        if timers_enabled():
            timer.report(stream=sys.stdout)
        return model

    def _identity(self, X, Y, k: int, regression: bool) -> str:
        """Resume identity of a run: the losses and regularizer with their
        state, the hyper-parameters, the maps, the shapes, the dtype, and
        the data's :func:`sample_digest`."""
        import hashlib

        from libskylark_tpu_torch.utility.checkpoint import sample_digest

        loss, reg = self.loss, self.regularizer
        n, d = X.shape
        h = hashlib.sha256()
        h.update(repr((
            type(loss).__name__, sorted(vars(loss).items()),
            type(reg).__name__, sorted(vars(reg).items()),
            self.lam, self.rho, list(self.block_sizes), self.scale_maps,
            int(self.num_features), int(k), int(n), int(d),
            bool(regression), str(X.dtype),
        )).encode())
        for fm in self.feature_maps:
            h.update(fm.to_json().encode())
        h.update(sample_digest(X).encode())
        h.update(sample_digest(Y).encode())
        return h.hexdigest()

    def _resume(self, ckpt, where, ident: str, carry: tuple):
        """``(carry, first iteration, finished)`` from the newest
        checkpoint of this run, or the zero carry when there is none.
        Refuses another scheme, another run, a step past ``maxiter``, and
        a converged run under another ``tol``."""
        if ckpt.latest_step() is None:
            return carry, 1, False
        step0, meta = ckpt.metadata()
        if meta.get("identity_scheme") != _IDENTITY_SCHEME:
            raise errors.InvalidParametersError(
                f"checkpoint at {where} was written by an older build "
                "(incompatible resume-identity scheme) — retrain from "
                "scratch")
        if meta.get("identity") != ident:
            raise errors.InvalidParametersError(
                f"checkpoint at {where} belongs to a different training "
                "run (data, feature maps or hyperparameters differ) — "
                "refusing to resume")
        if step0 > self.maxiter:
            raise errors.InvalidParametersError(
                f"checkpoint at {where} is at iteration {step0} > "
                f"maxiter={self.maxiter}; returning it would silently "
                "over-train — raise maxiter or point at a fresh directory")
        _, state, _ = ckpt.restore(step0, target=list(carry))
        # a run that stopped on convergence is done; a rerun asking for
        # another tol refuses instead of returning it as it is
        finished = bool(meta.get("converged", False))
        saved_tol = meta.get("tol")
        if finished and saved_tol is not None and \
                saved_tol != float(self.tol):
            raise errors.InvalidParametersError(
                f"checkpoint at {where} finished by converging at "
                f"tol={saved_tol}; this run requests tol={self.tol}. "
                "Refusing to return the converged model as-is — use a "
                "fresh checkpoint directory to re-train with the new "
                "tolerance")
        return tuple(state), step0 + 1, finished

    def _iterate(self, it, step, carry, X, Y, Zs, cache_mats, model, timer,
                 verbose, Xv, Yv, regression):
        """One iteration with its telemetry and printing: ``(carry,
        converged)``."""
        with timer.phase("ITERATIONS"):
            carry, (objective, reldel) = step(carry, X, Y, cache_mats, Zs)
            if timers_enabled() and X.is_cuda:
                torch.cuda.synchronize(X.device)  # device time here
        if _telemetry_metrics.enabled():
            _ADMM_ITERS.inc()
            _ADMM_OBJECTIVE.set(float(objective))
            _ADMM_RELDEL.set(float(reldel))
        model.coef = carry[0]
        if verbose:
            msg = f"iteration {it} objective {float(objective):.6g}"
            if Xv is not None:
                with timer.phase("PREDICTION"):
                    acc = self._validate(model, Xv, Yv, regression)
                msg += f" accuracy {acc:.4g}"
            print(msg)
        # convergence on the relative change of the consensus iterate;
        # tol = 0 forces maxiter iterations
        converged = self.tol > 0 and it > 1 and float(reldel) <= self.tol
        return carry, converged

    @staticmethod
    def _validate(model: HilbertModel, Xv, Yv, regression: bool) -> float:
        """Relative L2 error for regression, percent accuracy for
        classification."""
        labels, DV = model.predict(Xv)
        Yv = host_array(Yv).reshape(-1)
        if regression:
            err = np.linalg.norm(host_array(DV).reshape(-1) - Yv)
            return float(err / max(np.linalg.norm(Yv), 1e-30))
        return float((host_array(labels) == Yv).mean() * 100.0)
