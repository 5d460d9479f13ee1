"""Random Fourier and Laplace feature transforms: GaussianRFT,
LaplacianRFT, MaternRFT, ExpSemigroupRLT (the port of
libskylark_tpu/sketch/rft.py).

Rahimi–Recht features z(x) = outscale · cos(scales ⊙ (W x) + b), W the
lazy (S × N) frequency matrix inscale · (i.i.d. ``dist``) in the
dense-block format of base/randgen.py (sub-stream 0), b ~ U[0, 2π)
(sub-stream 1), per-feature scales 1 but for MaternRFT's √(2ν/χ²(2ν))
(sub-stream 2, the Gamma sampler). Routes, decided before any launch:

- rowwise, standard Normal frequencies (Gaussian, Matern), float32: the
  cos-epilogue kernel
  (sketch/cuda_dense.py ``rft_rowwise_apply``, B1-cos on a CUDA tensor,
  its plain version on a CPU tensor). Cauchy frequencies (Laplacian) make
  heavy-tailed phases where f32 cos turns a contraction-order difference
  into a visible one, so, as in the reference, they stay two-step;
- otherwise the projection W·A or A·Wᵀ takes the dense kernel's route
  (B1-rw, B1-cw, scale = inscale) when its distribution is one the kernel
  generates, then a torch cos. Cauchy frequencies project in the "f32"
  regime: bf16x3 keeps each term to ≈ 2⁻¹⁶, and under the cos their
  heavy-tailed phases turn that into ≈ 8e-4 of max|features| against the
  reference (Gaussian ones stay near 2e-5, inside the 1e-4 oracle). StandardLevy has no kernel: its W is made
  by ``dense_panel`` and contracted by ``torch.matmul``, as the
  reference's XLA path does. A pinned operator (OperatorCache) serves
  only that last path: no setting routes a CUDA tensor past a kernel.

A sparse operand projects by ``spmm``/``spmm_t`` against the pinned W
or W made whole (float32, whatever the distribution), then the same
featurization, as the reference's sparse branch does; a
:class:`~libskylark_tpu_torch.base.dist_sparse.DistSparseMatrix` projects
each rank's cell against its own panel of W (sketch/dist_sparse_apply.py),
then featurizes. A DTensor featurizes each rank's rows by the one-process
route (B1-cos on the card), or, where its sketched axis is split, sums
the ranks' partial projections (B1's partial kernel) by an all_reduce and
featurizes the sum (sketch/dtensor_apply.py).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.sketch import cuda_dense
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS
from libskylark_tpu_torch.sketch.transform import (OperatorCache,
                                                   SketchTransform, register,
                                                   seeded)


def matern_scales(chi2: torch.Tensor, nu: float) -> torch.Tensor:
    """√(2ν / max(χ², tiny)) in χ²'s dtype, the division rounded once as
    the reference's (a Python scalar over a tensor would take the
    reciprocal first)."""
    tiny = torch.finfo(chi2.dtype).tiny
    num = torch.tensor(2.0 * nu, dtype=chi2.dtype, device=chi2.device)
    return torch.sqrt(torch.div(num, torch.clamp_min(chi2, tiny)))


class RFT(OperatorCache, SketchTransform):
    """Base random-Fourier-feature transform."""

    sketch_type = "RFT"
    dist: randgen.Distribution = randgen.Normal()

    @property
    def inscale(self) -> float:
        raise NotImplementedError

    @property
    def outscale(self) -> float:
        return math.sqrt(2.0 / self._S)

    def w_panel(self, col_start: int, col_stop: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
        """W[:, col_start:col_stop] of the lazy (S × N) frequency matrix."""
        # the blocks' keys come from the seeded _panel_keys alone
        return self.inscale * randgen.dense_panel(
            None, self.dist, self._S, col_start, col_stop,
            BLOCK_COLS, dtype, device,
            self._panel_keys(col_start, col_stop, device))

    @seeded
    def _panel_keys(self, col_start: int, col_stop: int,
                    device=None) -> torch.Tensor:
        """The keys of the column blocks of W[:, col_start:col_stop]."""
        return randgen.block_keys(self.subkey(0), col_start, col_stop,
                                  BLOCK_COLS, device)

    def s_block(self, block_id: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
        """Column block ``block_id`` of W."""
        return self.inscale * randgen.dense_block(
            self.subkey(0), self.dist, self._S, block_id, BLOCK_COLS, dtype,
            device)

    @seeded
    def shifts(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(1), randgen.Uniform(0.0, 2.0 * math.pi), 0, self._S,
            dtype, device)

    @seeded
    def row_scales(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Per-feature scaling: 1."""
        return torch.ones((self._S,), dtype=dtype, device=device)

    def _full_operator(self, dtype, device) -> torch.Tensor:
        return self.w_panel(0, self._N, dtype, device)

    def _materialize_changes_numerics(self, A, seq_axis=None) -> bool:
        return self._projection_kernel_serves(A)

    def _projection_kernel_serves(self, A: torch.Tensor) -> bool:
        """The dense kernel's route for the projection: a distribution
        it generates, float32."""
        return A.ndim == 2 and cuda_dense.supported(self.dist, A.dtype)

    def _cos_kernel_serves(self, A: torch.Tensor) -> bool:
        """The cos-epilogue kernel's route: the rowwise projection's route
        with standard Normal frequencies."""
        return (type(self.dist) is randgen.Normal
                and self._projection_kernel_serves(A))

    def _featurize(self, WA: torch.Tensor, feature_axis: int) -> torch.Tensor:
        shape = [1, 1]
        shape[feature_axis] = self._S
        sc = self.row_scales(WA.dtype, WA.device).reshape(shape)
        sh = self.shifts(WA.dtype, WA.device).reshape(shape)
        return self.outscale * torch.cos(WA * sc + sh)

    def _project(self, A: torch.Tensor, rowwise: bool) -> torch.Tensor:
        """A·Wᵀ (rowwise) or W·A (columnwise)."""
        if self._projection_kernel_serves(A):
            fn = (cuda_dense.rowwise_apply if rowwise
                  else cuda_dense.columnwise_apply)
            heavy = isinstance(self.dist, randgen.Cauchy)
            return fn(self.kernel_key(0), self.dist, A.contiguous(), self._S,
                      self.inscale, precision="f32" if heavy else None)
        W = self._cached_op(A.dtype, A.device)
        if W is None:
            W = self.w_panel(0, self._N, A.dtype, A.device)
        return A @ W.T if rowwise else W @ A

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A, seq_axis=0)
        return self._featurize(self._project(A, rowwise=False),
                               feature_axis=0)

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A, seq_axis=1)
        if self._cos_kernel_serves(A):
            return cuda_dense.rft_rowwise_apply(
                self.kernel_key(0), self.dist, A.contiguous(), self._S,
                self.inscale, self.outscale,
                self.row_scales(torch.float32, A.device),
                self.shifts(torch.float32, A.device))
        return self._featurize(self._project(A, rowwise=True),
                               feature_axis=1)

    # -- sparse input: project with spmm, then featurize --

    def _sparse_operator(self, A, device) -> torch.Tensor:
        W = self._cached_op(A.tensor_dtype, device)
        return W if W is not None else self.w_panel(0, self._N,
                                                    A.tensor_dtype, device)

    def _apply_columnwise_sparse(self, A, device) -> torch.Tensor:
        from libskylark_tpu_torch.base.sparse import spmm_t

        W = self._sparse_operator(A, device)
        return self._featurize(spmm_t(A, W.T).T, feature_axis=0)

    def _apply_rowwise_sparse(self, A, device) -> torch.Tensor:
        from libskylark_tpu_torch.base.sparse import spmm

        W = self._sparse_operator(A, device)
        return self._featurize(spmm(A, W.T), feature_axis=1)

    # -- DTensor input, sketched axis split: partial, all_reduce, epilogue --

    def _split_axis_apply(self, A_loc, lo, rowwise, reduce):
        """The projection's partial on this rank's block (B1's unscaled
        partial kernel where it generates the distribution, "f32" for
        Cauchy frequencies as the one-process route; else the panel of
        W), summed over the ranks, then inscale, the shifts, the
        per-feature scales, cos and outscale on the sum."""
        seq = 1 if rowwise else 0
        if self._projection_kernel_serves(A_loc):
            from libskylark_tpu_torch.parallel import shard_apply

            heavy = isinstance(self.dist, randgen.Cauchy)
            WA = self.inscale * reduce(shard_apply._partial(
                self.subkey(0), self.dist, self._S, A_loc, lo, seq,
                precision="f32" if heavy else None))
        else:
            W = self.w_panel(lo, lo + A_loc.shape[seq], A_loc.dtype,
                             A_loc.device)
            WA = reduce(A_loc @ W.T if rowwise else W @ A_loc)
        return self._featurize(WA, feature_axis=1 if rowwise else 0)

    # -- distributed sparse input: per-cell panels of W, then featurize --

    def _apply_columnwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return self._featurize(dsa.dense_columnwise(self, A),
                               feature_axis=0)

    def _apply_rowwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return self._featurize(dsa.dense_rowwise(self, A), feature_axis=1)


class _SigmaRFT(RFT):
    """An RFT with bandwidth σ: inscale 1/σ."""

    def __init__(self, N, S, context, sigma: float = 1.0):
        self._sigma = float(sigma)
        super().__init__(N, S, context)

    @property
    def inscale(self) -> float:
        return 1.0 / self._sigma

    def _extra_params(self) -> dict[str, Any]:
        return {"sigma": self._sigma}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, sigma=float(d.get("sigma", 1.0)))


@register
class GaussianRFT(_SigmaRFT):
    """Gaussian-kernel random features: W ~ N(0, 1), inscale 1/σ."""

    sketch_type = "GaussianRFT"
    dist = randgen.Normal()


@register
class LaplacianRFT(_SigmaRFT):
    """Laplacian-kernel random features: W ~ Cauchy, inscale 1/σ."""

    sketch_type = "LaplacianRFT"
    dist = randgen.Cauchy()


@register
class MaternRFT(RFT):
    """Matern-kernel random features: multivariate-t frequencies, normal
    W (inscale 1/l) with per-feature scales √(2ν/χ²(2ν)), χ²(2ν) =
    Gamma(ν, scale 2) on sub-stream 2. Its rowwise apply takes the
    cos-epilogue kernel as GaussianRFT's does, the scales as ``sc``."""

    sketch_type = "MaternRFT"
    dist = randgen.Normal()

    def __init__(self, N, S, context, nu: float = 1.0, l: float = 1.0):
        self._nu = float(nu)
        self._l = float(l)
        super().__init__(N, S, context)

    @property
    def inscale(self) -> float:
        return 1.0 / self._l

    @seeded
    def row_scales(self, dtype=torch.float32, device=None) -> torch.Tensor:
        chi2 = randgen.stream_slice(
            self.subkey(2), randgen.Gamma(shape_param=self._nu, scale=2.0),
            0, self._S, dtype, device)
        return matern_scales(chi2, self._nu)

    def _extra_params(self) -> dict[str, Any]:
        return {"nu": self._nu, "l": self._l}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, nu=float(d.get("nu", 1.0)),
                   l=float(d.get("l", 1.0)))


@register
class ExpSemigroupRLT(RFT):
    """Random Laplace features for the exponential semigroup kernel:
    z(x) = √(1/S) · exp(−W x), W ~ (β²/2)·StandardLevy. Inputs must be
    nonnegative, as in the reference."""

    sketch_type = "ExpSemigroupRLT"
    dist = randgen.StandardLevy()

    def __init__(self, N, S, context, beta: float = 1.0):
        self._beta = float(beta)
        super().__init__(N, S, context)

    @property
    def inscale(self) -> float:
        return self._beta * self._beta / 2.0

    @property
    def outscale(self) -> float:
        return math.sqrt(1.0 / self._S)

    def _featurize(self, WA: torch.Tensor, feature_axis: int) -> torch.Tensor:
        return self.outscale * torch.exp(-WA)

    def _extra_params(self) -> dict[str, Any]:
        return {"beta": self._beta}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, beta=float(d.get("beta", 1.0)))
