"""Lazy dense sketch transforms: JLT, CT.

The port of libskylark_tpu/sketch/dense.py. The sketch matrix S
(S_dim × N) is virtual: its entries are a pure function of (allocation
key, column block) in the dense-block format of base/randgen.py, and S
is never stored. Applies take one of three routes, in this order:

- the fused generate-and-contract kernel's route (sketch/cuda_dense.py)
  for the distributions and dtype it supports — the CUDA kernel for a
  CUDA tensor, its plain version for a CPU tensor. A pinned operator
  never takes its place: no setting routes a CUDA tensor past the kernel;
- a pinned operator (OperatorCache) when one exists on A's device;
- otherwise the plain path: S materialized whole, or panel by panel when
  ``blocksize`` (or the auto-blocking threshold) asks for it.

A sparse operand (:class:`~libskylark_tpu_torch.base.sparse.SparseMatrix`)
is never densified and never takes the fused kernel, as in the
reference: the pinned operator, else S whole or panel by panel under the
same schedule, contracted by ``spmm``/``spmm_t`` (base/sparse.py). A
:class:`~libskylark_tpu_torch.base.dist_sparse.DistSparseMatrix` takes
sketch/dist_sparse_apply.py: each rank's cell against its own panel of S.
A DTensor whose sketched axis is split takes B1's partial kernel on each
rank's block at its global offset, an all_reduce, then the scale
(sketch/dtensor_apply.py).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.sketch import params as sketch_params
from libskylark_tpu_torch.sketch.transform import (OperatorCache,
                                                   SketchTransform, register,
                                                   seeded)

# Width of a virtual-S column block; part of the stream format.
BLOCK_COLS = 256


def virtual_panel(key, dist, s_dim: int, col_start: int, col_stop: int,
                  scale: float, dtype=torch.float32,
                  device=None, keys=None) -> torch.Tensor:
    """Columns [col_start, col_stop) of the scaled virtual (s_dim × N)
    operator — the one definition of the stream, BLOCK_COLS included
    (``keys``: its blocks' keys made beforehand, ``randgen.dense_panel``)."""
    return scale * randgen.dense_panel(
        key, dist, s_dim, col_start, col_stop, BLOCK_COLS, dtype, device,
        keys)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def regime_matmul(X: torch.Tensor, Y: torch.Tensor, precision: str,
                  gen_side: int) -> torch.Tensor:
    """X @ Y in the kernel regime ``precision``, term for term as the
    reference's ``pallas_dense._dot``; ``gen_side`` names the generated
    operator (0: X, 1: Y). With x = hi + lo, hi = bf16(x), lo = bf16(x −
    hi), each product of bf16 values is exact in float32, so the regimes
    differ from one another only in which terms they keep:

    - ``"f32"``: X @ Y;
    - ``"bf16x3"``: hi·hi + (hi·lo + lo·hi);
    - ``"bf16gen2"``: the operator rounded to bf16, the data split;
    - ``"bf16"``: bf16(X) @ bf16(Y)."""
    if precision == "f32":
        return X @ Y
    if precision == "bf16":
        return _bf16(X) @ _bf16(Y)
    if precision == "bf16gen2":
        if gen_side == 0:
            Xb, Yh = _bf16(X), _bf16(Y)
            return Xb @ Yh + Xb @ _bf16(Y - Yh)
        Xh, Yb = _bf16(X), _bf16(Y)
        return Xh @ Yb + _bf16(X - Xh) @ Yb
    if precision == "bf16x3":
        Xh, Yh = _bf16(X), _bf16(Y)
        Xl, Yl = _bf16(X - Xh), _bf16(Y - Yh)
        return Xh @ Yh + (Xh @ Yl + Xl @ Yh)
    raise ValueError(f"unknown kernel regime {precision!r}")


def serve_apply(key_data, scale, A: torch.Tensor, *, dist, s_dim: int,
                rowwise: bool, precision: str | None = None) -> torch.Tensor:
    """One request's A·Sᵀ (rowwise) or S·A (columnwise) as a function of
    the transform's raw key data ((2,) uint32) and its scale: the scaled
    :func:`virtual_panel` over the operand's (padded) extent, then the
    product in the kernel regime ``precision`` (default: the package's,
    sketch/params.py). Zero padding past the transform's N is exact, since
    the stream's first N columns do not depend on the panel's width. The
    serve layer's plain program (the microbatch kernel's plain version
    runs it lane by lane)."""
    p = sketch_params.check_kernel_precision(
        precision or sketch_params.get_kernel_precision())
    n = A.shape[1] if rowwise else A.shape[0]
    S = virtual_panel(key_data, dist, s_dim, 0, n, float(scale), A.dtype,
                      A.device)
    return (regime_matmul(A, S.T, p, 1) if rowwise
            else regime_matmul(S, A, p, 0))


class DenseTransform(OperatorCache, SketchTransform):
    """Base: S = scale × i.i.d. matrix from ``dist``."""

    sketch_type = "DenseTransform"
    dist: randgen.Distribution = randgen.Normal()

    @property
    def scale(self) -> float:
        raise NotImplementedError

    # -- virtual S materialization --

    def s_panel(self, col_start: int, col_stop: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
        """Materialize S[:, col_start:col_stop]."""
        # the blocks' keys come from the seeded _panel_keys alone
        return virtual_panel(None, self.dist, self._S,
                             col_start, col_stop, self.scale, dtype, device,
                             self._panel_keys(col_start, col_stop, device))

    @seeded
    def _panel_keys(self, col_start: int, col_stop: int,
                    device=None) -> torch.Tensor:
        """The keys of the column blocks of S[:, col_start:col_stop]."""
        return randgen.block_keys(self._alloc.key, col_start, col_stop,
                                  BLOCK_COLS, device)

    def s_block(self, block_id: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
        """Column block ``block_id`` of S (S_dim × BLOCK_COLS): the block
        protocol of the sequence-parallel apply (parallel/shard_apply.py)
        and of the distributed-sparse panels."""
        return self.scale * randgen.dense_block(
            self._alloc.key, self.dist, self._S, block_id, BLOCK_COLS, dtype,
            device)

    def _full_operator(self, dtype, device) -> torch.Tensor:
        return self.s_panel(0, self._N, dtype, device)

    def _kernel_serves(self, A: torch.Tensor) -> bool:
        """The dispatch rule of the fused kernel's route, decided before
        any launch: standard Normal/Cauchy/Rademacher and float32."""
        from libskylark_tpu_torch.sketch import cuda_dense

        return A.ndim == 2 and cuda_dense.supported(self.dist, A.dtype)

    def _materialize_changes_numerics(self, A, seq_axis=None) -> bool:
        return self._kernel_serves(A)

    # -- apply --

    def _effective_blocksize(self, dtype) -> int:
        """The panel width of the plain path: the ``blocksize`` knob, or
        an automatic width when the full operator would exceed the
        auto-blocking threshold; 0 for one unblocked panel."""
        blocksize = sketch_params.get_blocksize()
        if blocksize:
            return blocksize if self._N > blocksize else 0
        itemsize = dtype.itemsize
        if self._S * self._N * itemsize > sketch_params.get_auto_block_bytes():
            return max(BLOCK_COLS,
                       sketch_params.get_auto_block_bytes()
                       // max(self._S * itemsize, 1))
        return 0

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A, seq_axis=0)
        if self._kernel_serves(A):
            from libskylark_tpu_torch.sketch import cuda_dense

            return cuda_dense.columnwise_apply(
                self.kernel_key(), self.dist, A.contiguous(), self._S,
                self.scale)
        S = self._cached_op(A.dtype, A.device)
        if S is not None:
            return S @ A
        blocksize = self._effective_blocksize(A.dtype)
        if blocksize:
            return self._apply_columnwise_blocked(A, blocksize)
        return self.s_panel(0, self._N, A.dtype, A.device) @ A

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A, seq_axis=1)
        if self._kernel_serves(A):
            from libskylark_tpu_torch.sketch import cuda_dense

            return cuda_dense.rowwise_apply(
                self.kernel_key(), self.dist, A.contiguous(), self._S,
                self.scale)
        S = self._cached_op(A.dtype, A.device)
        if S is not None:
            return A @ S.T
        blocksize = self._effective_blocksize(A.dtype)
        if blocksize:
            return self._apply_rowwise_blocked(A, blocksize)
        return A @ self.s_panel(0, self._N, A.dtype, A.device).T

    # -- sparse input: spmm against the operator --

    def _apply_columnwise_sparse(self, A, device) -> torch.Tensor:
        """S·A = (Aᵀ·Sᵀ)ᵀ; blocked, the panel loop runs over Aᵀ, whose
        columns are A's rows, the sketched dimension."""
        from libskylark_tpu_torch.base.sparse import spmm_t

        dt = A.tensor_dtype
        S = self._cached_op(dt, device)
        if S is not None:
            return spmm_t(A, S.T).T
        blocksize = self._effective_blocksize(dt)
        if blocksize:
            return self._sparse_panel_loop(A.transpose(), blocksize,
                                           device).T
        return spmm_t(A, self.s_panel(0, self._N, dt, device).T).T

    def _apply_rowwise_sparse(self, A, device) -> torch.Tensor:
        """A·Sᵀ."""
        from libskylark_tpu_torch.base.sparse import spmm

        dt = A.tensor_dtype
        S = self._cached_op(dt, device)
        if S is not None:
            return spmm(A, S.T)
        blocksize = self._effective_blocksize(dt)
        if blocksize:
            return self._sparse_panel_loop(A, blocksize, device)
        return spmm(A, self.s_panel(0, self._N, dt, device).T)

    def _sparse_panel_loop(self, A, blocksize: int, device) -> torch.Tensor:
        """A·Sᵀ for a sparse (m, N) A with no more of S than one (S_dim ×
        panel) block made at a time: Σ_p A[:, p]·S[:, p]ᵀ over the column
        views of A."""
        from libskylark_tpu_torch.base.sparse import spmm

        dt = A.tensor_dtype
        acc = torch.zeros((A.height, self._S), dtype=dt, device=device)
        for p0, p1 in self._panel_bounds(blocksize):
            acc += spmm(A.column_view(p0, p1),
                        self.s_panel(p0, p1, dt, device).T)
        return acc

    # -- distributed sparse input: per-cell virtual panels + all-reduce --

    def _apply_columnwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.dense_columnwise(self, A)

    def _apply_rowwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.dense_rowwise(self, A)

    # -- DTensor input, sketched axis split: partial, all_reduce, scale --

    def _split_axis_apply(self, A_loc, lo, rowwise, reduce):
        """B1's unscaled partial against S's columns from ``lo`` (the
        shard padded to whole blocks, parallel/shard_apply.py), summed
        over the ranks, then scaled; a distribution or dtype B1 does not
        take contracts against the panel of S."""
        seq = 1 if rowwise else 0
        if self._kernel_serves(A_loc):
            from libskylark_tpu_torch.parallel import shard_apply

            return self.scale * reduce(shard_apply._partial(
                self._alloc.key, self.dist, self._S, A_loc, lo, seq))
        S = self.s_panel(lo, lo + A_loc.shape[seq], A_loc.dtype,
                         A_loc.device)
        return reduce(A_loc @ S.T if rowwise else S @ A_loc)

    # -- blocked (memory-bounded) apply: one virtual panel at a time --

    def _panel_bounds(self, blocksize: int) -> list[tuple[int, int]]:
        """Panels of a BLOCK_COLS multiple of columns, plus the tail."""
        bs = max(BLOCK_COLS, (blocksize // BLOCK_COLS) * BLOCK_COLS)
        return [(p, min(p + bs, self._N)) for p in range(0, self._N, bs)]

    def _apply_columnwise_blocked(self, A: torch.Tensor,
                                  blocksize: int) -> torch.Tensor:
        """S·A = Σ_p S[:, p] @ A[p, :]."""
        acc = torch.zeros((self._S, A.shape[1]), dtype=A.dtype,
                          device=A.device)
        for p0, p1 in self._panel_bounds(blocksize):
            acc += self.s_panel(p0, p1, A.dtype, A.device) @ A[p0:p1]
        return acc

    def _apply_rowwise_blocked(self, A: torch.Tensor,
                               blocksize: int) -> torch.Tensor:
        """A·Sᵀ = Σ_p A[:, p] @ S[:, p]ᵀ."""
        acc = torch.zeros((A.shape[0], self._S), dtype=A.dtype,
                          device=A.device)
        for p0, p1 in self._panel_bounds(blocksize):
            acc += A[:, p0:p1] @ self.s_panel(p0, p1, A.dtype, A.device).T
        return acc


@register
class JLT(DenseTransform):
    """Johnson-Lindenstrauss transform: S ~ N(0, 1/S_dim)."""

    sketch_type = "JLT"
    dist = randgen.Normal()

    @staticmethod
    def scale_for(s_dim: int) -> float:
        return math.sqrt(1.0 / s_dim)

    @property
    def scale(self) -> float:
        return self.scale_for(self._S)


@register
class CT(DenseTransform):
    """Cauchy transform for l1 embedding: Cauchy entries scaled C/S."""

    sketch_type = "CT"
    dist = randgen.Cauchy()

    def __init__(self, N, S, context, C: float = 1.0):
        self._C = float(C)
        super().__init__(N, S, context)

    @property
    def scale(self) -> float:
        return self._C / self._S

    def _extra_params(self) -> dict[str, Any]:
        return {"C": self._C}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, C=float(d.get("C", 1.0)))
