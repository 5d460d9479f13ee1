"""Hash-based sparse-embedding sketches: CWT (CountSketch), MMT, WZT (the
port of libskylark_tpu/sketch/hash.py).

A transform is two counter streams over its allocation key: ``row_idx``,
a bucket in [0, S) per input coordinate (sub-stream 0), and
``row_value``, a per-coordinate scale (sub-stream 1: Rademacher for CWT,
Cauchy for MMT, signed reciprocal-exponential for WZT). The apply is the
scatter SA[h[j], :] += v[j]·A[j, :]. CWT on a float32 operand runs the
CountSketch kernel's route (sketch/cuda_hash.py): kernel B2 on a CUDA
tensor, its plain version on a CPU tensor. The other transforms and
dtypes take the plain scatter (``index_add_``), which on the CPU adds in
increasing coordinate order. On a CUDA tensor ``index_add_`` adds with
atomics in no fixed order, so there MMT, WZT and a CWT of a dtype other
than float32 are neither ordered like the reference's ``segment_sum`` nor
bit-stable from run to run.

Sparse operands (:class:`~libskylark_tpu_torch.base.sparse.SparseMatrix`)
take an O(nnz) scatter over their nonzeros. A CWT scatters its CSR lanes
in row-major order: float32 through the CSR-lane CountSketch kernel's
route at one lane (sketch/cuda_sparse.py: kernel B3 on the card, its plain
version on the CPU), which adds each output cell's terms in the
reference's order, other dtypes through that plain version directly
(unordered on CUDA). MMT and WZT take ``index_add_`` over the COO
triplets (CSC order), ordered on the CPU, unordered on CUDA.
``apply_sparse`` gives a sparse result, on the host. A
:class:`~libskylark_tpu_torch.base.dist_sparse.DistSparseMatrix` takes
sketch/dist_sparse_apply.py: each rank's cell by the same routes (CWT in
float32 by B3 at the cell's global offset, the others by ``index_add_``,
unordered on CUDA), then an all-reduce over the ranks; ``apply_sparse``
of one stays distributed. A DTensor whose sketched axis is split hashes
each rank's block by its coordinates' global indices (CWT in float32: B2
with ``n0``), then an all-reduce (sketch/dtensor_apply.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch import cuda_hash, sparse_serve
from libskylark_tpu_torch.sketch.transform import (SketchTransform, register,
                                                   seeded)


def cwt_serve_apply(key_data, A: torch.Tensor, *, s_dim: int,
                    rowwise: bool) -> torch.Tensor:
    """One CountSketch as a function of the transform's raw key data
    ((2,) uint32): the same streams as :meth:`HashTransform.bucket_indices`
    and :meth:`CWT.values` over the operand's extent, so zero padding past
    the transform's N leaves the result unchanged. Float32 takes the
    kernel's route; other dtypes the plain scatter, unordered on CUDA."""
    if cuda_hash.supported(A.dtype):
        return cuda_hash.cwt_apply(key_data, A.contiguous(), s_dim, rowwise)
    return cuda_hash.cwt_apply_plain(key_data, A, s_dim, rowwise)


class HashTransform(SketchTransform):
    """Base: SA[h[j], :] += v[j]·A[j, :] (columnwise)."""

    sketch_type = "HashTransform"

    def _value_stream(self, dtype, device, lo: int = 0,
                      hi: int | None = None) -> torch.Tensor:
        """Per-coordinate values v[lo:hi] (default all N); overridden per
        transform."""
        raise NotImplementedError

    @seeded
    def bucket_indices(self, device=None, lo: int = 0,
                       hi: int | None = None) -> torch.Tensor:
        """h[lo:hi] (default all N), the bucket of each input coordinate
        (sub-stream 0)."""
        return randgen.stream_slice(
            self.subkey(0), randgen.UniformInt(0, self._S - 1), lo,
            self._N if hi is None else hi, device=device)

    def values(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return self._value_stream(dtype, device)

    def _kernel_serves(self, A: torch.Tensor) -> bool:
        return False

    def _apply(self, A: torch.Tensor, rowwise: bool) -> torch.Tensor:
        if self._kernel_serves(A):
            return cuda_hash.cwt_apply(self.kernel_key(), A.contiguous(),
                                       self._S, rowwise)
        h = self.bucket_indices(A.device)
        v = self.values(A.dtype, A.device)
        return cuda_hash.scatter(h, v, A, self._S, rowwise)

    def _apply_columnwise(self, A):
        return self._apply(A, rowwise=False)

    def _apply_rowwise(self, A):
        return self._apply(A, rowwise=True)

    # -- DTensor input, sketched axis split: each rank's coordinates --

    def _split_axis_apply(self, A_loc, lo, rowwise, reduce):
        """This rank's coordinates [lo, lo + n) hashed by their global
        index (CWT in float32: B2 with ``n0 = lo``; else the scatter on
        the sliced streams), summed over the ranks."""
        if self._kernel_serves(A_loc):
            return reduce(cuda_hash.cwt_apply(
                self._alloc.key, A_loc.contiguous(), self._S, rowwise, lo))
        hi = lo + A_loc.shape[1 if rowwise else 0]
        h = self.bucket_indices(A_loc.device, lo, hi)
        v = self._value_stream(A_loc.dtype, A_loc.device, lo, hi)
        return reduce(cuda_hash.scatter(h, v, A_loc, self._S, rowwise))

    # -- sparse input: O(nnz) scatter over the nonzeros --

    def _apply_sparse_dense_out(self, A, device, rowwise: bool):
        r, c, v = A.coo(device=device)
        h = self.bucket_indices(device)
        vs = self.values(v.dtype, device)
        if rowwise:
            flat = torch.zeros(A.height * self._S, dtype=v.dtype,
                               device=device)
            flat.index_add_(0, r * self._S + h[c], vs[c] * v)
            return flat.view(A.height, self._S)
        flat = torch.zeros(self._S * A.width, dtype=v.dtype, device=device)
        flat.index_add_(0, h[r] * A.width + c, vs[r] * v)
        return flat.view(self._S, A.width)

    def _apply_columnwise_sparse(self, A, device):
        return self._apply_sparse_dense_out(A, device, rowwise=False)

    def _apply_rowwise_sparse(self, A, device):
        return self._apply_sparse_dense_out(A, device, rowwise=True)

    # -- distributed sparse input: each rank's cell, then an all-reduce --

    def _apply_columnwise_dist_sparse(self, A):
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.hash_columnwise(self, A)

    def _apply_rowwise_dist_sparse(self, A):
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.hash_rowwise(self, A)

    def apply_sparse(self, A, dimension=None):
        """Sparse → sparse apply on the host: a :class:`SparseMatrix` with
        duplicates summed, equal elementwise to ``apply``'s dense
        result. A :class:`DistSparseMatrix` gives a distributed sparse
        result (the SpParMat → SpParMat analog)."""
        from libskylark_tpu_torch.base.dist_sparse import DistSparseMatrix
        from libskylark_tpu_torch.base.sparse import SparseMatrix, as_sparse
        from libskylark_tpu_torch.sketch.transform import COLUMNWISE

        if isinstance(A, DistSparseMatrix):
            from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

            return dsa.hash_apply_sparse(
                self, A, columnwise=(dimension or COLUMNWISE) == COLUMNWISE)
        A = as_sparse(A)
        dimension = dimension or COLUMNWISE
        n = A.height if dimension == COLUMNWISE else A.width
        if n != self._N:
            raise errors.SketchError(
                f"{dimension.value} apply expects {self._N} "
                f"{'rows' if dimension == COLUMNWISE else 'cols'}, got "
                f"{A.shape}")
        h = self.bucket_indices().numpy()
        sp = A.to_scipy().tocoo()
        v = self.values(getattr(torch, np.dtype(A.device_dtype).name)).numpy()
        if dimension == COLUMNWISE:
            return SparseMatrix.from_coo(h[sp.row], sp.col,
                                         v[sp.row] * sp.data,
                                         (self._S, A.width))
        return SparseMatrix.from_coo(sp.row, h[sp.col], v[sp.col] * sp.data,
                                     (A.height, self._S))


@register
class CWT(HashTransform):
    """Clarkson-Woodruff CountSketch: ±1 values."""

    sketch_type = "CWT"

    @seeded
    def _value_stream(self, dtype, device, lo=0, hi=None):
        return randgen.stream_slice(self.subkey(1), randgen.Rademacher(), lo,
                                    self._N if hi is None else hi, dtype,
                                    device)

    def _kernel_serves(self, A):
        return cuda_hash.supported(A.dtype)

    def _apply_sparse_dense_out(self, A, device, rowwise: bool):
        """The CSR-lane CountSketch of A's kept device CSR, by the route
        that ``sparse_serve.cwt_sparse_lane`` chooses."""
        return sparse_serve.cwt_sparse_lane(
            self._alloc.key, *A.csr(device=device), s_dim=self._S,
            rowwise=rowwise, shape=A.shape)


@register
class MMT(HashTransform):
    """Meng-Mahoney transform: CountSketch with Cauchy values (l1)."""

    sketch_type = "MMT"

    @seeded
    def _value_stream(self, dtype, device, lo=0, hi=None):
        return randgen.stream_slice(self.subkey(1), randgen.Cauchy(), lo,
                                    self._N if hi is None else hi, dtype,
                                    device)


@register
class WZT(HashTransform):
    """Woodruff-Zhang transform for lp, p in [1, 2]: values
    ±(1/Exp(1))^(1/p), the sign from a Rademacher stream (sub-stream 2)."""

    sketch_type = "WZT"

    def __init__(self, N, S, context, p: float = 2.0):
        if p < 1 or p > 2:
            raise errors.InvalidParametersError(
                "WZT parameter p has to be in [1, 2]")
        self._p = float(p)
        super().__init__(N, S, context)

    @seeded
    def _value_stream(self, dtype, device, lo=0, hi=None):
        hi = self._N if hi is None else hi
        e = randgen.stream_slice(self.subkey(1), randgen.Exponential(), lo,
                                 hi, dtype, device)
        pm = randgen.stream_slice(self.subkey(2), randgen.Rademacher(), lo,
                                  hi, dtype, device)
        return pm * torch.pow(1.0 / e, 1.0 / self._p)

    def _extra_params(self) -> dict[str, Any]:
        return {"P": self._p}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, p=float(d.get("P", 2.0)))
