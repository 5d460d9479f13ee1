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
``apply_sparse`` gives a sparse result, on the host. Distributed sparse
operands are not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch import cuda_hash, cuda_sparse, sparse_serve
from libskylark_tpu_torch.sketch.transform import SketchTransform, register


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

    def _value_stream(self, dtype, device) -> torch.Tensor:
        """Per-coordinate values v[0:N]; overridden per transform."""
        raise NotImplementedError

    def bucket_indices(self, device=None) -> torch.Tensor:
        """h[0:N], the bucket of each input coordinate (sub-stream 0)."""
        return randgen.stream_slice(
            self.subkey(0), randgen.UniformInt(0, self._S - 1), 0, self._N,
            device=device)

    def values(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return self._value_stream(dtype, device)

    def _kernel_serves(self, A: torch.Tensor) -> bool:
        return False

    def _apply(self, A: torch.Tensor, rowwise: bool) -> torch.Tensor:
        if self._kernel_serves(A):
            return cuda_hash.cwt_apply(self._alloc.key, A.contiguous(),
                                       self._S, rowwise)
        h = self.bucket_indices(A.device)
        v = self.values(A.dtype, A.device)
        return cuda_hash.scatter(h, v, A, self._S, rowwise)

    def _apply_columnwise(self, A):
        return self._apply(A, rowwise=False)

    def _apply_rowwise(self, A):
        return self._apply(A, rowwise=True)

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

    def apply_sparse(self, A, dimension=None):
        """Sparse → sparse apply on the host: a :class:`SparseMatrix` with
        duplicates summed, equal elementwise to ``apply``'s dense
        result."""
        from libskylark_tpu_torch.base.sparse import SparseMatrix, as_sparse
        from libskylark_tpu_torch.sketch.transform import COLUMNWISE

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

    def _value_stream(self, dtype, device):
        return randgen.stream_slice(self.subkey(1), randgen.Rademacher(), 0,
                                    self._N, dtype, device)

    def _kernel_serves(self, A):
        return cuda_hash.supported(A.dtype)

    def _apply_sparse_dense_out(self, A, device, rowwise: bool):
        """The CSR-lane CountSketch: float32 through the kernel's route,
        other dtypes through the plain CSR-order scatter."""
        data, indices, indptr = (torch.tensor(x, device=device)
                                 for x in A.csr_parts())
        rows = sparse_serve.csr_row_ids(indptr, data.shape[0])
        if cuda_sparse.supported(data.dtype):
            return cuda_sparse.cwt_sparse_apply(
                self._alloc.key, data, rows, indices, self._S, rowwise,
                A.shape)
        return sparse_serve.cwt_scatter_rows(
            self._alloc.key, data, rows, indices, s_dim=self._S,
            rowwise=rowwise, shape=A.shape)


@register
class MMT(HashTransform):
    """Meng-Mahoney transform: CountSketch with Cauchy values (l1)."""

    sketch_type = "MMT"

    def _value_stream(self, dtype, device):
        return randgen.stream_slice(self.subkey(1), randgen.Cauchy(), 0,
                                    self._N, dtype, device)


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

    def _value_stream(self, dtype, device):
        e = randgen.stream_slice(self.subkey(1), randgen.Exponential(), 0,
                                 self._N, dtype, device)
        pm = randgen.stream_slice(self.subkey(2), randgen.Rademacher(), 0,
                                  self._N, dtype, device)
        return pm * torch.pow(1.0 / e, 1.0 / self._p)

    def _extra_params(self) -> dict[str, Any]:
        return {"P": self._p}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, p=float(d.get("P", 2.0)))
