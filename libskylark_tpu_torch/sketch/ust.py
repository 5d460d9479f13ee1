"""Uniform sampling transform (UST): S is a row-sampling operator (the
port of libskylark_tpu/sketch/ust.py).

With replacement: S_dim independent uniform indices (sub-stream 0).
Without: the first S_dim entries of ``randgen.permutation`` of [0, N)
under sub-stream 1, jax.random.permutation's own shuffle. A sparse
operand is gathered on the host (sampling keeps it sparse) and the small
sampled result densified on the device; a distributed sparse operand
gathers each rank's sampled rows or columns of its cell
(sketch/dist_sparse_apply.py); a DTensor split on the sampled axis
gathers each rank's own samples, then an all-reduce of the disjoint
parts (sketch/dtensor_apply.py).
"""

from __future__ import annotations

from typing import Any

import torch

from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.sketch.transform import (SketchTransform, register,
                                                   seeded)


@register
class UST(SketchTransform):
    sketch_type = "UST"

    def __init__(self, N, S, context, replace: bool = True):
        self._replace = bool(replace)
        super().__init__(N, S, context)

    @seeded
    def sample_indices(self, device=None) -> torch.Tensor:
        """The S_dim sampled coordinates, int64."""
        if self._replace:
            return randgen.stream_slice(
                self.subkey(0), randgen.UniformInt(0, self._N - 1), 0,
                self._S, device=device)
        return randgen.permutation(self.subkey(1), self._N,
                                   device)[: self._S]

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        return A.index_select(0, self.sample_indices(A.device))

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        return A.index_select(1, self.sample_indices(A.device))

    def _split_axis_apply(self, A_loc, lo, rowwise, reduce):
        """The samples that fall in this rank's coordinates [lo, lo + n)
        gathered, zeros elsewhere, summed over the ranks: each sample has
        one writer, so the sum is exact."""
        seq = 1 if rowwise else 0
        n = A_loc.shape[seq]
        idx = self.sample_indices(A_loc.device)
        sel = ((idx >= lo) & (idx < lo + n)).nonzero().flatten()
        shape = list(A_loc.shape)
        shape[seq] = self._S
        out = A_loc.new_zeros(shape)
        out.index_copy_(seq, sel, A_loc.index_select(seq, idx[sel] - lo))
        return reduce(out)

    def _sampled_sparse(self, A, device, rowwise: bool) -> torch.Tensor:
        idx = self.sample_indices(device).cpu().numpy()
        M = A.to_scipy()
        M = M[:, idx] if rowwise else M[idx, :]
        return torch.as_tensor(M.toarray().astype(A.device_dtype),
                               device=device)

    def _apply_columnwise_sparse(self, A, device) -> torch.Tensor:
        return self._sampled_sparse(A, device, rowwise=False)

    def _apply_rowwise_sparse(self, A, device) -> torch.Tensor:
        return self._sampled_sparse(A, device, rowwise=True)

    def _apply_columnwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.ust_columnwise(self, A)

    def _apply_rowwise_dist_sparse(self, A) -> torch.Tensor:
        from libskylark_tpu_torch.sketch import dist_sparse_apply as dsa

        return dsa.ust_rowwise(self, A)

    def _extra_params(self) -> dict[str, Any]:
        return {"replace": self._replace}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, replace=bool(d.get("replace", True)))
