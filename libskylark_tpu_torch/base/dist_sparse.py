"""Mesh-distributed sparse matrix (the port of
libskylark_tpu/base/dist_sparse.py): the reference's P4/P5 strategies,
libSkylark's ``sparse_dist_matrix_t`` and the CombBLAS 2D grid.

The nonzeros are partitioned by (row-block × col-block) cell over a 1D or
2D process mesh (parallel/mesh.py): row blocks of ceil(h/pr) rows over
the mesh dimension ``row_axis``, column blocks of ceil(w/pc) over
``col_axis`` (either may be None: one block; a mesh dimension that names
no axis holds copies). Each rank keeps only its own cell, its triplets
``lr``, ``lc``, ``v`` in local coordinates on its device, and the cell
as a local :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` for
its products: cuSPARSE on the card, the CSC-order scatter on the CPU
(base/sparse.py), never a densified cell.

Products are a local product and then an ``all_reduce`` over the
contracted dimension's group (libSkylark's local gemm + all_reduce,
base/Gemm.hpp:84-103). Every result is the whole dense value on every
rank: each rank writes its block into a zero-padded result and one more
``all_reduce`` over the kept dimension assembles it (gloo carries
``all_reduce`` of CUDA tensors, which lets two processes share a card).
So the solvers downstream run unchanged on plain tensors. Dense operands
enter whole on every rank; each rank slices its block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.sparse import SparseMatrix, spmm, spmm_t
from libskylark_tpu_torch.parallel import mesh as pmesh


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _gather(mesh, axes, slot: int, slots: int, tensors):
    """Every rank's 1-D ``tensors`` (one length within a rank) on every
    rank, in slot order: each rank writes its own into slot ``slot`` of
    a zero-padded (slots, pad) buffer and all-reduces it over ``axes``
    (one writer a slot, so the sum is a copy; gloo carries all-reduce of
    CUDA tensors)."""
    dev = tensors[0].device
    n = torch.zeros(slots, dtype=torch.int64, device=dev)
    n[slot] = tensors[0].numel()
    for ax in axes:
        pmesh.all_reduce(n, mesh, ax)
    pad = max(int(n.max()), 1)
    keep = torch.arange(pad, device=dev)[None, :] < n[:, None]
    out = []
    for t in tensors:
        b = torch.zeros((slots, pad), dtype=t.dtype, device=dev)
        b[slot, : t.numel()] = t
        for ax in axes:
            pmesh.all_reduce(b, mesh, ax)
        out.append(b[keep])
    return out


class DistSparseMatrix:
    """Sparse (h × w) matrix distributed over a mesh grid (see the module
    docstring). Construct with :func:`distribute_sparse`; ``lr``, ``lc``
    and ``v`` are this rank's cell's triplets (local row, local column,
    value), in the order of the global matrix's CSC storage."""

    def __init__(self, mesh, row_axis: Optional[str],
                 col_axis: Optional[str], shape: Tuple[int, int],
                 lr: torch.Tensor, lc: torch.Tensor, v: torch.Tensor):
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis
        self._shape = (int(shape[0]), int(shape[1]))
        self.pr = pmesh.axis_size(mesh, row_axis)
        self.pc = pmesh.axis_size(mesh, col_axis)
        self.bs_r = _ceil_div(self._shape[0], self.pr)
        self.bs_c = _ceil_div(self._shape[1], self.pc)
        self.rb = pmesh.axis_index(mesh, row_axis)
        self.cb = pmesh.axis_index(mesh, col_axis)
        self.lr, self.lc, self.v = lr, lc, v
        self.cell = SparseMatrix.from_coo(
            lr.cpu().numpy(), lc.cpu().numpy(), v.cpu().numpy(),
            (self.bs_r, self.bs_c))

    # -- queries --

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def height(self) -> int:
        return self._shape[0]

    @property
    def width(self) -> int:
        return self._shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.v.dtype

    @property
    def tensor_dtype(self) -> torch.dtype:
        return self.v.dtype

    @property
    def device(self) -> torch.device:
        """This rank's device: where its cell and every result live."""
        return self.v.device

    def _axes(self):
        """(row axis, col axis): the mesh dimensions the grid uses."""
        return self.row_axis, self.col_axis

    def _assemble(self, part: torch.Tensor, block: int, size: int,
                  contract: Optional[str], keep: Optional[str],
                  extent: int) -> torch.Tensor:
        """Sum ``part`` over ``contract``, then place it as block
        ``block`` (of ``size`` rows) of a zero (extent·size, k) result and
        sum that over ``keep``: the whole value on every rank."""
        pmesh.all_reduce(part, self.mesh, contract)
        if extent == 1:
            return part
        out = torch.zeros((extent * size, part.shape[1]), dtype=part.dtype,
                          device=part.device)
        out[block * size:(block + 1) * size] = part
        return pmesh.all_reduce(out, self.mesh, keep)

    def _operand(self, B, rows: int, name: str):
        B = torch.as_tensor(B, device=self.device)
        squeeze = B.ndim == 1
        if squeeze:
            B = B[:, None]
        if B.shape[0] != rows:
            raise errors.InvalidParametersError(
                f"{name}: A is {self._shape}, B is {tuple(B.shape)}")
        return B.to(self.dtype), squeeze

    @staticmethod
    def _block(B: torch.Tensor, block: int, size: int) -> torch.Tensor:
        """Rows [block·size, (block + 1)·size) of B, zero-padded past its
        end."""
        lo = min(block * size, B.shape[0])
        hi = min(lo + size, B.shape[0])
        seg = B[lo:hi]
        if hi - lo == size:
            return seg
        return torch.nn.functional.pad(seg, (0, 0, 0, size - (hi - lo)))

    # -- conversions --

    def to_local(self) -> SparseMatrix:
        """The whole matrix as a local :class:`SparseMatrix` on every rank
        (the CIRC_CIRC analog; a collective): every cell's triplets in
        global coordinates."""
        r, c, v = (t.cpu().numpy() for t in _gather(
            self.mesh, self._axes(), self.rb * self.pc + self.cb,
            self.pr * self.pc, (self.lr.long() + self.rb * self.bs_r,
                                self.lc.long() + self.cb * self.bs_c,
                                self.v)))
        keep = v != 0
        return SparseMatrix.from_coo(r[keep], c[keep], v[keep], self._shape)

    def todense(self, device=None) -> torch.Tensor:
        """The dense (h, w) value on every rank (a collective); on
        ``device`` when given, else this rank's device."""
        dev = self.device
        out = torch.zeros((self.pr * self.bs_r, self.pc * self.bs_c),
                          dtype=self.dtype, device=dev)
        out[self.rb * self.bs_r:(self.rb + 1) * self.bs_r,
            self.cb * self.bs_c:(self.cb + 1) * self.bs_c] = \
            self.cell.todense(self.dtype, dev)
        for ax in self._axes():
            pmesh.all_reduce(out, self.mesh, ax)
        out = out[: self.height, : self.width]
        return out if device is None else out.to(device)

    # -- products --

    def spmm(self, B) -> torch.Tensor:
        """A @ B, B dense (w, k) or a vector on every rank → (h, k) on
        every rank: each cell against its B row block, all-reduce over
        ``col_axis``, blocks assembled over ``row_axis``."""
        B, squeeze = self._operand(B, self.width, "spmm")
        part = spmm(self.cell, self._block(B, self.cb, self.bs_c))
        out = self._assemble(part, self.rb, self.bs_r, self.col_axis,
                             self.row_axis, self.pr)[: self.height]
        return out[:, 0] if squeeze else out

    def spmm_t(self, B) -> torch.Tensor:
        """Aᵀ @ B, B dense (h, k) or a vector on every rank → (w, k) on
        every rank (the Gram-type product; all-reduce over ``row_axis``)."""
        B, squeeze = self._operand(B, self.height, "spmm_t")
        part = spmm_t(self.cell, self._block(B, self.rb, self.bs_r))
        out = self._assemble(part, self.cb, self.bs_c, self.row_axis,
                             self.col_axis, self.pc)[: self.width]
        return out[:, 0] if squeeze else out

    def compact(self, utilization_threshold: float = 0.5
                ) -> "DistSparseMatrix":
        """The reference shrinks the padded slots of its uniform per-cell
        arrays here; a rank of the port keeps exactly its cell's
        nonzeros, so there is nothing to shrink: returns ``self``."""
        return self

    def transpose(self) -> "DistSparseMatrix":
        """Aᵀ — a relabeling: the grid axes and local coordinates swap,
        and each cell is its transpose (base/sparse.py's kept one)."""
        out = DistSparseMatrix.__new__(DistSparseMatrix)
        out.mesh, out.row_axis, out.col_axis = (self.mesh, self.col_axis,
                                                self.row_axis)
        out._shape = (self.width, self.height)
        out.pr, out.pc, out.bs_r, out.bs_c = (self.pc, self.pr, self.bs_c,
                                              self.bs_r)
        out.rb, out.cb = self.cb, self.rb
        out.lr, out.lc, out.v = self.lc, self.lr, self.v
        out.cell = self.cell.transpose()
        return out

    @property
    def T(self) -> "DistSparseMatrix":
        return self.transpose()

    def __repr__(self) -> str:
        return (f"DistSparseMatrix({self.height}x{self.width}, "
                f"grid={self.pr}x{self.pc}, cell_nnz={self.v.numel()}, "
                f"axes=({self.row_axis}, {self.col_axis}))")


def distribute_sparse(A, mesh, row_axis: Optional[str] = None,
                      col_axis: Optional[str] = None) -> DistSparseMatrix:
    """Partition a local :class:`SparseMatrix` (or scipy sparse matrix),
    which every rank passes whole, onto the mesh grid: each rank keeps the
    triplets of its own cell, by index arithmetic (libSkylark's
    queue_update/finalize bulk construction), in local coordinates on its
    device, the values at the matrix's device dtype (float64 lands as
    float32, the package's precision policy)."""
    from libskylark_tpu_torch.base.sparse import as_sparse

    if row_axis is None and col_axis is None:
        raise errors.InvalidParametersError(
            "distribute_sparse needs at least one mesh axis")
    A = as_sparse(A)
    pr = pmesh.axis_size(mesh, row_axis)
    pc = pmesh.axis_size(mesh, col_axis)
    h, w = A.shape
    bs_r, bs_c = _ceil_div(h, pr), _ceil_div(w, pc)
    rb = pmesh.axis_index(mesh, row_axis)
    cb = pmesh.axis_index(mesh, col_axis)
    sp = A.to_scipy().tocoo()
    rows = np.asarray(sp.row, dtype=np.int64)
    cols = np.asarray(sp.col, dtype=np.int64)
    mine = (rows // bs_r == rb) & (cols // bs_c == cb)
    dev = pmesh._mesh_device(mesh)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    return DistSparseMatrix(
        mesh, row_axis, col_axis, (h, w),
        put(rows[mine] - rb * bs_r, np.int32),
        put(cols[mine] - cb * bs_c, np.int32),
        put(np.asarray(sp.data)[mine], np.dtype(A.device_dtype)))
