"""Sketch application over mesh-distributed sparse matrices (the port of
libskylark_tpu/sketch/dist_sparse_apply.py; libSkylark's CombBLAS hash
specializations, sketch/hash_transform_CombBLAS.hpp, and the mixed
sparse-input dense transform, sketch/dense_transform_Mixed.hpp).

Each rank contracts its own cell (base/dist_sparse.py) — hash transforms
by an O(nnz) scatter into the bucket dimension, UST by gathering the
sampled rows or columns, dense transforms against the panel of the
virtual operator S at the cell's global offset (``_cell_panel``) — then
one ``all_reduce`` over the mesh dimension that carries the sketched
dimension sums the cells, and one over the kept dimension assembles the
result: the whole dense result on every rank.

Routes of a cell: CWT in float32 takes kernel B3 (sketch/cuda_sparse.py)
on the cell's triplets at their global coordinate on the hashed axis,
bit-stable on the card; its plain version on the CPU. MMT, WZT and other
dtypes take ``index_add_``, whose CUDA atomics add in no fixed order (as
sketch/hash.py says of the single-process scatter). The dense transforms
contract the cell by ``spmm`` against their panel (cuSPARSE on the card),
as the single-process sparse branch does: the reference's distributed
applies are XLA scatters and segment sums, not Pallas kernels.
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.dist_sparse import DistSparseMatrix
from libskylark_tpu_torch.base.sparse import spmm, spmm_t


def _check_dim(T, D: DistSparseMatrix, columnwise: bool) -> None:
    n = D.height if columnwise else D.width
    if n != T.input_dim:
        raise errors.SketchError(
            f"{'columnwise' if columnwise else 'rowwise'} apply expects "
            f"{T.input_dim} on the sketched dimension, got {D.shape}")


def _columnwise_out(D, part: torch.Tensor) -> torch.Tensor:
    """A cell's (s, bs_c) columnwise partial summed over ``row_axis`` and
    assembled over ``col_axis``: the (s, w) result on every rank."""
    out = D._assemble(part.T.contiguous(), D.cb, D.bs_c, D.row_axis,
                      D.col_axis, D.pc)
    return out[: D.width].T.contiguous()


def _rowwise_out(D, part: torch.Tensor) -> torch.Tensor:
    """A cell's (bs_r, s) rowwise partial summed over ``col_axis`` and
    assembled over ``row_axis``: the (h, s) result on every rank."""
    return D._assemble(part, D.rb, D.bs_r, D.col_axis, D.row_axis,
                       D.pr)[: D.height]


def _cell_triplets(D: DistSparseMatrix):
    """This rank's (rows, cols, values) in CSR row-major order, local
    coordinates, on its device."""
    from libskylark_tpu_torch.sketch.sparse_serve import csr_row_ids

    val, idx, ptr = D.cell.csr(device=D.device)
    return csr_row_ids(ptr, val.shape[0]), idx.long(), val


# ---------------------------------------------------------------------------
# hash transforms (CWT / MMT / WZT)
# ---------------------------------------------------------------------------


def _hash_cell(T, D: DistSparseMatrix, columnwise: bool) -> torch.Tensor:
    """The cell's CountSketch partial: (s, bs_c) columnwise, (bs_r, s)
    rowwise, hashing each nonzero by its global coordinate on the
    sketched axis."""
    from libskylark_tpu_torch.sketch import cuda_sparse
    from libskylark_tpu_torch.sketch.hash import CWT

    s = T.sketch_dim
    r, c, v = _cell_triplets(D)
    if columnwise:
        r = r + D.rb * D.bs_r
        shape = (T.input_dim, D.bs_c)
    else:
        c = c + D.cb * D.bs_c
        shape = (D.bs_r, T.input_dim)
    if type(T) is CWT and cuda_sparse.supported(v.dtype):
        return cuda_sparse.cwt_sparse_apply(
            T.allocation.key, v, r.int(), c.int(), s, not columnwise, shape)
    h = T.bucket_indices(D.device)
    vs = T.values(v.dtype, D.device)
    if columnwise:
        flat = torch.zeros(s * D.bs_c, dtype=v.dtype, device=D.device)
        flat.index_add_(0, h[r] * D.bs_c + c, vs[r] * v)
        return flat.view(s, D.bs_c)
    flat = torch.zeros(D.bs_r * s, dtype=v.dtype, device=D.device)
    flat.index_add_(0, r * s + h[c], vs[c] * v)
    return flat.view(D.bs_r, s)


def hash_columnwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """S·A for A (N, w) distributed sparse → (S_dim, w) on every rank."""
    _check_dim(T, D, columnwise=True)
    return _columnwise_out(D, _hash_cell(T, D, columnwise=True))


def hash_rowwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """A·Sᵀ for A (m, N) distributed sparse → (m, S_dim) on every rank."""
    _check_dim(T, D, columnwise=False)
    return _rowwise_out(D, _hash_cell(T, D, columnwise=False))


def hash_apply_sparse(T, D: DistSparseMatrix, columnwise: bool = True
                      ) -> DistSparseMatrix:
    """Sparse → sparse distributed hash apply (the reference's SpParMat →
    SpParMat path). A hash sketch maps each nonzero 1:1 — columnwise
    (r, c, v) → (h[r], c, vs[r]·v) — so each rank rewrites its cell's
    triplets with no arithmetic; the cells along the sketched axis then
    merge into one bucket block, gathered to each rank of that axis
    (all-reduce of zero-padded triplet buffers: one writer a slot, a
    copy), leaving a :class:`DistSparseMatrix` distributed on the kept
    axis only. Colliding entries are summed when the merged cell is
    built."""
    from libskylark_tpu_torch.base.dist_sparse import _gather

    _check_dim(T, D, columnwise=columnwise)
    dev = D.device
    h = T.bucket_indices(dev)
    vs = T.values(D.dtype, dev)
    lr, lc, v = D.lr.long(), D.lc.long(), D.v
    if columnwise:
        g = D.rb * D.bs_r + lr
        lr = h[g]
        merged, own, extent = D.row_axis, D.rb, D.pr
    else:
        g = D.cb * D.bs_c + lc
        lc = h[g]
        merged, own, extent = D.col_axis, D.cb, D.pc
    v = vs[g] * v
    if extent > 1:
        lr, lc, v = _gather(D.mesh, (merged,), own, extent, (lr, lc, v))
    if columnwise:
        return DistSparseMatrix(D.mesh, None, D.col_axis,
                                (T.sketch_dim, D.width), lr.int(), lc.int(),
                                v)
    return DistSparseMatrix(D.mesh, D.row_axis, None,
                            (D.height, T.sketch_dim), lr.int(), lc.int(), v)


# ---------------------------------------------------------------------------
# UST (row/column sampling): each cell gathers its sampled rows or columns
# ---------------------------------------------------------------------------


def _sampled(val, idx, ptr, slots: torch.Tensor, first: int, size: int):
    """For each sampled slot t whose coordinate falls in [first, first +
    size), the entries of that row of the CSR (val, idx, ptr): (slot of
    each entry, its column, its value)."""
    local = slots - first
    t = torch.nonzero((local >= 0) & (local < size)).flatten()
    rows = local[t]
    starts, lens = ptr[rows].long(), (ptr[rows + 1] - ptr[rows]).long()
    slot = torch.repeat_interleave(t, lens)
    within = (torch.arange(slot.numel(), device=val.device)
              - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    at = torch.repeat_interleave(starts, lens) + within
    return slot, idx[at].long(), val[at]


def ust_columnwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """S·A = A[idx, :] for A (N, w) distributed sparse → (S_dim, w) on
    every rank; every slot t with idx[t] == r receives row r
    (with-replacement duplicates included)."""
    _check_dim(T, D, columnwise=True)
    val, idx, ptr = D.cell.csr(device=D.device)
    slot, col, v = _sampled(val, idx, ptr, T.sample_indices(D.device),
                            D.rb * D.bs_r, D.bs_r)
    part = torch.zeros((T.sketch_dim, D.bs_c), dtype=D.dtype,
                       device=D.device)
    part[slot, col] = v
    return _columnwise_out(D, part)


def ust_rowwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """A·Sᵀ = A[:, idx] for A (m, N) distributed sparse → (m, S_dim) on
    every rank."""
    _check_dim(T, D, columnwise=False)
    val, idx, ptr = D.cell.csr_t(device=D.device)
    slot, row, v = _sampled(val, idx, ptr, T.sample_indices(D.device),
                            D.cb * D.bs_c, D.bs_c)
    part = torch.zeros((D.bs_r, T.sketch_dim), dtype=D.dtype,
                       device=D.device)
    part[row, slot] = v
    return _rowwise_out(D, part)


# ---------------------------------------------------------------------------
# dense transforms (JLT / CT, and the random features' projection W)
# ---------------------------------------------------------------------------


def _cell_panel(T, block_start: int, width: int, dtype, device):
    """Columns [block_start, block_start + width) of the transform's
    virtual operator (S, or an RFT's frequency matrix W): each rank makes
    only its own (S_dim × width) window, from the blocks that cover it."""
    panel = T.w_panel if hasattr(T, "w_panel") else T.s_panel
    return panel(block_start, block_start + width, dtype, device)


def dense_rowwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """A·Sᵀ for A (m, N) distributed sparse → (m, S_dim) on every rank;
    the contraction over the col axis rides one all-reduce."""
    _check_dim(T, D, columnwise=False)
    P = _cell_panel(T, D.cb * D.bs_c, D.bs_c, D.dtype, D.device)
    return _rowwise_out(D, spmm(D.cell, P.T))


def dense_columnwise(T, D: DistSparseMatrix) -> torch.Tensor:
    """S·A for A (N, w) distributed sparse → (S_dim, w) on every rank."""
    _check_dim(T, D, columnwise=True)
    P = _cell_panel(T, D.rb * D.bs_r, D.bs_r, D.dtype, D.device)
    return _columnwise_out(D, spmm_t(D.cell, P.T).T)
