"""Sketch transforms on a mesh-distributed dense operand: the routes of
``SketchTransform.apply`` for a DTensor (parallel/mesh.py).

The route follows the placement of the sketched axis, the one the
transform contracts (A's rows columnwise, its columns rowwise):

- **not split** (rowwise on Shard(0), columnwise on Shard(1), or split
  only over mesh dimensions of one rank): each rank runs the one-process
  apply on its block, so the kernel that apply launches (B1, B1-cos, B2,
  B4, B5), with no collective;
- **split**: each rank takes its partial against its own columns of S,
  at its block's global offset (``_split_axis_apply`` of the transform:
  B1's partial kernel, B2 with ``n0``, the hash scatter on the sliced
  streams, UST's gather of its own samples), then one all_reduce over
  each mesh dimension that splits the axis, then the transform's
  epilogue on the sum (the scale; the RFTs' shift, cos and outscale).
  FJLT's mixer needs the whole axis instead: it first moves the split to
  the kept axis by one all-to-all (fjlt.py).

The result is a DTensor: the kept axis keeps its placement, the sketch
axis is Replicate(). A transform with no split-axis route raises
NotImplementedYetError naming ROADMAP A5b.
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.parallel import mesh as pmesh


def split_dims(A, axis: int) -> tuple:
    """The mesh dimensions of more than one rank that split ``A``'s
    tensor dimension ``axis``."""
    mesh = A.device_mesh
    return tuple(i for i, p in enumerate(A.placements)
                 if p.is_shard(axis) and mesh.size(i) > 1)


def _matrix(A, rowwise: bool):
    """A 1-D DTensor as the one-process apply reads a vector: a column
    (columnwise) or a row (rowwise), no traffic."""
    if A.ndim == 2:
        return A
    from torch.distributed.tensor import Shard

    loc, n = A.to_local(), A.shape[0]
    if rowwise:
        pl = [Shard(1) if p.is_shard(0) else p for p in A.placements]
        return pmesh._from_local(loc[None, :], A.device_mesh, pl, (1, n))
    return pmesh._from_local(loc[:, None], A.device_mesh, A.placements,
                             (n, 1))


def apply(T, A, rowwise: bool):
    """T·A (columnwise) or A·Tᵀ (rowwise) of the DTensor ``A`` by the
    route of its sketched axis (module docstring)."""
    from torch.distributed.tensor import Replicate

    pmesh._check_placements(A)
    A = _matrix(A, rowwise)
    seq = 1 if rowwise else 0
    if A.shape[seq] != T.input_dim:
        raise errors.SketchError(
            f"{'rowwise' if rowwise else 'columnwise'} apply expects "
            f"{T.input_dim} {'cols' if rowwise else 'rows'}, got "
            f"{tuple(A.shape)}")
    mesh = A.device_mesh
    split = split_dims(A, seq)
    A_loc, lo = pmesh._local_block(A, seq)
    if not split and 0 in A_loc.shape:
        # torch's split leaves the last ranks empty: nothing to sketch
        out = A_loc.new_zeros((A_loc.shape[0], T.sketch_dim) if rowwise
                              else (T.sketch_dim, A_loc.shape[1]))
    elif not split:
        out = T._apply_rowwise(A_loc) if rowwise else T._apply_columnwise(
            A_loc)
    else:
        out = T._split_axis_apply(
            A_loc, lo, rowwise, lambda t: pmesh._reduce_partial(t, mesh,
                                                               split))
    shape = ((A.shape[0], T.sketch_dim) if rowwise
             else (T.sketch_dim, A.shape[1]))
    placements = [Replicate() if p.is_shard(seq) else p
                  for p in A.placements]
    return pmesh._from_local(out, mesh, placements, shape)
