"""Sketch transforms on a mesh-distributed dense operand: the routes of
``SketchTransform.apply`` for a DTensor (parallel/mesh.py).

The route follows the placement of the sketched axis, the one the
transform contracts (A's rows columnwise, its columns rowwise):

- **not split** (rowwise on Shard(0), columnwise on Shard(1), or split
  only over mesh dimensions of one rank): each rank runs the one-process
  apply on its block, so the kernel that apply launches (B1, B1-cos, B2,
  B4, B5), with no collective;
- **split**: each rank takes its partial against its own columns of S,
  at its block's global offset (``_split_axis_apply`` of the transform),
  then one all_reduce over each mesh dimension that splits the axis,
  then the transform's epilogue on the sum:

  ================  ==================================================
  JLT, CT           B1's partial kernel; the scale
  CWT, MMT, WZT     B2 with ``n0`` (CWT in float32), else the scatter on
                    the sliced streams
  UST               the gather of the rank's own samples
  RFT family        B1's partial kernel (or W's panel); inscale, shifts,
                    per-feature scales, cos (exp) and outscale
  QRFT family       the columns [lo, hi) of W's quasi-random panel; the
                    shifts, cos (exp) and outscale
  PPT               each CountSketch's B2 at ``n0``, the q partials
                    reduced as one stacked tensor; the lift (once, on
                    the sum), the FFT product
  ================  ==================================================

- **a mixer that needs the whole axis** (FJLT, RFUT, Fastfood: the
  transforms that derive from :class:`WholeAxis`): one all-to-all
  (``parallel.mesh._exchange``) first moves the split to the kept axis,
  then each rank runs the one-process apply on its block (B5 for the
  SRHT, B4 for Fastfood); the result keeps the new split
  (:func:`apply_whole_axis`).

The result is a DTensor: the kept axis keeps its placement, the sketch
axis is Replicate(). Every transform of the reference's set has a route;
one outside it with no ``_split_axis_apply`` raises
NotImplementedYetError.
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


def apply_whole_axis(T, A, rowwise: bool):
    """T·A or A·Tᵀ of the DTensor ``A`` for a transform whose mixer needs
    the whole sketched axis: where that axis is split, one all-to-all
    moves the split to the kept axis (Shard(0) → Shard(1) columnwise,
    the layout change XLA's partitioner inserts), then each rank runs
    the one-process apply on its block (:func:`apply`)."""
    from torch.distributed.tensor import Shard

    pmesh._check_placements(A)
    A = _matrix(A, rowwise)
    seq = 1 if rowwise else 0
    if split_dims(A, seq):
        A = pmesh._exchange(A, [Shard(1 - seq) if p.is_shard(seq) else p
                                for p in A.placements])
    return apply(T, A, rowwise)


class WholeAxis:
    """Mixin of the transforms whose mixer needs the whole sketched axis
    (FJLT, RFUT, Fastfood): their DTensor apply is
    :func:`apply_whole_axis`."""

    def _apply_columnwise_dtensor(self, A):
        return apply_whole_axis(self, A, rowwise=False)

    def _apply_rowwise_dtensor(self, A):
        return apply_whole_axis(self, A, rowwise=True)
