"""Sequence-parallel sketch application: the explicit panel pipeline (the
port of libskylark_tpu/parallel/shard_apply.py).

The long axis N of A is split over the ranks along one mesh dimension;
each rank contracts only its own shard against its own column blocks of
the virtual operator S — generated from (seed, counter), never at full
size — and one ``all_reduce`` over the dimension's group sums the
partials (the reference's local gemm + all_reduce, libSkylark's
base/Gemm.hpp:84-103). Memory per rank: its shard and its output.

N is zero-padded to a multiple of p·BLOCK_COLS and rank r takes blocks
[r·bps, (r + 1)·bps), bps = padded N / (p·BLOCK_COLS), as the reference's
``shard_map`` in_spec gives them. A takes one of two forms:

- a tensor (or array) every rank holds whole: each rank slices its shard;
- a DTensor sharded on the sequence axis along ``axis``: each rank takes
  its local shard with no copy when the shard is block-aligned (torch's
  even split of N); an unaligned shard is zero-padded at its front to
  its first block, locally. A DTensor in any other layout is gathered
  first (``mesh._whole``).

Routes of a rank's partial, decided before any launch:

- a CUDA shard whose distribution and dtype the dense kernel takes (B1:
  standard Normal, Cauchy, Rademacher; float32) launches the partial
  kernel (``cuda_dense.fused_partial``) at ``block0 = first block``;
  ``use_pallas=False`` on a CUDA tensor raises — no knob routes a CUDA
  tensor past the kernel;
- a CPU shard takes the reference's fallback, the loop of ``s_block``
  products over its blocks in float32, unless ``use_pallas=True`` asks
  for the kernel's route, whose CPU form is the kernel's plain version
  (the regime's product; the reference's interpret mode);
- another distribution or dtype takes the ``s_block`` loop on either
  device.

``interpret`` is accepted for the reference's signature and does nothing
here: the port has no interpreter for its kernels, and a CPU tensor runs
the plain versions. Each rank multiplies its partial by ``T.scale``
before the reduction, as the reference does; every rank returns the whole
result.
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.parallel import mesh as pmesh
from libskylark_tpu_torch.parallel.mesh import ROWS
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS, DenseTransform


def _shard(A, mesh, axis: str, seq_axis: int, N: int):
    """(this rank's shard, its first index on the sequence axis)."""
    p = pmesh.axis_size(mesh, axis)
    r = pmesh.axis_index(mesh, axis)
    step = p * BLOCK_COLS
    bps = -(-N // step)
    dim = mesh.mesh_dim_names.index(axis)
    if pmesh._is_sharded(A):
        from torch.distributed.tensor import Replicate, Shard

        want = [Replicate()] * mesh.ndim
        want[dim] = Shard(seq_axis)
        if A.device_mesh == mesh and list(A.placements) == want:
            return pmesh._local_block(A, seq_axis)
        A = pmesh._whole(A)
    else:
        A = torch.as_tensor(A, device=pmesh._mesh_device(mesh))
    lo = min(r * bps * BLOCK_COLS, N)
    hi = min(lo + bps * BLOCK_COLS, N)
    return A.narrow(seq_axis, lo, hi - lo), lo


def _block_loop(T, A_loc: torch.Tensor, block0: int, seq_axis: int):
    """The reference's fallback partial: Σ_b S_{block0+b} · A_b (or
    A_b · S_bᵀ) over A_loc's 256-wide blocks, in block order, scaled
    (s_block carries T.scale)."""
    columnwise = seq_axis == 0
    m = A_loc.shape[1 - seq_axis]
    acc = torch.zeros((T.sketch_dim, m) if columnwise else (m, T.sketch_dim),
                      dtype=A_loc.dtype, device=A_loc.device)
    for b in range(A_loc.shape[seq_axis] // BLOCK_COLS):
        Sb = T.s_block(block0 + b, A_loc.dtype, A_loc.device)
        seg = A_loc.narrow(seq_axis, b * BLOCK_COLS, BLOCK_COLS)
        acc = acc + (Sb @ seg if columnwise else seg @ Sb.T)
    return acc


def _kernel_route(device_type: str, use_pallas: bool | None,
                  serves: bool) -> bool:
    """Whether a rank's partial takes the kernel's route (module
    docstring): on CUDA whenever the kernel ``serves`` the transform and
    dtype (``use_pallas=False`` raises), on the CPU only when
    ``use_pallas`` asks for it."""
    if device_type == "cuda":
        if use_pallas is False:
            raise errors.InvalidParametersError(
                "use_pallas=False on a CUDA tensor: the partial kernel is "
                "the CUDA route of the sequence-parallel apply")
        return serves
    return bool(use_pallas) and serves


def _aligned(A_loc: torch.Tensor, lo: int, seq_axis: int):
    """(A_loc padded to whole blocks, its first block): zeros in front to
    the block that global index ``lo`` falls in (a shard of torch's
    uneven split), behind to a block multiple."""
    block0 = lo // BLOCK_COLS
    front = lo - block0 * BLOCK_COLS
    n = front + A_loc.shape[seq_axis]
    back = max(-(-n // BLOCK_COLS), 1) * BLOCK_COLS - n
    if front or back:
        pad = [0, 0, 0, 0]
        pad[2 * (1 - seq_axis)] = front
        pad[2 * (1 - seq_axis) + 1] = back
        A_loc = torch.nn.functional.pad(A_loc, pad)
    return A_loc, block0


def _partial(key, dist, s_dim: int, A_loc: torch.Tensor, lo: int,
             seq_axis: int, precision: str | None = None) -> torch.Tensor:
    """A shard's UNSCALED partial against the operator's columns from
    global index ``lo``: B1's partial kernel (its plain version on a CPU
    tensor) on the shard padded to whole blocks."""
    from libskylark_tpu_torch.sketch import cuda_dense

    A_loc, block0 = _aligned(A_loc, lo, seq_axis)
    return cuda_dense.fused_partial(key, dist, A_loc.contiguous(), s_dim,
                                    seq_axis, block0, precision)


def _pipeline(T, A, mesh, axis: str, seq_axis: int,
              use_pallas: bool | None = None,
              interpret: bool = False) -> torch.Tensor:
    """Shared schedule: this rank's partial over its blocks, scaled, then
    one all-reduce over ``axis``'s group (module docstring)."""
    if not isinstance(T, DenseTransform):
        raise errors.UnsupportedError(
            "sequence-parallel apply needs a DenseTransform-backed sketch; "
            f"got {type(T).__name__}")
    N = T.input_dim
    if A.shape[seq_axis] != N:
        raise errors.SketchError(
            f"sequence axis has {A.shape[seq_axis]} entries, transform "
            f"expects {N} (A is {tuple(A.shape)})")
    A_loc, lo = _shard(A, mesh, axis, seq_axis, N)
    if _kernel_route(A_loc.device.type, use_pallas,
                     T._kernel_serves(A_loc)):
        part = T.scale * _partial(T._alloc.key, T.dist, T.sketch_dim, A_loc,
                                  lo, seq_axis)
    else:
        A_loc, block0 = _aligned(A_loc, lo, seq_axis)
        part = _block_loop(T, A_loc, block0, seq_axis)
    return pmesh.all_reduce(part, mesh, axis)


def columnwise(T, A, mesh, axis: str = ROWS,
               use_pallas: bool | None = None,
               interpret: bool = False) -> torch.Tensor:
    """S·A for A (N, m) split on its first (sequence) axis over ``axis``;
    returns the (S_dim, m) result on every rank."""
    return _pipeline(T, A, mesh, axis, seq_axis=0,
                     use_pallas=use_pallas, interpret=interpret)


def rowwise(T, A, mesh, axis: str = ROWS,
            use_pallas: bool | None = None,
            interpret: bool = False) -> torch.Tensor:
    """A·Sᵀ for A (m, N) split on its second (sequence) axis over
    ``axis``; returns the (m, S_dim) result on every rank."""
    return _pipeline(T, A, mesh, axis, seq_axis=1,
                     use_pallas=use_pallas, interpret=interpret)
