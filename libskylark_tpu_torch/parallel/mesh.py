"""Process meshes and placements — the distribution vocabulary (the port of
libskylark_tpu/parallel/mesh.py).

JAX's single controller over a device pool becomes SPMD here: one process
per device under ``torch.distributed`` (join with
:func:`~libskylark_tpu_torch.parallel.multihost.initialize_distributed`),
and a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
group's ranks with dimensions named ``"rows"`` and ``"cols"``. Every
process builds the same mesh; a dimension's process group is the
reference's mesh axis, and ``psum`` over it becomes ``dist.all_reduce`` on
``mesh.get_group(axis)``. A sharded dense tensor is a DTensor.

Correspondence with the reference's layouts (Elemental's, by way of
``NamedSharding``):

=============  ===================================  =========================
Reference      Meaning                              Here
=============  ===================================  =========================
[MC, MR]       2D over the process grid             ``grid2d(mesh)``: Shard(0), Shard(1)
[VC, *]        1D row distribution                  ``row_sharded(mesh)``: Shard(0) on every dim
[*, VR]        1D column distribution               ``col_sharded(mesh)``: Shard(1) on every dim
[*, *]         replicated on all ranks              ``replicated(mesh)``
[CIRC, CIRC]   on one host                          ``to_host``
=============  ===================================  =========================

Mesh devices are of the package default type ("cuda": NCCL groups)
unless a call passes ``device="cpu"`` (gloo), as the tests do.

A DTensor is a first-class operand of the entry points (sketches, QR,
SVD, Krylov, KRR, ADMM, range finders): each rank computes on its own
block (``_local_block``, ``_Blocks``) through the port's kernels, and
where the reference's partitioner would insert a collective the port
issues one on the mesh's groups: ``_reduce_partial`` (one all_reduce per
mesh dimension that splits the contracted axis), ``_Space.gather`` (an
all_gather of a small panel, named at each site) or ``_exchange`` (the
all-to-all that moves a split from one axis to the other;
``_rows_layout`` moves every column split to the rows). Any placement
is taken: rows, columns or both split, on a line or a grid. Every
collective is counted in :data:`collectives`; none gathers a tall
operand but krank's host variants, which pull A whole once as the
reference does. gloo
carries all_reduce of CUDA tensors itself; the other collectives of a
gloo group stage a CUDA tensor through host memory here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import default_device
from libskylark_tpu_torch.kernels import launch

ROWS = "rows"
COLS = "cols"

# Collectives the port issued on a mesh, by kind: calls, and bytes a rank
# put in. A call over a mesh dimension of one rank is not issued and not
# counted.
collectives = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
collective_bytes = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one DTensor placement per mesh dimension (the port's
    ``NamedSharding``)."""

    mesh: object
    placements: tuple


def _world():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise errors.CommunicationError(
            "no process group: call parallel.multihost.initialize_distributed "
            "(or torch.distributed.init_process_group) first")
    return dist


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              devices: Optional[Sequence[int]] = None, *, device=None):
    """A process mesh. Default: 1D over every rank of the group, axis
    ``rows``. ``devices`` lists the mesh's ranks in row-major order (the
    reference's device list; default all ranks), ``shape=(r, c)`` gives
    the 2D grid of Elemental's process grid, and ``device`` the type of
    the mesh's devices (default: the package default device's). Every
    rank of the group calls it with the same arguments; a rank outside
    ``devices`` gets a mesh it has no coordinate in."""
    from torch.distributed.device_mesh import DeviceMesh

    dist = _world()
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if shape is None:
        shape = (len(ranks),)
    if axis_names is None:
        axis_names = (ROWS, COLS)[: len(shape)]
    if math.prod(shape) != len(ranks):
        raise ValueError(
            f"mesh shape {tuple(shape)} does not cover {len(ranks)} ranks")
    kind = torch.device(device if device is not None
                        else default_device()).type
    mesh = DeviceMesh(kind, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))
    if len(shape) > 1:
        # one group over the whole grid, for _exchange; made here, where
        # every rank of the process group calls in the same order
        mesh._skylark_flat = dist.new_group(sorted(ranks))
    return mesh


def square_mesh(devices: Optional[Sequence[int]] = None, *, device=None):
    """Largest (r, c) grid with r·c == ranks and r ≤ c, r maximal — the
    analog of Elemental's default near-square grid."""
    n = len(devices) if devices is not None else _world().get_world_size()
    r = int(np.floor(np.sqrt(n)))
    while n % r:
        r -= 1
    return make_mesh((r, n // r), (ROWS, COLS), devices, device=device)


def _all(mesh, placement) -> Sharding:
    return Sharding(mesh, (placement,) * mesh.ndim)


def row_sharded(mesh) -> Sharding:
    """Rows over *all* mesh dimensions ([VC,*] analog)."""
    from torch.distributed.tensor import Shard

    return _all(mesh, Shard(0))


def col_sharded(mesh) -> Sharding:
    """Columns over *all* mesh dimensions ([*,VR] analog)."""
    from torch.distributed.tensor import Shard

    return _all(mesh, Shard(1))


def grid2d(mesh) -> Sharding:
    """Rows over the first dimension, columns over the second ([MC,MR]
    analog); a 1D mesh gives :func:`row_sharded`."""
    from torch.distributed.tensor import Shard

    if mesh.ndim < 2:
        return row_sharded(mesh)
    return Sharding(mesh, (Shard(0), Shard(1)))


def replicated(mesh) -> Sharding:
    """Every rank holds the whole tensor ([*,*] analog)."""
    from torch.distributed.tensor import Replicate

    return _all(mesh, Replicate())


def vec_sharded(mesh) -> Sharding:
    """A vector sharded over all mesh dimensions."""
    from torch.distributed.tensor import Shard

    return _all(mesh, Shard(0))


def distribute(x, sharding: Sharding):
    """``x`` as a DTensor with ``sharding``: each rank keeps its own piece
    of its own copy of ``x``, no data moves between ranks (the reference's
    ``device_put``, where every host passes the whole array)."""
    import inspect

    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    t = (x if isinstance(x, torch.Tensor)
         else torch.as_tensor(np.asarray(x)))
    t = t.to(_mesh_device(mesh))
    kw = ({"src_data_rank": None}
          if "src_data_rank" in inspect.signature(
              distribute_tensor).parameters else {})
    return distribute_tensor(t, mesh, list(sharding.placements), **kw)


def to_host(x) -> np.ndarray:
    """The whole value on the host ([CIRC,CIRC] analog): a DTensor's
    blocks gathered (``_whole``: a collective, every rank of its mesh
    calls it), any other tensor or array as it is."""
    if _is_sharded(x):
        x = _whole(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def use_mesh(mesh):
    """Context manager exposing ``mesh`` (the reference's ``with mesh:``);
    the port's collectives name their mesh explicitly, so it only yields
    it."""
    yield mesh


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``: the CPU, or the
    current CUDA device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: Optional[str]) -> int:
    """Ranks along mesh dimension ``axis`` (1 for None)."""
    return mesh.size(mesh.mesh_dim_names.index(axis)) if axis else 1


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate along ``axis`` (0 for None): the
    reference's ``lax.axis_index``."""
    return mesh.get_local_rank(axis) if axis else 0


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str],
               op: str = "sum") -> torch.Tensor:
    """Sum ``t`` in place over the ranks along ``axis`` (the reference's
    ``lax.psum``; ``op="max"``: the largest); nothing for None or a
    dimension of one rank. ``axis`` is a dimension's name or index."""
    if axis is None:
        return t
    dim = (mesh.mesh_dim_names.index(axis) if isinstance(axis, str)
           else int(axis))
    if mesh.size(dim) > 1:
        dist = _world()
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(t, op=ops[op], group=mesh.get_group(dim))
        _count("all_reduce", t)
    return t


def _count(kind: str, t: torch.Tensor) -> None:
    launch.count(collectives, kind)
    launch.count(collective_bytes, kind, t.numel() * t.element_size())


# -- DTensor operands -------------------------------------------------------


def _is_sharded(x) -> bool:
    """True for a DTensor: a dense operand laid out over a mesh."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _check_placements(x) -> None:
    if any(not (p.is_shard() or p.is_replicate()) for p in x.placements):
        raise errors.InvalidParametersError(
            f"a DTensor operand must be sharded or replicated on each mesh "
            f"dimension, got {tuple(x.placements)}: redistribute a partial "
            "sum to Replicate() first")
    if x.ndim not in (1, 2):
        raise errors.InvalidParametersError(
            f"a DTensor operand must be a vector or a matrix, got shape "
            f"{tuple(x.shape)}")


def _range(n: int, mesh, placements, dim: int, coord=None) -> tuple:
    """[lo, hi) of tensor dimension ``dim`` (extent n) at mesh coordinate
    ``coord`` (default this rank's): torch's split, mesh dimensions in
    order, each giving ceil(extent/k) entries a rank, the last ranks
    short or empty."""
    lo, size = 0, n
    for i, p in enumerate(placements):
        if not p.is_shard(dim):
            continue
        k = mesh.size(i)
        c = mesh.get_local_rank(i) if coord is None else coord[i]
        chunk = -(-size // k)
        a = min(c * chunk, size)
        lo, size = lo + a, min(a + chunk, size) - a
    return lo, lo + size


def _local_block(x, dim: int) -> tuple:
    """(this rank's block of the DTensor ``x``, its global start on
    tensor dimension ``dim``)."""
    _check_placements(x)
    loc = x.to_local()
    lo, hi = _range(x.shape[dim], x.device_mesh, x.placements, dim)
    if loc.shape[dim] != hi - lo:
        raise errors.InvalidParametersError(
            f"DTensor block of {loc.shape[dim]} entries on dimension {dim}, "
            f"torch's split gives [{lo}, {hi})")
    return loc, lo


def _reduce_partial(t: torch.Tensor, mesh, dims,
                    op: str = "sum") -> torch.Tensor:
    """Sum ``t`` in place over the ranks of each mesh dimension in
    ``dims``: one all_reduce per dimension (of more than one rank) that
    splits the contracted axis."""
    for d in dims:
        all_reduce(t, mesh, d, op)
    return t


def _strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(n)
    return tuple(reversed(out))


def _from_local(t: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose block on this rank is ``t``
    (no traffic)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape), stride=_strides(shape))


def _like(x, t: torch.Tensor):
    """``t`` (the same value on every rank: an identity, a shift vector, a
    scalar, a solution) as a Replicate() DTensor on ``x``'s mesh; ``t``
    itself beside an operand that is no DTensor."""
    if not _is_sharded(x):
        return t
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    return _from_local(t, mesh, [Replicate()] * mesh.ndim, t.shape)


def _transpose(x):
    """xᵀ as a DTensor: the local block transposed (a copy), Shard(0) and
    Shard(1) swapped, no traffic."""
    from torch.distributed.tensor import Shard

    swap = [Shard(1 - p.dim) if p.is_shard() else p for p in x.placements]
    return _from_local(x.to_local().T.contiguous(), x.device_mesh, swap,
                       (x.shape[1], x.shape[0]))


def _stage(t: torch.Tensor, group):
    """(t, back): gloo's all_gather and all_to_all take host tensors here,
    so a CUDA tensor of a gloo group goes through host memory."""
    import torch.distributed as dist

    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), t.device
    return t, None


def _all_gather(t: torch.Tensor, group, k: int) -> list:
    import torch.distributed as dist

    src, back = _stage(t.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(parts, src, group=group)
    _count("all_gather", t)
    return parts if back is None else [p.to(back) for p in parts]


class _Space:
    """One axis of a mesh-distributed operand, as a rank holds it: the
    extent ``n``, the mesh dimensions that split it (``dims``, those of
    more than one rank ``split``), and this rank's [lo, hi). Tensors of
    that space (an operand's rows, a panel living on them) are kept as
    their local rows; a local operand's axis is whole (every method the
    identity)."""

    def __init__(self, n: int, mesh=None, placements=(), dim: int = 0):
        self.n, self.mesh = int(n), mesh
        self.dims = tuple(i for i, p in enumerate(placements)
                          if p.is_shard(dim))
        self.split = tuple(i for i in self.dims if mesh.size(i) > 1)
        self.lo, self.hi = (_range(self.n, mesh, placements, dim)
                            if mesh is not None else (0, self.n))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks that split this axis of a contraction over
        it (in place)."""
        return _reduce_partial(t, self.mesh, self.split)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole panel from this rank's rows ``t``: one all_gather
        per splitting mesh dimension, innermost first."""
        if not self.split:
            return t
        exts, size = [], self.n
        for i in self.dims:
            exts.append(size)
            k, c = self.mesh.size(i), self.mesh.get_local_rank(i)
            chunk = -(-size // k)
            a = min(c * chunk, size)
            size = min(a + chunk, size) - a
        for i, ext in reversed(list(zip(self.dims, exts))):
            k = self.mesh.size(i)
            if k == 1:
                continue
            chunk = -(-ext // k)
            pad = torch.zeros((chunk - t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            parts = _all_gather(torch.cat([t, pad]), self.mesh.get_group(i),
                                k)
            t = torch.cat([parts[j][: min((j + 1) * chunk, ext)
                                    - min(j * chunk, ext)]
                           for j in range(k)])
        return t

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole panel ``t`` (no traffic)."""
        return t[self.lo: self.hi] if self.split else t

    def wrap(self, t: torch.Tensor):
        """A panel on this axis, from its local rows, as a DTensor sharded
        like the axis (a local operand's: ``t`` itself)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import Replicate, Shard

        placements = [Shard(0) if i in self.dims else Replicate()
                      for i in range(self.mesh.ndim)]
        return _from_local(t, self.mesh, placements,
                           (self.n,) + tuple(t.shape[1:]))

    def whole(self, t: torch.Tensor):
        """A value every rank holds whole (σ, a small factor) as a
        Replicate() DTensor (a local operand's: ``t`` itself)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import Replicate

        return _from_local(t, self.mesh, [Replicate()] * self.mesh.ndim,
                           t.shape)


class _Blocks:
    """A 2-D operand as one rank holds it: ``local`` (a DTensor's block,
    or a tensor or sparse matrix whole), its row and column spaces
    (:class:`_Space`), and the products with it on local blocks. For a
    DTensor, ``mv(X)`` = A_loc·X_loc summed over the ranks that split the
    columns, ``rmv(Y)`` = A_locᵀ·Y_loc summed over those that split the
    rows: the reference's (Xᵀ·A)ᵀ. Any other operand keeps its own
    products (``base.sparse.linear_ops``)."""

    def __init__(self, A):
        if _is_sharded(A):
            _check_placements(A)
            self.mesh = A.device_mesh
            m, n = A.shape
            self.rows = _Space(m, self.mesh, A.placements, 0)
            self.cols = _Space(n, self.mesh, A.placements, 1)
            self.local = A.to_local()
            want = (self.rows.hi - self.rows.lo, self.cols.hi - self.cols.lo)
            if tuple(self.local.shape) != want:
                raise errors.InvalidParametersError(
                    f"DTensor block {tuple(self.local.shape)}, torch's split "
                    f"gives {want}")
            loc = self.local
            self.mv = lambda X: self.cols.sum(loc @ X)
            self.rmv = lambda Y: self.rows.sum(loc.T @ Y)
        else:
            from libskylark_tpu_torch.base.sparse import linear_ops

            self.mesh = None
            self.rows, self.cols = _Space(A.shape[0]), _Space(A.shape[1])
            self.local = A
            self.mv, self.rmv = linear_ops(A)
        self.shape = (self.rows.n, self.cols.n)

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def mv_whole(self, X: torch.Tensor) -> torch.Tensor:
        """A·X for an X every rank holds whole (n × k): this rank's rows
        of the product (its columns of X, then ``mv``: one all_reduce
        per mesh dimension that splits the columns)."""
        return self.mv(self.cols.take(X))

    def rmv_whole(self, Y: torch.Tensor) -> torch.Tensor:
        """Aᵀ·Y for Y on this rank's rows: the whole (n × k) product on
        every rank (``rmv``, then the gather of the short column-indexed
        result over the mesh dimensions that split the columns)."""
        return self.cols.gather(self.rmv(Y))

    def qt_whole(self, Q: torch.Tensor) -> torch.Tensor:
        """Qᵀ·A whole (k × n) for Q on this rank's rows: ``rmv_whole``
        transposed, with the one-process product's operand order
        (Qᵀ·A_loc, summed over the ranks that split the rows, then
        gathered over those that split the columns)."""
        return self.cols.gather(self.rows.sum(Q.T @ self.local).T).T

    def whole(self, t: torch.Tensor):
        return self.rows.whole(t)

    def col_block(self, X) -> torch.Tensor:
        """This rank's rows of ``X``, a panel on the operand's columns
        (:meth:`_take_block`)."""
        return self._take_block(X, self.cols, "columns")

    def row_block(self, B) -> torch.Tensor:
        """This rank's rows of ``B``, a right-hand side beside the
        operand (:meth:`_take_block`)."""
        return self._take_block(B, self.rows, "rows")

    def _take_block(self, X, space: _Space, what: str) -> torch.Tensor:
        """This rank's rows of ``X`` on ``space``: a DTensor split as the
        space (its block), a DTensor whose rows are whole or a tensor
        every rank holds whole (sliced). A DTensor whose columns are
        split is refused: each rank would keep other columns of it."""
        if _is_sharded(X):
            mesh = X.device_mesh
            if any(p.is_shard() and p.dim != 0 and mesh.size(i) > 1
                   for i, p in enumerate(X.placements)):
                raise errors.InvalidParametersError(
                    f"operand on the {what} has its columns split "
                    f"({tuple(X.placements)}); give it with whole columns")
            loc, lo = _local_block(X, 0)
            if (lo, lo + loc.shape[0]) == (space.lo, space.hi):
                return loc
            if loc.shape[0] != space.n:
                raise errors.InvalidParametersError(
                    f"operand rows [{lo}, {lo + loc.shape[0]}) do not "
                    f"match the operand's {what} [{space.lo}, {space.hi})")
            return space.take(loc)
        from libskylark_tpu_torch.base.device import as_tensor

        dev = (self.local.device if isinstance(self.local, torch.Tensor)
               else None)
        return space.take(as_tensor(X, dev))


def _rows_layout(x):
    """``x`` (a 2-D DTensor) with its columns whole: every mesh dimension
    that splits its columns splits its rows instead, by one
    :func:`_exchange` (``x`` itself where no dimension of more than one
    rank splits the columns). The layout of the routes that need whole
    rows (CholeskyQR2's Gram, a feature map, ADMM's examples)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    if not any(p.is_shard(1) and mesh.size(i) > 1
               for i, p in enumerate(x.placements)):
        return x
    return _exchange(x, [Shard(0) if p.is_shard(1) else p
                         for p in x.placements])


def _whole(x) -> torch.Tensor:
    """The whole value of the DTensor ``x`` on every rank of its mesh: one
    all_gather per mesh dimension that splits each tensor dimension
    (``_Space.gather``). Not ``full_tensor()``: torch's gather of a CUDA
    tensor on a gloo group faults (ROADMAP C14); this one stages it
    through host memory."""
    _check_placements(x)
    loc = x.to_local()
    for dim in range(x.ndim):
        space = _Space(x.shape[dim], x.device_mesh, x.placements, dim)
        loc = space.gather(loc.movedim(dim, 0)).movedim(0, dim)
    return loc.contiguous()


def _flat_group(mesh):
    """The process group over all of ``mesh``'s ranks: a 1-D mesh's own,
    the one :func:`make_mesh` made for a grid, or, for a grid made
    elsewhere (``init_device_mesh``), that of torch's flattened mesh,
    made by the mesh's ranks alone on its first use and kept on the
    mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    group = getattr(mesh, "_skylark_flat", None)
    if group is None:
        if not mesh.mesh_dim_names:
            raise errors.InvalidParametersError(
                "a multi-dimensional mesh needs dimension names (rows, "
                "cols) for its ranks' group")
        group = mesh._flatten().get_group(0)
        mesh._skylark_flat = group
    return group


def _exchange(x, dst_placements):
    """``x`` (a 2-D DTensor) laid out as ``dst_placements`` by one
    all_to_all over the mesh's ranks: each rank sends every other the part
    of its block that falls in that rank's new block. The one collective
    that changes an operand's layout (FJLT's mixer needs its axis
    whole)."""
    import torch.distributed as dist

    mesh, shape = x.device_mesh, tuple(x.shape)
    src_pl, dst_pl = tuple(x.placements), tuple(dst_placements)
    _check_placements(x)
    group = _flat_group(mesh)
    # the group's ranks in its own order, the order of the splits
    ranks = dist.get_process_group_ranks(group)
    grid = mesh.mesh

    def rect(placements, r):
        coord = [int(c) for c in (grid == r).nonzero()[0]]
        return [_range(shape[d], mesh, placements, d, coord) for d in (0, 1)]

    me = dist.get_rank()
    mine_src, mine_dst = rect(src_pl, me), rect(dst_pl, me)
    loc = x.to_local()

    def cut(a, b):
        return [(max(a[d][0], b[d][0]), min(a[d][1], b[d][1]))
                for d in (0, 1)]

    sends, recvs = [], []
    for r in ranks:
        s = cut(mine_src, rect(dst_pl, r))
        piece = loc[max(s[0][0] - mine_src[0][0], 0):
                    max(s[0][1] - mine_src[0][0], 0),
                    max(s[1][0] - mine_src[1][0], 0):
                    max(s[1][1] - mine_src[1][0], 0)]
        sends.append(piece.reshape(-1))
        recvs.append(cut(rect(src_pl, r), mine_dst))
    sizes_in = [t.numel() for t in sends]
    sizes_out = [max(b[0][1] - b[0][0], 0) * max(b[1][1] - b[1][0], 0)
                 for b in recvs]
    flat = torch.cat(sends) if sends else loc.new_empty(0)
    src, back = _stage(flat, group)
    out = torch.empty(sum(sizes_out), dtype=loc.dtype, device=src.device)
    if len(ranks) > 1:
        dist.all_to_all_single(out, src, sizes_out, sizes_in, group=group)
        _count("all_to_all", flat)
    else:
        out = src
    if back is not None:
        out = out.to(back)
    block = torch.empty((mine_dst[0][1] - mine_dst[0][0],
                         mine_dst[1][1] - mine_dst[1][0]),
                        dtype=loc.dtype, device=loc.device)
    off = 0
    for b, k in zip(recvs, sizes_out):
        if k:
            (r0, r1), (c0, c1) = b
            block[r0 - mine_dst[0][0]: r1 - mine_dst[0][0],
                  c0 - mine_dst[1][0]: c1 - mine_dst[1][0]] = out[
                      off: off + k].reshape(r1 - r0, c1 - c0)
        off += k
    return _from_local(block, mesh, dst_pl, shape)
