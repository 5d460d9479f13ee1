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

ROWS = "rows"
COLS = "cols"


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
    return DeviceMesh(kind, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


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
    ``full_tensor()`` (a collective: every rank of its mesh calls it), any
    other tensor or array as it is."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
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


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Sum ``t`` in place over the ranks along ``axis`` (the reference's
    ``lax.psum``); nothing for None or a dimension of one rank."""
    if axis and axis_size(mesh, axis) > 1:
        _world().all_reduce(t, group=mesh.get_group(axis))
    return t
