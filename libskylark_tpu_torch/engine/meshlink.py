"""The serve executor's mesh link: the collectives that split a flush's
lanes over the ranks of a ``DeviceMesh``'s first dimension (the
transport of :class:`~libskylark_tpu_torch.engine.serve.
MicrobatchExecutor`'s ``mesh``).

The reference's executor is single-controller: one process shards each
flush's batch axis over every device of its mesh. The port's mesh is
SPMD, one process per rank (:mod:`libskylark_tpu_torch.parallel.mesh`),
so a mesh executor is a **front** (the rank at coordinate 0 of the batch
dimension: it admits submits, forms cohorts and resolves futures) and
**followers** (every other rank of that dimension: each runs its block of
the front's flushes). Along any further mesh dimension each coordinate's
ranks form a line of their own, with their own front.

One flush, in the order every rank issues it on the batch dimension's
process group:

1. the front broadcasts a header (``broadcast_object_list``): the
   bucket's statics and flush context, the route, the lanes per rank, the
   keys, scales and host arrays of the whole cohort, the shapes of the
   stacked operands, the cohort's fault tags, and whether a model follows;
2. a KRR/RLSC bucket's model (X_train, coef) is broadcast, once per model
   and link (a follower keeps it);
3. each stacked operand is cut along dim 0 and block r sent to rank r;
4. every rank runs its block; the ranks exchange one status each
   (``all_gather_object``), so all know whether the flush failed;
5. only if no rank failed, each follower sends its result block and the
   front receives them in rank order.

gloo carries neither point-to-point nor broadcast for CUDA tensors here:
on a gloo group a CUDA operand goes through host memory, as
``parallel.mesh`` stages its all-gathers (ROADMAP C13, C14). The front's
own block never leaves its device. :attr:`MeshLink.bytes` counts what
crossed between ranks.
"""

from __future__ import annotations

import collections
import pickle
from typing import Optional

import torch

from libskylark_tpu_torch.base import errors


class MeshLink:
    """This rank's end of a mesh executor's batch dimension. Every rank of
    the mesh builds one, in the same order (the executor does, at
    construction)."""

    def __init__(self, mesh, device: torch.device):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise errors.CommunicationError(
                "a mesh executor needs a process group: call "
                "parallel.multihost.initialize_distributed first")
        coord = mesh.get_coordinate()
        if coord is None:
            raise errors.MeshError(
                f"rank {dist.get_rank()} has no coordinate in the mesh "
                f"{mesh.mesh.tolist()}: only the mesh's ranks build its "
                f"executor")
        line = mesh.mesh.movedim(0, -1)[tuple(coord[1:])]
        self.ranks = [int(r) for r in line.reshape(-1).tolist()]
        self.ndev = len(self.ranks)
        self.index = int(coord[0])
        self.front = self.ranks[0]
        self.group = mesh.get_group(0)
        self.device = torch.device(device)
        self.stage = (self.device.type == "cuda"
                      and dist.get_backend(self.group) == "gloo")
        self.bytes = collections.Counter()
        self._dist = dist

    @property
    def is_front(self) -> bool:
        return self.index == 0

    # -- headers and statuses (pickled objects) ----------------------------

    def send_header(self, header: dict) -> None:
        """The front's header of the next collective step."""
        n = len(pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL))
        self.bytes["header"] += n * (self.ndev - 1)
        self._dist.broadcast_object_list([header], src=self.front,
                                         group=self.group)

    def recv_header(self) -> dict:
        """A follower's wait for the front's next header."""
        box = [None]
        self._dist.broadcast_object_list(box, src=self.front,
                                         group=self.group)
        return box[0]

    def statuses(self, status: Optional[str]) -> list:
        """Every rank's status of a flush (None: its block ran), in rank
        order."""
        out = [None] * self.ndev
        self._dist.all_gather_object(out, status, group=self.group)
        return out

    # -- tensors --------------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.stage else t.contiguous()

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype,
                           device="cpu" if self.stage else self.device)

    def broadcast(self, t: Optional[torch.Tensor], shape=None,
                  dtype=None) -> torch.Tensor:
        """The front's ``t`` on every rank (a follower passes its shape and
        dtype), on the link's device."""
        if self.is_front:
            buf = self._wire(t)
            self.bytes["replicated"] += (buf.numel() * buf.element_size()
                                         * (self.ndev - 1))
        else:
            buf = self._empty(shape, dtype)
        self._dist.broadcast(buf, src=self.front, group=self.group)
        return t if self.is_front else buf.to(self.device)

    def scatter(self, t: Optional[torch.Tensor], per: int, shape=None,
                dtype=None) -> torch.Tensor:
        """Block r (``per`` rows along dim 0) of the front's stacked ``t``
        on rank r, sent rank by rank; a follower passes the block's
        trailing shape and dtype. The front's block is a view of ``t``."""
        if self.is_front:
            for r in range(1, self.ndev):
                block = self._wire(t[r * per:(r + 1) * per])
                self.bytes["scattered"] += block.numel() * block.element_size()
                self._dist.send(block, dst=self.ranks[r], group=self.group)
            return t[:per]
        buf = self._empty((per, *shape), dtype)
        self._dist.recv(buf, src=self.front, group=self.group)
        return buf.to(self.device)

    def gather(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's block in rank order, stacked along dim 0 on the
        front's device (None on a follower). The front's block stays
        where it is."""
        if not self.is_front:
            self._dist.send(self._wire(t), dst=self.front, group=self.group)
            return None
        parts = [t]
        for r in range(1, self.ndev):
            buf = self._empty(t.shape, t.dtype)
            self._dist.recv(buf, src=self.ranks[r], group=self.group)
            self.bytes["gathered"] += buf.numel() * buf.element_size()
            parts.append(buf.to(self.device))
        return torch.cat(parts)
