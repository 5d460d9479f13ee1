"""Shared-memory operand/result transport for process replicas (the port
of libskylark_tpu/fleet/shm.py).

Every array crossing a :class:`~libskylark_tpu_torch.fleet.replica
.ProcessReplica` pipe would otherwise be pickled twice: serialized by the
sender, reassembled by the receiver, streamed through an OS pipe in
between. This module moves large arrays through
``multiprocessing.shared_memory`` instead:

- each replica pair owns **two rings** of fixed-size slots (one segment
  per direction, ``SKYLARK_FLEET_SHM_SLOTS`` ×
  ``SKYLARK_FLEET_SHM_SLOT_BYTES`` each);
- the **pipe stays the control channel**: a message that would have
  carried an array carries a small :class:`ShmRef` header (slot, shape,
  dtype) instead, and ordering is inherited from the pipe: the slot is
  fully written before the header is sent;
- the **receiver reads in place**: a decoded :class:`ShmRef` becomes a
  read-only ``np.ndarray`` view over the slot. The slot is released when
  that view (and every array derived from it) is garbage-collected: a
  ``weakref.finalize`` queues the slot id and the next pipe turnaround
  carries a ``shmfree`` ack back to the writer. The sender pays one
  ``np.copyto`` into the slot (strided sources need no staging copy);
- everything degrades to the **pickle fallback**: values under
  ``SKYLARK_FLEET_SHM_MIN_BYTES``, arrays larger than one slot, object
  dtypes, and any send finding the ring exhausted travel the pipe as
  before (``fleet.shm_fallbacks`` counts them). Transport choice never
  changes a result.

Where the port departs (ROADMAP C28), keeping the reference's rings,
headers and lifecycle:

- **No tensor reaches a pipe.** ``torch`` registers its own reductions
  with ``multiprocessing``'s pickler: a CPU tensor would cross as a file
  descriptor of torch's shared memory (outside this module's no-leak
  contract) and a CUDA tensor as a CUDA IPC handle that the sender must
  keep alive. :meth:`ShmTransport.encode` and :func:`to_wire` take
  tensors as well as arrays: a CPU tensor of any strides is copied into
  its slot as it is, a CUDA tensor is copied to the host once, and a
  tensor that falls back to the pipe travels as a :class:`HostTensor`
  (its host array). Every message goes through :func:`pipe_dumps`, whose
  pickler turns any tensor left inside another object into a
  :class:`HostTensor` too. A dtype with no numpy form (bfloat16) is
  refused at encode, as the wire refuses it.
- **A receiver may ask for tensors back.** :meth:`ShmTransport.decode`
  and :func:`from_wire` take ``tensors``, a function of a host array:
  each value that left the sender as a tensor (a :class:`ShmRef` with
  ``tensor`` set, or a :class:`HostTensor`) is handed to it, and the
  slot is released once its view is dropped. A process replica's parent
  uses it to resolve results to tensors on the pool's device, by one
  copy from the slot; its child reads operands as host arrays.

**Segment lifecycle (the no-leak contract).** The parent creates both
segments; the child attaches them at entry; once the parent's boot
liveness probe confirms the attach, the parent unlinks the names at
once. POSIX keeps the memory alive as long as either process maps it,
so steady-state operation runs with zero ``/dev/shm`` entries: a
SIGTERM'd replica, a ``kill -9``'d child, even a ``kill -9``'d parent
cannot leak a segment. The only window where names exist is replica
boot, covered three ways: :meth:`ShmTransport.destroy` runs from
``ProcessReplica.shutdown`` and the reader loop's dead-child path, an
``atexit`` sweep destroys any transport still live at interpreter exit,
and the ``multiprocessing`` resource tracker reaps registered names if
the parent dies mid-boot.
"""

from __future__ import annotations

import atexit
import io
import itertools
import os
import pickle
import struct
import weakref
from collections import deque
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.telemetry import metrics as _metrics

#: ``/dev/shm`` name prefix of every segment this module creates: tests
#: and operators can assert that no entry with it outlives the fleet. Not
#: the reference's (``skylark_shm_``), so that each package's leak check
#: sees its own segments.
SHM_PREFIX = "skylark_torch_shm_"

_SENDS = _metrics.counter(
    "fleet.shm_sends", "Arrays moved through a shared-memory slot, "
    "by replica and direction")
_FALLBACKS = _metrics.counter(
    "fleet.shm_fallbacks", "Array sends that degraded to the pickle "
    "pipe, by replica and reason")


class ShmRef:
    """Wire header of one array riding a shared-memory slot; travels the
    pipe in the array's place. ``tensor`` marks an array that left the
    sender as a tensor."""

    __slots__ = ("slot", "shape", "dtype", "nbytes", "tensor")

    def __init__(self, slot: int, shape: tuple, dtype: str, nbytes: int,
                 tensor: bool = False):
        self.slot = slot
        self.shape = shape
        self.dtype = dtype
        self.nbytes = nbytes
        self.tensor = bool(tensor)

    def __reduce__(self):
        return (ShmRef, (self.slot, self.shape, self.dtype, self.nbytes,
                         self.tensor))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ShmRef(slot={self.slot}, shape={self.shape}, "
                f"dtype={self.dtype}, tensor={self.tensor})")


class HostTensor:
    """A tensor's values as a host array, on the pickle pipe: the form a
    tensor takes where it does not ride a slot."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array

    def __reduce__(self):
        return (HostTensor, (self.array,))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host: a CPU tensor's own memory with its
    strides (no copy), a CUDA tensor copied off the card once, a
    DTensor's blocks gathered. A dtype with no numpy form is refused."""
    if t.dtype == torch.bfloat16:
        raise errors.UnsupportedError(
            "a bfloat16 tensor has no numpy form and cannot cross a "
            "process replica's pipe")
    if type(t).__module__.startswith("torch.distributed"):
        # a DTensor (only then: importing torch.distributed.tensor is
        # slow in a fresh process)
        from libskylark_tpu_torch.parallel.mesh import to_host

        return to_host(t)
    return t.detach().cpu().numpy()


class _PipePickler(pickle.Pickler):
    """The pipe's pickler: the standard one (none of the reductions
    ``torch`` registers with ``multiprocessing``), a tensor anywhere in
    the message made a :class:`HostTensor`."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return (HostTensor, (np.ascontiguousarray(host_array(obj)),))
        return NotImplemented


def pipe_dumps(msg) -> memoryview:
    """One pipe message's bytes, as a view of the pickler's buffer
    (``Connection.send_bytes``; the receiver's :func:`pipe_recv`, or
    ``Connection.recv``, unpickles them)."""
    buf = io.BytesIO()
    _PipePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(msg)
    return buf.getbuffer()


def _read_into(fd: int, view: memoryview) -> None:
    pos = 0
    while pos < len(view):
        n = os.readv(fd, [view[pos:]])
        if n == 0:
            raise EOFError("pipe closed mid-message")
        pos += n


def pipe_recv(conn):
    """One message off ``conn``, as ``Connection.send_bytes`` framed it (a
    4-byte big-endian length, or -1 and an 8-byte one), read into one
    buffer of its size and unpickled. ``Connection.recv`` reads a large
    frame in socket-sized pieces, each into a fresh buffer the size of
    what remains, which moves a 64 MB pickle at about 150 MB/s."""
    fd = conn.fileno()
    head = bytearray(4)
    _read_into(fd, memoryview(head))
    size = struct.unpack("!i", head)[0]
    if size == -1:
        head = bytearray(8)
        _read_into(fd, memoryview(head))
        size = struct.unpack("!Q", head)[0]
    buf = bytearray(size)
    _read_into(fd, memoryview(buf))
    return pickle.loads(buf)


def _untrack(shm) -> None:
    """Drop a segment from the ``resource_tracker`` after the deliberate
    unlink (the tracker would otherwise unlink, and warn about, a name
    that is already gone). Called once, by the owner: a spawn child
    shares the parent's tracker process, so its attach-time registration
    dedupes into the parent's and must not be removed twice."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 — bookkeeping only, never fatal
        pass


class ShmRing:
    """One direction of the transport: a slotted view over one shared
    segment. The *writer* side owns the free list and copies arrays in;
    the *reader* side builds views and reports released slots back
    (through the transport's acks, not directly)."""

    def __init__(self, shm, slots: int, slot_bytes: int, *,
                 writer: bool):
        self._shm = shm
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._writer = writer
        self._lock = _locks.make_lock("fleet.shm")
        # LIFO free list: the most recently released slot is the warmest
        self._free: Optional[List[int]] = (
            list(range(self.slots)) if writer else None)
        self.sends = 0
        # bytes written into slots, and bytes of arrays that fell back to
        # the pipe (the port's counters)
        self.sent_bytes = 0
        self.fallback_bytes = 0
        # fallbacks by reason: "ring" (exhausted: raise
        # SKYLARK_FLEET_SHM_SLOTS), "oversize" (raise
        # SKYLARK_FLEET_SHM_SLOT_BYTES), "dtype" (object/empty: no knob)
        self.fallback_reasons = {"ring": 0, "oversize": 0, "dtype": 0}

    @property
    def fallbacks(self) -> int:
        return sum(self.fallback_reasons.values())

    def try_put(self, arr: np.ndarray, tensor: bool = False
                ) -> Tuple[Optional[ShmRef], Optional[str]]:
        """Copy ``arr`` into a free slot: ``(ref, None)`` on a send,
        ``(None, reason)`` on a pickle fallback (oversize, a dtype the
        header cannot express, ring exhausted). Never blocks."""
        assert self._writer, "try_put on the reader side"
        # only simple scalar dtypes ride: their ``.str`` round-trips
        # through np.dtype() on the receiver
        if (arr.dtype.hasobject or arr.dtype.names is not None
                or arr.dtype.subdtype is not None or arr.nbytes == 0):
            return None, self._fallback("dtype", arr)
        if arr.nbytes > self.slot_bytes:
            return None, self._fallback("oversize", arr)
        with self._lock:
            if not self._free:
                self.fallback_reasons["ring"] += 1
                self.fallback_bytes += int(arr.nbytes)
                return None, "ring"
            slot = self._free.pop()
            self.sends += 1
            self.sent_bytes += int(arr.nbytes)
        # the copy runs outside the lock: the slot is ours until the
        # peer acks it back, and np.copyto takes strided sources
        view = np.ndarray(arr.shape, arr.dtype, buffer=self._shm.buf,
                          offset=slot * self.slot_bytes)
        np.copyto(view, arr, casting="no")
        del view
        return ShmRef(slot, tuple(arr.shape), arr.dtype.str,
                      int(arr.nbytes), tensor), None

    def _fallback(self, reason: str, arr: np.ndarray) -> str:
        with self._lock:
            self.fallback_reasons[reason] += 1
            self.fallback_bytes += int(arr.nbytes)
        return reason

    def release(self, slots: Iterable[int]) -> None:
        """Return acked slots to the free list (writer side)."""
        assert self._writer, "release on the reader side"
        with self._lock:
            for s in slots:
                s = int(s)
                if 0 <= s < self.slots and s not in self._free:
                    self._free.append(s)

    def free_slots(self) -> int:
        with self._lock:
            return len(self._free) if self._free is not None else 0

    def validate(self, ref: ShmRef) -> None:
        """Raise on a header :meth:`view` could not materialize; run over
        a whole payload before any view is made, so that a malformed
        payload is refused while no slot has a finalizer yet."""
        dt = np.dtype(ref.dtype)       # raises on a non-round-trip str
        if not 0 <= ref.slot < self.slots:
            raise ValueError(f"slot {ref.slot} out of range")
        nbytes = dt.itemsize * int(np.prod(ref.shape, dtype=np.int64))
        if nbytes != ref.nbytes or nbytes > self.slot_bytes:
            raise ValueError(
                f"header geometry inconsistent: shape {ref.shape} x "
                f"{ref.dtype} = {nbytes} B vs declared {ref.nbytes} B "
                f"(slot holds {self.slot_bytes})")

    def view(self, ref: ShmRef, on_release) -> np.ndarray:
        """Read-only array over ``ref``'s slot. ``on_release(slot)`` fires
        when the view and everything derived from it are collected; it
        must be cheap and lock-free (it runs wherever GC runs)."""
        assert not self._writer, "view on the writer side"
        arr = np.ndarray(ref.shape, np.dtype(ref.dtype),
                         buffer=self._shm.buf,
                         offset=ref.slot * self.slot_bytes)
        arr.flags.writeable = False
        weakref.finalize(arr, on_release, ref.slot)
        return arr


def _encode(obj, ring: Optional[ShmRing], min_bytes: int
            ) -> Tuple[object, List[int], dict]:
    """Replace the arrays and tensors of ``obj``: those in dict/list/tuple
    containers to two levels deep, at least ``min_bytes`` large, by
    :class:`ShmRef` headers where ``ring`` has a slot; every other tensor,
    at any depth, by a :class:`HostTensor`. Returns the encoded object,
    the claimed slots (released locally if the pipe send then fails) and
    this call's fallbacks by reason."""
    claimed: List[int] = []
    fallbacks: dict = {}

    def put(arr: np.ndarray, depth: int, tensor: bool):
        if ring is not None and depth <= 2 and arr.nbytes >= min_bytes:
            ref, reason = ring.try_put(arr, tensor)
            if ref is not None:
                claimed.append(ref.slot)
                return ref
            fallbacks[reason] = fallbacks.get(reason, 0) + 1
        return HostTensor(np.ascontiguousarray(arr)) if tensor else arr

    def enc(x, depth):
        if isinstance(x, torch.Tensor):
            return put(host_array(x), depth, True)
        if isinstance(x, np.ndarray):
            return put(x, depth, False)
        if isinstance(x, dict):
            return {k: enc(v, depth + 1) for k, v in x.items()}
        if isinstance(x, list):
            return [enc(v, depth + 1) for v in x]
        if isinstance(x, tuple):
            return tuple(enc(v, depth + 1) for v in x)
        return x

    return enc(obj, 0), claimed, fallbacks


def _decode(obj, ring: Optional[ShmRing], on_release,
            tensors: Optional[Callable] = None):
    """Inverse of :func:`_encode`: every :class:`ShmRef` a read-only view
    (see :meth:`ShmRing.view`), every :class:`HostTensor` its array, and
    each of those that left the sender as a tensor passed through
    ``tensors`` when given. Arrays that rode the pipe are marked
    read-only too, so a payload has one mutability whatever path each
    array took."""

    def readonly(x: np.ndarray) -> np.ndarray:
        try:
            x.flags.writeable = False
        except ValueError:
            pass                   # a non-owning view: leave it
        return x

    def dec(x):
        if isinstance(x, ShmRef):
            arr = ring.view(x, on_release)
            return tensors(arr) if (x.tensor and tensors) else arr
        if isinstance(x, HostTensor):
            arr = readonly(x.array)
            return tensors(arr) if tensors else arr
        if isinstance(x, np.ndarray):
            return readonly(x)
        if isinstance(x, dict):
            return {k: dec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [dec(v) for v in x]
        if isinstance(x, tuple):
            return tuple(dec(v) for v in x)
        return x

    return dec(obj)


def to_wire(obj):
    """A payload's pipe form without a ring: every tensor in its
    containers a :class:`HostTensor`."""
    return _encode(obj, None, 0)[0]


def from_wire(obj, tensors: Optional[Callable] = None):
    """Inverse of :func:`to_wire` (see :meth:`ShmTransport.decode` for
    ``tensors``)."""
    return _decode(obj, None, None, tensors)


def scan_refs(obj, _depth: int = 0) -> List[ShmRef]:
    """Every :class:`ShmRef` in a payload: the validation pre-pass, and
    the slot recovery when a payload is refused (claimed slots must go
    back to the writer or the ring loses capacity for good)."""
    out: List[ShmRef] = []

    def walk(x, depth):
        if isinstance(x, ShmRef):
            out.append(x)
            return
        if depth >= 2:
            return
        if isinstance(x, dict):
            for v in x.values():
                walk(v, depth + 1)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, depth + 1)

    walk(obj, _depth)
    return out


_SEQ = itertools.count()
_LIVE: "weakref.WeakSet[ShmTransport]" = weakref.WeakSet()


class ShmTransport:
    """Both rings of one replica pair, from one side.

    Build with :meth:`create` in the parent (makes the segments) and
    :meth:`attach` in the child (maps them). ``tx`` is the ring this side
    writes, ``rx`` the ring it reads; the parent's ``tx`` is the child's
    ``rx`` and the other way round.
    """

    def __init__(self, label: str, tx: ShmRing, rx: ShmRing,
                 min_bytes: int, names: Tuple[str, str],
                 owner: bool):
        self.label = label
        self.tx = tx
        self.rx = rx
        self.min_bytes = int(min_bytes)
        self._names = names
        self._owner = owner
        self._unlinked = not owner
        self._pending_free: "deque[int]" = deque()
        self.recv_views = 0
        if owner:
            _LIVE.add(self)

    # -- construction --------------------------------------------------

    @classmethod
    def create(cls, replica_name: str, *,
               slots: Optional[int] = None,
               slot_bytes: Optional[int] = None,
               min_bytes: Optional[int] = None) -> "ShmTransport":
        from multiprocessing import shared_memory

        slots = int(slots if slots is not None
                    else _env.FLEET_SHM_SLOTS.get())
        slot_bytes = int(slot_bytes if slot_bytes is not None
                         else _env.FLEET_SHM_SLOT_BYTES.get())
        min_bytes = int(min_bytes if min_bytes is not None
                        else _env.FLEET_SHM_MIN_BYTES.get())
        safe = "".join(c if c.isalnum() else "-"
                       for c in str(replica_name))[:32]
        base = f"{SHM_PREFIX}{os.getpid()}_{next(_SEQ)}_{safe}"
        size = slots * slot_bytes
        p2c = shared_memory.SharedMemory(name=base + "_p2c",
                                         create=True, size=size)
        try:
            c2p = shared_memory.SharedMemory(name=base + "_c2p",
                                             create=True, size=size)
        except BaseException:
            p2c.close()
            p2c.unlink()
            raise
        return cls(
            str(replica_name),
            tx=ShmRing(p2c, slots, slot_bytes, writer=True),
            rx=ShmRing(c2p, slots, slot_bytes, writer=False),
            min_bytes=min_bytes,
            names=(base + "_p2c", base + "_c2p"), owner=True)

    @classmethod
    def attach(cls, spec: dict) -> "ShmTransport":
        """The child's mapping, from :meth:`child_spec`'s dict."""
        from multiprocessing import shared_memory

        # the attach registers with the (shared) resource tracker; the
        # owner unregisters at unlink (see _untrack)
        p2c = shared_memory.SharedMemory(name=spec["p2c"])
        c2p = shared_memory.SharedMemory(name=spec["c2p"])
        slots, slot_bytes = int(spec["slots"]), int(spec["slot_bytes"])
        return cls(
            str(spec.get("label", "child")),
            tx=ShmRing(c2p, slots, slot_bytes, writer=True),
            rx=ShmRing(p2c, slots, slot_bytes, writer=False),
            min_bytes=int(spec["min_bytes"]),
            names=(spec["p2c"], spec["c2p"]), owner=False)

    def child_spec(self) -> dict:
        """The attach recipe that rides the spawn arguments."""
        return {"p2c": self._names[0], "c2p": self._names[1],
                "slots": self.tx.slots, "slot_bytes": self.tx.slot_bytes,
                "min_bytes": self.min_bytes, "label": self.label}

    # -- data path -----------------------------------------------------

    def encode(self, obj) -> Tuple[object, List[int]]:
        out, claimed, fallbacks = _encode(obj, self.tx, self.min_bytes)
        if claimed:
            _SENDS.inc(len(claimed), replica=self.label)
        for reason, n in fallbacks.items():
            _FALLBACKS.inc(n, replica=self.label, reason=reason)
        return out, claimed

    def decode(self, obj, tensors: Optional[Callable] = None):
        """``obj`` with its headers read (see :func:`_decode`). Two
        phases: every header is validated before any view is made, so
        that a malformed payload fails while :meth:`recover` can still
        ack all its slots."""
        for ref in scan_refs(obj):
            self.rx.validate(ref)
        return _decode(obj, self.rx, self._pending_free.append, tensors)

    def unclaim(self, slots: List[int]) -> None:
        """Return locally claimed slots after a failed pipe send (the
        header never left, so the peer will never ack them)."""
        self.tx.release(slots)

    def release(self, slots: Iterable[int]) -> None:
        """The peer's ack arrived: the slots we wrote are free again."""
        self.tx.release(slots)

    def recover(self, payload) -> None:
        """A payload was refused (validation failed, so no view owns any
        of its slots): queue every referenced slot for the ack turnaround.
        The request is lost (its future gets the error), the ring capacity
        is not."""
        for ref in scan_refs(payload):
            self._pending_free.append(ref.slot)

    def drain_acks(self) -> List[int]:
        """Slots whose received views were collected since the last call;
        the caller ships them to the peer as a ``shmfree`` message. Safe
        against concurrent appends (a missed slot rides the next
        turnaround)."""
        out: List[int] = []
        while True:
            try:
                out.append(self._pending_free.popleft())
            except IndexError:
                return out

    def stats(self) -> dict:
        return {"sends": self.tx.sends, "fallbacks": self.tx.fallbacks,
                "sent_bytes": self.tx.sent_bytes,
                "fallback_bytes": self.tx.fallback_bytes,
                "fallback_reasons": dict(self.tx.fallback_reasons),
                "free_slots": self.tx.free_slots(),
                "slot_bytes": self.tx.slot_bytes,
                "slots": self.tx.slots}

    # -- lifecycle -----------------------------------------------------

    def unlink(self) -> None:
        """Remove both ``/dev/shm`` names (parent side, once the child's
        attach is confirmed). The mappings, both processes' rings and
        every outstanding view, stay valid; the memory is freed with the
        last mapping. Idempotent."""
        if self._unlinked:
            return
        self._unlinked = True
        for ring in (self.tx, self.rx):
            try:
                # unlink also unregisters from the resource tracker
                ring._shm.unlink()
            except FileNotFoundError:
                # someone else removed the name: drop the stale tracker
                # registration ourselves
                _untrack(ring._shm)
            except Exception:  # noqa: BLE001 — cleanup must not raise
                pass

    def untrack_local(self) -> None:
        """Drop this process's resource-tracker registrations of both
        segments. Only for an attacher that does not share the owner's
        tracker (a standalone subprocess; spawn children share it):
        without it, that tracker would unlink the owner's names at its
        exit."""
        for ring in (self.tx, self.rx):
            _untrack(ring._shm)

    def destroy(self) -> None:
        """Unlink (if the boot window never got there) and drop the
        mappings no live view pins. Idempotent; called from replica
        shutdown, the dead-child reader path and the atexit sweep."""
        self.unlink()
        for ring in (self.tx, self.rx):
            try:
                ring._shm.close()
            except BufferError:
                # an outstanding view still references the mapping; it
                # goes with the view (or the process)
                pass
            except Exception:  # noqa: BLE001 — cleanup must not raise
                pass


def _atexit_sweep() -> None:  # pragma: no cover - interpreter exit
    for t in list(_LIVE):
        t.destroy()


atexit.register(_atexit_sweep)


def shm_entries(pid: Optional[int] = None) -> List[str]:
    """Live ``/dev/shm`` entries with this module's prefix (leak detection
    in tests and the chip smoke); with ``pid``, only those the process of
    that id created (a name carries its creator's pid)."""
    prefix = SHM_PREFIX if pid is None else f"{SHM_PREFIX}{int(pid)}_"
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(prefix))
    except OSError:
        return []


__all__ = ["HostTensor", "SHM_PREFIX", "ShmRef", "ShmRing",
           "ShmTransport", "from_wire", "host_array", "pipe_dumps",
           "pipe_recv", "shm_entries", "to_wire"]
