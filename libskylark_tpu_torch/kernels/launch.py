"""What every kernel wrapper does around a launch: take each tensor
argument's pointer through one gate (a DTensor is refused), call the C
function on PyTorch's current stream, and raise on a CUDA error (the
launch never ran). The kernels take the transform's 2-word key and
derive every chunk key on the card, so a launch needs no table from the
host. A key may also come as an int32 tensor already on the card (the
route of a captured body, engine/compiled.py), read by the kernel from
device memory.

Launch counts go through :func:`count`; while a thread captures a CUDA
graph (:func:`recording`) its counts are recorded instead of added, since
a capture launches nothing, and each replay adds them
(:func:`add_counts`), also into :data:`replayed` by counter name: the
launches made inside replays."""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks


def refuse_dtensor(*tensors) -> None:
    """Raise TypeError for a DTensor among ``tensors``: its own
    ``data_ptr()`` is 0, not its storage. A kernel takes a rank's block,
    ``to_local()``; the sharded entry points pass it."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and hasattr(t, "to_local") and hasattr(
                t, "device_mesh"):
            raise TypeError(
                "a kernel wrapper got a DTensor, whose data_ptr() is not its "
                "storage: pass its local block, x.to_local()")


def ptr(t) -> int | None:
    """The device pointer of a kernel argument (None for none), after
    :func:`refuse_dtensor`: the one way a tensor reaches a kernel."""
    if t is None:
        return None
    refuse_dtensor(t)
    return t.data_ptr()


def call(fn, device, *args) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream, each tensor
    argument passed as its :func:`ptr`; raises SketchError with the CUDA
    error code when the launch failed."""
    args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise errors.SketchError(
            f"{fn.__name__} launch failed: CUDA error {rc}")


_count_lock = _locks.make_lock("kernels.counts")
_tls = threading.local()
# launches made inside graph replays, by counter name (add_counts)
replayed: collections.Counter = collections.Counter()


def count(counters: dict, name: str, n: int = 1) -> None:
    """Add ``n`` (one launch, by default) to ``name`` in a wrapper's
    counter dict; the serve executor's worker threads launch
    concurrently. Inside :func:`recording` the count is recorded for this
    thread instead."""
    rec = getattr(_tls, "record", None)
    if rec is not None:
        rec.append((counters, name, n))
        return
    with _count_lock:
        counters[name] += n


@contextlib.contextmanager
def recording():
    """Record this thread's counts in the yielded list of (counters,
    name, n) instead of adding them: what one replay of a graph captured
    in the block launches."""
    rec = []
    prev = getattr(_tls, "record", None)
    _tls.record = rec
    try:
        yield rec
    finally:
        _tls.record = prev


def add_counts(recorded) -> None:
    """Add counts recorded by :func:`recording` (one replay's), to their
    counters and to :data:`replayed`."""
    with _count_lock:
        for counters, name, n in recorded:
            counters[name] += n
            replayed[name] += n
