"""What every kernel wrapper does around a launch: call the C function on
PyTorch's current stream, and raise on a CUDA error (the launch never
ran). The kernels take the transform's 2-word key and derive every chunk
key on the card, so a launch needs no table from the host."""

from __future__ import annotations

import threading

import torch

from libskylark_tpu_torch.base import errors


def call(fn, device, *args) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream; raises
    SketchError with the CUDA error code when the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise errors.SketchError(
            f"{fn.__name__} launch failed: CUDA error {rc}")


_count_lock = threading.Lock()


def count(counters: dict, name: str, n: int = 1) -> None:
    """Add ``n`` (one launch, by default) to ``name`` in a wrapper's
    counter dict; the serve executor's worker threads launch
    concurrently."""
    with _count_lock:
        counters[name] += n
