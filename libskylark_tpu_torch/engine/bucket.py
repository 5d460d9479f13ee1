"""Shape classes for microbatch serving: the pow2 pad-and-mask policy (the
port of libskylark_tpu/engine/bucket.py).

The executor (:mod:`libskylark_tpu_torch.engine.serve`) groups requests
into buckets: the same endpoint statics, dtype and **shape class**, every
paddable extent rounded up to the next power of two (at least
``PAD_FLOOR``). Padding is exact, not approximate: the sketch streams are
positional, so zero-padded coordinates add exact zeros.

A cohort of k requests runs at the **capacity class**, the power of two ≥
k clamped to ``max_batch``; filler lanes replicate the last real request
(never zeros: a zero operand can reach degenerate branches, and a filler
lane must cost exactly one real lane). Every lane runs the same program,
so its bits do not depend on the capacity. ``padding_waste`` is
1 − real elements / padded elements over the primary operand.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# Smallest padded extent: extents below it share one class.
PAD_FLOOR = 8


def pow2_pad(n: int, floor: int = PAD_FLOOR) -> int:
    """The shape class of extent ``n``: next power of two ≥ max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def pad_shape(shape: Sequence[int], pad_axes: Sequence[int],
              floor: int = PAD_FLOOR) -> tuple[int, ...]:
    """Round the extents named by ``pad_axes`` up to their pow2 class; the
    other extents are exact bucket components."""
    pad_axes = set(int(a) for a in pad_axes)
    return tuple(pow2_pad(e, floor) if i in pad_axes else int(e)
                 for i, e in enumerate(shape))


def nnz_class(nnz: int, floor: int = 64) -> int:
    """The nnz class of a sparse operand: next power of two ≥ max(nnz,
    floor). Ragged-nnz requests in one class pad their (data, indices)
    lanes to it and share a flush; padding entries are value 0.0 at
    index 0, exact zeros through every sparse endpoint."""
    return pow2_pad(nnz, max(int(floor), 1))


def capacity_class(k: int, max_batch: int, multiple: int = 1) -> int:
    """Batch capacity for a cohort of ``k`` requests: pow2 ≥ k, clamped to
    ``max_batch``, then rounded up to ``multiple``."""
    cap = min(1 << (max(int(k), 1) - 1).bit_length(), int(max_batch))
    m = max(int(multiple), 1)
    cap = ((cap + m - 1) // m) * m
    return max(cap, 1)


def capacity_ladder(max_batch: int, multiple: int = 1) -> tuple:
    """Every capacity class reachable up to ``max_batch``, ascending — a
    non-pow2 ``max_batch`` adds itself as the top rung."""
    rungs = []
    k = 1
    while k <= int(max_batch):
        cap = capacity_class(k, max_batch, multiple)
        if not rungs or cap != rungs[-1]:
            rungs.append(cap)
        k <<= 1
    top = capacity_class(int(max_batch), max_batch, multiple)
    if top != rungs[-1]:
        rungs.append(top)
    return tuple(rungs)


def stack_pad(arrays: Sequence[np.ndarray], padded_shape: Sequence[int],
              capacity: int, dtype, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """One host (capacity, *padded_shape) buffer holding every request's
    operand zero-padded into its leading corner, filler lanes replicating
    the last real request (written into ``out``, zeros of that shape and
    dtype, when given)."""
    padded_shape = tuple(int(e) for e in padded_shape)
    if out is None:
        out = np.zeros((int(capacity),) + padded_shape, dtype=dtype)
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        out[(i,) + tuple(slice(0, e) for e in a.shape)] = a
    for i in range(len(arrays), int(capacity)):
        out[i] = out[len(arrays) - 1]
    return out


def stack_pad_tensor(arrays: Sequence, padded_shape: Sequence[int],
                     capacity: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """:func:`stack_pad` as a tensor on ``device``. Host operands (numpy
    arrays or CPU tensors) are stacked into one host buffer and copied to
    the device once; operands already on the device are stacked there."""
    device = torch.device(device)
    if all(not isinstance(a, torch.Tensor) or a.device.type == "cpu"
           for a in arrays):
        # torch's allocator aligns the host buffer (64 bytes) as it aligns
        # a lane's fresh copy, so the CPU programs see one alignment
        host = torch.zeros((int(capacity),) + tuple(int(e) for e in
                                                    padded_shape),
                           dtype=dtype)
        stack_pad([a.numpy() if isinstance(a, torch.Tensor) else a
                   for a in arrays], padded_shape, capacity, None,
                  out=host.numpy())
        return host.to(device)
    out = torch.zeros((int(capacity),) + tuple(int(e) for e in padded_shape),
                      dtype=dtype, device=device)
    for i, a in enumerate(arrays):
        a = torch.as_tensor(a).to(device=device, dtype=dtype)
        out[(i,) + tuple(slice(0, e) for e in a.shape)] = a
    if len(arrays) < int(capacity):
        out[len(arrays):] = out[len(arrays) - 1]
    return out


def padded_elements(padded_shape: Sequence[int], capacity: int) -> int:
    return int(capacity) * int(np.prod([int(e) for e in padded_shape]))


def real_elements(shapes: Sequence[Sequence[int]]) -> int:
    return int(sum(int(np.prod([int(e) for e in s])) for s in shapes))


def result_nbytes(value) -> int:
    """Bytes of one serve result, for cache and residency quotas: an
    array or tensor counts its buffer, a tuple, list or dict 64 bytes
    plus its members, bytes their length, anything else 64."""
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, torch.Tensor):
        return int(value.numel() * value.element_size())
    if isinstance(value, (tuple, list)):
        return 64 + sum(result_nbytes(v) for v in value)
    if isinstance(value, dict):
        return 64 + sum(result_nbytes(v) for v in value.values())
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    return 64
