"""CountSketch (CWT): the wrappers of csrc/hash_sketch.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_hash.py (``_hash_call``, "exact"
mode): out[h[j]] += v[j]·A[j] columnwise, A·(signed one-hot)ᵀ rowwise,
with the bucket stream h = UniformInt(0, s−1) of sub-stream 0 and the
value stream v = Rademacher of sub-stream 1 of the transform's key —
``randgen.stream_slice``'s layout, so the result equals the reference's
``hash.cwt_serve_apply``. The kernel adds each output's terms in
increasing coordinate order, as the plain scatter does, and every v·a is
exact: the two are bit-equal. ``n0`` makes the operand a shard: its
contracted coordinates are [n0, n0 + n) of the streams, a rank's block of
a mesh-distributed operand (sketch/dtensor_apply.py), whose partials sum
over the ranks to the whole operand's sketch. :func:`cwt_apply_batched`
serves a stacked serve cohort with one launch, the lane a grid axis of
the kernel, as the reference's ``pallas_hash.cwt_apply_batched``.

``cwt_apply(..., out=acc)`` folds a batch of rows into a carried
columnwise accumulator: the kernel starts each (bucket, column) cell at
its value in ``acc`` and adds the batch's rows to it in increasing j, as
the reference's ``SX.at[h].add(v[:, None] * X)`` does
(libskylark_tpu/sessions/state.py, io/streaming.py). Folding a stream
batch by batch at the batches' row offsets so gives the one-shot sketch
of all its rows, bit for bit; ``acc + partial`` would reassociate the
sums and ``index_add_`` on CUDA adds in no fixed order. Its plain version
is the scatter into a clone of ``acc``, in increasing j on the CPU.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`cwt_apply_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import fold_in, key_words
from libskylark_tpu_torch.kernels import launch
from libskylark_tpu_torch.sketch.cuda_dense import (_key_args, host_words,
                                                   lane_words)

# a launch at a shard's offset (n0 > 0) counts under "hash_offset", both
# ways, and not under "hash_rowwise"/"hash_columnwise"
launches = {"hash_rowwise": 0, "hash_columnwise": 0, "hash_batched": 0,
            "hash_offset": 0, "hash_accumulate": 0}

# coordinates per columnwise sort tile of the kernel (csrc/hash_sketch.cu:
# kTile)
TILE = 1024

_lib = None


def streams(key, n: int, s_dim: int, device=None, n0: int = 0):
    """(h, v): the bucket stream (int64) and the ±1 value stream (f32) of
    the coordinates [n0, n0 + n), on ``device``."""
    h = randgen.stream_slice(fold_in(key, 0), randgen.UniformInt(0, s_dim - 1),
                             n0, n0 + n, device=device)
    v = randgen.stream_slice(fold_in(key, 1), randgen.Rademacher(), n0,
                             n0 + n, device=device)
    return h, v


def scatter(h, v, A: torch.Tensor, s_dim: int, rowwise: bool) -> torch.Tensor:
    """The sequential scatter: out[h[j]] += v[j]·A[j] (columnwise) or
    out[:, h[j]] += v[j]·A[:, j] (rowwise), by ``index_add_``. On the CPU
    it adds in increasing j, the order the kernel keeps."""
    v = v.to(A.dtype)
    if rowwise:
        out = torch.zeros((A.shape[0], s_dim), dtype=A.dtype, device=A.device)
        return out.index_add_(1, h, A * v[None, :])
    out = torch.zeros((s_dim, A.shape[1]), dtype=A.dtype, device=A.device)
    return out.index_add_(0, h, v[:, None] * A)


def cwt_apply_plain(key, A: torch.Tensor, s_dim: int, rowwise: bool,
                    n0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of both kernels: the streams of the
    coordinates [n0, n0 + n) made on A's device, then :func:`scatter`."""
    h, v = streams(key, A.shape[1] if rowwise else A.shape[0], s_dim,
                   A.device, n0)
    return scatter(h, v, A, s_dim, rowwise)


def accumulate_plain(key, A: torch.Tensor, s_dim: int, acc: torch.Tensor,
                     n0: int = 0) -> torch.Tensor:
    """The plain version of the accumulate mode: the rows of A, the
    coordinates [n0, n0 + n) of the streams, scattered into a clone of
    ``acc`` (s_dim, m) by ``index_add_`` (in increasing j on the CPU)."""
    h, v = streams(key, A.shape[0], s_dim, A.device, n0)
    return acc.clone().index_add_(0, h, v.to(A.dtype)[:, None] * A)


def supported(dtype) -> bool:
    """The kernel's dispatch rule: float32 operands."""
    return dtype == torch.float32


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("hash_sketch")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.sk_hash_apply.argtypes = ([p] * 5 + [i64] * 5
                                      + [ctypes.c_uint32, ctypes.c_int,
                                         ctypes.c_int, p])
        lib.sk_hash_apply.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(A: torch.Tensor, s_dim: int, ndim: int) -> None:
    launch.refuse_dtensor(A)
    if A.ndim != ndim or s_dim <= 0:
        raise errors.InvalidParametersError(
            f"need a {ndim}-D operand and s_dim > 0, got {tuple(A.shape)}, "
            f"s_dim={s_dim}")
    if not supported(A.dtype):
        raise errors.UnsupportedError(
            f"CountSketch kernel takes float32, got {A.dtype}")
    if A.device.type not in ("cpu", "cuda"):
        raise errors.UnsupportedError(
            f"CountSketch kernel runs on CUDA or CPU, got {A.device}")


def _launch(kd, A: torch.Tensor, s_dim: int, rowwise: bool,
            counter: str, n0: int = 0, out=None) -> torch.Tensor:
    """One launch over the stacked lanes A (B, ., .) on the card, counted
    under ``counter``, the contracted coordinates [n0, n0 + n); ``kd``
    the (B, 2) key words on the host, or already on the card as int32
    (``cuda_dense.device_key``); an empty operand launches and counts
    nothing. ``out`` (B, s_dim, m), columnwise only: the carried sums,
    which the launch adds the lanes' rows to in place."""
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "CountSketch kernel needs a contiguous operand")
    from libskylark_tpu_torch.sketch.cuda_dense import lane_keys

    B = A.shape[0]
    n, m = (A.shape[2], A.shape[1]) if rowwise else A.shape[1:]
    accumulate = out is not None
    if not accumulate:
        out = torch.empty((B, m, s_dim) if rowwise else (B, s_dim, m),
                          dtype=torch.float32, device=A.device)
    if m == 0 or n == 0 or B == 0:
        return out if accumulate else out.zero_()
    keys = (kd.reshape(B, 2) if isinstance(kd, torch.Tensor)
            else lane_keys(kd, A.device))
    if rowwise:
        s0 = torch.empty(B * n * 2, dtype=torch.int32, device=A.device)
        s1 = None
    else:
        tiles = -(-(n0 % TILE + n) // TILE)
        s0 = torch.empty(B * tiles * (s_dim + 1), dtype=torch.int32,
                         device=A.device)
        s1 = torch.empty(B * tiles * TILE, dtype=torch.int32,
                         device=A.device)
    launch.call(_load().sk_hash_apply, A.device, A, keys, out, s0, s1, B, m,
                n, n0, s_dim, randgen.randint_multiplier(s_dim),
                int(rowwise), int(accumulate))
    launch.count(launches, counter)
    return out


def consult_plan(sketch_type: str, A: torch.Tensor, s_dim: int,
                 rowwise: bool) -> None:
    """The reference's plan consultation of a hash apply
    (``pallas_hash.py``), counted under ``tune.plan_cache_lookups``: a
    CUDA tensor takes B2 whatever the plan says, so a plan that names
    another backend is counted ``ignored`` and changes nothing."""
    from libskylark_tpu_torch.sketch import params as sketch_params

    if not sketch_params.get_use_plan_cache():
        return
    from libskylark_tpu_torch import tune
    from libskylark_tpu_torch.tune.cache import count_lookup

    plan = tune.plan_for(tune.hash_workload(
        sketch_type, A.shape, A.dtype, s_dim, 1 if rowwise else 0,
        device_kind=tune.current_device_kind(A.device)))
    if plan is not None and plan.backend != "pallas":
        count_lookup("ignored")


def _check_out(out, A: torch.Tensor, s_dim: int, rowwise: bool) -> None:
    if rowwise:
        raise errors.InvalidParametersError(
            "the CountSketch accumulate mode is columnwise only")
    if (not isinstance(out, torch.Tensor) or out.dtype != A.dtype
            or out.device != A.device
            or tuple(out.shape) != (s_dim, A.shape[1])
            or not out.is_contiguous()):
        raise errors.InvalidParametersError(
            f"out must be a contiguous ({s_dim}, {A.shape[1]}) {A.dtype} "
            f"tensor on {A.device}, got "
            f"{getattr(out, 'shape', type(out))}")


def cwt_apply(key, A: torch.Tensor, s_dim: int, rowwise: bool,
              n0: int = 0, out=None) -> torch.Tensor:
    """CountSketch of A: (n, m) → (s_dim, m) columnwise, (m, n) → (m,
    s_dim) rowwise, its n contracted coordinates [n0, n0 + n) of the
    streams: the batched kernel with one lane. ``key`` is the key data,
    or its words as an int32 tensor on A's device
    (``cuda_dense.device_key``). ``out`` (columnwise): the carried
    accumulator, updated in place and returned (module docstring),
    counted under ``hash_accumulate``."""
    _check(A, s_dim, 2)
    if int(n0) < 0:
        raise errors.InvalidParametersError(
            f"n0 must be non-negative, got {n0}")
    if out is not None:
        _check_out(out, A, s_dim, rowwise)
    if A.device.type == "cpu":
        if out is not None:
            return out.copy_(accumulate_plain(key, A, s_dim, out, int(n0)))
        return cwt_apply_plain(key, A, s_dim, rowwise, int(n0))
    kd = (_key_args(key, A.device)["keys"] if isinstance(key, torch.Tensor)
          else np.asarray(key_words(key), dtype=np.uint32).reshape(1, 2))
    if out is not None:
        _launch(kd, A[None], s_dim, False, "hash_accumulate", int(n0),
                out[None])
        return out
    counter = ("hash_offset" if n0 else
               "hash_rowwise" if rowwise else "hash_columnwise")
    return _launch(kd, A[None], s_dim, rowwise, counter, int(n0))[0]


def cwt_apply_batched(key_data, A: torch.Tensor, s_dim: int,
                      rowwise: bool) -> torch.Tensor:
    """CountSketch of a stacked serve cohort A (B, m, n) rowwise or (B, n,
    m) columnwise, lane b under the key ``key_data[b]`` ((B, 2) uint32
    words, or their (B, 2) int32 tensor on A's device, which the launch
    reads from device memory): one counted launch on the card, the lane a
    grid axis, each lane's bits those of a launch of that lane alone."""
    _check(A, s_dim, 3)
    kd = lane_words(key_data, A.device)
    if kd.shape[0] != A.shape[0]:
        raise errors.InvalidParametersError(
            f"{kd.shape[0]} keys for {A.shape[0]} lanes")
    if A.device.type == "cpu":
        return cwt_apply_batched_plain(kd, A, s_dim, rowwise)
    return _launch(kd, A, s_dim, rowwise, "hash_batched")


def cwt_apply_batched_plain(key_data, A: torch.Tensor, s_dim: int,
                            rowwise: bool) -> torch.Tensor:
    """The plain version of :func:`cwt_apply_batched`, lane by lane."""
    kd = host_words(key_data)
    return torch.stack([cwt_apply_plain(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])
