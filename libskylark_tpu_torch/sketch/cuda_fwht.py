"""Panel-free SRHT: the wrappers of csrc/fwht_sketch.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_fwht.py (``_fwht_call``):
out = √(n/s)·gather(FWHT_n((1/√n)·D ⊙ a), idx) along the transform axis,
with the sign diagonal D = Rademacher of sub-stream 0 and the sampled
coordinates idx = UniformInt(0, n−1) of sub-stream 1 of the transform's
key, in ``randgen.stream_slice``'s layout: the function the reference's
``fjlt.srht_serve_apply`` computes, and ``FJLT(n, s, fut="wht").apply``.
n is a power of two ≥ 128 and s ≤ 2048. :func:`srht_apply_batched` serves
a stacked serve cohort with one launch, the lane a grid axis of the
kernel, as the reference's ``pallas_fwht.srht_apply_batched``.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`srht_apply_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import fold_in, key_words
from libskylark_tpu_torch.kernels import launch
from libskylark_tpu_torch.sketch.cuda_dense import (_key_args, host_words,
                                                   lane_words)
from libskylark_tpu_torch.sketch import fut

launches = {"fwht_rowwise": 0, "fwht_columnwise": 0, "fwht_batched": 0}

MIN_N = 128
MAX_S = 2048

_lib = None


def scales(n: int, s_dim: int) -> tuple[float, float]:
    """(fut_scale, samp_scale) = (1/√n, √(n/s))."""
    return 1.0 / math.sqrt(n), math.sqrt(n / s_dim)


def streams(key, n: int, s_dim: int, dtype=torch.float32, device=None):
    """(D, idx): the ±1 diagonal (``dtype``) and the s sampled
    coordinates (int64), on ``device``."""
    D = randgen.stream_slice(fold_in(key, 0), randgen.Rademacher(), 0, n,
                             dtype, device)
    idx = randgen.stream_slice(fold_in(key, 1), randgen.UniformInt(0, n - 1),
                               0, s_dim, device=device)
    return D, idx


def srht_apply_plain(key, A: torch.Tensor, s_dim: int,
                     rowwise: bool) -> torch.Tensor:
    """The plain PyTorch version of both kernels: the streams made on A's
    device, then ``fut.fwht_sketch`` — the reference's op order."""
    n = A.shape[1] if rowwise else A.shape[0]
    D, idx = streams(key, n, s_dim, A.dtype, A.device)
    return fut.fwht_sketch(A, D, idx, *scales(n, s_dim),
                           axis=1 if rowwise else 0)


def supported(n: int, s_dim: int, dtype) -> bool:
    """The kernel's dispatch rule: n a power of two ≥ 128, 1 ≤ s ≤ 2048,
    float32."""
    return (n >= MIN_N and not n & (n - 1) and 1 <= s_dim <= MAX_S
            and dtype == torch.float32)


def plan(n: int, m: int, rowwise: bool) -> dict:
    """The order of a lane's adds, which the CPU replay of the kernel reads:
    ``seg_bits`` K, the segment length 2^K (the whole vector rowwise up to
    2^14, columnwise up to 2^11); ``segments`` n / 2^K; ``groups``, the
    runs the segments are cut into, each run's sums added in run order by
    a second kernel. It mirrors ``lane_groups`` of csrc/fwht_sketch.cu,
    the one the wrapper asks (``sk_fwht_groups``): a fold's blocks take 1
    row or 8 columns, and the runs double until a lane has 132 blocks (an
    H100's SMs; a constant, so a lane's bits depend on its shape alone,
    never on the card or the lane count)."""
    k = n.bit_length() - 1
    K = min(k, 14 if rowwise else 11)
    segments = 1 << (k - K)
    blocks = m if rowwise else -(-m // 8)
    groups = 1
    while groups < segments and blocks * groups < 132:
        groups *= 2
    return {"seg_bits": K, "segments": segments, "groups": groups}


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("fwht_sketch")
        p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.sk_fwht_apply.argtypes = [p] * 6 + [i64] * 4 + [ctypes.c_int,
                                                          f32, f32, p]
        lib.sk_fwht_apply.restype = ctypes.c_int
        lib.sk_fwht_groups.argtypes = [i64, i64, ctypes.c_int]
        lib.sk_fwht_groups.restype = i64
        _lib = lib
    return _lib


def _check(A: torch.Tensor, s_dim: int, rowwise: bool, ndim: int) -> None:
    launch.refuse_dtensor(A)
    if A.ndim != ndim:
        raise errors.InvalidParametersError(
            f"need a {ndim}-D operand, got {tuple(A.shape)}")
    n = A.shape[-1] if rowwise else A.shape[-2]
    if not supported(n, s_dim, A.dtype):
        raise errors.UnsupportedError(
            f"SRHT kernel takes float32, n a power of two >= {MIN_N} and "
            f"1 <= s <= {MAX_S}; got {A.dtype}, n={n}, s={s_dim}")
    if A.device.type not in ("cpu", "cuda"):
        raise errors.UnsupportedError(
            f"SRHT kernel runs on CUDA or CPU, got {A.device}")


def _launch(kd, A: torch.Tensor, s_dim: int, rowwise: bool,
            counter: str) -> torch.Tensor:
    """One launch over the stacked lanes A (B, ., .) on the card, counted
    under ``counter``; ``kd`` the (B, 2) key words on the host, or
    already on the card as int32 (``cuda_dense.device_key``); an empty
    operand launches and counts nothing."""
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "SRHT kernel needs a contiguous operand")
    from libskylark_tpu_torch.sketch.cuda_dense import lane_keys

    B = A.shape[0]
    n, m = (A.shape[2], A.shape[1]) if rowwise else A.shape[1:]
    out = torch.empty((B, m, s_dim) if rowwise else (B, s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0 or B == 0:
        return out
    lib = _load()
    groups = lib.sk_fwht_groups(m, n, int(rowwise))
    keys = (kd.reshape(B, 2) if isinstance(kd, torch.Tensor)
            else lane_keys(kd, A.device))
    D = torch.empty((B, n), dtype=torch.float32, device=A.device)
    idx = torch.empty((B, s_dim), dtype=torch.int32, device=A.device)
    part = (torch.empty((B, groups, m * s_dim), dtype=torch.float32,
                        device=A.device) if groups > 1 else None)
    launch.call(lib.sk_fwht_apply, A.device, A, keys, D, idx, part, out, B,
                m, n, s_dim, int(rowwise), *scales(n, s_dim))
    launch.count(launches, counter)
    return out


def srht_apply(key, A: torch.Tensor, s_dim: int,
               rowwise: bool) -> torch.Tensor:
    """SRHT of A: (n, m) → (s_dim, m) columnwise, (m, n) → (m, s_dim)
    rowwise: the batched kernel with one lane. ``key`` is the key data,
    or its words as an int32 tensor on A's device
    (``cuda_dense.device_key``)."""
    _check(A, s_dim, rowwise, 2)
    if A.device.type == "cpu":
        return srht_apply_plain(key, A, s_dim, rowwise)
    kd = (_key_args(key, A.device)["keys"] if isinstance(key, torch.Tensor)
          else np.asarray(key_words(key), dtype=np.uint32).reshape(1, 2))
    return _launch(kd, A[None], s_dim, rowwise,
                   "fwht_rowwise" if rowwise else "fwht_columnwise")[0]


def srht_apply_batched(key_data, A: torch.Tensor, s_dim: int,
                       rowwise: bool) -> torch.Tensor:
    """SRHT of a stacked serve cohort A (B, m, n) rowwise or (B, n, m)
    columnwise, lane b under the key ``key_data[b]`` ((B, 2) uint32
    words, or their (B, 2) int32 tensor on A's device, which the launch
    reads from device memory): one counted launch on the card, the lane a
    grid axis, each lane's bits those of a launch of that lane alone."""
    _check(A, s_dim, rowwise, 3)
    kd = lane_words(key_data, A.device)
    if kd.shape[0] != A.shape[0]:
        raise errors.InvalidParametersError(
            f"{kd.shape[0]} keys for {A.shape[0]} lanes")
    if A.device.type == "cpu":
        return srht_apply_batched_plain(kd, A, s_dim, rowwise)
    return _launch(kd, A, s_dim, rowwise, "fwht_batched")


def srht_apply_batched_plain(key_data, A: torch.Tensor, s_dim: int,
                             rowwise: bool) -> torch.Tensor:
    """The plain version of :func:`srht_apply_batched`, lane by lane."""
    kd = host_words(key_data)
    return torch.stack([srht_apply_plain(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])
