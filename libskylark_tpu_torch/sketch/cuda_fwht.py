"""Panel-free SRHT: the wrappers of csrc/fwht_sketch.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_fwht.py (``_fwht_call``):
out = √(n/s)·gather(FWHT_n((1/√n)·D ⊙ a), idx) along the transform axis,
with the sign diagonal D = Rademacher of sub-stream 0 and the sampled
coordinates idx = UniformInt(0, n−1) of sub-stream 1 of the transform's
key, in ``randgen.stream_slice``'s layout: the function the reference's
``fjlt.srht_serve_apply`` computes, and ``FJLT(n, s, fut="wht").apply``.
n is a power of two ≥ 128 and s ≤ 2048. :func:`srht_apply_batched` serves
a stacked serve cohort with one launch per lane (the kernel has no lane
axis yet).

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
from libskylark_tpu_torch.sketch import fut

launches = {"fwht_rowwise": 0, "fwht_columnwise": 0}

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


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("fwht_sketch")
        p, i64, u32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                            ctypes.c_float)
        lib.sk_fwht_rowwise.argtypes = [p, u32, u32, p, p, p, i64, i64, i64,
                                        i64, f32, f32, p]
        lib.sk_fwht_columnwise.argtypes = [p, u32, u32, p, p, p, p, i64, i64,
                                           i64, i64, f32, f32, p]
        for fn in (lib.sk_fwht_rowwise, lib.sk_fwht_columnwise):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def srht_apply(key, A: torch.Tensor, s_dim: int,
               rowwise: bool) -> torch.Tensor:
    """SRHT of A: (n, m) → (s_dim, m) columnwise, (m, n) → (m, s_dim)
    rowwise."""
    if A.ndim != 2:
        raise errors.InvalidParametersError(
            f"need a 2-D operand, got {tuple(A.shape)}")
    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    if not supported(n, s_dim, A.dtype):
        raise errors.UnsupportedError(
            f"SRHT kernel takes float32, n a power of two >= {MIN_N} and "
            f"1 <= s <= {MAX_S}; got {A.dtype}, n={n}, s={s_dim}")
    if A.device.type == "cpu":
        return srht_apply_plain(key, A, s_dim, rowwise)
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"SRHT kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "SRHT kernel needs a contiguous operand")
    from libskylark_tpu_torch.kernels import launch

    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    D = torch.empty(n, dtype=torch.float32, device=A.device)
    idx = torch.empty(s_dim, dtype=torch.int32, device=A.device)
    fut_scale, samp_scale = scales(n, s_dim)
    lib = _load()
    if rowwise:
        launch.call(lib.sk_fwht_rowwise, A.device, A.data_ptr(),
                    *key_words(key), D.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), m, n, s_dim, A.shape[1], fut_scale,
                    samp_scale)
    else:
        Y = torch.empty((n, m), dtype=torch.float32, device=A.device)
        launch.call(lib.sk_fwht_columnwise, A.device, A.data_ptr(),
                    *key_words(key), D.data_ptr(), idx.data_ptr(),
                    Y.data_ptr(), out.data_ptr(), m, n, s_dim, A.shape[1],
                    fut_scale, samp_scale)
    launch.count(launches,
                 "fwht_rowwise" if rowwise else "fwht_columnwise")
    return out


def srht_apply_batched(key_data, A: torch.Tensor, s_dim: int,
                       rowwise: bool) -> torch.Tensor:
    """SRHT of a stacked serve cohort A (B, ., .), lane b under the key
    ``key_data[b]`` ((B, 2) uint32 words): one :func:`srht_apply` per
    lane, so one counted launch per lane on the card (the kernel has no
    lane axis yet)."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return torch.stack([srht_apply(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])


def srht_apply_batched_plain(key_data, A: torch.Tensor, s_dim: int,
                             rowwise: bool) -> torch.Tensor:
    """The plain version of :func:`srht_apply_batched`, lane by lane."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return torch.stack([srht_apply_plain(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])
