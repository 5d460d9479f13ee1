"""CountSketch (CWT): the wrappers of csrc/hash_sketch.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_hash.py (``_hash_call``, "exact"
mode): out[h[j]] += v[j]·A[j] columnwise, A·(signed one-hot)ᵀ rowwise,
with the bucket stream h = UniformInt(0, s−1) of sub-stream 0 and the
value stream v = Rademacher of sub-stream 1 of the transform's key —
``randgen.stream_slice``'s layout, so the result equals the reference's
``hash.cwt_serve_apply``. The kernel adds each output's terms in
increasing coordinate order, as the plain scatter does, and every v·a is
exact: the two are bit-equal. :func:`cwt_apply_batched` serves a stacked
serve cohort with one launch per lane (the kernel has no lane axis yet).

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

launches = {"hash_rowwise": 0, "hash_columnwise": 0}

# coordinates per sort tile of the kernel (csrc/hash_sketch.cu: kTile)
TILE = 1024

_lib = None


def streams(key, n: int, s_dim: int, device=None):
    """(h, v): the bucket stream (int64) and the ±1 value stream (f32) of
    the first ``n`` coordinates, on ``device``."""
    h = randgen.stream_slice(fold_in(key, 0), randgen.UniformInt(0, s_dim - 1),
                             0, n, device=device)
    v = randgen.stream_slice(fold_in(key, 1), randgen.Rademacher(), 0, n,
                             device=device)
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


def cwt_apply_plain(key, A: torch.Tensor, s_dim: int,
                    rowwise: bool) -> torch.Tensor:
    """The plain PyTorch version of both kernels: the streams made on A's
    device, then :func:`scatter`."""
    h, v = streams(key, A.shape[1] if rowwise else A.shape[0], s_dim,
                   A.device)
    return scatter(h, v, A, s_dim, rowwise)


def supported(dtype) -> bool:
    """The kernel's dispatch rule: float32 operands."""
    return dtype == torch.float32


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("hash_sketch")
        p, u32 = ctypes.c_void_p, ctypes.c_uint32
        sig = [p, u32, u32] + [p] * 4 + [ctypes.c_int64] * 4 + [u32, p]
        for fn in (lib.sk_hash_rowwise, lib.sk_hash_columnwise):
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def cwt_apply(key, A: torch.Tensor, s_dim: int,
              rowwise: bool) -> torch.Tensor:
    """CountSketch of A: (n, m) → (s_dim, m) columnwise, (m, n) → (m,
    s_dim) rowwise."""
    if A.ndim != 2 or s_dim <= 0:
        raise errors.InvalidParametersError(
            f"need a 2-D operand and s_dim > 0, got {tuple(A.shape)}, "
            f"s_dim={s_dim}")
    if not supported(A.dtype):
        raise errors.UnsupportedError(
            f"CountSketch kernel takes float32, got {A.dtype}")
    if A.device.type == "cpu":
        return cwt_apply_plain(key, A, s_dim, rowwise)
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"CountSketch kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "CountSketch kernel needs a contiguous operand")
    from libskylark_tpu_torch.kernels import launch

    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0 or n == 0:
        return out.zero_()
    tiles = -(-n // TILE)
    off = torch.empty(tiles * (s_dim + 1), dtype=torch.int32, device=A.device)
    idx = torch.empty(tiles * TILE, dtype=torch.int32, device=A.device)
    val = torch.empty(tiles * TILE, dtype=torch.float32, device=A.device)
    lib = _load()
    fn = lib.sk_hash_rowwise if rowwise else lib.sk_hash_columnwise
    launch.call(fn, A.device, A.data_ptr(), *key_words(key), out.data_ptr(),
                off.data_ptr(), idx.data_ptr(), val.data_ptr(), m, n, s_dim,
                A.shape[1], randgen.randint_multiplier(s_dim))
    launch.count(launches,
                 "hash_rowwise" if rowwise else "hash_columnwise")
    return out


def cwt_apply_batched(key_data, A: torch.Tensor, s_dim: int,
                      rowwise: bool) -> torch.Tensor:
    """CountSketch of a stacked serve cohort A (B, ., .), lane b under the
    key ``key_data[b]`` ((B, 2) uint32 words): one :func:`cwt_apply` per
    lane, so one counted launch per lane on the card (the kernel has no
    lane axis yet)."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return torch.stack([cwt_apply(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])


def cwt_apply_batched_plain(key_data, A: torch.Tensor, s_dim: int,
                            rowwise: bool) -> torch.Tensor:
    """The plain version of :func:`cwt_apply_batched`, lane by lane."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return torch.stack([cwt_apply_plain(kd[i], A[i], s_dim, rowwise)
                        for i in range(A.shape[0])])
