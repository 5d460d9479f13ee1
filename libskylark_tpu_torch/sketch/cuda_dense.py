"""Fused generate-and-contract dense sketch: the wrappers of
csrc/dense_sketch.cu, their plain versions, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_dense.py (``_fused_call`` and
``_fused_call_cw``): out = scale · A·Sᵀ (rowwise) or scale · S·A
(columnwise) with S the virtual dense-block operator of base/randgen.py,
generated inside the kernel from the per-block key table and never
stored.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`dense_apply_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch import params as sketch_params
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS

# dist kind codes of the C ABI (csrc/dense_sketch.cu: enum Dist)
_DIST_KINDS = {
    randgen.Normal: 0,
    randgen.Cauchy: 1,
    randgen.Rademacher: 2,
}

launches = {"dense_rowwise": 0, "dense_columnwise": 0}

_lib = None


def supported(dist, dtype) -> bool:
    """The kernel's dispatch rule (the reference's ``supported``): the
    standard Normal, Cauchy or Rademacher distribution, float32."""
    if type(dist) not in _DIST_KINDS:
        return False
    if isinstance(dist, randgen.Normal) and (dist.mean, dist.std) != (0, 1):
        return False
    if isinstance(dist, randgen.Cauchy) and (dist.loc, dist.scale) != (0, 1):
        return False
    return dtype == torch.float32


def block_keys(key, n: int, device) -> torch.Tensor:
    """The kernel's key table on ``device``: (ceil(n/BLOCK_COLS), 2) int32
    holding the uint32 words of ``chunk_key(key, b)`` for each column
    block b. Made on the host and uploaded from pinned memory, so the copy
    does not wait for the stream."""
    keys = randgen.chunk_keys(key, 0, -(-n // BLOCK_COLS)).view(np.int32)
    host = torch.from_numpy(keys)
    if torch.device(device).type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def dense_apply_plain(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                      rowwise: bool) -> torch.Tensor:
    """The plain PyTorch version of both kernels: S made whole on A's
    device, then one matmul."""
    n = A.shape[1] if rowwise else A.shape[0]
    S = randgen.dense_panel(key, dist, s_dim, 0, n, BLOCK_COLS,
                            torch.float32, A.device)
    return scale * (A @ S.T) if rowwise else scale * (S @ A)


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("dense_sketch")
        sig = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_int64, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p]
        for fn in (lib.sk_dense_rowwise, lib.sk_dense_columnwise):
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _apply(key, dist, A, s_dim: int, scale: float, precision, rowwise: bool):
    sketch_params.check_kernel_precision(
        precision or sketch_params.get_kernel_precision())
    if not supported(dist, A.dtype):
        raise errors.UnsupportedError(
            f"dense sketch kernel takes standard normal/cauchy/rademacher "
            f"and float32, got {dist!r} and {A.dtype}")
    if A.ndim != 2 or s_dim <= 0:
        raise errors.InvalidParametersError(
            f"need a 2-D operand and s_dim > 0, got {tuple(A.shape)}, "
            f"s_dim={s_dim}")
    if A.device.type == "cpu":
        return dense_apply_plain(key, dist, A, s_dim, scale, rowwise)
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"dense sketch kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "dense sketch kernel needs a contiguous operand")
    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    keys = block_keys(key, n, A.device)
    lib = _load()
    fn = lib.sk_dense_rowwise if rowwise else lib.sk_dense_columnwise
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), keys.data_ptr(), out.data_ptr(), m, n, s_dim,
                A.shape[1], _DIST_KINDS[type(dist)], float(scale), stream)
    if rc != 0:
        raise errors.SketchError(
            f"dense sketch kernel launch failed: CUDA error {rc}")
    launches["dense_rowwise" if rowwise else "dense_columnwise"] += 1
    return out


def rowwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                  precision: str | None = None) -> torch.Tensor:
    """out = scale · A @ Sᵀ for A (m, N) float32 → (m, s_dim)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=True)


def columnwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                     precision: str | None = None) -> torch.Tensor:
    """out = scale · S @ A for A (N, m) float32 → (s_dim, m)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=False)
