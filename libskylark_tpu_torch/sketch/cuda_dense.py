"""Fused generate-and-contract dense sketch: the wrappers of
csrc/dense_sketch.cu, their plain versions, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_dense.py (``_fused_call``,
``_fused_call_cw``, ``_fused_call_cos`` and ``_batched_call``): out =
scale · A·Sᵀ (rowwise)
or scale · S·A (columnwise) with S the virtual dense-block operator of
base/randgen.py, generated inside the kernel from the transform's key
(each block key is derived on the card) and never stored; and the random
Fourier feature map outscale · cos((A·Sᵀ)·inscale·sc + sh), the rowwise
kernel with a cos epilogue (:func:`rft_rowwise_apply`); and the batched
sketch of a stacked serve cohort, each lane with its own key and scale
(:func:`serve_batched_apply`), one launch for all lanes.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`dense_apply_plain`,
  :func:`rft_apply_plain` or :func:`serve_batched_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import key_words
from libskylark_tpu_torch.sketch import params as sketch_params
from libskylark_tpu_torch.sketch.dense import BLOCK_COLS, serve_apply

# dist kind codes of the C ABI (csrc/dense_sketch.cu: enum Dist)
_DIST_KINDS = {
    randgen.Normal: 0,
    randgen.Cauchy: 1,
    randgen.Rademacher: 2,
}

launches = {"dense_rowwise": 0, "dense_columnwise": 0,
            "dense_rowwise_cos": 0, "dense_batched_rowwise": 0,
            "dense_batched_columnwise": 0}

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


def dense_apply_plain(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                      rowwise: bool) -> torch.Tensor:
    """The plain PyTorch version of both kernels: S made whole on A's
    device, then one matmul."""
    n = A.shape[1] if rowwise else A.shape[0]
    S = randgen.dense_panel(key, dist, s_dim, 0, n, BLOCK_COLS,
                            torch.float32, A.device)
    return scale * (A @ S.T) if rowwise else scale * (S @ A)


def rft_apply_plain(key, dist, A: torch.Tensor, s_dim: int, inscale: float,
                    outscale: float, sc: torch.Tensor,
                    sh: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the cos-epilogue kernel, in its
    operation order: outscale · cos((A @ Sᵀ)·inscale·sc + sh), S made
    whole on A's device (unscaled: the kernel scales the sum)."""
    S = randgen.dense_panel(key, dist, s_dim, 0, A.shape[1], BLOCK_COLS,
                            torch.float32, A.device)
    return outscale * torch.cos((A @ S.T) * inscale * sc + sh)


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("dense_sketch")
        p, i64, u32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                            ctypes.c_float)
        sig = [p, u32, u32, p, i64, i64, i64, i64, ctypes.c_int, f32, p]
        for fn in (lib.sk_dense_rowwise, lib.sk_dense_columnwise):
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        lib.sk_dense_rowwise_cos.argtypes = [p, u32, u32, p, p, p, i64, i64,
                                             i64, i64, ctypes.c_int, f32, f32,
                                             p]
        lib.sk_dense_rowwise_cos.restype = ctypes.c_int
        lib.sk_dense_batched.argtypes = [ctypes.c_int, p, p, p, p, i64, i64,
                                         i64, i64, ctypes.c_int, p]
        lib.sk_dense_batched.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(dist, A, s_dim: int, precision) -> bool:
    """Checks shared by the wrappers; True when A lies on the CPU (the
    plain version's case)."""
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
        return True
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"dense sketch kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "dense sketch kernel needs a contiguous operand")
    return False


def _apply(key, dist, A, s_dim: int, scale: float, precision, rowwise: bool):
    if _check(dist, A, s_dim, precision):
        return dense_apply_plain(key, dist, A, s_dim, scale, rowwise)
    n, m = (A.shape[1], A.shape[0]) if rowwise else A.shape
    out = torch.empty((m, s_dim) if rowwise else (s_dim, m),
                      dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    from libskylark_tpu_torch.kernels import launch

    lib = _load()
    fn = lib.sk_dense_rowwise if rowwise else lib.sk_dense_columnwise
    launch.call(fn, A.device, A.data_ptr(), *key_words(key), out.data_ptr(),
                m, n, s_dim, A.shape[1], _DIST_KINDS[type(dist)],
                float(scale))
    launch.count(launches,
                 "dense_rowwise" if rowwise else "dense_columnwise")
    return out


def rowwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                  precision: str | None = None) -> torch.Tensor:
    """out = scale · A @ Sᵀ for A (m, N) float32 → (m, s_dim)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=True)


def columnwise_apply(key, dist, A: torch.Tensor, s_dim: int, scale: float,
                     precision: str | None = None) -> torch.Tensor:
    """out = scale · S @ A for A (N, m) float32 → (s_dim, m)."""
    return _apply(key, dist, A, s_dim, scale, precision, rowwise=False)


def rft_rowwise_apply(key, dist, A: torch.Tensor, s_dim: int, inscale: float,
                      outscale: float, sc: torch.Tensor, sh: torch.Tensor,
                      precision: str | None = None) -> torch.Tensor:
    """out = outscale · cos((A @ Sᵀ)·inscale·sc + sh) for A (m, N)
    float32 → (m, s_dim); ``sc``/``sh`` are (s_dim,) per-feature scales
    and shifts."""
    cpu = _check(dist, A, s_dim, precision)
    sc = sc.to(device=A.device, dtype=torch.float32).contiguous()
    sh = sh.to(device=A.device, dtype=torch.float32).contiguous()
    if sc.shape != (s_dim,) or sh.shape != (s_dim,):
        raise errors.InvalidParametersError(
            f"sc and sh must have shape ({s_dim},), got {tuple(sc.shape)} "
            f"and {tuple(sh.shape)}")
    if cpu:
        return rft_apply_plain(key, dist, A, s_dim, inscale, outscale, sc, sh)
    m, n = A.shape
    out = torch.empty((m, s_dim), dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    from libskylark_tpu_torch.kernels import launch

    launch.call(_load().sk_dense_rowwise_cos, A.device, A.data_ptr(),
                *key_words(key), sc.data_ptr(), sh.data_ptr(), out.data_ptr(),
                m, n, s_dim, A.shape[1], _DIST_KINDS[type(dist)],
                float(inscale), float(outscale))
    launch.count(launches, "dense_rowwise_cos")
    return out


def serve_batched_plain(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool) -> torch.Tensor:
    """The plain PyTorch version of the batched kernel: ``dense.serve_apply``
    lane by lane (the scaled operator, then the product)."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    sc = np.asarray(scale).reshape(-1)
    return torch.stack([serve_apply(kd[i], float(sc[i]), A[i], dist=dist,
                                    s_dim=s_dim, rowwise=rowwise)
                        for i in range(A.shape[0])])


def lane_keys(key_data, device) -> torch.Tensor:
    """(B, 2) uint32 key words as an int32 tensor on ``device`` (the
    kernels read the bits as uint32)."""
    kd = np.ascontiguousarray(np.asarray(key_data, dtype=np.uint32)
                              .reshape(-1, 2))
    return torch.from_numpy(kd.view(np.int32)).to(device)


def serve_batched_apply(key_data, scale, A: torch.Tensor, dist, s_dim: int,
                        rowwise: bool) -> torch.Tensor:
    """The batched sketch of a stacked cohort: A (B, m, n) rowwise → (B,
    m, s_dim), A (B, n, m) columnwise → (B, s_dim, m); lane b under the
    key ``key_data[b]`` ((B, 2) uint32 words) and scaled by ``scale[b]``.
    Lane b's result does not depend on B."""
    if not supported(dist, A.dtype):
        raise errors.UnsupportedError(
            f"dense sketch kernel takes standard normal/cauchy/rademacher "
            f"and float32, got {dist!r} and {A.dtype}")
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    sc = np.asarray(scale, dtype=np.float32).reshape(-1)
    if A.ndim != 3 or s_dim <= 0 or kd.shape[0] != A.shape[0] or \
            sc.shape[0] != A.shape[0]:
        raise errors.InvalidParametersError(
            f"need a (B, ., .) operand with B keys and B scales and s_dim "
            f"> 0, got {tuple(A.shape)}, {kd.shape[0]} keys, {sc.shape[0]} "
            f"scales, s_dim={s_dim}")
    if A.device.type == "cpu":
        return serve_batched_plain(kd, sc, A, dist, s_dim, rowwise)
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"dense sketch kernel runs on CUDA or CPU, got {A.device}")
    if not A.is_contiguous():
        raise errors.InvalidParametersError(
            "dense sketch kernel needs a contiguous operand")
    B = A.shape[0]
    n, m = (A.shape[2], A.shape[1]) if rowwise else (A.shape[1], A.shape[2])
    out = torch.empty((B, m, s_dim) if rowwise else (B, s_dim, m),
                      dtype=torch.float32, device=A.device)
    if B == 0 or m == 0:
        return out
    from libskylark_tpu_torch.kernels import launch

    keys = lane_keys(kd, A.device)
    scales = torch.from_numpy(sc.copy()).to(A.device)
    launch.call(_load().sk_dense_batched, A.device, int(rowwise),
                A.data_ptr(), keys.data_ptr(), scales.data_ptr(),
                out.data_ptr(), B, m, n, s_dim, _DIST_KINDS[type(dist)])
    launch.count(launches, "dense_batched_rowwise" if rowwise
                 else "dense_batched_columnwise")
    return out
