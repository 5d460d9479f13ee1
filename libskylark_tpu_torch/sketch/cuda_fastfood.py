"""Fastfood feature map: the wrappers of csrc/fastfood.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_fastfood.py (``_launch``,
``_launch_split`` and ``_launch_batched``): for each row x of A (m, N)
and block b,
scale·cos((scal·Sm_b) ⊙ H((scal·G_b) ⊙ Π_b(H(B_b ⊙ x))) + shift_b), H the
unnormalized Walsh–Hadamard transform of length NB (x zero-padded to NB),
Π_b gathering ``out[j] = in[perm_b[j]]``, the features block-major and
truncated to S — what ``FastRFT._features_rows`` computes. The streams
(B, scal·G, scal·Sm, the permutations, the shifts zero-padded past S) are
made on the card by the transform's torch streams and passed to the
kernel, as the TPU kernel receives them.

Variants: ``"fused"`` (one kernel, the gather in shared memory; what
``"auto"`` means, since the card has no compiler that could refuse the
gather) and ``"split"`` (a kernel up to the gather, ``torch.gather`` in
the place of XLA's ``take_along_axis``, a kernel after it).
:func:`serve_features_batched` runs the fused chain over a stacked serve
cohort, each lane with its own transform's streams (made for all lanes at
once by ``frft.serve_streams``), in one launch.

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`fastfood_plain` or
  :func:`serve_features_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.kernels import launch

launches = {"fastfood": 0, "fastfood_split": 0, "fastfood_batched": 0}

# The largest block the kernel serves (csrc/fastfood.cu: kMaxNB): 1024
# threads of 16 values and three NB-float exchange buffers.
MAX_NB = 16384
# Blocks along one lane's rows that the plan aims for: enough to fill the
# card's 132 SMs several times over from a single lane and block.
ROW_BLOCKS = 1024
_MAX_ROWS = 16

_lib = None


def plan(NB: int, m: int) -> dict:
    """The kernel's block shape for one lane of m rows and Fastfood blocks
    of NB (csrc/fastfood.cu ``Shape``; only ``rows`` is passed to it):
    ``levels`` L = min(4, log2 NB), each thread holding 2^L values of a
    row; ``threads`` per row group NB / 2^L; ``groups`` row groups a block
    (a block has at least 256 threads); ``rows`` each group takes, so a
    block reads its streams once for ``rows·groups`` rows; ``smem`` the
    three exchange buffers' bytes (two for the exchanges that cross warps,
    one for those that stay in a warp); ``grid_rows`` blocks along the
    rows. It reads one lane's shape, never the lane count, and changes no
    bit of the result."""
    k = NB.bit_length() - 1
    L = min(4, k)
    T = NB >> L
    groups = 1 if T >= 256 else 256 // T
    rows = max(1, min(_MAX_ROWS, m // (groups * ROW_BLOCKS)))
    return {"levels": L, "threads": T, "groups": groups,
            "block": groups * T, "rows": rows,
            "smem": 3 * groups * NB * 4,
            "grid_rows": -(-m // (groups * rows))}


def supported(NB: int, dtype) -> bool:
    """The kernel's dispatch rule: NB a power of two in [2, MAX_NB],
    float32."""
    return (2 <= NB <= MAX_NB and not NB & (NB - 1)
            and dtype == torch.float32)


def kernel_streams(transform, device=None):
    """(bdiag, perms, gdiag, smdiag, shifts), each (numblks, NB) on
    ``device``: B, the permutations (int64), scal·G and scal·Sm, and the
    shifts zero-padded past S (features past S are computed, then
    dropped)."""
    T = transform
    NB, nb = T._NB, T._numblks
    f32 = torch.float32
    sh = T.shifts(f32, device)
    sh = torch.nn.functional.pad(sh, (0, nb * NB - T._S)).reshape(nb, NB)
    return (T._B(f32, device), T._perms(device), T.scal * T._G(f32, device),
            (T.scal * T._Sm(f32, device)).reshape(nb, NB), sh)


def fastfood_plain(transform, A: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of both variants: the transform's torch
    chain (``frft._chain_rows`` with the WHT) on A's device."""
    return transform._features_rows(A)


def _load():
    global _lib
    if _lib is None:
        from libskylark_tpu_torch.kernels import build

        lib = build.load("fastfood")
        p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.sk_fastfood_fused.argtypes = [p] + [i64] * 7 + [p] * 5 + [
            f32, p, p]
        lib.sk_fastfood_pre.argtypes = [p] + [i64] * 6 + [p, p, p]
        lib.sk_fastfood_post.argtypes = [p] + [i64] * 5 + [p, p, p, f32, p,
                                                           p]
        lib.sk_fastfood_batched.argtypes = [p] + [i64] * 7 + [p] * 5 + [
            f32, p, p]
        for fn in (lib.sk_fastfood_fused, lib.sk_fastfood_pre,
                   lib.sk_fastfood_post, lib.sk_fastfood_batched):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def features_rows(transform, A: torch.Tensor,
                  variant: str = "auto") -> torch.Tensor:
    """The (m, S) Fastfood features of A (m, N) float32: the transform's
    streams made on A's device, then :func:`apply_streams`."""
    T = transform
    launch.refuse_dtensor(A)
    if T._fut_name != "wht" or not supported(T._NB, A.dtype):
        raise errors.UnsupportedError(
            f"Fastfood kernel takes the wht core, a power-of-two NB <= "
            f"{MAX_NB} and float32; got fut={T._fut_name!r}, NB={T._NB}, "
            f"{A.dtype}")
    if A.ndim != 2 or A.shape[1] != T._N:
        raise errors.InvalidParametersError(
            f"need a 2-D operand with {T._N} columns, got {tuple(A.shape)}")
    if variant not in ("auto", "fused", "split"):
        raise errors.InvalidParametersError(
            f"variant must be 'auto', 'fused' or 'split', got {variant!r}")
    if A.device.type == "cpu":
        return fastfood_plain(T, A)
    return apply_streams(A, kernel_streams(T, A.device), T.scale, T._S,
                         variant)


def apply_streams(A: torch.Tensor, streams, scale: float, s_dim: int,
                  variant: str = "auto") -> torch.Tensor:
    """The kernel on A (m, d) CUDA float32 and the (numblks, NB) streams
    of :func:`kernel_streams`: ``"fused"``/``"auto"`` one launch,
    ``"split"`` a launch, ``torch.gather``, a launch."""
    launch.refuse_dtensor(A, *streams)
    bdiag, perms, gdiag, smdiag, sh = streams
    nb, NB = bdiag.shape
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"Fastfood kernel runs on CUDA, got {A.device}")
    if A.ndim != 2 or not A.is_contiguous() or A.dtype != torch.float32:
        raise errors.InvalidParametersError(
            "Fastfood kernel needs a contiguous 2-D float32 operand")
    m, d = A.shape
    for t, dtype in zip(streams, (torch.float32, torch.int64) + (
            torch.float32,) * 3):
        if (t.shape != (nb, NB) or t.dtype != dtype or t.device != A.device
                or not t.is_contiguous()):
            raise errors.InvalidParametersError(
                "Fastfood streams must be contiguous (numblks, NB) tensors "
                "on the operand's device, as kernel_streams makes them")
    if not (supported(NB, A.dtype) and d <= NB
            and (nb - 1) * NB < s_dim <= nb * NB):
        raise errors.InvalidParametersError(
            f"Fastfood geometry: d={d}, NB={NB}, numblks={nb}, S={s_dim}")
    out = torch.empty((m, s_dim), dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    lib = _load()
    rows = plan(NB, m)["rows"]
    if variant == "split":
        W = split_pre(A, bdiag)
        W = torch.gather(W, 2, perms[:, None, :].expand(nb, m, NB))
        launch.call(lib.sk_fastfood_post, A.device, W, m, NB, nb, s_dim,
                    rows, gdiag, smdiag, sh, float(scale), out)
        launch.count(launches, "fastfood_split")
        return out
    perms = perms.to(torch.int32)
    launch.call(lib.sk_fastfood_fused, A.device, A, d, m, d, NB, nb, s_dim,
                rows, bdiag, perms, gdiag, smdiag, sh, float(scale), out)
    launch.count(launches, "fastfood")
    return out


def split_pre(A: torch.Tensor, bdiag: torch.Tensor) -> torch.Tensor:
    """B4-split's first kernel on A (m, d) CUDA float32 (contiguous) and
    B (numblks, NB): W (numblks, m, NB), W[b, r] = H(B_b ⊙ x_r) with x_r
    zero-padded to NB — in the butterfly's sum order, bit for bit.
    :func:`apply_streams` gathers W and launches the second kernel; its
    launch counter counts the pair."""
    nb, NB = bdiag.shape
    m, d = A.shape
    W = torch.empty((nb, m, NB), dtype=torch.float32, device=A.device)
    launch.call(_load().sk_fastfood_pre, A.device, A, d, m, d, NB, nb,
                plan(NB, m)["rows"], bdiag, W)
    return W


def serve_features_plain(key_data, A: torch.Tensor, n_dim: int, s_dim: int,
                         fut: str = "wht", sm_kind: str = "ones",
                         sm_param=None) -> torch.Tensor:
    """The plain PyTorch version of the batched kernel:
    ``frft.fastfood_serve_apply`` lane by lane."""
    from libskylark_tpu_torch.sketch.cuda_dense import host_words
    from libskylark_tpu_torch.sketch.frft import fastfood_serve_apply

    kd = host_words(key_data)
    return torch.stack([fastfood_serve_apply(
        kd[i], A[i], n_dim=n_dim, s_dim=s_dim, fut=fut, sm_kind=sm_kind,
        sm_param=sm_param) for i in range(A.shape[0])])


def batched_streams(key_data, n_dim: int, s_dim: int, fut: str = "wht",
                    sm_kind: str = "ones", sm_param=None, device=None):
    """(bdiag, perms, gdiag, smdiag, shifts) of a cohort, each (B, nb, NB)
    on ``device``, as the batched kernel takes them: the lanes' streams
    made at once (``frft.serve_streams``), scal folded into G and Sm, the
    permutations int32, the shifts zero-padded past S. With ``key_data``
    the (B, 2) int32 key tensor on the card, every stream is made there
    from it with no host read or copy: the streams of a captured flush
    are part of its graph, refilled by nothing."""
    from libskylark_tpu_torch.sketch.frft import block_geometry, serve_streams
    from libskylark_tpu_torch.sketch.fut import make_fut

    NB, nb = block_geometry(n_dim, s_dim, fut)
    kd = (key_data.reshape(-1, 2) if isinstance(key_data, torch.Tensor)
          else np.asarray(key_data, dtype=np.uint32).reshape(-1, 2))
    B = kd.shape[0]
    scal = math.sqrt(NB) * make_fut(fut, NB).scale()
    bdiag, gdiag, smdiag, perms, sh = serve_streams(
        kd, torch.float32, NB=NB, nb=nb, s_dim=s_dim, sm_kind=sm_kind,
        sm_param=sm_param, device=device)
    sh = torch.nn.functional.pad(sh, (0, nb * NB - s_dim))
    return (bdiag.contiguous(), perms.to(torch.int32).contiguous(),
            (scal * gdiag).contiguous(),
            (scal * smdiag).reshape(B, nb, NB).contiguous(),
            sh.reshape(B, nb, NB).contiguous())


def serve_features_batched(key_data, A: torch.Tensor, n_dim: int,
                           s_dim: int, fut: str = "wht",
                           sm_kind: str = "ones",
                           sm_param=None) -> torch.Tensor:
    """The (B, m, S) Fastfood features of a stacked cohort A (B, m, n_dim)
    float32, lane b under the key ``key_data[b]`` ((B, 2) uint32 words,
    or their int32 tensor on A's device): the lanes' streams made at once
    on A's device (:func:`batched_streams`), then one launch
    (:func:`apply_streams_batched`)."""
    from libskylark_tpu_torch.sketch.cuda_dense import lane_words
    from libskylark_tpu_torch.sketch.frft import block_geometry

    NB, _ = block_geometry(n_dim, s_dim, fut)
    kd = lane_words(key_data, A.device)
    if fut != "wht" or not supported(NB, A.dtype):
        raise errors.UnsupportedError(
            f"Fastfood kernel takes the wht core, a power-of-two NB <= "
            f"{MAX_NB} and float32; got fut={fut!r}, NB={NB}, {A.dtype}")
    if A.ndim != 3 or A.shape[2] != n_dim or kd.shape[0] != A.shape[0]:
        raise errors.InvalidParametersError(
            f"need a (B, m, {n_dim}) operand and B keys, got "
            f"{tuple(A.shape)} and {kd.shape[0]} keys")
    if A.device.type == "cpu":
        return serve_features_plain(kd, A, n_dim, s_dim, fut, sm_kind,
                                    sm_param)
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"Fastfood kernel runs on CUDA or CPU, got {A.device}")
    return apply_streams_batched(
        A.contiguous(), batched_streams(kd, n_dim, s_dim, fut, sm_kind,
                                        sm_param, A.device),
        math.sqrt(2.0 / s_dim), s_dim)


def apply_streams_batched(A: torch.Tensor, streams, scale: float,
                          s_dim: int) -> torch.Tensor:
    """The batched kernel on A (B, m, d) CUDA float32 and the (B, nb, NB)
    streams of :func:`batched_streams`: one launch."""
    bdiag, perms, gdiag, smdiag, sh = streams
    B, m, d = A.shape
    _, nb, NB = bdiag.shape
    if A.device.type != "cuda":
        raise errors.UnsupportedError(
            f"Fastfood kernel runs on CUDA, got {A.device}")
    if not A.is_contiguous() or A.dtype != torch.float32:
        raise errors.InvalidParametersError(
            "Fastfood kernel needs a contiguous float32 operand")
    for t, dtype in zip(streams, (torch.float32, torch.int32) + (
            torch.float32,) * 3):
        if (t.shape != (B, nb, NB) or t.dtype != dtype
                or t.device != A.device or not t.is_contiguous()):
            raise errors.InvalidParametersError(
                "Fastfood streams must be contiguous (B, numblks, NB) "
                "tensors on the operand's device, as batched_streams makes "
                "them")
    if not (supported(NB, A.dtype) and d <= NB
            and (nb - 1) * NB < s_dim <= nb * NB):
        raise errors.InvalidParametersError(
            f"Fastfood geometry: d={d}, NB={NB}, numblks={nb}, S={s_dim}")
    out = torch.empty((B, m, s_dim), dtype=torch.float32, device=A.device)
    if B == 0 or m == 0:
        return out
    launch.call(_load().sk_fastfood_batched, A.device, A, B, m, d, NB, nb,
                s_dim, plan(NB, m)["rows"], bdiag, perms, gdiag, smdiag, sh,
                float(scale), out)
    launch.count(launches, "fastfood_batched")
    return out
