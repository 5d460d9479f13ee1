"""Fastfood feature map: the wrappers of csrc/fastfood.cu, their plain
version, and their launch counters.

Replaces libskylark_tpu/sketch/pallas_fastfood.py (``_launch`` and
``_launch_split``): for each row x of A (m, N) and block b,
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

Rules of the wrappers:

- a CPU tensor takes the plain version, :func:`fastfood_plain`;
- a CUDA tensor launches the kernel or raises — no fallback;
- ``launches[...]`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from libskylark_tpu_torch.base import errors

launches = {"fastfood": 0, "fastfood_split": 0}

# The largest block the kernel serves: one row's two NB-float buffers in
# shared memory (csrc/fastfood.cu: kMaxNB).
MAX_NB = 16384

_lib = None


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
        lib.sk_fastfood_fused.argtypes = [p, i64, i64, i64, i64, i64, i64,
                                          p, p, p, p, p, f32, p, p]
        lib.sk_fastfood_pre.argtypes = [p, i64, i64, i64, i64, i64, p, p, p]
        lib.sk_fastfood_post.argtypes = [p, i64, i64, i64, i64, p, p, p, f32,
                                         p, p]
        for fn in (lib.sk_fastfood_fused, lib.sk_fastfood_pre,
                   lib.sk_fastfood_post):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def features_rows(transform, A: torch.Tensor,
                  variant: str = "auto") -> torch.Tensor:
    """The (m, S) Fastfood features of A (m, N) float32: the transform's
    streams made on A's device, then :func:`apply_streams`."""
    T = transform
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
    from libskylark_tpu_torch.kernels import launch

    out = torch.empty((m, s_dim), dtype=torch.float32, device=A.device)
    if m == 0:
        return out
    lib = _load()
    if variant == "split":
        W = torch.empty((nb, m, NB), dtype=torch.float32, device=A.device)
        launch.call(lib.sk_fastfood_pre, A.device, A.data_ptr(), d, m, d, NB,
                    nb, bdiag.data_ptr(), W.data_ptr())
        W = torch.gather(W, 2, perms[:, None, :].expand(nb, m, NB))
        launch.call(lib.sk_fastfood_post, A.device, W.data_ptr(), m, NB, nb,
                    s_dim, gdiag.data_ptr(), smdiag.data_ptr(), sh.data_ptr(),
                    float(scale), out.data_ptr())
        launches["fastfood_split"] += 1
        return out
    perms = perms.to(torch.int32)
    launch.call(lib.sk_fastfood_fused, A.device, A.data_ptr(), d, m, d, NB,
                nb, s_dim, bdiag.data_ptr(), perms.data_ptr(),
                gdiag.data_ptr(), smdiag.data_ptr(), sh.data_ptr(),
                float(scale), out.data_ptr())
    launches["fastfood"] += 1
    return out
