"""Fastfood random features: FastGaussianRFT (the port of
libskylark_tpu/sketch/frft.py).

Le–Sarlós–Smola Fastfood: each block of NB features is
Sm ⊙ F(G ⊙ Π(F(B ⊙ x))), two fast unitary transforms around a random
permutation Π and three diagonals, an implicit Gaussian-like frequency
matrix in O(NB log NB) per block; the features are scale·cos(w + shift),
block-major, truncated to S. Sub-streams of the allocation: 0 shifts,
1 B (Rademacher), 2 G (Normal), 3 the block permutations
(``randgen.permutation(fold_in(subkey(3), i), NB)``), 4 Sm (Matern).

Routes, decided before any launch: ``fut="wht"`` with an NB the kernel
serves and float32 takes the Fastfood kernel's route
(sketch/cuda_fastfood.py, B4 on a CUDA tensor, its plain version on a CPU
tensor); ``fut="dct"`` and every other NB take the torch chain
(:func:`_chain_rows` on ``torch.fft`` or the WHT), the reference's own
XLA chain. The columnwise apply is the rowwise apply of Aᵀ, transposed.

FastMaternRFT needs jax.random's Gamma sampler, which is not ported: it
raises on construction and on deserialization.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import fold_in
from libskylark_tpu_torch.sketch import cuda_fastfood
from libskylark_tpu_torch.sketch.fut import make_fut
from libskylark_tpu_torch.sketch.transform import SketchTransform, register


def _chain_rows(Ap, bdiag, gdiag, smdiag, perms, shifts, out_scale, scal,
                NB: int, nb: int, fut_apply):
    """The SHGΠHB chain on padded row-major input Ap (m, NB), in the
    reference's operation order, laid out (blocks, rows, NB) with the
    transform axis last; block-major features truncated to S =
    ``len(shifts)``. Π gathers ``out[..., j] = in[..., perm[j]]``."""
    m = Ap.shape[0]
    W = bdiag[:, None, :] * Ap[None, :, :]                # (nb, m, NB)
    W = fut_apply(W)
    W = torch.gather(W, 2, perms[:, None, :].expand(nb, m, NB))
    W = (scal * gdiag)[:, None, :] * W
    W = fut_apply(W)
    W = (scal * smdiag.reshape(nb, 1, NB)) * W
    W = W.permute(1, 0, 2).reshape(m, nb * NB)[:, : shifts.shape[0]]
    return out_scale * torch.cos(W + shifts[None, :])


def block_geometry(n_dim: int, s_dim: int, fut: str = "wht"
                   ) -> tuple[int, int]:
    """(NB, numblks): the next power of two ≥ N for the WHT (N itself for
    the DCT), and enough blocks for S features."""
    NB = (1 << max(0, (n_dim - 1).bit_length())) if fut == "wht" \
        else n_dim
    return NB, 1 + (s_dim - 1) // NB


class FastRFT(SketchTransform):
    """Base Fastfood transform: the WHT core by default, ``fut="dct"``
    for any N without padding."""

    sketch_type = "FastRFT"

    def __init__(self, N, S, context, fut: str = "wht"):
        self._fut_name = fut
        super().__init__(N, S, context)

    def _build(self):
        self._NB, self._numblks = block_geometry(self._N, self._S,
                                                 self._fut_name)
        self._fut = make_fut(self._fut_name, self._NB)

    @property
    def scale(self) -> float:
        return math.sqrt(2.0 / self._S)

    @property
    def scal(self) -> float:
        """√NB · fut.scale() in float64, as the reference computes it
        (not exactly 1 when log₂NB is odd)."""
        return math.sqrt(self._NB) * self._fut.scale()

    def shifts(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(0), randgen.Uniform(0.0, 2.0 * math.pi), 0, self._S,
            dtype, device)

    def _B(self, dtype, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(1), randgen.Rademacher(), 0,
            self._numblks * self._NB, dtype, device,
        ).reshape(self._numblks, self._NB)

    def _G(self, dtype, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(2), randgen.Normal(), 0, self._numblks * self._NB,
            dtype, device,
        ).reshape(self._numblks, self._NB)

    def _perms(self, device=None) -> torch.Tensor:
        """(numblks, NB) int64: block i's permutation."""
        key = self.subkey(3)
        return torch.stack([randgen.permutation(fold_in(key, i), self._NB,
                                                device)
                            for i in range(self._numblks)])

    def _Sm(self, dtype, device=None) -> torch.Tensor:
        """Per-feature scaling (numblks·NB,); base: ones."""
        return torch.ones((self._numblks * self._NB,), dtype=dtype,
                          device=device)

    def _fut_apply(self, W: torch.Tensor) -> torch.Tensor:
        return self._fut.apply(W, axis=-1)

    def _features_rows(self, At: torch.Tensor) -> torch.Tensor:
        """The (m, S) feature map of row-major At (m, N) by the torch
        chain."""
        dt, dev = At.dtype, At.device
        pad = self._NB - self._N
        Ap = torch.nn.functional.pad(At, (0, pad)) if pad else At
        return _chain_rows(
            Ap, self._B(dt, dev), self._G(dt, dev), self._Sm(dt, dev),
            self._perms(dev), self.shifts(dt, dev), self.scale, self.scal,
            self._NB, self._numblks, self._fut_apply)

    def _kernel_serves(self, A: torch.Tensor) -> bool:
        """The Fastfood kernel's route: the WHT core, an NB the kernel
        serves, float32."""
        return (self._fut_name == "wht" and A.ndim == 2
                and cuda_fastfood.supported(self._NB, A.dtype))

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        if self._kernel_serves(A):
            return cuda_fastfood.features_rows(self, A.contiguous())
        return self._features_rows(A)

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        return self._apply_rowwise(A.T).T

    def _extra_params(self) -> dict[str, Any]:
        return {"fut": self._fut_name}


@register
class FastGaussianRFT(FastRFT):
    """Fastfood for the Gaussian kernel: Sm = 1/(σ√NB), normalized by the
    padded block length NB, as the reference."""

    sketch_type = "FastGaussianRFT"

    def __init__(self, N, S, context, sigma: float = 1.0, fut: str = "wht"):
        self._sigma = float(sigma)
        super().__init__(N, S, context, fut=fut)

    def _Sm(self, dtype, device=None) -> torch.Tensor:
        v = 1.0 / (self._sigma * math.sqrt(self._NB))
        return torch.full((self._numblks * self._NB,), v, dtype=dtype,
                          device=device)

    def _extra_params(self) -> dict[str, Any]:
        return {"sigma": self._sigma, "fut": self._fut_name}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, sigma=float(d.get("sigma", 1.0)),
                   fut=d.get("fut", "wht"))


@register
class FastMaternRFT(FastRFT):
    """Fastfood for the Matern kernel. Its Sm is √(2ν/χ²(2ν)) samples of
    jax.random's Gamma sampler, which the port does not carry:
    construction and deserialization raise."""

    sketch_type = "FastMaternRFT"

    def __init__(self, N, S, context, nu: float = 1.0, l: float = 1.0,
                 fut: str = "wht"):
        raise errors.NotImplementedYetError(
            "FastMaternRFT needs the Gamma sampler (jax.random.gamma), "
            "which is not ported yet")

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, nu=float(d.get("nu", 1.0)),
                   l=float(d.get("l", 1.0)), fut=d.get("fut", "wht"))
