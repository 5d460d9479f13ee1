"""Fastfood random features: FastGaussianRFT, FastMaternRFT (the port of
libskylark_tpu/sketch/frft.py).

Le–Sarlós–Smola Fastfood: each block of NB features is
Sm ⊙ F(G ⊙ Π(F(B ⊙ x))), two fast unitary transforms around a random
permutation Π and three diagonals, an implicit Gaussian-like frequency
matrix in O(NB log NB) per block; the features are scale·cos(w + shift),
block-major, truncated to S. Sub-streams of the allocation: 0 shifts,
1 B (Rademacher), 2 G (Normal), 3 the block permutations
(``randgen.permutation(fold_in(subkey(3), i), NB)``), 4 Sm (Matern:
√(2ν/χ²(2ν))/(l√NB), χ²(2ν) = Gamma(ν, scale 2)).

Routes, decided before any launch: ``fut="wht"`` with an NB the kernel
serves and float32 takes the Fastfood kernel's route
(sketch/cuda_fastfood.py, B4 on a CUDA tensor, its plain version on a CPU
tensor); ``fut="dct"`` and every other NB take the torch chain
(:func:`_chain_rows` on ``torch.fft`` or the WHT), the reference's own
XLA chain. The columnwise apply is the rowwise apply of Aᵀ, transposed.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import fold_in
from libskylark_tpu_torch.sketch import cuda_fastfood
from libskylark_tpu_torch.sketch.fut import make_fut
from libskylark_tpu_torch.sketch.rft import matern_scales
from libskylark_tpu_torch.sketch.transform import (SketchTransform, register,
                                                   seeded)


def fut_apply_policy(fut_obj, fut_name: str, W: torch.Tensor) -> torch.Tensor:
    """The FUT along W's last (contiguous) axis, shared by the transform
    and the serve apply. ``fut_name`` is the reference's parameter, where
    it picks a matmul precision for the WHT; the port's matmuls are full
    float32 for every FUT, so it selects nothing here."""
    return fut_obj.apply(W, axis=-1)


def matern_sm(chi2: torch.Tensor, nu: float, el: float,
              NB: int) -> torch.Tensor:
    """FastMaternRFT's Sm from its χ²(2ν) draws: √(2ν/χ²)/(l√NB)."""
    return matern_scales(chi2, nu) / (float(el) * math.sqrt(NB))


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


def serve_streams(key, dtype=torch.float32, *, NB: int, nb: int,
                  s_dim: int, sm_kind: str, sm_param, device=None):
    """Every Fastfood stream of a cohort of transforms, as a function of
    their raw keys ``key`` ((B, 2) uint32 words, or one (2,) key): (bdiag, gdiag,
    smdiag, perms, shifts), shaped (B, nb, NB) (B, nb, NB) (B, nb·NB)
    (B, nb, NB) (B, s_dim) — lane b bit-equal to the transform's ``_B``,
    ``_G``, ``_Sm``, ``_perms`` and ``shifts`` (sub-streams 1, 2, the
    Sm spec, 3 and 0). Made for all lanes at once: one Threefry pass per
    stream over the lanes' chunk keys, and each permutation round one
    row-wise stable sort over the B·nb block rows. ``sm_kind`` is
    ``"ones"``, ``"gauss"`` (``sm_param`` = σ) or ``"matern"``
    (``sm_param`` = (ν, l)). Keys held in a tensor ((B, 2) int32 words on
    the card, the kernels' form) make every stream on their device with
    no host read or copy, as a captured serve flush needs; a Matern Sm
    still reads the host once a Gamma round."""
    if isinstance(key, torch.Tensor):
        keys = randgen.key_tensor(key)
        device = keys.device
    else:
        keys = np.asarray(key, dtype=np.uint32).reshape(-1, 2)
    B = keys.shape[0]

    def sub(tag):
        return randgen.fold_in_batched(keys, tag)

    bdiag = randgen.stream_slice_batched(
        sub(1), randgen.Rademacher(), 0, nb * NB, dtype, device
    ).reshape(B, nb, NB)
    gdiag = randgen.stream_slice_batched(
        sub(2), randgen.Normal(), 0, nb * NB, dtype, device
    ).reshape(B, nb, NB)
    if isinstance(keys, torch.Tensor):
        block_keys = randgen.fold_in_batched(
            sub(3).repeat_interleave(nb, dim=0),
            torch.arange(nb, dtype=torch.int64, device=device).repeat(B))
    else:
        block_keys = randgen.fold_in_batched(
            np.repeat(sub(3), nb, axis=0), np.tile(np.arange(nb), B))
    perms = randgen.permutation_batched(block_keys, NB, device).reshape(
        B, nb, NB)
    shifts = randgen.stream_slice_batched(
        sub(0), randgen.Uniform(0.0, 2.0 * math.pi), 0, s_dim, dtype, device)
    if sm_kind == "ones":
        smdiag = torch.ones((B, nb * NB), dtype=dtype, device=device)
    elif sm_kind == "gauss":
        smdiag = torch.full((B, nb * NB),
                            1.0 / (float(sm_param) * math.sqrt(NB)),
                            dtype=dtype, device=device)
    elif sm_kind == "matern":
        nu, el = sm_param
        chi2 = randgen.stream_slice_batched(
            sub(4), randgen.Gamma(shape_param=float(nu), scale=2.0), 0,
            nb * NB, dtype, device)
        smdiag = matern_sm(chi2, float(nu), float(el), NB)
    else:
        raise errors.InvalidParametersError(
            f"unknown Sm spec kind {sm_kind!r}")
    return bdiag, gdiag, smdiag, perms, shifts


def fastfood_serve_apply(key_data, A: torch.Tensor, *, n_dim: int,
                         s_dim: int, fut: str = "wht", sm_kind: str = "ones",
                         sm_param=None) -> torch.Tensor:
    """One request's (m, S) Fastfood features as a function of the
    transform's raw key data ((2,) uint32) and static geometry, by the
    torch chain. Rows are independent, so rows of zero padding leave the
    real rows' features unchanged; A's column extent must be ``n_dim``."""
    if A.shape[1] != n_dim:
        raise errors.InvalidParametersError(
            f"operand cols {A.shape[1]} != n_dim {n_dim}")
    NB, nb = block_geometry(n_dim, s_dim, fut)
    pad = NB - n_dim
    Ap = torch.nn.functional.pad(A, (0, pad)) if pad else A
    fut_obj = make_fut(fut, NB)
    scal = math.sqrt(NB) * fut_obj.scale()
    bdiag, gdiag, smdiag, perms, shifts = serve_streams(
        key_data, A.dtype, NB=NB, nb=nb, s_dim=s_dim, sm_kind=sm_kind,
        sm_param=sm_param, device=A.device)
    return _chain_rows(Ap, bdiag[0], gdiag[0], smdiag[0], perms[0],
                       shifts[0], math.sqrt(2.0 / s_dim), scal, NB, nb,
                       lambda W: fut_apply_policy(fut_obj, fut, W))


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

    def _sm_spec(self) -> tuple:
        """(kind, param) of the per-feature Sm scaling, as the serve layer
        buckets on it and :func:`serve_streams` rebuilds it."""
        return ("ones", None)

    @property
    def scale(self) -> float:
        return math.sqrt(2.0 / self._S)

    @property
    def scal(self) -> float:
        """√NB · fut.scale() in float64, as the reference computes it
        (not exactly 1 when log₂NB is odd)."""
        return math.sqrt(self._NB) * self._fut.scale()

    @seeded
    def shifts(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(0), randgen.Uniform(0.0, 2.0 * math.pi), 0, self._S,
            dtype, device)

    @seeded
    def _B(self, dtype, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(1), randgen.Rademacher(), 0,
            self._numblks * self._NB, dtype, device,
        ).reshape(self._numblks, self._NB)

    @seeded
    def _G(self, dtype, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(2), randgen.Normal(), 0, self._numblks * self._NB,
            dtype, device,
        ).reshape(self._numblks, self._NB)

    @seeded
    def _perms(self, device=None) -> torch.Tensor:
        """(numblks, NB) int64: block i's permutation."""
        key = self.subkey(3)
        return torch.stack([randgen.permutation(fold_in(key, i), self._NB,
                                                device)
                            for i in range(self._numblks)])

    @seeded
    def _Sm(self, dtype, device=None) -> torch.Tensor:
        """Per-feature scaling (numblks·NB,); base: ones."""
        return torch.ones((self._numblks * self._NB,), dtype=dtype,
                          device=device)

    def _fut_apply(self, W: torch.Tensor) -> torch.Tensor:
        return fut_apply_policy(self._fut, self._fut_name, W)

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

    @seeded
    def _Sm(self, dtype, device=None) -> torch.Tensor:
        v = 1.0 / (self._sigma * math.sqrt(self._NB))
        return torch.full((self._numblks * self._NB,), v, dtype=dtype,
                          device=device)

    def _sm_spec(self) -> tuple:
        return ("gauss", self._sigma)

    def _extra_params(self) -> dict[str, Any]:
        return {"sigma": self._sigma, "fut": self._fut_name}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, sigma=float(d.get("sigma", 1.0)),
                   fut=d.get("fut", "wht"))


@register
class FastMaternRFT(FastRFT):
    """Fastfood for the Matern kernel: Sm = √(2ν/χ²(2ν))/(l√NB), χ²(2ν)
    = Gamma(ν, scale 2) on sub-stream 4. The Fastfood kernel takes this
    Sm as it takes FastGaussianRFT's."""

    sketch_type = "FastMaternRFT"

    def __init__(self, N, S, context, nu: float = 1.0, l: float = 1.0,
                 fut: str = "wht"):
        self._nu = float(nu)
        self._l = float(l)
        super().__init__(N, S, context, fut=fut)

    @seeded
    def _Sm(self, dtype, device=None) -> torch.Tensor:
        chi2 = randgen.stream_slice(
            self.subkey(4), randgen.Gamma(shape_param=self._nu, scale=2.0),
            0, self._numblks * self._NB, dtype, device)
        return matern_sm(chi2, self._nu, self._l, self._NB)

    def _sm_spec(self) -> tuple:
        return ("matern", (self._nu, self._l))

    def _extra_params(self) -> dict[str, Any]:
        return {"nu": self._nu, "l": self._l, "fut": self._fut_name}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, nu=float(d.get("nu", 1.0)),
                   l=float(d.get("l", 1.0)), fut=d.get("fut", "wht"))
