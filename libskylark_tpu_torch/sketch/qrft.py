"""Quasi-random feature transforms: GaussianQRFT, LaplacianQRFT,
ExpSemigroupQRLT (the port of libskylark_tpu/sketch/qrft.py).

The feature maps of RFT/RLT with frequencies from a leaped Halton sequence
pushed through the kernel distribution's inverse CDF: W[i, j] = inscale ·
quantile(seq(skip + i, j)), shifts[i] = 2π·seq(skip + i, N). W is built on
the host in float64 numpy when the transform is built (no randomness is
involved), then materialized on the apply's device and applied with
``torch.matmul``, as the reference applies it; no kernel is involved.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
from scipy import special as sps

from libskylark_tpu_torch.base.quasirand import (LeapedHaltonSequence,
                                                 QMCSequence)
from libskylark_tpu_torch.sketch.transform import (OperatorCache,
                                                   SketchTransform, register,
                                                   seeded)


def _normal_quantile(p: np.ndarray) -> np.ndarray:
    return sps.ndtri(p)


def _cauchy_quantile(p: np.ndarray) -> np.ndarray:
    return np.tan(np.pi * (p - 0.5))


def _levy_quantile(p: np.ndarray) -> np.ndarray:
    """Standard Levy quantile: 1/(2·erfcinv(p)²)."""
    v = sps.erfcinv(p)
    return 1.0 / (2.0 * v * v)


class QRFT(OperatorCache, SketchTransform):
    """Base quasi-random Fourier features; W lives on the host and each
    apply moves it to the apply's device unless ``materialize()`` pinned
    it there."""

    sketch_type = "QRFT"
    _quantile = staticmethod(_normal_quantile)

    def __init__(self, N, S, context, sequence: Optional[QMCSequence] = None,
                 skip: int = 0):
        self._sequence = sequence or LeapedHaltonSequence(N + 1)
        self._skip = int(skip)
        super().__init__(N, S, context)

    @property
    def inscale(self) -> float:
        raise NotImplementedError

    @property
    def outscale(self) -> float:
        return math.sqrt(2.0 / self._S)

    def _build(self):
        # features [skip, skip + S) over dims [0, N]; the last feeds the
        # shifts. Coordinates are clamped away from {0, 1}.
        panel = self._sequence.panel(self._skip, self._skip + self._S,
                                     self._N + 1)
        eps = np.finfo(np.float64).tiny
        coords = np.clip(panel[:, : self._N], eps, 1 - 1e-16)
        self._W_host = self.inscale * self._quantile(coords)
        self._shifts_host = 2.0 * math.pi * panel[:, self._N]

    @seeded
    def w_matrix(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.from_numpy(self._W_host).to(device=device, dtype=dtype)

    @seeded
    def shifts(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.from_numpy(self._shifts_host).to(device=device,
                                                      dtype=dtype)

    def _full_operator(self, dtype, device) -> torch.Tensor:
        return self.w_matrix(dtype, device)

    def _device_W(self, A: torch.Tensor) -> torch.Tensor:
        W = self._cached_op(A.dtype, A.device)
        return W if W is not None else self.w_matrix(A.dtype, A.device)

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A)
        W = self._device_W(A)
        return self.outscale * torch.cos(
            W @ A + self.shifts(A.dtype, A.device)[:, None])

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A)
        W = self._device_W(A)
        return self.outscale * torch.cos(
            A @ W.T + self.shifts(A.dtype, A.device)[None, :])

    def _extra_params(self) -> dict[str, Any]:
        return {"sequence": self._sequence.to_dict(), "skip": self._skip}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        seq = (QMCSequence.from_dict(d["sequence"]) if "sequence" in d
               else None)
        return cls(N, S, alloc, sequence=seq, skip=int(d.get("skip", 0)),
                   **cls._extra_kernel_params(d))

    @staticmethod
    def _extra_kernel_params(d) -> dict[str, Any]:
        return {}


class _SigmaQRFT(QRFT):
    """A QRFT with bandwidth σ: inscale 1/σ."""

    def __init__(self, N, S, context, sigma: float = 1.0, sequence=None,
                 skip: int = 0):
        self._sigma = float(sigma)
        super().__init__(N, S, context, sequence=sequence, skip=skip)

    @property
    def inscale(self) -> float:
        return 1.0 / self._sigma

    def _extra_params(self):
        d = super()._extra_params()
        d["sigma"] = self._sigma
        return d

    @staticmethod
    def _extra_kernel_params(d):
        return {"sigma": float(d.get("sigma", 1.0))}


@register
class GaussianQRFT(_SigmaQRFT):
    """Gaussian kernel: the normal inverse CDF."""

    sketch_type = "GaussianQRFT"
    _quantile = staticmethod(_normal_quantile)


@register
class LaplacianQRFT(_SigmaQRFT):
    """Laplacian kernel: the Cauchy inverse CDF."""

    sketch_type = "LaplacianQRFT"
    _quantile = staticmethod(_cauchy_quantile)


@register
class ExpSemigroupQRLT(QRFT):
    """Quasi-random Laplace features for the exponential semigroup
    kernel: z(x) = √(1/S)·exp(−W x), W from the Levy quantile with
    inscale β²/2."""

    sketch_type = "ExpSemigroupQRLT"
    _quantile = staticmethod(_levy_quantile)

    def __init__(self, N, S, context, beta: float = 1.0, sequence=None,
                 skip: int = 0):
        self._beta = float(beta)
        super().__init__(N, S, context, sequence=sequence, skip=skip)

    @property
    def inscale(self) -> float:
        return self._beta * self._beta / 2.0

    @property
    def outscale(self) -> float:
        return math.sqrt(1.0 / self._S)

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A)
        return self.outscale * torch.exp(-(self._device_W(A) @ A))

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        self._note_eager_apply(A)
        return self.outscale * torch.exp(-(A @ self._device_W(A).T))

    def _extra_params(self):
        d = super()._extra_params()
        d["beta"] = self._beta
        return d

    @staticmethod
    def _extra_kernel_params(d):
        return {"beta": float(d.get("beta", 1.0))}
