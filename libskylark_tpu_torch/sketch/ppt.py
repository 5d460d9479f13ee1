"""PPT (TensorSketch): the Pham–Pagh sketch of the polynomial kernel
(γ·xᵀy + c)^q (the port of libskylark_tpu/sketch/ppt.py).

q independent CountSketches of x (the CWTs of sub-allocations
``child(i)``, which take the CountSketch kernel's route: B2 columnwise on
a CUDA tensor), each lifted by the homogeneity term √c·v_i at bucket h_i
(sub-streams 100 and 101), then FFT'd, multiplied elementwise across the
q sketches and inverse-FFT'd along the feature axis with ``torch.fft``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.sketch.hash import CWT
from libskylark_tpu_torch.sketch.transform import (COLUMNWISE,
                                                   SketchTransform, register,
                                                   seeded)


@register
class PPT(SketchTransform):
    sketch_type = "PPT"

    def __init__(self, N, S, context, q: int = 3, c: float = 1.0,
                 gamma: float = 1.0):
        if q < 1:
            raise errors.InvalidParametersError(
                f"PPT degree q must be >= 1, got {q}")
        if c < 0 or gamma < 0:
            raise errors.InvalidParametersError(
                "PPT parameters c and gamma must be nonnegative, got "
                f"c={c}, gamma={gamma}")
        self._q = int(q)
        self._c = float(c)
        self._gamma = float(gamma)
        super().__init__(N, S, context)

    def _build(self):
        self._cwts = [CWT(self._N, self._S, self._alloc.child(i))
                      for i in range(self._q)]

    def _children(self) -> tuple:
        return tuple(self._cwts)

    @seeded
    def _hash_idx(self, device=None) -> torch.Tensor:
        return randgen.stream_slice(
            self.subkey(100), randgen.UniformInt(0, self._S - 1), 0, self._q,
            device=device)

    @seeded
    def _hash_val(self, dtype, device=None) -> torch.Tensor:
        return randgen.stream_slice(self.subkey(101), randgen.Rademacher(),
                                    0, self._q, dtype, device)

    def _sketch_columns(self, A: torch.Tensor) -> torch.Tensor:
        """Columnwise TensorSketch of A (N, m) → (S, m)."""
        dt = A.dtype
        hidx = self._hash_idx(A.device)
        hval = self._hash_val(dt, A.device)
        sqrt_gamma = math.sqrt(self._gamma)
        sqrt_c = math.sqrt(self._c)
        P = None
        for i, cwt in enumerate(self._cwts):
            W = sqrt_gamma * cwt.apply(A, COLUMNWISE, device=A.device)
            # the lift as an index_add_ (a 0-dim index would be read on
            # the host, which a captured body cannot do)
            W.index_add_(0, hidx[i:i + 1],
                         (sqrt_c * hval[i:i + 1])[:, None].expand(
                             1, W.shape[1]))
            FW = torch.fft.fft(W, dim=0)
            P = FW if P is None else P * FW
        return torch.fft.ifft(P, dim=0).real.to(dt)

    def _apply_columnwise(self, A: torch.Tensor) -> torch.Tensor:
        return self._sketch_columns(A)

    def _apply_rowwise(self, A: torch.Tensor) -> torch.Tensor:
        return self._sketch_columns(A.T).T

    def _extra_params(self) -> dict[str, Any]:
        return {"q": self._q, "c": self._c, "gamma": self._gamma}

    @classmethod
    def _from_parts(cls, N, S, alloc, d):
        return cls(N, S, alloc, q=int(d.get("q", 3)),
                   c=float(d.get("c", 1.0)),
                   gamma=float(d.get("gamma", 1.0)))
