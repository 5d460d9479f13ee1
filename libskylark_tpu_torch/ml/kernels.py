"""Kernels: Gram matrices and random-feature-map factories (the port of
libskylark_tpu/ml/kernels.py).

Each kernel offers:

- ``gram(X, Y=None, device=None)``: K[i, j] = k(xᵢ, yⱼ), rows are
  examples. A :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix`
  operand stays sparse for the inner-product kernels (linear,
  polynomial: X·Yᵀ by ``spmm``, O(nnz)) and is densified on the device
  for the distance-based ones, whose Gram matrix is dense anyway;
- ``create_rft(S, context, tag)``: the random feature map, a
  SketchTransform whose rowwise apply maps (n, N) data to (n, S) features
  with E[Z·Zᵀ] ≈ gram; the tags are "regular", "fast", "quasi" and
  "sparse", as each kernel defines them;
- the reference's JSON form (``to_dict``/``deserialize_kernel``).
"""

from __future__ import annotations

import json
import math
from typing import Any, Union

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Allocation, Context
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.base.distance import (euclidean_distance_matrix,
                                                l1_distance_matrix)

_KERNEL_REGISTRY: dict[str, type["Kernel"]] = {}

# elements of the (rows, n, d) broadcast ExpSemigroup.gram forms at once
_BROADCAST_ELEMENTS = 1 << 26


def _as_dense(X, device) -> torch.Tensor:
    """A dense tensor on ``device``; a :class:`SparseMatrix` densified
    there."""
    from libskylark_tpu_torch.base.sparse import is_sparse_operand

    if is_sparse_operand(X):
        return X.todense(device=device)
    return as_tensor(X, device)


def _operands(X, Y, device):
    X = _as_dense(X, device)
    return X, X if Y is None else _as_dense(Y, X.device)


def _inner_gram(X, Y, device) -> torch.Tensor:
    """X·Yᵀ for the inner-product kernels, O(nnz) when X or Y is a
    :class:`SparseMatrix`: spmm against the other operand (densified when
    both are sparse, as in the reference)."""
    from libskylark_tpu_torch.base.sparse import is_sparse_operand, spmm

    if is_sparse_operand(X):
        d = resolve_device(device)
        return spmm(X, _as_dense(X if Y is None else Y, d).T)
    X = as_tensor(X, device)
    if is_sparse_operand(Y):
        return spmm(Y, X.T).T
    return X @ (X if Y is None else as_tensor(Y, X.device)).T


def _register(cls: type["Kernel"]) -> type["Kernel"]:
    _KERNEL_REGISTRY[cls.kernel_type] = cls
    return cls


class Kernel:
    """The kernel interface."""

    kernel_type = "kernel"

    def __init__(self, N: int):
        self._N = int(N)

    @property
    def input_dim(self) -> int:
        return self._N

    def gram(self, X, Y=None, device=None) -> torch.Tensor:
        """K[i, j] = k(X[i], Y[j]); Y defaults to X."""
        raise errors.NotImplementedYetError(
            f"{self.kernel_type}: gram not implemented")

    def symmetric_gram(self, X, device=None) -> torch.Tensor:
        return self.gram(X, None, device)

    def create_rft(self, S: int, context: Union[Context, Allocation],
                   tag: str = "regular"):
        """The feature map for ``tag``."""
        raise errors.NotImplementedYetError(
            f"{self.kernel_type}: no feature map for tag {tag!r}")

    def _extra_params(self) -> dict[str, Any]:
        return {}

    def to_dict(self) -> dict[str, Any]:
        d = {"skylark_object_type": "kernel",
             "kernel_type": self.kernel_type, "N": self._N}
        d.update(self._extra_params())
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def __repr__(self) -> str:
        ps = ", ".join(f"{k}={v}" for k, v in self._extra_params().items())
        return f"{type(self).__name__}(N={self._N}{', ' + ps if ps else ''})"


def _bad_tag(kernel: Kernel, tag: str):
    return errors.InvalidParametersError(
        f"{kernel.kernel_type} kernel has no {tag!r} feature transform")


@_register
class Linear(Kernel):
    """k(x, y) = ⟨x, y⟩; feature maps are plain sketches: JLT (regular),
    FJLT (fast), CWT (sparse)."""

    kernel_type = "linear"

    def gram(self, X, Y=None, device=None):
        return _inner_gram(X, Y, device)

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag == "regular":
            return sk.JLT(self._N, S, context)
        if tag == "fast":
            return sk.FJLT(self._N, S, context)
        if tag == "sparse":
            return sk.CWT(self._N, S, context)
        raise _bad_tag(self, tag)


@_register
class Gaussian(Kernel):
    """k(x, y) = exp(−‖x − y‖²/(2σ²))."""

    kernel_type = "gaussian"

    def __init__(self, N: int, sigma: float = 1.0):
        super().__init__(N)
        self._sigma = float(sigma)

    @property
    def sigma(self) -> float:
        return self._sigma

    def gram(self, X, Y=None, device=None):
        X, Y = _operands(X, Y, device)
        return torch.exp(-euclidean_distance_matrix(X, Y)
                         / (2.0 * self._sigma**2))

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag == "regular":
            return sk.GaussianRFT(self._N, S, context, sigma=self._sigma)
        if tag == "fast":
            return sk.FastGaussianRFT(self._N, S, context, sigma=self._sigma)
        if tag == "quasi":
            return sk.GaussianQRFT(self._N, S, context, sigma=self._sigma)
        raise _bad_tag(self, tag)

    def _extra_params(self):
        return {"sigma": self._sigma}


@_register
class Polynomial(Kernel):
    """k(x, y) = (γ⟨x, y⟩ + c)^q; the feature map is TensorSketch (PPT)."""

    kernel_type = "polynomial"

    def __init__(self, N: int, q: int = 2, c: float = 1.0,
                 gamma: float = 1.0):
        super().__init__(N)
        self._q = int(q)
        self._c = float(c)
        self._gamma = float(gamma)

    def gram(self, X, Y=None, device=None):
        return (self._gamma * _inner_gram(X, Y, device) + self._c) ** self._q

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag in ("regular", "fast"):
            return sk.PPT(self._N, S, context, q=self._q, c=self._c,
                          gamma=self._gamma)
        raise _bad_tag(self, tag)

    def _extra_params(self):
        return {"q": self._q, "c": self._c, "gamma": self._gamma}


@_register
class Laplacian(Kernel):
    """k(x, y) = exp(−‖x − y‖₁/σ)."""

    kernel_type = "laplacian"

    def __init__(self, N: int, sigma: float = 1.0):
        super().__init__(N)
        self._sigma = float(sigma)

    def gram(self, X, Y=None, device=None):
        X, Y = _operands(X, Y, device)
        return torch.exp(-l1_distance_matrix(X, Y) / self._sigma)

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag == "regular":
            return sk.LaplacianRFT(self._N, S, context, sigma=self._sigma)
        if tag == "quasi":
            return sk.LaplacianQRFT(self._N, S, context, sigma=self._sigma)
        raise _bad_tag(self, tag)

    def _extra_params(self):
        return {"sigma": self._sigma}


@_register
class ExpSemigroup(Kernel):
    """The exponential semigroup kernel on R₊: k(x, y) =
    exp(−β·Σᵢ√(xᵢ + yᵢ)), the Laplace transform of the scaled Levy
    distribution its RLT samples from."""

    kernel_type = "expsemigroup"

    def __init__(self, N: int, beta: float = 1.0):
        super().__init__(N)
        self._beta = float(beta)

    def gram(self, X, Y=None, device=None):
        X, Y = _operands(X, Y, device)
        # the (rows, n, d) broadcast, a bounded number of rows at a time
        step = max(1, _BROADCAST_ELEMENTS // max(1, Y.shape[0] * Y.shape[1]))
        parts = [torch.sqrt(torch.clamp_min(Xc[:, None, :] + Y[None, :, :],
                                            0.0)).sum(-1)
                 for Xc in torch.split(X, step)]
        return torch.exp(-self._beta * torch.cat(parts))

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag == "regular":
            return sk.ExpSemigroupRLT(self._N, S, context, beta=self._beta)
        if tag == "quasi":
            return sk.ExpSemigroupQRLT(self._N, S, context, beta=self._beta)
        raise _bad_tag(self, tag)

    def _extra_params(self):
        return {"beta": self._beta}


@_register
class Matern(Kernel):
    """The Matérn kernel k(r) = 2^{1−ν}/Γ(ν)·(√(2ν)·r/l)^ν·K_ν(√(2ν)·r/l):
    closed forms at ν ∈ {1/2, 3/2, 5/2}, scipy's Bessel K_ν on the host
    otherwise. Its feature maps are MaternRFT ("regular") and
    FastMaternRFT ("fast")."""

    kernel_type = "matern"

    def __init__(self, N: int, nu: float = 1.5, l: float = 1.0):
        super().__init__(N)
        self._nu = float(nu)
        self._l = float(l)

    def gram(self, X, Y=None, device=None):
        X, Y = _operands(X, Y, device)
        r = torch.sqrt(euclidean_distance_matrix(X, Y))
        nu, l = self._nu, self._l
        if nu == 0.5:
            return torch.exp(-r / l)
        if nu == 1.5:
            s = math.sqrt(3.0) * r / l
            return (1.0 + s) * torch.exp(-s)
        if nu == 2.5:
            s = math.sqrt(5.0) * r / l
            return (1.0 + s + s * s / 3.0) * torch.exp(-s)
        from scipy.special import gamma as _gamma, kv as _kv

        rh = r.cpu().double().numpy()
        s = np.maximum(np.sqrt(2.0 * nu) * rh / l,
                       np.finfo(np.float64).tiny ** 0.25)
        K = (2.0 ** (1.0 - nu) / _gamma(nu)) * (s**nu) * _kv(nu, s)
        K[rh <= 0] = 1.0
        return torch.from_numpy(K).to(device=r.device, dtype=r.dtype)

    def create_rft(self, S, context, tag="regular"):
        from libskylark_tpu_torch import sketch as sk

        if tag == "regular":
            return sk.MaternRFT(self._N, S, context, nu=self._nu, l=self._l)
        if tag == "fast":
            return sk.FastMaternRFT(self._N, S, context, nu=self._nu,
                                    l=self._l)
        raise _bad_tag(self, tag)

    def _extra_params(self):
        return {"nu": self._nu, "l": self._l}


def deserialize_kernel(obj: Union[str, dict[str, Any]]) -> Kernel:
    """A kernel from its JSON form (or its dict)."""
    d = json.loads(obj) if isinstance(obj, str) else dict(obj)
    cls = _KERNEL_REGISTRY.get(d.get("kernel_type"))
    if cls is None:
        raise errors.InvalidParametersError(
            f"unknown kernel type {d.get('kernel_type')!r}")
    kwargs = {k: v for k, v in d.items()
              if k not in ("skylark_object_type", "kernel_type", "N",
                           "skylark_version")}
    return cls(int(d["N"]), **kwargs)


def make_kernel(kernel_type: str, N: int, **kwargs) -> Kernel:
    """A kernel by its type name."""
    cls = _KERNEL_REGISTRY.get(kernel_type)
    if cls is None:
        raise errors.InvalidParametersError(
            f"unknown kernel type {kernel_type!r}")
    return cls(N, **kwargs)


KERNELS = _KERNEL_REGISTRY
