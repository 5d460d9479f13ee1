"""Kernel regression and classification toolkit: RLS, sketched RLS,
Nyström RLS and sketched PCR (the port of libskylark_tpu/ml/nonlinear.py).

Each model trains and predicts as the reference's does; multiclass labels
are integer classes, dummy-coded to ±1 one-vs-all. Training runs on
``device=`` (else the package default); prediction runs where the model
lives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.sparse import as_sparse
from libskylark_tpu_torch.ml.coding import dummy_coding, dummy_decode
from libskylark_tpu_torch.ml.krr import _ridge_solve


def _dense(X, device) -> torch.Tensor:
    """X as a dense tensor on ``device``; a sparse operand densified."""
    if hasattr(X, "todense"):
        return as_sparse(X).todense(device=device)
    return as_tensor(X, device)


def _code_labels(Y, multiclass: bool, like: torch.Tensor):
    """The targets as an (n, t) tensor beside ``like``, and the coding
    (None for regression)."""
    if not multiclass:
        Yc = torch.as_tensor(np.asarray(Y, dtype=np.float32),
                             device=like.device).to(like.dtype)
        return (Yc[:, None] if Yc.ndim == 1 else Yc), None
    return dummy_coding(Y, dtype=like.dtype, device=like.device)


def _decode(pred, coding):
    if coding is None:
        return pred[:, 0] if pred.shape[1] == 1 else pred
    return dummy_decode(pred, coding)


def _trained(model):
    if model is None:
        raise errors.MLError("predict before train")
    return model


class RLS:
    """Exact kernel regularized least squares: α = (K + λI)⁻¹·Y, predicted
    through the cross-Gram with the training data."""

    def __init__(self, kernel):
        self._kernel = kernel
        self.model = None

    def train(self, X, Y, regularization: float = 1.0,
              multiclass: bool = True, device=None):
        X = _dense(X, device)
        K = self._kernel.gram(X, device=X.device)
        Ym, coding = _code_labels(Y, multiclass, K)
        A = K + regularization * torch.eye(X.shape[0], dtype=K.dtype,
                                           device=K.device)
        alpha = torch.cholesky_solve(Ym, torch.linalg.cholesky(A))
        self.model = {"alpha": alpha, "data": X, "coding": coding,
                      "regularization": float(regularization)}
        return self

    def predict(self, Xt):
        m = _trained(self.model)
        Xt = _dense(Xt, m["data"].device)
        return _decode(self._kernel.gram(Xt, m["data"], Xt.device)
                       @ m["alpha"],
                       m["coding"])


class SketchRLS:
    """Random-features RLS: Z = rft(X), w = (ZᵀZ + λI)⁻¹·ZᵀY."""

    def __init__(self, kernel):
        self._kernel = kernel
        self.model = None
        self._rft = None

    def train(self, X, Y, context: Context, random_features: int = 100,
              regularization: float = 1.0, multiclass: bool = True,
              tag: str = "regular", device=None):
        from libskylark_tpu_torch.sketch import ROWWISE

        self._rft = self._kernel.create_rft(random_features, context, tag)
        Z = self._rft.apply(X, ROWWISE, device=device)
        Ym, coding = _code_labels(Y, multiclass, Z)
        self.model = {"weights": _ridge_solve(Z, Ym, regularization),
                      "coding": coding,
                      "regularization": float(regularization)}
        return self

    def predict(self, Xt):
        from libskylark_tpu_torch.sketch import ROWWISE

        m = _trained(self.model)
        Zt = self._rft.apply(Xt, ROWWISE, device=m["weights"].device)
        return _decode(Zt @ m["weights"], m["coding"])


class NystromRLS:
    """Nyström-feature RLS: sample landmark rows (uniformly or by ridge
    leverage scores), whiten the landmark Gram by its inverse square
    root, and regress on Z = K(X, landmarks)·U."""

    def __init__(self, kernel):
        self._kernel = kernel
        self.model = None

    def train(self, X, Y, context: Context, random_features: int = 100,
              regularization: float = 1.0, probdist: str = "uniform",
              multiclass: bool = True, device=None):
        X = _dense(X, device)
        m = X.shape[0]
        s = int(random_features)
        if probdist == "uniform":
            p = np.full(m, 1.0 / m)
        elif probdist == "leverages":
            K = self._kernel.gram(X, device=X.device)
            M = K + regularization * torch.eye(m, dtype=K.dtype,
                                               device=K.device)
            lev = torch.diagonal(K @ torch.linalg.inv(M))
            p = np.maximum(lev.cpu().numpy().astype(np.float64), 0)
            p = p / p.sum()
        else:
            raise errors.InvalidParametersError(
                f"probdist must be 'uniform' or 'leverages', got "
                f"{probdist!r}")
        # a non-uniform sample by the inverse CDF of the context's stream
        u = randgen.stream_slice(context.allocate().key, randgen.Uniform(),
                                 0, s, torch.float32, "cpu").numpy()
        cdf = np.cumsum(p)
        cdf[-1] = 1.0
        idx = np.searchsorted(cdf, u.astype(np.float64), side="right")
        SX = X[torch.as_tensor(idx, device=X.device)]

        K_II = self._kernel.gram(SX, device=X.device)
        eps = 1e-8
        evals, evecs = torch.linalg.eigh(
            K_II + eps * torch.eye(s, dtype=K_II.dtype, device=K_II.device))
        U = evecs / torch.sqrt(torch.clamp_min(evals, eps))[None, :]
        Z = self._kernel.gram(X, SX, X.device) @ U
        Ym, coding = _code_labels(Y, multiclass, Z)
        self.model = {"weights": _ridge_solve(Z, Ym, regularization), "SX": SX,
                      "U": U, "coding": coding}
        return self

    def predict(self, Xt):
        m = _trained(self.model)
        Xt = _dense(Xt, m["SX"].device)
        Zt = self._kernel.gram(Xt, m["SX"], Xt.device) @ m["U"]
        return _decode(Zt @ m["weights"], m["coding"])


class SketchPCR:
    """Sketched principal component regression: project random features
    onto the approximate k-dominant subspace (nla.lowrank) and regress
    there."""

    def __init__(self, kernel):
        self._kernel = kernel
        self.model = None
        self._rft = None

    def train(self, X, Y, context: Context, rank: int,
              s: Optional[int] = None, t: Optional[int] = None,
              multiclass: bool = True, tag: str = "regular", device=None):
        from libskylark_tpu_torch.nla.lowrank import (
            approximate_dominant_subspace_basis)

        s = 2 * rank if s is None else int(s)
        t = 2 * s if t is None else int(t)
        Z, S, R, V = approximate_dominant_subspace_basis(
            X, rank, s, t, context, kernel=self._kernel, tag=tag,
            device=device)
        Ym, coding = _code_labels(Y, multiclass, Z)
        # Z is orthonormal: the least-squares fit is the projection
        weights = torch.linalg.solve_triangular(R, V @ (Z.T @ Ym),
                                                upper=True)
        self._rft = S
        self.model = {"weights": weights, "coding": coding,
                      "rank": int(rank), "s": s, "t": t}
        return self

    def predict(self, Xt):
        from libskylark_tpu_torch.sketch import ROWWISE

        m = _trained(self.model)
        Zt = self._rft.apply(Xt, ROWWISE, device=m["weights"].device)
        return _decode(Zt @ m["weights"], m["coding"])
