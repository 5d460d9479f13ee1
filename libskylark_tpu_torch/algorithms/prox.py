"""Losses and regularizers with proximal operators (the port of
libskylark_tpu/algorithms/prox.py), the parts of the ADMM kernel machines
(ml/admm.py) that act on predictions and weights.

Conventions:
- ``O``/``X`` is (k, n): k outputs (1 for regression, the number of
  classes for classification), n examples.
- ``T`` is the target: for k == 1 the (n,) value or ±1-label vector; for
  k > 1 the (n,) integer class labels, one-vs-all encoded as ±1 on the
  fly.
- ``prox(X, lam, T)`` returns argmin_Y loss(Y, T) + 1/(2·lam)‖Y − X‖².

Everything is elementwise torch on the operands' device. The logistic prox
is a fixed number of damped Newton steps, batched across samples.
"""

from __future__ import annotations

import torch


def _expand_targets(T: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) labels → (k, n) ±1 one-vs-all matrix when k > 1; reshaped to
    (1, n) otherwise."""
    if k == 1:
        return T.reshape(1, -1)
    labels = T.reshape(-1).to(torch.int64)
    return torch.where(
        torch.arange(k, device=T.device)[:, None] == labels[None, :],
        1.0, -1.0)


class Loss:
    """Interface: ``evaluate(O, T)`` and ``prox(X, lam, T)``."""

    name = "loss"

    def evaluate(self, O: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prox(self, X: torch.Tensor, lam: float,
             T: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class SquaredLoss(Loss):
    """0.5‖O − T‖²_F."""

    name = "squared"

    def evaluate(self, O, T):
        Tm = _expand_targets(T, O.shape[0])
        return 0.5 * torch.sum((O - Tm) ** 2)

    def prox(self, X, lam, T):
        Tm = _expand_targets(T, X.shape[0])
        return (X + lam * Tm) / (1.0 + lam)


class LADLoss(Loss):
    """Least absolute deviations ‖O − T‖₁; the prox clamps softly toward
    the target."""

    name = "lad"

    def evaluate(self, O, T):
        Tm = _expand_targets(T, O.shape[0])
        return torch.sum(torch.abs(O - Tm))

    def prox(self, X, lam, T):
        Tm = _expand_targets(T, X.shape[0])
        return torch.where(X > Tm + lam, X - lam,
                           torch.where(X < Tm - lam, X + lam, Tm))


class HingeLoss(Loss):
    """Σ max(1 − t·o, 0)."""

    name = "hinge"

    def evaluate(self, O, T):
        Tm = _expand_targets(T, O.shape[0])
        return torch.sum(torch.clamp_min(1.0 - Tm * O, 0.0))

    def prox(self, X, lam, T):
        Tm = _expand_targets(T, X.shape[0])
        yv = Tm * X
        return torch.where(yv > 1.0, X,
                           torch.where(yv < 1.0 - lam, X + lam * Tm, Tm))


class LogisticLoss(Loss):
    """Multiclass logistic: Σᵢ −o_{tᵢ,i} + logsumexp(o_{:,i}). The prox is
    ``newton_iters`` damped Newton steps, batched across samples."""

    name = "logistic"

    def __init__(self, newton_iters: int = 30):
        self._iters = int(newton_iters)

    def evaluate(self, O, T):
        labels = T.reshape(-1).to(torch.int64)
        picked = O[labels, torch.arange(O.shape[1], device=O.device)]
        return torch.sum(-picked + torch.logsumexp(O, dim=0))

    def prox(self, X, lam, T):
        # argmin_x  −x_t + logsumexp(x) + 1/(2 lam) ‖x − v‖², per column
        k, _ = X.shape
        labels = T.reshape(-1).to(torch.int64)
        E = (torch.arange(k, device=X.device)[:, None]
             == labels[None, :]).to(X.dtype)
        ilam = 1.0 / lam
        x = X
        for _ in range(self._iters):
            p = torch.softmax(x, dim=0)
            grad = p - E + ilam * (x - X)
            # the Hessian's diagonal diag(p) + 1/lam, then the rank-one
            # −p·pᵀ term put back by one projection
            u = grad / (p + ilam)
            z = p / (p + ilam)
            pu = torch.sum(p * u, dim=0, keepdim=True)
            pptil = 1.0 - torch.sum(z * p, dim=0, keepdim=True)
            u = u - (pu / torch.clamp_min(pptil, 1e-12)) * z
            x = x - 0.5 * u
        return x


class Regularizer:
    """Interface: ``evaluate(W)`` and ``prox(W, lam, mu)``, which returns
    argmin_P r(P) + 1/(2·lam)‖P − (W − mu)‖², shifted by the dual
    variable mu."""

    name = "regularizer"

    def evaluate(self, W: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prox(self, W: torch.Tensor, lam: float,
             mu: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class EmptyRegularizer(Regularizer):
    """No regularization."""

    name = "none"

    def evaluate(self, W):
        return torch.zeros((), dtype=W.dtype, device=W.device)

    def prox(self, W, lam, mu):
        return W - mu


class L2Regularizer(Regularizer):
    """0.5‖W‖²; shrink."""

    name = "l2"

    def evaluate(self, W):
        return 0.5 * torch.sum(W * W)

    def prox(self, W, lam, mu):
        return (W - mu) / (1.0 + lam)


class L1Regularizer(Regularizer):
    """‖W‖₁; soft-threshold."""

    name = "l1"

    def evaluate(self, W):
        return torch.sum(torch.abs(W))

    def prox(self, W, lam, mu):
        V = W - mu
        return torch.sign(V) * torch.clamp_min(torch.abs(V) - lam, 0.0)


LOSSES = {c.name: c for c in [SquaredLoss, LADLoss, HingeLoss, LogisticLoss]}
REGULARIZERS = {c.name: c
                for c in [EmptyRegularizer, L2Regularizer, L1Regularizer]}
