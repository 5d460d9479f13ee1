"""Preconditioners for the Krylov solvers (the port of
libskylark_tpu/algorithms/precond.py): identity, matrix multiply,
triangular inverse and an arbitrary callable pair, each acting on (n, k)
blocks through ``apply`` and ``apply_adjoint``."""

from __future__ import annotations

import torch


class Precond:
    def apply(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_adjoint(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class IdPrecond(Precond):
    """Identity."""

    def apply(self, X):
        return X

    def apply_adjoint(self, X):
        return X


class MatPrecond(Precond):
    """Multiply by a fixed matrix M."""

    def __init__(self, M: torch.Tensor):
        self.M = M

    def apply(self, X):
        return self.M @ X

    def apply_adjoint(self, X):
        return self.M.T @ X


class TriInversePrecond(Precond):
    """R⁻¹ for a triangular R by triangular solves: the Blendenpik right
    preconditioner."""

    def __init__(self, R: torch.Tensor, lower: bool = False):
        self.R = R
        self.lower = lower

    def apply(self, X):
        return torch.linalg.solve_triangular(self.R, X, upper=not self.lower)

    def apply_adjoint(self, X):
        return torch.linalg.solve_triangular(self.R.T, X, upper=self.lower)


class FunctionPrecond(Precond):
    """An arbitrary callable pair (the adjoint defaults to the callable)."""

    def __init__(self, fn, fn_adjoint=None):
        self._fn = fn
        self._fn_adj = fn_adjoint or fn

    def apply(self, X):
        return self._fn(X)

    def apply_adjoint(self, X):
        return self._fn_adj(X)
