"""Algorithms: the regression solvers."""

from libskylark_tpu_torch.algorithms import regression
from libskylark_tpu_torch.algorithms.regression import (
    solve_l2_exact,
    solve_l2_sketched,
)

__all__ = ["regression", "solve_l2_exact", "solve_l2_sketched"]
