"""Algorithms: preconditioners, LSQR and the regression solvers."""

from libskylark_tpu_torch.algorithms import krylov, precond, regression
from libskylark_tpu_torch.algorithms.krylov import KrylovParams, lsqr
from libskylark_tpu_torch.algorithms.precond import (
    FunctionPrecond,
    IdPrecond,
    MatPrecond,
    Precond,
    TriInversePrecond,
)
from libskylark_tpu_torch.algorithms.regression import (
    AcceleratedParams,
    build_blendenpik_precond,
    build_lsrn_precond,
    solve_l2_accelerated,
    solve_l2_exact,
    solve_l2_sketched,
)

__all__ = [
    "krylov", "precond", "regression", "KrylovParams", "lsqr", "Precond",
    "IdPrecond", "MatPrecond", "TriInversePrecond", "FunctionPrecond",
    "AcceleratedParams", "build_blendenpik_precond", "build_lsrn_precond",
    "solve_l2_accelerated", "solve_l2_exact", "solve_l2_sketched",
]
