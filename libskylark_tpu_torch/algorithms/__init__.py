"""Algorithms: preconditioners, the Krylov solvers (LSQR, CG, FlexibleCG,
Chebyshev), prox operators, the regression solvers and the randomized
block solvers (asynch)."""

from libskylark_tpu_torch.algorithms import (asynch, krylov, precond, prox,
                                             regression)
from libskylark_tpu_torch.algorithms.krylov import (KrylovParams, cg,
                                                   chebyshev, flexible_cg,
                                                   lsqr)
from libskylark_tpu_torch.algorithms.precond import (
    FunctionPrecond,
    IdPrecond,
    MatPrecond,
    Precond,
    TriInversePrecond,
)
from libskylark_tpu_torch.algorithms.regression import (
    AcceleratedParams,
    RegressionProblem,
    build_blendenpik_precond,
    build_lsrn_precond,
    solve_l2_accelerated,
    solve_l2_exact,
    solve_l2_sketched,
)

__all__ = [
    "asynch", "krylov", "precond", "prox", "regression", "KrylovParams",
    "cg", "RegressionProblem",
    "chebyshev", "flexible_cg", "lsqr", "Precond",
    "IdPrecond", "MatPrecond", "TriInversePrecond", "FunctionPrecond",
    "AcceleratedParams", "build_blendenpik_precond", "build_lsrn_precond",
    "solve_l2_accelerated", "solve_l2_exact", "solve_l2_sketched",
]
