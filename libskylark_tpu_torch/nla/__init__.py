"""NLA layer: randomized SVD, CholeskyQR2, least squares, condition
estimation, range finders and range-assisted factorizations, randomized
EVDs of AᵀA, and the Chebyshev spectral helpers."""

from libskylark_tpu_torch.nla import (condest, krank, least_squares, lowrank,
                                      randlobpcg, spectral, svd, tsqr)
from libskylark_tpu_torch.nla.condest import condest as estimate_condition
from libskylark_tpu_torch.nla.condest import condest_serve
from libskylark_tpu_torch.nla.krank import (
    RandomizedRangeFinder,
    RangeAssistedEVD,
    RangeAssistedSVD,
    randomized_svd,
    srft_matrix,
)
from libskylark_tpu_torch.nla.least_squares import (
    approximate_least_squares,
    fast_least_squares,
)
from libskylark_tpu_torch.nla.lowrank import (
    approximate_dominant_subspace_basis,
)
from libskylark_tpu_torch.nla.randlobpcg import (
    lobpcg_rand_evd,
    power_iterations_rand_evd,
)
from libskylark_tpu_torch.nla.spectral import (chebyshev_diff_matrix,
                                               chebyshev_points)
from libskylark_tpu_torch.nla.svd import (
    ApproximateSVDParams,
    approximate_svd,
    approximate_symmetric_svd,
    power_iteration,
)

__all__ = [
    "condest", "krank", "least_squares", "lowrank", "randlobpcg",
    "spectral", "svd", "tsqr", "estimate_condition", "condest_serve",
    "RandomizedRangeFinder", "RangeAssistedSVD", "RangeAssistedEVD",
    "randomized_svd", "srft_matrix", "approximate_dominant_subspace_basis",
    "lobpcg_rand_evd", "power_iterations_rand_evd",
    "approximate_least_squares", "fast_least_squares", "chebyshev_points",
    "chebyshev_diff_matrix", "ApproximateSVDParams", "approximate_svd",
    "approximate_symmetric_svd", "power_iteration",
]
