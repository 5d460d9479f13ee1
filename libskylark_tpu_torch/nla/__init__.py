"""NLA layer: randomized SVD, CholeskyQR2, least squares, condition
estimation."""

from libskylark_tpu_torch.nla import condest, least_squares, svd, tsqr
from libskylark_tpu_torch.nla.condest import condest as estimate_condition
from libskylark_tpu_torch.nla.condest import condest_serve
from libskylark_tpu_torch.nla.least_squares import (
    approximate_least_squares,
    fast_least_squares,
)
from libskylark_tpu_torch.nla.svd import (
    ApproximateSVDParams,
    approximate_svd,
    approximate_symmetric_svd,
    power_iteration,
)

__all__ = [
    "condest", "least_squares", "svd", "tsqr", "estimate_condition",
    "condest_serve", "approximate_least_squares", "fast_least_squares",
    "ApproximateSVDParams", "approximate_svd", "approximate_symmetric_svd",
    "power_iteration",
]
