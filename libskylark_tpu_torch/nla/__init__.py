"""NLA layer: randomized SVD, CholeskyQR2, sketch-and-solve least squares."""

from libskylark_tpu_torch.nla import least_squares, svd, tsqr
from libskylark_tpu_torch.nla.least_squares import approximate_least_squares
from libskylark_tpu_torch.nla.svd import (
    ApproximateSVDParams,
    approximate_svd,
    approximate_symmetric_svd,
    power_iteration,
)

__all__ = [
    "least_squares", "svd", "tsqr", "approximate_least_squares",
    "ApproximateSVDParams", "approximate_svd", "approximate_symmetric_svd",
    "power_iteration",
]
