"""ML layer: kernels and their random feature maps, ``Gaussian(N,
sigma).create_rft(S, context, "fast")``. KRR, RLSC and ADMM are not
ported yet."""

from libskylark_tpu_torch.ml import kernels
from libskylark_tpu_torch.ml.kernels import (
    KERNELS,
    ExpSemigroup,
    Gaussian,
    Kernel,
    Laplacian,
    Linear,
    Matern,
    Polynomial,
    deserialize_kernel,
    make_kernel,
)

__all__ = [
    "kernels", "Kernel", "KERNELS", "Linear", "Gaussian", "Polynomial",
    "Laplacian", "ExpSemigroup", "Matern", "deserialize_kernel",
    "make_kernel",
]
