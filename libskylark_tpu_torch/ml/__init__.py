"""ML layer: kernels and their random feature maps (``Gaussian(N,
sigma).create_rft(S, context, "fast")``), KRR and RLSC in five regimes,
the Block-ADMM kernel machines, Hilbert-space models, and the nonlinear
RLS toolkit. ``ml/graph.py`` is not ported yet."""

from libskylark_tpu_torch.ml import (admm, coding, kernels, krr, metrics,
                                     model, modeling, nonlinear, rlsc)
from libskylark_tpu_torch.ml.admm import BlockADMMSolver
from libskylark_tpu_torch.ml.coding import dummy_coding, dummy_decode
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
from libskylark_tpu_torch.ml.krr import (
    FeatureMapPrecond,
    KrrParams,
    approximate_kernel_ridge,
    faster_kernel_ridge,
    kernel_ridge,
    krr_predict,
    large_scale_kernel_ridge,
    sketched_approximate_kernel_ridge,
)
from libskylark_tpu_torch.ml.metrics import classification_accuracy, rmse
from libskylark_tpu_torch.ml.model import HilbertModel
from libskylark_tpu_torch.ml.modeling import LinearizedKernelModel
from libskylark_tpu_torch.ml.nonlinear import (RLS, NystromRLS, SketchPCR,
                                               SketchRLS)
from libskylark_tpu_torch.ml.rlsc import (
    RlscParams,
    approximate_kernel_rlsc,
    faster_kernel_rlsc,
    kernel_rlsc,
    large_scale_kernel_rlsc,
    sketched_approximate_kernel_rlsc,
)

__all__ = [
    "admm", "metrics", "modeling", "nonlinear", "classification_accuracy",
    "rmse", "LinearizedKernelModel", "RLS", "SketchRLS", "NystromRLS",
    "SketchPCR", "model", "BlockADMMSolver", "HilbertModel", "coding",
    "kernels", "krr", "rlsc", "dummy_coding", "dummy_decode", "Kernel",
    "KERNELS", "Linear", "Gaussian", "Polynomial", "Laplacian",
    "ExpSemigroup", "Matern", "deserialize_kernel", "make_kernel",
    "KrrParams", "FeatureMapPrecond", "kernel_ridge", "krr_predict",
    "approximate_kernel_ridge", "sketched_approximate_kernel_ridge",
    "faster_kernel_ridge", "large_scale_kernel_ridge", "RlscParams",
    "kernel_rlsc", "approximate_kernel_rlsc",
    "sketched_approximate_kernel_rlsc", "faster_kernel_rlsc",
    "large_scale_kernel_rlsc",
]
