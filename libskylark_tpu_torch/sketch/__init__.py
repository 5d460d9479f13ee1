"""Sketching transforms: ``T = JLT(N, S, context); SA = T.apply(A,
COLUMNWISE)``, serialization via ``T.to_json()`` / ``deserialize_sketch``.
Random features: GaussianRFT, LaplacianRFT, ExpSemigroupRLT, the Fastfood
FastGaussianRFT, the quasi-random QRFTs, PPT (TensorSketch), and the
sampling UST."""

from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood, cuda_fwht,
                                         cuda_hash, cuda_sparse, fut, params,
                                         sparse_serve)
from libskylark_tpu_torch.sketch.dense import CT, JLT, DenseTransform
from libskylark_tpu_torch.sketch.fjlt import FJLT, RFUT
from libskylark_tpu_torch.sketch.frft import (FastGaussianRFT, FastMaternRFT,
                                              FastRFT)
from libskylark_tpu_torch.sketch.hash import CWT, MMT, WZT, HashTransform
from libskylark_tpu_torch.sketch.ppt import PPT
from libskylark_tpu_torch.sketch.qrft import (QRFT, ExpSemigroupQRLT,
                                              GaussianQRFT, LaplacianQRFT)
from libskylark_tpu_torch.sketch.rft import (RFT, ExpSemigroupRLT,
                                             GaussianRFT, LaplacianRFT,
                                             MaternRFT)
from libskylark_tpu_torch.sketch.transform import (
    COLUMNWISE,
    ROWWISE,
    Dimension,
    SketchTransform,
    deserialize_sketch,
    register,
)
from libskylark_tpu_torch.sketch.ust import UST

__all__ = [
    "COLUMNWISE", "ROWWISE", "Dimension", "SketchTransform",
    "deserialize_sketch", "register", "params", "cuda_dense",
    "cuda_hash", "cuda_fwht", "cuda_fastfood", "cuda_sparse", "sparse_serve",
    "fut", "DenseTransform",
    "JLT", "CT", "HashTransform", "CWT", "MMT", "WZT", "FJLT", "RFUT",
    "RFT", "GaussianRFT", "LaplacianRFT", "MaternRFT", "ExpSemigroupRLT",
    "FastRFT", "FastGaussianRFT", "FastMaternRFT", "QRFT", "GaussianQRFT",
    "LaplacianQRFT", "ExpSemigroupQRLT", "PPT", "UST",
]
