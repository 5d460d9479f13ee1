"""Sketching transforms: ``T = JLT(N, S, context); SA = T.apply(A,
COLUMNWISE)``, serialization via ``T.to_json()`` / ``deserialize_sketch``."""

from libskylark_tpu_torch.sketch import cuda_dense, params
from libskylark_tpu_torch.sketch.dense import CT, JLT, DenseTransform
from libskylark_tpu_torch.sketch.transform import (
    COLUMNWISE,
    ROWWISE,
    Dimension,
    SketchTransform,
    deserialize_sketch,
    register,
)

__all__ = [
    "COLUMNWISE", "ROWWISE", "Dimension", "SketchTransform",
    "deserialize_sketch", "register", "params", "cuda_dense",
    "DenseTransform", "JLT", "CT",
]
