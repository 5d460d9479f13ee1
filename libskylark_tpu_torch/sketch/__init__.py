"""Sketching transforms: ``T = JLT(N, S, context); SA = T.apply(A,
COLUMNWISE)``, serialization via ``T.to_json()`` / ``deserialize_sketch``."""

from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fwht, cuda_hash, fut,
                                         params)
from libskylark_tpu_torch.sketch.dense import CT, JLT, DenseTransform
from libskylark_tpu_torch.sketch.fjlt import FJLT, RFUT
from libskylark_tpu_torch.sketch.hash import CWT, MMT, WZT, HashTransform
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
    "cuda_hash", "cuda_fwht", "fut", "DenseTransform", "JLT", "CT",
    "HashTransform", "CWT", "MMT", "WZT", "FJLT", "RFUT",
]
