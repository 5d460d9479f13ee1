"""libskylark_tpu_torch — the PyTorch/CUDA port of libskylark_tpu.

Randomized numerical linear algebra on an NVIDIA Hopper GPU: seeded
sketches whose operator is a pure function of (seed, counter), randomized
SVD, sketch-and-solve least squares, kernel random feature maps, sparse
operands with LIBSVM IO, and a microbatch serving executor. The module
tree mirrors the JAX package's (base/, sketch/, nla/, algorithms/, ml/,
io/, engine/); hand-written CUDA kernels live in csrc/ and are built by
kernels/build.py. The package imports torch, numpy and scipy only.

Entry points run on the default device ("cuda"; see
:func:`set_default_device`) unless a call passes ``device=``.
"""

__version__ = "0.1.0"

from libskylark_tpu_torch.base.precision import (  # noqa: E402
    install_default_matmul_precision,
)

# f32 products must stay f32-grade for the 1e-4 oracle: TF32 off
install_default_matmul_precision()

from libskylark_tpu_torch.base import errors  # noqa: E402
from libskylark_tpu_torch.base.context import Context  # noqa: E402
from libskylark_tpu_torch.base.sparse import SparseMatrix  # noqa: E402
from libskylark_tpu_torch.base.dist_sparse import (  # noqa: E402
    DistSparseMatrix,
    distribute_sparse,
)
from libskylark_tpu_torch.base.device import (  # noqa: E402
    default_device,
    set_default_device,
)
from libskylark_tpu_torch import (  # noqa: E402
    algorithms, engine, io, ml, nla, sketch, telemetry)

__all__ = [
    "Context", "errors", "SparseMatrix", "DistSparseMatrix",
    "distribute_sparse", "default_device",
    "set_default_device", "algorithms", "engine", "io", "ml", "nla",
    "sketch", "telemetry", "__version__",
]
