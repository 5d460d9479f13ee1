"""Base layer of the port: errors, params, the Threefry stream, the random
context, matmul precision, the device policy and the sparse container."""

from libskylark_tpu_torch.base.context import Allocation, Context
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.sparse import SparseMatrix, gemm, spmm, spmm_t
from libskylark_tpu_torch.base import errors, quasirand, randgen, sprand

__all__ = [
    "Allocation", "Context", "Params", "SparseMatrix", "gemm", "spmm",
    "spmm_t", "errors", "randgen", "quasirand", "sprand",
]
