"""Local sparse matrix: CSC on the host, COO or dense tensors on demand.

The port of libskylark_tpu/base/sparse.py's ``SparseMatrix``. The matrix
is immutable and its CSC buffers live in numpy (construction attaches
scipy buffers without a copy where it can); ``coo`` and ``todense`` place
it on a device as torch tensors, the package default device unless the
caller names one. ``csr_parts`` gives the canonical CSR
form — row-major, sorted column indices, duplicates summed — whose
nonzero order the sparse serve endpoints accumulate in. The sparse×dense
products (``spmm``, ``spmm_t``, ``gemm``) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import resolve_device


class SparseMatrix:
    """Immutable local sparse matrix, CSC on the host."""

    def __init__(self, colptr: np.ndarray, rowind: np.ndarray,
                 values: np.ndarray, shape: Tuple[int, int]):
        self._colptr = np.asarray(colptr, dtype=np.int64)
        self._rowind = np.asarray(rowind, dtype=np.int32)
        self._values = np.asarray(values)
        self._shape = (int(shape[0]), int(shape[1]))
        if len(self._colptr) != self._shape[1] + 1:
            raise errors.InvalidParametersError(
                f"colptr length {len(self._colptr)} != width+1 "
                f"{self._shape[1] + 1}")
        if len(self._rowind) != len(self._values):
            raise errors.InvalidParametersError(
                "rowind/values length mismatch")
        self._csr = None  # canonical CSR parts, made once (immutable)

    # -- constructors --

    @classmethod
    def from_scipy(cls, A) -> "SparseMatrix":
        """Attach a ``scipy.sparse`` matrix (zero-copy when it is CSC)."""
        A = A.tocsc()
        return cls(A.indptr, A.indices, A.data, A.shape)

    @classmethod
    def from_coo(cls, rows, cols, values,
                 shape: Tuple[int, int]) -> "SparseMatrix":
        """Duplicate-summing COO → CSC build."""
        import scipy.sparse as sp

        A = sp.coo_matrix(
            (np.asarray(values), (np.asarray(rows), np.asarray(cols))),
            shape=shape).tocsc()
        A.sum_duplicates()
        return cls(A.indptr, A.indices, A.data, A.shape)

    @classmethod
    def from_csr(cls, data, indices, indptr,
                 shape: Tuple[int, int]) -> "SparseMatrix":
        """Build from CSR parts, the inverse of :meth:`csr_parts`;
        duplicates are summed."""
        import scipy.sparse as sp

        A = sp.csr_matrix(
            (np.asarray(data), np.asarray(indices), np.asarray(indptr)),
            shape=shape, copy=True)
        A.sum_duplicates()
        out = cls.from_scipy(A)
        out._csr = _canonical_parts(A)
        return out

    @classmethod
    def from_dense(cls, A, threshold: float = 0.0) -> "SparseMatrix":
        import scipy.sparse as sp

        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        if threshold > 0.0:
            A = np.where(np.abs(A) > threshold, A, 0.0)
        return cls.from_scipy(sp.csc_matrix(A))

    # -- queries --

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def height(self) -> int:
        return self._shape[0]

    @property
    def width(self) -> int:
        return self._shape[1]

    @property
    def nnz(self) -> int:
        return len(self._values)

    @property
    def density(self) -> float:
        """nnz / (height·width): the serve layer's auto-densify signal."""
        cells = self._shape[0] * self._shape[1]
        return (len(self._values) / cells) if cells else 0.0

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device_dtype(self) -> np.dtype:
        """The dtype of the values once placed on a device: float64 host
        buffers land as float32, the package's precision policy."""
        return (np.dtype(np.float32) if self._values.dtype == np.float64
                else self._values.dtype)

    @property
    def indptr(self) -> np.ndarray:
        return self._colptr

    @property
    def indices(self) -> np.ndarray:
        return self._rowind

    @property
    def data(self) -> np.ndarray:
        return self._values

    # -- conversions --

    def coo(self, dtype=None, device=None):
        """(rows, cols, vals) as tensors on ``device`` (the package
        default device unless given): int64 coordinates in CSC order,
        values in ``dtype`` (default :attr:`device_dtype`)."""
        device = resolve_device(device)
        eff = np.dtype(dtype) if dtype is not None else self.device_dtype
        cols = np.repeat(np.arange(self.width, dtype=np.int64),
                         np.diff(self._colptr))
        return (torch.as_tensor(self._rowind.astype(np.int64), device=device),
                torch.as_tensor(cols, device=device),
                torch.as_tensor(self._values.astype(eff, copy=False),
                                device=device))

    def csr_parts(self, dtype=None):
        """Canonical CSR parts ``(data, indices, indptr)`` as numpy arrays:
        row-major, sorted column indices, duplicates summed; int32
        indices. ``dtype=None`` resolves to :attr:`device_dtype`. Made
        once per matrix and shared: the arrays are read-only."""
        eff = np.dtype(dtype) if dtype is not None else self.device_dtype
        if self._csr is None:
            A = self.to_scipy().tocsr()
            A.sum_duplicates()
            self._csr = _canonical_parts(A)
        data, indices, indptr = self._csr
        return np.asarray(data, dtype=eff), indices, indptr

    def todense(self, dtype=None, device=None) -> torch.Tensor:
        """The dense matrix on ``device`` (the package default device
        unless given)."""
        r, c, v = self.coo(dtype, device)
        out = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
        return out.index_put_((r, c), v, accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix((self._values, self._rowind, self._colptr),
                             shape=self._shape)

    # -- structural ops --

    def transpose(self) -> "SparseMatrix":
        return SparseMatrix.from_scipy(self.to_scipy().T)

    @property
    def T(self) -> "SparseMatrix":
        return self.transpose()

    def column_view(self, j0: int, j1: int) -> "SparseMatrix":
        """Columns [j0, j1), sharing the rowind/values buffers."""
        lo, hi = self._colptr[j0], self._colptr[j1]
        return SparseMatrix(self._colptr[j0:j1 + 1] - lo,
                            self._rowind[lo:hi], self._values[lo:hi],
                            (self.height, j1 - j0))

    def __repr__(self) -> str:
        return (f"SparseMatrix({self.height}x{self.width}, nnz={self.nnz}, "
                f"dtype={self.dtype})")


def _canonical_parts(A):
    """Read-only (data, int32 indices, int32 indptr) of a scipy CSR matrix
    whose duplicates are summed, its column indices sorted."""
    A.sort_indices()
    parts = (np.array(A.data), np.asarray(A.indices, dtype=np.int32).copy(),
             np.asarray(A.indptr, dtype=np.int32).copy())
    for p in parts:
        p.setflags(write=False)
    return parts


def is_sparse_operand(A) -> bool:
    """True for the port's sparse matrix kind (``DistSparseMatrix`` is not
    ported yet)."""
    return isinstance(A, SparseMatrix)


def as_sparse(A) -> SparseMatrix:
    """A :class:`SparseMatrix` view of ``A`` (a SparseMatrix or a scipy
    sparse matrix); anything else raises TypeError."""
    if isinstance(A, SparseMatrix):
        return A
    import scipy.sparse as sp

    if sp.issparse(A):
        return SparseMatrix.from_scipy(A)
    raise TypeError(f"expected a SparseMatrix or scipy.sparse operand, got "
                    f"{type(A).__name__}")
