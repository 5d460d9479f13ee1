"""Local sparse matrix (CSC on the host) and sparse×dense products.

The port of libskylark_tpu/base/sparse.py. The matrix is immutable and
its CSC buffers live in numpy (construction attaches scipy buffers
without a copy where it can); ``coo``, ``csr`` and ``csr_t`` place it on
a device as torch tensors, the package default device unless the caller
names one, made once per (kind, dtype, device) and kept, as the
reference keeps its device triplets: a solver's products do not upload
the operand again. ``csr_parts`` gives the canonical CSR form —
row-major, sorted column indices, duplicates summed — whose nonzero
order the sparse serve endpoints accumulate in.

The products ``spmm`` (A·B) and ``spmm_t`` (Aᵀ·B) take one of two
routes, by the device of B:

- a CPU tensor: the reference's ``segment_sum`` formulation, v·B[c]
  added into row r by ``index_add_`` in the COO order (CSC: column-major,
  rows ascending in each column), which on the CPU adds in index order —
  the order of the reference's CPU ``segment_sum``;
- a CUDA tensor: a CSR product (``torch.sparse_csr_tensor(...) @ B``,
  cuSPARSE). ``spmm`` multiplies by the canonical CSR of A, ``spmm_t``
  by the CSC storage read as the CSR of Aᵀ. ``index_add_``'s CUDA
  atomics add in no fixed order, so it is not used there.

The reference's products are XLA ``segment_sum`` outside any Pallas
kernel, so a library call is their port. ``products`` counts the calls
and nonzeros of each route, and ``conversions["todense"]`` the
densifications, so a run can show which route it took.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.kernels.launch import count

# calls and nonzeros of each product route, and densifications
products = {"csr_calls": 0, "csr_nnz": 0, "plain_calls": 0, "plain_nnz": 0}
conversions = {"todense": 0}


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
        self._dev = {}  # (kind, dtype, device) -> device tensors
        self._t = None  # the transpose, made once; its _t is self

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
    def tensor_dtype(self) -> torch.dtype:
        """:attr:`device_dtype` as a torch dtype."""
        return getattr(torch, self.device_dtype.name)

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

    def _eff_dtype(self, dtype) -> np.dtype:
        if isinstance(dtype, torch.dtype):
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        return np.dtype(dtype) if dtype is not None else self.device_dtype

    def _cached(self, kind: str, dtype, device, make):
        """The device tensors of ``kind`` in ``dtype`` on ``device``, made
        by ``make(eff_dtype, device)`` on first use and kept. Callers must
        not write into them."""
        eff, dev = self._eff_dtype(dtype), resolve_device(device)
        key = (kind, eff.str, str(dev))
        hit = self._dev.get(key)
        if hit is None and self._t is not None and kind in _TWIN:
            # A's csr is Aᵀ's csr_t and the other way round
            hit = self._t._dev.get((_TWIN[kind], *key[1:]))
        if hit is None:
            hit = make(eff, dev)
            self._dev[key] = hit
        return hit

    def coo(self, dtype=None, device=None):
        """(rows, cols, vals) as tensors on ``device`` (the package
        default device unless given): int64 coordinates in CSC order,
        values in ``dtype`` (default :attr:`device_dtype`). Made once per
        (dtype, device) and shared: read-only."""
        def make(eff, dev):
            cols = np.repeat(np.arange(self.width, dtype=np.int64),
                             np.diff(self._colptr))
            return (torch.as_tensor(self._rowind.astype(np.int64),
                                    device=dev),
                    torch.as_tensor(cols, device=dev),
                    torch.as_tensor(self._values.astype(eff, copy=False),
                                    device=dev))

        return self._cached("coo", dtype, device, make)

    def csr(self, dtype=None, device=None):
        """The canonical CSR parts of A (:meth:`csr_parts`) on ``device``:
        ``(data, indices, indptr)``, int32 indices. Made once per (dtype,
        device) and shared: read-only."""
        def make(eff, dev):
            return tuple(torch.tensor(x, device=dev)
                         for x in self.csr_parts(eff))

        return self._cached("csr", dtype, device, make)

    def csr_t(self, dtype=None, device=None):
        """The CSR parts ``(data, indices, indptr)`` of Aᵀ, which are A's
        CSC storage (values, ``rowind``, ``colptr``; canonicalised first
        if it holds duplicates or unsorted rows), on ``device`` with int32
        indices. Made once per (dtype, device) and shared: read-only."""
        def make(eff, dev):
            A = self.to_scipy()
            if not A.has_canonical_format:
                A = A.copy()
                A.sum_duplicates()
            return (torch.tensor(A.data.astype(eff), device=dev),
                    torch.tensor(A.indices.astype(np.int32), device=dev),
                    torch.tensor(A.indptr.astype(np.int32), device=dev))

        return self._cached("csr_t", dtype, device, make)

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
        unless given); counted in ``conversions["todense"]``."""
        count(conversions, "todense")
        r, c, v = self.coo(dtype, device)
        out = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
        return out.index_put_((r, c), v, accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix((self._values, self._rowind, self._colptr),
                             shape=self._shape)

    # -- structural ops --

    def transpose(self) -> "SparseMatrix":
        """Aᵀ, made once and kept: later calls return the same matrix,
        whose device CSR forms are A's (``csr`` of one is ``csr_t`` of
        the other), so a solver that factors Aᵀ uploads nothing again."""
        if self._t is None:
            self._t = SparseMatrix.from_scipy(self.to_scipy().T)
            self._t._t = self
        return self._t

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


_TWIN = {"csr": "csr_t", "csr_t": "csr"}


def _canonical_parts(A):
    """Read-only (data, int32 indices, int32 indptr) of a scipy CSR matrix
    whose duplicates are summed, its column indices sorted."""
    A.sort_indices()
    parts = (np.array(A.data), np.asarray(A.indices, dtype=np.int32).copy(),
             np.asarray(A.indptr, dtype=np.int32).copy())
    for p in parts:
        p.setflags(write=False)
    return parts


def _is_dist(A) -> bool:
    from libskylark_tpu_torch.base.dist_sparse import DistSparseMatrix

    return isinstance(A, DistSparseMatrix)


def is_sparse_operand(A) -> bool:
    """True for the port's sparse matrix kinds — a local
    :class:`SparseMatrix` or a mesh-distributed ``DistSparseMatrix`` — the
    shared predicate of operand dispatch in the solver layers."""
    return isinstance(A, SparseMatrix) or _is_dist(A)


def place(A, device=None):
    """(A, device) for the solver layers: a sparse operand stays as it is,
    beside the resolved device (a distributed one beside its rank's own
    device); a DTensor too, beside its block's device (``device`` is not
    read); anything else becomes a tensor on ``device`` and comes with
    its own."""
    if _is_dist(A):
        return A, A.device
    from libskylark_tpu_torch.parallel.mesh import _is_sharded

    if _is_sharded(A):
        return A, A.to_local().device
    if is_sparse_operand(A):
        return A, resolve_device(device)
    A = as_tensor(A, device)
    return A, A.device


def linear_ops(A):
    """(mv, rmv): X ↦ A·X and X ↦ Aᵀ·X, by spmm/spmm_t for a sparse
    operand (never densified; a distributed one by its own collective
    products), by matmul for a tensor. For a DTensor A (rows sharded,
    columns whole) mv takes X whole (a tensor or a Replicate() DTensor)
    and gives A·X sharded like A's rows, with no traffic; rmv takes Y
    sharded like A's rows and gives Aᵀ·Y Replicate(): the local
    A_locᵀ·Y_loc, then one all_reduce (the reference's (Yᵀ·A)ᵀ)."""
    if _is_dist(A):
        return A.spmm, A.spmm_t
    from libskylark_tpu_torch.parallel import mesh as pmesh

    if pmesh._is_sharded(A):
        B = pmesh._Blocks(A)
        if B.cols.split:
            raise errors.NotImplementedYetError(
                "linear_ops of a DTensor with split columns (ROADMAP A5b)")

        def mv(X):
            X = X.to_local() if pmesh._is_sharded(X) else X
            return B.rows.wrap(B.mv(X))

        def rmv(Y):
            return B.cols.wrap(B.rmv(B.row_block(Y)))

        return mv, rmv
    if is_sparse_operand(A):
        return (lambda X: spmm(A, X)), (lambda X: spmm_t(A, X))
    return (lambda X: A @ X), (lambda X: A.T @ X)


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


def _dense_operand(B, rows: int, name: str, A: SparseMatrix):
    """B as a 2-D tensor (a vector becomes one column) on its device, or
    the package default device for a numpy array; and whether to squeeze
    the result back to a vector."""
    if not isinstance(B, torch.Tensor):
        B = as_tensor(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if B.shape[0] != rows:
        raise errors.InvalidParametersError(
            f"{name}: A is {A.shape}, B is {tuple(B.shape)}")
    return B, squeeze


def _product(A: SparseMatrix, B: torch.Tensor, transpose: bool):
    """Aᵀ·B (``transpose``) or A·B by the route of B's device (module
    docstring)."""
    out_rows = A.width if transpose else A.height
    if B.device.type == "cuda":
        val, idx, ptr = (A.csr_t if transpose else A.csr)(B.dtype, B.device)
        M = torch.sparse_csr_tensor(ptr, idx, val, (out_rows, B.shape[0]),
                                    check_invariants=False)
        count(products, "csr_calls")
        count(products, "csr_nnz", A.nnz)
        return M @ B.contiguous()
    r, c, v = A.coo(B.dtype, B.device)
    src, dst = (r, c) if transpose else (c, r)
    out = torch.zeros((out_rows, B.shape[1]), dtype=B.dtype,
                      device=B.device)
    count(products, "plain_calls")
    count(products, "plain_nnz", A.nnz)
    return out.index_add_(0, dst, v[:, None] * B[src])


def spmm(A: SparseMatrix, B) -> torch.Tensor:
    """A @ B with A sparse (h×w), B dense (w×k) or a vector → dense (h×k)
    on B's device: out[r] += v·B[c] for each nonzero (r, c, v)."""
    B, squeeze = _dense_operand(B, A.width, "spmm", A)
    out = _product(A, B, transpose=False)
    return out[:, 0] if squeeze else out


def spmm_t(A: SparseMatrix, B) -> torch.Tensor:
    """Aᵀ @ B with A sparse (h×w), B dense (h×k) or a vector → dense
    (w×k) on B's device."""
    B, squeeze = _dense_operand(B, A.height, "spmm_t", A)
    out = _product(A, B, transpose=True)
    return out[:, 0] if squeeze else out


def gemm(A, B, transpose_a: bool = False, device=None):
    """The unified dense/sparse matmul: sparse operands take the products
    above, sparse×sparse stays on the host (a scipy product, a
    :class:`SparseMatrix` result, as in the reference), dense×dense is a
    torch matmul on ``device``."""
    a_sp = isinstance(A, SparseMatrix)
    b_sp = isinstance(B, SparseMatrix)
    if a_sp and b_sp:
        out = ((A.to_scipy().T if transpose_a else A.to_scipy())
               @ B.to_scipy())
        return SparseMatrix.from_scipy(out)
    if a_sp:
        B = as_tensor(B, device)
        return spmm_t(A, B) if transpose_a else spmm(A, B)
    A = as_tensor(A, device)
    if transpose_a:
        A = A.T
    if b_sp:
        # A @ B = (Bᵀ @ Aᵀ)ᵀ
        return spmm_t(B, A.T).T
    return A @ as_tensor(B, A.device)
