"""HDF5 dataset IO, layout-compatible with libSkylark's (the port of
libskylark_tpu/io/hdf5.py; host numpy and h5py, no device work).

Dense layout (ref: ml/io.hpp write_hdf5:18-115): datasets ``X`` (n×d
float64) and ``Y`` (n). Sparse layout (ref: ml/io.hpp:124-205,256-507):
``dimensions`` = [d, n, nnz] ints, ``indptr`` (n+1, per-example CSC with
examples as columns of a d×n matrix), ``indices`` (feature indices),
``values``, ``Y`` — i.e. scipy CSR over examples, verbatim.

Gated on h5py at call time: ``have_hdf5()`` reports whether it is there.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.sparse import SparseMatrix


def have_hdf5() -> bool:
    try:
        import h5py  # noqa: F401

        return True
    except ImportError:
        return False


def _require_h5py():
    try:
        import h5py

        return h5py
    except ImportError as e:
        raise errors.UnsupportedError(
            "h5py not available; HDF5 IO disabled") from e


def write_hdf5(path, X, Y) -> None:
    """Write ``(X, Y)`` (examples as rows) to HDF5 in the reference layout."""
    h5py = _require_h5py()
    Y = np.asarray(Y, dtype=np.float64).reshape(-1)
    with h5py.File(path, "w") as f:
        if isinstance(X, SparseMatrix):
            sp = X.to_scipy().tocsr()
            n, d = sp.shape
            f.create_dataset(
                "dimensions", data=np.array([d, n, sp.nnz], dtype=np.int64))
            f.create_dataset("indptr", data=sp.indptr.astype(np.int64))
            f.create_dataset("indices", data=sp.indices.astype(np.int64))
            f.create_dataset("values", data=sp.data.astype(np.float64))
        else:
            X = np.asarray(X, dtype=np.float64)
            f.create_dataset("X", data=X)
        f.create_dataset("Y", data=Y)


def read_hdf5(
    path, sparse: bool = False, min_d: int = 0, dtype=np.float32
) -> Tuple[Union[np.ndarray, SparseMatrix], np.ndarray]:
    """Read ``(X, Y)`` (examples as rows) from the reference HDF5 layout."""
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        Y = np.asarray(f["Y"]).astype(dtype)
        if sparse or "X" not in f:
            dims = np.asarray(f["dimensions"])
            d, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            d = max(d, min_d)
            indptr = np.asarray(f["indptr"]).astype(np.int64)
            indices = np.asarray(f["indices"]).astype(np.int64)
            values = np.asarray(f["values"]).astype(dtype)
            if len(indptr) != n + 1 or len(indices) != nnz:
                raise errors.IOError_(
                    f"inconsistent sparse HDF5 file {path}")
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            X: Union[np.ndarray, SparseMatrix] = SparseMatrix.from_coo(
                rows, indices, values, (n, d))
        else:
            X = np.asarray(f["X"]).astype(dtype)
            if min_d > X.shape[1]:
                X = np.pad(X, ((0, 0), (0, min_d - X.shape[1])))
    return X, Y
