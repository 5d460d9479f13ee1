"""LIBSVM-format readers and writer (the port of
libskylark_tpu/io/libsvm.py, its pure-Python parser).

Format, as the reference reads it:

- one example per line: ``label [label2 ...] idx:val idx:val ...``;
- the number of targets is the count of leading tokens of the first line
  that hold no ``:``;
- feature indices are 1-based; the feature dimension is the largest index
  seen, at least ``min_d``;
- an empty line or one starting with ``#`` ends the read;
- ``max_n`` caps the number of examples.

The host parses into numpy (dense) or a :class:`SparseMatrix` (CSC);
placing the data on a device is the caller's. The native parser
(io/native.py, built by g++ at first use) reads when it can, the Python
parser otherwise (``native.runs`` counts which ran). The chunked and
sharded readers are in :mod:`~libskylark_tpu_torch.io.chunked`, the
streaming sketch in :mod:`~libskylark_tpu_torch.io.streaming` and the
HDF5 readers in :mod:`~libskylark_tpu_torch.io.hdf5`.
"""

from __future__ import annotations

import io as _io
import os
from typing import List, Sequence, Tuple, Union

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.sparse import SparseMatrix

ROWS = "rows"
COLUMNS = "columns"


def _open_lines(source) -> List[str]:
    if hasattr(source, "read"):
        return source.read().splitlines()
    with open(source, "r") as f:
        return f.read().splitlines()


def _parse_lines(lines: Sequence[str], max_n: int):
    """One pass: per-line (targets, 0-based indices, values), and (d, nt)."""
    targets, indices, values = [], [], []
    d, nt = 0, -1
    for line in lines:
        if max_n >= 0 and len(targets) == max_n:
            break
        line = line.strip()
        if not line or line.startswith("#"):
            break
        toks = line.split()
        if nt < 0:
            nt = 0
            while nt < len(toks) and ":" not in toks[nt]:
                nt += 1
        try:
            y = np.array([float(t) for t in toks[:nt]], dtype=np.float64)
            pairs = [t.split(":") for t in toks[nt:]]
            idx = np.array([int(p[0]) for p in pairs], dtype=np.int64)
            val = np.array([float(p[1]) for p in pairs], dtype=np.float64)
        except (ValueError, IndexError) as e:
            raise errors.IOError_(f"malformed libsvm line: {line!r}") from e
        if idx.size and idx.min() < 1:
            raise errors.IOError_(
                f"libsvm feature indices are 1-based; got {idx.min()}")
        if idx.size:
            d = max(d, int(idx.max()))
        targets.append(y)
        indices.append(idx - 1)
        values.append(val)
    return targets, indices, values, d, max(nt, 0)


def read_libsvm(source, direction: str = ROWS, sparse: bool = False,
                min_d: int = 0, max_n: int = -1, dtype=np.float32
                ) -> Tuple[Union[np.ndarray, SparseMatrix], np.ndarray]:
    """Read a LIBSVM file (a path or a text stream) into ``(X, Y)``.

    ``direction=ROWS`` gives X with examples as rows (n×d), ``COLUMNS``
    d×n. X is a numpy array, or a :class:`SparseMatrix` with
    ``sparse=True``. Y is (n,) for one target, (n, nt) otherwise
    (transposed with COLUMNS)."""
    if direction not in (ROWS, COLUMNS):
        raise errors.InvalidParametersError(f"bad direction {direction!r}")
    from libskylark_tpu_torch.io import native

    parsed = native.parse_libsvm(source, max_n)
    native.count_run(parsed is not None)
    if parsed is None:
        parsed = _parse_lines(_open_lines(source), max_n)
    targets, indices, values, d, nt = parsed
    n = len(targets)
    d = max(d, min_d)
    Y = np.zeros((n, nt), dtype=np.float64)
    for i, y in enumerate(targets):
        Y[i, :len(y)] = y
    Yout = Y[:, 0].astype(dtype) if nt == 1 else Y.astype(dtype)

    if sparse:
        if n:
            rows = np.concatenate([np.full(len(ix), i, dtype=np.int64)
                                   for i, ix in enumerate(indices)])
            cols = np.concatenate(indices)
            vals = np.concatenate(values).astype(dtype)
        else:
            rows = cols = np.zeros(0, np.int64)
            vals = np.zeros(0, dtype)
        if direction == ROWS:
            return SparseMatrix.from_coo(rows, cols, vals, (n, d)), Yout
        if nt != 1:
            Yout = Yout.T
        return SparseMatrix.from_coo(cols, rows, vals, (d, n)), Yout

    X = np.zeros((n, d), dtype=dtype)
    for i, (ix, v) in enumerate(zip(indices, values)):
        X[i, ix] = v
    if direction == COLUMNS:
        X = np.ascontiguousarray(X.T)
        if nt != 1:
            Yout = Yout.T
    return X, Yout


def _trim_shard(lines: List[str]) -> List[str]:
    """A shard's lines up to its first blank or comment line, so shards
    concatenate safely."""
    out = []
    for line in lines:
        if not line.strip() or line.strip().startswith("#"):
            break
        out.append(line)
    return out


def read_dir_libsvm(dirname: str, direction: str = ROWS,
                    sparse: bool = False, min_d: int = 0, max_n: int = -1,
                    dtype=np.float32):
    """Every regular file of ``dirname``, in sorted order, read as one
    libsvm dataset; each shard ends at its own first blank line."""
    names = sorted(os.path.join(dirname, f) for f in os.listdir(dirname)
                   if os.path.isfile(os.path.join(dirname, f)))
    if not names:
        raise errors.IOError_(f"no files in {dirname}")
    buf = _io.StringIO("\n".join(
        ln for name in names for ln in _trim_shard(_open_lines(name))))
    return read_libsvm(buf, direction, sparse, min_d, max_n, dtype)


def write_libsvm(path, X, Y, digits: int = 8) -> None:
    """Write ``(X, Y)``, examples as rows, in libsvm format: zero entries
    skipped, indices 1-based, numbers with ``digits`` significant
    digits. X is a numpy array, a tensor or a :class:`SparseMatrix`."""
    if isinstance(X, SparseMatrix):
        sp = X.to_scipy().tocsr()
        n = sp.shape[0]
        rows = [sp.indices[sp.indptr[i]:sp.indptr[i + 1]] for i in range(n)]
        vals = [sp.data[sp.indptr[i]:sp.indptr[i + 1]] for i in range(n)]
    else:
        X = X.cpu().numpy() if hasattr(X, "cpu") else np.asarray(X)
        n = X.shape[0]
        rows = [np.nonzero(X[i])[0] for i in range(n)]
        vals = [X[i][rows[i]] for i in range(n)]
    Y = Y.cpu().numpy() if hasattr(Y, "cpu") else np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape[0] != n:
        raise errors.InvalidParametersError(
            f"X has {n} examples but Y has {Y.shape[0]}")
    fmt = f"%.{digits}g"
    with open(path, "w") as f:
        for i in range(n):
            labels = " ".join(fmt % y for y in Y[i])
            feats = " ".join(f"{int(j) + 1}:{fmt % v}"
                             for j, v in zip(rows[i], vals[i]))
            f.write(labels + (" " + feats if feats else "") + "\n")
