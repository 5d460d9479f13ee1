"""Arc-list (edge list) graph IO (the port of libskylark_tpu/io/arclist.py).

Lines are ``from to [weight]`` (whitespace separated, weight 1 when
absent); blank lines and lines starting with ``#`` are skipped. The
result is a square :class:`SparseMatrix` sized by the largest vertex
index, duplicates summed. The native parser (io/native.py) reads when it
can, the Python parser otherwise.
"""

from __future__ import annotations

import numpy as np

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.sparse import SparseMatrix


def _parse_python(source):
    if hasattr(source, "read"):
        lines = source.read().splitlines()
    else:
        with open(source, "r") as f:
            lines = f.read().splitlines()
    srcs, dsts, ws = [], [], []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if len(toks) < 2:
            raise errors.IOError_(f"invalid arc-list line {line!r}")
        try:
            srcs.append(int(toks[0]))
            dsts.append(int(toks[1]))
            ws.append(float(toks[2]) if len(toks) > 2 else 1.0)
        except ValueError as e:
            raise errors.IOError_(f"invalid arc-list line {line!r}") from e
    return (np.asarray(srcs, dtype=np.int64), np.asarray(dsts, dtype=np.int64),
            np.asarray(ws, dtype=np.float64))


def read_arc_list(source, symmetrize: bool = False,
                  dtype=np.float32) -> SparseMatrix:
    """Parse an edge list (a path or a text stream) into a square sparse
    adjacency matrix; ``symmetrize=True`` also inserts each reverse edge
    (self-loops once), as the graph drivers do for undirected graphs."""
    from libskylark_tpu_torch.io import native

    parsed = native.parse_arc_list(source)
    native.count_run(parsed is not None)
    if parsed is None:
        parsed = _parse_python(source)
    src, dst, w = parsed
    if src.size and (src.min() < 0 or dst.min() < 0):
        raise errors.IOError_("negative vertex index in arc list")
    nv = int(max(src.max(), dst.max())) + 1 if src.size else 0
    if symmetrize:
        off = src != dst
        src, dst, w = (np.concatenate([src, dst[off]]),
                       np.concatenate([dst, src[off]]),
                       np.concatenate([w, w[off]]))
    return SparseMatrix.from_coo(src, dst, w.astype(dtype), (nv, nv))


def write_arc_list(path, A: SparseMatrix, digits: int = 8) -> None:
    """Write a sparse matrix as ``from to weight`` lines, weights with
    ``digits`` significant digits."""
    sp = A.to_scipy().tocoo()
    fmt = f"%.{digits}g"
    with open(path, "w") as f:
        for i, j, v in zip(sp.row, sp.col, sp.data):
            f.write(f"{int(i)} {int(j)} {fmt % v}\n")
