"""Sparse random matrices and hash maps (the port of
libskylark_tpu/base/sprand.py).

``sample`` is a sparse i.i.d. matrix of exact nnz, ``hashmap`` the
sparse matrix of a random hash h: [n] → [t] (the explicit form of the
CountSketch family). Both draw from counter streams of the context, so a
matrix is a function of (seed, counter): the positions, buckets and
signs are integer or sign streams, made on ``device`` (the package
default device unless given) and gathered to the host, where the matrix
is assembled as in the reference. The CSR is bit-equal to the
reference's on the same context.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.base.sparse import SparseMatrix


def _host(key, dist, lo: int, hi: int, dtype, device) -> np.ndarray:
    """Elements [lo, hi) of a counter stream, made on ``device``, as a
    numpy array."""
    return randgen.stream_slice(key, dist, lo, hi, dtype,
                                device).cpu().numpy()


def sample(m: int, n: int, density: float, nz_values: Sequence[float],
           nz_prob_dist: Sequence[float], context: Context,
           device=None) -> SparseMatrix:
    """(m, n) sparse matrix of round(density·m·n) nonzeros at distinct
    positions, each drawn i.i.d. from ``nz_values`` with probabilities
    ``nz_prob_dist``. The positions are the first distinct draws of a
    uniform-int stream over the m·n cells, consumed in growing slices;
    the values come from a uniform stream of the next allocation."""
    if not 0.0 <= density <= 1.0:
        raise errors.InvalidParametersError(f"bad density {density}")
    device = resolve_device(device)
    nnz = int(round(density * m * n))
    key = context.allocate().key
    chosen = np.zeros(0, dtype=np.int64)
    lo = 0
    draw = max(2 * nnz, 16)
    cells = randgen.UniformInt(0, m * n - 1)
    while len(chosen) < nnz and lo < 64 * max(nnz, 1):
        batch = _host(key, cells, lo, lo + draw, torch.int64, device)
        lo += draw
        # first occurrences in draw order (no positional bias from
        # np.unique's sorting)
        u, first = np.unique(batch, return_index=True)
        u = u[np.argsort(first)]
        u = u[~np.isin(u, chosen, assume_unique=True)]
        chosen = np.concatenate([chosen, u])
    if len(chosen) < nnz:
        raise errors.SkylarkError(
            f"drew {lo} candidates but found only {len(chosen)} distinct "
            f"positions (< nnz={nnz}); density {density} too high for "
            f"rejection sampling")
    flat = chosen[:nnz]
    rows, cols = flat // n, flat % n
    u = _host(context.allocate().key, randgen.Uniform(), 0,
              max(len(flat), 1), torch.float32, device
              ).astype(np.float64)[:len(flat)]
    cdf = np.cumsum(np.asarray(nz_prob_dist, dtype=np.float64))
    cdf = cdf / cdf[-1]
    vals = np.asarray(nz_values, dtype=np.float64)[
        np.searchsorted(cdf, u, side="right").clip(0, len(nz_values) - 1)]
    return SparseMatrix.from_coo(rows, cols, vals.astype(np.float32), (m, n))


def hashmap(t: int, n: int, context: Context, values: str = "rademacher",
            dimension: int = 0, device=None) -> SparseMatrix:
    """Sparse matrix of a random hash h: [n] → [t]: S[h(i), i] = v(i)
    (``dimension=0``, t×n) or S[i, h(i)] = v(i) (``dimension=1``, n×t).
    ``values`` is "rademacher" (±1, CountSketch) or "ones"."""
    device = resolve_device(device)
    h = _host(context.allocate().key, randgen.UniformInt(0, t - 1), 0, n,
              torch.int64, device)
    if values == "rademacher":
        v = _host(context.allocate().key, randgen.Rademacher(), 0, n,
                  torch.float32, device)
    elif values == "ones":
        v = np.ones(n, dtype=np.float32)
    else:
        raise errors.InvalidParametersError(
            f"values must be 'rademacher' or 'ones', got {values!r}")
    i = np.arange(n, dtype=np.int64)
    if dimension == 0:
        return SparseMatrix.from_coo(h, i, v, (t, n))
    return SparseMatrix.from_coo(i, h, v, (n, t))
