"""Sparse (CSR-lane) serve programs (the port of
libskylark_tpu/sketch/sparse_serve.py).

The serve layer takes a sparse operand as **CSR lanes**: ``data`` and
``indices`` zero-padded to the bucket's nnz class (value 0.0 at index 0),
``indptr`` padded with the true nnz up to the padded row extent. The
functions here are the per-lane plain programs of those flushes:

- CWT (:func:`cwt_sparse_serve_apply`): an O(nnz) scatter in CSR
  row-major order, the order in which the dense reference retires the same
  terms, so it is bit-equal to ``CWT.apply`` of the densified operand;
  the padding adds exact zeros. On the CPU ``index_add_`` adds in index
  order; on a CUDA tensor it is atomic and unordered, which is why the
  serve layer runs kernel B3 (sketch/cuda_sparse.py) there.
- JLT/CT (:func:`dense_sparse_serve_apply`): the lanes scattered to the
  padded dense shape (:func:`scatter_dense`, exact: canonical CSR has no
  duplicate coordinates), then ``dense.serve_apply``;
- sketch-and-solve with a CSR design matrix (:func:`sparse_solve_serve`):
  SA from the sparse columnwise sketch above, SB from the dense serve
  sketch of the target block, then ``solve_l2_exact``. Its CWT branch
  runs float32 through the kernels' routes (B3 for SA, B2 for SB).
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.sketch import cuda_hash


def csr_row_ids(indptr: torch.Tensor, nnz_pad: int,
                dtype=torch.int64) -> torch.Tensor:
    """The row of each of the first ``nnz_pad`` lane positions, from a
    (rows+1,) ``indptr`` or a (B, rows+1) stack of them, as ``dtype``
    (int32 is what the sparse kernel reads). Positions past the true nnz
    clamp to the last row; their data is 0.0."""
    j = torch.arange(int(nnz_pad), dtype=indptr.dtype, device=indptr.device)
    ends = indptr[..., 1:].contiguous()
    if indptr.ndim == 2:
        j = j.expand(indptr.shape[0], -1).contiguous()
    rows = torch.searchsorted(ends, j, right=True)
    return torch.clamp_max(rows, indptr.shape[-1] - 2).to(dtype)


def cwt_scatter_rows(key_data, data: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, *, s_dim: int, rowwise: bool,
                     shape: tuple) -> torch.Tensor:
    """One lane's CountSketch from expanded (data, row, col) entries in
    CSR row-major order: (rows, s_dim) rowwise, (s_dim, cols) columnwise,
    for the padded ``shape`` = (rows, cols). The plain version of kernel
    B3's lane."""
    n_rows, n_cols = int(shape[0]), int(shape[1])
    n = n_cols if rowwise else n_rows
    h, v = cuda_hash.streams(key_data, n, s_dim, data.device)
    v = v.to(data.dtype)
    rows, cols = rows.long(), cols.long()
    if rowwise:
        flat = torch.zeros(n_rows * s_dim, dtype=data.dtype,
                           device=data.device)
        flat.index_add_(0, rows * s_dim + h[cols], v[cols] * data)
        return flat.view(n_rows, s_dim)
    flat = torch.zeros(s_dim * n_cols, dtype=data.dtype, device=data.device)
    flat.index_add_(0, h[rows] * n_cols + cols, v[rows] * data)
    return flat.view(s_dim, n_cols)


def cwt_sparse_serve_apply(key_data, data: torch.Tensor,
                           indices: torch.Tensor, indptr: torch.Tensor, *,
                           s_dim: int, rowwise: bool,
                           shape: tuple) -> torch.Tensor:
    """One request's CountSketch of its CSR lanes: (s_dim, cols)
    columnwise, (rows, s_dim) rowwise, ``shape`` the padded (rows, cols)
    class shape; the caller slices the kept extent."""
    rows = csr_row_ids(indptr, data.shape[0])
    return cwt_scatter_rows(key_data, data, rows, indices, s_dim=s_dim,
                            rowwise=rowwise, shape=shape)


def cwt_sparse_lane(key_data, data: torch.Tensor, indices: torch.Tensor,
                    indptr: torch.Tensor, *, s_dim: int, rowwise: bool,
                    shape: tuple) -> torch.Tensor:
    """One CSR lane's CountSketch by the route of its dtype: float32
    through kernel B3's wrapper (sketch/cuda_sparse.py, which runs its
    plain version on a CPU tensor), other dtypes through the plain
    CSR-order scatter. The one dispatch of ``CWT``'s sparse apply and of
    :func:`sparse_solve_serve`."""
    from libskylark_tpu_torch.sketch import cuda_sparse

    rows = csr_row_ids(indptr, data.shape[0], torch.int32)
    if cuda_sparse.supported(data.dtype):
        return cuda_sparse.cwt_sparse_apply(
            key_data, data, rows, indices.to(torch.int32), s_dim, rowwise,
            shape)
    return cwt_scatter_rows(key_data, data, rows, indices, s_dim=s_dim,
                            rowwise=rowwise, shape=shape)


def scatter_dense(data: torch.Tensor, indices: torch.Tensor,
                  indptr: torch.Tensor, *, shape: tuple) -> torch.Tensor:
    """CSR lanes densified to ``shape``, or a (B, nnz) stack of lanes to
    (B, *shape). Exact: canonical CSR has no duplicate coordinates, and
    the padding adds 0.0 at a clamped coordinate."""
    rows = csr_row_ids(indptr, data.shape[-1])
    n_rows, n_cols = int(shape[0]), int(shape[1])
    lin = rows * n_cols + indices.long()
    if data.ndim == 2:
        lin = lin + (torch.arange(data.shape[0], device=data.device)
                     * (n_rows * n_cols))[:, None]
    flat = torch.zeros(data.numel() // data.shape[-1] * n_rows * n_cols,
                       dtype=data.dtype, device=data.device)
    flat.index_put_((lin.reshape(-1),), data.reshape(-1), accumulate=True)
    return flat.view(*data.shape[:-1], n_rows, n_cols)


def dense_sparse_serve_apply(key_data, scale, data: torch.Tensor,
                             indices: torch.Tensor, indptr: torch.Tensor, *,
                             dist, s_dim: int, rowwise: bool,
                             shape: tuple) -> torch.Tensor:
    """One request's JLT/CT sketch of its CSR lanes: densify in place of
    the flush, then the dense serve program."""
    from libskylark_tpu_torch.sketch.dense import serve_apply

    A = scatter_dense(data, indices, indptr, shape=shape)
    return serve_apply(key_data, scale, A, dist=dist, s_dim=s_dim,
                       rowwise=rowwise)


def sparse_solve_serve(key_data, scale, data: torch.Tensor,
                       indices: torch.Tensor, indptr: torch.Tensor,
                       B: torch.Tensor, *, sketch_type: str, s_dim: int,
                       method: str, shape: tuple) -> torch.Tensor:
    """One request's sketch-and-solve with a CSR design matrix of padded
    ``shape`` (rows, cols) and a dense target block B (rows, k): the
    compressed problem min ‖SA·X − SB‖ solved by ``solve_l2_exact``.
    Zero-padded rows add nothing through either sketch; the feature
    extent is exact (a zero column would make the small problem
    singular)."""
    from libskylark_tpu_torch.algorithms.regression import solve_l2_exact
    from libskylark_tpu_torch.base import errors, randgen
    from libskylark_tpu_torch.sketch import dense
    from libskylark_tpu_torch.sketch import hash as sketch_hash

    if sketch_type == "CWT":
        SA = cwt_sparse_lane(key_data, data, indices, indptr, s_dim=s_dim,
                             rowwise=False, shape=shape)
        SB = sketch_hash.cwt_serve_apply(key_data, B, s_dim=s_dim,
                                         rowwise=False)
    elif sketch_type == "JLT":
        SA = dense_sparse_serve_apply(
            key_data, scale, data, indices, indptr, dist=randgen.Normal(),
            s_dim=s_dim, rowwise=False, shape=shape)
        SB = dense.serve_apply(key_data, scale, B, dist=randgen.Normal(),
                               s_dim=s_dim, rowwise=False)
    else:
        raise errors.InvalidParametersError(
            f"sparse solve serve path supports JLT/CWT sketches, got "
            f"{sketch_type!r}")
    return solve_l2_exact(SA, SB, method=method, device=SA.device)
