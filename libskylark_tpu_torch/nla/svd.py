"""Randomized SVD: power_iteration, approximate_svd,
approximate_symmetric_svd (the port of libskylark_tpu/nla/svd.py,
Halko-Martinsson-Tropp).

Range sketch → power iteration with re-orthogonalization → Rayleigh-Ritz
→ truncation. The range sketch A·Sᵀ is ``JLT.apply(A, ROWWISE)``, so on a
CUDA tensor it runs the fused rowwise kernel (sketch/cuda_dense.py); the
other large products are plain matmuls. A wide matrix is factored as its
transpose.

A :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` operand is
never densified (the reference's sparse branch): its range sketch is the
JLT's sparse apply, and every product with A is ``spmm``/``spmm_t``.

A DTensor operand (parallel/mesh.py) is never gathered: each rank keeps
the rows of the panels that live on its rows of A (Q, U) and its columns
(Bᵀ, V). The range sketch is the JLT's DTensor apply (B1 on each rank's
rows of a row-sharded A), A·X and Aᵀ·Y are local products summed over the
ranks that split the contracted axis (``mesh._Blocks``), and CholeskyQR2
sums its k × k Grams the same way. ``ortho="qr"`` is the reference's
Householder QR, which XLA replicates: the panel is gathered explicitly
(an all_gather of the m × k' panel, not of A). U comes back sharded like
A's rows (Shard(0)), V like its columns (Replicate() for a row-sharded
A), σ Replicate(); a wide A is factored as its transpose, whose split
moves from Shard(0) to Shard(1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import (is_sparse_operand,
                                              linear_ops, place)
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.nla.tsqr import _cholesky_qr2
from libskylark_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass
class ApproximateSVDParams(Params):
    """Oversampling k' = ratio·k + additive; ``num_iterations`` power
    iterations; ``ortho`` "cqr2" (CholeskyQR2) or "qr" (Householder);
    ``rr`` "cqr2" (QR-reduce Bᵀ, SVD of the k'×k' factor) or "svd"
    (direct SVD of the k'×n panel)."""

    oversampling_ratio: float = 2.0
    oversampling_additive: int = 0
    num_iterations: int = 0
    skip_qr: bool = False
    ortho: str = "cqr2"
    rr: str = "cqr2"


def _orthonormalize(Q: torch.Tensor, method: str,
                    space: pmesh._Space) -> torch.Tensor:
    """An orthonormal basis of the panel whose local rows ``Q`` lie on
    ``space`` (a whole axis: Q is whole): CholeskyQR2 with its Grams
    summed over the ranks that split the axis, or the Householder QR of
    the panel, which the reference replicates: gathered, factored, and
    this rank's rows kept."""
    if method == "cqr2":
        return _cholesky_qr2(Q, space.sum)[0]
    if method != "qr":
        raise errors.InvalidParametersError(
            f"ortho must be 'qr' or 'cqr2', got {method!r}")
    return space.take(torch.linalg.qr(space.gather(Q))[0])


def _validate_params(params: ApproximateSVDParams) -> None:
    if params.ortho not in ("qr", "cqr2"):
        raise errors.InvalidParametersError(
            f"ortho must be 'qr' or 'cqr2', got {params.ortho!r}")
    if params.rr not in ("cqr2", "svd"):
        raise errors.InvalidParametersError(
            f"rr must be 'cqr2' or 'svd', got {params.rr!r}")


def _oversampled(params: ApproximateSVDParams, k: int, limit: int) -> int:
    kp = min(int(params.oversampling_ratio * k)
             + int(params.oversampling_additive), limit)
    return max(kp, k)


def _transposed(A):
    """Aᵀ: the operand's kept transpose for a sparse operand (made once,
    sharing A's device CSR forms), a DTensor's with its split moved to
    the other axis, a view otherwise."""
    if is_sparse_operand(A):
        return A.transpose()
    return pmesh._transpose(A) if pmesh._is_sharded(A) else A.T


def _operand(A, device, dtype=None):
    """(A, device) as :func:`~libskylark_tpu_torch.base.sparse.place`
    gives them, a dense A cast to ``dtype``; the override raises for a
    sparse operand, which computes at its device dtype."""
    if dtype is not None and is_sparse_operand(A):
        raise errors.InvalidParametersError(
            "dtype override is only supported for dense operands; "
            "sparse operands compute at their device dtype")
    A, device = place(A, device)
    if dtype is None:
        return A, device
    if pmesh._is_sharded(A):
        return pmesh._from_local(A.to_local().to(dtype), A.device_mesh,
                                 A.placements, A.shape), device
    return A.to(dtype), device


def _power(B: pmesh._Blocks, Q: torch.Tensor, num_iterations: int,
           orthogonalize: bool, adjoint: bool, ortho: str) -> torch.Tensor:
    """The iteration on local blocks: Q lives on A's rows (on its columns
    when ``adjoint``)."""
    space = B.cols if adjoint else B.rows
    for _ in range(num_iterations):
        Q = B.rmv(B.mv(Q)) if adjoint else B.mv(B.rmv(Q))
        if orthogonalize:
            Q = _orthonormalize(Q, ortho, space)
    return Q


@with_solver_precision
def power_iteration(A, Q: torch.Tensor, num_iterations: int,
                    orthogonalize: bool = True, adjoint: bool = False,
                    ortho: str = "qr") -> torch.Tensor:
    """(A·Aᵀ)^q · Q (or (Aᵀ·A)^q · Q when ``adjoint``), re-orthogonalized
    between products unless disabled. ``A`` is a dense tensor, a
    :class:`SparseMatrix` or a DTensor; for a DTensor, Q is a DTensor
    split like A's rows (its columns when ``adjoint``) or a tensor every
    rank holds whole, and so is the result."""
    B = pmesh._Blocks(A)
    if not B.sharded:
        return _power(B, Q, num_iterations, orthogonalize, adjoint, ortho)
    space = B.cols if adjoint else B.rows
    Q = (pmesh._local_block(Q, 0)[0] if pmesh._is_sharded(Q)
         else space.take(Q))
    return space.wrap(_power(B, Q, num_iterations, orthogonalize, adjoint,
                             ortho))


@with_solver_precision
def approximate_svd(A, rank: int, context: Context,
                    params: Optional[ApproximateSVDParams] = None,
                    dtype=None, device=None):
    """Rank-``rank`` approximate SVD: (U, S, V) with A ≈ U·diag(S)·Vᵀ.

    ``A`` is a numpy array or tensor, moved to ``device`` (default: the
    package default device); ``dtype`` casts it first. A
    :class:`SparseMatrix` stays sparse and the factors land on
    ``device``; ``dtype`` raises for it."""
    params = params or ApproximateSVDParams()
    _validate_params(params)
    A, device = _operand(A, device, dtype)
    m, n = A.shape
    k = int(rank)
    if k <= 0:
        raise errors.InvalidParametersError(f"rank must be positive, got {rank}")
    kp = _oversampled(params, k, min(m, n))

    if m < n:
        V, S, U = approximate_svd(_transposed(A), rank, context, params,
                                  dtype=dtype, device=device)
        return U, S, V

    from libskylark_tpu_torch.sketch import ROWWISE, JLT

    B = pmesh._Blocks(A)
    T = JLT(n, kp, context)
    Q = T.apply(A, ROWWISE, device=device)            # range sketch (m, kp)
    Q = Q.to_local() if B.sharded else Q
    if not params.skip_qr:
        Q = _orthonormalize(Q, params.ortho, B.rows)
    Q = _power(B, Q, params.num_iterations, not params.skip_qr, False,
               params.ortho)
    if params.skip_qr:
        # one final orthogonalization is always required before projection
        Q = _orthonormalize(Q, params.ortho, B.rows)

    Bt = B.rmv(Q)                                     # (n, kp); B = Btᵀ
    if params.rr == "svd":
        Ub, S, Vt = torch.linalg.svd(B.cols.gather(Bt).T,
                                     full_matrices=False)
        return (B.rows.wrap(Q @ Ub[:, :k]), B.whole(S[:k]),
                B.cols.wrap(B.cols.take(Vt[:k, :].T)))
    # Bᵀ = Qb·Rb ⇒ B = Rbᵀ·Qbᵀ; SVD only the k'×k' factor:
    # Rbᵀ = Ur·S·Vrᵀ ⇒ B = Ur·S·(Qb·Vr)ᵀ
    Qb, Rb = _cholesky_qr2(Bt, B.cols.sum)
    Ur, S, Vrt = torch.linalg.svd(Rb.T, full_matrices=False)
    return (B.rows.wrap(Q @ Ur[:, :k]), B.whole(S[:k]),
            B.cols.wrap(Qb @ Vrt.T[:, :k]))


@with_solver_precision
def approximate_symmetric_svd(A, rank: int, context: Context,
                              params: Optional[ApproximateSVDParams] = None,
                              device=None):
    """Approximate eigendecomposition of symmetric A: (V, S) with
    A ≈ V·diag(S)·Vᵀ, the k largest-magnitude eigenpairs, descending.
    ``A`` is dense or a :class:`SparseMatrix`."""
    params = params or ApproximateSVDParams()
    _validate_params(params)
    if pmesh._is_sharded(A):
        raise errors.NotImplementedYetError(
            "approximate_symmetric_svd of a DTensor (ROADMAP A5b)")
    A, device = _operand(A, device)
    n, n2 = A.shape
    if n != n2:
        raise errors.InvalidParametersError(
            "symmetric SVD expects a square matrix")
    k = int(rank)
    if k <= 0:
        raise errors.InvalidParametersError(f"rank must be positive, got {rank}")
    kp = _oversampled(params, k, n)

    from libskylark_tpu_torch.sketch import ROWWISE, JLT

    mv, _ = linear_ops(A)
    whole = pmesh._Space(n)
    T = JLT(n, kp, context)
    Q = _orthonormalize(T.apply(A, ROWWISE, device=device), params.ortho,
                        whole)
    for _ in range(params.num_iterations):
        Q = mv(Q)
        if not params.skip_qr:
            Q = _orthonormalize(Q, params.ortho, whole)
    if params.skip_qr:
        Q = _orthonormalize(Q, params.ortho, whole)

    # Rayleigh-Ritz: eigendecomposition of QᵀAQ
    G = Q.T @ mv(Q)
    G = 0.5 * (G + G.T)
    w, Z = torch.linalg.eigh(G)
    order = torch.argsort(-torch.abs(w))[:k]
    return Q @ Z[:, order], w[order]
