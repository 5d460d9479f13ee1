"""Randomized SVD: power_iteration, approximate_svd,
approximate_symmetric_svd (the port of libskylark_tpu/nla/svd.py,
Halko-Martinsson-Tropp).

Range sketch → power iteration with re-orthogonalization → Rayleigh-Ritz
→ truncation. The range sketch A·Sᵀ is ``JLT.apply(A, ROWWISE)``, so on a
CUDA tensor it runs the fused rowwise kernel (sketch/cuda_dense.py); the
other large products are plain matmuls. A wide matrix is factored as its
transpose.

A dense tensor operand runs through the engine's executable cache
(engine/compiled.py): ``_svd_pipeline`` (the range sketch, the power
iteration, Bᵀ = Aᵀ·Q and its CholeskyQR2) and
``_symmetric_svd_pipeline`` (through the Rayleigh-Ritz matrix QᵀAQ) are
captured once per (shape, dtype, statics) as CUDA graphs on the card,
the JLT's key a graph input, so every seed replays the same graph. The
k'×k' SVD or eigendecomposition and the rotations that follow run
eagerly after it: torch's ``linalg.svd`` and ``linalg.eigh`` read their
convergence info on the host, which a capture refuses (ROADMAP C20).

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
moves from Shard(0) to Shard(1). ``approximate_symmetric_svd`` of a
DTensor is built the same way (:func:`_symmetric_svd_pipeline`): the range
sketch by the JLT's DTensor route (B1-rw on each rank's rows of a
row-sharded A), each product A·Q as ``_Blocks.mv_whole`` of the gathered
(n × k') basis, CholeskyQR2 with its Grams summed, and the small k' × k'
eigendecomposition on every rank, so every rank holds the same bytes;
V comes back split like A's rows, the eigenvalues Replicate().
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from libskylark_tpu_torch import engine
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import is_sparse_operand, place
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


def _svd_pipeline(A, T, *, k: int, kp: int, num_iterations: int,
                  skip_qr: bool, ortho: str, rr: str, device=None):
    """The part of the tall randomized SVD that the executable cache
    captures for a dense operand: the range sketch A·Tᵀ (B1-rw on the
    card, T's key a graph input), the power iteration, Bᵀ = Aᵀ·Q and, for
    ``rr="cqr2"``, Bᵀ's CholeskyQR2. Returns (Q, Bᵀ) for "svd" (Bᵀ
    whole), (Q, Qb, Rb) for "cqr2", each on local blocks;
    :func:`_svd_finish` takes the rest. A sparse operand or a DTensor
    runs it directly, with the range sketch on ``device`` (default: A's)."""
    from libskylark_tpu_torch.sketch import ROWWISE

    B = pmesh._Blocks(A)
    Q = T.apply(A, ROWWISE, device=A.device if device is None else device)
    Q = Q.to_local() if B.sharded else Q              # range sketch (m, kp)
    if not skip_qr:
        Q = _orthonormalize(Q, ortho, B.rows)
    Q = _power(B, Q, num_iterations, not skip_qr, False, ortho)
    if skip_qr:
        # one final orthogonalization is always required before projection
        Q = _orthonormalize(Q, ortho, B.rows)
    Bt = B.rmv(Q)                                     # (n, kp); B = Btᵀ
    if rr == "svd":
        return Q, B.cols.gather(Bt)
    return (Q, *_cholesky_qr2(Bt, B.cols.sum))


def _svd_finish(parts, k: int, rr: str, B: pmesh._Blocks):
    """(U, S, V) from :func:`_svd_pipeline`'s parts: the small SVD and
    the rotations, eagerly, each factor laid out as ``B``'s spaces."""
    if rr == "svd":
        Q, Bt = parts
        Ub, S, Vt = torch.linalg.svd(Bt.T, full_matrices=False)
        return (B.rows.wrap(Q @ Ub[:, :k]), B.whole(S[:k]),
                B.cols.wrap(B.cols.take(Vt[:k, :].T)))
    # Bᵀ = Qb·Rb ⇒ B = Rbᵀ·Qbᵀ; SVD only the k'×k' factor:
    # Rbᵀ = Ur·S·Vrᵀ ⇒ B = Ur·S·(Qb·Vr)ᵀ
    Q, Qb, Rb = parts
    Ur, S, Vrt = torch.linalg.svd(Rb.T, full_matrices=False)
    return (B.rows.wrap(Q @ Ur[:, :k]), B.whole(S[:k]),
            B.cols.wrap(Qb @ Vrt.T[:, :k]))


def _symmetric_svd_pipeline(A, T, *, k: int, kp: int, num_iterations: int,
                            skip_qr: bool, ortho: str, device=None):
    """The captured part of the symmetric variant for a dense operand:
    the range sketch (B1-rw), the power iteration and the Rayleigh-Ritz
    matrix G = sym(QᵀAQ). Returns (Q, G) on local blocks;
    :func:`_symmetric_svd_finish` takes the rest. A sparse operand or a
    DTensor runs it directly, with the range sketch on ``device``
    (default: A's). For a DTensor, Q lives on A's rows and A·Q needs it
    on A's columns: the (n × k') basis is gathered (not A) and each
    rank's block multiplies its columns' rows of it, summed over the
    ranks that split the columns."""
    from libskylark_tpu_torch.sketch import ROWWISE

    B = pmesh._Blocks(A)

    def aq(Q):
        return B.mv_whole(B.rows.gather(Q))

    Q = T.apply(A, ROWWISE, device=A.device if device is None else device)
    Q = Q.to_local() if B.sharded else Q              # range sketch (n, kp)
    Q = _orthonormalize(Q, ortho, B.rows)
    for _ in range(num_iterations):
        Q = aq(Q)
        if not skip_qr:
            Q = _orthonormalize(Q, ortho, B.rows)
    if skip_qr:
        Q = _orthonormalize(Q, ortho, B.rows)
    G = B.rows.sum(Q.T @ aq(Q))
    return Q, 0.5 * (G + G.T)


def _symmetric_svd_finish(parts, k: int):
    """(V, S): the eigendecomposition of G, the k largest-magnitude pairs
    descending, rotated back, eagerly."""
    Q, G = parts
    w, Z = torch.linalg.eigh(G)
    order = torch.argsort(-torch.abs(w))[:k]
    return Q @ Z[:, order], w[order]


# donate="auto": the operand is consumed only when the user opted in
# (SKYLARK_ENGINE_DONATE=1)
_STATIC_SVD = ("k", "kp", "num_iterations", "skip_qr", "ortho", "rr")
_svd_compiled = engine.compiled(
    _svd_pipeline, static_argnames=_STATIC_SVD, donate_argnums=(0,),
    donate="auto", name="approximate_svd")
_symmetric_svd_compiled = engine.compiled(
    _symmetric_svd_pipeline, static_argnames=_STATIC_SVD[:-1],
    donate_argnums=(0,), donate="auto", name="approximate_symmetric_svd")


def _served(A) -> bool:
    """A dense, unsharded operand: the executable cache's route."""
    return not is_sparse_operand(A) and not pmesh._is_sharded(A)


@with_solver_precision
def approximate_svd(A, rank: int, context: Context,
                    params: Optional[ApproximateSVDParams] = None,
                    dtype=None, device=None):
    """Rank-``rank`` approximate SVD: (U, S, V) with A ≈ U·diag(S)·Vᵀ.

    ``A`` is a numpy array or tensor, moved to ``device`` (default: the
    package default device); ``dtype`` casts it first. A dense tensor
    runs ``_svd_pipeline`` from the executable cache, then the small SVD.
    A :class:`SparseMatrix` stays sparse and the factors land on
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

    from libskylark_tpu_torch.sketch import JLT

    T = JLT(n, kp, context)
    statics = dict(k=k, kp=kp, num_iterations=int(params.num_iterations),
                   skip_qr=bool(params.skip_qr), ortho=params.ortho,
                   rr=params.rr)
    parts = (_svd_compiled(A, T, **statics) if _served(A)
             else _svd_pipeline(A, T, device=device, **statics))
    return _svd_finish(parts, k, params.rr, pmesh._Blocks(A))


@with_solver_precision
def approximate_symmetric_svd(A, rank: int, context: Context,
                              params: Optional[ApproximateSVDParams] = None,
                              device=None):
    """Approximate eigendecomposition of symmetric A: (V, S) with
    A ≈ V·diag(S)·Vᵀ, the k largest-magnitude eigenpairs, descending.
    ``A`` is dense or a :class:`SparseMatrix`."""
    params = params or ApproximateSVDParams()
    _validate_params(params)
    A, device = _operand(A, device)
    n, n2 = A.shape
    if n != n2:
        raise errors.InvalidParametersError(
            "symmetric SVD expects a square matrix")
    k = int(rank)
    if k <= 0:
        raise errors.InvalidParametersError(f"rank must be positive, got {rank}")
    kp = _oversampled(params, k, n)

    from libskylark_tpu_torch.sketch import JLT

    T = JLT(n, kp, context)
    statics = dict(k=k, kp=kp, num_iterations=int(params.num_iterations),
                   skip_qr=bool(params.skip_qr), ortho=params.ortho)
    parts = (_symmetric_svd_compiled(A, T, **statics) if _served(A)
             else _symmetric_svd_pipeline(A, T, device=device, **statics))
    V, S = _symmetric_svd_finish(parts, k)
    if pmesh._is_sharded(A):
        B = pmesh._Blocks(A)
        return B.rows.wrap(V), B.whole(S)
    return V, S
