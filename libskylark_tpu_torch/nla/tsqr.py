"""Tall-skinny QR: CholeskyQR / CholeskyQR2 (the port of
libskylark_tpu/nla/tsqr.py).

For an (m × k) panel with m ≫ k: G = AᵀA, R = chol(G), Q = A·R⁻¹, twice —
the second pass repairs the squared-condition loss of the first
(Yamamoto et al. 2015). Every O(m·k²) flop is a matmul.

The Cholesky factor is not checked on the host (``cholesky_ex``, as
the reference's ``jnp.linalg.cholesky`` does not raise): a Gram that is
not positive definite even after the diagonal lift gives an unusable
factor (the reference's is NaN), never an error.

A DTensor panel whose rows are split over a mesh (parallel/mesh.py) is
never gathered: each rank forms its G_loc = A_locᵀ·A_loc, one all_reduce
of the k × k Gram sums them, the Cholesky runs on every rank, and Q =
A_loc·R⁻¹ stays on the rank's rows (Shard(0)); R is Replicate().
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.parallel import mesh as pmesh


def _cholesky_qr(A: torch.Tensor, total=None):
    """One pass on the rank's rows ``A``; ``total`` sums a Gram over the
    ranks that split them (None: A is whole)."""
    G = A.T @ A
    if total is not None:
        G = total(G)
    # tiny diagonal lift keeps chol defined when A is numerically
    # rank-deficient (the QR2 pass repairs the perturbation)
    eps = torch.finfo(A.dtype).eps
    eye = torch.eye(G.shape[0], dtype=A.dtype, device=A.device)
    G = G + (eps * torch.trace(G)) * eye
    # unchecked, as the reference's jnp.linalg.cholesky (no host read:
    # the pass runs inside captured bodies, ROADMAP C20)
    R = torch.linalg.cholesky_ex(G, upper=True).L
    # Q = A·R⁻¹ through an explicit k×k triangular inverse and one matmul
    # (the reference's choice: a gemm over the tall operand, not a
    # triangular solve over it)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return A @ Rinv, R


def _cholesky_qr2(A: torch.Tensor, total=None):
    Q1, R1 = _cholesky_qr(A, total)
    Q, R2 = _cholesky_qr(Q1, total)
    return Q, R2 @ R1


def _sharded(fn, A):
    """``fn`` on a DTensor panel's rows: (Q Shard(0), R Replicate())."""
    B = pmesh._Blocks(A)
    if B.cols.split:
        raise errors.NotImplementedYetError(
            "CholeskyQR of a DTensor with split columns (ROADMAP A5b)")
    Q, R = fn(B.local, B.rows.sum)
    return B.rows.wrap(Q), B.whole(R)


@with_solver_precision
def cholesky_qr(A: torch.Tensor):
    """One CholeskyQR pass: (Q, R) with A = Q·R, Q orthonormal to
    O(ε·cond²(A))."""
    if pmesh._is_sharded(A):
        return _sharded(_cholesky_qr, A)
    return _cholesky_qr(A)


@with_solver_precision
def cholesky_qr2(A: torch.Tensor):
    """CholeskyQR2: Q orthonormal to O(ε) for cond(A) ≲ 1/√ε;
    R = R₂·R₁."""
    if pmesh._is_sharded(A):
        return _sharded(_cholesky_qr2, A)
    return _cholesky_qr2(A)
