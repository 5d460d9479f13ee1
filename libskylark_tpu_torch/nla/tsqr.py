"""Tall-skinny QR: CholeskyQR / CholeskyQR2 (the port of
libskylark_tpu/nla/tsqr.py).

For an (m × k) panel with m ≫ k: G = AᵀA, R = chol(G), Q = A·R⁻¹, twice —
the second pass repairs the squared-condition loss of the first
(Yamamoto et al. 2015). Every O(m·k²) flop is a matmul.
"""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base.precision import with_solver_precision


@with_solver_precision
def cholesky_qr(A: torch.Tensor):
    """One CholeskyQR pass: (Q, R) with A = Q·R, Q orthonormal to
    O(ε·cond²(A))."""
    G = A.T @ A
    # tiny diagonal lift keeps chol defined when A is numerically
    # rank-deficient (the QR2 pass repairs the perturbation)
    eps = torch.finfo(A.dtype).eps
    eye = torch.eye(G.shape[0], dtype=A.dtype, device=A.device)
    G = G + (eps * torch.trace(G)) * eye
    R = torch.linalg.cholesky(G, upper=True)
    # Q = A·R⁻¹ through an explicit k×k triangular inverse and one matmul
    # (the reference's choice: a gemm over the tall operand, not a
    # triangular solve over it)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return A @ Rinv, R


@with_solver_precision
def cholesky_qr2(A: torch.Tensor):
    """CholeskyQR2: Q orthonormal to O(ε) for cond(A) ≲ 1/√ε;
    R = R₂·R₁."""
    Q1, R1 = cholesky_qr(A)
    Q, R2 = cholesky_qr(Q1)
    return Q, R2 @ R1
