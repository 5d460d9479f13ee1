"""Randomized EVD of AᵀA: sketch-preconditioned LOBPCG and sketched power
iteration (the port of libskylark_tpu/nla/randlobpcg.py).

``lobpcg_rand_evd`` sketches A columnwise down to s rows on A's device
(CWT: the hash kernel; JLT: the dense kernel; FJLT: its DCT chain), then
runs scipy's LOBPCG on the host against the operator AᵀA with
(RᵀR)⁻¹ as the preconditioner, R from qr(SA), exactly as the reference
does: a small k-dimensional iteration over matvecs. The host copy of A
and the iteration are the reference's. ``power_iterations_rand_evd``
runs on A's device: a JLT range sketch (the dense kernel, rowwise), power
iterations, QR and an SVD.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.precision import with_solver_precision


def _tall(A, k: int) -> None:
    m, n = A.shape
    if not (m > n and n >= k):
        raise errors.InvalidParametersError(
            f"expects tall A with n >= k; got {tuple(A.shape)}, k={k}")


def lobpcg_rand_evd(A, k: int, context: Context, s: Optional[int] = None,
                    sketch: str = "cwt", device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenpairs of AᵀA for tall A: (lambdas, Vt), numpy, Vt's
    rows the right singular vectors of A, descending."""
    import scipy.linalg as sla
    from scipy.sparse.linalg import LinearOperator, lobpcg

    from libskylark_tpu_torch import sketch as sk

    A = as_tensor(A, device)
    _tall(A, k)
    m, n = A.shape
    s = 4 * n if s is None else int(s)
    if s >= m:
        raise errors.InvalidParametersError(f"sketch size {s} >= rows {m}")
    if s < n:
        raise errors.InvalidParametersError(
            f"sketch size {s} < cols {n}; need s >= n for the "
            "(R'R)^-1 preconditioner")
    sketches = {"cwt": sk.CWT, "jlt": sk.JLT, "fjlt": sk.FJLT}
    if sketch not in sketches:
        raise errors.InvalidParametersError(
            f"sketch must be one of {sorted(sketches)}, got {sketch!r}")
    T = sketches[sketch](m, s, context)
    B = T.apply(A, sk.COLUMNWISE, device=A.device).cpu().numpy()
    _, _, Vt = np.linalg.svd(B, full_matrices=False)
    _, R = np.linalg.qr(B)

    Ah = A.cpu().numpy()

    def amul(x):
        return Ah.T @ (Ah @ x)

    def precond(y):
        # (RᵀR)⁻¹ y by two triangular solves
        z = sla.solve_triangular(R.T, y, lower=True)
        return sla.solve_triangular(R, z, lower=False)

    Aop = LinearOperator((n, n), matvec=amul, matmat=amul)
    Mop = LinearOperator((n, n), matvec=precond, matmat=precond)
    X = Vt[:k, :].T.copy()
    lambdas, V = lobpcg(Aop, X, M=Mop, largest=True)
    order = np.argsort(-lambdas)
    return lambdas[order], V[:, order].T


@with_solver_precision
def power_iterations_rand_evd(A, k: int, context: Context,
                              power_iters: int = 2, device=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of AᵀA by sketched power iteration on A's device:
    (lambdas, Vt)."""
    from libskylark_tpu_torch import sketch as sk

    A = as_tensor(A, device)
    _tall(A, k)
    T = sk.JLT(A.shape[1], k, context)
    Y = T.apply(A, sk.ROWWISE, device=A.device)          # A·Sᵀ (m, k)
    for _ in range(power_iters):
        Y = A @ (A.T @ Y)
    Q = torch.linalg.qr(Y)[0]
    _, Sigma, Vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
    return Sigma**2, Vt
