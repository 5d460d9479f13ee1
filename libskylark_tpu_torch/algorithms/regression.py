"""Regression: exact and sketch-and-solve L2 solvers (the port of the
``solve_l2_exact`` and ``solve_l2_sketched`` parts of
libskylark_tpu/algorithms/regression.py)."""

from __future__ import annotations

import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.precision import with_solver_precision

_solve = torch.linalg.solve_triangular


@with_solver_precision
def solve_l2_exact(A, B, method: str = "qr", device=None) -> torch.Tensor:
    """Exact least squares min ‖A·X − B‖ by the algorithm tag: "qr",
    "sne" (semi-normal equations), "ne" (normal equations) or "svd"."""
    A = as_tensor(A, device)
    B = as_tensor(B, A.device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if method == "qr":
        Q, R = torch.linalg.qr(A)
        X = _solve(R, Q.T @ B, upper=True)
    elif method == "sne":
        # R from QR(A), then RᵀR X = AᵀB
        _, R = torch.linalg.qr(A)
        Y = _solve(R.T, A.T @ B, upper=False)
        X = _solve(R, Y, upper=True)
    elif method == "ne":
        L = torch.linalg.cholesky(A.T @ A)
        Y = _solve(L, A.T @ B, upper=False)
        X = _solve(L.T, Y, upper=True)
    elif method == "svd":
        U, s, Vt = torch.linalg.svd(A, full_matrices=False)
        cut = s[0] * torch.finfo(A.dtype).eps * max(A.shape)
        s_inv = torch.where(s > cut, 1.0 / s, torch.zeros_like(s))
        X = Vt.T @ (s_inv[:, None] * (U.T @ B))
    else:
        raise errors.InvalidParametersError(
            f"unknown exact l2 method {method!r}")
    return X[:, 0] if squeeze else X


@with_solver_precision
def solve_l2_sketched(A, B, transform, method: str = "qr",
                      device=None) -> torch.Tensor:
    """Sketch-and-solve: compress the rows of [A | B] with a columnwise
    sketch, then solve the small problem exactly. On a CUDA tensor a
    dense sketch runs the fused columnwise kernel.

    A and B are sketched in one apply, so a virtual operator is generated
    once for both rather than once more for B's few columns; the copy
    into [A | B] costs one pass over A."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    A = as_tensor(A, device)
    B = as_tensor(B, A.device).to(A.dtype)
    squeeze = B.ndim == 1
    AB = torch.cat([A, B[:, None] if squeeze else B], dim=1)
    SAB = transform.apply(AB, COLUMNWISE, device=A.device)
    n = A.shape[1]
    X = solve_l2_exact(SAB[:, :n], SAB[:, n:], method=method,
                       device=A.device)
    return X[:, 0] if squeeze else X
