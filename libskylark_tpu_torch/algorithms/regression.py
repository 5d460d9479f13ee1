"""Regression: exact, sketch-and-solve and sketch-accelerated L2 solvers
(the port of libskylark_tpu/algorithms/regression.py; the serve program
``sketched_solve_serve`` is not ported yet).

The reference compiles the accelerated solvers as two engine executables
(preconditioner build, LSQR) with one host read between them, the
condition estimate that decides the fallback; here they are plain calls
with the same single read, and LSQR's own per-iteration stopping test.

A :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` design matrix
takes the reference's direct path: the sketch's sparse apply to A and
its dense apply to B, LSQR on ``spmm``/``spmm_t``, an FJLT sketch turned
into a CWT (the FJLT has no sparse apply), and a densified A only in the
exact fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from libskylark_tpu_torch.algorithms import krylov
from libskylark_tpu_torch.algorithms.precond import (MatPrecond, Precond,
                                                     TriInversePrecond)
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.sparse import is_sparse_operand, place
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision

_solve = torch.linalg.solve_triangular


@dataclasses.dataclass
class RegressionProblem:
    """min ‖A·x − b‖ with the reference's problem algebra: ``kind``
    linear, polynomial or kernel; ``penalty`` l2, l1 or lp; an optional
    ``regularization``. A plain record: the solvers take A and b."""

    A: object
    kind: str = "linear"
    penalty: str = "l2"
    regularization: Optional[str] = None


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
    into [A | B] costs one pass over A. A sparse A is sketched by the
    transform's sparse apply and B by its dense apply, on ``device``."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    if is_sparse_operand(A):
        A, d = place(A, device)
        B = as_tensor(B, d).to(A.tensor_dtype)
        X = solve_l2_exact(transform.apply(A, COLUMNWISE, device=d),
                           transform.apply(B, COLUMNWISE, device=d),
                           method=method, device=d)
        return X[:, 0] if B.ndim == 1 else X
    A = as_tensor(A, device)
    B = as_tensor(B, A.device).to(A.dtype)
    squeeze = B.ndim == 1
    AB = torch.cat([A, B[:, None] if squeeze else B], dim=1)
    SAB = transform.apply(AB, COLUMNWISE, device=A.device)
    n = A.shape[1]
    X = solve_l2_exact(SAB[:, :n], SAB[:, n:], method=method,
                       device=A.device)
    return X[:, 0] if squeeze else X


# -- accelerated solvers (Blendenpik, LSRN) --


@dataclasses.dataclass
class AcceleratedParams(Params):
    """Knobs of the Blendenpik/LSRN family."""

    sketch_size_factor: float = 4.0  # s = factor × n
    tolerance: float = 1e-10
    iter_lim: int = -1
    cond_threshold: float = 1e7  # exact SVD solve above this condition
    sketch: str = "fjlt"  # fjlt | jlt | cwt


def _accel_transform(m: int, n: int, context: Context,
                     params: AcceleratedParams, *, gaussian: bool = False):
    """The row-compressing sketch of the accelerated family (allocated
    here, so it advances the context's counter)."""
    from libskylark_tpu_torch import sketch as sk

    s = int(params.sketch_size_factor * n)
    s = min(max(s, n + 1), m)
    if gaussian or params.sketch == "jlt":
        return sk.JLT(m, s, context)
    if params.sketch == "fjlt":
        return sk.FJLT(m, s, context)
    if params.sketch == "cwt":
        return sk.CWT(m, max(s, 4 * n), context)
    raise errors.InvalidParametersError(f"unknown sketch {params.sketch!r}")


def _blendenpik_r(A, T, device) -> torch.Tensor:
    """R factor of the sketched operand: the right preconditioner."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    return torch.linalg.qr(T.apply(A, COLUMNWISE, device=device),
                           mode="r").R


def _lsrn_parts(A, T, device) -> tuple[torch.Tensor, torch.Tensor]:
    """LSRN preconditioner N = V·Σ⁻¹ from the SVD of the sketch, and the
    singular values."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    SA = T.apply(A, COLUMNWISE, device=device)
    _, sv, Vt = torch.linalg.svd(SA, full_matrices=False)
    floor = sv[0] * torch.finfo(SA.dtype).eps
    return Vt.T * (1.0 / torch.maximum(sv, floor))[None, :], sv


@with_solver_precision
def build_blendenpik_precond(A, context: Context, params: AcceleratedParams,
                             device=None) -> tuple[Precond, torch.Tensor]:
    """Sketch A and QR the sketch; R is the right preconditioner."""
    A, device = place(A, device)
    R = _blendenpik_r(A, _accel_transform(*A.shape, context, params),
                      device)
    return TriInversePrecond(R), R


@with_solver_precision
def build_lsrn_precond(A, context: Context, params: AcceleratedParams,
                       device=None) -> tuple[Precond, torch.Tensor]:
    """LSRN: Gaussian sketch, SVD of the sketch, preconditioner V·Σ⁻¹."""
    A, device = place(A, device)
    T = _accel_transform(*A.shape, context, params, gaussian=True)
    Ninv, sv = _lsrn_parts(A, T, device)
    return MatPrecond(Ninv), sv


@with_solver_precision
def solve_l2_accelerated(A, B, context: Context, method: str = "blendenpik",
                         params: Optional[AcceleratedParams] = None,
                         device=None):
    """Sketch-preconditioned LSQR (Blendenpik, its simplified CWT variant,
    or LSRN), with the exact SVD solve when the preconditioner's condition
    is not finite or exceeds ``params.cond_threshold``.

    Returns (X, iterations); iterations == 0 signals the exact fallback.
    Reading the condition is the one host synchronisation before LSQR.
    A sparse A turns an FJLT sketch into a CWT and is densified only for
    the exact fallback."""
    params = params or AcceleratedParams()
    A, device = place(A, device)
    B = as_tensor(B, device)
    if is_sparse_operand(A) and params.sketch == "fjlt":
        params = dataclasses.replace(params, sketch="cwt")
    if method == "simplified_blendenpik":
        params = dataclasses.replace(params, sketch="cwt")
    if method in ("blendenpik", "simplified_blendenpik"):
        precond, R = build_blendenpik_precond(A, context, params,
                                              device=device)
        cond = float(torch.linalg.cond(R))
    elif method == "lsrn":
        precond, sv = build_lsrn_precond(A, context, params, device=device)
        cond = float(sv[0] / torch.clamp_min(sv[-1],
                                             torch.finfo(sv.dtype).tiny))
    else:
        raise errors.InvalidParametersError(
            f"unknown accelerated method {method!r}")
    if not math.isfinite(cond) or cond > params.cond_threshold:
        Ad = A.todense(device=device) if is_sparse_operand(A) else A
        return solve_l2_exact(Ad, B, method="svd", device=device), 0
    kp = krylov.KrylovParams(tolerance=params.tolerance,
                             iter_lim=params.iter_lim)
    return krylov.lsqr(A, B, params=kp, precond=precond, device=device)
