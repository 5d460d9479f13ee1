"""Regression: exact, sketch-and-solve and sketch-accelerated L2 solvers
(the port of libskylark_tpu/algorithms/regression.py; the serve program
``sketched_solve_serve`` is not ported yet).

The reference compiles the accelerated solvers as two engine executables
(preconditioner build, LSQR) with one host read between them, the
condition estimate that decides the fallback; here they are plain calls
with the same single read, and LSQR's own per-iteration stopping test.
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
from libskylark_tpu_torch.base.params import Params
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


def _blendenpik_r(A, T) -> torch.Tensor:
    """R factor of the sketched operand: the right preconditioner."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    return torch.linalg.qr(T.apply(A, COLUMNWISE, device=A.device),
                           mode="r").R


def _lsrn_parts(A, T) -> tuple[torch.Tensor, torch.Tensor]:
    """LSRN preconditioner N = V·Σ⁻¹ from the SVD of the sketch, and the
    singular values."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    SA = T.apply(A, COLUMNWISE, device=A.device)
    _, sv, Vt = torch.linalg.svd(SA, full_matrices=False)
    floor = sv[0] * torch.finfo(SA.dtype).eps
    return Vt.T * (1.0 / torch.maximum(sv, floor))[None, :], sv


@with_solver_precision
def build_blendenpik_precond(A, context: Context, params: AcceleratedParams,
                             device=None) -> tuple[Precond, torch.Tensor]:
    """Sketch A and QR the sketch; R is the right preconditioner."""
    A = as_tensor(A, device)
    R = _blendenpik_r(A, _accel_transform(*A.shape, context, params))
    return TriInversePrecond(R), R


@with_solver_precision
def build_lsrn_precond(A, context: Context, params: AcceleratedParams,
                       device=None) -> tuple[Precond, torch.Tensor]:
    """LSRN: Gaussian sketch, SVD of the sketch, preconditioner V·Σ⁻¹."""
    A = as_tensor(A, device)
    T = _accel_transform(*A.shape, context, params, gaussian=True)
    Ninv, sv = _lsrn_parts(A, T)
    return MatPrecond(Ninv), sv


@with_solver_precision
def solve_l2_accelerated(A, B, context: Context, method: str = "blendenpik",
                         params: Optional[AcceleratedParams] = None,
                         device=None):
    """Sketch-preconditioned LSQR (Blendenpik, its simplified CWT variant,
    or LSRN), with the exact SVD solve when the preconditioner's condition
    is not finite or exceeds ``params.cond_threshold``.

    Returns (X, iterations); iterations == 0 signals the exact fallback.
    Reading the condition is the one host synchronisation before LSQR."""
    params = params or AcceleratedParams()
    A = as_tensor(A, device)
    B = as_tensor(B, A.device)
    if method == "simplified_blendenpik":
        params = dataclasses.replace(params, sketch="cwt")
    if method in ("blendenpik", "simplified_blendenpik"):
        precond, R = build_blendenpik_precond(A, context, params,
                                              device=A.device)
        cond = float(torch.linalg.cond(R))
    elif method == "lsrn":
        precond, sv = build_lsrn_precond(A, context, params, device=A.device)
        cond = float(sv[0] / torch.clamp_min(sv[-1],
                                             torch.finfo(A.dtype).tiny))
    else:
        raise errors.InvalidParametersError(
            f"unknown accelerated method {method!r}")
    if not math.isfinite(cond) or cond > params.cond_threshold:
        return solve_l2_exact(A, B, method="svd", device=A.device), 0
    kp = krylov.KrylovParams(tolerance=params.tolerance,
                             iter_lim=params.iter_lim)
    return krylov.lsqr(A, B, params=kp, precond=precond, device=A.device)
