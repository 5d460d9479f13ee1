"""Regression: exact, sketch-and-solve and sketch-accelerated L2 solvers
(the port of libskylark_tpu/algorithms/regression.py), and
``sketched_solve_serve``, one served solve request's program.

Dense tensor operands run through the engine's executable cache
(engine/compiled.py; CUDA graphs on the card, the sketch's key a graph
input): sketch-and-solve as ``"solve_l2_sketched"`` (the sketch of
[A | B] and, for the "qr" and "sne" methods, the small solve), and the
preconditioner builds of the accelerated solvers as
``"ls_accel_precond"`` (Blendenpik: the sketch and its R factor; LSRN:
the sketch). What reads a convergence flag on the host stays eager
after it (ROADMAP C20): LSRN's SVD of the sketch, the "ne" and "svd"
small solves, and the condition estimate, the one host read before
LSQR that decides the fallback, as in the reference. LSQR itself runs
eagerly with its per-iteration stopping test (ROADMAP B-ii 7).

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

from libskylark_tpu_torch import engine
from libskylark_tpu_torch.algorithms import krylov
from libskylark_tpu_torch.algorithms.precond import (MatPrecond, Precond,
                                                     TriInversePrecond)
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.sparse import is_sparse_operand, place
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.parallel import mesh as pmesh

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


# the small solves a capture takes: torch's "ne" Cholesky and "svd" read
# their info on the host
_CAPTURED_METHODS = ("qr", "sne")


def _sketch_and_solve(A: torch.Tensor, B: torch.Tensor, T, *, method: str):
    """The body of ``"solve_l2_sketched"``: [A | B] sketched in one
    columnwise apply and, for the captured methods, the small problem
    solved; otherwise the sketch, solved by the caller."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    SAB = T.apply(torch.cat([A, B], dim=1), COLUMNWISE, device=A.device)
    if method not in _CAPTURED_METHODS:
        return SAB
    n = A.shape[1]
    return solve_l2_exact(SAB[:, :n], SAB[:, n:], method=method,
                          device=A.device)


_sketch_and_solve_compiled = engine.compiled(
    _sketch_and_solve, static_argnames=("method",), donate_argnums=(0, 1),
    donate="auto", name="solve_l2_sketched")


@with_solver_precision
def solve_l2_sketched(A, B, transform, method: str = "qr",
                      device=None) -> torch.Tensor:
    """Sketch-and-solve: compress the rows of [A | B] with a columnwise
    sketch, then solve the small problem exactly. On a CUDA tensor a
    dense sketch runs the fused columnwise kernel, inside the captured
    ``"solve_l2_sketched"`` body.

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
    # a DTensor runs the body eagerly (its sketches' own collective routes)
    run = (_sketch_and_solve if pmesh._is_sharded(A)
           else _sketch_and_solve_compiled)
    X = run(A, B[:, None] if squeeze else B, transform, method=method)
    if method not in _CAPTURED_METHODS:
        n = A.shape[1]
        X = solve_l2_exact(X[:, :n], X[:, n:], method=method,
                           device=A.device)
    return X[:, 0] if squeeze else X


def sketched_solve_serve(key_data, scale, A, B, *, sketch_type: str,
                         s_dim: int, method: str = "qr") -> torch.Tensor:
    """One served sketch-and-solve request as a function of the
    transform's raw key data ((2,) uint32) and its scale: the columnwise
    sketch of A (n, d) and of B (n, t) from the key, JLT by
    ``dense.serve_apply`` (the operator made in torch) or CWT by
    ``hash.cwt_serve_apply``, then ``solve_l2_exact`` of the small
    problem. Zero-padded rows of A and B add nothing through either
    sketch; d and t are exact (a zero column would make the small
    problem singular). The serve layer's plain flush runs it lane by
    lane; its kernel flush sketches the whole cohort in one launch per
    operand (engine/serve.py)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import dense, hash as sketch_hash

    if sketch_type == "CWT":
        SA = sketch_hash.cwt_serve_apply(key_data, A, s_dim=s_dim,
                                         rowwise=False)
        SB = sketch_hash.cwt_serve_apply(key_data, B, s_dim=s_dim,
                                         rowwise=False)
    elif sketch_type == "JLT":
        SA = dense.serve_apply(key_data, scale, A, dist=randgen.Normal(),
                               s_dim=s_dim, rowwise=False)
        SB = dense.serve_apply(key_data, scale, B, dist=randgen.Normal(),
                               s_dim=s_dim, rowwise=False)
    else:
        raise errors.InvalidParametersError(
            f"serve path supports JLT/CWT sketches, got {sketch_type!r}")
    return solve_l2_exact(SA, SB, method=method, device=SA.device)


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


def _lsrn_parts(SA: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LSRN preconditioner N = V·Σ⁻¹ from the SVD of the sketch, and the
    singular values."""
    _, sv, Vt = torch.linalg.svd(SA, full_matrices=False)
    floor = sv[0] * torch.finfo(SA.dtype).eps
    return Vt.T * (1.0 / torch.maximum(sv, floor))[None, :], sv


def _precond_body(A, T, *, method: str, device=None) -> torch.Tensor:
    """The body of ``"ls_accel_precond"``: Blendenpik's R, or LSRN's
    sketch (its SVD reads convergence info on the host: eager after), on
    ``device`` (default: A's)."""
    from libskylark_tpu_torch.sketch import COLUMNWISE

    device = A.device if device is None else device
    if method == "lsrn":
        return T.apply(A, COLUMNWISE, device=device)
    return _blendenpik_r(A, T, device)


_precond_compiled = engine.compiled(
    _precond_body, static_argnames=("method",), name="ls_accel_precond")


def _precond_part(A, T, method: str, device) -> torch.Tensor:
    """:func:`_precond_body` from the executable cache for a dense
    tensor, directly for a sparse operand or a DTensor."""
    if is_sparse_operand(A) or pmesh._is_sharded(A):
        return _precond_body(A, T, method=method, device=device)
    return _precond_compiled(A, T, method=method)


@with_solver_precision
def build_blendenpik_precond(A, context: Context, params: AcceleratedParams,
                             device=None) -> tuple[Precond, torch.Tensor]:
    """Sketch A and QR the sketch; R is the right preconditioner."""
    A, device = place(A, device)
    R = _precond_part(A, _accel_transform(*A.shape, context, params),
                      "blendenpik", device)
    return TriInversePrecond(R), R


@with_solver_precision
def build_lsrn_precond(A, context: Context, params: AcceleratedParams,
                       device=None) -> tuple[Precond, torch.Tensor]:
    """LSRN: Gaussian sketch, SVD of the sketch, preconditioner V·Σ⁻¹."""
    A, device = place(A, device)
    T = _accel_transform(*A.shape, context, params, gaussian=True)
    Ninv, sv = _lsrn_parts(_precond_part(A, T, "lsrn", device))
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
