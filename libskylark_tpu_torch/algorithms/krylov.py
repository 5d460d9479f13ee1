"""Krylov solvers: LSQR, CG, FlexibleCG and the Chebyshev semi-iteration
(the port of libskylark_tpu/algorithms/krylov.py).

The reference runs LSQR and CG as a ``lax.while_loop``; here each is a
Python loop over the same ``body``. Each pass reads one device flag, "all
columns done", to decide whether to go on: one host synchronisation per
iteration. Chebyshev runs a fixed count and reads nothing. Operators are
matrices, sparse matrices (whose products are ``spmm``/``spmm_t``,
base/sparse.py) or (matvec, rmatvec) callable pairs.

A DTensor A whose rows are split over a mesh (parallel/mesh.py) is never
gathered. LSQR keeps B and U on each rank's rows and V, X whole: A·X is
local, Aᵀ·U and the column norms of U are local sums and one all_reduce
each (``mesh._Blocks``). CG, flexible CG and Chebyshev keep every vector
whole on every rank: each product A·P is the rank's rows A_loc·P and one
all_gather of the (n × k) result, the ``A @ X`` that XLA gathers for too.
Every rank computes the same replicated scalars, so every rank reads the
same stopping flag and stops at the same iteration. X comes back
Replicate().
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from libskylark_tpu_torch.algorithms.precond import IdPrecond, Precond
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.sparse import linear_ops, place
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.parallel import mesh as pmesh

Operator = Union[torch.Tensor, Tuple[Callable, Callable]]


@dataclasses.dataclass
class KrylovParams(Params):
    tolerance: float = 1e-6
    iter_lim: int = -1


def _as_ops(A: Operator):
    """(mv, rmv) of an explicit pair, a :class:`SparseMatrix`, a matrix or
    a DTensor's blocks (local products, summed over the ranks)."""
    if isinstance(A, pmesh._Blocks):
        return A.mv, A.rmv
    return A if isinstance(A, tuple) else linear_ops(A)


def _row_blocks(A):
    """A DTensor operand's blocks, its columns whole (the layouts the
    solvers take)."""
    B = pmesh._Blocks(A)
    if B.cols.split:
        raise errors.NotImplementedYetError(
            "Krylov solvers on a DTensor with split columns (ROADMAP A5b)")
    return B


def _gathered_ops(A):
    """(mv, rmv) on whole vectors for a row-split DTensor A: A_loc·X, then
    an all_gather of the (n × k) product (square systems: CG, flexible
    CG, Chebyshev)."""
    B = _row_blocks(A)
    return (lambda X: B.rows.gather(B.mv(X)),
            lambda Y: B.rmv(B.rows.take(Y)))


def _whole(B, device):
    """A right-hand side or start as every rank's whole tensor: a DTensor
    is gathered (n × k, small)."""
    if B is None or not pmesh._is_sharded(B):
        return None if B is None else as_tensor(B, device)
    return pmesh._whole(B)


def _columns(B):
    """(B as (n, k), squeeze): a vector becomes one column."""
    return (B[:, None], True) if B.ndim == 1 else (B, False)


def _operands(A, B, X0, device):
    """(A, B, X0) on one device: A placed (a pair stays as it is), B and
    X0 as tensors there. A DTensor A becomes its gathered-product pair
    (:func:`_gathered_ops`) and B, X0 whole tensors on its device."""
    if pmesh._is_sharded(A):
        dev = A.to_local().device
        return _gathered_ops(A), _whole(B, dev), _whole(X0, dev)
    if not isinstance(A, tuple):
        A, device = place(A, device)
    B = as_tensor(B, device)
    return A, B, None if X0 is None else as_tensor(X0, B.device)


def _colnorms(X):
    return torch.sqrt(torch.sum(X * X, dim=0))


def lsqr_parts(A: Operator, B: torch.Tensor,
               params: Optional[KrylovParams] = None,
               precond: Optional[Precond] = None,
               shape: Optional[Tuple[int, int]] = None):
    """The LSQR iteration taken apart: ``(state0, body, meta)`` — the
    initial carry (a dict of tensors), the one-iteration transition
    ``state -> state``, and the loop-free facts (``iter_lim``,
    ``squeeze``, ``extract``). :func:`lsqr` runs ``body`` until every
    column is done or ``iter_lim`` is reached."""
    params = params or KrylovParams()
    if pmesh._is_sharded(A):
        A = _row_blocks(A)
        B = A.row_block(B)
    mv, rmv = _as_ops(A)
    R = precond or IdPrecond()
    B, squeeze = _columns(B)
    if shape is None:
        if isinstance(A, tuple):
            raise ValueError("shape=(m, n) required for operator-pair A")
        shape = tuple(A.shape)
    m, n = shape
    k = B.shape[1]
    dt = B.dtype
    # norms of the vectors on A's rows (B, U): summed over the ranks that
    # split them
    if isinstance(A, pmesh._Blocks):
        def unorms(X):
            return torch.sqrt(A.rows.sum(torch.sum(X * X, dim=0)))
    else:
        unorms = _colnorms

    eps = 32 * torch.finfo(dt).eps
    tol = min(max(params.tolerance, eps), 1.0 - eps)
    iter_lim = params.iter_lim if params.iter_lim > 0 else max(20, 2 * min(m, n))

    beta = unorms(B)
    U = B / torch.clamp_min(beta, eps)[None, :]
    V = R.apply_adjoint(rmv(U))
    alpha = _colnorms(V)
    V = V / torch.clamp_min(alpha, eps)[None, :]
    Z = R.apply(V)
    nrm_ar_0 = alpha * beta

    state = dict(
        X=torch.zeros((n, k), dtype=dt, device=B.device), U=U, V=V, Z=Z,
        W=Z, alpha=alpha, beta=beta, phibar=beta, rhobar=alpha,
        nrm_a=torch.zeros((k,), dtype=dt, device=B.device), nrm_r=beta,
        done=nrm_ar_0 == 0, it=0,
    )

    def body(s):
        # bidiagonalization step
        U = mv(s["Z"]) - s["alpha"][None, :] * s["U"]
        beta = unorms(U)
        U = U / torch.clamp_min(beta, eps)[None, :]
        V = R.apply_adjoint(rmv(U)) - beta[None, :] * s["V"]
        alpha = _colnorms(V)
        V = V / torch.clamp_min(alpha, eps)[None, :]
        Z = R.apply(V)

        nrm_a = torch.sqrt(s["nrm_a"] ** 2 + s["alpha"] ** 2 + beta ** 2)

        # Givens rotation
        rho = torch.sqrt(s["rhobar"] ** 2 + beta ** 2)
        cs = s["rhobar"] / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]

        step = (phi / rho)[None, :] * s["W"]
        X = torch.where(s["done"][None, :], s["X"], s["X"] + step)
        W = Z - (theta / rho)[None, :] * s["W"]

        nrm_r = phibar
        nrm_ar = phibar * alpha * torch.abs(cs)
        done = (s["done"]
                | (nrm_ar <= tol * torch.clamp_min(nrm_a * nrm_r, eps))
                | (nrm_ar <= tol * nrm_ar_0))
        return dict(X=X, U=U, V=V, Z=Z, W=W, alpha=alpha, beta=beta,
                    phibar=phibar, rhobar=rhobar, nrm_a=nrm_a, nrm_r=nrm_r,
                    done=done, it=s["it"] + 1)

    meta = dict(iter_lim=iter_lim, squeeze=squeeze,
                extract=lambda s: s["X"][:, 0] if squeeze else s["X"])
    return state, body, meta


@with_solver_precision
def lsqr(A: Operator, B, params: Optional[KrylovParams] = None,
         precond: Optional[Precond] = None,
         shape: Optional[Tuple[int, int]] = None, device=None):
    """Paige-Saunders LSQR for min ‖A·X − B‖ with an optional right
    preconditioner R: the iteration runs on A·R and the solution
    accumulates in the original space through Z = R·V. B may have k
    columns, each with its own recurrence and stopping state. Returns
    (X, iterations)."""
    if pmesh._is_sharded(A):
        X, it = _run(*lsqr_parts(A, B, params, precond, shape))
        return pmesh._like(A, X), it
    A, B, _ = _operands(A, B, None, device)
    return _run(*lsqr_parts(A, B, params, precond, shape))


def _run(state, body, meta):
    """Iterate ``body`` until every column is done or ``iter_lim`` is
    reached: one device read per iteration, the stopping test."""
    while state["it"] < meta["iter_lim"] and not bool(state["done"].all()):
        state = body(state)
    return meta["extract"](state), state["it"]


def cg_parts(A: Operator, B: torch.Tensor,
             params: Optional[KrylovParams] = None,
             precond: Optional[Precond] = None,
             X0: Optional[torch.Tensor] = None,
             shape: Optional[Tuple[int, int]] = None):
    """The CG iteration taken apart, as :func:`lsqr_parts`. ``shape`` is
    accepted for symmetry (CG systems are square; B fixes the size)."""
    del shape
    params = params or KrylovParams()
    mv, _ = _as_ops(A)
    M = precond or IdPrecond()
    B, squeeze = _columns(B)
    n, k = B.shape
    eps = torch.finfo(B.dtype).eps
    iter_lim = params.iter_lim if params.iter_lim > 0 else max(20, 2 * n)
    tol = params.tolerance

    X = torch.zeros_like(B) if X0 is None else X0.reshape(n, k)
    Rr = B - mv(X)
    Zz = M.apply(Rr)
    rz = torch.sum(Rr * Zz, dim=0)
    nrm_b = torch.clamp_min(_colnorms(B), eps)

    state = dict(X=X, R=Rr, P=Zz, rz=rz, it=0,
                 done=_colnorms(Rr) <= tol * nrm_b)

    def body(s):
        AP = mv(s["P"])
        pap = torch.sum(s["P"] * AP, dim=0)
        alpha = s["rz"] / torch.where(pap == 0, 1.0, pap)
        alpha = torch.where(s["done"], 0.0, alpha)
        X = s["X"] + alpha[None, :] * s["P"]
        Rr = s["R"] - alpha[None, :] * AP
        Zz = M.apply(Rr)
        rz_new = torch.sum(Rr * Zz, dim=0)
        beta = rz_new / torch.where(s["rz"] == 0, 1.0, s["rz"])
        P = Zz + beta[None, :] * s["P"]
        done = s["done"] | (_colnorms(Rr) <= tol * nrm_b)
        return dict(X=X, R=Rr, P=P, rz=rz_new, it=s["it"] + 1, done=done)

    meta = dict(iter_lim=iter_lim, squeeze=squeeze,
                extract=lambda s: s["X"][:, 0] if squeeze else s["X"])
    return state, body, meta


@with_solver_precision
def cg(A: Operator, B, params: Optional[KrylovParams] = None,
       precond: Optional[Precond] = None, X0=None,
       shape: Optional[Tuple[int, int]] = None, device=None):
    """Preconditioned conjugate gradient for SPD A, each column of B with
    its own recurrence and stopping state. Returns (X, iterations)."""
    A0 = A
    A, B, X0 = _operands(A, B, X0, device)
    X, it = _run(*cg_parts(A, B, params, precond, X0, shape))
    return pmesh._like(A0, X), it


@with_solver_precision
def flexible_cg(A: Operator, B, params: Optional[KrylovParams] = None,
                precond=None, X0=None, device=None):
    """Flexible CG (Polak-Ribière beta), which tolerates a preconditioner
    that changes between iterations. ``precond`` is a :class:`Precond` or
    a callable ``(R, it) -> Z`` (an inner iterative solve). Returns (X,
    iterations)."""
    params = params or KrylovParams()
    A0 = A
    A, B, X0 = _operands(A, B, X0, device)
    mv, _ = _as_ops(A)
    B, squeeze = _columns(B)
    n, k = B.shape
    eps = torch.finfo(B.dtype).eps
    iter_lim = params.iter_lim if params.iter_lim > 0 else max(20, 2 * n)
    tol = params.tolerance

    if precond is None:
        apply_m = lambda Rr, it: Rr  # noqa: E731
    elif isinstance(precond, Precond):
        apply_m = lambda Rr, it: precond.apply(Rr)  # noqa: E731
    else:
        apply_m = precond

    X = torch.zeros_like(B) if X0 is None else X0.reshape(n, k)
    Rr = B - mv(X)
    nrm_b = torch.clamp_min(_colnorms(B), eps)
    Z = apply_m(Rr, 0)
    state = dict(X=X, R=Rr, P=Z, Zprev=Z, it=0,
                 done=_colnorms(Rr) <= tol * nrm_b)

    def body(s):
        AP = mv(s["P"])
        pap = torch.sum(s["P"] * AP, dim=0)
        rz = torch.sum(s["R"] * s["Zprev"], dim=0)
        alpha = rz / torch.where(pap == 0, 1.0, pap)
        alpha = torch.where(s["done"], 0.0, alpha)
        X = s["X"] + alpha[None, :] * s["P"]
        Rn = s["R"] - alpha[None, :] * AP
        Zn = apply_m(Rn, s["it"] + 1)
        # Polak-Ribière: beta = z_new·(r_new − r_old) / z_old·r_old
        num = torch.sum(Zn * (Rn - s["R"]), dim=0)
        beta = num / torch.where(rz == 0, 1.0, rz)
        P = Zn + beta[None, :] * s["P"]
        done = s["done"] | (_colnorms(Rn) <= tol * nrm_b)
        return dict(X=X, R=Rn, P=P, Zprev=Zn, it=s["it"] + 1, done=done)

    meta = dict(iter_lim=iter_lim,
                extract=lambda s: s["X"][:, 0] if squeeze else s["X"])
    X, it = _run(state, body, meta)
    return pmesh._like(A0, X), it


@with_solver_precision
def chebyshev(A: Operator, B, lambda_min: float, lambda_max: float,
              params: Optional[KrylovParams] = None,
              precond: Optional[Precond] = None, X0=None, device=None):
    """Chebyshev semi-iteration for SPD A with spectrum in [lambda_min,
    lambda_max]: matvecs only, no inner products. The scalar recurrence
    depends on the bounds alone, so it runs on the host in B's precision
    and the loop reads nothing from the device. Returns (X, iterations)."""
    params = params or KrylovParams()
    A0 = A
    A, B, X0 = _operands(A, B, X0, device)
    mv, _ = _as_ops(A)
    M = precond or IdPrecond()
    B, squeeze = _columns(B)
    f = torch.empty((), dtype=B.dtype).numpy().dtype.type
    iter_lim = params.iter_lim if params.iter_lim > 0 else 50

    d = (lambda_max + lambda_min) / 2.0
    c = f((lambda_max - lambda_min) / 2.0)
    X = torch.zeros_like(B) if X0 is None else X0.reshape(B.shape)
    P = torch.zeros_like(B)
    alpha = f(1.0)
    for i in range(iter_lim):
        Z = M.apply(B - mv(X))
        if i == 0:
            beta, alpha = f(0.0), f(1.0 / d)
        else:
            beta = (f(0.5) * (c * alpha) ** 2 if i == 1
                    else (c * alpha / f(2.0)) ** 2)
            alpha = f(1.0) / (f(d) - beta / alpha)
        P = Z + float(beta) * P
        X = X + float(alpha) * P
    return pmesh._like(A0, X[:, 0] if squeeze else X), iter_lim
