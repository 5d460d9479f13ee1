"""Krylov solvers: LSQR (the port of the LSQR part of
libskylark_tpu/algorithms/krylov.py).

The reference runs the iteration as a ``lax.while_loop``; here it is a
Python loop over the same ``body``. Each pass reads one device flag, "all
columns done", to decide whether to go on: one host synchronisation per
iteration. Operators are matrices, sparse matrices (whose products are
``spmm``/``spmm_t``, base/sparse.py) or (matvec, rmatvec) callable
pairs. CG, FlexibleCG and Chebyshev are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from libskylark_tpu_torch.algorithms.precond import IdPrecond, Precond
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.sparse import linear_ops, place
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision

Operator = Union[torch.Tensor, Tuple[Callable, Callable]]


@dataclasses.dataclass
class KrylovParams(Params):
    tolerance: float = 1e-6
    iter_lim: int = -1


def _as_ops(A: Operator):
    """(mv, rmv) of an explicit pair, a :class:`SparseMatrix` or a
    matrix."""
    return A if isinstance(A, tuple) else linear_ops(A)


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
    mv, rmv = _as_ops(A)
    R = precond or IdPrecond()
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if shape is None:
        if isinstance(A, tuple):
            raise ValueError("shape=(m, n) required for operator-pair A")
        shape = tuple(A.shape)
    m, n = shape
    k = B.shape[1]
    dt = B.dtype

    eps = 32 * torch.finfo(dt).eps
    tol = min(max(params.tolerance, eps), 1.0 - eps)
    iter_lim = params.iter_lim if params.iter_lim > 0 else max(20, 2 * min(m, n))

    beta = _colnorms(B)
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
        beta = _colnorms(U)
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
    if not isinstance(A, tuple):
        A, device = place(A, device)
    B = as_tensor(B, device)
    state, body, meta = lsqr_parts(A, B, params, precond, shape)
    # one device read per iteration: the stopping test
    while state["it"] < meta["iter_lim"] and not bool(state["done"].all()):
        state = body(state)
    return meta["extract"](state), state["it"]
