"""Condition number estimation by Golub-Kahan bidiagonalization (the port
of libskylark_tpu/nla/condest.py).

The Golub-Kahan recurrence (LSQR's core) runs for up to ``max_iter``
steps, collecting (alpha, beta); the singular values of the small
rectangular bidiagonal B_k bracket the operand's, σ_max(B_k) ↗ σ_max(A)
and σ_min(B_k) ↘ σ_min(A) as k grows, and the loop stops once both
extremes stabilise to a relative ``tol``.

- :func:`condest` is the host diagnostic, as in the reference: float64
  numpy for a dense operand, scipy matvecs for a
  :class:`~libskylark_tpu_torch.base.sparse.SparseMatrix` (never
  densified), full two-sided reorthogonalization, and a start vector
  from the port's own Normal sampler (jax.random.normal's, C2) under the
  context's next allocation.
- a :class:`~libskylark_tpu_torch.base.dist_sparse.DistSparseMatrix`
  takes :func:`_condest_device`: the same recurrence in float32 on each
  rank's device through the operand's ``spmm``/``spmm_t`` (an all-reduce
  each), the reorthogonalization as device dots against the stored
  Krylov vectors; only the two norms a step and the small bidiagonal's
  SVD reach the host. The operand is never gathered.
- :func:`condest_serve_apply` is its fixed-step device twin, in torch on
  the operand's device; :func:`condest_serve` pads the operand to the
  serve layer's class as the reference's eager twin does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context, key_words, seed_key
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.base.sparse import is_sparse_operand


def _normal(key, m: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.normal(key, (m,))`` on ``device``."""
    keys = torch.tensor([list(key_words(key))], dtype=torch.int64,
                        device=device)
    return randgen.Normal().sample_chunks(keys, m)[0].to(dtype)


@with_solver_precision
def condest(A, context: Context, max_iter: int = 100,
            tol: float = 1e-3) -> Tuple[float, float, float]:
    """Estimate (cond, sigma_max, sigma_min) of A (m ≥ n recommended) on
    the host in float64. ``A`` is a numpy array, a tensor or a
    :class:`SparseMatrix`; a :class:`DistSparseMatrix` runs on the card
    (:func:`_condest_device`). Deterministic given the context."""
    from libskylark_tpu_torch.base.dist_sparse import DistSparseMatrix

    if isinstance(A, DistSparseMatrix):
        return _condest_device(A, context, max_iter, tol)
    if is_sparse_operand(A):
        M = A.to_scipy().astype(np.float64)
    elif isinstance(A, torch.Tensor):
        M = A.detach().cpu().numpy().astype(np.float64)
    else:
        M = np.asarray(A, dtype=np.float64)
    m, n = M.shape
    b = _normal(context.allocate().key, m).numpy().astype(np.float64)
    return _golub_kahan(
        matvec=lambda x: M @ x, rmatvec=lambda x: M.T @ x, b=b,
        shape=(m, n), max_iter=max_iter, tol=tol,
        dot=lambda x, y: float(x @ y),
        norm=lambda x: float(np.linalg.norm(x)))


def _condest_device(D, context: Context, max_iter: int, tol: float
                    ) -> Tuple[float, float, float]:
    """Golub-Kahan against a DistSparseMatrix on each rank's device, in
    float32: u and v are whole vectors on every rank (the products'
    results), the reorthogonalization coefficients stay device scalars,
    and only the two norms a step read to the host, for the breakdown and
    convergence tests. Full two-sided reorthogonalization holds the
    bidiagonal at the moderate k this estimator needs, as in the
    reference."""
    m, n = D.shape
    b = _normal(context.allocate().key, m, torch.float32, D.device)
    return _golub_kahan(
        matvec=D.spmm, rmatvec=D.spmm_t, b=b, shape=(m, n),
        max_iter=max_iter, tol=tol, dot=torch.vdot,
        norm=lambda x: float(torch.linalg.norm(x)))


def _golub_kahan(matvec: Callable, rmatvec: Callable, b,
                 shape: Tuple[int, int], max_iter: int, tol: float,
                 dot: Callable, norm: Callable
                 ) -> Tuple[float, float, float]:
    """The recurrence, with two-sided reorthogonalization against every
    earlier vector (without it the bidiagonal stops being an orthogonal
    projection and its singular values can leave [σ_min, σ_max])."""
    m, n = shape
    beta = norm(b)
    u = b / beta
    v = rmatvec(u)
    alpha = norm(v)
    v = v / alpha

    Us, Vs = [u], [v]
    alphas: list[float] = [alpha]
    betas: list[float] = []
    prev = None
    # the Krylov space is exhausted after min(m, n) steps
    max_iter = min(max_iter, min(m, n) - 1)
    for it in range(max_iter):
        u = matvec(v) - alpha * u
        for up in Us:
            u = u - dot(up, u) * up
        beta = norm(u)
        if beta <= 1e-12 * max(alphas):
            break
        u = u / beta
        Us.append(u)
        v = rmatvec(u) - beta * v
        for vp in Vs:
            v = v - dot(vp, v) * vp
        alpha = norm(v)
        if alpha <= 1e-12 * max(alphas):
            betas.append(beta)
            break
        v = v / alpha
        Vs.append(v)
        betas.append(beta)
        alphas.append(alpha)

        if it >= 3 and (it % 5 == 0 or it == max_iter - 1):
            sv = _bidiag_svals(matvec, Us, Vs, alphas, betas, dot, norm)
            cur = (sv[0], sv[-1])
            if prev is not None:
                rel_max = abs(cur[0] - prev[0]) / max(cur[0], 1e-30)
                rel_min = abs(cur[1] - prev[1]) / max(cur[1], 1e-30)
                if rel_max < tol and rel_min < tol:
                    break
            prev = cur

    sv = _bidiag_svals(matvec, Us, Vs, alphas, betas, dot, norm)
    smax, smin = float(sv[0]), float(sv[-1])
    return (smax / max(smin, np.finfo(np.float64).tiny), smax, smin)


def _bidiag_svals(matvec, Us, Vs, alphas, betas, dot, norm) -> np.ndarray:
    """Singular values of the rectangular (k+1)×k Golub-Kahan bidiagonal,
    U_{k+1}ᵀ·A·V_k: its trailing beta row keeps them inside [σ_min(A),
    σ_max(A)], which the square truncation does not."""
    k = len(alphas)
    u_t = matvec(Vs[-1]) - alphas[-1] * Us[-1]
    for up in Us:
        u_t = u_t - dot(up, u_t) * up
    B = np.zeros((k + 1, k))
    for i, a in enumerate(alphas):
        B[i, i] = a
    for i, b in enumerate(betas[: k - 1]):
        B[i + 1, i] = b
    B[k, k - 1] = norm(u_t)
    return np.linalg.svd(B, compute_uv=False)


def condest_serve_apply(key_data, A: torch.Tensor, *,
                        steps: int) -> torch.Tensor:
    """One request's (cond, sigma_max, sigma_min) as a (3,) tensor on A's
    device: a fixed number of Golub-Kahan steps with full two-sided
    reorthogonalization, the start vector jax.random.normal's under the
    raw key, and the small bidiagonal's singular values. Zero padding of
    A is benign: the Krylov vectors stay in the true row and column
    spaces."""
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=A.dtype,
                        device=A.device)

    def nrm(x):
        return torch.maximum(torch.linalg.norm(x), tiny)

    b = _normal(key_data, A.shape[0], A.dtype, A.device)
    beta = nrm(b)
    u = b / beta
    v = A.T @ u
    alpha = nrm(v)
    v = v / alpha

    Us, Vs, alphas, betas = [u], [v], [alpha], []
    for _ in range(max(int(steps), 1)):
        u = A @ v - alpha * u
        for up in Us:
            u = u - (up @ u) * up
        beta = nrm(u)
        u = u / beta
        Us.append(u)
        v = A.T @ u - beta * v
        for vp in Vs:
            v = v - (vp @ v) * vp
        alpha = nrm(v)
        v = v / alpha
        Vs.append(v)
        betas.append(beta)
        alphas.append(alpha)

    u_t = A @ Vs[-1] - alphas[-1] * Us[-1]
    for up in Us:
        u_t = u_t - (up @ u_t) * up
    k = len(alphas)
    B = torch.zeros((k + 1, k), dtype=A.dtype, device=A.device)
    idx = torch.arange(k, device=A.device)
    B[idx, idx] = torch.stack(alphas)
    if k > 1:
        B[idx[1:], idx[:-1]] = torch.stack(betas[: k - 1])
    B[k, k - 1] = nrm(u_t)
    sv = torch.linalg.svdvals(B)
    return torch.stack([sv[0] / torch.maximum(sv[-1], tiny), sv[0], sv[-1]])


@with_solver_precision
def condest_serve(A, *, steps: int = 8, seed: int = 0, dtype=np.float32,
                  device=None) -> Tuple[float, float, float]:
    """Eager twin of the condest serve endpoint: ``A`` zero-padded to the
    serve layer's pow2 class, then :func:`condest_serve_apply` under
    ``jax.random.key(seed)``'s key data on ``device``. Returns (cond,
    sigma_max, sigma_min) as floats."""
    from libskylark_tpu_torch.engine import bucket

    A = (A.detach().cpu().numpy() if isinstance(A, torch.Tensor)
         else np.asarray(A)).astype(np.dtype(dtype))
    if A.ndim != 2:
        raise ValueError(f"condest expects a matrix, got {A.shape}")
    Ap = np.zeros(bucket.pad_shape(A.shape, (0, 1)), dtype=A.dtype)
    Ap[: A.shape[0], : A.shape[1]] = A
    out = condest_serve_apply(seed_key(seed), as_tensor(Ap, device),
                              steps=int(steps)).cpu().numpy()
    return float(out[0]), float(out[1]), float(out[2])
