"""Randomized low-rank toolkit: range finders and range-assisted
factorizations (the port of libskylark_tpu/nla/krank.py,
Halko–Martinsson–Tropp, SIAM Rev. 2011: range finders, Algs 4.1–4.5;
range-assisted SVD, Algs 5.1/5.2, and EVD, Algs 5.3–5.6; the SRFT).

Every random draw is a counter stream of the context, as in the
reference: a Gaussian test matrix is ``stream_slice(Normal)`` reshaped
(n, cols), made whole on the operand's device and multiplied by
``torch.matmul`` (the reference makes it whole too, outside any kernel).
The SRFT's mixer is the real DCT (``fut.dct``), the reference's choice.
Dense linear algebra runs on the operand's device; the adaptive finder's
recurrence and the interpolative-decomposition variants run on the host
(numpy, scipy), as in the reference.

A DTensor operand whose rows are split over a mesh (parallel/mesh.py) is
never gathered: the stored test matrices (whole on every rank) multiply
each rank's rows, Aᵀ·Y is the ranks' local products and one all_reduce,
and the basis Q stays on each rank's rows (Shard(0)). Each QR of a tall
panel is the reference's Householder QR, which XLA replicates: the
panel (m × s) is gathered, factored on every rank, and each keeps its
rows (``_qr``). ``RangeAssistedSVD``/``RangeAssistedEVD`` take the
``direct`` method on such operands (Qᵀ·A summed over the ranks, the small
factorization on every rank); the adaptive finder and the host variants
raise NotImplementedYetError (ROADMAP A5b).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Allocation, Context
from libskylark_tpu_torch.base.device import as_tensor, resolve_device
from libskylark_tpu_torch.base.precision import with_solver_precision
from libskylark_tpu_torch.parallel import mesh as pmesh


def _normal(alloc: Allocation, n: int, cols: int, dtype,
            device=None) -> torch.Tensor:
    flat = randgen.stream_slice(alloc.key, randgen.Normal(), 0, n * cols,
                                dtype, device)
    return flat.reshape(n, cols)


def srft_matrix(n: int, s: int, context: Context, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Realized (n, s) subsampled randomized cosine transform √(n/s)·D·Fᵀ·R:
    D a Rademacher diagonal, F the orthonormal DCT, R a uniform sample of
    s columns (two allocations: signs, then columns). ``A @
    srft_matrix(...)`` sketches A's columns."""
    from libskylark_tpu_torch.sketch import fut

    device = resolve_device(device)
    signs = randgen.stream_slice(context.allocate().key, randgen.Rademacher(),
                                 0, n, dtype, device)
    idx = randgen.stream_slice(context.allocate().key,
                               randgen.UniformInt(0, n - 1), 0, s,
                               device=device)
    F = fut.dct(torch.eye(n, dtype=dtype, device=device),
                axis=0) * fut.DCT(n).scale()
    S = signs[:, None] * F.T[:, idx]
    return float(np.sqrt(n / s)) * S


class RandomizedRangeFinder:
    """Orthonormal Q approximating range(A). Methods: ``generic`` (Alg
    4.1, s), ``adaptive`` (Alg 4.2, epsilon/r/max_iters),
    ``power_iteration`` (Alg 4.3, s/q), ``subspace_iteration`` (Alg 4.4,
    s/q), ``fast_generic`` (Alg 4.5, s: the SRFT). ``A`` lands on
    ``device`` (default: the package default)."""

    args = {
        "generic": {"s": None},
        "adaptive": {"epsilon": None, "r": None, "max_iters": 100},
        "power_iteration": {"s": None, "q": 1},
        "subspace_iteration": {"s": None, "q": 1},
        "fast_generic": {"s": None},
    }

    def __init__(self, A, method: str, params: dict, context: Context,
                 device=None):
        if method not in self.args:
            raise errors.InvalidParametersError(f"unknown method {method!r}")
        kwargs = dict(self.args[method])
        kwargs.update(params)
        if None in kwargs.values():
            missing = [k for k, v in kwargs.items() if v is None]
            raise errors.InvalidParametersError(
                f"missing arguments {missing} for method {method!r}")
        self.A = as_tensor(A, device)
        self._B = _row_blocks(self.A, method, ("adaptive",))
        self.method = method
        self.kwargs = kwargs
        self.context = context

    @with_solver_precision
    def compute(self) -> torch.Tensor:
        Q = getattr(self, f"_{self.method}")()
        return self._B.rows.wrap(Q) if self._B.sharded else Q

    def _test_matrix(self, s: int) -> torch.Tensor:
        B = self._B
        return _normal(self.context.allocate(), B.shape[1], s,
                       B.local.dtype, B.local.device)

    def _generic(self):
        S = self._test_matrix(int(self.kwargs["s"]))
        return _qr(self._B, self._B.mv(S))

    def _power_iteration(self):
        B = self._B
        S = self._test_matrix(int(self.kwargs["s"]))
        Y = B.mv(S)
        for _ in range(int(self.kwargs["q"])):
            Y = B.mv(B.rmv(Y))
        return _qr(B, Y)

    def _subspace_iteration(self):
        B = self._B
        S = self._test_matrix(int(self.kwargs["s"]))
        Q = _qr(B, B.mv(S))
        for _ in range(int(self.kwargs["q"])):
            W = torch.linalg.qr(B.rmv(Q))[0]
            Q = _qr(B, B.mv(W))
        return Q

    def _fast_generic(self):
        B = self._B
        S = srft_matrix(B.shape[1], int(self.kwargs["s"]), self.context,
                        B.local.dtype, B.local.device)
        return _qr(B, B.mv(S))

    def _adaptive(self):
        """Alg 4.2: grow Q one vector at a time until the residual norms
        of ``r`` probe vectors fall below ε/(10·√(2/π)). Sequential; runs
        on the host in the operand's precision, as the reference does."""
        A = self.A.cpu().numpy()
        eps = float(self.kwargs["epsilon"])
        r = int(self.kwargs["r"])
        max_iters = int(self.kwargs["max_iters"])
        m, n = A.shape
        alloc = self.context.allocate()
        draws = _normal(alloc, n, r + max_iters, torch.float32,
                        "cpu").numpy()
        w_next = r
        ys = [A @ draws[:, i] for i in range(r)]
        threshold = eps / (10.0 * np.sqrt(2.0 / np.pi))
        Q = np.empty((m, 0), dtype=A.dtype)
        iters = 0
        j = -1
        while (max(np.linalg.norm(y) for y in ys[j + 1:]) > threshold
               and iters < max_iters and w_next < draws.shape[1]):
            j += 1
            y = ys[j] - Q @ (Q.T @ ys[j])
            q = y / np.linalg.norm(y)
            Q = np.hstack([Q, q[:, None]])
            z = A @ draws[:, w_next]
            w_next += 1
            ys.append(z - Q @ (Q.T @ z))
            for i in range(j + 1, j + r):
                ys[i] = ys[i] - q * (q @ ys[i])
            iters += 1
        if iters == max_iters:
            warnings.warn(f"adaptive range finder: no convergence "
                          f"after {iters} iterations")
        return torch.from_numpy(Q).to(self.A.device)


def _row_blocks(A, method: str, host: tuple) -> pmesh._Blocks:
    """A's blocks (``mesh._Blocks``); a DTensor must keep its columns
    whole and take a method that runs on its blocks."""
    B = pmesh._Blocks(A)
    if B.sharded and (B.cols.split or method in host):
        raise errors.NotImplementedYetError(
            f"{method!r} on a DTensor (columns split or a host method) "
            "(ROADMAP A5b)")
    return B


def _qr(B: pmesh._Blocks, Y: torch.Tensor) -> torch.Tensor:
    """Q of the Householder QR of the panel on A's rows whose local rows
    are ``Y``: the reference's QR, which XLA replicates, so a split panel
    is gathered (m × s), factored on every rank, and each keeps its
    rows."""
    return B.rows.take(torch.linalg.qr(B.rows.gather(Y))[0])


def _local_rows(B: pmesh._Blocks, Q):
    """This rank's rows of a basis on A's rows: a DTensor's block, or a
    whole tensor's slice."""
    if pmesh._is_sharded(Q):
        return pmesh._local_block(Q, 0)[0]
    return B.rows.take(as_tensor(Q, B.local.device))


def _row_id(Q: np.ndarray, dtype):
    """Row interpolative decomposition of Q (k columns): (Xr, J) with
    Q ≈ Xr·Q[J, :] (scipy, the reference's routine)."""
    import scipy.linalg.interpolative as sli

    k = Q.shape[1]
    idx, proj = sli.interp_decomp(Q.T.astype(np.float64), k, rand=False)
    Xr = sli.reconstruct_interp_matrix(idx, proj).T.astype(dtype)
    return Xr, idx[:k]


class RangeAssistedSVD:
    """A ≈ U·diag(σ)·Vᵀ given a range basis Q. Methods: ``direct`` (Alg
    5.1, on Q's device), ``row_extraction`` (Alg 5.2, on the host)."""

    args = {"direct": {}, "row_extraction": {}}

    def __init__(self, A, Q, method: str = "direct", params: dict = None,
                 device=None):
        if method not in self.args:
            raise errors.InvalidParametersError(f"unknown method {method!r}")
        self.A = as_tensor(A, device)
        self._B = _row_blocks(self.A, method, ("row_extraction",))
        self.Q = (_local_rows(self._B, Q) if self._B.sharded
                  else as_tensor(Q, self.A.device))
        self.method = method

    @with_solver_precision
    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return getattr(self, f"_{self.method}")()

    def _direct(self):
        B = self._B
        # Qᵀ·A: the ranks' local products, summed
        U, sigma, Vt = torch.linalg.svd(B.rows.sum(self.Q.T @ B.local),
                                        full_matrices=False)
        return B.rows.wrap(self.Q @ U), B.whole(sigma), B.whole(Vt)

    def _row_extraction(self):
        A = self.A.cpu().numpy()
        Xr, J = _row_id(self.Q.cpu().numpy(), A.dtype)
        W, R = np.linalg.qr(A[J, :].T)     # A[J, :] = Rᵀ·Wᵀ
        U, sigma, Vhat_t = np.linalg.svd(Xr @ R.T, full_matrices=False)
        V = W @ Vhat_t.T
        dev = self.A.device
        return (torch.from_numpy(U).to(dev), torch.from_numpy(sigma).to(dev),
                torch.from_numpy(np.ascontiguousarray(V.T)).to(dev))


class RangeAssistedEVD:
    """Symmetric A ≈ U·diag(w)·Uᵀ given a range basis Q. Methods:
    ``direct`` (Alg 5.3), ``row_extraction`` (Alg 5.4, on the host),
    ``nystrom`` (Alg 5.5, PSD A), ``one_pass`` (Alg 5.6, s and a
    context)."""

    args = {"direct": {}, "row_extraction": {}, "nystrom": {},
            "one_pass": {"s": None}}

    def __init__(self, A, Q, method: str = "direct", params: dict = None,
                 context: Optional[Context] = None, device=None):
        if method not in self.args:
            raise errors.InvalidParametersError(f"unknown method {method!r}")
        kwargs = dict(self.args[method])
        kwargs.update(params or {})
        if None in kwargs.values():
            raise errors.InvalidParametersError(
                f"method {method!r} needs {list(kwargs)}")
        if method == "one_pass" and context is None:
            raise errors.InvalidParametersError("one_pass needs a context")
        self.A = as_tensor(A, device)
        self._B = _row_blocks(self.A, method,
                              ("row_extraction", "nystrom", "one_pass"))
        self.Q = (_local_rows(self._B, Q) if self._B.sharded
                  else as_tensor(Q, self.A.device))
        self.method = method
        self.kwargs = kwargs
        self.context = context

    @with_solver_precision
    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, f"_{self.method}")()

    def _direct(self):
        B = self._B
        # Qᵀ·A·Q of a square A split on its rows: A's columns need the
        # whole basis (an all_gather of the n × s panel, not of A)
        AQ = B.mv(B.rows.gather(self.Q))
        w, V = torch.linalg.eigh(B.rows.sum(self.Q.T @ AQ))
        return B.whole(w), B.rows.wrap(self.Q @ V)

    def _row_extraction(self):
        A = self.A.cpu().numpy()
        Xr, J = _row_id(self.Q.cpu().numpy(), A.dtype)
        V, R = np.linalg.qr(Xr)
        Z = R @ A[np.ix_(J, J)] @ R.T      # A ≈ Xr·A[J,J]·Xrᵀ
        w, W = np.linalg.eigh(Z)
        dev = self.A.device
        return torch.from_numpy(w).to(dev), torch.from_numpy(V @ W).to(dev)

    def _nystrom(self):
        B1 = self.A @ self.Q
        B2 = self.Q.T @ B1
        # B2 is singular whenever Q has more columns than rank(A): a
        # trace-scaled jitter keeps the Cholesky finite, as in the
        # reference
        s = B2.shape[0]
        jitter = 1e-6 * (torch.trace(B2) / s + 1e-30)
        C = torch.linalg.cholesky(
            B2 + jitter * torch.eye(s, dtype=B2.dtype, device=B2.device))
        # F = B1·C⁻ᵀ; eigenvalues σ(F)²
        Ft = torch.linalg.solve_triangular(C, B1.T, upper=False)
        U, sigma, _ = torch.linalg.svd(Ft.T, full_matrices=False)
        return sigma**2, U

    def _one_pass(self):
        n = self.A.shape[1]
        S = _normal(self.context.allocate(), n, int(self.kwargs["s"]),
                    self.A.dtype, self.A.device)
        Y = self.Q @ (self.Q.T @ (self.A @ S))
        B = torch.linalg.pinv(S.T @ self.Q) @ (Y.T @ self.Q)
        w, V = torch.linalg.eigh(0.5 * (B.T + B))
        return w, self.Q @ V


def randomized_svd(A, k: int, context: Context, q: int = 1, device=None):
    """Power-iteration range finder (s = 2k) and direct SVD, truncated to
    rank k: (U, σ, Vᵀ)."""
    A = as_tensor(A, device)
    finder = RandomizedRangeFinder(
        A, "power_iteration", {"s": min(2 * k, min(A.shape)), "q": q},
        context, device=A.device)
    U, sigma, Vt = RangeAssistedSVD(A, finder.compute(),
                                    device=A.device).compute()
    if pmesh._is_sharded(A):
        B = pmesh._Blocks(A)
        return (B.rows.wrap(U.to_local()[:, :k]),
                B.whole(sigma.to_local()[:k]), B.whole(Vt.to_local()[:k, :]))
    return U[:, :k], sigma[:k], Vt[:k, :]
