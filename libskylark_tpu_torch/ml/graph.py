"""Graph algorithms: adjacency spectral embedding and seeded local
community detection by time-dependent personalized PageRank (the port of
libskylark_tpu/ml/graph.py; libSkylark's ml/graph/spectral_embedding.hpp
and local_computations.hpp, the drivers skylark_graph_se and
skylark_community).

The split of the work is the reference's: the spectral embedding is bulk
linear algebra through the randomized symmetric SVD on the operand's
device (a dense adjacency's range sketch takes the dense kernel, B1
rowwise; a sparse one takes the JLT's sparse apply and ``spmm``), while
the time-dependent PPR push over a small active set and the sweep cut
run on the host in numpy. The serve programs ``ase_serve_apply`` and
``ppr_serve_apply`` are the pure per-request functions over CSR lanes,
with eager twins ``graph_ase_serve`` and ``graph_ppr_serve``.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Hashable, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from libskylark_tpu_torch.base import errors, randgen
from libskylark_tpu_torch.base.context import Context, seed_key
from libskylark_tpu_torch.base.device import resolve_device
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.nla.spectral import (chebyshev_diff_matrix,
                                               chebyshev_points)
from libskylark_tpu_torch.nla.svd import (ApproximateSVDParams,
                                          approximate_symmetric_svd)


class Graph:
    """Undirected graph over hashable vertices, in insertion order.
    ``num_edges`` counts both directions of every edge (the graph's
    volume), as the reference does."""

    def __init__(self, edges: Iterable[Tuple[Hashable, Hashable]] = ()):
        self._adj: Dict[Hashable, dict] = {}
        self._num_edges = 0
        for u, v in edges:
            self.add_edge(u, v)

    def add_edge(self, u, v) -> None:
        if u == v:
            return
        nu = self._adj.setdefault(u, {})
        if v in nu:
            return
        nu[v] = None  # a dict as an insertion-ordered set
        self._adj.setdefault(v, {})[u] = None
        self._num_edges += 2

    @property
    def vertices(self) -> list:
        return list(self._adj.keys())

    def num_vertices(self) -> int:
        return len(self._adj)

    def num_edges(self) -> int:
        return self._num_edges

    def degree(self, v) -> int:
        return len(self._adj[v])

    def neighbors(self, v):
        return self._adj[v].keys()

    def has_vertex(self, v) -> bool:
        return v in self._adj

    def adjacency_matrix(self, dtype=np.float32):
        """(A, indexmap): the dense adjacency (numpy) and the vertex of
        each row: :meth:`adjacency_sparse` densified."""
        S, indexmap = self.adjacency_sparse(dtype)
        return S.to_scipy().toarray(), indexmap

    def adjacency_sparse(self, dtype=np.float32):
        """(A, indexmap): the CSC adjacency and the vertex of each row."""
        indexmap = self.vertices
        index = {v: i for i, v in enumerate(indexmap)}
        deg = np.fromiter((len(nb) for nb in self._adj.values()),
                          dtype=np.int64, count=len(indexmap))
        rows = np.repeat(np.arange(len(indexmap), dtype=np.int64), deg)
        cols = np.fromiter((index[v] for nb in self._adj.values()
                            for v in nb), dtype=np.int64, count=len(rows))
        n = len(indexmap)
        return SparseMatrix.from_coo(rows, cols, np.ones(len(rows), dtype),
                                     (n, n)), indexmap


def approximate_ase(G: Graph, k: int, context: Context,
                    params: Optional[ApproximateSVDParams] = None,
                    sparse: Optional[bool] = None, device=None):
    """Approximate adjacency spectral embedding X = V·√|Λ| from the
    randomized symmetric eigendecomposition of the adjacency: (X,
    indexmap), X (n, k) on ``device``. ``sparse`` keeps the CSC adjacency
    (default: past 2048 vertices)."""
    if sparse is None:
        sparse = len(G.vertices) > 2048
    if sparse:
        A, indexmap = G.adjacency_sparse()
    else:
        Ad, indexmap = G.adjacency_matrix()
        A = torch.from_numpy(Ad).to(resolve_device(device))
    V, w = approximate_symmetric_svd(A, k, context, params, device=device)
    return V * torch.sqrt(torch.abs(w))[None, :], indexmap


# ---------------------------------------------------------------------------
# Time-dependent PPR (Avron & Horesh, "Community Detection Using
# Time-Dependent PageRank"): the host push algorithm.
# ---------------------------------------------------------------------------

_N_CACHE: Dict[Tuple[float, float], int] = {}
_D_CACHE: Dict[Tuple[int, float], Tuple[np.ndarray, np.ndarray]] = {}


def _min_chebyshev_order(epsilon: float, gamma: float) -> int:
    """The smallest discretization order meeting the Bessel-tail error
    bound."""
    key = (epsilon, gamma)
    if key not in _N_CACHE:
        from scipy.special import iv

        minN = 10
        C = 20.0 * math.exp(-gamma / 2.0)
        while (C * math.sqrt(minN) * iv(minN, gamma) * 0.8**minN
               > epsilon / (gamma * (1 + (2 / math.pi)
                                     * math.log(minN - 1)))):
            minN += 1
        _N_CACHE[key] = minN
    return _N_CACHE[key]


def _diffusion_matrix(N: int, gamma: float) -> Tuple[np.ndarray, np.ndarray]:
    """The push step's matrix D from the QR of (D_cheb + I): its top N−1
    rows apply R₁⁻¹Q₁ᵀ (the least-squares solve), its last row is Q's
    last column q (the residual direction). Returns (D, q)."""
    key = (N, gamma)
    if key not in _D_CACHE:
        from scipy.linalg import solve_triangular

        D0, _ = chebyshev_diff_matrix(N, 0.0, gamma)
        Q, R = np.linalg.qr(D0 + np.eye(N))
        q = Q[:, N - 1].copy()
        D = np.empty((N, N))
        D[N - 1, :] = q
        D[: N - 1, :] = solve_triangular(R[: N - 1, : N - 1],
                                         Q[:, : N - 1].T)
        _D_CACHE[key] = (D, q)
    return _D_CACHE[key]


def time_dependent_ppr(G: Graph, s: Dict[Hashable, float],
                       alpha: float = 0.85, gamma: float = 5.0,
                       epsilon: float = 0.001, NX: int = 4):
    """Localized time-dependent personalized PageRank. ``s`` maps seed
    vertices to weights. Returns (y, x): ``y`` maps each touched vertex to
    its NX diffusion values at the time samples ``x`` (descending
    Chebyshev samples in [0, gamma])."""
    minN = _min_chebyshev_order(epsilon, gamma)
    N = minN if minN % NX == 0 else (minN // NX + 1) * NX
    NR = N // NX

    D, q = _diffusion_matrix(N, gamma)
    x = chebyshev_points(N, 0.0, gamma)[np.arange(NX) * NR].copy()

    # the push threshold of a node: C·deg
    LC = 1 + (2 / math.pi) * math.log(N - 1)
    if alpha < 1:
        C = (1 - alpha) * epsilon / ((1 - math.exp((alpha - 1) * gamma))
                                     * LC)
    else:
        C = epsilon / (gamma * LC)

    # per node: [r (N), y (NX)] and an in-queue flag
    rymap: Dict[Hashable, np.ndarray] = {}
    inq: Dict[Hashable, bool] = {}
    violating = deque()

    def _entry(node):
        if node not in rymap:
            rymap[node] = np.zeros(N + NX)
            inq[node] = False
        return rymap[node]

    for node, v in s.items():
        if not G.has_vertex(node):
            raise errors.InvalidParametersError(f"seed {node!r} not in graph")
        ry = _entry(node)
        ry[:N] = -alpha * v
        ry[N:] = v
        inq[node] = True
        violating.append(node)
    for node in s:
        for onode in G.neighbors(node):
            _entry(onode)
    for node in s:
        v = alpha * rymap[node][N] / G.degree(node)
        for onode in G.neighbors(node):
            ro = rymap[onode]
            ro[:N] += v
            if not inq[onode] and np.any(np.abs(ro[:N])
                                         > C * G.degree(onode)):
                violating.append(onode)
                inq[onode] = True

    while violating:
        node = violating.popleft()
        ry = rymap[node]
        dyp = D @ ry[:N]
        ry[N:] += dyp[np.arange(NX) * NR]
        ry[:N] = dyp[N - 1] * q
        inq[node] = False

        c = alpha / G.degree(node)
        for onode in G.neighbors(node):
            ryo = _entry(onode)
            ryo[: N - 1] += c * dyp[: N - 1]
            if not inq[onode]:
                B = C * G.degree(onode)
                if np.any(np.abs(ryo[: N - 1]) > B) or abs(ryo[N - 1]) > B:
                    violating.append(onode)
                    inq[onode] = True

    y = {node: ry[N:].copy() for node, ry in rymap.items() if ry[N] != 0}
    return y, x


def find_local_cluster(G: Graph, seeds: Iterable[Hashable],
                       alpha: float = 0.85, gamma: float = 5.0,
                       epsilon: float = 0.001, NX: int = 4,
                       recursive: bool = False) -> Tuple[Set, float]:
    """Seeded community detection: the sweep cut of least conductance
    over the TD-PPR diffusion. Returns (cluster, conductance)."""
    currentcond = -1.0
    cluster: Set = set(seeds)
    Gvol = G.num_edges()

    while True:
        s = {v: 1.0 / len(cluster) for v in cluster}
        y, _ = time_dependent_ppr(G, s, alpha, gamma, epsilon, NX)

        improve = False
        for t in range(NX):
            # sweep order: descending degree-normalized diffusion
            vals = sorted(((-yv[t] / G.degree(node), node)
                           for node, yv in y.items()),
                          key=lambda sv: sv[0])
            volS, cutS = 0, 0
            bestcond, bestprefix = 1.0, 0
            currentset: Set = set()
            for i, (_, node) in enumerate(vals):
                volS += G.degree(node)
                for onode in G.neighbors(node):
                    cutS += -1 if onode in currentset else 1
                denom = min(volS, Gvol - volS)
                condS = cutS / denom if denom > 0 else 1.0
                if condS < bestcond:
                    bestcond, bestprefix = condS, i
                currentset.add(node)

            if currentcond == -1 or bestcond < 0.999999 * currentcond:
                improve = True
                cluster = {node for _, node in vals[: bestprefix + 1]}
                currentcond = bestcond

        if not (recursive and improve):
            break

    return cluster, currentcond


# ---------------------------------------------------------------------------
# Serve programs over CSR lanes, and their eager twins
# ---------------------------------------------------------------------------


def ase_serve_apply(key_data, data: torch.Tensor, indices: torch.Tensor,
                    indptr: torch.Tensor, *, k: int, iters: int,
                    shape) -> torch.Tensor:
    """One request's adjacency spectral embedding X = V·√|w| from its raw
    key and its padded CSR lanes: the exact densify, ``iters`` rounds of
    QR subspace iteration from a key-derived Gaussian block
    (``Normal().sample(key, (n, k))``), then the k × k Rayleigh–Ritz
    eigendecomposition, dominant |eigenvalue| first. Rows past the true
    n are exact zeros."""
    from libskylark_tpu_torch.sketch.sparse_serve import scatter_dense

    A = scatter_dense(data, indices, indptr, shape=tuple(shape))
    Omega = randgen.Normal().sample(key_data, (A.shape[1], int(k)),
                                    device=A.device).to(A.dtype)
    Q = torch.linalg.qr(A @ Omega)[0]
    for _ in range(max(int(iters), 1) - 1):
        Q = torch.linalg.qr(A @ Q)[0]
    B = Q.T @ (A @ Q)
    w, U = torch.linalg.eigh(0.5 * (B + B.T))
    order = torch.argsort(-torch.abs(w), stable=True)
    return (Q @ U[:, order]) * torch.sqrt(torch.abs(w[order]))[None, :]


def ppr_serve_apply(data: torch.Tensor, indices: torch.Tensor,
                    indptr: torch.Tensor, s: torch.Tensor, *, alpha: float,
                    iters: int, shape) -> torch.Tensor:
    """One request's personalized PageRank by ``iters`` power steps over
    the CSR adjacency, p ← (1 − α)·s + α·W·p with W the degree-normalized
    walk matrix. Padded coordinates have degree 0 and score exactly 0."""
    from libskylark_tpu_torch.sketch.sparse_serve import scatter_dense

    A = scatter_dense(data, indices, indptr, shape=tuple(shape))
    deg = torch.sum(A, dim=0)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    inv_deg = torch.where(deg > 0, one / torch.clamp_min(deg, 1e-30),
                          torch.zeros((), dtype=A.dtype, device=A.device))
    s = s / torch.clamp_min(torch.sum(s), 1e-30)
    p = s
    for _ in range(max(int(iters), 1)):
        p = (1.0 - alpha) * s + alpha * (A @ (p * inv_deg))
    return p


def coerce_adjacency(A, dtype=np.float32):
    """(SparseMatrix adjacency, indexmap or None) from a :class:`Graph`, a
    SparseMatrix, a scipy sparse matrix or a dense square array."""
    if isinstance(A, Graph):
        return A.adjacency_sparse(dtype)
    if isinstance(A, SparseMatrix):
        S = A
    else:
        import scipy.sparse as sp

        S = SparseMatrix.from_scipy(
            A if sp.issparse(A)
            else sp.csr_matrix(np.asarray(A, dtype=dtype)))
    if S.height != S.width:
        raise errors.InvalidParametersError(
            f"adjacency must be square, got {S.shape}")
    return S, None


def _eager_csr_endpoint(S: SparseMatrix, dtype, fn, *, seed: int,
                        device=None) -> np.ndarray:
    """Pack ``S`` as the serve layer packs a CSR request (pow2-padded
    extent, pow2 nnz class, indptr padded with the true nnz) and run
    ``fn(key_data, (data, indices, indptr), shape)`` on ``device``; the
    result comes back to the host."""
    from libskylark_tpu_torch.engine import bucket as bucketing
    from libskylark_tpu_torch.engine.serve import (SPARSE_NNZ_FLOOR,
                                                   MicrobatchExecutor)

    dev = resolve_device(device)
    shape = bucketing.pad_shape(S.shape, (0, 1))
    nnz_cls = bucketing.nnz_class(S.nnz, SPARSE_NNZ_FLOOR)
    lanes = MicrobatchExecutor._pack_csr(S, shape[0], nnz_cls,
                                         np.dtype(dtype))
    lanes = tuple(torch.from_numpy(x).to(dev) for x in lanes)
    return fn(seed_key(int(seed)), lanes, shape).cpu().numpy()


def graph_ase_serve(A, k: int, *, seed: int = 0, iters: int = 2,
                    dtype=np.float32, device=None):
    """Eager twin of the graph-ASE serve endpoint: the adjacency padded to
    its pow2 class through :func:`ase_serve_apply`, key ``key(seed)``.
    ``A`` is a :class:`Graph`, a SparseMatrix or anything scipy-sparse
    coercible. Returns the (n, k) embedding on the host (and the index map
    for a :class:`Graph`)."""
    S, indexmap = coerce_adjacency(A, dtype)
    X = _eager_csr_endpoint(
        S, dtype,
        lambda kd, lanes, shape: ase_serve_apply(
            kd, *lanes, k=int(k), iters=int(iters), shape=shape),
        seed=seed, device=device)[: S.height, :]
    return (X, indexmap) if indexmap is not None else X


def graph_ppr_serve(A, s, *, alpha: float = 0.85, iters: int = 16,
                    dtype=np.float32, device=None):
    """Eager twin of the graph-PPR serve endpoint (the contract of
    :func:`graph_ase_serve`). ``s`` is the (n,) personalization vector in
    adjacency row order."""
    S, indexmap = coerce_adjacency(A, dtype)
    s = np.asarray(s, dtype=dtype)
    if s.shape != (S.height,):
        raise errors.InvalidParametersError(
            f"personalization vector shape {s.shape} != ({S.height},)")

    def run(kd, lanes, shape):
        sp = torch.from_numpy(np.pad(s, (0, shape[0] - S.height))).to(
            lanes[0].device)
        return ppr_serve_apply(*lanes, sp, alpha=float(alpha),
                               iters=int(iters), shape=shape)

    p = _eager_csr_endpoint(S, dtype, run, seed=0, device=device)[: S.height]
    return (p, indexmap) if indexmap is not None else p
