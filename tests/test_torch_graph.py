"""The port's graph algorithms (ml/graph.py) against the JAX package's, on
the CPU, on the same edges (a planted two-community graph, the reference
tests' model, and a small R-MAT graph with hubs). Bounds: Graph queries
and adjacency equal; approximate_ase on both routes within 1e-4 · max|X|
after aligning column signs; time_dependent_ppr within 1e-12 (host
float64 in both) and find_local_cluster the same set and conductance;
the serve programs within 1e-4 · max. The cases mirror
tests/test_ml_graph.py.
"""

import numpy as np
import pytest
import torch

from libskylark_tpu import ml as jml
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.nla.svd import ApproximateSVDParams as JParams
from libskylark_tpu_torch import interop, ml
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.base.sparse import SparseMatrix
from libskylark_tpu_torch.nla.svd import ApproximateSVDParams

TOL = 1e-4


def _two_blocks(n_per=30, p_in=0.5, p_out=0.04, seed=0):
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            same = (i < n_per) == (j < n_per)
            if rng.random() < (p_in if same else p_out):
                edges.append((i, j))
    return edges


def _rmat(scale=9, factor=8, seed=1):
    rng = np.random.default_rng(seed)
    m = factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(scale):
        u = rng.random(m)
        src |= (u >= 0.76).astype(np.int64) << level
        dst |= (((u >= 0.57) & (u < 0.76)) | (u >= 0.95)).astype(
            np.int64) << level
    return list(zip(src.tolist(), dst.tolist()))


GRAPHS = {"blocks": _two_blocks, "rmat": _rmat}


def _pair(name):
    edges = GRAPHS[name]()
    return jml.Graph(edges), ml.Graph(edges)


def _aligned_err(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    return np.abs(got * s - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_queries_and_adjacency_equal(name):
    jG, G = _pair(name)
    assert G.vertices == jG.vertices
    assert G.num_vertices() == jG.num_vertices()
    assert G.num_edges() == jG.num_edges()
    for v in G.vertices[:50]:
        assert G.degree(v) == jG.degree(v)
        assert list(G.neighbors(v)) == list(jG.neighbors(v))
        assert G.has_vertex(v)
    assert not G.has_vertex(-1)
    A, idx = G.adjacency_matrix()
    Aj, idxj = jG.adjacency_matrix()
    assert idx == idxj and np.array_equal(A, Aj)
    S, _ = G.adjacency_sparse()
    Sj, _ = jG.adjacency_sparse()
    assert (S.to_scipy() != Sj.to_scipy()).nnz == 0


def test_no_self_loops_no_duplicates():
    G = ml.Graph([(0, 0), (0, 1), (1, 0), (1, 2)])
    assert G.num_edges() == 4 and G.degree(1) == 2


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("sparse", [False, True])
def test_approximate_ase_matches_reference(name, sparse):
    jG, G = _pair(name)
    want, jidx = jml.approximate_ase(jG, 3, JContext(5),
                                     JParams(num_iterations=3), sparse=sparse)
    got, idx = ml.approximate_ase(G, 3, Context(5),
                                  ApproximateSVDParams(num_iterations=3),
                                  sparse=sparse, device="cpu")
    assert idx == jidx and tuple(got.shape) == (len(idx), 3)
    assert _aligned_err(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("alpha,gamma", [(0.85, 5.0), (1.0, 3.0)])
def test_time_dependent_ppr_matches_reference(name, alpha, gamma):
    jG, G = _pair(name)
    seeds = {G.vertices[0]: 0.5, G.vertices[3]: 0.5}
    want, xw = jml.time_dependent_ppr(jG, seeds, alpha, gamma)
    got, x = ml.time_dependent_ppr(G, seeds, alpha, gamma)
    assert np.abs(x - xw).max() <= 1e-12
    assert set(got) == set(want)
    assert max(np.abs(got[v] - want[v]).max() for v in want) <= 1e-12


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("recursive", [False, True])
def test_find_local_cluster_matches_reference(name, recursive):
    jG, G = _pair(name)
    for seed in G.vertices[:3]:
        want = jml.find_local_cluster(jG, [seed], recursive=recursive)
        got = ml.find_local_cluster(G, [seed], recursive=recursive)
        assert got[0] == want[0] and got[1] == want[1]


def test_seed_not_in_graph_raises():
    G = ml.Graph([(0, 1)])
    with pytest.raises(errors.InvalidParametersError):
        ml.time_dependent_ppr(G, {99: 1.0})


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ase_serve_matches_reference(name):
    jG, G = _pair(name)
    want, jidx = jml.graph.graph_ase_serve(jG, 4, seed=3, iters=3)
    got, idx = ml.graph.graph_ase_serve(G, 4, seed=3, iters=3,
                                        device="cpu")
    assert idx == jidx and got.shape == want.shape
    assert _aligned_err(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ppr_serve_matches_reference(name):
    jG, G = _pair(name)
    s = np.zeros(G.num_vertices(), np.float32)
    s[[0, 5]] = 1.0
    want, _ = jml.graph.graph_ppr_serve(jG, s, alpha=0.8, iters=12)
    got, _ = ml.graph.graph_ppr_serve(G, s, alpha=0.8, iters=12,
                                      device="cpu")
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_serve_apply_pads_with_exact_zeros():
    _, G = _pair("blocks")
    S, _ = G.adjacency_sparse()
    X = ml.graph.graph_ase_serve(S, 3, device="cpu")
    assert X.shape == (G.num_vertices(), 3)
    from libskylark_tpu_torch.engine import bucket
    from libskylark_tpu_torch.engine.serve import MicrobatchExecutor

    shape = bucket.pad_shape(S.shape, (0, 1))
    lanes = MicrobatchExecutor._pack_csr(S, shape[0], bucket.nnz_class(
        S.nnz), np.dtype(np.float32))
    lanes = [torch.from_numpy(x) for x in lanes]
    full = ml.graph.ase_serve_apply(np.array([0, 0], np.uint32), *lanes,
                                    k=3, iters=2, shape=shape)
    assert bool((full[S.height:] == 0).all())


@pytest.mark.parametrize("make", ["scipy", "dense", "sparse"])
def test_coerce_adjacency_takes_every_operand_kind(make):
    import scipy.sparse as sp

    _, G = _pair("blocks")
    S, _ = G.adjacency_sparse()
    A = {"scipy": S.to_scipy(), "dense": S.to_scipy().toarray(),
         "sparse": S}[make]
    got, index = ml.graph.coerce_adjacency(A)
    assert index is None and (got.to_scipy() != S.to_scipy()).nnz == 0
    with pytest.raises(errors.InvalidParametersError):
        ml.graph.coerce_adjacency(sp.csr_matrix(np.ones((2, 3))))
    with pytest.raises(errors.InvalidParametersError):
        ml.graph.graph_ppr_serve(S, np.ones(3), device="cpu")


def test_graph_from_reference_carries_order_and_edges():
    jG, _ = _pair("rmat")
    G = interop.graph_from_reference(jG)
    assert G.vertices == jG.vertices and G.num_edges() == jG.num_edges()
    assert all(list(G.neighbors(v)) == list(jG.neighbors(v))
               for v in G.vertices)
    seed = G.vertices[2]
    assert ml.find_local_cluster(G, [seed]) == jml.find_local_cluster(
        jG, [seed])
    A, _ = G.adjacency_matrix()
    assert np.array_equal(A, jG.adjacency_matrix()[0])


def test_sparse_matrix_adjacency_is_the_port_container():
    _, G = _pair("blocks")
    S, index = G.adjacency_sparse()
    assert isinstance(S, SparseMatrix) and len(index) == S.height
