"""The port's mesh-sharded dense operands (DTensors) against the JAX
package's local route (ROADMAP A5b): the sketches, CholeskyQR2, the SVD,
the Krylov solvers, the range finders, krank's SVD, LOBPCG and the
dominant-subspace basis.

One gloo group of five CPU processes is spawned for the file
(``torch_dist_worker.run_group("sharded")``, about 20 s); it runs every
case on meshes of 1, 2, 4 and 5 ranks and the 2 × 2 grid and hands back
each rank's whole result and the collectives each case issued. Every rank
of a mesh must hold the same bytes. Each result is held to the JAX
package's local route on the same seed at the tolerance of the reference's
own sharded test: the transforms ``max(1e-4, atol)`` of
``TestShardedOracle`` (tests/test_sketch_core.py:38-99), FJLT 1e-4
(test_sketch_fast.py:136), CholeskyQR2 1e-4 / 1e-3 (test_tsqr.py:46), the
SVD's reconstruction (test_nla.py:77), the Krylov solutions 1e-4
(test_krylov_sharded.py), and the range finder, krank, LOBPCG and the
dominant subspace by test_nla_extras_sharded.py's measures.

Each case's collectives are asserted: the port's own count
(``parallel.mesh.collectives``: all_reduce, all_gather, all_to_all) must
be the list the design gives, and torch's CommDebugMode must see no
other (a DTensor op that inserted a gather would show there). No tall
operand is ever gathered.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from libskylark_tpu import nla as rnla, sketch as rsk
from libskylark_tpu.algorithms import krylov as rkrylov
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu.nla.krank import RandomizedRangeFinder, randomized_svd
from libskylark_tpu.nla.lowrank import approximate_dominant_subspace_basis
from libskylark_tpu.nla.randlobpcg import lobpcg_rand_evd
from libskylark_tpu.nla.tsqr import cholesky_qr2

RANKS = {"m1": 1, "m2": 2, "m4": 4, "m5": 5, "g22": 4}
# mesh dimensions of more than one rank that split a row_sharded operand's
# rows (each carries one all_reduce of a contraction over them)
ROW_SPLIT = {"m1": 0, "m2": 1, "m4": 1, "m5": 1, "g22": 2}


@pytest.fixture(scope="module")
def ranks():
    return W.run_group("sharded")


def _value(ranks, key, mname):
    """Rank 0's result, after checking every rank of the mesh returned the
    same bytes."""
    got = ranks[0][key]
    for r in range(1, RANKS[mname]):
        np.testing.assert_array_equal(ranks[r][key], got, err_msg=key)
    return got


def _collectives(ranks, key, mname, all_reduce=0, all_gather=0,
                 all_to_all=0):
    got = _value(ranks, key + "/counts", mname)
    want = [all_reduce, all_gather, all_to_all]
    assert list(got[:3]) == want, (key, got)
    # CommDebugMode saw exactly the port's own collectives
    assert got[3] == sum(want), (key, got)


def _sketch_split(layout, mname):
    """Mesh dimensions of more than one rank that split the sketched
    axis."""
    if mname == "g22":
        return {"cw_rows": 2, "rw_grid": 1, "rw_cols": 2}[layout]
    return 0 if layout == "rw_grid" or mname == "m1" else 1


@functools.lru_cache(maxsize=None)
def _ref_apply(name, rowwise):
    T = W.make_transform(rsk, name, RContext(seed=7))
    X = jnp.asarray(W.transform_operand(rowwise))
    return np.asarray(T.apply(X, rsk.ROWWISE if rowwise else rsk.COLUMNWISE))


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
@pytest.mark.parametrize("layout", sorted(W.LAYOUTS))
@pytest.mark.parametrize("name", list(W.TRANSFORMS))
def test_transform_matches_the_local_route(ranks, name, layout, mname):
    """T.apply of a DTensor, sketched axis split (partial, all_reduce,
    epilogue; FJLT: one all-to-all) or whole (each rank's block by the
    one-process route), against the reference's local apply."""
    key = f"{name}/{layout}/{mname}"
    got = _value(ranks, key, mname)
    want = _ref_apply(name, W.LAYOUTS[layout][0])
    tol = max(1e-4, W.TRANSFORMS[name])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=key)
    split = _sketch_split(layout, mname)
    if name == "FJLT":
        _collectives(ranks, key, mname, all_to_all=int(split > 0))
    else:
        _collectives(ranks, key, mname, all_reduce=split)


def test_every_wrapper_refuses_a_dtensor(ranks):
    """A DTensor's own data_ptr() is 0: every kernel wrapper and the
    launch gate raise TypeError naming ``to_local()`` (CPU check path)."""
    gates = {k: str(v) for k, v in ranks[0].items() if k.startswith("gate/")}
    assert len(gates) == 11
    assert all(v == "TypeError" for v in gates.values()), gates


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_cholesky_qr2_matches_the_local_route(ranks, mname):
    """Q Shard(0), R Replicate(): two k × k Gram all_reduces, no gather
    (the reference's tests/test_tsqr.py:58 tolerances)."""
    Q0, R0 = cholesky_qr2(jnp.asarray(W.tsqr_panel()))
    Q = _value(ranks, f"cqr2/{mname}/Q", mname)
    R = _value(ranks, f"cqr2/{mname}/R", mname)
    np.testing.assert_allclose(Q, np.asarray(Q0), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(R, np.asarray(R0), atol=1e-3, rtol=1e-3)
    _collectives(ranks, f"cqr2/{mname}", mname,
                 all_reduce=2 * ROW_SPLIT[mname])


# all_reduce, all_gather per row-splitting dimension at q = 2: cqr2 of the
# range sketch (2), per power iteration Aᵀ·Q and cqr2 (3 each), Bᵀ = Aᵀ·Q
# (1); ortho="qr" gathers the panel instead of each cqr2; the wide operand
# sums its sketch (1), A·X per iteration (1 each) and cqr2 of Bᵀ (2)
SVD_COLLECTIVES = {"svd": (9, 0), "svd_qr": (3, 3), "svd_wide": (5, 0)}


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
@pytest.mark.parametrize("case", sorted(SVD_COLLECTIVES))
def test_approximate_svd_matches_the_local_route(ranks, case, mname):
    """U Shard(0), σ and V Replicate(): the reconstruction within 1e-3 of
    ‖A‖ (tests/test_nla.py:77) and σ within 1e-3 of the reference's local
    σ, with the collectives of its design and no gather of A."""
    A = W.lowrank(256, 64, 4, 6)
    A = A.T if case == "svd_wide" else A
    ortho = "qr" if case == "svd_qr" else "cqr2"
    _, S0, _ = rnla.approximate_svd(
        jnp.asarray(A), 4, RContext(seed=17),
        rnla.ApproximateSVDParams(num_iterations=W.SVD_Q, ortho=ortho))
    rec = _value(ranks, f"{case}/{mname}/rec", mname)
    S = _value(ranks, f"{case}/{mname}/S", mname)
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-3
    np.testing.assert_allclose(S, np.asarray(S0), rtol=1e-3)
    ar, ag = SVD_COLLECTIVES[case]
    _collectives(ranks, f"{case}/{mname}", mname,
                 all_reduce=ar * ROW_SPLIT[mname],
                 all_gather=ag * ROW_SPLIT[mname])


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_lsqr_matches_the_local_route(ranks, mname):
    """B and U on the ranks' rows, V and X whole: per iteration one
    all_reduce of Aᵀ·U and one of U's column norms (two at the start),
    never a gather (tests/test_krylov_sharded.py)."""
    A, B = W.lsqr_problem()
    X0, _ = rkrylov.lsqr(jnp.asarray(A), jnp.asarray(B),
                         rkrylov.KrylovParams(tolerance=1e-8, iter_lim=200))
    X = _value(ranks, f"lsqr/{mname}/X", mname)
    it = int(_value(ranks, f"lsqr/{mname}/it", mname))
    np.testing.assert_allclose(X, np.asarray(X0), atol=1e-4, rtol=1e-4)
    _collectives(ranks, f"lsqr/{mname}", mname,
                 all_reduce=(2 + 2 * it) * ROW_SPLIT[mname])


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
@pytest.mark.parametrize("case", ["cg", "fcg", "cheb"])
def test_spd_solvers_match_the_local_route(ranks, case, mname):
    """CG, flexible CG and Chebyshev on a row-sharded SPD A: every vector
    whole, each product A_loc·P and one all_gather of the (n × k) result
    (and one of B), A itself never gathered."""
    seed = {"cg": 1, "fcg": 4, "cheb": 5}[case]
    A, B = W.spd(seed=seed)
    if case == "cheb":
        w = np.linalg.eigvalsh(A)
        X0, _ = rkrylov.chebyshev(
            jnp.asarray(A), jnp.asarray(B), float(w[0]) * 0.9,
            float(w[-1]) * 1.1, rkrylov.KrylovParams(iter_lim=W.CHEB_ITERS))
        X = _value(ranks, f"cheb/{mname}", mname)
        products = W.CHEB_ITERS
    else:
        fn = rkrylov.cg if case == "cg" else rkrylov.flexible_cg
        X0, _ = fn(jnp.asarray(A), jnp.asarray(B),
                   rkrylov.KrylovParams(tolerance=1e-10, iter_lim=300))
        X = _value(ranks, f"{case}/{mname}/X", mname)
        products = 1 + int(_value(ranks, f"{case}/{mname}/it", mname))
    np.testing.assert_allclose(X, np.asarray(X0), atol=1e-4, rtol=1e-4)
    _collectives(ranks, f"{case}/{mname}", mname,
                 all_gather=(products + 1) * ROW_SPLIT[mname])


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_range_finder_matches_the_local_route(ranks, mname):
    """power_iteration (s = 8, q = 1): the reconstruction Q·Qᵀ·A within
    1e-3 of the local one (test_nla_extras_sharded.py:40); one all_reduce
    (Aᵀ·Y) and the replicated Householder QR's gather of the (m × 8)
    panel."""
    A = W.extras_operand()
    Q0 = np.asarray(RandomizedRangeFinder(
        jnp.asarray(A), "power_iteration", {"s": 8, "q": 1},
        RContext(seed=21)).compute())
    Q = _value(ranks, f"range_finder/{mname}", mname)
    rec0, rec = Q0 @ (Q0.T @ A), Q @ (Q.T @ A)
    nrm = np.linalg.norm(A)
    assert np.linalg.norm(rec - rec0) / nrm < 1e-3
    assert np.linalg.norm(A - rec0) / nrm < 1e-2
    _collectives(ranks, f"range_finder/{mname}", mname,
                 all_reduce=ROW_SPLIT[mname], all_gather=ROW_SPLIT[mname])


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_krank_randomized_svd_matches_the_local_route(ranks, mname):
    """krank.randomized_svd (rank 6, q = 1): the leading σ within 1e-4 /
    1e-3, all within 1e-3 / 3e-2 (test_nla_extras_sharded.py:63)."""
    _, S0, _ = randomized_svd(jnp.asarray(W.extras_operand()), 6,
                              RContext(seed=22), q=1)
    S = _value(ranks, f"krank_svd/{mname}", mname)
    S0 = np.asarray(S0)
    np.testing.assert_allclose(S[:4], S0[:4], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(S, S0, atol=1e-3, rtol=3e-2)
    _collectives(ranks, f"krank_svd/{mname}", mname,
                 all_reduce=2 * ROW_SPLIT[mname],
                 all_gather=ROW_SPLIT[mname])


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_lobpcg_rand_evd_matches_the_local_route(ranks, mname):
    """lobpcg_rand_evd (CWT, k = 4, s = 128): the sketch by the split
    axis's route, AᵀA·x by the ranks' rows and one all_reduce a product;
    every rank the same eigenvalues, within atol 1e-4 / rtol 1e-2 of the
    local ones and 5e-2 of the spectrum (test_nla_extras_sharded.py:76)."""
    lam0, _ = lobpcg_rand_evd(jnp.asarray(W.extras_operand()), 4,
                              RContext(seed=23), s=128)
    lam = _value(ranks, f"lobpcg/{mname}", mname)
    np.testing.assert_allclose(lam, np.asarray(lam0), atol=1e-4, rtol=1e-2)
    np.testing.assert_allclose(np.sort(lam)[::-1],
                               (0.7 ** np.arange(4)) ** 2, rtol=5e-2)
    counts = _value(ranks, f"lobpcg/{mname}/counts", mname)
    split = ROW_SPLIT[mname]
    assert counts[1] == counts[2] == 0 and counts[3] == counts[0]
    assert counts[0] >= 2 * split and counts[0] % max(split, 1) == 0


@pytest.mark.parametrize("mname", W.SHARDED_MESHES)
def test_dominant_subspace_matches_the_local_route(ranks, mname):
    """approximate_dominant_subspace_basis (k = 4, s = 16, t = 24): Z
    within 1e-4 (test_nla_extras_sharded.py:88); the QR's gather of the
    (m × 16) sketch and one all_reduce of Uᵀ·Y."""
    Z0, _, _, _ = approximate_dominant_subspace_basis(
        jnp.asarray(W.extras_operand()), k=4, s=16, t=24,
        context=RContext(seed=24))
    Z = _value(ranks, f"lowrank/{mname}", mname)
    np.testing.assert_allclose(Z, np.asarray(Z0), atol=1e-4, rtol=1e-4)
    _collectives(ranks, f"lowrank/{mname}", mname,
                 all_reduce=ROW_SPLIT[mname], all_gather=ROW_SPLIT[mname])
