"""The port's mesh-distributed sparse layer against the JAX package's
(ROADMAP A5's explicit half), mirroring tests/test_dist_sparse.py.

One gloo group of CPU processes is spawned for the file
(``torch_dist_worker.run_group``, about 5 s) and runs every case on the
group shapes (2,), (4,), (5,) and (2, 2) — the reference's 1D rows, 1D
cols, 2D grid and ragged-5 layouts — returning each rank's result; every
rank of a mesh must hold the same whole value. The reference's
distributed route compiles a ``shard_map`` per call (2–20 s a call on a
CPU; its own tests of it are marked slow), so
each result is held to the reference's local sparse route, the oracle its
own distributed tests use, and in one case to its distributed route
itself. Limits: CWT and UST ``torch.equal`` where the reference's CPU
scatter adds each output entry's terms in the same order (C4) — UST
always (its entries are copies), CWT where no rank sums another's
partial; everything else ≤ 1e-4·max(1, max|reference|), the reference's
own.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

import torch_dist_worker as W
from libskylark_tpu import parallel as rpar
from libskylark_tpu import sketch as rsk
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu.base.dist_sparse import distribute_sparse as rdistribute
from libskylark_tpu.base.sparse import SparseMatrix as RSparse, spmm, spmm_t

ATOL = 1e-4
RANKS = {"m2": 2, "m4": 4, "m5": 5, "g22": 4}


@pytest.fixture(scope="module")
def ranks():
    return W.run_group("dist_sparse")


def _value(ranks, key):
    """Rank 0's result, after checking that every rank of its mesh holds
    the same array."""
    mesh = key.rsplit("/", 1)[-1].split(":")[0]
    got = ranks[0][key]
    for r in range(1, RANKS.get(mesh, 4)):
        np.testing.assert_array_equal(ranks[r][key], got, err_msg=key)
    return got


def _tag(mname, axes):
    return f"{mname}:{axes.get('row_axis')}:{axes.get('col_axis')}"


def _ref(A) -> RSparse:
    return RSparse.from_scipy(A)


def _close(got, want, key):
    assert got.shape == want.shape, key
    tol = ATOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=key)


def _no_cross_rank_sum(mname, axes, columnwise):
    """True when the sketched axis is not split: no rank adds another
    rank's partial, so each entry sums its terms in the reference's
    order."""
    return axes.get("row_axis" if columnwise else "col_axis") is None


def test_roundtrip_to_local(ranks):
    A = W.rand_sparse(53, 37, seed=1).toarray()
    np.testing.assert_array_equal(_value(ranks, "roundtrip/m2"), A)
    np.testing.assert_array_equal(_value(ranks, "roundtrip/g22"), A)


def test_todense_matches(ranks):
    np.testing.assert_array_equal(_value(ranks, "todense"),
                                  W.rand_sparse(45, 30, seed=2).toarray())


@pytest.mark.parametrize("hw", [(64, 48), (53, 41)])
def test_spmm_oracle(ranks, hw):
    h, w = hw
    want = np.asarray(spmm(_ref(W.rand_sparse(h, w, seed=3)),
                           W.normal((w, 7), 4)))
    for mname, axes in W.GRIDS:
        key = f"spmm/{h}x{w}/{_tag(mname, axes)}"
        _close(_value(ranks, key), want, key)


@pytest.mark.parametrize("hw", [(64, 48), (53, 41)])
def test_spmm_t_oracle(ranks, hw):
    h, w = hw
    want = np.asarray(spmm_t(_ref(W.rand_sparse(h, w, seed=5)),
                             W.normal((h, 5), 6)))
    for mname, axes in W.GRIDS:
        key = f"spmm_t/{h}x{w}/{_tag(mname, axes)}"
        _close(_value(ranks, key), want, key)


def test_spmm_vector(ranks):
    want = np.asarray(spmm(_ref(W.rand_sparse(40, 33, seed=7)),
                           W.normal(33, 8)))
    _close(_value(ranks, "spmm_vector"), want, "spmm_vector")


@pytest.mark.parametrize("fam", ["CWT", "MMT", "WZT"])
def test_hash_columnwise_dist_oracle(ranks, fam):
    T = getattr(rsk, fam)(100, 24, RContext(seed=17))
    want = np.asarray(T.apply(_ref(W.rand_sparse(100, 37, seed=9)),
                              rsk.COLUMNWISE))
    for mname, axes in W.GRIDS:
        key = f"hash_cw/{fam}/{_tag(mname, axes)}"
        got = _value(ranks, key)
        _close(got, want, key)
        if fam == "CWT" and _no_cross_rank_sum(mname, axes, True):
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_cwt_equals_the_reference_distributed_route(ranks, devices):
    """The one case held to the reference's own distributed route: CWT
    columnwise on 2 ranks splitting the columns, bit for bit."""
    mesh = rpar.make_mesh(devices=devices[:2])
    T = rsk.CWT(100, 24, RContext(seed=17))
    D = rdistribute(_ref(W.rand_sparse(100, 37, seed=9)), mesh,
                    col_axis="rows")
    want = np.asarray(T.apply(D, rsk.COLUMNWISE))
    np.testing.assert_array_equal(
        _value(ranks, "hash_cw/CWT/m2:None:rows"), want)


@pytest.mark.parametrize("fam", ["CWT", "MMT"])
def test_hash_rowwise_dist_oracle(ranks, fam):
    T = getattr(rsk, fam)(100, 24, RContext(seed=18))
    want = np.asarray(T.apply(_ref(W.rand_sparse(37, 100, seed=10)),
                              rsk.ROWWISE))
    for mname, axes in W.GRIDS:
        key = f"hash_rw/{fam}/{_tag(mname, axes)}"
        got = _value(ranks, key)
        _close(got, want, key)
        if fam == "CWT" and _no_cross_rank_sum(mname, axes, False):
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("fam", ["JLT", "CT"])
def test_dense_rowwise_dist_oracle(ranks, fam):
    T = getattr(rsk, fam)(300, 16, RContext(seed=19))
    want = np.asarray(T.apply(_ref(W.rand_sparse(29, 300, seed=11)),
                              rsk.ROWWISE))
    for mname, axes in W.DENSE_GRIDS:
        key = f"dense_rw/{fam}/{_tag(mname, axes)}"
        _close(_value(ranks, key), want, key)


def test_dense_columnwise_dist_oracle(ranks):
    T = rsk.JLT(300, 16, RContext(seed=20))
    want = np.asarray(T.apply(_ref(W.rand_sparse(300, 29, seed=12)),
                              rsk.COLUMNWISE))
    for mname, axes in W.DENSE_GRIDS:
        key = f"dense_cw/JLT/{_tag(mname, axes)}"
        _close(_value(ranks, key), want, key)


@pytest.mark.parametrize("cw", [True, False], ids=["columnwise", "rowwise"])
def test_hash_sparse_to_sparse_dist(ranks, cw):
    """The distributed sparse result densifies to the reference's local
    sparse → sparse apply, and stays distributed on the kept axis only."""
    T = rsk.CWT(100, 24, RContext(seed=23))
    A = _ref(W.rand_sparse(*((100, 37) if cw else (37, 100)), seed=14))
    want = T.apply_sparse(A, rsk.COLUMNWISE if cw else rsk.ROWWISE)
    want = want.to_scipy().toarray()
    for mname, axes in W.GRIDS:
        key = f"sparse_to_sparse/{'cw' if cw else 'rw'}/{_tag(mname, axes)}"
        _close(_value(ranks, key), want, key)
        kept = (f"None,{axes.get('col_axis')}" if cw
                else f"{axes.get('row_axis')},None")
        assert str(ranks[0][key + "/axes"]) == kept


def test_hash_sparse_chained(ranks):
    """Chained sparse → sparse applies match the reference's, and each
    rank's cell holds exactly its nonzeros: nothing to compact."""
    T1 = rsk.CWT(120, 64, RContext(seed=41))
    T2 = rsk.CWT(64, 24, RContext(seed=42))
    want = T2.apply_sparse(T1.apply_sparse(
        _ref(W.rand_sparse(120, 33, seed=31)), rsk.COLUMNWISE),
        rsk.COLUMNWISE).to_scipy().toarray()
    _close(_value(ranks, "chained"), want, "chained")
    for r in range(4):
        mid, mid_nz, out, out_nz = ranks[r]["chained/slots"]
        assert mid == mid_nz and out == out_nz


@pytest.mark.parametrize("replace", [True, False], ids=["with", "without"])
def test_ust_dist_oracle(ranks, replace):
    """Row and column sampling of a distributed sparse matrix is the
    local gather, bit for bit (with-replacement duplicates included)."""
    T = rsk.UST(100, 24, RContext(seed=31), replace=replace)
    want = np.asarray(T.apply(_ref(W.rand_sparse(100, 37, seed=21)),
                              rsk.COLUMNWISE))
    wantr = np.asarray(T.apply(_ref(W.rand_sparse(37, 100, seed=22)),
                               rsk.ROWWISE))
    for mname, axes in W.GRIDS:
        tag = _tag(mname, axes)
        np.testing.assert_array_equal(
            _value(ranks, f"ust/{replace}/cw/{tag}"), want, err_msg=tag)
        np.testing.assert_array_equal(
            _value(ranks, f"ust/{replace}/rw/{tag}"), wantr, err_msg=tag)


def test_rft_dist_sparse_oracle(ranks):
    """Random features of a distributed sparse input, both ways."""
    from libskylark_tpu.sketch.rft import GaussianRFT

    T = GaussianRFT(300, 16, RContext(seed=33), sigma=1.5)
    A = W.rand_sparse(29, 300, seed=23)
    want = np.asarray(T.apply(_ref(A), rsk.ROWWISE))
    wantc = np.asarray(T.apply(_ref(A.T.tocsc()), rsk.COLUMNWISE))
    for mname, axes in W.DENSE_GRIDS:
        tag = _tag(mname, axes)
        _close(_value(ranks, f"rft/rw/{tag}"), want, tag)
        _close(_value(ranks, f"rft/cw/{tag}"), wantc, tag)


def test_transpose(ranks):
    np.testing.assert_array_equal(
        _value(ranks, "transpose"), W.rand_sparse(37, 53, seed=15).toarray().T)


def test_approximate_svd_on_dist_sparse(ranks):
    """Randomized SVD of a DistSparseMatrix (never densified) tracks the
    reference's on the dense operand, at the reference test's limits."""
    import jax.numpy as jnp

    from libskylark_tpu.nla.svd import ApproximateSVDParams, approximate_svd

    dense = W.svd_operand()
    Ud, Sd, Vd = approximate_svd(jnp.asarray(dense), 4, RContext(seed=30),
                                 ApproximateSVDParams(num_iterations=2))
    np.testing.assert_allclose(_value(ranks, "svd/S"), np.asarray(Sd),
                               rtol=1e-3, atol=1e-3)
    recd = np.asarray(Ud * Sd[None]) @ np.asarray(Vd).T
    np.testing.assert_allclose(_value(ranks, "svd/rec"), recd, atol=1e-2)


def test_wide_svd_on_dist_sparse(ranks):
    """The wide branch (m < n) through the transposed DistSparseMatrix
    against the reference's on its transposed local operand."""
    from libskylark_tpu.nla.svd import ApproximateSVDParams, approximate_svd

    A = _ref(sp.csc_matrix(W.svd_operand()))
    _, Sw, _ = approximate_svd(A.T, 4, RContext(seed=30),
                               ApproximateSVDParams(num_iterations=2))
    np.testing.assert_allclose(_value(ranks, "svd_wide/S"), np.asarray(Sw),
                               rtol=1e-3, atol=1e-3)


def test_least_squares_on_dist_sparse(ranks):
    """approximate_least_squares of a DistSparseMatrix (its FJLT default
    turns into a CWT, as for a local sparse operand) against the
    reference's on the local operand; LSQR against the reference's on the
    densified operand (its sparse LSQR does not run here, ROADMAP C7),
    iterations within one."""
    from libskylark_tpu import algorithms as ralg, nla as rnla

    A, b = W.ls_operands()
    want = np.asarray(rnla.approximate_least_squares(_ref(A), b,
                                                     RContext(seed=34)))
    _close(_value(ranks, "lstsq"), want, "lstsq")
    xd, itd = ralg.lsqr(np.asarray(A.toarray()), b, ralg.KrylovParams(
        tolerance=1e-6, iter_lim=200))
    _close(_value(ranks, "lsqr"), np.asarray(xd), "lsqr")
    assert abs(int(_value(ranks, "lsqr/iterations")) - int(itd)) <= 1


def test_empty_cells_ok(ranks):
    """A matrix whose nonzeros all lie in one cell: the other ranks'
    cells are empty."""
    want = np.asarray(spmm(_ref(W.empty_cells_operand()),
                           W.normal((40, 3), 13)))
    _close(_value(ranks, "empty_cells"), want, "empty_cells")


class _LocalStandIn:
    """The reference's local products under the interface its
    ``_condest_device`` reads (shape, spmm, spmm_t): its device recurrence
    without a ``shard_map`` compile per product."""

    def __init__(self, A: RSparse):
        self.shape = A.shape
        self.spmm = lambda x: spmm(A, x)
        self.spmm_t = lambda x: spmm_t(A, x)


@pytest.mark.parametrize("mesh", ["m2", "g22"])
def test_condest_device_route(ranks, mesh):
    """condest of a DistSparseMatrix runs the float32 device recurrence
    (the operand is never gathered: the worker disables to_local): within
    1e-4 of the reference's _condest_device over the same operator, and
    within the reference test's 5e-2 of the float64 host estimate."""
    from libskylark_tpu.nla import condest as rce

    A = _ref(sp.csc_matrix(W.condest_operand()))
    want = np.array(rce._condest_device(_LocalStandIn(A), RContext(seed=43),
                                        100, 1e-3))
    got = _value(ranks, f"condest/{mesh}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    host = np.array(rce.condest(A, RContext(seed=43)))
    np.testing.assert_allclose(got, host, rtol=5e-2)
