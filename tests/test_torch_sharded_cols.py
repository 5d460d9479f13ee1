"""The port's DTensor routes for operands whose columns (features, or the
sketched axis) are split, against the JAX package's local route: the
split-axis applies of Fastfood, RFUT, QRFT and PPT, CholeskyQR2,
``linear_ops``, the Krylov solvers, the kernels' Gram matrices, KRR,
Block-ADMM, LOBPCG and the sketched power EVD, krank's finders and
variants, the dominant subspace, the SVD and the symmetric SVD.

One gloo group of five CPU processes is spawned for the file
(``torch_dist_worker.run_group("sharded_cols")``, about 20 s). Its meshes
are 1, 2, 4 and 5 ranks, the 2 × 2 grid of ``parallel.make_mesh`` and a
2 × 2 grid of torch's ``init_device_mesh`` (which has no group of
make_mesh's own: the exchange takes its flattened mesh's group). Each
operand is laid out ``col_sharded`` on every mesh and ``grid2d`` (rows and
columns split) on the grids; each transform is applied with its sketched
axis split (columnwise on split rows, rowwise on split columns or on the
grid). Every rank of a mesh must hold the same bytes, and each result is
held to the reference's local route on the same seed at the reference's
own sharded tolerances: the transforms ``max(1e-4, atol)`` of
``TestShardedOracle`` (LaplacianQRFT and ExpSemigroupQRLT 1e-3, as their
RFT twins; LaplacianQRFT at σ = 64, as test_torch_qrft.py, ROADMAP C30),
RFUT FJLT's 1e-4, CholeskyQR2 1e-4 / 1e-3, the Krylov
solutions 1e-4, KRR and ADMM 1e-3 (tests/test_ml_sharded.py:35), and
test_nla_extras_sharded.py's measures for LOBPCG, the range finders and
krank.

Each case's collectives are asserted as in test_torch_sharded.py: the
port's own count (all_reduce, all_gather, all_to_all) is the list its
design gives, per mesh dimension of more than one rank that splits the
rows (R) or the columns (C), and torch's CommDebugMode sees no other.
Only krank's host variants gather A.
"""

from __future__ import annotations

import concurrent.futures
import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from libskylark_tpu import ml as rml, nla as rnla, sketch as rsk
from libskylark_tpu.algorithms import krylov as rkrylov
from libskylark_tpu.algorithms.prox import L2Regularizer, SquaredLoss
from libskylark_tpu.base.context import Context as RContext
from libskylark_tpu.nla import krank as rkrank
from libskylark_tpu.nla.lowrank import approximate_dominant_subspace_basis
from libskylark_tpu.nla.randlobpcg import (lobpcg_rand_evd,
                                           power_iterations_rand_evd)
from libskylark_tpu.nla.tsqr import cholesky_qr2

RANKS = {"m1": 1, "m2": 2, "m4": 4, "m5": 5, "g22": 4, "i22": 4}
GRIDS = ("g22", "i22")
# (mesh, layout) of an operand with split columns, and its (R, C): the
# mesh dimensions of more than one rank that split its rows and columns
MLAYOUTS = [(m, "cols") for m in W.COLS_MESHES] + [(g, "grid")
                                                   for g in GRIDS]


def _rc(mname, lay):
    if lay == "grid":
        return 1, 1
    return 0, {"m1": 0, "g22": 2, "i22": 2}.get(mname, 1)


@pytest.fixture(scope="module")
def ranks():
    """The group's results; the reference's local results are made in
    this process while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        group = pool.submit(W.run_group, "sharded_cols")
        _references()
        return group.result()


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
    assert list(got[:3]) == want, (key, got, want)
    # CommDebugMode saw exactly the port's own collectives
    assert got[3] == sum(want), (key, got)


def _sketch_split(layout, mname):
    """Mesh dimensions of more than one rank that split the sketched
    axis."""
    if mname in GRIDS:
        return {"cw_rows": 2, "rw_grid": 1, "rw_cols": 2}[layout]
    return 0 if mname == "m1" else 1


def _transform_params():
    return [(name, lay, m) for name in W.COLS_TRANSFORMS
            for lay in sorted(W.LAYOUTS) for m in W.COLS_MESHES
            if not (lay == "rw_grid" and m not in GRIDS)
            and not (name == "FastMaternRFT" and lay != "rw_cols")]


@functools.lru_cache(maxsize=None)
def _ref_apply(name, rowwise):
    T = W.make_cols_transform(rsk, name, RContext(seed=7))
    X = jnp.asarray(W.transform_operand(rowwise))
    return np.asarray(T.apply(X, rsk.ROWWISE if rowwise else rsk.COLUMNWISE))


@pytest.mark.parametrize("name,layout,mname", _transform_params())
def test_transform_matches_the_local_route(ranks, name, layout, mname):
    """T.apply of a DTensor whose sketched axis is split: Fastfood and
    RFUT by one all-to-all to the kept axis, then each rank's block by the
    one-process route; QRFT and PPT by each rank's partial, one all_reduce
    over each splitting dimension, then the epilogue once."""
    key = f"{name}/{layout}/{mname}"
    got = _value(ranks, key, mname)
    want = _ref_apply(name, W.LAYOUTS[layout][0])
    tol = max(1e-4, W.COLS_TRANSFORMS[name])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=key)
    split = _sketch_split(layout, mname)
    if name.startswith("Fast") or name == "RFUT":
        _collectives(ranks, key, mname, all_to_all=int(split > 0))
    else:
        _collectives(ranks, key, mname, all_reduce=split)


@pytest.mark.parametrize("mname", ["m2", "m4", "m5"])
@pytest.mark.parametrize("layout", ["cw_rows", "rw_cols"])
def test_ppt_lifts_once(ranks, layout, mname):
    """PPT on p = 2, 4 and 5 ranks: the lift √c·v_i at h_i is added once,
    to the reduced CountSketches, so the sum equals the local route (a
    lift on every rank would put p of them into each sketch)."""
    got = _value(ranks, f"PPT/{layout}/{mname}", mname)
    want = _ref_apply("PPT", W.LAYOUTS[layout][0])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_every_reference_transform_has_a_dtensor_route():
    """No transform of the reference's set reaches the base
    ``_split_axis_apply`` raise: each has its own or takes the whole-axis
    route (an exchange first)."""
    from libskylark_tpu.sketch.transform import _REGISTRY as RREG
    from libskylark_tpu_torch.sketch import transform as T
    from libskylark_tpu_torch.sketch.dtensor_apply import WholeAxis

    names = sorted(RREG)
    assert names and set(names) <= set(T._REGISTRY)
    bare = [n for n in names
            if T._REGISTRY[n]._split_axis_apply
            is T.SketchTransform._split_axis_apply
            and not issubclass(T._REGISTRY[n], WholeAxis)]
    assert not bare, bare


def test_no_port_error_names_a_missing_dtensor_route():
    """The port's sources name no A5b refusal any longer."""
    root = pathlib.Path(W.HERE).parent / "libskylark_tpu_torch"
    hits = [str(p) for p in root.rglob("*.py") if "A5b" in p.read_text()]
    assert not hits, hits


def _block0(shape, mname, lay):
    """Rank 0's block shape of ``shape`` laid out ``lay`` on ``mname``
    (torch's split: ceil(extent / ranks) a dimension)."""
    sizes = (2, 2) if mname in GRIDS else (RANKS[mname],)
    out = list(shape)
    for i, k in enumerate(sizes):
        d = 1 if lay == "cols" or i == 1 else 0
        out[d] = -(-out[d] // k)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The reference's local result of a case that every mesh layout
    shares."""
    if case == "cqr2":
        return tuple(np.asarray(t) for t in cholesky_qr2(
            jnp.asarray(W.tsqr_panel())))
    if case == "lsqr":
        A, B = W.lsqr_problem()
        return np.asarray(rkrylov.lsqr(
            jnp.asarray(A), jnp.asarray(B),
            rkrylov.KrylovParams(tolerance=1e-8, iter_lim=200))[0])
    if case in ("cg", "fcg"):
        A, B = W.spd(seed={"cg": 1, "fcg": 4}[case])
        fn = rkrylov.cg if case == "cg" else rkrylov.flexible_cg
        return np.asarray(fn(jnp.asarray(A), jnp.asarray(B),
                             rkrylov.KrylovParams(tolerance=1e-10,
                                                  iter_lim=300))[0])
    if case == "row_extraction":
        A = jnp.asarray(W.extras_operand())
        Q = rkrank.RandomizedRangeFinder(
            A, "power_iteration", {"s": 8, "q": 1},
            RContext(seed=27)).compute()
        return np.asarray(rkrank.RangeAssistedSVD(A, Q, "row_extraction")
                          .compute()[1])
    if case.startswith("evd_"):
        A = jnp.asarray(W.sym_operand(psd=True))
        Q = rkrank.RandomizedRangeFinder(
            A, "power_iteration", {"s": 8, "q": 2},
            RContext(seed=28)).compute()
        return np.sort(np.asarray(rkrank.RangeAssistedEVD(
            A, Q, case[4:]).compute()[0]))[::-1]
    raise KeyError(case)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_cholesky_qr2_split_columns(ranks, mname, lay):
    """The panel exchanged to its rows, the row route (two k × k Gram
    all_reduces a row-splitting dimension), Q exchanged back to the
    panel's own placement, R Replicate() (tests/test_tsqr.py:58)."""
    key = f"cqr2/{mname}/{lay}"
    Q0, R0 = _ref("cqr2")
    Q, R = _value(ranks, f"{key}/Q", mname), _value(ranks, f"{key}/R", mname)
    np.testing.assert_allclose(Q, np.asarray(Q0), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(R, np.asarray(R0), atol=1e-3, rtol=1e-3)
    blk = _block0(Q.shape, mname, lay)
    np.testing.assert_array_equal(ranks[0][f"{key}/Q_local"],
                                  Q[: blk[0], : blk[1]])
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=2 * (r + c),
                 all_to_all=2 * (c > 0))


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_linear_ops_split_columns(ranks, mname, lay):
    """mv: the block times X's rows for the rank's columns, one all_reduce
    a column-splitting dimension; rmv: one all_reduce a row-splitting
    dimension, then the gather of the short n-length result."""
    A, B = W.lsqr_problem()
    r, c = _rc(mname, lay)
    key = f"{mname}/{lay}"
    mv = _value(ranks, f"mv/{key}", mname)
    rmv = _value(ranks, f"rmv/{key}", mname)
    np.testing.assert_allclose(mv, np.asarray(jnp.asarray(A) @ B[:24]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(rmv, np.asarray(jnp.asarray(A).T @ B),
                               atol=1e-4, rtol=1e-4)
    _collectives(ranks, f"mv/{key}", mname, all_reduce=c)
    _collectives(ranks, f"rmv/{key}", mname, all_reduce=r, all_gather=c)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_lsqr_split_columns(ranks, mname, lay):
    """V and X whole on every rank, U on the rank's rows: per iteration
    A·Z's all_reduce over the column-splitting dimensions, Aᵀ·U's and U's
    norms' over the row-splitting ones, and Aᵀ·U's gather
    (tests/test_krylov_sharded.py)."""
    X0 = _ref("lsqr")
    key = f"lsqr/{mname}/{lay}"
    X = _value(ranks, f"{key}/X", mname)
    it = int(_value(ranks, f"{key}/it", mname))
    np.testing.assert_allclose(X, np.asarray(X0), atol=1e-4, rtol=1e-4)
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=r * (2 + 2 * it) + c * it,
                 all_gather=c * (1 + it))


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
@pytest.mark.parametrize("case", ["cg", "fcg"])
def test_spd_solvers_split_columns(ranks, case, mname, lay):
    """CG and flexible CG, every vector whole: each product A·P one
    all_reduce a column-splitting dimension and one all_gather a
    row-splitting one."""
    X0 = _ref(case)
    key = f"{case}/{mname}/{lay}"
    X = _value(ranks, f"{key}/X", mname)
    np.testing.assert_allclose(X, np.asarray(X0), atol=1e-4, rtol=1e-4)
    products = 1 + int(_value(ranks, f"{key}/it", mname))
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=c * products,
                 all_gather=r * products)


@functools.lru_cache(maxsize=None)
def _ref_gram(kname, case):
    X, Y = W.gram_operands()
    k = W.make_cols_kernel(rml, kname, X.shape[1])
    if case == "gram":
        return np.asarray(k.gram(jnp.asarray(X)))
    return np.asarray(k.gram(jnp.asarray(X), jnp.asarray(Y)))


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
@pytest.mark.parametrize("case", ["gram", "gram_xy", "gram_whole_x"])
@pytest.mark.parametrize("kname", W.COLS_KERNELS)
def test_gram_split_features(ranks, kname, case, mname, lay):
    """K = f(Σ over features of g): each rank's features' partial, one
    all_reduce a feature-splitting dimension, f on the sum. X split
    against itself (its rows gathered for the other side), against a
    whole Y, and a whole X against a split Y (K split on its columns)."""
    key = f"{case}/{kname}/{mname}/{lay}"
    got = _value(ranks, key, mname)
    want = _ref_gram(kname, "gram" if case == "gram" else "xy")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=key)
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=c,
                 all_gather=r if case == "gram" else 0)


@functools.lru_cache(maxsize=None)
def _ref_ml(case):
    X, Y = W.ml_data()
    X, Y = jnp.asarray(X), jnp.asarray(Y)
    lam, s, t = W.KRR["lam"], W.KRR["s"], W.KRR["t"]
    k = rml.Gaussian(8, sigma=W.KRR["sigma"])
    if case == "krr":
        return np.asarray(rml.kernel_ridge(k, X, Y, lam))
    if case == "akrr":
        return np.asarray(rml.approximate_kernel_ridge(
            k, X, Y, lam, s=s, context=RContext(seed=3))[1])
    if case == "akrr_cwt":
        params = rml.KrrParams(sketched_rr=True, fast_sketch=True,
                               sketch_size=t)
        return np.asarray(rml.approximate_kernel_ridge(
            k, X, Y, lam, s=s, context=RContext(seed=4), params=params)[1])
    y = np.asarray(Y > 0).astype(np.int64)
    S = rml.BlockADMMSolver(SquaredLoss(), L2Regularizer(), W.ADMM["lam"],
                            8, num_partitions=W.ADMM["partitions"])
    S.maxiter, S.tol = W.ADMM["maxiter"], 0.0
    return np.asarray(S.train(X, y).coef)


def _ml_params():
    return [(case, m, lay) for case in ("krr", "akrr", "akrr_cwt", "admm")
            for m, lay in MLAYOUTS]


@pytest.mark.parametrize("case,mname,lay", _ml_params())
def test_ml_split_features(ranks, case, mname, lay):
    """Exact KRR through the Gram's features-split route (K's rows and
    Y gathered where the rows are split); the random-feature regimes (with
    and without a CWT regression sketch) and linear ADMM after one
    all-to-all that lays X out on its examples, then the row route (ZᵀZ
    and ZᵀY all_reduces; ADMM's per-partition sums): W and the
    coefficients within 1e-3 of the reference's local route
    (tests/test_ml_sharded.py). The other regimes take the same exchange
    into the row routes that test_torch_sharded_ml.py holds."""
    key = f"{case}/{mname}/{lay}"
    got = _value(ranks, key, mname)
    want = _ref_ml(case)
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-3,
                               rtol=1e-3, err_msg=key)
    r, c = _rc(mname, lay)
    rows = r + c          # row-splitting dimensions after the exchange
    a2a = int(c > 0)
    P, it = W.ADMM["partitions"], W.ADMM["maxiter"]
    want_c = {"krr": (c, 3 * r, 0), "akrr": (2 * rows, 0, a2a),
              "akrr_cwt": (2 * rows, 0, a2a),
              "admm": ((1 + P + it * (2 * P + 1)) * rows, 0, a2a)}
    _collectives(ranks, key, mname, *want_c[case])


@functools.lru_cache(maxsize=None)
def _ref_extras(case):
    A = jnp.asarray(W.extras_operand())
    if case == "lobpcg":
        return np.asarray(lobpcg_rand_evd(A, 4, RContext(seed=23),
                                          s=128)[0])
    if case == "power_evd":
        return np.asarray(power_iterations_rand_evd(
            A, 4, RContext(seed=25), power_iters=2)[0])
    if case == "range_finder":
        return np.asarray(rkrank.RandomizedRangeFinder(
            A, "power_iteration", {"s": W.KRANK["s"], "q": W.KRANK["q"]},
            RContext(seed=21)).compute())
    if case == "krank_svd":
        return np.asarray(rkrank.randomized_svd(A, 6, RContext(seed=22),
                                                q=1)[1])
    if case == "lowrank":
        return np.asarray(approximate_dominant_subspace_basis(
            A, k=4, s=16, t=24, context=RContext(seed=24))[0])
    if case == "svd":
        return np.asarray(rnla.approximate_svd(
            jnp.asarray(W.lowrank(256, 64, 4, 6)), 4, RContext(seed=17),
            rnla.ApproximateSVDParams(num_iterations=W.SVD_Q))[1])
    if case == "adaptive":
        return np.asarray(rkrank.RandomizedRangeFinder(
            A, "adaptive", {"epsilon": W.KRANK["eps"], "r": W.KRANK["r"],
                            "max_iters": W.KRANK["iters"]},
            RContext(seed=26)).compute())
    raise KeyError(case)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_lobpcg_split_columns(ranks, mname, lay):
    """lobpcg_rand_evd (CWT, k = 4, s = 128): the sketch's columns
    gathered, AᵀA·x on the host blocks (A·x summed over the
    column-splitting dimensions, Aᵀ·(A·x) over the row-splitting ones and
    gathered); every rank the same eigenvalues, within atol 1e-4 / rtol
    1e-2 of the local ones and 5e-2 of the spectrum
    (test_nla_extras_sharded.py:76)."""
    key = f"lobpcg/{mname}/{lay}"
    lam = _value(ranks, key, mname)
    np.testing.assert_allclose(lam, _ref_extras("lobpcg"), atol=1e-4,
                               rtol=1e-2)
    np.testing.assert_allclose(np.sort(lam)[::-1],
                               (0.7 ** np.arange(4)) ** 2, rtol=5e-2)
    counts = _value(ranks, key + "/counts", mname)
    r, c = _rc(mname, lay)
    assert counts[2] == 0 and counts[3] == counts[0] + counts[1]
    # the sketch's gather, then one all_gather a column-splitting and one
    # all_reduce a splitting dimension per product
    assert counts[1] >= c and (counts[1] - c) % max(c, 1) == 0
    assert (counts[0] == 0) == (r + c == 0)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_power_evd_split_columns(ranks, mname, lay):
    """power_iterations_rand_evd (k = 4, two iterations): the JLT's
    split-axis sketch, the whole-vector products, the QR's gather: the
    eigenvalues within 1e-3 of the local ones."""
    key = f"power_evd/{mname}/{lay}"
    lam = _value(ranks, key, mname)
    np.testing.assert_allclose(lam, _ref_extras("power_evd"), rtol=1e-3,
                               atol=1e-5)
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=3 * r + 3 * c,
                 all_gather=r + 3 * c)


def _projector_close(Q, Q0):
    A = W.extras_operand()
    rec0, rec = Q0 @ (Q0.T @ A), Q @ (Q.T @ A)
    nrm = np.linalg.norm(A)
    assert np.linalg.norm(rec - rec0) / nrm < 1e-3
    assert np.linalg.norm(A - rec0) / nrm < 1e-2


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_range_finders_split_columns(ranks, mname, lay):
    """power_iteration (s = 8, q = 1) on the blocks and the adaptive
    finder on A pulled whole once (its one gather): the reconstructions
    Q·Qᵀ·A within 1e-3 of the local ones (test_nla_extras_sharded.py:40),
    the adaptive basis as wide as the reference's."""
    r, c = _rc(mname, lay)
    key = f"range_finder/{mname}/{lay}"
    _projector_close(_value(ranks, key, mname), _ref_extras("range_finder"))
    _collectives(ranks, key, mname, all_reduce=2 * c + r,
                 all_gather=c + r)
    key = f"adaptive/{mname}/{lay}"
    Q, Q0 = _value(ranks, key, mname), _ref_extras("adaptive")
    assert Q.shape == Q0.shape
    _projector_close(Q, Q0)
    _collectives(ranks, key, mname, all_gather=r + c)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_krank_svd_split_columns(ranks, mname, lay):
    """randomized_svd (rank 6, q = 1): the leading σ within 1e-4 / 1e-3,
    all within 1e-3 / 3e-2 (test_nla_extras_sharded.py:63); the
    row-extraction SVD (on A pulled whole once) within 1e-3 of the
    reference's."""
    r, c = _rc(mname, lay)
    key = f"krank_svd/{mname}/{lay}"
    S, S0 = _value(ranks, key, mname), _ref_extras("krank_svd")
    np.testing.assert_allclose(S[:4], S0[:4], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(S, S0, atol=1e-3, rtol=3e-2)
    _collectives(ranks, key, mname, all_reduce=2 * c + 2 * r,
                 all_gather=2 * c + r)
    key = f"row_extraction/{mname}/{lay}"
    S0 = _ref("row_extraction")
    np.testing.assert_allclose(_value(ranks, key, mname)[:6], S0[:6],
                               atol=1e-4, rtol=1e-3)
    _collectives(ranks, key, mname, all_gather=2 * r + c)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
@pytest.mark.parametrize("method", ["direct", "nystrom"])
def test_range_assisted_evd_split_columns(ranks, method, mname, lay):
    """RangeAssistedEVD of a PSD operand: ``direct`` on the blocks (the
    basis gathered, A·Q summed over the column-splitting dimensions),
    ``nystrom`` on A pulled whole once; the leading eigenvalues within
    1e-3 of the reference's."""
    w0 = _ref(f"evd_{method}")
    key = f"evd_{method}/{mname}/{lay}"
    w = np.sort(_value(ranks, key, mname))[::-1]
    np.testing.assert_allclose(w[:4], w0[:4], atol=1e-4, rtol=1e-3)
    r, c = _rc(mname, lay)
    if method == "direct":
        _collectives(ranks, key, mname, all_reduce=r + c, all_gather=r)
    else:
        _collectives(ranks, key, mname, all_gather=2 * r + c)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_dominant_subspace_split_columns(ranks, mname, lay):
    """approximate_dominant_subspace_basis (k = 4, s = 16, t = 24): both
    sketches by the split axis's route (one all_reduce a
    column-splitting dimension each), the QR's gather and Uᵀ·Y's sum
    over the row-splitting ones; Z within 1e-4
    (test_nla_extras_sharded.py:88)."""
    key = f"lowrank/{mname}/{lay}"
    np.testing.assert_allclose(_value(ranks, key, mname),
                               _ref_extras("lowrank"), atol=1e-4, rtol=1e-4)
    r, c = _rc(mname, lay)
    _collectives(ranks, key, mname, all_reduce=2 * c + r, all_gather=r)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_approximate_svd_split_columns(ranks, mname, lay):
    """approximate_svd (rank 4, q = 2) with A's columns split: the range
    sketch's partials summed, A·X summed over the column-splitting
    dimensions and Aᵀ·Q over the row-splitting ones, Bᵀ's CholeskyQR2
    on A's columns: the reconstruction within 1e-3 of ‖A‖ and σ within
    1e-3 of the reference's (tests/test_nla.py:77)."""
    A = W.lowrank(256, 64, 4, 6)
    key = f"svd/{mname}/{lay}"
    rec = _value(ranks, f"{key}/rec", mname)
    S = _value(ranks, f"{key}/S", mname)
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-3
    np.testing.assert_allclose(S, _ref_extras("svd"), rtol=1e-3)
    r, c = _rc(mname, lay)
    q = W.SVD_Q
    _collectives(ranks, key, mname, all_reduce=(3 + q) * c + (3 + 3 * q) * r)


@functools.lru_cache(maxsize=None)
def _ref_sym_svd():
    V, S = rnla.approximate_symmetric_svd(
        jnp.asarray(W.sym_operand()), 4, RContext(seed=29),
        rnla.ApproximateSVDParams(num_iterations=W.SVD_Q))
    return np.asarray(V), np.asarray(S)


@pytest.mark.parametrize("mname,lay", MLAYOUTS + [
    (m, "rows") for m in W.COLS_MESHES])
def test_symmetric_svd(ranks, mname, lay):
    """approximate_symmetric_svd (rank 4, q = 2): the range sketch by the
    JLT's DTensor route, each A·Q on the gathered basis, CholeskyQR2's
    Grams summed, the k' × k' eigh on every rank: σ within 1e-3 and each
    vector's |cos| with the reference's within 1e-4 (tests/test_nla.py)."""
    V0, S0 = _ref_sym_svd()
    key = f"sym_svd/{mname}/{lay}"
    V, S = _value(ranks, f"{key}/V", mname), _value(ranks, f"{key}/S", mname)
    np.testing.assert_allclose(S, S0, rtol=1e-3)
    cos = np.abs(np.sum(V * V0, axis=0)) / (np.linalg.norm(V, axis=0)
                                            * np.linalg.norm(V0, axis=0))
    assert cos.min() >= 1 - 1e-4, cos
    if lay == "rows":
        r, c = {"m1": 0, "g22": 2, "i22": 2}.get(mname, 1), 0
    else:
        r, c = _rc(mname, lay)
    q = W.SVD_Q
    _collectives(ranks, key, mname, all_reduce=(q + 2) * c + (2 * q + 3) * r,
                 all_gather=(q + 1) * r)


@functools.lru_cache(maxsize=None)
def _ref_sym_svd_skip_qr():
    k = W.SKIP_QR
    V, S = rnla.approximate_symmetric_svd(
        jnp.asarray(W.sym_operand(decay=k["decay"])), k["rank"],
        RContext(seed=k["seed"]),
        rnla.ApproximateSVDParams(num_iterations=k["q"], skip_qr=True))
    return np.asarray(V), np.asarray(S)


@pytest.mark.parametrize("mname,lay", MLAYOUTS + [
    (m, "rows") for m in W.COLS_MESHES])
def test_symmetric_svd_skip_qr(ranks, mname, lay):
    """approximate_symmetric_svd with skip_qr=True (rank 8, one power
    iteration, eigenvalues ±0.3^i): the range sketch is orthonormalized
    before the power iteration, as in the reference, and the basis once
    more after it; σ within 1e-3 and each vector's |cos| within 1e-4 of
    the reference's. Without the first orthonormalization the final
    CholeskyQR2 factors A²·S and σ is off by tens of percent."""
    V0, S0 = _ref_sym_svd_skip_qr()
    key = f"sym_svd_skip_qr/{mname}/{lay}"
    V, S = _value(ranks, f"{key}/V", mname), _value(ranks, f"{key}/S", mname)
    np.testing.assert_allclose(S, S0, rtol=1e-3)
    cos = np.abs(np.sum(V * V0, axis=0)) / (np.linalg.norm(V, axis=0)
                                            * np.linalg.norm(V0, axis=0))
    assert cos.min() >= 1 - 1e-4, cos
    if lay == "rows":
        r, c = {"m1": 0, "g22": 2, "i22": 2}.get(mname, 1), 0
    else:
        r, c = _rc(mname, lay)
    # two CholeskyQR2 (the sketch's and the final one), two products A·Q
    q = W.SKIP_QR["q"]
    _collectives(ranks, key, mname, all_reduce=(q + 2) * c + 5 * r,
                 all_gather=(q + 1) * r)


@pytest.mark.parametrize("mname,lay", MLAYOUTS)
def test_a_right_hand_side_with_split_columns_is_refused(ranks, mname, lay):
    """LSQR with a right-hand side laid out col_sharded: a rank would hold
    other columns of it than its neighbours, so the port refuses it
    (InvalidParametersError) wherever a mesh dimension of more than one
    rank splits its columns; on one rank nothing is split."""
    got = _value(ranks, f"split_rhs/{mname}/{lay}", mname)
    want = "InvalidParametersError" if RANKS[mname] > 1 else ""
    assert str(got) == want, (mname, lay, got)


def _references() -> None:
    """Every reference result the tests read (each cached)."""
    for name in W.COLS_TRANSFORMS:
        for rowwise in (False, True):
            _ref_apply(name, rowwise)
    for case in ("cqr2", "lsqr", "cg", "fcg", "row_extraction",
                 "evd_direct", "evd_nystrom"):
        _ref(case)
    for kname in W.COLS_KERNELS:
        _ref_gram(kname, "gram")
        _ref_gram(kname, "xy")
    for case in ("krr", "akrr", "akrr_cwt", "admm"):
        _ref_ml(case)
    for case in ("lobpcg", "power_evd", "range_finder", "krank_svd",
                 "adaptive", "lowrank", "svd"):
        _ref_extras(case)
    _ref_sym_svd()
    _ref_sym_svd_skip_qr()
