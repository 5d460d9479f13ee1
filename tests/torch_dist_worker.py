"""Rank worker of the port's distributed tests (imports no jax).

``python torch_dist_worker.py <rank> <world> <port> <task> <outdir>``
joins a gloo group of ``world`` CPU processes through the port's own
bootstrap (``parallel.multihost.initialize_distributed``), builds every
mesh of :data:`MESHES` (each over the first ranks of the group), runs
every case of ``task`` (a key of :data:`TASKS`) on the meshes this rank
belongs to, and writes the results
as ``<outdir>/<rank>.npz``: a numpy array per case, or the name of the
exception class a case asks to see. The sharded tasks also write each
case's collective counts (:func:`_put`). The test files spawn one
group per file (:func:`run_group`), hold rank 0's results against the JAX
package in the pytest process, and check that every rank of a mesh
returned the same value.

The inputs are made here and in the test files by the same seeded numpy
functions below, so both packages see the same data.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 5
# name -> (shape, ranks): the group shapes (1,), (2,), (4,), (5,), (2, 2)
# and, in a group of 7 (the sharded ML file), (7,)
MESHES = {"m1": ((1,), 1), "m2": ((2,), 2), "m4": ((4,), 4),
          "m5": ((5,), 5), "g22": ((2, 2), 4), "m7": ((7,), 7)}
# the reference's _grids (tests/test_dist_sparse.py:36): 1D rows, 1D
# cols, the 2D grid, ragged 5
GRIDS = [("m4", {"row_axis": "rows"}), ("m2", {"col_axis": "rows"}),
         ("g22", {"row_axis": "rows", "col_axis": "cols"}),
         ("m5", {"row_axis": "rows"})]
DENSE_GRIDS = [GRIDS[2], GRIDS[3]]
SHARD_P = (1, 2, 4, 5)


def rand_sparse(h, w, density=0.08, seed=0):
    """The reference's ``_rand_sparse`` (tests/test_dist_sparse.py:26):
    a float32 scipy CSC matrix."""
    rng = np.random.default_rng(seed)
    return sp.random(h, w, density=density, random_state=rng, format="csc",
                     dtype=np.float32)


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def svd_operand():
    """The reference's rank-5 masked operand
    (tests/test_dist_sparse.py:292)."""
    rng = np.random.default_rng(16)
    U0 = rng.standard_normal((120, 5)).astype(np.float32)
    V0 = rng.standard_normal((5, 60)).astype(np.float32)
    mask = rng.uniform(size=(120, 60)) < 0.3
    return (U0 @ V0) * mask


def condest_operand():
    """The reference's condest operand (tests/test_nla.py:260)."""
    rng = np.random.default_rng(13)
    return (rng.standard_normal((120, 20))
            * (rng.uniform(size=(120, 20)) < 0.3)).astype(np.float32)


def ls_operands():
    """A tall, well-conditioned sparse least-squares problem."""
    A = rand_sparse(400, 20, density=0.2, seed=24)
    return A, normal(400, 25)


def empty_cells_operand():
    return sp.csc_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                          (np.array([0, 1, 2]), np.array([0, 1, 2]))),
                         shape=(40, 40))


# shard_apply cases: name -> (family, N, S, m, A's seed, context seed,
# columnwise); the reference's tests/test_base.py:193-279
SHARD_CASES = {
    "jlt_cw": ("JLT", 2048, 64, 16, 5, 17, True),
    "ct_rw": ("CT", 2048, 64, 16, 6, 18, False),
    "ragged_cw": ("JLT", 1000, 16, 4, 7, 1, True),
    "ragged_rw": ("JLT", 1000, 16, 4, 8, 1, False),
}


def shard_operand(name):
    fam, N, S, m, seed, _, cw = SHARD_CASES[name]
    return normal((N, m) if cw else (m, N), seed)


# -- the cases, run in the rank processes ------------------------------------


def _parallel_cases(P, meshes, out):
    from libskylark_tpu_torch import parallel as par, sketch as sk
    from libskylark_tpu_torch.base import errors
    from libskylark_tpu_torch.parallel import mesh as pmesh, shard_apply
    from torch.distributed.tensor import Replicate, Shard

    for p in SHARD_P:
        mesh = meshes.get(f"m{p}")
        if mesh is None:
            continue
        for name, (fam, N, S, m, _, ctx, cw) in SHARD_CASES.items():
            T = (sk.JLT(N, S, P.Context(seed=ctx)) if fam == "JLT"
                 else sk.CT(N, S, P.Context(seed=ctx), C=1.0))
            A = shard_operand(name)
            fn = shard_apply.columnwise if cw else shard_apply.rowwise
            out[f"{name}/p{p}"] = fn(T, A, mesh).numpy()
            # the kernel's route: its plain version on a CPU tensor
            out[f"{name}/p{p}/kernel_route"] = fn(
                T, A, mesh, use_pallas=True).numpy()
            # a DTensor sharded on the sequence axis: the local shard
            dA = par.distribute(A, pmesh.Sharding(mesh, (Shard(0 if cw
                                                              else 1),)))
            out[f"{name}/p{p}/dtensor"] = fn(T, dA, mesh).numpy()
            rA = par.distribute(A, par.replicated(mesh))
            out[f"{name}/p{p}/replicated"] = fn(T, rA, mesh).numpy()
            assert isinstance(rA.placements[0], Replicate)
        if p == 2:
            T = sk.CWT(2048, 16, P.Context(seed=1))
            try:
                shard_apply.columnwise(T, np.zeros((2048, 4), np.float32),
                                       mesh)
            except errors.SkylarkError as e:
                out["reject/non_dense"] = np.array(type(e).__name__)
            T = sk.JLT(2048, 16, P.Context(seed=1))
            try:
                shard_apply.columnwise(T, np.zeros((2000, 4), np.float32),
                                       mesh)
            except errors.SkylarkError as e:
                out["reject/length"] = np.array(type(e).__name__)
            # the mesh helpers on this mesh
            x = np.arange(64, dtype=np.float32).reshape(8, 8)
            for h in ("row_sharded", "col_sharded", "grid2d", "replicated"):
                d = par.distribute(x, getattr(par, h)(mesh))
                out[f"mesh/{h}/local"] = d.to_local().numpy()
                out[f"mesh/{h}/host"] = par.to_host(d)
            v = par.distribute(np.arange(8, dtype=np.float32),
                               par.vec_sharded(mesh))
            out["mesh/vec_sharded/local"] = v.to_local().numpy()
    g = meshes.get("g22")
    if g is not None:
        x = np.arange(64, dtype=np.float32).reshape(8, 8)
        for h in ("row_sharded", "col_sharded", "grid2d", "replicated"):
            d = par.distribute(x, getattr(par, h)(g))
            out[f"grid/{h}/local"] = d.to_local().numpy()
            out[f"grid/{h}/host"] = par.to_host(d)
        out["grid/coordinate"] = np.array(g.get_coordinate())


def _dist_sparse_cases(P, meshes, out):
    import torch

    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.base.dist_sparse import distribute_sparse
    from libskylark_tpu_torch.nla import condest as ce
    from libskylark_tpu_torch.nla.svd import (ApproximateSVDParams,
                                              approximate_svd)
    from libskylark_tpu_torch.sketch.rft import GaussianRFT

    def grids(which=GRIDS):
        for mname, axes in which:
            if mname in meshes:
                yield (f"{mname}:{axes.get('row_axis')}:"
                       f"{axes.get('col_axis')}", meshes[mname], axes)

    g = meshes.get("g22")
    m2 = meshes.get("m2")
    A = rand_sparse(53, 37, seed=1)
    if m2 is not None:
        out["roundtrip/m2"] = distribute_sparse(
            A, m2, row_axis="rows").to_local().to_scipy().toarray()
    if g is not None:
        out["roundtrip/g22"] = distribute_sparse(
            A, g, row_axis="rows", col_axis="cols"
        ).to_local().to_scipy().toarray()
        D = distribute_sparse(rand_sparse(45, 30, seed=2), g,
                              row_axis="rows", col_axis="cols")
        out["todense"] = D.todense().numpy()
        D = distribute_sparse(rand_sparse(40, 33, seed=7), g,
                              row_axis="rows", col_axis="cols")
        out["spmm_vector"] = D.spmm(normal(33, 8)).numpy()
        D = distribute_sparse(rand_sparse(37, 53, seed=15), g,
                              row_axis="rows", col_axis="cols")
        out["transpose"] = D.T.todense().numpy()
        D = distribute_sparse(empty_cells_operand(), g, row_axis="rows",
                              col_axis="cols")
        out["empty_cells"] = D.spmm(normal((40, 3), 13)).numpy()
    for h, w in ((64, 48), (53, 41)):
        for tag, mesh, axes in grids():
            D = distribute_sparse(rand_sparse(h, w, seed=3), mesh, **axes)
            out[f"spmm/{h}x{w}/{tag}"] = D.spmm(normal((w, 7), 4)).numpy()
            D = distribute_sparse(rand_sparse(h, w, seed=5), mesh, **axes)
            out[f"spmm_t/{h}x{w}/{tag}"] = D.spmm_t(
                normal((h, 5), 6)).numpy()
    for fam in ("CWT", "MMT", "WZT"):
        for tag, mesh, axes in grids():
            T = getattr(sk, fam)(100, 24, P.Context(seed=17))
            D = distribute_sparse(rand_sparse(100, 37, seed=9), mesh, **axes)
            out[f"hash_cw/{fam}/{tag}"] = T.apply(D, sk.COLUMNWISE).numpy()
    for fam in ("CWT", "MMT"):
        for tag, mesh, axes in grids():
            T = getattr(sk, fam)(100, 24, P.Context(seed=18))
            D = distribute_sparse(rand_sparse(37, 100, seed=10), mesh,
                                  **axes)
            out[f"hash_rw/{fam}/{tag}"] = T.apply(D, sk.ROWWISE).numpy()
    for fam in ("JLT", "CT"):
        for tag, mesh, axes in grids(DENSE_GRIDS):
            T = getattr(sk, fam)(300, 16, P.Context(seed=19))
            D = distribute_sparse(rand_sparse(29, 300, seed=11), mesh,
                                  **axes)
            out[f"dense_rw/{fam}/{tag}"] = T.apply(D, sk.ROWWISE).numpy()
    for tag, mesh, axes in grids(DENSE_GRIDS):
        T = sk.JLT(300, 16, P.Context(seed=20))
        D = distribute_sparse(rand_sparse(300, 29, seed=12), mesh, **axes)
        out[f"dense_cw/JLT/{tag}"] = T.apply(D, sk.COLUMNWISE).numpy()
    for cw in (True, False):
        for tag, mesh, axes in grids():
            T = sk.CWT(100, 24, P.Context(seed=23))
            D = distribute_sparse(rand_sparse(*((100, 37) if cw
                                                else (37, 100)), seed=14),
                                  mesh, **axes)
            R = T.apply_sparse(D, sk.COLUMNWISE if cw else sk.ROWWISE)
            key = f"sparse_to_sparse/{'cw' if cw else 'rw'}/{tag}"
            out[key] = R.todense().numpy()
            out[key + "/axes"] = np.array(f"{R.row_axis},{R.col_axis}")
    if g is not None:
        T1 = sk.CWT(120, 64, P.Context(seed=41))
        T2 = sk.CWT(64, 24, P.Context(seed=42))
        D = distribute_sparse(rand_sparse(120, 33, seed=31), g,
                              row_axis="rows", col_axis="cols")
        mid = T1.apply_sparse(D, sk.COLUMNWISE)
        got = T2.apply_sparse(mid, sk.COLUMNWISE)
        out["chained"] = got.todense().numpy()
        # each rank keeps exactly its cell's nonzeros: no padded slots
        out["chained/slots"] = np.array(
            [int(mid.v.numel()), int(torch.count_nonzero(mid.v)),
             int(got.v.numel()), int(torch.count_nonzero(got.v))])
    for replace in (True, False):
        for tag, mesh, axes in grids():
            T = sk.UST(100, 24, P.Context(seed=31), replace=replace)
            D = distribute_sparse(rand_sparse(100, 37, seed=21), mesh,
                                  **axes)
            Dr = distribute_sparse(rand_sparse(37, 100, seed=22), mesh,
                                   **axes)
            out[f"ust/{replace}/cw/{tag}"] = T.apply(D, sk.COLUMNWISE).numpy()
            out[f"ust/{replace}/rw/{tag}"] = T.apply(Dr, sk.ROWWISE).numpy()
    for tag, mesh, axes in grids(DENSE_GRIDS):
        T = GaussianRFT(300, 16, P.Context(seed=33), sigma=1.5)
        A = rand_sparse(29, 300, seed=23)
        out[f"rft/rw/{tag}"] = T.apply(distribute_sparse(A, mesh, **axes),
                                       sk.ROWWISE).numpy()
        out[f"rft/cw/{tag}"] = T.apply(
            distribute_sparse(A.T.tocsc(), mesh, **axes),
            sk.COLUMNWISE).numpy()
    if g is not None:
        D = distribute_sparse(sp.csc_matrix(svd_operand()), g,
                              row_axis="rows", col_axis="cols")
        U, S, V = approximate_svd(D, 4, P.Context(seed=30),
                                  ApproximateSVDParams(num_iterations=2))
        out["svd/S"] = S.numpy()
        out["svd/rec"] = ((U * S[None]) @ V.T).numpy()
        # the wide branch, through the transposed operand
        _, S, _ = approximate_svd(D.T, 4, P.Context(seed=30),
                                  ApproximateSVDParams(num_iterations=2))
        out["svd_wide/S"] = S.numpy()
        from libskylark_tpu_torch import algorithms, nla

        A, b = ls_operands()
        D = distribute_sparse(A, g, row_axis="rows", col_axis="cols")
        out["lstsq"] = nla.approximate_least_squares(
            D, b, P.Context(seed=34)).numpy()
        x, it = algorithms.lsqr(D, b, algorithms.KrylovParams(
            tolerance=1e-6, iter_lim=200))
        out["lsqr"], out["lsqr/iterations"] = x.numpy(), np.array(it)
    for mname, axes in (("m2", {"row_axis": "rows"}),
                        ("g22", {"row_axis": "rows", "col_axis": "cols"})):
        if mname in meshes:
            D = distribute_sparse(sp.csc_matrix(condest_operand()),
                                  meshes[mname], **axes)
            D.to_local = None  # the device route never gathers
            out[f"condest/{mname}"] = np.array(
                ce.condest(D, P.Context(seed=43)))


# -- the sharded (DTensor) cases ---------------------------------------------

SHARDED_MESHES = ("m1", "m2", "m4", "m5", "g22")
ML_MESHES = SHARDED_MESHES + ("m7",)
# the reference's ALL_TRANSFORMS (tests/test_sketch_core.py:38-50) and
# FJLT, each with its oracle atol
TRANSFORMS = {
    "JLT": 1e-4, "CT": 1e-4, "CWT": 1e-4, "MMT": 1e-4, "WZT": 1e-4,
    "UST_replace": 1e-4, "UST_noreplace": 1e-4, "GaussianRFT": 1e-4,
    "LaplacianRFT": 1e-3, "MaternRFT": 1e-4, "ExpSemigroupRLT": 1e-3,
    "FJLT": 1e-4}
# layout -> (rowwise, placement helper): the sketched axis split
# (cw_rows, rw_cols; rw_grid on the 2 × 2 grid) or whole (rw_grid on a
# line)
LAYOUTS = {"cw_rows": (False, "row_sharded"), "rw_grid": (True, "grid2d"),
           "rw_cols": (True, "col_sharded")}
TN, TS, TM = 128, 32, 16


def make_transform(sk, name, ctx):
    """The transform ``name`` of either package's sketch module, as the
    reference's ALL_TRANSFORMS builds it (N = 128, S = 32)."""
    N, S = TN, TS
    return {
        "JLT": lambda: sk.JLT(N, S, ctx),
        "CT": lambda: sk.CT(N, S, ctx, C=2.0),
        "CWT": lambda: sk.CWT(N, S, ctx),
        "MMT": lambda: sk.MMT(N, S, ctx),
        "WZT": lambda: sk.WZT(N, S, ctx, p=1.5),
        "UST_replace": lambda: sk.UST(N, S, ctx, replace=True),
        "UST_noreplace": lambda: sk.UST(N, S, ctx, replace=False),
        "GaussianRFT": lambda: sk.GaussianRFT(N, S, ctx, sigma=2.0),
        "LaplacianRFT": lambda: sk.LaplacianRFT(N, S, ctx, sigma=2.0),
        "MaternRFT": lambda: sk.MaternRFT(N, S, ctx, nu=1.5, l=2.0),
        "ExpSemigroupRLT": lambda: sk.ExpSemigroupRLT(N, S, ctx, beta=0.5),
        "FJLT": lambda: sk.FJLT(N, S, ctx),
    }[name]()


def transform_operand(rowwise):
    """The reference's sharded-oracle operands (test_sketch_core.py:75,
    :91)."""
    return normal((TM, TN), 2) if rowwise else normal((TN, TM), 1)


def tsqr_panel(m=512, k=24, cond=1e3, seed=2):
    """The reference's ``_panel`` (tests/test_tsqr.py:17)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((k, k)))
    s = np.logspace(0, -np.log10(cond), k)
    return ((U * s) @ V.T).astype(np.float32)


def lowrank(m, n, r, seed):
    """The reference's ``_lowrank`` (tests/test_nla.py:18)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
            ).astype(np.float32)


def lsqr_problem():
    """The reference's ``problem`` (tests/test_krylov_sharded.py:25)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((96, 24)).astype(np.float32)
    return A, rng.standard_normal((96, 3)).astype(np.float32)


def spd(n=48, seed=1):
    """The reference's ``_spd`` (tests/test_krylov_sharded.py:71)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = M @ M.T + n * np.eye(n, dtype=np.float32)
    return A, rng.standard_normal((n, 2)).astype(np.float32)


def extras_operand():
    """The reference's ``A_np`` (tests/test_nla_extras_sharded.py:26)."""
    rng = np.random.default_rng(11)
    U = np.linalg.qr(rng.standard_normal((192, 8)))[0]
    V = np.linalg.qr(rng.standard_normal((32, 8)))[0]
    s = 0.7 ** np.arange(8)
    A = (U * s) @ V.T + 1e-5 * rng.standard_normal((192, 32))
    return A.astype(np.float32)


def ml_data():
    """The reference's ``data`` (tests/test_ml_sharded.py:18)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 8)).astype(np.float32)
    return X, np.sin(X[:, 0]).astype(np.float32)


SVD_Q = 2
CHEB_ITERS = 80
ADMM = {"partitions": 2, "maxiter": 6, "lam": 0.01, "features": 64}
KRR = {"sigma": 2.0, "lam": 0.01, "s": 64, "t": 128}


def _host(x):
    from libskylark_tpu_torch import parallel as par

    return par.to_host(x)


def _put(out, key, fn, host):
    """Run a case; store its host value (a dict: one array a field,
    ``key/field``) and its collectives: [all_reduce, all_gather,
    all_to_all] as the port counts them, and the total torch's
    CommDebugMode saw, which also sees any a DTensor op would insert
    (``chip_smoke.counted_call``)."""
    import torch

    import chip_smoke

    res, counts = chip_smoke.counted_call(torch, fn)
    h = host(res)
    for k, v in (h.items() if isinstance(h, dict) else [("", h)]):
        out[f"{key}/{k}" if k else key] = np.asarray(v)
    out[key + "/counts"] = np.array(counts)


def _sharded_cases(P, meshes, out):
    import torch

    from libskylark_tpu_torch import algorithms as alg, nla
    from libskylark_tpu_torch import parallel as par, sketch as sk
    from libskylark_tpu_torch.nla import krank, lowrank as plr, tsqr
    from libskylark_tpu_torch.nla.randlobpcg import lobpcg_rand_evd

    def put(key, fn, host=_host):
        _put(out, key, fn, host)

    for mname in SHARDED_MESHES:
        mesh = meshes.get(mname)
        if mesh is None:
            continue
        for name in TRANSFORMS:
            for lay, (rowwise, helper) in LAYOUTS.items():
                X = transform_operand(rowwise)
                T = make_transform(sk, name, P.Context(seed=7))
                dX = par.distribute(X, getattr(par, helper)(mesh))
                dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
                put(f"{name}/{lay}/{mname}", lambda: T.apply(dX, dim))
        rows = par.row_sharded(mesh)
        A = par.distribute(tsqr_panel(), rows)
        put(f"cqr2/{mname}", lambda: tsqr.cholesky_qr2(A),
            host=lambda r: {"Q": _host(r[0]), "R": _host(r[1])})
        params = nla.ApproximateSVDParams(num_iterations=SVD_Q)
        qr = nla.ApproximateSVDParams(num_iterations=SVD_Q, ortho="qr")
        L = lowrank(256, 64, 4, 6)
        for case, A, prm in (("svd", L, params), ("svd_qr", L, qr),
                             ("svd_wide", np.ascontiguousarray(L.T),
                              params)):
            dA = par.distribute(A, rows)
            put(f"{case}/{mname}",
                lambda: nla.approximate_svd(dA, 4, P.Context(seed=17), prm),
                host=lambda r: {
                    "rec": (_host(r[0]) * _host(r[1])[None]) @ _host(r[2]).T,
                    "S": _host(r[1])})
        A, B = lsqr_problem()
        dA, dB = par.distribute(A, rows), par.distribute(B, rows)
        kp = alg.KrylovParams(tolerance=1e-8, iter_lim=200)
        put(f"lsqr/{mname}", lambda: alg.lsqr(dA, dB, kp),
            host=lambda r: {"X": _host(r[0]), "it": r[1]})
        for case, fn, seed in (("cg", alg.cg, 1), ("fcg", alg.flexible_cg,
                                                    4)):
            A, B = spd(seed=seed)
            dA, dB = par.distribute(A, rows), par.distribute(B, rows)
            kp = alg.KrylovParams(tolerance=1e-10, iter_lim=300)
            put(f"{case}/{mname}", lambda: fn(dA, dB, kp),
                host=lambda r: {"X": _host(r[0]), "it": r[1]})
        A, B = spd(seed=5)
        w = np.linalg.eigvalsh(A)
        dA, dB = par.distribute(A, rows), par.distribute(B, rows)
        put(f"cheb/{mname}", lambda: alg.chebyshev(
            dA, dB, float(w[0]) * 0.9, float(w[-1]) * 1.1,
            alg.KrylovParams(iter_lim=CHEB_ITERS)),
            host=lambda r: _host(r[0]))
        dA = par.distribute(extras_operand(), rows)
        put(f"range_finder/{mname}", lambda: krank.RandomizedRangeFinder(
            dA, "power_iteration", {"s": 8, "q": 1},
            P.Context(seed=21)).compute())
        put(f"krank_svd/{mname}", lambda: krank.randomized_svd(
            dA, 6, P.Context(seed=22), q=1), host=lambda r: _host(r[1]))
        put(f"lobpcg/{mname}", lambda: lobpcg_rand_evd(
            dA, 4, P.Context(seed=23), s=128), host=lambda r: r[0])
        put(f"lowrank/{mname}",
            lambda: plr.approximate_dominant_subspace_basis(
                dA, k=4, s=16, t=24, context=P.Context(seed=24)),
            host=lambda r: _host(r[0]))
    m1 = meshes.get("m1")
    if m1 is not None:
        _gate_cases(P, m1, out)


def _gate_cases(P, mesh, out):
    """Every kernel wrapper handed a DTensor: each refuses it (TypeError)
    before any pointer is taken, and so does the launch gate itself."""
    import torch

    from libskylark_tpu_torch import parallel as par, sketch as sk
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.kernels import launch
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht, cuda_hash,
                                             cuda_sparse)

    key = P.Context(seed=1).allocate().key
    d = par.distribute(normal((8, 256), 3), par.row_sharded(mesh))
    d3 = par.distribute(normal((1, 8, 256), 3), par.replicated(mesh))
    sc = torch.ones(16)
    ff = sk.FastGaussianRFT(256, 16, P.Context(seed=2), fut="wht")
    data = par.distribute(np.ones((1, 4), np.float32), par.replicated(mesh))
    idx = torch.zeros((1, 4), dtype=torch.int64)
    calls = {
        "launch.ptr": lambda: launch.ptr(d),
        "dense_rowwise": lambda: cuda_dense.rowwise_apply(
            key, randgen.Normal(), d, 16, 1.0),
        "dense_columnwise": lambda: cuda_dense.columnwise_apply(
            key, randgen.Normal(), d, 16, 1.0),
        "dense_partial": lambda: cuda_dense.fused_partial(
            key, randgen.Normal(), d, 16, 1, 0),
        "dense_rowwise_cos": lambda: cuda_dense.rft_rowwise_apply(
            key, randgen.Normal(), d, 16, 1.0, 1.0, sc, sc),
        "dense_batched": lambda: cuda_dense.serve_batched_apply(
            np.zeros((1, 2), np.uint32), [1.0], d3, randgen.Normal(), 16,
            True),
        "hash": lambda: cuda_hash.cwt_apply(key, d, 16, True, 3),
        "hash_batched": lambda: cuda_hash.cwt_apply_batched(
            np.zeros((1, 2), np.uint32), d3, 16, True),
        "fwht": lambda: cuda_fwht.srht_apply(key, d, 16, True),
        "fastfood": lambda: cuda_fastfood.features_rows(ff, d),
        "sparse": lambda: cuda_sparse.cwt_sparse_apply_batched(
            np.zeros((1, 2), np.uint32), data, idx, idx, 16, True, (1, 8)),
    }
    for name, call in calls.items():
        try:
            call()
            out[f"gate/{name}"] = np.array("none")
        except TypeError as e:
            out[f"gate/{name}"] = np.array(
                "TypeError" if "to_local()" in str(e) else str(e))


def _sharded_ml_cases(P, meshes, out):
    from libskylark_tpu_torch import parallel as par
    from libskylark_tpu_torch.algorithms.prox import (HingeLoss,
                                                       L2Regularizer,
                                                       SquaredLoss)
    from libskylark_tpu_torch.ml import admm, kernels, krr

    X, Y = ml_data()
    y = (Y > 0).astype(np.int64)
    k = kernels.Gaussian(X.shape[1], sigma=KRR["sigma"])

    def put(key, fn, host=_host):
        _put(out, key, fn, host)

    for mname in ML_MESHES:
        mesh = meshes.get(mname)
        if mesh is None:
            continue
        Xs = par.distribute(X, par.row_sharded(mesh))
        Ys = par.distribute(Y, par.vec_sharded(mesh))
        lam, s = KRR["lam"], KRR["s"]
        put(f"krr/{mname}", lambda: krr.kernel_ridge(k, Xs, Ys, lam))
        put(f"akrr/{mname}", lambda: krr.approximate_kernel_ridge(
            k, Xs, Y, lam, s=s, context=P.Context(seed=3)),
            host=lambda r: _host(r[1]))
        cwt = krr.KrrParams(sketched_rr=True, fast_sketch=True,
                            sketch_size=KRR["t"])
        put(f"akrr_cwt/{mname}", lambda: krr.approximate_kernel_ridge(
            k, Xs, Ys, lam, s=s, context=P.Context(seed=4), params=cwt),
            host=lambda r: _host(r[1]))
        put(f"sakrr/{mname}", lambda: krr.sketched_approximate_kernel_ridge(
            k, Xs, Ys, lam, s=s, context=P.Context(seed=5), t=KRR["t"]),
            host=lambda r: _host(r[1]))

        def linear():
            S = admm.BlockADMMSolver(SquaredLoss(), L2Regularizer(),
                                     ADMM["lam"], X.shape[1],
                                     num_partitions=ADMM["partitions"])
            S.maxiter, S.tol = ADMM["maxiter"], 0.0
            return S.train(Xs, y).coef

        def kernel():
            S = admm.BlockADMMSolver.from_kernel(
                P.Context(seed=6), HingeLoss(), L2Regularizer(),
                ADMM["lam"], ADMM["features"], k, "regular",
                ADMM["partitions"])
            S.maxiter, S.tol = ADMM["maxiter"], 0.0
            return S.train(Xs, y).coef

        put(f"admm/{mname}", linear)
        put(f"admm_kernel/{mname}", kernel)


# -- the split-column (DTensor) cases ----------------------------------------

# the meshes of the split-column group: make_mesh's, and "i22", a 2 × 2
# grid made by torch's init_device_mesh (no group of make_mesh's own)
COLS_MESHES = ("m1", "m2", "m4", "m5", "g22", "i22")
# the transforms whose split-axis route this group holds, each with its
# oracle atol (the reference's TestShardedOracle: max(1e-4, atol))
COLS_TRANSFORMS = {
    "FastGaussianRFT": 1e-4, "FastMaternRFT": 1e-4, "GaussianQRFT": 1e-4,
    "LaplacianQRFT": 1e-3, "ExpSemigroupQRLT": 1e-3, "PPT": 1e-4,
    "RFUT": 1e-4}
# layouts of an operand whose columns are split: col_sharded on every
# mesh, grid2d (rows and columns) on the 2-D ones
COLS_LAYOUTS = ("cols", "grid")
COLS_KERNELS = ("Linear", "Gaussian", "Polynomial", "Laplacian",
                "ExpSemigroup", "Matern")
KRANK = {"s": 8, "q": 1, "eps": 1e-2, "r": 4, "iters": 24}


def make_cols_transform(sk, name, ctx):
    """A transform of :data:`COLS_TRANSFORMS` of either package (N = 128,
    S = 32; RFUT keeps N)."""
    N, S = TN, TS
    return {
        "FastGaussianRFT": lambda: sk.FastGaussianRFT(N, S, ctx, sigma=2.0),
        "FastMaternRFT": lambda: sk.FastMaternRFT(N, S, ctx, nu=1.5, l=2.0),
        "GaussianQRFT": lambda: sk.GaussianQRFT(N, S, ctx, sigma=2.0),
        "LaplacianQRFT": lambda: sk.LaplacianQRFT(N, S, ctx, sigma=64.0),
        "ExpSemigroupQRLT": lambda: sk.ExpSemigroupQRLT(N, S, ctx,
                                                        beta=0.5),
        "PPT": lambda: sk.PPT(N, S, ctx, q=3, c=1.0, gamma=0.5),
        "RFUT": lambda: sk.RFUT(N, ctx, fut="wht"),
    }[name]()


def make_cols_kernel(ml, name, d):
    """A kernel of :data:`COLS_KERNELS` of either package's ml module on
    ``d`` features."""
    return {
        "Linear": lambda: ml.Linear(d),
        "Gaussian": lambda: ml.Gaussian(d, sigma=2.0),
        "Polynomial": lambda: ml.Polynomial(d, q=2, c=1.0, gamma=0.5),
        "Laplacian": lambda: ml.Laplacian(d, sigma=3.0),
        "ExpSemigroup": lambda: ml.ExpSemigroup(d, beta=0.3),
        "Matern": lambda: ml.Matern(d, nu=1.5, l=2.0),
    }[name]()


def gram_operands():
    """X (24 × 10) and Y (18 × 10), nonnegative (ExpSemigroup's domain)."""
    return (np.abs(normal((24, 10), 41)), np.abs(normal((18, 10), 42)))


def sym_operand(n=128, seed=4, psd=False, decay=0.7):
    """A symmetric operand with eigenvalues ±0.7^i
    (tests/test_torch_nla.py's, at n = 128); 0.7^i with ``psd``; another
    ``decay`` in place of 0.7."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = decay ** np.arange(n) * (1 if psd else np.where(np.arange(n) % 3
                                                         == 1, -1, 1))
    A = ((Q * w) @ Q.T).astype(np.float32)
    return (A + A.T) / 2


def _cols_meshes(meshes):
    """(mesh name, mesh) of the group, with the init_device_mesh grid
    (made by every rank, kept by the ranks it holds)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() >= 4:
        i22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("rows", "cols"))
        if i22.get_coordinate() is not None:
            meshes = {**meshes, "i22": i22}
    return [(m, meshes[m]) for m in COLS_MESHES if m in meshes]


def _sharded_cols_cases(P, meshes, out):
    import torch

    from libskylark_tpu_torch import algorithms as alg, ml, nla
    from libskylark_tpu_torch import parallel as par, sketch as sk
    from libskylark_tpu_torch.algorithms.prox import (L2Regularizer,
                                                       SquaredLoss)
    from libskylark_tpu_torch.base import errors
    from libskylark_tpu_torch.base.sparse import linear_ops
    from libskylark_tpu_torch.nla import krank, lowrank as plr, tsqr
    from libskylark_tpu_torch.nla.randlobpcg import (
        lobpcg_rand_evd, power_iterations_rand_evd)

    def put(key, fn, host=_host):
        _put(out, key, fn, host)

    for mname, mesh in _cols_meshes(meshes):
        grid = mesh.ndim == 2
        for name in COLS_TRANSFORMS:
            for lay, (rowwise, helper) in LAYOUTS.items():
                # FastMaternRFT differs from FastGaussianRFT only in its
                # Gamma-drawn scales, slow on the CPU: one layout
                if ((lay == "rw_grid" and not grid)
                        or (name == "FastMaternRFT" and lay != "rw_cols")):
                    continue
                X = transform_operand(rowwise)
                T = make_cols_transform(sk, name, P.Context(seed=7))
                dX = par.distribute(X, getattr(par, helper)(mesh))
                dim = sk.ROWWISE if rowwise else sk.COLUMNWISE
                put(f"{name}/{lay}/{mname}", lambda: T.apply(dX, dim))
        for lay in COLS_LAYOUTS[: 1 + grid]:
            sh = par.col_sharded(mesh) if lay == "cols" else par.grid2d(mesh)
            key = f"{mname}/{lay}"
            A = par.distribute(tsqr_panel(), sh)
            put(f"cqr2/{key}", lambda: tsqr.cholesky_qr2(A),
                host=lambda r: {"Q": _host(r[0]), "R": _host(r[1]),
                                "Q_local": r[0].to_local().numpy()})
            A, B = lsqr_problem()
            dA = par.distribute(A, sh)
            mv, rmv = linear_ops(dA)
            put(f"mv/{key}", lambda: mv(torch.from_numpy(B[:24])))
            put(f"rmv/{key}", lambda: rmv(torch.from_numpy(B)))
            put(f"lsqr/{key}", lambda: alg.lsqr(dA, B, alg.KrylovParams(
                tolerance=1e-8, iter_lim=200)),
                host=lambda r: {"X": _host(r[0]), "it": r[1]})
            # a right-hand side whose columns are split: each rank would
            # hold other columns of it, so it is refused
            dB = par.distribute(B, par.col_sharded(mesh))
            try:
                alg.lsqr(dA, dB, alg.KrylovParams(iter_lim=2))
                out[f"split_rhs/{key}"] = np.asarray("")
            except errors.InvalidParametersError as e:
                out[f"split_rhs/{key}"] = np.asarray(type(e).__name__)
            for case, fn, seed in (("cg", alg.cg, 1),
                                   ("fcg", alg.flexible_cg, 4)):
                A, B = spd(seed=seed)
                dA = par.distribute(A, sh)
                kp = alg.KrylovParams(tolerance=1e-10, iter_lim=300)
                put(f"{case}/{key}", lambda: fn(dA, B, kp),
                    host=lambda r: {"X": _host(r[0]), "it": r[1]})
            X, Y = gram_operands()
            dX, dY = par.distribute(X, sh), par.distribute(Y, sh)
            for kname in COLS_KERNELS:
                k = make_cols_kernel(ml, kname, X.shape[1])
                put(f"gram/{kname}/{key}", lambda: k.gram(dX))
                put(f"gram_xy/{kname}/{key}", lambda: k.gram(dX, Y))
                put(f"gram_whole_x/{kname}/{key}", lambda: k.gram(X, dY))
            X, Y = ml_data()
            y = (Y > 0).astype(np.int64)
            dX = par.distribute(X, sh)
            k = ml.Gaussian(X.shape[1], sigma=KRR["sigma"])
            lam, s = KRR["lam"], KRR["s"]
            put(f"krr/{key}", lambda: ml.kernel_ridge(k, dX, Y, lam))
            put(f"akrr/{key}", lambda: ml.approximate_kernel_ridge(
                k, dX, Y, lam, s=s, context=P.Context(seed=3)),
                host=lambda r: _host(r[1]))
            cwt = ml.KrrParams(sketched_rr=True, fast_sketch=True,
                               sketch_size=KRR["t"])
            put(f"akrr_cwt/{key}", lambda: ml.approximate_kernel_ridge(
                k, dX, Y, lam, s=s, context=P.Context(seed=4), params=cwt),
                host=lambda r: _host(r[1]))

            # the other regimes take the same exchange, then the row
            # routes that test_torch_sharded_ml.py holds

            def linear():
                S = ml.BlockADMMSolver(SquaredLoss(), L2Regularizer(),
                                       ADMM["lam"], X.shape[1],
                                       num_partitions=ADMM["partitions"])
                S.maxiter, S.tol = ADMM["maxiter"], 0.0
                return S.train(dX, y).coef

            put(f"admm/{key}", linear)
            dA = par.distribute(extras_operand(), sh)
            put(f"lobpcg/{key}", lambda: lobpcg_rand_evd(
                dA, 4, P.Context(seed=23), s=128), host=lambda r: r[0])
            put(f"power_evd/{key}", lambda: power_iterations_rand_evd(
                dA, 4, P.Context(seed=25), power_iters=2),
                host=lambda r: _host(r[0]))
            put(f"range_finder/{key}", lambda: krank.RandomizedRangeFinder(
                dA, "power_iteration", {"s": KRANK["s"], "q": KRANK["q"]},
                P.Context(seed=21)).compute())
            put(f"krank_svd/{key}", lambda: krank.randomized_svd(
                dA, 6, P.Context(seed=22), q=1), host=lambda r: _host(r[1]))
            put(f"adaptive/{key}", lambda: krank.RandomizedRangeFinder(
                dA, "adaptive", {"epsilon": KRANK["eps"], "r": KRANK["r"],
                                 "max_iters": KRANK["iters"]},
                P.Context(seed=26)).compute())
            Q = krank.RandomizedRangeFinder(
                extras_operand(), "power_iteration", {"s": 8, "q": 1},
                P.Context(seed=27)).compute()
            put(f"row_extraction/{key}", lambda: krank.RangeAssistedSVD(
                dA, Q, "row_extraction").compute(),
                host=lambda r: _host(r[1]))
            put(f"lowrank/{key}",
                lambda: plr.approximate_dominant_subspace_basis(
                    dA, k=4, s=16, t=24, context=P.Context(seed=24)),
                host=lambda r: _host(r[0]))
            dL = par.distribute(lowrank(256, 64, 4, 6), sh)
            put(f"svd/{key}", lambda: nla.approximate_svd(
                dL, 4, P.Context(seed=17),
                nla.ApproximateSVDParams(num_iterations=SVD_Q)),
                host=lambda r: {
                    "rec": (_host(r[0]) * _host(r[1])[None]) @ _host(r[2]).T,
                    "S": _host(r[1])})
            dS = par.distribute(sym_operand(psd=True), sh)
            Qs = krank.RandomizedRangeFinder(
                sym_operand(psd=True), "power_iteration", {"s": 8, "q": 2},
                P.Context(seed=28)).compute()
            for method in ("direct", "nystrom"):
                put(f"evd_{method}/{key}", lambda: krank.RangeAssistedEVD(
                    dS, Qs, method).compute(), host=lambda r: _host(r[0]))
            dS = par.distribute(sym_operand(), sh)
            params = nla.ApproximateSVDParams(num_iterations=SVD_Q)
            put(f"sym_svd/{key}", lambda: nla.approximate_symmetric_svd(
                dS, 4, P.Context(seed=29), params),
                host=lambda r: {"V": _host(r[0]), "S": _host(r[1])})
            dS = par.distribute(sym_operand(decay=SKIP_QR["decay"]), sh)
            put(f"sym_svd_skip_qr/{key}", lambda: sym_svd_skip_qr(nla, P, dS),
                host=lambda r: {"V": _host(r[0]), "S": _host(r[1])})
        # the symmetric SVD on a row-sharded operand too (its range
        # sketch takes B1-rw on each rank's rows)
        dS = par.distribute(sym_operand(), par.row_sharded(mesh))
        params = nla.ApproximateSVDParams(num_iterations=SVD_Q)
        put(f"sym_svd/{mname}/rows", lambda: nla.approximate_symmetric_svd(
            dS, 4, P.Context(seed=29), params),
            host=lambda r: {"V": _host(r[0]), "S": _host(r[1])})
        dS = par.distribute(sym_operand(decay=SKIP_QR["decay"]),
                            par.row_sharded(mesh))
        put(f"sym_svd_skip_qr/{mname}/rows",
            lambda: sym_svd_skip_qr(nla, P, dS),
            host=lambda r: {"V": _host(r[0]), "S": _host(r[1])})


# the symmetric SVD with skip_qr: eigenvalues ±0.3^i, so that A²·S (no
# first orthonormalization) is too ill-conditioned for f32 CholeskyQR2
SKIP_QR = {"decay": 0.3, "rank": 8, "q": 1, "seed": 31}


def sym_svd_skip_qr(nla, P, A):
    """approximate_symmetric_svd of ``A`` at SKIP_QR's settings (rank 8,
    one power iteration, skip_qr=True)."""
    return nla.approximate_symmetric_svd(
        A, SKIP_QR["rank"], P.Context(seed=SKIP_QR["seed"]),
        nla.ApproximateSVDParams(num_iterations=SKIP_QR["q"], skip_qr=True))


def io_libsvm_lines(n: int = 23, d: int = 9, targets: int = 1,
                    seed: int = 5) -> list:
    """A seeded libsvm text (``n`` lines, features 1..d, 0-4 nonzeros a
    row on a 1/4 grid, ``targets`` label columns), as a list of lines."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ys = " ".join(str(int(y)) for y in rng.integers(0, 3, targets))
        cols = np.sort(rng.choice(d, rng.integers(0, 5), replace=False))
        feats = " ".join(f"{c + 1}:{0.25 * rng.integers(-8, 9)}"
                         for c in cols)
        lines.append(f"{ys} {feats}".rstrip() + "\n")
    return lines


# read_libsvm_sharded cases: name -> (mesh, axis, lines kwargs, reader
# kwargs, source: "path", "stream" or "stream_dims")
IO_CASES = {
    "m2_rows": ("m2", "rows", {}, {"batch_rows": 4}, "path"),
    "m4_ragged": ("m4", "rows", {"n": 6}, {"batch_rows": 5}, "path"),
    "g22_rows": ("g22", "rows", {"targets": 2}, {"batch_rows": 7}, "path"),
    "g22_cols": ("g22", "cols", {}, {"batch_rows": 3}, "path"),
    "m4_stream_max_n": ("m4", "rows", {}, {"batch_rows": 6, "max_n": 17},
                        "stream_dims"),
}


def _io_sharded_cases(P, meshes, out):
    """read_libsvm_sharded on each case's mesh, from a path (each rank
    writes its own copy) or a one-shot stream with ``dims`` from a scan
    of another copy; every rank stores the whole X and Y, and its own
    block's row count under ``rows/``."""
    from libskylark_tpu_torch import io as pio
    from libskylark_tpu_torch import parallel as par

    outdir = os.environ["SKYLARK_TEST_OUTDIR"]
    import torch.distributed as dist

    rank = dist.get_rank()
    for name, (mname, axis, lkw, rkw, src) in IO_CASES.items():
        mesh = meshes.get(mname)
        if mesh is None:
            continue
        lines = io_libsvm_lines(**lkw)
        if src == "path":
            path = os.path.join(outdir, f"{name}.{rank}.libsvm")
            with open(path, "w") as fh:
                fh.writelines(lines)
            X, Y = pio.read_libsvm_sharded(path, mesh, axis=axis, **rkw)
        else:
            dims = pio.scan_libsvm_dims(iter(lines))
            X, Y = pio.read_libsvm_sharded(iter(lines), mesh, axis=axis,
                                           dims=dims, **rkw)
        out[f"x/{name}"] = par.to_host(X)
        out[f"y/{name}"] = par.to_host(Y)
        out[f"rows/{name}"] = np.asarray(X.to_local().shape[0])


def serve_mesh_operands(n_reqs: int = 16, seed: int = 11):
    """The reference's ``_ragged_sketch_reqs`` operands
    (tests/test_serve.py:57): request i is a JLT of input dim
    40 + 9·(i % 3) to 16 under ``Context(seed)``, built in order, on an
    (n, 3 + i % 4) operand."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reqs):
        n = 40 + (i % 3) * 9
        out.append((n, rng.standard_normal((n, 3 + i % 4)).astype(
            np.float32)))
    return out


def serve_mesh_krr(seed: int = 12):
    """The reference's sharded KRR data (tests/test_serve.py:609): X (32,
    4), Y (32, 1) and 12 query blocks of 3-6 rows."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((32, 4)).astype(np.float32)
    Y = rng.standard_normal((32, 1)).astype(np.float32)
    queries = [rng.standard_normal((3 + i % 4, 4)).astype(np.float32)
               for i in range(12)]
    return X, Y, queries


def _serve_mesh_cases(P, meshes, out):
    """The mesh executor on the (2,) and (4,) meshes: rank 0 (the front)
    serves the reference's 16 ragged JLT requests and 12 KRR predicts,
    a cohort with a request poisoned at the front's ``serve.flush`` and one
    poisoned at a follower's ``serve.mesh_block``, then drains; every
    follower first tries a submit (which must raise), then shuts down.
    Rank 0 also serves the same requests on a one-rank executor."""
    import torch.distributed as dist

    from libskylark_tpu_torch import engine, ml, sketch as sk
    from libskylark_tpu_torch.base import errors
    from libskylark_tpu_torch.resilience import faults
    from libskylark_tpu_torch.sketch import params

    # the reference's test holds its executor's f32 route to T.apply at
    # 1e-5; the port's plain route follows B1's regime (bf16x3 is held to
    # 1e-4, ROADMAP C2), so this group runs the f32 regime
    params.set_kernel_precision("f32")
    rank = dist.get_rank()
    ops = serve_mesh_operands()
    X, Y, queries = serve_mesh_krr()
    k = ml.Gaussian(4, sigma=1.5)
    coef = ml.kernel_ridge(k, X, Y, 0.1, device="cpu")

    def transforms():
        ctx = P.Context(seed=11)
        return [sk.JLT(n, 16, ctx) for n, _ in ops]

    def serve(ex, tag):
        futs = [ex.submit_sketch(T, A) for T, (_, A) in zip(transforms(),
                                                              ops)]
        futs += [ex.submit_krr_predict(k, q, X, coef) for q in queries]
        ex.flush()
        for i, f in enumerate(futs):
            out[f"{tag}/{i}"] = f.result(timeout=120).numpy()

    def poisoned(ex, site, tag):
        plan = faults.FaultPlan({"seed": 3, "faults": [
            {"site": site, "error": "SketchError", "tag": "poison"}]})
        Ts = transforms()
        futs = []
        with faults.fault_plan(plan):
            for i in range(4):
                if i == 1:
                    with faults.tag("poison"):
                        futs.append(ex.submit_sketch(Ts[i], ops[i][1]))
                else:
                    futs.append(ex.submit_sketch(Ts[i], ops[i][1]))
            ex.flush()
        errs = [type(f.exception(timeout=120)).__name__
                if f.exception(timeout=120) is not None else ""
                for f in futs]
        out[f"{tag}/errors"] = np.asarray(errs)
        for i, e in enumerate(errs):
            if not e:
                out[f"{tag}/ok/{i}"] = futs[i].result().numpy()

    if rank == 0:
        out["coef"] = coef.numpy()
        with engine.MicrobatchExecutor(max_batch=8, linger_us=10_000_000,
                                       device="cpu") as one:
            serve(one, "one")
    # the follower's own plan: its block fails where the front's cohort
    # carries the tag
    follower_plan = faults.FaultPlan({"seed": 3, "faults": [
        {"site": "serve.mesh_block", "error": "SketchError",
         "tag": "poison"}]})
    for mname in ("m2", "m4"):
        mesh = meshes.get(mname)
        if mesh is not None:
            ex = engine.MicrobatchExecutor(max_batch=8,
                                           linger_us=10_000_000, mesh=mesh,
                                           device="cpu", name=mname)
            if rank == 0:
                serve(ex, mname)
                poisoned(ex, "serve.flush", f"{mname}/front_fault")
                poisoned(ex, "serve.mesh_block", f"{mname}/follower_fault")
                st = ex.stats()
                out[f"{mname}/caps"] = np.asarray(
                    sorted(st["batch_capacity_hist"]))
                out[f"{mname}/flush_failures"] = np.asarray(
                    st["flush_failures"])
                out[f"{mname}/drained"] = np.asarray(ex.drain(timeout=60))
            else:
                try:
                    ex.submit_sketch(transforms()[0], ops[0][1])
                    out[f"{mname}/follower_submit"] = np.asarray("")
                except errors.MeshError as e:
                    out[f"{mname}/follower_submit"] = np.asarray(str(e))
                with faults.fault_plan(follower_plan):
                    ex.shutdown()
                out[f"{mname}/follower_alive"] = np.asarray(
                    ex._follower.is_alive())
            m = ex.stats()["mesh"]
            out[f"{mname}/mesh"] = np.asarray(
                [m["ndev"], m["coordinate"], m["flushes"],
                 m["failed_flushes"]])
            out[f"{mname}/lanes"] = np.asarray(sorted(m["lanes_hist"]))
        dist.barrier()


TASKS = {"parallel": _parallel_cases, "dist_sparse": _dist_sparse_cases,
         "sharded": _sharded_cases, "sharded_ml": _sharded_ml_cases,
         "sharded_cols": _sharded_cols_cases,
         "io_sharded": _io_sharded_cases, "serve_mesh": _serve_mesh_cases}


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    task, outdir = sys.argv[4], sys.argv[5]
    sys.path.insert(0, os.path.dirname(HERE))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch.parallel import make_mesh, multihost

    P.set_default_device("cpu")
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     connect_timeout=60.0)
    meshes = {}
    for name, (shape, n) in MESHES.items():
        if n > world:
            continue
        m = make_mesh(shape, devices=list(range(n)))
        if rank < n:
            meshes[name] = m
    out: dict = {}
    TASKS[task](P, meshes, out)
    np.savez(os.path.join(outdir, f"{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "libskylark_tpu" not in sys.modules


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(task: str, world: int = WORLD, timeout: float = 240.0):
    """Spawn ``world`` rank processes on ``task``; returns each rank's
    results as a dict (raises with the ranks' output if one fails). A
    group whose free port was taken before rank 0 bound it is spawned
    once more on another."""
    try:
        return _run_group(task, world, timeout)
    except RuntimeError as e:
        if "address already in use" not in str(e).lower():
            raise
        return _run_group(task, world, timeout)


def _run_group(task: str, world: int, timeout: float):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as outdir:
        env["SKYLARK_TEST_OUTDIR"] = outdir
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
             str(r), str(world), str(port), task, outdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError(
                f"{task} group failed: rcs {[p.returncode for p in procs]}\n"
                + "\n".join(log[-4000:] for log in logs))
        results = []
        for r in range(world):
            with np.load(os.path.join(outdir, f"{r}.npz")) as z:
                results.append({k: z[k] for k in z.files})
        return results


if __name__ == "__main__":
    main()
