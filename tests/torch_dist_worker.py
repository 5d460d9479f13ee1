"""Rank worker of the port's distributed tests (imports no jax).

``python torch_dist_worker.py <rank> <world> <port> <task> <outdir>``
joins a gloo group of ``world`` CPU processes through the port's own
bootstrap (``parallel.multihost.initialize_distributed``), builds every
mesh of :data:`MESHES` (each over the first ranks of the group), runs
every case of ``task`` ("parallel" or "dist_sparse") on the meshes this
rank belongs to, and writes the results as ``<outdir>/<rank>.npz``: a
numpy array per case, or the name of the exception class a case asks to
see. The test files spawn one group per file (:func:`run_group`), hold
rank 0's results against the JAX package in the pytest process, and
check that every rank of a mesh returned the same value.

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
# name -> (shape, ranks): the group shapes (1,), (2,), (4,), (5,) and (2, 2)
MESHES = {"m1": ((1,), 1), "m2": ((2,), 2), "m4": ((4,), 4),
          "m5": ((5,), 5), "g22": ((2, 2), 4)}
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


TASKS = {"parallel": _parallel_cases, "dist_sparse": _dist_sparse_cases}


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
