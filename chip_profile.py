#!/usr/bin/env python3
"""Where the time goes on the port's main path (libskylark_tpu_torch).

Run from the root of a checkout, with one CUDA card: ``python3
chip_profile.py``. For each main-path cell of chip_smoke.py — JLT.apply
rowwise and columnwise, CWT.apply and FJLT(fut="wht").apply rowwise, on
8192×8192 → 1024, approximate_svd of the SVD
cell's 8192×8192 matrix at rank 64 (k' = 128, two power iterations),
approximate_least_squares on 65536×512 with the JLT, the default FJLT and
the CWT, solve_l2_sketched with FJLT(fut="wht") (the SRHT) on the same
operands, fast_least_squares (Blendenpik) on chip_smoke.py's 65536×512
matrix with singular values over [1e-3, 1], and config 3's random
features on X 16384×4096 → 4096 (GaussianRFT with σ = 64, the Fastfood
FastGaussianRFT, and GaussianQRFT, whose W is built once on the host, as
its construction does, and moved to the card by every apply), and B1's
batched columnwise launch at the ct-cw serve bucket's capacity-8 shape
(8 × 8192×128 → 1024, Cauchy, new keys per call) — it prints one JSON
line with:

- ``warm_ms``: median host time of 5 calls after 2 warm-ups, each call
  ended by ``torch.cuda.synchronize()``. Every call of a cell draws its
  transform from the cell's one Context, which advances, so each call
  has a new key, as a user solving again from one Context does;
- ``profiled_ms``, ``device_ms``: one more call under ``torch.profiler``:
  its host time (which includes the profiler's own cost) and the device
  time summed over its kernels;
- ``busy``: ``device_ms / warm_ms``, the device's busy share of a warm
  call made without the profiler;
- ``top``: the profiled call's kernels by device time, in ms;
- for Blendenpik, and for LSQR alone on Blendenpik's preconditioner,
  ``iterations`` (LSQR's) and ``idle_ms_per_iteration`` = (warm_ms −
  device_ms) / iterations. For LSQR alone that is the card's idle time
  per iteration: the host's launches and the stopping test's read, which
  synchronises once per iteration.

Then one ``serve-<bucket>`` line per bucket of chip_smoke.py's serve
phase (``chip_smoke.serve_cells``): ``warm_ms``, the median host time of
one synchronous capacity-8 flush of the bucket's requests through a
MicrobatchExecutor on the card (capacity 4 for the smaller buckets),
``device_ms`` its kernels' time under torch.profiler, ``busy`` their
ratio, and ``requests_per_s`` = requests / warm time. The same for each
bucket of the serve-solve phase (``chip_smoke.serve_solve_cells``:
``serve-solve-jlt``, ``serve-solve-cwt``, ``serve-sparse-solve-cwt``,
``serve-sparse-solve-jlt``, ``serve-cmm-srht``, ``serve-cmm-cwt-sparse``,
``serve-lowrank``, ``serve-krr-predict``, ``serve-rlsc-predict``,
``serve-condest``, ``serve-graph-ase``, ``serve-graph-ppr``), at capacity
8 (4 for the sparse solves). Then the cache and residency cells of the
serve-solve-jlt bucket with its operands on the host
(``chip_smoke.serve_qos_cells``): ``serve-solve-jlt-hit``, the warm ms of
one request served from the cache (its digest, ``digest_ms``, the lookup
and the clone); ``serve-solve-jlt-resident``, a capacity-8 flush of
submits by OperandRef; ``serve-solve-jlt-by-value``, the same flush with A
shipped from the host by every lane; each with its H2D bytes per flush by
operand.

Then one ``sparse-<cell>`` line per timed entry point of chip_smoke.py's
sparse phase (config 2, ``sparse_cells``): each transform's rowwise apply
of the 20,242×47,236 CSR (JLT, CT, UST and CWT → 1024, GaussianRFT and
LaplacianRFT → 4096), approximate_svd of the weighted operand at rank 64
(q = 2), and on the 262,144×1,024 CSR: approximate_least_squares (CWT),
Blendenpik and LSRN (with ``iterations`` and ``idle_ms_per_iteration``),
sparse_solve_serve (CWT, s = 4096; JLT, s = 2048) and condest (on the
host), with the same fields as above.

Then one ``ml-<cell>`` line per solver of chip_smoke.py's ml phase
(config 5 at MNIST's shape, ``ml_cells``): approximate_kernel_rlsc at s =
8192, large_scale_kernel_rlsc over 4 blocks, faster_kernel_rlsc on
16,384 rows with the s = 2048 preconditioner, and BlockADMMSolver's 10
iterations, with the same fields as above; the BCD and the PCG also with
``iterations`` (sweeps, CG iterations) and ``idle_ms_per_iteration``, the
card's idle time per iteration, where the host reads the stopping test.

Then one ``compiled-<entry>`` line per entry of chip_smoke.py's compiled
phase (``chip_smoke.compiled_cells``: approximate_svd, the symmetric SVD,
sketch-and-solve by JLT, CWT and FJLT(wht), the Blendenpik and LSRN
preconditioner builds, approximate_kernel_ridge, kernel_ridge and
krr_predict at the phase's full width): ``cold_ms`` (the first call:
warm-up and CUDA-graph capture), ``replay_warm_ms``/``replay_device_ms``/
``replay_busy`` of the CompiledFn's hit beside ``eager_warm_ms``/
``eager_device_ms``/``eager_busy`` of its body called directly, and the
graph's ``pool_bytes``; every check of the phase holds there too.

Then one ``a3-<cell>`` line per cell of chip_smoke.py's a3 phase
(``a3_cells``): MaternRFT and FastMaternRFT (ν = 1.5, l = 64) on config
3's X 16384×4096 → 4096, each call drawing its Gamma scales on the card;
BlockADMMSolver's 10 iterations on Matern(784, ν = 1.5) at config 5;
randomized_svd at rank 64 (q = 2) of the 8192² gap operand;
lobpcg_rand_evd (CWT) on the 65536×512 least-squares operand, whose
LOBPCG runs on the host; approximate_ase (k = 6, q = 2, the sparse route)
of the scale-18 R-MAT graph; rand_block_fcg on the 16,384-row Gaussian
Gram system, with ``iterations`` and ``idle_ms_per_iteration``; the same
fields as above.

Then two ``dist-<cell>`` lines, A5's explicit half: ``dist-shard-ls``,
the least-squares sketch S·[A | b] (65536 × 513 → 2048) as 4 ranks
emulated in this process (each rank's partial kernel at its own block
offset, scaled and summed in rank order, a new key per call), and
``dist-sparse-svd``, approximate_svd (rank 64, q = 2) of chip_smoke.py's
weighted config-2 CSR as a DistSparseMatrix on two gloo processes
sharing the card (rank 0's figures; rank 1's beside them); the same
fields as above.

Then three ``sharded-<cell>`` lines, A5b: ``sharded-lsqr`` (LSQR on the
65536 × 512 least-squares operand), ``sharded-svd`` (approximate_svd,
rank 64, q = 2, of the 8192² SVD operand) and ``sharded-krr``
(approximate_kernel_ridge at config 5, s = 8192), each operand
row-sharded over two gloo processes sharing the card (rank 0's figures,
rank 1's times beside them), the same fields as above, plus the
collectives one call issues (``collectives``, ``collective_bytes``: a
rank's bytes into them) and ``one_process_warm_ms`` /
``one_process_device_ms``: the same call on the whole operands, timed on
rank 0 while rank 1 waits.

``python3 chip_profile.py --lobpcg-seeds R`` prints instead, for R
rounds of Context seeds, the a3 phase's randlobpcg measures for each
sketch (``lobpcg_spread``): the spread across seeds of what the phase
holds to its limits.

It ends with the card's name and power limit as nvidia-smi gives them.
It exits non-zero without a CUDA device. It imports neither jax nor
libskylark_tpu.
"""

from __future__ import annotations

import io
import json
import statistics
import sys
import time

import chip_smoke


def warm_ms(torch, fn, reps=5, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_call(torch, fn, top=8) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:90]] = (by_name.get(e.name[:90], 0.0)
                                    + e.time_range.elapsed_us() / 1e3)
    device = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"profiled_ms": wall, "device_ms": device,
            "top": [[name, ms] for name, ms in ranked]}


def sparse_cells(torch, P, np) -> dict:
    """The timed entry points of chip_smoke.py's sparse phase on its
    operands, each call with a new key from the cell's one Context."""
    import scipy.sparse as sp

    from libskylark_tpu_torch import algorithms, nla, sketch as sk
    from libskylark_tpu_torch.base import sprand
    from libskylark_tpu_torch.base.sparse import SparseMatrix, spmm
    from libskylark_tpu_torch.sketch import sparse_serve

    cs = chip_smoke
    A = sprand.sample(cs.RCV1_N, cs.RCV1_D, cs.RCV1_DENSITY, cs.DYADIC,
                      (1, 1, 1), P.Context(70))
    c, q = cs.SVD_WEIGHT
    W = SparseMatrix.from_scipy(sp.diags(1.0 + c * q ** np.arange(cs.RCV1_N))
                                @ A.to_scipy())
    m, n, dens = cs.SPARSE_LS
    L = sprand.sample(m, n, dens, cs.DYADIC, (1, 1, 1), P.Context(81))
    g = torch.Generator(device="cuda").manual_seed(82)
    b = (spmm(L, torch.randn(n, generator=g, device="cuda"))
         + 0.1 * torch.randn(m, generator=g, device="cuda"))
    data, indices, indptr = (t.clone() for t in L.csr())
    ctx = {seed: P.Context(seed) for seed in range(300, 320)}
    cells = {}
    for i, (name, s, kw) in enumerate(cs.SPARSE_SKETCHES):
        cells[f"{name.lower()}_rowwise_rcv1_to_{s}"] = (
            lambda name=name, s=s, kw=kw, i=i: getattr(sk, name)(
                cs.RCV1_D, s, ctx[300 + i], **kw).apply(A, sk.ROWWISE))
    params = nla.ApproximateSVDParams(num_iterations=2)
    cells["svd_rcv1_weighted_rank64_q2"] = (
        lambda: nla.approximate_svd(W, 64, ctx[310], params))
    cells[f"lstsq_cwt_{m}x{n}_s{4 * n}"] = (
        lambda: nla.approximate_least_squares(L, b, ctx[311]))
    cells[f"blendenpik_{m}x{n}"] = (
        lambda: algorithms.solve_l2_accelerated(L, b, ctx[312]))
    cells[f"lsrn_{m}x{n}"] = (
        lambda: algorithms.solve_l2_accelerated(L, b, ctx[313],
                                                method="lsrn"))
    for name, s, seed in (("CWT", 4 * n, 314), ("JLT", 2 * n, 315)):
        def solve(name=name, s=s, seed=seed):
            T = getattr(sk, name)(m, s, ctx[seed])
            return sparse_serve.sparse_solve_serve(
                T.allocation.key, getattr(T, "scale", 1.0), data, indices,
                indptr, b[:, None], sketch_type=name, s_dim=s, method="qr",
                shape=(m, n))
        cells[f"serve_solve_{name.lower()}_{m}x{n}_s{s}"] = solve
    cells[f"condest_{m}x{n}_host"] = (
        lambda: nla.estimate_condition(L, ctx[316]))
    return cells


def ml_cells(torch, P) -> dict:
    """The ml phase's four solvers on its data (config 5 at MNIST's
    shape), each call with a new key from the cell's one Context: name ->
    (fn, log) where ``fn(log)`` runs the solver once, logging to ``log``
    when it is given (the iteration count: CG iterations or BCD sweeps;
    ADMM runs a fixed count)."""
    from libskylark_tpu_torch import ml
    from libskylark_tpu_torch.algorithms import prox

    cs = chip_smoke
    size = cs.ML_FULL
    X, y, _, _ = cs.ml_data(torch, size, "cuda")
    k = cs.ml_kernel(ml, size)
    s, rows = size["s"], size["faster_rows"]
    ctx = {seed: P.Context(seed) for seed in range(620, 624)}

    def params(log, **kw):
        return ml.RlscParams(am_i_printing=log is not None, log_level=3,
                             log_stream=log, **kw)

    def admm(log):
        solver = ml.BlockADMMSolver.from_kernel(
            ctx[623], prox.HingeLoss(), prox.L2Regularizer(), cs.ADMM_LAM,
            s, k, num_partitions=size["partitions"])
        solver.maxiter, solver.tol = size["admm_iters"], 0.0
        return solver.train(X, y)

    return {
        f"rlsc_approximate_{size['n']}x{size['d']}_s{s}":
            lambda log: ml.approximate_kernel_rlsc(
                k, X, y, cs.ML_LAM, s, ctx[620], params(log)),
        f"rlsc_large_scale_{size['n']}x{size['d']}_s{s}_4blocks":
            lambda log: ml.large_scale_kernel_rlsc(
                k, X, y, cs.ML_LAM, s, ctx[621], params(
                    log, max_split=size["max_split"],
                    tolerance=cs.ML_BCD_TOLERANCE)),
        f"rlsc_faster_{rows}x{size['d']}_s{size['faster_s']}":
            lambda log: ml.faster_kernel_rlsc(
                k, X[:rows], y[:rows], cs.ML_LAM, size["faster_s"],
                ctx[622], params(log, tolerance=cs.ML_CG_TOLERANCE)),
        f"admm_{size['n']}x{size['d']}_s{s}_{size['admm_iters']}it": admm,
    }


def a3_cells(torch, P, np) -> dict:
    """The a3 phase's cells on its operands, each call with a new key from
    the cell's one Context: name -> fn."""
    from libskylark_tpu_torch import algorithms, ml, nla, sketch as sk
    from libskylark_tpu_torch.algorithms import krylov, prox

    cs = chip_smoke
    size = cs.A3_FULL
    d, s, k = size["rft_d"], size["rft_s"], size["rank"]
    X = cs.a3_matern_operand(torch, size, "cuda")
    asz = size["admm"]
    Xa, ya, _, _ = cs.ml_data(torch, asz, "cuda")
    matern = ml.Matern(asz["d"], nu=size["admm_nu"],
                       l=(asz["latent"] * asz["d"]) ** 0.5)
    Ak = cs.a3_krank_operand(torch, size, "cuda")[0]
    Als = cs.a3_lobpcg_operand(torch, size, "cuda")
    G = cs.a3_graph(ml, np, size)[0]
    Kb, Bb = cs.a3_block_system(torch, ml, size, "cuda")
    ctx = {seed: P.Context(seed) for seed in range(780, 787)}
    ase = nla.ApproximateSVDParams(num_iterations=2, oversampling_ratio=2)
    kprm = krylov.KrylovParams(tolerance=size["fcg_tolerance"],
                               iter_lim=size["fcg_iter_lim"])

    def admm():
        solver = ml.BlockADMMSolver.from_kernel(
            ctx[782], prox.HingeLoss(), prox.L2Regularizer(), cs.ADMM_LAM,
            asz["s"], matern, num_partitions=asz["partitions"])
        solver.maxiter, solver.tol = asz["admm_iters"], 0.0
        return solver.train(Xa, ya)

    def lobpcg():
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return nla.lobpcg_rand_evd(Als, size["evd_k"], ctx[784],
                                       sketch="cwt")

    return {
        "matern-rft": lambda: sk.MaternRFT(
            d, s, ctx[780], nu=1.5, l=d ** 0.5).apply(X, sk.ROWWISE),
        "fast-matern": lambda: sk.FastMaternRFT(
            d, s, ctx[781], nu=1.5, l=d ** 0.5).apply(X, sk.ROWWISE),
        "admm-matern": admm,
        "krank": lambda: nla.randomized_svd(Ak, k, ctx[783], q=2),
        "lobpcg-cwt": lobpcg,
        "graph-ase": lambda: ml.approximate_ase(G, size["ase_k"], ctx[785],
                                                ase, sparse=True),
        "asynch-fcg": lambda: algorithms.asynch.rand_block_fcg(
            Kb, Bb, ctx[786], algorithms.asynch.RandBlockParams(), kprm),
    }


def lobpcg_spread(torch, P, np, rounds: int) -> None:
    """The a3 phase's randlobpcg measures (chip_smoke.lobpcg_values) over
    ``rounds`` sets of Context seeds: round r gives sketch j (CWT, JLT,
    FJLT) the seed 740 + 3r + j, so round 0 is the phase's own. One JSON
    line per sketch and round."""
    import warnings

    from libskylark_tpu_torch import nla

    cs = chip_smoke
    size = cs.A3_FULL
    k = size["evd_k"]
    A = cs.a3_lobpcg_operand(torch, size, "cuda")
    lam = torch.linalg.svdvals(A.double())[:k] ** 2
    for r in range(rounds):
        for j, name in enumerate(("cwt", "jlt", "fjlt")):
            seed = 740 + 3 * r + j
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got, _ = nla.lobpcg_rand_evd(A, k, P.Context(seed),
                                             sketch=name)
            host_s = time.perf_counter() - t0
            vals = cs.lobpcg_values(torch, np, P, A, k, name, seed, got, lam,
                                    "cuda")
            print(json.dumps({"cell": f"lobpcg-spread-{name}",
                              "context_seed": seed, "seconds": host_s,
                              **vals}), flush=True)


def dist_shard_ls(torch, P):
    """The emulated 4-rank least-squares sketch: a new key per call."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    way, shape, s = chip_smoke.DIST_SHAPES[0]
    A = chip_smoke.make_operand(torch, shape, 4000)
    p = chip_smoke.DIST_TIME_P
    bps = shape[0] // (p * 256)
    shards = [A[r * bps * 256:(r + 1) * bps * 256] for r in range(p)]
    ctx, d, scale = P.Context(470), randgen.Normal(), s ** -0.5

    def run():
        key = ctx.allocate().key
        total = scale * cd.fused_partial(key, d, shards[0], s, 0, 0)
        for r in range(1, p):
            total += scale * cd.fused_partial(key, d, shards[r], s, 0,
                                              r * bps)
        return total
    return run


def dist_svd_child(rank: int, world: int, port: int) -> int:
    """One gloo rank of the ``dist-sparse-svd`` cell: prints its row."""
    import numpy as np
    import torch

    sys.path.insert(0, str(chip_smoke.ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import nla, parallel as par
    from libskylark_tpu_torch.base.dist_sparse import distribute_sparse
    from libskylark_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     connect_timeout=120.0, backend="gloo")
    _, W, _ = chip_smoke.dist_operands(torch, P, np)
    D = distribute_sparse(W, par.make_mesh((world, 1)), row_axis="rows",
                          col_axis="cols")
    ctx, params = P.Context(480), nla.ApproximateSVDParams(num_iterations=2)

    def fn():
        return nla.approximate_svd(D, 64, ctx, params)
    row = {"rank": rank, "warm_ms": warm_ms(torch, fn)}
    row.update(profile_call(torch, fn))
    row["busy"] = row["device_ms"] / row["warm_ms"]
    print("DIST_ROW " + json.dumps(row), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_sparse_svd() -> dict:
    """Spawn the two ranks of ``dist-sparse-svd``; rank 0's row, rank
    1's beside it."""
    import subprocess

    world, port = 2, chip_smoke.free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--dist-svd-child", str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    chip_smoke.check(all(p.returncode == 0 for p in procs),
                     "dist-sparse-svd rank failed:\n"
                     + "\n".join(x[-3000:] for x in logs))
    rows = [json.loads(next(ln for ln in x.splitlines()
                            if ln.startswith("DIST_ROW "))[9:])
            for x in logs]
    return {**rows[0], "rank1": {k: rows[1][k] for k in
                                 ("warm_ms", "device_ms", "busy")}}


def sharded_child(rank: int, world: int, port: int) -> int:
    """One gloo rank of the ``sharded-*`` cells (A5b): LSQR on the
    least-squares operand, approximate_svd (rank 64, q = 2) of the SVD
    operand, and approximate_kernel_ridge at config 5, each on its
    operands row-sharded over the two ranks; per cell the warm and
    profiled times, the collectives one call issues (count and bytes) and,
    on rank 0 while rank 1 waits, the same call's one-process time."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(chip_smoke.ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import algorithms as alg, ml, nla
    from libskylark_tpu_torch import parallel as par
    from libskylark_tpu_torch.parallel import mesh as pmesh, multihost

    torch.cuda.set_device(0)
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     connect_timeout=120.0, backend="gloo")
    size = chip_smoke.SHARDED_FULL
    ops = chip_smoke.sharded_operands(torch, size, "cuda")
    rows = par.row_sharded(par.make_mesh())
    d = {k: par.distribute(ops[k], rows) for k in ("A", "b", "S", "X", "Y")}
    kern = chip_smoke.ml_kernel(ml, size["ml"])
    lsqr = alg.KrylovParams(tolerance=size["lsqr_tolerance"],
                            iter_lim=size["lsqr_iter_lim"])
    svd = nla.ApproximateSVDParams(num_iterations=size["q"])
    ctx = {name: P.Context(seed) for name, seed in
           (("lsqr", 520), ("svd", 521), ("krr", 522))}
    cells = {
        "lsqr": lambda o: alg.lsqr(o["A"], o["b"], lsqr),
        "svd": lambda o: nla.approximate_svd(o["S"], size["rank"],
                                             ctx["svd"], svd),
        "krr": lambda o: ml.approximate_kernel_ridge(
            kern, o["X"], o["Y"], chip_smoke.ML_LAM, size["ml"]["s"],
            ctx["krr"]),
    }
    for name, fn in cells.items():
        row = {"cell": f"sharded-{name}", "rank": rank,
               "warm_ms": warm_ms(torch, lambda: fn(d))}
        row.update(profile_call(torch, lambda: fn(d)))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        for k in pmesh.collectives:
            pmesh.collectives[k] = pmesh.collective_bytes[k] = 0
        fn(d)
        row["collectives"] = dict(pmesh.collectives)
        row["collective_bytes"] = dict(pmesh.collective_bytes)
        dist.barrier()
        if rank == 0:
            row["one_process_warm_ms"] = warm_ms(torch, lambda: fn(ops))
            row.update({f"one_process_{k}": v for k, v in profile_call(
                torch, lambda: fn(ops)).items() if k == "device_ms"})
        dist.barrier()
        print("SHARDED_ROW " + json.dumps(row), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_cells() -> list:
    """Spawn the two ranks of the ``sharded-*`` cells; rank 0's rows, rank
    1's times beside them."""
    import subprocess

    world, port = 2, chip_smoke.free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--sharded-child", str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    chip_smoke.check(all(p.returncode == 0 for p in procs),
                     "sharded cell rank failed:\n"
                     + "\n".join(x[-3000:] for x in logs))
    rows = [[json.loads(ln[12:]) for ln in x.splitlines()
             if ln.startswith("SHARDED_ROW ")] for x in logs]
    return [{**r0, "rank1": {k: r1[k] for k in
                             ("warm_ms", "device_ms", "busy")}}
            for r0, r1 in zip(*rows)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-svd-child"]:
        return dist_svd_child(*(int(a) for a in sys.argv[2:5]))
    if sys.argv[1:2] == ["--sharded-child"]:
        return sharded_child(*(int(a) for a in sys.argv[2:5]))
    sys.path.insert(0, str(chip_smoke.ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import algorithms, nla, sketch as sk
    from libskylark_tpu_torch.kernels import build

    build.build()
    if "--lobpcg-seeds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--lobpcg-seeds") + 1])
        lobpcg_spread(torch, P, np, rounds)
        print(chip_smoke.smi("name,power.limit"), flush=True)
        return 0
    A = chip_smoke.make_operand(torch, (8192, 8192), 1)
    Asvd, _ = chip_smoke.svd_operand(torch)
    Als, b = chip_smoke.ls_operands(torch)
    Ak, bk = chip_smoke.kappa_operands(torch)
    X = chip_smoke.make_operand(torch, chip_smoke.RFT_SHAPE, 12)
    d, s = chip_smoke.RFT_SHAPE[1], chip_smoke.RFT_S
    qrft = sk.GaussianQRFT(d, s, P.Context(62), sigma=64.0)
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense

    Acw = chip_smoke.make_operand(torch, (8, 8192, 128), 9000)
    lanes = P.Context(900)
    params = nla.ApproximateSVDParams(num_iterations=2)
    # one advancing Context per cell: every call has a new key
    ctx = {seed: P.Context(seed) for seed in range(42, 62)}
    # LSQR alone, on Blendenpik's own preconditioner and tolerance
    accel = algorithms.AcceleratedParams()
    precond, _ = algorithms.build_blendenpik_precond(Ak, P.Context(50),
                                                     accel)
    lsqr_params = algorithms.KrylovParams(tolerance=accel.tolerance)
    cells = {
        "jlt_rowwise_8192x8192_to_1024":
            lambda: sk.JLT(8192, 1024, ctx[42]).apply(A, sk.ROWWISE),
        "jlt_columnwise_8192x8192_to_1024":
            lambda: sk.JLT(8192, 1024, ctx[48]).apply(A, sk.COLUMNWISE),
        "cwt_rowwise_8192x8192_to_1024":
            lambda: sk.CWT(8192, 1024, ctx[49]).apply(A, sk.ROWWISE),
        "fjlt_wht_rowwise_8192x8192_to_1024":
            lambda: sk.FJLT(8192, 1024, ctx[51], fut="wht").apply(
                A, sk.ROWWISE),
        "svd_8192x8192_rank64_q2":
            lambda: nla.approximate_svd(Asvd, 64, ctx[43], params),
        "lstsq_jlt_65536x512_s2048":
            lambda: nla.approximate_least_squares(Als, b, ctx[44],
                                                  sketch="jlt"),
        "lstsq_fjlt_65536x512_s2048":
            lambda: nla.approximate_least_squares(Als, b, ctx[45]),
        "lstsq_cwt_65536x512_s2048":
            lambda: nla.approximate_least_squares(Als, b, ctx[46],
                                                  sketch="cwt"),
        "lstsq_srht_65536x512_s2048":
            lambda: algorithms.solve_l2_sketched(
                Als, b, sk.FJLT(65536, 2048, ctx[47], fut="wht")),
        "blendenpik_65536x512_kappa1e3":
            lambda: nla.fast_least_squares(Ak, bk, ctx[50]),
        "lsqr_blendenpik_precond_65536x512_kappa1e3":
            lambda: algorithms.lsqr(Ak, bk, params=lsqr_params,
                                    precond=precond),
        "rft_gauss_16384x4096_to_4096":
            lambda: sk.GaussianRFT(d, s, ctx[60], sigma=64.0).apply(
                X, sk.ROWWISE),
        "fastfood_16384x4096_to_4096":
            lambda: sk.FastGaussianRFT(d, s, ctx[61], sigma=64.0).apply(
                X, sk.ROWWISE),
        "qrft_16384x4096_to_4096": lambda: qrft.apply(X, sk.ROWWISE),
        "b1_batched_columnwise_8x8192x128_to_1024":
            lambda: cuda_dense.serve_batched_apply(
                chip_smoke.new_keys(np, lanes, 8), np.full(8, 1 / 1024), Acw,
                randgen.Cauchy(), 1024, False),
    }
    for name, fn in cells.items():
        row = {"cell": name, "warm_ms": warm_ms(torch, fn)}
        row.update(profile_call(torch, fn))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        if "blendenpik" in name:
            row["iterations"] = fn()[1]
            row["idle_ms_per_iteration"] = ((row["warm_ms"] - row["device_ms"])
                                            / row["iterations"])
        print(json.dumps(row), flush=True)
    del A, Asvd, Als, b, Ak, bk, X, qrft, precond, Acw
    # the cells reach the solver entry points through the executable
    # cache: each group ends by dropping its graphs
    chip_smoke.release_cache(torch)
    for name, row in chip_smoke.serve_cells(torch, np).items():
        print(json.dumps({"cell": f"serve-{name}", **row}), flush=True)
    for name, row in chip_smoke.serve_solve_cells(torch, P, np).items():
        print(json.dumps({"cell": f"serve-{name}", **row}), flush=True)
    for name, row in chip_smoke.serve_qos_cells(torch, P, np).items():
        print(json.dumps({"cell": f"serve-{name}", **row}), flush=True)
    for name, fn in sparse_cells(torch, P, np).items():
        row = {"cell": f"sparse-{name}", "warm_ms": warm_ms(torch, fn)}
        row.update(profile_call(torch, fn))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        if name.startswith(("blendenpik", "lsrn")):
            row["iterations"] = fn()[1]
            row["idle_ms_per_iteration"] = ((row["warm_ms"] - row["device_ms"])
                                            / row["iterations"])
        print(json.dumps(row), flush=True)
    for name, fn in ml_cells(torch, P).items():
        row = {"cell": f"ml-{name}",
               "warm_ms": warm_ms(torch, lambda: fn(None))}
        row.update(profile_call(torch, lambda: fn(None)))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        log = io.StringIO()
        fn(log)
        iterations = chip_smoke.ml_iterations(log.getvalue())
        if iterations is not None:
            row["iterations"] = iterations
            row["idle_ms_per_iteration"] = (
                (row["warm_ms"] - row["device_ms"]) / row["iterations"])
        print(json.dumps(row), flush=True)
    chip_smoke.release_cache(torch)
    entries, _ = chip_smoke.compiled_cells(torch, P)
    for name, row in entries.items():
        print(json.dumps({"cell": f"compiled-{name}", **row}), flush=True)
    chip_smoke.release_cache(torch)
    for name, fn in a3_cells(torch, P, np).items():
        row = {"cell": f"a3-{name}", "warm_ms": warm_ms(torch, fn)}
        row.update(profile_call(torch, fn))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        if name == "asynch-fcg":
            row["iterations"] = fn()[1]
            row["idle_ms_per_iteration"] = ((row["warm_ms"] - row["device_ms"])
                                            / row["iterations"])
        print(json.dumps(row), flush=True)
    chip_smoke.release_cache(torch)
    fn = dist_shard_ls(torch, P)
    row = {"cell": "dist-shard-ls", "warm_ms": warm_ms(torch, fn)}
    row.update(profile_call(torch, fn))
    row["busy"] = row["device_ms"] / row["warm_ms"]
    print(json.dumps(row), flush=True)
    del fn
    print(json.dumps({"cell": "dist-sparse-svd", **dist_sparse_svd()}),
          flush=True)
    for row in sharded_cells():
        print(json.dumps(row), flush=True)
    chip_smoke.check("jax" not in sys.modules
                     and "libskylark_tpu" not in sys.modules,
                     "the port imported jax or libskylark_tpu")
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
