#!/usr/bin/env python3
"""Where the time goes on the port's main path (libskylark_tpu_torch).

Run from the root of a checkout, with one CUDA card: ``python3
chip_profile.py``. For each main-path cell of chip_smoke.py — JLT.apply
rowwise and columnwise on 8192×8192 → 1024, approximate_svd of the SVD
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
ratio, and ``requests_per_s`` = requests / warm time.

It ends with the card's name and power limit as nvidia-smi gives them.
It exits non-zero without a CUDA device. It imports neither jax nor
libskylark_tpu.
"""

from __future__ import annotations

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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(chip_smoke.ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import algorithms, nla, sketch as sk
    from libskylark_tpu_torch.kernels import build

    build.build()
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
    for name, row in chip_smoke.serve_cells(torch, np).items():
        print(json.dumps({"cell": f"serve-{name}", **row}), flush=True)
    chip_smoke.check("jax" not in sys.modules
                     and "libskylark_tpu" not in sys.modules,
                     "the port imported jax or libskylark_tpu")
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
