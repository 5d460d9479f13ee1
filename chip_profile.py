#!/usr/bin/env python3
"""Where the time goes on the port's main path (libskylark_tpu_torch).

Run from the root of a checkout, with one CUDA card: ``python3
chip_profile.py``. For each main-path cell of chip_smoke.py — JLT.apply
rowwise and columnwise on 8192×8192 → 1024, approximate_svd of the SVD
cell's 8192×8192 matrix at rank 64 (k' = 128, two power iterations), and
approximate_least_squares(sketch="jlt") on 65536×512 — it prints one JSON
line with:

- ``warm_ms``: median host time of 5 calls after 2 warm-ups, each call
  ended by ``torch.cuda.synchronize()``;
- ``profiled_ms``, ``device_ms``: one more call under ``torch.profiler``:
  its host time (which includes the profiler's own cost) and the device
  time summed over its kernels;
- ``busy``: ``device_ms / warm_ms``, the device's busy share of a warm
  call made without the profiler;
- ``top``: the profiled call's kernels by device time, in ms.

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
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(chip_smoke.ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import nla, sketch as sk
    from libskylark_tpu_torch.kernels import build

    build.build()
    A = chip_smoke.make_operand(torch, (8192, 8192), 1)
    T = sk.JLT(8192, 1024, P.Context(42))
    Asvd, _ = chip_smoke.svd_operand(torch)
    Als, b = chip_smoke.ls_operands(torch)
    params = nla.ApproximateSVDParams(num_iterations=2)
    cells = {
        "jlt_rowwise_8192x8192_to_1024": lambda: T.apply(A, sk.ROWWISE),
        "jlt_columnwise_8192x8192_to_1024":
            lambda: T.apply(A, sk.COLUMNWISE),
        "svd_8192x8192_rank64_q2":
            lambda: nla.approximate_svd(Asvd, 64, P.Context(43), params),
        "lstsq_jlt_65536x512_s2048":
            lambda: nla.approximate_least_squares(Als, b, P.Context(44),
                                                  sketch="jlt"),
    }
    for name, fn in cells.items():
        row = {"cell": name, "warm_ms": warm_ms(torch, fn)}
        row.update(profile_call(torch, fn))
        row["busy"] = row["device_ms"] / row["warm_ms"]
        print(json.dumps(row), flush=True)
    chip_smoke.check("jax" not in sys.modules
                     and "libskylark_tpu" not in sys.modules,
                     "the port imported jax or libskylark_tpu")
    print(chip_smoke.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
