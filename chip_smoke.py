#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (libskylark_tpu_torch).

Run from the root of a checkout, with one CUDA card: ``python3
chip_smoke.py``. In order, each phase printing one JSON line:

1. env    — torch and CUDA versions, the card, and the peak rates of the
            bound, derived from the card's own attributes;
2. build  — every kernel in csrc/ built from source with nvcc (sm_90a);
3. check  — each kernel's wrapper on the card against its plain PyTorch
            version on the same inputs, three distributions, main-path,
            aligned and ragged shapes: max|kernel − plain| ≤ 1e-4·max|plain|;
4. main   — the main path at full size through the public entry points
            (JLT.apply both ways on 8192×8192 → 1024; approximate_svd of an
            8192×8192 matrix with a known spectrum, rank 64, k' = 128;
            approximate_least_squares(sketch="jlt") on 65536×512), with
            every launch counter set to 0 before and read after;
5. time   — CUDA-event medians of each kernel, its plain version and the
            PyTorch matmul against a pre-made S, beside the card's bound,
            at the main-path shapes (and, for comparison, least squares'
            sketch as the two launches S·A, S·b that one on [A|b] replaces);
6. the ``{"kernels": [...]}`` line, the card's name and power limit, and
   ``{"ok": true, ...}`` as the last line.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero without a CUDA device, and when it does not sit in a
checkout of the repository. It imports neither jax nor libskylark_tpu.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4  # the reference's oracle, relative to max|plain|
# The kernels sum over n in another order than cuBLAS (n = 8192 gives
# ≈ √n·2⁻²⁴ ≈ 5e-6 relative) and CUDA's log1pf/tanf may round an entry
# differently from torch's by ~1e-7 relative: both far inside 1e-4.


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# NVIDIA's data sheet for one H100 SXM at its full 700 W (dense): fp32
# outside the tensor cores, and HBM3 bandwidth. Printed beside the peaks
# of the attached card, which the bound uses.
DATASHEET_H100_SXM = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
FP32_LANES_PER_SM = {9: 128}  # Hopper: 128 fp32 FMA units per SM


def card_peaks(torch) -> dict:
    """The attached card's peak rates, from its own attributes: fp32 FMA
    lanes × 2 × SM count × max SM clock, and 2 (double data rate) × max
    memory clock × bus width. The kernels run fp32 FMA on the CUDA cores,
    so their bound is the larger of flops over the first and bytes over
    the second."""
    import ctypes

    torch.cuda.init()
    major = torch.cuda.get_device_properties(0).major
    check(major in FP32_LANES_PER_SM,
          f"no fp32 lane count for compute capability {major}.x")
    names = [f"libcudart.so.{torch.version.cuda.split('.')[0]}",
             "libcudart.so", "/usr/local/cuda/lib64/libcudart.so"]
    for name in names:
        try:
            rt = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError(f"chip_smoke: no CUDA runtime among {names}")

    def attr(code: int) -> int:
        v = ctypes.c_int()
        rc = rt.cudaDeviceGetAttribute(ctypes.byref(v), code,
                                       torch.cuda.current_device())
        check(rc == 0 and v.value > 0, f"cudaDeviceGetAttribute({code}): "
              f"error {rc}, value {v.value}")
        return v.value

    # cudaDevAttr: ClockRate 13 and MemoryClockRate 36 in kHz,
    # MultiProcessorCount 16, GlobalMemoryBusWidth 37 in bits
    sm_hz, sms = attr(13) * 1e3, attr(16)
    mem_hz, bus_bits = attr(36) * 1e3, attr(37)
    return {"fp32_flops": 2.0 * FP32_LANES_PER_SM[major] * sms * sm_hz,
            "hbm_bytes_per_s": 2.0 * mem_hz * bus_bits / 8,
            "sms": sms, "sm_clock_mhz": sm_hz / 1e6,
            "mem_clock_mhz": mem_hz / 1e6, "bus_bits": bus_bits}


def make_operand(torch, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.float32)


def svd_operand(torch):
    """The SVD cell's 8192×8192 matrix of rank 512 with singular values
    0.95^i and random singular vectors, built on the card; returns
    (A, sigma)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    r = 512
    U0 = torch.linalg.qr(torch.randn(8192, r, generator=g, device="cuda"))[0]
    V0 = torch.linalg.qr(torch.randn(8192, r, generator=g, device="cuda"))[0]
    sigma = 0.95 ** torch.arange(r, device="cuda", dtype=torch.float32)
    return (U0 * sigma) @ V0.T, sigma


def ls_operands(torch):
    """The least-squares cell: A 65536×512 and b = A·x0 + 0.1·noise."""
    A = make_operand(torch, (65536, 512), 3)
    x0 = make_operand(torch, (512,), 4)
    return A, A @ x0 + 0.1 * make_operand(torch, (65536,), 5)


def compare(torch, cd, key, dist, A, s_dim, scale, rowwise):
    """Max abs and relative error of one wrapper call against the plain
    version on the same inputs."""
    fn = cd.rowwise_apply if rowwise else cd.columnwise_apply
    got = fn(key, dist, A, s_dim, scale)
    want = cd.dense_apply_plain(key, dist, A, s_dim, scale, rowwise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    return err, err / ref


def check_kernels(torch, P, cases) -> dict:
    """Phase 3: every case against the plain version; returns the worst
    error per (kernel, shape)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    dists = {"normal": randgen.Normal(), "cauchy": randgen.Cauchy(),
             "rademacher": randgen.Rademacher()}
    results = []
    for i, (name, dist, shape, s_dim) in enumerate(cases):
        rowwise = name == "dense_rowwise"
        key = P.Context(100 + i).allocate().key
        A = make_operand(torch, shape, 1000 + i)
        err, rel = compare(torch, cd, key, dists[dist], A, s_dim,
                           1.0 / math.sqrt(s_dim), rowwise)
        results.append({"kernel": name, "dist": dist, "shape": list(shape),
                        "s_dim": s_dim, "max_abs_err": err,
                        "max_rel_err": rel, "ok": rel <= TOL})
        del A
    emit("check", tolerance=f"max|kernel-plain| <= {TOL} * max|plain|",
         cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return {(r["kernel"], tuple(r["shape"]), r["s_dim"], r["dist"]): r
            for r in results}


def main_path(torch, P) -> dict:
    """Phase 4: the main path at full size through the public API."""
    from libskylark_tpu_torch import nla, sketch as sk
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    for k in cd.launches:
        cd.launches[k] = 0
    out = {}

    # 1. JLT both ways: BASELINE config 1 at the headline size
    A = make_operand(torch, (8192, 8192), 1)
    T = sk.JLT(8192, 1024, P.Context(42))
    t0 = time.perf_counter()
    Yr = T.apply(A, sk.ROWWISE)
    Yc = T.apply(A, sk.COLUMNWISE)
    torch.cuda.synchronize()
    out["jlt_seconds"] = time.perf_counter() - t0
    launches_jlt = dict(cd.launches)
    check(tuple(Yr.shape) == (8192, 1024) and tuple(Yc.shape) == (1024, 8192),
          "JLT output shapes")
    check(bool(torch.isfinite(Yr).all() and torch.isfinite(Yc).all()),
          "JLT output not finite")
    for name, Y, rowwise in (("rowwise", Yr, True), ("columnwise", Yc, False)):
        want = cd.dense_apply_plain(T.allocation.key, T.dist, A, 1024,
                                    T.scale, rowwise)
        out[f"jlt_{name}_rel_err"] = float((Y - want).abs().max()
                                           / want.abs().max())
        check(out[f"jlt_{name}_rel_err"] <= TOL, f"JLT {name} vs plain")
    # JL property: squared row norms kept on average (E‖S a‖² = ‖a‖²)
    out["jlt_norm_ratio"] = float((Yr.square().sum(1)
                                   / A.square().sum(1)).mean())
    check(abs(out["jlt_norm_ratio"] - 1.0) < 0.01, "JLT norm ratio")
    del A, Yr, Yc, want

    # 2. randomized SVD at rank 64 (k' = 128) of the SVD cell's matrix
    k = 64
    A, sigma = svd_operand(torch)
    params = nla.ApproximateSVDParams(num_iterations=2)
    t0 = time.perf_counter()
    U, S, V = nla.approximate_svd(A, k, P.Context(43), params)
    torch.cuda.synchronize()
    out["svd_seconds"] = time.perf_counter() - t0
    check(tuple(U.shape) == (8192, k) and tuple(S.shape) == (k,)
          and tuple(V.shape) == (8192, k), "SVD output shapes")
    out["svd_sigma_rel_err"] = float(((S - sigma[:k]).abs() / sigma[:k]).max())
    recon = float(torch.linalg.norm(A - (U * S) @ V.T) / torch.linalg.norm(A))
    tail = float(torch.linalg.norm(sigma[k:]) / torch.linalg.norm(sigma))
    out["svd_recon_rel"], out["svd_recon_optimal"] = recon, tail
    check(out["svd_sigma_rel_err"] <= 1e-3, "SVD sigma rel err > 1e-3")
    check(recon <= 1.01 * tail + 1e-4, "SVD reconstruction above bound")
    del A, U, V

    # 3. sketch-and-solve least squares, s = 4·512
    A, b = ls_operands(torch)
    t0 = time.perf_counter()
    x = nla.approximate_least_squares(A, b, P.Context(44), sketch="jlt")
    torch.cuda.synchronize()
    out["ls_seconds"] = time.perf_counter() - t0
    check(tuple(x.shape) == (512,) and bool(torch.isfinite(x).all()),
          "least squares output")
    x_ls = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    out["ls_residual"] = float(torch.linalg.norm(A @ x - b))
    out["ls_residual_lstsq"] = float(torch.linalg.norm(A @ x_ls - b))
    out["ls_residual_ratio"] = out["ls_residual"] / out["ls_residual_lstsq"]
    # Gaussian sketch-and-solve: E ratio ≈ sqrt(1 + n/(s − n)) ≈ 1.15
    check(out["ls_residual_ratio"] <= 1.5, "LS residual ratio > 1.5")
    del A, b

    out["launches"] = dict(cd.launches)
    out["launches_jlt"] = launches_jlt
    emit("main", **out)
    for k_, v in cd.launches.items():
        check(v > 0, f"kernel {k_} never launched on the main path")
    return out


def event_ms(torch, fn, reps=10, warmup=3) -> float:
    """Median device time of one call: an event pair around each of
    ``reps`` back-to-back calls, one synchronize at the end, so the host
    runs ahead and its own work between calls is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def time_kernels(torch, P, shapes, main_path: bool,
                 peaks: dict) -> list[dict]:
    """Phase 5: kernel, plain and library times at the given shapes."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    dist = randgen.Normal()
    rows = []
    for name, use, shape, s_dim in shapes:
        rowwise = name == "dense_rowwise"
        A = make_operand(torch, shape, 7)
        key = P.Context(9).allocate().key
        scale = 1.0 / math.sqrt(s_dim)
        n, m = (shape[1], shape[0]) if rowwise else shape
        fn = cd.rowwise_apply if rowwise else cd.columnwise_apply
        ms = event_ms(torch, lambda: fn(key, dist, A, s_dim, scale))
        plain_ms = event_ms(torch, lambda: cd.dense_apply_plain(
            key, dist, A, s_dim, scale, rowwise))
        S = virtual_panel(key, dist, s_dim, 0, n, scale, device=A.device)
        lib = (lambda: torch.matmul(A, S.T)) if rowwise else (
            lambda: torch.matmul(S, A))
        library_ms = event_ms(torch, lib)
        # A and the key table read once, the output written once
        flops = 2.0 * m * n * s_dim
        nbytes = 4.0 * (m * n + m * s_dim) + 8.0 * -(-n // 256)
        t_ops = flops / peaks["fp32_flops"] * 1e3
        t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
        rows.append({"kernel": name, "use": use, "main_path": main_path,
                     "shape": list(shape),
                     "s_dim": s_dim, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes})
        del A, S
    return rows


# (kernel, use, A's shape, s_dim); A is (m, N) rowwise, (N, m) columnwise
MAIN_SHAPES = [
    ("dense_rowwise", "JLT.apply rowwise", (8192, 8192), 1024),
    ("dense_rowwise", "SVD range sketch", (8192, 8192), 128),
    ("dense_columnwise", "JLT.apply columnwise", (8192, 8192), 1024),
    ("dense_columnwise", "least squares S·[A|b]", (65536, 513), 2048),
]
# Timed only: least squares' sketch as two launches, S·A then S·b, which
# the one launch on [A|b] replaces.
SPLIT_LS_SHAPES = [
    ("dense_columnwise", "S·A alone", (65536, 512), 2048),
    ("dense_columnwise", "S·b alone", (65536, 1), 2048),
]


def check_cases() -> list:
    cases = [(name, "normal", shape, s) for name, _, shape, s in MAIN_SHAPES]
    for dist in ("normal", "cauchy", "rademacher"):
        cases += [("dense_rowwise", dist, (37, 700), 48),
                  ("dense_columnwise", dist, (700, 37), 48),
                  ("dense_rowwise", dist, (8192, 1024), 1024),
                  ("dense_columnwise", dist, (1024, 8192), 1024),
                  ("dense_rowwise", dist, (1000, 3000), 300),
                  ("dense_columnwise", dist, (3000, 1000), 300)]
    return cases


KERNELS = {
    "dense_rowwise": "libskylark_tpu/sketch/pallas_dense.py:396",
    "dense_columnwise": "libskylark_tpu/sketch/pallas_dense.py:480",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import libskylark_tpu_torch as P

    check(Path(P.__file__).resolve().parent.parent == ROOT,
          f"libskylark_tpu_torch imported from {P.__file__}, not {ROOT}")
    from libskylark_tpu_torch.kernels import build

    card = smi("name,power.limit")
    peaks = card_peaks(torch)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=card,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), peaks=peaks,
         datasheet_h100_sxm=DATASHEET_H100_SXM)

    t0 = time.perf_counter()
    report = build.build(force=True)
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": v["seconds"],
                      "ptxas": [ln for ln in v["ptxas"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    checked = check_kernels(torch, P, check_cases())
    main = main_path(torch, P)
    rows = (time_kernels(torch, P, MAIN_SHAPES, True, peaks)
            + time_kernels(torch, P, SPLIT_LS_SHAPES, False, peaks))
    emit("time", method="CUDA events around each of 10 back-to-back calls "
                        "after 3 warm-ups, median",
         library="torch.matmul against S made beforehand, TF32 off: the "
                 "contraction alone, without generation",
         rows=rows)

    kernels = []
    for name, replaces in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name and r["main_path"]]
        head = mine[0]
        # the worst check over this kernel's main-path shapes
        cs = [checked[(name, tuple(r["shape"]), r["s_dim"], "normal")]
              for r in mine]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "libskylark_tpu_torch/csrc/dense_sketch.cu",
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "max_rel_err": max(c["max_rel_err"] for c in cs),
            "shape": head["shape"], "s_dim": head["s_dim"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    check("jax" not in sys.modules and "libskylark_tpu" not in sys.modules,
          "the port imported jax or libskylark_tpu")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
