#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (libskylark_tpu_torch).

Run from the root of a checkout, with one CUDA card: ``python3
chip_smoke.py``. In order, each phase printing one JSON line:

1. env    — torch and CUDA versions, the card, and the peak rates of the
            bound, derived from the card's own attributes;
2. build  — every kernel in csrc/ built from source with nvcc (sm_90a),
            one nvcc per source, all started together;
3. check  — each kernel's wrapper on the card against its plain PyTorch
            version on the same inputs, at main-path, aligned and ragged
            shapes:
            - dense (B1): three distributions, max|kernel − plain| ≤
              1e-4·max|plain|;
            - hash (B2): bit-equal (torch.equal) to the plain scatter run
              on a CPU copy of the operand, also at a span that is not a
              power of two (s = 300) and at ragged n;
            - fwht (B5): bit-equal on dyadic data (integers in [−8, 8],
              n = 4096, s = 256), ≤ 1e-4·max|plain| on Gaussian data;
4. main   — the main path at full size through the public entry points,
            with every launch counter set to 0 before and read after:
            JLT.apply both ways on 8192×8192 → 1024; approximate_svd of an
            8192×8192 matrix with a known spectrum, rank 64, k' = 128;
            approximate_least_squares on 65536×512, s = 2048, with the JLT,
            the default FJLT (DCT mixer, cuFFT: no kernel) and the CWT;
            solve_l2_sketched with FJLT(fut="wht"); fast_least_squares
            (Blendenpik over the FJLT) and solve_l2_accelerated
            (simplified_blendenpik, lsrn) on a 65536×512 matrix with
            singular values over [1e-3, 1]; CWT and FJLT(fut="wht") applied
            rowwise on 8192×8192 → 1024;
5. time   — CUDA-event medians of each kernel, its plain version and one
            PyTorch call computing the same function, beside the card's
            bound, at the main-path shapes; every timed call of a kernel
            or a plain version draws a new key from one Context, as a
            user solving again does;
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


def kappa_operands(torch):
    """The accelerated cell: A 65536×512 = U·diag(σ)·Vᵀ with σ spread
    evenly in log over [1e-3, 1] and random orthonormal U, V, and b =
    A·x0 + 0.1·noise."""
    g = torch.Generator(device="cuda").manual_seed(6)
    U = torch.linalg.qr(torch.randn(65536, 512, generator=g,
                                    device="cuda"))[0]
    V = torch.linalg.qr(torch.randn(512, 512, generator=g, device="cuda"))[0]
    sigma = torch.logspace(0, -3, 512, device="cuda")
    A = (U * sigma) @ V.T
    x0 = torch.randn(512, generator=g, device="cuda")
    return A, A @ x0 + 0.1 * torch.randn(65536, generator=g, device="cuda")


def lstsq_residual(torch, A, b) -> float:
    """‖A·x − b‖ at the exact least-squares solution, solved in float64."""
    x = torch.linalg.lstsq(A.double(), b.double()[:, None]).solution
    return float(torch.linalg.norm(A.double() @ x[:, 0] - b.double()))


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


def check_hash(torch, P, cases) -> dict:
    """Phase 3, B2: each case bit-equal to the plain scatter on a CPU
    copy of the operand (which adds in increasing coordinate order; CUDA's
    index_add_ uses atomics and has no order)."""
    from libskylark_tpu_torch.sketch import cuda_hash as ch

    results = []
    for i, (name, shape, s_dim) in enumerate(cases):
        rowwise = name == "hash_rowwise"
        key = P.Context(200 + i).allocate().key
        A = make_operand(torch, shape, 2000 + i)
        got = ch.cwt_apply(key, A, s_dim, rowwise).cpu()
        want = ch.cwt_apply_plain(key, A.cpu(), s_dim, rowwise)
        results.append({"kernel": name, "shape": list(shape), "s_dim": s_dim,
                        "bit_equal": bool(torch.equal(got, want)),
                        "max_abs_err": float((got - want).abs().max())})
        del A
    emit("check", tolerance="B2: torch.equal with the plain scatter on a "
                            "CPU copy", cases=results)
    bad = [r for r in results if not r["bit_equal"]]
    check(not bad, f"CountSketch kernel differs from its plain version: {bad}")
    return {(r["kernel"], tuple(r["shape"]), r["s_dim"]): r for r in results}


def check_fwht(torch, P, cases) -> dict:
    """Phase 3, B5: dyadic cases bit-equal to the plain version on the
    card, Gaussian ones within TOL·max|plain|."""
    from libskylark_tpu_torch.sketch import cuda_fwht as cf

    results = []
    for i, (name, shape, s_dim, dyadic) in enumerate(cases):
        rowwise = name == "fwht_rowwise"
        key = P.Context(300 + i).allocate().key
        if dyadic:
            g = torch.Generator(device="cuda").manual_seed(3000 + i)
            A = torch.randint(-8, 9, shape, generator=g,
                              device="cuda").float()
        else:
            A = make_operand(torch, shape, 3000 + i)
        got = cf.srht_apply(key, A, s_dim, rowwise)
        want = cf.srht_apply_plain(key, A, s_dim, rowwise)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "SRHT kernel output not finite")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ok = bool(torch.equal(got, want)) if dyadic else rel <= TOL
        results.append({"kernel": name, "shape": list(shape), "s_dim": s_dim,
                        "dyadic": dyadic, "max_abs_err": err,
                        "max_rel_err": rel, "ok": ok})
        del A
    emit("check", tolerance=f"B5: torch.equal on dyadic data, else "
                            f"max|kernel-plain| <= {TOL} * max|plain|",
         cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"SRHT kernel disagrees with its plain version: {bad}")
    return {(r["kernel"], tuple(r["shape"]), r["s_dim"]): r for r in results}


def counters():
    """Every kernel wrapper's launch counter dict."""
    from libskylark_tpu_torch.sketch import cuda_dense, cuda_fwht, cuda_hash

    return [cuda_dense.launches, cuda_hash.launches, cuda_fwht.launches]


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def main_path(torch, P) -> dict:
    """Phase 4: the main path at full size through the public API."""
    from libskylark_tpu_torch import algorithms, nla, sketch as sk
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    for c in counters():
        for k in c:
            c[k] = 0
    out = {"launches_by_step": {}}

    def step(name, fn):
        """Run one step timed, and record the launches it made."""
        before = launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
        out["launches_by_step"][name] = {
            k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}
        return result

    # 1. JLT both ways: BASELINE config 1 at the headline size
    A = make_operand(torch, (8192, 8192), 1)
    T = sk.JLT(8192, 1024, P.Context(42))
    Yr, Yc = step("jlt", lambda: (T.apply(A, sk.ROWWISE),
                                  T.apply(A, sk.COLUMNWISE)))
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
    del Yc, want

    def norm_ratio(Y):
        # E‖S a‖² = ‖a‖² for every sketch here: squared row norms kept on
        # average over the 8192 rows
        return float((Y.square().sum(1) / A.square().sum(1)).mean())

    out["jlt_norm_ratio"] = norm_ratio(Yr)
    check(abs(out["jlt_norm_ratio"] - 1.0) < 0.01, "JLT norm ratio")
    del Yr

    # 2. CWT and the SRHT rowwise on the same operand (B2-rw, B5-rw)
    for name, Ts in (("cwt_rowwise", sk.CWT(8192, 1024, P.Context(48))),
                     ("srht_rowwise", sk.FJLT(8192, 1024, P.Context(49),
                                              fut="wht"))):
        Y = step(name, lambda: Ts.apply(A, sk.ROWWISE))
        check(tuple(Y.shape) == (8192, 1024)
              and bool(torch.isfinite(Y).all()), f"{name} output")
        out[f"{name}_norm_ratio"] = norm_ratio(Y)
        check(abs(out[f"{name}_norm_ratio"] - 1.0) < 0.01,
              f"{name} norm ratio")
        del Y
    del A

    # 3. randomized SVD at rank 64 (k' = 128) of the SVD cell's matrix
    k = 64
    A, sigma = svd_operand(torch)
    params = nla.ApproximateSVDParams(num_iterations=2)
    U, S, V = step("svd", lambda: nla.approximate_svd(A, k, P.Context(43),
                                                      params))
    check(tuple(U.shape) == (8192, k) and tuple(S.shape) == (k,)
          and tuple(V.shape) == (8192, k), "SVD output shapes")
    out["svd_sigma_rel_err"] = float(((S - sigma[:k]).abs() / sigma[:k]).max())
    recon = float(torch.linalg.norm(A - (U * S) @ V.T) / torch.linalg.norm(A))
    tail = float(torch.linalg.norm(sigma[k:]) / torch.linalg.norm(sigma))
    out["svd_recon_rel"], out["svd_recon_optimal"] = recon, tail
    check(out["svd_sigma_rel_err"] <= 1e-3, "SVD sigma rel err > 1e-3")
    check(recon <= 1.01 * tail + 1e-4, "SVD reconstruction above bound")
    del A, U, V

    # 4. sketch-and-solve least squares, s = 4·512, with each sketch
    A, b = ls_operands(torch)
    out["ls_residual_lstsq"] = lstsq_residual(torch, A, b)
    solves = {
        "ls_jlt": lambda: nla.approximate_least_squares(
            A, b, P.Context(44), sketch="jlt"),
        "ls_fjlt": lambda: nla.approximate_least_squares(A, b, P.Context(45)),
        "ls_cwt": lambda: nla.approximate_least_squares(
            A, b, P.Context(46), sketch="cwt"),
        "ls_srht": lambda: algorithms.solve_l2_sketched(
            A, b, sk.FJLT(65536, 2048, P.Context(47), fut="wht")),
    }
    for name, fn in solves.items():
        x = step(name, fn)
        check(tuple(x.shape) == (512,) and bool(torch.isfinite(x).all()),
              f"{name} output")
        ratio = (float(torch.linalg.norm(A @ x - b))
                 / out["ls_residual_lstsq"])
        out[f"{name}_residual_ratio"] = ratio
        # sketch-and-solve at s = 4n: E ratio ≈ sqrt(1 + n/(s − n)) ≈ 1.15
        check(ratio <= 1.5, f"{name} residual ratio {ratio} > 1.5")
    del A, b

    # 5. Blendenpik, simplified Blendenpik and LSRN over LSQR on an
    # ill-conditioned problem: the exact residual, in 0 < iterations < limit
    A, b = kappa_operands(torch)
    best = lstsq_residual(torch, A, b)
    out["accel_residual_lstsq"] = best
    iter_lim = max(20, 2 * 512)  # LSQR's default limit at n = 512
    accel = {
        "fast_ls": lambda: nla.fast_least_squares(A, b, P.Context(50)),
        "simplified_blendenpik": lambda: algorithms.solve_l2_accelerated(
            A, b, P.Context(51), method="simplified_blendenpik"),
        "lsrn": lambda: algorithms.solve_l2_accelerated(
            A, b, P.Context(52), method="lsrn"),
    }
    for name, fn in accel.items():
        x, it = step(name, fn)
        ratio = float(torch.linalg.norm(A @ x - b)) / best
        out[f"{name}_residual_ratio"], out[f"{name}_iterations"] = ratio, it
        check(0 < it < iter_lim, f"{name} iterations {it}")
        check(ratio <= 1 + 1e-3, f"{name} residual ratio {ratio} > 1 + 1e-3")
    del A, b

    out["launches"] = launch_counts()
    emit("main", **out)
    for k_, v in out["launches"].items():
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


def profiled_device_ms(torch, fn, reps=10) -> float:
    """Device time of one call summed over the kernels it runs, from
    torch.profiler over ``reps`` calls after one warm-up: the kernels'
    own time, without the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3


def bound(ops: float, ops_per_s: float, nbytes: float,
          peaks: dict) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def time_kernels(torch, P, shapes, main_path: bool,
                 peaks: dict) -> list[dict]:
    """Phase 5, B1: kernel, plain and library times at the given shapes."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    dist = randgen.Normal()
    rows = []
    for name, use, shape, s_dim in shapes:
        rowwise = name == "dense_rowwise"
        A = make_operand(torch, shape, 7)
        ctx = P.Context(9)
        scale = 1.0 / math.sqrt(s_dim)
        n, m = (shape[1], shape[0]) if rowwise else shape
        fn = cd.rowwise_apply if rowwise else cd.columnwise_apply
        ms = event_ms(torch, lambda: fn(ctx.allocate().key, dist, A, s_dim,
                                        scale))
        dev_ms = profiled_device_ms(torch, lambda: fn(
            ctx.allocate().key, dist, A, s_dim, scale))
        plain_ms = event_ms(torch, lambda: cd.dense_apply_plain(
            ctx.allocate().key, dist, A, s_dim, scale, rowwise))
        key = ctx.allocate().key
        S = virtual_panel(key, dist, s_dim, 0, n, scale, device=A.device)
        lib = (lambda: torch.matmul(A, S.T)) if rowwise else (
            lambda: torch.matmul(S, A))
        library_ms = event_ms(torch, lib)
        # 2·m·n·s flops on the CUDA cores; A read once, the output
        # written once
        rows.append({"kernel": name, "use": use, "main_path": main_path,
                     "shape": list(shape), "s_dim": s_dim, "ms": ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **bound(2.0 * m * n * s_dim, peaks["fp32_flops"],
                             4.0 * (m * n + m * s_dim), peaks)})
        del A, S
    return rows


def time_hash(torch, P, shapes, peaks: dict) -> list[dict]:
    """Phase 5, B2: kernel, plain version, and index_add_ against h and v
    made beforehand (the scatter alone, without generation)."""
    from libskylark_tpu_torch.sketch import cuda_hash as ch

    rows = []
    for name, use, shape, s_dim in shapes:
        rowwise = name == "hash_rowwise"
        A = make_operand(torch, shape, 8)
        ctx = P.Context(10)
        n, m = (shape[1], shape[0]) if rowwise else shape
        ms = event_ms(torch, lambda: ch.cwt_apply(ctx.allocate().key, A,
                                                  s_dim, rowwise))
        dev_ms = profiled_device_ms(torch, lambda: ch.cwt_apply(
            ctx.allocate().key, A, s_dim, rowwise))
        plain_ms = event_ms(torch, lambda: ch.cwt_apply_plain(
            ctx.allocate().key, A, s_dim, rowwise))
        h, v = ch.streams(ctx.allocate().key, n, s_dim, A.device)
        library_ms = event_ms(torch, lambda: ch.scatter(h, v, A, s_dim,
                                                        rowwise))
        # a multiply and an add per element of A; A read once, the
        # output written once
        rows.append({"kernel": name, "use": use, "main_path": True,
                     "shape": list(shape), "s_dim": s_dim, "ms": ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **bound(2.0 * m * n, peaks["fp32_flops"],
                             4.0 * (m * n + m * s_dim), peaks)})
        del A
    return rows


def time_fwht(torch, P, shapes, peaks: dict) -> list[dict]:
    """Phase 5, B5: kernel, plain version, and fut.fwht_sketch against D
    and idx made beforehand: the D multiply, the kron two-torch.matmul WHT
    (TF32 off), index_select and the scale, without generation."""
    from libskylark_tpu_torch.sketch import cuda_fwht as cf, fut

    rows = []
    for name, use, shape, s_dim in shapes:
        rowwise = name == "fwht_rowwise"
        A = make_operand(torch, shape, 9)
        ctx = P.Context(11)
        n, m = (shape[1], shape[0]) if rowwise else shape
        ms = event_ms(torch, lambda: cf.srht_apply(ctx.allocate().key, A,
                                                   s_dim, rowwise))
        dev_ms = profiled_device_ms(torch, lambda: cf.srht_apply(
            ctx.allocate().key, A, s_dim, rowwise))
        plain_ms = event_ms(torch, lambda: cf.srht_apply_plain(
            ctx.allocate().key, A, s_dim, rowwise))
        D, idx = cf.streams(ctx.allocate().key, n, s_dim, device=A.device)
        fs, ss = cf.scales(n, s_dim)
        library_ms = event_ms(torch, lambda: fut.fwht_sketch(
            A, D, idx, fs, ss, axis=1 if rowwise else 0))
        # n·log2(n) adds per transformed vector at the fp32 add rate (half
        # the FMA flop rate); A read once, the output written once
        rows.append({"kernel": name, "use": use, "main_path": True,
                     "shape": list(shape), "s_dim": s_dim, "ms": ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **bound(float(m) * n * math.log2(n),
                             peaks["fp32_flops"] / 2,
                             4.0 * (m * n + m * s_dim), peaks)})
        del A
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
HASH_SHAPES = [
    ("hash_columnwise", "CWT least squares S·[A|b]", (65536, 513), 2048),
    ("hash_columnwise", "simplified Blendenpik S·A", (65536, 512), 2048),
    ("hash_rowwise", "CWT.apply rowwise", (8192, 8192), 1024),
]
FWHT_SHAPES = [
    ("fwht_columnwise", "SRHT least squares S·[A|b]", (65536, 513), 2048),
    ("fwht_rowwise", "FJLT(wht).apply rowwise", (8192, 8192), 1024),
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


# main-path shapes; s = 300 (randint's multiplier is not 0); n ragged
# (not a multiple of the 4096-chunk nor of the 1024-tile)
HASH_CASES = [(name, shape, s) for name, _, shape, s in HASH_SHAPES] + [
    ("hash_columnwise", (5000, 37), 300), ("hash_rowwise", (37, 5000), 300),
    ("hash_columnwise", (12305, 70), 2048),
    ("hash_rowwise", (70, 12305), 1500)]
# dyadic at n = 4096, s = 256; Gaussian at 8192 → 1024 and 65536 → 2048
FWHT_CASES = [
    ("fwht_columnwise", (4096, 64), 256, True),
    ("fwht_rowwise", (64, 4096), 256, True),
    ("fwht_columnwise", (8192, 300), 1024, False),
    ("fwht_rowwise", (8192, 8192), 1024, False),
    ("fwht_columnwise", (65536, 513), 2048, False),
    ("fwht_rowwise", (64, 65536), 2048, False)]

CSRC = "libskylark_tpu_torch/csrc/"
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "dense_rowwise": (CSRC + "dense_sketch.cu",
                      "libskylark_tpu/sketch/pallas_dense.py:396"),
    "dense_columnwise": (CSRC + "dense_sketch.cu",
                         "libskylark_tpu/sketch/pallas_dense.py:480"),
    "hash_rowwise": (CSRC + "hash_sketch.cu",
                     "libskylark_tpu/sketch/pallas_hash.py:423"),
    "hash_columnwise": (CSRC + "hash_sketch.cu",
                        "libskylark_tpu/sketch/pallas_hash.py:423"),
    "fwht_rowwise": (CSRC + "fwht_sketch.cu",
                     "libskylark_tpu/sketch/pallas_fwht.py:314"),
    "fwht_columnwise": (CSRC + "fwht_sketch.cu",
                        "libskylark_tpu/sketch/pallas_fwht.py:314"),
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

    checked = {(k[0], k[1], k[2]): v
               for k, v in check_kernels(torch, P, check_cases()).items()
               if k[3] == "normal"}
    checked.update(check_hash(torch, P, HASH_CASES))
    checked.update(check_fwht(torch, P, FWHT_CASES))
    main = main_path(torch, P)
    rows = (time_kernels(torch, P, MAIN_SHAPES, True, peaks)
            + time_kernels(torch, P, SPLIT_LS_SHAPES, False, peaks)
            + time_hash(torch, P, HASH_SHAPES, peaks)
            + time_fwht(torch, P, FWHT_SHAPES, peaks))
    emit("time", method="ms: CUDA events around each of 10 back-to-back "
                        "calls after 3 warm-ups, median; device_ms: the "
                        "kernels' own time per call under torch.profiler, "
                        "mean of 10; each kernel and plain call with a new "
                        "key from one Context",
         library={"dense": "torch.matmul against S made beforehand, TF32 "
                           "off: the contraction alone, without generation",
                  "hash": "index_add_ of v·A at h, h and v made "
                          "beforehand: the scatter alone",
                  "fwht": "D multiply, kron two-torch.matmul WHT (TF32 off), "
                          "index_select and scale, D and idx made "
                          "beforehand"},
         rows=rows)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name and r["main_path"]]
        head = mine[0]
        # the worst check over this kernel's main-path shapes
        cs = [checked[(name, tuple(r["shape"]), r["s_dim"])] for r in mine]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "shape": head["shape"], "s_dim": head["s_dim"],
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
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
