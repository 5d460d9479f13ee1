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
            - dense (B1): three distributions, each in every regime
              (bf16x3, the default, bf16gen2 and bf16 on the tensor
              cores; f32 as fp32 FMA) against the plain version of that
              regime, max|kernel − plain| ≤ 1e-4·max|plain|, and Cauchy
              draws entry by entry, |kernel − plain| ≤ 1e-4·(|S|·|A|) (the
              heavy tail puts max|plain| far above a typical entry);
            - hash (B2): bit-equal (torch.equal) to the plain scatter run
              on a CPU copy of the operand, also at a span that is not a
              power of two (s = 300) and at ragged n;
            - fwht (B5): bit-equal on dyadic data (integers in [−8, 8],
              n = 4096, s = 256), ≤ 1e-4·max|plain| on Gaussian data;
            - cos (B1-cos): random sc/sh, every regime, ≤ 1e-4·max|plain|;
            - fastfood (B4, B4-split): ≤ 1e-4·max|plain| at 16384×4096 →
              4096, d = 1000 → 3000 (padding, 3 blocks, truncation), an
              odd log2 NB (d = 2048) and m = 37;
            - batched (B1-batched in every regime, B4-batched): the serve
              buckets' capacity-8 stacks (the ct-cw shape with Cauchy and
              with Normal draws) and ragged lanes zero-padded into them,
              against the per-lane serve program with B1's limits, and every
              lane bit-equal to a launch of that lane alone;
            - sparse (B3): CSR lanes at config 2's shape (rcv1.binary:
              47,236 features, 0.16% dense) both ways, s = 300 and s = 7,
              bit-equal to the plain scatter on a CPU copy, every lane
              bit-equal to its launch alone;
4. main   — the main path at full size through the public entry points,
            with every launch counter set to 0 before and read after (and
            B1's launches by regime and the operator entries its
            generation kernel made, s_dim·n per lane and call):
            JLT.apply both ways on 8192×8192 → 1024; approximate_svd of an
            8192×8192 matrix with a known spectrum, rank 64, k' = 128;
            approximate_least_squares on 65536×512, s = 2048, with the JLT,
            the default FJLT (DCT mixer, cuFFT: no kernel) and the CWT;
            solve_l2_sketched with FJLT(fut="wht"); fast_least_squares
            (Blendenpik over the FJLT) and solve_l2_accelerated
            (simplified_blendenpik, lsrn) on a 65536×512 matrix with
            singular values over [1e-3, 1]; CWT and FJLT(fut="wht") applied
            rowwise on 8192×8192 → 1024, and CWT on a 4096×47236 CSR operand
            (config 2); random features (BASELINE config
            3) on X 16384×4096 → 4096 through ml.kernels' create_rft:
            Gaussian regular/fast (fused, split, columnwise)/quasi,
            Laplacian, ExpSemigroup on |X|, Polynomial (PPT), Linear fast
            (FJLT), and UST with and without replacement, each feature map
            held to its kernel's Gram matrix on 512 sampled rows;
4b. serve — the serving path: 16 requests per main bucket (JLT 8192 →
            1024 rowwise on 1537–2048 rows, CT columnwise on 65–128
            columns, FastGaussianRFT 4096 → 4096 on 1025–2048 rows, CWT
            rowwise on 4096×47236 CSR) and 4 per smaller bucket (CWT
            columnwise on 47236×512 CSR, JLT on 8192×512 CSR, CWT and SRHT
            dense) from 4 threads into one MicrobatchExecutor(max_batch=8,
            linger_us=5000), warm-up storm then a measured one with the
            launch counters set to 0 before and read after; every request
            held to its capacity-1 plain flush (≤ 1e-4·max|plain|, CT's
            Cauchy draws entry by entry; CWT torch.equal on the CPU) and
            bit-equal to its capacity-1 kernel flush; then each bucket's flush cell (warm ms, device ms, busy);
5. time   — CUDA-event medians of each kernel, its plain version and one
            PyTorch call computing the same function, beside the card's
            bound, at the main-path shapes (B1 in its default regime, with
            the f32 body's time and each regime's bound beside it); every
            timed call of a kernel or a plain version draws a new key from
            one Context, as a user solving again does (the Fastfood
            kernels, whose streams are made outside them, are timed on
            streams made beforehand, and their wrappers with new streams
            per call beside them); the serve kernels at their buckets'
            capacity-8 shapes;
6. the ``{"kernels": [...]}`` line (``max_abs_err``: the worst of every
   check at the kernel's main-path shapes, all distributions and ragged
   variants), the card's name and power limit, and
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
CHECK_TOLERANCE = (f"max|kernel-plain| <= {TOL} * max|plain|; Cauchy draws "
                   f"entry by entry: |kernel-plain| <= {TOL} * (|S|·|A|)")
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
# outside the tensor cores, bf16 on the tensor cores, and HBM3 bandwidth.
# Printed beside the peaks of the attached card, for reference only: the
# bounds use the attached card's own rates (card_peaks).
DATASHEET_H100_SXM = {"fp32_flops": 67e12, "bf16_tensor_flops": 989e12,
                      "hbm_bytes_per_s": 3.35e12}
FP32_LANES_PER_SM = {9: 128}  # Hopper: 128 fp32 FMA units per SM
# Hopper: 4 tensor cores per SM, each 512 dense bf16 FMA (1024 flops) a clock
BF16_FLOPS_PER_SM_CLOCK = {9: 4 * 1024}


def card_peaks(torch) -> dict:
    """The attached card's peak rates, from its own attributes: fp32 FMA
    lanes × 2 × SM count × max SM clock; bf16 dense tensor flops per SM
    per clock (4 tensor cores × 1024) × SM count × max SM clock; and 2
    (double data rate) × max memory clock × bus width. B1 runs its bf16
    regimes on the tensor cores and ``f32`` as fp32 FMA on the CUDA cores;
    the other kernels add and multiply in fp32 on the CUDA cores."""
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
            "bf16_tensor_flops": BF16_FLOPS_PER_SM_CLOCK[major] * sms * sm_hz,
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


def elementwise_limit(torch, key, dist, A, s_dim, scale, rowwise):
    """TOL·(|A|·|S|ᵀ) rowwise, TOL·(|S|·|A|) columnwise, in float64: per
    output entry, TOL times the sum of its terms' magnitudes, which bounds
    the rounding of any summation order. It is the limit for Cauchy
    draws, whose heavy tail puts max|plain| far above a typical entry."""
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    n = A.shape[1] if rowwise else A.shape[0]
    S = virtual_panel(key, dist, s_dim, 0, n, scale,
                      device=A.device).double().abs()
    Aa = A.double().abs()
    return TOL * ((Aa @ S.T) if rowwise else (S @ Aa))


def held(torch, got, want, limit=None) -> dict:
    """``got`` against ``want``: max abs and relative error, and ok by
    max|got-want| <= TOL·max|plain|, or entry by entry within ``limit``
    when one is given (its worst share of the limit reported too)."""
    diff = (got - want).abs()
    err = float(diff.max())
    rel = err / float(want.abs().max())
    if limit is None:
        return {"max_abs_err": err, "max_rel_err": rel, "ok": rel <= TOL}
    return {"max_abs_err": err, "max_rel_err": rel,
            "max_err_over_limit": float(
                (diff.double() / limit.clamp_min(1e-300)).max()),
            "ok": bool((diff.double() <= limit).all())}


# B1's contraction regimes; the default first
REGIMES = ("bf16x3", "bf16gen2", "bf16", "f32")


def check_kernels(torch, P, cases) -> list:
    """Phase 3: every case in every regime against the plain version of
    that regime; Cauchy cases entry by entry within
    :func:`elementwise_limit`."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    dists = {"normal": randgen.Normal(), "cauchy": randgen.Cauchy(),
             "rademacher": randgen.Rademacher()}
    results = []
    for i, (name, dist, shape, s_dim) in enumerate(cases):
        rowwise = name == "dense_rowwise"
        key = P.Context(100 + i).allocate().key
        A = make_operand(torch, shape, 1000 + i)
        d, scale = dists[dist], 1.0 / math.sqrt(s_dim)
        fn = cd.rowwise_apply if rowwise else cd.columnwise_apply
        limit = (elementwise_limit(torch, key, d, A, s_dim, scale, rowwise)
                 if dist == "cauchy" else None)
        for p in REGIMES:
            got = fn(key, d, A, s_dim, scale, precision=p)
            want = cd.dense_apply_plain(key, d, A, s_dim, scale, rowwise, p)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "kernel output not finite")
            results.append({"kernel": name, "dist": dist, "regime": p,
                            "shape": list(shape), "s_dim": s_dim,
                            **held(torch, got, want, limit)})
            del got, want
        del A, limit
    emit("check", tolerance=CHECK_TOLERANCE, cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return results


def check_hash(torch, P, cases) -> list:
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
    return results


def check_fwht(torch, P, cases) -> list:
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
    return results


def check_cos(torch, P, cases) -> list:
    """Phase 3, B1-cos: each case in every regime against rft_apply_plain
    of that regime on the same inputs, with random per-feature scales and
    shifts (they are indexed by the output column), inscale 1/√n and
    outscale √(2/s)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    results = []
    for i, (shape, s_dim) in enumerate(cases):
        key = P.Context(400 + i).allocate().key
        A = make_operand(torch, shape, 4000 + i)
        g = torch.Generator(device="cuda").manual_seed(4100 + i)
        sc = 0.5 + torch.rand(s_dim, generator=g, device="cuda")
        sh = 2 * math.pi * torch.rand(s_dim, generator=g, device="cuda")
        args = (key, randgen.Normal(), A, s_dim, 1.0 / math.sqrt(shape[1]),
                math.sqrt(2.0 / s_dim), sc, sh)
        for p in REGIMES:
            got = cd.rft_rowwise_apply(*args, precision=p)
            want = cd.rft_apply_plain(*args, precision=p)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  "cos kernel output not finite")
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            results.append({"kernel": "dense_rowwise_cos", "regime": p,
                            "shape": list(shape), "s_dim": s_dim,
                            "max_abs_err": err, "max_rel_err": rel,
                            "ok": rel <= TOL})
            del got, want
        del A
    emit("check", tolerance=f"B1-cos: max|kernel-plain| <= {TOL} * "
                            "max|plain|", cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"cos kernel disagrees with its plain version: {bad}")
    return results


def check_fastfood(torch, P, cases) -> list:
    """Phase 3, B4 and B4-split: each case's FastGaussianRFT (σ = √d)
    through both variants against fastfood_plain, the torch chain, on the
    same operand."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf

    results = []
    for i, (m, d, s_dim) in enumerate(cases):
        T = sk.FastGaussianRFT(d, s_dim, P.Context(500 + i),
                               sigma=math.sqrt(d))
        A = make_operand(torch, (m, d), 5000 + i)
        want = cf.fastfood_plain(T, A)
        for name, variant in (("fastfood", "fused"),
                              ("fastfood_split", "split")):
            got = cf.features_rows(T, A, variant)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} output not finite")
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            results.append({"kernel": name, "shape": [m, d], "s_dim": s_dim,
                            "NB": T._NB, "blocks": T._numblks,
                            "max_abs_err": err, "max_rel_err": rel,
                            "ok": rel <= TOL})
        del A, want
    emit("check", tolerance=f"B4: max|kernel-plain| <= {TOL} * max|plain|",
         cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"Fastfood kernel disagrees with its plain version: {bad}")
    return results


def counters():
    """Every kernel wrapper's launch counter dict."""
    from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fastfood,
                                             cuda_fwht, cuda_hash,
                                             cuda_sparse)

    return [cuda_dense.launches, cuda_hash.launches, cuda_fwht.launches,
            cuda_fastfood.launches, cuda_sparse.launches]


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def dense_counts() -> dict:
    """B1's launches by regime, and the operator entries its generation
    kernel made (s_dim · n per lane and call in the bf16 regimes)."""
    from libskylark_tpu_torch.sketch import cuda_dense

    return {**cuda_dense.by_regime,
            "generated_entries": cuda_dense.generated["entries"]}


def main_path(torch, P) -> dict:
    """Phase 4: the main path at full size through the public API."""
    from libskylark_tpu_torch import algorithms, nla, sketch as sk
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    for c in counters() + [cd.by_regime, cd.generated]:
        for k in c:
            c[k] = 0
    out = {"launches_by_step": {}, "dense_by_step": {}}

    def step(name, fn):
        """Run one step timed, and record the launches it made, B1's by
        regime, and the operator entries B1 generated."""
        before, dense_before = launch_counts(), dense_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
        out["launches_by_step"][name] = {
            k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}
        out["dense_by_step"][name] = {
            k: v - dense_before[k] for k, v in dense_counts().items()
            if v != dense_before[k]}
        return result

    # 1. JLT both ways: BASELINE config 1 at the headline size
    A = make_operand(torch, (8192, 8192), 1)
    T = sk.JLT(8192, 1024, P.Context(42))
    Yr, Yc = step("jlt", lambda: (T.apply(A, sk.ROWWISE),
                                  T.apply(A, sk.COLUMNWISE)))
    check(tuple(Yr.shape) == (8192, 1024) and tuple(Yc.shape) == (1024, 8192),
          "JLT output shapes")
    # the default regime on the tensor cores, each operator entry made once
    # per apply: s_dim · n = 1024 · 8192, twice
    jlt_route = {"bf16x3": 2, "generated_entries": 2 * 1024 * 8192}
    check(out["dense_by_step"]["jlt"] == jlt_route,
          f"JLT did not take B1's bf16x3 route once per entry: "
          f"{out['dense_by_step']['jlt']}")
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

    # 2b. CWT of a CSR operand at config 2's shape (B3 at one lane), bit-
    # equal to the plain scatter on the CPU
    Asp = csr_operand(4096, RCV1_D, RCV1_DENSITY, 47)
    Tsp = sk.CWT(RCV1_D, 1024, P.Context(53))
    Y = step("cwt_sparse_rowwise", lambda: Tsp.apply(Asp, sk.ROWWISE))
    out["cwt_sparse_nnz"] = Asp.nnz
    check(tuple(Y.shape) == (4096, 1024) and bool(torch.equal(
        Y.cpu(), Tsp.apply(Asp, sk.ROWWISE, device="cpu"))),
        "CWT of a CSR operand differs from the plain scatter")
    check(out["launches_by_step"]["cwt_sparse_rowwise"]
          == {"sparse_rowwise": 1}, "CWT of a CSR operand did not take B3")
    del Y

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

    # 6. random features, BASELINE config 3
    failed = random_features(torch, P, step, out)

    out["launches"] = launch_counts()
    out["dense"] = dense_counts()
    emit("main", **out)
    check(not failed, f"random features: {failed}")
    for k_ in MAIN_KERNELS:
        check(out["launches"][k_] > 0,
              f"kernel {k_} never launched on the main path")
    return out


# the kernels the main path must launch
MAIN_KERNELS = ("dense_rowwise", "dense_columnwise", "hash_rowwise",
                "hash_columnwise", "fwht_rowwise", "fwht_columnwise",
                "dense_rowwise_cos", "fastfood", "fastfood_split",
                "sparse_rowwise")


# Bounds of the random-feature check on 512 sampled rows, relative to
# max|K|: (max |Z·Zᵀ − K|, mean |Z·Zᵀ − K|). The Monte-Carlo error at
# S = 4096 features measured 0.047–0.082 and 0.007–0.013 (PERF.md). A
# wrong scale or shift leaves them by far (no shifts add K(x + y), ≈ 0.37
# off the diagonal here); a wrong permutation direction gives another
# valid random map, which the comparison with the plain version catches.
GRAM_BOUNDS = {
    "rft_regular": (0.1, 0.02),
    "rft_fast": (0.1, 0.02),
    "rft_quasi": (0.1, 0.02),
    "laplacian_regular": (0.1, 0.02),
    "expsemigroup_regular": (0.1, 0.02),
    "polynomial_ppt": (0.1, 0.02),
    "linear_fast": (0.1, 0.02),
}


def random_features(torch, P, step, out) -> list:
    """Main path, config 3: X (RFT_SHAPE) 16384×4096 Gaussian, S = 4096,
    every feature map made by its kernel's create_rft and applied
    rowwise. Each map's Z·Zᵀ on 512 sampled rows is held to the kernel's
    Gram matrix, made in float64 on the card; the kernel-served Gaussian
    maps are also held to their plain versions on the same X (the split
    variant to the fused). Each kernel's parameter puts K's off-diagonal
    between 0.1 and 0.9 of its diagonal on this data (Linear has none).
    Returns the names of the maps outside GRAM_BOUNDS."""
    from libskylark_tpu_torch import ml, sketch as sk
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf

    (m, d), s = RFT_SHAPE, RFT_S
    X = make_operand(torch, (m, d), 12)
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = torch.randperm(m, generator=g, device="cuda")[:512]
    failed = []

    def gram_check(name, kernel, Z, data):
        check(tuple(Z.shape) == (m, s) and bool(torch.isfinite(Z).all()),
              f"{name} output")
        Zs = Z[rows].double()
        K = kernel.gram(data[rows].double())
        err = (Zs @ Zs.T - K).abs()
        top = float(K.abs().max())
        diag = float(K.diagonal().mean())
        off = float((K.sum() - K.diagonal().sum()) / (512 * 511))
        out[f"{name}_gram_max_err"] = float(err.max()) / top
        out[f"{name}_gram_mean_err"] = float(err.mean()) / top
        out[f"{name}_offdiag_over_diag"] = off / diag
        bmax, bmean = GRAM_BOUNDS[name]
        if (out[f"{name}_gram_max_err"] > bmax
                or out[f"{name}_gram_mean_err"] > bmean):
            failed.append(name)

    def plain_check(name, Z, want):
        out[f"{name}_rel_err_vs_plain"] = float((Z - want).abs().max()
                                                / want.abs().max())
        check(out[f"{name}_rel_err_vs_plain"] <= TOL, f"{name} vs plain")

    gauss = ml.Gaussian(d, math.sqrt(d))
    T = gauss.create_rft(s, P.Context(60), "regular")
    Z = step("rft_regular", lambda: T.apply(X, sk.ROWWISE))
    gram_check("rft_regular", gauss, Z, X)
    plain_check("rft_regular", Z, cd.rft_apply_plain(
        T.subkey(0), T.dist, X, s, T.inscale, T.outscale,
        T.row_scales(device=X.device), T.shifts(device=X.device)))

    Tf = gauss.create_rft(s, P.Context(61), "fast")
    Z = step("rft_fast", lambda: Tf.apply(X, sk.ROWWISE))
    gram_check("rft_fast", gauss, Z, X)
    plain_check("rft_fast", Z, cf.fastfood_plain(Tf, X))
    # the split variant, as the reference's features_rows(variant="split")
    Zsplit = step("rft_fast_split",
                  lambda: cf.features_rows(Tf, X, variant="split"))
    plain_check("rft_fast_split", Zsplit, Z)
    del Zsplit
    # columnwise: a (d, m) operand, transposed on the way in and out
    Xt = X.T.contiguous()
    Zc = step("rft_fast_columnwise", lambda: Tf.apply(Xt, sk.COLUMNWISE))
    check(tuple(Zc.shape) == (s, m) and bool(torch.equal(Zc.T, Z)),
          "Fastfood columnwise is not the rowwise features transposed")
    del Xt, Zc

    Z = step("rft_quasi", lambda: gauss.create_rft(
        s, P.Context(62), "quasi").apply(X, sk.ROWWISE))
    gram_check("rft_quasi", gauss, Z, X)

    # l1 distances average 1.128·d here: σ = 2d gives K ≈ 0.57
    lap = ml.Laplacian(d, 2.0 * d)
    Z = step("laplacian_regular", lambda: lap.create_rft(
        s, P.Context(63), "regular").apply(X, sk.ROWWISE))
    gram_check("laplacian_regular", lap, Z, X)

    # on |X|, Σ√(x+y) exceeds Σ√(2x) by ≈ 0.051·d: β = 6e-4 gives a
    # ratio ≈ 0.88 and keeps the features' variance in bounds
    Xa = X.abs()
    exps = ml.ExpSemigroup(d, 6e-4)
    Z = step("expsemigroup_regular", lambda: exps.create_rft(
        s, P.Context(64), "regular").apply(Xa, sk.ROWWISE))
    gram_check("expsemigroup_regular", exps, Z, Xa)
    del Xa

    # (⟨x,y⟩/d + 1)²: diagonal 4, off-diagonal ≈ 1
    poly = ml.Polynomial(d, q=2, c=1.0, gamma=1.0 / d)
    Z = step("polynomial_ppt", lambda: poly.create_rft(
        s, P.Context(65)).apply(X, sk.ROWWISE))
    gram_check("polynomial_ppt", poly, Z, X)

    lin = ml.Linear(d)
    Z = step("linear_fast", lambda: lin.create_rft(
        s, P.Context(66), "fast").apply(X, sk.ROWWISE))
    gram_check("linear_fast", lin, Z, X)
    del Z

    for name, replace in (("ust_replace", True), ("ust_no_replace", False)):
        Tu = sk.UST(d, d // 4, P.Context(67), replace=replace)
        Y = step(name, lambda: Tu.apply(X, sk.ROWWISE))
        idx = Tu.sample_indices(X.device)
        check(bool(torch.equal(Y, X[:, idx])) and int(idx.min()) >= 0
              and int(idx.max()) < d, f"{name} is not a column sample")
        if not replace:
            check(int(torch.unique(idx).numel()) == d // 4,
                  f"{name} repeats a column")
    del X

    by_step = out["launches_by_step"]
    check(by_step["rft_regular"] == {"dense_rowwise_cos": 1},
          f"GaussianRFT launches {by_step['rft_regular']}")
    check(out["dense_by_step"]["rft_regular"]
          == {"bf16x3": 1, "generated_entries": s * d},
          f"GaussianRFT B1 route {out['dense_by_step']['rft_regular']}")
    check(by_step["rft_fast"] == {"fastfood": 1},
          f"FastGaussianRFT launches {by_step['rft_fast']}")
    check(by_step["rft_fast_split"] == {"fastfood_split": 1},
          f"split launches {by_step['rft_fast_split']}")
    check(by_step["polynomial_ppt"] == {"hash_columnwise": 2},
          f"PPT launches {by_step['polynomial_ppt']}")
    return failed


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


# bf16 tensor-core passes of each B1 regime (pallas_dense._dot)
REGIME_PASSES = {"bf16x3": 3, "bf16gen2": 2, "bf16": 1}


def dense_bounds(flops: float, nbytes: float, peaks: dict) -> dict:
    """B1's bounds for a contraction of ``flops`` = 2·m·n·s (times the
    lanes): the default regime's (``bound_ms``, ``bound_by``: bf16x3, 3
    passes at the card's bf16 tensor rate), and each regime's under
    ``bounds`` — the bf16 ones at that rate, f32 at the card's fp32 FMA
    rate; bytes: A read once, the output written once."""
    bounds = {p: bound(k * flops, peaks["bf16_tensor_flops"], nbytes, peaks)
              for p, k in REGIME_PASSES.items()}
    bounds["f32"] = bound(flops, peaks["fp32_flops"], nbytes, peaks)
    return {**bounds["bf16x3"], "regime": "bf16x3",
            "bounds": {p: {"bound_ms": b["bound_ms"],
                           "bound_by": b["bound_by"]}
                       for p, b in bounds.items()}}


def time_kernels(torch, P, shapes, main_path: bool,
                 peaks: dict) -> list[dict]:
    """Phase 5, B1: kernel (the default regime, and ``f32_ms`` the f32
    regime's fp32-FMA body), plain (default regime) and library times at
    the given shapes. A shape's optional 6th field names the regime its
    entry point runs when that is not the default (``route_regime``,
    timed as ``route_ms``)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    rows = []
    for name, use, shape, s_dim, *extra in shapes:
        dist = (randgen.Cauchy() if extra[:1] == ["cauchy"]
                else randgen.Normal())
        route = extra[1] if len(extra) > 1 else "bf16x3"
        rowwise = name == "dense_rowwise"
        A = make_operand(torch, shape, 7)
        ctx = P.Context(9)
        scale = 1.0 / math.sqrt(s_dim)
        n, m = (shape[1], shape[0]) if rowwise else shape
        fn = cd.rowwise_apply if rowwise else cd.columnwise_apply
        ms = event_ms(torch, lambda: fn(ctx.allocate().key, dist, A, s_dim,
                                        scale))
        f32_ms = event_ms(torch, lambda: fn(ctx.allocate().key, dist, A,
                                            s_dim, scale, precision="f32"))
        dev_ms = profiled_device_ms(torch, lambda: fn(
            ctx.allocate().key, dist, A, s_dim, scale))
        plain_ms = event_ms(torch, lambda: cd.dense_apply_plain(
            ctx.allocate().key, dist, A, s_dim, scale, rowwise))
        key = ctx.allocate().key
        S = virtual_panel(key, dist, s_dim, 0, n, scale, device=A.device)
        lib = (lambda: torch.matmul(A, S.T)) if rowwise else (
            lambda: torch.matmul(S, A))
        library_ms = event_ms(torch, lib)
        rows.append({"kernel": name, "use": use, "main_path": main_path,
                     "shape": list(shape), "s_dim": s_dim, "ms": ms,
                     "f32_ms": f32_ms, "route_regime": route,
                     "route_ms": f32_ms if route == "f32" else ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **dense_bounds(2.0 * m * n * s_dim,
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


def time_cos(torch, P, peaks: dict) -> list[dict]:
    """Phase 5, B1-cos at config 3's shape: kernel, plain version, and the
    torch chain on S, sc and sh made beforehand (torch.matmul, TF32 off,
    then the epilogue's elementwise ops and torch.cos)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    (m, n), s_dim = RFT_SHAPE, RFT_S
    A = make_operand(torch, (m, n), 14)
    dist, ctx = randgen.Normal(), P.Context(16)
    g = torch.Generator(device="cuda").manual_seed(17)
    sc = torch.ones(s_dim, device="cuda")
    sh = 2 * math.pi * torch.rand(s_dim, generator=g, device="cuda")
    inscale, outscale = 1.0 / math.sqrt(n), math.sqrt(2.0 / s_dim)

    def args():
        return (ctx.allocate().key, dist, A, s_dim, inscale, outscale, sc,
                sh)

    ms = event_ms(torch, lambda: cd.rft_rowwise_apply(*args()))
    f32_ms = event_ms(torch, lambda: cd.rft_rowwise_apply(*args(),
                                                          precision="f32"))
    dev_ms = profiled_device_ms(torch, lambda: cd.rft_rowwise_apply(*args()))
    plain_ms = event_ms(torch, lambda: cd.rft_apply_plain(*args()))
    S = virtual_panel(ctx.allocate().key, dist, s_dim, 0, n, 1.0,
                      device=A.device)
    library_ms = event_ms(torch, lambda: outscale * torch.cos(
        torch.matmul(A, S.T) * inscale * sc + sh))
    del A, S
    # the epilogue's m·s cos aside
    return [{"kernel": "dense_rowwise_cos", "use": "GaussianRFT.apply "
             "rowwise", "main_path": True, "shape": [m, n], "s_dim": s_dim,
             "ms": ms, "f32_ms": f32_ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             **dense_bounds(2.0 * m * n * s_dim, 4.0 * (m * n + m * s_dim),
                            peaks)}]


def wht_chain(torch, A, streams, scale, s_dim):
    """The Fastfood chain from torch calls on streams made beforehand:
    the kron two-torch.matmul WHT (TF32 off), gather, torch.cos."""
    bdiag, perms, gdiag, smdiag, sh = streams
    nb, NB = bdiag.shape
    k = NB.bit_length() - 1
    a, b = 1 << (k - k // 2), 1 << (k // 2)
    Ha, Hb = (torch.ones(1, 1, device=A.device), ) * 2
    while Ha.shape[0] < a:
        Ha = torch.cat([torch.cat([Ha, Ha], 1), torch.cat([Ha, -Ha], 1)])
    while Hb.shape[0] < b:
        Hb = torch.cat([torch.cat([Hb, Hb], 1), torch.cat([Hb, -Hb], 1)])

    def wht(W):
        return torch.matmul(torch.matmul(Ha, W.reshape(nb, -1, a, b)),
                            Hb).reshape(W.shape)

    m = A.shape[0]
    W = wht(bdiag[:, None, :] * A[None])
    W = wht(gdiag[:, None, :] * torch.gather(
        W, 2, perms[:, None, :].expand(nb, m, NB)))
    F = scale * torch.cos(smdiag[:, None, :] * W + sh[:, None, :])
    return F.permute(1, 0, 2).reshape(m, nb * NB)[:, :s_dim]


def time_fastfood(torch, P, peaks: dict) -> list[dict]:
    """Phase 5, B4 and B4-split at config 3's shape. ``ms``/``device_ms``:
    the kernel on streams made beforehand; ``wrapper_ms``: features_rows
    with a new transform (new streams) per call; ``plain_ms``:
    fastfood_plain with a new transform per call; ``library_ms``:
    wht_chain on the streams made beforehand."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf

    (m, d), s_dim = RFT_SHAPE, RFT_S
    A = make_operand(torch, (m, d), 15)
    ctx = P.Context(18)

    def transform():
        return sk.FastGaussianRFT(d, s_dim, ctx, sigma=math.sqrt(d))

    T0 = transform()
    streams = cf.kernel_streams(T0, A.device)
    library_ms = event_ms(torch, lambda: wht_chain(torch, A, streams,
                                                   T0.scale, s_dim))
    plain_ms = event_ms(torch, lambda: cf.fastfood_plain(transform(), A))
    rows = []
    for name, variant in (("fastfood", "fused"), ("fastfood_split", "split")):
        ms = event_ms(torch, lambda: cf.apply_streams(A, streams, T0.scale,
                                                      s_dim, variant))
        dev_ms = profiled_device_ms(torch, lambda: cf.apply_streams(
            A, streams, T0.scale, s_dim, variant))
        wrapper_ms = event_ms(torch, lambda: cf.features_rows(
            transform(), A, variant))
        # 2·m·NB·log2(NB) adds per block at the fp32 add rate; A read
        # once, the features written once
        rows.append({"kernel": name, "use": "FastGaussianRFT.apply rowwise",
                     "main_path": True, "shape": [m, d], "s_dim": s_dim,
                     "ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **bound(2.0 * m * T0._NB * math.log2(T0._NB)
                             * T0._numblks, peaks["fp32_flops"] / 2,
                             4.0 * (m * d + m * s_dim), peaks)})
    del A
    return rows


# ---------------------------------------------------------------------------
# The serving slice: B1-batched, B4-batched and B3, and the serve phase
# ---------------------------------------------------------------------------

# config 2 (BASELINE.md): LIBSVM's rcv1.binary, 47,236 features at 0.16%
# density (≈ 75 nonzeros per row), made from a seed at that shape
RCV1_D, RCV1_DENSITY = 47236, 0.0016


def csr_operand(rows: int, cols: int, density: float, seed: int):
    """A SparseMatrix of rows × cols with ≈ density·rows·cols nonzeros at
    distinct uniform positions and standard normal values, made from a
    numpy seed."""
    import numpy as np

    from libskylark_tpu_torch.base.sparse import SparseMatrix

    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, rows * cols,
                                 int(round(density * rows * cols))))
    r, c = pos // cols, pos % cols
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=rows))])
    data = rng.standard_normal(pos.size).astype(np.float32)
    return SparseMatrix.from_csr(data, c, indptr, (rows, cols))


def csr_lanes(torch, ops, nnz_class: int, rows_pad: int):
    """Stacked (data, rows, cols) lanes of SparseMatrix operands on the
    card, packed as the serve layer packs them; returns them and the
    operands' true nnz."""
    import numpy as np

    from libskylark_tpu_torch.engine.serve import MicrobatchExecutor
    from libskylark_tpu_torch.sketch import sparse_serve

    packed = [MicrobatchExecutor._pack_csr(A, rows_pad, nnz_class,
                                           np.float32) for A in ops]
    data, idx, ptr = (torch.from_numpy(np.stack(x)).cuda()
                      for x in zip(*packed))
    rows = sparse_serve.csr_row_ids(ptr, nnz_class)
    return data, rows, idx, sum(A.nnz for A in ops)


def new_keys(np, ctx, B: int):
    return np.stack([ctx.allocate().key for _ in range(B)])


def check_batched(torch, P, np) -> list:
    """Phase 3, B1-batched (every regime) and B4-batched: each cohort
    against the plain version (the per-lane serve program, in the same
    regime) on the same stacked lanes, ≤ TOL·max|plain|, with ragged lanes
    zero-padded into the stack; and capacity invariance: every lane of the
    batched launch bit-equal to a launch of that lane alone."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.engine import bucket
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf

    g = np.random.default_rng(6000)
    results = []
    for i, (name, dist, B, shape, s_dim, ragged) in enumerate(BATCHED_CASES):
        rowwise = name == "dense_batched_rowwise"
        kd = new_keys(np, P.Context(600 + i), B)
        scale = (1.0 + g.integers(0, 2, B)) / s_dim
        if ragged:  # lanes with fewer rows (rowwise) or columns, padded
            free = 0 if rowwise else 1
            ops = []
            for b in range(B):
                sh = list(shape)
                sh[free] = int(g.integers(shape[free] // 2, shape[free] + 1))
                ops.append(make_operand(torch, tuple(sh), 6100 + 10 * i + b))
            A = bucket.stack_pad_tensor(ops, shape, B, torch.float32, "cuda")
        else:
            A = make_operand(torch, (B, *shape), 6100 + 10 * i)
        d = {"normal": randgen.Normal(), "cauchy": randgen.Cauchy()}[dist]
        limit = (torch.stack([
            elementwise_limit(torch, kd[b], d, A[b], s_dim, float(scale[b]),
                              rowwise) for b in range(B)])
            if dist == "cauchy" else None)
        for p in REGIMES:
            got = cd.serve_batched_apply(kd, scale, A, d, s_dim, rowwise, p)
            want = cd.serve_batched_plain(kd, scale, A, d, s_dim, rowwise, p)
            alone = [cd.serve_batched_apply(kd[b:b + 1], scale[b:b + 1],
                                            A[b:b + 1], d, s_dim, rowwise,
                                            p)[0] for b in range(B)]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} output not finite")
            h = held(torch, got, want, limit)
            inv = all(bool(torch.equal(got[b], alone[b])) for b in range(B))
            results.append({"kernel": name, "dist": dist, "regime": p,
                            "shape": [B, *shape], "s_dim": s_dim,
                            "ragged": ragged, **h, "capacity_invariant": inv,
                            "ok": h["ok"] and inv})
            del got, want, alone
        del A, limit
    for i, (B, m, d, s_dim) in enumerate(FASTFOOD_BATCHED_CASES):
        kd = new_keys(np, P.Context(650 + i), B)
        A = make_operand(torch, (B, m, d), 6500 + i)
        args = (d, s_dim, "wht", "gauss", math.sqrt(d))
        got = cf.serve_features_batched(kd, A, *args)
        want = cf.serve_features_plain(kd, A, *args)
        alone = [cf.serve_features_batched(kd[b:b + 1], A[b:b + 1], *args)[0]
                 for b in range(B)]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              "fastfood_batched output not finite")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        inv = all(bool(torch.equal(got[b], alone[b])) for b in range(B))
        results.append({"kernel": "fastfood_batched", "shape": [B, m, d],
                        "s_dim": s_dim, "max_abs_err": err,
                        "max_rel_err": rel, "capacity_invariant": inv,
                        "ok": rel <= TOL and inv})
        del A, got, want, alone
    emit("check", tolerance=f"B1-batched, B4-batched: {CHECK_TOLERANCE}; "
                            "each lane torch.equal to its launch alone",
         cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"batched kernel disagrees: {bad}")
    return results


def check_sparse(torch, P, np) -> list:
    """Phase 3, B3: each cohort of CSR lanes bit-equal (torch.equal) to
    the plain scatter on a CPU copy of the lanes (it adds in CSR row-major
    order; CUDA's index_add_ is atomic), and every lane bit-equal to a
    launch of that lane alone."""
    from libskylark_tpu_torch.engine import bucket
    from libskylark_tpu_torch.sketch import cuda_sparse as cs

    results = []
    for i, (name, B, rows, cols, density, s_dim) in enumerate(SPARSE_CASES):
        rowwise = name == "sparse_rowwise"
        ops = [csr_operand(rows, cols, density, 7000 + 10 * i + b)
               for b in range(B)]
        nnz_class = bucket.nnz_class(max(A.nnz for A in ops))
        shape = bucket.pad_shape((rows, cols), (0, 1))
        data, r, c, nnz = csr_lanes(torch, ops, nnz_class, shape[0])
        kd = new_keys(np, P.Context(700 + i), B)
        got = cs.cwt_sparse_apply_batched(kd, data, r, c, s_dim, rowwise,
                                          shape)
        alone = [cs.cwt_sparse_apply(kd[b], data[b], r[b], c[b], s_dim,
                                     rowwise, shape) for b in range(B)]
        torch.cuda.synchronize()
        got = got.cpu()
        want = cs.cwt_sparse_plain(kd, data.cpu(), r.cpu(), c.cpu(), s_dim,
                                   rowwise, shape)
        inv = all(bool(torch.equal(got[b], alone[b].cpu()))
                  for b in range(B))
        results.append({"kernel": name, "shape": [B, rows, cols],
                        "s_dim": s_dim, "nnz": nnz, "nnz_class": nnz_class,
                        "bit_equal": bool(torch.equal(got, want)),
                        "capacity_invariant": inv,
                        "max_abs_err": float((got - want).abs().max())})
        del data, r, c, got, want, alone
    emit("check", tolerance="B3: torch.equal with the plain scatter on a CPU "
                            "copy; each lane torch.equal to its launch "
                            "alone", cases=results)
    bad = [r for r in results
           if not (r["bit_equal"] and r["capacity_invariant"])]
    check(not bad, f"sparse CountSketch kernel disagrees: {bad}")
    return results


def serve_requests(torch, np) -> list:
    """The serve phase's requests: (bucket, endpoint, transform, operand,
    dimension), 16 per main bucket with 8 distinct seeds, 4 per smaller
    bucket. Dense operands are made on the card; CSR operands on the host,
    as a SparseMatrix."""
    from libskylark_tpu_torch import Context, sketch as sk

    g = np.random.default_rng(800)
    reqs = []
    for i in range(16):
        reqs.append(("dense-rw", "sketch_apply",
                     sk.JLT(8192, 1024, Context(800 + i % 8)),
                     make_operand(torch, (int(g.integers(1537, 2049)), 8192),
                                  8000 + i), sk.ROWWISE))
        reqs.append(("ct-cw", "sketch_apply",
                     sk.CT(8192, 1024, Context(810 + i % 8), C=1 + i % 2),
                     make_operand(torch, (8192, int(g.integers(65, 129))),
                                  8100 + i), sk.COLUMNWISE))
        reqs.append(("fastfood", "fastfood_features",
                     sk.FastGaussianRFT(4096, 4096, Context(820 + i % 8),
                                        sigma=64.0),
                     make_operand(torch, (int(g.integers(1025, 2049)), 4096),
                                  8200 + i), None))
        reqs.append(("sparse-rw", "sparse_sketch_apply",
                     sk.CWT(RCV1_D, 1024, Context(830 + i % 8)),
                     csr_operand(4096, RCV1_D, RCV1_DENSITY, 8300 + i),
                     sk.ROWWISE))
    for i in range(4):
        reqs.append(("sparse-cw", "sparse_sketch_apply",
                     sk.CWT(RCV1_D, 1024, Context(840 + i)),
                     csr_operand(RCV1_D, 512, RCV1_DENSITY, 8400 + i),
                     sk.COLUMNWISE))
        reqs.append(("sparse-jlt", "sparse_sketch_apply",
                     sk.JLT(8192, 1024, Context(850 + i)),
                     csr_operand(8192, 512, 0.01, 8500 + i), sk.COLUMNWISE))
        reqs.append(("cwt", "sketch_apply",
                     sk.CWT(8192, 1024, Context(860 + i)),
                     make_operand(torch, (int(g.integers(257, 513)), 8192),
                                  8600 + i), sk.ROWWISE))
        reqs.append(("srht", "sketch_apply",
                     sk.FJLT(8192, 1024, Context(870 + i), fut="wht"),
                     make_operand(torch, (int(g.integers(257, 513)), 8192),
                                  8700 + i), sk.ROWWISE))
    return reqs


def submit(ex, endpoint, T, A, dim):
    if endpoint == "fastfood_features":
        return ex.submit_fastfood(T, A)
    if endpoint == "sparse_sketch_apply":
        return ex.submit_sparse(T, A, dimension=dim)
    return ex.submit_sketch(T, A, dimension=dim)


def storm(ex, reqs, threads: int = 4):
    """Submit every request from ``threads`` threads, interleaved; returns
    the results and, per request, (submit time, completion time)."""
    import threading

    futs = [None] * len(reqs)
    times = [[0.0, 0.0] for _ in reqs]

    def done(i):
        return lambda f: times[i].__setitem__(1, time.perf_counter())

    def worker(t):
        for i in range(t, len(reqs), threads):
            _, endpoint, T, A, dim = reqs[i]
            times[i][0] = time.perf_counter()
            futs[i] = submit(ex, endpoint, T, A, dim)
            futs[i].add_done_callback(done(i))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return [f.result(timeout=300) for f in futs], times


# the kernels the serve phase must launch
SERVE_KERNELS = ("dense_batched_rowwise", "dense_batched_columnwise",
                 "fastfood_batched", "sparse_rowwise", "sparse_columnwise",
                 "hash_rowwise", "fwht_rowwise")
# buckets whose result is held bit-equal to the plain program on the CPU
EXACT_BUCKETS = ("sparse-rw", "sparse-cw", "cwt")


def serve_phase(torch, P, np) -> dict:
    """Phase 4b, the serving path at full width: 16 requests per main
    bucket from 4 threads into one MicrobatchExecutor(max_batch=8,
    linger_us=5000) on the card, once to warm up and once measured, with
    every launch counter set to 0 just before the measured storm and read
    just after. Then each request's result is held to its own capacity-1
    flush with kernel="plain" (on the card, ≤ TOL·max|plain|, the CT's
    Cauchy draws entry by entry within :func:`elementwise_limit`; for CWT
    on the CPU, torch.equal) and to its own capacity-1 flush through the
    kernel (torch.equal: capacity invariance)."""
    from libskylark_tpu_torch import engine, sketch as sk
    from libskylark_tpu_torch.base import randgen

    reqs = serve_requests(torch, np)
    names = sorted({r[0] for r in reqs})
    statics = {b: repr(engine.request_statics(
        e, transform=T, A=A, dimension=dim))
        for b, e, T, A, dim in reqs}
    out = {"buckets": {}}
    with engine.MicrobatchExecutor(max_batch=8, linger_us=5000,
                                   device="cuda") as ex:
        storm(ex, reqs)
        torch.cuda.synchronize()
        warm = ex.stats()
    with engine.MicrobatchExecutor(max_batch=8, linger_us=5000,
                                   device="cuda") as ex:
        for c in counters():
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        results, times = storm(ex, reqs)
        torch.cuda.synchronize()
        out["storm_seconds"] = time.perf_counter() - t0
        out["launches"] = launch_counts()
        st = ex.stats()
    check(warm["failed"] == 0, f"warm-up storm failed: {warm['failed']}")
    out["stats"] = {k: st[k] for k in (
        "submitted", "completed", "failed", "rejected", "flushes",
        "coalesced", "isolation_retries", "kernel", "sparse",
        "padding_waste_ratio", "latency_s", "batch_capacity_hist")}
    for b in names:
        mine = [i for i, r in enumerate(reqs) if r[0] == b]
        lat = sorted(times[i][1] - times[i][0] for i in mine)
        span = (max(times[i][1] for i in mine)
                - min(times[i][0] for i in mine))
        out["buckets"][b] = {"requests": len(mine),
                             "requests_per_s": len(mine) / span,
                             "latency_p50_ms": 1e3 * statistics.median(lat),
                             "latency_p99_ms": 1e3 * lat[-1],
                             **st["by_bucket"][statics[reqs[mine[0]][0]]]}
    check(st["failed"] == 0 and st["completed"] == len(reqs)
          and st["submitted"] == len(reqs),
          f"serve storm: {st['submitted']} submitted, {st['completed']} "
          f"completed, {st['failed']} failed of {len(reqs)}")
    check(set(st["kernel"]["by_backend"]) == {"cuda"}
          and not st["kernel"]["by_reason"],
          f"a kernel bucket flushed on the plain program: {st['kernel']}")
    for k in SERVE_KERNELS:
        check(out["launches"][k] > 0, f"kernel {k} never launched by the "
                                      "serve phase")

    # references: capacity-1 flushes, plain and through the kernel
    with engine.MicrobatchExecutor(max_batch=1, kernel="plain",
                                   device="cuda") as plain, \
            engine.MicrobatchExecutor(max_batch=1, device="cpu") as cpu, \
            engine.MicrobatchExecutor(max_batch=1, device="cuda") as one:
        worst, over = {}, {}
        for (b, e, T, A, dim), got in zip(reqs, results):
            alone = submit(one, e, T, A, dim).result(timeout=300)
            check(bool(torch.equal(got, alone)),
                  f"{b}: a lane of a capacity-8 flush differs from its "
                  "capacity-1 flush through the kernel")
            if b in EXACT_BUCKETS:
                Ah = A.cpu() if isinstance(A, torch.Tensor) else A
                want = submit(cpu, e, T, Ah, dim).result(timeout=300)
                ok = bool(torch.equal(got.cpu(), want))
                err = float((got.cpu() - want).abs().max())
            else:
                want = submit(plain, e, T, A, dim).result(timeout=300)
                limit = None
                if isinstance(getattr(T, "dist", None), randgen.Cauchy):
                    limit = elementwise_limit(
                        torch, T.allocation.key, T.dist, A, T.sketch_dim,
                        float(T.scale), dim == sk.ROWWISE)
                h = held(torch, got, want, limit)
                ok, err = h["ok"], h["max_abs_err"]
                if limit is not None:
                    over[b] = max(over.get(b, 0.0), h["max_err_over_limit"])
            check(ok and tuple(got.shape) == tuple(want.shape),
                  f"{b}: served result disagrees with its plain flush "
                  f"(max abs err {err})")
            worst[b] = max(worst.get(b, 0.0), err)
    out["max_abs_err_vs_plain"] = worst
    out["max_err_over_elementwise_limit"] = over
    emit("serve", **out)
    return out


def flush_cell(torch, ex, bucket_reqs, reps: int = 5, warmup: int = 2):
    """One bucket's capacity-8 flush through ``ex`` (max_batch 16, a long
    linger, so 8 submits wait for :meth:`flush`): ``warm_ms``, the median
    host time of the synchronous flush; ``device_ms``, its kernels' time
    under torch.profiler in one more flush; ``busy`` = device/warm."""
    from torch.profiler import ProfilerActivity, profile

    def one():
        futs = [submit(ex, e, T, A, dim) for _, e, T, A, dim in bucket_reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.flush()
        ms = (time.perf_counter() - t0) * 1e3
        for f in futs:
            f.result()
        return ms

    for _ in range(warmup):
        one()
    warm = statistics.median(one() for _ in range(reps))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"warm_ms": warm, "device_ms": device, "busy": device / warm,
            "requests_per_s": len(bucket_reqs) / (warm / 1e3)}


def serve_cells(torch, np) -> dict:
    """Every serve bucket's flush cell (:func:`flush_cell`) on its first 8
    requests (the smaller buckets: their 4)."""
    from libskylark_tpu_torch import engine

    reqs = serve_requests(torch, np)
    cells = {}
    with engine.MicrobatchExecutor(max_batch=16, linger_us=60_000_000,
                                   device="cuda") as ex:
        for b in sorted({r[0] for r in reqs}):
            cells[b] = flush_cell(torch, ex, [r for r in reqs
                                              if r[0] == b][:8])
    return cells


def time_serve_kernels(torch, P, np, peaks: dict) -> list[dict]:
    """Phase 5, the serve kernels at their buckets' capacity-8 shapes:
    kernel (a new key per lane and call), plain version, and one PyTorch
    call on pre-made randomness — B1-batched torch.bmm against stored
    per-lane S; B4-batched the batched kron two-matmul WHT chain with its
    gather on stored streams; B3 one index_add_ of v·data at (row,
    h[col]) with h, v gathered beforehand."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.engine import bucket
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf
    from libskylark_tpu_torch.sketch import cuda_hash as ch
    from libskylark_tpu_torch.sketch import cuda_sparse as cs
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    rows = []
    for name, dist, B, shape, s_dim, _ in BATCHED_CASES[:2]:
        rowwise = name == "dense_batched_rowwise"
        d = {"normal": randgen.Normal(), "cauchy": randgen.Cauchy()}[dist]
        A = make_operand(torch, (B, *shape), 9000)
        ctx = P.Context(900)
        sc = np.full(B, 1.0 / s_dim)
        n, m = (shape[1], shape[0]) if rowwise else shape
        ms = event_ms(torch, lambda: cd.serve_batched_apply(
            new_keys(np, ctx, B), sc, A, d, s_dim, rowwise))
        f32_ms = event_ms(torch, lambda: cd.serve_batched_apply(
            new_keys(np, ctx, B), sc, A, d, s_dim, rowwise, "f32"))
        dev_ms = profiled_device_ms(torch, lambda: cd.serve_batched_apply(
            new_keys(np, ctx, B), sc, A, d, s_dim, rowwise))
        plain_ms = event_ms(torch, lambda: cd.serve_batched_plain(
            new_keys(np, ctx, B), sc, A, d, s_dim, rowwise))
        S = torch.stack([virtual_panel(k, d, s_dim, 0, n, 1.0 / s_dim,
                                       device=A.device)
                         for k in new_keys(np, ctx, B)])
        lib = (lambda: torch.bmm(A, S.transpose(1, 2))) if rowwise else (
            lambda: torch.bmm(S, A))
        library_ms = event_ms(torch, lib)
        rows.append({"kernel": name, "use": f"serve {name}", "main_path": True,
                     "shape": [B, *shape], "s_dim": s_dim, "ms": ms,
                     "f32_ms": f32_ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **dense_bounds(2.0 * B * m * n * s_dim,
                                    4.0 * B * (m * n + m * s_dim), peaks)})
        del A, S

    B, m, d, s_dim = FASTFOOD_BATCHED_CASES[0]
    A = make_operand(torch, (B, m, d), 9100)
    ctx = P.Context(910)
    args = (d, s_dim, "wht", "gauss", 64.0)
    streams = cf.batched_streams(new_keys(np, ctx, B), *args, A.device)
    scale = math.sqrt(2.0 / s_dim)
    ms = event_ms(torch, lambda: cf.apply_streams_batched(A, streams, scale,
                                                          s_dim))
    dev_ms = profiled_device_ms(torch, lambda: cf.apply_streams_batched(
        A, streams, scale, s_dim))
    wrapper_ms = event_ms(torch, lambda: cf.serve_features_batched(
        new_keys(np, ctx, B), A, *args))
    plain_ms = event_ms(torch, lambda: cf.serve_features_plain(
        new_keys(np, ctx, B), A, *args), reps=3, warmup=1)
    library_ms = event_ms(torch, lambda: wht_chain_batched(
        torch, A, streams, scale, s_dim))
    NB, nb = streams[0].shape[2], streams[0].shape[1]
    rows.append({"kernel": "fastfood_batched", "use": "serve fastfood",
                 "main_path": True, "shape": [B, m, d], "s_dim": s_dim,
                 "ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
                 "plain_ms": plain_ms,
                 "library_ms": library_ms,
                 **bound(2.0 * B * m * NB * math.log2(NB) * nb,
                         peaks["fp32_flops"] / 2,
                         4.0 * B * (m * d + m * s_dim), peaks)})
    del A, streams

    for i, (name, B, nr, nc, density, s_dim) in enumerate(SPARSE_CASES[:2]):
        rowwise = name == "sparse_rowwise"
        ops = [csr_operand(nr, nc, density, 9200 + 10 * i + b)
               for b in range(B)]
        nnz_class = bucket.nnz_class(max(A.nnz for A in ops))
        shape = bucket.pad_shape((nr, nc), (0, 1))
        data, r, c, nnz = csr_lanes(torch, ops, nnz_class, shape[0])
        ctx = P.Context(920 + i)
        m = shape[0] if rowwise else shape[1]
        n = shape[1] if rowwise else shape[0]
        ms = event_ms(torch, lambda: cs.cwt_sparse_apply_batched(
            new_keys(np, ctx, B), data, r, c, s_dim, rowwise, shape))
        dev_ms = profiled_device_ms(
            torch, lambda: cs.cwt_sparse_apply_batched(
                new_keys(np, ctx, B), data, r, c, s_dim, rowwise, shape))
        plain_ms = event_ms(torch, lambda: cs.cwt_sparse_plain(
            new_keys(np, ctx, B), data, r, c, s_dim, rowwise, shape))
        hv = [ch.streams(k, n, s_dim, data.device)
              for k in new_keys(np, ctx, B)]
        hashed, kept = (c, r) if rowwise else (r, c)
        lane = torch.arange(B, device=data.device)[:, None]
        h = torch.stack([x[0] for x in hv]).gather(1, hashed.long())
        v = torch.stack([x[1] for x in hv]).gather(1, hashed.long())
        lin = ((lane * m + kept) * s_dim + h if rowwise
               else (lane * s_dim + h) * m + kept).reshape(-1)
        vals = (v * data).reshape(-1)
        library_ms = event_ms(torch, lambda: torch.zeros(
            B * m * s_dim, device=data.device).index_add_(0, lin, vals))
        # a multiply and an add per nonzero; the real nonzeros' (value,
        # row, col) read once, the output written once
        rows.append({"kernel": name, "use": f"serve {name}",
                     "main_path": True, "shape": [B, nr, nc],
                     "s_dim": s_dim, "nnz": nnz, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     **bound(2.0 * nnz, peaks["fp32_flops"],
                             12.0 * nnz + 4.0 * B * m * s_dim, peaks)})
        del data, r, c, lin, vals
    return rows


def wht_chain_batched(torch, A, streams, scale, s_dim):
    """:func:`wht_chain` over a cohort: A (B, m, d) and (B, nb, NB)
    streams made beforehand."""
    bdiag, perms, gdiag, smdiag, sh = streams
    B, nb, NB = bdiag.shape
    m = A.shape[1]
    k = NB.bit_length() - 1
    a, b = 1 << (k - k // 2), 1 << (k // 2)
    Ha, Hb = (torch.ones(1, 1, device=A.device), ) * 2
    while Ha.shape[0] < a:
        Ha = torch.cat([torch.cat([Ha, Ha], 1), torch.cat([Ha, -Ha], 1)])
    while Hb.shape[0] < b:
        Hb = torch.cat([torch.cat([Hb, Hb], 1), torch.cat([Hb, -Hb], 1)])

    def wht(W):
        return torch.matmul(torch.matmul(Ha, W.reshape(B, nb, m, a, b)),
                            Hb).reshape(W.shape)

    X = torch.nn.functional.pad(A, (0, NB - A.shape[2]))
    W = wht(bdiag[:, :, None, :] * X[:, None])
    W = wht(gdiag[:, :, None, :] * torch.gather(
        W, 3, perms.long()[:, :, None, :].expand(B, nb, m, NB)))
    F = scale * torch.cos(smdiag[:, :, None, :] * W + sh[:, :, None, :])
    return F.permute(0, 2, 1, 3).reshape(B, m, nb * NB)[:, :, :s_dim]


# (kernel, dist, B, one lane's shape, s_dim, ragged): the dense-rw and
# ct-cw buckets' capacity-8 shapes (the first two are timed), ct-cw's
# shape with Normal draws, then ragged lanes padded into the stack and
# small uneven cases
BATCHED_CASES = [
    ("dense_batched_rowwise", "normal", 8, (2048, 8192), 1024, False),
    ("dense_batched_columnwise", "cauchy", 8, (8192, 128), 1024, False),
    ("dense_batched_columnwise", "normal", 8, (8192, 128), 1024, False),
    ("dense_batched_rowwise", "normal", 8, (2048, 8192), 1024, True),
    ("dense_batched_columnwise", "cauchy", 8, (8192, 128), 1024, True),
    ("dense_batched_rowwise", "cauchy", 3, (37, 700), 48, True),
    ("dense_batched_columnwise", "normal", 3, (700, 37), 300, True),
]
# (B, m, d, S): the fastfood bucket's capacity-8 shape; padding, 3 blocks
# and truncation
FASTFOOD_BATCHED_CASES = [(8, 2048, 4096, 4096), (3, 37, 1000, 3000)]
# (kernel, B, rows, cols, density, s_dim): the sparse buckets' capacity-8
# shapes at rcv1's density; then s = 300 (randint's multiplier is not 0)
# and s = 7 (many nonzeros of a row or column share a bucket)
SPARSE_CASES = [
    ("sparse_rowwise", 8, 4096, RCV1_D, RCV1_DENSITY, 1024),
    ("sparse_columnwise", 8, RCV1_D, 512, RCV1_DENSITY, 1024),
    ("sparse_rowwise", 3, 300, 5000, 0.02, 300),
    ("sparse_columnwise", 3, 5000, 300, 0.02, 300),
    ("sparse_rowwise", 2, 64, 1000, 0.1, 7),
    ("sparse_columnwise", 2, 1000, 64, 0.1, 7),
]


# config 3 (BASELINE.md): 16384 rows, d = 4096 → S = 4096
RFT_SHAPE, RFT_S = (16384, 4096), 4096

# (kernel, use, A's shape, s_dim); A is (m, N) rowwise, (N, m) columnwise
MAIN_SHAPES = [
    ("dense_rowwise", "JLT.apply rowwise", (8192, 8192), 1024),
    ("dense_rowwise", "SVD range sketch", (8192, 8192), 128),
    ("dense_columnwise", "JLT.apply columnwise", (8192, 8192), 1024),
    ("dense_columnwise", "least squares S·[A|b]", (65536, 513), 2048),
    # LaplacianRFT projects its Cauchy frequencies in f32 (sketch/rft.py)
    ("dense_rowwise", "LaplacianRFT (Cauchy) features", (16384, 4096), 4096,
     "cauchy", "f32"),
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
    cases = [(name, (d or ["normal"])[0], shape, s)
             for name, _, shape, s, *d in MAIN_SHAPES]
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

COS_CASES = [(RFT_SHAPE, RFT_S), ((37, 700), 48), ((1000, 3000), 300)]
# (m, d, S): config 3; NB = 1024 with 3 blocks, padding and truncation;
# odd log2 NB; few rows
FASTFOOD_CASES = [(*RFT_SHAPE, RFT_S), (512, 1000, 3000), (512, 2048, 2048),
                  (37, 4096, 4096)]

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
    "dense_rowwise_cos": (CSRC + "dense_sketch.cu",
                          "libskylark_tpu/sketch/pallas_dense.py:396"),
    "fastfood": (CSRC + "fastfood.cu",
                 "libskylark_tpu/sketch/pallas_fastfood.py:166"),
    "fastfood_split": (CSRC + "fastfood.cu",
                       "libskylark_tpu/sketch/pallas_fastfood.py:201"),
    "dense_batched_rowwise": (CSRC + "dense_sketch.cu",
                              "libskylark_tpu/sketch/pallas_dense.py:954"),
    "dense_batched_columnwise": (CSRC + "dense_sketch.cu",
                                 "libskylark_tpu/sketch/pallas_dense.py:954"),
    "fastfood_batched": (CSRC + "fastfood.cu",
                         "libskylark_tpu/sketch/pallas_fastfood.py:255"),
    "sparse_rowwise": (CSRC + "sparse_sketch.cu",
                       "libskylark_tpu/sketch/pallas_sparse.py:225"),
    "sparse_columnwise": (CSRC + "sparse_sketch.cu",
                          "libskylark_tpu/sketch/pallas_sparse.py:225"),
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

    import numpy as np

    checked = (check_kernels(torch, P, check_cases())
               + check_hash(torch, P, HASH_CASES)
               + check_fwht(torch, P, FWHT_CASES)
               + check_cos(torch, P, COS_CASES)
               + check_fastfood(torch, P, FASTFOOD_CASES)
               + check_batched(torch, P, np) + check_sparse(torch, P, np))
    main = main_path(torch, P)
    serve = serve_phase(torch, P, np)
    emit("serve_cells", cells=serve_cells(torch, np))
    rows = (time_kernels(torch, P, MAIN_SHAPES, True, peaks)
            + time_kernels(torch, P, SPLIT_LS_SHAPES, False, peaks)
            + time_hash(torch, P, HASH_SHAPES, peaks)
            + time_fwht(torch, P, FWHT_SHAPES, peaks)
            + time_cos(torch, P, peaks) + time_fastfood(torch, P, peaks)
            + time_serve_kernels(torch, P, np, peaks))
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
                          "beforehand",
                  "cos": "torch.matmul against S made beforehand (TF32 "
                         "off), then the epilogue's elementwise ops and "
                         "torch.cos on sc and sh made beforehand",
                  "fastfood": "the chain from torch calls on streams made "
                              "beforehand: kron two-torch.matmul WHT (TF32 "
                              "off), gather, torch.cos",
                  "dense_batched": "torch.bmm against per-lane S made "
                                   "beforehand (TF32 off)",
                  "fastfood_batched": "the fastfood chain over the cohort "
                                      "on streams made beforehand",
                  "sparse": "one index_add_ of v·data at (row, h[col]) or "
                            "(h[row], col), h and v gathered beforehand"},
         rows=rows)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name and r["main_path"]]
        head = mine[0]
        # the worst check at this kernel's main-path shapes, over every
        # distribution and ragged variant checked there
        at = {(tuple(r["shape"]), r["s_dim"]) for r in mine}
        cs = [c for c in checked if c["kernel"] == name
              and (tuple(c["shape"]), c["s_dim"]) in at]
        check(bool(cs), f"{name}: no check at its main-path shapes")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main["launches"][name] + serve["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "shape": head["shape"], "s_dim": head["s_dim"],
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **{k: head[k] for k in ("regime", "f32_ms", "bounds")
               if k in head}})
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
