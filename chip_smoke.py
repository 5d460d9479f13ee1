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
              (bf16x3, the default, bf16gen2 and bf16, and f32 as
              3×TF32, all on the tensor cores) against the plain version of that
              regime, max|kernel − plain| ≤ 1e-4·max|plain|, and Cauchy
              draws entry by entry, |kernel − plain| ≤ 1e-4·(|S|·|A|) (the
              heavy tail puts max|plain| far above a typical entry);
            - hash (B2): bit-equal (torch.equal) to the plain scatter run
              on a CPU copy of the operand, also at a span that is not a
              power of two (s = 300), at ragged n, and at config 5's
              sketched regression (60000×8192 and 60000×10 → 32768); and
              cohorts through the batched entry point (B ∈ {1, 3, 8},
              ragged lanes, an all-padding lane, s = 7), every lane also
              bit-equal to a launch of that lane alone;
            - fwht (B5): bit-equal on dyadic data (integers in [−8, 8],
              n = 4096 and 65536, both ways), ≤ 1e-4·max|plain| on
              Gaussian data; cohorts as for B2 at every segment plan
              (whole rows at n = 128 and 8192, folded segments at n =
              65536 both ways), every lane bit-equal to its launch alone;
            - cos (B1-cos): random sc/sh, every regime, ≤ 1e-4·max|plain|,
              also at config 5's 60000×784 → 2047, 2048, 2051 and 8192
              and at its other row counts, 16384 and 10000 → 2048 (d =
              784 is no multiple of the block columns);
            - fastfood (B4, B4-split): ≤ 1e-4·max|plain| at 16384×4096 →
              4096, d = 1000 → 3000 (padding, 3 blocks, truncation), an
              odd log2 NB (d = 2048), m = 37, NB = 16384, NB = 2 and
              config 5's 60000×784 and 10000×784 → 8192 (NB = 1024, 8
              blocks); and
              B4-split's first kernel output W torch.equal to
              fut._wht_butterfly(B ⊙ x) at every case (the redesigned
              WHT keeps the butterfly's sum order);
            - batched (B1-batched in every regime, B4-batched): the serve
              buckets' capacity-8 stacks (the ct-cw shape with Cauchy and
              with Normal draws) and ragged lanes zero-padded into them,
              against the per-lane serve program with B1's limits, and every
              lane bit-equal to a launch of that lane alone (B4-batched
              also at m = 3001 and m = 37 with NB = 128, neither a
              multiple of a block's rows);
            - sparse (B3): CSR lanes at config 2's shape (rcv1.binary:
              47,236 features, 0.16% dense) both ways, s = 300 and s = 7,
              bit-equal to the plain scatter on a CPU copy, every lane
              bit-equal to its launch alone; also duplicate (row,
              column) entries inside a row, a row of more than 1024
              nonzeros, an all-padding lane, and outputs wider than the
              kernels' on-chip row of 1024 columns both ways (rowwise s =
              2048 and 8192), and rowwise 2^21 columns at s = 300;
            - f32 exact (B1 in f32): config 3's Laplacian projection on
              2048 rows through the kernel against the float64 product,
              entry by entry within 1e-4·(|S|·|A|), the plain version's
              figure beside it;
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
            held to its kernel's Gram matrix on 512 sampled rows (and
            the Laplacian features, whose Cauchy projection runs B1 in
            f32, to the plain f32 route's entry by entry, within the
            phase's elementwise limit times cos's Lipschitz factor);
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
            bit-equal to its capacity-1 kernel flush, and each serve-cwt
            and serve-srht flush exactly one hash_batched or fwht_batched
            launch; then each bucket's flush cell (warm ms, device ms,
            busy);
4c. sparse — config 2 end to end at full width (LIBSVM rcv1.binary's
            20,242 × 47,236 at 0.16%): a sprand.sample operand with
            dyadic values written by write_libsvm and read back by
            read_libsvm(sparse=True) through the native parser (CSR
            torch.equal, an arc-list file likewise); JLT, CT, UST, CWT
            → 1024 and GaussianRFT, LaplacianRFT → 4096 rowwise on the
            CSR against each transform's dense apply of the densified
            operand (≤ 1e-4·max|dense|, CT and LaplacianRFT entry by
            entry, UST and CWT torch.equal, CWT also to B3's plain
            version on the CPU); approximate_svd at rank 64, q = 2, of
            the operand with weighted documents (SVD_WEIGHT), never
            densified, σ within 1e-3 of the float64 eigenvalues of its
            Gram matrix and the reconstruction within 1.01 × the optimal
            tail; on a 262,144 × 1,024 CSR at 0.5%:
            approximate_least_squares (CWT: B3-cw on A, B2-cw on b),
            solve_l2_accelerated blendenpik and lsrn, sparse_solve_serve
            (CWT and JLT) against solve_l2_sketched on the same key,
            condest against the float64 singular values, condest_serve
            against condest; every product on the CSR route (cuSPARSE),
            B3 both ways and B2-cw launched; spmm/spmm_t timed at the
            SVD's and LSQR's shapes beside their bytes bound;
4d. ml   — BASELINE config 5 at MNIST's shape (60,000 training and
            10,000 held-out rows, d = 784, 10 classes; generated with a
            16-dimensional latent class structure), Gaussian kernel,
            through the public ml entry points, each step's launches
            required to be exactly its feature maps' and sketches'
            (B1-cos, B4, B2-cw): approximate_kernel_rlsc at s = 8192 with
            Gaussian features, with the regression sketched by the CWT and
            by the FJLT (DCT), and with Fastfood features, each W held to
            its normal equations in float64 with the features made again
            by the plain route (≤ 1e-3·‖ZᵀY‖_F); large_scale_kernel_rlsc
            (BCD over 4 blocks, tolerance 1e-3, 4 B1-cos launches a sweep,
            ≤ 1e-2); faster_kernel_rlsc on 16,384 rows with the
            random-features preconditioner (s = 2048) and without,
            against kernel_rlsc's Cholesky (rtol 1e-2, atol 1e-3), with
            fewer CG iterations; BlockADMMSolver.from_kernel (hinge, L2,
            λ = 0.01, 4 partitions, 10 iterations) against the same maps
            on their plain route (coefficients ≤ 1e-3·max|coef|, each
            iteration's objective ≤ 1e-4 relative); every model's
            held-out accuracy, required above 5× chance; and the ADMM
            model saved, loaded and predicting torch.equal;
5. time   — CUDA-event medians of each kernel, its plain version and one
            PyTorch call computing the same function, beside the card's
            bound, at the main-path shapes (B1 in its default regime, with
            the f32 regime's time and each regime's bound beside it, the
            fp32-FMA bound of f32 too; the LaplacianRFT shape in f32, its
            route; B1-cos also at config 5's 60000×784 → 2048 and 8192);
            every
            timed call of a kernel or a plain version draws a new key from
            one Context, as a user solving again does (the Fastfood
            kernels, whose streams are made outside them, are timed on
            streams made beforehand, and their wrappers with new streams
            per call beside them); the serve kernels at their buckets'
            capacity-8 shapes (B2's and B5's batched entry points at the
            cwt and srht buckets' capacity-4 shape);
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
                      "tf32_tensor_flops": 495e12,
                      "hbm_bytes_per_s": 3.35e12}
FP32_LANES_PER_SM = {9: 128}  # Hopper: 128 fp32 FMA units per SM
# Hopper: 4 tensor cores per SM, each 512 dense bf16 FMA (1024 flops) a
# clock, and half that in tf32
BF16_FLOPS_PER_SM_CLOCK = {9: 4 * 1024}
TF32_FLOPS_PER_SM_CLOCK = {9: 4 * 512}


def card_peaks(torch) -> dict:
    """The attached card's peak rates, from its own attributes: fp32 FMA
    lanes × 2 × SM count × max SM clock; bf16 (tf32) dense tensor flops
    per SM per clock (4 tensor cores × 1024 (512)) × SM count × max SM
    clock; and 2 (double data rate) × max memory clock × bus width. B1
    runs its bf16 regimes in bf16 and ``f32`` as three tf32 passes on the
    tensor cores; the other kernels add and multiply in fp32 on the CUDA
    cores."""
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
            "tf32_tensor_flops": TF32_FLOPS_PER_SM_CLOCK[major] * sms * sm_hz,
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
    results += check_cohorts(torch, P, HASH_BATCHED_CASES, "hash_batched")
    emit("check", tolerance="B2: torch.equal with the plain scatter on a "
                            "CPU copy; every lane of a cohort torch.equal "
                            "to its launch alone", cases=results)
    bad = [r for r in results
           if not r["bit_equal"] or not r.get("capacity_invariant", True)]
    check(not bad, f"CountSketch kernel differs from its plain version: {bad}")
    return results


def cohort_operand(torch, g, B, shape, rowwise, variant, dyadic, seed):
    """A stacked cohort (B, *shape): lanes with fewer vectors on the free
    axis zero-padded into it ("ragged"), or lane 1 all padding
    ("empty_lane"); integers in [−8, 8] when ``dyadic``."""
    free = 0 if rowwise else 1
    lanes = []
    for b in range(B):
        sh = list(shape)
        if variant == "ragged":
            sh[free] = int(g.integers(max(1, shape[free] // 2),
                                      shape[free] + 1))
        if dyadic:
            gen = torch.Generator(device="cuda").manual_seed(seed + b)
            lane = torch.randint(-8, 9, tuple(sh), generator=gen,
                                 device="cuda").float()
        else:
            lane = make_operand(torch, tuple(sh), seed + b)
        if variant == "empty_lane" and b == 1:
            lane.zero_()
        pad = [0, 0, 0, 0]
        pad[3 - 2 * free] = shape[free] - sh[free]
        lanes.append(torch.nn.functional.pad(lane, pad))
    return torch.stack(lanes)


def check_cohorts(torch, P, cases, name) -> list:
    """Phase 3, the batched entry points of B2 (``hash_batched``) and B5
    (``fwht_batched``): each cohort against the plain version lane by lane
    (B2 on a CPU copy, torch.equal; B5 on the card, torch.equal on dyadic
    data, else ≤ TOL·max|plain|), and every lane torch.equal to a launch of
    that lane alone (B = 1)."""
    import numpy as np

    from libskylark_tpu_torch.sketch import cuda_fwht as cf
    from libskylark_tpu_torch.sketch import cuda_hash as ch

    hash_ = name == "hash_batched"
    fn = ch.cwt_apply_batched if hash_ else cf.srht_apply_batched
    plain = ch.cwt_apply_batched_plain if hash_ else cf.srht_apply_batched_plain
    g = np.random.default_rng(7000 if hash_ else 7100)
    results = []
    for i, (rowwise, B, shape, s_dim, variant, dyadic) in enumerate(cases):
        kd = new_keys(np, P.Context((710 if hash_ else 720) + i), B)
        A = cohort_operand(torch, g, B, shape, rowwise, variant, dyadic,
                           (7200 if hash_ else 7300) + 10 * i)
        got = fn(kd, A, s_dim, rowwise)
        alone = [fn(kd[b:b + 1], A[b:b + 1], s_dim, rowwise)[0]
                 for b in range(B)]
        want = plain(kd, A.cpu() if hash_ else A, s_dim, rowwise)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name} output not finite")
        got_c = got.cpu() if hash_ else got
        err = float((got_c - want).abs().max())
        top = float(want.abs().max())
        equal = bool(torch.equal(got_c, want))
        inv = all(bool(torch.equal(got[b], alone[b])) for b in range(B))
        ok = (equal if hash_ or dyadic else err <= TOL * top) and inv
        results.append({"kernel": name, "rowwise": rowwise,
                        "shape": [B, *shape], "s_dim": s_dim,
                        "variant": variant, "dyadic": dyadic,
                        "max_abs_err": err,
                        "max_rel_err": err / top if top else 0.0,
                        "bit_equal": equal,
                        "capacity_invariant": inv, "ok": ok})
        del A, got, alone, want
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
        n, m = (shape[1], shape[0]) if rowwise else shape
        runs = cf._load().sk_fwht_groups(m, n, int(rowwise))
        check(runs == cf.plan(n, m, rowwise)["groups"],
              f"SRHT {name} {shape}: the kernel cuts {runs} runs, the "
              "CPU replay's plan() another count")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ok = bool(torch.equal(got, want)) if dyadic else rel <= TOL
        results.append({"kernel": name, "shape": list(shape), "s_dim": s_dim,
                        "dyadic": dyadic, "runs": runs,
                        "max_abs_err": err, "max_rel_err": rel, "ok": ok})
        del A
    results += check_cohorts(torch, P, FWHT_BATCHED_CASES, "fwht_batched")
    emit("check", tolerance=f"B5: torch.equal on dyadic data, else "
                            f"max|kernel-plain| <= {TOL} * max|plain|; "
                            "every lane of a cohort torch.equal to its "
                            "launch alone",
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

    from libskylark_tpu_torch.sketch.fut import _wht_butterfly

    results = []
    for i, (m, d, s_dim) in enumerate(cases):
        T = sk.FastGaussianRFT(d, s_dim, P.Context(500 + i),
                               sigma=math.sqrt(d))
        A = make_operand(torch, (m, d), 5000 + i)
        # B4-split's first kernel: W = H(B ⊙ x), x zero-padded to NB, laid
        # out (nb, m, NB), in the butterfly's sum order bit for bit
        bdiag = cf.kernel_streams(T, A.device)[0]
        W = cf.split_pre(A, bdiag)
        X = torch.nn.functional.pad(A, (0, T._NB - d))
        w_equal = bool(torch.equal(W, _wht_butterfly(
            bdiag[:, None, :] * X[None], axis=2)))
        del W, X
        want = cf.fastfood_plain(T, A)
        for name, variant in (("fastfood", "fused"),
                              ("fastfood_split", "split")):
            got = cf.features_rows(T, A, variant)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} output not finite")
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            split = variant == "split"
            results.append({"kernel": name, "shape": [m, d], "s_dim": s_dim,
                            "NB": T._NB, "blocks": T._numblks,
                            "max_abs_err": err, "max_rel_err": rel,
                            **({"w_bit_equal": w_equal} if split else {}),
                            "ok": rel <= TOL and (w_equal or not split)})
        del A, want
    emit("check", tolerance=f"B4: max|kernel-plain| <= {TOL} * max|plain|; "
                            "B4-split's W torch.equal to the butterfly",
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
    Tl = lap.create_rft(s, P.Context(63), "regular")
    Z = step("laplacian_regular", lambda: Tl.apply(X, sk.ROWWISE))
    gram_check("laplacian_regular", lap, Z, X)
    laplacian_check(torch, Tl, X, Z, out)

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
    check(out["dense_by_step"]["laplacian_regular"]
          == {"f32": 1, "generated_entries": s * d},
          f"LaplacianRFT B1 route {out['dense_by_step']['laplacian_regular']}")
    check(by_step["rft_fast"] == {"fastfood": 1},
          f"FastGaussianRFT launches {by_step['rft_fast']}")
    check(by_step["rft_fast_split"] == {"fastfood_split": 1},
          f"split launches {by_step['rft_fast_split']}")
    check(by_step["polynomial_ppt"] == {"hash_columnwise": 2},
          f"PPT launches {by_step['polynomial_ppt']}")
    return failed


def laplacian_check(torch, T, X, Z, out) -> None:
    """Main path, LaplacianRFT: its features Z, whose Cauchy projection
    runs B1 in f32 (3×TF32), against the plain f32 route's features (one
    fp32 matmul of the whole operator), entry by entry within the phase's
    elementwise limit times cos's Lipschitz factor, |ΔZ| ≤ outscale · sc ·
    TOL · inscale · (|X|·|W|ᵀ), as tests/test_torch_dense_regimes.py holds
    the cos kernel's Cauchy features. 1e-4 · max|Z| is no yardstick here:
    phases reach O(10³) rad, where one f32 ulp of a phase is 2.4e-4 rad;
    that figure is reported beside it."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import BLOCK_COLS

    s = Z.shape[1]
    W = randgen.dense_panel(T.subkey(0), T.dist, s, 0, X.shape[1],
                            BLOCK_COLS, torch.float32, X.device)
    want = T._featurize(cd.dense_apply_plain(T.subkey(0), T.dist, X, s,
                                             T.inscale, True, "f32"), 1)
    limit = (T.outscale * T.row_scales(torch.float32, X.device).double()
             * TOL * T.inscale * (X.abs().double() @ W.abs().double().T))
    diff = (Z - want).abs()
    out["laplacian_regular_err_over_limit_vs_plain"] = float(
        (diff.double() / limit).max())
    out["laplacian_regular_rel_err_vs_plain"] = float(diff.max()
                                                      / want.abs().max())
    check(out["laplacian_regular_err_over_limit_vs_plain"] <= 1.0,
          "LaplacianRFT features vs the plain f32 route")


def check_f32_exact(torch, P) -> list:
    """Phase 3, B1 in f32 against the exact product: LaplacianRFT's Cauchy
    projection (config 3's operator, 2048 of its 16384 rows) through the
    kernel and through the plain f32 version (cuBLAS fp32, TF32 off), each
    against the float64 product of the same operator, entry by entry over
    :func:`elementwise_limit`; the kernel must hold it."""
    from libskylark_tpu_torch import ml
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    (m, d), s = RFT_SHAPE, RFT_S
    X = make_operand(torch, (m, d), 12)[:2048].contiguous()
    T = ml.Laplacian(d, 2.0 * d).create_rft(s, P.Context(63), "regular")
    key, dist, scale = T.subkey(0), T.dist, T.inscale
    limit = elementwise_limit(torch, key, dist, X, s, scale, True)
    exact = X.double() @ virtual_panel(key, dist, s, 0, d, scale,
                                       device=X.device).double().T
    got = cd.rowwise_apply(key, dist, X, s, scale, precision="f32")
    plain = cd.dense_apply_plain(key, dist, X, s, scale, True, "f32")
    err = (got.double() - exact).abs()
    over = float((err / limit).max())
    results = [{"kernel": "dense_rowwise", "regime": "f32", "dist": "cauchy",
                "shape": list(X.shape), "s_dim": s, "against": "float64",
                "max_abs_err": float(err.max()),
                "kernel_err_over_limit": over,
                "plain_err_over_limit": float(
                    ((plain.double() - exact).abs() / limit).max()),
                "ok": over <= 1.0}]
    emit("check", tolerance=f"B1 f32 vs the float64 product: |kernel - "
                            f"exact| <= {TOL} * (|S|·|A|)", cases=results)
    check(results[0]["ok"], f"f32 route vs the exact product: {results}")
    return results


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


def dense_bounds(flops: float, nbytes: float, peaks: dict,
                 regime: str = "bf16x3") -> dict:
    """B1's bounds for a contraction of ``flops`` = 2·m·n·s (times the
    lanes): ``bound_ms``/``bound_by`` of ``regime`` (the one the entry
    point runs), and each regime's under ``bounds`` — the bf16 ones at the
    card's bf16 tensor rate, f32 as its 3 tf32 passes at the tf32 tensor
    rate, and ``f32_fma`` the same product at the fp32 FMA rate of the
    CUDA cores (the f32 regime's first body); bytes: A read once, the
    output written once."""
    bounds = {p: bound(k * flops, peaks["bf16_tensor_flops"], nbytes, peaks)
              for p, k in REGIME_PASSES.items()}
    bounds["f32"] = bound(3 * flops, peaks["tf32_tensor_flops"], nbytes,
                          peaks)
    bounds["f32_fma"] = bound(flops, peaks["fp32_flops"], nbytes, peaks)
    return {**bounds[regime], "regime": regime,
            "bounds": {p: {"bound_ms": b["bound_ms"],
                           "bound_by": b["bound_by"]}
                       for p, b in bounds.items()}}


def time_kernels(torch, P, shapes, main_path: bool,
                 peaks: dict) -> list[dict]:
    """Phase 5, B1: kernel (the default regime, and ``f32_ms`` the f32
    regime: 3×TF32 on the tensor cores), plain and library times at the
    given shapes. A shape's optional 6th field names the regime its entry
    point runs when that is not the default (``route_regime``, timed as
    ``route_ms``; ``device_ms``, ``plain_ms`` and the bound are the route
    regime's)."""
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
            ctx.allocate().key, dist, A, s_dim, scale, precision=route))
        plain_ms = event_ms(torch, lambda: cd.dense_apply_plain(
            ctx.allocate().key, dist, A, s_dim, scale, rowwise, route))
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
                                    4.0 * (m * n + m * s_dim), peaks,
                                    route)})
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
    """Phase 5, B1-cos at each of COS_TIME_SHAPES: kernel, plain version,
    and the torch chain on S, sc and sh made beforehand (torch.matmul,
    TF32 off, then the epilogue's elementwise ops and torch.cos)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    rows = []
    for i, ((m, n), s_dim, use) in enumerate(COS_TIME_SHAPES):
        A = make_operand(torch, (m, n), 14 + 10 * i)
        dist, ctx = randgen.Normal(), P.Context(16 + 10 * i)
        g = torch.Generator(device="cuda").manual_seed(17 + 10 * i)
        sc = torch.ones(s_dim, device="cuda")
        sh = 2 * math.pi * torch.rand(s_dim, generator=g, device="cuda")
        inscale, outscale = 1.0 / math.sqrt(n), math.sqrt(2.0 / s_dim)

        def args():
            return (ctx.allocate().key, dist, A, s_dim, inscale, outscale,
                    sc, sh)

        ms = event_ms(torch, lambda: cd.rft_rowwise_apply(*args()))
        f32_ms = event_ms(torch, lambda: cd.rft_rowwise_apply(
            *args(), precision="f32"))
        dev_ms = profiled_device_ms(torch,
                                    lambda: cd.rft_rowwise_apply(*args()))
        plain_ms = event_ms(torch, lambda: cd.rft_apply_plain(*args()))
        S = virtual_panel(ctx.allocate().key, dist, s_dim, 0, n, 1.0,
                          device=A.device)
        library_ms = event_ms(torch, lambda: outscale * torch.cos(
            torch.matmul(A, S.T) * inscale * sc + sh))
        del A, S
        # the epilogue's m·s cos aside
        rows.append({"kernel": "dense_rowwise_cos", "use": use,
                     "main_path": True, "shape": [m, n], "s_dim": s_dim,
                     "ms": ms, "f32_ms": f32_ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     **dense_bounds(2.0 * m * n * s_dim,
                                    4.0 * (m * n + m * s_dim), peaks)})
    return rows


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
    card, packed as the serve layer packs them (rows int32, as its kernel
    route asks for them); returns them and the operands' true nnz."""
    import numpy as np

    from libskylark_tpu_torch.engine.serve import MicrobatchExecutor
    from libskylark_tpu_torch.sketch import sparse_serve

    packed = [MicrobatchExecutor._pack_csr(A, rows_pad, nnz_class,
                                           np.float32) for A in ops]
    data, idx, ptr = (torch.from_numpy(np.stack(x)).cuda()
                      for x in zip(*packed))
    rows = sparse_serve.csr_row_ids(ptr, nnz_class, torch.int32)
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


def sparse_lanes(torch, np, case, seed: int):
    """The stacked lanes of one SPARSE_CASES entry on the card: (data,
    rows, cols, true nnz, nnz class, padded shape). Plain cases are packed
    as the serve layer packs them (:func:`csr_lanes`). A variant edits each
    lane's CSR triplets first and pads them as the serve layer does (value
    0.0 at column 0 in the padded extent's last row):

    - ``"dup"``: a fifth of the entries repeated with new values at the end
      of their row, so (row, column) pairs repeat inside a row, adjacent
      and not (canonical CSR has none; the sum must keep position order);
    - ``"long_row"``: row 1 of every lane filled at every column (more than
      1024 nonzeros in one row);
    - ``"empty_lane"``: lane 1 holds padding only."""
    from libskylark_tpu_torch.engine import bucket

    name, B, nr, nc, density, s_dim, *variant = case
    ops = [csr_operand(nr, nc, density, seed + b) for b in range(B)]
    shape = bucket.pad_shape((nr, nc), (0, 1))
    if not variant:
        nnz_class = bucket.nnz_class(max(A.nnz for A in ops))
        data, r, c, nnz = csr_lanes(torch, ops, nnz_class, shape[0])
        return data, r, c, nnz, nnz_class, shape
    g = np.random.default_rng(seed)
    trips = []
    for b, A in enumerate(ops):
        d, idx, ptr = A.csr_parts(np.float32)
        rows = np.repeat(np.arange(nr), np.diff(ptr))
        order = np.arange(len(d), dtype=np.float64)
        if variant[0] == "dup":
            pick = np.flatnonzero(g.random(len(d)) < 0.2)
            rows = np.concatenate([rows, rows[pick]])
            idx = np.concatenate([idx, idx[pick]])
            d = np.concatenate([d, g.standard_normal(len(pick))
                                .astype(np.float32)])
            order = np.concatenate([order, len(order) + order[pick]])
        elif variant[0] == "long_row":
            keep = rows != 1
            rows = np.concatenate([rows[keep], np.ones(nc, np.int64)])
            idx = np.concatenate([idx[keep], np.arange(nc)])
            d = np.concatenate([d[keep], g.standard_normal(nc)
                                .astype(np.float32)])
            order = np.concatenate([order[keep], np.arange(nc) - 0.5])
        elif variant[0] == "empty_lane" and b == 1:
            rows, idx, d, order = rows[:0], idx[:0], d[:0], order[:0]
        at = np.lexsort((order, rows))
        trips.append((d[at], rows[at], idx[at]))
    nnz_class = bucket.nnz_class(max(len(t[0]) for t in trips))
    data = np.zeros((B, nnz_class), np.float32)
    rows = np.full((B, nnz_class), shape[0] - 1, np.int64)
    cols = np.zeros((B, nnz_class), np.int32)
    for b, (d, rw, cl) in enumerate(trips):
        data[b, :len(d)], rows[b, :len(d)], cols[b, :len(d)] = d, rw, cl
    return (torch.from_numpy(data).cuda(), torch.from_numpy(rows).cuda(),
            torch.from_numpy(cols).cuda(), sum(len(t[0]) for t in trips),
            nnz_class, shape)


def check_sparse(torch, P, np) -> list:
    """Phase 3, B3: each cohort of CSR lanes bit-equal (torch.equal) to
    the plain scatter on a CPU copy of the lanes (it adds in CSR row-major
    order; CUDA's index_add_ is atomic), and every lane bit-equal to a
    launch of that lane alone."""
    from libskylark_tpu_torch.sketch import cuda_sparse as cs

    results = []
    for i, case in enumerate(SPARSE_CASES):
        name, B, rows, cols, density, s_dim, *variant = case
        rowwise = name == "sparse_rowwise"
        data, r, c, nnz, nnz_class, shape = sparse_lanes(torch, np, case,
                                                         7000 + 10 * i)
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
                        "s_dim": s_dim, "variant": (variant or [None])[0],
                        "nnz": nnz, "nnz_class": nnz_class,
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
                 "hash_batched", "fwht_batched")
# serve buckets whose flush is one launch of one batched kernel
ONE_LAUNCH_BUCKETS = {"cwt": "hash_batched", "srht": "fwht_batched"}
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
        ex.flush()  # the last flush's counters land after its futures
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
        ex.flush()
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
    for b, k in ONE_LAUNCH_BUCKETS.items():
        check(out["launches"][k] == out["buckets"][b]["flushes"],
              f"{b}: {out['launches'][k]} {k} launches for "
              f"{out['buckets'][b]['flushes']} flushes, not one a flush")
    for k in ("hash_rowwise", "hash_columnwise", "fwht_rowwise",
              "fwht_columnwise"):
        check(out["launches"][k] == 0,
              f"the serve phase launched {k}: a flush went lane by lane")

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

    rows += time_cohorts(torch, P, np, peaks)
    return rows


def time_cohorts(torch, P, np, peaks: dict) -> list[dict]:
    """Phase 5, B2's and B5's batched entry points at the serve-cwt and
    serve-srht buckets' capacity-4 shape (the first case of
    HASH_BATCHED_CASES, FWHT_BATCHED_CASES): kernel (new keys per lane
    and call), plain version, and the library chain on streams made
    beforehand — B2 one index_add_ of v·A at lane·s + h over the lanes'
    columns; B5 the D multiply, the kron two-matmul WHT (TF32 off), a
    gather at idx and the scale."""
    from libskylark_tpu_torch.sketch import cuda_fwht as cf
    from libskylark_tpu_torch.sketch import cuda_hash as ch
    from libskylark_tpu_torch.sketch import fut

    rows = []
    for name, cases in (("hash_batched", HASH_BATCHED_CASES),
                        ("fwht_batched", FWHT_BATCHED_CASES)):
        rowwise, B, shape, s_dim, _, _ = cases[0]
        hash_ = name == "hash_batched"
        A = make_operand(torch, (B, *shape), 9300 + hash_)
        ctx = P.Context(930 + hash_)
        fn = ch.cwt_apply_batched if hash_ else cf.srht_apply_batched
        plain = (ch.cwt_apply_batched_plain if hash_
                 else cf.srht_apply_batched_plain)
        n, m = (shape[1], shape[0]) if rowwise else shape
        ms = event_ms(torch, lambda: fn(new_keys(np, ctx, B), A, s_dim,
                                        rowwise))
        dev_ms = profiled_device_ms(torch, lambda: fn(
            new_keys(np, ctx, B), A, s_dim, rowwise))
        plain_ms = event_ms(torch, lambda: plain(new_keys(np, ctx, B), A,
                                                 s_dim, rowwise))
        keys = new_keys(np, ctx, B)
        if hash_:
            hv = [ch.streams(k, n, s_dim, A.device) for k in keys]
            lane = torch.arange(B, device=A.device)[:, None]
            lin = (lane * s_dim + torch.stack([x[0] for x in hv])).reshape(-1)
            v = torch.stack([x[1] for x in hv])
            X = (A * v[:, None, :]).permute(1, 0, 2).reshape(m, B * n)
            library_ms = event_ms(torch, lambda: torch.zeros(
                m, B * s_dim, device=A.device).index_add_(1, lin, X))
            # a sign flip and an add per element of A
            b = bound(2.0 * B * m * n, peaks["fp32_flops"],
                      4.0 * B * (m * n + m * s_dim), peaks)
        else:
            st = [cf.streams(k, n, s_dim, device=A.device) for k in keys]
            D = torch.stack([x[0] for x in st])
            idx = torch.stack([x[1] for x in st])
            fs, ss = cf.scales(n, s_dim)
            library_ms = event_ms(torch, lambda: ss * torch.gather(
                fut.wht(fs * D[:, None, :] * A, axis=2), 2,
                idx[:, None, :].expand(B, m, s_dim)))
            # n·log2(n) adds per row at the fp32 add rate
            b = bound(float(B) * m * n * math.log2(n),
                      peaks["fp32_flops"] / 2,
                      4.0 * B * (m * n + m * s_dim), peaks)
        rows.append({"kernel": name, "use": f"serve {'cwt' if hash_ else 'srht'}",
                     "main_path": True, "shape": [B, *shape],
                     "s_dim": s_dim, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, **b})
        del A
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
# and truncation; rows not a multiple of a block's rows (2 rows a group
# at m = 3001; 32 groups of 8 threads at NB = 128)
FASTFOOD_BATCHED_CASES = [(8, 2048, 4096, 4096), (3, 37, 1000, 3000),
                          (2, 3001, 4096, 4096), (3, 37, 100, 300)]
# (kernel, B, rows, cols, density, s_dim[, variant]): the sparse buckets'
# capacity-8 shapes at rcv1's density; then s = 300 (randint's multiplier
# is not 0) and s = 7 (many nonzeros of a row or column share a bucket);
# then duplicate (row, column) entries inside a row, a row of more than
# 1024 nonzeros, an all-padding lane (:func:`sparse_lanes`), and
# columnwise outputs wider than the kernel's on-chip row of 1024 columns
# (2048 and 8192 padded columns); rowwise: outputs wider than its on-chip
# row (s = 2048, 8192), a row of more than 1024 nonzeros, an all-padding
# lane, and 2^21 columns (512 stream chunks) at s = 300
SPARSE_CASES = [
    ("sparse_rowwise", 8, 4096, RCV1_D, RCV1_DENSITY, 1024),
    ("sparse_columnwise", 8, RCV1_D, 512, RCV1_DENSITY, 1024),
    ("sparse_rowwise", 3, 300, 5000, 0.02, 300),
    ("sparse_columnwise", 3, 5000, 300, 0.02, 300),
    ("sparse_rowwise", 2, 64, 1000, 0.1, 7),
    ("sparse_columnwise", 2, 1000, 64, 0.1, 7),
    ("sparse_columnwise", 3, 3000, 700, 0.01, 7, "dup"),
    ("sparse_rowwise", 3, 700, 3000, 0.01, 7, "dup"),
    ("sparse_columnwise", 2, 3000, 1500, 0.002, 64, "long_row"),
    ("sparse_columnwise", 3, 5000, 300, 0.02, 300, "empty_lane"),
    ("sparse_columnwise", 2, 2000, 5000, 0.005, 1024),
    ("sparse_rowwise", 2, 500, 3000, 0.01, 2048),
    ("sparse_rowwise", 2, 300, 2000, 0.01, 8192),
    ("sparse_rowwise", 2, 300, 1500, 0.002, 64, "long_row"),
    ("sparse_rowwise", 3, 300, 5000, 0.02, 300, "empty_lane"),
    ("sparse_rowwise", 2, 64, 1 << 21, 2e-4, 300),
    # the sparse phase's sketch-and-solve: S·A of its 262,144 × 1,024 CSR
    ("sparse_columnwise", 1, 262144, 1024, 0.005, 4096),
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
    ("hash_rowwise", (70, 12305), 1500),
    # the sparse phase's sketch-and-solve: S·b, one column
    ("hash_columnwise", (262144, 1), 4096),
    # config 5's sketched regression: CWT of Z (60000 × 8192) and of Y
    # (60000 × 10, the class coding) to 4·8192
    ("hash_columnwise", (60000, 8192), 32768),
    ("hash_columnwise", (60000, 10), 32768)]
# dyadic at n = 4096, s = 256 and at n = 65536 (the folded segments);
# Gaussian at 8192 → 1024 and 65536 → 2048
FWHT_CASES = [
    ("fwht_columnwise", (4096, 64), 256, True),
    ("fwht_rowwise", (64, 4096), 256, True),
    ("fwht_columnwise", (8192, 300), 1024, False),
    ("fwht_rowwise", (8192, 8192), 1024, False),
    ("fwht_columnwise", (65536, 513), 2048, False),
    ("fwht_rowwise", (64, 65536), 2048, False),
    ("fwht_columnwise", (65536, 24), 2048, True),
    ("fwht_rowwise", (16, 65536), 2048, True)]
# cohorts of the batched entry points: (rowwise, B, one lane's shape, s,
# variant, dyadic). The serve buckets' capacity-4 shape (timed); ragged
# lanes zero-padded on the free axis; an all-padding lane; s = 300 (a
# nonzero randint multiplier), s = 7 (many equal buckets in a row), ragged
# n; for B5 every segment plan: whole rows at n = 128 (32 rows a block)
# and 8192, folded segments in runs (n = 65536 both ways), dyadic ones
# bit-equal
HASH_BATCHED_CASES = [
    (True, 4, (512, 8192), 1024, None, False),
    (True, 3, (300, 5000), 300, "ragged", False),
    (True, 8, (64, 4096), 7, "empty_lane", False),
    (True, 1, (70, 12305), 1500, None, False),
    (False, 3, (5000, 37), 300, "ragged", False),
    (False, 8, (12305, 70), 2048, "empty_lane", False),
    (False, 1, (65536, 513), 2048, None, False)]
FWHT_BATCHED_CASES = [
    (True, 4, (512, 8192), 1024, None, False),
    (True, 3, (64, 4096), 256, "ragged", True),
    (True, 8, (37, 128), 64, "empty_lane", False),
    (True, 3, (37, 65536), 2048, "ragged", True),
    (False, 3, (4096, 64), 256, "empty_lane", True),
    (False, 8, (8192, 37), 1024, "ragged", False),
    (False, 2, (65536, 20), 2048, None, True),
    (False, 1, (128, 9), 16, None, False)]

COS_CASES = [(RFT_SHAPE, RFT_S), ((37, 700), 48), ((1000, 3000), 300),
             # config 5 (the ml phase): d = 784 is no multiple of B1's
             # block columns; the ADMM blocks, the BCD's first three
             # blocks (a last column tile with 127 of 128 columns live)
             # and its last (3 live), and the whole map
             ((60000, 784), 2048), ((60000, 784), 2047),
             ((60000, 784), 2051), ((60000, 784), 8192),
             # its other row counts: faster_kernel_rlsc's preconditioner
             # map and the held-out rows' predictions
             ((16384, 784), 2048), ((10000, 784), 2048)]
# B1-cos's timed shapes: config 3's, then config 5's at d = 784 (the
# ADMM blocks and approximate_kernel_rlsc's whole map)
COS_TIME_SHAPES = [(RFT_SHAPE, RFT_S, "GaussianRFT.apply rowwise"),
                   ((60000, 784), 2048, "config 5: an ADMM block"),
                   ((60000, 784), 8192, "config 5: approximate_kernel_rlsc")]


# (m, d, S): config 3; NB = 1024 with 3 blocks, padding and truncation;
# odd log2 NB; few rows; the largest NB (16384: 1024 threads a row); the
# smallest (2, three blocks, 256 rows a block)
FASTFOOD_CASES = [(*RFT_SHAPE, RFT_S), (512, 1000, 3000), (512, 2048, 2048),
                  (37, 4096, 4096), (64, 16384, 16384), (37, 2, 5),
                  # config 5: d = 784 padded to NB = 1024, 8 blocks; the
                  # training rows and the held-out rows
                  (60000, 784, 8192), (10000, 784, 8192)]

# Config 2 at full width (BASELINE.md:32, LIBSVM rcv1.binary's training
# set): 20,242 documents × 47,236 features at 0.16% density; the values
# are dyadic, so the libsvm text round trip is exact. The least-squares
# operand is a tall hashed-feature design matrix.
RCV1_N = 20242
DYADIC = (0.25, 0.5, 1.0)
SPARSE_LS = (262144, 1024, 0.005)
# The SVD operand weights document i by 1 + 30·0.97^i: the unweighted
# operand's spectrum is flat past its first value (its bulk edge holds
# σ2 … σ129 within a few percent), where no q = 2 sketch meets the SVD
# limit (tests/test_torch_sparse_nla.py shows both cases).
SVD_WEIGHT = (30.0, 0.97)
SPARSE_SKETCHES = (("JLT", 1024, {}), ("CT", 1024, {}),
                   ("GaussianRFT", 4096, {"sigma": 8.0}),
                   ("LaplacianRFT", 4096, {"sigma": 100.0}),
                   ("UST", 1024, {}), ("CWT", 1024, {}))


def sparse_products() -> dict:
    from libskylark_tpu_torch.base import sparse as bs

    return {**bs.products, **bs.conversions}


def feature_limit(torch, T, Xabs, W):
    """Entry by entry limit of a random-feature map against another
    projection order: the phase's elementwise limit TOL·(|X|·|W|ᵀ), W the
    scaled frequency matrix (``w_panel``), times cos's Lipschitz factor
    outscale (per-feature scales 1)."""
    return T.outscale * TOL * (Xabs @ W.abs().double().T)


def spmm_bound(peaks, nnz, b_rows, k, out_rows) -> dict:
    """spmm's bytes bound on the CSR route it times: each nonzero's value
    and column (8 bytes), the row pointers (the CSR's rows are the
    output's), the dense operand read once and the output written once.
    ``bound_ms_nnz12`` counts 12 bytes a nonzero (value, column, row)
    instead, the COO form's count."""
    dense = 4.0 * k * (b_rows + out_rows)
    out = bound(0.0, 1.0, 8.0 * nnz + 4.0 * (out_rows + 1) + dense, peaks)
    out["bound_ms_nnz12"] = bound(0.0, 1.0, 12.0 * nnz + dense,
                                  peaks)["bound_ms"]
    return out


def sketch_equal(torch, T, A, dimension) -> dict:
    """T.apply(A) on the card against the same apply on the CPU, where
    the CountSketch wrappers run their plain versions (which add in the
    reference's order): torch.equal."""
    got = T.apply(A, dimension).cpu()
    want = T.apply(A.cpu() if isinstance(A, torch.Tensor) else A, dimension,
                   device="cpu")
    return {"shape": list(want.shape), "bit_equal": bool(torch.equal(
        got, want)), "max_abs_err": float((got - want).abs().max())}


def sparse_phase(torch, P, np, peaks) -> dict:
    """Phase 4c: config 2 end to end on the card through the public entry
    points, with every launch counter, the product routes and the
    densification count set to 0 before and read after, and the card's
    memory high-water mark reset before, so that the phase reports its own
    peak."""
    import tempfile

    from libskylark_tpu_torch import algorithms, io, nla, sketch as sk
    from libskylark_tpu_torch.base import sparse as bs, sprand
    from libskylark_tpu_torch.base.sparse import SparseMatrix, spmm, spmm_t
    from libskylark_tpu_torch.io import native
    from libskylark_tpu_torch.sketch import sparse_serve

    for c in counters() + [bs.products, bs.conversions, native.runs]:
        for k in c:
            c[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"launches_by_step": {}, "products_by_step": {}}

    def step(name, fn):
        before, prod = launch_counts(), sparse_products()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
        out["launches_by_step"][name] = {
            k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}
        out["products_by_step"][name] = {
            k: v - prod[k] for k, v in sparse_products().items()
            if v != prod[k]}
        return result

    # 1. the operand, written as libsvm text and read back natively
    A0 = sprand.sample(RCV1_N, RCV1_D, RCV1_DENSITY, DYADIC, (1, 1, 1),
                       P.Context(70))
    labels = np.where(np.arange(RCV1_N) % 3 == 0, 1.0, -1.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/rcv1.svm"
        io.write_libsvm(path, A0, labels)
        A, y = step("read_libsvm", lambda: io.read_libsvm(
            path, sparse=True, min_d=RCV1_D))
        G = sprand.sample(3000, 3000, 0.002, DYADIC, (1, 1, 1),
                          P.Context(71))
        io.write_arc_list(f"{tmp}/graph.arcs", G)
        G2 = io.read_arc_list(f"{tmp}/graph.arcs")
    out["rcv1_nnz"], out["native_runs"] = A.nnz, dict(native.runs)
    for name, (X, Y) in (("libsvm", (A0, A)), ("arc_list", (G, G2))):
        check(X.shape == Y.shape and all(
            torch.equal(torch.tensor(a), torch.tensor(b))
            for a, b in zip(X.csr_parts(), Y.csr_parts())),
            f"{name} round trip changed the CSR")
    check(bool(np.array_equal(y, labels)), "libsvm labels changed")
    check(native.runs == {"native": 2, "python": 0},
          f"the native parser did not read: {native.runs}")
    del A0, G, G2

    # 2. every transform with a sparse apply, rowwise on the CSR, against
    # its dense apply of the densified operand
    Ad = A.todense()
    Aabs = Ad.double().abs()
    sketches = {}
    for i, (name, s, kw) in enumerate(SPARSE_SKETCHES):
        T = getattr(sk, name)(RCV1_D, s, P.Context(72 + i), **kw)
        Z = step(f"{name.lower()}_sparse", lambda: T.apply(A, sk.ROWWISE))
        want = T.apply(Ad, sk.ROWWISE)
        check(tuple(Z.shape) == (RCV1_N, s)
              and bool(torch.isfinite(Z).all()), f"{name} sparse output")
        if name in ("UST", "CWT"):
            ok = bool(torch.equal(Z, want))
            r = {"max_abs_err": float((Z - want).abs().max()), "ok": ok}
            if name == "CWT":
                r["cpu_equal"] = bool(torch.equal(
                    Z.cpu(), T.apply(A, sk.ROWWISE, device="cpu")))
                r["ok"] = ok and r["cpu_equal"]
        elif name == "CT":
            r = held(torch, Z, want, elementwise_limit(
                torch, T.allocation.key, T.dist, Ad, s, T.scale, True))
        elif name == "LaplacianRFT":
            W = T.w_panel(0, RCV1_D, torch.float32, Ad.device)
            r = held(torch, Z, want, feature_limit(torch, T, Aabs, W))
            del W
        else:
            r = held(torch, Z, want)
        sketches[name] = r
        check(r["ok"], f"{name} sparse apply vs its dense apply: {r}")
        del Z, want
    out["sketches"] = sketches
    del Ad, Aabs

    # 3. randomized SVD of the weighted operand, never densified
    c, q = SVD_WEIGHT
    import scipy.sparse as sp

    W = SparseMatrix.from_scipy(sp.diags(1.0 + c * q ** np.arange(RCV1_N))
                                @ A.to_scipy())
    Wd = W.todense(dtype=np.float64)
    w2 = torch.linalg.eigvalsh(Wd @ Wd.T).flip(0).clamp_min(0)
    sigma = w2.sqrt()
    k = 64
    bs.conversions["todense"] = 0
    U, S, V = step("svd_sparse", lambda: nla.approximate_svd(
        W, k, P.Context(80), nla.ApproximateSVDParams(num_iterations=2)))
    out["svd_todense"] = bs.conversions["todense"]
    check(out["svd_todense"] == 0, "the sparse SVD densified its operand")
    check(tuple(U.shape) == (RCV1_N, k) and tuple(V.shape) == (RCV1_D, k),
          "sparse SVD output shapes")
    out["svd_sigma_rel_err"] = float(
        ((S.double() - sigma[:k]).abs() / sigma[:k]).max())
    recon = float(torch.linalg.norm(Wd - (U.double() * S.double())
                                    @ V.double().T) / torch.linalg.norm(sigma))
    tail = float(torch.linalg.norm(sigma[k:]) / torch.linalg.norm(sigma))
    out["svd_recon_rel"], out["svd_recon_optimal"] = recon, tail
    check(out["svd_sigma_rel_err"] <= 1e-3, "sparse SVD sigma rel err > 1e-3")
    check(recon <= 1.01 * tail + 1e-4, "sparse SVD reconstruction")
    del Wd, U, V
    # spmm and spmm_t at the SVD's shape: the power iteration's products
    # with the tall transposed operand (47236 × 20242), k' = 128 columns
    Wt = W.transpose()
    Q = torch.randn(RCV1_N, 2 * k, device="cuda")
    Q2 = torch.randn(RCV1_D, 2 * k, device="cuda")
    timings = [
        {"product": "spmm", "use": "SVD power iteration Aᵀ-tall · Q",
         "shape": list(Wt.shape), "nnz": Wt.nnz, "k": 2 * k,
         "ms": event_ms(torch, lambda: spmm(Wt, Q)),
         **spmm_bound(peaks, Wt.nnz, RCV1_N, 2 * k, RCV1_D)},
        {"product": "spmm_t", "use": "SVD power iteration (Aᵀ-tall)ᵀ · Q",
         "shape": list(Wt.shape), "nnz": Wt.nnz, "k": 2 * k,
         "ms": event_ms(torch, lambda: spmm_t(Wt, Q2)),
         **spmm_bound(peaks, Wt.nnz, RCV1_D, 2 * k, RCV1_N)}]
    del W, Wt, Q, Q2, A

    # 4. a tall sparse least-squares problem
    m, n, dens = SPARSE_LS
    L = sprand.sample(m, n, dens, DYADIC, (1, 1, 1), P.Context(81))
    g = torch.Generator(device="cuda").manual_seed(82)
    x0 = torch.randn(n, generator=g, device="cuda")
    b = spmm(L, x0) + 0.1 * torch.randn(m, generator=g, device="cuda")
    Ld = L.todense(dtype=np.float64)
    xe = torch.linalg.lstsq(Ld, b.double()[:, None]).solution[:, 0]
    best = float(torch.linalg.norm(Ld @ xe - b.double()))
    sv_exact = torch.linalg.svdvals(torch.linalg.qr(Ld, mode="r").R)
    out["ls_nnz"], out["ls_residual_lstsq"] = L.nnz, best
    del Ld, xe

    def resid(x):
        return float(torch.linalg.norm(spmm(L, x) - b)) / best

    x = step("ls_sparse", lambda: nla.approximate_least_squares(
        L, b, P.Context(83)))
    out["ls_sparse_residual_ratio"] = resid(x)
    check(out["ls_sparse_residual_ratio"] <= 1.5,
          f"sparse sketch-and-solve ratio {out['ls_sparse_residual_ratio']}")
    check({"sparse_columnwise", "hash_columnwise"}
          <= set(out["launches_by_step"]["ls_sparse"]),
          "sparse sketch-and-solve did not take B3-cw and B2-cw")
    # its two sketches on the same key, outside the path's steps: SA (B3-cw
    # on L) and SB (B2-cw on b as one column), each held to its plain
    # version at the path's shapes
    T = sk.CWT(m, 4 * n, P.Context(83))
    out["ls_sketches"] = {
        "SA": sketch_equal(torch, T, L, sk.COLUMNWISE),
        "SB": sketch_equal(torch, T, b[:, None], sk.COLUMNWISE)}
    check(all(r["bit_equal"] for r in out["ls_sketches"].values()),
          f"sketch-and-solve's CountSketches differ from their plain "
          f"versions: {out['ls_sketches']}")
    iter_lim = max(20, 2 * n)
    for meth in ("blendenpik", "lsrn"):
        x, it = step(f"{meth}_sparse", lambda: algorithms.solve_l2_accelerated(
            L, b, P.Context(84), method=meth))
        out[f"{meth}_sparse_residual_ratio"] = resid(x)
        out[f"{meth}_sparse_iterations"] = it
        check(0 < it < iter_lim, f"sparse {meth} iterations {it}")
        check(out[f"{meth}_sparse_residual_ratio"] <= 1 + 1e-3,
              f"sparse {meth} ratio {out[f'{meth}_sparse_residual_ratio']}")

    # sparse_solve_serve at one request against the transform's own
    # sketch-and-solve on the same key (JLT at s = 2n: one whole panel)
    data, indices, indptr = (t.clone() for t in L.csr())
    for name, s in (("CWT", 4 * n), ("JLT", 2 * n)):
        T = getattr(sk, name)(m, s, P.Context(85))
        scale = getattr(T, "scale", 1.0)
        xs = step(f"serve_{name.lower()}_solve", lambda: (
            sparse_serve.sparse_solve_serve(
                T.allocation.key, scale, data, indices, indptr, b[:, None],
                sketch_type=name, s_dim=s, method="qr", shape=(m, n))))
        xo = algorithms.solve_l2_sketched(L, b, T)
        r = held(torch, xs[:, 0], xo)
        out[f"serve_{name.lower()}_solve"] = r
        check(r["ok"], f"sparse_solve_serve {name} vs solve_l2_sketched: {r}")
    check("sparse_columnwise" in out["launches_by_step"]["serve_cwt_solve"]
          and "hash_columnwise" in out["launches_by_step"]["serve_cwt_solve"],
          "sparse_solve_serve CWT did not take B3-cw and B2-cw")

    # condest on the host in float64, and its device twin on a block
    cond, smax, smin = step("condest_sparse", lambda: nla.estimate_condition(
        L, P.Context(86)))
    out["condest"] = {"cond": cond, "sigma_max": smax, "sigma_min": smin,
                      "exact_max": float(sv_exact[0]),
                      "exact_min": float(sv_exact[-1])}
    for got, want in ((smax, sv_exact[0]), (smin, sv_exact[-1])):
        check(abs(got - float(want)) <= 1e-3 * float(want),
              f"condest vs exact: {out['condest']}")
    block = torch.randn(512, 64, generator=g, device="cuda").cpu().numpy()
    ref = nla.estimate_condition(block, P.Context(87))
    twin = step("condest_serve", lambda: nla.condest_serve(block, steps=8,
                                                            seed=1))
    cpu_twin = nla.condest_serve(block, steps=8, seed=1, device="cpu")
    out["condest_serve"] = {"card": twin, "cpu": cpu_twin, "condest": ref}
    check(abs(twin[1] - ref[1]) <= 0.2 * ref[1]
          and 1.0 <= twin[0] <= 3.0 * ref[0],
          f"condest_serve vs condest: {out['condest_serve']}")
    check(all(abs(a - c_) <= TOL * abs(c_) for a, c_ in zip(twin, cpu_twin)),
          f"condest_serve card vs CPU: {out['condest_serve']}")

    # spmm and spmm_t at LSQR's shape: one matrix-vector product each way
    xv, bv = torch.randn(n, 1, device="cuda"), b[:, None].contiguous()
    timings += [
        {"product": "spmm", "use": "LSQR A·v", "shape": [m, n],
         "nnz": L.nnz, "k": 1, "ms": event_ms(torch, lambda: spmm(L, xv)),
         **spmm_bound(peaks, L.nnz, n, 1, m)},
        {"product": "spmm_t", "use": "LSQR Aᵀ·u", "shape": [m, n],
         "nnz": L.nnz, "k": 1, "ms": event_ms(torch, lambda: spmm_t(L, bv)),
         **spmm_bound(peaks, L.nnz, m, 1, n)}]
    for t in timings:
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["bound_share_nnz12"] = t["bound_ms_nnz12"] / t["ms"]
    out["spmm_times"] = timings
    out["seconds"] = time.perf_counter() - t_phase
    # the path's launches and products: its steps', not the comparisons'
    out["launches"] = {k_: sum(s.get(k_, 0) for s in
                               out["launches_by_step"].values())
                       for k_ in launch_counts()}
    out["products"] = {k_: sum(s.get(k_, 0) for s in
                               out["products_by_step"].values())
                       for k_ in sparse_products()}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit("sparse", **out)
    for k_ in SPARSE_KERNELS:
        check(out["launches"][k_] > 0,
              f"kernel {k_} never launched on the sparse path")
    check(out["products"]["plain_calls"] == 0
          and out["products"]["csr_calls"] > 0,
          f"a product left the CSR route: {out['products']}")
    return out


# the kernels the sparse phase must launch: B3 both ways, B2 columnwise
SPARSE_KERNELS = ("sparse_rowwise", "sparse_columnwise", "hash_columnwise")


# BASELINE config 5 (BASELINE.md:35, "KRR + BlockADMM RLSC";
# benchmarks/run_all.py bench_admm) at the shape of the reference's
# skylark_ml demo data, MNIST: 60,000 training and 10,000 held-out rows,
# d = 784, 10 classes. MNIST is not in the repo; the rows are generated
# from a seed with MNIST's trait that matters to the solvers, a low
# intrinsic dimension: a latent z = center_c + N(0, I_16) of class c,
# mixed into 784 pixels by a fixed Gaussian matrix, plus unit pixel
# noise. The Gaussian kernel with σ = √(16·784) separates the classes,
# and its Gram matrix has the decaying spectrum that faster_kernel_rlsc's
# random-features preconditioner is for.
ML_FULL = {"n": 60000, "test": 10000, "d": 784, "classes": 10,
           "latent": 16, "center": 1.0, "noise": 1.0,
           "s": 8192, "partitions": 4,
           # the reference's split schedule gives the last block the
           # remainder: max_split 4095 makes blocks of 2047, 2047, 2047 and
           # 2051 (4096 would make 2048, 2048 and 4096)
           "max_split": 4095,
           "faster_rows": 16384, "faster_s": 2048, "admm_iters": 10}
ML_LAM = 1.0        # RLSC's λ
ADMM_LAM = 0.01     # bench_admm's
# limits of the ml phase, each with its reason
ML_LIMITS = {
    # W solves (ZᵀZ + λI)W = ZᵀY in float32 (Cholesky, TF32 off); Z made
    # again by the plain route (float64 check): 1e-3 of ‖ZᵀY‖_F leaves
    # room for κ(ZᵀZ + λI)·ε32 at the planted spectrum (4.1e-7 on an H100)
    "normal_equations": 1e-3,
    # the BCD stops on the relative update (the reference's default
    # tolerance 1e-3), not on the residual (2.4e-4 after 141 sweeps on an
    # H100); the reference's own test holds its residual to 1e-2
    "bcd_normal_equations": 1e-2,
    # faster_kernel_rlsc (PCG, tolerance 1e-6) against kernel_rlsc's
    # Cholesky: the reference's tests/test_ml_krr.py:59
    "cg_rtol": 1e-2, "cg_atol": 1e-3,
    # ADMM on the kernel route against the plain route on the same maps:
    # the features differ by ≤ 1e-4·max|plain| (the check phase), which
    # ten iterations carry into the coefficients
    "admm_coef": 1e-3, "admm_objective": 1e-4,
}
ML_BCD_TOLERANCE = 1e-3
ML_CG_TOLERANCE = 1e-6


def ml_data(torch, size, device):
    """(X, y, X_test, y_test) of the ml phase on ``device``, from seed 600:
    float32 rows, int64 labels."""
    g = torch.Generator(device=device).manual_seed(600)
    n, m, d, c, r = (size[k] for k in ("n", "test", "d", "classes",
                                       "latent"))
    mix = torch.randn(r, d, generator=g, device=device)
    centers = size["center"] * torch.randn(c, r, generator=g, device=device)
    labels = torch.randint(0, c, (n + m,), generator=g, device=device)
    z = centers[labels] + torch.randn(n + m, r, generator=g, device=device)
    X = z @ mix + size["noise"] * torch.randn(n + m, d, generator=g,
                                               device=device)
    return X[:n].contiguous(), labels[:n], X[n:].contiguous(), labels[n:]


def ml_kernel(ml, size):
    return ml.Gaussian(size["d"], math.sqrt(size["latent"] * size["d"]))


def plain_features(torch, T, X):
    """T's rowwise features on the plain route on X's device: B1-cos's
    plain version on the same key for a GaussianRFT, the torch chain for a
    FastGaussianRFT."""
    from libskylark_tpu_torch.sketch import cuda_dense, cuda_fastfood

    if hasattr(T, "_NB"):
        return cuda_fastfood.fastfood_plain(T, X)
    return cuda_dense.rft_apply_plain(
        T.subkey(0), T.dist, X, T.sketch_dim, T.inscale, T.outscale,
        T.row_scales(torch.float32, X.device),
        T.shifts(torch.float32, X.device))


class PlainMap:
    """A feature map whose rowwise apply takes the plain route: the ADMM
    comparison trains on the same maps with no kernel."""

    def __init__(self, torch, T):
        self._torch, self.T = torch, T
        self.sketch_dim, self.input_dim = T.sketch_dim, T.input_dim

    def apply(self, X, dimension=None, device=None):
        return plain_features(self._torch, self.T, X)


def normal_residual(torch, Z, W, Y, lam) -> float:
    """‖(ZᵀZ + λI)W − ZᵀY‖_F / ‖ZᵀY‖_F in float64."""
    Z, W, Y = Z.double(), W.double(), Y.double()
    ZtY = Z.T @ Y
    r = Z.T @ (Z @ W) + lam * W - ZtY
    return float(torch.linalg.norm(r) / torch.linalg.norm(ZtY))


def held_limit(value, limit) -> dict:
    return {"value": value, "limit": limit, "ok": value <= limit}


def ml_iterations(log_text):
    """The iteration count a KRR/RLSC solver logs at level 2: the BCD's
    sweeps ("large_scale_krr: N sweeps, ...") or PCG's iterations
    ("faster_krr: N CG iterations"); None where the log has neither."""
    import re

    found = re.search(r"(?:large_scale_krr: (\d+) sweeps|"
                      r"faster_krr: (\d+) CG iterations)", log_text)
    return None if found is None else int(found.group(1) or found.group(2))


def ml_launch_checks(out) -> None:
    """Every feature apply and sketch of the ml path took its kernel:
    each step's launches are exactly the expected ones (a plain route on
    a CUDA tensor would launch nothing)."""
    P4 = out["size"]["partitions"]
    want = {
        "rlsc_approximate": {"dense_rowwise_cos": 1},
        "rlsc_sketched_cwt": {"dense_rowwise_cos": 1, "hash_columnwise": 2},
        "rlsc_sketched_fjlt": {"dense_rowwise_cos": 1},
        "rlsc_fast": {"fastfood": 1},
        "rlsc_large_scale": {"dense_rowwise_cos": 4 * out["bcd_sweeps"]},
        "rlsc_kernel": {},
        "rlsc_faster": {"dense_rowwise_cos": 1},
        "rlsc_faster_s0": {},
        "admm_train": {"dense_rowwise_cos":
                       P4 * (1 + out["size"]["admm_iters"])},
        "admm_predict": {"dense_rowwise_cos": P4},
        "model_load_predict": {"dense_rowwise_cos": P4},
    }
    check(out["launches_by_step"] == want,
          f"ml path launches {out['launches_by_step']}, expected {want}")
    for k_ in ML_KERNELS:
        check(out["launches"][k_] > 0,
              f"kernel {k_} never launched on the ml path")


# the kernels the ml phase must launch
ML_KERNELS = ("dense_rowwise_cos", "fastfood", "hash_columnwise")


def ml_phase(torch, P, np, size=ML_FULL, device="cuda") -> dict:
    """Phase 4d: config 5 on one card through the public entry points, at
    MNIST's shape, with every launch counter set to 0 before and read
    after each step (comparisons run outside the steps)."""
    import contextlib
    import io as stdio
    import tempfile

    from libskylark_tpu_torch import ml, sketch as sk
    from libskylark_tpu_torch.algorithms import prox
    from libskylark_tpu_torch.sketch import cuda_hash

    for c in counters():
        for k in c:
            c[k] = 0
    if device == "cuda":  # the phase's own peak, not the process's
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"size": dict(size), "launches_by_step": {}, "step_seconds": {},
           "checks": {}, "accuracy": {}, "cg_iterations": {}}
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else (
        lambda: None)

    def step(name, fn):
        before = launch_counts()
        t0 = time.perf_counter()
        result = fn()
        sync()
        out["step_seconds"][name] = time.perf_counter() - t0
        out["launches_by_step"][name] = {
            k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}
        return result

    n, s = size["n"], size["s"]
    X, y, Xte, yte = ml_data(torch, size, device)
    k = ml_kernel(ml, size)
    Y = ml.dummy_coding(y, device=device)[0]
    lim = ML_LIMITS

    def accuracy(name, scores, coding):
        out["accuracy"][name] = ml.classification_accuracy(
            ml.dummy_decode(scores, coding), yte)

    # 1. random-features RLSC, s features, and its sketched regressions
    S, W, coding = step("rlsc_approximate", lambda: ml.approximate_kernel_rlsc(
        k, X, y, ML_LAM, s, P.Context(601), device=device))
    Zp = plain_features(torch, S, X)
    out["checks"]["rlsc_approximate"] = held_limit(
        normal_residual(torch, Zp, W, Y, ML_LAM), lim["normal_equations"])
    accuracy("rlsc_approximate",
             S.apply(Xte, sk.ROWWISE, device=device) @ W, coding)
    for name, seed, fast in (("rlsc_sketched_cwt", 602, True),
                             ("rlsc_sketched_fjlt", 603, False)):
        params = ml.RlscParams(sketched_rls=True, fast_sketch=fast)
        S2, W2, _ = step(name, lambda: ml.approximate_kernel_rlsc(
            k, X, y, ML_LAM, s, P.Context(seed), params, device=device))
        # the sketch the solver drew: the allocation after its map's
        ctx = P.Context(seed)
        check(k.create_rft(s, ctx).to_dict() == S2.to_dict(),
              f"{name}: the feature map is not the context's first")
        R = sk.CWT(n, 4 * s, ctx) if fast else sk.FJLT(n, 4 * s, ctx)
        Zp2 = plain_features(torch, S2, X)
        if fast:  # B2's plain scatter on the card (unordered, allclose)
            key = R.allocation.key
            SZ = cuda_hash.cwt_apply_plain(key, Zp2, 4 * s, False)
            SY = cuda_hash.cwt_apply_plain(key, Y, 4 * s, False)
        else:  # the FJLT (DCT mixer) has no kernel
            SZ = R.apply(Zp2, sk.COLUMNWISE, device=device)
            SY = R.apply(Y, sk.COLUMNWISE, device=device)
        del Zp2
        out["checks"][name] = held_limit(
            normal_residual(torch, SZ, W2, SY, ML_LAM),
            lim["normal_equations"])
        del SZ, SY
    # 2. the same with Fastfood features (B4 at d = 784: NB = 1024)
    S4, W4, coding4 = step("rlsc_fast", lambda: ml.approximate_kernel_rlsc(
        k, X, y, ML_LAM, s, P.Context(604), ml.RlscParams(use_fast=True),
        device=device))
    del Zp
    Zp = plain_features(torch, S4, X)
    out["checks"]["rlsc_fast"] = held_limit(
        normal_residual(torch, Zp, W4, Y, ML_LAM), lim["normal_equations"])
    accuracy("rlsc_fast", S4.apply(Xte, sk.ROWWISE, device=device) @ W4,
             coding4)
    del Zp
    # 3. block coordinate descent over 4 blocks
    log = stdio.StringIO()
    params = ml.RlscParams(max_split=size["max_split"],
                           tolerance=ML_BCD_TOLERANCE, am_i_printing=True,
                           log_level=3, log_stream=log)
    maps, W5, coding5 = step("rlsc_large_scale",
                             lambda: ml.large_scale_kernel_rlsc(
                                 k, X, y, ML_LAM, s, P.Context(605), params,
                                 device=device))
    out["bcd_blocks"] = [T.sketch_dim for T in maps]
    out["bcd_sweeps"] = ml_iterations(log.getvalue())
    check(len(maps) == 4 and out["bcd_sweeps"] < params.iter_lim,
          f"BCD: blocks {out['bcd_blocks']}, sweeps {out['bcd_sweeps']}")
    Zp = torch.cat([plain_features(torch, T, X) for T in maps], 1)
    out["checks"]["rlsc_large_scale"] = held_limit(
        normal_residual(torch, Zp, W5, Y, ML_LAM),
        lim["bcd_normal_equations"])
    del Zp
    accuracy("rlsc_large_scale", torch.cat(
        [T.apply(Xte, sk.ROWWISE, device=device) for T in maps], 1) @ W5,
        coding5)
    # 4. exact Gram on the first rows: Cholesky, and PCG with and without
    # the random-features preconditioner
    rows = size["faster_rows"]
    Xf, yf = X[:rows], y[:rows]
    A, codingf = step("rlsc_kernel", lambda: ml.kernel_rlsc(
        k, Xf, yf, ML_LAM, device=device))
    for name, sf, seed in (("rlsc_faster", size["faster_s"], 606),
                           ("rlsc_faster_s0", 0, 607)):
        log = stdio.StringIO()
        params = ml.RlscParams(tolerance=ML_CG_TOLERANCE, am_i_printing=True,
                               log_level=3, log_stream=log)
        Acg, _ = step(name, lambda: ml.faster_kernel_rlsc(
            k, Xf, yf, ML_LAM, sf, P.Context(seed), params, device=device))
        it = ml_iterations(log.getvalue())
        out["cg_iterations"][name] = it
        diff = (Acg - A).abs().double()
        excess = float((diff - lim["cg_rtol"] * A.abs().double()).max())
        out["checks"][name] = {
            "max_abs_err": float(diff.max()), "excess": excess,
            "limit": f"|Δ| <= {lim['cg_atol']} + {lim['cg_rtol']}·|A|",
            "iterations": it, "ok": excess <= lim["cg_atol"]
            and 0 < it < params.iter_lim}
    check(out["cg_iterations"]["rlsc_faster"]
          < out["cg_iterations"]["rlsc_faster_s0"],
          f"the preconditioner saved no CG iterations: "
          f"{out['cg_iterations']}")
    accuracy("rlsc_kernel", ml.krr_predict(k, Xte, Xf, A, device=device),
             codingf)
    # 5. Block-ADMM: bench_admm's settings on the kernel route, and on the
    # plain route with the same maps
    solver = ml.BlockADMMSolver.from_kernel(
        P.Context(608), prox.HingeLoss(), prox.L2Regularizer(), ADMM_LAM, s,
        k, num_partitions=size["partitions"])
    plain = ml.BlockADMMSolver.with_maps(
        prox.HingeLoss(), prox.L2Regularizer(),
        [PlainMap(torch, T) for T in solver.feature_maps], ADMM_LAM)
    objectives = {}
    models = {}
    for name, sv in (("admm_train", solver), ("admm_plain", plain)):
        sv.maxiter, sv.tol = size["admm_iters"], 0.0
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            models[name] = (step(name, lambda: sv.train(X, y, verbose=True,
                                                        device=device))
                            if name == "admm_train"
                            else sv.train(X, y, verbose=True, device=device))
        objectives[name] = [float(ln.split()[3])
                            for ln in buf.getvalue().splitlines()]
    model, pmodel = models["admm_train"], models["admm_plain"]
    coef_err = float((model.coef - pmodel.coef).abs().max()
                     / pmodel.coef.abs().max())
    obj_err = max(abs(a - b) / abs(b) for a, b in
                  zip(objectives["admm_train"], objectives["admm_plain"]))
    check(len(objectives["admm_train"]) == size["admm_iters"],
          f"ADMM printed {len(objectives['admm_train'])} objectives")
    out["admm_objectives"] = objectives["admm_train"]
    out["checks"]["admm_coef"] = held_limit(coef_err, lim["admm_coef"])
    out["checks"]["admm_objective"] = held_limit(obj_err,
                                                 lim["admm_objective"])
    labels, DV = step("admm_predict", lambda: model.predict(Xte))
    out["accuracy"]["admm"] = ml.classification_accuracy(labels, yte)
    out["accuracy"]["admm_plain"] = ml.classification_accuracy(
        pmodel.predict(Xte)[0], yte)
    # 6. the trained model saved, loaded and predicting the same bits
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model.json"
        model.save(path, header="chip_smoke ml phase")
        loaded = step("model_load_predict", lambda: ml.HilbertModel.load(
            path, device=device).predict(Xte))
    out["checks"]["model_round_trip"] = {
        "ok": bool(torch.equal(loaded[0], labels)
                   and torch.equal(loaded[1], DV))}
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = {k_: sum(st.get(k_, 0) for st in
                               out["launches_by_step"].values())
                       for k_ in launch_counts()}
    if device == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit("ml", **out)
    bad = {name: c for name, c in out["checks"].items() if not c["ok"]}
    check(not bad, f"ml phase checks failed: {bad}")
    chance = 100.0 / size["classes"]
    check(all(a > 5 * chance for a in out["accuracy"].values()),
          f"held-out accuracy near chance: {out['accuracy']}")
    ml_launch_checks(out)
    return out


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
    "hash_batched": (CSRC + "hash_sketch.cu",
                     "libskylark_tpu/sketch/pallas_hash.py:423"),
    "fwht_batched": (CSRC + "fwht_sketch.cu",
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
                                if "registers" in ln or "spill" in ln
                                or "entry function" in ln]}
                  for k, v in report.items()})

    import numpy as np

    checked = (check_kernels(torch, P, check_cases())
               + check_hash(torch, P, HASH_CASES)
               + check_fwht(torch, P, FWHT_CASES)
               + check_cos(torch, P, COS_CASES)
               + check_fastfood(torch, P, FASTFOOD_CASES)
               + check_batched(torch, P, np) + check_sparse(torch, P, np)
               + check_f32_exact(torch, P))
    main = main_path(torch, P)
    serve = serve_phase(torch, P, np)
    emit("serve_cells", cells=serve_cells(torch, np))
    sparse = sparse_phase(torch, P, np, peaks)
    ml_path = ml_phase(torch, P, np)
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
                            "(h[row], col), h and v gathered beforehand",
                  "hash_batched": "one index_add_ of v·A at lane·s + h over "
                                  "the lanes' columns, h and v made "
                                  "beforehand",
                  "fwht_batched": "the fwht chain over the cohort (kron "
                                  "two-torch.matmul WHT, TF32 off; a gather "
                                  "at idx), D and idx made beforehand"},
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
            "launches": (main["launches"][name] + serve["launches"][name]
                         + sparse["launches"][name]
                         + ml_path["launches"][name]),
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
