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
            launch; every flush of the five captured buckets (dense-rw,
            ct-cw, fastfood, cwt, srht) through the executable cache; then
            each captured bucket's flush, by its CompiledFn, torch.equal
            to the same flush run eagerly on the same stacked inputs: the
            first cohort captures, the second (other seeds, the same
            operands) replays, a hit launching the bucket's kernel once
            and giving another result; then each bucket's flush cell (warm
            ms, device ms, busy);
4b-iii. warmup — a warmup pack (engine/warmup.py) at the serve cells'
            widths: JLT 8192 → 1024 rowwise on 2045–2048 rows and CT
            columnwise on 125–128 columns, capacities 1 and 8; CWT 8192 →
            1024 rowwise on 509–512 rows, 1 and 4; FastGaussianRFT 4096 →
            4096 (σ = 64) on 2045–2048 rows, 1 and 8; every entry captured
            on the kernel route with its capture record; each entry's
            cold flush (warm-up and capture), replay and eager flush
            (median ms, device ms under torch.profiler, busy) and its
            graph's pool MB; then two fresh processes (``python -m
            libskylark_tpu_torch.cli.skylark_warmup boot-probe``) serve
            every packed cohort, cold (one capture per entry) and booted
            from the pack (every entry loaded and its route restored, then
            no capture and a hit per entry), both bit-equal to the
            builder's results, with their time to first result;
4b'. serve_solve — the nine solve-family endpoints at full width, the
            same storm (4 threads, max_batch 8, warm-up then measured with
            every launch counter and the torch panel counter set to 0):
            solve JLT and CWT (16 each, 49,153–65,536 × 512, b = A·x₀ +
            0.1·noise, s = 2048), sparse solve CWT (s = 4096) and JLT
            (s = 2048) on 4 sprand CSRs of 262,144 × 1,024 at 0.5%,
            compressed matmul by SRHT (8, 1,025–2,048 × 8,192 · 8,192 ×
            256, s = 1024) and by CWT of rcv1-shaped CSR rows (8,
            1,025–2,048 × 47,236 at 0.16%), lowrank (8, rows 4,097–8,192
            of config 4's SVD operand, JLT 8192 → 128 and → 512, k = 64),
            KRR and RLSC predict (16 each, 129–256 query rows, config 5's
            Gaussian model on 16,384 rows held on the host, coef from
            kernel_rlsc), condest (8, 8,193–16,384 × 512, 8 steps), ASE
            (k = 6, 2 iterations) and PPR (α = 0.85, 16 iterations) on a
            scale-16 R-MAT graph (8 each). Every served request
            torch.equal to its capacity-1 flush through the kernel route;
            the kernel-routed ones held to their capacity-1 plain flush
            (SOLVE_LIMITS: solves 1e-4·max|x|, lowrank projector 1e-4,
            cmm 1e-4·max and the bound 1e-6 relative); each solve's
            residual ≤ 1.5 × the exact float64 one; condest within the
            reference's bounds of the operand's singular values; the cmm
            estimate's Frobenius error reported beside its bound; exactly
            one batched launch per operand per flush (SOLVE_ROUTES) and no
            other launch, no torch operator panel, no declined bucket, the
            sketch-free endpoints on the library route, one model upload
            per KRR/RLSC bucket; each kernel-routed bucket's sketches at
            its flush shape against their plain versions (B2, B3
            torch.equal on CPU copies; B1, B5 1e-4·max); requests/s,
            p50/p99, flushes, padding waste, H2D bytes per flush and the
            phase's peak memory on its line;
4b''. serve_qos — the executor's production layer at full width, with
            the lock-order witness on (``check_witness`` raises nothing):
            64 identical serve-solve-jlt requests (65,536 × 512 host
            operands, s = 2048) from 8 threads through a cache-on
            executor make one flush of 2 B1-batched launches, the rest
            hits or coalesced followers, every result its own tensor
            ``torch.equal`` to a cache-off executor's (a caller's
            in-place write reaches no later hit), another seed misses;
            ``register_operand(A)`` uploads A once, 16 submits by
            OperandRef ship 0 bytes of A and equal their by-value twins,
            a sketch pinned with the registration is served with 0
            launches; 4 requests with a 10 ms deadline queued behind a
            long flush expire unlaunched; a fault plan on ``serve.flush``
            (no launch) degrades the executor, a health subscriber sees
            SERVING → DEGRADED, best_effort past its class bound is shed,
            interactive requests are served ``torch.equal`` to their
            capacity-1 flush with the cache bypassed, and the executor
            recovers; an interactive and a best_effort tenant queued on
            one worker on the serve-dense-rw bucket, every request of both
            queued while a held flush runs, then every interactive cohort
            started before any best_effort one (their mean queue waits
            reported), and a tenant of burst 4 refused exactly
            8 of 12; the adaptive controller ticks, keeps its targets in
            bounds and changes no result; one flush profiled, in a
            process of its own (the bucket's second flush, a graph
            replay), its ``serve.flush`` range enclosing the launches of
            its B1-batched kernels (their cudaGraphLaunch record); storm
            requests/s with the cache on and off, the H2D bytes residency
            saved, per-class waits and latencies, expired, shed and
            rate-limited counts, the transitions, the seconds and the
            peak memory on its line;
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
4e. a3   — the rest of the single-card ML and NLA, each step's launches
            required to be exactly its kernels': jax.random's Gamma
            sampler on the card against the CPU route (10⁵ samples at
            shapes 0.3–10: at most one flip in 10⁴, the rest within 1e-5
            relative); MaternRFT (B1-cos with Gamma-derived scales) and
            FastMaternRFT (B4 with the Matern Sm) at config 3's shape, ν ∈
            {0.5, 1.5, 2.5}, each held to Matern.gram on 512 rows;
            Block-ADMM on Matern(784, ν = 1.5) with the ml phase's
            settings against the same maps on their plain route; the
            five range finders, RangeAssistedSVD/EVD and randomized_svd
            on an 8192² operand with a spectral gap at rank 64;
            lobpcg_rand_evd (CWT, JLT, FJLT) and power_iterations_rand_evd
            on the 65536×512 least-squares operand against the same
            iterations from the kernel's plain sketch or in float64;
            approximate_ase (sparse and dense routes) on a scale-18 R-MAT
            graph against a float64 replay, find_local_cluster from three
            seeds, and the graph serve programs against float64 replays;
            rand_block_gauss_seidel and rand_block_fcg on a 16,384-row
            Gaussian Gram system against the same sweeps in float64;
4f. dist — A5's explicit half (about 30 s): B1's partial kernel for p ∈
            {1, 2, 4, 8} ranks and 5 with N padded, emulated in this
            process at config 4's S·[A | b] (65536 × 513 → 2048) and
            config 1's JLT (8192² → 1024 rowwise), Normal, Rademacher and
            Cauchy: each rank's launch at its own block0 against its plain
            version, the scaled partials summed in rank order against
            B1's one-shot apply and the plain partials' sum, p launches and
            s·n_loc generated entries a rank; then the main path with the
            counters set to 0: a one-rank NCCL group joined through
            multihost.initialize_distributed (the public shard_apply both
            ways against B1's one-shot apply, use_pallas=False refused,
            a 1 × 1 DistSparseMatrix's CWT and spmm against the
            SparseMatrix route), and two processes sharing the card
            through gloo (``chip_smoke.py --dist-child <rank> 2 <port>``:
            shard_apply both ways; config 2's CSR on (2, 1) and (1, 2)
            meshes through CWT, JLT and GaussianRFT both ways and
            spmm/spmm_t; the sparse SVD at rank 64, q = 2, of the weighted
            operand; condest's device route on the 262,144 × 1,024 CSR),
            each against the one-process route (1e-4·max, σ 1e-3), both
            ranks' results byte-equal; the phase's seconds and peak
            memory on its line;
4g. sharded — A5b, mesh-sharded dense operands (DTensors) through the
            public entry points (about 60 s): B2 with a shard's row offset
            n0 for p ∈ {1, 2, 4, 5} ranks of torch's split (ragged),
            emulated in this process at config 4's S·[A | b] (65536 ×
            513 → 2048) and config 1's CWT (8192² → 1024 rowwise), each
            rank's launch torch.equal to the plain scatter at its offset
            on a CPU copy, the ranks' sketches summed in rank order
            within 1e-4·max of the one-shot B2 (torch.equal at p = 1);
            then the main path with the counters set to 0: a one-rank
            NCCL group with a 1 × 1 mesh, where every entry point of the
            slice (those below, and MMT, WZT, LaplacianRFT, MaternRFT,
            ExpSemigroupRLT, power_iteration, CG, flexible CG,
            Chebyshev, exact and split-sketched KRR, RangeAssistedEVD,
            the dominant subspace) must be torch.equal to its
            one-process route (MMT and WZT, whose scatter is atomic on
            CUDA, within 1e-4·max) and issue no collective, and two
            processes sharing the card through gloo (``chip_smoke.py
            --sharded-child <rank> 2 <port>``) with the operands
            row-sharded: JLT, CT, CWT, GaussianRFT, UST and FJLT(wht)
            columnwise on config 4's [A | b], CWT sketch-and-solve and
            LSQR on its 65536 × 512 operand, cholesky_qr2 of that tall
            operand, approximate_svd (rank 64, q = 2) of the 8192² SVD
            operand, approximate_kernel_ridge at config 5 (60,000 × 784,
            σ = 112, s = 8192), BlockADMMSolver at the ml-admm cell's
            settings, krank's randomized_svd (rank 64) of its gap
            operand and lobpcg_rand_evd (CWT, k = 10) of the LS operand;
            each held to the one-process route with the one-process
            phases' limits (applies 1e-4·max, CT entry by entry, UST
            torch.equal; σ 1e-3; the LS residual ratios; KRR's normal
            equations 1e-3·‖ZᵀY‖_F; ADMM coef 1e-3·max and objectives
            1e-4; LOBPCG by C11's measures), both ranks' results
            byte-equal, each entry point's collectives (the port's own
            count and CommDebugMode's) its design's list (no gather of a
            tall operand), and each rank's launches of B1's partial, B1,
            B1-cos, B5 and B2 (at its offset on rank 1) exactly the
            path's; the phase's seconds and peak memory on its line;
4h. compiled — the executable cache (engine/compiled.py) at full width
            (about 40 s): approximate_svd (rank 64, q = 2) of config 4's
            8192² rank-512 operand and approximate_symmetric_svd (rank
            64) of its symmetric part, solve_l2_sketched with the JLT, the
            CWT, FJLT(fut="wht") and the UST on the LS cell's 65536×512
            operand (s = 2048), and with a JLT whose operator is pinned
            (materialize(), float64, no kernel's route) on its first
            16,384 rows, the Blendenpik and LSRN preconditioner builds on
            it, approximate_kernel_ridge at config 5 (60,000 × 784, σ =
            112, s = 8192, 10 classes) and with the polynomial kernel
            (PPT, s = 2048: its CountSketches are sub-transforms) on
            ml-rlsc-faster's 16,384 rows, kernel_ridge and krr_predict on
            those rows (10,000 held-out queries); for
            each, the CompiledFn against its eager body (the ``_pipeline``
            function or the closure, called directly): the first call
            (warm-up plus capture), a replay and a replay under a second
            seed (a new λ or new coefficients where there is no seed) each
            torch.equal to the eager body, the first result unchanged by
            the later calls, the entry point's Context counter equal to
            the eager route's, exactly one miss and one capture for the
            key and hits after it (the public entry point's call among
            them), the launches of one replay equal to the eager body's
            (B1-rw, B1-cw, B1-cos, B2-cw and B5-cw each inside a replay),
            and a hit under ``torch.cuda.set_sync_debug_mode("error")``;
            each entry's cold, replay and eager warm ms, device ms and
            busy, its replay's warm ms when every call brings a new
            operand (copied in), and its graph's pool bytes; then the
            cache's memory bound: 8 sketch-and-solve widths captured with
            no reset under a 1 GiB budget, what the graphs hold within it
            after every call, the least recent evicted, and the memory
            allocated grown by no more than the budget; the phase's
            seconds and peak memory on its line;
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
            cwt and srht buckets' capacity-4 shape); B1's partial at p =
            4's per-rank shapes; B2 at rank 1 of 2's offset (32768 × 513
            → 2048, n0 = 32768);
6. the ``{"kernels": [...]}`` line (``max_abs_err``: the worst of every
   check at the kernel's main-path shapes, all distributions and ragged
   variants; ``replay_launches``: the launches made inside graph replays,
   required for the five serve kernels of the captured flushes), the
   card's name and power limit, and
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


def release_cache(torch) -> None:
    """Hand the blocks this process's allocator caches back to the card,
    before child processes that share it allocate their own: the
    executable cache's graphs, their static buffers and pools first."""
    import gc

    from libskylark_tpu_torch import engine

    engine.reset()
    gc.collect()
    torch.cuda.empty_cache()


def make_operand(torch, shape, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def svd_operand(torch, n: int = 8192, r: int = 512, device="cuda"):
    """The SVD cell's 8192×8192 matrix (n × n) of rank 512 (r) with
    singular values 0.95^i and random singular vectors, built on the card;
    returns (A, sigma)."""
    g = torch.Generator(device=device).manual_seed(2)
    U0 = torch.linalg.qr(torch.randn(n, r, generator=g, device=device))[0]
    V0 = torch.linalg.qr(torch.randn(n, r, generator=g, device=device))[0]
    sigma = 0.95 ** torch.arange(r, device=device, dtype=torch.float32)
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
    outscale √(2/s). A case with a third entry ν takes a MaternRFT's
    inputs instead (l = √n): its Gamma-derived scales √(2ν/χ²(2ν)),
    heavy-tailed at small ν, multiply the phase, so it is held entry by
    entry within the phase's elementwise limit times cos's Lipschitz
    factor, outscale·sc_j·TOL·(|A|·|S|ᵀ)_ij."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    results = []
    for i, case in enumerate(cases):
        shape, s_dim = case[:2]
        nu = case[2] if len(case) > 2 else None
        key = P.Context(400 + i).allocate().key
        A = make_operand(torch, shape, 4000 + i)
        g = torch.Generator(device="cuda").manual_seed(4100 + i)
        sc = 0.5 + torch.rand(s_dim, generator=g, device="cuda")
        sh = 2 * math.pi * torch.rand(s_dim, generator=g, device="cuda")
        inscale, outscale = 1.0 / math.sqrt(shape[1]), math.sqrt(2.0 / s_dim)
        limit = None
        if nu is not None:
            T = sk.MaternRFT(shape[1], s_dim, P.Context(400 + i), nu=nu,
                             l=math.sqrt(shape[1]))
            key, inscale = T.subkey(0), T.inscale
            sc, sh = T.row_scales(device="cuda"), T.shifts(device="cuda")
            limit = outscale * sc.double()[None, :] * elementwise_limit(
                torch, key, randgen.Normal(), A, s_dim, inscale, True)
        args = (key, randgen.Normal(), A, s_dim, inscale, outscale, sc, sh)
        for p in REGIMES:
            got = cd.rft_rowwise_apply(*args, precision=p)
            want = cd.rft_apply_plain(*args, precision=p)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  "cos kernel output not finite")
            results.append({"kernel": "dense_rowwise_cos", "regime": p,
                            "shape": list(shape), "s_dim": s_dim,
                            **({"matern_nu": nu} if nu is not None else {}),
                            **held(torch, got, want, limit)})
            del got, want
        del A, limit
    emit("check", tolerance=f"B1-cos: max|kernel-plain| <= {TOL} * "
                            "max|plain|; Matern scales entry by entry, "
                            f"outscale·sc·{TOL}·(|A|·|S|ᵀ)", cases=results)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"cos kernel disagrees with its plain version: {bad}")
    return results


def fastfood_limit(torch, T, A):
    """The Fastfood phase's elementwise limit times cos's Lipschitz
    factor: the phase of feature j (block b) is scal·Sm_j times the last
    WHT's sum of ±scal·G_k·W_π(k), W = H(B ⊙ x); |Δ| ≤ outscale ·
    |scal·Sm_j| · TOL · Σ_k |scal·G_k|·|W_π(k)| (m, S), in float64, W made
    by the plain butterfly."""
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf
    from libskylark_tpu_torch.sketch.fut import _wht_butterfly

    bdiag, perms, gdiag, smdiag, _ = cf.kernel_streams(T, A.device)
    nb, NB = bdiag.shape
    m = A.shape[0]
    X = torch.nn.functional.pad(A, (0, NB - A.shape[1]))
    W = _wht_butterfly(bdiag[:, None, :] * X[None], axis=2).abs()
    W = torch.gather(W, 2, perms[:, None, :].expand(nb, m, NB)).double()
    R = (W * gdiag.double().abs()[:, None, :]).sum(2)          # (nb, m)
    del W, X
    lim = TOL * T.scale * (R[:, :, None]
                           * smdiag.double().abs()[:, None, :])
    return lim.permute(1, 0, 2).reshape(m, nb * NB)[:, :T._S]


def check_fastfood(torch, P, cases) -> list:
    """Phase 3, B4 and B4-split: each case's FastGaussianRFT (σ = √d)
    through both variants against fastfood_plain, the torch chain, on the
    same operand. A case with a fourth entry ν is a FastMaternRFT (l =
    √d) with its Gamma-derived Sm, held entry by entry within
    :func:`fastfood_limit`."""
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.sketch import cuda_fastfood as cf

    from libskylark_tpu_torch.sketch.fut import _wht_butterfly

    results = []
    for i, case in enumerate(cases):
        m, d, s_dim = case[:3]
        nu = case[3] if len(case) > 3 else None
        T = (sk.FastGaussianRFT(d, s_dim, P.Context(500 + i),
                                sigma=math.sqrt(d)) if nu is None
             else sk.FastMaternRFT(d, s_dim, P.Context(500 + i), nu=nu,
                                   l=math.sqrt(d)))
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
        limit = None if nu is None else fastfood_limit(torch, T, A)
        for name, variant in (("fastfood", "fused"),
                              ("fastfood_split", "split")):
            got = cf.features_rows(T, A, variant)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} output not finite")
            h = held(torch, got, want, limit)
            split = variant == "split"
            results.append({"kernel": name, "shape": [m, d], "s_dim": s_dim,
                            "NB": T._NB, "blocks": T._numblks,
                            **({"matern_nu": nu} if nu is not None else {}),
                            **h,
                            **({"w_bit_equal": w_equal} if split else {}),
                            "ok": h["ok"] and (w_equal or not split)})
        del A, want, limit
    emit("check", tolerance=f"B4: max|kernel-plain| <= {TOL} * max|plain|; "
                            "Matern Sm entry by entry (fastfood_limit); "
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
    TF32 off, then the epilogue's elementwise ops and torch.cos); then at
    config 3's shape again with a MaternRFT's Gamma-derived scales (ν =
    0.5, phases up to ~10⁴ rad: cosf's argument reduction does more work
    than at GaussianRFT's phases of a few rad)."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    rows = []
    from libskylark_tpu_torch import sketch as sk

    matern = (RFT_SHAPE, RFT_S, "MaternRFT.apply rowwise (nu = 0.5)")
    for i, ((m, n), s_dim, use) in enumerate(COS_TIME_SHAPES + [matern]):
        A = make_operand(torch, (m, n), 14 + 10 * i)
        dist, ctx = randgen.Normal(), P.Context(16 + 10 * i)
        g = torch.Generator(device="cuda").manual_seed(17 + 10 * i)
        sc = torch.ones(s_dim, device="cuda")
        if use.startswith("MaternRFT"):
            sc = sk.MaternRFT(n, s_dim, P.Context(19), nu=0.5,
                              l=math.sqrt(n)).row_scales(device="cuda")
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
                     "main_path": not use.startswith("MaternRFT"),
                     "shape": [m, n], "s_dim": s_dim,
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


def serve_requests(torch, np, seed_offset: int = 0) -> list:
    """The serve phase's requests: (bucket, endpoint, transform, operand,
    dimension), 16 per main bucket with 8 distinct seeds, 4 per smaller
    bucket. Dense operands are made on the card; CSR operands on the host,
    as a SparseMatrix. ``seed_offset`` moves every transform's seed and
    keeps the operands."""
    from libskylark_tpu_torch import sketch as sk

    def Context(seed):
        from libskylark_tpu_torch import Context as C

        return C(seed + seed_offset)

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


def storm(ex, reqs, threads: int = 4, call=None):
    """Submit every request from ``threads`` threads, interleaved, each by
    ``call(ex, request)`` (default: :func:`submit` of a serve-phase
    request); returns the results and, per request, (submit time,
    completion time)."""
    import threading

    futs = [None] * len(reqs)
    times = [[0.0, 0.0] for _ in reqs]
    if call is None:
        def call(ex, r):
            return submit(ex, *r[1:])

    def done(i):
        return lambda f: times[i].__setitem__(1, time.perf_counter())

    def worker(t):
        for i in range(t, len(reqs), threads):
            times[i][0] = time.perf_counter()
            futs[i] = call(ex, reqs[i])
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
# the serve sketch cells whose flushes are captured graphs (the sparse
# flushes stay eager, ROADMAP B-ii 10)
CAPTURED_BUCKETS = ("dense-rw", "ct-cw", "fastfood", "cwt", "srht")


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
    out["capture"] = st["capture"]
    check(st["capture"]["captured_flushes"] == sum(
        out["buckets"][b]["flushes"] for b in CAPTURED_BUCKETS),
        f"the captured buckets' flushes were not all captured: "
        f"{st['capture']}")
    out["captured"] = captured_flush_checks(torch, np)
    emit("serve", **out)
    return out


def _prepare_request(ex, r):
    """(bucket key, ctx, request) of a serve-phase request, packed by the
    executor's own code and not queued."""
    _, endpoint, T, A, dim = r
    kw = {} if endpoint == "fastfood_features" else {"dimension": dim}
    return ex._prepare(endpoint, transform=T, A=A, **kw)


def captured_flush_checks(torch, np, device="cuda") -> dict:
    """Each captured serve sketch cell's flush (CAPTURED_BUCKETS) through
    its CompiledFn against the same flush run eagerly on the same stacked
    inputs, torch.equal: the first cohort (the bucket's first 8 requests,
    the smaller buckets' 4) captures the graph, the second (the same
    operands under transforms of other seeds) replays it, a hit that
    launches the bucket's kernel exactly once, inside the replay, and
    gives another result than the first. Per bucket: the capture's and
    the replay's ms, the replay's launches and the graph's pool MB."""
    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.engine import serve

    first = serve_requests(torch, np)
    second = serve_requests(torch, np, seed_offset=1000)
    out = {}
    with engine.MicrobatchExecutor(max_batch=8, linger_us=60_000_000,
                                   device=device) as ex:
        for b in CAPTURED_BUCKETS:
            row, results = {}, []
            for tag, reqs in (("capture", first), ("replay", second)):
                mine = [r for r in reqs if r[0] == b][:8]
                prepared = [_prepare_request(ex, r) for r in mine]
                key, ctx, _ = prepared[0]
                kd, scale, arrays, _ = ex._stack_cohort(
                    ctx, [q for _, _, q in prepared], len(mine))
                eager = serve.run_flush(ctx, "cuda", kd, scale,
                                        {"A": arrays["A"].clone()})
                with ex._lock:
                    fn, why = ex._flush_fn_locked(key, ctx, "cuda")
                check(fn is not None, f"{b}: the flush is not captured "
                                      f"({why})")
                before, hits = launch_counts(), engine.stats().hits
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = serve.run_flush(dict(ctx, flush_fn=fn), "cuda", kd,
                                      scale, arrays)
                if device == "cuda":
                    torch.cuda.synchronize()
                row[tag + "_ms"] = (time.perf_counter() - t0) * 1e3
                launched = {k: v for k, v in qos_launches(before).items()
                            if v}
                check(bool(torch.equal(got, eager)),
                      f"{b}: the {tag}'s flush differs from the same flush "
                      "run eagerly")
                if tag == "replay":
                    check(engine.stats().hits == hits + 1,
                          f"{b}: the second cohort's flush was no hit")
                    check(device != "cuda"
                          or list(launched.values()) == [1],
                          f"{b}: the replay launched {launched}, not its "
                          "kernel once")
                    row["replay_launches"] = launched
                    entry = engine.cache().snapshot()[-1]
                    row["pool_mb"] = entry["pool_bytes"] / 2**20
                    row["graph_mb"] = entry["nbytes"] / 2**20
                results.append(got)
            check(not torch.equal(results[0], results[1]),
                  f"{b}: the replay under other keys repeated the captured "
                  "result")
            out[b] = row
            del results
    return out


def flush_cell(torch, ex, bucket_reqs, reps: int = 5, warmup: int = 2,
               call=None):
    """One bucket's capacity-8 flush through ``ex`` (max_batch 16, a long
    linger, so 8 submits wait for :meth:`flush`): ``warm_ms``, the median
    host time of the synchronous flush; ``device_ms``, its kernels' time
    under torch.profiler in one more flush; ``busy`` = device/warm.
    ``call(ex, request)`` submits one request (default: the serve phase's
    :func:`submit`)."""
    from torch.profiler import ProfilerActivity, profile

    if call is None:
        def call(ex, r):
            return submit(ex, *r[1:])

    def one():
        futs = [call(ex, r) for r in bucket_reqs]
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


# the warmup phase's pack: PERF.md §4's serve cells at their own shapes
# (SRHT is no family of the reference's builder: its flush is captured and
# checked in the serve phase)
WARMUP_SPECS = [
    {"endpoint": "sketch_apply", "family": "JLT", "n": 8192, "m": 2048,
     "s_dim": 1024, "rowwise": True, "capacities": [1, 8], "seed": 1700},
    {"endpoint": "sketch_apply", "family": "CT", "n": 8192, "m": 128,
     "s_dim": 1024, "rowwise": False, "capacities": [1, 8], "seed": 1710},
    {"endpoint": "sketch_apply", "family": "CWT", "n": 8192, "m": 512,
     "s_dim": 1024, "rowwise": True, "capacities": [1, 4], "seed": 1720},
    {"endpoint": "fastfood_features", "family": "FastGaussianRFT",
     "n": 4096, "m": 2048, "s_dim": 4096, "sigma": 64.0,
     "capacities": [1, 8], "seed": 1730},
]


def warmup_cell(torch, spec, cap: int, device: str, reps: int = 5) -> dict:
    """One packed (bucket, capacity)'s flush through a fresh executor on
    its canonical cohort, the operands on the device: the cold flush
    (warm-up and capture, the cache reset first), the median of ``reps``
    replays, and the median of ``reps`` eager flushes (the capture turned
    off); device ms of a replay and of an eager flush under
    torch.profiler, busy = device / warm; the graph's pool and total MB."""
    from torch.profiler import ProfilerActivity, profile

    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.engine import serve, warmup

    cuda = device == "cuda"
    reqs = [(T, torch.from_numpy(A).to(device))
            for T, A in warmup._spec_requests(spec, cap)]

    def flush_ms(ex):
        futs = [warmup._submit(ex, spec, T, A) for T, A in reqs]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.flush()
        ms = (time.perf_counter() - t0) * 1e3
        for f in futs:
            f.result(timeout=600)
        return ms

    def device_ms(ex):
        if not cuda:
            return None
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_ms(ex)
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    row = {}
    engine.reset()
    # max_batch 2·cap: the cohort waits for flush(), its class is cap
    with engine.MicrobatchExecutor(max_batch=2 * cap, linger_us=60_000_000,
                                   device=device) as ex:
        row["cold_ms"] = flush_ms(ex)
        row["replay_ms"] = statistics.median(flush_ms(ex)
                                             for _ in range(reps))
        row["replay_device_ms"] = device_ms(ex)
        (entry,) = engine.cache().snapshot()
        row["pool_mb"] = entry["pool_bytes"] / 2**20
        row["graph_mb"] = entry["nbytes"] / 2**20
    captured = serve._CAPTURED_ENDPOINTS
    serve._CAPTURED_ENDPOINTS = ()
    try:
        with engine.MicrobatchExecutor(max_batch=2 * cap,
                                       linger_us=60_000_000,
                                       device=device) as ex:
            flush_ms(ex)
            row["eager_ms"] = statistics.median(flush_ms(ex)
                                                for _ in range(reps))
            row["eager_device_ms"] = device_ms(ex)
            check(ex.stats()["capture"]["captured_flushes"] == 0,
                  "an eager flush went through the executable cache")
    finally:
        serve._CAPTURED_ENDPOINTS = captured
    if cuda:
        row["busy_replay"] = row["replay_device_ms"] / row["replay_ms"]
        row["busy_eager"] = row["eager_device_ms"] / row["eager_ms"]
    engine.reset()
    return row


def warmup_phase(torch, P, np, specs=WARMUP_SPECS, device="cuda") -> dict:
    """Phase 4b-iii, warmup packs at full width: a pack built from
    WARMUP_SPECS (each bucket at capacities 1 and 8, CWT 1 and 4), every
    entry captured on the kernel route with its capture record written;
    each entry's cold, replay and eager flush (:func:`warmup_cell`); then
    two fresh processes serve every packed cohort (on the CPU: this one,
    the cache reset between), cold and booted from the pack: the cold one
    must capture each entry once (compiles = misses = entries), the
    packed one load every entry (loaded = aot_loads = kernel_restored =
    entries) and then serve with no capture (compiles = misses = 0, a hit
    per entry), both bit-equal to the builder's results."""
    import shutil

    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.engine import warmup

    cuda = device == "cuda"
    t_phase = time.perf_counter()
    specs = [warmup.BucketSpec.from_dict(s) for s in specs]
    pack = ROOT / "build" / "warmup_pack"
    shutil.rmtree(pack, ignore_errors=True)
    before = launch_counts()
    out = {"card": smi("name,power.limit") if cuda else None}
    t0 = time.perf_counter()
    manifest = warmup.build_pack(str(pack), specs, device=device)
    out["build_seconds"] = time.perf_counter() - t0
    n = len(manifest["entries"])
    route = "cuda" if cuda else "plain"
    check(n == sum(len(s.capacities) for s in specs)
          and not manifest["uncaptured"],
          f"the pack holds {n} entries, uncaptured: "
          f"{manifest['uncaptured']}")
    check(all(e["kernel"] == route and not e.get("artifact_missing")
              for e in manifest["entries"]),
          "a packed entry is off the kernel route or has no record")
    out["entries"] = [{k: e[k] for k in ("name", "capacity", "kernel",
                                         "digest")}
                      for e in manifest["entries"]]
    if cuda:
        # the pack's graphs, all resident after the build, within the
        # executable cache's device-memory bound
        from libskylark_tpu_torch.engine.compiled import byte_budget

        held = engine.cache().nbytes()
        budget = byte_budget(torch.device("cuda",
                                          torch.cuda.current_device()))
        out["graphs_mb"], out["budget_mb"] = held / 2**20, budget / 2**20
        check(len(engine.cache()) == n and held <= budget,
              f"the pack's {len(engine.cache())} graphs hold {held} bytes "
              f"against a budget of {budget}")
    out["cells"] = {f"{s.family}-{'rw' if s.rowwise else 'cw'}-{c}":
                    warmup_cell(torch, s, c, device)
                    for s in specs for c in s.capacities}
    out["launches"] = qos_launches(before)
    if cuda:
        release_cache(torch)
        cold = warmup.spawn_boot_probe(str(pack), load=False, timeout=600)
        packed = warmup.spawn_boot_probe(str(pack), load=True, timeout=600)
    else:
        engine.reset()
        cold = warmup.serve_probe(str(pack), load=False, device=device)
        engine.reset()
        packed = warmup.serve_probe(str(pack), load=True, device=device)
        engine.reset()
    ce, pe, w = cold["engine"], packed["engine"], packed["warmup"] or {}
    check(cold["bit_equal"] and ce["compiles"] == n and ce["misses"] == n,
          f"cold boot probe: bit_equal {cold['bit_equal']}, {ce}")
    check(packed["bit_equal"] and w.get("skipped") is None
          and not w.get("failed") and w.get("loaded") == n
          and w.get("kernel_restored") == n,
          f"packed boot probe: bit_equal {packed['bit_equal']}, {w}")
    check(pe["compiles"] == 0 and pe["misses"] == 0 and pe["hits"] == n
          and pe["aot_loads"] == n,
          f"the packed boot probe captured during traffic: {pe}")
    keys = ("t_first_result_s", "t_total_s", "wall_since_spawn_s",
            "flush_ms")
    out["boot_probe"] = {
        name: {**{k: r.get(k) for k in keys},
               **{k: r["engine"][k] for k in (
                   "compiles", "misses", "hits", "aot_loads",
                   "compile_seconds", "load_seconds")},
               "bit_equal": r["bit_equal"]}
        for name, r in (("cold", cold), ("packed", packed))}
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        release_cache(torch)
    emit("warmup", **out)
    return out


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
    # the a3 phase: lobpcg_rand_evd's JLT sketch, the power-iteration
    # EVD's range sketch, and the dense ASE's at k' = 12 (its subgraph has
    # at most 2048 vertices: whole and ragged)
    cases += [("dense_columnwise", "normal", (65536, 512), 2048),
              ("dense_rowwise", "normal", (65536, 512), 10),
              ("dense_rowwise", "normal", (2048, 2048), 12),
              ("dense_rowwise", "normal", (1531, 1531), 12)]
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
             ((16384, 784), 2048), ((10000, 784), 2048),
             # the a3 phase: MaternRFT at config 3's shape (ν = 0.5 takes
             # the Gamma boost), and Block-ADMM on Matern(784, ν = 1.5)
             (RFT_SHAPE, RFT_S, 0.5), (RFT_SHAPE, RFT_S, 1.5),
             (RFT_SHAPE, RFT_S, 2.5), ((60000, 784), 2048, 1.5),
             ((10000, 784), 2048, 1.5)]
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
                  (60000, 784, 8192), (10000, 784, 8192),
                  # the a3 phase: FastMaternRFT at config 3's shape
                  (*RFT_SHAPE, RFT_S, 0.5), (*RFT_SHAPE, RFT_S, 1.5),
                  (*RFT_SHAPE, RFT_S, 2.5)]

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


# Phase 4b': the solve-family serve endpoints at full width. Shapes:
# config 4's LS cell (ls), the sparse LS cell (sparse), config 1's n and s
# (cmm-srht), config 2's rcv1 rows (cmm-cwt-sparse), config 4's SVD
# operand (lowrank), config 5's model on the ml phase's first 16,384 rows
# (krr, rlsc), the LS operand's width (condest), and the a3 phase's R-MAT
# generator at scale 16 with skylark_graph_se's defaults (graph).
SOLVE_FULL = {"ls_rows": (49153, 65537), "ls_cols": 512, "ls_s": 2048,
              "ls_requests": 16, "sparse_requests": 4,
              "sparse_s": {"CWT": 4096, "JLT": 2048},
              "cmm_rows": (1025, 2049), "cmm_n": 8192, "cmm_p": 256,
              "cmm_s": 1024, "cmm_requests": 8,
              "lowrank_rows": (4097, 8193), "lowrank_s": 128,
              "lowrank_t": 512, "lowrank_k": 64, "lowrank_requests": 8,
              "krr_rows": (129, 257), "krr_train": 16384,
              "krr_requests": 16, "condest_rows": (8193, 16385),
              "condest_cols": 512, "condest_steps": 8,
              "condest_requests": 8, "graph_scale": 16,
              "graph_edge_factor": 4, "ase_k": 6, "ase_iters": 2,
              "ppr_alpha": 0.85, "ppr_iters": 16, "graph_requests": 8,
              "sparse_ls": SPARSE_LS, "rcv1_d": RCV1_D, "svd_n": 8192,
              "svd_rank": 512, "ml": ML_FULL}
# the phase's limits, each with its reason
SOLVE_LIMITS = {
    # the LS cell's: s = 4d gives ≈ 1.15, s = 2d (sparse JLT) ≈ 1.41
    "residual_ratio": 1.5,
    # kernel against plain: the reference's oracle, on x, Z·Zᵀ and the
    # cmm estimate; the bound is host arithmetic on both routes
    "solve": TOL, "projector": TOL, "cmm": TOL, "cmm_bound_rel": 1e-6,
    # condest: the reference's qos bounds (σmax within 0.2; cond in
    # [1, 3·exact]); Golub–Kahan's σmin is a Ritz value, not below the
    # true one beyond rounding
    "condest_max_rel": 0.2, "condest_cond": 3.0, "condest_min_rel": 1e-3}
# bucket -> (kernel, launches per flush) of its flush's sketches
SOLVE_ROUTES = {
    "solve-jlt": {"dense_batched_columnwise": 2},
    "solve-cwt": {"hash_batched": 2},
    "sparse-solve-cwt": {"sparse_columnwise": 1, "hash_batched": 1},
    "sparse-solve-jlt": {"dense_batched_columnwise": 2},
    "cmm-srht": {"fwht_batched": 2},
    "cmm-cwt-sparse": {"sparse_rowwise": 1, "hash_batched": 1},
    "lowrank": {"dense_batched_rowwise": 2},
}
LIBRARY_BUCKETS = ("krr-predict", "rlsc-predict", "condest", "graph-ase",
                   "graph-ppr")


def rmat_adjacency(np, scale: int, edge_factor: int, seed: int):
    """The a3 phase's R-MAT edges (Graph500's probabilities) as a binary
    symmetric scipy CSR adjacency without self-loops, 2^scale vertices."""
    import scipy.sparse as sp

    src, dst = rmat_edges(np, scale, edge_factor, (0.57, 0.19, 0.19, 0.05),
                          seed)
    keep = src != dst
    n = 1 << scale
    A = sp.coo_matrix((np.ones(int(keep.sum()), np.float32),
                       (src[keep], dst[keep])), shape=(n, n)).tocsr()
    A = ((A + A.T) > 0).astype(np.float32)
    A.sort_indices()
    return A


def serve_solve_requests(torch, P, np, size=SOLVE_FULL,
                         device="cuda") -> tuple:
    """The serve-solve phase's requests and what its checks need: a list
    of (bucket, submit method, kwargs, check data) and the shared
    operands, dense ones on ``device``, CSR and KRR ones on the host."""
    from libskylark_tpu_torch import ml, sketch as sk
    from libskylark_tpu_torch.base import sprand
    from libskylark_tpu_torch.base.sparse import spmm

    g = np.random.default_rng(900)
    reqs, ops = [], {}
    # the LS cell: one operand per request, sketched by JLT and by CWT
    d, s = size["ls_cols"], size["ls_s"]
    for i in range(size["ls_requests"]):
        n = int(g.integers(*size["ls_rows"]))
        A = make_operand(torch, (n, d), 9000 + i, device)
        x0 = make_operand(torch, (d,), 9100 + i, device)
        b = A @ x0 + 0.1 * make_operand(torch, (n,), 9200 + i, device)
        for fam in ("JLT", "CWT"):
            T = getattr(sk, fam)(n, s, P.Context(910 + i % 8))
            reqs.append((f"solve-{fam.lower()}", "submit_solve",
                         {"A": A, "B": b, "transform": T}, {"op": i}))
        ops[("ls", i)] = (A, b)
    # the sparse LS cell
    m, n, dens = size["sparse_ls"]
    for i in range(size["sparse_requests"]):
        L = sprand.sample(m, n, dens, DYADIC, (1, 1, 1), P.Context(920 + i),
                          device=device)
        gt = torch.Generator(device=device).manual_seed(930 + i)
        x0 = torch.randn(n, generator=gt, device=device)
        b = spmm(L, x0) + 0.1 * torch.randn(m, generator=gt, device=device)
        for fam, s in size["sparse_s"].items():
            T = getattr(sk, fam)(m, s, P.Context(940 + i))
            reqs.append((f"sparse-solve-{fam.lower()}", "submit_sparse_solve",
                         {"A": L, "B": b, "transform": T}, {"op": i}))
        ops[("sparse", i)] = (L, b)
    # compressed matmul: dense SRHT and rcv1-shaped CSR by CWT
    cn, cp, cs = size["cmm_n"], size["cmm_p"], size["cmm_s"]
    for i in range(size["cmm_requests"]):
        rows = int(g.integers(*size["cmm_rows"]))
        A = make_operand(torch, (rows, cn), 9300 + i, device)
        B = make_operand(torch, (cn, cp), 9400 + i, device)
        reqs.append(("cmm-srht", "submit_compressed_matmul",
                     {"A": A, "B": B, "transform": sk.FJLT(
                         cn, cs, P.Context(950 + i), fut="wht")}, {}))
        rows = int(g.integers(*size["cmm_rows"]))
        As = csr_operand(rows, size["rcv1_d"], RCV1_DENSITY, 9500 + i)
        Bs = make_operand(torch, (size["rcv1_d"], cp), 9600 + i, device)
        reqs.append(("cmm-cwt-sparse", "submit_compressed_matmul",
                     {"A": As, "B": Bs, "transform": sk.CWT(
                         size["rcv1_d"], cs, P.Context(960 + i))}, {}))
    # lowrank on the rows of config 4's SVD operand
    Asvd, _ = svd_operand(torch, size["svd_n"], size["svd_rank"], device)
    lin = ml.kernels.Linear(Asvd.shape[1])
    for i in range(size["lowrank_requests"]):
        rows = int(g.integers(*size["lowrank_rows"]))
        ctx = P.Context(970 + i)
        Ts = lin.create_rft(size["lowrank_s"], ctx)
        Tt = lin.create_rft(size["lowrank_t"], ctx)
        reqs.append(("lowrank", "submit_lowrank",
                     {"transform_s": Ts, "transform_t": Tt,
                      "A": Asvd[:rows], "k": size["lowrank_k"]}, {}))
    # KRR and RLSC: config 5's model on the first rows of the ml phase,
    # held on the host as a server would hold it
    X, y, Xq, _ = ml_data(torch, size["ml"], device)
    X, y = X[:size["krr_train"]], y[:size["krr_train"]]
    kern = ml_kernel(ml, size["ml"])
    coef, coding = ml.kernel_rlsc(kern, X, y, ML_LAM, device=device)
    model = (X.cpu().numpy(), coef.cpu().numpy())
    Xq = Xq.cpu().numpy()
    at = 0
    for i in range(size["krr_requests"]):
        for ep, method in (("krr-predict", "submit_krr_predict"),
                           ("rlsc-predict", "submit_rlsc_predict")):
            rows = int(g.integers(*size["krr_rows"]))
            q = Xq[at % (Xq.shape[0] - rows):][:rows]
            at += rows
            reqs.append((ep, method, {"kernel": kern, "X_new": q,
                                      "X_train": model[0],
                                      "coef": model[1]}, {}))
    ops["model"] = model
    del X, y, coef
    # condest on Gaussian operands of the LS operand's width
    for i in range(size["condest_requests"]):
        rows = int(g.integers(*size["condest_rows"]))
        reqs.append(("condest", "submit_condest",
                     {"A": make_operand(torch, (rows, size["condest_cols"]),
                                        9700 + i, device),
                      "steps": size["condest_steps"], "seed": i}, {}))
    # the graph endpoints on one R-MAT adjacency
    G = rmat_adjacency(np, size["graph_scale"], size["graph_edge_factor"],
                       980)
    nv = G.shape[0]
    for i in range(size["graph_requests"]):
        reqs.append(("graph-ase", "submit_graph_ase",
                     {"A": G, "k": size["ase_k"], "seed": 990 + i,
                      "iters": size["ase_iters"]}, {}))
        svec = np.zeros(nv, np.float32)
        svec[g.choice(nv, 8, replace=False)] = 1.0
        reqs.append(("graph-ppr", "submit_graph_ppr",
                     {"A": G, "s": svec, "alpha": size["ppr_alpha"],
                      "iters": size["ppr_iters"]}, {}))
    ops["graph_nnz"] = G.nnz
    return reqs, ops


def cusparse_repeat(torch, np, size, device) -> dict:
    """Recorded, not a check: torch's cuSPARSE product of the phase's
    R-MAT adjacency (CSR) with a Gaussian (n, 6) block, made twice on the
    same inputs: whether the two agree bit for bit, and by how much they
    differ. The graph lanes sum in CSR order instead (ROADMAP C17)."""
    from libskylark_tpu_torch.base.sparse import SparseMatrix

    S = SparseMatrix.from_scipy(rmat_adjacency(
        np, size["graph_scale"], size["graph_edge_factor"], 980))
    data, indices, indptr = (torch.from_numpy(x).to(device)
                             for x in S.csr_parts(np.dtype(np.float32)))
    A = torch.sparse_csr_tensor(indptr.long(), indices.long(), data,
                                S.shape)
    X = torch.randn(S.shape[1], size["ase_k"], device=device)
    runs = [A @ X for _ in range(5)]
    return {"equal": all(bool(torch.equal(runs[0], r)) for r in runs),
            "max_abs_diff": max(float((runs[0] - r).abs().max())
                                for r in runs),
            "max_abs": float(runs[0].abs().max())}


# the endpoint each submit method of the phase reaches (none of the
# phase's CSR operands is dense enough to go densified)
SOLVE_ENDPOINTS = {"submit_solve": "solve_l2_sketched",
                   "submit_sparse_solve": "sparse_solve_l2_sketched",
                   "submit_compressed_matmul": "compressed_matmul",
                   "submit_lowrank": "lowrank",
                   "submit_krr_predict": "krr_predict",
                   "submit_rlsc_predict": "rlsc_predict",
                   "submit_condest": "condest", "submit_graph_ase": "graph_ase",
                   "submit_graph_ppr": "graph_ppr"}


def solve_call(ex, req):
    _, method, kw, _ = req
    return getattr(ex, method)(**kw)


def solve_prepare(ex, req) -> tuple:
    """(bucket key, ctx, request) of a phase request, packed by the
    executor's own code and not queued."""
    _, method, kw, _ = req
    return ex._prepare(SOLVE_ENDPOINTS[method], **kw)


def same(torch, a, b) -> bool:
    """torch.equal of two served results (a tuple's members, a host array
    by value)."""
    if isinstance(a, tuple):
        return all(same(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return bool((a == b).all()) if hasattr(a, "all") else a == b


def flush_inputs(ex, reqs):
    """(ctx, kd, scale, arrays) of one flush of those of ``reqs`` that
    share the first one's executor bucket, stacked by the executor."""
    prepared = [solve_prepare(ex, r) for r in reqs]
    key, ctx, _ = prepared[0]
    cohort = [q for k, _, q in prepared if k == key]
    kd, scale, arrays, _ = ex._stack_cohort(ctx, cohort, len(cohort))
    return ctx, kd, scale, arrays


def solve_sketch_checks(torch, ex, reqs) -> list:
    """Each kernel-routed bucket's sketches at its first flush's shape
    (8 lanes; 4 sparse): the batched kernels against their plain versions
    on the same stacked operands — B1-batched and B5-batched on the card
    within TOL·max|plain|, B2-batched and B3 torch.equal to the plain
    scatter on CPU copies."""
    from libskylark_tpu_torch.engine import serve

    results = []
    for b in SOLVE_ROUTES:
        mine = [r for r in reqs if r[0] == b][:8]
        ctx, kd, scale, arrays = flush_inputs(ex, mine)
        got = serve.sketch_stage(ctx, kd, scale, arrays)
        exact = ctx["family"] == "CWT"
        if exact:
            host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in arrays.items()}
            want = serve.sketch_stage(ctx, kd, scale, host, plain=True)
        else:
            want = serve.sketch_stage(ctx, kd, scale, arrays, plain=True)
        for name, gt, wt in zip(("A", "B"), got, want):
            if exact:
                ok = bool(torch.equal(gt.cpu(), wt))
                err = float((gt.cpu() - wt).abs().max())
                h = {"max_abs_err": err, "ok": ok}
            else:
                h = held(torch, gt, wt)
            results.append({"bucket": b, "operand": name,
                            "shape": list(arrays["A" if "A" in arrays
                                                 else "data"].shape),
                            "out": list(gt.shape), **h})
        del got, want, arrays
    return results


def serve_solve_route_checks(out, st) -> None:
    """The card's routes of the measured storm: every sketch bucket on its
    kernels (none declined), the endpoints without a sketch on the
    library route, exactly one batched launch per operand per flush and
    no other launch, and no operator panel made in torch."""
    check(set(st["kernel"]["by_backend"]) == {"cuda"}
          and not st["kernel"]["by_reason"],
          f"a kernel bucket flushed on the plain program: {st['kernel']}")
    for b, v in out["buckets"].items():
        want = "library" if b in LIBRARY_BUCKETS else "cuda"
        check(v["route"] == want, f"{b} took route {v['route']}, not {want}")
    expected = {k: 0 for k in out["launches"]}
    for b, per in SOLVE_ROUTES.items():
        for k, n in per.items():
            expected[k] += n * out["buckets"][b]["flushes"]
    out["launches_expected"] = expected
    check(out["launches"] == expected,
          f"serve-solve launches {out['launches']} != one batched launch "
          f"per operand per flush {expected}")
    check(out["panels"] == 0,
          f"the kernel routes made {out['panels']} torch operator panels")


def serve_solve_phase(torch, P, np, size=SOLVE_FULL, device="cuda") -> dict:
    """Phase 4b': the nine solve-family endpoints at full width. The
    storm of :func:`serve_phase` (4 threads, max_batch 8, a warm-up storm
    on one executor, then a measured one on another with every launch
    counter and the torch panel counter set to 0 just before and read
    just after); then every served request held to its capacity-1 flush
    through the kernel route (torch.equal) and, on the kernel-routed
    buckets, to its capacity-1 plain flush (SOLVE_LIMITS); each solve's
    residual against the exact least-squares residual in float64;
    condest against the operand's singular values; each kernel-routed
    bucket's sketches against their plain versions at its flush shape.
    Fails on any check."""
    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.base.sparse import spmm

    cuda = device == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reqs, ops = serve_solve_requests(torch, P, np, size, device)
    names = list(dict.fromkeys(r[0] for r in reqs))
    lim = SOLVE_LIMITS
    out = {"limits": lim, "card": smi("name,power.limit") if cuda else None,
           "buckets": {}, "setup_seconds": time.perf_counter() - t_phase}
    with engine.MicrobatchExecutor(max_batch=8, linger_us=5000,
                                   device=device) as ex:
        storm(ex, reqs, call=solve_call)
        ex.flush()
        warm = ex.stats()
    check(warm["failed"] == 0, f"serve-solve warm-up failed: "
                               f"{warm['failed']}")
    with engine.MicrobatchExecutor(max_batch=8, linger_us=5000,
                                   device=device) as ex:
        for c in counters():
            for k in c:
                c[k] = 0
        panels0 = randgen.panels["dense_panel"]
        t0 = time.perf_counter()
        results, times = storm(ex, reqs, call=solve_call)
        out["storm_seconds"] = time.perf_counter() - t0
        ex.flush()
        out["launches"] = launch_counts()
        out["panels"] = randgen.panels["dense_panel"] - panels0
        st = ex.stats()
    out["stats"] = {k: st[k] for k in (
        "submitted", "completed", "failed", "flushes", "coalesced",
        "isolation_retries", "kernel", "library", "models", "sparse",
        "padding_waste_ratio", "latency_s", "batch_capacity_hist")}
    # the executor's bucket keys of each phase bucket (a KRR/RLSC key
    # carries the model's ids; cmm-cwt-sparse's rows span two nnz classes)
    statics = {}
    for r in reqs:
        statics.setdefault(r[0], set()).add(repr(solve_prepare(ex, r)[0]))
    for b in names:
        mine = [i for i, r in enumerate(reqs) if r[0] == b]
        lat = sorted(times[i][1] - times[i][0] for i in mine)
        span = (max(times[i][1] for i in mine)
                - min(times[i][0] for i in mine))
        keys = [st["by_bucket"][k] for k in sorted(statics[b])]
        out["buckets"][b] = {
            "requests": len(mine), "requests_per_s": len(mine) / span,
            "latency_p50_ms": 1e3 * statistics.median(lat),
            "latency_p99_ms": 1e3 * lat[-1],
            "route": "/".join(sorted({v["route"] for v in keys})),
            "flushes": sum(v["flushes"] for v in keys),
            "completed": sum(v["completed"] for v in keys),
            "executor_buckets": keys}
    check(sum(v["flushes"] for v in out["buckets"].values())
          == st["flushes"], "a flush of the storm is in no phase bucket")
    check(st["failed"] == 0 and st["completed"] == len(reqs)
          and st["submitted"] == len(reqs),
          f"serve-solve storm: {st['submitted']} submitted, "
          f"{st['completed']} completed, {st['failed']} failed of "
          f"{len(reqs)}")
    serve_solve_route_checks(out, st)
    check(st["library"]["flushes"] == sum(
        out["buckets"][b]["flushes"] for b in LIBRARY_BUCKETS),
        f"library flushes {st['library']} differ from the buckets'")
    check(st["models"]["uploads"] == 2,
          f"KRR/RLSC models uploaded {st['models']['uploads']} times, not "
          "once per bucket")
    # references: capacity-1 flushes through the kernel route and plain
    worst = {}
    with engine.MicrobatchExecutor(max_batch=1, device=device) as one, \
            engine.MicrobatchExecutor(max_batch=1, kernel="plain",
                                      device=device) as plain:
        for r, got in zip(reqs, results):
            b = r[0]
            alone = solve_call(one, r).result(timeout=600)
            check(same(torch, got, alone),
                  f"{b}: a lane of a capacity-8 flush differs from its "
                  "capacity-1 flush through the kernel")
            if b in LIBRARY_BUCKETS:
                continue
            want = solve_call(plain, r).result(timeout=600)
            if b == "lowrank":
                P1, P2 = got.double() @ got.double().T, \
                    want.double() @ want.double().T
                err, limit = float((P1 - P2).abs().max()), lim["projector"]
                del P1, P2
            elif b.startswith("cmm"):
                rel = abs(got[1] - want[1]) / abs(want[1])
                check(rel <= lim["cmm_bound_rel"],
                      f"{b}: bound {got[1]} vs plain {want[1]}")
                err = float((got[0] - want[0]).abs().max()
                            / want[0].abs().max())
                limit = lim["cmm"]
            else:
                err = float((got - want).abs().max() / want.abs().max())
                limit = lim["solve"]
            check(err <= limit, f"{b}: served result vs its plain flush "
                                f"{err} > {limit}")
            worst[b] = max(worst.get(b, 0.0), err)
    out["max_err_vs_plain"] = worst

    # algorithm contracts
    ratios = {}
    exact = {}
    for (kind, i), (A, b) in ((k, v) for k, v in ops.items()
                              if isinstance(k, tuple)):
        if kind == "ls":
            exact[(kind, i)] = lstsq_residual(torch, A, b)
        else:
            Ld = A.todense(dtype=np.float64, device=device)
            xe = torch.linalg.lstsq(Ld, b.double()[:, None]).solution
            exact[(kind, i)] = float(torch.linalg.norm(
                Ld @ xe[:, 0] - b.double()))
            del Ld, xe
    for r, x in zip(reqs, results):
        b = r[0]
        if "solve" not in b:
            continue
        kind = "sparse" if b.startswith("sparse") else "ls"
        A, rhs = ops[(kind, r[3]["op"])]
        res = (spmm(A, x) if kind == "sparse" else A @ x) - rhs
        ratio = float(torch.linalg.norm(res.double())) / exact[(kind,
                                                                r[3]["op"])]
        ratios.setdefault(b, []).append(ratio)
        check(ratio <= lim["residual_ratio"],
              f"{b}: residual ratio {ratio} > {lim['residual_ratio']}")
    out["residual_ratio"] = {b: {"max": max(v), "min": min(v)}
                             for b, v in ratios.items()}
    cond = []
    for r, got in zip(reqs, results):
        if r[0] != "condest":
            continue
        sv = torch.linalg.svdvals(r[2]["A"].double())
        smax, smin = float(sv[0]), float(sv[-1])
        c, gmax, gmin = (float(v) for v in got)
        cond.append({"cond": c, "sigma_max": gmax, "sigma_min": gmin,
                     "exact_max": smax, "exact_min": smin})
        check(abs(gmax - smax) <= lim["condest_max_rel"] * smax
              and 1.0 <= c <= lim["condest_cond"] * smax / smin
              and gmin >= smin * (1 - lim["condest_min_rel"]),
              f"condest outside the reference's bounds: {cond[-1]}")
    out["condest"] = cond
    cmm = []
    for r, got in zip(reqs, results):
        if not r[0].startswith("cmm"):
            continue
        (est, bound), A, B = got, r[2]["A"], r[2]["B"]
        exact_ab = (spmm(A, B) if r[0].endswith("sparse") else A @ B)
        cmm.append({"bucket": r[0], "frobenius_error": float(
            torch.linalg.norm(est - exact_ab)), "bound": bound})
    out["cmm_error_vs_bound"] = cmm
    del results
    out["cusparse_repeat"] = cusparse_repeat(torch, np, size, device)

    # each kernel-routed bucket's sketches against their plain versions
    with engine.MicrobatchExecutor(max_batch=8, device=device) as ex:
        out["sketch_checks"] = solve_sketch_checks(torch, ex, reqs)
    bad = [c for c in out["sketch_checks"] if not c["ok"]]
    check(not bad, f"serve-solve sketches disagree with their plain "
                   f"versions: {bad}")
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del reqs, ops
        release_cache(torch)
    emit("serve_solve", **out)
    return out


def serve_solve_cells(torch, P, np) -> dict:
    """Every serve-solve bucket's flush cell (:func:`flush_cell`) on its
    first 8 requests (the sparse buckets: their 4)."""
    from libskylark_tpu_torch import engine

    reqs, _ = serve_solve_requests(torch, P, np)
    cells = {}
    with engine.MicrobatchExecutor(max_batch=16, linger_us=60_000_000,
                                   device="cuda") as ex:
        for b in dict.fromkeys(r[0] for r in reqs):
            cells[b] = flush_cell(torch, ex, [r for r in reqs
                                              if r[0] == b][:8],
                                  call=solve_call)
    return cells


# ---------------------------------------------------------------------------
# phase 4b'': the serve executor's production layer (A6/A7, serve_qos)
# ---------------------------------------------------------------------------

# config 4's serve-solve-jlt bucket (65,536 × 512, s = 2048) for the cache
# storm, residency and deadlines; the serve phase's dense-rw bucket (JLT
# 8192 → 1024 rowwise on 1,537–2,048 rows) for DEGRADED, QoS, the
# adaptive controller and the profiled flush
QOS_FULL = {"ls_rows": 65536, "ls_cols": 512, "ls_s": 2048,
            "storm": 64, "storm_threads": 8, "ref_requests": 16,
            "rw_rows": (1537, 2049), "rw_n": 8192, "rw_s": 1024,
            "rw_operands": 8, "deadline_requests": 4, "deadline_s": 0.01,
            "degrade_failures": 4, "max_queue": 64, "qos_requests": 32,
            "burst": 4, "rate_requests": 12, "adaptive_requests": 32,
            "adapt_interval_s": 0.05, "hold_s": 1.0}


def qos_launches(before: dict) -> dict:
    """Every kernel's launches since ``before`` (a :func:`launch_counts`)."""
    now = launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def add_launches(total: dict, delta: dict) -> None:
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def qos_storm(ex, call, n: int, threads: int, submitted=None):
    """``n`` calls of ``call(ex, i)`` from ``threads`` threads; (futures in
    call order, seconds until every future resolved). ``submitted(futs)``,
    when given, runs once every call has returned, before any wait."""
    import threading

    futs = [None] * n

    def worker(t):
        for i in range(t, n, threads):
            futs[i] = call(ex, i)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if submitted is not None:
        submitted(futs)
    for f in futs:
        f.exception(timeout=600)
    return futs, time.perf_counter() - t0


def qos_outcome(f) -> str:
    """The name of a resolved future's exception, or "ok"."""
    e = f.exception(timeout=600)
    return "ok" if e is None else type(e).__name__


def profiled_flush_checks(torch, prof, device) -> dict:
    """The profiled flush's ``serve.flush`` range: exactly one, and the
    work it encloses. On the card, every B1 kernel in the trace was
    launched inside the host's range: each kernel's launch record is
    found by its correlation id and compared on the host's clock, never
    the kernel's device timestamps with the host's; the trace's
    device-side ``serve.flush`` annotation holds every kernel. On the
    CPU, the plain program's torch operators lie inside the range."""
    events = list(prof.events())
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    flush = [e for e in events
             if e.name == "serve.flush" and e.device_type == cpu]
    check(len(flush) == 1, f"{len(flush)} serve.flush ranges in the "
                           "profiled flush, not 1")
    lo, hi = flush[0].time_range.start, flush[0].time_range.end
    if device != "cuda":
        inside = [e.name for e in events if e.name.startswith("aten::")
                  and lo <= e.time_range.start and e.time_range.end <= hi]
        check(bool(inside), f"serve.flush [{lo}, {hi}] encloses none of "
                            "the flush's operators")
        return {"range_us": hi - lo, "enclosed": sorted(set(inside))}
    kernels = [e for e in events
               if e.device_type == gpu and "dense" in e.name]
    # a replayed graph's kernels share its cudaGraphLaunch record
    launch = {e.id: e for e in events if e.device_type == cpu
              and e.name.startswith(("cudaLaunch", "cuLaunch",
                                     "cudaGraphLaunch", "cuGraphLaunch"))}
    # the device-side annotation: one span per run of kernels (a
    # replayed graph's kernels may each get their own)
    annot = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "serve.flush" and e.device_type == gpu]
    check(bool(kernels) and bool(annot),
          f"the profiled flush's trace holds {len(kernels)} B1 kernels and "
          f"{len(annot)} device-side serve.flush annotations")
    dlo, dhi = min(a for a, _ in annot), max(b for _, b in annot)
    inside = [k.name for k in kernels if k.id in launch
              and lo <= launch[k.id].time_range.start
              and launch[k.id].time_range.end <= hi
              and any(a <= k.time_range.start and k.time_range.end <= b
                      for a, b in annot)]
    check(len(inside) == len(kernels),
          f"serve.flush [{lo}, {hi}] encloses the launches of {len(inside)} "
          f"of the flush's {len(kernels)} kernels")
    return {"range_us": hi - lo, "device_range_us": dhi - dlo,
            "device_annotations": len(annot),
            "enclosed": sorted(set(inside)),
            "launch_records": sorted({launch[k.id].name for k in kernels
                                      if k.id in launch})}


def qos_rw_operands(torch, P, g, size, device) -> list:
    """The dense-rw bucket's ``rw_operands`` (operand, JLT) pairs: rows
    drawn from ``g`` in ``rw_rows``, each operand and transform from its
    own seed."""
    from libskylark_tpu_torch import sketch as sk

    rw = []
    for i in range(size["rw_operands"]):
        rows = int(g.integers(*size["rw_rows"]))
        rw.append((make_operand(torch, (rows, size["rw_n"]), 15000 + i,
                                device),
                   sk.JLT(size["rw_n"], size["rw_s"], P.Context(1510 + i))))
    return rw


def profiled_flush(torch, rw, device) -> tuple:
    """Four dense-rw requests held for one :meth:`flush`, twice: the first
    flush captures the bucket's graph, the second, a replay, runs under
    torch.profiler, spans on: (:func:`profiled_flush_checks`' result,
    the two flushes' launches). Fails unless the profiled flush's
    ``serve.flush`` span carries its four requests' ids."""
    from torch.profiler import ProfilerActivity, profile

    from libskylark_tpu_torch import engine, sketch as sk, telemetry

    tele = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        px = engine.MicrobatchExecutor(max_batch=8, linger_us=60_000_000,
                                       device=device)
        try:
            def cohort():
                return [px.submit_sketch(T, A, dimension=sk.ROWWISE)
                        for A, T in (rw[i % len(rw)] for i in range(4))]

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            before = launch_counts()
            pf = cohort()
            px.flush()
            for f in pf:
                f.result(timeout=600)
            hits = engine.stats().hits
            pf = cohort()
            with profile(activities=acts) as prof:
                px.flush()
            launched = qos_launches(before)
            for f in pf:
                f.result(timeout=600)
            check(engine.stats().hits == hits + 1,
                  "the profiled flush was not a replay")
        finally:
            px.shutdown()
    finally:
        telemetry.set_enabled(tele)
    checked = profiled_flush_checks(torch, prof, device)
    checked["profiled"] = "the bucket's second flush, a graph replay"
    spans = [sp for sp in telemetry.finished_spans()
             if sp.name == "serve.flush"]
    check(bool(spans) and len(spans[-1].attrs["request_ids"]) == 4,
          "the profiled flush left no serve.flush span with its "
          "requests' ids")
    return checked, launched


def flush_child(size: dict) -> int:
    """The serve-qos phase's profiled flush on the card, in a process
    whose first profiler session it is: late in a long process,
    torch.profiler loses some or all of a session's device records.
    Prints one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import libskylark_tpu_torch as P

    rw = qos_rw_operands(torch, P, np.random.default_rng(1501), size,
                         "cuda")
    checked, launched = profiled_flush(torch, rw, "cuda")
    print("FLUSH_CHILD " + json.dumps({"profiled_flush": checked,
                                       "launches": launched}), flush=True)
    return 0


def profiled_flush_in_child(size: dict) -> tuple:
    """:func:`flush_child` run at ``size``'s dense-rw bucket: its
    (checks, launches). Fails if the child does."""
    keys = ("rw_rows", "rw_n", "rw_s", "rw_operands")
    run = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--flush-child",
         json.dumps({k: size[k] for k in keys})],
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, "the profiled-flush child failed:\n"
          + (run.stdout + run.stderr)[-3000:])
    line = next(ln for ln in run.stdout.splitlines()
                if ln.startswith("FLUSH_CHILD "))
    report = json.loads(line[len("FLUSH_CHILD "):])
    return report["profiled_flush"], report["launches"]


def serve_qos_phase(torch, P, np, size=QOS_FULL, device="cuda") -> dict:
    """Phase 4b'': the executor's production layer at full width, with
    the lock-order witness on. Cache storm: ``storm`` identical solve
    requests (config 4's bucket) from ``storm_threads`` threads make one
    flush of one B1-batched launch per operand, every other request a
    hit or a coalesced follower, each result its own tensor torch.equal
    to a cache-off executor's; the same bytes under another seed miss.
    Residency: a registered A is uploaded once, ``ref_requests`` submits by
    OperandRef ship none of its bytes and equal their by-value twins, a
    pinned sketch is served with no launch. Deadlines: requests queued
    behind a long flush expire and never launch. DEGRADED: a fault plan
    on ``serve.flush`` degrades the executor (a subscriber sees it),
    best_effort past its class bound is shed, interactive requests are
    served torch.equal to their capacity-1 flush with the cache
    bypassed, and the executor recovers. QoS: interactive and best_effort
    tenants saturate one worker, interactive waits no longer on average;
    a burst-limited tenant is refused exactly past its burst. The adaptive
    controller ticks, keeps its targets in bounds and changes no result.
    One flush is profiled, on the card in a process of its own
    (:func:`flush_child`): its ``serve.flush`` range encloses the
    launches. Fails on any check."""
    import os

    from libskylark_tpu_torch import engine, qos, sketch as sk
    from libskylark_tpu_torch.base import errors, locks
    from libskylark_tpu_torch.engine import serve
    from libskylark_tpu_torch.resilience import faults, health

    cuda = device == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    locks.reset_witness()
    locks.enable_witness(True)
    g = np.random.default_rng(1500)
    n, d, s = size["ls_rows"], size["ls_cols"], size["ls_s"]
    A = g.standard_normal((n, d), dtype=np.float32)
    x0 = g.standard_normal(d, dtype=np.float32)
    b = A @ x0 + 0.1 * g.standard_normal(n, dtype=np.float32)
    T = sk.JLT(n, s, P.Context(1500))
    rw = qos_rw_operands(torch, P, g, size, device)

    def rw_call(ex, i, **kw):
        Ai, Ti = rw[i % len(rw)]
        return ex.submit_sketch(Ti, Ai, dimension=sk.ROWWISE, **kw)

    launches = {k: 0 for k in launch_counts()}
    out = {"card": smi("name,power.limit") if cuda else None,
           "step_seconds": {}}
    executors = []
    t_step = [time.perf_counter()]

    def mark(step):
        now = time.perf_counter()
        out["step_seconds"][step] = now - t_step[0]
        t_step[0] = now

    def executor(**kw):
        ex = engine.MicrobatchExecutor(device=device, **kw)
        executors.append(ex)
        return ex

    try:
        # -- the cache storm -------------------------------------------
        off = executor(max_batch=8, linger_us=5000, cache=False)
        on = executor(max_batch=8, linger_us=5000, cache=True)
        want = off.submit_solve(A, b, T).result(timeout=600)   # warm-up
        futs, t_off = qos_storm(off, lambda ex, i: ex.submit_solve(A, b, T),
                                size["storm"], size["storm_threads"])
        check(all(same(torch, f.result(), want) for f in futs),
              "the cache-off storm's results differ from one another")
        before = launch_counts()
        futs, t_on = qos_storm(on, lambda ex, i: ex.submit_solve(A, b, T),
                               size["storm"], size["storm_threads"])
        storm_launches = qos_launches(before)
        add_launches(launches, storm_launches)
        got = [f.result() for f in futs]
        st = on.stats()
        c = st["cache"]
        resolved = sum(f.done() and f.exception() is None for f in futs)
        storm = {"requests": size["storm"], "completed": resolved,
                 "flushes": st["flushes"], "flushed_lanes": st["completed"],
                 "hits": c["hits"], "coalesced": c["single_flight_coalesced"],
                 "misses": c["misses"], "launches": {
                     k: v for k, v in storm_launches.items() if v},
                 "requests_per_s_cache_on": size["storm"] / t_on,
                 "requests_per_s_cache_off": size["storm"] / t_off,
                 "digest_d2h_bytes": c["digest_d2h_bytes"]}
        check(storm["flushes"] == 1 and resolved == size["storm"]
              and c["hits"] + c["single_flight_coalesced"]
              == size["storm"] - 1 and c["misses"] == 1,
              f"cache storm: {storm}")
        kernel_launches = {k: v for k, v in storm_launches.items() if v}
        check(kernel_launches == ({"dense_batched_columnwise": 2} if cuda
                                  else {}),
              f"cache storm launched {kernel_launches}, not one "
              "B1-batched launch per operand")
        check(all(same(torch, x, want) for x in got),
              "a storm result differs from the cache-off executor's")
        ptrs = {x.data_ptr() for x in got}
        check(len(ptrs) == len(got),
              "two storm results share one tensor")
        got[0].add_(1.0)
        late = on.submit_solve(A, b, T).result(timeout=600)
        check(same(torch, late, want) and late.data_ptr() not in ptrs,
              "mutating a served result reached a later hit")
        T2 = sk.JLT(n, s, P.Context(1501))
        misses = on.stats()["cache"]["misses"]
        on.submit_solve(A, b, T2).result(timeout=600)
        check(on.stats()["cache"]["misses"] == misses + 1,
              "the same bytes under another seed did not miss")
        out["storm"] = storm
        mark("setup_and_storm")

        # -- residency ---------------------------------------------------
        key = repr(on._prepare("solve_l2_sketched", A=A, B=b,
                               transform=T)[0])
        bs = [A @ g.standard_normal(d, dtype=np.float32)
              + 0.1 * g.standard_normal(n, dtype=np.float32)
              for _ in range(size["ref_requests"])]
        h0 = on.stats()["by_bucket"][key]["h2d_bytes_by_operand"]
        ref = on.register_operand(A)
        res = on.stats()["cache"]["residency"]
        check(res["uploads"] == 1 and res["upload_bytes"] == A.nbytes,
              f"register_operand uploaded {res}, not A once")
        before = launch_counts()
        by_ref, _ = qos_storm(on, lambda ex, i: ex.submit_solve(ref, bs[i], T),
                              len(bs), size["storm_threads"])
        by_ref = [f.result(timeout=600) for f in by_ref]
        add_launches(launches, qos_launches(before))
        h1 = on.stats()["by_bucket"][key]["h2d_bytes_by_operand"]
        shipped_a = h1["A"] - h0["A"]
        by_value = [f.result(timeout=600) for f in
                    [off.submit_solve(A, bi, T) for bi in bs]]
        check(all(same(torch, x, y) for x, y in zip(by_ref, by_value)),
              "a submit by OperandRef differs from its by-value twin")
        check(shipped_a == 0, f"submits by OperandRef shipped {shipped_a} "
                              "bytes of A host→device")
        off_bucket = off.stats()["by_bucket"][key]
        Tsk = sk.JLT(n, s, P.Context(1502))
        before = launch_counts()
        sref = on.register_operand(A, transform=Tsk,
                                   dimension=sk.COLUMNWISE)
        add_launches(launches, qos_launches(before))
        check(sref == ref, "registering A again gave another digest")
        before = launch_counts()
        pinned = on.submit_sketch(Tsk, ref, dimension=sk.COLUMNWISE
                                  ).result(timeout=600)
        pinned_launches = {k: v for k, v in qos_launches(before).items()
                           if v}
        check(not pinned_launches,
              f"a pinned sketch launched {pinned_launches}")
        check(same(torch, pinned, off.submit_sketch(
            Tsk, A, dimension=sk.COLUMNWISE).result(timeout=600)),
            "the pinned sketch differs from a by-value sketch")
        out["residency"] = {
            "requests": size["ref_requests"], "a_bytes_shipped": shipped_a,
            "b_bytes_shipped": h1["B"] - h0["B"],
            "h2d_bytes_saved": size["ref_requests"] * A.nbytes,
            "by_value_h2d_bytes_per_flush":
                off_bucket["h2d_bytes_per_flush"],
            "residency": on.stats()["cache"]["residency"],
            "digest_d2h_bytes": on.stats()["cache"]["digest_d2h_bytes"]}
        check(out["residency"]["digest_d2h_bytes"] == 0,
              "a digest copied bytes off the card")
        on.unregister_operand(ref)
        on._cache.clear()
        mark("residency")
        del got, futs, by_ref, by_value, pinned, late, want

        # -- deadlines ---------------------------------------------------
        dl = executor(max_batch=8, linger_us=1000, workers=1)
        xs = [A @ g.standard_normal(d, dtype=np.float32) for _ in range(8)]
        before = launch_counts()
        slow = [dl.submit_solve(A, xi, T) for xi in xs]
        late = [rw_call(dl, i, deadline=size["deadline_s"])
                for i in range(size["deadline_requests"])]
        for f in slow + late:
            f.exception(timeout=600)
        dl_launches = qos_launches(before)
        add_launches(launches, dl_launches)
        dst = dl.stats()
        expired = sum(isinstance(f.exception(), serve.ServeOverloadedError)
                      for f in late)
        check(expired == size["deadline_requests"]
              and dst["expired"] == expired
              and all(f.exception() is None for f in slow),
              f"deadlines: {expired} of {len(late)} expired, stats "
              f"{dst['expired']}")
        flushed = {k: v for k, v in dl_launches.items() if v}
        check(flushed == ({"dense_batched_columnwise": 2} if cuda else {})
              and dst["flushes"] == 1 and dst["completed"] == len(slow),
              f"deadlines: launches {flushed}, flushes {dst['flushes']}: "
              "an expired request launched")
        out["deadlines"] = {"requests": len(late), "expired": expired,
                            "deadline_s": size["deadline_s"],
                            "flushes": dst["flushes"]}
        del xs, slow, late
        mark("deadlines")

        # -- DEGRADED ----------------------------------------------------
        reg = qos.TenantRegistry()
        reg.register("ui", qos.INTERACTIVE)
        reg.register("bulk", qos.BEST_EFFORT)
        deg = executor(max_batch=8, linger_us=60_000_000,
                       max_queue=size["max_queue"], cache=True, tenants=reg)
        one = executor(max_batch=1, linger_us=0)
        seen = []
        unsubscribe = health.subscribe(
            lambda src, old, new: seen.append((old, new)) if src is deg
            else None)
        plan = {"seed": 1, "faults": [{"site": "serve.flush",
                                       "error": "IOError_", "tag": "fail"}]}
        before = launch_counts()
        try:
            with faults.fault_plan(plan) as fp:
                with faults.tag("fail"):
                    for i in range(size["degrade_failures"]):
                        f = rw_call(deg, i, tenant="ui")
                        deg.flush()
                        check(qos_outcome(f) == "IOError_",
                              f"a faulted flush gave {qos_outcome(f)}")
                fired = len(fp.fired)
            fault_launches = {k: v for k, v in qos_launches(before).items()
                              if v}
            check(not fault_launches,
                  f"a flush failed by the fault plan launched "
                  f"{fault_launches}")
            check(deg.state == serve.DEGRADED
                  and ("SERVING", "DEGRADED") in seen,
                  f"state {deg.state}, transitions {seen}")
            cache0 = deg.stats()["cache"]
            bound = deg._class_shed_bound(qos.BEST_EFFORT)
            best = [rw_call(deg, i, tenant="bulk") for i in range(bound)]
            shed = 0
            for i in range(2):
                try:
                    rw_call(deg, i, tenant="bulk")
                except serve.ServeOverloadedError:
                    shed += 1
            check(shed == 2, f"best_effort past its bound {bound}: {shed} "
                             "of 2 shed")
            # the last one repeats the first: no cache, so both flush
            picks = [0, 1, 2, 3, 0]
            inter = [rw_call(deg, i, tenant="ui") for i in picks]
            before = launch_counts()
            deg.flush()
            add_launches(launches, qos_launches(before))
            check(all(qos_outcome(f) == "ok" for f in best + inter),
                  "a request admitted while DEGRADED failed")
            for i, f in zip(picks, inter):
                check(same(torch, f.result(), rw_call(one, i).result(600)),
                      "an interactive request served while DEGRADED "
                      "differs from its capacity-1 flush")
            cache1 = deg.stats()["cache"]
            check(all(cache1[k] == cache0[k] for k in (
                "hits", "misses", "single_flight_coalesced", "insertions")),
                f"the cache was consulted while DEGRADED: {cache0} → "
                f"{cache1}")
            recovered = 0
            while deg.state == serve.DEGRADED and recovered < 32:
                before = launch_counts()
                rw_call(deg, recovered, tenant="ui")
                deg.flush()
                add_launches(launches, qos_launches(before))
                recovered += 1
            check(deg.state == serve.SERVING
                  and seen[-1] == ("DEGRADED", "SERVING"),
                  f"after the plan: state {deg.state}, transitions {seen}")
        finally:
            unsubscribe()
        dstats = deg.stats()
        out["degraded"] = {"fired": fired, "transitions": seen,
                           "best_effort_bound": bound, "shed": shed,
                           "served_while_degraded": len(best + inter),
                           "flushes_to_recover": recovered,
                           "qos": {c: {k: v for k, v in blk.items()
                                       if k in ("admitted", "shed")}
                                   for c, blk in
                                   dstats["qos"]["by_class"].items()}}
        mark("degraded")

        # -- QoS: two tenants on one worker, and a rate limit -------------
        qx = executor(max_batch=8, linger_us=2000, workers=1, tenants=reg)
        per = size["qos_requests"]

        def tenant_call(ex, i):
            return rw_call(ex, i // 2, tenant="ui" if i % 2 else "bulk")

        # one solve request's flush, stalled ``hold_s`` at its fault site,
        # holds the one worker while both tenants queue: the tenants
        # submit once it has left the queue (one request, so no linger
        # can split it into two cohorts). The check's premise is
        # asserted, not assumed: every request of both tenants is queued
        # while the hold still runs. Then the scheduler must start every interactive cohort
        # before any best_effort one (deficit round robin at weights 8:1,
        # a quantum of max_batch: one round's credit covers interactive's
        # whole queue), the order in which it charges cohorts, which no
        # submission timing moves. Each tenant submits from its own
        # thread, so the classes' mean waits also follow which thread ran
        # ahead; they are reported, not compared.
        hold = {"faults": [{"site": "serve.flush", "tag": "hold",
                            "stall_s": size["hold_s"]}]}
        started, charge = [], qx._sched.charge

        def charged(cls, n):
            started.append(cls)
            charge(cls, n)

        def all_queued(futs):
            st = qx.stats()
            check(st["queued"] == 2 * per
                  and not any(f.done() for f in block + futs),
                  f"QoS: {st['queued']} of {2 * per} requests queued when "
                  f"the storm's submissions ended, the hold "
                  f"{'over' if any(f.done() for f in block) else 'running'}")

        before = launch_counts()
        with faults.fault_plan(hold):
            with faults.tag("hold"):
                block = [qx.submit_solve(A, bs[0], T)]
            t_end = time.perf_counter() + 60
            while qx.stats()["queued"] and time.perf_counter() < t_end:
                time.sleep(0.001)
            qx._sched.charge = charged
            try:
                futs, t_qos = qos_storm(qx, tenant_call, 2 * per, 2,
                                        all_queued)
            finally:
                qx._sched.charge = charge
            for f in block:
                f.result(timeout=600)
        add_launches(launches, qos_launches(before))
        check(all(qos_outcome(f) == "ok" for f in futs),
              "a QoS storm request failed")
        check(sorted(set(started)) == ["best_effort", "interactive"]
              and "interactive" not in started[started.index("best_effort"):],
              f"QoS: cohorts started in class order {started}")
        qb = qx.stats()["qos"]["by_class"]
        reg.register("capped", qos.STANDARD, rate=1e-6,
                     burst=size["burst"])
        refused, admitted = 0, []
        before = launch_counts()
        for i in range(size["rate_requests"]):
            try:
                admitted.append(rw_call(qx, i, tenant="capped"))
            except errors.TenantQuotaError:
                refused += 1
        for f in admitted:
            f.result(timeout=600)
        add_launches(launches, qos_launches(before))
        check(refused == size["rate_requests"] - size["burst"]
              and qx.stats()["qos"]["by_class"]["standard"]["rate_limited"]
              == refused,
              f"{refused} of {size['rate_requests']} refused past a burst of "
              f"{size['burst']}")
        out["qos"] = {
            "requests": 2 * per, "seconds": t_qos,
            "by_class": {c: {"queue_wait_mean_ms": 1e3 * (
                qb[c]["queue_wait_s"]["mean"] or 0.0),
                "latency_p50_ms": 1e3 * (qb[c]["latency_s"]["p50"] or 0.0),
                "latency_p99_ms": 1e3 * (qb[c]["latency_s"]["p99"] or 0.0)}
                for c in ("interactive", "best_effort")},
            "rate_limited": refused, "burst": size["burst"],
            "started": started,
            "scheduler": qx.stats()["qos"]["scheduler"]}
        mark("qos")

        # -- the adaptive controller --------------------------------------
        saved = os.environ.get("SKYLARK_QOS_ADAPT_INTERVAL")
        os.environ["SKYLARK_QOS_ADAPT_INTERVAL"] = str(
            size["adapt_interval_s"])
        try:
            ad = executor(max_batch=8, linger_us=2000, adaptive=True)
        finally:
            if saved is None:
                del os.environ["SKYLARK_QOS_ADAPT_INTERVAL"]
            else:
                os.environ["SKYLARK_QOS_ADAPT_INTERVAL"] = saved
        before = launch_counts()
        futs, _ = qos_storm(ad, rw_call, size["adaptive_requests"], 4)
        add_launches(launches, qos_launches(before))
        t_end = time.perf_counter() + 10 * size["adapt_interval_s"] + 5
        while (ad._controller.stats()["ticks"] < 1
               and time.perf_counter() < t_end):
            time.sleep(size["adapt_interval_s"])
        cstats = ad._controller.stats()
        check(cstats["ticks"] >= 1, "the adaptive controller never ticked")
        targets = {}
        for statics in ad.qos_bucket_obs():
            linger, cap = ad.bucket_targets(statics)
            targets[statics[0]] = (linger, cap)
            check(0.0 <= linger <= 8 * ad.linger + 1e-12
                  and 1 <= cap <= ad.max_batch,
                  f"adaptive targets out of bounds: {linger}, {cap}")
        for i, f in enumerate(futs):
            check(same(torch, f.result(), rw_call(one, i).result(600)),
                  "a result under the adaptive controller differs from "
                  "its capacity-1 flush")
        out["adaptive"] = {"controller": cstats, "targets": targets}
        mark("adaptive")

        # -- one profiled flush, spans on --------------------------------
        if cuda:
            out["profiled_flush"], flushed = profiled_flush_in_child(size)
        else:
            out["profiled_flush"], flushed = profiled_flush(torch, rw,
                                                            device)
        add_launches(launches, flushed)
        mark("profiled_flush")
        stats = {"serve": serve.serve_stats(), "qos": serve.qos_stats(),
                 "cache": serve.cache_stats()}
        check(stats["serve"]["executors"] >= len(executors)
              and stats["cache"]["caches"] >= 2,
              "serve_stats/cache_stats missed an executor")
        out["stats"] = {
            "serve": {k: stats["serve"][k] for k in (
                "executors", "submitted", "completed", "failed", "shed",
                "expired", "flushes", "states")},
            "qos": stats["qos"]["by_class"],
            "cache": {k: stats["cache"][k] for k in (
                "hits", "misses", "single_flight_coalesced", "bytes_saved",
                "digest_d2h_bytes", "residency")}}
        locks.check_witness()
        out["lock_witness"] = {k: v for k, v in
                               locks.witness_report().items()
                               if k != "violations"}
    finally:
        locks.enable_witness(False)
        for ex in executors:
            if ex._cache is not None:
                ex._cache.clear()
            for dg in ex.resident_operands():
                ex.unregister_operand(dg)
            ex.shutdown()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del executors, rw, A
        release_cache(torch)
    emit("serve_qos", **out)
    return out


def serve_qos_cells(torch, P, np) -> dict:
    """The cache and residency cells of config 4's serve-solve-jlt bucket
    (65,536 × 512 host operands, s = 2048), each a :func:`flush_cell` row
    or like one: ``solve-jlt-hit``, one request served from the cache
    (submit to result: its digest of the host operand, the lookup and the
    clone; ``device_ms`` the clone's); ``solve-jlt-resident``, a
    capacity-8 flush of 8 submits by OperandRef (one resident A, 8 b's);
    ``solve-jlt-by-value``, the same flush with A passed by value from
    the host, each lane shipping A. Each row carries its flush's H2D
    bytes."""
    from torch.profiler import ProfilerActivity, profile

    from libskylark_tpu_torch import engine, sketch as sk
    from libskylark_tpu_torch.engine import serve

    size = QOS_FULL
    g = np.random.default_rng(1600)
    n, d, s = size["ls_rows"], size["ls_cols"], size["ls_s"]
    A = g.standard_normal((n, d), dtype=np.float32)
    bs = [A @ g.standard_normal(d, dtype=np.float32)
          + 0.1 * g.standard_normal(n, dtype=np.float32) for _ in range(8)]
    T = sk.JLT(n, s, P.Context(1600))
    cells = {}
    with engine.MicrobatchExecutor(max_batch=16, linger_us=60_000_000,
                                   cache=True, device="cuda") as ex:
        f = ex.submit_solve(A, bs[0], T)
        ex.flush()
        f.result()

        def hit():
            return ex.submit_solve(A, bs[0], T).result()

        warm = [0.0] * 7
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hit()
            warm[i] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hit()
        device = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        # the digest alone: derive_request and blake2b over the request
        kw = {"A": A, "B": bs[0], "transform": T}
        t0 = time.perf_counter()
        serve.request_digest("solve_l2_sketched", serve.derive_request(
            "solve_l2_sketched", **kw), kw)
        digest_ms = (time.perf_counter() - t0) * 1e3
        st = ex.stats()["cache"]
        cells["solve-jlt-hit"] = {
            "warm_ms": statistics.median(warm[2:]), "device_ms": device,
            "busy": device / statistics.median(warm[2:]),
            "hits": st["hits"], "digest_d2h_bytes": st["digest_d2h_bytes"],
            "digest_ms": digest_ms}
        ex._cache.clear()
    with engine.MicrobatchExecutor(max_batch=16, linger_us=60_000_000,
                                   device="cuda") as ex:
        ref = ex.register_operand(A)
        key = repr(ex._prepare("solve_l2_sketched", A=A, B=bs[0],
                               transform=T)[0])
        for name, arg in (("solve-jlt-resident", ref),
                          ("solve-jlt-by-value", A)):
            before = ex.stats()["by_bucket"].get(key, {}).get(
                "h2d_bytes_by_operand", {})
            flushes0 = ex.stats()["by_bucket"].get(key, {}).get("flushes", 0)
            row = flush_cell(torch, ex, bs, call=lambda e, b, a=arg:
                             e.submit_solve(a, b, T))
            after = ex.stats()["by_bucket"][key]
            flushes = after["flushes"] - flushes0
            row["h2d_bytes_per_flush"] = {
                k: (v - before.get(k, 0)) / flushes
                for k, v in after["h2d_bytes_by_operand"].items()}
            cells[name] = row
        ex.unregister_operand(ref)
    del A, bs
    release_cache(torch)
    return cells


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


# ---------------------------------------------------------------------------
# Phase 4e (a3): the rest of the single-card ML and NLA
# ---------------------------------------------------------------------------

# The a3 phase's sizes. Matern features at config 3's shape (l = σ of its
# GaussianRFT, √d); Block-ADMM on Matern(784, ν = 1.5) at config 5 (the
# ml phase's data and settings, l = that phase's σ); krank on config 4's
# 8192² SVD operand shape with a gap at the rank; randlobpcg on the
# least-squares operand; an R-MAT graph of Graph500's generator at scale
# 18 and edge factor 4 (SNAP com-DBLP's size, the kind of graph that
# TD-PPR community detection runs on); the block solvers on the Gaussian
# Gram matrix of ml-rlsc-faster's 16,384 rows.
A3_FULL = {"rft_rows": 16384, "rft_d": 4096, "rft_s": 4096,
           "gram_rows": 512, "nus": (0.5, 1.5, 2.5),
           "gamma_n": 100000,
           "gamma_shapes": (0.3, 0.5, 1.0, 1.5, 2.5, 10.0),
           "admm": ML_FULL, "admm_nu": 1.5,
           "krank_n": 8192, "krank_r": 512, "rank": 64,
           "adaptive_eps": 0.5, "adaptive_r": 10, "adaptive_iters": 200,
           "ls_rows": 65536, "ls_cols": 512, "evd_k": 10,
           "graph_scale": 18, "graph_edge_factor": 4,
           "dense_sub": 2048, "serve_sub": 4096, "cluster_seeds": 3,
           "ase_k": 6, "block_rows": 16384, "fcg_tolerance": 1e-5,
           "fcg_iter_lim": 500}
# limits of the a3 phase, each with its reason
A3_LIMITS = {
    # Gamma on the card against the CPU route: an element whose accept
    # test (a backend-rounded log) flips takes another draw, an unrelated
    # sample more than 1e-2 relative off; at most one in 10^4 samples
    # may, and the rest agree within 1e-5 relative times their condition
    # factor (gamma_condition; ROADMAP C2)
    "gamma_flips_per_sample": 1e-4, "gamma_flip_rel": 1e-2,
    "gamma_rel": 1e-5,
    # the Monte-Carlo Gram limits of the feature maps (PERF.md §2)
    "gram_max": 0.1, "gram_mean": 0.02,
    # the ml phase's ADMM limits
    "admm_coef": 1e-3, "admm_objective": 1e-4,
    # krank: σ and λ within 1e-3 of the operand's, reconstruction within
    # 1.01 × the optimal tail + 1e-4 (the main path's SVD limits)
    "sigma_rel": 1e-3, "recon_factor": 1.01, "recon_add": 1e-4,
    # the port against the same algorithm replayed in float64 from the
    # same random draws
    "replay_rel": 1e-3,
    # LOBPCG's eigenvalues are Ritz values, at most σ² but for float32
    # rounding; its 20 float32 iterations stopped 0.09-1.5% short of σ²
    # over 15 seeds on the H100 (chip_profile.py --lobpcg-seeds 5), and
    # are held to 5%
    "ritz_excess": 1e-5, "lobpcg_reach": 5e-2,
    # a sketch made on the card against the same sketch made by an
    # independent route (the check phase's kernel limit)
    "sketch_rel": 1e-4, "ase_rel": 1e-3, "serve_rel": 1e-4,
    "block_rel": 1e-3,
}
# the krank operand's spectrum: 64 values from 1 down to 0.51, then a gap
# to 0.05·0.95^j (ROADMAP C8: the 1e-3 limit needs a spectral gap at the
# rank)
A3_GAP = (0.05, 0.95)
# the kernels the a3 phase must launch
A3_KERNELS = ("dense_rowwise_cos", "fastfood", "dense_rowwise",
              "dense_columnwise", "hash_columnwise")


def gamma_condition(torch, np, key, a: float, scale: float, want, start=0):
    """The condition factor of each Gamma(a, scale) sample of the stream
    under ``key`` from element ``start`` on, ``want`` its values: max(1,
    1/(4v)). A sample is d·v³ (times the boost (1 − U)^(1/a) when a < 1),
    v = 1 + c·x with x the element's normal draw; two routes compute x a
    few ulp apart, and where v is small the sum cancels, so the relative
    error of v³ grows as 3·|c·x|/v. Below v = 1/4 the 1e-5 limit scales
    by 1/(4v). V = sample/(scale·d·boost), with the boost made from the
    element's own key as the sampler makes it."""
    from libskylark_tpu_torch.base import randgen, threefry as tf

    want = np.asarray(want, np.float64)
    n = want.size
    boosted = a < 1
    d = (a + 1 if boosted else a) - 1.0 / 3.0
    boost = np.ones(n)
    if boosted:
        L = randgen.CHUNK
        c0, c1 = start // L, -(-(start + n) // L)
        ck = torch.from_numpy(
            randgen.chunk_keys(key, c0, c1 - c0).astype(np.int64))
        x0, x1 = tf.threefry2x32(ck[:, :1], ck[:, 1:], 0,
                                 torch.arange(L, dtype=torch.int64))
        _, sub = randgen.split_keys(
            torch.stack([x0.reshape(-1), x1.reshape(-1)], 1))
        u = 1.0 - randgen._scalar_uniform(sub).double().numpy()
        boost = (u ** (1.0 / a))[start - c0 * L:start - c0 * L + n]
    v = np.cbrt(np.maximum(want / (scale * d * boost), 0.0))
    return np.maximum(1.0, 1.0 / np.maximum(4.0 * v, 1e-30))


def a3_generator(torch, seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def a3_matern_operand(torch, size, device):
    """Config 3's X (rft_rows × rft_d), seed 12."""
    return torch.randn((size["rft_rows"], size["rft_d"]),
                       generator=a3_generator(torch, 12, device),
                       device=device)


def a3_krank_operand(torch, size, device):
    """krank's operand U0·diag(σ)·V0ᵀ (krank_n², rank krank_r): σ from 1
    down to 0.51 over the first ``rank`` values, then A3_GAP's decay;
    (A, U0, σ)."""
    n, r, k = size["krank_n"], size["krank_r"], size["rank"]
    g = a3_generator(torch, 2, device)
    U0 = torch.linalg.qr(torch.randn(n, r, generator=g, device=device))[0]
    V0 = torch.linalg.qr(torch.randn(n, r, generator=g, device=device))[0]
    i = torch.arange(r, device=device, dtype=torch.float32)
    sigma = torch.where(i < k, 1.0 - i / (2 * k),
                        A3_GAP[0] * A3_GAP[1] ** (i - k))
    return (U0 * sigma) @ V0.T, U0, sigma


def a3_lobpcg_operand(torch, size, device):
    """The least-squares operand (ls_rows × ls_cols, seed 3: on the card
    ls_operands' A)."""
    return torch.randn((size["ls_rows"], size["ls_cols"]),
                       generator=a3_generator(torch, 3, device),
                       device=device)


def a3_graph(ml, np, size):
    """The R-MAT graph (Graph500's probabilities, seed 750) built by
    add_edge as skylark_graph_se does; (G, generated edges, seconds the
    build took)."""
    src, dst = rmat_edges(np, size["graph_scale"], size["graph_edge_factor"],
                          (0.57, 0.19, 0.19, 0.05), 750)
    t0 = time.perf_counter()
    G = ml.Graph()
    for u, v in zip(src.tolist(), dst.tolist()):
        G.add_edge(u, v)
    return G, len(src), time.perf_counter() - t0


def a3_block_system(torch, ml, size, device):
    """The block solvers' K + λI (λ = 1), K the Gaussian Gram of the
    first block_rows rows of the ml data, and the one-hot class columns;
    (K + λI, B)."""
    asz = size["admm"]
    X, y, _, _ = ml_data(torch, asz, device)
    nb = size["block_rows"]
    K = ml_kernel(ml, asz).gram(X[:nb], device=device)
    K.diagonal().add_(1.0)
    return K, torch.nn.functional.one_hot(y[:nb], asz["classes"]).float()


def a3_limit(value, limit) -> dict:
    return {"value": value, "limit": limit, "ok": bool(value <= limit)}


def rmat_edges(np, scale: int, edge_factor: int, abcd, seed: int):
    """Graph500's Kronecker (R-MAT) generator: edge_factor·2^scale edges,
    each endpoint pair chosen bit by bit from the quadrants (a, b, c, d),
    then the vertex ids permuted; (src, dst) int64, with the duplicates
    and self-loops the generator makes."""
    rng = np.random.default_rng(seed)
    m = edge_factor << scale
    a, b, c, _ = abcd
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(scale):
        u = rng.random(m)
        right = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        down = u >= a + b
        src |= down.astype(np.int64) << level
        dst |= right.astype(np.int64) << level
    perm = rng.permutation(1 << scale)
    return perm[src], perm[dst]


def induced_subgraph(ml, G, count: int):
    """The subgraph of G induced on its first ``count`` vertices, edges
    added in G's order."""
    keep = G.vertices[:count]
    inside = set(keep)
    H = ml.Graph()
    for u in keep:
        for v in G.neighbors(u):
            if v in inside:
                H.add_edge(u, v)
    return H


def align_signs(torch, X, ref):
    """X's columns with the signs that best match ref's."""
    s = torch.sign((X * ref).sum(0))
    return X * torch.where(s == 0, torch.ones_like(s), s)


def ase_replay(torch, A64, S64, k, iters):
    """approximate_symmetric_svd's algorithm in float64 from the JLT's
    operator S (k' × n): Q = orth(A·Sᵀ), ``iters`` rounds of Q =
    orth(A·Q), the Rayleigh–Ritz eigenpairs of QᵀAQ, the k of largest
    |λ|; X = V·√|λ|."""
    Q = torch.linalg.qr(A64 @ S64.T.contiguous())[0]
    for _ in range(iters):
        Q = torch.linalg.qr(A64 @ Q)[0]
    G = Q.T @ (A64 @ Q)
    w, Z = torch.linalg.eigh(0.5 * (G + G.T))
    order = torch.argsort(-w.abs())[:k]
    return (Q @ Z[:, order]) * w[order].abs().sqrt()[None, :], w[order]


def conductance(G, cluster) -> float:
    """cut(S)/min(vol(S), vol(G) − vol(S)), as find_local_cluster
    computes it (1 for an empty side)."""
    vol = sum(G.degree(v) for v in cluster)
    cut = sum(1 for v in cluster for u in G.neighbors(v) if u not in cluster)
    denom = min(vol, G.num_edges() - vol)
    return cut / denom if denom > 0 else 1.0


def a3_launch_checks(out) -> None:
    """Every step launched exactly its kernels: B1-cos for each MaternRFT
    apply and ADMM's maps, B4 for each FastMaternRFT apply, B2-cw and
    B1-cw once per LOBPCG sketch, B1-rw for the power-iteration EVD's
    sketch and the dense ASE; nothing elsewhere (the krank test matrices
    are stored, the sparse ASE runs spmm, the host steps launch
    nothing)."""
    size = out["size"]
    P4 = size["admm"]["partitions"]
    want = {}
    for nu in size["nus"]:
        want[f"matern_rft_{nu}"] = {"dense_rowwise_cos": 1}
        want[f"fast_matern_{nu}"] = {"fastfood": 1}
    want["admm_matern_train"] = {
        "dense_rowwise_cos": P4 * (1 + size["admm"]["admm_iters"])}
    want["admm_matern_predict"] = {"dense_rowwise_cos": P4}
    want["lobpcg_cwt"] = {"hash_columnwise": 1}
    want["lobpcg_jlt"] = {"dense_columnwise": 1}
    want["power_evd"] = {"dense_rowwise": 1}
    want["graph_ase_dense"] = {"dense_rowwise": 1}
    got = {k: v for k, v in out["launches_by_step"].items() if v}
    check(got == want, f"a3 path launches {got}, expected {want}")
    for k_ in A3_KERNELS:
        check(out["launches"][k_] > 0,
              f"kernel {k_} never launched on the a3 path")


def a3_phase(torch, P, np, size=A3_FULL, device="cuda") -> dict:
    """Phase 4e: the a3 slice on one card through the public entry
    points, each step's launches read (counters set to 0 before the
    phase), the phase's own peak memory; comparisons run outside the
    steps."""
    import contextlib
    import io as stdio
    import warnings

    from libskylark_tpu_torch import algorithms, ml, nla, sketch as sk
    from libskylark_tpu_torch.algorithms import asynch, krylov, prox
    from libskylark_tpu_torch.base import randgen, sparse as bs
    from libskylark_tpu_torch.base.context import seed_key
    from libskylark_tpu_torch.sketch import cuda_dense as cd, cuda_hash
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    for c in counters() + [bs.products]:
        for k in c:
            c[k] = 0
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"size": {k: v for k, v in size.items()}, "launches_by_step": {},
           "step_seconds": {}, "checks": {}, "recorded": {}}
    lim = A3_LIMITS
    sync = torch.cuda.synchronize if on_card else (lambda: None)

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

    def gen(seed):
        return a3_generator(torch, seed, device)

    # 1. Gamma on the card against the CPU route: a flip is a sample more
    # than 1e-2 relative off (an unrelated draw); every other sample is
    # held within 1e-5 relative times its condition factor
    flips, worst, worst_plain = {}, 0.0, 0.0
    for i, a in enumerate(size["gamma_shapes"]):
        key = P.Context(700 + i).allocate().key
        dist = randgen.Gamma(shape_param=a, scale=2.0)
        got = step(f"gamma_{a}", lambda: randgen.stream_slice(
            key, dist, 0, size["gamma_n"], device=device)).cpu().double()
        want = randgen.stream_slice(key, dist, 0, size["gamma_n"],
                                    device="cpu").double()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-300)).numpy()
        flipped = rel > lim["gamma_flip_rel"]
        cond = gamma_condition(torch, np, key, a, 2.0, want.numpy())
        flips[a] = int(flipped.sum())
        worst = max(worst, float((rel / cond)[~flipped].max()))
        worst_plain = max(worst_plain, float(rel[~flipped].max()))
    out["recorded"]["gamma_flips"] = flips
    out["recorded"]["gamma_unflipped_max_rel"] = worst_plain
    out["checks"]["gamma_flips"] = a3_limit(
        max(flips.values()) / size["gamma_n"],
        lim["gamma_flips_per_sample"])
    out["checks"]["gamma_unflipped_rel_over_condition"] = a3_limit(
        worst, lim["gamma_rel"])

    # 2. Matern features at config 3's shape, each held to its kernel's
    # Gram matrix on sampled rows
    m, d, s = size["rft_rows"], size["rft_d"], size["rft_s"]
    X = a3_matern_operand(torch, size, device)
    rows = torch.randperm(m, generator=gen(13), device=device)[
        :size["gram_rows"]]
    Xr = X[rows].double()
    for j, nu in enumerate(size["nus"]):
        kern = ml.Matern(d, nu=nu, l=math.sqrt(d))
        K = kern.gram(Xr, device=device)
        top = float(K.abs().max())
        for tag, name in (("regular", f"matern_rft_{nu}"),
                          ("fast", f"fast_matern_{nu}")):
            T = kern.create_rft(s, P.Context(710 + 2 * j
                                             + (tag == "fast")), tag)
            Z = step(name, lambda: T.apply(X, sk.ROWWISE, device=device))
            check(tuple(Z.shape) == (m, s) and bool(torch.isfinite(Z).all()),
                  f"{name} output")
            Zs = Z[rows].double()
            err = (Zs @ Zs.T - K).abs()
            out["checks"][f"{name}_gram_max"] = a3_limit(
                float(err.max()) / top, lim["gram_max"])
            out["checks"][f"{name}_gram_mean"] = a3_limit(
                float(err.mean()) / top, lim["gram_mean"])
            del Z, Zs
    del X, Xr

    # 3. Block-ADMM on a Matern kernel at config 5: the ml phase's
    # settings, its kernel swapped; the same maps on their plain route
    asz = size["admm"]
    Xa, ya, Xte, yte = ml_data(torch, asz, device)
    kern = ml.Matern(asz["d"], nu=size["admm_nu"],
                     l=math.sqrt(asz["latent"] * asz["d"]))
    solver = ml.BlockADMMSolver.from_kernel(
        P.Context(720), prox.HingeLoss(), prox.L2Regularizer(), ADMM_LAM,
        asz["s"], kern, num_partitions=asz["partitions"])
    plain = ml.BlockADMMSolver.with_maps(
        prox.HingeLoss(), prox.L2Regularizer(),
        [PlainMap(torch, T) for T in solver.feature_maps], ADMM_LAM)
    objectives, models = {}, {}
    for name, sv in (("admm_matern_train", solver), ("plain", plain)):
        sv.maxiter, sv.tol = asz["admm_iters"], 0.0
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            train = lambda: sv.train(Xa, ya, verbose=True,  # noqa: E731
                                     device=device)
            models[name] = (step(name, train) if name != "plain"
                            else train())
        objectives[name] = [float(ln.split()[3])
                            for ln in buf.getvalue().splitlines()]
    model, pmodel = models["admm_matern_train"], models["plain"]
    check(len(objectives["plain"]) == asz["admm_iters"],
          "ADMM printed the wrong number of objectives")
    out["checks"]["admm_matern_coef"] = a3_limit(
        float((model.coef - pmodel.coef).abs().max()
              / pmodel.coef.abs().max()), lim["admm_coef"])
    out["checks"]["admm_matern_objective"] = a3_limit(
        max(abs(a - b) / abs(b) for a, b in zip(
            objectives["admm_matern_train"], objectives["plain"])),
        lim["admm_objective"])
    labels, _ = step("admm_matern_predict", lambda: model.predict(Xte))
    acc = ml.classification_accuracy(labels, yte)
    out["recorded"]["admm_matern_accuracy"] = acc
    out["checks"]["admm_matern_accuracy"] = {
        "value": acc, "limit": f"> {5 * 100.0 / asz['classes']}",
        "ok": acc > 5 * 100.0 / asz["classes"]}
    del Xa, ya, Xte, yte, model, pmodel, solver, plain

    # 4. krank on an 8192² operand of rank 512 with a gap at rank 64
    k = size["rank"]
    A, U0, sigma = a3_krank_operand(torch, size, device)
    normA = float(torch.linalg.norm(sigma.double()))
    tail = float(torch.linalg.norm(sigma[k:].double())) / normA
    s_k = 2 * k

    def svd_checks(name, U, S, Vt, recon=True):
        kk = min(k, S.shape[0])
        out["checks"][f"{name}_sigma"] = a3_limit(float(
            ((S[:kk] - sigma[:kk]).abs() / sigma[:kk]).max()),
            lim["sigma_rel"])
        if recon:
            rec = float(torch.linalg.norm(A - (U[:, :kk] * S[:kk])
                                          @ Vt[:kk])) / normA
            out["checks"][f"{name}_recon"] = a3_limit(
                rec, lim["recon_factor"] * tail + lim["recon_add"])

    finders = (("generic", {"s": s_k}),
               ("power_iteration", {"s": s_k, "q": 2}),
               ("subspace_iteration", {"s": s_k, "q": 2}),
               ("fast_generic", {"s": s_k}),
               ("adaptive", {"epsilon": size["adaptive_eps"],
                             "r": size["adaptive_r"],
                             "max_iters": size["adaptive_iters"]}))
    Qs = {}
    for j, (method, prm) in enumerate(finders):
        Q = step(f"krank_{method}", lambda: nla.RandomizedRangeFinder(
            A, method, prm, P.Context(730 + j), device=device).compute())
        Qs[method] = Q
        orth = float((Q.T @ Q - torch.eye(Q.shape[1], device=device))
                     .abs().max())
        out["recorded"][f"krank_{method}_columns"] = Q.shape[1]
        out["checks"][f"krank_{method}_orthonormal"] = a3_limit(orth, 1e-4)
        U, S, Vt = nla.RangeAssistedSVD(A, Q, device=device).compute()
        svd_checks(f"krank_{method}", U, S, Vt,
                   recon=method != "adaptive")
        if method == "adaptive":
            out["checks"]["krank_adaptive_eps"] = a3_limit(
                float(torch.linalg.norm(A - Q @ (Q.T @ A))),
                size["adaptive_eps"])
    U, S, Vt = step("krank_svd_row_extraction", lambda: nla.RangeAssistedSVD(
        A, Qs["subspace_iteration"], "row_extraction",
        device=device).compute())
    svd_checks("krank_svd_row_extraction", U, S, Vt)
    U, S, Vt = step("randomized_svd", lambda: nla.randomized_svd(
        A, k, P.Context(736), q=2, device=device))
    svd_checks("randomized_svd", U, S, Vt)
    del A, U, Vt, Qs
    Sym = (U0 * sigma) @ U0.T
    Q = nla.RandomizedRangeFinder(Sym, "subspace_iteration",
                                  {"s": s_k, "q": 2}, P.Context(737),
                                  device=device).compute()
    for method, prm in (("direct", None), ("nystrom", None),
                        ("one_pass", {"s": 2 * s_k})):
        w, _ = step(f"krank_evd_{method}", lambda: nla.RangeAssistedEVD(
            Sym, Q, method, prm, context=P.Context(738),
            device=device).compute())
        w = torch.sort(w, descending=True).values[:k]
        out["checks"][f"krank_evd_{method}_lambda"] = a3_limit(float(
            ((w - sigma[:k]).abs() / sigma[:k]).max()), lim["sigma_rel"])
    del Sym, Q, U0

    # 5. randlobpcg on the least-squares operand. LOBPCG's host
    # iteration is the reference's (float32, scipy's default 20
    # iterations): it stops short of σ², and where it stops moves by up
    # to 1e-2 with a 1e-6 change of the sketch (ROADMAP C11), so no
    # replay of it can be held to 1e-3. Each sketch is held instead
    # (lobpcg_values): the card's sketch against one made by an
    # independent route; the converged quantity, LOBPCG in float64 from
    # the card's sketch run to its end, against the float64 σ²; and the
    # port's eigenvalues as Ritz values, at most σ² (to rounding) and
    # within the reach of the reference's 20 iterations
    mr, nr, ke = size["ls_rows"], size["ls_cols"], size["evd_k"]
    A = a3_lobpcg_operand(torch, size, device)
    A64 = A.double()
    lam = torch.linalg.svdvals(A64)[:ke] ** 2
    for j, name in enumerate(("cwt", "jlt", "fjlt")):
        ctx_seed = 740 + j
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, _ = step(f"lobpcg_{name}", lambda: nla.lobpcg_rand_evd(
                A, ke, P.Context(ctx_seed), sketch=name, device=device))
        vals = lobpcg_values(torch, np, P, A, ke, name, ctx_seed, got, lam,
                             device)
        out["checks"][f"lobpcg_{name}_sketch"] = a3_limit(
            vals["sketch"], lim["sketch_rel"])
        out["checks"][f"lobpcg_{name}_converged"] = a3_limit(
            vals["converged"], lim["sigma_rel"])
        out["checks"][f"lobpcg_{name}_ritz_excess"] = a3_limit(
            vals["ritz_excess"], lim["ritz_excess"])
        out["checks"][f"lobpcg_{name}_vs_sigma2"] = a3_limit(
            vals["vs_sigma2"], lim["lobpcg_reach"])
        out["recorded"][f"lobpcg_{name}_converged_iterations"] = vals[
            "iterations"]
        out["recorded"][f"lobpcg_{name}_replay"] = vals["replay"]
    got, _ = step("power_evd", lambda: nla.power_iterations_rand_evd(
        A, ke, P.Context(743), device=device))
    T = sk.JLT(nr, ke, P.Context(743))
    Y = A64 @ virtual_panel(T.allocation.key, T.dist, ke, 0, nr, T.scale,
                            torch.float64, device).T
    for _ in range(2):
        Y = A64 @ (A64.T @ Y)
    Qy = torch.linalg.qr(Y)[0]
    want = torch.linalg.svdvals(Qy.T @ A64) ** 2
    out["checks"]["power_evd_replay"] = a3_limit(float(
        ((got.double() - want).abs() / want).max()), lim["replay_rel"])
    out["recorded"]["power_evd_vs_sigma2"] = float(
        ((got.double() - lam).abs() / lam).max())
    del A, A64, Y, Qy

    # 6. graph: an R-MAT graph built by add_edge as skylark_graph_se does
    G, generated, out["recorded"]["graph_build_seconds"] = a3_graph(
        ml, np, size)
    out["recorded"]["graph"] = {"vertices": G.num_vertices(),
                                "volume": G.num_edges(),
                                "generated_edges": int(generated)}
    params = nla.ApproximateSVDParams(num_iterations=2,
                                      oversampling_ratio=2)
    kg = size["ase_k"]
    kp = 2 * kg

    def ase_check(name, G_, sparse, seed):
        X, index = step(name, lambda: ml.approximate_ase(
            G_, kg, P.Context(seed), params, sparse=sparse, device=device))
        Asp = G_.adjacency_sparse()[0]
        T = sk.JLT(len(index), kp, P.Context(seed))
        S64 = virtual_panel(T.allocation.key, T.dist, kp, 0, len(index),
                            T.scale, torch.float64, device)
        if sparse:
            data, idx, ptr = Asp.csr(np.float64, device)
            A64 = torch.sparse_csr_tensor(ptr.long(), idx.long(), data,
                                          Asp.shape)
        else:
            A64 = torch.as_tensor(Asp.to_scipy().toarray(),
                                  dtype=torch.float64, device=device)
        want, w = ase_replay(torch, A64, S64, kg, params.num_iterations)
        Xd = align_signs(torch, X.double(), want)
        out["checks"][f"{name}_replay"] = a3_limit(
            float((Xd - want).abs().max() / want.abs().max()),
            lim["ase_rel"])
        return X, Asp, w

    X, Asp, w = ase_check("graph_ase_sparse", G, True, 751)
    from scipy.sparse.linalg import eigsh

    t0 = time.perf_counter()
    ev = eigsh(Asp.to_scipy().astype(np.float64), k=kg, which="LM",
               return_eigenvectors=False)
    out["recorded"]["eigsh_seconds"] = time.perf_counter() - t0
    ev = np.sort(np.abs(ev))[::-1]
    lam_port = np.sort((X.double() ** 2).sum(0).cpu().numpy())[::-1]
    out["recorded"]["ase_abs_lambda_vs_eigsh"] = float(
        np.max(np.abs(lam_port - ev) / ev))
    del X, Asp
    sub = induced_subgraph(ml, G, size["dense_sub"])
    ase_check("graph_ase_dense", sub, False, 752)
    # local clusters from seeds of degree 5-50
    rng = np.random.default_rng(753)
    pool = [v for v in G.vertices if 5 <= G.degree(v) <= 50]
    seeds = [pool[int(j)] for j in rng.choice(len(pool),
                                              size["cluster_seeds"],
                                              replace=False)]
    clusters = []
    for j, v in enumerate(seeds):
        cl, cond = step(f"local_cluster_{j}", lambda: ml.find_local_cluster(
            G, [v]))
        clusters.append({"seed_degree": G.degree(v), "size": len(cl),
                         "conductance": cond,
                         "seconds": out["step_seconds"][
                             f"local_cluster_{j}"]})
        recomputed = conductance(G, cl)
        out["checks"][f"local_cluster_{j}_conductance"] = {
            "value": cond, "recomputed": recomputed,
            "ok": cond == recomputed}
    out["recorded"]["clusters"] = clusters
    # the serve programs on a 4096-vertex induced subgraph
    sub = induced_subgraph(ml, G, size["serve_sub"])
    Xs, index = step("graph_ase_serve", lambda: ml.graph.graph_ase_serve(
        sub, kg, seed=754, iters=2, device=device))
    Ssub = sub.adjacency_sparse()[0]
    A64 = torch.as_tensor(Ssub.to_scipy().toarray(), dtype=torch.float64,
                          device=device)
    nv = A64.shape[0]
    npad = 1 << max(3, (nv - 1).bit_length())
    Om = randgen.Normal().sample(seed_key(754),
                                 (npad, kg), device=device).double()[:nv]
    Q = torch.linalg.qr(A64 @ Om)[0]
    Q = torch.linalg.qr(A64 @ Q)[0]
    Bq = Q.T @ (A64 @ Q)
    wq, Uq = torch.linalg.eigh(0.5 * (Bq + Bq.T))
    order = torch.argsort(-wq.abs())
    want = (Q @ Uq[:, order]) * wq[order].abs().sqrt()[None, :]
    got = align_signs(torch, torch.as_tensor(Xs, device=device).double(),
                      want)
    out["checks"]["graph_ase_serve"] = a3_limit(
        float((got - want).abs().max() / want.abs().max()), lim["serve_rel"])
    svec = np.zeros(nv, np.float32)
    svec[:8] = 1.0
    p, _ = step("graph_ppr_serve", lambda: ml.graph.graph_ppr_serve(
        sub, svec, device=device))
    deg = A64.sum(0)
    inv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-30),
                      torch.zeros_like(deg))
    s64 = torch.as_tensor(svec, dtype=torch.float64, device=device)
    s64 = s64 / s64.sum()
    pw = s64
    for _ in range(16):
        pw = 0.15 * s64 + 0.85 * (A64 @ (pw * inv))
    out["checks"]["graph_ppr_serve"] = a3_limit(
        float((torch.as_tensor(p, device=device).double() - pw).abs().max()
              / pw.abs().max()), lim["serve_rel"])
    del G, sub, A64, Q

    # 7. the block solvers on K + λI, K the Gaussian Gram of the rows of
    # ml-rlsc-faster, the right-hand sides the one-hot class columns
    Kb, Bb = a3_block_system(torch, ml, size, device)
    prm = asynch.RandBlockParams()
    Xg, sweeps = step("rand_block_gauss_seidel",
                      lambda: algorithms.asynch.rand_block_gauss_seidel(
                          Kb, Bb, P.Context(760), prm, device=device))
    K64, B64 = Kb.double(), Bb.double()
    X64, _ = asynch.rand_block_gauss_seidel(
        K64, B64, P.Context(760),
        asynch.RandBlockParams(tolerance=0.0,
                               max_outer=sweeps // prm.sweeps),
        device=device)
    out["recorded"]["gauss_seidel_sweeps"] = sweeps
    out["recorded"]["gauss_seidel_residual"] = float(
        torch.linalg.norm(B64 - K64 @ Xg.double()) / torch.linalg.norm(B64))
    out["checks"]["gauss_seidel_replay"] = a3_limit(float(
        torch.linalg.norm(Xg.double() - X64) / torch.linalg.norm(X64)),
        lim["block_rel"])
    kprm = krylov.KrylovParams(tolerance=size["fcg_tolerance"],
                               iter_lim=size["fcg_iter_lim"])
    Xf, its = step("rand_block_fcg", lambda: asynch.rand_block_fcg(
        Kb, Bb, P.Context(761), prm, kprm, device=device))
    X64, _ = asynch.rand_block_fcg(
        K64, B64, P.Context(761), prm,
        krylov.KrylovParams(tolerance=0.0, iter_lim=its), device=device)
    out["recorded"]["fcg_iterations"] = its
    out["recorded"]["fcg_residual"] = float(
        torch.linalg.norm(B64 - K64 @ Xf.double()) / torch.linalg.norm(B64))
    out["checks"]["fcg_iterations"] = {
        "value": its, "limit": f"< {size['fcg_iter_lim']}",
        "ok": 0 < its < size["fcg_iter_lim"]}
    out["checks"]["fcg_replay"] = a3_limit(float(
        torch.linalg.norm(Xf.double() - X64) / torch.linalg.norm(X64)),
        lim["block_rel"])
    del Kb, Bb, K64, B64, X64

    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = {k_: sum(st.get(k_, 0) for st in
                               out["launches_by_step"].values())
                       for k_ in launch_counts()}
    out["products"] = dict(bs.products)
    if on_card:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit("a3", **out)
    bad = {name: c for name, c in out["checks"].items() if not c["ok"]}
    check(not bad, f"a3 phase checks failed: {bad}")
    a3_launch_checks(out)
    return out


def lobpcg_sketch_plain(torch, np, name, T, A, device):
    """The sketch S·A (s × n) that ``lobpcg_rand_evd(sketch=name)``
    makes, by a route independent of the card's: CWT by B2's plain
    scatter in order on the CPU; JLT by the dense kernel's plain version;
    FJLT by its definition in float64, √(N/s)·C·(D ⊙ A)/√(2N), with C
    the sampled rows of the unnormalized DCT-II written out as cosines,
    2·cos(π·idx_k·(2j + 1)/(2N)), in column panels."""
    from libskylark_tpu_torch.sketch import cuda_dense as cd, cuda_hash

    s = T.sketch_dim
    if name == "cwt":
        return cuda_hash.cwt_apply_plain(T.allocation.key, A.cpu(), s,
                                         False).double()
    if name == "jlt":
        return cd.dense_apply_plain(T.allocation.key, T.dist, A, s,
                                    T.scale, False).double()
    N = A.shape[0]
    idx = T.sample_indices(device)
    DA = T.diagonal(torch.float64, device)[:, None] * A.double()
    out = torch.zeros((s, A.shape[1]), dtype=torch.float64, device=device)
    step_ = 8192
    for j0 in range(0, N, step_):
        j = torch.arange(j0, min(j0 + step_, N), device=device)
        r = (idx[:, None] * (2 * j[None, :] + 1)) % (4 * N)
        C = 2.0 * torch.cos(math.pi * r.double() / (2 * N))
        out += C @ DA[j0:j0 + len(j)]
    return math.sqrt(N / s) / math.sqrt(2 * N) * out


def lobpcg_values(torch, np, P, A, k, name, ctx_seed, got, lam, device,
                  maxiter=200) -> dict:
    """The measures ``lobpcg_rand_evd(A, k, Context(ctx_seed),
    sketch=name)`` is held to, its eigenvalues ``got`` and the float64
    σ² ``lam``: "sketch", max|card − independent|/max|independent| of
    the sketch (lobpcg_sketch_plain); "converged", the largest relative
    distance from σ² of float64 LOBPCG from the card's sketch, at most
    ``maxiter`` iterations (lobpcg_converged), with its "iterations";
    "vs_sigma2", that of ``got``; "ritz_excess", max((got − σ²)/σ²),
    which a Ritz value keeps ≤ 0 but for rounding; and, recorded only,
    "replay", the largest relative distance of ``got`` from the
    reference's float32 iteration replayed on the independent sketch
    (lobpcg_replay), which the unconverged iteration's sensitivity to its
    sketch keeps from being a limit (ROADMAP C11)."""
    import warnings

    from libskylark_tpu_torch import sketch as sk

    m, n = A.shape
    T = {"cwt": sk.CWT, "jlt": sk.JLT, "fjlt": sk.FJLT}[name](
        m, 4 * n, P.Context(ctx_seed))
    B = T.apply(A, sk.COLUMNWISE, device=device).double()
    Bp = lobpcg_sketch_plain(torch, np, name, T, A, device).to(B.device)
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    lam = lam.double().cpu()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        conv, its = lobpcg_converged(torch, np, A.double(),
                                     B.cpu().numpy(), k, maxiter)
        want = torch.as_tensor(lobpcg_replay(
            np, A.cpu().numpy(), Bp.float().cpu().numpy(), k))
    return {"sketch": float((B - Bp).abs().max() / Bp.abs().max()),
            "replay": float(((got - want).abs() / want).max()),
            "converged": float(((conv - lam).abs() / lam).max()),
            "iterations": its,
            "vs_sigma2": float(((got - lam).abs() / lam).max()),
            "ritz_excess": float(((got - lam) / lam).max())}


def lobpcg_converged(torch, np, A64, B, k, maxiter):
    """lobpcg_rand_evd's iteration in float64 and run to its end: the
    start Vt[:k] and the (RᵀR)⁻¹ preconditioner from the sketch B (s ×
    n), AᵀA applied on A64's device, at most ``maxiter`` iterations to a
    residual of 1e-7·‖A‖²; (the eigenvalues descending, the iterations
    taken)."""
    import scipy.linalg as sla
    from scipy.sparse.linalg import LinearOperator, lobpcg

    n = A64.shape[1]
    B = np.asarray(B, np.float64)
    _, _, Vt = np.linalg.svd(B, full_matrices=False)
    _, R = np.linalg.qr(B)

    def amul(x):
        xt = torch.as_tensor(np.asarray(x), device=A64.device)
        return (A64.T @ (A64 @ xt)).cpu().numpy()

    def precond(y):
        return sla.solve_triangular(
            R, sla.solve_triangular(R.T, y, lower=True), lower=False)

    top = float(torch.linalg.matrix_norm(A64, 2)) ** 2
    lam, _, hist = lobpcg(LinearOperator((n, n), matvec=amul, matmat=amul,
                                         dtype=np.float64),
                          Vt[:k].T.copy(),
                          M=LinearOperator((n, n), matvec=precond,
                                           matmat=precond,
                                           dtype=np.float64),
                          largest=True, tol=1e-7 * top, maxiter=maxiter,
                          retLambdaHistory=True)
    return (torch.as_tensor(np.sort(lam)[::-1].copy()), len(hist) - 1)


def lobpcg_replay(np, A, B, k):
    """lobpcg_rand_evd's host iteration from the sketch B (s × n) of A,
    in their precision: the start Vt[:k] of B's SVD, the (RᵀR)⁻¹
    preconditioner of qr(B), scipy's LOBPCG on AᵀA; the eigenvalues,
    descending."""
    import scipy.linalg as sla
    from scipy.sparse.linalg import LinearOperator, lobpcg

    n = A.shape[1]
    _, _, Vt = np.linalg.svd(B, full_matrices=False)
    _, R = np.linalg.qr(B)

    def amul(x):
        return A.T @ (A @ x)

    def precond(y):
        return sla.solve_triangular(
            R, sla.solve_triangular(R.T, y, lower=True), lower=False)

    lam, _ = lobpcg(LinearOperator((n, n), matvec=amul, matmat=amul),
                    Vt[:k].T.copy(),
                    M=LinearOperator((n, n), matvec=precond,
                                     matmat=precond), largest=True)
    return np.sort(lam)[::-1].copy()


# -- 4f. the dist phase: A5's explicit half ---------------------------------

# Sequence-parallel cells at full width: config 4's least-squares sketch
# S·[A | b] (65536 × 513 → 2048, columnwise) and config 1's JLT (8192² →
# 1024, rowwise); the ranks' counts, p = 5 with N padded to a multiple of
# 5·256 (ragged).
DIST_SHAPES = (("columnwise", (65536, 513), 2048),
               ("rowwise", (8192, 8192), 1024))
DIST_P = (1, 2, 4, 8, 5)
DIST_DISTS = ("normal", "rademacher", "cauchy")
DIST_TIME_P = 4  # the per-rank shapes the kernel rows time
DIST_KERNELS = ("dense_partial_rowwise", "dense_partial_columnwise")
# every dist-sparse sketch on config 2's CSR, both ways (s_dim, kwargs)
DIST_SKETCHES = (("CWT", 1024, {}), ("JLT", 1024, {}),
                 ("GaussianRFT", 1024, {"sigma": 8.0}))


def dist_partial_limit(torch, key, dist, Ar, s_dim, seq, block0):
    """TOL·(|S_r|·|A_r|) (columnwise) or TOL·(|A_r|·|S_r|ᵀ) (rowwise) of
    one rank's unscaled partial, S_r the operator's columns from block
    block0: the entry-by-entry limit of Cauchy draws."""
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    n = Ar.shape[seq]
    S = virtual_panel(key, dist, s_dim, 256 * block0, 256 * block0 + n, 1.0,
                      device=Ar.device).double().abs()
    Aa = Ar.double().abs()
    return TOL * ((S @ Aa) if seq == 0 else (Aa @ S.T))


def dist_emulated(torch, P) -> list:
    """Step 1: p ranks emulated in this process. Each rank's partial
    kernel (``cuda_dense.fused_partial``) at its own block0 against its
    plain version, and the partials scaled and summed in rank order
    against B1's one-shot apply and against the plain partials' sum, with
    the counters showing p launches and s·n_loc generated entries a rank.
    These launches compare kernels; they are not the main path's."""
    import torch.nn.functional as F

    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd

    dists = {"normal": randgen.Normal(), "rademacher": randgen.Rademacher(),
             "cauchy": randgen.Cauchy()}
    results = []
    for i, (way, shape, s) in enumerate(DIST_SHAPES):
        seq = 0 if way == "columnwise" else 1
        name = f"dense_partial_{way}"
        A = make_operand(torch, shape, 4000 + i)
        N, scale = shape[seq], 1.0 / math.sqrt(s)
        for j, dname in enumerate(DIST_DISTS):
            d = dists[dname]
            key = P.Context(400 + 10 * i + j).allocate().key
            one = (cd.columnwise_apply if seq == 0 else cd.rowwise_apply)(
                key, d, A, s, scale)
            limit = (elementwise_limit(torch, key, d, A, s, scale, seq == 1)
                     if dname == "cauchy" else None)
            for p in DIST_P:
                bps = -(-N // (p * 256))
                pad = [0, 0, 0, 0]
                pad[2 * (1 - seq) + 1] = p * bps * 256 - N
                Ap = F.pad(A, pad) if any(pad) else A
                for c in (cd.launches, cd.generated):
                    for k in c:
                        c[k] = 0
                total = plain_total = None
                per_rank = []
                for r in range(p):
                    Ar = Ap.narrow(seq, r * bps * 256, bps * 256).contiguous()
                    part = cd.fused_partial(key, d, Ar, s, seq, r * bps)
                    plain = cd.partial_plain(key, d, Ar, s, seq, r * bps)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(part).all()),
                          f"{name} output not finite")
                    lim = (dist_partial_limit(torch, key, d, Ar, s, seq,
                                              r * bps)
                           if dname == "cauchy" else None)
                    per_rank.append(held(torch, part, plain, lim))
                    total = scale * part if total is None else (
                        total + scale * part)
                    plain_total = scale * plain if plain_total is None else (
                        plain_total + scale * plain)
                    del Ar, part, plain, lim
                launched = cd.launches[name]
                entries = cd.generated["entries"]
                vs_one = held(torch, total, one, limit)
                vs_plain = held(torch, total, plain_total, limit)
                rank_shape = list(shape)
                rank_shape[seq] = bps * 256
                results.append({
                    "kernel": name, "dist": dname, "p": p,
                    "shape": rank_shape, "s_dim": s,
                    "max_abs_err": max(c["max_abs_err"] for c in per_rank),
                    "ranks_ok": all(c["ok"] for c in per_rank),
                    "sum_vs_one_shot": vs_one, "sum_vs_plain": vs_plain,
                    "launches": launched, "generated_entries": entries,
                    "ok": (all(c["ok"] for c in per_rank) and vs_one["ok"]
                           and vs_plain["ok"] and launched == p
                           and entries == p * s * bps * 256)})
                del Ap, total, plain_total
            del one, limit
        del A
    return results


def dist_one_rank(torch, P, np, A_csr) -> dict:
    """Step 2: a one-rank NCCL group joined through
    ``multihost.initialize_distributed`` on localhost; the public
    shard_apply both ways on it against B1's one-shot apply (and
    use_pallas=False refused on a CUDA tensor), and a DistSparseMatrix of
    config 2's CSR on a 1 × 1 mesh against the one-process SparseMatrix
    route. The counters are read after the dist calls, before the
    one-process references run."""
    import torch.distributed as dist

    from libskylark_tpu_torch import parallel as par, sketch as sk
    from libskylark_tpu_torch.base import errors
    from libskylark_tpu_torch.base.dist_sparse import distribute_sparse
    from libskylark_tpu_torch.base.sparse import spmm
    from libskylark_tpu_torch.parallel import multihost, shard_apply

    out = {"applies": {}}
    multihost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                     connect_timeout=120.0)
    try:
        out["backend"] = str(dist.get_backend())
        check(out["backend"] == "nccl", f"one-rank group on {out['backend']}")
        mesh = par.make_mesh()
        for c in counters():
            for k in c:
                c[k] = 0
        got, ops = {}, {}
        for i, (way, shape, s) in enumerate(DIST_SHAPES):
            A = make_operand(torch, shape, 4100 + i)
            T = sk.JLT(shape[0 if way == "columnwise" else 1], s,
                       P.Context(430 + i))
            ops[way] = (T, A)
            got[way] = getattr(shard_apply, way)(T, A, mesh)
        try:
            T, A = ops["columnwise"]
            shard_apply.columnwise(T, A, mesh, use_pallas=False)
            refused = False
        except errors.InvalidParametersError:
            refused = True
        check(refused, "use_pallas=False on a CUDA tensor was not refused")
        grid = par.make_mesh((1, 1))
        D = distribute_sparse(A_csr, grid, row_axis="rows", col_axis="cols")
        Tc = sk.CWT(RCV1_D, 1024, P.Context(440))
        g = torch.Generator(device="cuda").manual_seed(441)
        B = torch.randn(RCV1_D, 64, generator=g, device="cuda")
        dgot = {"cwt": Tc.apply(D, sk.ROWWISE), "spmm": D.spmm(B)}
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        for way, (T, A) in ops.items():
            want = T.apply(A, sk.COLUMNWISE if way == "columnwise"
                           else sk.ROWWISE)
            out["applies"][way] = held(torch, got[way], want)
        want = {"cwt": Tc.apply(A_csr, sk.ROWWISE), "spmm": spmm(A_csr, B)}
        for k, v in dgot.items():
            out["applies"][f"dist_sparse_1x1_{k}"] = {
                **held(torch, v, want[k]),
                "bit_equal": bool(torch.equal(v, want[k]))}
    finally:
        dist.destroy_process_group()
    bad = {k: v for k, v in out["applies"].items() if not v["ok"]}
    check(not bad, f"one-rank group: {bad}")
    check(out["applies"]["dist_sparse_1x1_cwt"]["bit_equal"],
          "1 × 1 DistSparseMatrix CWT differs from the SparseMatrix route")
    for k in DIST_KERNELS:
        check(out["launches"][k] == 1, f"one-rank group: {k} launches "
              f"{out['launches'][k]}, not 1")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_operands(torch, P, np):
    """Config 2's CSR (the sparse phase's rcv1 operand), its weighted SVD
    form, and the 262,144 × 1,024 least-squares CSR."""
    import scipy.sparse as sp

    from libskylark_tpu_torch.base import sprand
    from libskylark_tpu_torch.base.sparse import SparseMatrix

    A = sprand.sample(RCV1_N, RCV1_D, RCV1_DENSITY, DYADIC, (1, 1, 1),
                      P.Context(70))
    c, q = SVD_WEIGHT
    W = SparseMatrix.from_scipy(sp.diags(1.0 + c * q ** np.arange(RCV1_N))
                                @ A.to_scipy())
    m, n, dens = SPARSE_LS
    L = sprand.sample(m, n, dens, DYADIC, (1, 1, 1), P.Context(81))
    return A, W, L


def digest(torch, t) -> str:
    """A rank's result as bytes, hashed: equal on every rank of a group."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def dist_child(rank: int, world: int, port: int) -> int:
    """Step 3, one of two processes sharing the card through gloo: the
    public shard_apply both ways at step 1's shapes; a DistSparseMatrix
    of config 2's CSR on (2, 1) and (1, 2) meshes through CWT, JLT and
    GaussianRFT both ways, and spmm/spmm_t; the sparse SVD (rank 64, q =
    2) of the weighted operand; and condest's device route on the
    262,144 × 1,024 CSR. Each against the one-process route, computed
    after the dist calls and their launch counts; prints one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import nla, parallel as par, sketch as sk
    from libskylark_tpu_torch.base.dist_sparse import distribute_sparse
    from libskylark_tpu_torch.base.sparse import spmm, spmm_t
    from libskylark_tpu_torch.parallel import multihost, shard_apply

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     connect_timeout=120.0, backend="gloo")
    A_csr, W, L = dist_operands(torch, P, np)
    meshes = {"2x1": par.make_mesh((world, 1)),
              "1x2": par.make_mesh((1, world))}
    line = par.make_mesh()
    torch.cuda.reset_peak_memory_stats()
    for c in counters():
        for k in c:
            c[k] = 0
    t1 = time.perf_counter()
    got, refs = {}, {}
    for i, (way, shape, s) in enumerate(DIST_SHAPES):
        A = make_operand(torch, shape, 4100 + i)
        T = sk.JLT(shape[0 if way == "columnwise" else 1], s,
                   P.Context(430 + i))
        got[f"shard_{way}"] = getattr(shard_apply, way)(T, A, line)
        refs[f"shard_{way}"] = lambda T=T, A=A, way=way: T.apply(
            A, sk.COLUMNWISE if way == "columnwise" else sk.ROWWISE)
    g = torch.Generator(device="cuda").manual_seed(442)
    Bw = torch.randn(RCV1_D, 128, generator=g, device="cuda")
    Bh = torch.randn(RCV1_N, 128, generator=g, device="cuda")
    for mname, mesh in meshes.items():
        D = distribute_sparse(A_csr, mesh, row_axis="rows", col_axis="cols")
        for i, (name, s, kw) in enumerate(DIST_SKETCHES):
            for way, dim, n in (("rw", sk.ROWWISE, RCV1_D),
                                ("cw", sk.COLUMNWISE, RCV1_N)):
                T = getattr(sk, name)(n, s, P.Context(460 + i), **kw)
                key = f"{mname}_{name.lower()}_{way}"
                got[key] = T.apply(D, dim)
                refs[key] = lambda T=T, dim=dim: T.apply(A_csr, dim)
        got[f"{mname}_spmm"] = D.spmm(Bw)
        refs[f"{mname}_spmm"] = lambda: spmm(A_csr, Bw)
        got[f"{mname}_spmm_t"] = D.spmm_t(Bh)
        refs[f"{mname}_spmm_t"] = lambda: spmm_t(A_csr, Bh)
        del D
    params = nla.ApproximateSVDParams(num_iterations=2)
    Dw = distribute_sparse(W, meshes["2x1"], row_axis="rows",
                           col_axis="cols")
    t2 = time.perf_counter()
    _, S_dist, _ = nla.approximate_svd(Dw, 64, P.Context(80), params)
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t2
    Dl = distribute_sparse(L, meshes["2x1"], row_axis="rows",
                           col_axis="cols")
    Dl.to_local = None  # the device route never gathers the operand
    t2 = time.perf_counter()
    cond = nla.estimate_condition(Dl, P.Context(86))
    condest_s = time.perf_counter() - t2
    torch.cuda.synchronize()
    launches = launch_counts()
    dist_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2**30

    checks = {}
    for key, v in got.items():
        want = refs[key]()
        r = {**held(torch, v, want), "digest": digest(torch, v)}
        if "cwt" in key:
            r["bit_equal"] = bool(torch.equal(v, want))
        checks[key] = r
    _, S_one, _ = nla.approximate_svd(W, 64, P.Context(80), params)
    svd_rel = float(((S_dist.double() - S_one.double()).abs()
                     / S_one.double()).max())
    host = nla.estimate_condition(L, P.Context(86))
    cond_rel = [abs(a - b) / abs(b) for a, b in zip(cond[1:], host[1:])]
    print("DIST_CHILD " + json.dumps({
        "rank": rank, "checks": checks, "launches": launches,
        "svd": {"sigma_rel_vs_one_process": svd_rel,
                "digest": digest(torch, S_dist), "seconds": svd_s},
        "condest": {"device": list(cond), "host": list(host),
                    "sigma_rel": cond_rel, "seconds": condest_s},
        "seconds": {"setup": t1 - t0, "dist_calls": dist_s},
        "peak_memory_gib": peak,
        "imports_jax": "jax" in sys.modules or "libskylark_tpu" in
        sys.modules}), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_two_ranks(torch) -> dict:
    """Step 3: spawn :func:`dist_child` twice (two gloo ranks on the one
    card), wait, and hold what they report: every check within the
    sparse phase's limits (applies 1e-4·max|one-process|, the SVD's σ and
    condest's σmax, σmin within 1e-3), the CWT cells that no rank sums
    bit-equal, every result the same on both ranks, and the partial
    kernel launched."""
    release_cache(torch)
    world, port = 2, free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-child",
         str(r), str(world), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          "dist child failed:\n" + "\n".join(x[-3000:] for x in logs))
    reports = [json.loads(next(ln for ln in x.splitlines()
                               if ln.startswith("DIST_CHILD "))[11:])
               for x in logs]
    r0 = reports[0]
    bad = [k for k, v in r0["checks"].items() if not v["ok"]]
    # no rank adds another's partial: rowwise on (2, 1), columnwise on
    # (1, 2)
    exact = [k for k in r0["checks"] if k in ("2x1_cwt_rw", "1x2_cwt_cw")]
    bad += [k for k in exact if not r0["checks"][k]["bit_equal"]]
    bad += [k for k in r0["checks"]
            if any(r["checks"][k]["digest"] != r0["checks"][k]["digest"]
                   for r in reports)]
    check(not bad, f"two-rank gloo group: {bad}: {r0['checks']}")
    check(all(r["svd"]["digest"] == r0["svd"]["digest"] for r in reports)
          and r0["svd"]["sigma_rel_vs_one_process"] <= 1e-3,
          f"two-rank sparse SVD: {r0['svd']}")
    check(max(r0["condest"]["sigma_rel"]) <= 1e-3,
          f"two-rank condest: {r0['condest']}")
    check(not any(r["imports_jax"] for r in reports),
          "a dist child imported jax or libskylark_tpu")
    for k in DIST_KERNELS:
        check(all(r["launches"][k] == 1 for r in reports),
              f"two-rank group: {k} launches "
              f"{[r['launches'][k] for r in reports]}")
    launches = {k: sum(r["launches"][k] for r in reports)
                for k in r0["launches"]}
    return {"reports": reports, "launches": launches}


def time_partials(torch, P, peaks: dict) -> list[dict]:
    """Phase 5 rows of the partial kernel at p = 4's per-rank shapes
    (rank 1's block offset), a new key per call; ``library_ms``:
    torch.matmul against the rank's panel of S made beforehand."""
    from libskylark_tpu_torch.base import randgen
    from libskylark_tpu_torch.sketch import cuda_dense as cd
    from libskylark_tpu_torch.sketch.dense import virtual_panel

    rows = []
    for way, shape, s in DIST_SHAPES:
        seq = 0 if way == "columnwise" else 1
        bps = -(-shape[seq] // (DIST_TIME_P * 256))
        rank = list(shape)
        rank[seq] = bps * 256
        A = make_operand(torch, tuple(rank), 7)
        d, ctx = randgen.Normal(), P.Context(9)
        n, m = rank[seq], rank[1 - seq]

        def kernel():
            return cd.fused_partial(ctx.allocate().key, d, A, s, seq, bps)

        S = virtual_panel(ctx.allocate().key, d, s, 256 * bps,
                          256 * bps + n, 1.0, device=A.device)
        rows.append({
            "kernel": f"dense_partial_{way}",
            "use": f"rank 1 of {DIST_TIME_P}: shard_apply.{way}",
            "main_path": True, "shape": rank, "s_dim": s,
            "ms": event_ms(torch, kernel),
            "device_ms": profiled_device_ms(torch, kernel),
            "plain_ms": event_ms(torch, lambda: cd.partial_plain(
                ctx.allocate().key, d, A, s, seq, bps)),
            "library_ms": event_ms(torch, (lambda: torch.matmul(S, A))
                                   if seq == 0 else
                                   (lambda: torch.matmul(A, S.T))),
            **dense_bounds(2.0 * m * n * s, 4.0 * (m * n + m * s), peaks)})
        del A, S
    return rows


def dist_phase(torch, P, np, peaks) -> dict:
    """Phase 4f: A5's explicit half on the card. Step 1 (emulated ranks)
    checks the partial kernel; steps 2 and 3 are the main path, through
    the public entry points, with every launch counter set to 0 before
    (the children start from 0) and read after; step 4 times the kernel.
    Prints its seconds and the card's peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emulated = dist_emulated(torch, P)
    bad = [r for r in emulated if not r["ok"]]
    check(not bad, f"partial kernel: {bad}")
    from libskylark_tpu_torch.base import sprand

    A_csr = sprand.sample(RCV1_N, RCV1_D, RCV1_DENSITY, DYADIC, (1, 1, 1),
                          P.Context(70))
    t1 = time.perf_counter()
    one = dist_one_rank(torch, P, np, A_csr)
    two = dist_two_ranks(torch)
    launches = {k: one["launches"][k] + two["launches"][k]
                for k in one["launches"]}
    main_s = time.perf_counter() - t1
    rows = time_partials(torch, P, peaks)
    out = {"emulated": emulated, "one_rank": one,
           "two_ranks": two["reports"], "launches": launches,
           "rows": rows, "main_path_seconds": main_s,
           "seconds": time.perf_counter() - t0,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit("dist", **{k: v for k, v in out.items() if k != "rows"})
    for k in DIST_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the dist path")
    return out


# -- 4g. the sharded phase: A5b, mesh-sharded dense operands (DTensors) ------

# B2 at a shard's offset, as torch's split gives p ranks their rows:
# config 4's S·[A | b] (65536 × 513 → 2048, columnwise) and config 1's
# CWT (8192² → 1024, rowwise); p = 5 ragged (shards not 1024-aligned)
SHARDED_HASH = (("columnwise", (65536, 513), 2048),
                ("rowwise", (8192, 8192), 1024))
SHARDED_P = (1, 2, 4, 5)
# the entry points' operands at full width: config 4's least-squares
# operand and sketch size, the SVD cell's 8192² (rank 64, q = 2), krank's
# gap operand, config 5 (60,000 × 784, Gaussian σ = 112, s = 8192, λ = 1;
# Block-ADMM at the ml-admm cell's settings)
SHARDED_FULL = {"ls_rows": 65536, "ls_cols": 512, "s": 2048,
                "svd_n": 8192, "svd_r": 512, "rank": 64, "q": 2,
                "rft_sigma": 256.0, "lsqr_tolerance": 1e-6,
                "lsqr_iter_lim": 100, "krank_n": 8192, "krank_r": 512,
                "evd_k": 10, "ml": ML_FULL}
# limits of the two-rank step against the one-process route, each the
# one-process phases' own (the 1 × 1 mesh is held torch.equal)
SHARDED_LIMITS = {"sigma": 1e-3, "sketch_solve": 1.5,
                  "lsqr_residual": 1 + 1e-3,
                  "normal_equations": ML_LIMITS["normal_equations"],
                  "admm_coef": ML_LIMITS["admm_coef"],
                  "admm_objective": ML_LIMITS["admm_objective"],
                  "lobpcg_sketch": 1e-4, "lobpcg_converged": 1e-3,
                  "lobpcg_vs_sigma2": 0.05, "lobpcg_ritz": 1e-5}
# the kernels each rank launches on its own block in one run of the
# entry points: B1's partial (JLT, CT, GaussianRFT columnwise), B1 (the
# SVD's range sketch), B1-cos (KRR's map, ADMM's 4 maps at 11 applies),
# B5 (FJLT after its all-to-all), B2 (CWT, sketch-and-solve, LOBPCG's
# sketch): at offset 0 on rank 0, at its offset on the others
SHARDED_KERNELS = ("dense_partial_columnwise", "dense_rowwise",
                   "dense_rowwise_cos", "hash_offset")


def sharded_launches(rank: int, world: int, size) -> dict:
    """Each kernel's launches on ``rank`` of ``world`` in one run of the
    entry points: on one rank nothing is split, so the columnwise
    sketches take B1's one-shot launch, not its partial."""
    P4, it = size["ml"]["partitions"], size["ml"]["admm_iters"]
    split = 3 if world > 1 else 0
    return {"dense_partial_columnwise": split,
            "dense_columnwise": 3 - split, "dense_rowwise": 1,
            "dense_rowwise_cos": 1 + P4 * (1 + it),
            "fwht_columnwise": 1,
            "hash_columnwise": 3 if rank == 0 else 0,
            "hash_offset": 0 if rank == 0 else 3}


def sharded_emulated(torch, P) -> list:
    """Step 1: B2 with ``n0`` on each rank's block of torch's split,
    emulated in this process, torch.equal to the plain scatter at the same
    offset on a CPU copy; the blocks' sketches summed in rank order
    against the one-shot B2 (≤ 1e-4·max, torch.equal at p = 1), with p − 1
    offset launches and one at offset 0. These launches compare kernels;
    they are not the main path's."""
    from libskylark_tpu_torch.sketch import cuda_hash as ch

    results = []
    for i, (way, shape, s) in enumerate(SHARDED_HASH):
        rowwise = way == "rowwise"
        seq = 1 if rowwise else 0
        A = make_operand(torch, shape, 4200 + i)
        key = P.Context(490 + i).allocate().key
        one = ch.cwt_apply(key, A, s, rowwise)
        N = shape[seq]
        for p in SHARDED_P:
            chunk = -(-N // p)
            for k in ch.launches:
                ch.launches[k] = 0
            total, zero_ok = None, True
            for r in range(p):
                lo, hi = min(r * chunk, N), min((r + 1) * chunk, N)
                Ar = A.narrow(seq, lo, hi - lo).contiguous()
                got = ch.cwt_apply(key, Ar, s, rowwise, lo)
                plain = ch.cwt_apply_plain(key, Ar.cpu(), s, rowwise, lo)
                equal = bool(torch.equal(got.cpu(), plain))
                if lo:
                    results.append({
                        "kernel": "hash_offset", "way": way, "p": p,
                        "rank": r, "n0": lo, "shape": list(Ar.shape),
                        "s_dim": s, "bit_equal": equal,
                        "max_abs_err": float((got.cpu() - plain).abs().max()),
                        "ok": equal})
                else:
                    zero_ok = zero_ok and equal
                total = got if total is None else total + got
                del Ar, got, plain
            launched = dict(ch.launches)
            vs_one = held(torch, total, one)
            vs_one["bit_equal"] = bool(torch.equal(total, one))
            results.append({
                "kernel": "hash_offset_sum", "way": way, "p": p,
                "shape": list(shape), "s_dim": s, "sum_vs_one_shot": vs_one,
                "launches": launched,
                "ok": (zero_ok and vs_one["ok"]
                       and (p > 1 or vs_one["bit_equal"])
                       and launched["hash_offset"] == p - 1
                       and launched[f"hash_{way}"] == 1)})
            del total
        del A, one
    return results


def sharded_operands(torch, size, device):
    """The phase's operands, made on ``device`` from seeds (the same in
    every process): the least-squares [A | b] (b = A·x0 + 0.1·noise), the
    SVD operand (rank svd_r, σ = 0.95^i) with its σ, krank's gap operand
    with its σ, and config 5's X, labels y and ±1 targets Y."""
    g = torch.Generator(device=device).manual_seed(3)
    m, n = size["ls_rows"], size["ls_cols"]
    A = torch.randn(m, n, generator=g, device=device)
    x0 = torch.randn(n, generator=g, device=device)
    b = A @ x0 + 0.1 * torch.randn(m, generator=g, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    N, r = size["svd_n"], size["svd_r"]
    U0 = torch.linalg.qr(torch.randn(N, r, generator=g, device=device))[0]
    V0 = torch.linalg.qr(torch.randn(N, r, generator=g, device=device))[0]
    sig = 0.95 ** torch.arange(r, device=device, dtype=torch.float32)
    K, _, ksig = a3_krank_operand(torch, size, device)
    X, y, _, _ = ml_data(torch, size["ml"], device)
    Y = 2.0 * torch.nn.functional.one_hot(
        y, size["ml"]["classes"]).to(torch.float32) - 1.0
    Ab = torch.cat([A, b[:, None]], 1).contiguous()
    # an SPD system for CG and Chebyshev (spectrum in [1, spd_top]), a
    # start for power_iteration, a subset for exact KRR's n × n Gram
    B = A[:2048]
    spd = B @ B.T / n + torch.eye(2048, device=device)
    return {"Ab": Ab, "Ab_abs": Ab.abs(), "A": A, "b": b,
            "S": (U0 * sig) @ V0.T, "sigma": sig, "K": K, "ksigma": ksig,
            "X": X, "y": y, "Y": Y, "spd": spd, "spd_b": b[:2048, None],
            "spd_top": torch.linalg.eigvalsh(spd.double())[-1] * 1.01,
            "Q0": torch.linalg.qr(A[:N, :2 * size["rank"]])[0],
            "Xk": X[:4096], "Yk": Y[:4096]}


def sharded_cases(torch, P, ops, size):
    """The entry points of the slice: name -> fn(operands) for a DTensor
    or a tensor operand (the same call both ways), and each one's
    collectives per mesh dimension that splits the rows, (all_reduce,
    all_gather, all_to_all); None where the count depends on the
    iteration (LSQR, LOBPCG)."""
    import contextlib
    import io as stdio

    from libskylark_tpu_torch import algorithms as alg, ml, nla
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.algorithms import prox
    from libskylark_tpu_torch.nla import tsqr

    m, n, s = size["ls_rows"], size["ls_cols"], size["s"]
    ms, mp = size["ml"], size["ml"]["partitions"]
    cw = sk.COLUMNWISE
    kern = ml_kernel(ml, ms)

    def admm(o):
        sv = ml.BlockADMMSolver.from_kernel(
            P.Context(608), prox.HingeLoss(), prox.L2Regularizer(),
            ADMM_LAM, ms["s"], kern, num_partitions=mp)
        sv.maxiter, sv.tol = ms["admm_iters"], 0.0
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            model = sv.train(o["X"], o["y"], verbose=True)
        return model.coef, [float(ln.split()[3])
                            for ln in buf.getvalue().splitlines()]

    def sketch_solve(o):
        SAb = sk.CWT(m, s, P.Context(503)).apply(o["Ab"], cw)
        SAb = SAb.to_local() if hasattr(SAb, "to_local") else SAb
        return alg.solve_l2_exact(SAb[:, :n], SAb[:, n:])[:, 0]

    svd = nla.ApproximateSVDParams(num_iterations=size["q"])
    return {
        "jlt_cw": (lambda o: sk.JLT(m, s, P.Context(500)).apply(o["Ab"], cw),
                   (1, 0, 0)),
        "ct_cw": (lambda o: sk.CT(m, s, P.Context(501)).apply(o["Ab"], cw),
                  (1, 0, 0)),
        "cwt_cw": (lambda o: sk.CWT(m, s, P.Context(502)).apply(o["Ab"], cw),
                   (1, 0, 0)),
        "gaussianrft_cw": (lambda o: sk.GaussianRFT(
            m, s, P.Context(504), sigma=size["rft_sigma"]).apply(o["Ab"], cw),
            (1, 0, 0)),
        "ust_cw": (lambda o: sk.UST(m, s, P.Context(505)).apply(o["Ab"], cw),
                   (1, 0, 0)),
        "fjlt_cw": (lambda o: sk.FJLT(m, s, P.Context(506), fut="wht").apply(
            o["Ab"], cw), (0, 0, 1)),
        "ls_cwt": (sketch_solve, (1, 0, 0)),
        "lsqr": (lambda o: alg.lsqr(o["A"], o["b"], alg.KrylovParams(
            tolerance=size["lsqr_tolerance"],
            iter_lim=size["lsqr_iter_lim"])), None),
        "cqr2": (lambda o: tsqr.cholesky_qr2(o["A"]), (2, 0, 0)),
        "svd": (lambda o: nla.approximate_svd(o["S"], size["rank"],
                                              P.Context(507), svd),
                (9, 0, 0)),
        "akrr": (lambda o: ml.approximate_kernel_ridge(
            kern, o["X"], o["Y"], ML_LAM, ms["s"], P.Context(509)),
            (2, 0, 0)),
        "admm": (admm, (1 + mp + ms["admm_iters"] * (2 * mp + 1), 0, 0)),
        # q products Aᵀ·Y, the QR's gather of the (m × 2k) panel, Qᵀ·A
        "krank_svd": (lambda o: nla.randomized_svd(
            o["K"], size["rank"], P.Context(510), q=size["q"]),
            (size["q"] + 1, 1, 0)),
        "lobpcg": (lambda o: nla.lobpcg_rand_evd(
            o["A"], size["evd_k"], P.Context(511), sketch="cwt"), None),
    }


def sharded_one_rank_cases(torch, P, size):
    """The slice's other entry points, held on the 1 × 1 mesh only (the
    CPU tests hold each on meshes of 2–7 ranks against the JAX package):
    name -> (fn(operands), whether its one-process route is deterministic
    on the card; MMT and WZT scatter with CUDA atomics)."""
    from libskylark_tpu_torch import algorithms as alg, ml, nla
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.nla import lowrank

    m, s = size["ls_rows"], size["s"]
    ms, cw = size["ml"], sk.COLUMNWISE
    kern = ml_kernel(ml, ms)
    kp = alg.KrylovParams(tolerance=1e-6, iter_lim=200)

    def cheb(o):
        return alg.chebyshev(o["spd"], o["spd_b"], 1.0,
                             float(o["spd_top"]), alg.KrylovParams(
                                 iter_lim=30))

    def evd(o):
        Q = nla.RandomizedRangeFinder(o["spd"], "generic", {"s": 64},
                                      P.Context(519)).compute()
        return nla.RangeAssistedEVD(o["spd"], Q).compute()

    return {
        "mmt_cw": (lambda o: sk.MMT(m, s, P.Context(512)).apply(o["Ab"], cw),
                   False),
        "wzt_cw": (lambda o: sk.WZT(m, s, P.Context(513), p=1.5).apply(
            o["Ab"], cw), False),
        "laplacianrft_cw": (lambda o: sk.LaplacianRFT(
            m, s, P.Context(514), sigma=4.0 * m).apply(o["Ab"], cw), True),
        "maternrft_cw": (lambda o: sk.MaternRFT(
            m, s, P.Context(515), nu=1.5, l=size["rft_sigma"]).apply(
                o["Ab"], cw), True),
        "expsemigroup_cw": (lambda o: sk.ExpSemigroupRLT(
            m, s, P.Context(516), beta=0.01).apply(o["Ab_abs"], cw), True),
        "power_iteration": (lambda o: nla.power_iteration(
            o["S"], o["Q0"], size["q"]), True),
        "cg": (lambda o: alg.cg(o["spd"], o["spd_b"], kp), True),
        "flexible_cg": (lambda o: alg.flexible_cg(o["spd"], o["spd_b"], kp),
                        True),
        "chebyshev": (cheb, True),
        "kernel_ridge": (lambda o: ml.kernel_ridge(kern, o["Xk"], o["Yk"],
                                                   ML_LAM), True),
        "sketched_krr": (lambda o: ml.sketched_approximate_kernel_ridge(
            kern, o["X"], o["Y"], ML_LAM, s, P.Context(517)), True),
        "range_assisted_evd": (evd, True),
        "dominant_subspace": (
            lambda o: lowrank.approximate_dominant_subspace_basis(
                o["A"], size["evd_k"], 64, 128, P.Context(518)), True),
    }


def counted_call(torch, fn):
    """(fn(), [all_reduce, all_gather, all_to_all, every collective
    CommDebugMode saw]): the port's own count of the collectives it
    issued (parallel.mesh.collectives) and torch's, which also sees any a
    DTensor op would insert."""
    from torch.distributed.tensor.debug import CommDebugMode

    from libskylark_tpu_torch.parallel import mesh as pmesh

    for k in pmesh.collectives:
        pmesh.collectives[k] = 0
    with CommDebugMode() as mode:
        out = fn()
    return out, [pmesh.collectives[k] for k in
                 ("all_reduce", "all_gather", "all_to_all")] + [
                     mode.get_total_counts()]


def whole_of(torch, x):
    """A result as tensors every rank holds whole: a DTensor read with
    ``parallel.to_host`` (a collective, outside the counted calls) and
    put back on its block's device."""
    from libskylark_tpu_torch import parallel as par

    if isinstance(x, (tuple, list)):
        return type(x)(whole_of(torch, v) for v in x)
    if hasattr(x, "to_local"):
        return torch.from_numpy(par.to_host(x)).to(x.to_local().device)
    return x


def sharded_run(torch, P, np, mesh, size, device,
                extras: bool = False) -> dict:
    """Every entry point on the operands laid out row_sharded on ``mesh``
    (the main path: launch counters set to 0 before, read after), then
    the same calls on the whole operands (the one-process route). Returns
    the results, each call's collectives and seconds, the launches; with
    ``extras`` (the 1 × 1 mesh) also sharded_one_rank_cases', after the
    launches are read."""
    from libskylark_tpu_torch import parallel as par

    ops = sharded_operands(torch, size, device)
    rows = par.row_sharded(mesh)
    dops = {k: (v if k in ("y", "sigma", "ksigma", "Q0", "spd_top")
                else par.distribute(v, rows)) for k, v in ops.items()}
    cases = sharded_cases(torch, P, ops, size)
    for c in counters():
        for k in c:
            c[k] = 0
    got, colls, seconds = {}, {}, {}
    for name, (fn, _) in cases.items():
        t0 = time.perf_counter()
        got[name], colls[name] = counted_call(torch, lambda: fn(dops))
        if device != "cpu":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    launches = launch_counts()
    got = {k: whole_of(torch, v) for k, v in got.items()}
    want = {name: fn(ops) for name, (fn, _) in cases.items()
            if name != "lobpcg" or mesh.size() == 1}
    extra = {}
    if extras:
        for name, (fn, exact) in sharded_one_rank_cases(torch, P,
                                                        size).items():
            g, c = counted_call(torch, lambda: fn(dops))
            extra[name] = (whole_of(torch, g), fn(ops), exact, c)
    return {"ops": ops, "cases": cases, "got": got, "want": want,
            "collectives": colls, "seconds": seconds, "launches": launches,
            "extra": extra}


def sharded_values(torch, x) -> list:
    """A result's values as host arrays, in order: tensors, arrays and
    numbers (a returned transform is left out)."""
    import numpy as np

    if isinstance(x, (tuple, list)):
        return [a for v in x for a in sharded_values(torch, v)]
    if isinstance(x, torch.Tensor):
        return [x.detach().contiguous().cpu().numpy()]
    if isinstance(x, (np.ndarray, np.generic, int, float)):
        return [np.asarray(x)]
    return []


def sharded_digest(torch, x) -> str:
    import hashlib

    return hashlib.sha256(b"".join(
        v.tobytes() for v in sharded_values(torch, x))).hexdigest()[:16]


def sharded_equal(torch, got, want) -> bool:
    """Every value of a result equal to the bit (torch.equal)."""
    import numpy as np

    a, b = sharded_values(torch, got), sharded_values(torch, want)
    return len(a) == len(b) and all(
        x.shape == y.shape and bool(np.array_equal(x, y))
        for x, y in zip(a, b))


def sharded_checks(torch, P, np, run, size, lobpcg_lam) -> dict:
    """The two-rank results against the one-process route with the
    one-process phases' limits (module docstring, phase 4g)."""
    got, want, ops = run["got"], run["want"], run["ops"]
    lim = SHARDED_LIMITS
    out = {}
    for name in ("jlt_cw", "cwt_cw", "gaussianrft_cw", "fjlt_cw"):
        out[name] = {**held(torch, got[name], want[name]),
                     "bit_equal": bool(torch.equal(got[name], want[name]))}
    T = P.Context(501)
    from libskylark_tpu_torch import sketch as sk
    from libskylark_tpu_torch.base import randgen

    Tct = sk.CT(size["ls_rows"], size["s"], T)
    out["ct_cw"] = held(torch, got["ct_cw"], want["ct_cw"], elementwise_limit(
        torch, Tct.allocation.key, randgen.Cauchy(), ops["Ab"], size["s"],
        Tct.scale, False))
    out["ust_cw"] = {"bit_equal": bool(torch.equal(got["ust_cw"],
                                                   want["ust_cw"]))}
    out["ust_cw"]["ok"] = out["ust_cw"]["bit_equal"]
    exact = lstsq_residual(torch, ops["A"], ops["b"])
    for name, bound_ in (("ls_cwt", lim["sketch_solve"]),
                         ("lsqr", lim["lsqr_residual"])):
        x = got[name][0] if name == "lsqr" else got[name]
        xw = want[name][0] if name == "lsqr" else want[name]
        ratio = float(torch.linalg.norm(ops["A"].double() @ x.double()
                                        - ops["b"].double())) / exact
        out[name] = {**held(torch, x, xw), "residual_ratio": ratio}
        out[name]["ok"] = out[name]["ok"] and ratio <= bound_
    out["lsqr"]["iterations"] = [got["lsqr"][1], want["lsqr"][1]]
    Q, R = got["cqr2"]
    out["cqr2"] = {"Q": held(torch, Q, want["cqr2"][0]),
                   "R": held(torch, R, want["cqr2"][1])}
    out["cqr2"]["ok"] = out["cqr2"]["Q"]["ok"] and out["cqr2"]["R"]["ok"]
    k = size["rank"]
    for name, sig in (("svd", ops["sigma"][:k]), ("krank_svd",
                                                  ops["ksigma"][:k])):
        S, S1 = got[name][1].double(), want[name][1].double()
        vs_one = float(((S - S1).abs() / S1).max())
        vs_true = float(((S - sig.double()).abs() / sig.double()).max())
        out[name] = {"sigma_vs_one_process": vs_one, "sigma_vs_true": vs_true,
                     "ok": max(vs_one, vs_true) <= lim["sigma"]}
    S, W = got["akrr"]
    Z = S.apply(ops["X"], sk.ROWWISE)
    res = normal_residual(torch, Z, W, ops["Y"], ML_LAM)
    out["akrr"] = {"normal_residual": res,
                   "one_process": normal_residual(torch, Z, want["akrr"][1],
                                                  ops["Y"], ML_LAM),
                   "ok": res <= lim["normal_equations"]}
    coef, objs = got["admm"]
    coef1, objs1 = want["admm"]
    cerr = float((coef - coef1).abs().max() / coef1.abs().max())
    oerr = max(abs(a - b) / abs(b) for a, b in zip(objs, objs1))
    out["admm"] = {"coef": cerr, "objective": oerr,
                   "iterations": len(objs),
                   "ok": (cerr <= lim["admm_coef"]
                          and oerr <= lim["admm_objective"]
                          and len(objs) == size["ml"]["admm_iters"])}
    vals = lobpcg_values(torch, np, P, ops["A"], size["evd_k"], "cwt", 511,
                         got["lobpcg"][0], lobpcg_lam, ops["A"].device)
    out["lobpcg"] = {**vals, "ok": (
        vals["sketch"] <= lim["lobpcg_sketch"]
        and vals["converged"] <= lim["lobpcg_converged"]
        and vals["vs_sigma2"] <= lim["lobpcg_vs_sigma2"]
        and vals["ritz_excess"] <= lim["lobpcg_ritz"])}
    return out


def sharded_expected(cases, got, collectives, split: int) -> list:
    """The entries whose collectives differ from their design's: each
    case's per-dimension list times the splitting dimensions (LSQR: 2
    all_reduces a step and 2 to start; LOBPCG: the sketch's and one a
    product, no gather), and CommDebugMode's total equal to the port's."""
    bad = []
    for name, (_, want) in cases.items():
        c = collectives[name]
        if name == "lsqr":
            want = (2 + 2 * int(got["lsqr"][1]), 0, 0)
        if name == "lobpcg":
            ok = (c[1] == c[2] == 0 and c[0] >= 2 * split
                  and (split == 0) == (c[0] == 0))
        else:
            ok = list(c[:3]) == [w * split for w in want]
        if not ok or c[3] != sum(c[:3]):
            bad.append((name, c))
    return bad


def sharded_one_rank(torch, P, np, size) -> dict:
    """Step 2: a one-rank NCCL group and a 1 × 1 mesh: every entry point
    of the slice on DTensors against its one-process route, torch.equal
    (each route is deterministic and a 1 × 1 mesh sums nothing), no
    collective issued, each kernel of the path launched."""
    import torch.distributed as dist

    from libskylark_tpu_torch import parallel as par
    from libskylark_tpu_torch.parallel import multihost

    multihost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                     connect_timeout=120.0)
    try:
        backend = str(dist.get_backend())
        run = sharded_run(torch, P, np, par.make_mesh((1, 1)), size, "cuda",
                          extras=True)
    finally:
        dist.destroy_process_group()
    check(backend == "nccl", f"one-rank group on {backend}")
    equal = {k: sharded_equal(torch, run["got"][k], run["want"][k])
             for k in run["want"]}
    extra = {}
    for k, (g, w, exact, c) in run["extra"].items():
        extra[k] = {"bit_equal": sharded_equal(torch, g, w),
                    "collectives": c}
        if not exact:
            extra[k].update(held(torch, g, w))
        extra[k]["ok"] = ((extra[k]["bit_equal"] if exact
                           else extra[k]["ok"]) and not any(c))
    bad = [k for k, v in equal.items() if not v] + [
        k for k, v in extra.items() if not v["ok"]]
    check(not bad, f"1 × 1 mesh differs from the one-process route: {bad}")
    bad = sharded_expected(run["cases"], run["got"], run["collectives"], 0)
    check(not bad, f"1 × 1 mesh issued collectives: {bad}")
    want = sharded_launches(0, 1, size)
    bad = {k: (run["launches"][k], v) for k, v in want.items()
           if run["launches"][k] != v}
    check(not bad, f"1 × 1 mesh launches (got, expected): {bad}")
    return {"backend": backend, "bit_equal": equal, "others": extra,
            "collectives": run["collectives"], "launches": run["launches"],
            "seconds": run["seconds"]}


def sharded_child(rank: int, world: int, port: int) -> int:
    """Step 3, one of two processes sharing the card through gloo: every
    entry point on the operands row_sharded over the two ranks, then the
    one-process route in this process; prints one SHARDED_CHILD line with
    the checks, each result's digest, the collectives, the launches, the
    seconds and the peak memory."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import parallel as par
    from libskylark_tpu_torch.parallel import multihost

    import warnings

    # scipy's LOBPCG warns that it stops at its 20 iterations (C11)
    warnings.simplefilter("ignore", UserWarning)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     connect_timeout=120.0, backend="gloo")
    mesh = par.make_mesh()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    run = sharded_run(torch, P, np, mesh, SHARDED_FULL, "cuda")
    dist_s = sum(run["seconds"].values())
    A = run["ops"]["A"].double()
    lam = torch.linalg.eigvalsh(A.T @ A).flip(0)[:SHARDED_FULL["evd_k"]]
    checks = sharded_checks(torch, P, np, run, SHARDED_FULL, lam)
    print("SHARDED_CHILD " + json.dumps({
        "rank": rank, "checks": checks,
        "digests": {k: sharded_digest(torch, v)
                    for k, v in run["got"].items()},
        "collectives": run["collectives"],
        "collectives_bad": sharded_expected(run["cases"], run["got"],
                                            run["collectives"], 1),
        "launches": run["launches"], "call_seconds": run["seconds"],
        "seconds": {"setup": t1 - t0, "dist_calls": dist_s,
                    "total": time.perf_counter() - t0},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "imports_jax": "jax" in sys.modules or "libskylark_tpu" in
        sys.modules}, default=float), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_two_ranks(torch) -> dict:
    """Step 3: spawn :func:`sharded_child` twice (two gloo ranks on the
    one card) and hold what they report: every check within its limit,
    each entry point's collectives its design's list, every result the
    same bytes on both ranks, each rank's kernels launched on its block."""
    release_cache(torch)
    world, port = 2, free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-child",
         str(r), str(world), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"sharded child failed, rcs {[p.returncode for p in procs]}:\n"
          + "\n".join(x[max(x.rfind("Traceback"), 0):][-4000:]
                      for x in logs))
    reports = [json.loads(next(ln for ln in x.splitlines()
                               if ln.startswith("SHARDED_CHILD "))[14:])
               for x in logs]
    r0 = reports[0]
    bad = [k for k, v in r0["checks"].items() if not v["ok"]]
    check(not bad, f"two-rank sharded group: {bad}: {r0['checks']}")
    bad = [k for k in r0["digests"]
           if any(r["digests"][k] != r0["digests"][k] for r in reports)]
    check(not bad, f"two-rank sharded group: ranks differ on {bad}")
    check(not any(r["collectives_bad"] for r in reports),
          f"collectives: {[r['collectives_bad'] for r in reports]}")
    for r in reports:
        want = sharded_launches(r["rank"], world, SHARDED_FULL)
        bad = {k: (r["launches"][k], v) for k, v in want.items()
               if r["launches"][k] != v}
        check(not bad, f"rank {r['rank']} launches (got, expected): {bad}")
    check(not any(r["imports_jax"] for r in reports),
          "a sharded child imported jax or libskylark_tpu")
    launches = {k: sum(r["launches"][k] for r in reports)
                for k in r0["launches"]}
    return {"reports": reports, "launches": launches}


def time_offset(torch, P, peaks: dict) -> list[dict]:
    """Phase 5 row of B2 at a shard's offset: rank 1 of 2's block of
    config 4's S·[A | b] (32768 × 513 → 2048 at n0 = 32768), a new key
    per call; ``library_ms``: index_add_ against h and v of the block's
    coordinates made beforehand."""
    from libskylark_tpu_torch.sketch import cuda_hash as ch

    way, shape, s = SHARDED_HASH[0]
    n0 = shape[0] // 2
    A = make_operand(torch, (shape[0] - n0, shape[1]), 8)
    ctx = P.Context(11)
    n, m = A.shape
    h, v = ch.streams(ctx.allocate().key, n, s, A.device, n0)
    row = {"kernel": "hash_offset",
           "use": "rank 1 of 2: CWT columnwise on a DTensor",
           "main_path": True, "shape": list(A.shape), "s_dim": s, "n0": n0,
           "ms": event_ms(torch, lambda: ch.cwt_apply(
               ctx.allocate().key, A, s, False, n0)),
           "device_ms": profiled_device_ms(torch, lambda: ch.cwt_apply(
               ctx.allocate().key, A, s, False, n0)),
           "plain_ms": event_ms(torch, lambda: ch.cwt_apply_plain(
               ctx.allocate().key, A, s, False, n0)),
           "library_ms": event_ms(torch, lambda: ch.scatter(h, v, A, s,
                                                            False)),
           **bound(2.0 * m * n, peaks["fp32_flops"], 4.0 * (m * n + m * s),
                   peaks)}
    del A
    return [row]


def sharded_phase(torch, P, np, peaks) -> dict:
    """Phase 4g: A5b on the card. Step 1 (emulated ranks) checks B2 at a
    shard's offset; steps 2 and 3 are the main path through the public
    entry points on DTensors, with every launch counter set to 0 before
    (the children start from 0) and read after; step 4 times B2 at an
    offset. Prints its seconds and the card's peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emulated = sharded_emulated(torch, P)
    bad = [r for r in emulated if not r["ok"]]
    check(not bad, f"B2 at an offset: {bad}")
    t1 = time.perf_counter()
    one = sharded_one_rank(torch, P, np, SHARDED_FULL)
    two = sharded_two_ranks(torch)
    launches = {k: one["launches"][k] + two["launches"][k]
                for k in one["launches"]}
    main_s = time.perf_counter() - t1
    rows = time_offset(torch, P, peaks)
    out = {"emulated": emulated, "one_rank": one,
           "two_ranks": two["reports"], "launches": launches,
           "rows": rows, "main_path_seconds": main_s,
           "seconds": time.perf_counter() - t0,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit("sharded", **{k: v for k, v in out.items() if k != "rows"})
    for k in SHARDED_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the sharded "
                               "path")
    return out


# phase 4h: the executable cache at full width (configs 4 and 5, the LS
# cell); "exact_rows" is ml-rlsc-faster's 16,384 rows
COMPILED_FULL = {"svd_n": 8192, "svd_r": 512, "rank": 64, "q": 2,
                 "ls_rows": 65536, "ls_cols": 512, "ls_s": 2048,
                 "n": 60000, "test": 10000, "d": 784, "classes": 10,
                 "latent": 16, "center": 1.0, "noise": 1.0, "s": 8192,
                 "exact_rows": 16384, "poly_s": 2048, "pinned_rows": 16384,
                 "reps": 5, "budget_shapes": 8, "budget_gib": 1.0}
# each compiled entry's kernel, which must launch from inside its replay
COMPILED_KERNELS = {"svd": "dense_rowwise", "symmetric_svd": "dense_rowwise",
                    "solve_jlt": "dense_columnwise",
                    "solve_cwt": "hash_columnwise",
                    "solve_fjlt_wht": "fwht_columnwise",
                    "precond_lsrn": "dense_columnwise",
                    "approximate_krr": "dense_rowwise_cos",
                    # PPT's CountSketches, sub-transforms of the argument
                    "approximate_krr_poly": "hash_columnwise"}


def compiled_cases(torch, P, size, device) -> dict:
    """name -> (CompiledFn, make(ctx, variant) -> (args, statics), the
    eager body, entry(ctx), the public entry point's call): the compiled
    entries of the phase. ``make`` allocates what the entry point
    allocates from ``ctx``, in its order; ``variant`` 1 is another input
    where a body has no seed (λ for kernel_ridge, the coefficients for
    krr_predict)."""
    from libskylark_tpu_torch import algorithms, engine, ml, nla, sketch as sk
    from libskylark_tpu_torch.algorithms import regression as reg
    from libskylark_tpu_torch.ml import krr
    from libskylark_tpu_torch.nla import svd as nsvd

    n, k, q = size["svd_n"], size["rank"], size["q"]
    A, _ = svd_operand(torch, n, size["svd_r"], device)
    Asym = 0.5 * (A + A.T)
    params = nla.ApproximateSVDParams(num_iterations=q)
    kp = 2 * k
    st_svd = dict(k=k, kp=kp, num_iterations=q, skip_qr=False,
                  ortho="cqr2", rr="cqr2")
    st_sym = {key: v for key, v in st_svd.items() if key != "rr"}
    m, c, s = size["ls_rows"], size["ls_cols"], size["ls_s"]
    g = torch.Generator(device=device).manual_seed(3)
    Als = torch.randn(m, c, generator=g, device=device)
    bls = Als @ torch.randn(c, generator=g, device=device) + 0.1 * torch.randn(
        m, generator=g, device=device)
    accel = algorithms.AcceleratedParams()
    X, y, Xte, _ = ml_data(torch, size, device)
    kern = ml_kernel(ml, size)
    Y = ml.dummy_coding(y, device=device)[0]
    ne = size["exact_rows"]
    Xe, Ye = X[:ne].contiguous(), Y[:ne].contiguous()

    def lam_of(variant):
        return torch.as_tensor(ML_LAM * (1 + variant),
                               dtype=X.dtype).to(device)

    exact = engine.compiled(krr._exact_program(kern), name="kernel_ridge",
                            donate_argnums=(0, 1), donate="auto",
                            key_fn=lambda *a, **kw: (engine.digest(kern),))
    coef = exact(Xe, Ye, lam_of(0))
    predict = engine.compiled(krr._predict_program(kern), name="krr_predict",
                              key_fn=lambda *a: (engine.digest(kern),))
    features = engine.compiled(krr._features_ridge,
                               name="approximate_kernel_ridge",
                               donate_argnums=(0, 1), donate="auto",
                               key_fn=lambda *a, **kw: ())
    solve = reg._sketch_and_solve_compiled

    def solve_case(family, A=Als, b=bls, **kw):
        return (solve,
                lambda ctx, v: ((A, b[:, None], family(A.shape[0], s, ctx,
                                                       **kw)),
                                {"method": "qr"}),
                reg._sketch_and_solve,
                lambda ctx: algorithms.solve_l2_sketched(
                    A, b, family(A.shape[0], s, ctx, **kw), device=device))

    def pinned(N, S, ctx):
        # a pinned operator (materialize()) on a route no kernel takes
        return sk.JLT(N, S, ctx).materialize(torch.float64, device)

    mp = size["pinned_rows"]
    poly = ml.Polynomial(size["d"], q=3, c=1.0, gamma=1.0 / size["d"])

    return {
        "svd": (nsvd._svd_compiled,
                lambda ctx, v: ((A, sk.JLT(n, kp, ctx)), st_svd),
                nsvd._svd_pipeline,
                lambda ctx: nla.approximate_svd(A, k, ctx, params,
                                                device=device)),
        "symmetric_svd": (nsvd._symmetric_svd_compiled,
                          lambda ctx, v: ((Asym, sk.JLT(n, kp, ctx)),
                                          st_sym),
                          nsvd._symmetric_svd_pipeline,
                          lambda ctx: nla.approximate_symmetric_svd(
                              Asym, k, ctx, params, device=device)),
        "solve_jlt": solve_case(sk.JLT),
        "solve_cwt": solve_case(sk.CWT),
        "solve_fjlt_wht": solve_case(sk.FJLT, fut="wht"),
        "solve_ust": solve_case(sk.UST),
        "solve_pinned": solve_case(pinned, Als[:mp].double(),
                                   bls[:mp].double()),
        "precond_blendenpik": (
            reg._precond_compiled,
            lambda ctx, v: ((Als, reg._accel_transform(m, c, ctx, accel)),
                            {"method": "blendenpik"}),
            reg._precond_body,
            lambda ctx: algorithms.build_blendenpik_precond(
                Als, ctx, accel, device=device)),
        "precond_lsrn": (
            reg._precond_compiled,
            lambda ctx, v: ((Als, reg._accel_transform(m, c, ctx, accel,
                                                       gaussian=True)),
                            {"method": "lsrn"}),
            reg._precond_body,
            lambda ctx: algorithms.build_lsrn_precond(
                Als, ctx, accel, device=device)),
        "approximate_krr": (
            features,
            lambda ctx, v: ((X, Y, lam_of(0),
                             kern.create_rft(size["s"], ctx, "regular")),
                            {}),
            krr._features_ridge,
            lambda ctx: ml.approximate_kernel_ridge(
                kern, X, Y, ML_LAM, size["s"], ctx, device=device)),
        "approximate_krr_poly": (
            features,
            lambda ctx, v: ((Xe, Ye, lam_of(0),
                             poly.create_rft(size["poly_s"], ctx, "regular")),
                            {}),
            krr._features_ridge,
            lambda ctx: ml.approximate_kernel_ridge(
                poly, Xe, Ye, ML_LAM, size["poly_s"], ctx, device=device)),
        "kernel_ridge": (
            exact, lambda ctx, v: ((Xe, Ye, lam_of(v)), {}),
            krr._exact_program(kern),
            lambda ctx: ml.kernel_ridge(kern, Xe, Ye, ML_LAM, device=device)),
        "krr_predict": (
            predict, lambda ctx, v: ((Xte, Xe, coef * (1 + v)), {}),
            krr._predict_program(kern),
            lambda ctx: ml.krr_predict(kern, Xte, Xe, coef, device=device)),
    }


def clone_tree(torch, x):
    return (tuple(clone_tree(torch, t) for t in x) if isinstance(x, tuple)
            else x.clone())


def compiled_entry(torch, P, name, case, cuda: bool, reps: int) -> dict:
    """The checks and figures of one compiled entry (module docstring,
    phase 4h); the engine is reset first, so its counters are this
    entry's."""
    import itertools

    from libskylark_tpu_torch import engine

    cf, make, body, entry = case
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kernel = COMPILED_KERNELS.get(name)
    engine.reset()
    launched = {key: 0 for key in launch_counts()}

    def counted(fn, route=False):
        for cs in counters():
            for key in cs:
                cs[key] = 0
        t0 = time.perf_counter()
        r = fn()
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        got = launch_counts()
        if route:  # launches of the compiled route, for the phase's total
            for key, v in got.items():
                launched[key] += v
        return r, got, dt

    args1, st = make(P.Context(1601), 0)
    ref1, eager_counts, _ = counted(lambda: body(*args1, **st))
    out1, _, cold_ms = counted(lambda: cf(*args1, **st), True)
    check(same(torch, out1, ref1),
          f"compiled {name}: the first call differs from the eager body")
    first = clone_tree(torch, out1)
    out1b, replay_counts, _ = counted(lambda: cf(*args1, **st), True)
    check(same(torch, out1b, ref1),
          f"compiled {name}: a replay differs from the eager body")
    check(replay_counts == eager_counts,
          f"compiled {name}: a replay's launches {replay_counts} are not "
          f"the eager body's {eager_counts}")
    if cuda and kernel:
        check(replay_counts[kernel] >= 1,
              f"compiled {name}: no {kernel} launch inside the replay")
    args2, st2 = make(P.Context(1602), 1)
    ref2, _, _ = counted(lambda: body(*args2, **st2))
    out2, _, _ = counted(lambda: cf(*args2, **st2), True)
    check(same(torch, out2, ref2),
          f"compiled {name}: a replay under a second seed (or input) "
          "differs from the eager body")
    check(not same(torch, ref2, ref1),
          f"compiled {name}: the second seed's result is the first's")
    check(same(torch, out1, first),
          f"compiled {name}: the first result changed after later calls")
    c_entry, c_eager = P.Context(1603), P.Context(1603)
    counted(lambda: entry(c_entry), True)
    make(c_eager, 0)
    check(c_entry.counter == c_eager.counter,
          f"compiled {name}: the entry point advanced its Context to "
          f"{c_entry.counter}, the eager route to {c_eager.counter}")
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
        try:
            cf(*args2, **st2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync()
    stats = engine.stats()
    entries = engine.cache().snapshot()
    check(stats.misses == 1 and stats.compiles == 1 and len(entries) == 1,
          f"compiled {name}: {stats.misses} misses, {stats.compiles} "
          f"materializations and {len(entries)} entries, not 1")
    check(stats.hits == (4 if cuda else 3),
          f"compiled {name}: {stats.hits} hits")
    row = {"cold_ms": cold_ms, "pool_bytes": entries[0]["pool_bytes"],
           "replay_launches": {key: v for key, v in replay_counts.items()
                               if v},
           "launches": launched}
    if cuda:
        row.update(compiled_times(torch, lambda: cf(*args2, **st2),
                                  lambda: body(*args2, **st2), reps))
        # a new operand every call: each hit copies its tensors in
        other = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args2)
        calls = itertools.cycle((other, args2))
        row["replay_copy_warm_ms"] = compiled_times(
            torch, lambda: cf(*next(calls), **st2), None,
            reps)["replay_warm_ms"]
    return row


def compiled_times(torch, replay, eager, reps: int) -> dict:
    """Warm host ms (median of ``reps`` synchronized calls after one),
    device ms (torch.profiler, mean of 3) and busy of the replay and of
    the eager body (None: not timed)."""
    out = {}
    for label, fn in (("replay", replay), ("eager", eager)):
        if fn is None:
            continue
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        warm = statistics.median(times)
        dev = profiled_device_ms(torch, fn, reps=3)
        out[f"{label}_warm_ms"] = warm
        out[f"{label}_device_ms"] = dev
        out[f"{label}_busy"] = dev / warm
    return out


def compiled_cells(torch, P, size=COMPILED_FULL, device="cuda") -> tuple:
    """(entry rows, the compiled routes' launches): every compiled entry
    through :func:`compiled_entry`, the engine reset after each."""
    from libskylark_tpu_torch import engine

    cuda = device == "cuda"
    entries = {}
    launches = {key: 0 for key in launch_counts()}
    for name, case in compiled_cases(torch, P, size, device).items():
        entries[name] = compiled_entry(torch, P, name, case, cuda,
                                       size["reps"])
        for key, v in entries[name].pop("launches").items():
            launches[key] += v
        engine.reset()
    return entries, launches


def compiled_budget(torch, P, size) -> dict:
    """The executable cache's device-memory bound: sketch-and-solve at
    ``budget_shapes`` distinct widths of the LS operand, one capture each,
    with no reset between them under a budget of ``budget_gib``; what
    the cached graphs hold stays within it, the least recent entries are
    evicted, and the memory allocated after the last call is within the
    budget of what it was before the first (plus that call's result)."""
    from libskylark_tpu_torch import algorithms, engine, sketch as sk

    m, c, s = size["ls_rows"], size["ls_cols"], size["ls_s"]
    budget = int(size["budget_gib"] * 2**30)
    g = torch.Generator(device="cuda").manual_seed(5)
    A = torch.randn(m, c, generator=g, device="cuda")
    b = torch.randn(m, generator=g, device="cuda")
    saved, engine.cache().max_bytes = engine.cache().max_bytes, budget
    engine.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    held, x = [], None
    try:
        for i in range(size["budget_shapes"]):
            w = c - 8 * i
            x = algorithms.solve_l2_sketched(A[:, :w], b,
                                             sk.JLT(m, s, P.Context(i)),
                                             device="cuda")
            held.append(engine.cache().nbytes())
            check(held[-1] <= budget or len(engine.cache()) == 1,
                  f"compiled budget: the cache holds {held[-1]} bytes past "
                  f"its budget of {budget}")
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
    finally:
        engine.cache().max_bytes = saved
    st = engine.stats()
    misses, evictions = st.misses, st.evictions
    check(misses == size["budget_shapes"] and evictions > 0,
          f"compiled budget: {misses} misses, {evictions} evictions")
    check(grown <= budget + x.numel() * x.element_size(),
          f"compiled budget: {grown} bytes more allocated after "
          f"{size['budget_shapes']} captures, budget {budget}")
    kept = len(engine.cache())
    engine.reset()
    return {"budget_bytes": budget, "held_bytes": held,
            "evictions": evictions, "grown_bytes": grown,
            "entries": kept}


def compiled_phase(torch, P, np, size=COMPILED_FULL, device="cuda") -> dict:
    """Phase 4h: the executable cache at full width: each compiled entry
    point's replay against its eager body (module docstring)."""
    cuda = device == "cuda"
    if cuda:  # the phase's own peak, not the process's
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    entries, launches = compiled_cells(torch, P, size, device)
    for key in COMPILED_KERNELS.values():
        check(not cuda or launches[key] > 0,
              f"compiled phase: no {key} launch")
    out = {"size": dict(size), "entries": entries, "launches": launches}
    if cuda:
        out["budget"] = compiled_budget(torch, P, size)
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["card"] = smi("name,power.limit")
    emit("compiled", **out)
    return out


# the serve kernels of the captured sketch flushes: each must launch
# inside a graph replay (kernels.launch.replayed)
REPLAYED_KERNELS = ("dense_batched_rowwise", "dense_batched_columnwise",
                    "hash_batched", "fwht_batched", "fastfood_batched")
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
    "dense_partial_rowwise": (CSRC + "dense_sketch.cu",
                              "libskylark_tpu/sketch/pallas_dense.py:786"),
    "dense_partial_columnwise": (CSRC + "dense_sketch.cu",
                                 "libskylark_tpu/sketch/pallas_dense.py:786"),
    "hash_offset": (CSRC + "hash_sketch.cu",
                    "libskylark_tpu/sketch/pallas_hash.py:423"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child(*(int(a) for a in sys.argv[2:5]))
    if sys.argv[1:2] == ["--sharded-child"]:
        return sharded_child(*(int(a) for a in sys.argv[2:5]))
    if sys.argv[1:2] == ["--flush-child"]:
        return flush_child(json.loads(sys.argv[2]))
    sys.path.insert(0, str(ROOT))
    import libskylark_tpu_torch as P

    check(Path(P.__file__).resolve().parent.parent == ROOT,
          f"libskylark_tpu_torch imported from {P.__file__}, not {ROOT}")
    from libskylark_tpu_torch.kernels import build, launch

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
    # every phase reaches the solver entry points through the executable
    # cache: each ends by dropping its graphs (release_cache)
    main = main_path(torch, P)
    release_cache(torch)
    serve = serve_phase(torch, P, np)
    emit("serve_cells", cells=serve_cells(torch, np))
    release_cache(torch)
    wphase = warmup_phase(torch, P, np)
    release_cache(torch)
    ssolve = serve_solve_phase(torch, P, np)
    release_cache(torch)
    sqos = serve_qos_phase(torch, P, np)
    release_cache(torch)
    sparse = sparse_phase(torch, P, np, peaks)
    release_cache(torch)
    ml_path = ml_phase(torch, P, np)
    release_cache(torch)
    a3 = a3_phase(torch, P, np)
    release_cache(torch)
    dphase = dist_phase(torch, P, np, peaks)
    checked += dphase["emulated"]
    release_cache(torch)
    sphase = sharded_phase(torch, P, np, peaks)
    checked += sphase["emulated"]
    release_cache(torch)
    cphase = compiled_phase(torch, P, np)
    release_cache(torch)
    rows = (time_kernels(torch, P, MAIN_SHAPES, True, peaks)
            + time_kernels(torch, P, SPLIT_LS_SHAPES, False, peaks)
            + time_hash(torch, P, HASH_SHAPES, peaks)
            + time_fwht(torch, P, FWHT_SHAPES, peaks)
            + time_cos(torch, P, peaks) + time_fastfood(torch, P, peaks)
            + time_serve_kernels(torch, P, np, peaks) + dphase["rows"]
            + sphase["rows"])
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
                                  "at idx), D and idx made beforehand",
                  "dense_partial": "torch.matmul against the rank's panel "
                                   "of S made beforehand (TF32 off)",
                  "hash_offset": "index_add_ of v·A at h, h and v of the "
                                 "block's coordinates made beforehand"},
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
        # the Matern cases, held entry by entry, apart
        matern = [c for c in cs if "matern_nu" in c]
        cs = [c for c in cs if "matern_nu" not in c]
        check(bool(cs), f"{name}: no check at its main-path shapes")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (main["launches"][name] + serve["launches"][name]
                         + wphase["launches"][name]
                         + ssolve["launches"][name]
                         + sqos["launches"][name]
                         + sparse["launches"][name]
                         + ml_path["launches"][name]
                         + a3["launches"][name]
                         + dphase["launches"][name]
                         + sphase["launches"][name]
                         + cphase["launches"][name]),
            "replay_launches": launch.replayed[name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "shape": head["shape"], "s_dim": head["s_dim"],
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **{k: head[k] for k in ("regime", "f32_ms", "bounds")
               if k in head},
            **({"matern": {
                "max_abs_err": max(c["max_abs_err"] for c in matern),
                "max_err_over_limit": max(c["max_err_over_limit"]
                                          for c in matern),
                "ms": [r["ms"] for r in rows if r["kernel"] == name
                       and r.get("use", "").startswith("MaternRFT")]}}
               if matern else {})})
    for name in REPLAYED_KERNELS:
        check(launch.replayed[name] > 0,
              f"{name} was never launched inside a graph replay")
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
