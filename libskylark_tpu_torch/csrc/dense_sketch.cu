// Dense sketch for Hopper (sm_90a): generate the operator, contract it.
//
// Replaces the TPU kernels of libskylark_tpu/sketch/pallas_dense.py:
//   rowwise    out = scale * A * S^T   (_fused_call -> _kernel / _kernel_pipe)
//   columnwise out = scale * S * A     (_fused_call_cw -> _kernel_cw /
//                                        _kernel_pipe_cw)
//   rowwise with the random-feature epilogue (_fused_call_cos ->
//   _kernel_cos / _kernel_pipe_cos, _apply_epilogue)
//              out = outscale * cos((A * S^T) * inscale * sc + sh)
//   where sc and sh are per-feature vectors indexed by the output column.
//   batched (_batched_call -> _kernel_batched_rw / _kernel_batched_cw):
//              out[b] = A[b] * (scale[b] S_b)^T  or  (scale[b] S_b) * A[b]
//   over a stacked microbatch cohort, each lane b with its own key and
//   scale.
// S (s_dim x n) is the virtual dense-block operator of base/randgen.py,
// generated on the card from the transform's 2-word key and never stored
// whole: block k's key is chunk_key(key, k), and one Threefry-2x32-20 call
// at counter c = r*128 + j (r the operator row, j < 128) under it gives
// column j of block k (word 0) and column 128 + j (word 1, second counter
// c + s_dim*128). The bits map to values with exactly the f32 operations of
// base/threefry.py.
//
// Contraction regimes (pallas_dense.py _dot), x = hi + lo with hi the
// round-to-nearest bf16 of x and lo = bf16(x - hi):
//   bf16x3   (default) hi*hi + hi*lo + lo*hi, three bf16 passes
//   bf16gen2 the operator rounded to bf16, only the data split: two passes
//   bf16     one pass on rounded operands
//   f32      fp32 FMA on the CUDA cores (the fp32 body further below)
//
// The bf16 regimes run in three kernels per call, all on the caller's
// stream:
// 1. dense_gen_kernel writes one chunk of n of the operator as bf16 planes
//    (hi, and lo for bf16x3) into a workspace the wrapper allocates, already
//    in the swizzled layout of a wgmma B tile (csrc/hopper.cuh): each entry
//    is generated once per call (s_dim * n per lane), where the fp32 body
//    regenerates it once per m-tile. The workspace holds at most
//    kWorkspaceCap bytes per lane, whatever n is; a longer n is walked in
//    chunks, the contraction of chunk c + 1 adding onto that of chunk c.
// 2. dense_tc_kernel: each block owns a 128 x BN output tile (BN = 64 or
//    128 operator rows) and a share of the chunk's k-blocks (64 deep). A
//    producer warpgroup (40 registers a thread, setmaxnreg) fills a ring
//    of shared-memory stages guarded by mbarriers, from one thread: per
//    k-block it bulk-copies the operator planes (one contiguous run per
//    k-block and plane) and loads A's 128 x 64 fp32 tile through a TMA
//    tensor map (boxes of 32 floats with the 128-byte swizzle; rows ld
//    floats apart, ld a multiple of 4; zeros past m or n).
//    Two consumer warpgroups (232 registers), 64 data rows each, read
//    their wgmma register fragments of A from the tile, split them into
//    bf16 hi and lo, and issue the regime's passes as m64nBNk16 wgmma
//    with the operator planes as the shared-memory operand. One body
//    serves both orientations of the data X[i][k] (rowwise X = A,
//    columnwise X = A^T, its tile kept in A's layout and its output tile
//    stored transposed). Each k-block's passes go to a scratch
//    accumulator that is then added to the running sum with fp32 adds: the
//    tensor cores truncate the sums they form, and over n = 65536 that
//    alone reached 8e-5 of max|out|.
// 3. When a thin output leaves SMs idle, n is split across blocks (split
//    partial sums per tile) and dense_tc_finish adds the partials in split
//    order: no atomics, so a result is the same run to run. The scale and
//    the cos epilogue are applied once, to the finished sum, in
//    _apply_epilogue's order with every product and sum rounded on its own
//    and the accurate cosf (never build with --use_fast_math: phases reach
//    O(10)).
//
// Bound on this card: regime passes * 2*m*n*s_dim flops on the bf16 tensor
// cores (bytes moved: A once plus the output once), and s_dim * n entries
// of Threefry and erfinv/tanf on the CUDA cores. At a thin output (least
// squares' S * [A | b], s_dim = 2048 over n = 65536) the generation pass is
// the larger of the two. Every block copies its A and operator tiles from
// L2 (64 KiB per k-block at BN = 128 in bf16x3). Feeding A by 16-byte
// cp.async from all 128 producer threads made that feed the limit; one
// thread issuing TMA boxes took 0.56 of its time at 8192^2 -> 1024
// (PERF.md).
//
// Scale order: in the batched launch the bf16 regimes scale the generated
// entries before they are rounded, as the reference's batched kernel does;
// every other launch multiplies the finished sum by the scale, as the
// reference's rowwise_apply and columnwise_apply do. The plan (tile width,
// split, chunk) reads one lane's (m, n, s_dim), never the lane count, so a
// lane's bits do not depend on how many lanes share the launch (the serve
// layer's capacity invariance).
//
// The f32 regime keeps the first design: a plain shared-memory SGEMM tiling
// (256 threads, 8x8 or 4x4 outputs per thread, 32-deep k-steps) that
// regenerates its operator tile for every m-tile and sums over n in one
// fixed order per block, scaling the finished sum in every variant.

#include <cuda.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "threefry.cuh"

namespace {

constexpr int kHalf = 128;       // BLOCK_COLS / 2: counters per row per block
constexpr int kT = 16;           // counters per k-step
constexpr int kBK = 2 * kT;      // operator columns per k-step: kT per half
constexpr int kThreads = 256;
constexpr int kPad = 4;          // keeps float4 rows aligned, splits banks

enum Dist { kNormal = 0, kCauchy = 1, kRademacher = 2 };

using sk::threefry2x32;

// f32 erfinv by the reference's algorithm (XLA's ErfInv32, Giles 2010),
// term for term as base/threefry.py erfinv_f32: products and sums are
// rounded separately (no FMA contraction), as the plain version rounds.
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p;
  if (lt) {
    p = 2.81022636e-08f;
    p = __fadd_rn(3.43273939e-07f, __fmul_rn(p, w));
    p = __fadd_rn(-3.5233877e-06f, __fmul_rn(p, w));
    p = __fadd_rn(-4.39150654e-06f, __fmul_rn(p, w));
    p = __fadd_rn(0.00021858087f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00125372503f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00417768164f, __fmul_rn(p, w));
    p = __fadd_rn(0.246640727f, __fmul_rn(p, w));
    p = __fadd_rn(1.50140941f, __fmul_rn(p, w));
  } else {
    p = -0.000200214257f;
    p = __fadd_rn(0.000100950558f, __fmul_rn(p, w));
    p = __fadd_rn(0.00134934322f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00367342844f, __fmul_rn(p, w));
    p = __fadd_rn(0.00573950773f, __fmul_rn(p, w));
    p = __fadd_rn(-0.0076224613f, __fmul_rn(p, w));
    p = __fadd_rn(0.00943887047f, __fmul_rn(p, w));
    p = __fadd_rn(1.00167406f, __fmul_rn(p, w));
    p = __fadd_rn(2.83297682f, __fmul_rn(p, w));
  }
  return __fmul_rn(p, x);
}

// bits -> value, the f32 operations of base/threefry.py bits_to_*.
template <int DIST>
__device__ __forceinline__ float from_bits(uint32_t b) {
  if (DIST == kRademacher) return (b >> 31) ? -1.0f : 1.0f;
  const float u = (float)(int)(b >> 8) * 5.9604644775390625e-8f;  // 2^-24
  if (DIST == kNormal) {
    const float v = fminf(fmaxf(2.0f * u - 1.0f, -1.0f + 1.1920928955078125e-7f),
                          1.0f - 1.1920928955078125e-7f);  // 1 -/+ 2^-23
    return __fmul_rn(1.41421356237309515f, erfinv_f32(v));
  }
  const float v = fminf(fmaxf(u, 5.9604644775390625e-8f),
                        1.0f - 5.9604644775390625e-8f);  // 2^-24, 1 - 2^-24
  return tanf(3.14159265358979312f * (v - 0.5f));
}

// acc[i][j] += X[k][row_i] * Y[k][col_j] over the k-step. Thread (ty, tx)
// owns rows g*64 + ty*4 + {0..3} and columns g*64 + tx*4 + {0..3}, so
// both operands are read as float4 without bank conflicts.
template <int TILE>
__device__ __forceinline__ void fma_tile(const float (&X)[kBK][TILE + kPad],
                                         const float (&Y)[kBK][TILE + kPad],
                                         float (&acc)[TILE / 16][TILE / 16],
                                         int tx, int ty) {
  constexpr int MICRO = TILE / 16;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float x[MICRO], y[MICRO];
#pragma unroll
    for (int g = 0; g < MICRO / 4; ++g) {
      const float4 xv = *reinterpret_cast<const float4*>(&X[kk][g * 64 + ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&Y[kk][g * 64 + tx * 4]);
      x[g * 4 + 0] = xv.x; x[g * 4 + 1] = xv.y; x[g * 4 + 2] = xv.z; x[g * 4 + 3] = xv.w;
      y[g * 4 + 0] = yv.x; y[g * 4 + 1] = yv.y; y[g * 4 + 2] = yv.z; y[g * 4 + 3] = yv.w;
    }
#pragma unroll
    for (int i = 0; i < MICRO; ++i)
#pragma unroll
      for (int j = 0; j < MICRO; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// One block: one TILE x TILE output tile. ROWWISE: A is (m, n), output
// (m, s_dim), tile rows index m. Columnwise: A is (n, m), output
// (s_dim, m), tile rows index the operator. blockIdx.x walks m and
// blockIdx.y walks the operator rows in both orientations. The 64-wide
// tile is held to 64 registers so that four blocks fit on an SM: a thin
// output's grid (e.g. 9 x 32 blocks for least squares' S * [A | b]) then
// runs in one wave instead of two.
template <int TILE, bool ROWWISE, int DIST, bool COS>
__global__ void __launch_bounds__(kThreads, TILE == 64 ? 4 : 2)
dense_sketch_kernel(const float* __restrict__ A, uint32_t key0, uint32_t key1,
                    float* __restrict__ out, int64_t m, int64_t n, int s_dim,
                    int64_t ld, float scale, const float* __restrict__ sc,
                    const float* __restrict__ sh, float outscale,
                    const uint32_t* __restrict__ keys, const float* __restrict__ scales,
                    int64_t a_lane, int64_t out_lane) {
  constexpr int MICRO = TILE / 16;
  if (keys != nullptr) {  // batched: lane blockIdx.z's key, scale and extents
    const int64_t z = blockIdx.z;
    key0 = keys[2 * z];
    key1 = keys[2 * z + 1];
    scale = scales[z];
    A += z * a_lane;
    out += z * out_lane;
  }
  __shared__ __align__(16) float As[kBK][TILE + kPad];  // [k][index into m]
  __shared__ __align__(16) float Ss[kBK][TILE + kPad];  // [k][operator row]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * TILE;
  const int s0 = blockIdx.y * TILE;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.0f;

  const int64_t n_blocks = (n + 2 * kHalf - 1) / (2 * kHalf);
  for (int64_t kb = 0; kb < n_blocks; ++kb) {
    // block kb's key: two cipher calls, uniform across the block
    uint32_t k0 = key0, k1 = key1;
    sk::chunk_key(k0, k1, kb);
    for (int j0 = 0; j0 < kHalf; j0 += kT) {
      // k-step columns: [c_lo, c_lo + kT) then [c_lo + 128, c_lo + 128 + kT)
      const int64_t c_lo = kb * 2 * kHalf + j0;
      if (c_lo >= n) break;  // uniform across the block
      const int64_t c_hi = c_lo + kHalf;

      if (ROWWISE) {
        // lanes run along k: one row's 2 x 64 contiguous bytes per warp
        for (int e = tid; e < TILE * kBK; e += kThreads) {
          const int kk = e % kBK, i = e / kBK;
          const int64_t row = m0 + i;
          const int64_t col = kk < kT ? c_lo + kk : c_hi + (kk - kT);
          As[kk][i] = (row < m && col < n) ? __ldg(A + row * ld + col) : 0.0f;
        }
      } else {
        // lanes run along m: coalesced rows of A
        for (int e = tid; e < TILE * kBK; e += kThreads) {
          const int i = e % TILE, kk = e / TILE;
          const int64_t col = m0 + i;
          const int64_t row = kk < kT ? c_lo + kk : c_hi + (kk - kT);
          As[kk][i] = (row < n && col < m) ? __ldg(A + row * ld + col) : 0.0f;
        }
      }

      for (int e = tid; e < TILE * kT; e += kThreads) {
        const int r = e % TILE, j = e / TILE;
        const int srow = s0 + r;
        float v0 = 0.0f, v1 = 0.0f;
        if (srow < s_dim) {
          uint32_t x0 = (uint32_t)srow * kHalf + (uint32_t)(j0 + j);
          uint32_t x1 = x0 + (uint32_t)s_dim * kHalf;
          threefry2x32(k0, k1, x0, x1);
          v0 = from_bits<DIST>(x0);
          v1 = from_bits<DIST>(x1);
        }
        Ss[j][r] = v0;
        Ss[kT + j][r] = v1;
      }
      __syncthreads();
      if (ROWWISE)
        fma_tile<TILE>(As, Ss, acc, tx, ty);
      else
        fma_tile<TILE>(Ss, As, acc, tx, ty);
      __syncthreads();
    }
  }

  const int64_t rows = ROWWISE ? m : (int64_t)s_dim;
  const int64_t cols = ROWWISE ? (int64_t)s_dim : m;
  const int64_t r0 = ROWWISE ? m0 : (int64_t)s0;
  const int64_t q0 = ROWWISE ? (int64_t)s0 : m0;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int64_t row = r0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int64_t col = q0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (col >= cols) continue;
      if (COS) {
        // outscale * cos(acc * inscale * sc + sh), scale being inscale
        const float z = __fadd_rn(__fmul_rn(__fmul_rn(acc[i][j], scale), sc[col]), sh[col]);
        out[row * cols + col] = __fmul_rn(outscale, cosf(z));
      } else {
        out[row * cols + col] = scale * acc[i][j];
      }
    }
  }
}

// Lane arguments of a launch: keys (B, 2) and scales (B,) on the card, and
// the per-lane strides of A and out; keys == nullptr for one lane whose key
// and scale are arguments.
struct Lanes {
  const uint32_t* keys;
  const float* scales;
  int64_t count, a_lane, out_lane;
};

template <int TILE, bool ROWWISE, bool COS>
cudaError_t launch_tile(const float* A, uint32_t key0, uint32_t key1, float* out, int64_t m,
                        int64_t n, int64_t s_dim, int64_t ld, int dist, float scale,
                        const float* sc, const float* sh, float outscale, Lanes ln,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)((m + TILE - 1) / TILE), (unsigned)((s_dim + TILE - 1) / TILE),
                  (unsigned)ln.count);
  const int s = (int)s_dim;
  switch (dist) {
    case kNormal:
      dense_sketch_kernel<TILE, ROWWISE, kNormal, COS><<<grid, kThreads, 0, stream>>>(
          A, key0, key1, out, m, n, s, ld, scale, sc, sh, outscale, ln.keys, ln.scales,
          ln.a_lane, ln.out_lane);
      break;
    case kCauchy:
      dense_sketch_kernel<TILE, ROWWISE, kCauchy, COS><<<grid, kThreads, 0, stream>>>(
          A, key0, key1, out, m, n, s, ld, scale, sc, sh, outscale, ln.keys, ln.scales,
          ln.a_lane, ln.out_lane);
      break;
    case kRademacher:
      dense_sketch_kernel<TILE, ROWWISE, kRademacher, COS><<<grid, kThreads, 0, stream>>>(
          A, key0, key1, out, m, n, s, ld, scale, sc, sh, outscale, ln.keys, ln.scales,
          ln.a_lane, ln.out_lane);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// 128-wide tiles when they give at least two blocks per SM, else 64-wide
// ones (a thin output, e.g. the SVD range sketch or least squares' S*A,
// would leave most SMs idle). The tile changes no sum order. The choice
// reads one lane's (m, s_dim), never the lane count.
template <bool ROWWISE, bool COS>
cudaError_t launch(const float* A, uint32_t key0, uint32_t key1, float* out, int64_t m, int64_t n,
                   int64_t s_dim, int64_t ld, int dist, float scale, const float* sc,
                   const float* sh, float outscale, Lanes ln, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || s_dim <= 0 || ld < (ROWWISE ? n : m) ||
      (s_dim + 63) / 64 > 65535 || (m + 63) / 64 > 0x7FFFFFFF ||
      s_dim * kHalf > 0xFFFFFFFFLL || (COS && (sc == nullptr || sh == nullptr)) ||
      ln.count < 1 || ln.count > 65535 || (ln.count > 1 && ln.keys == nullptr))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t big_tiles = ((m + 127) / 128) * ((s_dim + 127) / 128);
  if (big_tiles >= 2 * (int64_t)sms)
    return launch_tile<128, ROWWISE, COS>(A, key0, key1, out, m, n, s_dim, ld, dist, scale, sc,
                                          sh, outscale, ln, stream);
  return launch_tile<64, ROWWISE, COS>(A, key0, key1, out, m, n, s_dim, ld, dist, scale, sc, sh,
                                       outscale, ln, stream);
}

constexpr Lanes kOneLane = {nullptr, nullptr, 1, 0, 0};

}  // namespace

extern "C" int sk_dense_rowwise(const float* A, uint32_t key0, uint32_t key1, float* out,
                                int64_t m, int64_t n, int64_t s_dim, int64_t ld,
                                int dist, float scale, cudaStream_t stream) {
  return (int)launch<true, false>(A, key0, key1, out, m, n, s_dim, ld, dist, scale, nullptr,
                                  nullptr, 0.0f, kOneLane, stream);
}

extern "C" int sk_dense_columnwise(const float* A, uint32_t key0, uint32_t key1, float* out,
                                   int64_t m, int64_t n, int64_t s_dim, int64_t ld,
                                   int dist, float scale, cudaStream_t stream) {
  return (int)launch<false, false>(A, key0, key1, out, m, n, s_dim, ld, dist, scale, nullptr,
                                   nullptr, 0.0f, kOneLane, stream);
}

extern "C" int sk_dense_rowwise_cos(const float* A, uint32_t key0, uint32_t key1, const float* sc,
                                    const float* sh, float* out, int64_t m, int64_t n,
                                    int64_t s_dim, int64_t ld, int dist, float inscale,
                                    float outscale, cudaStream_t stream) {
  return (int)launch<true, true>(A, key0, key1, out, m, n, s_dim, ld, dist, inscale, sc, sh,
                                 outscale, kOneLane, stream);
}

// The batched sketch of a stacked cohort: A (B, m, n) rowwise -> out
// (B, m, s_dim), or A (B, n, m) columnwise -> out (B, s_dim, m), lane b
// under keys[2b], keys[2b + 1] and scaled by scales[b]; both arrays on the
// card. Contiguous lanes (ld = n rowwise, m columnwise).
extern "C" int sk_dense_batched(int rowwise, const float* A, const uint32_t* keys,
                                const float* scales, float* out, int64_t B, int64_t m,
                                int64_t n, int64_t s_dim, int dist, cudaStream_t stream) {
  if (keys == nullptr || scales == nullptr) return (int)cudaErrorInvalidValue;
  const Lanes ln = {keys, scales, B, m * n, m * s_dim};
  if (rowwise)
    return (int)launch<true, false>(A, 0u, 0u, out, m, n, s_dim, n, dist, 1.0f, nullptr,
                                    nullptr, 0.0f, ln, stream);
  return (int)launch<false, false>(A, 0u, 0u, out, m, n, s_dim, m, dist, 1.0f, nullptr, nullptr,
                                   0.0f, ln, stream);
}

// ---------------------------------------------------------------------------
// The bf16 regimes on the tensor cores
// ---------------------------------------------------------------------------

namespace {

enum Regime { kF32 = 0, kBf16x3 = 1, kBf16Gen2 = 2, kBf16 = 3 };

constexpr int64_t kWorkspaceCap = 64ll << 20;  // operator planes, bytes per lane
constexpr int kBM = 128;                       // data rows per block: 2 x 64
constexpr int kKB = 64;                        // k-block: one 128-byte swizzle row
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kProducers = 128;                // and a producer warpgroup
constexpr int kTcThreads = kConsumers + kProducers;
// A's fp32 tile in a stage, in A's own layout as TMA boxes of 32 floats
// (128 bytes) by R rows with the 128-byte swizzle (csrc/hopper.cuh):
// rowwise 2 boxes of [128 data rows][32 k], columnwise 4 boxes of [64 k][32
// data rows]; the swizzle spreads each fragment read over all 32 banks
constexpr int kABytes = kBM * kKB * 4;  // 32 KiB
constexpr int kMaxStages = 6;
constexpr int kSmemBudget = 220 * 1024;        // stages; barriers and alignment aside
constexpr int kMinKbPerSplit = 32;             // k-blocks a split share keeps at least

// The launch plan of one lane; the same for every lane of a batched launch.
struct Plan {
  int bn, split, stages, planes;
  int64_t s_pad, kc, chunks, m_pad;
  int64_t ws_lane;    // bf16 elements of the operator planes, per lane
  int64_t part_lane;  // floats of partial sums per lane (0: none needed)
};

Plan make_plan(int64_t m, int64_t n, int64_t s_dim, int regime, int sms) {
  Plan p;
  p.bn = s_dim <= 64 ? 64 : 128;
  p.s_pad = (s_dim + p.bn - 1) / p.bn * p.bn;
  p.planes = regime == kBf16x3 ? 2 : 1;
  const int64_t n256 = (n + 255) / 256 * 256;
  int64_t kc = kWorkspaceCap / (p.planes * p.s_pad * 2) / 256 * 256;
  p.kc = kc < 256 ? 256 : (kc > n256 ? n256 : kc);
  p.chunks = (n + p.kc - 1) / p.kc;
  p.m_pad = (m + kBM - 1) / kBM * kBM;
  const int64_t tiles = (p.m_pad / kBM) * (p.s_pad / p.bn);
  const int64_t kb = (std::min(p.kc, n) + kKB - 1) / kKB;  // k-blocks of the first chunk
  // a thin output (fewer tiles than SMs) splits n: the split that fills
  // the last wave of blocks best (the smallest on a tie), each share
  // keeping at least kMinKbPerSplit k-blocks
  const int64_t most =
      tiles >= sms ? 1 : std::max<int64_t>(1, std::min<int64_t>(kb / kMinKbPerSplit, 64));
  int64_t split = 1;
  double best = 0.0;
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t blocks = tiles * s;
    const double fill = (double)blocks / (double)(((blocks + sms - 1) / sms) * sms);
    if (fill > best + 1e-9) {
      best = fill;
      split = s;
    }
  }
  p.split = (int)split;
  const int stage_bytes = p.planes * p.bn * 128 + kABytes;
  p.stages = kSmemBudget / stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.ws_lane = p.planes * p.s_pad * p.kc;
  p.part_lane = (p.split > 1 || p.chunks > 1) ? p.split * p.m_pad * p.s_pad : 0;
  return p;
}

struct GenArgs {
  uint32_t key0, key1;
  const uint32_t* keys;  // (B, 2) lane keys, or nullptr: key0, key1
  const float* scales;   // (B,) entry scales, or nullptr: none
  int64_t n, c0;         // operator columns; this chunk's first
  int s_dim, s_pad, planes;
  __nv_bfloat16* ws;
  int64_t ws_lane, plane;  // elements
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns [c0 + 256*blockIdx.x, + 256) of operator rows 16*blockIdx.y + [0,
// 16) of lane blockIdx.z, as bf16 hi (and lo) planes in the swizzled
// k-block layout: element (r, k) of the chunk at ((k/64)*s_pad + r)*64 +
// (((k%64)/8) ^ (r%8))*8 + k%8. Thread (row, 8-counter group) makes 16
// entries, columns j..j+7 and 128+j..128+j+7 of the 256-column block, and
// stores each run of 8 as one 16-byte vector per plane.
template <int DIST>
__global__ void __launch_bounds__(256) dense_gen_kernel(const GenArgs g) {
  __shared__ uint32_t key[2];
  const int64_t lane = blockIdx.z;
  const int64_t kb = g.c0 / 256 + blockIdx.x;
  if (threadIdx.x == 0) {
    uint32_t k0 = g.keys ? g.keys[2 * lane] : g.key0;
    uint32_t k1 = g.keys ? g.keys[2 * lane + 1] : g.key1;
    sk::chunk_key(k0, k1, kb);
    key[0] = k0;
    key[1] = k1;
  }
  __syncthreads();
  const int r = blockIdx.y * 16 + threadIdx.x / 16;
  const int j0 = (threadIdx.x % 16) * 8;
  const int64_t col = kb * 256 + j0;  // word 0's first column
  float v[2][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[0][e] = 0.0f;
    v[1][e] = 0.0f;
    if (r < g.s_dim) {
      uint32_t x0 = (uint32_t)r * kHalf + (uint32_t)(j0 + e);
      uint32_t x1 = x0 + (uint32_t)g.s_dim * kHalf;
      sk::threefry2x32(key[0], key[1], x0, x1);
      if (col + e < g.n) v[0][e] = from_bits<DIST>(x0);
      if (col + kHalf + e < g.n) v[1][e] = from_bits<DIST>(x1);
    }
  }
  if (g.scales != nullptr) {
    const float s = g.scales[lane];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[0][e] = __fmul_rn(v[0][e], s);
      v[1][e] = __fmul_rn(v[1][e], s);
    }
  }
  __nv_bfloat16* ws = g.ws + lane * g.ws_lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lc = blockIdx.x * 256 + h * kHalf + j0;  // column within the chunk
    const int64_t off =
        ((int64_t)(lc / kKB) * g.s_pad + r) * kKB + (int64_t)((((lc % kKB) / 8) ^ (r % 8)) * 8);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = v[h][2 * e], x1 = v[h][2 * e + 1];
      const __nv_bfloat162 bh = __floats2bfloat162_rn(x0, x1);
      const float2 fh = __bfloat1622float2(bh);
      hi[e] = pack_bf16(bh);
      lo[e] = pack_bf16(__floats2bfloat162_rn(__fsub_rn(x0, fh.x), __fsub_rn(x1, fh.y)));
    }
    *reinterpret_cast<uint4*>(ws + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (g.planes == 2)
      *reinterpret_cast<uint4*>(ws + g.plane + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The contraction's arguments; A itself reaches the kernel as its tensor
// map (encode_a).
struct TcArgs {
  int rowwise;
  int64_t m, n;
  int s_dim, s_pad;
  int64_t c0, clen;  // this chunk's columns
  const __nv_bfloat16* ws;
  int64_t ws_lane, plane;
  int split, stages, first, last;
  int64_t lanes;
  float* part;  // partial sums: [lane][split], then [m_pad][s_pad] rowwise,
                // [s_pad][m_pad] columnwise (the output's orientation)
  int64_t p_lane, p_split, m_pad;
  float* out;
  int64_t oi, oj, out_lane;  // out[lane*out_lane + i*oi + j*oj]
  float scale, outscale;
  const float* sc;  // cos epilogue's per-feature scales, or nullptr: none
  const float* sh;
};

// Partial sum (i, j) of a split share.
__device__ __forceinline__ int64_t part_at(const TcArgs& p, int64_t i, int64_t j) {
  return p.rowwise ? i * p.s_pad + j : j * p.m_pad + i;
}

// The finished sum of output (i, j): scale * acc, or outscale * cos(acc *
// inscale * sc + sh) with the scale being inscale.
__device__ __forceinline__ float finish(const TcArgs& p, float acc, int64_t j) {
  if (p.sc != nullptr)
    return __fmul_rn(p.outscale,
                     cosf(__fadd_rn(__fmul_rn(__fmul_rn(acc, p.scale), p.sc[j]), p.sh[j])));
  return __fmul_rn(p.scale, acc);
}

// See the file's head, step 2. Block (x, y, z): operator rows x*BN + [0,
// BN), data rows y*128 + [0, 128), lane z / split and split share z % split
// of the chunk's k-blocks.
template <int BN, int REGIME>
__global__ void __launch_bounds__(kTcThreads, 1)
    dense_tc_kernel(const TcArgs p, const __grid_constant__ CUtensorMap amap) {
  constexpr int kPlanes = REGIME == kBf16x3 ? 2 : 1;
  constexpr bool kALo = REGIME != kBf16;
  constexpr int kSBytes = kPlanes * BN * 128;
  constexpr int kStageBytes = kSBytes + kABytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.z / p.split;
  const int sidx = blockIdx.z % p.split;
  const int n0 = blockIdx.x * BN;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const int64_t nkb = (p.clen + kKB - 1) / kKB;
  const int64_t kb0 = nkb * sidx / p.split;
  const int iters = (int)(nkb * (sidx + 1) / p.split - kb0);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kConsumers / 32);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers back, and one thread
    // feeds the ring: per k-block the operator planes by bulk copy and A's
    // 128 x 64 fp32 tile as TMA boxes (zeros past m or n), all counted on
    // the stage's full barrier.
    hop::regs_dec<40>();
    if (tid != kConsumers) return;
    const __nv_bfloat16* src = p.ws + lane * p.ws_lane + (kb0 * p.s_pad + n0) * kKB;
    for (int it = 0; it < iters; ++it) {
      const int s = it % p.stages;
      if (it >= p.stages) hop::mbar_wait(&empty[s], ((it / p.stages) - 1) & 1);
      uint8_t* stage = smem + s * kStageBytes;
      hop::mbar_expect_tx(&full[s], kSBytes + kABytes);
      const __nv_bfloat16* at = src + (int64_t)it * p.s_pad * kKB;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
        hop::bulk_copy(stage + q * BN * 128, at + q * p.plane, BN * 128, &full[s]);
      uint8_t* as = stage + kSBytes;
      const int kbase = (int)(p.c0 + (kb0 + it) * kKB);
      if (p.rowwise) {
        hop::tma_load_3d(as, &amap, kbase, (int)m0, (int)lane, &full[s]);
        hop::tma_load_3d(as + kABytes / 2, &amap, kbase + 32, (int)m0, (int)lane, &full[s]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          hop::tma_load_3d(as + b * (kABytes / 4), &amap, (int)m0 + 32 * b, kbase, (int)lane,
                           &full[s]);
      }
    }
    return;
  }

  hop::regs_inc<232>();
  const int wg = tid / 128, t = tid % 128, w = t / 32, ln = t % 32, g = ln / 4, q = ln % 4;
  // Fragment row g + 8h of warp w is tile row 16w + 8h + gs: the order
  // (0, 2, 4, 6, 1, 3, 5, 7) puts the rows that lanes 0-15 (and 16-31)
  // read together on distinct swizzle phases, so the rowwise float2 reads
  // hit every bank once. Loads and stores use the same rows.
  const int gs = (g & 3) * 2 + (g >> 2);
  const int l0 = wg * 64 + w * 16 + gs;  // r0's row in the tile
  const int64_t r0 = m0 + l0, r1 = r0 + 8;
  const bool active = m0 + wg * 64 < p.m;  // uniform across the warpgroup
  float* part = p.part + lane * p.p_lane + sidx * p.p_split;

  // acc: the sum so far; tmp: one k-block's passes. The tensor cores add
  // in fp32 but truncate the aligned sum, an error that grows with the
  // number of additions; adding each k-block's tmp into acc with fp32 adds
  // (round to nearest) keeps it to one k-block's worth.
  float acc[BN / 2], tmp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.0f;
    tmp[i] = 0.0f;
  }
  if (!p.first && active) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = h ? r1 : r0, col = n0 + 8 * i + 2 * q;
        acc[4 * i + 2 * h] = part[part_at(p, row, col)];
        acc[4 * i + 2 * h + 1] = part[part_at(p, row, col + 1)];
      }
  }

  for (int it = 0; it < iters; ++it) {
    const int s = it % p.stages;
    hop::mbar_wait(&full[s], (it / p.stages) & 1);
    // A's fragments from the stage's tile, split into bf16 hi and lo:
    // k-step kk's register r holds rows (r & 1 ? r1 : r0), columns 16*kk +
    // 2q + (r & 2 ? 8 : 0) and the next
    uint32_t ah[4][4], al[4][4];
    if (active) {
      const float* as = reinterpret_cast<const float*>(smem + s * kStageBytes + kSBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lr = l0 + ((r & 1) ? 8 : 0), k = 16 * kk + 2 * q + ((r & 2) ? 8 : 0);
          // (row, col) of a box at float row * 32 + ((col / 4) ^ (row % 8)) * 4 + col % 4
          float2 x;
          if (p.rowwise) {
            x = *reinterpret_cast<const float2*>(as + (k / 32) * (kBM * 32) + lr * 32 +
                                                 ((((k % 32) / 4) ^ (lr % 8)) * 4) + k % 4);
          } else {
            const float* box = as + (lr / 32) * (kKB * 32) + lr % 4;
            const int c = (lr % 32) / 4;
            x.x = box[k * 32 + ((c ^ (k % 8)) * 4)];
            x.y = box[(k + 1) * 32 + ((c ^ ((k + 1) % 8)) * 4)];
          }
          const __nv_bfloat162 bh = __floats2bfloat162_rn(x.x, x.y);
          const float2 fh = __bfloat1622float2(bh);
          ah[kk][r] = pack_bf16(bh);
          al[kk][r] =
              pack_bf16(__floats2bfloat162_rn(__fsub_rn(x.x, fh.x), __fsub_rn(x.y, fh.y)));
        }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hop::fence_operand(tmp[i]);
      hop::wgmma_fence();
      const uint32_t base = hop::smem_u32(smem + s * kStageBytes);
      const uint64_t dhi = hop::desc_k128(base);
      const uint64_t dlo = hop::desc_k128(base + BN * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hop::wgmma_rs<BN>(tmp, ah[kk], dhi + 2 * kk, kk > 0);  // +32 bytes per k-step
        if constexpr (kPlanes == 2) hop::wgmma_rs<BN>(tmp, ah[kk], dlo + 2 * kk, 1);
        if constexpr (kALo) hop::wgmma_rs<BN>(tmp, al[kk], dhi + 2 * kk, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        hop::fence_operand(tmp[i]);
        acc[i] = __fadd_rn(acc[i], tmp[i]);
      }
    }
    __syncwarp();
    if (ln == 0) hop::mbar_arrive(&empty[s]);
  }

  if (!active) return;
  const bool done = p.last && p.split == 1;
  float* out = p.out + lane * p.out_lane;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = h ? r1 : r0;
      const int64_t col = n0 + 8 * i + 2 * q;
      if (!done) {
        part[part_at(p, row, col)] = acc[4 * i + 2 * h];
        part[part_at(p, row, col + 1)] = acc[4 * i + 2 * h + 1];
        continue;
      }
      if (row >= p.m) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < p.s_dim)
          out[row * p.oi + (col + e) * p.oj] = finish(p, acc[4 * i + 2 * h + e], col + e);
    }
}

// The split partials of every (lane, i, j) added in split order, then
// finished. Rowwise outputs run j fastest, columnwise ones i fastest:
// partial sums and outputs share that orientation, so reads and writes are
// coalesced.
__global__ void __launch_bounds__(256) dense_tc_finish(const TcArgs p) {
  const int64_t per_lane = p.m * p.s_dim;
  const int64_t total = p.lanes * per_lane;
  for (int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; x < total;
       x += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = x / per_lane, r = x % per_lane;
    const int64_t i = p.oj == 1 ? r / p.s_dim : r % p.m;
    const int64_t j = p.oj == 1 ? r % p.s_dim : r / p.m;
    const float* src = p.part + lane * p.p_lane + part_at(p, i, j);
    float acc = src[0];
    for (int s = 1; s < p.split; ++s) acc = __fadd_rn(acc, src[s * p.p_split]);
    p.out[lane * p.out_lane + i * p.oi + j * p.oj] = finish(p, acc, j);
  }
}

template <int DIST>
cudaError_t launch_gen(const GenArgs& g, dim3 grid, cudaStream_t stream) {
  dense_gen_kernel<DIST><<<grid, 256, 0, stream>>>(g);
  return cudaGetLastError();
}

template <int BN, int REGIME>
cudaError_t launch_tc(const TcArgs& a, const CUtensorMap& amap, dim3 grid, cudaStream_t stream) {
  constexpr int kSBytes = (REGIME == kBf16x3 ? 2 : 1) * BN * 128;
  const int smem = a.stages * (kSBytes + kABytes) + 1024 + 2 * kMaxStages * 8;
  cudaError_t err = cudaFuncSetAttribute(dense_tc_kernel<BN, REGIME>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dense_tc_kernel<BN, REGIME><<<grid, kTcThreads, smem, stream>>>(a, amap);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_tc_bn(const TcArgs& a, const CUtensorMap& amap, int regime, dim3 grid,
                         cudaStream_t stream) {
  switch (regime) {
    case kBf16x3: return launch_tc<BN, kBf16x3>(a, amap, grid, stream);
    case kBf16Gen2: return launch_tc<BN, kBf16Gen2>(a, amap, grid, stream);
    case kBf16: return launch_tc<BN, kBf16>(a, amap, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's entry
// point query (the library links no libcuda), or nullptr.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The tensor map of A's lanes as TMA reads them: rowwise (n, m, B) with
// boxes of 32 x 128 x 1, columnwise (m, n, B) with boxes of 32 x 64 x 1,
// innermost first; rows ld floats apart, lanes a_lane floats apart.
cudaError_t encode_a(CUtensorMap* map, int rowwise, const float* A, int64_t ld, int64_t a_lane,
                     int64_t B, int64_t m, int64_t n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)(rowwise ? n : m), (cuuint64_t)(rowwise ? m : n),
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)a_lane * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)(rowwise ? kBM : kKB), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(A), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// The plan of a bf16-regime launch, for the wrapper's allocations: plan[0]
// workspace bytes per lane, [1] partial-sum bytes per lane, [2] split, [3]
// chunks, [4] tile width BN, [5] chunk columns.
extern "C" int sk_dense_tc_plan(int64_t m, int64_t n, int64_t s_dim, int regime, int64_t* plan) {
  if (m <= 0 || n <= 0 || s_dim <= 0 || regime < kBf16x3 || regime > kBf16)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(m, n, s_dim, regime, sms);
  plan[0] = 2 * p.ws_lane;
  plan[1] = 4 * p.part_lane;
  plan[2] = p.split;
  plan[3] = p.chunks;
  plan[4] = p.bn;
  plan[5] = p.kc;
  return 0;
}

// The bf16 regimes, one lane or a stacked cohort. Rowwise A (B, m, n) ->
// out (B, m, s_dim); columnwise A (B, n, m) -> out (B, s_dim, m); A's rows
// ld floats apart, ld a multiple of 4, lanes contiguous in that layout, A
// 16-byte aligned. One lane: keys == nullptr, key0/key1 its key, and out is
// scaled by ``scale`` (sc, sh: the cos epilogue, rowwise only). A cohort:
// keys (B, 2) and scales (B,) on the card, each lane's operator entries
// scaled before they are rounded. ws and part hold B times the sizes that
// sk_dense_tc_plan gives.
extern "C" int sk_dense_tc(int rowwise, int regime, int dist, const float* A, int64_t ld,
                           uint32_t key0, uint32_t key1, const uint32_t* keys,
                           const float* scales, int64_t B, int64_t m, int64_t n, int64_t s_dim,
                           float scale, const float* sc,
                           const float* sh, float outscale, float* out, void* ws, void* part,
                           cudaStream_t stream) {
  if (m <= 0 || n <= 0 || s_dim <= 0 || B < 1 || regime < kBf16x3 || regime > kBf16 ||
      dist < kNormal || dist > kRademacher || s_dim * kHalf > 0xFFFFFFFFLL ||
      (sc == nullptr) != (sh == nullptr) || (sc != nullptr && (!rowwise || keys != nullptr)) ||
      (keys == nullptr) != (scales == nullptr) || (keys == nullptr && B != 1) ||
      ws == nullptr || ld < (rowwise ? n : m) || ld % 4 != 0 || n >= (1ll << 31) - 256 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(m, n, s_dim, regime, sms);
  if (pl.m_pad / kBM > 65535 || B * pl.split > 65535 || pl.s_pad / 16 > 65535 ||
      (pl.part_lane > 0 && part == nullptr))
    return (int)cudaErrorInvalidValue;

  GenArgs g;
  g.key0 = key0;
  g.key1 = key1;
  g.keys = keys;
  g.scales = scales;
  g.n = n;
  g.s_dim = (int)s_dim;
  g.s_pad = (int)pl.s_pad;
  g.planes = pl.planes;
  g.ws = static_cast<__nv_bfloat16*>(ws);
  g.ws_lane = pl.ws_lane;
  g.plane = pl.s_pad * pl.kc;

  TcArgs a;
  a.rowwise = rowwise;
  a.m = m;
  a.n = n;
  a.s_dim = (int)s_dim;
  a.s_pad = (int)pl.s_pad;
  a.ws = g.ws;
  a.ws_lane = g.ws_lane;
  a.plane = g.plane;
  a.split = pl.split;
  a.stages = pl.stages;
  a.lanes = B;
  a.part = static_cast<float*>(part);
  a.p_lane = pl.part_lane;
  a.p_split = pl.m_pad * pl.s_pad;
  a.m_pad = pl.m_pad;
  a.out = out;
  a.oi = rowwise ? s_dim : 1;
  a.oj = rowwise ? 1 : m;
  a.out_lane = m * s_dim;
  a.scale = keys != nullptr ? 1.0f : scale;
  a.outscale = outscale;
  a.sc = sc;
  a.sh = sh;

  CUtensorMap amap;
  err = encode_a(&amap, rowwise, A, ld, (rowwise ? m : n) * ld, B, m, n);
  if (err != cudaSuccess) return (int)err;
  const dim3 tc_grid((unsigned)(pl.s_pad / pl.bn), (unsigned)(pl.m_pad / kBM),
                     (unsigned)(B * pl.split));
  for (int64_t c = 0; c < pl.chunks; ++c) {
    g.c0 = c * pl.kc;
    const int64_t clen = std::min(pl.kc, n - g.c0);
    const dim3 gen_grid((unsigned)((clen + 255) / 256), (unsigned)(pl.s_pad / 16), (unsigned)B);
    switch (dist) {
      case kNormal: err = launch_gen<kNormal>(g, gen_grid, stream); break;
      case kCauchy: err = launch_gen<kCauchy>(g, gen_grid, stream); break;
      default: err = launch_gen<kRademacher>(g, gen_grid, stream); break;
    }
    if (err != cudaSuccess) return (int)err;
    a.c0 = g.c0;
    a.clen = clen;
    a.first = c == 0;
    a.last = c == pl.chunks - 1;
    err = pl.bn == 64 ? launch_tc_bn<64>(a, amap, regime, tc_grid, stream)
                      : launch_tc_bn<128>(a, amap, regime, tc_grid, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (pl.split > 1) {
    const int64_t total = B * m * s_dim;
    const unsigned blocks = (unsigned)std::min<int64_t>((total + 255) / 256, 4 * 65535);
    dense_tc_finish<<<blocks, 256, 0, stream>>>(a);
    err = cudaGetLastError();
  }
  return (int)err;
}
