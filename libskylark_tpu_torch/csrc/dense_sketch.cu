// Fused generate-and-contract dense sketch for Hopper (sm_90a).
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
//              out[b] = scale[b] * A[b] * S_b^T  or  scale[b] * S_b * A[b]
//   over a stacked microbatch cohort, each lane b with its own key and
//   scale: blockIdx.z is the lane, its two key words and its scale are
//   read from device arrays, and A and out advance by one lane's extent.
// S (s_dim x n) is the virtual dense-block operator of base/randgen.py. It
// is generated here, tile by tile, from the transform's 2-word key and
// never stored: each block derives block k's key chunk_key(key, k) on the
// card, and one Threefry-2x32-20 call at counter c = r*128 + j (r the
// global operator row, j < 128) under it gives column j of block k (word
// 0) and column 128 + j (word 1, second counter c + s_dim*128). The bits
// map to values with exactly the f32 operations of base/threefry.py.
//
// Bound on this card: 2*m*n*s_dim FMA flops on the FP32 CUDA cores; at the
// main-path shapes (e.g. 8192 x 8192 -> 1024) that is compute-bound by a
// wide margin (bytes moved are A once plus the output once).
//
// Regeneration: each block owns one TILE x TILE output tile and loops over
// all of n, so every operator entry is generated once per tile of the
// other dimension, ceil(m / TILE) times in all. Generation costs about as
// many issue slots per k-step as the FMAs at TILE = 128; that is the price
// of never storing S.
//
// The first design is simple on purpose: a plain shared-memory SGEMM
// tiling (256 threads, 8x8 or 4x4 outputs per thread, 32-deep k-steps)
// with no software pipelining, no tensor cores and no split-K. Each block
// sums over n in one fixed order, so the result is deterministic and no
// reduction crosses blocks. Ragged edges are masked (A reads as 0 past m
// and n) instead of padded. The "f32" and "bf16x3" regimes both run as
// fp32 FMA here.
//
// The cos epilogue is applied at the store, in _apply_epilogue's operation
// order with every product and sum rounded on its own (no FMA contraction)
// and the accurate cosf (never build with --use_fast_math: phases reach
// O(10)). The feature matrix is written once and never read back.
//
// Scale order: every variant multiplies the finished sum by the scale
// (scale * (A * S^T)); the reference's batched kernel scales the
// generated entries before the product. The two differ by rounding only.
// In a batched launch the tile width is chosen from one lane's shape,
// never from the lane count, so a lane's bits do not depend on how many
// lanes share the launch (the serve layer's capacity invariance).

#include <cuda_runtime.h>
#include <stdint.h>

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
