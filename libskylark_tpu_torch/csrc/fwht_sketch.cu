// Panel-free SRHT for Hopper (sm_90a).
//
// Replaces the TPU kernel of libskylark_tpu/sketch/pallas_fwht.py
// (_fwht_call -> _kernel):
//   out = samp_scale * gather(FWHT_n((fut_scale * D) (.) a), idx)
// along the transform axis: rowwise A (m, n) -> out (m, s), columnwise
// A (n, m) -> out (s, m); n is a power of two >= 128, s <= 2048,
// fut_scale = 1/sqrt(n), samp_scale = sqrt(n/s). fwht_gen_kernel makes D
// (Rademacher, sub-stream 0; the scale is folded in, an exact product) and
// idx (randint over the power-of-two span n, sub-stream 1: the low draw
// alone, since the multiplier is 0) from the transform's 2-word key, in
// base/randgen.py's counter-stream layout: each thread derives the chunk
// key of its D entry (chunk_key(fold_in(key, 0), j / 4096)) and, for idx,
// randint's low-draw key (split(chunk_key(fold_in(key, 1), 0))[1]) on the
// card.
//
// Bound on this card: bytes. A is read once and the output written once;
// n*log2(n) adds per row (or column) are far below the fp32 add rate.
//
// Design. One n = 65536 column is 256 KiB, more than an SM's shared
// memory, so the transform does not sit in one block. It factors as
// H_n = H_P (x) H_b with b = min(n, segment): Y = (I_P (x) H_b)(D (.) x)
// is formed segment by segment in shared memory, and only the s sampled
// outputs of the outer factor are formed from it: for idx_k = p_k*b + q_k,
// out_k = samp * sum_{p'} (-1)^popcount(p_k & p') * Y[p'*b + q_k].
// - rowwise: one block per row. Each segment of 2048 is transformed in
//   shared memory and folded at once into the row's s sums, which live
//   in registers (s/256 per thread): A is read once, Y never stored.
// - columnwise: the transform runs down the columns. fwht_cw_seg_kernel
//   transforms 16 columns x 1024 rows per block in shared memory and
//   writes Y (n, m) to scratch; fwht_cw_gather_kernel forms the sampled
//   sums, one thread per (k, column), reads coalesced along the columns.
//   Y costs one more write and read of A's size.
// The reference's op order is kept: the scale multiplies D first, the
// transform adds, the gather comes last and samp_scale multiplies after
// it. On dyadic data (integer operands, n and s even powers of two) every
// step is exact and the result bit-equal to the reference in any add
// order; otherwise the adds run in another order than the reference's
// kron matmul (allclose).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kChunk = 4096;    // randgen.CHUNK
constexpr int kThreads = 256;
constexpr int kMaxS = 2048;     // one cipher sweep of chunk 0, as the TPU kernel
constexpr int kPerT = kMaxS / kThreads;
constexpr int kSegRW = 2048;    // rowwise segment: 8 KB of shared memory
constexpr int kSegCW = 1024;    // columnwise segment rows
constexpr int kColsCW = 16;     // columnwise columns per block: 64 KB

__global__ void fwht_gen_kernel(uint32_t key0, uint32_t key1, int64_t n, int s,
                                float fut_scale, float* __restrict__ D,
                                int* __restrict__ idx) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) {
    uint32_t k0 = key0, k1 = key1;
    sk::fold_in(k0, k1, 0u);
    sk::chunk_key(k0, k1, j / kChunk);
    D[j] = __fmul_rn(fut_scale, sk::rademacher(sk::stream_bits(k0, k1, (uint32_t)(j % kChunk))));
  }
  if (j < s) {
    uint32_t k0 = key0, k1 = key1;
    sk::fold_in(k0, k1, 1u);
    sk::chunk_key(k0, k1, 0);
    sk::fold_in(k0, k1, 1u);
    idx[j] = (int)(sk::stream_bits(k0, k1, (uint32_t)j) & (uint32_t)(n - 1));
  }
}

// In-place unnormalized WHT (natural order) of Y[0..b) by the butterfly,
// the whole block taking part; ends synchronised.
__device__ __forceinline__ void block_wht(float* Y, int b) {
  for (int h = 1; h < b; h <<= 1) {
    for (int e = threadIdx.x; e < b / 2; e += kThreads) {
      const int lo = ((e & ~(h - 1)) << 1) | (e & (h - 1));
      const float x = Y[lo], y = Y[lo + h];
      Y[lo] = __fadd_rn(x, y);
      Y[lo + h] = __fsub_rn(x, y);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fwht_rw_kernel(const float* __restrict__ A, const float* __restrict__ D,
               const int* __restrict__ idx, float* __restrict__ out, int64_t n, int s,
               int64_t ld, int log_b, float samp_scale) {
  __shared__ float Y[kSegRW];
  const int tid = threadIdx.x;
  const int b = 1 << log_b;
  const int64_t segs = n >> log_b;
  const float* a = A + (int64_t)blockIdx.x * ld;
  int pk[kPerT], qk[kPerT];
  float acc[kPerT];
#pragma unroll
  for (int r = 0; r < kPerT; ++r) {
    const int k = tid + kThreads * r;
    const int id = k < s ? idx[k] : 0;
    pk[r] = id >> log_b;
    qk[r] = id & (b - 1);
    acc[r] = 0.0f;
  }
  for (int64_t p = 0; p < segs; ++p) {
    const int64_t j0 = p << log_b;
    for (int e = tid; e < b; e += kThreads) Y[e] = __fmul_rn(D[j0 + e], a[j0 + e]);
    __syncthreads();
    block_wht(Y, b);
#pragma unroll
    for (int r = 0; r < kPerT; ++r) {
      if (tid + kThreads * r < s) {
        const float y = Y[qk[r]];
        acc[r] = (__popc(pk[r] & (int)p) & 1) ? __fsub_rn(acc[r], y) : __fadd_rn(acc[r], y);
      }
    }
    __syncthreads();
  }
  float* o = out + (int64_t)blockIdx.x * s;
#pragma unroll
  for (int r = 0; r < kPerT; ++r) {
    const int k = tid + kThreads * r;
    if (k < s) o[k] = __fmul_rn(samp_scale, acc[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
fwht_cw_seg_kernel(const float* __restrict__ A, const float* __restrict__ D,
                   float* __restrict__ Yg, int64_t m, int64_t ld, int log_b) {
  extern __shared__ float S[];  // [b][kColsCW]
  const int tid = threadIdx.x;
  const int b = 1 << log_b;
  const int64_t j0 = (int64_t)blockIdx.x << log_b;
  const int64_t c0 = (int64_t)blockIdx.y * kColsCW;
  for (int e = tid; e < b * kColsCW; e += kThreads) {
    const int q = e / kColsCW;
    const int64_t col = c0 + e % kColsCW;
    S[e] = col < m ? __fmul_rn(D[j0 + q], __ldg(A + (j0 + q) * ld + col)) : 0.0f;
  }
  __syncthreads();
  for (int h = 1; h < b; h <<= 1) {
    for (int e = tid; e < (b / 2) * kColsCW; e += kThreads) {
      const int c = e % kColsCW, pi = e / kColsCW;
      const int lo = (((pi & ~(h - 1)) << 1) | (pi & (h - 1))) * kColsCW + c;
      const int hi = lo + h * kColsCW;
      const float x = S[lo], y = S[hi];
      S[lo] = __fadd_rn(x, y);
      S[hi] = __fsub_rn(x, y);
    }
    __syncthreads();
  }
  for (int e = tid; e < b * kColsCW; e += kThreads) {
    const int64_t col = c0 + e % kColsCW;
    if (col < m) Yg[(j0 + e / kColsCW) * m + col] = S[e];
  }
}

__global__ void fwht_cw_gather_kernel(const float* __restrict__ Yg, const int* __restrict__ idx,
                                      float* __restrict__ out, int64_t m, int s, int log_b,
                                      int64_t segs, float samp_scale) {
  const int64_t c = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const int k = blockIdx.y * 8 + threadIdx.y;
  if (c >= m || k >= s) return;
  const int id = idx[k];
  const int pk = id >> log_b;
  const int64_t q = id & ((1 << log_b) - 1);
  float acc = 0.0f;
  for (int64_t p = 0; p < segs; ++p) {
    const float y = Yg[((p << log_b) + q) * m + c];
    acc = (__popc(pk & (int)p) & 1) ? __fsub_rn(acc, y) : __fadd_rn(acc, y);
  }
  out[(int64_t)k * m + c] = __fmul_rn(samp_scale, acc);
}

int log2_exact(int64_t n) {
  int k = 0;
  while ((int64_t{1} << k) < n) ++k;
  return (int64_t{1} << k) == n ? k : -1;
}

cudaError_t gen(uint32_t key0, uint32_t key1, float* D, int* idx, int64_t n, int64_t s,
                float fut_scale, cudaStream_t stream) {
  const int64_t count = n > s ? n : s;
  fwht_gen_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      key0, key1, n, (int)s, fut_scale, D, idx);
  return cudaGetLastError();
}

bool bad_shape(int64_t m, int64_t n, int64_t s, int log_n) {
  return m <= 0 || s <= 0 || s > kMaxS || log_n < 7 || log_n > 40;
}

}  // namespace

// Scratch, allocated by the caller: D (n floats), idx (s ints) and, for
// the columnwise orientation, Y (n * m floats). (key0, key1): the
// transform's key.
extern "C" int sk_fwht_rowwise(const float* A, uint32_t key0, uint32_t key1, float* D,
                               int* idx, float* out, int64_t m, int64_t n, int64_t s,
                               int64_t ld, float fut_scale, float samp_scale,
                               cudaStream_t stream) {
  const int log_n = log2_exact(n);
  if (bad_shape(m, n, s, log_n) || ld < n || m > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaError_t err = gen(key0, key1, D, idx, n, s, fut_scale, stream);
  if (err != cudaSuccess) return (int)err;
  const int log_seg = log2_exact(kSegRW);
  const int log_b = log_n < log_seg ? log_n : log_seg;
  fwht_rw_kernel<<<(unsigned)m, kThreads, 0, stream>>>(A, D, idx, out, n, (int)s, ld, log_b,
                                                       samp_scale);
  return (int)cudaGetLastError();
}

extern "C" int sk_fwht_columnwise(const float* A, uint32_t key0, uint32_t key1, float* D,
                                  int* idx, float* Y, float* out, int64_t m, int64_t n,
                                  int64_t s, int64_t ld, float fut_scale, float samp_scale,
                                  cudaStream_t stream) {
  const int log_n = log2_exact(n);
  if (bad_shape(m, n, s, log_n) || ld < m || (m + kColsCW - 1) / kColsCW > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = gen(key0, key1, D, idx, n, s, fut_scale, stream);
  if (err != cudaSuccess) return (int)err;
  const int log_seg = log2_exact(kSegCW);
  const int log_b = log_n < log_seg ? log_n : log_seg;
  const size_t smem = (size_t)(1 << log_b) * kColsCW * sizeof(float);
  err = cudaFuncSetAttribute(fwht_cw_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t segs = n >> log_b;
  fwht_cw_seg_kernel<<<dim3((unsigned)segs, (unsigned)((m + kColsCW - 1) / kColsCW)), kThreads,
                       smem, stream>>>(A, D, Y, m, ld, log_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwht_cw_gather_kernel<<<dim3((unsigned)((m + 31) / 32), (unsigned)((s + 7) / 8)), dim3(32, 8),
                          0, stream>>>(Y, idx, out, m, (int)s, log_b, segs, samp_scale);
  return (int)cudaGetLastError();
}
