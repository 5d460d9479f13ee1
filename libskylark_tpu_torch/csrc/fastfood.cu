// Fastfood feature map for Hopper (sm_90a).
//
// Replaces the TPU kernels of libskylark_tpu/sketch/pallas_fastfood.py:
//   fused  (_launch -> _kernel): per (row, block) the whole chain
//          B.x -> WHT -> Pi gather -> (scal G). -> WHT -> (scal Sm).
//          -> scale * cos(. + shift)
//   split  (_launch_split -> _kernel_pre, _kernel_post): the same chain cut
//          at the gather; the caller gathers between the two kernels.
// It computes what FastRFT._features_rows computes (frft._chain_rows); it
// is not a copy of the Pallas kernel's two kron dots. The streams arrive as
// (nb, NB) device arrays, scal already folded into G and Sm and the shifts
// zero-padded past S, exactly as the TPU kernel receives them.
//
// Design: one block per (row, Fastfood block). The row's NB-vector lives in
// shared memory (x zero-padded to NB on the load), the Walsh-Hadamard
// transform runs as log2(NB) radix-2 butterfly stages in place (natural
// Sylvester order, the order fut.wht's butterfly uses), the gather
// out[j] = in[perm[j]] is a shared-memory read into a second buffer, and
// the diagonals and the cos are applied in registers at the load and the
// store. Each feature goes straight to its block-major column b*NB + j of
// the (m, S) output, dropped past S. Only A is read from device memory and
// only the features written (the streams, 5 * NB floats per block, are
// re-read by every row from L2).
//
// Bound on this card: bytes. At the main path's 16384 x 4096 -> 4096 the
// chain's 2 * m * NB * log2(NB) adds take ~0.05 ms at the fp32 add rate
// against ~0.16 ms to move A and the features.
//
// Numerics: every product and sum is rounded on its own (no FMA
// contraction) in the reference's operation order, and cos is the accurate
// cosf (never build with --use_fast_math: phases reach O(10)). The WHT sums
// in butterfly order, not the kron matmul's, so it agrees with the plain
// version to rounding, not to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNB = 16384;     // two NB-float buffers: 128 KiB of shared memory
constexpr int kMaxThreads = 512;

// In-place unnormalized WHT of s[0:NB] by the block's threads; ends synced.
__device__ __forceinline__ void wht_shared(float* s, int NB) {
  for (int h = 1; h < NB; h <<= 1) {
    for (int k = threadIdx.x; k < NB / 2; k += blockDim.x) {
      const int i = ((k & ~(h - 1)) << 1) | (k & (h - 1));
      const float a = s[i], b = s[i + h];
      s[i] = __fadd_rn(a, b);
      s[i + h] = __fsub_rn(a, b);
    }
    __syncthreads();
  }
}

// u = B_b . x, x = row r of A zero-padded from d to NB; then u = H u.
__device__ __forceinline__ void stage_pre(float* u, const float* __restrict__ A, int64_t lda,
                                          int64_t r, int64_t d, int NB,
                                          const float* __restrict__ bdiag) {
  const float* a = A + r * lda;
  for (int j = threadIdx.x; j < NB; j += blockDim.x)
    u[j] = j < d ? __fmul_rn(bdiag[j], __ldg(a + j)) : 0.0f;
  __syncthreads();
  wht_shared(u, NB);
}

// v = H v (v already holds scal*G times the gathered vector), then the
// features scale * cos((scal*Sm) * v + shift) of block b, row r.
__device__ __forceinline__ void stage_post(float* v, int NB, int b, int64_t r, int64_t s_dim,
                                           const float* __restrict__ smdiag,
                                           const float* __restrict__ shift, float scale,
                                           float* __restrict__ out) {
  wht_shared(v, NB);
  for (int j = threadIdx.x; j < NB; j += blockDim.x) {
    const int64_t f = (int64_t)b * NB + j;
    if (f >= s_dim) break;
    const float z = __fadd_rn(__fmul_rn(smdiag[j], v[j]), shift[j]);
    out[r * s_dim + f] = __fmul_rn(scale, cosf(z));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fastfood_fused(const float* __restrict__ A, int64_t lda, int64_t d, int NB, int64_t m,
               int64_t s_dim, const float* __restrict__ bdiag, const int32_t* __restrict__ perm,
               const float* __restrict__ gdiag, const float* __restrict__ smdiag,
               const float* __restrict__ shift, float scale, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* u = smem;
  float* v = smem + NB;
  const int64_t r = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t off = (int64_t)b * NB;
  stage_pre(u, A, lda, r, d, NB, bdiag + off);
  for (int j = threadIdx.x; j < NB; j += blockDim.x)
    v[j] = __fmul_rn(gdiag[off + j], u[perm[off + j]]);
  __syncthreads();
  stage_post(v, NB, b, r, s_dim, smdiag + off, shift + off, scale, out);
}

// Split, first kernel: W[b, r, :] = H(B_b . x_r).
__global__ void __launch_bounds__(kMaxThreads)
fastfood_pre(const float* __restrict__ A, int64_t lda, int64_t d, int NB, int64_t m,
             const float* __restrict__ bdiag, float* __restrict__ W) {
  extern __shared__ float smem[];
  const int64_t r = blockIdx.x;
  const int b = blockIdx.y;
  stage_pre(smem, A, lda, r, d, NB, bdiag + (int64_t)b * NB);
  float* w = W + ((int64_t)b * m + r) * NB;
  for (int j = threadIdx.x; j < NB; j += blockDim.x) w[j] = smem[j];
}

// Split, second kernel, on the gathered W: the chain after the gather.
__global__ void __launch_bounds__(kMaxThreads)
fastfood_post(const float* __restrict__ W, int NB, int64_t m, int64_t s_dim,
              const float* __restrict__ gdiag, const float* __restrict__ smdiag,
              const float* __restrict__ shift, float scale, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int64_t r = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t off = (int64_t)b * NB;
  const float* w = W + ((int64_t)b * m + r) * NB;
  for (int j = threadIdx.x; j < NB; j += blockDim.x)
    smem[j] = __fmul_rn(gdiag[off + j], w[j]);
  __syncthreads();
  stage_post(smem, NB, b, r, s_dim, smdiag + off, shift + off, scale, out);
}

bool bad_geometry(int64_t m, int64_t NB, int64_t nb) {
  return m <= 0 || m > 0x7FFFFFFF || NB < 2 || NB > kMaxNB || (NB & (NB - 1)) || nb <= 0 ||
         nb > 65535;
}

int threads_for(int64_t NB) {
  const int64_t t = NB / 2 < 32 ? 32 : NB / 2;
  return (int)(t > kMaxThreads ? kMaxThreads : t);
}

// Opt in to more than the default 48 KiB of dynamic shared memory.
template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int sk_fastfood_fused(const float* A, int64_t lda, int64_t m, int64_t d, int64_t NB,
                                 int64_t nb, int64_t s_dim, const float* bdiag,
                                 const int32_t* perm, const float* gdiag, const float* smdiag,
                                 const float* shift, float scale, float* out,
                                 cudaStream_t stream) {
  if (bad_geometry(m, NB, nb) || d > NB || lda < d || s_dim <= (nb - 1) * NB ||
      s_dim > nb * NB)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)NB * sizeof(float);
  cudaError_t err = smem_attr(fastfood_fused, bytes);
  if (err != cudaSuccess) return (int)err;
  fastfood_fused<<<dim3((unsigned)m, (unsigned)nb), threads_for(NB), bytes, stream>>>(
      A, lda, d, (int)NB, m, s_dim, bdiag, perm, gdiag, smdiag, shift, scale, out);
  return (int)cudaGetLastError();
}

extern "C" int sk_fastfood_pre(const float* A, int64_t lda, int64_t m, int64_t d, int64_t NB,
                               int64_t nb, const float* bdiag, float* W, cudaStream_t stream) {
  if (bad_geometry(m, NB, nb) || d > NB || lda < d) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)NB * sizeof(float);
  cudaError_t err = smem_attr(fastfood_pre, bytes);
  if (err != cudaSuccess) return (int)err;
  fastfood_pre<<<dim3((unsigned)m, (unsigned)nb), threads_for(NB), bytes, stream>>>(
      A, lda, d, (int)NB, m, bdiag, W);
  return (int)cudaGetLastError();
}

extern "C" int sk_fastfood_post(const float* W, int64_t m, int64_t NB, int64_t nb, int64_t s_dim,
                                const float* gdiag, const float* smdiag, const float* shift,
                                float scale, float* out, cudaStream_t stream) {
  if (bad_geometry(m, NB, nb) || s_dim <= (nb - 1) * NB || s_dim > nb * NB)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)NB * sizeof(float);
  cudaError_t err = smem_attr(fastfood_post, bytes);
  if (err != cudaSuccess) return (int)err;
  fastfood_post<<<dim3((unsigned)m, (unsigned)nb), threads_for(NB), bytes, stream>>>(
      W, (int)NB, m, s_dim, gdiag, smdiag, shift, scale, out);
  return (int)cudaGetLastError();
}
