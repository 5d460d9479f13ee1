// Fastfood feature map for Hopper (sm_90a).
//
// Replaces the TPU kernels of libskylark_tpu/sketch/pallas_fastfood.py:
//   fused  (_launch -> _kernel): per (row, block) the whole chain
//          B.x -> WHT -> Pi gather -> (scal G). -> WHT -> (scal Sm).
//          -> scale * cos(. + shift)
//   split  (_launch_split -> _kernel_pre, _kernel_post): the same chain cut
//          at the gather; the caller gathers between the two kernels.
//   batched (_launch_batched -> _kernel_batched): the fused chain over a
//          stacked microbatch cohort, blockIdx.z the lane, each lane with
//          its own streams at offset lane * nb * NB and its own (m, S)
//          output block, written in block-major feature order and cut at
//          S (what serve_features_batched gets after its moveaxis and
//          slice).
// It computes what FastRFT._features_rows computes (frft._chain_rows); it
// is not a copy of the Pallas kernel's two kron dots. The streams arrive as
// (nb, NB) device arrays, scal already folded into G and Sm and the shifts
// zero-padded past S, exactly as the TPU kernel receives them.
//
// Bound on this card: bytes. At the main path's 16384 x 4096 -> 4096 only
// A (268 MB) and the features (268 MB) must cross device memory: 0.16 ms.
// The chain's 2 * m * NB * log2(NB) adds take ~0.05 ms at the fp32 add
// rate. Between the two lies on-chip traffic (a radix-2 WHT in shared
// memory makes 12 passes and 12 barriers a WHT), which the design cuts:
// - The WHT runs in registers. With NB = 2^k, each thread holds V = 2^L
//   values (L = min(4, k)), T = NB / V threads a row. A phase applies the
//   L levels whose index bits are the thread's own "window" of bits
//   [lo, lo + L): value j of thread t is element
//   (t mod 2^lo) | j << lo | (t >> lo) << (lo + L). Between phases one
//   shared-memory exchange (each value written once, read once) re-deals
//   the values so the next window is local. NB = 4096 takes three phases
//   and two exchanges a WHT where a radix-2 kernel takes twelve stages.
//   The last window is [k - L, k) (it may repeat levels of the one before
//   and applies only the new ones), so the last phase leaves element
//   t + j * T in value j: the stores are coalesced.
// - The levels keep the butterfly's order (h = 1, 2, ..., NB/2, each
//   butterfly (a + b, a - b)), so every WHT output is the same sum tree as
//   fut._wht_butterfly's, bit for bit.
// - The gather Pi is placed in an exchange: WHT1's last phase writes u in
//   natural order, and each thread reads u[perm[i]] for the positions of
//   WHT2's first window.
// - The exchange buffer is swizzled (swz) so that every exchange of the
//   main path's windows is free of bank conflicts. An exchange whose
//   elements stay in their warp (window 0 to 4 at NB = 4096; all of them,
//   the gather too, when a row group fits in a warp) takes warp barriers
//   only; the others alternate between two buffers with one __syncthreads
//   each. NB = 4096 takes three block barriers a row.
// - A block takes R rows of one Fastfood block (R * G rows, G groups of T
//   threads when a row needs fewer than 256 threads), so its streams are
//   re-read from L1, not from L2. Loading the next row's A during the
//   current one gains nothing: other blocks on the SM hide it.
//
// What holds it back now (0.47 ms on an H100): latency, not bytes or
// instruction rate. A 256-thread row group holds a row in registers, and
// registers (the chain needs ~128 a thread without spills) allow two such
// blocks a SM, so few rows are in flight to cover each row's chain of
// exchanges, stream loads and barriers.
//
// Numerics: every product and sum is rounded on its own (no FMA
// contraction) in the reference's operation order, and cos is the accurate
// cosf (never build with --use_fast_math: phases reach O(10)). The WHT sums
// in butterfly order, not the kron matmul's, so it agrees with the plain
// version to rounding, not to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wht.cuh"

namespace {

using namespace sk;

constexpr int kMaxNB = 16384;

enum Mode { kFused = 0, kPre = 1, kPost = 2 };

struct Args {
  const float* src;  // A (m, lda), or W (nb, m, NB) for kPost
  int64_t lda, d, m, s_dim;
  int NB, R;         // NB a power of two; R rows per group
  const float* bdiag;
  const int32_t* perm;
  const float* gdiag;
  const float* smdiag;
  const float* shift;
  float scale;
  float* out;        // features (m, s_dim), or W for kPre
  int64_t src_lane, out_lane, stream_lane;  // per-lane strides (blockIdx.z)
};

// The gather's slots: pv[j] = swz(perm[i0 + j]), to be XORed with the
// group's swz(base).
template <int V>
__device__ __forceinline__ void load_perm(int (&pv)[V], const int32_t* __restrict__ perm,
                                          int i0) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(perm + i0 + j));
      pv[j] = swz(q.x);
      pv[j + 1] = swz(q.y);
      pv[j + 2] = swz(q.z);
      pv[j + 3] = swz(q.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) pv[j] = swz(__ldg(perm + i0 + j));
  }
}

// One kernel for the three entry points, NB = 2^K. Block (x, b, z): rows
// x * R * G + it * G + g (it < R) of lane z, Fastfood block b; group g of
// T threads per row.
template <int K, int MODE>
__global__ void __launch_bounds__(Shape<K>::BLOCK, Shape<K>::MIN_BLOCKS)
    fastfood_kernel(const Args a) {
  using S = Shape<K>;
  constexpr int L = S::L, V = S::V, T = S::T, NB = 1 << K, LAST = S::LAST;
  extern __shared__ float smem[];
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  const int b = blockIdx.y;
  const int64_t z = blockIdx.z;
  const int64_t so = z * a.stream_lane + (int64_t)b * NB;
  const float* __restrict__ bd = a.bdiag + so;
  const int32_t* __restrict__ pm = a.perm + so;
  const float* __restrict__ gd = a.gdiag + so;
  const float* __restrict__ sm = a.smdiag + so;
  const float* __restrict__ sh = a.shift + so;
  const float* __restrict__ src = a.src + z * a.src_lane;
  float* __restrict__ out = a.out + z * a.out_lane;
  const int stride = S::G * NB;
  const int base = g * NB;
  const int i0 = t << L;  // window 0: elements i0 .. i0 + V
  int parity = 0;
  const int64_t len = MODE == kPost ? NB : a.d;
  const int64_t pitch = MODE == kPost ? NB : a.lda;
  const float* rows = MODE == kPost ? src + (int64_t)b * a.m * NB : src;
  const bool vec = (pitch & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;

  int64_t r = (int64_t)blockIdx.x * S::G * a.R + g;
  for (int it = 0; it < a.R; ++it, r += S::G) {
    float x[V];
    load_row<V>(x, rows + r * pitch, len, i0, vec, r < a.m);
    if (MODE != kPost) {
      scale_by<V>(x, bd, i0);
      wht<K>(x, smem, stride, parity, base, t);
      if (MODE == kPre) {
        if (r < a.m) {
          float* w = out + ((int64_t)b * a.m + r) * NB + t;
#pragma unroll
          for (int j = 0; j < V; ++j) w[j * T] = x[j];  // element t + j * T
        }
        continue;
      }
      // the gather: u in natural order to the buffer, u[perm[i]] back
      // (within the warp when a row group fits in one)
      constexpr bool local = T <= 32;
      float* e = smem + (local ? 2 : parity) * stride;
      if (local)
        __syncwarp();
      else
        parity ^= 1;
      const int wb = swz(base | tpart<L>(t, LAST));
#pragma unroll
      for (int j = 0; j < V; ++j) e[wb ^ swz(j << LAST)] = x[j];
      int pv[V];
      load_perm<V>(pv, pm, i0);
      if (local)
        __syncwarp();
      else
        __syncthreads();
      const int sb = swz(base);
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = e[sb ^ pv[j]];
    }
    scale_by<V>(x, gd, i0);
    wht<K>(x, smem, stride, parity, base, t);
    if (r < a.m) {
      // value j is element t + j * T of block b
      float* o = out + r * a.s_dim + (int64_t)b * NB + t;
      const int64_t last = a.s_dim - (int64_t)b * NB - t;  // values kept: j * T < last
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j * T < last) {
          const float zz =
              __fadd_rn(__fmul_rn(__ldg(sm + t + j * T), x[j]), __ldg(sh + t + j * T));
          o[j * T] = __fmul_rn(a.scale, cosf(zz));
        }
      }
    }
  }
}

template <int K, int MODE>
cudaError_t go(const Args& a, int64_t nb, int64_t B, cudaStream_t stream) {
  using S = Shape<K>;
  const size_t smem = 3 * (size_t)S::G * (1 << K) * sizeof(float);
  const int64_t per = (int64_t)S::G * a.R;
  const int64_t gx = (a.m + per - 1) / per;
  if (gx > 0x7FFFFFFF) return cudaErrorInvalidValue;
  auto kern = fastfood_kernel<K, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3((unsigned)gx, (unsigned)nb, (unsigned)B), S::G * S::T, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
int launch(const Args& a, int64_t nb, int64_t B, cudaStream_t stream) {
  int k = 0;
  while ((1 << k) < a.NB) ++k;
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
#define SK_FF_K(K) \
  case K: err = go<K, MODE>(a, nb, B, stream); break;
    SK_FF_K(1) SK_FF_K(2) SK_FF_K(3) SK_FF_K(4) SK_FF_K(5) SK_FF_K(6) SK_FF_K(7)
    SK_FF_K(8) SK_FF_K(9) SK_FF_K(10) SK_FF_K(11) SK_FF_K(12) SK_FF_K(13) SK_FF_K(14)
#undef SK_FF_K
  }
  return (int)err;
}

bool bad_geometry(int64_t m, int64_t NB, int64_t nb, int64_t R) {
  return m <= 0 || m > 0x7FFFFFFF || NB < 2 || NB > kMaxNB || (NB & (NB - 1)) || nb <= 0 ||
         nb > 65535 || R < 1 || R > 65535;
}

Args make_args(const float* src, int64_t lda, int64_t m, int64_t d, int64_t NB, int64_t s_dim,
               int64_t R, const float* bdiag, const int32_t* perm, const float* gdiag,
               const float* smdiag, const float* shift, float scale, float* out) {
  Args a;
  a.src = src;
  a.lda = lda;
  a.d = d;
  a.m = m;
  a.s_dim = s_dim;
  a.NB = (int)NB;
  a.R = (int)R;
  a.bdiag = bdiag;
  a.perm = perm;
  a.gdiag = gdiag;
  a.smdiag = smdiag;
  a.shift = shift;
  a.scale = scale;
  a.out = out;
  a.src_lane = a.out_lane = a.stream_lane = 0;
  return a;
}

}  // namespace

// rows: R, the rows each group of a block takes (sketch/cuda_fastfood.py
// plan()); it changes no bit of the result.
extern "C" int sk_fastfood_fused(const float* A, int64_t lda, int64_t m, int64_t d, int64_t NB,
                                 int64_t nb, int64_t s_dim, int64_t rows, const float* bdiag,
                                 const int32_t* perm, const float* gdiag, const float* smdiag,
                                 const float* shift, float scale, float* out,
                                 cudaStream_t stream) {
  if (bad_geometry(m, NB, nb, rows) || d > NB || d < 1 || lda < d ||
      s_dim <= (nb - 1) * NB || s_dim > nb * NB)
    return (int)cudaErrorInvalidValue;
  return launch<kFused>(make_args(A, lda, m, d, NB, s_dim, rows, bdiag, perm, gdiag, smdiag,
                                  shift, scale, out),
                        nb, 1, stream);
}

// Lane blockIdx.z of a stacked cohort: A (B, m, d), streams (B, nb, NB),
// out (B, m, s_dim).
extern "C" int sk_fastfood_batched(const float* A, int64_t B, int64_t m, int64_t d, int64_t NB,
                                   int64_t nb, int64_t s_dim, int64_t rows, const float* bdiag,
                                   const int32_t* perm, const float* gdiag, const float* smdiag,
                                   const float* shift, float scale, float* out,
                                   cudaStream_t stream) {
  if (bad_geometry(m, NB, nb, rows) || B < 1 || B > 65535 || d > NB || d < 1 ||
      s_dim <= (nb - 1) * NB || s_dim > nb * NB)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(A, d, m, d, NB, s_dim, rows, bdiag, perm, gdiag, smdiag, shift, scale, out);
  a.src_lane = m * d;
  a.out_lane = m * s_dim;
  a.stream_lane = nb * NB;
  return launch<kFused>(a, nb, B, stream);
}

// Split, first kernel: W[b, r, :] = H(B_b . x_r).
extern "C" int sk_fastfood_pre(const float* A, int64_t lda, int64_t m, int64_t d, int64_t NB,
                               int64_t nb, int64_t rows, const float* bdiag, float* W,
                               cudaStream_t stream) {
  if (bad_geometry(m, NB, nb, rows) || d > NB || d < 1 || lda < d)
    return (int)cudaErrorInvalidValue;
  return launch<kPre>(make_args(A, lda, m, d, NB, nb * NB, rows, bdiag, nullptr, nullptr,
                                nullptr, nullptr, 0.0f, W),
                      nb, 1, stream);
}

// Split, second kernel, on the gathered W (nb, m, NB): the chain after the
// gather.
extern "C" int sk_fastfood_post(const float* W, int64_t m, int64_t NB, int64_t nb, int64_t s_dim,
                                int64_t rows, const float* gdiag, const float* smdiag,
                                const float* shift, float scale, float* out,
                                cudaStream_t stream) {
  if (bad_geometry(m, NB, nb, rows) || s_dim <= (nb - 1) * NB || s_dim > nb * NB)
    return (int)cudaErrorInvalidValue;
  return launch<kPost>(make_args(W, NB, m, NB, NB, s_dim, rows, nullptr, nullptr, gdiag,
                                 smdiag, shift, scale, out),
                       nb, 1, stream);
}
