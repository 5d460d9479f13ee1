// Panel-free SRHT for Hopper (sm_90a), one launch per cohort.
//
// Replaces the TPU kernel of libskylark_tpu/sketch/pallas_fwht.py
// (_fwht_call -> _kernel; srht_apply_batched, the lane as a grid axis):
//   out = samp_scale * gather(FWHT_n((fut_scale * D) (.) a), idx)
// along the transform axis, for each lane z of a stacked cohort: rowwise
// A (B, m, n) -> out (B, m, s), columnwise A (B, n, m) -> out (B, s, m);
// n is a power of two >= 128, s <= 2048, fut_scale = 1/sqrt(n),
// samp_scale = sqrt(n/s). fwht_gen_kernel makes each lane's D (Rademacher,
// sub-stream 0; the scale folded in, an exact product) and idx (randint
// over the power-of-two span n, sub-stream 1: the low draw alone, since
// the multiplier is 0) from the lane's 2-word key, in base/randgen.py's
// counter-stream layout (chunk_key(fold_in(key, 0), j / 4096) for D, and
// randint's low-draw key split(chunk_key(fold_in(key, 1), 0))[1] for idx).
//
// Bound on this card: bytes. A is read once and the output written once;
// n*log2(n) adds per transformed vector are far below the fp32 add rate.
// What stands between is on-chip traffic and latency: a radix-2 WHT in
// shared memory takes log2(n) passes and as many block barriers. So:
// - The transform runs in registers (wht.cuh, the register WHT of B4):
//   NB = 2^K values of a vector over T = NB/16 threads, 16 each, with a
//   shared-memory exchange between phases of four levels. A vector of
//   NB = 8192 takes two block barriers, where a radix-2 WHT takes 13.
// - The sampled outputs come straight from one more exchange: the last
//   phase writes the vector in natural order, and out[k] reads element
//   idx[k]. Rowwise up to n = 16384 a row is one segment, so there is no
//   outer-factor sum.
// - Longer vectors factor H_n = H_P (x) H_b (b = 16384 rowwise, 2048
//   columnwise): each segment p is transformed as above and folded into
//   the s sums, out_k = samp * sum_p (-1)^popcount(p_k & p) * Y_p[q_k] for
//   idx_k = p_k * b + q_k, the segments in increasing p. When a lane has
//   too few vectors to fill the card, the segments are cut into `groups`
//   runs of blocks (the plan, from one lane's shape only); each run's sums
//   go to scratch unscaled and fwht_combine_kernel adds them in run order
//   and scales.
// - Columnwise, a block takes 8 columns (one 32-byte sector a row): each
//   segment of 2048 x 8 is copied by cp.async into an exchange buffer (a
//   column per vector, an XOR of the column into the bank bits keeps the
//   stores free of conflicts) and read back in the transform's layout; no
//   n x m scratch and no transpose (the reference transposes around its
//   rowwise kernel, one more round trip of A). Its s sums a thread live in
//   shared memory, where a third exchange buffer would be: beside the 16
//   values in registers they spill.
// What holds it back (H100): columnwise, one 1024-thread block a SM and
// each segment's load not overlapped with its transform; rowwise, the
// latency of a row's exchanges, as in B4.
// - Lanes are blockIdx.z: one launch of each kernel per cohort, each lane
//   with its own key, D and idx.
// The reference's op order is kept: the scale multiplies D first, the
// transform adds, the gather comes last and samp_scale multiplies after
// it. On dyadic data (integer operands, n and s even powers of two) every
// step is exact and the result bit-equal to the reference in any add
// order; otherwise the adds run in the butterfly's order, not the
// reference's kron matmul (allclose).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "threefry.cuh"
#include "wht.cuh"

namespace {

using namespace sk;

constexpr int kChunk = 4096;    // randgen.CHUNK
constexpr int kGenThreads = 256;
constexpr int kMaxS = 2048;     // one cipher sweep of chunk 0, as the TPU kernel
constexpr int kRowBits = 14;    // rowwise: whole rows up to 2^14, segments of 2^14 above
constexpr int kColBits = 11;    // columnwise: segments of 2^11 rows
constexpr int kCols = 8;        // columnwise: columns a block takes
constexpr int kFillBlocks = 132;  // blocks a lane should reach before its segments are cut
                                  // into runs (an H100's SMs; a constant, so a lane's bits
                                  // never depend on the card)

struct Args {
  const float* A;     // lane z at A + z * m * n
  const float* D;     // (B, n): fut_scale * Rademacher
  const int* idx;     // (B, s)
  float* out;         // (B, groups, out lane): the result when groups == 1, else partials
  int64_t m, n, s;
  int64_t segs;       // segments a block folds (one run of blockIdx.y)
  float scale;        // samp_scale when groups == 1, else 1
};

// The block of NB = 2^K: T threads a vector, G vectors a block (rows
// rowwise, kCols columns columnwise), 1024 threads a SM at most, so 64
// registers a thread. Rowwise a fold keeps its ACC sums a thread in
// registers; columnwise its SACC sums a thread in shared memory (sixteen
// sums beside the sixteen values would spill), in the room of the third
// exchange buffer, so every columnwise exchange takes a block barrier.
template <int K, bool COLS, bool FOLD>
struct Geo {
  static constexpr int T = Shape<K>::T;
  static constexpr int G = COLS ? kCols : Shape<K>::G;
  static constexpr int BLOCK = G * T;
  static constexpr int MIN_BLOCKS = BLOCK >= 1024 ? 1 : 1024 / BLOCK;
  static constexpr int BUFS = COLS ? 2 : 3;
  static constexpr int ACC = FOLD && !COLS ? (kMaxS + T - 1) / T : 1;
  static constexpr int SACC = FOLD && COLS ? (kMaxS + T - 1) / T : 0;
  static constexpr size_t SMEM = ((size_t)BUFS * G * (1 << K) + (size_t)SACC * BLOCK) * 4;
};

__global__ void fwht_gen_kernel(const uint32_t* __restrict__ keys, int64_t n, int s,
                                float fut_scale, float* __restrict__ D,
                                int* __restrict__ idx) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t z = blockIdx.y;
  const uint32_t key0 = keys[2 * z], key1 = keys[2 * z + 1];
  if (j < n) {
    uint32_t k0 = key0, k1 = key1;
    fold_in(k0, k1, 0u);
    chunk_key(k0, k1, j / kChunk);
    D[z * n + j] =
        __fmul_rn(fut_scale, rademacher(stream_bits(k0, k1, (uint32_t)(j % kChunk))));
  }
  if (j < s) {
    uint32_t k0 = key0, k1 = key1;
    fold_in(k0, k1, 1u);
    chunk_key(k0, k1, 0);
    fold_in(k0, k1, 1u);
    idx[z * s + j] = (int)(stream_bits(k0, k1, (uint32_t)j) & (uint32_t)(n - 1));
  }
}

// cp.async of one float into shared memory, zero-filled when !valid (no
// register holds it: a segment's 16 loads a thread are all in flight).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block (x, y, z): vectors x * G .. x * G + G (rows, or columns x * 8 ..)
// of lane z, segments y * segs .. (y + 1) * segs. FOLD: more than one
// segment a vector, the sums kept across segments; else the one segment's
// samples are written straight from the exchange buffer.
template <int K, bool COLS, bool FOLD>
__global__ void __launch_bounds__(Geo<K, COLS, FOLD>::BLOCK, Geo<K, COLS, FOLD>::MIN_BLOCKS)
    fwht_kernel(const Args a) {
  using S = Shape<K>;
  using Gm = Geo<K, COLS, FOLD>;
  constexpr int L = S::L, V = S::V, T = S::T, NB = 1 << K, LAST = S::LAST;
  constexpr int G = Gm::G, BLOCK = Gm::BLOCK;
  constexpr int NSUM = COLS ? Gm::SACC : Gm::ACC;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, g = tid / T, t = tid % T;
  const int64_t z = blockIdx.z;
  const int64_t m = a.m, n = a.n;
  const int s = (int)a.s;
  const float* __restrict__ A = a.A + z * m * n;
  const float* __restrict__ D = a.D + z * n;
  const int* __restrict__ idx = a.idx + z * s;
  float* __restrict__ out = a.out + (z * gridDim.y + blockIdx.y) * m * s;
  const int stride = G * NB;
  const int base = g * NB;
  const int i0 = t << L;  // window 0: elements i0 .. i0 + V
  int parity = 0;
  // rowwise: row v of the block's G; columnwise: columns c0 .. c0 + 8
  const int64_t v = (int64_t)blockIdx.x * G + g;
  const int64_t c0 = (int64_t)blockIdx.x * kCols;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  // the sums' owners: rowwise sample t + T * r of row g; columnwise
  // sample tid / 8 + T * r of column tid % 8 (a warp writes 4 x 32 bytes),
  // its sum at sacc[tid + BLOCK * r]: the (s, 8) block, each thread's own
  const int k0 = COLS ? tid / kCols : t;
  const int cg = COLS ? tid % kCols : g;
  float acc[Gm::ACC];
  float* sacc = smem + Gm::BUFS * stride;
#pragma unroll
  for (int r = 0; r < NSUM; ++r) {
    if constexpr (COLS)
      sacc[tid + BLOCK * r] = 0.0f;
    else
      acc[r] = 0.0f;
  }

  const int64_t p0 = (int64_t)blockIdx.y * a.segs;
  for (int64_t p = p0; p < p0 + a.segs; ++p) {
    float x[V];
    if constexpr (COLS) {
      // rows p * NB .. + NB of columns c0 .. c0 + 8, coalesced, into a
      // buffer as 8 vectors by cp.async; element i of column c at
      // swz(c * NB + i) ^ (c << 2), so a warp's 4 rows x 8 columns hit 32
      // banks
      // (thread tid loads column tid % 8 of rows tid / 8 + T * u: the
      // slot is its own part XOR a constant per u, the source a stride)
      float* e = smem + parity * stride;
      parity ^= 1;
      const bool ok = c0 + cg < m;
      const float* src = ok ? A + (p * NB + k0) * m + c0 + cg : A;
      const int sl = swz(cg * NB + k0) ^ (cg << 2);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        cp_async_f32(e + (sl ^ swz(u * T)), src, ok);
        if (ok) src += (int64_t)T * m;
      }
      cp_async_wait_all();
      __syncthreads();
      const int rb = swz(base | tpart<L>(t, 0)) ^ (g << 2);
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = e[rb ^ swz(j)];
    } else {
      load_row<V>(x, A + v * n + p * NB, NB, i0, vec, v < m);
    }
    scale_by<V>(x, D + p * NB, i0);
    wht<K, COLS>(x, smem, stride, parity, base, t);
    // the vector in natural order to a buffer (within the warp when a
    // row fits in one), then the samples read at idx; columnwise, the
    // column is XORed into the bank bits again, so the 8 columns of one
    // sample fall in 8 banks
    constexpr bool local = !COLS && T <= 32;
    float* e = smem + (local ? 2 : parity) * stride;
    if (local)
      __syncwarp();
    else
      parity ^= 1;
    const int wb = swz(base | tpart<L>(t, LAST)) ^ (COLS ? g << 2 : 0);
#pragma unroll
    for (int j = 0; j < V; ++j) e[wb ^ swz(j << LAST)] = x[j];
    if (local)
      __syncwarp();
    else
      __syncthreads();
    const int sb = swz(cg * NB) ^ (COLS ? cg << 2 : 0);
    if constexpr (FOLD && COLS) {
      // the sums, in shared memory, one at a time (unrolled, the loads of
      // all sixteen would be hoisted, and spill)
#pragma unroll 1
      for (int r = 0; r < NSUM; ++r) {
        const int k = k0 + T * r;
        if (k < s) {
          const int id = __ldg(idx + k);
          const float y = e[sb ^ swz(id & (NB - 1))];
          float& sum = sacc[tid + BLOCK * r];
          sum = (__popc((id >> K) & (int)p) & 1) ? __fsub_rn(sum, y) : __fadd_rn(sum, y);
        }
      }
    } else if constexpr (FOLD) {
#pragma unroll
      for (int r = 0; r < NSUM; ++r) {
        const int k = k0 + T * r;
        if (k < s) {
          const int id = __ldg(idx + k);
          const float y = e[sb ^ swz(id & (NB - 1))];
          acc[r] = (__popc((id >> K) & (int)p) & 1) ? __fsub_rn(acc[r], y) : __fadd_rn(acc[r], y);
        }
      }
    } else if constexpr (COLS) {
#pragma unroll 1
      for (int q = tid; q < s * kCols; q += BLOCK) {
        const int k = q / kCols, c = q % kCols;
        if (c0 + c < m)
          out[(int64_t)k * m + c0 + c] =
              __fmul_rn(a.scale, e[swz(c * NB) ^ (c << 2) ^ swz(__ldg(idx + k))]);
      }
    } else if (v < m) {
      for (int k = t; k < s; k += T)
        out[v * s + k] = __fmul_rn(a.scale, e[sb ^ swz(__ldg(idx + k))]);
    }
  }
  if constexpr (FOLD) {
#pragma unroll
    for (int r = 0; r < NSUM; ++r) {
      const int k = k0 + T * r;
      if (k >= s) continue;
      if constexpr (COLS) {
        if (c0 + cg < m) out[(int64_t)k * m + c0 + cg] = __fmul_rn(a.scale, sacc[tid + BLOCK * r]);
      } else if (v < m) {
        out[v * s + k] = __fmul_rn(a.scale, acc[r]);
      }
    }
  }
}

// out[z][e] = samp * (part[z][0][e] + part[z][1][e] + ...), the runs in
// order.
__global__ void fwht_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int64_t size, int groups, float samp) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  const int64_t z = blockIdx.y;
  const float* p = part + z * groups * size + e;
  float total = p[0];
  for (int i = 1; i < groups; ++i) total = __fadd_rn(total, p[i * size]);
  out[z * size + e] = __fmul_rn(samp, total);
}

// One launch of fwht_kernel<K, COLS, FOLD>; the shared-memory attribute is
// set once per device.
template <int K, bool COLS, bool FOLD>
cudaError_t go(const Args& a, int64_t B, int64_t groups, cudaStream_t stream) {
  using Gm = Geo<K, COLS, FOLD>;
  auto kern = fwht_kernel<K, COLS, FOLD>;
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (Gm::SMEM > 48 * 1024 && dev < 64 && !((ready.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Gm::SMEM);
    if (err != cudaSuccess) return err;
    ready.fetch_or(1ull << dev);
  }
  const int64_t per = COLS ? kCols : Gm::G;
  const int64_t gx = (a.m + per - 1) / per;
  if (gx > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)gx, (unsigned)groups, (unsigned)B), Gm::BLOCK, Gm::SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int log_n, bool rowwise, int64_t B, int64_t groups,
                     cudaStream_t stream) {
  if (!rowwise) {
    switch (log_n) {
      case 7: return go<7, true, false>(a, B, groups, stream);
      case 8: return go<8, true, false>(a, B, groups, stream);
      case 9: return go<9, true, false>(a, B, groups, stream);
      case 10: return go<10, true, false>(a, B, groups, stream);
      case 11: return go<11, true, false>(a, B, groups, stream);
      default: return go<kColBits, true, true>(a, B, groups, stream);
    }
  }
  switch (log_n) {
    case 7: return go<7, false, false>(a, B, groups, stream);
    case 8: return go<8, false, false>(a, B, groups, stream);
    case 9: return go<9, false, false>(a, B, groups, stream);
    case 10: return go<10, false, false>(a, B, groups, stream);
    case 11: return go<11, false, false>(a, B, groups, stream);
    case 12: return go<12, false, false>(a, B, groups, stream);
    case 13: return go<13, false, false>(a, B, groups, stream);
    case 14: return go<14, false, false>(a, B, groups, stream);
    default: return go<kRowBits, false, true>(a, B, groups, stream);
  }
}

int log2_exact(int64_t n) {
  int k = 0;
  while ((int64_t{1} << k) < n) ++k;
  return (int64_t{1} << k) == n ? k : -1;
}

// The runs a lane's segments are cut into: 1 unless a vector folds
// segments (n > 2^14 rowwise, n > 2^11 columnwise); then doubled, up to
// the segments, until a lane of m vectors has kFillBlocks blocks. It reads
// one lane's shape only (sketch/cuda_fwht.py plan() mirrors it for the CPU
// replay of the add order).
int64_t lane_groups(int64_t m, int log_n, bool rowwise) {
  const int seg_bits = rowwise ? kRowBits : kColBits;
  const int64_t segs = log_n > seg_bits ? int64_t{1} << (log_n - seg_bits) : 1;
  const int64_t per = rowwise ? Geo<kRowBits, false, true>::G : Geo<kColBits, true, true>::G;
  const int64_t blocks = (m + per - 1) / per;
  int64_t groups = 1;
  while (groups < segs && blocks * groups < kFillBlocks) groups *= 2;
  return groups;
}

}  // namespace

// The runs of a launch over lanes of m vectors of length n: the wrapper
// sizes the scratch `part` of sk_fwht_apply by it.
extern "C" int64_t sk_fwht_groups(int64_t m, int64_t n, int rowwise) {
  const int log_n = log2_exact(n);
  return log_n < 0 ? 1 : lane_groups(m, log_n, rowwise != 0);
}

// SRHT of a stacked cohort, one launch of each kernel: keys (B, 2) words;
// A (B, m, n) rowwise or (B, n, m) columnwise, contiguous; out (B, m, s)
// or (B, s, m). Scratch, allocated by the caller: D (B * n floats), idx
// (B * s ints) and, when sk_fwht_groups(m, n, rowwise) > 1, part
// (B * groups * m * s floats).
extern "C" int sk_fwht_apply(const float* A, const uint32_t* keys, float* D, int* idx,
                             float* part, float* out, int64_t B, int64_t m, int64_t n,
                             int64_t s, int rowwise, float fut_scale, float samp_scale,
                             cudaStream_t stream) {
  const int log_n = log2_exact(n);
  const int seg_bits = rowwise ? kRowBits : kColBits;
  const int64_t segs = log_n > seg_bits ? int64_t{1} << (log_n - seg_bits) : 1;
  if (log_n < 7 || log_n > 40 || m <= 0 || m > 0x7FFFFFFF || s <= 0 || s > kMaxS || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t groups = lane_groups(m, log_n, rowwise != 0);
  if (groups > 65535 || segs % groups || (groups > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const int64_t count = n > s ? n : s;
  fwht_gen_kernel<<<dim3((unsigned)((count + kGenThreads - 1) / kGenThreads), (unsigned)B),
                    kGenThreads, 0, stream>>>(keys, n, (int)s, fut_scale, D, idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.A = A;
  a.D = D;
  a.idx = idx;
  a.out = groups > 1 ? part : out;
  a.m = m;
  a.n = n;
  a.s = s;
  a.segs = segs / groups;
  a.scale = groups > 1 ? 1.0f : samp_scale;
  err = dispatch(a, log_n, rowwise != 0, B, groups, stream);
  if (err != cudaSuccess || groups == 1) return (int)err;
  const int64_t size = m * s;
  fwht_combine_kernel<<<dim3((unsigned)((size + 255) / 256), (unsigned)B), 256, 0, stream>>>(
      part, out, size, (int)groups, samp_scale);
  return (int)cudaGetLastError();
}
