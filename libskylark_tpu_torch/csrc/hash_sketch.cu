// CountSketch (CWT) for Hopper (sm_90a), ordered and deterministic.
//
// Replaces the TPU kernel of libskylark_tpu/sketch/pallas_hash.py
// (_hash_call -> _kernel_cw / _kernel_rw, "exact" mode):
//   columnwise  out[h[j], :] += v[j] * A[j, :]    A (n, m) -> out (s, m)
//   rowwise     out[:, h[j]] += v[j] * A[:, j]    A (m, n) -> out (m, s)
// h[j] is UniformInt(0, s-1) of sub-stream 0 (jax.random.randint's double
// draw) and v[j] Rademacher of sub-stream 1. Both are generated here from
// the transform's 2-word key in base/randgen.py's counter-stream layout
// (word p of chunk c is x0 ^ x1 of Threefry at the counters (0, p) under
// the chunk key): each sort block derives its chunk's keys on the card —
// sub-stream i's key is fold_in(key, i), chunk c's is chunk_key of that,
// and randint's high- and low-draw keys are split's pair of the bucket
// stream's chunk key. A sort tile lies inside one chunk.
//
// Bound on this card: bytes. A is read once and the output written once;
// there is one multiply-add per element of A.
//
// Design. The sums must be the sequential scatter's, in increasing j, so
// that the result is bit-equal to it: every v * a is exact (v = +-1), so
// only the order of the adds matters. Atomics would add in an arbitrary
// order, so the kernel sorts instead:
// 1. hash_sort_kernel, one block per tile of kTile coordinates, derives
//    its chunk's keys, generates h and v and sorts the tile's coordinates
//    by bucket, stably: the position of coordinate e is the number of the
//    tile's coordinates with a smaller bucket plus the number of earlier
//    ones with the same bucket
//    (an O(kTile^2) count in shared memory: no atomics, no scan). It writes
//    the sorted local indices and values, and off[t][b], the first sorted
//    position of bucket b in tile t (b <= s).
// 2. Accumulation walks the tiles in order and each bucket's coordinates
//    within a tile in order, so each output entry adds its terms in
//    increasing j.
//    - columnwise: one warp per (bucket, 128 output columns); a lane owns
//      4 columns, and each row of A it adds is read coalesced.
//    - rowwise: one block per (8 rows, 1024 buckets); per tile the block
//      stages A's 8 x kTile tile in shared memory, and each thread adds
//      the coordinates of its 4 buckets for the 8 rows. With s > 1024 the
//      tile is read once per group of 1024 buckets.
// Ragged n is masked, not padded: coordinates past n are never sorted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kChunk = 4096;   // randgen.CHUNK: stream chunk length
constexpr int kTile = 1024;    // coordinates per sort tile
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;  // coordinates per thread in a tile
constexpr int kColsCW = 128;   // output columns per warp, columnwise
constexpr int kRowsRW = 8;     // rows per block, rowwise
constexpr int kBucketsRW = kThreads * 4;  // buckets per block, rowwise
static_assert(kChunk % kTile == 0, "a sort tile must lie inside one stream chunk");

__global__ void __launch_bounds__(kThreads)
hash_sort_kernel(uint32_t key0, uint32_t key1, int64_t n, int s, uint32_t mult,
                 int* __restrict__ off, int* __restrict__ idx, float* __restrict__ val) {
  __shared__ int hs[kTile];
  __shared__ int sorted_h[kTile];
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int len = (int)(n - base < kTile ? n - base : kTile);
  const uint32_t span = (uint32_t)s;

  // the chunk's keys (8 cipher calls, the same in every thread): randint's
  // high (hk) and low (lk) draw keys, and the value stream's key (vk)
  const int64_t c = base / kChunk;
  uint32_t hk0 = key0, hk1 = key1, vk0 = key0, vk1 = key1;
  sk::fold_in(hk0, hk1, 0u);
  sk::chunk_key(hk0, hk1, c);
  uint32_t lk0 = hk0, lk1 = hk1;
  sk::fold_in(hk0, hk1, 0u);
  sk::fold_in(lk0, lk1, 1u);
  sk::fold_in(vk0, vk1, 1u);
  sk::chunk_key(vk0, vk1, c);

  int h[kPer];
  float v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid * kPer + q;
    h[q] = -1;
    v[q] = 0.0f;
    if (e < len) {
      const uint32_t p = (uint32_t)((base + e) % kChunk);
      uint32_t r = sk::stream_bits(lk0, lk1, p) % span;
      if (mult) {  // uint32 arithmetic, wrapping as jax.random.randint's
        const uint32_t hi = sk::stream_bits(hk0, hk1, p) % span;
        r = (hi * mult + r) % span;
      }
      h[q] = (int)r;
      v[q] = sk::rademacher(sk::stream_bits(vk0, vk1, p));
    }
    hs[e] = h[q];
  }
  __syncthreads();

  // stable counting sort: pos = #{i : h_i < h_e} + #{i < e : h_i == h_e}
  int pos[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) pos[q] = 0;
  for (int i = 0; i < len; ++i) {
    const int hi = hs[i];
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      pos[q] += (hi < h[q]) + (hi == h[q] && i < tid * kPer + q);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid * kPer + q;
    if (e < len) {
      sorted_h[pos[q]] = h[q];
      idx[base + pos[q]] = e;
      val[base + pos[q]] = v[q];
    }
  }
  __syncthreads();

  // off[b] = first sorted position k with sorted_h[k] >= b, for b <= s:
  // position k covers the buckets (sorted_h[k-1], sorted_h[k]], and
  // position len the buckets after the last one, up to s
  int* o = off + (int64_t)blockIdx.x * (s + 1);
  for (int k = tid; k <= len; k += kThreads) {
    const int lo = k == 0 ? -1 : sorted_h[k - 1];
    const int hi = k == len ? s : sorted_h[k];
    for (int b = lo + 1; b <= hi; ++b) o[b] = k;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_cw_kernel(const float* __restrict__ A, const int* __restrict__ off,
               const int* __restrict__ idx, const float* __restrict__ val,
               float* __restrict__ out, int64_t m, int64_t n, int s, int64_t ld) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (b >= s) return;  // whole warps
  const int64_t c0 = (int64_t)blockIdx.y * kColsCW + lane;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = 0; t < tiles; ++t) {
    const int* o = off + t * (s + 1);
    const int64_t base = t * kTile;
    const int k1 = o[b + 1];
    for (int k = o[b]; k < k1; ++k) {
      const float vk = val[base + k];
      const float* row = A + (base + idx[base + k]) * ld;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int64_t c = c0 + 32 * p;
        if (c < m) acc[p] = __fadd_rn(acc[p], __fmul_rn(vk, __ldg(row + c)));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int64_t c = c0 + 32 * p;
    if (c < m) out[(int64_t)b * m + c] = acc[p];
  }
}

__global__ void __launch_bounds__(kThreads)
hash_rw_kernel(const float* __restrict__ A, const int* __restrict__ off,
               const int* __restrict__ idx, const float* __restrict__ val,
               float* __restrict__ out, int64_t m, int64_t n, int s, int64_t ld) {
  __shared__ float As[kRowsRW][kTile];
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kRowsRW;
  const int b0 = blockIdx.y * kBucketsRW;
  float acc[kRowsRW][4];
#pragma unroll
  for (int r = 0; r < kRowsRW; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t base = t * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    for (int e = tid; e < kRowsRW * kTile; e += kThreads) {
      const int r = e / kTile, jj = e % kTile;
      const int64_t row = r0 + r;
      As[r][jj] = (row < m && jj < len) ? __ldg(A + row * ld + base + jj) : 0.0f;
    }
    __syncthreads();
    const int* o = off + t * (s + 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + tid + kThreads * q;
      if (b < s) {
        const int k1 = o[b + 1];
        for (int k = o[b]; k < k1; ++k) {
          const int jj = idx[base + k];
          const float vk = val[base + k];
#pragma unroll
          for (int r = 0; r < kRowsRW; ++r)
            acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(vk, As[r][jj]));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsRW; ++r) {
    const int64_t row = r0 + r;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + tid + kThreads * q;
      if (b < s) out[row * s + b] = acc[r][q];
    }
  }
}

cudaError_t launch(bool rowwise, const float* A, uint32_t key0, uint32_t key1, float* out,
                   int* off,
                   int* idx, float* val, int64_t m, int64_t n, int64_t s, int64_t ld,
                   uint32_t mult, cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (m <= 0 || n <= 0 || s <= 0 || s >= 0x7FFFFFFF || n >= 0x7FFFFFFF ||
      ld < (rowwise ? n : m) || (rowwise ? (m + kRowsRW - 1) / kRowsRW > 0x7FFFFFFF ||
                                               (s + kBucketsRW - 1) / kBucketsRW > 65535
                                         : (m + kColsCW - 1) / kColsCW > 65535))
    return cudaErrorInvalidValue;
  hash_sort_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(key0, key1, n, (int)s, mult, off,
                                                             idx, val);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (rowwise) {
    const dim3 grid((unsigned)((m + kRowsRW - 1) / kRowsRW),
                    (unsigned)((s + kBucketsRW - 1) / kBucketsRW));
    hash_rw_kernel<<<grid, kThreads, 0, stream>>>(A, off, idx, val, out, m, n, (int)s, ld);
  } else {
    const int warps = kThreads / 32;
    const dim3 grid((unsigned)((s + warps - 1) / warps), (unsigned)((m + kColsCW - 1) / kColsCW));
    hash_cw_kernel<<<grid, kThreads, 0, stream>>>(A, off, idx, val, out, m, n, (int)s, ld);
  }
  return cudaGetLastError();
}

}  // namespace

// Scratch, allocated by the caller: off (ceil(n/1024) * (s+1) ints), idx
// and val (ceil(n/1024) * 1024 each). (key0, key1): the transform's key.
extern "C" int sk_hash_columnwise(const float* A, uint32_t key0, uint32_t key1, float* out,
                                  int* off, int* idx, float* val, int64_t m, int64_t n,
                                  int64_t s, int64_t ld, uint32_t mult, cudaStream_t stream) {
  return (int)launch(false, A, key0, key1, out, off, idx, val, m, n, s, ld, mult, stream);
}

extern "C" int sk_hash_rowwise(const float* A, uint32_t key0, uint32_t key1, float* out,
                               int* off, int* idx, float* val, int64_t m, int64_t n, int64_t s,
                               int64_t ld, uint32_t mult, cudaStream_t stream) {
  return (int)launch(true, A, key0, key1, out, off, idx, val, m, n, s, ld, mult, stream);
}
