// CountSketch (CWT) for Hopper (sm_90a), ordered and deterministic, one
// launch per cohort.
//
// Replaces the TPU kernel of libskylark_tpu/sketch/pallas_hash.py
// (_hash_call -> _kernel_cw / _kernel_rw, "exact" mode; cwt_apply_batched,
// the lane as a grid axis), for each lane z of a stacked cohort:
//   columnwise  out[z][h[j], :] += v[j] * A[z][j, :]   A (B, n, m) -> out (B, s, m)
//   rowwise     out[z][:, h[j]] += v[j] * A[z][:, j]   A (B, m, n) -> out (B, m, s)
// h[j] is UniformInt(0, s-1) of sub-stream 0 (jax.random.randint's double
// draw) and v[j] Rademacher of sub-stream 1 of the lane's key, in
// base/randgen.py's counter-stream layout (word p of chunk c is x0 ^ x1 of
// Threefry at the counters (0, p) under the chunk key): sub-stream i's key
// is fold_in(key, i), chunk c's is chunk_key of that, and randint's high-
// and low-draw keys are split's pair of the bucket stream's chunk key. A
// coordinate's bucket and sign travel as one word, the sign in bit 31.
//
// Bound on this card: bytes. A is read once and the output written once;
// there is one sign flip and one add per element of A.
//
// Contract: bit-equal to the sequential scatter, in increasing j. Every
// v * a is exact (v = +-1: a sign flip), so only the order of the adds
// matters. Atomics would add in an arbitrary order, so:
// - rowwise needs no sort. Every row meets the same buckets in the same
//   batches of 32 coordinates, so hash_table_kernel ranks them once a
//   lane: each coordinate's word, and beside it its rank among the earlier
//   coordinates of its batch that share its bucket (__match_any_sync) and
//   the batch's largest rank (2 ints a coordinate, read from L2). One warp
//   per row streams the row of A coalesced in increasing j, 8 batches of
//   32 coordinates in flight, and adds each batch into an on-chip copy of
//   the output row: at once when the batch's buckets are distinct (the
//   common case), else rank by rank, so coordinates that share a bucket
//   add in j order. The row is written whole, zeros included: the output
//   needs no zero-fill. A row wider than 1024 buckets is walked in tiles of
//   1024, the row of A read again for each.
// - columnwise keeps an order-giving sort: hash_sort_kernel, one block per
//   (1024-coordinate tile, lane), hashes the tile and sorts it by (bucket,
//   j) with a bitonic sort in shared memory, and writes each bucket's first
//   sorted position (off, s + 1 ints a tile). hash_cw_kernel takes one warp
//   per (bucket, column strip): lane u reads the bucket's run in tile
//   t0 + u, so 32 tiles' runs come from one round of loads, then 32 of the
//   runs' coordinates at once, then the rows of A in increasing j, four
//   rows in flight. The strip is sized to m (at most 256 columns, 8 a
//   lane), so no strip is nearly empty.
// Ragged n is masked, not padded: coordinates past n are never added.
//
// Accumulate (columnwise): each (bucket, column) cell of out starts at its
// value on entry instead of 0, and the batch's rows are added to it in
// increasing j, the order of a sequential scatter into a carried
// accumulator. A bucket that no coordinate of the batch hits keeps its
// value: its warp adds nothing and writes back what it read. A stream
// folded batch by batch so adds every cell's terms in the order of the
// one-shot sketch of all its rows, and the two are bit-equal.
//
// A shard (n0 > 0): the operand holds the contracted coordinates
// [n0, n0 + n) of a longer axis, a rank's block of a mesh-distributed
// operand. Coordinate j of the lane is hashed as n0 + j, in the streams'
// layout an add to the counter (chunk (n0 + j) / 4096, word (n0 + j) %
// 4096), so the shard meets exactly its own buckets and signs and the
// ranks' partials sum to the whole operand's sketch. Columnwise sort tiles
// stay aligned to the global axis (a tile lies in one chunk): the first
// tile starts n0 % 1024 entries before the shard and masks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using namespace sk;

constexpr int kChunk = 4096;      // randgen.CHUNK: stream chunk length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBits = 10;
constexpr int kTile = 1 << kTileBits;  // coordinates per sort tile, columnwise
constexpr int kSortThreads = kTile / 2;
constexpr int kRowBuf = 1024;     // output columns a rowwise warp holds on chip
constexpr int kBatch = 8;         // 32-coordinate batches a rowwise warp loads at once
constexpr int kMaxCpl = 8;        // output columns a lane holds, columnwise
constexpr int kCoords = 4;        // coordinates a columnwise warp loads at once
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;
static_assert(kChunk % kTile == 0, "a sort tile lies inside one stream chunk");

// Chunk c's keys of lane z: randint's low (l) and high (h) draw keys and
// the value stream's key (v).
struct ChunkKeys {
  uint32_t l0, l1, h0, h1, v0, v1;
};

__device__ __forceinline__ ChunkKeys chunk_keys(const uint32_t* __restrict__ keys, int64_t z,
                                                int64_t c) {
  uint32_t h0 = keys[2 * z], h1 = keys[2 * z + 1];
  uint32_t v0 = h0, v1 = h1;
  fold_in(h0, h1, 0u);
  chunk_key(h0, h1, c);
  ChunkKeys k;
  k.l0 = h0;
  k.l1 = h1;
  fold_in(k.l0, k.l1, 1u);
  fold_in(h0, h1, 0u);
  k.h0 = h0;
  k.h1 = h1;
  fold_in(v0, v1, 1u);
  chunk_key(v0, v1, c);
  k.v0 = v0;
  k.v1 = v1;
  return k;
}

// Word p of the chunk: the bucket (randint in uint32 arithmetic, wrapping
// as jax.random.randint's; mult = 0 for spans that are powers of two or
// above 2^16), and bit 31 set where v = -1 (Rademacher's top bit).
__device__ __forceinline__ uint32_t hash_word(const ChunkKeys& k, uint32_t p, uint32_t span,
                                              uint32_t mult) {
  uint32_t r = stream_bits(k.l0, k.l1, p) % span;
  if (mult) r = ((stream_bits(k.h0, k.h1, p) % span) * mult + r) % span;
  return r | (stream_bits(k.v0, k.v1, p) & kSign);
}

// v * a for the word's sign: a sign flip, exact.
__device__ __forceinline__ float signed_value(float a, uint32_t word) {
  return __int_as_float(__float_as_int(a) ^ (int)(word & kSign));
}

// Rowwise, pass 1, one thread per (coordinate, lane), a warp per batch of
// 32 coordinates: (word, rank | top << 8), rank = the batch's earlier
// coordinates with the same bucket, top = the batch's largest rank.
__global__ void __launch_bounds__(kThreads)
hash_table_kernel(const uint32_t* __restrict__ keys, int64_t n, int64_t n0, uint32_t span,
                  uint32_t mult, uint2* __restrict__ words) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t z = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const bool valid = j < n;
  uint32_t wd = 0;
  if (valid) {
    const int64_t g = n0 + j;  // the coordinate's global index
    const ChunkKeys k = chunk_keys(keys, z, g / kChunk);
    wd = hash_word(k, (uint32_t)(g % kChunk), span, mult);
  }
  const unsigned peers = __match_any_sync(kFull, valid ? (int)(wd & ~kSign) : -1 - lane);
  const unsigned rank = __popc(peers & ((1u << lane) - 1u));
  const unsigned top = __reduce_max_sync(kFull, valid ? rank : 0u);
  if (valid) words[z * n + j] = make_uint2(wd, rank | top << 8);
}

// Rowwise, pass 2, one warp per (row, lane); buf_w output columns a warp
// on chip (a multiple of 4).
__global__ void __launch_bounds__(kThreads)
hash_rw_kernel(const float* __restrict__ A, const uint2* __restrict__ words,
               float* __restrict__ out, int64_t m, int64_t n, int s, int buf_w) {
  extern __shared__ __align__(16) float buf[];
  const int64_t z = blockIdx.y;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + w;
  if (r >= m) return;  // whole warps; no block barrier follows
  const float* __restrict__ a = A + (z * m + r) * n;
  const uint2* __restrict__ hw = words + z * n;
  float* __restrict__ o = out + (z * m + r) * s;
  float* row = buf + w * buf_w;
  for (int c0 = 0; c0 < s; c0 += buf_w) {
    const int cw = s - c0 < buf_w ? s - c0 : buf_w;
    for (int i = lane; i < cw; i += 32) row[i] = 0.0f;
    __syncwarp();
    for (int64_t j0 = 0; j0 < n; j0 += 32 * kBatch) {
      float x[kBatch];
      uint2 wd[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t j = j0 + 32 * u + lane;
        x[u] = j < n ? __ldg(a + j) : 0.0f;
        wd[u] = j < n ? __ldg(hw + j) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + 32 * u >= n) break;  // warp-uniform
        const int b = (int)(wd[u].x & ~kSign) - c0;
        const bool valid = j0 + 32 * u + lane < n && b >= 0 && b < cw;
        const float xv = signed_value(x[u], wd[u].x);
        // lane 0 holds a coordinate of every batch entered
        const unsigned top = __shfl_sync(kFull, wd[u].y, 0) >> 8;
        const unsigned rank = wd[u].y & 0xFFu;
        // at once when the batch's buckets are distinct, else rank by rank:
        // coordinates sharing a bucket add in j order
        for (unsigned q = 0; q <= top; ++q) {
          if (valid && rank == q) row[b] = __fadd_rn(row[b], xv);
          __syncwarp();
        }
      }
    }
    if ((s & 3) == 0) {
      float4* o4 = reinterpret_cast<float4*>(o + c0);
      const float4* r4 = reinterpret_cast<const float4*>(row);
      for (int i = lane; i < cw / 4; i += 32) o4[i] = r4[i];
    } else {
      for (int i = lane; i < cw; i += 32) o[c0 + i] = row[i];
    }
    __syncwarp();
  }
}

// Columnwise, pass 1, one block per (tile, lane): the tile's words sorted
// by (bucket, e), as e | sign (bit 31), e the position in the tile, and
// off[b] = the first sorted position whose bucket is >= b, for b <= s.
// Tile t holds the global coordinates (n0 / 1024 + t) * 1024 + e, those of
// the shard [n0, n0 + n) valid.
__global__ void __launch_bounds__(kSortThreads)
hash_sort_kernel(const uint32_t* __restrict__ keys, int64_t n, int64_t n0, int s,
                 uint32_t mult, int* __restrict__ off, uint32_t* __restrict__ sorted) {
  __shared__ unsigned long long key[kTile];
  const int64_t z = blockIdx.y, t = blockIdx.x, tiles = gridDim.x;
  const int front = (int)(n0 % kTile);
  const int64_t base = (n0 / kTile + t) * kTile;  // global index of entry 0
  const int first = t == 0 ? front : 0;
  const int64_t rest = n + front - t * kTile;
  const int last = (int)(rest < kTile ? rest : kTile);
  const int len = last - first;
  const ChunkKeys k = chunk_keys(keys, z, base / kChunk);  // a tile lies in one chunk
  for (int e = threadIdx.x; e < kTile; e += kSortThreads) {
    unsigned long long kk = ~0ull;
    if (e >= first && e < last) {
      const uint32_t wd = hash_word(k, (uint32_t)((base + e) % kChunk), (uint32_t)s, mult);
      // (bucket, j), the sign below j
      kk = ((unsigned long long)(wd & ~kSign) << (kTileBits + 1)) | ((unsigned)e << 1) |
           (wd >> 31);
    }
    key[e] = kk;
  }
  __syncthreads();
  // bitonic sort, ascending; thread t compares the pairs (i, i + stride)
  for (int size = 2; size <= kTile; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int pr = threadIdx.x; pr < kTile / 2; pr += kSortThreads) {
        const int i = 2 * pr - (pr & (stride - 1)), j = i + stride;
        const unsigned long long x = key[i], y = key[j];
        if ((x > y) == ((i & size) == 0)) {
          key[i] = y;
          key[j] = x;
        }
      }
      __syncthreads();
    }
  const int64_t tb = z * tiles + t;
  uint32_t* so = sorted + tb * kTile;
  int* o = off + tb * (s + 1);
  for (int i = threadIdx.x; i <= len; i += kSortThreads) {
    if (i < len) {
      const unsigned long long kk = key[i];
      so[i] = (uint32_t)((kk >> 1) & (kTile - 1)) | ((uint32_t)(kk & 1) << 31);
    }
    // position i covers the buckets (bucket[i - 1], bucket[i]], and
    // position len those after the last one, up to s
    const int lo = i == 0 ? -1 : (int)(key[i - 1] >> (kTileBits + 1));
    const int hi = i == len ? s : (int)(key[i] >> (kTileBits + 1));
    for (int b = lo + 1; b <= hi; ++b) o[b] = i;
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The lane u whose inclusive prefix (non-decreasing over the lanes) is the
// first above x (31 when none is): a warp-wide binary search by shuffles.
__device__ __forceinline__ int lane_above(int incl, int x) {
  int u = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (__shfl_sync(kFull, incl, u + step - 1) <= x) u += step;
  return u;
}

// Columnwise, pass 2, one warp per (bucket, column strip, lane): the
// bucket's coordinates tile by tile in increasing j, each row of A added
// to the lane's cpl columns c0 + lane + 32 q in registers, then written.
// Block x takes strip x % strips of buckets (x / strips) * 8 .. + 8: the
// strips of one row of A are read by neighbouring blocks at about the
// same time. Entry e of tile t is row t * 1024 + e - front of A.
__global__ void __launch_bounds__(kThreads)
hash_cw_kernel(const float* __restrict__ A, const int* __restrict__ off,
               const uint32_t* __restrict__ sorted, float* __restrict__ out, int64_t m,
               int64_t n, int front, int s, int width, int cpl, int strips, int accumulate) {
  const int64_t z = blockIdx.y;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int b = (int)(blockIdx.x / strips) * kWarps + w;
  if (b >= s) return;  // whole warps
  const int64_t c0 = (int64_t)(blockIdx.x % strips) * width;
  const int64_t cend = c0 + width < m ? c0 + width : m;
  const int64_t tiles = (n + front + kTile - 1) / kTile;
  const float* __restrict__ Az = A + z * n * m;
  const int* __restrict__ oz = off + z * tiles * (s + 1);
  const uint32_t* __restrict__ sz = sorted + z * tiles * kTile;
  float* o = out + (z * s + b) * m;
  float acc[kMaxCpl];
#pragma unroll
  for (int q = 0; q < kMaxCpl; ++q) {
    const int64_t col = c0 + lane + 32 * q;
    acc[q] = accumulate && q < cpl && col < cend ? o[col] : 0.0f;
  }
  for (int64_t t0 = 0; t0 < tiles; t0 += 32) {
    // lane u: the bucket's run [a, a + cnt) of tile t0 + u
    int a = 0, cnt = 0;
    if (t0 + lane < tiles) {
      const int* o = oz + (t0 + lane) * (s + 1);
      a = __ldg(o + b);
      cnt = __ldg(o + b + 1) - a;
    }
    const int incl = warp_inclusive_sum(cnt, lane);
    const int excl = incl - cnt;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int q0 = 0; q0 < total; q0 += 32) {
      // lane i takes the (q0 + i)-th coordinate of the runs, in order
      const int q = q0 + lane;
      const int u = lane_above(incl, q);
      const int slot = __shfl_sync(kFull, a, u) + (q - __shfl_sync(kFull, excl, u));
      uint32_t wd = 0;
      if (q < total) wd = __ldg(sz + (t0 + u) * kTile + slot);
      const int64_t jj = (t0 + u) * kTile + (wd & (kTile - 1)) - front;
      const int batch = total - q0 < 32 ? total - q0 : 32;
      // kCoords rows of A in flight, added in order
      for (int e0 = 0; e0 < batch; e0 += kCoords) {
        float x[kCoords][kMaxCpl];
        uint32_t sg[kCoords];
#pragma unroll
        for (int e = 0; e < kCoords; ++e) {
          const int64_t j = __shfl_sync(kFull, jj, (e0 + e) & 31);
          sg[e] = __shfl_sync(kFull, wd, (e0 + e) & 31);
          const float* __restrict__ rowp = Az + j * m;
#pragma unroll
          for (int c = 0; c < kMaxCpl; ++c) {
            const int64_t col = c0 + lane + 32 * c;
            x[e][c] = e0 + e < batch && c < cpl && col < cend ? __ldg(rowp + col) : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < kCoords; ++e) {
          if (e0 + e >= batch) break;  // warp-uniform
#pragma unroll
          for (int c = 0; c < kMaxCpl; ++c) acc[c] = __fadd_rn(acc[c], signed_value(x[e][c], sg[e]));
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCpl; ++c) {
    const int64_t col = c0 + lane + 32 * c;
    if (c < cpl && col < cend) o[col] = acc[c];
  }
}

}  // namespace

// CountSketch of a stacked cohort: keys (B, 2) words; A (B, m, n) rowwise
// or (B, n, m) columnwise, contiguous, its n contracted coordinates the
// global [n0, n0 + n) of every lane's streams; out (B, m, s) or (B, s, m),
// every cell written. mult: randint's multiplier for the span s.
// accumulate (columnwise only): out holds the carried sums on entry and
// each cell adds the batch's terms to its own value. Scratch,
// allocated by the caller: rowwise, s0 = the words (B * n * 2 ints);
// columnwise, s0 = off (B * T * (s + 1) ints) and s1 = the sorted words
// (B * T * 1024 ints), T = ceil((n0 % 1024 + n) / 1024).
extern "C" int sk_hash_apply(const float* A, const uint32_t* keys, float* out, int* s0, int* s1,
                             int64_t B, int64_t m, int64_t n, int64_t n0, int64_t s,
                             uint32_t mult, int rowwise, int accumulate,
                             cudaStream_t stream) {
  if (B < 1 || B > 65535 || m <= 0 || n <= 0 || s <= 0 || s >= 0x7FFFFFFF || n0 < 0 ||
      n0 + n >= 0x7FFFFFFF || (rowwise && accumulate))
    return (int)cudaErrorInvalidValue;
  const uint32_t span = (uint32_t)s;
  if (rowwise) {
    const int64_t rows = (m + kWarps - 1) / kWarps;
    if (rows > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    uint2* words = reinterpret_cast<uint2*>(s0);
    hash_table_kernel<<<dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)B), kThreads,
                        0, stream>>>(keys, n, n0, span, mult, words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int buf_w = (int)(((s < kRowBuf ? s : kRowBuf) + 3) / 4 * 4);
    hash_rw_kernel<<<dim3((unsigned)rows, (unsigned)B), kThreads,
                     (size_t)kWarps * buf_w * sizeof(float), stream>>>(A, words, out, m, n,
                                                                      (int)s, buf_w);
    return (int)cudaGetLastError();
  }
  const int front = (int)(n0 % kTile);
  const int64_t tiles = (front + n + kTile - 1) / kTile;
  // column strips of at most 32 * kMaxCpl columns, as even as m allows
  const int64_t strips = (m + 32 * kMaxCpl - 1) / (32 * kMaxCpl);
  const int64_t width = (m + strips - 1) / strips;
  const int cpl = (int)((width + 31) / 32);
  const int64_t blocks = (s + kWarps - 1) / kWarps * strips;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  uint32_t* sorted = reinterpret_cast<uint32_t*>(s1);
  hash_sort_kernel<<<dim3((unsigned)tiles, (unsigned)B), kSortThreads, 0, stream>>>(
      keys, n, n0, (int)s, mult, s0, sorted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hash_cw_kernel<<<dim3((unsigned)blocks, (unsigned)B), kThreads, 0, stream>>>(
      A, s0, sorted, out, m, n, front, (int)s, (int)width, cpl, (int)strips, accumulate);
  return (int)cudaGetLastError();
}
