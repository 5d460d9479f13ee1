// CountSketch (CWT) of CSR lanes for Hopper (sm_90a), exact mode.
//
// Replaces the TPU kernel of libskylark_tpu/sketch/pallas_sparse.py
// (_sparse_call -> _kernel_sparse, accum="exact"): for each lane b of a
// stacked cohort of CSR operands, given as per-nonzero (data, row, col)
// lanes of nnz_pad entries in CSR row-major order,
//   rowwise     out[b][r, h[c]] += v[c] * val      (m = rows) -> (m, s)
//   columnwise  out[b][h[r], c] += v[r] * val      (m = cols) -> (s, m)
// h is UniformInt(0, s-1) of sub-stream 0 and v Rademacher of sub-stream 1
// of the lane's key, in base/randgen.py's counter-stream layout. They are
// derived here at each nonzero's hashed coordinate only (the column
// rowwise, the row columnwise): the chunk key of coordinate j's chunk
// j / 4096 and randint's split pair, as csrc/hash_sketch.cu derives them,
// so the cipher work is O(nnz), not O(n).
//
// Contract: bit-equal to the plain scatter (sketch/sparse_serve.py
// cwt_sparse_serve_apply on the CPU), which adds each output cell's terms
// in CSR row-major order. Every v * val is exact (v = +-1), so only the
// order of the adds matters, and the kernel keeps it:
// - rowwise: output row r takes row r's nonzeros only, a contiguous range
//   of the lane (rows are non-decreasing in CSR order; the range is found
//   by binary search). One warp per (lane, row): the 32 lanes hash 32
//   nonzeros at once, then add them in order, the nonzeros that share a
//   bucket one after another in position order (__match_any_sync ranks
//   them), into the zeroed output row. The warp reads the range's values
//   1024 at a time and hashes only the 32-entry batches that hold a
//   nonzero value; a first pass finds each lane's last nonzero value, and
//   every range is cut there.
// - columnwise: cell (h[r], c) takes column c's terms in row order, spread
//   over the whole lane. A stable counting sort by column makes that order
//   a contiguous run: per tile of 1024 nonzeros each nonzero's rank among
//   the tile's earlier nonzeros of its column (an O(tile^2) count in shared
//   memory, as hash_sketch.cu sorts), the per-(column, tile) counts scanned
//   in column-major order, then each nonzero placed at its column's offset
//   plus its rank. One thread per (lane, column) then walks its run and
//   adds in order.
// No float atomics anywhere.
//
// Zero values. An entry whose value is 0.0 adds +-0.0 to its cell. Every
// cell starts at +0.0, and under round-to-nearest a sum is -0.0 only when
// both addends are, so a cell is never -0.0 and adding +-0.0 never changes
// its bits. The kernel therefore passes over such entries by their value
// (never by their position): the lane padding (value 0.0 at column 0, the
// row clamped to the last row: up to half of a lane, all in one row or
// one column) and explicit zeros cost no hashing and no sorting, and the
// result stays bit-equal to the plain scatter, which adds them, at every
// capacity.
//
// Bound on this card: bytes (the lanes read once, the output written
// once); a few Threefry calls per nonzero are far below the integer rate.
// The TPU kernel's "mxu" (one-hot) fast mode becomes shared-memory atomic
// accumulation in a later design; only the exact mode is here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kChunk = 4096;   // randgen.CHUNK: stream chunk length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;    // nonzeros per sort tile, columnwise
constexpr int kPer = kTile / kThreads;
constexpr int kScan = 1024;    // threads of the scan block

// The lane's sub-stream keys: bucket stream fold_in(key, 0), value stream
// fold_in(key, 1).
struct LaneKeys {
  uint32_t h0, h1, v0, v1;
};

__device__ __forceinline__ LaneKeys lane_keys(const uint32_t* __restrict__ keys, int64_t b) {
  LaneKeys k;
  k.h0 = k.v0 = keys[2 * b];
  k.h1 = k.v1 = keys[2 * b + 1];
  sk::fold_in(k.h0, k.h1, 0u);
  sk::fold_in(k.v0, k.v1, 1u);
  return k;
}

// Bucket h[j] and sign v[j] of coordinate j: randint's double draw in
// uint32 arithmetic (mult = 0 for spans that are powers of two or above
// 2^16) and the Rademacher word.
__device__ __forceinline__ void hash_coord(const LaneKeys& k, int64_t j, uint32_t span,
                                           uint32_t mult, int& h, float& v) {
  const int64_t c = j / kChunk;
  const uint32_t p = (uint32_t)(j % kChunk);
  uint32_t hk0 = k.h0, hk1 = k.h1;
  sk::chunk_key(hk0, hk1, c);
  uint32_t lk0 = hk0, lk1 = hk1;
  sk::fold_in(hk0, hk1, 0u);
  sk::fold_in(lk0, lk1, 1u);
  uint32_t r = sk::stream_bits(lk0, lk1, p) % span;
  if (mult) {
    const uint32_t hi = sk::stream_bits(hk0, hk1, p) % span;
    r = (hi * mult + r) % span;
  }
  h = (int)r;
  uint32_t vk0 = k.v0, vk1 = k.v1;
  sk::chunk_key(vk0, vk1, c);
  v = sk::rademacher(sk::stream_bits(vk0, vk1, p));
}

// First position in a[0:n) (non-decreasing) whose value is >= x.
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ a, int64_t n, int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Rowwise, pass 1, one block per (tile, lane): end[b] = 1 + the last
// position of lane b holding a nonzero value (end[b] starts at 0). An
// integer max: the order of the atomics changes nothing.
__global__ void __launch_bounds__(kThreads)
sparse_lane_end(const float* __restrict__ data, int64_t nnz, int* __restrict__ end) {
  __shared__ int top;
  const int64_t b = blockIdx.y;
  if (threadIdx.x == 0) top = 0;
  __syncthreads();
  int mine = 0;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int64_t j = (int64_t)blockIdx.x * kTile + e;
    if (j < nnz && data[b * nnz + j] != 0.0f) mine = (int)j + 1;
  }
  if (mine) atomicMax(&top, mine);
  __syncthreads();
  if (threadIdx.x == 0 && top) atomicMax(end + b, top);
}

// Rowwise, pass 2: one warp per (lane, row).
__global__ void __launch_bounds__(kThreads)
sparse_rw_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ data,
                 const int* __restrict__ rows, const int* __restrict__ cols,
                 const int* __restrict__ end, float* __restrict__ out, int64_t nnz, int64_t m,
                 int s, uint32_t mult) {
  const int64_t b = blockIdx.y;
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= m) return;  // whole warps
  const LaneKeys k = lane_keys(keys, b);
  const int* rw = rows + b * nnz;
  const int* cl = cols + b * nnz;
  const float* dt = data + b * nnz;
  // the row's range, cut at the lane's last nonzero value
  const int64_t stop = end[b];
  const int64_t hi = lower_bound(rw, stop, r + 1);
  const int64_t lo = lower_bound(rw, hi, r);
  float* o = out + (b * m + r) * s;
  for (int64_t sb = lo; sb < hi; sb += 32 * 32) {
    // bit u of mine: entry sb + 32u + lane lies in the row and is nonzero
    unsigned mine = 0;
#pragma unroll 8
    for (int u = 0; u < 32; ++u) {
      const int64_t j = sb + 32 * u + lane;
      if (j < hi && dt[j] != 0.0f) mine |= 1u << u;
    }
    for (unsigned todo = __reduce_or_sync(0xFFFFFFFFu, mine); todo; todo &= todo - 1) {
      const int u = __ffs(todo) - 1;
      const int64_t j = sb + 32 * u + lane;
      const bool valid = (mine >> u) & 1u;
      int h = -1;
      float x = 0.0f;
      if (valid) {
        float v;
        hash_coord(k, cl[j], (uint32_t)s, mult, h, v);
        x = __fmul_rn(v, dt[j]);
      }
      // nonzeros sharing a bucket add in position order
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, h);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int top = valid ? rank : 0;
      for (int off = 16; off; off >>= 1) top = max(top, __shfl_xor_sync(0xFFFFFFFFu, top, off));
      for (int q = 0; q <= top; ++q) {
        if (valid && rank == q) o[h] = __fadd_rn(o[h], x);
        __syncwarp();
      }
    }
  }
}

// Columnwise, pass 1, one block per (tile, lane): each nonzero-valued
// entry's rank among the tile's earlier ones of its column; the last one of
// each column writes the column's count in the tile to hist[c * T + t].
__global__ void __launch_bounds__(kThreads)
sparse_cw_rank(const float* __restrict__ data, const int* __restrict__ cols, int64_t nnz,
               int64_t m, int* __restrict__ lrank, int* __restrict__ hist) {
  __shared__ int cs[kTile];
  const int64_t b = blockIdx.y;
  const int64_t t = blockIdx.x, T = gridDim.x;
  const int64_t base = t * kTile;
  const int len = (int)(nnz - base < kTile ? nnz - base : kTile);
  const int* cl = cols + b * nnz + base;
  const float* dt = data + b * nnz + base;
  for (int e = threadIdx.x; e < kTile; e += kThreads)
    cs[e] = e < len && dt[e] != 0.0f ? cl[e] : -1;
  __syncthreads();
  int* hb = hist + b * (m * T + 1);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x * kPer + q;
    if (e >= len || cs[e] < 0) continue;
    const int c = cs[e];
    int rank = 0, tot = 0;
    for (int i = 0; i < len; ++i) {
      const int same = cs[i] == c;
      tot += same;
      rank += same & (i < e);
    }
    lrank[b * nnz + base + e] = rank;
    if (rank == tot - 1) hb[(int64_t)c * T + t] = tot;
  }
}

// Columnwise, pass 2, one block per lane: exclusive scan of the lane's
// (column, tile) counts in place; hist[L] receives the total.
__global__ void __launch_bounds__(kScan) sparse_cw_scan(int* __restrict__ hist, int64_t L) {
  __shared__ int buf[kScan];
  int* h = hist + (int64_t)blockIdx.x * (L + 1);
  int carry = 0;
  for (int64_t base = 0; base < L; base += kScan) {
    const int64_t i = base + threadIdx.x;
    const int x = i < L ? h[i] : 0;
    buf[threadIdx.x] = x;
    __syncthreads();
    for (int off = 1; off < kScan; off <<= 1) {
      const int y = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
      __syncthreads();
      buf[threadIdx.x] += y;
      __syncthreads();
    }
    if (i < L) h[i] = carry + buf[threadIdx.x] - x;
    carry += buf[kScan - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) h[L] = carry;
}

// Columnwise, pass 3: each nonzero's position in the column-sorted order.
__global__ void __launch_bounds__(kThreads)
sparse_cw_place(const float* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ lrank, const int* __restrict__ hist, int64_t nnz,
                int64_t m, int* __restrict__ perm) {
  const int64_t b = blockIdx.y;
  const int64_t t = blockIdx.x, T = gridDim.x;
  const int* hb = hist + b * (m * T + 1);
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int64_t j = t * kTile + e;
    if (j >= nnz) break;
    if (data[b * nnz + j] == 0.0f) continue;
    const int c = cols[b * nnz + j];
    perm[b * nnz + hb[(int64_t)c * T + t] + lrank[b * nnz + j]] = (int)j;
  }
}

// Columnwise, pass 4, one thread per (column, lane): column c's nonzero-
// valued entries in row order, each added to its bucket's cell of the
// zeroed output.
__global__ void __launch_bounds__(kThreads)
sparse_cw_accum(const uint32_t* __restrict__ keys, const float* __restrict__ data,
                const int* __restrict__ rows, const int* __restrict__ perm,
                const int* __restrict__ hist, float* __restrict__ out, int64_t nnz, int64_t m,
                int64_t T, int s, uint32_t mult) {
  const int64_t b = blockIdx.y;
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= m) return;
  const LaneKeys k = lane_keys(keys, b);
  const int* hb = hist + b * (m * T + 1);
  const int* pm = perm + b * nnz;
  const int* rw = rows + b * nnz;
  const float* dt = data + b * nnz;
  float* o = out + b * (int64_t)s * m + c;
  const int end = hb[(c + 1) * T];
  for (int q = hb[c * T]; q < end; ++q) {
    const int j = pm[q];
    int h;
    float v;
    hash_coord(k, rw[j], (uint32_t)s, mult, h, v);
    o[(int64_t)h * m] = __fadd_rn(o[(int64_t)h * m], __fmul_rn(v, dt[j]));
  }
}

bool bad_shape(int64_t B, int64_t nnz, int64_t m, int64_t s) {
  return B < 1 || B > 65535 || nnz < 1 || nnz >= 0x7FFFFFFF || m < 1 || s < 1 ||
         s >= 0x7FFFFFFF;
}

}  // namespace

// Rowwise: out (B, m, s) must hold zeros; m = the lanes' (padded) row
// count. Scratch, allocated by the caller: end (B ints, zeroed).
extern "C" int sk_sparse_rowwise(const uint32_t* keys, const float* data, const int* rows,
                                 const int* cols, float* out, int* end, int64_t B, int64_t nnz,
                                 int64_t m, int64_t s, uint32_t mult, cudaStream_t stream) {
  if (bad_shape(B, nnz, m, s) || (m + kWarps - 1) / kWarps > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  sparse_lane_end<<<dim3((unsigned)((nnz + kTile - 1) / kTile), (unsigned)B), kThreads, 0,
                    stream>>>(data, nnz, end);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + kWarps - 1) / kWarps), (unsigned)B);
  sparse_rw_kernel<<<grid, kThreads, 0, stream>>>(keys, data, rows, cols, end, out, nnz, m,
                                                  (int)s, mult);
  return (int)cudaGetLastError();
}

// Columnwise: out (B, s, m) must hold zeros; m = the lanes' (padded) column
// count. Scratch, allocated by the caller: lrank and perm (B * nnz ints),
// hist (B * (m * T + 1) ints, zeroed), T = ceil(nnz / 1024).
extern "C" int sk_sparse_columnwise(const uint32_t* keys, const float* data, const int* rows,
                                    const int* cols, float* out, int* lrank, int* hist,
                                    int* perm, int64_t B, int64_t nnz, int64_t m, int64_t s,
                                    uint32_t mult, cudaStream_t stream) {
  const int64_t T = (nnz + kTile - 1) / kTile;
  if (bad_shape(B, nnz, m, s) || T > 0x7FFFFFFF || m * T >= 0x7FFFFFFF ||
      (m + kThreads - 1) / kThreads > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const dim3 tiles((unsigned)T, (unsigned)B);
  sparse_cw_rank<<<tiles, kThreads, 0, stream>>>(data, cols, nnz, m, lrank, hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparse_cw_scan<<<(unsigned)B, kScan, 0, stream>>>(hist, m * T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparse_cw_place<<<tiles, kThreads, 0, stream>>>(data, cols, lrank, hist, nnz, m, perm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)B);
  sparse_cw_accum<<<grid, kThreads, 0, stream>>>(keys, data, rows, perm, hist, out, nnz, m, T,
                                                 (int)s, mult);
  return (int)cudaGetLastError();
}
