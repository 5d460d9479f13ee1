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
// derived here at the hashed coordinates that hold nonzeros only (each
// nonzero's column rowwise, each row run columnwise), so the cipher work
// is O(nnz), not O(n). Columnwise derives coordinate j's chunk key (chunk
// j / 4096) and randint's split pair per row, as csrc/hash_sketch.cu
// does; rowwise derives them once per (lane, chunk) into a table (2-3
// stream words a nonzero instead of 8-9 cipher calls).
//
// Contract: bit-equal to the plain scatter (sketch/sparse_serve.py
// cwt_sparse_serve_apply on the CPU), which adds each output cell's terms
// in CSR row-major order. Every v * val is exact (v = +-1), so only the
// order of the adds matters, and the kernel keeps it:
// - rowwise: output row r takes row r's nonzeros only, a contiguous range
//   of the lane (rows are non-decreasing in CSR order). A first pass finds
//   each lane's last nonzero value (every range is cut there) and writes
//   the lane's chunk table. One block per 8 rows finds the rows' ranges by
//   two 32-ary warp searches and one scan; one warp per (lane, row) hashes
//   32 nonzeros at once, then adds them in order, the nonzeros that share
//   a bucket one after another in position order (__match_any_sync ranks
//   them), into an on-chip copy of the output row (kRowBuf columns, a
//   wider row walked in column tiles), and writes the row whole with
//   16-byte stores: the output needs no zero-fill.
// - columnwise: cell (h[r], c) takes the terms of the rows r hashed to
//   bucket h, in increasing r. In a CSR lane a row is one contiguous run of
//   positions, so each row is hashed once (O(rows) cipher calls, not one
//   per nonzero) and the runs are ordered by (bucket, row): per tile of
//   2048 rows a bitonic sort in shared memory of the distinct keys
//   h * 2048 + (r - tile start), so each tile holds its rows of bucket h
//   as one segment in increasing r, found by binary search. One warp per
//   (lane, bucket) then walks the tiles in order, gathers the bucket's
//   runs 32 at a time, and adds their nonzeros 32 at a time into an
//   on-chip copy of output row h (kRowBuf floats; a wider row is walked in
//   column tiles): positions in a batch keep their order, and those that
//   share a column (duplicate CSR entries) add in position order, ranked
//   by __match_any_sync. The warp writes the whole row once, zeros
//   included, so the output needs no zero-fill; the scratch is O(rows) per
//   lane.
// No float atomics anywhere.
//
// Zero values. An entry whose value is 0.0 adds +-0.0 to its cell. Every
// cell starts at +0.0, and under round-to-nearest a sum is -0.0 only when
// both addends are, so a cell is never -0.0 and adding +-0.0 never changes
// its bits. The kernel therefore passes over such entries by their value
// (never by their position): the lane padding (value 0.0 at column 0, the
// row clamped to the last row: up to half of a lane, all in one row or
// one column) and explicit zeros are never added, the padding past each
// lane's last nonzero value is cut from every range, and the result stays
// bit-equal to the plain scatter, which adds them, at every capacity.
//
// Bound on this card: bytes (the lanes read once, the output written
// once). Rowwise, deriving each nonzero's keys (8-9 Threefry calls) and
// adding into a zero-filled output in device memory would cost more than
// the bytes; the chunk table and the on-chip row avoid both.
// The TPU kernel's "mxu" (one-hot) fast mode becomes shared-memory atomic
// accumulation in a later design; only the exact mode is here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kChunk = 4096;   // randgen.CHUNK: stream chunk length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;    // positions per block of sparse_lane_end
constexpr int kRunBits = 11;
constexpr int kRunTile = 1 << kRunBits;  // rows per sort tile, columnwise
constexpr int kSortThreads = 1024;
constexpr int kAccWarps = 8;   // buckets per accumulation block
constexpr int kRowBuf = 1024;  // output columns a warp holds on chip
constexpr int kRwBatch = 4;    // 32-position batches a rowwise warp loads at once
constexpr int kPrepTile = 4096;  // positions per block of sparse_rw_prep
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// lower_bound by one warp, 32 probes a step (four dependent loads over
// 2^16 positions where the binary search takes 16); every lane returns it.
__device__ __forceinline__ int64_t warp_lower_bound(const int* __restrict__ a, int64_t n,
                                                    int64_t x, int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, p < hi && a[p] < x));
    if (c == 0) return lo;
    const int64_t top = lo + c * step;
    lo += (c - 1) * step + 1;
    if (top < hi) hi = top;
  }
  return lo + __popc(__ballot_sync(kFull, lo + lane < hi && a[lo + lane] < x));
}

// Pass 1 of both orientations, one block per (tile, lane): end[b] = 1 + the last
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

// Rowwise, pass 1, one block per (4096-position tile, lane): end[b] as
// sparse_lane_end computes it, and lane b's chunk table, one thread per chunk c of the
// hashed columns: randint's low-draw key fold_in(chunk_key(hk, c), 1) and
// high-draw key fold_in(chunk_key(hk, c), 0), and the value stream's
// chunk_key(vk, c) (hk, vk the lane's bucket and value stream keys), eight
// words a chunk (two unused). A nonzero then costs two or three stream
// words instead of eight or nine cipher calls.
__global__ void __launch_bounds__(kThreads)
sparse_rw_prep(const uint32_t* __restrict__ keys, const float* __restrict__ data, int64_t nnz,
               int64_t n_chunks, int* __restrict__ end, uint4* __restrict__ table) {
  __shared__ int top;
  const int64_t b = blockIdx.y;
  if (threadIdx.x == 0) top = 0;
  __syncthreads();
  int mine = 0;
  const float* dt = data + b * nnz;
  if ((nnz & 3) == 0) {  // 16-byte loads: the lane starts 16-byte aligned
    for (int e = 4 * threadIdx.x; e < kPrepTile; e += 4 * kThreads) {
      const int64_t j = (int64_t)blockIdx.x * kPrepTile + e;
      if (j >= nnz) break;
      const float4 q = *reinterpret_cast<const float4*>(dt + j);
      if (q.w != 0.0f) mine = (int)j + 4;
      else if (q.z != 0.0f) mine = (int)j + 3;
      else if (q.y != 0.0f) mine = (int)j + 2;
      else if (q.x != 0.0f) mine = (int)j + 1;
    }
  } else {
    for (int e = threadIdx.x; e < kPrepTile; e += kThreads) {
      const int64_t j = (int64_t)blockIdx.x * kPrepTile + e;
      if (j < nnz && dt[j] != 0.0f) mine = (int)j + 1;
    }
  }
  if (mine) atomicMax(&top, mine);
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c < n_chunks) {
    const LaneKeys k = lane_keys(keys, b);
    uint32_t hk0 = k.h0, hk1 = k.h1;
    sk::chunk_key(hk0, hk1, c);
    uint32_t lk0 = hk0, lk1 = hk1;
    sk::fold_in(hk0, hk1, 0u);
    sk::fold_in(lk0, lk1, 1u);
    uint32_t vk0 = k.v0, vk1 = k.v1;
    sk::chunk_key(vk0, vk1, c);
    table[(b * n_chunks + c) * 2] = make_uint4(lk0, lk1, hk0, hk1);
    table[(b * n_chunks + c) * 2 + 1] = make_uint4(vk0, vk1, 0u, 0u);
  }
  __syncthreads();
  if (threadIdx.x == 0 && top) atomicMax(end + b, top);
}

// Rowwise, pass 2, one block per (kWarps rows, lane), one warp per row.
// The block's rows' first positions come from two 32-ary warp searches and
// one coalesced scan of the positions between them. Each warp adds its
// row's nonzeros, 32 at a time in position order (those that share a
// bucket one after another, ranked by __match_any_sync), into an on-chip
// copy of its output row (kRowBuf columns; a wider row is walked in column
// tiles, the row's nonzeros hashed again for each), then writes the row
// whole, zeros included: the output needs no zero-fill.
__global__ void __launch_bounds__(kThreads)
sparse_rw_kernel(const uint4* __restrict__ table, const float* __restrict__ data,
                 const int* __restrict__ rows, const int* __restrict__ cols,
                 const int* __restrict__ end, float* __restrict__ out, int64_t nnz, int64_t m,
                 int s, uint32_t mult, int64_t n_chunks) {
  __shared__ __align__(16) float buf[kWarps][kRowBuf];
  __shared__ int64_t start[kWarps + 1];
  const int64_t b = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * kWarps;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int* rw = rows + b * nnz;
  const int* cl = cols + b * nnz;
  const float* dt = data + b * nnz;
  const uint4* tb = table + b * n_chunks * 2;
  // positions [p0, p1) of rows r0 .. r0 + kWarps, cut at the lane's last
  // nonzero value
  const int64_t stop = end[b];
  if (w < 2) {
    const int64_t p = warp_lower_bound(rw, stop, r0 + w * kWarps, lane);
    if (lane == 0) start[w * kWarps] = p;
  }
  __syncthreads();
  const int64_t p0 = start[0], p1 = start[kWarps];
  __syncthreads();
  for (int i = threadIdx.x; i < kWarps; i += kThreads) start[i] = p1;
  __syncthreads();
  // a row's first position is where the row id rises to it; a row with no
  // position starts where the next one does
  for (int64_t j = p0 + threadIdx.x; j < p1; j += kThreads) {
    const int r = rw[j];
    if (j == p0 || rw[j - 1] != r) start[r - r0] = j;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = kWarps - 1; i >= 0; --i)
      if (start[i + 1] < start[i]) start[i] = start[i + 1];
  __syncthreads();
  const int64_t r = r0 + w;
  if (r >= m) return;  // whole warps; no barrier follows
  const int64_t lo = start[w], hi = start[w + 1];
  const uint32_t span = (uint32_t)s;
  float* o = out + (b * m + r) * s;
  float* row = buf[w];
  for (int c0 = 0; c0 < s; c0 += kRowBuf) {
    const int cw = s - c0 < kRowBuf ? s - c0 : kRowBuf;
    for (int i = lane; i < cw; i += 32) row[i] = 0.0f;
    __syncwarp();
    for (int64_t j0 = lo; j0 < hi; j0 += 32 * kRwBatch) {
      // kRwBatch batches of 32 positions: loads and hashes side by side,
      // then the adds batch by batch in position order
      float dv[kRwBatch];
      int cc[kRwBatch];
#pragma unroll
      for (int u = 0; u < kRwBatch; ++u) {
        const int64_t j = j0 + 32 * u + lane;
        dv[u] = j < hi ? dt[j] : 0.0f;
        cc[u] = j < hi ? cl[j] : 0;
      }
      int h[kRwBatch];
      float x[kRwBatch];
#pragma unroll
      for (int u = 0; u < kRwBatch; ++u) {
        h[u] = -1;
        x[u] = 0.0f;
        if (dv[u] != 0.0f) {
          const int c = cc[u];
          const uint4 k0 = __ldg(tb + 2 * (c / kChunk));
          const uint4 k1 = __ldg(tb + 2 * (c / kChunk) + 1);
          const uint32_t p = (uint32_t)(c % kChunk);
          uint32_t hh = sk::stream_bits(k0.x, k0.y, p) % span;
          if (mult) hh = ((sk::stream_bits(k0.z, k0.w, p) % span) * mult + hh) % span;
          h[u] = (int)hh - c0;
          if (h[u] < 0 || h[u] >= cw) h[u] = -1;
          x[u] = __fmul_rn(sk::rademacher(sk::stream_bits(k1.x, k1.y, p)), dv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRwBatch; ++u) {
        if (j0 + 32 * u >= hi) break;  // warp-uniform
        // nonzeros sharing a bucket add in position order
        const bool valid = h[u] >= 0;
        const unsigned peers = __match_any_sync(kFull, h[u]);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        int top = valid ? rank : 0;
        for (int off = 16; off; off >>= 1) top = max(top, __shfl_xor_sync(kFull, top, off));
        for (int q = 0; q <= top; ++q) {
          if (valid && rank == q) row[h[u]] = __fadd_rn(row[h[u]], x[u]);
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

// Columnwise, pass 2, one block per (row tile, lane): the runs of the
// tile's rows, cut at the lane's last nonzero value, from one coalesced
// pass over the tile's positions; each non-empty row hashed once; the
// tile's rows sorted by (bucket, row) in shared memory. Slot i of the tile
// receives the bucket of the i-th row in that order (INT_MAX past the
// tile's non-empty rows) and its run: first position, end, and sign bits.
__global__ void __launch_bounds__(kSortThreads)
sparse_cw_sort(const uint32_t* __restrict__ keys, const int* __restrict__ rows,
               const int* __restrict__ end, int64_t nnz, int s, uint32_t mult,
               int* __restrict__ bucket, int4* __restrict__ runs) {
  __shared__ unsigned long long key[kRunTile];
  __shared__ int slo[kRunTile], shi[kRunTile];
  __shared__ float sv[kRunTile];
  __shared__ int64_t span[2];
  const int64_t b = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * kRunTile;
  const int* rw = rows + b * nnz;
  const int64_t stop = end[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // the tile's positions [span[0], span[1]): warps 0 and 1 search at once
  if (warp < 2) {
    const int64_t p = warp_lower_bound(rw, stop, r0 + warp * kRunTile, lane);
    if (lane == 0) span[warp] = p;
  }
  for (int i = threadIdx.x; i < kRunTile; i += kSortThreads) slo[i] = shi[i] = 0;
  __syncthreads();
  const int64_t p0 = span[0], p1 = span[1];
  for (int64_t j = p0 + threadIdx.x; j < p1; j += kSortThreads) {
    const int r = rw[j];
    if (j == p0 || rw[j - 1] != r) slo[r - r0] = (int)j;
    if (j == p1 - 1 || rw[j + 1] != r) shi[r - r0] = (int)(j + 1);
  }
  __syncthreads();
  const LaneKeys k = lane_keys(keys, b);
  for (int i = threadIdx.x; i < kRunTile; i += kSortThreads) {
    unsigned long long kk = ~0ull;
    if (shi[i] > slo[i]) {
      int h;
      float v;
      hash_coord(k, r0 + i, (uint32_t)s, mult, h, v);
      kk = ((unsigned long long)h << kRunBits) | (unsigned)i;
      sv[i] = v;
    }
    key[i] = kk;
  }
  __syncthreads();
  // bitonic sort, ascending; the keys are distinct, so the order is r's
  // within each bucket; thread t compares the pair (i, i + stride)
  static_assert(2 * kSortThreads == kRunTile, "one pair a thread");
  for (int size = 2; size <= kRunTile; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int t = threadIdx.x;
      const int i = 2 * t - (t & (stride - 1)), j = i + stride;
      const unsigned long long x = key[i], y = key[j];
      if ((x > y) == ((i & size) == 0)) {
        key[i] = y;
        key[j] = x;
      }
      __syncthreads();
    }
  const int64_t base = ((int64_t)b * gridDim.x + blockIdx.x) * kRunTile;
  for (int i = threadIdx.x; i < kRunTile; i += kSortThreads) {
    const unsigned long long kk = key[i];
    if (kk == ~0ull) {
      bucket[base + i] = 0x7FFFFFFF;
      continue;
    }
    const int li = (int)(kk & (kRunTile - 1));
    bucket[base + i] = (int)(kk >> kRunBits);
    runs[base + i] = make_int4(slo[li], shi[li], __float_as_int(sv[li]), 0);
  }
}

// The lane u of a warp whose inclusive prefix (non-decreasing over the
// lanes) is the first above x, for x below lane 31's: a warp-wide binary
// search by shuffles (every lane takes part).
__device__ __forceinline__ int lane_above(int incl, int x) {
  int u = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (__shfl_sync(kFull, incl, u + step - 1) <= x) u += step;
  return u;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Columnwise, pass 3, one warp per (lane, bucket h): the runs of the rows
// hashed to h, tile by tile in increasing r, each nonzero-valued entry
// added to its column's cell of output row h on chip, then the row
// written whole.
__global__ void __launch_bounds__(kAccWarps * 32)
sparse_cw_accum(const float* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ bucket, const int4* __restrict__ runs,
                float* __restrict__ out, int64_t nnz, int64_t n_rows, int64_t m, int s) {
  __shared__ float buf[kAccWarps][kRowBuf];
  const int64_t b = blockIdx.y;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t h = (int64_t)blockIdx.x * kAccWarps + w;
  if (h >= s) return;  // whole warps
  const int64_t T = (n_rows + kRunTile - 1) / kRunTile;
  const int* bk = bucket + b * T * kRunTile;
  const int4* rn = runs + b * T * kRunTile;
  const float* dt = data + b * nnz;
  const int* cl = cols + b * nnz;
  float* o = out + (b * s + h) * m;
  float* row = buf[w];
  for (int64_t c0 = 0; c0 < m; c0 += kRowBuf) {
    const int cw = (int)(m - c0 < kRowBuf ? m - c0 : kRowBuf);
    for (int i = lane; i < cw; i += 32) row[i] = 0.0f;
    __syncwarp();
    for (int64_t t0 = 0; t0 < T; t0 += 32) {
      // lane u: the bucket's segment [a, a + cnt) of tile t0 + u
      int a = 0, cnt = 0;
      if (t0 + lane < T) {
        const int64_t t = t0 + lane;
        const int64_t len = n_rows - t * kRunTile < kRunTile ? n_rows - t * kRunTile : kRunTile;
        const int* tk = bk + t * kRunTile;
        a = (int)lower_bound(tk, len, h);
        while (a + cnt < len && tk[a + cnt] == h) ++cnt;  // a bucket's rows of a tile: few
      }
      const int incl = warp_inclusive_sum(cnt, lane);
      const int excl = incl - cnt;
      const int total = __shfl_sync(kFull, incl, 31);
      // the segments' runs, 32 at a time in order: lane u takes run q0 + u
      for (int q0 = 0; q0 < total; q0 += 32) {
        const int q = q0 + lane;
        const int u = lane_above(incl, q);
        const int slot = __shfl_sync(kFull, a, u) + (q - __shfl_sync(kFull, excl, u));
        int lo = 0, len = 0;
        float v = 0.0f;
        if (q < total) {
          const int4 r = rn[(t0 + u) * kRunTile + slot];
          lo = r.x;
          len = r.y - r.x;
          v = __int_as_float(r.z);
        }
        const int pin = warp_inclusive_sum(len, lane);
        const int pex = pin - len;
        const int ptotal = __shfl_sync(kFull, pin, 31);
        // the runs' positions, 32 at a time in order
        for (int p0 = 0; p0 < ptotal; p0 += 32) {
          const int p = p0 + lane;
          const int e = lane_above(pin, p);
          const int j = __shfl_sync(kFull, lo, e) + (p - __shfl_sync(kFull, pex, e));
          const float sign = __shfl_sync(kFull, v, e);
          bool valid = false;
          int c = -1;
          float x = 0.0f;
          if (p < ptotal) {
            const float d = dt[j];
            c = (int)(cl[j] - c0);
            valid = d != 0.0f && c >= 0 && c < cw;
            x = __fmul_rn(sign, d);
          }
          // entries sharing a column add in position order
          const unsigned peers = __match_any_sync(kFull, valid ? c : -1);
          const int rank = __popc(peers & ((1u << lane) - 1u));
          int top = valid ? rank : 0;
          for (int off = 16; off; off >>= 1) top = max(top, __shfl_xor_sync(kFull, top, off));
          for (int r = 0; r <= top; ++r) {
            if (valid && rank == r) row[c] = __fadd_rn(row[c], x);
            __syncwarp();
          }
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < cw; i += 32) o[c0 + i] = row[i];
    __syncwarp();
  }
}

bool bad_shape(int64_t B, int64_t nnz, int64_t m, int64_t s) {
  return B < 1 || B > 65535 || nnz < 1 || nnz >= 0x7FFFFFFF || m < 1 || s < 1 ||
         s >= 0x7FFFFFFF;
}

}  // namespace

// Rowwise: out (B, m, s), every cell written; m = the lanes' (padded)
// row count, n their (padded) column count. Scratch, allocated by the
// caller in one int tensor: end (B ints, zeroed), then at a 16-byte
// boundary the chunk table (B * ceil(n / 4096) * 8 words).
extern "C" int sk_sparse_rowwise(const uint32_t* keys, const float* data, const int* rows,
                                 const int* cols, float* out, int* end, int* table, int64_t B,
                                 int64_t nnz, int64_t m, int64_t n, int64_t s, uint32_t mult,
                                 cudaStream_t stream) {
  if (bad_shape(B, nnz, m, s) || n < 1 || n >= 0x7FFFFFFF ||
      (m + kWarps - 1) / kWarps > 0x7FFFFFFF || (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const int64_t tiles = (nnz + kPrepTile - 1) / kPrepTile;
  const int64_t chunk_blocks = (n_chunks + kThreads - 1) / kThreads;
  uint4* tb = reinterpret_cast<uint4*>(table);
  sparse_rw_prep<<<dim3((unsigned)(tiles > chunk_blocks ? tiles : chunk_blocks), (unsigned)B),
                   kThreads, 0, stream>>>(keys, data, nnz, n_chunks, end, tb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + kWarps - 1) / kWarps), (unsigned)B);
  sparse_rw_kernel<<<grid, kThreads, 0, stream>>>(tb, data, rows, cols, end, out, nnz, m,
                                                  (int)s, mult, n_chunks);
  return (int)cudaGetLastError();
}

// Columnwise: out (B, s, m), every cell written; m = the lanes' (padded)
// column count, n_rows their (padded) row count. Scratch, allocated by the
// caller: end (B ints, zeroed), bucket (B * T * 2048 ints) and runs (B * T
// * 2048 int4), T = ceil(n_rows / 2048).
extern "C" int sk_sparse_columnwise(const uint32_t* keys, const float* data, const int* rows,
                                    const int* cols, float* out, int* end, int* bucket,
                                    int* runs, int64_t B, int64_t nnz, int64_t n_rows, int64_t m,
                                    int64_t s, uint32_t mult, cudaStream_t stream) {
  const int64_t T = (n_rows + kRunTile - 1) / kRunTile;
  if (bad_shape(B, nnz, m, s) || n_rows < 1 || n_rows >= 0x7FFFFFFF ||
      (s + kAccWarps - 1) / kAccWarps > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  sparse_lane_end<<<dim3((unsigned)((nnz + kTile - 1) / kTile), (unsigned)B), kThreads, 0,
                    stream>>>(data, nnz, end);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int4* rn = reinterpret_cast<int4*>(runs);
  sparse_cw_sort<<<dim3((unsigned)T, (unsigned)B), kSortThreads, 0, stream>>>(
      keys, rows, end, nnz, (int)s, mult, bucket, rn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s + kAccWarps - 1) / kAccWarps), (unsigned)B);
  sparse_cw_accum<<<grid, kAccWarps * 32, 0, stream>>>(data, cols, bucket, rn, out, nnz, n_rows,
                                                       m, (int)s);
  return (int)cudaGetLastError();
}
