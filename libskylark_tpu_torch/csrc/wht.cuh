// The register Walsh-Hadamard transform for Hopper (sm_90a), shared by
// fastfood.cu (B4) and fwht_sketch.cu (B5).
//
// A vector of NB = 2^K floats lives in the registers of a group of T
// threads, V = 2^L values a thread (L = min(4, K)). A phase applies the L
// butterfly levels whose index bits are the thread's own "window" of bits
// [lo, lo + L): value j of thread t is element
// (t mod 2^lo) | j << lo | (t >> lo) << (lo + L). Between phases one
// shared-memory exchange (each value written once, read once) re-deals the
// values so that the next window is local; the last window is [K - L, K)
// (it may repeat levels of the one before and applies only the new ones),
// so the last phase leaves element t + j * T in value j. The levels keep
// the butterfly's order (h = 1, 2, ..., NB/2, each (a + b, a - b)), so
// every output is fut._wht_butterfly's sum tree, bit for bit. The exchange
// buffer is swizzled (swz) so that the exchanges of the main windows are
// free of bank conflicts; an exchange whose elements stay in their warp
// takes warp barriers and a third buffer, the others alternate between two
// buffers with one __syncthreads each.
#pragma once

#include <stdint.h>

namespace sk {

constexpr int kMaxL = 4;           // a thread holds at most 16 values of a row
constexpr int kBlockThreads = 256; // threads of a block whose rows need fewer

// Swizzled shared-memory slot of block-wide element n: bits 0-4 (the bank)
// XOR bits 5-8 and bit 8 again into bit 4. Conflict-free for the windows
// [0, 4) (a warp's lanes on bits 4-8), [4, 8) (bits 0-3 and 8) and any
// window at or above bit 5 (bits 0-4). It is linear over XOR: for n = a | b
// with a, b on disjoint bits, swz(n) = swz(a) ^ swz(b), so a thread's slot
// is its own part, computed once, XOR a constant per value.
__host__ __device__ constexpr int swz(int n) {
  return n ^ (((n >> 5) & 15) | (((n >> 8) & 1) << 4));
}

// The block shape of NB = 2^K (sketch/cuda_fastfood.py plan() mirrors it):
// V = 2^L values a thread, T threads a row, G row groups a block; windows
// [lo, lo + L) of index bits, the last one [K - L, K).
template <int K>
struct Shape {
  static constexpr int L = K < kMaxL ? K : kMaxL;
  static constexpr int V = 1 << L;
  static constexpr int T = 1 << (K - L);
  static constexpr int G = T >= kBlockThreads ? 1 : kBlockThreads / T;
  static constexpr int LAST = K - L;
  static constexpr int BLOCK = G * T;
  // two 256-thread blocks a SM at least (128 registers a thread: the
  // chain spills below that); one block of 512 or 1024 threads
  static constexpr int MIN_BLOCKS = BLOCK == kBlockThreads ? 2 : 1;
};

// Thread t's bits of its elements in window [lo, lo + L): element
// tpart | j << lo holds value j.
template <int L>
__device__ __forceinline__ int tpart(int t, int lo) {
  return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + L));
}

// Levels lo + q for q in [qa, qb) on the thread's values, in increasing
// order, each butterfly (a + b, a - b).
template <int L>
__device__ __forceinline__ void levels(float (&x)[1 << L], int qa, int qb) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    if (q < qa || q >= qb) continue;
#pragma unroll
    for (int j = 0; j < (1 << L); ++j) {
      if (j & (1 << q)) continue;
      const float a = x[j], b = x[j | (1 << q)];
      x[j] = __fadd_rn(a, b);
      x[j | (1 << q)] = __fsub_rn(a, b);
    }
  }
}

// Element bits that select the warp holding an element in window lo's
// layout: thread bit q >= 5 is element bit q (q < lo) or q + L (q >= lo).
template <int K>
__host__ __device__ constexpr unsigned warp_bits(int lo) {
  unsigned m = 0;
  for (int q = 5; q < K - Shape<K>::L; ++q) m |= 1u << (q < lo ? q : q + Shape<K>::L);
  return m;
}

// True when every element stays in its warp from window lo to window nlo
// (always when a row group fits in a warp): the exchange then needs no
// block barrier.
template <int K>
__host__ __device__ constexpr bool warp_local(int lo, int nlo) {
  return Shape<K>::T <= 32 || warp_bits<K>(lo) == warp_bits<K>(nlo);
}

// x to the exchange buffer at window lo's slots and back at window nlo's.
// A warp-local exchange uses the third buffer with warp barriers (a warp
// touches only its own elements there); the others alternate between the
// first two with one block barrier each, so a buffer is written again only
// after the next block barrier, when every read of it is done. TWO: the
// first two buffers only, every exchange with a block barrier (for a
// caller that keeps the third buffer's room for itself).
template <int K, bool TWO = false>
__device__ __forceinline__ void exchange(float (&x)[Shape<K>::V], float* buf, int stride,
                                         int& parity, int base, int t, int lo, int nlo) {
  constexpr int L = Shape<K>::L, V = Shape<K>::V;
  const bool local = !TWO && warp_local<K>(lo, nlo);
  float* e = buf + (local ? 2 : parity) * stride;
  if (local)
    __syncwarp();
  else
    parity ^= 1;
  const int wb = swz(base | tpart<L>(t, lo));
#pragma unroll
  for (int j = 0; j < V; ++j) e[wb ^ swz(j << lo)] = x[j];
  if (local)
    __syncwarp();
  else
    __syncthreads();
  const int rb = swz(base | tpart<L>(t, nlo));
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = e[rb ^ swz(j << nlo)];
}

// Unnormalized WHT of a row, values in window 0's layout on entry and in
// window K - L's on return, an exchange between windows. Every index is a
// compile-time constant but the thread's own parts.
template <int K, bool TWO = false>
__device__ __forceinline__ void wht(float (&x)[Shape<K>::V], float* buf, int stride,
                                    int& parity, int base, int t) {
  constexpr int L = Shape<K>::L;
  levels<L>(x, 0, L);
  int lo = 0;
#pragma unroll
  for (int p = L; p < K; p += L) {
    const int nlo = p < K - L ? p : K - L;
    exchange<K, TWO>(x, buf, stride, parity, base, t, lo, nlo);
    levels<L>(x, p - nlo, (p + L < K ? p + L : K) - nlo);
    lo = nlo;
  }
}

// V consecutive floats a[i0 .. i0 + V), zero past len (or all zero when
// !valid); 16-byte loads where aligned.
template <int V>
__device__ __forceinline__ void load_row(float (&x)[V], const float* __restrict__ a, int64_t len,
                                         int i0, bool vec, bool valid) {
  if (!valid) {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = 0.0f;
    return;
  }
  if constexpr (V >= 4) {
    if (vec && i0 + V <= len) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(a + i0 + j));
        x[j] = q.x;
        x[j + 1] = q.y;
        x[j + 2] = q.z;
        x[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = i0 + j < len ? __ldg(a + i0 + j) : 0.0f;
}

// x[j] *= s[i0 + j] (a stream in window 0's layout), each product
// rounded on its own; NB is a multiple of V and the streams are 16-byte
// aligned. Four entries are live at a time.
template <int V>
__device__ __forceinline__ void scale_by(float (&x)[V], const float* __restrict__ s, int i0) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(s + i0 + j));
      x[j] = __fmul_rn(q.x, x[j]);
      x[j + 1] = __fmul_rn(q.y, x[j + 1]);
      x[j + 2] = __fmul_rn(q.z, x[j + 2]);
      x[j + 3] = __fmul_rn(q.w, x[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = __fmul_rn(__ldg(s + i0 + j), x[j]);
  }
}

}  // namespace sk
