// Threefry-2x32-20 on the card, shared by the port's CUDA kernels.
//
// The cipher is the public Threefry-2x32 with 20 rounds (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11), word for word as
// base/threefry.py computes it in int64 on the host.
#pragma once

#include <stdint.h>

namespace sk {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32-20 under (k0, k1), in place on the counter words (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define SK_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  SK_ROUND(13) SK_ROUND(15) SK_ROUND(26) SK_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  SK_ROUND(17) SK_ROUND(29) SK_ROUND(16) SK_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  SK_ROUND(13) SK_ROUND(15) SK_ROUND(26) SK_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  SK_ROUND(17) SK_ROUND(29) SK_ROUND(16) SK_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  SK_ROUND(13) SK_ROUND(15) SK_ROUND(26) SK_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef SK_ROUND
}

// jax.random.fold_in(key, d), in place on (k0, k1): the cipher under the
// key at the counter words (0, d). jax.random.split(key)[i] is the same
// pair at (0, i), so fold_in(key, i) is also split's i-th key.
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// base/randgen.py chunk_key(key, c), in place: fold_in(fold_in(key,
// c >> 31), c & (2^31 - 1)), the key of chunk (or column block) c.
__device__ __forceinline__ void chunk_key(uint32_t& k0, uint32_t& k1, int64_t c) {
  fold_in(k0, k1, (uint32_t)(c >> 31));
  fold_in(k0, k1, (uint32_t)(c & 0x7FFFFFFF));
}

// Word p (< 2^32) of jax.random.bits(key, (L,)) under JAX's partitionable
// Threefry: x0 ^ x1 of the cipher at the counter words (0, p). This is
// the layout of base/randgen.py's counter streams (stream_slice).
__device__ __forceinline__ uint32_t stream_bits(uint32_t k0, uint32_t k1, uint32_t p) {
  uint32_t x0 = 0u, x1 = p;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.rademacher from its word: +1 where the top bit is 0.
__device__ __forceinline__ float rademacher(uint32_t bits) {
  return (bits >> 31) ? -1.0f : 1.0f;
}

}  // namespace sk
