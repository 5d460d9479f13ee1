// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, the TMA's copies into shared memory (1-D bulk copies, and 3-D
// tiles through a tensor map), register budgets, and bf16 and tf32
// warpgroup matrix multiplies (wgmma) with the A operand in registers and
// B in shared memory.
//
// Shared-memory layout of a wgmma B operand here: K-major with the 128-byte
// swizzle. A tile of R rows by 64 bf16 values keeps row r at byte r * 128,
// with its 16-byte chunk c stored at chunk c ^ (r % 8); 8-row groups are
// 1024 bytes apart (the descriptor's stride byte offset), and the tile must
// start on a 1024-byte boundary. A 16-deep k-step inside the tile is the
// same descriptor advanced by 32 bytes. A tf32 tile has the same byte
// layout: a row holds 32 values, and an 8-deep k-step is again 32 bytes.
//
// Register fragment of a 64 x 16 bf16 A operand, as for mma.m16n8k16: warp
// w of the warpgroup holds rows 16w .. 16w + 15; lane l = 4g + q holds, in
// its four 32-bit registers, (row g, cols 2q, 2q + 1), (row g + 8, cols 2q,
// 2q + 1), (row g, cols 2q + 8, 2q + 9), (row g + 8, cols 2q + 8, 2q + 9),
// the lower column in the low half. Of a 64 x 8 tf32 A operand, lane 4g + q
// of warp w holds (row g, col q), (row g + 8, col q), (row g, col q + 4),
// (row g + 8, col q + 4), one value a register. The fp32 accumulator of a 64 x N tile:
// register 4i + 2h + e of lane 4g + q in warp w is row 16w + g + 8h,
// column 8i + 2q + e.
#pragma once

#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces ``bytes`` of bulk-copy traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned); completion is counted on bar's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Register budget of a warpgroup: a producer gives registers back, the
// consumers take them (every warp of the warpgroup executes it).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The box of a 3-D tensor map (a __grid_constant__ kernel parameter) whose
// first corner is element (c0, c1, c2), innermost first, to shared dst
// (1024-byte aligned for the 128-byte swizzle); elements outside the
// tensor arrive as zeros, and the whole box counts on bar's transaction
// count.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a K-major, 128-byte-swizzled B tile at shared address
// ``addr`` (1024-byte aligned, or advanced from such an address by a
// k-step's 32 bytes): start address >> 4 in bits 0-13, leading byte offset
// 1 (unused by this layout), stride byte offset 1024 >> 4 in bits 32-45,
// layout 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The accumulator and A operands of an m64nNk* wgmma with A in registers.
#define HOP_D32                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOP_D64                                                                             \
  HOP_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),    \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),         \
      "+f"(d[62]), "+f"(d[63])
#define HOP_A "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
#define HOP_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOP_R64                                                                          \
  HOP_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
          "%62, %63"

// D[64 x N] += A[64 x 16] (registers) * B[16 x N] (shared memory, K-major,
// 128-byte swizzle), bf16 inputs, fp32 accumulators; accumulate == 0
// overwrites D with the product.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOP_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOP_D32
      : HOP_A);
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOP_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOP_D64
      : HOP_A);
}

// D[64 x N] += A[64 x 8] (registers) * B[8 x N] (shared memory, K-major,
// 128-byte swizzle), tf32 inputs (fp32 bit patterns whose low 13 mantissa
// bits the tensor cores ignore), fp32 accumulators. tf32 takes no
// transpose argument: its B tile is always K-major.
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" HOP_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOP_D32
      : HOP_A);
}

__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" HOP_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOP_D64
      : HOP_A);
}

#undef HOP_D32
#undef HOP_D64
#undef HOP_A
#undef HOP_R32
#undef HOP_R64

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc, accumulate);
  else wgmma_rs_n128(d, a, desc, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_tf32_n64(d, a, desc, accumulate);
  else wgmma_rs_tf32_n128(d, a, desc, accumulate);
}

// x rounded to tf32 (10 stored mantissa bits, to nearest, ties away from
// zero), as an fp32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

}  // namespace hop
