// Hopper (sm_90a) building blocks for the hand-written kernels: cp.async
// copies into shared memory, the 128-byte swizzled tile layout that wgmma
// reads, wgmma's matrix descriptors, the two wgmma shapes of the flash
// attention kernel, and the warp-level mma.sync and ldmatrix of the decode
// kernel.
#pragma once
#include <cuda_bf16.h>

#include <cstdint>

namespace raven_hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes from global to shared memory, not through L1; with
// src_bytes = 0 nothing is read and the 16 bytes are zeroed.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's earlier shared-memory writes (cp.async lands through
// the generic proxy) before later reads by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The 128-byte swizzled layout. A tile of bf16 rows is cut into slabs of 64
// columns (128 bytes a row); within a slab, row r's 16-byte chunk c sits at
// byte r * 128 + ((c ^ (r % 8)) * 16), so the eight rows of a 1,024-byte
// atom spread each column over all banks. Slabs start 1,024-byte aligned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + (((chunk ^ row) & 7) << 4));
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle:
// start address, leading- and stride-dimension byte offsets (in 16-byte
// units), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ---------------------------------------------------------------------------
// wgmma: issued by the four warps of a warpgroup together.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to the accumulator registers
// across an asynchronous wgmma (they are written when wgmma_wait returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core products (mma.sync, sm_80 and later) and ldmatrix.
// ---------------------------------------------------------------------------

// D(16 x 8, f32) += A(16 x 16, bf16, row) . B(16 x 8, bf16, col): per lane
// (r = lane / 4, c = lane % 4) a = {A[r][2c..], A[r+8][2c..], A[r][2c+8..],
// A[r+8][2c+8..]}, b = {B[2c..][r], B[2c+8..][r]}, d = {D[r][2c], D[r][2c+1],
// D[r+8][2c], D[r+8][2c+1]}.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8 i .. 8 i + 7 give the
// row addresses of matrix i, and lane l receives row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of each (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

#define RAVEN_ACC8(b)                                                          \
  "+f"(d[(b)]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]), "+f"(d[(b) + 3]),          \
      "+f"(d[(b) + 4]), "+f"(d[(b) + 5]), "+f"(d[(b) + 6]), "+f"(d[(b) + 7])

// D(64 x 64, f32) (+)= A(64 x 16) . B(64 x 16)^T, bf16, both operands
// K-major in shared memory. Accumulator element i of thread t (warp w, lane
// l of the warpgroup) is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RAVEN_ACC8(0), RAVEN_ACC8(8), RAVEN_ACC8(16), RAVEN_ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) += A(64 x 16) . B(16 x 128), bf16; A from registers in
// the m16n8k16 fragment layout of each warp's 16 rows, B in shared memory
// MN-major (its 128 columns contiguous: the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : RAVEN_ACC8(0), RAVEN_ACC8(8), RAVEN_ACC8(16), RAVEN_ACC8(24), RAVEN_ACC8(32),
        RAVEN_ACC8(40), RAVEN_ACC8(48), RAVEN_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef RAVEN_ACC8

}  // namespace raven_hopper
