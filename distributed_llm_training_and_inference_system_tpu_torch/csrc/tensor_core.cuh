// Tensor-core fragment helpers for Hopper (sm_90a), shared by the bf16
// flash-attention kernels (flash_attention.cu), the W4A16 and W8A16
// matmuls (int4_matmul.cu, int8_matmul.cu) and paged attention
// (paged_attention.cu): ldmatrix
// loads of mma.sync m16n8k16 operands from padded shared tiles (rows
// padded by 8 bf16: the eight 16-byte rows an 8x8 matrix reads fall in
// eight distinct bank groups, so no load conflicts), the bf16 mma.sync
// with fp32 accumulation, cp.async copies global -> shared, and the
// accumulator -> A-fragment repack.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 g + t): A (row-major
// 16 x 16) a0 = (row g, cols 2t, 2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t +
// 8..), a3 = (g + 8, 2t + 8..); B (16 x 8, "col") b0 = (k 2t, 2t+1, col g),
// b1 = (k 2t + 8.., col g); C c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8,
// 2t), c3 = (g + 8, 2t + 1). Two bf16 values in one register hold the
// lower index in the low half.

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lane l gives the address of row l & 7 of matrix
// l >> 3 and receives, of matrix j, row l / 4, columns 2 (l % 4) and +1 in
// r[j] (.trans: column l / 4, rows 2 (l % 4) and +1)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows [0, 16) x columns [0, 16) of a row-major tile
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16_t* tile,
                                       int ld, int lane) {
  ldsm_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}
// B fragments of two n-tiles from a tile stored [n][k] (rows n, n + 16 x
// columns k, k + 16): n-tile 0 in (b[0], b[1]), n-tile 1 in (b[2], b[3])
__device__ __forceinline__ void ldsm_b_nk(uint32_t b[4], const bf16_t* tile,
                                          int ld, int lane) {
  ldsm_x4(b, tile + ((lane >> 4) * 8 + (lane & 7)) * ld
                 + ((lane >> 3) & 1) * 8);
}
// the same from a tile stored [k][n] (rows k .. k + 16, columns n .. n + 16)
__device__ __forceinline__ void ldsm_b_kn(uint32_t b[4], const bf16_t* tile,
                                          int ld, int lane) {
  ldsm_x4_trans(b, tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld
                       + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 and packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The m16n8 accumulators of n-tiles 2j and 2j + 1 hold a 16 x 16 block in
// the m16n8k16 A layout once rounded: the next product's A fragment j.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared, bypassing L1; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// until at most N of this thread's newest groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tc
