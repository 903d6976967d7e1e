// Tensor-core primitives (mma.sync m16n8k16 in bf16, ldmatrix) shared by
// the estimate, the select, the fused decode kernel and the decode
// attention chunk (attend.cuh).
#pragma once

#include "common.cuh"

namespace qt {

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), c 16 x 8 f32, in the m16n8k16 fragment layout.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed (the B operand
// of mma_bf16 from a row-major [k][n] tile); lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

}  // namespace qt
