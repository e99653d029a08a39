// bf16 tensor-core helper for the attention kernels, for sm_90a: one
// m16n8k16 product of bf16 operands with f32 accumulation (the
// reference's "bf16 inputs, f32 accumulate": one product where an
// f32-accurate one takes three TF32 ones, mma_tf32.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// c += a * b, one m16n8k16 bf16 product with f32 accumulation.  A
// fragment (row-major 16 x 16), two bf16 a register, the lower half the
// lower column: a0 (row g, cols 2t, 2t + 1), a1 (row g + 8, the same),
// a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8, the same); B (16 x 8):
// b0 (rows 2t, 2t + 1 of column g), b1 (rows 2t + 8, 2t + 9); C: c0, c1
// (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).  g = lane / 4, t = lane
// % 4.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (to nearest, ties to even) in one
// register, x in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two bf16 values from their 16-bit patterns in one register, x lower
__device__ __forceinline__ uint32_t pack_bits(uint16_t x, uint16_t y) {
  return (uint32_t)x | ((uint32_t)y << 16);
}

}  // namespace tc
