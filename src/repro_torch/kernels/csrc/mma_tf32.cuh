// Tensor-core and async-copy helpers shared by the attention kernels
// (prism_attention.cu, decode_attention.cu), for sm_90a.
//
// 3xTF32: an f32 product on the TF32 tensor cores at f32 accuracy.  Each
// operand x is split into hi = tf32(x) and lo = x - hi, and a product is
// lo*hi + hi*lo + hi*hi with f32 accumulation (lo*lo, 2^-22 of the
// product, is dropped).  Single-pass TF32 keeps about three decimal
// digits and does not meet the kernels' f32 tolerances.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds) with two integer ops in place of the cvt
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi in TF32 (x's top 11 significant bits, rounded)
// and lo = x - hi exact in f32; lo goes to the tensor core as it is,
// which reads a TF32 operand's top 19 bits (lo truncated to 11
// significant bits: a relative error of at most 2^-21 of x, for two
// integer ops fewer per operand than rounding it)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the small cross terms first, the large one last
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 16 bytes from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace tc
