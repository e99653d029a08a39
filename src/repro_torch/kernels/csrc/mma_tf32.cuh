// Tensor-core and async-copy helpers shared by the attention kernels
// (prism_attention.cu, decode_attention.cu), for sm_90a.
//
// 3xTF32: an f32 product on the TF32 tensor cores at f32 accuracy.  Each
// operand x is split into hi = tf32(x) and lo = x - hi, and a product is
// lo*hi + hi*lo + hi*hi with f32 accumulation (lo*lo, 2^-22 of the
// product, is dropped).  Single-pass TF32 keeps about three decimal
// digits and does not meet the kernels' f32 tolerances.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// an operand element in f32: f32 as it is, bf16 widened (exact)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// k-steps of QK^T a score accumulator takes: the tensor core truncates
// as it accumulates, so a longer product (head dim 128's 16 k-steps,
// 256's 32) runs as chains of this many, each in its own accumulator,
// added in f32 in order
constexpr int QK_CHAIN = 8;

// acc += Q K^T over k-steps [K0, K1) of a warp's 16 query rows and a
// 32-column K tile (NJ n-tiles of 8).  Q's TF32 parts are parked per
// thread in A-fragment order (my_q[(2 ks) * 32] hi, [(2 ks + 1) * 32]
// lo); K's rows (stride LDK floats in shared memory) are read permuted
// inside each 8-column group (column 2i <- i, 2i + 1 <- i + 4), so the
// accumulator is the A fragment of the P V product that follows.  n-tile
// j, entry e holds column j*8 + t + 4*(e & 1) of row g + 8*(e >> 1).
// K's elements are f32 or bf16 (T), widened where they are read: a bf16
// value is a TF32 value, so its lo part is 0.
template <int K0, int K1, int NJ, int LDK, typename T>
__device__ __forceinline__ void qk_3xtf32(float (&acc)[NJ][4],
                                          const uint4* my_q, const T* sK,
                                          int g, int t) {
#pragma unroll
  for (int ks = K0; ks < K1; ++ks) {
    const uint4 h4 = my_q[(2 * ks) * 32], l4 = my_q[(2 * ks + 1) * 32];
    const uint32_t qh[4] = {h4.x, h4.y, h4.z, h4.w};
    const uint32_t ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const T* kr = sK + (j * 8 + (g >> 1) + (g & 1) * 4) * LDK + ks * 8;
      uint32_t bh0, bl0, bh1, bl1;
      split(to_f32(kr[t]), bh0, bl0);
      split(to_f32(kr[t + 4]), bh1, bl1);
      mma_3xtf32(acc[j], qh, ql, bh0, bh1, bl0, bl1);
    }
  }
}

// acc += Q K^T over NK k-steps, as qk_3xtf32, with Q kept in f32 (one
// float4 a k-step per thread, A-fragment order: rows g, g + 8 at dim t,
// then at dim t + 4) and split into its TF32 parts where it is used:
// half the shared memory of parked parts, for two integer ops an operand.
// The parts are the same, so the product is qk_3xtf32's.  my_q and sK
// point at the chain's first k-step.
template <int NK, int NJ, int LDK>
__device__ __forceinline__ void qk_3xtf32_f32q(float (&acc)[NJ][4],
                                               const float4* my_q,
                                               const float* sK, int g,
                                               int t) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const float4 q4 = my_q[ks * 32];
    uint32_t qh[4], ql[4];
    split(q4.x, qh[0], ql[0]);
    split(q4.y, qh[1], ql[1]);
    split(q4.z, qh[2], ql[2]);
    split(q4.w, qh[3], ql[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* kr = sK + (j * 8 + (g >> 1) + (g & 1) * 4) * LDK + ks * 8;
      uint32_t bh0, bl0, bh1, bl1;
      split(kr[t], bh0, bl0);
      split(kr[t + 4], bh1, bl1);
      mma_3xtf32(acc[j], qh, ql, bh0, bh1, bl0, bl1);
    }
  }
}

// 16 bytes from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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
