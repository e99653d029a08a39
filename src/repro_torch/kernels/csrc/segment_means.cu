// Segment Means reduction (paper Alg. 2, Eq. 8), f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_means.py
// (segment_means_op, body _kernel).
//
// What it computes: x (B, N, D) -> (B, L, D), the column means of L
// contiguous segments of each row block: segment l covers rows
// [l * s, (l + 1) * s) with s = N / L, and the last segment runs to N
// (the Eq. 8 ragged tail is handled here, in the kernel).  Sums are taken
// in f32.
//
// What bounds it on an H100: memory.  Every input element is read once
// and added once, so the floor is (B*N*D + B*L*D) * 4 bytes over the
// 3.35 TB/s HBM rate (15.7 MB, about 4.7 us, on the main path).
//
// Design: one thread per (batch row, segment, feature column); a block
// of 256 threads covers 256 neighbouring features of one segment, so
// each row of the segment is one coalesced 1 KB read per block.  Each
// thread walks its segment's rows and keeps the running sum in a
// register.  No shared memory, no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) segment_means_kernel(
    const float* __restrict__ x,   // (B, N, D)
    float* __restrict__ out,       // (B, L, D)
    int N, int L, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  if (d >= D) return;
  const int s = N / L;
  const int start = l * s;
  const int end = (l == L - 1) ? N : start + s;
  const float* xp = x + ((size_t)b * N + start) * D + d;
  float acc = 0.f;
  for (int i = start; i < end; ++i, xp += D) acc += *xp;
  out[((size_t)b * L + l) * D + d] = acc / (float)(end - start);
}

}  // namespace

extern "C" int segment_means_f32(const void* x, void* out, int B, int N,
                                 int L, int D, void* stream) {
  if (L < 1 || L > N || L > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + NT - 1) / NT, L, B);
  segment_means_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), N, L, D);
  return (int)cudaGetLastError();
}
