// Segment Means reduction (paper Alg. 2, Eq. 8) and the fused PRISM
// augment, f32 and bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_means.py
// (segment_means_op, body _kernel).
//
// What it computes: x (R, N, D) -> the column means of L contiguous
// segments of each row block: segment l covers rows [l * s, (l + 1) * s)
// with s = N / L, and the last segment runs to N (the Eq. 8 ragged tail,
// handled here, in the kernel).  Sums are taken in f32; the means are
// written in x's type.  Two entries:
//
//   segment_means_*   out (R, L, D), the means alone;
//   prism_augment_*   x_hat (R, N + P*L, D), the PRISM prefill's K/V
//                     source: row r = b*P + p holds shard p of sequence
//                     b; its first N rows are x[r], then the means of
//                     every shard of sequence b, shard-major.  Each block
//                     copies its segment's rows of x[r] into x_hat[r] and
//                     writes their mean into all P rows of sequence b.
//
// What bounds it on an H100: memory.  Every input element is read once
// and every output element written once: (R*N*D + R*L*D) elements for
// the means alone (15.7 MB in f32 on the main path, 4.7 us at 3.35 TB/s),
// R*N*D + R*(N + P*L)*D for the augment (37.7 MB, 11.3 us).  About one
// add per element read, far below the card's f32 rate.
//
// Design: one block per (row, segment), spanning the whole feature row
// of D / 4 float4 (or D / 8 bf16x8) 16-byte columns, one per thread: on
// the main path 32 x 32 = 1,024 blocks of 192 threads.  A thread issues
// the 16-byte loads of up to 4 segment rows before it sums any of them
// (rows past the segment's end are predicated off), so it keeps 64 bytes
// in flight; a longer segment loops over such chunks.  Four rows match
// the main path's s = 4; eight measured no faster.  At 52-60 registers
// five blocks fit an SM, so the 1,024 blocks take two waves; capping the
// registers so that eight fit (one wave) measured no faster either: the
// bytes bound the call, not the waves.  D not a multiple of the vector
// width, or a base not 16-byte aligned, takes the same kernel with one
// element per thread and column (D = 33, D = 5).  Stores are ordinary:
// the augment's x_hat (25 MB) stays in the 50 MB L2 for the LayerNorm
// that reads it next.  A single pass over 4 rows per segment reuses
// nothing, so shared memory, TMA and the tensor cores have nothing to
// offer it.
//
// Measured on an H100 (chip_smoke.py's device_ms, PERF.md): 1.8x the
// byte bound for the means alone and 1.3x for the augment, after an L2
// flush that leaves the cache dirty, so that each line read evicts one
// to be written back; the augment takes about half the time of the
// means kernel, expand and concatenation it replaces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // threads per block, at most
constexpr int CHUNK = 4;          // rows a thread loads before summing

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// What one thread loads per row: W elements of T, summed in f32.
template <typename T, bool VEC>
struct Unit;

template <typename T>
struct Unit<T, false> {                  // one element
  static constexpr int W = 1;
  using Raw = T;
  __device__ __forceinline__ static void add(float* acc, const Raw& r) {
    acc[0] += to_float(r);
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    return from_float<T>(v[0]);
  }
};

template <>
struct Unit<float, true> {               // float4
  static constexpr int W = 4;
  using Raw = float4;
  __device__ __forceinline__ static void add(float* acc, const Raw& r) {
    acc[0] += r.x;
    acc[1] += r.y;
    acc[2] += r.z;
    acc[3] += r.w;
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Unit<__nv_bfloat16, true> {       // 8 bf16 in a uint4
  static constexpr int W = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void add(float* acc, const Raw& r) {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  __device__ __forceinline__ static Raw pack(const float* v) {
    Raw r;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

// Block (r, l) of a 1-D grid of R * L blocks: the means of segment l of
// x[r] go to rows (r / P) * P + q, q < P, column out_off + (r % P) * L + l
// of out (R, out_rows, D); with COPY, rows [start, end) of x[r] go to the
// same rows of out[r].
template <typename T, bool VEC, bool COPY>
__global__ void __launch_bounds__(MAX_THREADS) segment_means_kernel(
    const T* __restrict__ x, T* __restrict__ out, int N, int L, int D,
    int P, int out_rows, int out_off) {
  using U = Unit<T, VEC>;
  using Raw = typename U::Raw;
  const int r = blockIdx.x / L;
  const int l = blockIdx.x % L;
  const int s = N / L;
  const int start = l * s;
  const int end = (l == L - 1) ? N : start + s;
  const int cols = D / U::W;                      // units per feature row
  const Raw* xr = reinterpret_cast<const Raw*>(x) + (size_t)r * N * cols;
  Raw* o = reinterpret_cast<Raw*>(out);
  Raw* orow = o + (size_t)r * out_rows * cols;
  const size_t seq0 = (size_t)(r - r % P);        // row of shard 0
  const int col = out_off + (r % P) * L + l;
  const float count = (float)(end - start);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float acc[U::W];
#pragma unroll
    for (int k = 0; k < U::W; ++k) acc[k] = 0.f;
    for (int i = start; i < end; i += CHUNK) {
      Raw v[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        if (i + u < end) v[u] = xr[(size_t)(i + u) * cols + c];
      if (COPY) {
#pragma unroll
        for (int u = 0; u < CHUNK; ++u)
          if (i + u < end) orow[(size_t)(i + u) * cols + c] = v[u];
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        if (i + u < end) U::add(acc, v[u]);
    }
    float mean[U::W];
#pragma unroll
    for (int k = 0; k < U::W; ++k) mean[k] = acc[k] / count;
    const Raw m = U::pack(mean);
    for (int q = 0; q < P; ++q)
      o[((seq0 + q) * out_rows + col) * cols + c] = m;
  }
}

template <typename T, bool COPY>
int launch(const void* x, void* out, int R, int N, int L, int D, int P,
           void* stream) {
  if (R < 1 || D < 1 || L < 1 || L > N || P < 1 || R % P ||
      (long long)R * L > INT_MAX || (long long)P * L > INT_MAX - N)
    return (int)cudaErrorInvalidValue;
  constexpr int W = Unit<T, true>::W;
  const bool vec = D % W == 0 &&
                   ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int cols = vec ? D / W : D;
  const int threads =
      cols < MAX_THREADS ? (cols + 31) / 32 * 32 : MAX_THREADS;
  const int out_rows = COPY ? N + P * L : L;
  const int out_off = COPY ? N : 0;
  const auto* xp = static_cast<const T*>(x);
  auto* op = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    segment_means_kernel<T, true, COPY><<<R * L, threads, 0, st>>>(
        xp, op, N, L, D, P, out_rows, out_off);
  else
    segment_means_kernel<T, false, COPY><<<R * L, threads, 0, st>>>(
        xp, op, N, L, D, P, out_rows, out_off);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, N, D) -> out (B, L, D)
extern "C" int segment_means_f32(const void* x, void* out, int B, int N,
                                 int L, int D, void* stream) {
  return launch<float, false>(x, out, B, N, L, D, 1, stream);
}

extern "C" int segment_means_bf16(const void* x, void* out, int B, int N,
                                  int L, int D, void* stream) {
  return launch<__nv_bfloat16, false>(x, out, B, N, L, D, 1, stream);
}

// x (B*P, N, D) -> x_hat (B*P, N + P*L, D)
extern "C" int prism_augment_f32(const void* x, void* x_hat, int BP, int N,
                                 int L, int D, int P, void* stream) {
  return launch<float, true>(x, x_hat, BP, N, L, D, P, stream);
}

extern "C" int prism_augment_bf16(const void* x, void* x_hat, int BP, int N,
                                  int L, int D, int P, void* stream) {
  return launch<__nv_bfloat16, true>(x, x_hat, BP, N, L, D, P, stream);
}
