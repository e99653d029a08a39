// The Eq. 17 mask rule and the exact tile skip shared by the prefill
// attention kernels (prism_attention.cu, f32; prism_attention_bf16.cu).
#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace prism {

constexpr float NEG = -1e30f;

// whether a column [lo, hi] is visible to a row at position r
__device__ __forceinline__ bool visible(int lo, int hi, int r, int causal,
                                        int prefix_len, int has_window,
                                        int window) {
  bool vis = true;
  if (causal) {
    vis = hi <= r;
    if (prefix_len > 0) vis = vis || (hi < prefix_len);
  }
  if (has_window) vis = vis && ((long long)lo > (long long)r - window);
  return vis;
}

// The BK-column tiles in which some column is live (log g > -1e30 / 2)
// and could be visible to a row position of the query tile of BQ rows
// from q0, from the tile's own min / max test per column (the PRISM means
// columns are not sorted by position): their indices, in order, into
// s_tiles (ceil(M / BK) ints of shared memory).  Returns how many.  Every
// thread of the block (NT threads) calls it; s_int is 3 ints of shared
// memory.
template <int BQ, int BK, int NT>
__device__ __forceinline__ int live_tiles(
    const float* __restrict__ log_g, const int* __restrict__ col_lo,
    const int* __restrict__ col_hi, const int* __restrict__ row_pos,
    int pm, int q0, int Nq, int M, int causal, int prefix_len,
    int has_window, int window, int* s_tiles, int* s_int) {
  const int tid = threadIdx.x;
  const int ntiles = (M + BK - 1) / BK;
  if (tid == 0) {
    s_int[0] = INT_MAX;                 // the tile's least row position
    s_int[1] = INT_MIN;                 // and its largest
  }
  for (int i = tid; i < ntiles; i += NT) s_tiles[i] = 0;
  __syncthreads();
  if (tid < BQ && q0 + tid < Nq) {
    const int r = row_pos[pm * Nq + q0 + tid];
    atomicMin(&s_int[0], r);
    atomicMax(&s_int[1], r);
  }
  __syncthreads();
  const int rmin = s_int[0], rmax = s_int[1];
  for (int c = tid; c < M; c += NT) {
    const float lg = log_g[pm * M + c];
    const long long lo = col_lo[pm * M + c], hi = col_hi[pm * M + c];
    if (!(lg > NEG * 0.5f)) continue;
    // the rows that could see [lo, hi]: r >= hi (causal, unless a
    // prefix column) and r < lo + window; intersect with [rmin, rmax]
    long long a = rmin, z = rmax;
    if (causal && !(prefix_len > 0 && hi < prefix_len)) a = a > hi ? a : hi;
    if (has_window) z = z < lo + window - 1 ? z : lo + window - 1;
    if (a <= z) s_tiles[c / BK] = 1;
  }
  __syncthreads();
  if (tid == 0) {                       // compact the live tiles in order
    int n = 0;
    for (int i = 0; i < ntiles; ++i)
      if (s_tiles[i]) s_tiles[n++] = i;
    s_int[2] = n;
  }
  __syncthreads();
  return s_int[2];
}

}  // namespace prism
