// PRISM scaling-aware flash attention (prefill), f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prism_attention.py
// (prism_flash_attention, body _kernel) with its wrapper
// src/repro/kernels/ops.py (prism_attention_op).
//
// What it computes: softmax(Q K^T * scale + log g) V per query row, with
// the Eq. 14 repeat counts as a +log g column bias (log g = -1e30 marks
// a dead column) and the Eq. 17 partition-aware mask evaluated from
// per-row positions and per-column [lo, hi] position ranges, plus the
// causal / prefix_len / window rules.  No (Nq, M) mask is ever built.
// A row that sees no column comes out as 0.  GQA: query head h reads KV
// head h / (Hq / Hkv).  The shard axis is folded into the batch: batch
// row b reads metadata row b % P and K/V row b / rep.
//
// What bounds it on an H100: bytes and f32 arithmetic about equally.  On
// the main path (GPT-2 small, B = 8, P = 4) a PRISM layer (Nq = 128,
// M = 256) moves 75 MB and needs 1.4 GFLOP for its visible pairs, about
// 22 us either way at 3.35 TB/s and 67 TFLOP/s; a Voltage layer
// (M = 512) needs 3.2 GFLOP, 48 us.  The kernel computes in f32 FMA (no
// TF32), so its results agree with the f32 plain version to rounding,
// and it reads each K/V tile from device memory once per 64 query rows.
// It also computes the masked pairs of a tile; skipping fully masked
// tiles is for a later change.
//
// Design: one block of 128 threads per (64-row query tile, query head,
// batch row).  Two threads share a query row: each holds half the row's
// scores of a 64-column K tile (even / odd columns) and half its output
// dims (even / odd dims) in registers, with the query row itself in
// registers.  K, V and the probability tile are staged in shared memory
// with a padded row stride (hd + 1 floats), so the threads of a warp
// read distinct banks or broadcast.  The online softmax (m, l, acc)
// stays in registers across K tiles; the two threads of a row combine
// their max and sum with one shuffle.  The ragged Nq and M edges are
// masked in the kernel.  This is the simple, correct form; wgmma / TMA
// and a pipelined K loop are for a later change.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // K/V columns per tile
constexpr int NT = 128;  // threads per block: two per query row

template <int HD>
__global__ void __launch_bounds__(NT) prism_attention_kernel(
    const float* __restrict__ q,        // (B, Nq, Hq, HD)
    const float* __restrict__ k,        // (B / rep, M, Hkv, HD)
    const float* __restrict__ v,        // (B / rep, M, Hkv, HD)
    const float* __restrict__ log_g,    // (P, M)
    const int* __restrict__ col_lo,     // (P, M)
    const int* __restrict__ col_hi,     // (P, M)
    const int* __restrict__ row_pos,    // (P, Nq)
    float* __restrict__ out,            // (B, Nq, Hq, HD)
    int Nq, int M, int Hq, int Hkv, int rep, int P, int causal,
    int prefix_len, int has_window, int window, float scale) {
  constexpr int LD = HD + 1;            // padded smem row stride
  constexpr int LP = BK + 1;
  constexpr int DPT = HD / 2;           // output dims per thread
  extern __shared__ float smem[];
  float* sK = smem;                     // BK x LD
  float* sV = sK + BK * LD;             // BK x LD
  float* sP = sV + BK * LD;             // BQ x LP
  __shared__ float sLg[BK];
  __shared__ int sLo[BK];
  __shared__ int sHi[BK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (Hq / Hkv);
  const int bk = b / rep;
  const int pm = b % P;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int qi = q0 + r;
  const bool row_ok = qi < Nq;

  float qr[HD];
  {
    const float* qp = q + ((size_t)(b * Nq + (row_ok ? qi : 0)) * Hq + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = row_ok ? qp[d] : 0.f;
  }
  const int rpos = row_ok ? row_pos[pm * Nq + qi] : 0;

  float m_run = NEG, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < M; c0 += BK) {
    __syncthreads();                    // previous tile fully consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int cc = idx / HD, d = idx % HD, c = c0 + cc;
      const size_t off = ((size_t)(bk * M + c) * Hkv + kvh) * HD + d;
      sK[cc * LD + d] = c < M ? k[off] : 0.f;
      sV[cc * LD + d] = c < M ? v[off] : 0.f;
    }
    if (tid < BK) {
      const int c = c0 + tid;
      const bool ok = c < M;
      sLg[tid] = ok ? log_g[pm * M + c] : NEG;
      sLo[tid] = ok ? col_lo[pm * M + c] : INT_MAX;
      sHi[tid] = ok ? col_hi[pm * M + c] : INT_MAX;
    }
    __syncthreads();

    float s[BK / 2];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int cc = 2 * j + half;
      const float* kr = sK + cc * LD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      bool vis = true;
      if (causal) {
        vis = sHi[cc] <= rpos;
        if (prefix_len > 0) vis = vis || (sHi[cc] < prefix_len);
      }
      if (has_window) vis = vis && (sLo[cc] > rpos - window);
      if (c0 + cc >= M) vis = false;
      const float sv = vis ? dot * scale + sLg[cc] : NEG;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float ps = 0.f;
    float* pr = sP + r * LP;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      // dead columns (masked, g = 0, padding) are re-zeroed so a row with
      // no visible column ends with l = 0 and a zero output
      const float p = s[j] > NEG * 0.5f ? expf(s[j] - m_new) : 0.f;
      ps += p;
      pr[2 * j + half] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l_run = l_run * corr + ps;
    m_run = m_new;
    __syncwarp();                       // both halves of the row are in sP
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int cc = 0; cc < BK; ++cc) {
      const float p = pr[cc];
      const float* vr = sV + cc * LD + half;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
    }
  }
  if (row_ok) {
    const float denom = fmaxf(l_run, 1e-30f);
    float* op = out + ((size_t)(b * Nq + qi) * Hq + h) * HD + half;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[2 * i] = acc[i] / denom;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v,
           const float* log_g, const int* col_lo, const int* col_hi,
           const int* row_pos, float* out, int B, int Nq, int M, int Hq,
           int Hkv, int rep, int P, int causal, int prefix_len,
           int has_window, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BK * (HD + 1) + BQ * (BK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      prism_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nq + BQ - 1) / BQ, Hq, B);
  prism_attention_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, log_g, col_lo, col_hi, row_pos, out, Nq, M, Hq, Hkv, rep, P,
      causal, prefix_len, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prism_attention_f32(
    const void* q, const void* k, const void* v, const void* log_g,
    const void* col_lo, const void* col_hi, const void* row_pos, void* out,
    int B, int Nq, int M, int Hq, int Hkv, int hd, int rep, int P,
    int causal, int prefix_len, int has_window, int window, float scale,
    void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lg = static_cast<const float*>(log_g);
  const auto* lo = static_cast<const int*>(col_lo);
  const auto* hi = static_cast<const int*>(col_hi);
  const auto* rp = static_cast<const int*>(row_pos);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // one head dim per ported model (GPT-2: 64); each instantiation is
  // fully unrolled and lengthens the build
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return launch<64>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv, rep, P,
                    causal, prefix_len, has_window, window, scale, st);
}
