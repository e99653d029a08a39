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
// What bounds it on an H100.  On GPT-2 small's path (B = 8,
// P = 4) a PRISM layer (Nq = 128, M = 256) moves 75 MB and needs
// 1.4 GFLOP for its visible pairs; a Voltage layer (M = 512) moves 50 MB
// and needs 3.2 GFLOP.  At 3.35 TB/s and at the tensor cores' rate for
// f32-accurate products in 3xTF32 (495 TFLOP/s TF32 over three, 165)
// that is 22 us bytes-bound for PRISM and 20 us operations-bound for
// Voltage.  Scalar f32 FMAs fed from shared memory (one shared load per
// FMA) ran 14x and 29x above that bound.  This design runs 3x and 6x
// above it (chip_smoke.py, H100); the likely limits are mma.sync's issue
// rate (three per product, fragments loaded by every warp) and the
// operand splits.
//
// Design:
// - Tensor cores in 3xTF32.  QK^T and PV run as mma.sync m16n8k8 with
//   TF32 operands: each f32 operand x is split into hi = tf32(x) and
//   lo = x - hi, and a product is lo*hi + hi*lo + hi*hi with f32
//   accumulation.  That keeps the error at the level of f32 FMA (single-
//   pass TF32 does not meet the kernel-vs-plain tolerance).
// - FlashAttention-2 layout: one block of 4 warps per (64-row query
//   tile, query head, batch row); each warp owns 16 query rows.  The
//   scores, the online softmax (m, l) and the output accumulator stay in
//   registers; Q's hi/lo A fragments are split once and parked in shared
//   memory in fragment order (each thread reads back only its own), which
//   keeps the kernel at 148 registers, three blocks per SM at head dim 64.
//   K's rows are read in a permuted order inside each 8-column group
//   (column 2i <- i, 2i + 1 <- i + 4), so the score accumulator of QK^T
//   already is the A fragment of PV: no shuffle or shared-memory round
//   trip for P.
//   K and V tiles have padded row strides (HD + 4 and HD + 8 floats) so
//   that every fragment load is free of bank conflicts.
// - Head dims 64 (GPT-2) and 128 (the Llama family: Yi-6B).  At 128 the
//   output accumulator doubles to 64 registers a thread and shared memory
//   grows to 133 KB a block (a two-stage ring of 32 x (132 + 136) floats
//   and 64 KB of Q fragments), one block an SM: the kernel is built for
//   one block an SM there, so it may take up to 255 registers (it takes
//   195, no spills).  QK^T's 16 k-steps run as two chains of 8, each in
//   its own accumulator, added in f32: the tensor core truncates as it
//   accumulates, and one chain of 48 products would double the error of
//   hd 64's 24.  At Yi-6B's shapes (B 8, P 4, 32 query heads over 4 KV
//   heads) a PRISM layer is bound by its 168 MB (0.050 ms) and a Voltage
//   layer by 17 GFLOP (0.104 ms); this runs 6.9x and 5.9x above that,
//   1.4-1.5x faster than SDPA (chip_smoke.py, H100).
// - Head dim 32 (the accuracy protocol's char-LM: 4 heads of 32).  The
//   hd-64 layout at KS = 4 k-steps, one QK^T chain; strides 36 and 40
//   floats give hd 64's banks (4g + t for K, 8t + g for V); built for
//   three blocks an SM, as hd 64.  Head dim 16 (the reference's test
//   grid; no ported model has it) is the same at KS = 2.
// - bf16 inputs take prism_attention_bf16.cu, a library of its own.
// - Head dim 80 (Zamba2 2.7B: 32 heads, MHA).  The hd-128 layout with
//   KS = 10 k-steps: QK^T runs as a chain of 8 and one of 2, each in its
//   own accumulator; strides 84 and 88 floats keep the fragment loads
//   conflict-free (banks 20g + t for K, 24t + g for V, distinct over a
//   warp).  About 85 KB of shared memory a block (a two-stage ring of
//   32 x (84 + 88) floats and 40 KB of Q's parts); built for one block
//   an SM, as hd 128.
// - Head dim 256 (Gemma 3 1B: 4 query heads over 1 KV head).  Neither
//   the hd-128 tile nor its accumulator fits there: two ring stages of
//   32 x (260 + 264) floats and 128 KB of Q's parked parts are 263 KB
//   of shared memory, and the output accumulator would be 128 floats a
//   lane.  So a block computes half of the output dims (128 of 256; two
//   blocks per query tile, each computing QK^T over all 256 dims) and
//   keeps Q once in f32, split into its TF32 parts where it is used
//   (mma_tf32.cuh, qk_3xtf32_f32q): the V tile holds the block's half,
//   shared memory is 2 x 32 x (260 + 136 + 3) floats plus 64 KB of Q,
//   166 KB a block, and the accumulator stays at hd 128's 64 floats.  QK^T
//   is computed twice (a third more tensor-core work than one pass);
//   that is the price of the fit, for a later PR to remove.  Its 32
//   k-steps run as four chains of 8, each from zero, added in f32 in
//   order.  A local (sliding-window) layer's query tile sees at most
//   W + 63 of its columns: the tile skip below drops every whole tile
//   before the window, and halo columns before position 0 come with
//   log g = -1e30.
// - Exact tile skipping.  Before the loop the block scans all column
//   metadata once and keeps the 32-column tiles in which some column
//   is live (log g > -1e30 / 2) and could be visible to a row position
//   of its query tile, from the tile's own min / max test per column
//   (the PRISM means columns are not sorted by position).  Only those
//   tiles are loaded and computed; inside them the mask is per pair.
//   32 columns, not 64: a shard's own (dead) means fill a tile of their
//   own, and the narrower score tile frees registers.
// - Pipelined loads.  K/V tiles and their metadata come in with 16-byte
//   (metadata 4-byte) cp.async into a two-stage ring in shared memory;
//   the next live tile's copy is in flight while this one is computed.
//   The ragged M edge is zero-filled by the copy and masked per pair.
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "prism_tiles.cuh"

namespace {

using prism::NEG;
using prism::visible;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BK = 32;          // K/V columns per tile
constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;     // threads per block
constexpr int STAGES = 2;       // cp.async ring depth

// output dims a block computes: all of them up to head dim 128, half of
// them at 256 (two blocks a query tile)
__host__ __device__ constexpr int out_dims(int hd) {
  return hd <= 128 ? hd : 128;
}
// whether Q is parked as TF32 hi / lo parts (up to 128) or in f32 and
// split where it is used (256)
__host__ __device__ constexpr bool q_parts(int hd) { return hd <= 128; }

// one ring stage, in floats: K and V tiles, then log g, lo, hi per column
template <int HD>
struct Smem {
  static constexpr int LDK = HD + 4;  // padded row strides (floats):
  static constexpr int LDV = out_dims(HD) + 8;  // conflict-free loads
  static constexpr int K = 0;
  static constexpr int V = K + BK * LDK;
  static constexpr int LG = V + BK * LDV;
  static constexpr int LO = LG + BK;
  static constexpr int HI = LO + BK;
  static constexpr int STAGE = HI + BK;        // floats per stage
};

using namespace tc;   // 3xTF32 mma.sync and cp.async (mma_tf32.cuh)

// blocks an SM the kernel is built for: three at head dims 16, 32 and 64;
// one at 80, 128 and 256, whose shared memory admits no second
constexpr int min_blocks(int hd) { return hd <= 64 ? 3 : 1; }

template <int HD>
__global__ void __launch_bounds__(NT, min_blocks(HD)) prism_attention_kernel(
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
  static_assert(HD % 8 == 0 && HD <= 256, "head dim");
  using S = Smem<HD>;
  constexpr int LDK = S::LDK, LDV = S::LDV;
  constexpr int KS = HD / 8;            // k-steps of QK^T
  constexpr int DV = out_dims(HD);      // output dims of this block
  constexpr int NSPLIT = HD / DV;       // blocks a query tile
  constexpr int KV = DV / 8;            // n-tiles of PV
  constexpr bool QP = q_parts(HD);
  constexpr int NJ = BK / 8;            // n-tiles of QK^T; k-steps of PV
  extern __shared__ __align__(16) float smem[];
  // Q kept per thread in its mma A-fragment order: TF32 parts, or f32
  uint4* s_q = reinterpret_cast<uint4*>(smem + STAGES * S::STAGE);
  int* s_tiles = reinterpret_cast<int*>(s_q + NW * KS * (QP ? 2 : 1) * 32);
  __shared__ int s_int[3];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (blockIdx.x / NSPLIT) * BQ;
  const int d0 = (blockIdx.x % NSPLIT) * DV;   // the block's output dims
  const int kvh = h / (Hq / Hkv);
  const int bk = b / rep;
  const int pm = b % P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread-in-group

  // ---- this warp's Q rows g and g + 8: loads issued first, split later
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Nq, ok1 = r1 < Nq;
  const float* qp0 = q + ((size_t)(b * Nq + (ok0 ? r0 : 0)) * Hq + h) * HD;
  const float* qp1 = q + ((size_t)(b * Nq + (ok1 ? r1 : 0)) * Hq + h) * HD;
  float qf[QP ? KS : 1][4];
  if constexpr (QP) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = ok0 ? qp0[ks * 8 + t] : 0.f;
      qf[ks][1] = ok1 ? qp1[ks * 8 + t] : 0.f;
      qf[ks][2] = ok0 ? qp0[ks * 8 + t + 4] : 0.f;
      qf[ks][3] = ok1 ? qp1[ks * 8 + t + 4] : 0.f;
    }
  }
  const int rp0 = ok0 ? row_pos[pm * Nq + r0] : INT_MIN;
  const int rp1 = ok1 ? row_pos[pm * Nq + r1] : INT_MIN;

  // ---- which tiles can any row of this query tile see? ----------------
  const int nlive = prism::live_tiles<BQ, BK, NT>(
      log_g, col_lo, col_hi, row_pos, pm, q0, Nq, M, causal, prefix_len,
      has_window, window, s_tiles, s_int);

  auto load_tile = [&](int tile, int stage) {
    float* st = smem + stage * S::STAGE;
    const int c0 = tile * BK;
    // K whole, V's dims [d0, d0 + DV): all of them below head dim 256
    for (int i = tid; i < BK * HD / 4; i += NT) {
      const int cc = i / (HD / 4), d4 = (i % (HD / 4)) * 4;
      const int c = c0 + cc;
      const bool ok = c < M;
      const size_t off =
          ((size_t)(bk * M + (ok ? c : 0)) * Hkv + kvh) * HD + d4;
      cp_async16(st + S::K + cc * LDK + d4, k + off, ok);
      if (DV == HD) cp_async16(st + S::V + cc * LDV + d4, v + off, ok);
    }
    for (int i = tid; DV < HD && i < BK * DV / 4; i += NT) {
      const int cc = i / (DV / 4), d4 = (i % (DV / 4)) * 4;
      const int c = c0 + cc;
      const bool ok = c < M;
      const size_t off =
          ((size_t)(bk * M + (ok ? c : 0)) * Hkv + kvh) * HD + d0 + d4;
      cp_async16(st + S::V + cc * LDV + d4, v + off, ok);
    }
    if (tid < BK) {
      const int c = c0 + tid;
      const bool ok = c < M;
      const int o = pm * M + (ok ? c : 0);
      cp_async4(st + S::LG + tid, log_g + o, ok);
      cp_async4(st + S::LO + tid, col_lo + o, ok);
      cp_async4(st + S::HI + tid, col_hi + o, ok);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nlive) load_tile(s_tiles[s], s);
    cp_async_commit();
  }

  // Q's TF32 parts for all tiles (A fragments: rows g / g + 8, dims t
  // and t + 4 of each 8-dim k-step), parked in shared memory
  uint4* my_q = s_q + warp * KS * (QP ? 2 : 1) * 32 + lane;
  float4* my_qf = reinterpret_cast<float4*>(my_q);
  if constexpr (QP) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qh[4], ql[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qf[ks][e], qh[e], ql[e]);
      my_q[(2 * ks) * 32] = make_uint4(qh[0], qh[1], qh[2], qh[3]);
      my_q[(2 * ks + 1) * 32] = make_uint4(ql[0], ql[1], ql[2], ql[3]);
    }
  } else {                              // f32, in the same order
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks)
      my_qf[ks * 32] = make_float4(ok0 ? qp0[ks * 8 + t] : 0.f,
                                   ok1 ? qp1[ks * 8 + t] : 0.f,
                                   ok0 ? qp0[ks * 8 + t + 4] : 0.f,
                                   ok1 ? qp1[ks * 8 + t + 4] : 0.f);
  }

  // online softmax state in the log2 domain; l is this thread's partial
  // sum over its columns (the quad is reduced once, at the end)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[KV][4];
#pragma unroll
  for (int j = 0; j < KV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < nlive; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile `it` landed; `it - 1` consumed
    {
      const int nxt = it + STAGES - 1;
      if (nxt < nlive) load_tile(s_tiles[nxt], nxt % STAGES);
      cp_async_commit();
    }
    const float* st = smem + (it % STAGES) * S::STAGE;
    const float* sK = st + S::K;
    const float* sV = st + S::V;
    const float* sLg = st + S::LG;
    const int* sLo = reinterpret_cast<const int*>(st + S::LO);
    const int* sHi = reinterpret_cast<const int*>(st + S::HI);
    const int c0 = s_tiles[it] * BK;

    // S = Q K^T; n-tile j, accumulator entry e holds column
    // j*8 + t + 4*(e & 1) of row g + 8*(e >> 1)
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (KS <= QK_CHAIN) {
      qk_3xtf32<0, KS, NJ, LDK>(sc, my_q, sK, g, t);
    } else if constexpr (!QP) {         // four chains from f32 Q
      static_assert(KS == 4 * QK_CHAIN, "head dim");
#pragma unroll
      for (int c = 0; c < KS / QK_CHAIN; ++c) {
        float part[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
        qk_3xtf32_f32q<QK_CHAIN, NJ, LDK>(part, my_qf + c * QK_CHAIN * 32,
                                          sK + c * QK_CHAIN * 8, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
      }
    } else {                            // two chains, added in f32
      // hd 128: 8 + 8 k-steps; hd 80: 8 + 2
      static_assert(KS <= 2 * QK_CHAIN, "head dim");
      float part[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      qk_3xtf32<0, QK_CHAIN, NJ, LDK>(sc, my_q, sK, g, t);
      qk_3xtf32<QK_CHAIN, KS, NJ, LDK>(part, my_q, sK, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
    }

    // mask, bias, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = j * 8 + t + 4 * u;
        const bool col_ok = c0 + cc < M && sLg[cc] > NEG * 0.5f;
        const int lo = sLo[cc], hi = sHi[cc];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int rp = rr ? rp1 : rp0;
          const bool vis = col_ok && (rr ? ok1 : ok0) &&
                           visible(lo, hi, rp, causal, prefix_len,
                                   has_window, window);
          const float x = fmaf(sc[j][2 * rr + u], scale, sLg[cc]) * LOG2E;
          sc[j][2 * rr + u] = vis ? x : -INFINITY;
          mx[rr] = fmaxf(mx[rr], sc[j][2 * rr + u]);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_run[rr], mx[rr]);
      // a row with nothing visible yet keeps m = -inf: subtract 0 so
      // exp2 gives 0, never inf - inf
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[rr] = exp2f(m_run[rr] - m_use);
      m_run[rr] = m_new;
      mx[rr] = m_use;
      l_run[rr] *= corr[rr];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < KV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

    // O += P V; the score accumulator of n-tile ks is P's A fragment
#pragma unroll
    for (int ks = 0; ks < NJ; ++ks) {
      uint32_t ph[4], pl[4];
      split(sc[ks][0], ph[0], pl[0]);
      split(sc[ks][2], ph[1], pl[1]);
      split(sc[ks][1], ph[2], pl[2]);
      split(sc[ks][3], ph[3], pl[3]);
      const float* v0 = sV + (ks * 8 + t) * LDV + g;
      const float* v1 = v0 + 4 * LDV;
#pragma unroll
      for (int j = 0; j < KV; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(v0[j * 8], bh0, bl0);
        split(v1[j * 8], bh1, bl1);
        mma_3xtf32(o[j], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
  cp_async_wait<0>();

  // normalise and store: entry e of n-tile j is dim j*8 + 2t + (e & 1)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = rr ? r1 : r0;
    if (r < Nq) {
      float* op = out + ((size_t)(b * Nq + r) * Hq + h) * HD + d0 + 2 * t;
#pragma unroll
      for (int j = 0; j < KV; ++j)
        *reinterpret_cast<float2*>(op + j * 8) =
            make_float2(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v,
           const float* log_g, const int* col_lo, const int* col_hi,
           const int* row_pos, float* out, int B, int Nq, int M, int Hq,
           int Hkv, int rep, int P, int causal, int prefix_len,
           int has_window, int window, float scale, cudaStream_t stream) {
  const int ntiles = (M + BK - 1) / BK;
  const size_t smem =
      sizeof(float) * STAGES * Smem<HD>::STAGE +
      sizeof(uint4) * NW * (HD / 8) * (q_parts(HD) ? 2 : 1) * 32 +
      sizeof(int) * ntiles;
  cudaError_t e = cudaFuncSetAttribute(
      prism_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nq + BQ - 1) / BQ * (HD / out_dims(HD)), Hq, B);
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
  // one head dim per ported model family (the accuracy protocol's
  // char-LM: 32; GPT-2: 64; Zamba2 2.7B: 80; Llama, Yi-6B: 128; Gemma 3
  // 1B: 256) and the reference's test grid's 16
  switch (hd) {
    case 16:
      return launch<16>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                        rep, P, causal, prefix_len, has_window, window,
                        scale, st);
    case 32:
      return launch<32>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                        rep, P, causal, prefix_len, has_window, window,
                        scale, st);
    case 64:
      return launch<64>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                        rep, P, causal, prefix_len, has_window, window,
                        scale, st);
    case 80:
      return launch<80>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                        rep, P, causal, prefix_len, has_window, window,
                        scale, st);
    case 128:
      return launch<128>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                         rep, P, causal, prefix_len, has_window, window,
                         scale, st);
    case 256:
      return launch<256>(qf, kf, vf, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv,
                         rep, P, causal, prefix_len, has_window, window,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
