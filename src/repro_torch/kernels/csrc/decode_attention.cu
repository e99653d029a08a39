// Single-token flash-decode partial softmax stats, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (flash_decode_stats, body _decode_kernel).
//
// What it computes: for each batch row and query head, the partial
// softmax stats (m, l, acc) of one decode query over a local KV-cache
// shard: columns masked per row by `valid`, then, in prism mode, the
// Segment-Means columns kz / vz with a per-row +log g bias (log g = -1e30
// marks a dead column).  A row with no live column gives (-1e30, 0, 0).
// The stats are not normalized: the caller combines them across shards
// (exact mode) or normalizes per shard and selects the owner (prism).
// The shard axis is folded into the batch: output row b reads query row
// b / rep, its own `valid` and log g rows, and the cache shard
// r * rep + b % rep and means row r of its cache row r, where r is
// rows[b / rep] when a row map is given (a packed tick: tokens of one
// slot share its cache row; the wrapper clamps the map) and b / rep
// otherwise.  The map replaces a gather of each token's cache row.
//
// What bounds it on an H100: memory.  Each live cache column is read
// once and used for a handful of FMAs per query head, so the floor is
// the live K/V bytes over the 3.35 TB/s HBM rate (about 35 MB per layer
// on the main path in prism mode: B = 8, 4 shards of 144 columns plus
// 128 means, 12 heads of 64, f32).  One block per (row, KV head) gave
// 384 blocks that each streamed up to 5 tiles with 4-byte loads and no
// load in flight during compute, with one warp of four computing.
//
// Two routes; the wrapper (kernels/decode_attention.py, decode_route)
// picks one by a fixed rule: the tile route below for a group of at
// least 4 query heads a KV head (the measured crossover) and no row
// map, the row route for the rest (one token a row, packed tokens
// through the row map).
//
// The row route (decode_stats_kernel): one block of 4 warps per (row, KV
// head, tile of up to 32 query heads of its group), so the main path
// runs 12 x 32 blocks in both modes, about three per SM.  Each warp
// takes 16 columns per pass, two at a time: a half-warp holds one
// 64-float K or V row as 16 float4s.  A warp first reads its columns'
// `valid` / log g, then issues the 16-byte K and V loads of every live
// column of the pass at once into registers, so 8 KB per warp are in
// flight; a dead column (`valid` false or log g <= -1e30 / 2) is never
// loaded.  Every warp then computes the scores of the tile's query heads
// over its columns, keeping a running (m, l, acc) per head in shared
// memory, and the four warps' partials are merged in warp order:
// deterministic, one launch per call.  A warp that met no live column
// holds (-inf, 0, 0) and drops out of the merge.  A group of more than
// 32 heads takes more blocks, each of which reads the KV head's columns
// again (from L2), so any group size launches with at most 35 KB of
// shared memory.
//
// Splitting a row's columns over a cluster of up to 4 blocks, merged over
// distributed shared memory, was measured 13% slower at the main path's
// shape (chip_smoke.py's decode times, H100): 384 blocks already fill
// the card, and the split adds a cluster barrier and a merge.
//
// The tile route (decode_stats_mq_kernel), for many queries a KV head.
// The chunked prefill folds a chunk of C = 64 queries into the head
// axis, so 64 query heads share every K/V row of a KV head.  There the
// row route runs 15-16x its bound: every score costs four FMAs and four
// warp shuffles on the f32 cores, 32 heads' partials are rescaled in
// shared memory per 16-column pass, and two 32-head blocks read each K/V
// row.  What the work is there: a small matrix product, 64 queries x 64
// dims x up to 144 columns per (row, KV head), bound by bytes (the live
// K/V once: 0.009 ms at a 448-token offset, 30 MB; its operations take
// 0.004 ms at the tensor cores' f32-accurate rate).  Design:
// - One block of 4 warps per (output row, KV head, tile of 64 query
//   heads of the group); each warp owns 16 query heads.  The chunk
//   layout runs 32 x 12 x 1 = 384 blocks, so each K/V row is read from
//   device memory once.  A group that is not a multiple of 64 leaves a
//   ragged last tile: its rows have zero queries and are not written; a
//   warp with no row skips the products.
// - S = Q K^T and acc += P V on the tensor cores in 3xTF32 (mma.sync
//   m16n8k8, mma_tf32.cuh): f32 accuracy, as prism_attention.cu.  Q's
//   TF32 parts are split once per block and parked in shared memory in
//   A-fragment order; K's rows are read permuted inside each 8-column
//   group so that the score accumulator is PV's A fragment.  (m, l,
//   acc) of each query row stay in registers, in the log2 domain, and
//   are rescaled once per 32-column tile.  The tensor core truncates as
//   it accumulates, so each tile's P V gets an accumulator of its own,
//   added to acc in f32: one chain over every tile missed the decode
//   tolerance on the card (2.1e-5 at 144 columns).
// - `valid` and log g are per output row, shared by every query of the
//   block: the block reads its row's once, keeps each column's bias in
//   shared memory (-inf for a dead column), and skips every 32-column
//   tile with no live column (exact).  Local tiles come first, then
//   the means tiles.  The live tiles stream through a two-stage
//   cp.async ring with padded strides (68 and 72 floats: conflict-free
//   fragment loads); a dead or out-of-range column is zero-filled by
//   the copy, never read, and masked.
// - A row with no live column, even one whose every tile was skipped,
//   gives (-1e30, 0, 0).  One block owns each output element: no
//   atomics, deterministic.
// - 167 registers, no spills; 69 KB of dynamic shared memory at the
//   chunk layout (the limit is raised once per process), three blocks
//   an SM, so the 384 blocks run in one wave.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.0225 ms at
// the chunk layout, 2.5x its bound and 6.1x faster than the row route
// there; 0.017 ms for any group up to 16 (the latency of a block's two
// dependent round trips, `valid` then the K/V tiles, and of streaming
// four tiles through a two-stage ring: group 16 computes a quarter of
// group 64's products in 76% of its time).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int NW = 4;               // warps per block
constexpr int NT = 32 * NW;         // threads per block
constexpr int WCOLS = 16;           // columns per warp per pass
constexpr int UNIT = NW * WCOLS;    // columns per block per pass
constexpr int GMAX = 32;            // query heads per block
// the tile route
constexpr int MQ_ROWS = 16 * NW;    // query heads per block, 16 per warp
constexpr int MQ_BK = 32;           // K/V columns per tile
constexpr int MQ_STAGES = 2;        // cp.async ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using namespace tc;   // 3xTF32 mma.sync and cp.async (mma_tf32.cuh)

template <int HD>
__global__ void __launch_bounds__(NT) decode_stats_kernel(
    const float* __restrict__ q,        // (B / rep, Hq, HD)
    const float* __restrict__ k,        // (R * rep, M, Hkv, HD)
    const float* __restrict__ v,        // (R * rep, M, Hkv, HD)
    const uint8_t* __restrict__ valid,  // (B, M)
    const float* __restrict__ log_gz,   // (B, MZ) or null
    const float* __restrict__ kz,       // (R, MZ, Hkv, HD) or null
    const float* __restrict__ vz,       // (R, MZ, Hkv, HD) or null
    const int* __restrict__ rows,       // (B / rep) cache row map or null
    float* __restrict__ m_out,          // (B, Hq)
    float* __restrict__ l_out,          // (B, Hq)
    float* __restrict__ acc_out,        // (B, Hq, HD)
    int M, int MZ, int Hq, int Hkv, int rep, float scale) {
  // a half-warp holds one row as 16 float4s
  static_assert(HD == 64, "decode kernel is laid out for head dim 64");
  constexpr int LP = HD + 4;            // partial: acc[HD], m, l, pad
  constexpr int NP = HD + 2;            // the used part of a partial
  const int grp = Hq / Hkv;
  const int g0 = blockIdx.x * GMAX;     // this block's heads of the group
  const int gt = min(GMAX, grp - g0);
  extern __shared__ __align__(16) float sPart[];  // NW x gt partials

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int bq = b / rep;
  const int r = rows != nullptr ? rows[bq] : bq;   // the cache row
  const int bk = r * rep + (b - bq * rep);         // its shard's row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int n_cols = M + (kz != nullptr ? MZ : 0);
  const int h0 = kvh * grp + g0;        // the block's first query head

  const float4* qg =                    // the block's query rows
      reinterpret_cast<const float4*>(q + ((size_t)bq * Hq + h0) * HD);
  for (int i = lane; i < gt * LP; i += 32)    // this warp's partials
    sPart[warp * gt * LP + i] = (i % LP) == HD ? -INFINITY : 0.f;
  __syncwarp();

  for (int base = warp * WCOLS; base < n_cols; base += UNIT) {
    // this pass: columns base + 2i + half, i < 8
    bool live[WCOLS / 2];
    float bias[WCOLS / 2];
#pragma unroll
    for (int i = 0; i < WCOLS / 2; ++i) {
      const int c = base + 2 * i + half;
      live[i] = false;
      bias[i] = 0.f;
      if (c < n_cols) {
        if (c < M) {
          live[i] = valid[(size_t)b * M + c] != 0;
        } else {
          bias[i] = log_gz[(size_t)b * MZ + (c - M)];
          live[i] = bias[i] > NEG * 0.5f;
        }
      }
    }
    float4 kr[WCOLS / 2], vr[WCOLS / 2];
#pragma unroll
    for (int i = 0; i < WCOLS / 2; ++i) {
      const int c = base + 2 * i + half;
      kr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[i] = kr[i];
      if (live[i]) {
        const size_t off =
            c < M ? ((size_t)(bk * M + c) * Hkv + kvh) * HD
                  : ((size_t)(r * MZ + (c - M)) * Hkv + kvh) * HD;
        const float* ks = (c < M ? k : kz) + off;
        const float* vs = (c < M ? v : vz) + off;
        kr[i] = __ldg(reinterpret_cast<const float4*>(ks) + hl);
        vr[i] = __ldg(reinterpret_cast<const float4*>(vs) + hl);
      }
    }
    for (int g = 0; g < gt; ++g) {
      const float4 q4 = __ldg(qg + g * (HD / 4) + hl);
      float s[WCOLS / 2];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < WCOLS / 2; ++i) {
        float d = q4.x * kr[i].x;
        d = fmaf(q4.y, kr[i].y, d);
        d = fmaf(q4.z, kr[i].z, d);
        d = fmaf(q4.w, kr[i].w, d);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[i] = live[i] ? fmaf(d, scale, bias[i]) : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      float* part = sPart + (warp * gt + g) * LP;
      const float m_prev = part[HD];
      const float m_new = fmaxf(m_prev, mx);
      // nothing live yet: subtract 0, so exp gives 0 and never inf - inf
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m_prev - m_use);
      float ps = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < WCOLS / 2; ++i) {
        const float p = expf(s[i] - m_use);
        ps += p;
        a.x = fmaf(p, vr[i].x, a.x);
        a.y = fmaf(p, vr[i].y, a.y);
        a.z = fmaf(p, vr[i].z, a.z);
        a.w = fmaf(p, vr[i].w, a.w);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      a.x += __shfl_xor_sync(0xffffffffu, a.x, 16);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, 16);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, 16);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, 16);
      const float l_prev = part[HD + 1];
      __syncwarp();                     // every lane has read m, l
      if (half == 0) {
        float4* acc = reinterpret_cast<float4*>(part) + hl;
        float4 r = *acc;
        r.x = fmaf(r.x, corr, a.x);
        r.y = fmaf(r.y, corr, a.y);
        r.z = fmaf(r.z, corr, a.z);
        r.w = fmaf(r.w, corr, a.w);
        *acc = r;
      }
      if (lane == 0) {
        part[HD] = m_new;
        part[HD + 1] = fmaf(l_prev, corr, ps);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' partials in warp order
  for (int i = tid; i < gt * NP; i += NT) {
    const int g = i / NP, d = i % NP;
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      mw = fmaxf(mw, sPart[(w * gt + g) * LP + HD]);
    const int h = h0 + g;
    if (d == HD) {
      m_out[(size_t)b * Hq + h] = mw == -INFINITY ? NEG : mw;
      continue;
    }
    const float m_use = mw == -INFINITY ? 0.f : mw;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* pw = sPart + (w * gt + g) * LP;
      x = fmaf(pw[d], expf(pw[HD] - m_use), x);
    }
    if (d == HD + 1)
      l_out[(size_t)b * Hq + h] = x;
    else
      acc_out[((size_t)b * Hq + h) * HD + d] = x;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v,
           const uint8_t* valid, const float* log_gz, const float* kz,
           const float* vz, const int* rows, float* m_out, float* l_out,
           float* acc_out, int B, int M, int MZ, int Hq, int Hkv, int rep,
           float scale, cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const size_t smem = sizeof(float) * NW * min(grp, GMAX) * (HD + 4);
  const dim3 grid((grp + GMAX - 1) / GMAX, Hkv, B);
  decode_stats_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, rows, m_out, l_out, acc_out, M, MZ,
      Hq, Hkv, rep, scale);
  return (int)cudaGetLastError();
}

// floats of one ring stage of the tile route: a K and a V tile
template <int HD>
__host__ __device__ constexpr int mq_stage() {
  return MQ_BK * ((HD + 4) + (HD + 8));
}

template <int HD>
__global__ void __launch_bounds__(NT, 3) decode_stats_mq_kernel(
    const float* __restrict__ q,        // (B / rep, Hq, HD)
    const float* __restrict__ k,        // (B, M, Hkv, HD)
    const float* __restrict__ v,        // (B, M, Hkv, HD)
    const uint8_t* __restrict__ valid,  // (B, M)
    const float* __restrict__ log_gz,   // (B, MZ) or null
    const float* __restrict__ kz,       // (B / rep, MZ, Hkv, HD) or null
    const float* __restrict__ vz,       // (B / rep, MZ, Hkv, HD) or null
    float* __restrict__ m_out,          // (B, Hq)
    float* __restrict__ l_out,          // (B, Hq)
    float* __restrict__ acc_out,        // (B, Hq, HD)
    int M, int MZ, int Hq, int Hkv, int rep, float scale) {
  static_assert(HD % 8 == 0 && HD <= 128, "head dim");
  constexpr int KS = HD / 8;            // k-steps of QK^T; n-tiles of PV
  constexpr int NJ = MQ_BK / 8;         // n-tiles of QK^T; k-steps of PV
  constexpr int LDK = HD + 4;           // padded row strides (floats)
  constexpr int LDV = HD + 8;
  constexpr int STAGE = mq_stage<HD>();
  extern __shared__ __align__(16) float smem[];
  // after the ring: Q's TF32 parts in A-fragment order, each column's
  // bias (log2 domain, -inf = dead), then the live tiles' indices
  uint4* s_q = reinterpret_cast<uint4*>(smem + MQ_STAGES * STAGE);
  float* s_bias = reinterpret_cast<float*>(s_q + NW * KS * 2 * 32);
  const int mz = kz != nullptr ? MZ : 0;
  const int nlt = (M + MQ_BK - 1) / MQ_BK;            // local tiles
  const int ntiles = nlt + (mz + MQ_BK - 1) / MQ_BK;  // then means tiles
  int* s_tiles = reinterpret_cast<int*>(s_bias + ntiles * MQ_BK);
  __shared__ int s_nlive;

  const int grp = Hq / Hkv;
  const int g0 = blockIdx.x * MQ_ROWS;  // the block's heads of the group
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int bq = b / rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread-in-group

  // ---- this warp's query rows g and g + 8: loads issued first --------
  const int r0 = g0 + warp * 16 + g, r1 = r0 + 8;   // heads of the group
  const bool ok0 = r0 < grp, ok1 = r1 < grp;
  const bool warp_live = g0 + warp * 16 < grp;      // warp-uniform
  float qf[KS][4];
  {
    const float* p0 = q + ((size_t)bq * Hq + kvh * grp + r0) * HD;
    const float* p1 = p0 + 8 * HD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = ok0 ? p0[ks * 8 + t] : 0.f;
      qf[ks][1] = ok1 ? p1[ks * 8 + t] : 0.f;
      qf[ks][2] = ok0 ? p0[ks * 8 + t + 4] : 0.f;
      qf[ks][3] = ok1 ? p1[ks * 8 + t + 4] : 0.f;
    }
  }

  // ---- the row's columns: bias per column, which tiles are live ------
  for (int i = tid; i < ntiles; i += NT) s_tiles[i] = 0;
  __syncthreads();
  for (int i = tid; i < ntiles * MQ_BK; i += NT) {
    const int ti = i / MQ_BK;
    float bias = -INFINITY;
    if (ti < nlt) {
      const int c = i;                  // local tiles start at column 0
      if (c < M && valid[(size_t)b * M + c]) bias = 0.f;
    } else {
      const int c = i - nlt * MQ_BK;
      if (c < mz) {
        const float lg = log_gz[(size_t)b * MZ + c];
        if (lg > NEG * 0.5f) bias = lg * LOG2E;
      }
    }
    s_bias[i] = bias;
    if (bias != -INFINITY) s_tiles[ti] = 1;
  }
  __syncthreads();
  if (warp == 0) {                      // compact the live tiles in order
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool live = i < ntiles && s_tiles[i] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) s_tiles[n + __popc(bal & ((1u << lane) - 1u))] = i;
      n += __popc(bal);
    }
    if (lane == 0) s_nlive = n;
  }
  __syncthreads();
  const int nlive = s_nlive;

  // a tile's K and V rows; a dead or out-of-range column is zero-filled
  auto load_tile = [&](int ti, int stage) {
    float* sK = smem + stage * STAGE;
    float* sV = sK + MQ_BK * LDK;
    const bool local = ti < nlt;
    const int c0 = (local ? ti : ti - nlt) * MQ_BK;
    const size_t row0 = local ? (size_t)b * M : (size_t)bq * MZ;
    const float* kb = local ? k : kz;
    const float* vb = local ? v : vz;
    for (int i = tid; i < MQ_BK * HD / 4; i += NT) {
      const int cc = i / (HD / 4), d4 = (i % (HD / 4)) * 4;
      const bool ok = s_bias[ti * MQ_BK + cc] != -INFINITY;
      const size_t off =
          ((row0 + (ok ? c0 + cc : 0)) * Hkv + kvh) * HD + d4;
      cp_async16(sK + cc * LDK + d4, kb + off, ok);
      cp_async16(sV + cc * LDV + d4, vb + off, ok);
    }
  };

  for (int s = 0; s < MQ_STAGES - 1; ++s) {
    if (s < nlive) load_tile(s_tiles[s], s);
    cp_async_commit();
  }

  // Q's TF32 parts for all tiles (A fragments: rows g / g + 8, dims t
  // and t + 4 of each 8-dim k-step), parked in shared memory
  uint4* my_q = s_q + warp * KS * 2 * 32 + lane;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qh[4], ql[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(qf[ks][e], qh[e], ql[e]);
    my_q[(2 * ks) * 32] = make_uint4(qh[0], qh[1], qh[2], qh[3]);
    my_q[(2 * ks + 1) * 32] = make_uint4(ql[0], ql[1], ql[2], ql[3]);
  }

  // online softmax state in the log2 domain; l is this thread's partial
  // sum over its columns (the quad is reduced once, at the end)
  const float scale2 = scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < nlive; ++it) {
    cp_async_wait<MQ_STAGES - 2>();
    __syncthreads();                    // tile `it` landed; `it - 1` consumed
    {
      const int nxt = it + MQ_STAGES - 1;
      if (nxt < nlive) load_tile(s_tiles[nxt], nxt % MQ_STAGES);
      cp_async_commit();
    }
    if (!warp_live) continue;           // no query row: only the copies
    const float* sK = smem + (it % MQ_STAGES) * STAGE;
    const float* sV = sK + MQ_BK * LDK;
    const float* sB = s_bias + s_tiles[it] * MQ_BK;

    // S = Q K^T; n-tile j, accumulator entry e holds column
    // j*8 + t + 4*(e & 1) of row g + 8*(e >> 1)
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint4 h4 = my_q[(2 * ks) * 32], l4 = my_q[(2 * ks + 1) * 32];
      const uint32_t qh[4] = {h4.x, h4.y, h4.z, h4.w};
      const uint32_t ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kr = sK + (j * 8 + (g >> 1) + (g & 1) * 4) * LDK + ks * 8;
        uint32_t bh0, bl0, bh1, bl1;
        split(kr[t], bh0, bl0);
        split(kr[t + 4], bh1, bl1);
        mma_3xtf32(sc[j], qh, ql, bh0, bh1, bl0, bl1);
      }
    }

    // bias and mask (one per column, every row alike), online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float bias = sB[j * 8 + t + 4 * u];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float x = bias == -INFINITY
                              ? -INFINITY
                              : fmaf(sc[j][2 * rr + u], scale2, bias);
          sc[j][2 * rr + u] = x;
          mx[rr] = fmaxf(mx[rr], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      // every row of the block sees the tile's live columns, so m_new
      // is finite (a row's first tile: corr = exp2(-inf) = 0)
      const float m_new = fmaxf(m_run[rr], mx[rr]);
      corr[rr] = exp2f(m_run[rr] - m_new);
      m_run[rr] = m_new;
      mx[rr] = m_new;
      l_run[rr] *= corr[rr];
    }
    // P's TF32 parts: the score accumulator of n-tile ks is P's A
    // fragment for k-step ks of PV
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        l_run[e >> 1] += p;
        // A fragment order: (row g, col t), (g + 8, t), (g, t + 4), ...
        split(p, ph[j][(e & 1) * 2 + (e >> 1)], pl[j][(e & 1) * 2 + (e >> 1)]);
      }
    }

    // acc = acc * corr + P V.  The tensor core truncates as it
    // accumulates, so each tile's product gets an accumulator of its
    // own, added to acc in f32: one chain over every tile drifts by
    // 2e-5 at 144 columns, twice the decode tolerance.
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < NJ; ++ks) {
        const float* v0 = sV + (ks * 8 + t) * LDV + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(v0[0], bh0, bl0);
        split(v0[4 * LDV], bh1, bl1);
        mma_3xtf32(c, ph[ks], pl[ks], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], corr[e >> 1], c[e]);
    }
  }
  cp_async_wait<0>();

  // store the unnormalised stats, m back in natural-log units: entry e
  // of n-tile j is dim j*8 + 2t + (e & 1)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = rr ? r1 : r0;
    if (r < grp) {
      const size_t row = (size_t)b * Hq + kvh * grp + r;
      if (t == 0) {
        m_out[row] = m_run[rr] == -INFINITY ? NEG : m_run[rr] * LN2;
        l_out[row] = l;
      }
      float* op = acc_out + row * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < KS; ++j)
        *reinterpret_cast<float2*>(op + j * 8) =
            make_float2(o[j][2 * rr], o[j][2 * rr + 1]);
    }
  }
}

template <int HD>
int launch_mq(const float* q, const float* k, const float* v,
              const uint8_t* valid, const float* log_gz, const float* kz,
              const float* vz, float* m_out, float* l_out, float* acc_out,
              int B, int M, int MZ, int Hq, int Hkv, int rep, float scale,
              cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const int mz = kz != nullptr ? MZ : 0;
  const int ntiles = (M + MQ_BK - 1) / MQ_BK + (mz + MQ_BK - 1) / MQ_BK;
  const size_t smem = sizeof(float) * MQ_STAGES * mq_stage<HD>() +
                      sizeof(uint4) * NW * (HD / 8) * 2 * 32 +
                      (sizeof(float) * MQ_BK + sizeof(int)) * ntiles;
  // above 48 KB only after raising the kernel's limit: once per process
  // for the largest size launched so far
  static size_t allowed = 48 << 10;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_stats_mq_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((grp + MQ_ROWS - 1) / MQ_ROWS, Hkv, B);
  decode_stats_mq_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, m_out, l_out, acc_out, M, MZ, Hq, Hkv,
      rep, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_stats_f32(
    const void* q, const void* k, const void* v, const void* valid,
    const void* log_gz, const void* kz, const void* vz, const void* rows,
    void* m_out, void* l_out, void* acc_out, int B, int M, int MZ, int Hq,
    int Hkv, int hd, int rep, float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* lg = static_cast<const float*>(log_gz);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vzf = static_cast<const float*>(vz);
  const auto* rw = static_cast<const int*>(rows);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  auto* ao = static_cast<float*>(acc_out);
  auto st = static_cast<cudaStream_t>(stream);
  // one head dim per ported model (GPT-2: 64)
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return launch<64>(qf, kf, vf, ok, lg, kzf, vzf, rw, mo, lo, ao, B, M, MZ,
                    Hq, Hkv, rep, scale, st);
}

// the tile route: no row map (output row b reads cache row b)
extern "C" int flash_decode_stats_mq_f32(
    const void* q, const void* k, const void* v, const void* valid,
    const void* log_gz, const void* kz, const void* vz, void* m_out,
    void* l_out, void* acc_out, int B, int M, int MZ, int Hq, int Hkv,
    int hd, int rep, float scale, void* stream) {
  // one head dim per ported model (GPT-2: 64)
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return launch_mq<64>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(log_gz), static_cast<const float*>(kz),
      static_cast<const float*>(vz), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), B, M, MZ,
      Hq, Hkv, rep, scale, static_cast<cudaStream_t>(stream));
}
