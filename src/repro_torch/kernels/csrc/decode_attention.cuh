// Single-token flash-decode partial softmax stats, for sm_90a: the
// kernels, templated on the storage type T of the cache (K, V and the
// means K/V: f32 or bf16).  decode_attention.cu instantiates them for an
// f32 cache, decode_attention_bf16.cu for a bf16 one, each in its own
// library, so the two build in parallel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (flash_decode_stats, body _decode_kernel).
//
// Dtypes, as the reference's kernel reads them.  The query is f32 here:
// the wrapper widens a bf16 query, which is exact, and the reference's
// product of two bf16 values, accumulated in f32, is exact in f32 too,
// so the scores are the reference's.  The wrapper casts the means K/V to
// K's dtype (the reference's kz.astype(k.dtype)).  A bf16 cache is read
// 8 bytes (4 values) a lane where an f32 one is read 16, each value
// widened on load (exact); every score, max, sum and accumulator is f32
// as in the f32 kernel, and p is rounded to bf16 before P V, as the
// reference's p.astype(v.dtype), while l sums the unrounded p.  A bf16
// value is a TF32 value, so on the tile route its 3xTF32 lo part is 0.
//
// Measured over a bf16 cache (chip_smoke.py, NVIDIA H100 80GB HBM3, 700
// W): GPT-2's static exact / prism 0.030 / 0.038 ms (the f32 cache's
// 0.021 / 0.027; bound 0.004 / 0.005): the row route's half-sized loads
// keep fewer bytes in flight, and the time is latency, not bytes; Yi-6B's
// (tile route) 0.030 / 0.040, Gemma 7B's 0.046 / 0.059.
//
// Head dims 16 and 32 (the reference's test grid).  On the row route a
// half-warp's 16 lanes hold 64 dims; at 16 and 32 only the first 4 and
// 8 lanes hold any (the ragged path of head dim 80: the others hold
// zeros, never loaded or stored, and add zeros in the shuffles).  The
// tile route takes them as head dim 64's layout with 2 and 4 k-steps.
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
// The paged cache (both routes).  With a page table `pages` (R, ppr)
// the K/V operands are the page pool, (n_pages * rep, PC, Hkv, HD): a
// page holds PC columns on each of the rep shards, and column j of
// cache row r on shard s is pool row (pages[r, j / PC] * rep + s) * PC
// + j % PC.  A page id below 0 (unmapped) makes its columns dead,
// whatever `valid` says, and its rows are never read; an id past the
// pool reads its last page (as the reference's take clips it), a means
// row is clamped to the state pool, both in the kernel.  A dense call is
// the same address with PC = M and pages[r, 0] = r: the tile route
// computes it so when `pages` is null (one address path); the row route
// has the lookup as a compile-time path (PAGED), because its per-column
// division slowed the dense packed layout.  The means
// rows of a paged call live in a state pool: `zrows` (R) maps cache row
// r to its means row (null: means row r).  The reference gathers every
// row's pages into a dense copy before its kernel (serve.py,
// _gather_pages); here the page lookup is one load per column.
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
// The row route (decode_stats_kernel): one block of 4 warps per (row, KV head,
// tile of up to 32 query heads of its group), so GPT-2's path runs 12 x 32
// blocks in both modes, about three per SM.  A half-warp holds one K or V row,
// each lane HD / 64 float4s of it (lane l float4s l, l + 16, ...), two rows at
// a time a warp: 16 columns per pass at head dim 64, 8 at 80 and 128.  At 80 a
// row is 20 float4s: lanes 0-3 hold two and the others one, their second left
// zero.  A warp first reads its columns' `valid` / log g, then starts the
// 16-byte K and V loads of every live column of the pass at once into
// registers, so 8 KB per warp are in flight at either head dim; a dead column
// (`valid` false or log g <= -1e30 / 2) is never loaded.  Every warp then
// computes the scores of the tile's query heads over its columns, keeping a
// running (m, l, acc) per head in shared memory, and the four warps' partials
// are merged in warp order: deterministic, one launch per call.  A warp that
// met no live column holds (-inf, 0, 0) and drops out of the merge.  A group of
// more than 32 heads takes more blocks, each of which reads the KV head's
// columns again (from L2), so any group size launches with at most 35 KB of
// shared memory at head dim 64 and 68 KB at 128 (above 48 KB the limit is
// raised once per device).
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
//   chunk layout (the limit is raised once per device), three blocks
//   an SM, so the 384 blocks run in one wave.
// - Head dim 128 (the Llama family: Yi-6B's static and engine decode,
//   a group of 8 and no row map, take this route): strides HD + 4 and
//   HD + 8, about 135 KB of shared memory a block (64 KB of it Q's
//   fragments), one block an SM, so the kernel is built for one block an
//   SM there and may take up to 255 registers (acc doubles to 64 a
//   thread; it takes 226, no spills).  QK^T's 16 k-steps run as two
//   chains of 8, each in its own accumulator (mma_tf32.cuh, QK_CHAIN).
//   At a group of 8 a 64-row query tile holds 8 live rows, in its first
//   warp: right, and slow.  Yi's static decode (32 rows of 144 columns,
//   4 KV heads) moves 19.5 MB, a bound of 0.0058 ms; the tile route
//   takes 0.025 ms there, the row route 0.032 (chip_smoke.py, H100).
// - Head dim 80 (Zamba2 2.7B: MHA, so its decode takes the row route;
//   the tile route is built and checked at 80 all the same): hd 128's
//   kernel with KS = 10, QK^T as a chain of 8 k-steps and one of 2,
//   strides 84 and 88 (conflict-free: banks 20g + t and 24t + g).
// - Head dim 256 (Gemma 3 1B: a group of 4 query heads over 1 KV head,
//   static decode over the global layers' cache and the local layers'
//   ring).  A 64-row tile does not fit there (a 134 KB ring plus 128 KB
//   of Q's parts), and a group of 4 fills 4 of its rows.  So the hd-256
//   kernel (decode_stats_mq_split_kernel) takes 16 query heads a block,
//   one 16-row tile shared by its 4 warps, and splits the head dim
//   across them: warp w computes k-steps [8w, 8w + 8) of QK^T, one chain
//   of QK_CHAIN, into its own accumulator; the four partial score tiles
//   meet in shared memory and every warp adds them in f32 in warp order
//   (the four chains of the other kernels, without computing any twice),
//   runs the same online softmax, and computes P V for its own 64 output
//   dims (8 n-tiles, a 32-float accumulator).  Shared memory: the
//   two-stage ring of 32 x (260 + 264) floats, 32 KB of Q's parts (a
//   warp parks only its k-steps) and 8 KB of score partials, about 175
//   KB a block at Gemma's layouts; one block an SM.  One more barrier a
//   tile.  Its K/V traffic is the hd-128 kernel's per column; the grid
//   is one block per (output row, KV head): 32 at Gemma's global layers,
//   8 at its ring, too few to fill the card (a later PR's split over
//   columns).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.0225 ms at
// the chunk layout, 2.5x its bound and 6.1x faster than the row route
// there; 0.017 ms for any group up to 16 (the latency of a block's two
// dependent round trips, `valid` then the K/V tiles, and of streaming
// four tiles through a two-stage ring: group 16 computes a quarter of
// group 64's products in 76% of its time).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int NW = 4;               // warps per block
constexpr int NT = 32 * NW;         // threads per block
constexpr int GMAX = 32;            // query heads per block
// the tile route
constexpr int MQ_ROWS = 16 * NW;    // query heads per block, 16 per warp
constexpr int MQ_BK = 32;           // K/V columns per tile
constexpr int MQ_STAGES = 2;        // cp.async ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using namespace tc;   // 3xTF32 mma.sync and cp.async (mma_tf32.cuh)

// four consecutive cache values from 4-value vector `i` of a row, in
// f32: one 16-byte load of f32, one 8-byte load of bf16 widened
__device__ __forceinline__ float4 load4(const float* row, int i) {
  return __ldg(reinterpret_cast<const float4*>(row) + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + i);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// p as the P V product takes it: rounded to the cache's type (the
// reference's p.astype(v.dtype)), widened back
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(NT) decode_stats_kernel(
    const float* __restrict__ q,        // (B / rep, Hq, HD)
    const T* __restrict__ k,            // (R * rep, M, Hkv, HD)
    const T* __restrict__ v,            // (R * rep, M, Hkv, HD)
    const uint8_t* __restrict__ valid,  // (B, M)
    const float* __restrict__ log_gz,   // (B, MZ) or null
    const T* __restrict__ kz,           // (R, MZ, Hkv, HD) or null
    const T* __restrict__ vz,           // (R, MZ, Hkv, HD) or null
    const int* __restrict__ rows,       // (B / rep) cache row map or null
    const int* __restrict__ pages,      // (R, ppr) page table or null
    const int* __restrict__ zrows,      // (R) means row map or null
    float* __restrict__ m_out,          // (B, Hq)
    float* __restrict__ l_out,          // (B, Hq)
    float* __restrict__ acc_out,        // (B, Hq, HD)
    int M, int MZ, int Hq, int Hkv, int rep, int ppr, int PC, int NPAGES,
    int NZROWS, float scale) {
  // a half-warp holds one row as 16 x VEC float4s: lane hl holds
  // float4s hl, hl + 16, ... (head dim 256: 4 of them, 2 columns a
  // half-warp a pass).  At head dim 80 a row is 20 float4s: every lane
  // holds float4 hl, and lanes 0-3 also hl + 16; the other lanes' second
  // float4 stays zero (never loaded, never stored), so the dot products,
  // the shuffles and the merge are as at the other head dims
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  constexpr int F4 = HD / 4;            // float4s of a row
  constexpr int VEC = (F4 + 15) / 16;   // float4s of a row a lane holds
  constexpr bool RAGGED = F4 % 16 != 0; // some lanes hold VEC - 1
  constexpr int HC = 8 / VEC;           // columns a half-warp takes a pass
  constexpr int WCOLS = 2 * HC;         // columns per warp per pass
  constexpr int UNIT = NW * WCOLS;      // columns per block per pass
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
  const int sh = b - bq * rep;                     // its shard
  const int bk = r * rep + sh;                     // its dense row
  const int zr = zrows != nullptr ? min(max(zrows[r], 0), NZROWS - 1) : r;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, hl = lane & 15;
  // the lane's float4s u < nvec are in the row (all of them unless a
  // row's float4s are not a multiple of 16)
  const int nvec = (F4 - hl + 15) / 16;
  const int n_cols = M + (kz != nullptr ? MZ : 0);
  const int h0 = kvh * grp + g0;        // the block's first query head
  // column c's page is floor((c + 0.5) / PC) in f32: exact for c < 2^21
  // (the quotient stays 0.5 / PC from an integer, farther than the two
  // roundings move it), where an integer division by a runtime PC costs
  // about 20 instructions a column
  const float inv_pc = 1.f / PC;

  const float4* qg =                    // the block's query rows
      reinterpret_cast<const float4*>(q + ((size_t)bq * Hq + h0) * HD);
  for (int i = lane; i < gt * LP; i += 32)    // this warp's partials
    sPart[warp * gt * LP + i] = (i % LP) == HD ? -INFINITY : 0.f;
  __syncwarp();

  for (int base = warp * WCOLS; base < n_cols; base += UNIT) {
    // this pass: columns base + 2i + half, i < HC; the page lookup and
    // `valid` are independent loads
    bool live[HC];
    float bias[HC];
    int krow[HC];                       // the column's K/V or means row
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int c = base + 2 * i + half;
      live[i] = false;
      bias[i] = 0.f;
      krow[i] = 0;
      if (c < n_cols) {
        if (c < M) {
          live[i] = valid[(size_t)b * M + c] != 0;
          if constexpr (PAGED) {
            const int j = __float2int_rz((c + 0.5f) * inv_pc);
            const int pg = min(pages[r * ppr + j], NPAGES - 1);
            live[i] = live[i] && pg >= 0;
            krow[i] = (pg * rep + sh) * PC + (c - j * PC);
          } else {
            krow[i] = bk * M + c;
          }
        } else {
          bias[i] = log_gz[(size_t)b * MZ + (c - M)];
          live[i] = bias[i] > NEG * 0.5f;
          krow[i] = zr * MZ + (c - M);
        }
      }
    }
    float4 kr[HC][VEC], vr[HC][VEC];
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int c = base + 2 * i + half;
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        kr[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[i][u] = kr[i][u];
      }
      if (live[i]) {
        const size_t off = ((size_t)krow[i] * Hkv + kvh) * HD;
        const T* ks = (c < M ? k : kz) + off;
        const T* vs = (c < M ? v : vz) + off;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          if (!RAGGED || u < nvec) {
            kr[i][u] = load4(ks, hl + 16 * u);
            vr[i][u] = load4(vs, hl + 16 * u);
          }
        }
      }
    }
    for (int g = 0; g < gt; ++g) {
      float4 q4[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        q4[u] = !RAGGED || u < nvec ? __ldg(qg + g * F4 + hl + 16 * u)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      float s[HC];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < HC; ++i) {
        float d = q4[0].x * kr[i][0].x;
        d = fmaf(q4[0].y, kr[i][0].y, d);
        d = fmaf(q4[0].z, kr[i][0].z, d);
        d = fmaf(q4[0].w, kr[i][0].w, d);
#pragma unroll
        for (int u = 1; u < VEC; ++u) {
          d = fmaf(q4[u].x, kr[i][u].x, d);
          d = fmaf(q4[u].y, kr[i][u].y, d);
          d = fmaf(q4[u].z, kr[i][u].z, d);
          d = fmaf(q4[u].w, kr[i][u].w, d);
        }
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
      float4 a[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < HC; ++i) {
        const float p = expf(s[i] - m_use);
        ps += p;
        const float pv = round_p(p, T{});
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          a[u].x = fmaf(pv, vr[i][u].x, a[u].x);
          a[u].y = fmaf(pv, vr[i][u].y, a[u].y);
          a[u].z = fmaf(pv, vr[i][u].z, a[u].z);
          a[u].w = fmaf(pv, vr[i][u].w, a[u].w);
        }
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        a[u].x += __shfl_xor_sync(0xffffffffu, a[u].x, 16);
        a[u].y += __shfl_xor_sync(0xffffffffu, a[u].y, 16);
        a[u].z += __shfl_xor_sync(0xffffffffu, a[u].z, 16);
        a[u].w += __shfl_xor_sync(0xffffffffu, a[u].w, 16);
      }
      const float l_prev = part[HD + 1];
      __syncwarp();                     // every lane has read m, l
      if (half == 0) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          if (!RAGGED || u < nvec) {
            float4* acc = reinterpret_cast<float4*>(part) + hl + 16 * u;
            float4 r = *acc;
            r.x = fmaf(r.x, corr, a[u].x);
            r.y = fmaf(r.y, corr, a[u].y);
            r.z = fmaf(r.z, corr, a[u].z);
            r.w = fmaf(r.w, corr, a[u].w);
            *acc = r;
          }
        }
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

// the devices a process may launch on (the limits below are per device)
constexpr int MAX_DEVICES = 64;

// Dynamic shared memory above 48 KB needs the kernel's limit raised,
// which holds for the current device alone (the wrapper makes the
// tensors' device current): `allowed` tracks, per device, the largest
// size raised for `kernel` so far.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= (48 << 10)) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, int HD>
int launch(const float* q, const T* k, const T* v,
           const uint8_t* valid, const float* log_gz, const T* kz,
           const T* vz, const int* rows, const int* pages,
           const int* zrows, float* m_out, float* l_out, float* acc_out,
           int B, int M, int MZ, int Hq, int Hkv, int rep, int ppr, int PC,
           int NPAGES, int NZROWS, float scale, cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const size_t smem = sizeof(float) * NW * min(grp, GMAX) * (HD + 4);
  const dim3 grid((grp + GMAX - 1) / GMAX, Hkv, B);
  // the page lookup is a compile-time path: a dense call keeps the
  // plain address (one path for both cost the dense packed layout
  // 26-30%: 0.063-0.065 ms against 0.050, chip_smoke.py, NVIDIA H100
  // 80GB HBM3 at 700 W)
  auto kernel = pages != nullptr ? decode_stats_kernel<T, HD, true>
                                 : decode_stats_kernel<T, HD, false>;
  static size_t allowed[2][MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(kernel, smem, allowed[pages != nullptr]);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, rows, pages, zrows, m_out, l_out,
      acc_out, M, MZ, Hq, Hkv, rep, ppr, PC, NPAGES, NZROWS, scale);
  return (int)cudaGetLastError();
}

// the tile route's padded row strides in shared memory, in elements:
// conflict-free f32 fragment loads (HD + 4, HD + 8); a bf16 row padded
// to a whole 16-byte copy (HD + 8 both)
template <typename T, int HD>
__host__ __device__ constexpr int mq_ldk() {
  return HD + (sizeof(T) == 4 ? 4 : 8);
}
template <typename T, int HD>
__host__ __device__ constexpr int mq_ldv() {
  return HD + 8;
}
// floats of one ring stage of the tile route: a K and a V tile
template <typename T, int HD>
__host__ __device__ constexpr int mq_stage() {
  return MQ_BK * (mq_ldk<T, HD>() + mq_ldv<T, HD>()) * (int)sizeof(T) / 4;
}

// The tile route's column scan, once a block for its output row b: each
// column's bias in the log2 domain into s_bias (-inf = dead: `valid`
// false, an unmapped page, or g = 0), each live local column's K/V row
// (its page looked up once) into s_row, and the indices of the 32-column
// tiles that hold a live column, local tiles then means tiles, compacted
// in order into s_tiles.  Returns how many are live.  Every thread of the
// block calls it.
__device__ __forceinline__ int mq_scan_columns(
    const uint8_t* __restrict__ valid, const float* __restrict__ log_gz,
    const int* __restrict__ pages, int b, int bq, int sh, int M, int MZ,
    int mz, int nlt, int ntiles, int rep, int ppr, int PC, int NPAGES,
    float* s_bias, int* s_tiles, int* s_row, int* s_nlive) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < ntiles; i += NT) s_tiles[i] = 0;
  __syncthreads();
  for (int i = tid; i < ntiles * MQ_BK; i += NT) {
    const int ti = i / MQ_BK;
    float bias = -INFINITY;
    if (ti < nlt) {
      const int c = i;                  // local tiles start at column 0
      if (c < M) {
        const int pg =
            pages != nullptr ? min(pages[bq * ppr + c / PC], NPAGES - 1) : bq;
        if (valid[(size_t)b * M + c] && pg >= 0) bias = 0.f;
        s_row[c] = bias == 0.f ? (pg * rep + sh) * PC + c % PC : 0;
      }
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
    if (lane == 0) *s_nlive = n;
  }
  __syncthreads();
  return *s_nlive;
}

// a tile's K and V rows into one ring stage at row strides LDK and LDV
// (elements), 16 bytes a copy; a dead or out-of-range column is
// zero-filled
template <typename T, int HD, int LDK, int LDV>
__device__ __forceinline__ void mq_load_tile(
    T* sK, int ti, int nlt, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ kz,
    const T* __restrict__ vz, const float* s_bias, const int* s_row,
    int zr, int MZ, int Hkv, int kvh) {
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a copy
  T* sV = sK + MQ_BK * LDK;
  const bool local = ti < nlt;
  const int c0 = (local ? ti : ti - nlt) * MQ_BK;
  const T* kb = local ? k : kz;
  const T* vb = local ? v : vz;
  for (int i = threadIdx.x; i < MQ_BK * HD / EPC; i += NT) {
    const int cc = i / (HD / EPC), d4 = (i % (HD / EPC)) * EPC;
    const bool ok = s_bias[ti * MQ_BK + cc] != -INFINITY;
    // each row is one contiguous copy, wherever its page is
    const size_t row = !ok ? 0
                       : local ? (size_t)s_row[c0 + cc]
                               : (size_t)zr * MZ + c0 + cc;
    const size_t off = (row * Hkv + kvh) * HD + d4;
    cp_async16(sK + cc * LDK + d4, kb + off, ok);
    cp_async16(sV + cc * LDV + d4, vb + off, ok);
  }
}

// blocks an SM the tile route is built for: three at head dim 64; one at
// 128, whose shared memory admits no second
constexpr int mq_min_blocks(int hd) { return hd <= 64 ? 3 : 1; }

template <typename T, int HD>
__global__ void __launch_bounds__(NT, mq_min_blocks(HD))
    decode_stats_mq_kernel(
    const float* __restrict__ q,        // (B / rep, Hq, HD)
    const T* __restrict__ k,            // (B, M, Hkv, HD) or the pool
    const T* __restrict__ v,            // (B, M, Hkv, HD) or the pool
    const uint8_t* __restrict__ valid,  // (B, M)
    const float* __restrict__ log_gz,   // (B, MZ) or null
    const T* __restrict__ kz,           // (B / rep, MZ, Hkv, HD) or null
    const T* __restrict__ vz,           // (B / rep, MZ, Hkv, HD) or null
    const int* __restrict__ pages,      // (B / rep, ppr) page table or null
    const int* __restrict__ zrows,      // (B / rep) means row map or null
    float* __restrict__ m_out,          // (B, Hq)
    float* __restrict__ l_out,          // (B, Hq)
    float* __restrict__ acc_out,        // (B, Hq, HD)
    int M, int MZ, int Hq, int Hkv, int rep, int ppr, int PC, int NPAGES,
    int NZROWS, float scale) {
  static_assert(HD % 8 == 0 && HD <= 128, "head dim");
  constexpr int KS = HD / 8;            // k-steps of QK^T; n-tiles of PV
  constexpr int NJ = MQ_BK / 8;         // n-tiles of QK^T; k-steps of PV
  constexpr int LDK = mq_ldk<T, HD>();  // padded row strides (elements)
  constexpr int LDV = mq_ldv<T, HD>();
  constexpr int STAGE = mq_stage<T, HD>();   // floats
  extern __shared__ __align__(16) float smem[];
  // after the ring: Q's TF32 parts in A-fragment order, each column's
  // bias (log2 domain, -inf = dead), the live tiles' indices, then each
  // local column's K/V row (its page looked up once)
  uint4* s_q = reinterpret_cast<uint4*>(smem + MQ_STAGES * STAGE);
  float* s_bias = reinterpret_cast<float*>(s_q + NW * KS * 2 * 32);
  const int mz = kz != nullptr ? MZ : 0;
  const int nlt = (M + MQ_BK - 1) / MQ_BK;            // local tiles
  const int ntiles = nlt + (mz + MQ_BK - 1) / MQ_BK;  // then means tiles
  int* s_tiles = reinterpret_cast<int*>(s_bias + ntiles * MQ_BK);
  int* s_row = s_tiles + ntiles;
  __shared__ int s_nlive;

  const int grp = Hq / Hkv;
  const int g0 = blockIdx.x * MQ_ROWS;  // the block's heads of the group
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int bq = b / rep;
  const int sh = b - bq * rep;
  const int zr = zrows != nullptr ? min(max(zrows[bq], 0), NZROWS - 1) : bq;
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
  const int nlive = mq_scan_columns(valid, log_gz, pages, b, bq, sh, M, MZ,
                                    mz, nlt, ntiles, rep, ppr, PC, NPAGES,
                                    s_bias, s_tiles, s_row, &s_nlive);

  auto load_tile = [&](int ti, int stage) {
    mq_load_tile<T, HD, LDK, LDV>(
        reinterpret_cast<T*>(smem + stage * STAGE), ti, nlt, k, v, kz, vz,
        s_bias, s_row, zr, MZ, Hkv, kvh);
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
    const T* sK = reinterpret_cast<const T*>(smem + (it % MQ_STAGES) * STAGE);
    const T* sV = sK + MQ_BK * LDK;
    const float* sB = s_bias + s_tiles[it] * MQ_BK;

    // S = Q K^T; n-tile j, accumulator entry e holds column
    // j*8 + t + 4*(e & 1) of row g + 8*(e >> 1)
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (KS <= QK_CHAIN) {
      qk_3xtf32<0, KS, NJ, LDK>(sc, my_q, sK, g, t);
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
    // fragment for k-step ks of PV; p rounded to a bf16 cache's type
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        l_run[e >> 1] += p;
        // A fragment order: (row g, col t), (g + 8, t), (g, t + 4), ...
        split(round_p(p, T{}), ph[j][(e & 1) * 2 + (e >> 1)],
              pl[j][(e & 1) * 2 + (e >> 1)]);
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
        const T* v0 = sV + (ks * 8 + t) * LDV + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(to_f32(v0[0]), bh0, bl0);
        split(to_f32(v0[4 * LDV]), bh1, bl1);
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

// the tile route at head dim 256: 16 query heads a block, the head dim
// split across the 4 warps (see the file's note)
constexpr int MQS_ROWS = 16;

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1) decode_stats_mq_split_kernel(
    const float* __restrict__ q,        // (B / rep, Hq, HD)
    const T* __restrict__ k,            // (B, M, Hkv, HD) or the pool
    const T* __restrict__ v,            // (B, M, Hkv, HD) or the pool
    const uint8_t* __restrict__ valid,  // (B, M)
    const float* __restrict__ log_gz,   // (B, MZ) or null
    const T* __restrict__ kz,           // (B / rep, MZ, Hkv, HD) or null
    const T* __restrict__ vz,           // (B / rep, MZ, Hkv, HD) or null
    const int* __restrict__ pages,      // (B / rep, ppr) page table or null
    const int* __restrict__ zrows,      // (B / rep) means row map or null
    float* __restrict__ m_out,          // (B, Hq)
    float* __restrict__ l_out,          // (B, Hq)
    float* __restrict__ acc_out,        // (B, Hq, HD)
    int M, int MZ, int Hq, int Hkv, int rep, int ppr, int PC, int NPAGES,
    int NZROWS, float scale) {
  constexpr int KS = HD / 8;            // k-steps of QK^T
  constexpr int KW = KS / NW;           // a warp's k-steps: one chain
  static_assert(KW == QK_CHAIN, "head dim");
  constexpr int DW = HD / NW;           // a warp's output dims
  constexpr int NV = DW / 8;            // a warp's n-tiles of PV
  constexpr int NJ = MQ_BK / 8;         // n-tiles of QK^T; k-steps of PV
  constexpr int LDK = mq_ldk<T, HD>();  // padded row strides (elements)
  constexpr int LDV = mq_ldv<T, HD>();
  constexpr int STAGE = mq_stage<T, HD>();   // floats
  constexpr int SC = NJ * 4 * 32;       // floats of a warp's score tile
  extern __shared__ __align__(16) float smem[];
  // after the ring: each warp's Q parts (its k-steps), each warp's
  // partial score tile, each column's bias (log2 domain, -inf = dead),
  // the live tiles' indices, then each local column's K/V row
  uint4* s_q = reinterpret_cast<uint4*>(smem + MQ_STAGES * STAGE);
  float* s_sc = reinterpret_cast<float*>(s_q + NW * KW * 2 * 32);
  float* s_bias = s_sc + NW * SC;
  const int mz = kz != nullptr ? MZ : 0;
  const int nlt = (M + MQ_BK - 1) / MQ_BK;            // local tiles
  const int ntiles = nlt + (mz + MQ_BK - 1) / MQ_BK;  // then means tiles
  int* s_tiles = reinterpret_cast<int*>(s_bias + ntiles * MQ_BK);
  int* s_row = s_tiles + ntiles;
  __shared__ int s_nlive;

  const int grp = Hq / Hkv;
  const int g0 = blockIdx.x * MQS_ROWS; // the block's heads of the group
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int bq = b / rep;
  const int sh = b - bq * rep;
  const int zr = zrows != nullptr ? min(max(zrows[bq], 0), NZROWS - 1) : bq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread-in-group

  // ---- the tile's query rows g and g + 8, this warp's k-steps --------
  const int r0 = g0 + g, r1 = r0 + 8;   // heads of the group
  const bool ok0 = r0 < grp, ok1 = r1 < grp;
  float qf[KW][4];
  {
    const float* p0 =
        q + ((size_t)bq * Hq + kvh * grp + r0) * HD + warp * KW * 8;
    const float* p1 = p0 + 8 * HD;
#pragma unroll
    for (int ks = 0; ks < KW; ++ks) {
      qf[ks][0] = ok0 ? p0[ks * 8 + t] : 0.f;
      qf[ks][1] = ok1 ? p1[ks * 8 + t] : 0.f;
      qf[ks][2] = ok0 ? p0[ks * 8 + t + 4] : 0.f;
      qf[ks][3] = ok1 ? p1[ks * 8 + t + 4] : 0.f;
    }
  }

  // ---- the row's columns: bias per column, which tiles are live ------
  const int nlive = mq_scan_columns(valid, log_gz, pages, b, bq, sh, M, MZ,
                                    mz, nlt, ntiles, rep, ppr, PC, NPAGES,
                                    s_bias, s_tiles, s_row, &s_nlive);

  auto load_tile = [&](int ti, int stage) {
    mq_load_tile<T, HD, LDK, LDV>(
        reinterpret_cast<T*>(smem + stage * STAGE), ti, nlt, k, v, kz, vz,
        s_bias, s_row, zr, MZ, Hkv, kvh);
  };

  for (int s = 0; s < MQ_STAGES - 1; ++s) {
    if (s < nlive) load_tile(s_tiles[s], s);
    cp_async_commit();
  }

  // this warp's Q parts (A fragments: rows g / g + 8, dims t and t + 4
  // of each of its k-steps), parked in shared memory
  uint4* my_q = s_q + warp * KW * 2 * 32 + lane;
#pragma unroll
  for (int ks = 0; ks < KW; ++ks) {
    uint32_t qh[4], ql[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(qf[ks][e], qh[e], ql[e]);
    my_q[(2 * ks) * 32] = make_uint4(qh[0], qh[1], qh[2], qh[3]);
    my_q[(2 * ks + 1) * 32] = make_uint4(ql[0], ql[1], ql[2], ql[3]);
  }
  float* my_sc = s_sc + warp * SC + lane;

  // online softmax state in the log2 domain, the same in every warp; l
  // is this thread's partial sum over its columns
  const float scale2 = scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < nlive; ++it) {
    cp_async_wait<MQ_STAGES - 2>();
    __syncthreads();                    // tile `it` landed; `it - 1` and
                                        // its score partials consumed
    {
      const int nxt = it + MQ_STAGES - 1;
      if (nxt < nlive) load_tile(s_tiles[nxt], nxt % MQ_STAGES);
      cp_async_commit();
    }
    const T* sK = reinterpret_cast<const T*>(smem + (it % MQ_STAGES) * STAGE);
    const T* sV = sK + MQ_BK * LDK;
    const float* sB = s_bias + s_tiles[it] * MQ_BK;

    // this warp's chain of QK^T, shared; then S = the four chains added
    // in f32 in warp order (n-tile j, entry e: column j*8 + t +
    // 4*(e & 1) of row g + 8*(e >> 1))
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    qk_3xtf32<0, KW, NJ, LDK>(sc, my_q, sK + warp * KW * 8, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) my_sc[(j * 4 + e) * 32] = sc[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_sc[(j * 4 + e) * 32 + lane];
#pragma unroll
        for (int w = 1; w < NW; ++w)
          x += s_sc[w * SC + (j * 4 + e) * 32 + lane];
        sc[j][e] = x;
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
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        l_run[e >> 1] += p;
        const int a = (e & 1) * 2 + (e >> 1);   // A fragment order
        split(round_p(p, T{}), ph[j][a], pl[j][a]);
      }
    }

    // acc = acc * corr + P V over this warp's output dims, each tile's
    // product in an accumulator of its own, added in f32
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < NJ; ++ks) {
        const T* v0 = sV + (ks * 8 + t) * LDV + warp * DW + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(to_f32(v0[0]), bh0, bl0);
        split(to_f32(v0[4 * LDV]), bh1, bl1);
        mma_3xtf32(c, ph[ks], pl[ks], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], corr[e >> 1], c[e]);
    }
  }
  cp_async_wait<0>();

  // store: m and l from warp 0 (every warp holds the same), each warp
  // its output dims; entry e of n-tile j is dim j*8 + 2t + (e & 1)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = rr ? r1 : r0;
    if (r < grp) {
      const size_t row = (size_t)b * Hq + kvh * grp + r;
      if (warp == 0 && t == 0) {
        m_out[row] = m_run[rr] == -INFINITY ? NEG : m_run[rr] * LN2;
        l_out[row] = l;
      }
      float* op = acc_out + row * HD + warp * DW + 2 * t;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        *reinterpret_cast<float2*>(op + j * 8) =
            make_float2(o[j][2 * rr], o[j][2 * rr + 1]);
    }
  }
}

template <typename T, int HD>
int launch_mq_split(const float* q, const T* k, const T* v,
                    const uint8_t* valid, const float* log_gz,
                    const T* kz, const T* vz, const int* pages,
                    const int* zrows, float* m_out, float* l_out,
                    float* acc_out, int B, int M, int MZ, int Hq, int Hkv,
                    int rep, int ppr, int PC, int NPAGES, int NZROWS,
                    float scale, cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const int mz = kz != nullptr ? MZ : 0;
  const int nlt = (M + MQ_BK - 1) / MQ_BK;
  const int ntiles = nlt + (mz + MQ_BK - 1) / MQ_BK;
  const size_t smem = sizeof(float) * MQ_STAGES * mq_stage<T, HD>() +
                      sizeof(uint4) * HD / 8 * 2 * 32 +
                      sizeof(float) * NW * (MQ_BK / 8) * 4 * 32 +
                      (sizeof(float) * MQ_BK + sizeof(int)) * ntiles +
                      sizeof(int) * MQ_BK * nlt;
  static size_t allowed[MAX_DEVICES] = {};
  const cudaError_t e =
      allow_smem(decode_stats_mq_split_kernel<T, HD>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((grp + MQS_ROWS - 1) / MQS_ROWS, Hkv, B);
  decode_stats_mq_split_kernel<T, HD><<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, pages, zrows, m_out, l_out, acc_out,
      M, MZ, Hq, Hkv, rep, ppr, pages != nullptr ? PC : M, NPAGES, NZROWS,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_mq(const float* q, const T* k, const T* v,
              const uint8_t* valid, const float* log_gz, const T* kz,
              const T* vz, const int* pages, const int* zrows,
              float* m_out, float* l_out, float* acc_out, int B, int M,
              int MZ, int Hq, int Hkv, int rep, int ppr, int PC, int NPAGES,
              int NZROWS, float scale, cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const int mz = kz != nullptr ? MZ : 0;
  const int nlt = (M + MQ_BK - 1) / MQ_BK;
  const int ntiles = nlt + (mz + MQ_BK - 1) / MQ_BK;
  const size_t smem = sizeof(float) * MQ_STAGES * mq_stage<T, HD>() +
                      sizeof(uint4) * NW * (HD / 8) * 2 * 32 +
                      (sizeof(float) * MQ_BK + sizeof(int)) * ntiles +
                      sizeof(int) * MQ_BK * nlt;
  static size_t allowed[MAX_DEVICES] = {};
  const cudaError_t e =
      allow_smem(decode_stats_mq_kernel<T, HD>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((grp + MQ_ROWS - 1) / MQ_ROWS, Hkv, B);
  decode_stats_mq_kernel<T, HD><<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, pages, zrows, m_out, l_out, acc_out,
      M, MZ, Hq, Hkv, rep, ppr, pages != nullptr ? PC : M, NPAGES, NZROWS,
      scale);
  return (int)cudaGetLastError();
}

// the tile route's kernel for a head dim: at 256 the one that splits the
// head dim over its warps
template <typename T, int HD, typename... Args>
int launch_tile(Args... args) {
  if constexpr (HD > 128)
    return launch_mq_split<T, HD>(args...);
  else
    return launch_mq<T, HD>(args...);
}

// one head dim per ported model family (GPT-2: 64; Zamba2 2.7B: 80;
// Llama, Yi-6B: 128; Gemma 3 1B: 256) and the reference's test grid's
// 16 and 32: fn(std::integral_constant<int, HD>) for the call's head dim
template <typename Fn>
int by_head_dim(int hd, Fn fn) {
  switch (hd) {
    case 16:
      return fn(std::integral_constant<int, 16>{});
    case 32:
      return fn(std::integral_constant<int, 32>{});
    case 64:
      return fn(std::integral_constant<int, 64>{});
    case 80:
      return fn(std::integral_constant<int, 80>{});
    case 128:
      return fn(std::integral_constant<int, 128>{});
    case 256:
      return fn(std::integral_constant<int, 256>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the row route over a cache of T (the C entry points' body)
template <typename T>
int decode_row_entry(const void* q, const void* k, const void* v,
                     const void* valid, const void* log_gz, const void* kz,
                     const void* vz, const void* rows, const void* pages,
                     const void* zrows, void* m_out, void* l_out,
                     void* acc_out, int B, int M, int MZ, int Hq, int Hkv,
                     int hd, int rep, int ppr, int pc, int n_pages,
                     int n_zrows, float scale, void* stream) {
  return by_head_dim(hd, [&](auto h) {
    return launch<T, decltype(h)::value>(
        static_cast<const float*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(log_gz), static_cast<const T*>(kz),
        static_cast<const T*>(vz), static_cast<const int*>(rows),
        static_cast<const int*>(pages), static_cast<const int*>(zrows),
        static_cast<float*>(m_out), static_cast<float*>(l_out),
        static_cast<float*>(acc_out), B, M, MZ, Hq, Hkv, rep, ppr, pc,
        n_pages, n_zrows, scale, static_cast<cudaStream_t>(stream));
  });
}

// the tile route over a cache of T: no row map (output row b reads cache
// row b / rep)
template <typename T>
int decode_tile_entry(const void* q, const void* k, const void* v,
                      const void* valid, const void* log_gz, const void* kz,
                      const void* vz, const void* pages, const void* zrows,
                      void* m_out, void* l_out, void* acc_out, int B, int M,
                      int MZ, int Hq, int Hkv, int hd, int rep, int ppr,
                      int pc, int n_pages, int n_zrows, float scale,
                      void* stream) {
  return by_head_dim(hd, [&](auto h) {
    return launch_tile<T, decltype(h)::value>(
        static_cast<const float*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(log_gz), static_cast<const T*>(kz),
        static_cast<const T*>(vz), static_cast<const int*>(pages),
        static_cast<const int*>(zrows), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(acc_out), B, M, MZ,
        Hq, Hkv, rep, ppr, pc, n_pages, n_zrows, scale,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace
