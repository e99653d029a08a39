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
// Design: one block of 4 warps per (row, KV head, tile of up to 32 query
// heads of its group), so the main path runs 12 x 32 blocks in both
// modes, about three per SM.  Each warp takes 16 columns per pass, two at
// a time: a half-warp holds one 64-float K or V row as 16 float4s.  A
// warp first reads its columns' `valid` / log g, then issues the 16-byte
// K and V loads of every live column of the pass at once into registers,
// so 8 KB per warp are in flight; a dead column (`valid` false or
// log g <= -1e30 / 2) is never loaded.  Every warp then computes the
// scores of the tile's query heads over its columns, keeping a running
// (m, l, acc) per head in shared memory, and the four warps' partials
// are merged in warp order: deterministic, one launch per call.  A warp
// that met no live column holds (-inf, 0, 0) and drops out of the merge.
// A group of more than 32 heads takes more blocks, each of which reads
// the KV head's columns again (from L2), so any group size launches with
// at most 35 KB of shared memory.
//
// Splitting a row's columns over a cluster of up to 4 blocks, merged over
// distributed shared memory, was measured 13% slower at the main path's
// shape (chip_smoke.py's decode times, H100): 384 blocks already fill
// the card, and the split adds a cluster barrier and a merge.
//
// What bounds it still: each block waits on two dependent device-memory
// round trips (`valid`, then K/V), so the call is latency-bound, about
// 2.6x its byte bound.  The chunked prefill's layout (a chunk of 64
// queries folded into the head axis: 64 heads a KV head, two 32-head
// blocks reading the same K/V) is bound by bytes too, but there every
// score costs four FMAs and four warp shuffles on the f32 cores, where
// the card's 3xTF32 tensor-core products would take under half the
// byte time: about 15x its bound at 64 tokens after a 448-token prefix
// (chip_smoke.py, H100).  A design for many queries a KV head (tensor
// cores, K/V tiles shared by the heads) waits for its own change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NW = 4;               // warps per block
constexpr int NT = 32 * NW;         // threads per block
constexpr int WCOLS = 16;           // columns per warp per pass
constexpr int UNIT = NW * WCOLS;    // columns per block per pass
constexpr int GMAX = 32;            // query heads per block

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
