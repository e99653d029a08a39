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
// The shard axis is folded into the batch: batch row b reads query row
// and means row b / rep, and its own cache shard, `valid` and log g rows.
//
// What bounds it on an H100: memory.  Each cache column is read once and
// used for a handful of FMAs per query head, so the floor is the K/V
// bytes over the 3.35 TB/s HBM rate (about 28 MB per layer on the main
// path: B = 8, 4 shards of 144 columns, 12 heads of 64, f32).
//
// Design: a split-K flash-decode whose split is the shard axis: one
// block of 128 threads per (batch row x shard, KV head).  The block
// streams its shard's columns, then the means columns, in tiles of 64
// staged in shared memory (padded row stride, conflict-free).  The
// grp = Hq / Hkv query heads that share the KV head are handed to the
// four warps in turn, so any group size works (the chunked-prefill
// caller folds C * Hq queries into the head axis later); each warp's
// lanes compute two scores each, reduce max and sum with shuffles, and
// own hd / 32 output dims of the row's accumulator.  The running
// (m, l, acc) of every query row lives in shared memory across tiles.
// This is the simple, correct form: with grp = 1 only one warp computes
// while all four load; splitting each shard further and TMA loads are
// for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BK = 64;   // columns per tile
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;

template <int HD>
__global__ void __launch_bounds__(NT) decode_stats_kernel(
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
  constexpr int LD = HD + 1;
  constexpr int DPL = (HD + 31) / 32;   // output dims per lane
  const int grp = Hq / Hkv;
  extern __shared__ float smem[];
  float* sK = smem;                     // BK x LD
  float* sV = sK + BK * LD;             // BK x LD
  float* sP = sV + BK * LD;             // NW x BK probabilities
  float* sQ = sP + NW * BK;             // grp x HD query rows
  float* sAcc = sQ + grp * HD;          // grp x HD running accumulators
  float* sM = sAcc + grp * HD;          // grp running maxima
  float* sL = sM + grp;                 // grp running sums
  __shared__ float sBias[BK];
  __shared__ uint8_t sOk[BK];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int bq = b / rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < grp * HD; i += NT) {
    sQ[i] = q[((size_t)bq * Hq + kvh * grp) * HD + i];
    sAcc[i] = 0.f;
  }
  for (int i = tid; i < grp; i += NT) {
    sM[i] = NEG;
    sL[i] = 0.f;
  }

  const int nt_loc = (M + BK - 1) / BK;
  const int nt = nt_loc + (kz != nullptr ? (MZ + BK - 1) / BK : 0);
  for (int t = 0; t < nt; ++t) {
    const bool means = t >= nt_loc;
    const int c0 = (means ? t - nt_loc : t) * BK;
    const int mc = means ? MZ : M;
    const float* ks = means ? kz + (size_t)bq * MZ * Hkv * HD
                            : k + (size_t)b * M * Hkv * HD;
    const float* vs = means ? vz + (size_t)bq * MZ * Hkv * HD
                            : v + (size_t)b * M * Hkv * HD;
    __syncthreads();                    // previous tile fully consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int cc = idx / HD, d = idx % HD, c = c0 + cc;
      const size_t off = ((size_t)c * Hkv + kvh) * HD + d;
      sK[cc * LD + d] = c < mc ? ks[off] : 0.f;
      sV[cc * LD + d] = c < mc ? vs[off] : 0.f;
    }
    if (tid < BK) {
      const int c = c0 + tid;
      if (means) {
        sOk[tid] = c < mc;
        sBias[tid] = c < mc ? log_gz[(size_t)b * MZ + c] : 0.f;
      } else {
        sOk[tid] = c < mc && valid[(size_t)b * M + c] != 0;
        sBias[tid] = 0.f;
      }
    }
    __syncthreads();

    float* pw = sP + warp * BK;
    for (int g = warp; g < grp; g += NW) {
      const float* qr = sQ + g * HD;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = lane + 32 * u;
        const float* kr = sK + cc * LD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        // local columns: valid ? s : NEG; means columns: max(s + log g,
        // NEG) -- the clamp keeps a dead mean at the sentinel
        s[u] = sOk[cc] ? fmaxf(dot * scale + sBias[cc], NEG) : NEG;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // dead columns are re-zeroed: an all-dead row keeps l = 0
        const float p = s[u] > NEG * 0.5f ? expf(s[u] - m_new) : 0.f;
        pw[lane + 32 * u] = p;
        ps += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      __syncwarp();                     // pw complete
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) {
          float a = sAcc[g * HD + d] * corr;
          for (int cc = 0; cc < BK; ++cc) a = fmaf(pw[cc], sV[cc * LD + d], a);
          sAcc[g * HD + d] = a;
        }
      }
      __syncwarp();                     // every lane read sM[g] and pw
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * corr + ps;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < grp * HD; i += NT)
    acc_out[((size_t)b * Hq + kvh * grp) * HD + i] = sAcc[i];
  for (int i = tid; i < grp; i += NT) {
    m_out[(size_t)b * Hq + kvh * grp + i] = sM[i];
    l_out[(size_t)b * Hq + kvh * grp + i] = sL[i];
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v,
           const uint8_t* valid, const float* log_gz, const float* kz,
           const float* vz, float* m_out, float* l_out, float* acc_out,
           int B, int M, int MZ, int Hq, int Hkv, int rep, float scale,
           cudaStream_t stream) {
  const int grp = Hq / Hkv;
  const size_t smem = sizeof(float) * (2 * BK * (HD + 1) + NW * BK +
                                       2 * grp * HD + 2 * grp);
  cudaError_t e = cudaFuncSetAttribute(
      decode_stats_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, Hkv);
  decode_stats_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, valid, log_gz, kz, vz, m_out, l_out, acc_out, M, MZ, Hq, Hkv,
      rep, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_stats_f32(
    const void* q, const void* k, const void* v, const void* valid,
    const void* log_gz, const void* kz, const void* vz, void* m_out,
    void* l_out, void* acc_out, int B, int M, int MZ, int Hq, int Hkv,
    int hd, int rep, float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* lg = static_cast<const float*>(log_gz);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vzf = static_cast<const float*>(vz);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  auto* ao = static_cast<float*>(acc_out);
  auto st = static_cast<cudaStream_t>(stream);
  // one head dim per ported model (GPT-2: 64); each instantiation is
  // fully unrolled and lengthens the build
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return launch<64>(qf, kf, vf, ok, lg, kzf, vzf, mo, lo, ao, B, M, MZ, Hq,
                    Hkv, rep, scale, st);
}
