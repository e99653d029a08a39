// PRISM scaling-aware flash attention (prefill), bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prism_attention.py
// (prism_flash_attention, body _kernel) at bf16, as prism_attention.cu
// replaces it at f32: the same function (the +log g column bias, the
// Eq. 17 mask from positions, causal / prefix_len / window, GQA, the
// shard axis folded into the batch, a row that sees nothing gives 0),
// with q, k and v in bf16 and the output in bf16.
//
// What it computes, in the reference's dtypes: QK^T of bf16 operands
// accumulated in f32 (the reference's dot_general with
// preferred_element_type=f32), the bias, mask and online softmax in f32,
// p rounded to bf16 before P V (the reference's p.astype(v.dtype)) while
// l sums the unrounded p, P V accumulated in f32, the normalised output
// rounded to bf16 once.
//
// What bounds it on an H100.  Half the f32 kernel's bytes, and its
// products at the tensor cores' bf16 rate (989 TFLOP/s dense) where the
// f32 kernel's f32-accurate ones take three TF32 products each (165): at
// GPT-2's PRISM layer (Nq 128, M 256, B 8 x P 4) 38 MB, about 11 us at
// 3.35 TB/s, against 1.4 us of operations.  Bytes, then, and the fixed
// cost of a block's tile scan and first load.
//
// Design (FlashAttention-2's, as the f32 kernel's):
// - One block of 4 warps per (64-row query tile, query head, batch row);
//   each warp owns 16 query rows and all of the head's output dims.  One
//   mma.sync m16n8k16 bf16 product a (16-row, 8-column, 16-dim) step
//   (mma_bf16.cuh).  The score accumulator's layout (rows g, g + 8;
//   columns 2t, 2t + 1 of each 8-column n-tile) is P's A fragment for P V
//   as it stands: two n-tiles make one 16-column k-step, each pair of
//   entries packed to bf16 in one register.
// - Q is parked once in shared memory in A-fragment order (one uint4 a
//   lane a 16-dim k-step), read back by its own lane each tile: 2 KB a
//   k-step a block, 32 KB at head dim 256.  So no head dim computes QK^T
//   twice (the f32 kernel's hd-256 layout does) and every warp keeps its
//   whole output accumulator in registers: HD / 2 floats a lane, 128 at
//   head dim 256, where the kernel is built for one block an SM (up to
//   255 registers).
// - K and V tiles of 32 columns stream through a two-stage cp.async ring
//   with rows padded to HD + 8 bf16 (a whole 16-byte copy): K's B
//   fragments are 32-bit loads (two dims of one column), V's are two
//   16-bit loads (one dim of two columns) packed.  The tile metadata
//   (log g, lo, hi) comes with its tile.  The exact tile skip and the
//   mask rule are prism_attention.cu's (prism_tiles.cuh).
// - Head dims 16, 32, 64, 80, 128 and 256: 1 to 16 k-steps of QK^T, 2
//   to 32 n-tiles of P V.  72 registers at head dim 16 to 227 at 256, no
//   spill.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): GPT-2's PRISM
// layer 0.042 ms against bf16 SDPA's 0.034 and its bound of 0.011
// (bytes), Voltage 0.068 (0.049); Yi-6B's PRISM 0.124 (0.102); Gemma 7B's
// PRISM at head dim 256 0.128, faster than SDPA (0.141) and than the f32
// kernel's two-pass 0.547.  The likely limits: V's fragments are two
// 16-bit loads each, and a 32-column tile a loop step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "prism_tiles.cuh"

namespace {

using prism::NEG;
using prism::visible;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::pack_bits;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BK = 32;          // K/V columns per tile
constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;     // threads per block
constexpr int STAGES = 2;       // cp.async ring depth

// one ring stage, in bytes: K and V tiles (bf16, rows of LD), then log g,
// lo, hi per column (4 bytes each)
template <int HD>
struct Stage {
  static constexpr int LD = HD + 8;                 // row stride (bf16)
  static constexpr int K = 0;
  static constexpr int V = K + BK * LD * 2;
  static constexpr int LG = V + BK * LD * 2;
  static constexpr int LO = LG + BK * 4;
  static constexpr int HI = LO + BK * 4;
  static constexpr int BYTES = HI + BK * 4;
  static_assert(BYTES % 16 == 0, "stage alignment");
};

// blocks an SM the kernel is built for: up to head dim 64 three; above it
// one, which lets a lane take up to 255 registers (head dim 256 keeps a
// 128-float accumulator)
constexpr int min_blocks(int hd) { return hd <= 64 ? 3 : 1; }

template <int HD>
__global__ void __launch_bounds__(NT, min_blocks(HD))
    prism_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Nq, Hq, HD)
    const __nv_bfloat16* __restrict__ k,   // (B / rep, M, Hkv, HD)
    const __nv_bfloat16* __restrict__ v,   // (B / rep, M, Hkv, HD)
    const float* __restrict__ log_g,       // (P, M)
    const int* __restrict__ col_lo,        // (P, M)
    const int* __restrict__ col_hi,        // (P, M)
    const int* __restrict__ row_pos,       // (P, Nq)
    __nv_bfloat16* __restrict__ out,       // (B, Nq, Hq, HD)
    int Nq, int M, int Hq, int Hkv, int rep, int P, int causal,
    int prefix_len, int has_window, int window, float scale) {
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  using S = Stage<HD>;
  constexpr int LD = S::LD;
  constexpr int KS = HD / 16;           // k-steps of QK^T
  constexpr int NJ = BK / 8;            // n-tiles of QK^T
  constexpr int KP = BK / 16;           // k-steps of P V
  constexpr int ND = HD / 8;            // n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  // after the ring: Q in A-fragment order (a uint4 a lane a k-step), then
  // the live tiles' indices
  uint4* s_q = reinterpret_cast<uint4*>(smem + STAGES * S::BYTES);
  int* s_tiles = reinterpret_cast<int*>(s_q + NW * KS * 32);
  __shared__ int s_int[3];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (Hq / Hkv);
  const int bk = b / rep;
  const int pm = b % P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread-in-group

  // ---- this warp's Q rows g and g + 8 in A-fragment order, parked ------
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Nq, ok1 = r1 < Nq;
  {
    const __nv_bfloat16* qp0 =
        q + ((size_t)(b * Nq + (ok0 ? r0 : 0)) * Hq + h) * HD;
    const __nv_bfloat16* qp1 =
        q + ((size_t)(b * Nq + (ok1 ? r1 : 0)) * Hq + h) * HD;
    uint4* my_q = s_q + warp * KS * 32 + lane;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      const int d = ks * 16 + 2 * t;
      auto pair = [&](const __nv_bfloat16* row, bool ok, int dd) {
        return ok ? *reinterpret_cast<const uint32_t*>(row + dd) : 0u;
      };
      my_q[ks * 32] = make_uint4(pair(qp0, ok0, d), pair(qp1, ok1, d),
                                 pair(qp0, ok0, d + 8),
                                 pair(qp1, ok1, d + 8));
    }
  }
  const int rp0 = ok0 ? row_pos[pm * Nq + r0] : INT_MIN;
  const int rp1 = ok1 ? row_pos[pm * Nq + r1] : INT_MIN;

  // ---- which tiles can any row of this query tile see? ----------------
  const int nlive = prism::live_tiles<BQ, BK, NT>(
      log_g, col_lo, col_hi, row_pos, pm, q0, Nq, M, causal, prefix_len,
      has_window, window, s_tiles, s_int);

  auto load_tile = [&](int tile, int stage) {
    unsigned char* st = smem + stage * S::BYTES;
    auto* sK = reinterpret_cast<__nv_bfloat16*>(st + S::K);
    auto* sV = reinterpret_cast<__nv_bfloat16*>(st + S::V);
    const int c0 = tile * BK;
    for (int i = tid; i < BK * HD / 8; i += NT) {     // 8 bf16 a copy
      const int cc = i / (HD / 8), d8 = (i % (HD / 8)) * 8;
      const int c = c0 + cc;
      const bool ok = c < M;
      const size_t off =
          ((size_t)(bk * M + (ok ? c : 0)) * Hkv + kvh) * HD + d8;
      cp_async16(sK + cc * LD + d8, k + off, ok);
      cp_async16(sV + cc * LD + d8, v + off, ok);
    }
    if (tid < BK) {
      const int c = c0 + tid;
      const bool ok = c < M;
      const int o = pm * M + (ok ? c : 0);
      cp_async4(st + S::LG + 4 * tid, log_g + o, ok);
      cp_async4(st + S::LO + 4 * tid, col_lo + o, ok);
      cp_async4(st + S::HI + 4 * tid, col_hi + o, ok);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nlive) load_tile(s_tiles[s], s);
    cp_async_commit();
  }
  __syncthreads();                      // Q parked (and read below per lane)
  const uint4* my_q = s_q + warp * KS * 32 + lane;

  // online softmax state in the log2 domain; l is this thread's partial
  // sum over its columns (the quad is reduced once, at the end)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
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
    const unsigned char* st = smem + (it % STAGES) * S::BYTES;
    const auto* sK = reinterpret_cast<const __nv_bfloat16*>(st + S::K);
    const auto* sV = reinterpret_cast<const uint16_t*>(st + S::V);
    const float* sLg = reinterpret_cast<const float*>(st + S::LG);
    const int* sLo = reinterpret_cast<const int*>(st + S::LO);
    const int* sHi = reinterpret_cast<const int*>(st + S::HI);
    const int c0 = s_tiles[it] * BK;

    // S = Q K^T; n-tile j, entry e holds column j*8 + 2t + (e & 1) of
    // row g + 8*(e >> 1)
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint4 q4 = my_q[ks * 32];
      const uint32_t a[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(sc[j], a, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, bias, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = j * 8 + 2 * t + (e & 1), rr = e >> 1;
        const bool vis = c0 + cc < M && sLg[cc] > NEG * 0.5f &&
                         (rr ? ok1 : ok0) &&
                         visible(sLo[cc], sHi[cc], rr ? rp1 : rp0, causal,
                                 prefix_len, has_window, window);
        const float x = fmaf(sc[j][e], scale, sLg[cc]) * LOG2E;
        sc[j][e] = vis ? x : -INFINITY;
        mx[rr] = fmaxf(mx[rr], sc[j][e]);
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
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

    // O += P V: n-tiles 2kk and 2kk + 1 of the scores are P's A fragment
    // for k-step kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const uint16_t* v0 = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const uint16_t* vj = v0 + j * 8;
        mma_bf16(o[j], a, pack_bits(vj[0], vj[LD]),
                 pack_bits(vj[8 * LD], vj[9 * LD]));
      }
    }
  }
  cp_async_wait<0>();

  // normalise and store in bf16: entry e of n-tile j is dim j*8 + 2t +
  // (e & 1) of row g + 8*(e >> 1)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = rr ? r1 : r0;
    if (r < Nq) {
      __nv_bfloat16* op = out + ((size_t)(b * Nq + r) * Hq + h) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8) =
            pack_bf16(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
    }
  }
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const float* log_g, const int* col_lo,
           const int* col_hi, const int* row_pos, __nv_bfloat16* out, int B,
           int Nq, int M, int Hq, int Hkv, int rep, int P, int causal,
           int prefix_len, int has_window, int window, float scale,
           cudaStream_t stream) {
  const int ntiles = (M + BK - 1) / BK;
  const size_t smem = (size_t)STAGES * Stage<HD>::BYTES +
                      sizeof(uint4) * NW * (HD / 16) * 32 +
                      sizeof(int) * ntiles;
  cudaError_t e = cudaFuncSetAttribute(
      prism_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nq + BQ - 1) / BQ, Hq, B);
  prism_attention_bf16_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, log_g, col_lo, col_hi, row_pos, out, Nq, M, Hq, Hkv, rep, P,
      causal, prefix_len, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prism_attention_bf16(
    const void* q, const void* k, const void* v, const void* log_g,
    const void* col_lo, const void* col_hi, const void* row_pos, void* out,
    int B, int Nq, int M, int Hq, int Hkv, int hd, int rep, int P,
    int causal, int prefix_len, int has_window, int window, float scale,
    void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* lg = static_cast<const float*>(log_g);
  const auto* lo = static_cast<const int*>(col_lo);
  const auto* hi = static_cast<const int*>(col_hi);
  const auto* rp = static_cast<const int*>(row_pos);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // the f32 kernel's head dims (prism_attention.cu): 16 and 32 (the
  // reference's test grid, the char-LM), 64, 80, 128, 256
  switch (hd) {
#define PRISM_BF16_CASE(HD)                                                  \
  case HD:                                                                   \
    return launch<HD>(qb, kb, vb, lg, lo, hi, rp, o, B, Nq, M, Hq, Hkv, rep, \
                      P, causal, prefix_len, has_window, window, scale, st);
    PRISM_BF16_CASE(16)
    PRISM_BF16_CASE(32)
    PRISM_BF16_CASE(64)
    PRISM_BF16_CASE(80)
    PRISM_BF16_CASE(128)
    PRISM_BF16_CASE(256)
#undef PRISM_BF16_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
