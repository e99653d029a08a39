// Single-token flash-decode partial softmax stats over a bf16 cache, for
// sm_90a: the C entry points of the kernels in decode_attention.cuh (the
// design, what bounds them and what was measured are there),
// instantiated for bf16 K/V (the means K/V cast to K's dtype by the
// wrapper).  The query is f32: the wrapper widens a bf16 one, exactly.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (flash_decode_stats, body _decode_kernel).
#include "decode_attention.cuh"

extern "C" int flash_decode_stats_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* log_gz, const void* kz, const void* vz, const void* rows,
    const void* pages, const void* zrows, void* m_out, void* l_out,
    void* acc_out, int B, int M, int MZ, int Hq, int Hkv, int hd, int rep,
    int ppr, int pc, int n_pages, int n_zrows, float scale, void* stream) {
  return decode_row_entry<__nv_bfloat16>(
      q, k, v, valid, log_gz, kz, vz, rows, pages, zrows, m_out, l_out,
      acc_out, B, M, MZ, Hq, Hkv, hd, rep, ppr, pc, n_pages, n_zrows, scale,
      stream);
}

// the tile route: no row map (output row b reads cache row b / rep)
extern "C" int flash_decode_stats_mq_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* log_gz, const void* kz, const void* vz, const void* pages,
    const void* zrows, void* m_out, void* l_out, void* acc_out, int B,
    int M, int MZ, int Hq, int Hkv, int hd, int rep, int ppr, int pc,
    int n_pages, int n_zrows, float scale, void* stream) {
  return decode_tile_entry<__nv_bfloat16>(
      q, k, v, valid, log_gz, kz, vz, pages, zrows, m_out, l_out, acc_out, B,
      M, MZ, Hq, Hkv, hd, rep, ppr, pc, n_pages, n_zrows, scale, stream);
}
