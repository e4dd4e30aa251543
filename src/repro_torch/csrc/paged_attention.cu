// Paged single-token decode attention: q (B, 1, Hq, D) over a shared pool
// k/v_pages (P, page_size, Hkv, D); token t of slot b lives in pool page
// page_table[b, t / page_size] (table (B, n_pages) int32), row
// t % page_size; per-slot valid lengths cache_len (B,) int32; optional logit
// softcap, no sliding window (the paged cache rejects it).
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_decode_attention_pallas (body _paged_decode_kernel).  The block reads
// the page table itself, where the TPU kernel took it by scalar prefetch.
// The device body, its bound and its design are in decode_attention.cuh;
// with the same kv_block it does the dense kernel's arithmetic in the same
// order, so paged and dense decode agree bit for bit on the same rows.
#include "decode_attention.cuh"

extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const int* page_table,
                                            const int* cache_len, void* o, int B,
                                            int page_size, int n_pages, int Hq,
                                            int Hkv, int D, float softcap, float scale,
                                            int kv_block, int dtype, void* stream) {
  repro::DecodeArgs a{q, k_pages, v_pages, page_table, cache_len, o,
                      n_pages * page_size, Hq, Hkv, D, 0, softcap, scale,
                      kv_block, page_size, n_pages};
  return repro::launch_decode<true>(a, B, dtype, static_cast<cudaStream_t>(stream));
}
