// Dense single-token decode attention: q (B, 1, Hq, D) over a per-slot cache
// k/v (B, Skv, Hkv, D) with per-slot valid lengths cache_len (B,) int32;
// optional sliding window and logit softcap.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// decode_attention_pallas (body _decode_kernel).  The device body, its
// bound and its design are in decode_attention.cuh.
#include "decode_attention.cuh"

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* cache_len, void* o, int B, int Skv,
                                      int Hq, int Hkv, int D, int window,
                                      float softcap, float scale, int kv_block,
                                      int dtype, void* stream) {
  repro::DecodeArgs a{q, k, v, nullptr, cache_len, o, Skv, Hq, Hkv, D, window,
                      softcap, scale, kv_block, 0, 0};
  return repro::launch_decode<false>(a, B, dtype, static_cast<cudaStream_t>(stream));
}
