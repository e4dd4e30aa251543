// Prefill (and non-causal cross-) attention with an online softmax in fp32.
// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), out (B, Sq, Hq, D), contiguous.
// Masks: causal (with q_offset), sliding window, padding past Skv; logit
// softcap; GQA maps q head h to kv head h / (Hq / Hkv).  A fully masked row
// gives 0, as the TPU kernel's finalize does.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _attn_kernel).
//
// Bound on the H100: at the serving shapes (S = 64..200, D = 64) the work is
// a few MFLOP per (batch, head) and the card's bound is bytes; at long
// prompts it is tensor-core flops.  This first kernel uses neither well:
// it computes with fp32 FMAs, no tensor cores (wgmma/TMA are later work).
// Design: one CUDA block per (q tile, q head, batch), one thread per query
// row holding its scaled q row and its fp32 accumulator in registers, so
// the online-softmax statistics need no cross-thread reduction.  Each step
// stages `kv_block` K/V rows in shared memory as fp32 (every thread of the
// block reads the same K row: a broadcast, no bank conflicts) and walks
// them in chunks of 8 keys, rescaling the accumulator once per chunk.  KV
// tiles that are masked for every row of the block (causal future, rows
// before the window) are never loaded.  Where the TPU kernel carried its
// statistics across a sequential grid axis, this kernel's loop over KV
// tiles runs inside the block; blocks share nothing.
#include "common.cuh"

namespace repro {

constexpr int kChunk = 8;

template <typename T, int HD>
__global__ void flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ o,
                                       int Sq, int Skv, int Hq, int Hkv, int causal,
                                       int window, float softcap, float scale,
                                       int q_offset, int kv_block) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kv_block * HD;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int BM = blockDim.x;
  const int row = tile * BM + threadIdx.x;
  const bool active = row < Sq;
  const int q_pos = q_offset + row;

  // the block's visible KV range: [kv_lo, kv_hi)
  const int q_first = q_offset + tile * BM;
  const int q_last = q_offset + min(tile * BM + BM, Sq) - 1;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  float qr[HD];
  float acc[HD];
  const T* qrow = q + (static_cast<size_t>(b) * Sq + (active ? row : 0)) * Hq * HD +
                  static_cast<size_t>(h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_float(qrow[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int kv0 = (kv_lo / kv_block) * kv_block; kv0 < kv_hi; kv0 += kv_block) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kv_block * HD; e += BM) {
      const int j = e / HD, d = e % HD, pos = kv0 + j;
      float kk = 0.f, vv = 0.f;
      if (pos < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + pos) * Hkv + hk) * HD + d;
        kk = to_float(k[off]);
        vv = to_float(v[off]);
      }
      Ks[e] = kk;
      Vs[e] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int jmax = min(kv_block, kv_hi - kv0);
    for (int j0 = 0; j0 < jmax; j0 += kChunk) {
      float s[kChunk];
      bool vis[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c, pos = kv0 + j;
        vis[c] = j < jmax && (!causal || pos <= q_pos) &&
                 (window <= 0 || pos > q_pos - window);
        s[c] = kNegInf;
        if (vis[c]) {
          const float4* kr = reinterpret_cast<const float4*>(Ks + j * HD);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kv4 = kr[d4];
            dot += qr[4 * d4] * kv4.x;
            dot += qr[4 * d4 + 1] * kv4.y;
            dot += qr[4 * d4 + 2] * kv4.z;
            dot += qr[4 * d4 + 3] * kv4.w;
          }
          s[c] = softcap_fn(dot, softcap);
        }
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!vis[c]) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + c) * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv4 = vr[d4];
          acc[4 * d4] += p * vv4.x;
          acc[4 * d4 + 1] += p * vv4.y;
          acc[4 * d4 + 2] += p * vv4.z;
          acc[4 * d4 + 3] += p * vv4.w;
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float denom = l == 0.f ? 1.f : l;  // fully masked rows -> 0
  T* orow = o + (static_cast<size_t>(b) * Sq + row) * Hq * HD + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) orow[d] = from_float<T>(acc[d] / denom);
}

template <typename T, int HD>
static cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                             int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                             int window, float softcap, float scale, int q_offset,
                             int q_block, int kv_block, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kv_block) * HD * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + q_block - 1) / q_block, Hq, B);
  kernel<<<grid, q_block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq, Hkv, causal, window, softcap, scale,
      q_offset, kv_block);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                          int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                          int window, float softcap, float scale, int q_offset,
                          int q_block, int kv_block, cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                           \
  case HD:                                                                          \
    return launch_hd<T, HD>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, \
                            scale, q_offset, q_block, kv_block, stream);
  switch (D) {
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int D, int causal, int window,
                                     float softcap, float scale, int q_offset,
                                     int q_block, int kv_block, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                                softcap, scale, q_offset, q_block, kv_block, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                        window, softcap, scale, q_offset, q_block,
                                        kv_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
