// Single-token decode attention over a dense or a paged KV cache — the one
// device body behind repro_decode_attention (decode_attention.cu) and
// repro_paged_decode_attention (paged_attention.cu).
//
// Bound on the H100: bytes.  Each step reads every valid K/V row of every
// slot once for 2 * G flops per element (G = Hq / Hkv = 4 for llama3.2-1b),
// three orders of magnitude below the card's flops/byte ridge.  Design:
// one CUDA block per (slot, kv head) holding that group's G query heads, so
// each K/V row is read from device memory once per group, not once per
// query head.  The block stages `kv_block` K/V rows in shared memory as fp32
// (K rows padded by one float so the score pass is free of bank conflicts),
// computes the G x kv_block scores, runs the online softmax with one warp per
// head, and accumulates P.V into a G x D fp32 accumulator in shared memory.
// Known limit: only B * Hkv blocks run (32 at batch 4), far fewer than the
// 132 SMs; splitting the KV axis across blocks (flash-decoding) is later
// work.
//
// Lengths follow the reference semantics exactly: slot b attends to
// positions [max(0, len - window), min(len, capacity)), where capacity is
// the cache's rows (dense) or n_pages * page_size (paged).  An empty
// batcher slot's length grows past the capacity; the rows beyond it do not
// exist and are never read.  Paged: logical row t of slot b lives in pool
// page page_table[b, t / page_size], row t % page_size; table entries at or
// past the slot's length are never dereferenced.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeThreads = 128;

struct DecodeArgs {
  const void* q;           // (B, 1, Hq, D)
  const void* k;           // dense (B, Skv, Hkv, D) | paged pool (P, page_size, Hkv, D)
  const void* v;
  const int* page_table;   // paged: (B, n_pages); dense: null
  const int* cache_len;    // (B,)
  void* o;                 // (B, 1, Hq, D)
  int Skv;                 // dense rows per slot (paged: n_pages * page_size)
  int Hq, Hkv, D;
  int window;              // dense only; 0 = off
  float softcap, scale;
  int kv_block;
  int page_size, n_pages;  // paged only
};

inline size_t decode_smem_bytes(int kv_block, int D, int G) {
  const size_t floats = static_cast<size_t>(kv_block) * (D + 1)  // K (padded)
                        + static_cast<size_t>(kv_block) * D      // V
                        + 2 * static_cast<size_t>(G) * D         // Q, acc
                        + static_cast<size_t>(G) * kv_block      // scores / probs
                        + 3 * static_cast<size_t>(G);            // m, l, alpha
  return floats * sizeof(float);
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(DecodeArgs a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, BN = a.kv_block, G = a.Hq / a.Hkv;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BN * (D + 1);
  float* Qs = Vs + BN * D;
  float* Acc = Qs + G * D;
  float* S = Acc + G * D;
  float* M = S + G * BN;
  float* L = M + G;
  float* Alpha = L + G;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kDecodeThreads / 32;
  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int len = a.cache_len[b];
  const int len_eff = min(len, a.Skv);
  const int lo = (!PAGED && a.window > 0) ? max(0, len - a.window) : 0;

  for (int e = tid; e < G * D; e += kDecodeThreads) {
    Qs[e] = to_float(q[(static_cast<size_t>(b) * a.Hq + hk * G) * D + e]) * a.scale;
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    M[g] = kNegInf;
    L[g] = 0.f;
  }

  for (int kv0 = (lo / BN) * BN; kv0 < len_eff; kv0 += BN) {
    __syncthreads();  // the previous tile is consumed (and Q/acc are set)
    for (int e = tid; e < BN * D; e += kDecodeThreads) {
      const int j = e / D, d = e % D, pos = kv0 + j;
      float kk = 0.f, vv = 0.f;
      if (pos < len_eff) {
        size_t row;
        if (PAGED) {
          const int pid = a.page_table[b * a.n_pages + pos / a.page_size];
          row = static_cast<size_t>(pid) * a.page_size + pos % a.page_size;
        } else {
          row = static_cast<size_t>(b) * a.Skv + pos;
        }
        const size_t off = (row * a.Hkv + hk) * D + d;
        kk = to_float(kc[off]);
        vv = to_float(vc[off]);
      }
      Ks[j * (D + 1) + d] = kk;
      Vs[j * D + d] = vv;
    }
    __syncthreads();
    // scores for the G heads x BN keys
    for (int e = tid; e < G * BN; e += kDecodeThreads) {
      const int g = e / BN, j = e % BN, pos = kv0 + j;
      float s = kNegInf;
      if (pos < len_eff && pos >= lo) {
        const float* qg = Qs + g * D;
        const float* kr = Ks + j * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qg[d] * kr[d];
        s = softcap_fn(dot, a.softcap);
      }
      S[e] = s;
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int j = lane; j < BN; j += 32) mx = fmaxf(mx, S[g * BN + j]);
      mx = warp_max(mx);
      const float m_old = M[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BN; j += 32) {
        const int pos = kv0 + j;
        const bool vis = pos < len_eff && pos >= lo;
        const float p = vis ? expf(S[g * BN + j] - m_new) : 0.f;
        S[g * BN + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        M[g] = m_new;
        L[g] = L[g] * alpha + sum;
        Alpha[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P.V
    for (int e = tid; e < G * D; e += kDecodeThreads) {
      const int g = e / D, d = e % D;
      const float* pg = S + g * BN;
      float acc = Acc[e] * Alpha[g];
      for (int j = 0; j < BN; ++j) acc += pg[j] * Vs[j * D + d];
      Acc[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kDecodeThreads) {
    const float l = L[e / D];
    const float denom = l == 0.f ? 1.f : l;
    o[(static_cast<size_t>(b) * a.Hq + hk * G) * D + e] = from_float<T>(Acc[e] / denom);
  }
}

template <bool PAGED>
inline int launch_decode(const DecodeArgs& a, int B, int dtype, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = decode_smem_bytes(a.kv_block, a.D, G);
  dim3 grid(a.Hkv, B);
  cudaError_t err;
  if (dtype == kFloat32) {
    auto kernel = decode_attention_kernel<float, PAGED>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDecodeThreads, smem, stream>>>(a);
  } else if (dtype == kBFloat16) {
    auto kernel = decode_attention_kernel<__nv_bfloat16, PAGED>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDecodeThreads, smem, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
