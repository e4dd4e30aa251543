// Single-token decode attention over a dense or a paged KV cache — the one
// device body behind repro_decode_attention (decode_attention.cu) and
// repro_paged_decode_attention (paged_attention.cu) — split over the KV axis
// in one launch (flash-decoding).
//
// Bound on the H100: bytes.  Each step reads every valid K/V row of every
// slot once for 2 * G flops per element (G = Hq / Hkv = 4 for llama3.2-1b),
// three orders of magnitude below the card's flops/byte ridge.  With one
// block per (slot, kv head) only B * Hkv blocks run (32 at batch 4), each
// walking its whole cache serially: the kernel is latency-bound, far from
// its byte bound.  Design:
// - grid (Hkv, B, n_split).  A block takes the G query heads of one kv head,
//   so each K/V row is read once per group, over one contiguous range of
//   split_rows logical positions (a whole number of kv_block tiles).  The
//   host picks n_split from shapes only (capacity, kv_block, B, Hkv, SM
//   count; see plan_decode_splits in kernels/flash_attention/kernel.py),
//   never from cache_len: reading the lengths would synchronise the device
//   every step.  Blocks whose range holds no visible row exit at once;
// - K/V tiles are copied in their storage type into a two-stage ring of
//   shared memory with cp.async (16 bytes a thread, zero-filled past the
//   slot's length), so the copy of tile j + 1 overlaps the math on tile j;
// - scores and the online softmax take one warp per head and one lane per
//   key (K rows padded by 16 bytes, so the lanes' 16-byte reads of
//   consecutive rows are free of bank conflicts); the row max and sum are
//   warp reductions, each head's running max and sum stay in fp32; P V
//   takes one thread per (head, pair of dims) into a G x D fp32
//   accumulator;
// - the splits are combined in the same launch.  With one active split its
//   block writes the output.  Otherwise each active block writes its partial
//   (unnormalised fp32 accumulator, max, sum) to a scratch buffer, fences,
//   and takes a ticket from a per-(slot, kv head) counter; the last block to
//   arrive combines the partials in split order, writes the output and
//   resets the counter to 0 for the next launch.  The fixed order keeps the
//   result the same from run to run, and the same split boundaries keep
//   paged decode equal to dense decode bit for bit at equal capacity.
// fp32 and bf16 caches both take this body (no tensor cores: G is 4 and
// the work is bytes-bound).
//
// Lengths follow the reference semantics exactly: slot b attends to
// positions [max(0, len - window), min(len, capacity)), where capacity is
// the cache's rows (dense) or n_pages * page_size (paged).  An empty
// batcher slot's length grows past the capacity; the rows beyond it do not
// exist and are never read.  A slot with no visible row gives 0.  Paged:
// logical row t of slot b lives in pool page page_table[b, t / page_size],
// row t % page_size, looked up per row, so a split may start mid-page;
// table entries at or past the slot's length are never dereferenced.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeStages = 2;

struct DecodeArgs {
  const void* q;           // (B, 1, Hq, D)
  const void* k;           // dense (B, Skv, Hkv, D) | paged pool (P, page_size, Hkv, D)
  const void* v;
  const int* page_table;   // paged: (B, n_pages); dense: null
  const int* cache_len;    // (B,)
  void* o;                 // (B, 1, Hq, D)
  int Skv;                 // capacity: dense rows per slot (paged: n_pages * page_size)
  int Hq, Hkv, D;
  int window;              // dense only; 0 = off
  float softcap, scale;
  int kv_block;
  int page_size, n_pages;  // paged only
  int n_split, split_rows; // split_rows: a multiple of kv_block
  float* partial;          // (B * Hkv, n_split, G, D + 2) fp32: acc, then m, l
  int* counters;           // (B * Hkv,), 0 between launches
};

// shared K rows are padded by 16 bytes, so that lanes reading 16 bytes of
// consecutive rows hit distinct banks
template <typename T>
__host__ __device__ inline int decode_k_ld(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
inline size_t decode_smem_bytes(int kv_block, int D, int G) {
  const size_t kv = static_cast<size_t>(kDecodeStages) * kv_block *
                    (decode_k_ld<T>(D) + D) * sizeof(T);
  const size_t floats = 2 * static_cast<size_t>(G) * D      // Q, acc
                        + static_cast<size_t>(G) * kv_block  // probabilities
                        + 3 * static_cast<size_t>(G);        // m, l, alpha
  return kv + floats * sizeof(float);
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  load16(p, out);
  load16(p + 4, out + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  load16(p, out);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(DecodeArgs a) {
  extern __shared__ uint4 smem_u4[];
  const int D = a.D, BN = a.kv_block, G = a.Hq / a.Hkv;
  const int KLD = decode_k_ld<T>(D);
  T* Kst = reinterpret_cast<T*>(smem_u4);            // [stage][BN][KLD]
  T* Vst = Kst + kDecodeStages * BN * KLD;           // [stage][BN][D]
  float* Qs = reinterpret_cast<float*>(Vst + kDecodeStages * BN * D);
  float* Acc = Qs + G * D;
  float* P = Acc + G * D;
  float* M = P + G * BN;
  float* L = M + G;
  float* Alpha = L + G;
  __shared__ int last_block;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  T* orow = o + (static_cast<size_t>(b) * a.Hq + hk * G) * D;

  const int len = a.cache_len[b];
  const int len_eff = min(len, a.Skv);
  const int lo = (!PAGED && a.window > 0) ? max(0, len - a.window) : 0;

  // the splits that hold a visible row, from the length alone: every block
  // of the group agrees on them
  const int s_first = lo / a.split_rows;
  const int n_active = len_eff > lo ? (len_eff - 1) / a.split_rows - s_first + 1 : 0;
  if (n_active == 0) {  // nothing visible: the output is 0
    if (split == 0)
      for (int e = tid; e < G * D; e += kDecodeThreads) orow[e] = from_float<T>(0.f);
    return;
  }
  if (split < s_first || split >= s_first + n_active) return;

  for (int e = tid; e < G * D; e += kDecodeThreads) {
    Qs[e] = to_float(q[(static_cast<size_t>(b) * a.Hq + hk * G) * D + e]) * a.scale;
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    M[g] = kNegInf;
    L[g] = 0.f;
  }

  // this block's tiles: [t0, t1) in rows, BN-aligned
  const int r0 = split * a.split_rows;
  const int t0 = max(r0, (lo / BN) * BN);
  const int t1 = min(r0 + a.split_rows, len_eff);
  const int n_tiles = (t1 - t0 + BN - 1) / BN;

  constexpr int kEl = 16 / sizeof(T);  // elements per 16-byte copy
  const int cpr = D / kEl;             // copies per row
  auto load_tile = [&](int kv0, int stage) {
    T* ks = Kst + stage * BN * KLD;
    T* vs = Vst + stage * BN * D;
    for (int c = tid; c < BN * cpr; c += kDecodeThreads) {
      const int j = c / cpr, ch = c % cpr, pos = kv0 + j;
      const bool valid = pos < len_eff;
      size_t row = 0;
      if (valid) {
        if (PAGED) {
          const int pid = a.page_table[b * a.n_pages + pos / a.page_size];
          row = static_cast<size_t>(pid) * a.page_size + pos % a.page_size;
        } else {
          row = static_cast<size_t>(b) * a.Skv + pos;
        }
      }
      const size_t off = (row * a.Hkv + hk) * D + ch * kEl;
      cp_async16(ks + j * KLD + ch * kEl, kc + off, valid);
      cp_async16(vs + j * D + ch * kEl, vc + off, valid);
    }
  };

  load_tile(t0, 0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int kv0 = t0 + i * BN, stage = i % kDecodeStages;
    cp_async_wait<0>();
    // tile i has landed; Q, acc and the stats are set; tile i - 1 and its
    // probabilities are consumed
    __syncthreads();
    if (i + 1 < n_tiles) load_tile(kv0 + BN, (i + 1) % kDecodeStages);
    cp_async_commit();
    const T* ks = Kst + stage * BN * KLD;
    const T* vs = Vst + stage * BN * D;
    // scores and online softmax: one warp per head, one lane per key
    // (keys lane and lane + 32), the whole dot product in the lane
    for (int g = warp; g < G; g += kDecodeWarps) {
      const float* qg = Qs + g * D;
      float sc[2];
      bool vis[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h, pos = kv0 + j;
        vis[h] = j < BN && pos < len_eff && pos >= lo;
        float dot = 0.f;
        if (vis[h]) {
          const T* kr = ks + j * KLD;
          for (int d8 = 0; d8 < D; d8 += 8) {
            float kk[8];
            load8(kr + d8, kk);
            const float4 qa = *reinterpret_cast<const float4*>(qg + d8);
            const float4 qb = *reinterpret_cast<const float4*>(qg + d8 + 4);
            dot += qa.x * kk[0] + qa.y * kk[1] + qa.z * kk[2] + qa.w * kk[3] +
                   qb.x * kk[4] + qb.y * kk[5] + qb.z * kk[6] + qb.w * kk[7];
          }
        }
        sc[h] = vis[h] ? softcap_fn(dot, a.softcap) : kNegInf;
      }
      const float m_old = M[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(sc[0], sc[1])));
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        const float p = vis[h] ? expf(sc[h] - m_new) : 0.f;
        if (j < BN) P[g * BN + j] = p;
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
    // acc = acc * alpha + P V: a thread per (head, pair of dims), even and
    // odd keys summed apart
    const int jmax = min(BN, t1 - kv0);
    for (int e = 2 * tid; e < G * D; e += 2 * kDecodeThreads) {
      const int g = e / D, d = e % D;
      const float* pg = P + g * BN;
      float2 even = make_float2(0.f, 0.f), odd = make_float2(0.f, 0.f);
      int j = 0;
      for (; j + 1 < jmax; j += 2) {
        const float p0 = pg[j], p1 = pg[j + 1];
        const float2 v0 = load2(vs + j * D + d), v1 = load2(vs + (j + 1) * D + d);
        even.x += p0 * v0.x;
        even.y += p0 * v0.y;
        odd.x += p1 * v1.x;
        odd.y += p1 * v1.y;
      }
      if (j < jmax) {
        const float p0 = pg[j];
        const float2 v0 = load2(vs + j * D + d);
        even.x += p0 * v0.x;
        even.y += p0 * v0.y;
      }
      const float alpha = Alpha[g];
      Acc[e] = Acc[e] * alpha + (even.x + odd.x);
      Acc[e + 1] = Acc[e + 1] * alpha + (even.y + odd.y);
    }
  }
  __syncthreads();  // the last tile's accumulator is complete

  if (n_active == 1) {  // the only split with visible rows: finish here
    for (int e = tid; e < G * D; e += kDecodeThreads) {
      const float l = L[e / D];
      orow[e] = from_float<T>(Acc[e] / (l == 0.f ? 1.f : l));
    }
    return;
  }

  // write this split's partial, then take a ticket
  const int bh = b * a.Hkv + hk;
  const size_t per_split = static_cast<size_t>(G) * (D + 2);
  float* part = a.partial + (static_cast<size_t>(bh) * a.n_split + split) * per_split;
  for (int e = tid; e < G * D; e += kDecodeThreads) part[e] = Acc[e];
  for (int g = tid; g < G; g += kDecodeThreads) {
    part[G * D + g] = M[g];
    part[G * D + G + g] = L[g];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(a.counters + bh, 1) == n_active - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block combines the active splits in split order
  const float* base = a.partial + (static_cast<size_t>(bh) * a.n_split + s_first) * per_split;
  for (int e = tid; e < G * D; e += kDecodeThreads) {
    const int g = e / D;
    float m = kNegInf;
    for (int s = 0; s < n_active; ++s) m = fmaxf(m, __ldcg(base + s * per_split + G * D + g));
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float* ps = base + s * per_split;
      const float w = expf(__ldcg(ps + G * D + g) - m);
      l += w * __ldcg(ps + G * D + G + g);
      acc += w * __ldcg(ps + e);
    }
    orow[e] = from_float<T>(acc / (l == 0.f ? 1.f : l));
  }
  if (tid == 0) a.counters[bh] = 0;  // ready for the next launch
}

template <bool PAGED>
inline int launch_decode(const DecodeArgs& a, int B, int dtype, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (a.D % 8 != 0 || (a.kv_block != 32 && a.kv_block != 64) ||
      a.split_rows % a.kv_block != 0 || a.n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.Hkv, B, a.n_split);
  cudaError_t err;
  if (dtype == kFloat32) {
    auto kernel = decode_attention_kernel<float, PAGED>;
    const size_t smem = decode_smem_bytes<float>(a.kv_block, a.D, G);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDecodeThreads, smem, stream>>>(a);
  } else if (dtype == kBFloat16) {
    auto kernel = decode_attention_kernel<__nv_bfloat16, PAGED>;
    const size_t smem = decode_smem_bytes<__nv_bfloat16>(a.kv_block, a.D, G);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDecodeThreads, smem, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
