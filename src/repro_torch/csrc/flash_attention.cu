// Prefill (and non-causal cross-) attention with an online softmax in fp32.
// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out
// (B, Sq, Hq, Dv), contiguous.  V's head dim may differ from Q/K's (MLA
// prefill: D 192 with Dv 128); the kernels are templated on both.
// Masks: causal (with q_offset, which may be negative), sliding window, the
// ragged tail past Skv (masked in place, never padded); logit softcap; GQA
// maps q head h to kv head h / (Hq / Hkv).  A fully masked row gives 0, as
// the TPU kernel's finalize does.  Masked logits are kNegInf = -1e30.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _attn_kernel).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the serving prompt
// (4 x 64 tokens, 32 / 8 heads, d 64) bytes, 0.78 us for q, k, v and out
// read or written once; at zamba2-2.7b's training shape (2 x 1024, 32 / 32
// heads, d 80, causal) bytes and operations are close, 12.5 us for the
// bytes against 10.9 us for the 10.7 GFLOP of the two causal products.
// Both are far below what a simple kernel reaches, so the design goes after
// the operations first, then the bytes' latency:
//
// bf16 route (flash_attention_mma_kernel), the FlashAttention-2 structure:
// - one CUDA block per (q head, batch, q tile of q_block rows), q_block / 16
//   warps, each warp owning 16 query rows; the q tile is the slowest grid
//   axis, taken backwards, so the causal tiles with the most work start
//   first and the light ones fill the tail;
// - Q is loaded once into registers as bf16 mma A-fragments (unscaled; S
//   is scaled in fp32);
// - K/V tiles of kv_block rows are copied as bf16 into a two-stage ring of
//   shared memory with cp.async (16 bytes a thread, zero-filled past Skv),
//   so the copy of tile j + 1 overlaps the math on tile j; rows are padded
//   by 8 elements (16 bytes), which keeps ldmatrix free of bank conflicts
//   at every head dim;
// - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
//   accumulators in registers), B operands through ldmatrix (.trans for
//   V); P is rounded to bf16 for the P V product;
// - the online softmax stays in fp32 (base-2 exponent), the row max and
//   sum reduced across the 4 lanes of an mma row quad; the accumulator is
//   rescaled once per KV tile;
// - KV tiles masked for every row of the block are never loaded; a warp
//   skips the math of a tile masked for all of its rows, and applies the
//   per-element mask only on tiles that straddle an edge (diagonal,
//   window, Skv tail).
// Not yet: wgmma on 64-row warpgroup tiles with TMA and a producer warp.
//
// fp32 route (flash_attention_kernel): tensor cores in bf16 or TF32 cannot
// meet fp32's 1e-4 tolerance, so fp32 inputs take a SIMT kernel with fp32
// FMAs: one thread per query row holding its scaled q row and its fp32
// accumulator in registers; each step stages kv_block K/V rows in shared
// memory as fp32 (every thread reads the same K row: a broadcast) and walks
// them in chunks of 8 keys, rescaling once per chunk.  A bf16 tensor never
// reaches it.  Where the TPU kernel carried its statistics across a
// sequential grid axis, both kernels loop over the KV tiles inside the
// block; blocks share nothing.
#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int kChunk = 8;

template <typename T, int HD, int HV>
__global__ void flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ o,
                                       int Sq, int Skv, int Hq, int Hkv, int causal,
                                       int window, float softcap, float scale,
                                       int q_offset, int kv_block) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kv_block * HD;  // kv_block rows of HV

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
  float acc[HV];
  const T* qrow = q + (static_cast<size_t>(b) * Sq + (active ? row : 0)) * Hq * HD +
                  static_cast<size_t>(h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = active ? to_float(qrow[d]) * scale : 0.f;
#pragma unroll
  for (int d = 0; d < HV; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kv0 = (kv_lo / kv_block) * kv_block; kv0 < kv_hi; kv0 += kv_block) {
    __syncthreads();  // the previous tile is consumed
    if constexpr (HV == HD) {  // K and V rows alike: one pass
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
    } else {
      for (int e = threadIdx.x; e < kv_block * HD; e += BM) {
        const int j = e / HD, d = e % HD, pos = kv0 + j;
        Ks[e] = pos < Skv
                    ? to_float(k[((static_cast<size_t>(b) * Skv + pos) * Hkv + hk) * HD + d])
                    : 0.f;
      }
      for (int e = threadIdx.x; e < kv_block * HV; e += BM) {
        const int j = e / HV, d = e % HV, pos = kv0 + j;
        Vs[e] = pos < Skv
                    ? to_float(v[((static_cast<size_t>(b) * Skv + pos) * Hkv + hk) * HV + d])
                    : 0.f;
      }
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
      for (int d = 0; d < HV; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!vis[c]) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + c) * HV);
#pragma unroll
        for (int d4 = 0; d4 < HV / 4; ++d4) {
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
  T* orow = o + (static_cast<size_t>(b) * Sq + row) * Hq * HV + static_cast<size_t>(h) * HV;
#pragma unroll
  for (int d = 0; d < HV; ++d) orow[d] = from_float<T>(acc[d] / denom);
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

// q_block 64 at most: at ~140-200 registers a thread (d 64-128), a block of
// four warps leaves room for two or three blocks on an SM, so one block's
// barrier and softmax hide behind another's products; eight warps fit one
constexpr int kMaxWarps = 4;
constexpr int kStages = 2;  // K/V ring depth

// HD: Q/K head dim; HV: V's (and O's).  V is computed HVP wide, rounded up
// to the 16 of an ldmatrix pair, its extra columns zero-filled in shared
// memory and never stored (Dv 8 for the MLA smoke shape).
template <int HD, int HV, int BN>
struct MmaTile {
  static constexpr int HVP = (HV + 15) / 16 * 16;
  static constexpr int LDK = HD + 8;          // padded shared rows (elements)
  static constexpr int LDV = HVP + 8;
  static constexpr int KSTEPS = HD / 16;      // k-steps of Q K^T
  static constexpr int NT = BN / 8;           // 8-key n-tiles of S
  static constexpr int DT = HVP / 8;          // 8-wide n-tiles of O computed
  static constexpr int DTS = HV / 8;          // ... and stored
  static constexpr int CPRK = HD / 8;         // 16-byte chunks per K row
  static constexpr int CPRV = HVP / 8;        // ... per V row (HV / 8 read)
  static constexpr int STAGE = BN * (LDK + LDV);  // K then V, elements
  static size_t smem_bytes() {
    return static_cast<size_t>(kStages) * STAGE * sizeof(__nv_bfloat16);
  }
  static_assert(HD % 16 == 0 && HV % 8 == 0 && BN % 16 == 0, "mma tiles");
};

template <int HD, int HV, int BN>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                           int Hkv, int causal, int window, float softcap,
                           float scale, int q_offset) {
  using Tile = MmaTile<HD, HV, BN>;
  constexpr int LDK = Tile::LDK, LDV = Tile::LDV, KSTEPS = Tile::KSTEPS, NT = Tile::NT,
                DT = Tile::DT, DTS = Tile::DTS, CPRK = Tile::CPRK, CPRV = Tile::CPRV;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_u4);

  const int nthreads = blockDim.x, BM = nthreads / 2;  // 16 rows per warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // blocks start in x, y, z order: the q tile runs slowest and backwards,
  // so every head's heaviest causal tiles start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv);

  // the block's visible KV range [kv_lo, kv_hi) and the warp's rows
  const int q_first = q_offset + tile * BM;
  const int q_last = q_offset + min(tile * BM + BM, Sq) - 1;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int row0 = tile * BM + warp * 16;
  const bool warp_rows = row0 < Sq;
  const int wq_first = q_offset + row0;
  const int wq_last = q_offset + min(row0 + 16, Sq) - 1;

  // Q as A-fragments, unscaled bf16; rows past Sq are zero
  uint32_t qa[KSTEPS][4];
  {
    const int ra = row0 + g, rb = row0 + g + 8;
    const size_t stride = static_cast<size_t>(Hq) * HD;
    const __nv_bfloat16* qa_row = q + (static_cast<size_t>(b) * Sq + ra) * stride + h * HD;
    const __nv_bfloat16* qb_row = q + (static_cast<size_t>(b) * Sq + rb) * stride + h * HD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qa_row + c) : 0u;
      qa[kk][1] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qb_row + c) : 0u;
      qa[kk][2] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qa_row + c + 8) : 0u;
      qa[kk][3] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qb_row + c + 8) : 0u;
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // in units of u (below)
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum
  const float u = softcap > 0.f ? 1.f : scale * kLog2e;

  const size_t k_row_stride = static_cast<size_t>(Hkv) * HD;
  const size_t v_row_stride = static_cast<size_t>(Hkv) * HV;
  const __nv_bfloat16* kbase = k + static_cast<size_t>(b) * Skv * k_row_stride + hk * HD;
  const __nv_bfloat16* vbase = v + static_cast<size_t>(b) * Skv * v_row_stride + hk * HV;
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* ks = smem + stage * Tile::STAGE;
    __nv_bfloat16* vs = ks + BN * LDK;
    if constexpr (HV == HD) {  // K and V rows alike: one pass, as many copies
      for (int c = tid; c < BN * CPRK; c += nthreads) {
        const int r = c / CPRK, ch = c % CPRK, pos = t * BN + r;
        const bool valid = pos < Skv;
        const size_t off = static_cast<size_t>(valid ? pos : 0) * k_row_stride + ch * 8;
        cp_async16(ks + r * LDK + ch * 8, kbase + off, valid);
        cp_async16(vs + r * LDV + ch * 8, vbase + off, valid);
      }
    } else {
      for (int c = tid; c < BN * CPRK; c += nthreads) {
        const int r = c / CPRK, ch = c % CPRK, pos = t * BN + r;
        const bool valid = pos < Skv;
        const size_t off = static_cast<size_t>(valid ? pos : 0) * k_row_stride + ch * 8;
        cp_async16(ks + r * LDK + ch * 8, kbase + off, valid);
      }
      for (int c = tid; c < BN * CPRV; c += nthreads) {
        const int r = c / CPRV, ch = c % CPRV, pos = t * BN + r;
        const bool valid = pos < Skv && ch < HV / 8;  // columns past HV: zeros
        const size_t off = valid ? static_cast<size_t>(pos) * v_row_stride + ch * 8 : 0;
        cp_async16(vs + r * LDV + ch * 8, vbase + off, valid);
      }
    }
  };

  const int t_begin = kv_lo / BN;
  const int t_end = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_begin;
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % kStages;
    cp_async_wait<0>();  // tile t has landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's; and tile t - 1 is consumed
    if (t + 1 < t_end) load_tile(t + 1, (t + 1 - t_begin) % kStages);
    cp_async_commit();
    const int kv0 = t * BN;
    const bool skip = !warp_rows || (causal && kv0 > wq_last) ||
                      (window > 0 && kv0 + BN - 1 <= wq_first - window);
    if (!skip) {
      const __nv_bfloat16* ks = smem + stage * Tile::STAGE;
      const __nv_bfloat16* vs = ks + BN * LDK;
      // S = Q K^T
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          // matrices: (keys 16jp, d 16kk), (keys 16jp, d 16kk+8),
          //           (keys 16jp+8, d 16kk), (keys 16jp+8, d 16kk+8)
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDK + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * jp], qa[kk], bk[0], bk[1]);
          mma_bf16_16816(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
        }
      }
      // logits in units of u: x * u is the base-2 logit (u = scale * log2 e
      // with no softcap; the softcap's tanh takes the scale itself, u = 1)
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
      }
      const bool edge = kv0 + BN > Skv || (causal && kv0 + BN - 1 > wq_first) ||
                        (window > 0 && kv0 <= wq_last - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = kv0 + j * 8 + 2 * t4 + (e & 1);
            const int qpos = wq_first + g + (e >> 1) * 8;
            const bool vis = pos < Skv && (!causal || pos <= qpos) &&
                             (window <= 0 || pos > qpos - window);
            if (!vis) s[j][e] = kNegInf;
          }
        }
      }
      // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        // a row masked so far keeps m = kNegInf: subtract 0 so that every
        // masked exponent underflows to exactly 0
        const float base = m_new == kNegInf ? 0.f : m_new * u;
        const float alpha = fast_exp2(m_run[r] * u - base);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float p0 = fast_exp2(fmaf(s[j][2 * r], u, -base));
          const float p1 = fast_exp2(fmaf(s[j][2 * r + 1], u, -base));
          s[j][2 * r] = p0;
          s[j][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          oacc[dt][2 * r] *= alpha;
          oacc[dt][2 * r + 1] *= alpha;
        }
      }
      // O += P V, P as bf16 A-fragments straight from the S fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          // matrices: (keys 16kk, d 16dp), (keys 16kk+8, d 16dp),
          //           (keys 16kk, d 16dp+8), (keys 16kk+8, d 16dp+8)
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDV +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(oacc[2 * dp], pa, bv[0], bv[1]);
          mma_bf16_16816(oacc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  // normalize and store rows g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;  // fully masked rows -> 0
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + row) * Hq * HV +
                          static_cast<size_t>(h) * HV;
#pragma unroll
    for (int dt = 0; dt < DTS; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t4) =
          pack_bf16(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int HD, int HV>
static cudaError_t launch_simt_hd(const void* q, const void* k, const void* v, void* o,
                                  int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                  int window, float softcap, float scale, int q_offset,
                                  int q_block, int kv_block, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kv_block) * (HD + HV) * sizeof(float);
  auto kernel = flash_attention_kernel<float, HD, HV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + q_block - 1) / q_block, Hq, B);
  kernel<<<grid, q_block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq, Hkv, causal,
      window, softcap, scale, q_offset, kv_block);
  return cudaGetLastError();
}

template <int HD, int HV, int BN>
static cudaError_t launch_mma_bn(const void* q, const void* k, const void* v, void* o,
                                 int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                 int window, float softcap, float scale, int q_offset,
                                 int q_block, cudaStream_t stream) {
  const size_t smem = MmaTile<HD, HV, BN>::smem_bytes();
  auto kernel = flash_attention_mma_kernel<HD, HV, BN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + q_block - 1) / q_block);
  kernel<<<grid, 2 * q_block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq,
      Hkv, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

template <int HD, int HV>
static cudaError_t launch_mma_hd(const void* q, const void* k, const void* v, void* o,
                                 int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                 int window, float softcap, float scale, int q_offset,
                                 int q_block, int kv_block, cudaStream_t stream) {
  if (q_block % 16 != 0 || q_block > 16 * kMaxWarps) return cudaErrorInvalidValue;
  if (kv_block == 32)
    return launch_mma_bn<HD, HV, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap,
                                 scale, q_offset, q_block, stream);
  if (kv_block == 64)
    return launch_mma_bn<HD, HV, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap,
                                 scale, q_offset, q_block, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro

// dtype picks the route: fp32 -> the SIMT kernel, bf16 -> the tensor cores.
// (D, Dv) pairs: equal head dims, plus MLA's (192, 128) and (16, 8).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int D, int Dv, int causal, int window,
                                     float softcap, float scale, int q_offset,
                                     int q_block, int kv_block, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == repro::kFloat32;
  if (!f32 && dtype != repro::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FA_CASE(HD, HV)                                                          \
  if (D == HD && Dv == HV)                                                            \
    return static_cast<int>(                                                          \
        f32 ? repro::launch_simt_hd<HD, HV>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,  \
                                            window, softcap, scale, q_offset,         \
                                            q_block, kv_block, s)                     \
            : repro::launch_mma_hd<HD, HV>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,   \
                                           window, softcap, scale, q_offset, q_block, \
                                           kv_block, s));
  REPRO_FA_CASE(16, 16)
  REPRO_FA_CASE(32, 32)
  REPRO_FA_CASE(64, 64)
  REPRO_FA_CASE(80, 80)
  REPRO_FA_CASE(128, 128)
  REPRO_FA_CASE(192, 128)
  REPRO_FA_CASE(16, 8)
#undef REPRO_FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
