// Mamba-2 SSD (state-space duality), chunked.  Per head h:
//   S_t = exp(dt_t * A_h) * S_{t-1} + B_t (dt_t x_t)^T   (state (N, P))
//   y_t = C_t^T S_t + D_h * x_t
// x (B, L, H, P); dt (B, L, H); A, D (H,) fp32; Bm, Cm (B, L, G, N), head h
// reads group h / (H / G); y (B, L, H, P).  x, Bm and Cm share one storage
// type (fp32 or bf16), dt has its own; y has x's type.  init, when not null,
// is the state entering step 0 (B, H, N, P) fp32 (else zero); state_out,
// when not null, receives the state after step L - 1, (B, H, N, P) fp32:
// serving's prefill hands it to the decode steps.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel).
//
// Bound on the H100: bytes.  At zamba2-2.7b's training shape (B 2, L 1024,
// H 80, P 64, N 64, G 1) the call reads x, dt, B and C and writes y once,
// 42.8 MB (12.8 us at 3.35 TB/s), while the chunked form's products are
// 5.4 GFLOP (5.4 us at the bf16 tensor-core rate).
//
// Per chunk of Q steps, with cum_t = sum_{s<=t} dt_s A_h inside the chunk:
//   M[t][s] = <C_t, B_s> exp(cum_t - cum_s) dt_s             for s <= t only
//   y_t     = sum_{s<=t} M[t][s] x_s + exp(cum_t) C_t^T S_in + D_h x_t
//   S_out   = exp(cum_end) S_in + sum_s B_s exp(cum_end - cum_s) dt_s x_s^T
// The decay is computed only where s <= t: above the diagonal cum_t - cum_s
// is positive and its exp could overflow (the TPU kernel computes the whole
// square and masks afterwards).
//
// bf16 route (ssd_mma_kernel): the chunks in parallel on the tensor cores,
// the state handed from chunk to chunk inside the one launch.
// - One block of eight warps per two consecutive chunks of a (b, h) pair,
//   four warps a chunk.  Blocks take their tile from an atomic ticket in
//   arrival order, pair-minor (ticket t -> the pair's block t / (B H), pair
//   t % (B H)), so a pair's block k is handed out only after its block
//   k - 1 is held by a running block: a wait never depends on a block that
//   has not started.  The block that draws the last ticket resets the
//   counter for the next launch.
// - x, B and C of the chunk are copied as bf16 into shared memory with
//   cp.async, rows padded by 16 bytes so that ldmatrix has no bank
//   conflicts; dt and the cumulative log-decay come from one warp's
//   shuffle scan.
// - Three products on mma.sync m16n8k16 (bf16 in, fp32 accumulators), warp
//   w owning steps 16w..16w+15 of the chunk, or state rows 16w..16w+15:
//   scores = C B^T, only the tiles on or below the diagonal (x, B and C are
//   bf16 already: exact); the decay and the causal mask applied in
//   registers; y = M x (x through ldmatrix.trans); and the chunk's own
//   state S_z = (B o w)^T x, w_s = exp(cum_end - cum_s) dt_s.  An operand
//   computed in fp32 (M, B o w, and S_in below) goes in as a bf16 high
//   part and a bf16 low part, two MMAs: with one bf16 rounding per term
//   (2^-9) the output left the bf16 tolerance where large terms cancel
//   (dt A of -8 and -20 per step, on the CPU through ssd_tensor_core_ref's
//   arithmetic); the split keeps ~16 bits.
// - Before it waits, the block folds its two chunks' own states into one,
//   S_out = d_0 d_1 S_in + (d_1 S_z0 + S_z1) with d_c = exp(cum_end) of
//   chunk c, so the chain links once per two chunks.
// - The chain, the only serial part: block k waits (one thread,
//   ld.acquire.gpu) for the flag of block k - 1 of its pair, reads the
//   entering fp32 state S_in from the pair's slot (k - 1) % 2 through L2,
//   publishes S_out to slot k % 2 and releases its flag (st.release.gpu
//   after a barrier).  A link costs three L2 round trips (the fence, the
//   flag, the read), so a long sequence pays for every link; chip_smoke.py
//   times a 128-chunk chain.  Flags hold the launch's epoch, so they need
//   no reset.
//   Slot k % 2 is free: block k - 1 read it before it released block k.
//   The first chunk's warps also form the second chunk's entering state,
//   d_0 S_in + S_z0.
// - The ends of the chain: block 0 takes S_in from init (zero without it),
//   and the last block, which publishes nothing, forms S_out all the same
//   when state_out is asked for and writes it there.  Steps past L were
//   copied as zeros with dt = 0, so they leave the state as it was.
// - Then the fourth product, C S_in (S_in split as above), scaled by
//   exp(cum_t) per row; then D x; y goes out through shared memory, 16
//   bytes a lane.
// At zamba2-2.7b's shape (16 chunks) the time is set by how long a block
// holds its SM (its loads, its products, its wait for the chain, its tail)
// over the two blocks that fit an SM, more than by the chain itself.
// The result is deterministic: every element is summed in a fixed order.
// kernels/ssd/ref.py::ssd_tensor_core_ref rounds where this kernel rounds.
//
// fp32 route (ssd_kernel), and bf16 shapes the tensor-core route does not
// cover (N not a multiple of 16 or above 64, P outside 16/32/64/80/128):
// tensor cores cannot meet fp32's tolerance, so fp32 keeps the sequential
// SIMT body: one block per (head, batch) walks the chunks in order with the
// (N, P) state in shared memory and does the three products with fp32 FMAs.
// B and C rows are padded by one float so that a warp reading one column
// of <C_t, B_s> across s hits 32 banks.  The state starts from init and
// ends in state_out.
//
// The chunk is at most 64 (`ssd.chunk`); the config's requested 256 is
// snapped down by the wrapper, which changes the rounding, not the result.
// L not a multiple of the chunk is masked.
#include "common.cuh"
#include "mma.cuh"

namespace repro {

// ---------------------------------------------------------------------------
// fp32 route: one block per (head, batch), chunks in order
// ---------------------------------------------------------------------------

constexpr int kSsdThreads = 256;

static size_t ssd_smem(int N, int P, int Q) {
  return (static_cast<size_t>(N) * P + static_cast<size_t>(Q) * P +
          2 * static_cast<size_t>(Q) * (N + 1) + static_cast<size_t>(Q) * Q + 3 * Q) *
         sizeof(float);
}

template <typename Tin, typename Tdt, typename Tout>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_kernel(const Tin* __restrict__ x, const Tdt* __restrict__ dt,
               const float* __restrict__ A, const Tin* __restrict__ Bm,
               const Tin* __restrict__ Cm, const float* __restrict__ D,
               Tout* __restrict__ y, const float* __restrict__ init,
               float* __restrict__ state_out, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [N][P]
  float* xs = S + N * P;                        // [Q][P]
  float* bs = xs + Q * P;                       // [Q][N + 1]
  float* cs = bs + Q * (N + 1);                 // [Q][N + 1]
  float* M = cs + Q * (N + 1);                  // [Q][Q]
  float* dts = M + Q * Q;                       // [Q]
  float* cum = dts + Q;                         // [Q]
  float* w = cum + Q;                           // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h], dh = D[h];
  const int NB = N + 1;

  const size_t head_state = (static_cast<size_t>(b) * H + h) * N * P;
  for (int e = tid; e < N * P; e += kSsdThreads) S[e] = init ? init[head_state + e] : 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int steps = min(Q, L - t0);
    __syncthreads();  // the previous chunk (and the state update) is done
    for (int e = tid; e < Q * P; e += kSsdThreads) {
      const int t = e / P, p = e % P;
      xs[e] = t < steps
                  ? to_float(x[((static_cast<size_t>(b) * L + t0 + t) * H + h) * P + p])
                  : 0.f;
    }
    for (int e = tid; e < Q * N; e += kSsdThreads) {
      const int t = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (t < steps) {
        const size_t off = ((static_cast<size_t>(b) * L + t0 + t) * G + g) * N + n;
        bv = to_float(Bm[off]);
        cv = to_float(Cm[off]);
      }
      bs[t * NB + n] = bv;
      cs[t * NB + n] = cv;
    }
    for (int t = tid; t < Q; t += kSsdThreads)
      dts[t] = t < steps ? to_float(dt[(static_cast<size_t>(b) * L + t0 + t) * H + h]) : 0.f;
    __syncthreads();
    if (tid == 0) {  // cumulative log-decay, in order (Q <= 64 adds)
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
    }
    __syncthreads();
    const float cum_end = cum[Q - 1];
    for (int t = tid; t < Q; t += kSsdThreads) w[t] = expf(cum_end - cum[t]) * dts[t];
    for (int e = tid; e < Q * Q; e += kSsdThreads) {
      const int t = e / Q, s = e % Q;
      float m = 0.f;
      if (s <= t) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += cs[t * NB + n] * bs[s * NB + n];
        m = dot * expf(cum[t] - cum[s]) * dts[s];
      }
      M[e] = m;
    }
    __syncthreads();
    // outputs: intra-chunk term + carried state + skip
    for (int e = tid; e < steps * P; e += kSsdThreads) {
      const int t = e / P, p = e % P;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += M[t * Q + s] * xs[s * P + p];
      float off = 0.f;
      for (int n = 0; n < N; ++n) off += cs[t * NB + n] * S[n * P + p];
      acc += expf(cum[t]) * off + dh * xs[e];
      y[((static_cast<size_t>(b) * L + t0 + t) * H + h) * P + p] = from_float<Tout>(acc);
    }
    __syncthreads();  // every read of the entering state is done
    const float decay = expf(cum_end);
    for (int e = tid; e < N * P; e += kSsdThreads) {
      const int n = e / P, p = e % P;
      float acc = 0.f;
      for (int s = 0; s < steps; ++s) acc += bs[s * NB + n] * w[s] * xs[s * P + p];
      S[e] = decay * S[e] + acc;
    }
  }
  // each thread stores the entries it last updated itself
  if (state_out)
    for (int e = tid; e < N * P; e += kSsdThreads) state_out[head_state + e] = S[e];
}

template <typename Tin, typename Tdt, typename Tout>
static cudaError_t launch_simt(const void* x, const void* dt, const float* A, const void* Bm,
                               const void* Cm, const float* D, void* y, const float* init,
                               float* state_out, int B, int L, int H, int P, int G, int N,
                               int Q, cudaStream_t stream) {
  const size_t smem = ssd_smem(N, P, Q);
  auto kernel = ssd_kernel<Tin, Tdt, Tout>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kernel<<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tdt*>(dt), A,
      static_cast<const Tin*>(Bm), static_cast<const Tin*>(Cm), D, static_cast<Tout*>(y), init,
      state_out, L, H, P, G, N, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: chunks in parallel on the tensor cores, the state chained
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMaxQ = 16 * kMmaWarps;  // 64: one 16-step slab per warp
constexpr int kMaxN = 16 * kMmaWarps;  // 64: one 16-row state slab per warp

// the pair's state slots, its flags and the ticket counter
struct SsdChain {
  float* states;  // (B H, 2, N, P) fp32, slot z % 2 written by chunk z
  int* flags;     // (B H, n_chunks): epoch once chunk z's S_out is out
  int* ticket;    // 0 between launches
  int epoch;      // this launch's flag value, never 0
};

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// a wait this long means the predecessor will never publish: a fault, which
// traps (the launch fails) instead of holding the card
constexpr unsigned long long kChainWaitLimitNs = 2000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ float ex(float v) { return fast_exp2(v * kLog2e); }

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two fp32 values as bf16 high parts and the bf16 rounding of what remains:
// hi + lo keeps ~16 of the 24 bits
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// A block takes kChunksPerBlock consecutive chunks of one pair, four warps
// each; the chain links once per block.
constexpr int kChunksPerBlock = 2;
constexpr int kSsdMmaThreads = 32 * kMmaWarps * kChunksPerBlock;

// one chunk's shared memory: the padded bf16 tiles x [Q][P + 8], B and C
// [Q][N + 8], the entering state's high and low parts [N][P + 8]; then cum
// and dt, kMaxQ floats each (a multiple of 16 bytes)
__host__ __device__ inline size_t ssd_chunk_smem(int N, int P, int Q) {
  const size_t elems = static_cast<size_t>(Q) * (P + 8) + 2 * static_cast<size_t>(Q) * (N + 8) +
                       2 * static_cast<size_t>(N) * (P + 8);
  return elems * sizeof(bf16) + 2 * kMaxQ * sizeof(float);
}
// a block: its chunks, then the first chunk's own state [N][P] fp32
static size_t ssd_mma_smem(int N, int P, int Q) {
  return kChunksPerBlock * ssd_chunk_smem(N, P, Q) + static_cast<size_t>(N) * P * sizeof(float);
}

struct ChunkTiles {
  bf16 *xs, *bs, *cs, *shi, *slo;
  float *cum, *dts;
};
__device__ __forceinline__ ChunkTiles chunk_tiles(void* smem, size_t chunk_bytes, int c, int Q,
                                                  int N, int LDX, int LDN) {
  ChunkTiles t;
  t.xs = reinterpret_cast<bf16*>(static_cast<char*>(smem) + c * chunk_bytes);
  t.bs = t.xs + Q * LDX;
  t.cs = t.bs + Q * LDN;
  t.shi = t.cs + Q * LDN;
  t.slo = t.shi + N * LDX;
  t.cum = reinterpret_cast<float*>(t.slo + N * LDX);
  t.dts = t.cum + kMaxQ;
  return t;
}

template <int P, typename Tdt>
__global__ void __launch_bounds__(kSsdMmaThreads, 2)
    ssd_mma_kernel(const bf16* __restrict__ x, const Tdt* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const float* __restrict__ D,
                   bf16* __restrict__ y, const float* __restrict__ init,
                   float* __restrict__ state_out, int Bsz, int L, int H, int G, int N, int Q,
                   SsdChain chain) {
  constexpr int LDX = P + 8;  // padded rows (elements): 16 bytes past the row
  constexpr int PT = P / 8;   // 8-wide n-tiles over P
  constexpr int XCH = P / 8;  // 16-byte chunks of an x row
  static_assert(P % 16 == 0, "P is a multiple of 16");
  static_assert(kChunksPerBlock == 2, "the fold below joins two chunks");
  const int LDN = N + 8;
  extern __shared__ uint4 smem_u4[];
  __shared__ int ticket_s;

  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = tid / (32 * kMmaWarps);  // this warp's chunk of the block
  const int warp = (tid >> 5) % kMmaWarps;  // and its place among that chunk's warps
  const int g = lane >> 2, t4 = lane & 3;

  // the block's two chunks' tiles, this warp's chunk's, and the first
  // chunk's S_z [N][P] fp32
  const size_t chunk_bytes = ssd_chunk_smem(N, P, Q);
  const ChunkTiles first = chunk_tiles(smem_u4, chunk_bytes, 0, Q, N, LDX, LDN);
  const ChunkTiles second = chunk_tiles(smem_u4, chunk_bytes, 1, Q, N, LDX, LDN);
  const ChunkTiles& own = sub == 0 ? first : second;
  bf16 *xs = own.xs, *bs = own.bs, *cs = own.cs, *shi = own.shi, *slo = own.slo;
  float *cum = own.cum, *dts = own.dts;
  float* sza = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_u4) +
                                        kChunksPerBlock * chunk_bytes);

  if (tid == 0) {
    const int t = atomicAdd(chain.ticket, 1);
    if (t == static_cast<int>(gridDim.x) - 1) atomicExch(chain.ticket, 0);
    ticket_s = t;
  }
  __syncthreads();
  const int BH = Bsz * H;
  const int n_blocks = gridDim.x / BH;  // per pair
  const int n_chunks = (L + Q - 1) / Q;
  const int kb = ticket_s / BH, bh = ticket_s % BH;  // the pair's kb-th block
  const int z = kb * kChunksPerBlock + sub;          // this warp's chunk
  const int b = bh / H, h = bh % H;
  const int grp = h / (H / G);
  const int t0 = z * Q;
  const int steps = z < n_chunks ? min(Q, L - t0) : 0;  // 0: past L, an empty chunk
  const size_t seq0 = static_cast<size_t>(b) * L + t0;  // (b, t0) as a row of (B L)
  const size_t seq_b = static_cast<size_t>(b) * L;      // a mapped row for masked copies
  const bool publish = kb + 1 < n_blocks;               // the next block needs S_out
  const bool fold = publish || state_out != nullptr;    // this block forms S_out
  const int ctid = tid % (32 * kMmaWarps);              // thread within the chunk's warps

  // ---- stage x, B, C (cp.async, zero past L); dt and cum by the chunk's warp 0
  for (int c = ctid; c < Q * XCH; c += 32 * kMmaWarps) {
    const int t = c / XCH, ch = c % XCH;
    const bool valid = t < steps;
    const bf16* src = x + ((valid ? seq0 + t : seq_b) * H + h) * P + ch * 8;
    cp_async16(xs + t * LDX + ch * 8, src, valid);
  }
  const int NCH = N / 8;
  for (int c = ctid; c < Q * NCH; c += 32 * kMmaWarps) {
    const int t = c / NCH, ch = c % NCH;
    const bool valid = t < steps;
    const size_t off = ((valid ? seq0 + t : seq_b) * G + grp) * N + ch * 8;
    cp_async16(bs + t * LDN + ch * 8, Bm + off, valid);
    cp_async16(cs + t * LDN + ch * 8, Cm + off, valid);
  }
  cp_async_commit();
  const float a = A[h];
  if (warp == 0) {  // inclusive scan of dt * A over the chunk, two steps a lane
    const float d0 = lane < steps ? to_float(dt[(seq0 + lane) * H + h]) : 0.f;
    const float d1 = lane + 32 < steps ? to_float(dt[(seq0 + lane + 32) * H + h]) : 0.f;
    float c0 = d0 * a, c1 = d1 * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, c0, o);
      const float u1 = __shfl_up_sync(0xffffffffu, c1, o);
      if (lane >= o) {
        c0 += u0;
        c1 += u1;
      }
    }
    c1 += __shfl_sync(0xffffffffu, c0, 31);
    cum[lane] = c0;
    cum[lane + 32] = c1;
    dts[lane] = d0;
    dts[lane + 32] = d1;
  }
  cp_async_wait<0>();
  __syncthreads();
  const float cum_end = cum[Q - 1];

  // ---- y = M x for the warp's 16 steps (products 1 and 2)
  const int r0 = warp * 16;
  const bool rows = r0 < steps;
  float yacc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
  if (rows) {
    float sc[kMaxQ / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ca[4];
      ldmatrix_x4(ca, cs + (r0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kMaxQ / 16; ++jp) {
        if (jp <= warp) {  // 16-step tiles of s on or below the diagonal
          // matrices: (s 16jp, n 16kk), (s 16jp, n 16kk+8), (s 16jp+8, n
          // 16kk), (s 16jp+8, n 16kk+8)
          uint32_t bk[4];
          ldmatrix_x4(bk, bs + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[2 * jp], ca, bk[0], bk[1]);
          mma_bf16_16816(sc[2 * jp + 1], ca, bk[2], bk[3]);
        }
      }
    }
    // decay and causal mask, in registers: rows t = r0 + g (+ 8), cols s
    const float ct[2] = {cum[r0 + g], cum[r0 + g + 8]};
#pragma unroll
    for (int j = 0; j < kMaxQ / 8; ++j) {
      if (j < 2 * warp + 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + g + (e >> 1) * 8;
          const int s = j * 8 + 2 * t4 + (e & 1);
          sc[j][e] = s <= t ? sc[j][e] * ex(ct[e >> 1] - cum[s]) * dts[s] : 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMaxQ / 16; ++kk) {
      if (kk <= warp) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(yacc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16_16816(yacc[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16_16816(yacc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16_16816(yacc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

  // ---- the chunk's own state S_z = (B o w)^T x for state rows m0..m0+15
  // (product 3), where a later chunk reads it
  const int m0 = warp * 16;
  const bool srows = m0 < N;
  float sacc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
  if (srows && (z + 1 < n_chunks || (state_out != nullptr && z < n_chunks))) {
#pragma unroll
    for (int kk = 0; kk < kMaxQ / 16; ++kk) {
      if (kk * 16 < Q) {
        // A = B^T (rows n, cols s) through ldmatrix.trans of B [s][n]:
        // matrices (s 0-7, n 0-7), (s 0-7, n 8-15), (s 8-15, n 0-7), (s 8-15,
        // n 8-15) of the 16 x 16 tile
        uint32_t ba[4];
        ldmatrix_x4_trans(ba, bs + (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDN + m0 +
                                  ((lane >> 3) & 1) * 8);
        const int s0 = kk * 16 + 2 * t4;
        const float w0 = ex(cum_end - cum[s0]) * dts[s0];
        const float w1 = ex(cum_end - cum[s0 + 1]) * dts[s0 + 1];
        const float w8 = ex(cum_end - cum[s0 + 8]) * dts[s0 + 8];
        const float w9 = ex(cum_end - cum[s0 + 9]) * dts[s0 + 9];
        uint32_t wh[4], wl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack_bf16(ba[r]);
          split_bf16(v.x * (r < 2 ? w0 : w8), v.y * (r < 2 ? w1 : w9), wh[r], wl[r]);
        }
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(sacc[2 * dp], wh, bv[0], bv[1]);
          mma_bf16_16816(sacc[2 * dp + 1], wh, bv[2], bv[3]);
          mma_bf16_16816(sacc[2 * dp], wl, bv[0], bv[1]);
          mma_bf16_16816(sacc[2 * dp + 1], wl, bv[2], bv[3]);
        }
      }
    }
  }

  // ---- the block's own state, before the wait: with d_c = exp(cum_end) of
  // chunk c, S_out = d_0 d_1 S_in + (d_1 S_z0 + S_z1); the second chunk's
  // warps fold the first chunk's S_z into theirs
  const int NP = N * P;
  const float d0 = ex(first.cum[Q - 1]), d1 = ex(second.cum[Q - 1]);
  if (fold) {
    if (sub == 0 && srows) {
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sza + (m0 + g + 8 * r) * P + j * 8 + 2 * t4) =
              make_float2(sacc[j][2 * r], sacc[j][2 * r + 1]);
    }
    __syncthreads();
    if (sub == 1 && srows) {
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 s0v =
              *reinterpret_cast<const float2*>(sza + (m0 + g + 8 * r) * P + j * 8 + 2 * t4);
          sacc[j][2 * r] += d1 * s0v.x;
          sacc[j][2 * r + 1] += d1 * s0v.y;
        }
    }
  }

  // ---- the chain: wait for the state entering the block, publish the one
  // leaving it, release the next block
  int* flags = chain.flags + static_cast<size_t>(bh) * n_blocks;
  if (kb > 0) {
    if (tid == 0) {
      const unsigned long long t_wait = global_ns();
      while (ld_acquire_gpu(flags + kb - 1) != chain.epoch)
        if (global_ns() - t_wait > kChainWaitLimitNs) __trap();
    }
    __syncthreads();
  }
  if (srows) {
    // the entering state: the predecessor's slot, else init (or zero);
    // the leaving one: the next block's slot, else state_out
    const size_t head = static_cast<size_t>(bh) * NP;
    const float* s_in = kb > 0 ? chain.states + head * 2 + ((kb + 1) & 1) * NP
                               : (init != nullptr ? init + head : nullptr);
    float* s_out = publish ? chain.states + head * 2 + (kb & 1) * NP
                           : (state_out != nullptr ? state_out + head : nullptr);
    const float d01 = d0 * d1;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = m0 + g + 8 * r, p = j * 8 + 2 * t4;
        float2 v = make_float2(0.f, 0.f);
        if (s_in != nullptr) v = __ldcg(reinterpret_cast<const float2*>(s_in + n * P + p));
        uint32_t hi, lo;
        if (sub == 0) {
          // the first chunk's S_in, and the second's: d_0 S_in + S_z0
          split_bf16(v.x, v.y, hi, lo);
          *reinterpret_cast<uint32_t*>(shi + n * LDX + p) = hi;
          *reinterpret_cast<uint32_t*>(slo + n * LDX + p) = lo;
          split_bf16(d0 * v.x + sacc[j][2 * r], d0 * v.y + sacc[j][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(second.shi + n * LDX + p) = hi;
          *reinterpret_cast<uint32_t*>(second.slo + n * LDX + p) = lo;
        } else if (s_out != nullptr) {
          __stcg(reinterpret_cast<float2*>(s_out + n * P + p),
                 make_float2(d01 * v.x + sacc[j][2 * r], d01 * v.y + sacc[j][2 * r + 1]));
        }
      }
    }
  }
  __syncthreads();  // S_out is written and both S_in are in shared memory
  if (tid == 0 && publish) st_release_gpu(flags + kb, chain.epoch);

  // ---- y += exp(cum_t) C_t S_in (product 4, S_in as high + low bf16; the
  // first chunk's S_in is zero unless init gives it)
  if (rows && (z > 0 || init != nullptr)) {
    float oacc[PT][4];
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ca[4];
      ldmatrix_x4(ca, cs + (r0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        const int off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX + dp * 16 +
                        (lane >> 4) * 8;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, shi + off);
        mma_bf16_16816(oacc[2 * dp], ca, bv[0], bv[1]);
        mma_bf16_16816(oacc[2 * dp + 1], ca, bv[2], bv[3]);
        ldmatrix_x4_trans(bv, slo + off);
        mma_bf16_16816(oacc[2 * dp], ca, bv[0], bv[1]);
        mma_bf16_16816(oacc[2 * dp + 1], ca, bv[2], bv[3]);
      }
    }
    const float e0 = ex(cum[r0 + g]), e1 = ex(cum[r0 + g + 8]);
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      yacc[j][0] += e0 * oacc[j][0];
      yacc[j][1] += e0 * oacc[j][1];
      yacc[j][2] += e1 * oacc[j][2];
      yacc[j][3] += e1 * oacc[j][3];
    }
  }

  // ---- + D x, then y through the warp's own rows of xs, 16 bytes a lane
  if (rows) {
    const float dh = D[h];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* px = xs + (r0 + g + 8 * r) * LDX + j * 8 + 2 * t4;
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(px));
        *reinterpret_cast<uint32_t*>(px) =
            pack_bf16(yacc[j][2 * r] + dh * xv.x, yacc[j][2 * r + 1] + dh * xv.y);
      }
    }
    __syncwarp();
    for (int c = lane; c < 16 * XCH; c += 32) {
      const int t = r0 + c / XCH, ch = c % XCH;
      if (t < steps)
        *reinterpret_cast<uint4*>(y + ((seq0 + t) * H + h) * P + ch * 8) =
            *reinterpret_cast<const uint4*>(xs + t * LDX + ch * 8);
    }
  }
}

template <int P, typename Tdt>
static cudaError_t launch_mma_p(const void* x, const void* dt, const float* A, const void* Bm,
                                const void* Cm, const float* D, void* y, const float* init,
                                float* state_out, int B, int L, int H, int G, int N, int Q,
                                SsdChain chain, cudaStream_t stream) {
  const size_t smem = ssd_mma_smem(N, P, Q);
  auto kernel = ssd_mma_kernel<P, Tdt>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long n_chunks = (L + Q - 1) / Q;
  const long n_blocks = (n_chunks + kChunksPerBlock - 1) / kChunksPerBlock;  // per pair
  kernel<<<static_cast<unsigned>(n_blocks * B * H), kSsdMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const Tdt*>(dt), A,
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), D, static_cast<bf16*>(y), init,
      state_out, B, L, H, G, N, Q, chain);
  return cudaGetLastError();
}

template <typename Tdt>
static cudaError_t launch_mma(const void* x, const void* dt, const float* A, const void* Bm,
                              const void* Cm, const float* D, void* y, const float* init,
                              float* state_out, int B, int L, int H, int P, int G, int N, int Q,
                              SsdChain chain, cudaStream_t stream) {
  if (N % 16 != 0 || N > kMaxN || Q % 16 != 0 || Q > kMaxQ || chain.epoch == 0)
    return cudaErrorInvalidValue;
#define REPRO_SSD_P(PP)                                                              \
  case PP:                                                                           \
    return launch_mma_p<PP, Tdt>(x, dt, A, Bm, Cm, D, y, init, state_out, B, L, H, G, N, Q, \
                                 chain, stream);
  switch (P) {
    REPRO_SSD_P(16)
    REPRO_SSD_P(32)
    REPRO_SSD_P(64)
    REPRO_SSD_P(80)
    REPRO_SSD_P(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_P
}

}  // namespace repro

// in_dtype: storage type of x, Bm, Cm; dt_dtype: of dt; out_dtype: of y.
// init_state, state_out: (B, H, N, P) fp32 or null (see the top).
// route 1 (tensor cores, bf16 x/Bm/Cm and y) needs the chain scratch:
// states (B H 2 N P floats), flags (B H ceil(n_chunks / 2) ints at least),
// ticket (one int, 0), epoch (this launch's flag value, not 0); route 0
// ignores them.
extern "C" int repro_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, const void* D, void* y, int B, int L, int H, int P,
                         int G, int N, int Q, int in_dtype, int dt_dtype, int out_dtype,
                         int route, const void* init_state, void* state_out, void* states,
                         void* flags, void* ticket, int epoch, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  const float* init = static_cast<const float*>(init_state);
  float* so = static_cast<float*>(state_out);
  if (G < 1 || H % G != 0 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (in_dtype != kBFloat16 || out_dtype != kBFloat16)
      return static_cast<int>(cudaErrorInvalidValue);
    SsdChain chain{static_cast<float*>(states), static_cast<int*>(flags),
                   static_cast<int*>(ticket), epoch};
    if (dt_dtype == kFloat32)
      return launch_mma<float>(x, dt, a, Bm, Cm, d, y, init, so, B, L, H, P, G, N, Q, chain, s);
    if (dt_dtype == kBFloat16)
      return launch_mma<__nv_bfloat16>(x, dt, a, Bm, Cm, d, y, init, so, B, L, H, P, G, N, Q,
                                       chain, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_SSD(TI, TD, TO) \
  return launch_simt<TI, TD, TO>(x, dt, a, Bm, Cm, d, y, init, so, B, L, H, P, G, N, Q, s)
#define REPRO_SSD_DT(TI, TO)                                  \
  {                                                           \
    if (dt_dtype == kFloat32) REPRO_SSD(TI, float, TO);       \
    if (dt_dtype == kBFloat16) REPRO_SSD(TI, __nv_bfloat16, TO); \
  }
  if (in_dtype == kFloat32 && out_dtype == kFloat32) REPRO_SSD_DT(float, float)
  if (in_dtype == kFloat32 && out_dtype == kBFloat16) REPRO_SSD_DT(float, __nv_bfloat16)
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    REPRO_SSD_DT(__nv_bfloat16, __nv_bfloat16)
#undef REPRO_SSD_DT
#undef REPRO_SSD
  return static_cast<int>(cudaErrorInvalidValue);
}
