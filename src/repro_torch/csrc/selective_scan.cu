// Mamba-1 selective scan, fp32 inside:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = <h_t, C_t> + D * x_t
// x, dt (B, L, C); A (C, N) fp32; Bm, Cm (B, L, N); D (C,) fp32; y (B, L, C).
// Inputs share one storage type (fp32 or bf16); y has x's type.  N <= 128.
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py::
// selective_scan_pallas (body _scan_kernel).
//
// Bound on the H100: every exp(dt_t * A) is computed once, B*L*C*N of
// them, on the special-function units at 16 results per clock per SM
// (ex2); at the training shape (B 2, L 1024, C 8192, N 16) that is ~64 us
// at a 1.98 GHz SM clock, against ~30 us for the bytes (one read of x, dt,
// B, C, one write of y) and ~32 us for the four fp32 operations per
// element.  The design spends as few other instructions as it can per
// exponential:
// - The sequence loop runs inside the block with the state in registers
//   (where the TPU kernel kept it in VMEM across a sequential grid axis):
//   the parallelism is the B*C*N independent recurrences.  A lane holds
//   S = 4 consecutive states of one channel (the fastest of 1, 2, 4 and 8
//   in a sweep on the card), LPC = K / S lanes (a power of two, K >= N the
//   padded state size) share the channel, and a block takes `cpb`
//   channels of one batch row.  LPC is a template parameter; the planner
//   (kernels/mamba_scan/kernel.py::plan_scan) picks it, cpb and the chunk
//   from the shapes.
// - The time loop is unrolled in groups of G = max(LPC, U) steps, two
//   groups at a time.  For U = 8 steps every decay
//   exp2(dt * A log2 e) (A log2 e folded in once at load; ex2.approx.ftz)
//   and every input dt * x * B is computed first — neither depends on h —
//   then the U FMAs on h and the U partial dot products with C.  The G
//   partial sums of a group are summed over the LPC lanes by a butterfly
//   reduce-scatter (G (1 - 1 / LPC) shuffles per lane, not G log2 LPC),
//   after which each lane holds G / LPC whole steps and writes their y.
// - x and dt are read once per channel-step: the lane that will write a
//   step's y reads its x and dt and forms dt * x, and the other lanes of
//   the channel take dt and dt * x from it by shuffle.
// - Staging is a two-stage ring filled by cp.async (16 bytes a thread):
//   chunk k+1's x and dt, and chunk k+2's B and C, are requested before
//   chunk k's recurrence, with one barrier per chunk.  x and dt stay in
//   their storage type in shared memory; B and C (shared by every channel
//   of the row) are widened once per block into an fp32 table laid out so
//   a lane reads its S values of B_t and of C_t as one vector each, zero
//   past N.  y leaves through a shared tile as 16-byte stores.  Widths that
//   are not whole 16-byte vectors (and unaligned tensors) are staged and
//   stored element by element.  Steps past L and channels past C are
//   zero-filled: dt = 0 leaves h unchanged, and their y is not stored.
// No atomics and nothing shared between blocks: two launches give the
// same bits.
#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace scan {

constexpr int kMaxThreads = 256;
constexpr int kStates = 4;  // S: states a lane holds
constexpr int kDecaySteps = 8;  // U: steps whose decays a lane forms together
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  void* y;
  int L, C, N, cpb, chunk;
  int vec_x, vec_bc, vec_y;  // 16-byte staging of x/dt, of B/C; 16-byte stores of y
};

// Shared bytes of one block; mirrored by plan_scan (kernels/mamba_scan/
// kernel.py::scan_smem_bytes).  The y tile is sized with the input's
// element size, an upper bound for an output no wider than the input.
__host__ __device__ inline size_t smem_bytes(int N, int K, int cpb, int chunk, int in_size) {
  const size_t ring = 4ull * chunk * (cpb + 16 / in_size) * in_size;  // [2][x, dt][chunk][cpb+pad]
  const size_t raw = 4ull * chunk * N * in_size;                      // [2][B, C][chunk * N]
  const size_t table = 2ull * chunk * 2 * K * sizeof(float);          // [2][chunk][LPC][B, C][S]
  const size_t ytile = 2ull * chunk * (cpb + 16 / in_size) * in_size; // [2][chunk][cpb+pad]
  return ring + raw + table + ytile;
}

template <typename T>
__device__ __forceinline__ T zero() { return from_float<T>(0.f); }

// a lane's S = 4 consecutive floats from shared memory as one vector
__device__ __forceinline__ void load_states(const float* p, float (&v)[kStates]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// Butterfly reduce-scatter of G partial sums over the LPC lanes of a
// channel: lane g ends with the whole sums of steps [g Q, g Q + Q) in
// acc[0..Q), Q = G / LPC.  Round r exchanges half of what is left.
template <int LPC, int G>
__device__ __forceinline__ void reduce_scatter(float (&acc)[G], int g) {
  constexpr int kRounds = LPC >= 32 ? 5 : LPC >= 16 ? 4 : LPC >= 8 ? 3 : LPC >= 4 ? 2
                        : LPC >= 2 ? 1 : 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int m = LPC >> (r + 1);
    const int half = G >> (r + 1);
    const bool up = g & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float lo = acc[i], hi = acc[i + half];
      const float send = up ? lo : hi;
      const float keep = up ? hi : lo;
      acc[i] = keep + __shfl_xor_sync(kFull, send, m);
    }
  }
}

template <typename Tin, typename Tout, int LPC>
__global__ void __launch_bounds__(kMaxThreads)
    selective_scan_kernel(const Params p) {
  constexpr int S = kStates;
  constexpr int K = S * LPC;               // padded state size
  // 32 decays a lane in flight (faster on the card than 16)
  constexpr int U = kDecaySteps;
  constexpr int G = LPC > U ? LPC : U;     // steps per reduce-scatter group
  constexpr int Q = G / LPC;               // steps each lane finishes per group
  constexpr int kIn = 16 / sizeof(Tin);    // elements per 16-byte vector
  constexpr int kOut = 16 / sizeof(Tout);

  extern __shared__ float4 smem4[];
  const int L = p.L, C = p.C, N = p.N, cpb = p.cpb, T = p.chunk;
  const int xs = cpb + kIn;                // row stride of the x / dt tiles
  const int ysd = cpb + kOut;              // row stride of the y tile
  const int tile = T * xs;
  const int tn = T * N;
  Tin* ring = reinterpret_cast<Tin*>(smem4);          // [2][x, dt][T][xs]
  Tin* raw = ring + 4 * tile;                         // [2][B, C][T * N]
  float* table = reinterpret_cast<float*>(raw + 4 * tn);  // [2][T][2K]
  Tout* ytile = reinterpret_cast<Tout*>(table + 2 * T * 2 * K);  // [2][T][ysd]

  const Tin* __restrict__ x = static_cast<const Tin*>(p.x);
  const Tin* __restrict__ dt = static_cast<const Tin*>(p.dt);
  const Tin* __restrict__ Bm = static_cast<const Tin*>(p.Bm);
  const Tin* __restrict__ Cm = static_cast<const Tin*>(p.Cm);
  Tout* __restrict__ y = static_cast<Tout*>(p.y);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.y, c0 = blockIdx.x * cpb;
  const int ci = tid / LPC, g = tid % LPC;
  const int c = c0 + ci;
  const bool valid_c = c < C;
  const int nchunks = (L + T - 1) / T;
  const size_t row_b = static_cast<size_t>(b) * L;

  float a2[S], h[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int n = g * S + k;
    a2[k] = (valid_c && n < N) ? p.A[static_cast<size_t>(c) * N + n] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  const float dd = valid_c ? p.D[c] : 0.f;

  // chunk k's x and dt -> ring stage s
  auto stage_x = [&](int k, int s) {
    const int t0 = k * T;
    Tin* dst = ring + 2 * s * tile;
    if (p.vec_x) {
      const int vpr = cpb / kIn;
      const int per = T * vpr;
      for (int e = tid; e < 2 * per; e += nthreads) {
        const int arr = e >= per;
        const int r = e - arr * per, t = r / vpr, v = r - t * vpr;
        const int cc = c0 + v * kIn;
        const bool ok = t0 + t < L && cc < C;
        const Tin* src = arr ? dt : x;
        cp_async16(dst + arr * tile + t * xs + v * kIn,
                   ok ? src + (row_b + t0 + t) * C + cc : src, ok);
      }
    } else {
      const int per = T * cpb;
      for (int e = tid; e < 2 * per; e += nthreads) {
        const int arr = e >= per;
        const int r = e - arr * per, t = r / cpb, v = r - t * cpb;
        const int cc = c0 + v;
        const Tin* src = arr ? dt : x;
        dst[arr * tile + t * xs + v] =
            (t0 + t < L && cc < C) ? src[(row_b + t0 + t) * C + cc] : zero<Tin>();
      }
    }
  };
  // chunk k's B and C (contiguous T * N elements each) -> raw stage s
  auto stage_bc = [&](int k, int s) {
    const int t0 = k * T;
    const int valid = min(T, L - t0) * N;
    const size_t off = (row_b + t0) * N;
    Tin* dst = raw + 2 * s * tn;
    if (p.vec_bc) {
      const int nv = tn / kIn;
      for (int e = tid; e < 2 * nv; e += nthreads) {
        const int arr = e >= nv;
        const int v = e - arr * nv;
        const bool ok = v * kIn < valid;
        const Tin* src = arr ? Cm : Bm;
        cp_async16(dst + arr * tn + v * kIn, ok ? src + off + v * kIn : src, ok);
      }
    } else {
      for (int e = tid; e < 2 * tn; e += nthreads) {
        const int arr = e >= tn;
        const int v = e - arr * tn;
        const Tin* src = arr ? Cm : Bm;
        dst[arr * tn + v] = v < valid ? src[off + v] : zero<Tin>();
      }
    }
  };
  // raw stage s -> fp32 table s: row t holds, for lane g, B[gS..gS+S) then
  // C[gS..gS+S), zero past N
  auto widen_bc = [&](int s) {
    const Tin* rb = raw + 2 * s * tn;
    float* dst = table + s * T * 2 * K;
    for (int e = tid; e < T * K; e += nthreads) {
      const int t = e / K, n = e % K;
      float bv = 0.f, cv = 0.f;
      if (n < N) {
        bv = to_float(rb[t * N + n]);
        cv = to_float(rb[tn + t * N + n]);
      }
      float* d = dst + t * 2 * K + (n / S) * 2 * S + n % S;
      d[0] = bv;
      d[S] = cv;
    }
  };
  // y tile s (chunk k) -> y
  auto store_y = [&](int k, int s) {
    const int t0 = k * T;
    const Tout* src = ytile + s * T * ysd;
    if (p.vec_y) {
      const int vpr = cpb / kOut;
      for (int e = tid; e < T * vpr; e += nthreads) {
        const int t = e / vpr, v = e - t * vpr;
        const int cc = c0 + v * kOut;
        if (t0 + t < L && cc < C)
          *reinterpret_cast<uint4*>(y + (row_b + t0 + t) * C + cc) =
              *reinterpret_cast<const uint4*>(src + t * ysd + v * kOut);
      }
    } else {
      for (int e = tid; e < T * cpb; e += nthreads) {
        const int t = e / cpb, v = e - t * cpb;
        if (t0 + t < L && c0 + v < C) y[(row_b + t0 + t) * C + c0 + v] = src[t * ysd + v];
      }
    }
  };
  // the recurrence over one staged chunk
  auto run_chunk = [&](int s) {
    const Tin* xr = ring + 2 * s * tile + ci;
    const Tin* dr = xr + tile;
    const float* bc = table + s * T * 2 * K + g * 2 * S;
    Tout* yo = ytile + s * T * ysd + ci;
#pragma unroll 2
    for (int t0 = 0; t0 < T; t0 += G) {
      float xq[Q], dq[Q], dxq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int t = t0 + g * Q + q;
        xq[q] = to_float(xr[t * xs]);
        dq[q] = to_float(dr[t * xs]);
        dxq[q] = dq[q] * xq[q];
      }
      float acc[G];
#pragma unroll
      for (int u0 = 0; u0 < G; u0 += U) {
        float dA[U][S], dB[U][S];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int step = u0 + j;
          float dtv, dxv;
          if constexpr (LPC > 1) {
            dtv = __shfl_sync(kFull, dq[step % Q], step / Q, LPC);
            dxv = __shfl_sync(kFull, dxq[step % Q], step / Q, LPC);
          } else {
            dtv = dq[step];
            dxv = dxq[step];
          }
          float bv[S];
          load_states(bc + (t0 + step) * 2 * K, bv);
#pragma unroll
          for (int k = 0; k < S; ++k) {
            dA[j][k] = fast_exp2(dtv * a2[k]);
            dB[j][k] = dxv * bv[k];
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          float cv[S];
          load_states(bc + (t0 + u0 + j) * 2 * K + S, cv);
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < S; ++k) {
            h[k] = fmaf(dA[j][k], h[k], dB[j][k]);
            sum = fmaf(h[k], cv[k], sum);
          }
          acc[u0 + j] = sum;
        }
      }
      reduce_scatter<LPC, G>(acc, g);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        yo[(t0 + g * Q + q) * ysd] = from_float<Tout>(fmaf(dd, xq[q], acc[q]));
    }
  };

  // prologue: chunk 0's x/dt, B/C of chunks 0 and 1; chunk 0's table
  stage_x(0, 0);
  stage_bc(0, 0);
  if (nchunks > 1) stage_bc(1, 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  widen_bc(0);
  __syncthreads();
  // Invariant at the top of iteration k (s = k & 1): x/dt of chunk k in
  // ring s, chunk k's table in table s, B/C of chunk k+1 landed in raw s^1.
  for (int k = 0; k < nchunks; ++k) {
    const int s = k & 1;
    if (k > 0) store_y(k - 1, s ^ 1);
    if (k + 1 < nchunks) {
      widen_bc(s ^ 1);
      stage_x(k + 1, s ^ 1);
    }
    if (k + 2 < nchunks) stage_bc(k + 2, s);
    cp_async_commit();
    run_chunk(s);
    cp_async_wait<0>();
    __syncthreads();
  }
  store_y(nchunks - 1, (nchunks - 1) & 1);
}

template <typename Tin, typename Tout, int LPC>
static cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.N, kStates * LPC, p.cpb, p.chunk, sizeof(Tin));
  auto kernel = selective_scan_kernel<Tin, Tout, LPC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + p.cpb - 1) / p.cpb, B);
  kernel<<<grid, p.cpb * LPC, smem, stream>>>(p);
  return cudaGetLastError();
}

// LPC instantiated: 1, 2, 4, 8, 16, 32 (N up to 4, 8, 16, 32, 64, 128)
template <typename Tin, typename Tout>
static cudaError_t launch_lanes(const Params& p, int B, int lpc, cudaStream_t st) {
  switch (lpc) {
    case 1: return launch<Tin, Tout, 1>(p, B, st);
    case 2: return launch<Tin, Tout, 2>(p, B, st);
    case 4: return launch<Tin, Tout, 4>(p, B, st);
    case 8: return launch<Tin, Tout, 8>(p, B, st);
    case 16: return launch<Tin, Tout, 16>(p, B, st);
    case 32: return launch<Tin, Tout, 32>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace scan
}  // namespace repro

// in_dtype: storage type of x, dt, Bm, Cm; out_dtype: of y (x's type, so
// bf16 inputs give bf16 y).  lanes (LPC), channels (cpb) and chunk come
// from plan_scan; the entry point refuses a plan the kernel
// does not take and picks the 16-byte paths from the widths and addresses.
extern "C" int repro_selective_scan(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D, void* y,
                                    int B, int L, int C, int N, int lanes, int channels,
                                    int chunk, int in_dtype, int out_dtype,
                                    void* stream) {
  using namespace repro;
  using namespace repro::scan;
  const int K = kStates * lanes;
  const int in_size = in_dtype == kBFloat16 ? 2 : 4;
  const int out_size = out_dtype == kBFloat16 ? 2 : 4;
  const int threads = channels * lanes;
  const int group = lanes > kDecaySteps ? lanes : kDecaySteps;
  if (N < 1 || N > K || K > 128 || threads % 32 != 0 || threads > kMaxThreads ||
      (channels * in_size) % 16 != 0 || (channels * out_size) % 16 != 0 || chunk % 16 != 0 ||
      chunk < group || out_size > in_size ||
      smem_bytes(N, K, channels, chunk, in_size) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, static_cast<const float*>(A), Bm, Cm, static_cast<const float*>(D), y,
           L, C, N, channels, chunk, 0, 0, 0};
  p.vec_x = (C * in_size) % 16 == 0 && aligned16(x) && aligned16(dt);
  p.vec_bc = (N * in_size) % 16 == 0 && aligned16(Bm) && aligned16(Cm);
  p.vec_y = (C * out_size) % 16 == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return static_cast<int>(launch_lanes<float, float>(p, B, lanes, s));
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return static_cast<int>(launch_lanes<float, __nv_bfloat16>(p, B, lanes, s));
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return static_cast<int>(launch_lanes<__nv_bfloat16, __nv_bfloat16>(p, B, lanes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
