// Mamba-2 SSD (state-space duality), chunked, fp32 inside.  Per head h:
//   S_t = exp(dt_t * A_h) * S_{t-1} + B_t (dt_t x_t)^T   (state (N, P))
//   y_t = C_t^T S_t + D_h * x_t
// x (B, L, H, P); dt (B, L, H); A, D (H,) fp32; Bm, Cm (B, L, G, N), head h
// reads group h / (H / G); y (B, L, H, P).  Inputs share one storage type
// (fp32 or bf16); y has x's type.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel).
//
// Bound on the H100: the recurrence needs ~4*N*P fp32 flops per (b, t, h)
// (state update and read-out) against one read of x and one write of y;
// at zamba2-2.7b's training shape (B 2, L 1024, H 80, P 64, N 64) that is
// ~2.7 GFLOP (40 us at 67 TFLOP/s fp32) against ~45 MB of bf16 traffic
// (13 us): operations bound it.  The chunked form below does more
// (Q*Q*(N+P)/2 + 2*Q*N*P per chunk of Q steps) in exchange for parallel
// work inside a chunk; on tensor cores it would be three small GEMMs per
// chunk, which is the later, faster kernel.
// Design: one block per (head, batch) walks the chunks in order, with the
// (N, P) state in shared memory (where the TPU kernel kept it in VMEM
// scratch across a sequential grid axis).  Per chunk of Q = `chunk` steps
// it stages x, dt, B and C as fp32, takes the cumulative log-decay
// cum_t = sum_{s<=t} dt_s A_h, and then, with fp32 FMAs:
//   M[t][s] = <C_t, B_s> exp(cum_t - cum_s) dt_s           for s <= t only
//   y_t     = sum_{s<=t} M[t][s] x_s + exp(cum_t) C_t^T S + D_h x_t
//   S      <- exp(cum_end) S + sum_s B_s exp(cum_end - cum_s) dt_s x_s^T
// The decay is computed only where s <= t: above the diagonal cum_t - cum_s
// is positive and its exp could overflow (the TPU kernel computes the
// whole square and masks afterwards).  The chunk is at most 64, so the
// Q x Q tile fits beside the state; the config's requested 256 is snapped
// down by the wrapper, which changes the rounding, not the result.  B and
// C rows are padded by one float so that a warp reading one column of
// <C_t, B_s> across s hits 32 banks.  L not a multiple of Q is masked.
#include "common.cuh"

namespace repro {

constexpr int kSsdThreads = 256;

static size_t ssd_smem(int N, int P, int Q) {
  return (static_cast<size_t>(N) * P + static_cast<size_t>(Q) * P +
          2 * static_cast<size_t>(Q) * (N + 1) + static_cast<size_t>(Q) * Q + 3 * Q) *
         sizeof(float);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ dt,
               const float* __restrict__ A, const Tin* __restrict__ Bm,
               const Tin* __restrict__ Cm, const float* __restrict__ D,
               Tout* __restrict__ y, int L, int H, int P, int G, int N, int Q) {
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

  for (int e = tid; e < N * P; e += kSsdThreads) S[e] = 0.f;

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
}

template <typename Tin, typename Tout>
static cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                          const void* Cm, const float* D, void* y, int B, int L, int H,
                          int P, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = ssd_smem(N, P, Q);
  auto kernel = ssd_kernel<Tin, Tout>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kernel<<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(dt), A,
      static_cast<const Tin*>(Bm), static_cast<const Tin*>(Cm), D, static_cast<Tout*>(y), L,
      H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace repro

// in_dtype: storage type of x, dt, Bm, Cm; out_dtype: of y.
extern "C" int repro_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, const void* D, void* y, int B, int L, int H, int P,
                         int G, int N, int Q, int in_dtype, int out_dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  if (G < 1 || H % G != 0 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SSD(TI, TO) return launch<TI, TO>(x, dt, a, Bm, Cm, d, y, B, L, H, P, G, N, Q, s)
  if (in_dtype == kFloat32 && out_dtype == kFloat32) REPRO_SSD(float, float);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16) REPRO_SSD(float, __nv_bfloat16);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16) REPRO_SSD(__nv_bfloat16, __nv_bfloat16);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32) REPRO_SSD(__nv_bfloat16, float);
#undef REPRO_SSD
  return static_cast<int>(cudaErrorInvalidValue);
}
