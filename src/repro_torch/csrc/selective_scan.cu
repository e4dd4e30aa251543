// Mamba-1 selective scan, fp32 inside:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = <h_t, C_t> + D * x_t
// x, dt (B, L, C); A (C, N) fp32; Bm, Cm (B, L, N); D (C,) fp32; y (B, L, C).
// Inputs share one storage type (fp32 or bf16); y has x's type.
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py::
// selective_scan_pallas (body _scan_kernel).
//
// Bound on the H100: B*L*C*N exponentials plus ~6 fp32 flops each, against
// one read of x, dt, B, C and one write of y.  At the training shape (B 2,
// L 1024, C 8192, N 16) that is ~1.9e9 operations (28 us at 67 TFLOP/s
// fp32) against ~100 MB of bf16 traffic (30 us at 3.35 TB/s): the two are
// close, and the exponentials run on the special-function units.
// Design: the recurrence is sequential in t, so the sequence loop runs
// inside the block with the state in registers (where the TPU kernel kept
// it in VMEM scratch across a sequential grid axis).  Each channel gets
// `lpc` lanes of one warp (the smallest power of two with lpc * 4 >= N);
// each lane holds 4 of the channel's N states, and a shuffle over the lpc
// lanes sums <h_t, C_t>.  That gives B*C*lpc threads instead of B*C, so
// the card has enough warps to hide the exp/FMA latency of the recurrence.
// A block takes `c_block` consecutive channels of one batch row and walks
// the sequence `chunk` steps at a time: it stages x and dt (coalesced over
// the channels), B_t and C_t (shared by every channel of the row) as fp32
// in shared memory, runs the chunk, and writes y back coalesced from a
// shared tile.  The ragged edges (L not a multiple of chunk, C not a
// multiple of c_block) are masked, not padded.
#include "common.cuh"

namespace repro {

constexpr int kStatesPerLane = 4;

template <typename Tin, typename Tout>
__global__ void selective_scan_kernel(const Tin* __restrict__ x, const Tin* __restrict__ dt,
                                      const float* __restrict__ A,
                                      const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
                                      const float* __restrict__ D, Tout* __restrict__ y,
                                      int L, int C, int N, int lpc, int c_block, int chunk) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [chunk][c_block]
  float* ds = xs + chunk * c_block;             // [chunk][c_block]
  float* ys = ds + chunk * c_block;             // [chunk][c_block]
  float* bs = ys + chunk * c_block;             // [chunk][N]
  float* cs = bs + chunk * N;                   // [chunk][N]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * c_block;
  const int ci = threadIdx.x / lpc, lane = threadIdx.x % lpc;
  const int c = c0 + ci;
  const bool valid_c = c < C;
  const int nthreads = blockDim.x;

  float a[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int n = lane + k * lpc;
    a[k] = (valid_c && n < N) ? A[static_cast<size_t>(c) * N + n] : 0.f;
    h[k] = 0.f;
  }
  const float dc = valid_c ? D[c] : 0.f;
  const size_t row = static_cast<size_t>(b) * L;

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int steps = min(chunk, L - t0);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int e = threadIdx.x; e < chunk * c_block; e += nthreads) {
      const int tt = e / c_block, cc = c0 + e % c_block;
      float xv = 0.f, dv = 0.f;
      if (tt < steps && cc < C) {
        const size_t off = (row + t0 + tt) * C + cc;
        xv = to_float(x[off]);
        dv = to_float(dt[off]);
      }
      xs[e] = xv;
      ds[e] = dv;
    }
    for (int e = threadIdx.x; e < chunk * N; e += nthreads) {
      const int tt = e / N;
      float bv = 0.f, cv = 0.f;
      if (tt < steps) {
        const size_t off = (row + t0) * N + e;
        bv = to_float(Bm[off]);
        cv = to_float(Cm[off]);
      }
      bs[e] = bv;
      cs[e] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float xv = xs[tt * c_block + ci];
      const float dv = ds[tt * c_block + ci];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kStatesPerLane; ++k) {
        const int n = lane + k * lpc;
        if (n < N) {
          h[k] = __expf(dv * a[k]) * h[k] + dx * bs[tt * N + n];
          acc += h[k] * cs[tt * N + n];
        }
      }
      for (int o = lpc >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) ys[tt * c_block + ci] = acc + dc * xv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < steps * c_block; e += nthreads) {
      const int tt = e / c_block, cc = c0 + e % c_block;
      if (cc < C) y[(row + t0 + tt) * C + cc] = from_float<Tout>(ys[e]);
    }
  }
}

static size_t selective_scan_smem(int N, int c_block, int chunk) {
  return (3 * static_cast<size_t>(chunk) * c_block + 2 * static_cast<size_t>(chunk) * N) *
         sizeof(float);
}

template <typename Tin, typename Tout>
static cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                          const void* Cm, const float* D, void* y, int B, int L, int C,
                          int N, int lpc, int c_block, int chunk, cudaStream_t stream) {
  const size_t smem = selective_scan_smem(N, c_block, chunk);
  auto kernel = selective_scan_kernel<Tin, Tout>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + c_block - 1) / c_block, B);
  kernel<<<grid, c_block * lpc, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(dt), A,
      static_cast<const Tin*>(Bm), static_cast<const Tin*>(Cm), D, static_cast<Tout*>(y), L,
      C, N, lpc, c_block, chunk);
  return cudaGetLastError();
}

}  // namespace repro

// in_dtype: storage type of x, dt, Bm, Cm; out_dtype: of y.  The wrapper
// checks shapes and that c_block * lpc is a multiple of 32 and <= 1024.
extern "C" int repro_selective_scan(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D, void* y,
                                    int B, int L, int C, int N, int lpc, int c_block,
                                    int chunk, int in_dtype, int out_dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  if (lpc < 1 || lpc > 32 || N > kStatesPerLane * lpc || (c_block * lpc) % 32 != 0 ||
      c_block * lpc > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SCAN(TI, TO) \
  return launch<TI, TO>(x, dt, a, Bm, Cm, d, y, B, L, C, N, lpc, c_block, chunk, s)
  if (in_dtype == kFloat32 && out_dtype == kFloat32) REPRO_SCAN(float, float);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16) REPRO_SCAN(float, __nv_bfloat16);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16) REPRO_SCAN(__nv_bfloat16, __nv_bfloat16);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32) REPRO_SCAN(__nv_bfloat16, float);
#undef REPRO_SCAN
  return static_cast<int>(cudaErrorInvalidValue);
}
