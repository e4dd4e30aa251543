// RMSNorm, optionally on x + residual: y = (x * rsqrt(mean(x^2) + eps)) * w,
// computed in fp32, stored in x's dtype.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
// (bodies _rms_kernel and _rms_res_kernel).
//
// Bound on the H100: bytes.  A row of 2048 bf16 is 4 KB read and 4 KB
// written for ~4 flops per element, far below the card's ~295 flops/byte
// ridge; at the sizes the port calls it with (4 to 2048 rows) the byte
// bound is below a microsecond, so what costs is latency: DRAM round trips
// that follow one another, and SMs left idle when rows are few.
// Design: one pass over device memory.  Each lane holds SLOTS 16-byte
// vectors of its row (or SLOTS scalars, for widths that are not whole
// vectors and for unaligned tensors), and every load of the row, the
// residual and the weight is issued before the first is used, so a row
// costs one round trip; the normalising pass reads registers, and x +
// residual is added once and kept.  A row spans `wpr` warps (1, 2, 4 or
// 8): several when rows are few, so a 4-row decode call still has all of
// its loads in flight at once; their partial sums meet in shared memory
// behind one barrier, added in warp order (deterministic).  With one warp
// per row, `rpb` rows share a block.  The host plans wpr, rpb and SLOTS
// from the shapes alone (repro_torch/kernels/rmsnorm/kernel.py,
// plan_rmsnorm); a width no instantiation covers is refused.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kMaxRmsWarps = 8;  // warps of one block (wpr * rpb)

// one slot of a row: a 16-byte vector or one element
template <typename T, bool VEC>
struct Slot {
  static constexpr int E = VEC ? Vec16<T>::N : 1;  // elements per slot
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  static __device__ __forceinline__ Raw load(const T* p, int s) {
    if constexpr (VEC) return *reinterpret_cast<const uint4*>(p + s * E);
    else return p[s];
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* out) {
    if constexpr (VEC) load16(reinterpret_cast<const T*>(&r), out);
    else out[0] = to_float(r);
  }
  static __device__ __forceinline__ void store(T* p, int s, const float* in) {
    if constexpr (VEC) store16(p + s * E, in);
    else p[s] = from_float<T>(in[0]);
  }
};

template <typename T, int SLOTS, bool VEC>
__global__ void __launch_bounds__(32 * kMaxRmsWarps)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const T* __restrict__ w, T* __restrict__ y, int rows, int dim,
                   float eps, int wpr) {
  using S = Slot<T, VEC>;
  constexpr int E = S::E;
  __shared__ float partial[kMaxRmsWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = blockDim.x / (32 * wpr);
  const int row = blockIdx.x * rpb + warp / wpr;
  const bool active = row < rows;
  const int lanes = 32 * wpr;                        // lanes of one row
  const int first = (warp % wpr) * 32 + lane;        // this lane's first slot
  const int n_slots = dim / E;
  const size_t off = static_cast<size_t>(active ? row : 0) * dim;

  // every load in flight at once: x, residual, weight
  typename S::Raw xr[SLOTS], rr[SLOTS], wr[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = first + k * lanes;
    if (active && s < n_slots) {
      xr[k] = S::load(x + off, s);
      if (res) rr[k] = S::load(res + off, s);
      wr[k] = S::load(w, s);
    }
  }
  float v[SLOTS][E];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = first + k * lanes;
#pragma unroll
    for (int j = 0; j < E; ++j) v[k][j] = 0.f;
    if (active && s < n_slots) {
      S::widen(xr[k], v[k]);
      if (res) {
        float t[E];
        S::widen(rr[k], t);
#pragma unroll
        for (int j = 0; j < E; ++j) v[k][j] += t[j];
      }
#pragma unroll
      for (int j = 0; j < E; ++j) ss += v[k][j] * v[k][j];
    }
  }
  ss = warp_sum(ss);
  if (wpr > 1) {  // the row's warps meet once; every warp adds in warp order
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    const int w0 = (warp / wpr) * wpr;
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += partial[w0 + i];
  }
  if (!active) return;
  const float inv = rsqrtf(ss / static_cast<float>(dim) + eps);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = first + k * lanes;
    if (s < n_slots) {
      float wv[E];
      S::widen(wr[k], wv);
#pragma unroll
      for (int j = 0; j < E; ++j) v[k][j] = v[k][j] * inv * wv[j];
      S::store(y + off, s, v[k]);
    }
  }
}

template <typename T, bool VEC>
static cudaError_t launch_slots(const void* x, const void* r, const void* w, void* y,
                                int rows, int dim, float eps, int rpb, int wpr, int slots,
                                cudaStream_t stream) {
  dim3 block(32 * wpr * rpb);
  dim3 grid((rows + rpb - 1) / rpb);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
#define REPRO_RMS(N)                                                                \
  case N:                                                                           \
    rmsnorm_kernel<T, N, VEC><<<grid, block, 0, stream>>>(xt, rt, wt, yt, rows, dim, \
                                                          eps, wpr);                \
    break;
  switch (slots) {
    REPRO_RMS(1)
    REPRO_RMS(2)
    REPRO_RMS(3)
    REPRO_RMS(4)
    REPRO_RMS(5)
    REPRO_RMS(6)
    REPRO_RMS(8)
    REPRO_RMS(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RMS
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* x, const void* r, const void* w, void* y, int rows,
                          int dim, float eps, int rpb, int wpr, int slots, int vectorized,
                          cudaStream_t stream) {
  const int e = vectorized ? Vec16<T>::N : 1;
  const bool wpr_ok = wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8;
  if (!wpr_ok || rpb < 1 || wpr * rpb > kMaxRmsWarps || (wpr > 1 && rpb != 1) ||
      dim % e != 0 || static_cast<long>(slots) * 32 * wpr * e < dim)
    return cudaErrorInvalidValue;
  return vectorized ? launch_slots<T, true>(x, r, w, y, rows, dim, eps, rpb, wpr, slots, stream)
                    : launch_slots<T, false>(x, r, w, y, rows, dim, eps, rpb, wpr, slots,
                                             stream);
}

}  // namespace repro

// rows_per_block (rpb) rows of warps_per_row (wpr) warps each per block;
// slots: 16-byte vectors (vectorized) or elements per lane
extern "C" int repro_rmsnorm(const void* x, const void* residual, const void* w,
                             void* y, int rows, int dim, float eps, int dtype,
                             int rows_per_block, int warps_per_row, int slots,
                             int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(x, residual, w, y, rows, dim, eps, rows_per_block,
                                warps_per_row, slots, vectorized, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(x, residual, w, y, rows, dim, eps, rows_per_block,
                                        warps_per_row, slots, vectorized, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
