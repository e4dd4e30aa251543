// RMSNorm, optionally on x + residual: y = (x * rsqrt(mean(x^2) + eps)) * w,
// computed in fp32, stored in x's dtype.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
// (bodies _rms_kernel and _rms_res_kernel).
//
// Bound on the H100: bytes.  A row of 2048 bf16 is 4 KB read and 4 KB
// written for ~4 flops per element, far below the card's ~295 flops/byte
// ridge.  Design: one warp per row, so the row's reduction is a register
// sum plus a 5-step warp shuffle and needs no shared memory or block
// barrier; 16-byte vector loads (8 bf16 per lane) keep each warp's reads
// fully coalesced.  The second pass re-reads the row, which a 4 KB row
// finds in L1/L2.  `row_block` warps share one CUDA block.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                               const T* __restrict__ w, T* __restrict__ y,
                               int rows, int dim, float eps, int vectorized) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  const T* rr = res ? res + static_cast<size_t>(row) * dim : nullptr;
  T* yr = y + static_cast<size_t>(row) * dim;
  constexpr int V = Vec16<T>::N;

  float ss = 0.f;
  if (vectorized) {
    for (int i = lane * V; i < dim; i += 32 * V) {
      float v[V];
      load16(xr + i, v);
      if (rr) {
        float t[V];
        load16(rr + i, t);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += t[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ss += v[j] * v[j];
    }
  } else {
    for (int i = lane; i < dim; i += 32) {
      float v = to_float(xr[i]);
      if (rr) v += to_float(rr[i]);
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(dim) + eps);

  if (vectorized) {
    for (int i = lane * V; i < dim; i += 32 * V) {
      float v[V], wv[V];
      load16(xr + i, v);
      if (rr) {
        float t[V];
        load16(rr + i, t);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += t[j];
      }
      load16(w + i, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = v[j] * inv * wv[j];
      store16(yr + i, v);
    }
  } else {
    for (int i = lane; i < dim; i += 32) {
      float v = to_float(xr[i]);
      if (rr) v += to_float(rr[i]);
      yr[i] = from_float<T>(v * inv * to_float(w[i]));
    }
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* r, const void* w, void* y,
                          int rows, int dim, float eps, int row_block,
                          int vectorized, cudaStream_t stream) {
  dim3 block(32 * row_block);
  dim3 grid((rows + row_block - 1) / row_block);
  rmsnorm_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<T*>(y), rows, dim, eps, vectorized);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_rmsnorm(const void* x, const void* residual, const void* w,
                             void* y, int rows, int dim, float eps, int dtype,
                             int row_block, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(x, residual, w, y, rows, dim, eps, row_block,
                                vectorized, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(x, residual, w, y, rows, dim, eps,
                                        row_block, vectorized, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
