// Inline-PTX building blocks for the tensor-core and asynchronous-copy
// kernels: cp.async (16 bytes a thread, zero-filled past the data),
// ldmatrix (plain and transposed) and the bf16 m16n8k16 mma.sync with fp32
// accumulators.  Fragment layouts of mma.m16n8k16 (lane l, group g = l / 4,
// thread-in-group t = l % 4):
//   A (16 x 16, row-major), 4 x b32 of two bf16:  a0 (row g, cols 2t, 2t+1),
//     a1 (row g + 8, cols 2t..), a2 (row g, cols 2t + 8..), a3 (row g + 8,
//     cols 2t + 8..);
//   B (16 x 8, "col": stored n-major), 2 x b32:  b0 (k 2t, 2t+1; n g),
//     b1 (k 2t + 8, 2t + 9; n g);
//   C (16 x 8, fp32):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g + 8).
// The lower-indexed element of a pair sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid == false nothing is read and
// the 16 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives element pair (row l / 4, cols 2(l % 4), +1)
// of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the same, each matrix transposed: lane l receives (rows 2(l % 4), +1;
// col l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (bf16 inputs, fp32 accumulate)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (flush-to-zero; 2^-huge is exactly 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one b32 of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace repro
