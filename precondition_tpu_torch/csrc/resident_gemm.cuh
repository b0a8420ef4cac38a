// The resident products of the Newton-root kernel, shared by
// csrc/newton_root.cu (its resident path) and csrc/matmul_chain.cu (the same
// products with no Newton control, which times them).
//
// One 256-thread CTA holds one member's iterates in dynamic shared memory:
// buffers of kRes rows with row stride kLd.  A product is an f32 FMA GEMM on
// a 16x16 thread grid, 8x8 outputs a thread, one fmaf per k in order
// 0..n-1, over the member's valid n x n corner.  Every write to a buffer
// covers its whole kRes x kRes tile and stores zero outside the corner, so
// the float4 reads past n add nothing.  A product's output stays in the
// threads' registers (acc) until res_store writes it, which may be over one
// of its own inputs.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide maximum over a kWarps scratch in shared memory that propagates
// NaN like jnp.max: every thread gets the same value.
__device__ float cta_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = nan_max(t, red[w]);
  __syncthreads();
  return t;
}

constexpr int kRes = 128;          // largest m the resident path takes
constexpr int kLd = kRes + 4;      // row stride of a resident buffer, floats
constexpr int kResBuf = kRes * kLd;
constexpr int kResSmem = 3 * kResBuf * (int)sizeof(float);  // 202,752 B

// The resident path takes p = 2^k or 2^k + 1: their T^p chain needs one
// stored matrix.
__host__ __device__ inline bool resident(int m, int p) {
  const int q = (p > 1 && (p & 1)) ? p - 1 : p;
  return m <= kRes && p >= 1 && (q & (q - 1)) == 0;
}

// Row and column of a thread's i-th / j-th output, as in newton_root.cu's
// cta_gemm.
__device__ __forceinline__ int own_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x >> 4) * 4 + (i & 3);
}
__device__ __forceinline__ int own_col(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x & 15) * 4 + (j & 3);
}

// acc = A @ B over the n x n corner of two resident buffers.  With TA (TB)
// the operand is T = (1 + 1/p) I - X/p of the buffer X, computed on read
// with the expression newton_root.cu's global path stores, and zero
// outside the corner.  Reads only: the caller stores acc when every thread
// is done (res_store).
template <bool TA, bool TB>
__device__ __forceinline__ void res_gemm(const float* __restrict__ A,
                                         const float* __restrict__ B, int n,
                                         float inv_p, float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const float diag = 1.f + inv_p;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n4 = (n + 3) & ~3;
  for (int k0 = 0; k0 < n4; k0 += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = own_row(i);
      const float4 v = *reinterpret_cast<const float4*>(A + r * kLd + k0);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
      if (TA) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          a[i][kk] = (r == k0 + kk && r < n ? diag : 0.f) - inv_p * a[i][kk];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = B + (k0 + kk) * kLd + tx * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
      float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if (TB) {
        const int k = k0 + kk;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = (k == own_col(j) && k < n ? diag : 0.f) - inv_p * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
    }
  }
}

// Stores acc over C (which may be an operand of the product that made it),
// zero outside the corner.  Barriers before and after.
__device__ __forceinline__ void res_store(const float (&acc)[8][8], float* C, int n) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = own_row(i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = own_col(4 * h);
      float4 v;
      v.x = r < n && c < n ? acc[i][4 * h] : 0.f;
      v.y = r < n && c + 1 < n ? acc[i][4 * h + 1] : 0.f;
      v.z = r < n && c + 2 < n ? acc[i][4 * h + 2] : 0.f;
      v.w = r < n && c + 3 < n ? acc[i][4 * h + 3] : 0.f;
      *reinterpret_cast<float4*>(C + r * kLd + c) = v;
    }
  }
  __syncthreads();
}

}  // namespace
