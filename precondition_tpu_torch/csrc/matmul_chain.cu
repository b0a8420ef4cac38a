// The Newton iteration's matmul chain with no Newton control, for Hopper
// (sm_90a), true f32: a timing probe of the Newton-root kernel's products.
//
// Replaces the Pallas TPU kernel benchmarks/pallas_tile_breakdown.py
// (`_matmul_only_kernel`, launched by `_matmul_only`).  Same inputs, output
// and arithmetic: for each member of a [N, m, m] batch, M = stats and H = I,
// then `iters` times
//   T = 1.25 I - 0.25 M,  M <- (T^p M) / max(max|T^p M|, 1e-30),  H <- H T,
// and the member's H + M is written out.  The maximum propagates NaN like
// jnp.max, and the renormalisation is a division, as in JAX.
//
// What bounds it on this card: every step is the p-th power chain, T^p M and
// H T, dependent [m, m] products of 2 m^3 FLOP each, in true f32 (the
// products it times must not run in TF32), so it is bound by the f32 FMA
// rate of the CUDA cores.  Its design is the Newton kernel's resident path
// with the control taken out: one 256-thread CTA per member over a
// persistent grid, M, H and one scratch W resident in three [128][132] f32
// buffers of dynamic shared memory (202,752 B, one CTA per SM), and every
// product made by resident_gemm.cuh's res_gemm / res_store in the Newton
// loop's order, its store of T^p M over W and its swap of M and W included.
// Where the Newton step tests its error, the ratio and the tolerance, this
// step takes one block-wide maximum of |T^p M| and divides by it.  So the
// Newton kernel's per-step time minus this kernel's is what the Newton
// control costs.  It admits the resident path's (m, p): m <= 128 and
// p = 2^k or 2^k + 1.

#include <cuda_runtime.h>

#include "resident_gemm.cuh"

namespace {

// T = (1 + inv_p) I - inv_p M with inv_p = 1/4 for every p, the JAX body's
// hard-coded 1.25 I - 0.25 M.
constexpr float kInvP = 0.25f;

__global__ void __launch_bounds__(kThreads, 1)
matmul_chain_kernel(const float* __restrict__ stats, float* __restrict__ out,
                    int n_mats, int m, int p, int iters) {
  extern __shared__ __align__(16) float res_smem[];
  __shared__ float red[kWarps];
  const size_t mm = (size_t)m * m;
  float acc[8][8];

  for (int b = blockIdx.x; b < n_mats; b += gridDim.x) {
    const float* S = stats + (size_t)b * mm;
    // Roles of the three buffers; the loop swaps M and W.
    float* M = res_smem;
    float* H = res_smem + kResBuf;
    float* W = res_smem + 2 * kResBuf;
    for (int idx = threadIdx.x; idx < kRes * kRes; idx += kThreads) {
      const int i = idx / kRes, j = idx % kRes;
      const bool in = i < m && j < m;
      M[i * kLd + j] = in ? S[(size_t)i * m + j] : 0.f;
      H[i * kLd + j] = in && i == j ? 1.f : 0.f;
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      // T^p M in registers, T^p built in W as the Newton loop builds it:
      // T T, squarings in place, then T W for odd p.
      if (p == 1) {
        res_gemm<true, false>(M, M, m, kInvP, acc);
      } else {
        res_gemm<true, true>(M, M, m, kInvP, acc);
        res_store(acc, W, m);
        for (int q = 4; q <= p; q *= 2) {
          res_gemm<false, false>(W, W, m, kInvP, acc);
          res_store(acc, W, m);
        }
        if (p & 1) {
          res_gemm<true, false>(M, W, m, kInvP, acc);
          res_store(acc, W, m);
        }
        res_gemm<false, false>(W, M, m, kInvP, acc);
      }
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = own_row(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = own_col(j);
          if (r < m && c < m) v = nan_max(v, fabsf(acc[i][j]));
        }
      }
      const float scale = nan_max(cta_max(v, red), 1e-30f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] / scale;
      // M <- T^p M / scale over W, then H <- H T with T from the old M.
      res_store(acc, W, m);
      res_gemm<false, true>(H, M, m, kInvP, acc);
      res_store(acc, H, m);
      float* t = M;
      M = W;
      W = t;
    }

    float* O = out + (size_t)b * mm;
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
      const int i = idx / m, j = idx % m;
      O[idx] = H[i * kLd + j] + M[i * kLd + j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), the
// error that refused the kernel its shared memory, or cudaErrorInvalidValue
// for arguments it does not take (m or p outside the resident rule).
int matmul_chain_launch(const float* stats, float* out, int n_mats, int m, int p,
                        int iters, int grid, void* stream) {
  if (m < 1 || !resident(m, p) || iters < 0 || n_mats < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kResSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_chain_kernel<<<grid, kThreads, kResSmem, static_cast<cudaStream_t>(stream)>>>(
      stats, out, n_mats, m, p, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* matmul_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
