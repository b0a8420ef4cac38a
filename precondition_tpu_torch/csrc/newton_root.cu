// Batched coupled-Newton inverse p-th root for Hopper (sm_90a), true f32.
//
// Replaces the Pallas TPU kernel precondition_tpu/ops/pallas/newton_root.py
// (`_kernel`, launched by `batched_inverse_pth_root_pallas`).  Same inputs,
// outputs and semantics: for each member of a [N, m, m] PSD batch,
// (A + r I)^{-1/p} with r = ridge_epsilon * max(lambda_max, 1e-25), per-member
// Newton exit (error <= tolerance, a step whose error ratio is >= max_ratio
// is rejected, at most num_iters steps), the ridge x10 retry ladder, the
// certified warm round 0 from `prevs` (even p), padding masks, and
// symmetrised roots.
//
// What bounds it on this card: a Newton step at m=128 is 4 dependent
// [128,128] products (T^2, T^4, T^p M, H T for p=4), 16.8 MFLOP, and the
// products must run in true f32 (TF32 rounding breaks the coupled
// iteration's invariant, so no tensor cores).  The kernel is bound by the
// f32 FMA rate of the CUDA cores, and by whether the operands of those
// FMAs come from shared memory or have to travel from global memory.
//
// Both paths run a persistent grid of 256-thread CTAs, each owning one
// matrix at a time (i = blockIdx.x; i < N; i += gridDim.x), so every member
// exits its Newton loop and its retry ladder on its own with no straggler
// coupling.  Every product is the same FMA GEMM: a 16x16 thread grid, 8x8
// outputs a thread, one fmaf per k in order 0..n-1, over the member's valid
// n x n corner only (n = padding start; padded rows and columns are zero in
// every iterate).  Block-wide reductions give max|M - I|, the Frobenius
// norm and the 1-norm bound.  The launcher picks the path from (m, p):
//
// * Resident (m <= 128 and p = 2^k or 2^k + 1, the main path's p = 4 and
//   p = 2 among them): every iterate of one member stays in the CTA's
//   dynamic shared memory, three [128][132] f32 buffers (202,752 B of the
//   232,448 B a block may use, so one CTA per SM).  Two facts make three
//   buffers enough.  T = (1 + 1/p) I - M/p is never stored: a product reads
//   it from M, one FMA per operand element, zero outside the corner.  And
//   a product's 128x128 output lives in the 256 threads' registers until a
//   barrier, so it can be stored over one of its own inputs.  So M, H and
//   one scratch W hold a Newton step whose T^p chain needs one stored
//   matrix, which is what p = 2^k (squarings in place) and p = 2^k + 1
//   (T times the last square, in place) need; p = 6 or 7 would need two.
//   A fourth [128][132] buffer would not fit, which is also why the path
//   stops at m = 128.  No iterate touches global memory inside the Newton
//   loop: the statistics are read once per ladder round and the root
//   written once.  Operands are read from shared memory as float4 (A along
//   k, B along columns); the row stride 132 puts a warp's two A rows on
//   different banks.
// * Global (m in (128, 1024], or p such as 6 or 7): the iterates live in a
//   per-CTA workspace of kBuffers m*m matrices in global memory, allocated
//   by the caller (7 x 64 KB at m = 128, which over 132 CTAs overflows the
//   50 MB L2), and each product streams both operands through a 16-deep
//   shared-memory stage.  It is bound by those loads as much as by the
//   FMAs.
//
// Maxima propagate NaN like jnp.max (fmaxf would drop it and let a NaN
// step pass the error-ratio test).

#include <cuda_runtime.h>
#include <stdint.h>

#include "resident_gemm.cuh"

namespace {

constexpr int kTile = 128;  // output tile edge of one CTA-wide GEMM pass
constexpr int kBK = 16;     // depth of one shared-memory stage
constexpr int kAPad = 4;
constexpr int kBuffers = 7;  // M, H, T, X and three matrix-power temps
constexpr float kLn10 = 2.302585092994046f;

struct __align__(16) Smem {
  float a[kBK][kTile + kAPad];  // A tile, transposed (k-major)
  float b[kBK][kTile];
  float red[kWarps];
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Block-wide sum over a kWarps scratch in shared memory (cta_max, in
// resident_gemm.cuh, is its maximum): every thread gets the same value.
__device__ float cta_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// C = A @ B over the n x n corner of row-major matrices with leading
// dimension ld.  C must not alias A or B.  Ends with a barrier, so C is
// visible to the whole CTA.
__device__ void cta_gemm(const float* __restrict__ A, const float* __restrict__ B,
                         float* __restrict__ C, int n, int ld, Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int r0 = 0; r0 < n; r0 += kTile) {
    for (int c0 = 0; c0 < n; c0 += kTile) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kBK) {
        for (int idx = tid; idx < kTile * kBK; idx += kThreads) {
          const int r = idx / kBK, k = idx % kBK;
          const int gr = r0 + r, gk = k0 + k;
          s.a[k][r] = (gr < n && gk < n) ? A[(size_t)gr * ld + gk] : 0.f;
        }
        for (int idx = tid; idx < kTile * kBK; idx += kThreads) {
          const int k = idx / kTile, c = idx % kTile;
          const int gk = k0 + k, gc = c0 + c;
          s.b[k][c] = (gk < n && gc < n) ? B[(size_t)gk * ld + gc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
          const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4 + 64]);
          const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4 + 64]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
          if (col < n) C[(size_t)row * ld + col] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();
}

// base^p by square-and-multiply (the product order of the JAX package's
// `_bmat_power`).  Returns a pointer to the result: `base` itself for p=1,
// otherwise one of the three temps.  `base` is never written.
__device__ const float* cta_pow(const float* base, int p, float* const tmp[3],
                                int n, int ld, Smem& s) {
  const float* out = nullptr;
  const float* sq = base;
  while (p > 0) {
    if (p & 1) {
      if (out == nullptr) {
        out = sq;
      } else {
        float* d = tmp[0] != out && tmp[0] != sq ? tmp[0]
                 : tmp[1] != out && tmp[1] != sq ? tmp[1] : tmp[2];
        cta_gemm(out, sq, d, n, ld, s);
        out = d;
      }
    }
    p >>= 1;
    if (p) {
      float* d = tmp[0] != out && tmp[0] != sq ? tmp[0]
               : tmp[1] != out && tmp[1] != sq ? tmp[1] : tmp[2];
      cta_gemm(sq, sq, d, n, ld, s);
      sq = d;
    }
  }
  return out;
}

// max over the n x n corner of |scale * X - I|.
__device__ float cta_err(const float* X, float scale, int n, int ld, Smem& s) {
  float v = 0.f;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    v = nan_max(v, fabsf(X[(size_t)i * ld + j] * scale - (i == j ? 1.f : 0.f)));
  }
  return cta_max(v, s.red);
}

struct Params {
  const float* stats;
  const int32_t* pads;
  const float* max_evs;
  const float* prevs;  // null for a cold solve
  float* roots;
  float* errors;
  float* iters;
  float* retries;
  float* max_ev_out;
  float* workspace;  // gridDim.x * kBuffers * m * m
  int n_mats, m, p;
  int num_iters, num_tries;
  int relative_matrix_epsilon;
  float ridge_epsilon, error_tolerance, warm_error_threshold;
  float retry_threshold, max_error_ratio;
};

// P > 0 fixes the exponent at compile time; P == 0 reads it from prm.p.
template <int P>
__global__ void __launch_bounds__(kThreads)
newton_root_kernel(const Params prm) {
  __shared__ Smem s;
  const int m = prm.m;
  const size_t mm = (size_t)m * m;
  const int p = P > 0 ? P : prm.p;
  const float pf = (float)p;
  const float inv_p = 1.f / pf;
  const bool warm = prm.prevs != nullptr;
  const int total_rounds = warm ? prm.num_tries + 1 : prm.num_tries;
  float* ws = prm.workspace + (size_t)blockIdx.x * kBuffers * mm;

  for (int b = blockIdx.x; b < prm.n_mats; b += gridDim.x) {
    const float* S = prm.stats + (size_t)b * mm;
    const float* prev = warm ? prm.prevs + (size_t)b * mm : nullptr;
    const int n = min(max(prm.pads[b], 0), m);
    const float max_ev = prm.relative_matrix_epsilon ? prm.max_evs[b] : 1.f;
    const float ridge = prm.ridge_epsilon * nan_max(max_ev, 1e-25f);

    float* M = ws;
    float* H = ws + mm;
    float* T = ws + 2 * mm;
    float* X = ws + 3 * mm;
    float* const tmp[3] = {ws + 4 * mm, ws + 5 * mm, ws + 6 * mm};

    float error = 1000.f, iters = 0.f, retries = 0.f;
    bool failed = true, warm_final = false, entered = false;
    for (int rnd = 0; rnd < total_rounds && failed; ++rnd) {
      const float expo = (float)(warm ? max(rnd - 1, 0) : rnd);
      const float ridge_i = ridge * expf(expo * kLn10);

      float fro2 = 0.f;
      for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int i = idx / n, j = idx % n;
        const float d = S[(size_t)i * m + j] + (i == j ? ridge_i : 0.f);
        fro2 += d * d;
      }
      const float fro = sqrtf(cta_sum(fro2, s.red));
      const float z = (1.f + pf) / (2.f * nan_max(fro, 1e-30f));

      bool use_warm = false;
      if (warm && rnd == 0) {
        // Round 0 tries C (A + rI) C with C = prev^{p/2}, certified by
        // |z_w M0_w - I| <= warm_error_threshold.
        const float* C = cta_pow(prev, p / 2, tmp, n, m, s);
        cta_gemm(S, C, T, n, m, s);
        cta_gemm(C, T, X, n, m, s);
        for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
          const int i = idx / n, j = idx % n;
          if (i < j) {
            const float v = 0.5f * (X[(size_t)i * m + j] + X[(size_t)j * m + i]);
            X[(size_t)i * m + j] = v;
            X[(size_t)j * m + i] = v;
          }
        }
        __syncthreads();
        cta_gemm(C, C, T, n, m, s);
        for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
          const int i = idx / n, j = idx % n;
          M[(size_t)i * m + j] = X[(size_t)i * m + j] + ridge_i * T[(size_t)i * m + j];
        }
        __syncthreads();
        // 1-norm bound: the largest absolute row sum, one warp per row.
        float bound = 0.f;
        for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
          float r = 0.f;
          for (int j = threadIdx.x & 31; j < n; j += 32) r += fabsf(M[(size_t)i * m + j]);
          for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
          bound = nan_max(bound, r);
        }
        bound = cta_max(bound, s.red);
        const float z_w = nan_min(1.f, (1.f + pf) / (2.f * nan_max(bound, 1e-30f)));
        use_warm = cta_err(M, z_w, n, m, s) <= prm.warm_error_threshold;
        if (use_warm) {
          const float hs = expf(logf(z_w) * inv_p);
          for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
            const int i = idx / n, j = idx % n;
            M[(size_t)i * m + j] *= z_w;
            H[(size_t)i * m + j] = prev[(size_t)i * m + j] * hs;
          }
          __syncthreads();
        }
      }
      if (!use_warm) {
        const float hs = expf(logf(z) * inv_p);
        for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
          const int i = idx / n, j = idx % n;
          const float d = S[(size_t)i * m + j] + (i == j ? ridge_i : 0.f);
          M[(size_t)i * m + j] = d * z;
          H[(size_t)i * m + j] = i == j ? hs : 0.f;
        }
        __syncthreads();
      }

      float n_err = cta_err(M, 1.f, n, m, s);
      float n_it = 0.f;
      bool active = n_err > prm.error_tolerance;
      for (int it = 0; it < prm.num_iters && active; ++it) {
        for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
          const int i = idx / n, j = idx % n;
          T[(size_t)i * m + j] = (i == j ? 1.f + inv_p : 0.f) - inv_p * M[(size_t)i * m + j];
        }
        __syncthreads();
        const float* Tp = cta_pow(T, p, tmp, n, m, s);
        cta_gemm(Tp, M, X, n, m, s);
        const float new_err = cta_err(X, 1.f, n, m, s);
        const float ratio = new_err / nan_max(n_err, 1e-30f);
        const bool ok = ratio < prm.max_error_ratio;
        if (ok) {
          // Adopt M <- T^p M, then H <- H T; a rejected step keeps both.
          float* t = M; M = X; X = t;
          cta_gemm(H, T, X, n, m, s);
          t = H; H = X; X = t;
          n_err = new_err;
          n_it += 1.f;
        }
        active = ok && n_err > prm.error_tolerance;
      }
      error = n_err;
      iters = n_it;
      retries += 1.f;
      warm_final = use_warm;
      entered = true;
      failed = error > prm.retry_threshold;
    }

    // The cold principal root is symmetric up to rounding, so it is
    // symmetrised; a warm root only where the warm round was taken.
    const bool sym = !warm || warm_final;
    float* R = prm.roots + (size_t)b * mm;
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
      const int i = idx / m, j = idx % m;
      float v = 0.f;
      if (entered && i < n && j < n) {
        v = sym ? 0.5f * (H[(size_t)i * m + j] + H[(size_t)j * m + i])
                : H[(size_t)i * m + j];
      }
      R[idx] = v;
    }
    if (threadIdx.x == 0) {
      prm.errors[b] = n == 0 ? 0.f : error;
      prm.iters[b] = iters;
      prm.retries[b] = retries;
      prm.max_ev_out[b] = max_ev;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Resident path: the iterates of one member live in three shared-memory
// buffers of kRes rows with row stride kLd.  Every write to a buffer covers
// its whole kRes x kRes tile and stores zero outside the member's n x n
// corner, so the float4 reads past n in the GEMM add nothing.  The buffers'
// layout, the path's (m, p) rule and its products (res_gemm, res_store) are
// in resident_gemm.cuh.

// This thread's share of max over the corner of |acc - I|.
__device__ __forceinline__ float acc_err(const float (&acc)[8][8], int n) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = own_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = own_col(j);
      if (r < n && c < n) v = nan_max(v, fabsf(acc[i][j] - (r == c ? 1.f : 0.f)));
    }
  }
  return v;
}

// dst = scale * src (global, row stride m) on the corner, zero elsewhere.
__device__ void res_stage(const float* __restrict__ src, float scale, float* dst,
                          int n, int m) {
  for (int idx = threadIdx.x; idx < kRes * kRes; idx += kThreads) {
    const int i = idx / kRes, j = idx % kRes;
    dst[i * kLd + j] = i < n && j < n ? src[(size_t)i * m + j] * scale : 0.f;
  }
  __syncthreads();
}

// max over the corner of |scale * X - I|, X a resident buffer.
__device__ float res_err(const float* X, float scale, int n, float* red) {
  float v = 0.f;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    v = nan_max(v, fabsf(X[i * kLd + j] * scale - (i == j ? 1.f : 0.f)));
  }
  return cta_max(v, red);
}

__global__ void __launch_bounds__(kThreads, 1)
newton_root_resident(const Params prm) {
  extern __shared__ __align__(16) float res_smem[];
  __shared__ float red[kWarps];
  const int m = prm.m;
  const size_t mm = (size_t)m * m;
  const int p = prm.p;
  const float pf = (float)p;
  const float inv_p = 1.f / pf;
  const bool warm = prm.prevs != nullptr;
  const int total_rounds = warm ? prm.num_tries + 1 : prm.num_tries;
  float acc[8][8];

  for (int b = blockIdx.x; b < prm.n_mats; b += gridDim.x) {
    const float* S = prm.stats + (size_t)b * mm;
    const float* prev = warm ? prm.prevs + (size_t)b * mm : nullptr;
    const int n = min(max(prm.pads[b], 0), m);
    const float max_ev = prm.relative_matrix_epsilon ? prm.max_evs[b] : 1.f;
    const float ridge = prm.ridge_epsilon * nan_max(max_ev, 1e-25f);

    // Roles of the three buffers; the Newton loop swaps M and W.
    float* M = res_smem;
    float* H = res_smem + kResBuf;
    float* W = res_smem + 2 * kResBuf;

    float error = 1000.f, iters = 0.f, retries = 0.f;
    bool failed = true, warm_final = false, entered = false;
    for (int rnd = 0; rnd < total_rounds && failed; ++rnd) {
      const float expo = (float)(warm ? max(rnd - 1, 0) : rnd);
      const float ridge_i = ridge * expf(expo * kLn10);

      float fro2 = 0.f;
      for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int i = idx / n, j = idx % n;
        const float d = S[(size_t)i * m + j] + (i == j ? ridge_i : 0.f);
        fro2 += d * d;
      }
      const float fro = sqrtf(cta_sum(fro2, red));
      const float z = (1.f + pf) / (2.f * nan_max(fro, 1e-30f));

      bool use_warm = false;
      if (warm && rnd == 0) {
        // Round 0 tries C (A + rI) C with C = prev^{p/2}, certified by
        // |z_w M0_w - I| <= warm_error_threshold.  p is a power of two
        // here, so C is prev squared in place.  C goes to H, S to M, and
        // the products to W.
        if (p == 2) {
          res_stage(prev, 1.f, H, n, m);
        } else {
          res_stage(prev, 1.f, M, n, m);
          res_gemm<false, false>(M, M, n, inv_p, acc);
          res_store(acc, H, n);
          for (int q = 4; q < p; q *= 2) {
            res_gemm<false, false>(H, H, n, inv_p, acc);
            res_store(acc, H, n);
          }
        }
        res_stage(S, 1.f, M, n, m);
        res_gemm<false, false>(M, H, n, inv_p, acc);  // S C
        res_store(acc, W, n);
        res_gemm<false, false>(H, W, n, inv_p, acc);  // C (S C)
        res_store(acc, W, n);
        for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
          const int i = idx / n, j = idx % n;
          if (i < j) {
            const float v = 0.5f * (W[i * kLd + j] + W[j * kLd + i]);
            W[i * kLd + j] = v;
            W[j * kLd + i] = v;
          }
        }
        __syncthreads();
        // M0_w = C (A + rI) C = sym(C S C) + r C^2, C^2 from registers.
        res_gemm<false, false>(H, H, n, inv_p, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = own_row(i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = own_col(j);
            M[r * kLd + c] = r < n && c < n ? W[r * kLd + c] + ridge_i * acc[i][j] : 0.f;
          }
        }
        __syncthreads();
        // 1-norm bound: the largest absolute row sum, one warp per row.
        float bound = 0.f;
        for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
          float r = 0.f;
          for (int j = threadIdx.x & 31; j < n; j += 32) r += fabsf(M[i * kLd + j]);
          for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
          bound = nan_max(bound, r);
        }
        bound = cta_max(bound, red);
        const float z_w = nan_min(1.f, (1.f + pf) / (2.f * nan_max(bound, 1e-30f)));
        use_warm = res_err(M, z_w, n, red) <= prm.warm_error_threshold;
        if (use_warm) {
          const float hs = expf(logf(z_w) * inv_p);
          for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
            const int i = idx / n, j = idx % n;
            M[i * kLd + j] *= z_w;
          }
          res_stage(prev, hs, H, n, m);
        }
      }
      if (!use_warm) {
        const float hs = expf(logf(z) * inv_p);
        for (int idx = threadIdx.x; idx < kRes * kRes; idx += kThreads) {
          const int i = idx / kRes, j = idx % kRes;
          const bool in = i < n && j < n;
          const float d = in ? S[(size_t)i * m + j] + (i == j ? ridge_i : 0.f) : 0.f;
          M[i * kLd + j] = in ? d * z : 0.f;
          H[i * kLd + j] = in && i == j ? hs : 0.f;
        }
        __syncthreads();
      }

      float n_err = res_err(M, 1.f, n, red);
      float n_it = 0.f;
      bool active = n_err > prm.error_tolerance;
      for (int it = 0; it < prm.num_iters && active; ++it) {
        // X = T^p M in registers, T^p built in W by cta_pow's product
        // order: T T, squarings in place, then T W for odd p.
        if (p == 1) {
          res_gemm<true, false>(M, M, n, inv_p, acc);
        } else {
          res_gemm<true, true>(M, M, n, inv_p, acc);
          res_store(acc, W, n);
          for (int q = 4; q <= p; q *= 2) {
            res_gemm<false, false>(W, W, n, inv_p, acc);
            res_store(acc, W, n);
          }
          if (p & 1) {
            res_gemm<true, false>(M, W, n, inv_p, acc);
            res_store(acc, W, n);
          }
          res_gemm<false, false>(W, M, n, inv_p, acc);
        }
        const float new_err = cta_max(acc_err(acc, n), red);
        const float ratio = new_err / nan_max(n_err, 1e-30f);
        const bool ok = ratio < prm.max_error_ratio;
        if (ok) {
          // Adopt M <- T^p M, then H <- H T with T from the old M; a
          // rejected step keeps both.
          res_store(acc, W, n);
          res_gemm<false, true>(H, M, n, inv_p, acc);
          res_store(acc, H, n);
          float* t = M;
          M = W;
          W = t;
          n_err = new_err;
          n_it += 1.f;
        }
        active = ok && n_err > prm.error_tolerance;
      }
      error = n_err;
      iters = n_it;
      retries += 1.f;
      warm_final = use_warm;
      entered = true;
      failed = error > prm.retry_threshold;
    }

    const bool sym = !warm || warm_final;
    float* R = prm.roots + (size_t)b * mm;
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
      const int i = idx / m, j = idx % m;
      float v = 0.f;
      if (entered && i < n && j < n) {
        v = sym ? 0.5f * (H[i * kLd + j] + H[j * kLd + i]) : H[i * kLd + j];
      }
      R[idx] = v;
    }
    if (threadIdx.x == 0) {
      prm.errors[b] = n == 0 ? 0.f : error;
      prm.iters[b] = iters;
      prm.retries[b] = retries;
      prm.max_ev_out[b] = max_ev;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// m*m matrices of global workspace each CTA needs: 0 on the resident path.
int newton_root_workspace_buffers(int m, int p) { return resident(m, p) ? 0 : kBuffers; }

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error that refused the resident kernel its shared memory.  `prevs`
// may be null (cold solve); `max_evs` is read only when
// relative_matrix_epsilon is nonzero; `workspace` holds
// grid * newton_root_workspace_buffers(m, p) * m * m floats and may be null
// when that is 0.
int newton_root_launch(const float* stats, const int32_t* pads, const float* max_evs,
                       const float* prevs, float* roots, float* errors, float* iters,
                       float* retries, float* max_ev_out, float* workspace,
                       int n_mats, int m, int p, int grid, int num_iters,
                       float ridge_epsilon, float error_tolerance,
                       int relative_matrix_epsilon, float warm_error_threshold,
                       float retry_threshold, int num_tries, float max_error_ratio,
                       void* stream) {
  Params prm;
  prm.stats = stats;
  prm.pads = pads;
  prm.max_evs = max_evs;
  prm.prevs = prevs;
  prm.roots = roots;
  prm.errors = errors;
  prm.iters = iters;
  prm.retries = retries;
  prm.max_ev_out = max_ev_out;
  prm.workspace = workspace;
  prm.n_mats = n_mats;
  prm.m = m;
  prm.p = p;
  prm.num_iters = num_iters;
  prm.num_tries = num_tries;
  prm.relative_matrix_epsilon = relative_matrix_epsilon;
  prm.ridge_epsilon = ridge_epsilon;
  prm.error_tolerance = error_tolerance;
  prm.warm_error_threshold = warm_error_threshold;
  prm.retry_threshold = retry_threshold;
  prm.max_error_ratio = max_error_ratio;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident(m, p)) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_root_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, kResSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    newton_root_resident<<<grid, kThreads, kResSmem, st>>>(prm);
    return static_cast<int>(cudaGetLastError());
  }
  if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 2: newton_root_kernel<2><<<grid, kThreads, 0, st>>>(prm); break;
    case 4: newton_root_kernel<4><<<grid, kThreads, 0, st>>>(prm); break;
    case 6: newton_root_kernel<6><<<grid, kThreads, 0, st>>>(prm); break;
    case 8: newton_root_kernel<8><<<grid, kThreads, 0, st>>>(prm); break;
    default: newton_root_kernel<0><<<grid, kThreads, 0, st>>>(prm); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* newton_root_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
