// f32 GEMM with a fused epilogue, on CUDA cores:
//
//     C[M, N] = act(A[M, K] @ W[K, N] + bias[N]) (+ R[M, N])
//
// A, W, R and C are row-major and contiguous; W keeps the JAX package's
// (in, out) layout, so no transpose is made anywhere. It computes every
// product the TPU kernels on the main path compute in their own bodies: the
// layer front's joint (B*N, d) x (d, 7d) projection, the edge (B*E, d) x
// (d, d) projection and the attention out-projection (residual epilogue), and
// the FFN's two products (gelu epilogue, then residual epilogue).
//
// Bound on the H100: at the main path's shapes these products are bound by
// f32 operations (67 TFLOP/s outside the tensor cores), not bytes. Design: a
// classic shared-memory tiled SGEMM -- 64x64 output tile per block of 256
// threads, each thread a 4x4 register tile, K stepped 16 at a time through
// shared memory, edges guarded so any M, N, K works. It is simple and right
// first; the tensor-core (TF32/wgmma) version is later work.
#pragma once

#include "common.cuh"

namespace ggps {
namespace {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_TM = 4;
constexpr int GEMM_TN = 4;
constexpr int GEMM_THREADS = (GEMM_BM / GEMM_TM) * (GEMM_BN / GEMM_TN);  // 256

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_act_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     const float* __restrict__ bias, const float* __restrict__ R,
                     float* __restrict__ C, int M, int N, int K, int act) {
  __shared__ float As[GEMM_BK][GEMM_BM + 4];  // A tile, stored k-major
  __shared__ float Ws[GEMM_BK][GEMM_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (GEMM_BN / GEMM_TN);
  const int ty = tid / (GEMM_BN / GEMM_TN);
  const int row0 = blockIdx.y * GEMM_BM;
  const int col0 = blockIdx.x * GEMM_BN;

  float acc[GEMM_TM][GEMM_TN];
#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
      const int m = i / GEMM_BK, k = i % GEMM_BK;
      const int gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.0f;
    }
    for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
      const int k = i / GEMM_BN, n = i % GEMM_BN;
      const int gk = k0 + k, gc = col0 + n;
      Ws[k][n] = (gk < K && gc < N) ? W[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GEMM_BK; ++k) {
      float a[GEMM_TM], b[GEMM_TN];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i) a[i] = As[k][ty * GEMM_TM + i];
#pragma unroll
      for (int j = 0; j < GEMM_TN; ++j) b[j] = Ws[k][tx * GEMM_TN + j];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i) {
    const int r = row0 + ty * GEMM_TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) {
      const int c = col0 + tx * GEMM_TN + j;
      if (c >= N) continue;
      float v = apply_act(acc[i][j] + bias[c], act);
      if (R != nullptr) v = v + R[(size_t)r * N + c];
      C[(size_t)r * N + c] = v;
    }
  }
}

inline cudaError_t gemm_bias_act(const float* A, const float* W, const float* bias,
                                 const float* R, float* C, int M, int N, int K,
                                 int act, cudaStream_t stream) {
  const dim3 grid(cdiv(N, GEMM_BN), cdiv(M, GEMM_BM));
  gemm_bias_act_kernel<<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, R, C, M, N, K,
                                                          act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ggps
