// f32 GEMM on CUDA cores, in three layouts, with a fused epilogue:
//
//   NN  C[M, N] = epi(A[M, K] @ W[K, N])        forward products, W (in, out)
//   NT  C[M, N] = epi(A[M, K] @ B[N, K]^T)      input gradients G @ W^T
//   TN  C[M, N] = A[K, M]^T @ G[K, N]           weight gradients X^T @ G, K = rows
//
//   epi(acc): pre = acc + bias[n]   (bias optional; `pre` optionally stored)
//             v = drop(act(pre))    (dropout on the (M, N) view, optional)
//             C = v + R[m, n]       (residual optional)
//   (common.cuh Epi, shared with the tensor-core GEMM gemm_tc.cuh)
//
// All operands row-major and contiguous; weights keep the JAX package's
// (in, out) layout, so no transpose is made anywhere. These are the products
// the TPU kernels on the main path compute in their own bodies (_dot, _dot_nt,
// _dot_tn of ops/pallas/fused_gatedgcn.py); its one user left is the
// long-graph attention's projections (wide_attention.cu), with their input
// and weight gradients in the backward.
//
// Bound on the H100: at the main path's shapes these products are bound by
// f32 operations (67 TFLOP/s outside the tensor cores), not bytes. Design: a
// classic shared-memory tiled SGEMM -- 64x64 output tile per block of 256
// threads, each thread a 4x4 register tile, K stepped 16 at a time through
// shared memory, edges guarded so any M, N, K works. A weight gradient has few
// output tiles and a long K (all rows), so TN splits K over blockIdx.z into
// partials that a second pass adds in split order: no float atomics, and two
// runs give the same bits. Every other kernel runs its products on the
// tensor cores (gemm_tc.cuh, ffn_fused.cuh).
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

// A element (m, k): TA ? A[k * M + m] : A[m * K + k]
// B element (k, n): TB ? B[n * K + k] : B[k * N + n]
// blockIdx.z selects a K range of k_split; with gridDim.z > 1 the raw sums go
// to C + z * M * N and the epilogue is not applied.
template <bool TA, bool TB>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K, int k_split, Epi epi) {
  __shared__ float As[GEMM_BK][GEMM_BM + 4];  // A tile, stored k-major
  __shared__ float Bs[GEMM_BK][GEMM_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (GEMM_BN / GEMM_TN);
  const int ty = tid / (GEMM_BN / GEMM_TN);
  const int row0 = blockIdx.y * GEMM_BM;
  const int col0 = blockIdx.x * GEMM_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  float acc[GEMM_TM][GEMM_TN];
#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += GEMM_BK) {
    for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
      // neighbouring threads on neighbouring addresses in either layout
      const int m = TA ? i % GEMM_BM : i / GEMM_BK;
      const int k = TA ? i / GEMM_BM : i % GEMM_BK;
      const int gr = row0 + m, gk = k0 + k;
      float a = 0.0f;
      if (gr < M && gk < k_end) a = TA ? A[(size_t)gk * M + gr] : A[(size_t)gr * K + gk];
      As[k][m] = a;
    }
    for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
      const int n = TB ? i / GEMM_BK : i % GEMM_BN;
      const int k = TB ? i % GEMM_BK : i / GEMM_BN;
      const int gk = k0 + k, gc = col0 + n;
      float b = 0.0f;
      if (gk < k_end && gc < N) b = TB ? B[(size_t)gc * K + gk] : B[(size_t)gk * N + gc];
      Bs[k][n] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GEMM_BK; ++k) {
      float a[GEMM_TM], b[GEMM_TN];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i) a[i] = As[k][ty * GEMM_TM + i];
#pragma unroll
      for (int j = 0; j < GEMM_TN; ++j) b[j] = Bs[k][tx * GEMM_TN + j];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
  float* Cz = C + (split ? (size_t)blockIdx.z * M * N : 0);
#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i) {
    const int r = row0 + ty * GEMM_TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) {
      const int c = col0 + tx * GEMM_TN + j;
      if (c >= N) continue;
      const size_t idx = (size_t)r * N + c;
      if (split) {
        Cz[idx] = acc[i][j];
        continue;
      }
      float v = acc[i][j];
      if (epi.bias != nullptr) v += epi.bias[c];
      if (epi.pre != nullptr) epi.pre[idx] = v;
      v = drop_apply(epi.drop, idx, apply_act(v, epi.act));
      if (epi.res != nullptr) v += epi.res[idx];
      C[idx] = v;
    }
  }
}

template <bool TA, bool TB>
inline cudaError_t gemm_launch(const float* A, const float* B, float* C, int M, int N,
                               int K, const Epi& epi, cudaStream_t stream) {
  const dim3 grid(cdiv(N, GEMM_BN), cdiv(M, GEMM_BM), 1);
  gemm_kernel<TA, TB><<<grid, GEMM_THREADS, 0, stream>>>(A, B, C, M, N, K, K, epi);
  return cudaGetLastError();
}

// C = epi(A @ W), W (K, N)
inline cudaError_t gemm_nn(const float* A, const float* W, float* C, int M, int N,
                           int K, const Epi& epi, cudaStream_t stream) {
  return gemm_launch<false, false>(A, W, C, M, N, K, epi, stream);
}

// C = epi(A @ B^T), B (N, K): an input gradient G @ W^T with W (in=N, out=K)
inline cudaError_t gemm_nt(const float* A, const float* B, float* C, int M, int N,
                           int K, const Epi& epi, cudaStream_t stream) {
  return gemm_launch<false, true>(A, B, C, M, N, K, epi, stream);
}

// K splits of a TN product: enough blocks for two waves over 132 SMs, at
// least 256 rows each.
inline int tn_splits(int M, int N, int K) {
  const int tiles = cdiv(M, GEMM_BM) * cdiv(N, GEMM_BN);
  int s = cdiv(2 * 132, tiles);
  s = min(s, max(1, K / 256));
  return max(1, min(s, 64));
}

// floats of scratch gemm_tn needs for these shapes
inline size_t tn_scratch(int M, int N, int K) {
  const int s = tn_splits(M, N, K);
  return s > 1 ? (size_t)s * M * N : 0;
}

// C (M, N) = A^T @ G with A (K, M), G (K, N): a weight gradient X^T @ G over
// K rows. scratch holds tn_scratch(M, N, K) floats.
inline cudaError_t gemm_tn(const float* A, const float* G, float* C, int M, int N,
                           int K, float* scratch, cudaStream_t stream) {
  const int s = tn_splits(M, N, K);
  if (s == 1) return gemm_launch<true, false>(A, G, C, M, N, K, Epi(), stream);
  const int k_split = cdiv(cdiv(K, s), GEMM_BK) * GEMM_BK;
  const dim3 grid(cdiv(N, GEMM_BN), cdiv(M, GEMM_BM), cdiv(K, k_split));
  gemm_kernel<true, false><<<grid, GEMM_THREADS, 0, stream>>>(A, G, scratch, M, N, K,
                                                              k_split, Epi());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(scratch, C, 1, grid.z, (long long)M * N, stream);
}

// The three products as one type, for a body written over either GEMM
// (ffn_core.cuh): these on the CUDA cores, tc::Gemm (gemm_tc.cuh) on the
// tensor cores.
struct Gemm {
  static cudaError_t nn(const float* A, const float* W, float* C, int M, int N, int K,
                        const Epi& epi, cudaStream_t st) {
    return gemm_nn(A, W, C, M, N, K, epi, st);
  }
  static cudaError_t nt(const float* A, const float* B, float* C, int M, int N, int K,
                        const Epi& epi, cudaStream_t st) {
    return gemm_nt(A, B, C, M, N, K, epi, st);
  }
  static cudaError_t tn(const float* A, const float* G, float* C, int M, int N, int K,
                        float* scratch, cudaStream_t st) {
    return gemm_tn(A, G, C, M, N, K, scratch, st);
  }
  static size_t scratch(int M, int N, int K) { return tn_scratch(M, N, K); }
};

}  // namespace
}  // namespace ggps
