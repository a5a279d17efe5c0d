// Shared device helpers for the port's kernels (f32 throughout).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ggps {

// Activation codes shared with the Python wrappers (ops/kernels/build.py ACTS).
enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2 };

// gelu is the exact-erf form (torch nn.GELU() default, graphgps_tpu
// models/common.py act registry); the TPU kernels approximate erf with
// Abramowitz-Stegun (|err| < 1.5e-7), here erff is used directly.
__device__ __forceinline__ float apply_act(float z, int act) {
  if (act == ACT_RELU) return fmaxf(z, 0.0f);
  if (act == ACT_GELU) return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
  return z;
}

// d act / dz: relu's is 0 at z = 0 (as torch and the TPU kernels take it);
// gelu's is Phi(z) + z phi(z).
__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == ACT_RELU) return z > 0.0f ? 1.0f : 0.0f;
  if (act == ACT_GELU)
    return 0.5f * (1.0f + erff(z * 0.70710678118654752f))
           + z * expf(-0.5f * z * z) * 0.3989422804014327f;
  return 1.0f;
}

// ---------------------------------------------------------------------------
// Dropout: one counter hash of (seed, site, row, column) over a site's logical
// 2-D (rows, cols) view, the same in ops/kernels/common.py (torch integer ops)
// so a kernel and its plain version draw bit-identical masks, whatever the
// tiling. mix32 is the finalizer of graphgps_tpu/ops/pallas/fused_tail.py
// _bits; the 64-bit counter idx = row * cols + col is folded in as
// mix32(lo ^ mix32(hi ^ key)). Keep rule (fused_tail.py _keep, u8 grid): keep
// when (bits & 255) >= t, scale kept values by 1 / (1 - t/256). The backward
// replays the forward's masks from the same seed; no mask is stored.

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

struct Drop {
  const uint32_t* seed;  // the step's seed in device memory (null when t = 0
                         // and once resolved)
  uint32_t salt;         // 0x9E3779B9 * (site + 1)
  int t;                 // keep threshold on the u8 grid; 0 = no dropout
  float scale;           // 1 / (1 - t/256), rounded to f32 by the wrapper
  uint32_t key;          // drop_key(seed, site), once resolved
};

// The seed is read in the kernel, not passed by value: a CUDA graph that
// captures the launch replays it with whatever seed the buffer holds then.
inline Drop make_drop(const uint32_t* seed, int site, int t, float scale) {
  Drop dp;
  dp.seed = t > 0 ? seed : nullptr;
  dp.salt = 0x9E3779B9u * (uint32_t)(site + 1);
  dp.t = t;
  dp.scale = scale;
  dp.key = 0u;
  return dp;
}

// The Drop with its key computed from the seed read in the kernel: each
// kernel resolves its Drops once a thread at its start, so the hash of an
// element costs what it cost with the key passed by value.
__device__ __forceinline__ Drop resolved(Drop dp) {
  if (dp.seed != nullptr) {
    dp.key = mix32(__ldg(dp.seed) + dp.salt);
    dp.seed = nullptr;
  }
  return dp;
}

// drop_key(seed, site) of common.py: the resolved key, or from the seed
__device__ __forceinline__ uint32_t drop_key(const Drop& dp) {
  return dp.seed != nullptr ? mix32(__ldg(dp.seed) + dp.salt) : dp.key;
}

__device__ __forceinline__ bool drop_keep(const Drop& dp, unsigned long long idx) {
  const uint32_t h = mix32((uint32_t)idx ^ mix32((uint32_t)(idx >> 32) ^ drop_key(dp)));
  return (h & 255u) >= (uint32_t)dp.t;
}

// v with the site's mask applied at element idx of its view (identity when off)
__device__ __forceinline__ float drop_apply(const Drop& dp, unsigned long long idx,
                                            float v) {
  if (dp.t <= 0) return v;
  return drop_keep(dp, idx) ? v * dp.scale : 0.0f;
}

// drop_keep on a view of fewer than 2^32 elements: the counter's high word
// is 0 there, so drop_keep's inner mix32(0 ^ key) is one value for the whole
// launch. A kernel computes it once a thread with drop_hi, and drop_apply_lo
// hashes the low word alone: one mix32 an element, drop_apply's bits.
__device__ __forceinline__ uint32_t drop_hi(const Drop& dp) {
  return dp.t > 0 ? mix32(0u ^ drop_key(dp)) : 0u;
}

__device__ __forceinline__ float drop_apply_lo(const Drop& dp, uint32_t hi,
                                               uint32_t idx, float v) {
  if (dp.t <= 0) return v;
  return (mix32(idx ^ hi) & 255u) >= (uint32_t)dp.t ? v * dp.scale : 0.0f;
}

// drop_apply at element idx of a kernel's index type: the low-word hash for
// a 32-bit index, drop_apply's full path for a 64-bit one.
__device__ __forceinline__ float drop_at(const Drop& dp, uint32_t hi,
                                         uint32_t idx, float v) {
  return drop_apply_lo(dp, hi, idx, v);
}
__device__ __forceinline__ float drop_at(const Drop& dp, uint32_t,
                                         unsigned long long idx, float v) {
  return drop_apply(dp, idx, v);
}

// Views of fewer elements than this take 32-bit indices and the low-word
// hash (no index of theirs, four past a vector's start included, can wrap).
constexpr long long NARROW_VIEW = 1LL << 31;

// Element k of a float4, or a float itself, with k known at compile time
// (the unrolled loops of the vectorised elementwise kernels).
__device__ __forceinline__ float elem(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ void set_elem(float4& v, int k, float f) {
  if (k == 0) v.x = f;
  else if (k == 1) v.y = f;
  else if (k == 2) v.z = f;
  else v.w = f;
}
__device__ __forceinline__ void set_elem(float& v, int, float f) { v = f; }

// V consecutive floats moved as one load or store: float4 (V = 4) or float.
template <int V>
struct VecOf {
  using type = float4;
};
template <>
struct VecOf<1> {
  using type = float;
};

// whether a pointer allows 16-byte (float4) loads and stores
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// A GEMM's fused epilogue (gemm.cuh, gemm_tc.cuh): pre = acc + bias[n]
// (`pre` optionally stored), v = drop(act(pre)) on the (M, N) view, C = v +
// res[m, n].
struct Epi {
  const float* bias = nullptr;  // (N,)
  const float* res = nullptr;   // (M, N), added last
  float* pre = nullptr;         // (M, N): acc + bias, before the activation
  int act = ACT_IDENTITY;
  Drop drop = {nullptr, 0u, 0, 1.0f, 0u};
};

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Grid-stride launch shape for an elementwise pass over `total` elements.
inline int elementwise_blocks(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

// ---------------------------------------------------------------------------
// Deterministic column sums. The TPU kernels carried weight and norm-vector
// gradients across their sequential grid; Hopper blocks run in any order and
// float atomics would change the summation order from run to run. So a
// column-sum pass runs on blocks of COLS x ROW_WARPS threads, each block owns
// COLS columns of one chunk of CHUNK_ROWS rows, its warps stride the rows in
// order and are summed in warp order into partials part[s][chunk][col]; then
// reduce_partials adds the chunks in order.

constexpr int COLS = 32;
constexpr int ROW_WARPS = 8;
constexpr int CHUNK_ROWS = 256;

inline int row_chunks(long long rows) { return cdiv(rows > 0 ? rows : 1, CHUNK_ROWS); }

// Store the block's NS per-thread sums, each added over the warps in warp
// order: sum s of column c of chunk k goes to part[s * sum_ld + k * ld + c].
template <int NS>
__device__ __forceinline__ void store_col_partials(const float (&acc)[NS],
                                                   float* __restrict__ part, int k,
                                                   int ld, size_t sum_ld, int n,
                                                   int c) {
  __shared__ float red[NS][ROW_WARPS][COLS];
#pragma unroll
  for (int s = 0; s < NS; ++s) red[s][threadIdx.y][threadIdx.x] = acc[s];
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float t = 0.0f;
      for (int w = 0; w < ROW_WARPS; ++w) t += red[s][w][threadIdx.x];
      part[s * sum_ld + (size_t)k * ld + c] = t;
    }
  }
}

// (T, B, W) partials -> (T, W) sums over B, in order.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int T, int B,
                                       long long W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * W) return;
  const long long t = i / W, w = i % W;
  const float* p = part + (size_t)t * B * W + w;
  float s = 0.0f;
  for (int g = 0; g < B; ++g) s += p[(size_t)g * W];
  out[i] = s;
}

inline cudaError_t reduce_partials(const float* part, float* out, int T, int B,
                                   long long W, cudaStream_t st) {
  reduce_partials_kernel<<<cdiv((long long)T * W, 256), 256, 0, st>>>(part, out, T, B, W);
  return cudaGetLastError();
}

// out = drop(in) * act'(aux) (aux optional), with per-chunk column partials
// of out, chunk k's at part + k * ld. out may alias in. The FFN backward
// kernels' dropout and activation gradient with its bias gradient's
// partials.
__global__ void __launch_bounds__(COLS* ROW_WARPS)
drop_grad_kernel(const float* in, const float* __restrict__ aux, float* out,
                 float* __restrict__ part, int ld, int R, int n, int act, Drop drop) {
  drop = resolved(drop);
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[1] = {0.0f};
  if (c < n) {
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * n + c;
      float o = drop_apply(drop, i, in[i]);
      if (aux != nullptr) o *= act_grad(aux[i], act);
      out[i] = o;
      acc[0] += o;
    }
  }
  store_col_partials<1>(acc, part, blockIdx.y, ld, 0, n, c);
}

// Column sums of X (R, n) into part (1, chunks, n).
__global__ void __launch_bounds__(COLS* ROW_WARPS)
colsum_partial_kernel(const float* __restrict__ X, float* __restrict__ part, int R,
                      int n) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[1] = {0.0f};
  if (c < n)
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS)
      acc[0] += X[(size_t)r * n + c];
  store_col_partials<1>(acc, part, blockIdx.y, n, 0, n, c);
}

// out (n,) = sum over the R rows of X (R, n); part holds row_chunks(R) * n.
inline cudaError_t colsum(const float* X, float* out, float* part, int R, int n,
                          cudaStream_t st) {
  const int chunks = row_chunks(R);
  colsum_partial_kernel<<<dim3(cdiv(n, COLS), chunks), dim3(COLS, ROW_WARPS), 0, st>>>(
      X, part, R, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, 1, chunks, n, st);
}

}  // namespace ggps
