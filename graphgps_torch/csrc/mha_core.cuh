// Key-masked multi-head attention over a graph's N <= 128 node slots, its
// N x N scores held whole in shared memory, forward and backward: the MHA
// body shared by the layer front (gps_front.cu) and the standalone GPS
// attention (gps_attention.cu).
//
// The TPU kernels compute it in _attn_fwd_all (graphgps_tpu/ops/pallas/
// fused_gps_attn.py:121, packing all heads into one 128-lane contraction) and
// in their backward bodies. Here one block of MHA_THREADS threads takes one
// (graph, head): q, k and v come from a projection matrix whose row stride and
// q/k/v column offsets the caller gives (QkvLayout: the front's joint
// (B*N, 7d) projection at offsets 4d, 5d, 6d; the attention's (B*N, 3d) one at
// 0, d, 2d), MHA_CHUNK head columns at a time into padded shared rows, so a
// head of any width fits beside the scores (N = 128: 116,224 bytes forward,
// 215,552 backward); a head of one chunk stays resident. A product over the
// head's columns accumulates in column order across the chunks, so the bits
// do not depend on the chunk width.
// Masked keys take -1e30, so a graph with no real node gives finite, uniform
// weights, and the backward passes gradient through every logit, as the TPU
// kernels' hand-written backward does.
//
// Dropout (common.cuh): site 0 of the (B*H*N, N) view of the probabilities,
// row (g*H + h)*N + n, column m; the softmax normaliser sums the probabilities
// before dropout. The backward replays the mask from the seed.
//
// Bound on the H100: per head 4*N*N*Dh f32 operations forward (q k^T, P v) and
// about twice that backward, on shared memory; small beside the projections
// around it at the main shapes.
#pragma once

#include "common.cuh"

namespace ggps {
namespace {

constexpr int MHA_THREADS = 128;
// head columns a block holds in shared memory at a time
constexpr int MHA_CHUNK = 32;

// Where q, k and v of a head sit in a (B*N, ld) projection matrix (and its
// gradient): columns q + h*Dh, k + h*Dh, v + h*Dh of each row.
struct QkvLayout {
  int ld;
  int q, k, v;
};

// row stride of a shared column chunk: padded, conflict-free column reads
__host__ __device__ __forceinline__ int chunk_ld(int Dh) {
  return (Dh < MHA_CHUNK ? Dh : MHA_CHUNK) + 1;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Columns [col, col + cw) of the N rows at base (row stride P: a graph's
// head in the projection or in dO) into a padded shared chunk of row stride
// ldc.
__device__ __forceinline__ void load_chunk(const float* __restrict__ base, size_t P,
                                           int col, float* buf, int N, int cw, int ldc) {
  for (int i = threadIdx.x; i < N * cw; i += blockDim.x) {
    const int n = i / cw, j = i % cw;
    buf[n * ldc + j] = base[(size_t)n * P + col + j];
  }
}

// The masked scores of head h of graph g, q k^T over the head's columns in
// chunks of MHA_CHUNK through the shared buffers qc and kc, and their row
// softmax into S (N x N). A head of one chunk also loads v into vc with q
// and k, and the callers keep all three resident. When dropP is non-null the
// site-0 mask is applied to the probabilities in place. Each score
// accumulates its products in column order across the chunks (kept in S
// between them).
__device__ __forceinline__ void attn_probs(const float* __restrict__ proj,
                                           const float* __restrict__ nmask, float* qc,
                                           float* kc, float* vc, float* S, int g, int h,
                                           int N, int d, int H, float scale,
                                           const Drop* dropP, QkvLayout lay) {
  const int Dh = d / H;
  const int ldc = chunk_ld(Dh);
  const size_t P = lay.ld;
  const float* base = proj + (size_t)g * N * P + h * Dh;
  const float* nm = nmask + (size_t)g * N;
  for (int c0 = 0; c0 < Dh; c0 += MHA_CHUNK) {
    const int cw = min(MHA_CHUNK, Dh - c0);
    const bool last = c0 + cw == Dh;
    for (int i = threadIdx.x; i < N * cw; i += blockDim.x) {
      const int n = i / cw, j = i % cw;
      const float* row = base + (size_t)n * P + c0 + j;
      qc[n * ldc + j] = row[lay.q];
      kc[n * ldc + j] = row[lay.k];
      if (Dh <= MHA_CHUNK) vc[n * ldc + j] = row[lay.v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int n = i / N, m = i % N;
      float acc = c0 ? S[i] : 0.0f;
      for (int j = 0; j < cw; ++j) acc = fmaf(qc[n * ldc + j], kc[m * ldc + j], acc);
      S[i] = !last ? acc : nm[m] > 0.0f ? acc * scale : -1e30f;
    }
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const unsigned long long row0 = ((unsigned long long)g * H + h) * N;
  for (int n = warp; n < N; n += nwarps) {
    float* row = S + n * N;
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) mx = fmaxf(mx, row[m]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int m = lane; m < N; m += 32) {
      const float ex = expf(row[m] - mx);
      row[m] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < N; m += 32) {
      const float p = row[m] / sum;
      row[m] = dropP != nullptr ? drop_apply(*dropP, (row0 + n) * N + m, p) : p;
    }
  }
  __syncthreads();
}

// grid (B, H), MHA_THREADS threads, mha_smem bytes: out (B*N, d), heads merged
__global__ void __launch_bounds__(MHA_THREADS)
mha_kernel(const float* __restrict__ proj, const float* __restrict__ nmask,
           float* __restrict__ out, int N, int d, int H, float scale, Drop drop,
           QkvLayout lay) {
  extern __shared__ float smem[];
  const int Dh = d / H;
  const int ldc = chunk_ld(Dh);
  float* S = smem;                      // [N][N] scores, then probabilities
  float* qc = S + N * N;                // column chunks of q, k, v: N rows
  float* kc = qc + N * ldc;
  float* vc = kc + N * ldc;
  const int g = blockIdx.x, h = blockIdx.y;
  attn_probs(proj, nmask, qc, kc, vc, S, g, h, N, d, H, scale, &drop, lay);

  const size_t P = lay.ld;
  const float* base = proj + (size_t)g * N * P + h * Dh;
  float* o = out + (size_t)g * N * d + h * Dh;
  for (int c0 = 0; c0 < Dh; c0 += MHA_CHUNK) {
    const int cw = min(MHA_CHUNK, Dh - c0);
    if (Dh > MHA_CHUNK) load_chunk(base, P, lay.v + c0, vc, N, cw, ldc);
    __syncthreads();
    for (int i = threadIdx.x; i < N * cw; i += blockDim.x) {
      const int n = i / cw, j = i % cw;
      float acc = 0.0f;
      for (int m = 0; m < N; ++m) acc = fmaf(S[n * N + m], vc[m * ldc + j], acc);
      o[(size_t)n * d + c0 + j] = acc;
    }
    __syncthreads();
  }
}

// grid (B, H), MHA_THREADS threads, mha_bwd_smem bytes: from dO (B*N, d) the
// q, k and v gradients of each head into dproj, laid out as proj
__global__ void __launch_bounds__(MHA_THREADS)
mha_bwd_kernel(const float* __restrict__ proj, const float* __restrict__ nmask,
               const float* __restrict__ dO, float* __restrict__ dproj, int N, int d,
               int H, float scale, Drop drop, QkvLayout lay) {
  extern __shared__ float smem[];
  const int Dh = d / H;
  const int ldc = chunk_ld(Dh);
  float* Pm = smem;                     // [N][N] probabilities before dropout
  float* dP = Pm + N * N;               // [N][N] dP, then dS
  float* rs = dP + N * N;               // [N] row sums of dP * P
  float* qc = rs + N;                   // column chunks of q, k, v, dO: N rows
  float* kc = qc + N * ldc;
  float* vc = kc + N * ldc;
  float* oc = vc + N * ldc;
  unsigned char* kp = reinterpret_cast<unsigned char*>(oc + N * ldc);  // [N][N] keep
  const int g = blockIdx.x, h = blockIdx.y;
  const size_t PL = lay.ld;
  const bool one = Dh <= MHA_CHUNK;     // q, k, v and dO stay resident
  const float* dob = dO + (size_t)g * N * d + h * Dh;
  if (one) load_chunk(dob, d, 0, oc, N, Dh, ldc);
  attn_probs(proj, nmask, qc, kc, vc, Pm, g, h, N, d, H, scale, nullptr, lay);

  const bool dropping = drop.t > 0;
  const unsigned long long row0 = ((unsigned long long)g * H + h) * N;
  if (dropping)
    for (int i = threadIdx.x; i < N * N; i += blockDim.x)
      kp[i] = drop_keep(drop, row0 * N + i) ? 1 : 0;

  const float* base = proj + (size_t)g * N * PL + h * Dh;
  float* dpg = dproj + (size_t)g * N * PL + h * Dh;
  // per chunk of columns of dO and v
  for (int c0 = 0; c0 < Dh; c0 += MHA_CHUNK) {
    const int cw = min(MHA_CHUNK, Dh - c0);
    const bool last = c0 + cw == Dh;
    if (!one) {
      load_chunk(dob, d, c0, oc, N, cw, ldc);
      load_chunk(base, PL, lay.v + c0, vc, N, cw, ldc);
    }
    __syncthreads();
    // dv[m, j] = sum_n drop0(P)[n, m] dO[n, j]
    for (int i = threadIdx.x; i < N * cw; i += blockDim.x) {
      const int m = i / cw, j = i % cw;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n) {
        float p = Pm[n * N + m];
        if (dropping) p = kp[n * N + m] ? p * drop.scale : 0.0f;
        acc = fmaf(p, oc[n * ldc + j], acc);
      }
      dpg[(size_t)m * PL + lay.v + c0 + j] = acc;
    }
    // dP[n, m] = drop0(sum_j dO[n, j] v[m, j])
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int n = i / N, m = i % N;
      float acc = c0 ? dP[i] : 0.0f;
      for (int j = 0; j < cw; ++j) acc = fmaf(oc[n * ldc + j], vc[m * ldc + j], acc);
      if (last && dropping) acc = kp[i] ? acc * drop.scale : 0.0f;
      dP[i] = acc;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n = warp; n < N; n += blockDim.x / 32) {
    float s = 0.0f;
    for (int m = lane; m < N; m += 32) s += dP[n * N + m] * Pm[n * N + m];
    s = warp_sum(s);
    if (lane == 0) rs[n] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * N; i += blockDim.x)
    dP[i] = Pm[i] * (dP[i] - rs[i / N]);   // dS
  __syncthreads();
  // per chunk of columns of q and k
  for (int c0 = 0; c0 < Dh; c0 += MHA_CHUNK) {
    const int cw = min(MHA_CHUNK, Dh - c0);
    if (!one) {
      load_chunk(base, PL, lay.q + c0, qc, N, cw, ldc);
      load_chunk(base, PL, lay.k + c0, kc, N, cw, ldc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N * cw; i += blockDim.x) {
      const int n = i / cw, j = i % cw;
      float aq = 0.0f, ak = 0.0f;
      for (int m = 0; m < N; ++m) {
        aq = fmaf(dP[n * N + m], kc[m * ldc + j], aq);
        ak = fmaf(dP[m * N + n], qc[m * ldc + j], ak);
      }
      dpg[(size_t)n * PL + lay.q + c0 + j] = aq * scale;
      dpg[(size_t)n * PL + lay.k + c0 + j] = ak * scale;
    }
    __syncthreads();
  }
}

// dynamic shared memory of mha_kernel and mha_bwd_kernel
inline size_t mha_smem(int N, int d, int H) {
  return ((size_t)N * N + 3 * (size_t)N * chunk_ld(d / H)) * sizeof(float);
}

inline size_t mha_bwd_smem(int N, int d, int H) {
  return (2 * (size_t)N * N + N + 4 * (size_t)N * chunk_ld(d / H)) * sizeof(float)
         + (size_t)N * N;
}

}  // namespace
}  // namespace ggps
