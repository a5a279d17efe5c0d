// The GPS layer's Transformer branch for WIDE graphs, forward and backward:
// QKV projection, masked multi-head attention with dropout on the
// probabilities, out-projection.
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_attn_wide.py:244
// fused_wide_attention (forward pallas_call at :272 over _fwd_kernel :93,
// backward _vjp_bwd :297 with its pallas_call at :303 over _bwd_kernel :137).
// Per call, for B graphs of N node slots each, H heads of Dh = d / H:
//
//   qkv = x @ Wqkv + bqkv                                  (B*N, 3d)
//   P   = softmax(mask(q k^T * scale))   per (graph, head); key j of graph b
//                                        is masked to -1e30 when j >= counts[b]
//   o   = drop(P) v                      heads merged, (B*N, d)
//   y   = o @ Wo + bo
//
// counts are the real-node counts (the loaders' masks are prefixes). A graph
// with counts 0 has every logit at -1e30: its weights are uniform over all N
// slots and the backward passes gradient through them, as the TPU kernel's
// does. Dropout (common.cuh) is site 0 of the (B*H*N, N) view, row
// (b*H + h)*N + i, column j, with no tile in the counter, so tile sizes can
// change without changing the bits; the softmax normaliser sums the
// probabilities before dropout. The kernels run at the true head width: the
// TPU's per-head padding (pad_heads) and its packing of all heads into one
// 128-lane contraction are layout devices of that chip and are not made.
//
// Bound on the H100: f32 operations (the two projections and, per head,
// q k^T and P v over N x N pairs; x and y are 2*B*N*d floats).
//
// Forward, in launches on the caller's stream: the QKV product through the
// shared GEMM (gemm.cuh); wide_fwd_kernel; the out-projection through the
// GEMM. wide_fwd_kernel: one block per (graph, head, 32 query rows), 8 warps of
// 4 query rows each. Keys and values come through shared memory in tiles of 64;
// per 32 keys a lane holds one key: it forms the 4 rows' logits against q rows
// in shared memory, the warp takes the online-softmax step (running max m and
// sum l per row), and then a lane holds one column of the head and adds
// p_j * v_j with p_j handed round by shuffle. The N x N scores exist only in
// registers. Key tiles wholly beyond counts[b] are skipped (their
// probabilities are exactly 0) unless counts[b] is 0. The row maxima and sums
// are written out (B*H*N floats each), and qkv and o are kept, for the
// backward: the TPU recomputed them in a first pass over VMEM.
// Backward: dbo, dWo = o^T gy, dO = gy Wo^T; wide_dq_kernel, the forward's
// mirror: per query tile over key tiles it forms P from the kept m and l,
// D = dO . o per row (= sum_j dPd * Pd), dS = P * (drop(dP) - D), and dq;
// wide_dkv_kernel: per tile of 32 keys over query tiles, a lane holds one
// query for the logits and one column for dk = dS^T q and dv = drop(P)^T dO.
// Each output row is owned by one warp, so nothing is added atomically; then
// dx = dqkv Wqkv^T (NT), dWqkv = x^T dqkv (TN, split over rows, partials added
// in split order) and the bias gradients as fixed-order column sums: two runs
// give the same bits.
#include "gemm.cuh"

namespace ggps {
namespace {

constexpr int WA_WARPS = 8;
constexpr int WA_ROWS = 4;                    // rows a warp carries at once
constexpr int WA_BLOCK = WA_WARPS * WA_ROWS;  // rows per block (queries, or keys in dkv)
constexpr int WA_TILE = 64;                   // rows of the other side per shared tile
// two column registers per lane (ops/kernels/wide_attention.py MAX_HEAD_DIM)
constexpr int WA_MAX_DH = 64;
constexpr float WA_NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float wmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float wsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// rows row0 .. row0 + rows of one head's section (column offset col0 of a
// matrix with row stride ld_src) into shared rows of stride ld, times `mul`;
// rows from N on are zero
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int rows, int N, int Dh, int ld,
                                          size_t ld_src, float mul) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int i = tid; i < rows * Dh; i += 32 * WA_WARPS) {
    const int r = i / Dh, t = i % Dh;
    dst[r * ld + t] = row0 + r < N ? src[(size_t)(row0 + r) * ld_src + t] * mul : 0.0f;
  }
}

// keys a (graph, head) attends to: its real nodes, or all N slots when it has
// none (uniform weights)
__device__ __forceinline__ int key_end(int cnt, int N) { return cnt > 0 ? cnt : N; }

template <int ACC>
__global__ void __launch_bounds__(32 * WA_WARPS)
wide_fwd_kernel(const float* __restrict__ qkv, const int* __restrict__ counts,
                float* __restrict__ o, float* __restrict__ Mrow,
                float* __restrict__ Lrow, int N, int d, int H, float scale, Drop drop) {
  extern __shared__ float smem[];
  const int Dh = d / H, ld = Dh + 1;
  float* Qs = smem;                    // [WA_BLOCK][ld], times scale
  float* Ks = Qs + WA_BLOCK * ld;      // [WA_TILE][ld]
  float* Vs = Ks + WA_TILE * ld;       // [WA_TILE][ld]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WA_BLOCK;
  const int cnt = min(max(counts[b], 0), N);
  const int kend = key_end(cnt, N);
  const size_t P = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * N * P + h * Dh;
  load_rows(Qs, base, q0, WA_BLOCK, N, Dh, ld, P, scale);

  float m[WA_ROWS], l[WA_ROWS], acc[WA_ROWS][ACC];
#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r) {
    m[r] = WA_NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int a = 0; a < ACC; ++a) acc[r][a] = 0.0f;
  }
  const float* qw = Qs + warp * WA_ROWS * ld;
  const unsigned long long row0 = ((unsigned long long)b * H + h) * N + q0 + warp * WA_ROWS;

  for (int k0 = 0; k0 < kend; k0 += WA_TILE) {
    __syncthreads();
    load_rows(Ks, base + d, k0, WA_TILE, N, Dh, ld, P, 1.0f);
    load_rows(Vs, base + 2 * d, k0, WA_TILE, N, Dh, ld, P, 1.0f);
    __syncthreads();
    for (int kc = 0; kc < WA_TILE && k0 + kc < kend; kc += 32) {
      const int j = k0 + kc + lane;
      const float* kr = Ks + (kc + lane) * ld;
      float s[WA_ROWS];
#pragma unroll
      for (int r = 0; r < WA_ROWS; ++r) s[r] = 0.0f;
      for (int t = 0; t < Dh; ++t) {
        const float kv = kr[t];
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) s[r] = fmaf(qw[r * ld + t], kv, s[r]);
      }
      float p[WA_ROWS];
#pragma unroll
      for (int r = 0; r < WA_ROWS; ++r) {
        const float sv = j < cnt ? s[r] : WA_NEG;
        const float m_new = fmaxf(m[r], wmax(sv));
        float pv = j < N ? expf(sv - m_new) : 0.0f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + wsum(pv);
        m[r] = m_new;
        p[r] = drop_apply(drop, (row0 + r) * N + j, pv);
#pragma unroll
        for (int a = 0; a < ACC; ++a) acc[r][a] *= corr;
      }
      for (int jj = 0; jj < 32; ++jj) {
        float vv[ACC];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          vv[a] = c < Dh ? Vs[(kc + jj) * ld + c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) {
          const float pj = __shfl_sync(FULL, p[r], jj);
#pragma unroll
          for (int a = 0; a < ACC; ++a) acc[r][a] = fmaf(pj, vv[a], acc[r][a]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r) {
    const int row = q0 + warp * WA_ROWS + r;
    if (row >= N) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int c = lane + 32 * a;
      if (c < Dh) o[((size_t)b * N + row) * d + h * Dh + c] = acc[r][a] * inv;
    }
    if (lane == 0) {
      Mrow[((size_t)b * H + h) * N + row] = m[r];
      Lrow[((size_t)b * H + h) * N + row] = l[r];
    }
  }
}

// dq of one (graph, head, 32 query rows) over the key tiles, and the rows'
// D = dO . o written out for wide_dkv_kernel.
template <int ACC>
__global__ void __launch_bounds__(32 * WA_WARPS)
wide_dq_kernel(const float* __restrict__ qkv, const int* __restrict__ counts,
               const float* __restrict__ o, const float* __restrict__ dO,
               const float* __restrict__ Mrow, const float* __restrict__ Lrow,
               float* __restrict__ Drow, float* __restrict__ dqkv, int N, int d, int H,
               float scale, Drop drop) {
  extern __shared__ float smem[];
  const int Dh = d / H, ld = Dh + 1;
  float* Qs = smem;                    // [WA_BLOCK][ld], times scale
  float* Gs = Qs + WA_BLOCK * ld;      // [WA_BLOCK][ld] dO rows
  float* Ks = Gs + WA_BLOCK * ld;      // [WA_TILE][ld]
  float* Vs = Ks + WA_TILE * ld;       // [WA_TILE][ld]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WA_BLOCK;
  const int cnt = min(max(counts[b], 0), N);
  const int kend = key_end(cnt, N);
  const size_t P = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * N * P + h * Dh;
  load_rows(Qs, base, q0, WA_BLOCK, N, Dh, ld, P, scale);
  load_rows(Gs, dO + (size_t)b * N * d + h * Dh, q0, WA_BLOCK, N, Dh, ld, d, 1.0f);
  __syncthreads();

  const float* qw = Qs + warp * WA_ROWS * ld;
  const float* gw = Gs + warp * WA_ROWS * ld;
  const size_t stat0 = ((size_t)b * H + h) * N;
  float m[WA_ROWS], linv[WA_ROWS], D[WA_ROWS], acc[WA_ROWS][ACC];
#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r) {
    const int row = q0 + warp * WA_ROWS + r;
    const bool row_ok = row < N;
    m[r] = row_ok ? Mrow[stat0 + row] : 0.0f;
    linv[r] = row_ok ? 1.0f / fmaxf(Lrow[stat0 + row], 1e-30f) : 0.0f;
    float part = 0.0f;
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int c = lane + 32 * a;
      if (row_ok && c < Dh)
        part = fmaf(gw[r * ld + c], o[((size_t)b * N + row) * d + h * Dh + c], part);
      acc[r][a] = 0.0f;
    }
    D[r] = wsum(part);
    if (row_ok && lane == 0) Drow[stat0 + row] = D[r];
  }
  const unsigned long long row0 = (unsigned long long)stat0 + q0 + warp * WA_ROWS;

  for (int k0 = 0; k0 < kend; k0 += WA_TILE) {
    __syncthreads();
    load_rows(Ks, base + d, k0, WA_TILE, N, Dh, ld, P, 1.0f);
    load_rows(Vs, base + 2 * d, k0, WA_TILE, N, Dh, ld, P, 1.0f);
    __syncthreads();
    for (int kc = 0; kc < WA_TILE && k0 + kc < kend; kc += 32) {
      const int j = k0 + kc + lane;
      const float* kr = Ks + (kc + lane) * ld;
      const float* vr = Vs + (kc + lane) * ld;
      float s[WA_ROWS], dp[WA_ROWS];
#pragma unroll
      for (int r = 0; r < WA_ROWS; ++r) s[r] = dp[r] = 0.0f;
      for (int t = 0; t < Dh; ++t) {
        const float kv = kr[t], vv = vr[t];
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) {
          s[r] = fmaf(qw[r * ld + t], kv, s[r]);
          dp[r] = fmaf(gw[r * ld + t], vv, dp[r]);
        }
      }
      float dS[WA_ROWS];
#pragma unroll
      for (int r = 0; r < WA_ROWS; ++r) {
        const float sv = j < cnt ? s[r] : WA_NEG;
        const float pv = j < N ? expf(sv - m[r]) * linv[r] : 0.0f;
        dS[r] = pv * (drop_apply(drop, (row0 + r) * N + j, dp[r]) - D[r]);
      }
      for (int jj = 0; jj < 32; ++jj) {
        float kk[ACC];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          kk[a] = c < Dh ? Ks[(kc + jj) * ld + c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) {
          const float ds = __shfl_sync(FULL, dS[r], jj);
#pragma unroll
          for (int a = 0; a < ACC; ++a) acc[r][a] = fmaf(ds, kk[a], acc[r][a]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r) {
    const int row = q0 + warp * WA_ROWS + r;
    if (row >= N) continue;
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int c = lane + 32 * a;
      if (c < Dh) dqkv[((size_t)b * N + row) * P + h * Dh + c] = acc[r][a] * scale;
    }
  }
}

// dk and dv of one (graph, head, 32 keys) over the query tiles.
template <int ACC>
__global__ void __launch_bounds__(32 * WA_WARPS)
wide_dkv_kernel(const float* __restrict__ qkv, const int* __restrict__ counts,
                const float* __restrict__ dO, const float* __restrict__ Mrow,
                const float* __restrict__ Lrow, const float* __restrict__ Drow,
                float* __restrict__ dqkv, int N, int d, int H, float scale, Drop drop) {
  extern __shared__ float smem[];
  const int Dh = d / H, ld = Dh + 1;
  float* Ks = smem;                    // [WA_BLOCK][ld]
  float* Vs = Ks + WA_BLOCK * ld;      // [WA_BLOCK][ld]
  float* Qs = Vs + WA_BLOCK * ld;      // [WA_TILE][ld], times scale
  float* Gs = Qs + WA_TILE * ld;       // [WA_TILE][ld] dO rows
  float* Ms = Gs + WA_TILE * ld;       // [WA_TILE] row maxima
  float* Ls = Ms + WA_TILE;            // [WA_TILE] 1 / row sums
  float* Ds = Ls + WA_TILE;            // [WA_TILE]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * WA_BLOCK;
  const int cnt = min(max(counts[b], 0), N);
  const size_t P = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * N * P + h * Dh;
  const size_t stat0 = ((size_t)b * H + h) * N;
  float dk[WA_ROWS][ACC], dv[WA_ROWS][ACC];
#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r)
#pragma unroll
    for (int a = 0; a < ACC; ++a) dk[r][a] = dv[r][a] = 0.0f;

  // keys beyond the real ones get no weight, so no gradient: zeros
  if (k0 < key_end(cnt, N)) {
    load_rows(Ks, base + d, k0, WA_BLOCK, N, Dh, ld, P, 1.0f);
    load_rows(Vs, base + 2 * d, k0, WA_BLOCK, N, Dh, ld, P, 1.0f);
    const float* kw = Ks + warp * WA_ROWS * ld;
    const float* vw = Vs + warp * WA_ROWS * ld;
    for (int q0 = 0; q0 < N; q0 += WA_TILE) {
      __syncthreads();
      load_rows(Qs, base, q0, WA_TILE, N, Dh, ld, P, scale);
      load_rows(Gs, dO + (size_t)b * N * d + h * Dh, q0, WA_TILE, N, Dh, ld, d, 1.0f);
      if (tid < WA_TILE) {
        const int row = q0 + tid;
        Ms[tid] = row < N ? Mrow[stat0 + row] : 0.0f;
        Ls[tid] = row < N ? 1.0f / fmaxf(Lrow[stat0 + row], 1e-30f) : 0.0f;
        Ds[tid] = row < N ? Drow[stat0 + row] : 0.0f;
      }
      __syncthreads();
      for (int qc = 0; qc < WA_TILE && q0 + qc < N; qc += 32) {
        const int i = q0 + qc + lane;         // this lane's query
        const float* qr = Qs + (qc + lane) * ld;
        const float* gr = Gs + (qc + lane) * ld;
        float s[WA_ROWS], dp[WA_ROWS];
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) s[r] = dp[r] = 0.0f;
        for (int t = 0; t < Dh; ++t) {
          const float qv = qr[t], gv = gr[t];
#pragma unroll
          for (int r = 0; r < WA_ROWS; ++r) {
            s[r] = fmaf(qv, kw[r * ld + t], s[r]);
            dp[r] = fmaf(gv, vw[r * ld + t], dp[r]);
          }
        }
        const float mi = Ms[qc + lane], li = Ls[qc + lane], Di = Ds[qc + lane];
        float dS[WA_ROWS], pd[WA_ROWS];
#pragma unroll
        for (int r = 0; r < WA_ROWS; ++r) {
          const int j = k0 + warp * WA_ROWS + r;
          const float sv = j < cnt ? s[r] : WA_NEG;
          const float pv = (i < N && j < N) ? expf(sv - mi) * li : 0.0f;
          const unsigned long long idx = ((unsigned long long)stat0 + i) * N + j;
          pd[r] = drop_apply(drop, idx, pv);
          dS[r] = pv * (drop_apply(drop, idx, dp[r]) - Di);
        }
        for (int ii = 0; ii < 32; ++ii) {
          float qq[ACC], go[ACC];
#pragma unroll
          for (int a = 0; a < ACC; ++a) {
            const int c = lane + 32 * a;
            qq[a] = c < Dh ? Qs[(qc + ii) * ld + c] : 0.0f;
            go[a] = c < Dh ? Gs[(qc + ii) * ld + c] : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < WA_ROWS; ++r) {
            const float ds = __shfl_sync(FULL, dS[r], ii);
            const float pp = __shfl_sync(FULL, pd[r], ii);
#pragma unroll
            for (int a = 0; a < ACC; ++a) {
              dk[r][a] = fmaf(ds, qq[a], dk[r][a]);
              dv[r][a] = fmaf(pp, go[a], dv[r][a]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < WA_ROWS; ++r) {
    const int j = k0 + warp * WA_ROWS + r;
    if (j >= N) continue;
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int c = lane + 32 * a;
      if (c >= Dh) continue;
      float* row = dqkv + ((size_t)b * N + j) * P + h * Dh + c;
      row[d] = dk[r][a];          // Qs carries the scale already
      row[2 * d] = dv[r][a];
    }
  }
}

inline size_t wide_fwd_smem(int Dh) {
  return (size_t)(WA_BLOCK + 2 * WA_TILE) * (Dh + 1) * sizeof(float);
}

inline size_t wide_dq_smem(int Dh) {
  return (size_t)(2 * WA_BLOCK + 2 * WA_TILE) * (Dh + 1) * sizeof(float);
}

inline size_t wide_dkv_smem(int Dh) {
  return ((size_t)(2 * WA_BLOCK + 2 * WA_TILE) * (Dh + 1) + 3 * WA_TILE) * sizeof(float);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Inputs x (B, N, d), counts (B,) int32, wqkv (d, 3d), bqkv (3d,), wo (d, d),
// bo (d,). Output y (B, N, d). Kept for the backward: qkv (B*N, 3d),
// o (B*N, d), Mrow and Lrow (B*H*N).
extern "C" int wide_attention_forward(
    const float* x, const int* counts, const float* wqkv, const float* bqkv,
    const float* wo, const float* bo, float* y, float* qkv, float* o, float* Mrow,
    float* Lrow, int B, int N, int d, int H, float scale, unsigned int seed, int t_attn,
    float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int Dh = d / H;
  if (H <= 0 || d % H || Dh > WA_MAX_DH) return cudaErrorInvalidValue;
  Epi eb;
  eb.bias = bqkv;
  if ((err = gemm_nn(x, wqkv, qkv, B * N, 3 * d, d, eb, st)) != cudaSuccess) return err;

  const dim3 grid(cdiv(N, WA_BLOCK), H, B), block(32, WA_WARPS);
  const size_t smem = wide_fwd_smem(Dh);
  const Drop drop = make_drop(seed, 0, t_attn, sc_attn);
  if (Dh <= 32) {
    if ((err = allow_smem(wide_fwd_kernel<1>, smem)) != cudaSuccess) return err;
    wide_fwd_kernel<1><<<grid, block, smem, st>>>(qkv, counts, o, Mrow, Lrow, N, d, H,
                                                  scale, drop);
  } else {
    if ((err = allow_smem(wide_fwd_kernel<2>, smem)) != cudaSuccess) return err;
    wide_fwd_kernel<2><<<grid, block, smem, st>>>(qkv, counts, o, Mrow, Lrow, N, d, H,
                                                  scale, drop);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  eb.bias = bo;
  return gemm_nn(o, wo, y, B * N, d, d, eb, st);
}

// floats of scratch wide_attention_backward needs (reused by its passes in turn)
extern "C" long long wide_attention_backward_scratch(int B, int N, int d) {
  const long long rn = (long long)B * N;
  long long s = (long long)row_chunks(rn) * 3 * d;
  const long long c[] = {(long long)tn_scratch(d, 3 * d, (int)rn),
                         (long long)tn_scratch(d, d, (int)rn)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: x, counts, wqkv, wo, the forward's kept qkv, o, Mrow, Lrow, and the
// cotangent gy (B, N, d). Outputs dx (B, N, d), dwqkv (d, 3d), dbqkv (3d,),
// dwo (d, d), dbo (d,). Work: dO (B*N, d), dqkv (B*N, 3d), Drow (B*H*N),
// scratch.
extern "C" int wide_attention_backward(
    const float* x, const int* counts, const float* wqkv, const float* wo,
    const float* qkv, const float* o, const float* Mrow, const float* Lrow,
    const float* gy, float* dx, float* dwqkv, float* dbqkv, float* dwo, float* dbo,
    float* dO, float* dqkv, float* Drow, float* scratch, int B, int N, int d, int H,
    float scale, unsigned int seed, int t_attn, float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int Dh = d / H, RN = B * N;
  if (H <= 0 || d % H || Dh > WA_MAX_DH) return cudaErrorInvalidValue;
  if ((err = colsum(gy, dbo, scratch, RN, d, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(o, gy, dwo, d, d, RN, scratch, st)) != cudaSuccess) return err;
  if ((err = gemm_nt(gy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  const dim3 grid(cdiv(N, WA_BLOCK), H, B), block(32, WA_WARPS);
  const Drop drop = make_drop(seed, 0, t_attn, sc_attn);
  const size_t smem_q = wide_dq_smem(Dh), smem_kv = wide_dkv_smem(Dh);
  if (Dh <= 32) {
    if ((err = allow_smem(wide_dq_kernel<1>, smem_q)) != cudaSuccess) return err;
    wide_dq_kernel<1><<<grid, block, smem_q, st>>>(qkv, counts, o, dO, Mrow, Lrow, Drow,
                                                   dqkv, N, d, H, scale, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(wide_dkv_kernel<1>, smem_kv)) != cudaSuccess) return err;
    wide_dkv_kernel<1><<<grid, block, smem_kv, st>>>(qkv, counts, dO, Mrow, Lrow, Drow,
                                                     dqkv, N, d, H, scale, drop);
  } else {
    if ((err = allow_smem(wide_dq_kernel<2>, smem_q)) != cudaSuccess) return err;
    wide_dq_kernel<2><<<grid, block, smem_q, st>>>(qkv, counts, o, dO, Mrow, Lrow, Drow,
                                                   dqkv, N, d, H, scale, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(wide_dkv_kernel<2>, smem_kv)) != cudaSuccess) return err;
    wide_dkv_kernel<2><<<grid, block, smem_kv, st>>>(qkv, counts, dO, Mrow, Lrow, Drow,
                                                     dqkv, N, d, H, scale, drop);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = gemm_nt(dqkv, wqkv, dx, RN, d, 3 * d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_tn(x, dqkv, dwqkv, d, 3 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  return colsum(dqkv, dbqkv, scratch, RN, 3 * d, st);
}
