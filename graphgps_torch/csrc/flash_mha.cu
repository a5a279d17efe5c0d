// Segment-masked multi-head attention with an optional additive bias, by an
// online softmax over key tiles (flash attention), forward and backward.
//
// Replaces graphgps_tpu/ops/pallas/flash_mha.py:67 flash_mha, which calls the
// TPU flash kernel of jax.experimental.pallas.ops.tpu.flash_attention (its
// forward and backward pallas_calls live in that library). Its semantics are
// copied, not re-invented: for q, k, v (B, H, N, Dh), segment ids
// ids = key_mask (B, N) as int (padded 0, real 1) and bias (B, H, N, N),
//
//   s   = (q k^T + bias) * scale,  scale = 1/sqrt(Dh)   (the scale multiplies
//                                                        the bias too)
//   s  += MASK where ids[query] != ids[key],  MASK = -0.7 * FLT_MAX (added,
//         not assigned: a padded query row attends over the padded keys of
//         its graph; real rows see the real keys only)
//   o   = softmax(s) v
//
// The TPU wrapper pads Dh to 128 lanes (pad_head_dim, flash_mha.py:51); here
// the kernels run at the true head width (24 on VOC superpixels).
//
// Bound on the H100: operations, 4*N^2*Dh per (graph, head) forward and
// about 2.5 times that backward; with a bias the (B, H, N, N) bias read (and
// dbias written) is the larger term in bytes.
//
// Forward (flash_fwd_kernel), f32 on the CUDA cores: one block per (graph,
// head, 32 query rows), 8 warps of 4 query rows. Keys, values and key ids
// come through shared memory in tiles of 64; per 32 keys a lane holds one
// key, forms the 4 rows' logits against the q rows in shared memory (the
// bias read straight from device memory, neighbouring lanes on neighbouring
// keys), the warp takes the online softmax step (running max m and sum l per
// row), and then a lane holds one column of the head and adds p_j * v_j with
// p_j handed round by shuffle. The N x N scores exist only in registers.
// Each row's log-sum-exp m + log(l) is written out for the backward. The
// forward stays on this loop, not on the tensor-core body: on VOC under
// flash the attention output's bits decide which side of a kink some units
// of the ill-conditioned training step fall on, and the body's forward
// (more accurate, other bits) moved one clean weight entry of
// chip_smoke.py's card-vs-CPU step (4c) out of its tolerance (PERF.md).
//
// Backward, the FLASH mode of the tensor-core body attn_tc.cuh (3xTF32
// mma.sync; its notes give the layout), with no float atomics: a dq pass per
// query tile recomputes P = exp(s - lse), forms D = dO . o per row,
// dS = P (dO v^T - D), dq = scale * dS k and, with a bias, dbias = scale * dS
// (each element written by its one owner); then a dk/dv pass per key tile
// forms dk = scale * dS^T q and dv = P^T dO. Every sum runs in a fixed order,
// so two runs give the same bits. Bound at the 3xTF32 rate (165 TFLOP/s).
#include "attn_tc.cuh"

namespace ggps {
namespace {

constexpr int FA_WARPS = 8;
constexpr int FA_ROWS = 4;                    // rows a warp carries at once
constexpr int FA_BLOCK = FA_WARPS * FA_ROWS;  // rows per block (queries, or keys in dkv)
constexpr int FA_TILE = 64;                   // rows of the other side per shared tile
// ops/kernels/flash_mha.py MAX_HEAD_DIM: four column registers per lane in
// the forward, 2 warps and tiles of 32 in the body's backward
constexpr int FA_MAX_DH = 128;
using tc::FA_MASK;
using tc::FULL;

__device__ __forceinline__ float wmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float wsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// rows row0 .. row0 + rows of one head's (N, Dh) matrix into shared rows of
// stride ld; rows from N on are zero
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int rows, int N, int Dh, int ld) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int i = tid; i < rows * Dh; i += 32 * FA_WARPS) {
    const int r = i / Dh, t = i % Dh;
    dst[r * ld + t] = row0 + r < N ? src[(size_t)(row0 + r) * Dh + t] : 0.0f;
  }
}

// ids of rows row0 .. row0 + rows of graph b's (N,) segment ids; 0 from N on
__device__ __forceinline__ void load_ids(int* dst, const int* __restrict__ ids,
                                         int row0, int rows, int N) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (tid < rows) dst[tid] = row0 + tid < N ? ids[row0 + tid] : 0;
}

// the logit of a (query, key) pair from its dot product, as the library forms it
__device__ __forceinline__ float logit(float dot, const float* brow, int j, float scale,
                                       bool same) {
  float s = dot;
  if (brow != nullptr) s += brow[j];
  s *= scale;
  return same ? s : s + FA_MASK;
}

template <int ACC>
__global__ void __launch_bounds__(32 * FA_WARPS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ ids,
                 const float* __restrict__ bias, float* __restrict__ o,
                 float* __restrict__ lse, int N, int H, int Dh, float scale) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* Qs = smem;                    // [FA_BLOCK][ld]
  float* Ks = Qs + FA_BLOCK * ld;      // [FA_TILE][ld]
  float* Vs = Ks + FA_TILE * ld;       // [FA_TILE][ld]
  int* Is = reinterpret_cast<int*>(Vs + FA_TILE * ld);  // [FA_TILE] key ids
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_BLOCK;
  const size_t head = ((size_t)b * H + h) * N;     // this (graph, head)'s first row
  const int* gid = ids + (size_t)b * N;
  load_rows(Qs, q + head * Dh, q0, FA_BLOCK, N, Dh, ld);

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][ACC];
  int qid[FA_ROWS];
  const float* brow[FA_ROWS];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int i = q0 + warp * FA_ROWS + r;
    m[r] = -INFINITY;
    l[r] = 0.0f;
    qid[r] = i < N ? gid[i] : 0;
    brow[r] = bias != nullptr && i < N ? bias + (head + i) * N : nullptr;
#pragma unroll
    for (int a = 0; a < ACC; ++a) acc[r][a] = 0.0f;
  }
  const float* qw = Qs + warp * FA_ROWS * ld;

  for (int k0 = 0; k0 < N; k0 += FA_TILE) {
    __syncthreads();
    load_rows(Ks, k + head * Dh, k0, FA_TILE, N, Dh, ld);
    load_rows(Vs, v + head * Dh, k0, FA_TILE, N, Dh, ld);
    load_ids(Is, gid, k0, FA_TILE, N);
    __syncthreads();
    for (int kc = 0; kc < FA_TILE && k0 + kc < N; kc += 32) {
      const int j = k0 + kc + lane;
      const bool valid = j < N;
      const float* kr = Ks + (kc + lane) * ld;
      float s[FA_ROWS];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) s[r] = 0.0f;
      for (int t = 0; t < Dh; ++t) {
        const float kv = kr[t];
#pragma unroll
        for (int r = 0; r < FA_ROWS; ++r) s[r] = fmaf(qw[r * ld + t], kv, s[r]);
      }
      float p[FA_ROWS];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float sv = valid ? logit(s[r], brow[r], j, scale, Is[kc + lane] == qid[r])
                               : -INFINITY;
        const float m_new = fmaxf(m[r], wmax(sv));
        const float pv = valid ? expf(sv - m_new) : 0.0f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + wsum(pv);
        m[r] = m_new;
        p[r] = pv;
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
        for (int r = 0; r < FA_ROWS; ++r) {
          const float pj = __shfl_sync(FULL, p[r], jj);
#pragma unroll
          for (int a = 0; a < ACC; ++a) acc[r][a] = fmaf(pj, vv[a], acc[r][a]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int i = q0 + warp * FA_ROWS + r;
    if (i >= N) continue;
    const float inv = 1.0f / l[r];
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int c = lane + 32 * a;
      if (c < Dh) o[(head + i) * Dh + c] = acc[r][a] * inv;
    }
    if (lane == 0) lse[head + i] = m[r] + logf(l[r]);
  }
}


inline size_t fwd_smem(int Dh) {
  return (size_t)(FA_BLOCK + 2 * FA_TILE) * (Dh + 1) * sizeof(float) + FA_TILE * sizeof(int);
}


template <int ACC>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const int* ids,
                       const float* bias, float* o, float* lse, int B, int H, int N,
                       int Dh, float scale, cudaStream_t st) {
  const dim3 grid(cdiv(N, FA_BLOCK), H, B), block(32, FA_WARPS);
  const size_t smem = fwd_smem(Dh);
  cudaError_t err = allow_smem(flash_fwd_kernel<ACC>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<ACC><<<grid, block, smem, st>>>(q, k, v, ids, bias, o, lse, N, H, Dh,
                                                   scale);
  return cudaGetLastError();
}


}  // namespace
}  // namespace ggps

using namespace ggps;

// Inputs q, k, v (B, H, N, Dh), ids (B, N) int32 segment ids, bias
// (B, H, N, N) or null. Outputs o (B, H, N, Dh) and lse (B*H*N), the rows'
// log-sum-exps the backward takes back.
extern "C" int flash_mha_forward(const float* q, const float* k, const float* v,
                                 const int* ids, const float* bias, float* o, float* lse,
                                 int B, int H, int N, int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh <= 0 || Dh > FA_MAX_DH) return cudaErrorInvalidValue;
  if (Dh <= 32) return launch_fwd<1>(q, k, v, ids, bias, o, lse, B, H, N, Dh, scale, st);
  if (Dh <= 64) return launch_fwd<2>(q, k, v, ids, bias, o, lse, B, H, N, Dh, scale, st);
  return launch_fwd<4>(q, k, v, ids, bias, o, lse, B, H, N, Dh, scale, st);
}

// Inputs: the forward's q, k, v, ids, bias (or null), o and lse, and the
// cotangent dO (B, H, N, Dh). Outputs dq, dk, dv (B, H, N, Dh) and, with a
// bias, dbias (B, H, N, N). Work: Drow (B*H*N).
extern "C" int flash_mha_backward(const float* q, const float* k, const float* v,
                                  const int* ids, const float* bias, const float* o,
                                  const float* lse, const float* dO, float* dq, float* dk,
                                  float* dv, float* dbias, float* Drow, int B, int H,
                                  int N, int Dh, float scale, void* stream) {
  if (Dh <= 0 || Dh > FA_MAX_DH) return cudaErrorInvalidValue;
  const long long sh = (long long)N * Dh, sb = sh * H;
  tc::Params pr = {};
  pr.q = tc::view(q, sb, sh, Dh);
  pr.k = tc::view(k, sb, sh, Dh);
  pr.v = tc::view(v, sb, sh, Dh);
  pr.o = tc::view(o, sb, sh, Dh);
  pr.dO = tc::view(dO, sb, sh, Dh);
  pr.dq = tc::view(dq, sb, sh, Dh);
  pr.dk = tc::view(dk, sb, sh, Dh);
  pr.dv = tc::view(dv, sb, sh, Dh);
  pr.ids = ids;
  pr.bias = bias;
  pr.dbias = dbias;
  pr.lse = const_cast<float*>(lse);
  pr.drow = Drow;
  pr.N = N;
  pr.H = H;
  pr.Dh = Dh;
  pr.scale = scale;
  pr.vec4 = tc::rows_vec4(pr.q, Dh) && tc::rows_vec4(pr.k, Dh) && tc::rows_vec4(pr.v, Dh) &&
            tc::rows_vec4(pr.dO, Dh);
  return tc::launch<tc::FLASH, true, FA_MAX_DH>(pr, B, static_cast<cudaStream_t>(stream));
}
