// The GPS layer's Transformer branch for graphs of at most 128 node slots,
// forward and backward: QKV projection, key-masked multi-head attention with
// dropout on the probabilities, out-projection.
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_gps_attn.py:279
// fused_gps_attention (forward pallas_call at :308 over _fwd_kernel :161,
// backward _vjp_bwd :330 with its pallas_call at :337 over _bwd_kernel :183).
// Per call, for B graphs of N node slots each, H heads of Dh = d / H:
//
//   qkv = x @ Wqkv + bqkv                                  (B*N, 3d)
//   P   = softmax(mask(q k^T * scale))   per (graph, head), scale = 1/sqrt(Dh);
//                                        key m of graph g at -1e30 where
//                                        kmask[g, m] = 0
//   o   = drop0(P) v                     heads merged, (B*N, d)
//   y   = o @ Wo + bo
//
// The attention is the layer front's (mha_core.cuh), at row stride 3d and
// q/k/v offsets 0, d, 2d; so is its dropout, site 0 of the (B*H*N, N) view.
//
// Bound on the H100: f32 operations -- the two projections (8*B*N*d^2) and
// per head q k^T and P v (4*N^2*Dh per graph and head); x and y are 2*B*N*d
// floats. Forward, in launches on the caller's stream: the QKV product
// through the shared GEMM (gemm.cuh) with the bias in its epilogue;
// mha_kernel, one block per (graph, head) with the N x N scores in shared
// memory; the out-projection through the GEMM with bo in its epilogue.
//
// The TPU kernel keeps nothing and recomputes q/k/v and P in its backward.
// Here the forward's qkv (B*N, 3d) and o (B*N, d) are kept: 31.5 + 10.5 MB a
// layer at GPS-deep's 10,240 rows, ~0.67 GB over 16 layers of an 80 GB card,
// against the QKV product (a third of the forward's operations) done again.
// Backward: dbo as a column sum of gy, dWo = o^T gy (TN), dO = gy Wo^T (NT);
// mha_bwd_kernel recomputes P per (graph, head), replays the site-0 mask and
// forms dq, dk, dv; then dx = dqkv Wqkv^T (NT), dWqkv = x^T dqkv (TN, split
// over rows, the partials added in split order) and dbqkv as a fixed-order
// column sum: no float atomics, so two runs give the same bits.
#include "gemm.cuh"
#include "mha_core.cuh"

using namespace ggps;

namespace {

// q, k, v at columns 0, d, 2d of the (B*N, 3d) projection
inline QkvLayout attn_qkv(int d) { return QkvLayout{3 * d, 0, d, 2 * d}; }

}  // namespace

// Inputs x (B, N, d), kmask (B, N) f32 0/1, wqkv (d, 3d), bqkv (3d,),
// wo (d, d), bo (d,). Output y (B, N, d). Kept for the backward:
// qkv (B*N, 3d), o (B*N, d).
extern "C" int gps_attention_forward(
    const float* x, const float* kmask, const float* wqkv, const float* bqkv,
    const float* wo, const float* bo, float* y, float* qkv, float* o, int B, int N,
    int d, int H, float scale, unsigned int seed, int t_attn, float sc_attn,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 0 || d % H) return cudaErrorInvalidValue;
  Epi eb;
  eb.bias = bqkv;
  if ((err = gemm_nn(x, wqkv, qkv, B * N, 3 * d, d, eb, st)) != cudaSuccess) return err;

  const size_t smem = mha_smem(N, d, H);
  if ((err = allow_smem(mha_kernel, smem)) != cudaSuccess) return err;
  mha_kernel<<<dim3(B, H), MHA_THREADS, smem, st>>>(
      qkv, kmask, o, N, d, H, scale, make_drop(seed, 0, t_attn, sc_attn), attn_qkv(d));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  eb.bias = bo;
  return gemm_nn(o, wo, y, B * N, d, d, eb, st);
}

// floats of scratch gps_attention_backward needs (reused by its passes in turn)
extern "C" long long gps_attention_backward_scratch(int B, int N, int d) {
  const long long rn = (long long)B * N;
  long long s = (long long)row_chunks(rn) * 3 * d;
  const long long c[] = {(long long)tn_scratch(d, 3 * d, (int)rn),
                         (long long)tn_scratch(d, d, (int)rn)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: x, kmask, wqkv, wo, the forward's kept qkv and o, and the cotangent
// gy (B, N, d). Outputs dx (B, N, d), dwqkv (d, 3d), dbqkv (3d,), dwo (d, d),
// dbo (d,). Work: dO (B*N, d), dqkv (B*N, 3d), scratch.
extern "C" int gps_attention_backward(
    const float* x, const float* kmask, const float* wqkv, const float* wo,
    const float* qkv, const float* o, const float* gy, float* dx, float* dwqkv,
    float* dbqkv, float* dwo, float* dbo, float* dO, float* dqkv, float* scratch,
    int B, int N, int d, int H, float scale, unsigned int seed, int t_attn,
    float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N;
  if (H <= 0 || d % H) return cudaErrorInvalidValue;
  if ((err = colsum(gy, dbo, scratch, RN, d, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(o, gy, dwo, d, d, RN, scratch, st)) != cudaSuccess) return err;
  if ((err = gemm_nt(gy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  const size_t smem = mha_bwd_smem(N, d, H);
  if ((err = allow_smem(mha_bwd_kernel, smem)) != cudaSuccess) return err;
  mha_bwd_kernel<<<dim3(B, H), MHA_THREADS, smem, st>>>(
      qkv, kmask, dO, dqkv, N, d, H, scale, make_drop(seed, 0, t_attn, sc_attn),
      attn_qkv(d));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = gemm_nt(dqkv, wqkv, dx, RN, d, 3 * d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_tn(x, dqkv, dwqkv, d, 3 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  return colsum(dqkv, dbqkv, scratch, RN, 3 * d, st);
}
