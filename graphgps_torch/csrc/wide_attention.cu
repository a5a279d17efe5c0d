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
// probabilities before dropout. The kernels run at the true head width
// padded to a multiple of 8 in shared memory only: the TPU's per-head
// padding (pad_heads) and its packing of all heads into one 128-lane
// contraction are layout devices of that chip and are not made.
//
// Forward, in launches on the caller's stream: the QKV product through the
// shared GEMM (gemm.cuh); the attention, the WIDE mode of the tensor-core
// body attn_tc.cuh (3xTF32 mma.sync; its notes give the layout; key tiles
// wholly beyond counts[b] are skipped, their probabilities being exactly 0,
// unless counts[b] is 0); the out-projection through the GEMM. The row
// maxima and sums are written out (B*H*N floats each), and qkv and o are
// kept, for the backward: the TPU recomputed them in a first pass over VMEM.
// Backward: dbo, dWo = o^T gy, dO = gy Wo^T; the body's dq pass (P from the
// kept maxima and sums, D = dO . o per row, dS = P * (drop(dP) - D), dq) and
// its dk/dv pass (dk = dS^T q, dv = drop(P)^T dO), each output row owned by
// one warp, so nothing is added atomically; then dx = dqkv Wqkv^T (NT),
// dWqkv = x^T dqkv (TN, split over rows, partials added in split order) and
// the bias gradients as fixed-order column sums: two runs give the same bits.
//
// Bound on the H100: operations. The two projections are f32 on CUDA cores
// (67 TFLOP/s); the attention's q k^T and P v over N x N pairs per head are
// on the tensor cores at the 3xTF32 rate (165 TFLOP/s); x and y are 2*B*N*d
// floats.
#include "attn_tc.cuh"
#include "gemm.cuh"

using namespace ggps;

namespace {

// ops/kernels/wide_attention.py MAX_HEAD_DIM
constexpr int WA_MAX_DH = 64;

// The attention's views of qkv (B*N, 3d) and of o-shaped (B*N, d) tensors.
tc::Params wide_params(const float* qkv, const int* counts, int B, int N, int d, int H,
                       float scale, const unsigned int* seed, int t_attn, float sc_attn) {
  const int Dh = d / H;
  const long long P3 = 3LL * d;
  tc::Params pr = {};
  pr.q = tc::view(qkv, N * P3, Dh, 3 * d);
  pr.k = tc::view(qkv + d, N * P3, Dh, 3 * d);
  pr.v = tc::view(qkv + 2 * d, N * P3, Dh, 3 * d);
  pr.counts = counts;
  pr.N = N;
  pr.H = H;
  pr.Dh = Dh;
  pr.scale = scale;
  pr.drop = make_drop(seed, 0, t_attn, sc_attn);
  return pr;
}

tc::View rows_d(const float* p, int N, int d, int Dh) {
  return tc::view(p, (long long)N * d, Dh, d);
}

}  // namespace

// Inputs x (B, N, d), counts (B,) int32, wqkv (d, 3d), bqkv (3d,), wo (d, d),
// bo (d,). Output y (B, N, d). Kept for the backward: qkv (B*N, 3d),
// o (B*N, d), Mrow and Lrow (B*H*N).
extern "C" int wide_attention_forward(
    const float* x, const int* counts, const float* wqkv, const float* bqkv,
    const float* wo, const float* bo, float* y, float* qkv, float* o, float* Mrow,
    float* Lrow, int B, int N, int d, int H, float scale, const unsigned int* seed, int t_attn,
    float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 0 || d % H || d / H > WA_MAX_DH) return cudaErrorInvalidValue;
  Epi eb;
  eb.bias = bqkv;
  if ((err = gemm_nn(x, wqkv, qkv, B * N, 3 * d, d, eb, st)) != cudaSuccess) return err;

  tc::Params pr = wide_params(qkv, counts, B, N, d, H, scale, seed, t_attn, sc_attn);
  pr.o = rows_d(o, N, d, pr.Dh);
  pr.mrow = Mrow;
  pr.lrow = Lrow;
  pr.vec4 = tc::rows_vec4(pr.k, pr.Dh) && tc::rows_vec4(pr.v, pr.Dh);
  if ((err = tc::launch<tc::WIDE, false, WA_MAX_DH>(pr, B, st)) != cudaSuccess) return err;
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
    float scale, const unsigned int* seed, int t_attn, float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N;
  if (H <= 0 || d % H || d / H > WA_MAX_DH) return cudaErrorInvalidValue;
  if ((err = colsum(gy, dbo, scratch, RN, d, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(o, gy, dwo, d, d, RN, scratch, st)) != cudaSuccess) return err;
  if ((err = gemm_nt(gy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  tc::Params pr = wide_params(qkv, counts, B, N, d, H, scale, seed, t_attn, sc_attn);
  const int Dh = pr.Dh;
  pr.o = rows_d(o, N, d, Dh);
  pr.dO = rows_d(dO, N, d, Dh);
  pr.mrow = const_cast<float*>(Mrow);
  pr.lrow = const_cast<float*>(Lrow);
  pr.drow = Drow;
  const long long P3 = 3LL * d;
  pr.dq = tc::view(dqkv, N * P3, Dh, 3 * d);
  pr.dk = tc::view(dqkv + d, N * P3, Dh, 3 * d);
  pr.dv = tc::view(dqkv + 2 * d, N * P3, Dh, 3 * d);
  pr.vec4 = tc::rows_vec4(pr.q, Dh) && tc::rows_vec4(pr.k, Dh) && tc::rows_vec4(pr.v, Dh) &&
            tc::rows_vec4(pr.dO, Dh);
  if ((err = tc::launch<tc::WIDE, true, WA_MAX_DH>(pr, B, st)) != cudaSuccess) return err;

  if ((err = gemm_nt(dqkv, wqkv, dx, RN, d, 3 * d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_tn(x, dqkv, dwqkv, d, 3 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  return colsum(dqkv, dbqkv, scratch, RN, 3 * d, st);
}
