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
// The attention is the KMASK mode of the tensor-core body (attn_tc.cuh), read
// straight out of qkv at row stride 3d and q/k/v offsets 0, d, 2d; its
// dropout is site 0 of the (B*H*N, N) view, as the layer front's.
//
// Bound on the H100: operations -- the two projections (8*B*N*d^2) and per
// head q k^T and P v (4*N^2*Dh per graph and head), all in 3xTF32 on the
// tensor cores (165 TFLOP/s); x and y are 2*B*N*d floats. Forward, in
// launches on the caller's stream: the QKV product on the tensor-core GEMM
// (gemm_tc.cuh) with the bias in its epilogue; the attention forward (one
// block per 64 query rows of a (graph, head) at heads up to 64 columns, 32
// rows wider; it writes the row maxima and sums); the out-projection with bo
// in its epilogue.
//
// The TPU kernel keeps nothing and recomputes q/k/v and P in its backward.
// Here the forward's qkv (B*N, 3d), o (B*N, d) and the softmax's row maxima
// and sums (B*H*N each) are kept: 31.5 + 10.5 MB a layer at GPS-deep's
// 10,240 rows, against the QKV product (a third of the forward's operations)
// done again. Backward: dbo as a column sum of gy, dWo = o^T gy (TN),
// dO = gy Wo^T (NT); the body's dq pass (P from the kept statistics, the
// site-0 mask replayed, D = dO . o per row) and its dk/dv pass write dq, dk,
// dv into dqkv; then dx = dqkv Wqkv^T (NT), dWqkv = x^T dqkv (TN, split over
// rows, the partials added in split order) and dbqkv as a fixed-order column
// sum: no float atomics, so two runs give the same bits.
#include "attn_tc.cuh"
#include "gemm_tc.cuh"

using namespace ggps;

namespace {

// ops/kernels/gps_attention.py MAX_HEAD_DIM: the body's widest padded head
constexpr int GA_MAX_DH = 128;

// The attention's views of qkv (B*N, 3d): q, k, v at columns 0, d, 2d
tc::Params attn_params(const float* qkv, const float* kmask, int B, int N, int d, int H,
                       float scale, const unsigned int* seed, int t_attn, float sc_attn) {
  const int Dh = d / H;
  const long long P3 = 3LL * d;
  tc::Params pr = {};
  pr.q = tc::view(qkv, N * P3, Dh, 3 * d);
  pr.k = tc::view(qkv + d, N * P3, Dh, 3 * d);
  pr.v = tc::view(qkv + 2 * d, N * P3, Dh, 3 * d);
  pr.kmask = kmask;
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

bool in_envelope(int N, int d, int H) {
  return H > 0 && d % H == 0 && d / H <= GA_MAX_DH && N <= 128;
}

}  // namespace

// Inputs x (B, N, d), kmask (B, N) f32 0/1, wqkv (d, 3d), bqkv (3d,),
// wo (d, d), bo (d,). Output y (B, N, d). Kept for the backward:
// qkv (B*N, 3d), o (B*N, d), Mrow and Lrow (B*H*N).
extern "C" int gps_attention_forward(
    const float* x, const float* kmask, const float* wqkv, const float* bqkv,
    const float* wo, const float* bo, float* y, float* qkv, float* o, float* Mrow,
    float* Lrow, int B, int N, int d, int H, float scale, const unsigned int* seed, int t_attn,
    float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_envelope(N, d, H)) return cudaErrorInvalidValue;
  Epi eb;
  eb.bias = bqkv;
  if ((err = tc::gemm_nn(x, wqkv, qkv, B * N, 3 * d, d, eb, st)) != cudaSuccess) return err;

  tc::Params pr = attn_params(qkv, kmask, B, N, d, H, scale, seed, t_attn, sc_attn);
  pr.o = rows_d(o, N, d, pr.Dh);
  pr.mrow = Mrow;
  pr.lrow = Lrow;
  pr.vec4 = tc::rows_vec4(pr.k, pr.Dh) && tc::rows_vec4(pr.v, pr.Dh);
  if ((err = tc::launch<tc::KMASK, false, GA_MAX_DH>(pr, B, st)) != cudaSuccess) return err;

  eb.bias = bo;
  return tc::gemm_nn(o, wo, y, B * N, d, d, eb, st);
}

// floats of scratch gps_attention_backward needs (reused by its passes in turn)
extern "C" long long gps_attention_backward_scratch(int B, int N, int d) {
  const long long rn = (long long)B * N;
  long long s = (long long)row_chunks(rn) * 3 * d;
  const long long c[] = {(long long)tc::tn_scratch(d, 3 * d, (int)rn),
                         (long long)tc::tn_scratch(d, d, (int)rn)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: x, kmask, wqkv, wo, the forward's kept qkv, o, Mrow, Lrow, and the
// cotangent gy (B, N, d). Outputs dx (B, N, d), dwqkv (d, 3d), dbqkv (3d,),
// dwo (d, d), dbo (d,). Work: dO (B*N, d), dqkv (B*N, 3d), Drow (B*H*N),
// scratch.
extern "C" int gps_attention_backward(
    const float* x, const float* kmask, const float* wqkv, const float* wo,
    const float* qkv, const float* o, const float* Mrow, const float* Lrow,
    const float* gy, float* dx, float* dwqkv, float* dbqkv, float* dwo, float* dbo,
    float* dO, float* dqkv, float* Drow, float* scratch, int B, int N, int d, int H,
    float scale, const unsigned int* seed, int t_attn, float sc_attn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N;
  if (!in_envelope(N, d, H)) return cudaErrorInvalidValue;
  if ((err = colsum(gy, dbo, scratch, RN, d, st)) != cudaSuccess) return err;
  if ((err = tc::gemm_tn(o, gy, dwo, d, d, RN, scratch, st)) != cudaSuccess) return err;
  if ((err = tc::gemm_nt(gy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  tc::Params pr = attn_params(qkv, kmask, B, N, d, H, scale, seed, t_attn, sc_attn);
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
  if ((err = tc::launch<tc::KMASK, true, GA_MAX_DH>(pr, B, st)) != cudaSuccess) return err;

  if ((err = tc::gemm_nt(dqkv, wqkv, dx, RN, d, 3 * d, Epi(), st)) != cudaSuccess)
    return err;
  if ((err = tc::gemm_tn(x, dqkv, dwqkv, d, 3 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  return colsum(dqkv, dbqkv, scratch, RN, 3 * d, st);
}
