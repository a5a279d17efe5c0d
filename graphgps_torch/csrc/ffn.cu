// The GPS FFN block with its residual, forward and backward:
//
//   out = h + drop2(W2 drop1(act(W1 h + b1)) + b2)      (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:387 fused_ffn
// (forward _ffn_fwd :402 with its pallas_call at :408 over _ffn_fwd_kernel,
// backward _ffn_vjp_bwd :433 with its pallas_call at :441 over
// _ffn_bwd_kernel :343). A GPS layer with no deferred combine takes it in
// training with dropout (the GCN+Transformer recipes). The TPU wrapper
// fused_ffn_padded (:525) pads d = 96 to 128 lanes and dh = 192 to 256; here
// a row is never padded. Dropout sites (common.cuh): 1 the inner (R, dh)
// view, 2 the outer (R, d) view (with drop2), both at one rate.
//
// Bound on the H100: the products (forward 4*R*d*dh f32 operations, backward
// 10*R*d*dh with the recomputed first product), so operations. Design, in
// launches on the caller's stream: the shared FFN block (ffn_core.cuh), two
// GEMMs with bias, activation, dropout and residual in their epilogues. As
// the TPU kernel does, the forward keeps nothing and the backward recomputes
// a1 = h W1 + b1 and z = drop1(act(a1)) with one more GEMM (into work
// buffers), then runs the block's backward: dh = g + da1 W1^T and the weight
// and bias gradients, the column sums in a fixed order, so two runs give the
// same bits.
#include "gemm.cuh"
#include "ffn_core.cuh"

using namespace ggps;

// Work the caller allocates: z (R, dh). With a1 != null the forward also
// stores the pre-activation (R, dh); the training path passes null, and the
// checks of a relu's kinks read it.
extern "C" int ffn_forward(const float* h, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* out, float* z,
                           float* a1, int R, int d, int dh, int act, unsigned int seed,
                           int t1, int t2, float scale, void* stream) {
  return ffn_core_forward<Gemm>(h, w1, b1, w2, b2, out, z, a1, R, d, dh, act,
                                make_drop(seed, 1, t1, scale),
                                make_drop(seed, 2, t2, scale),
                                static_cast<cudaStream_t>(stream));
}

// floats of scratch ffn_backward needs
extern "C" long long ffn_backward_scratch(int R, int d, int dh) {
  return ffn_core_scratch<Gemm>(R, d, dh);
}

// Inputs: h (R, d), W1 (d, dh), b1 (dh,), W2 (dh, d), the cotangent g (R, d).
// Outputs: dh (R, d), dw1 (d, dh), db1 (dh,), dw2 (dh, d), db2 (d,).
// Work: a1, z, da1 (R, dh), da2 (R, d), scratch.
extern "C" int ffn_backward(const float* h, const float* w1, const float* b1,
                            const float* w2, const float* g, float* dh, float* dw1,
                            float* db1, float* dw2, float* db2, float* a1, float* z,
                            float* da1, float* da2, float* scratch, int R, int d,
                            int dhid, int act, unsigned int seed, int t1, int t2,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop1 = make_drop(seed, 1, t1, scale);
  // recompute a1 and z = drop1(act(a1)), as the forward made them
  Epi e1;
  e1.bias = b1;
  e1.pre = a1;
  e1.act = act;
  e1.drop = drop1;
  cudaError_t err = gemm_nn(h, w1, z, R, dhid, d, e1, st);
  if (err != cudaSuccess) return err;
  return ffn_core_backward<Gemm>(h, a1, z, g, w1, w2, dh, dw1, db1, dw2, db2, da2, da1,
                                 scratch, R, d, dhid, act, drop1,
                                 make_drop(seed, 2, t2, scale), st);
}
