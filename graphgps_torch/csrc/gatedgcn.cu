// Standalone GatedGCN layer core, forward and backward: the five projections,
// the sender/receiver gathers, the sigma gate, the masked aggregation, the
// node update, and the masked BatchNorm moment partials of both outputs.
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_gatedgcn.py:279
// fused_gatedgcn (forward pallas_call at :318 over _fwd_kernel :131, backward
// _vjp_bwd :349 with its pallas_call at :357 over _bwd_kernel :172). It is the
// local branch of every GPS layer whose width is no multiple of 128 (the
// merged front of gps_front.cu takes the others). Per call, for B graphs of N
// node slots and E edge slots each, at the true width d (the TPU's zero
// padding to 128 lanes is a layout device of that chip and is not made):
//
//   proj = x @ [A|D|E|B] + bn                          (B*N, 4d)
//   ce   = e @ C + bc                                  (B*E, d)
//   gate = D x_r + E x_s + ce                          -> the edge output
//   xo   = A x + sum_e m*sig(gate)*B x_s / (sum_e m*sig(gate) + 1e-6)
//   px, pg = [sum m(v-c) | sum m(v-c)^2] of xo (shift cx) and gate (cg)
//
// Bound on the H100: at a recipe's width (d = 64..304) the two products are
// 2*B*N*d*4d + 2*B*E*d*d f32 operations against (B*N + B*E)*d*4 bytes in and
// as many out, so the forward is bound by operations from d of about 30 up;
// at ogbg-molhiv's shapes (1,280 x 64 rows) every launch is a fraction of one
// wave of the card and the time is launch latency. Forward, on the caller's
// stream: the two projections through the shared GEMM (gemm.cuh; ce is
// written into the gate output and overwritten in place), ggcn_core_kernel
// (ggcn_core.cuh, row stride 4d), then the per-graph moment partials added
// over the graphs in order (the TPU summed across its sequential grid).
// Backward: the forward's proj is kept (B*N*4d floats: 1.3 MB a layer at
// molhiv's shapes, 50 MB at B=256, d=304; the TPU recomputed it in VMEM,
// here recomputing would repeat the forward's largest product), and so are xo
// and gate. ggcn_core_bwd_kernel folds the px/pg cotangents into the xo/gate
// cotangents and forms dproj (B*N, 4d) and dgate; then dx = dproj Wn^T and
// de = dgate C^T (NT), dWn = x^T dproj and dC = e^T dgate (TN, split over
// rows, partials added in split order), dbn and dbc by fixed-order column
// sums. No float atomics anywhere: two runs give the same bits. cx and cg get
// no gradient (the caller stops it, as in the JAX package).
#include "gemm.cuh"
#include "ggcn_core.cuh"

using namespace ggps;

extern "C" size_t gatedgcn_core_smem(int N) { return ggcn_core_smem(N); }

extern "C" size_t gatedgcn_core_bwd_smem(int N) { return ggcn_core_bwd_smem(N); }

// Outputs: xo (B, N, d), gate (B, E, d), moments (2, 2d) = [px | pg].
// proj (B*N, 4d) is what the backward takes back; part (2, B, 2d) is scratch.
extern "C" int gatedgcn_forward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* wn, const float* bn, const float* wc, const float* bc, float* xo,
    float* gate, float* moments, float* proj, float* part, int B, int N, int E, int d,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  Epi eb;
  eb.bias = bn;
  if ((err = gemm_nn(x, wn, proj, B * N, 4 * d, d, eb, st)) != cudaSuccess) return err;
  eb.bias = bc;
  if ((err = gemm_nn(e, wc, gate, B * E, d, d, eb, st)) != cudaSuccess) return err;

  const size_t smem = ggcn_core_smem(N);
  if ((err = allow_smem(ggcn_core_kernel, smem)) != cudaSuccess) return err;
  ggcn_core_kernel<<<dim3(B, cdiv(d, CORE_COLS)), CORE_COLS, smem, st>>>(
      proj, gate, s_loc, r_loc, emask, nmask, cx, cg, xo, part,
      part + (size_t)B * 2 * d, N, E, d, 4 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, moments, 2, B, 2 * d, st);
}

// floats of scratch gatedgcn_backward needs (reused by its passes in turn)
extern "C" long long gatedgcn_backward_scratch(int B, int N, int E, int d) {
  const long long rn = (long long)B * N, re = (long long)B * E;
  long long s = (long long)row_chunks(rn) * 4 * d;
  const long long c[] = {(long long)row_chunks(re) * d,
                         (long long)tn_scratch(d, 4 * d, (int)rn),
                         (long long)tn_scratch(d, d, (int)re)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: the forward's operands, its kept proj and its outputs xo and gate,
// and the cotangents gx (B, N, d), gg (B, E, d), gpx/gpg (2d,) of the four
// outputs. Outputs: dx (B, N, d), de (B, E, d), dwn (d, 4d), dbn (4d,),
// dwc (d, d), dbc (d,). Work: dproj (B*N, 4d), dgate (B*E, d), scratch.
extern "C" int gatedgcn_backward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* wn, const float* wc, const float* proj, const float* xo,
    const float* gate, const float* gx, const float* gg, const float* gpx,
    const float* gpg, float* dx, float* de, float* dwn, float* dbn, float* dwc,
    float* dbc, float* dproj, float* dgate, float* scratch, int B, int N, int E,
    int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N, RE = B * E;
  const size_t smem = ggcn_core_bwd_smem(N);
  if ((err = allow_smem(ggcn_core_bwd_kernel, smem)) != cudaSuccess) return err;
  ggcn_core_bwd_kernel<<<dim3(B, cdiv(d, CORE_BWD_COLS)), CORE_BWD_COLS, smem, st>>>(
      proj, gate, xo, s_loc, r_loc, emask, nmask, cx, cg, gx, gg, gpx, gpg, dproj,
      dgate, N, E, d, 4 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = gemm_nt(dproj, wn, dx, RN, d, 4 * d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_nt(dgate, wc, de, RE, d, d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_tn(x, dproj, dwn, d, 4 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  if ((err = colsum(dproj, dbn, scratch, RN, 4 * d, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(e, dgate, dwc, d, d, RE, scratch, st)) != cudaSuccess) return err;
  return colsum(dgate, dbc, scratch, RE, d, st);
}
