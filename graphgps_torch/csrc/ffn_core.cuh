// The GPS FFN block with its residual, forward and backward, shared by
// ffn.cu, combine_ffn.cu and bn_ffn.cu (each puts its own prologue in front
// and its own epilogue behind):
//
//   a1  = h W1 + b1                      (R, dh)
//   z   = drop1(act(a1))                 (R, dh)
//   out = h + drop2(z W2 + b2)           (R, d)
//
// Forward: two GEMMs with bias, activation, dropout and the residual in
// their epilogues; a1 is stored when a backward will need it. The includer
// picks the GEMM as the template argument Products: tc::Gemm (gemm_tc.cuh,
// 3xTF32 on the tensor cores) for combine_ffn.cu and bn_ffn.cu's wide
// shapes, Gemm (gemm.cuh, f32 on the CUDA cores) for ffn.cu; both share
// common.cuh's epilogue.
// Backward, given g = d out and the forward's h, a1 and z: da2 = drop2(g) with
// its column sum (db2); du = da2 W2^T (NT GEMM); da1 = drop1(du) * act'(a1)
// with its column sum (db1); dh = g + da1 W1^T (NT GEMM, residual epilogue);
// dW1 = h^T da1 and dW2 = z^T da2 (TN GEMMs split over rows). Every column sum
// adds per-chunk partials in a fixed order (no float atomics), so two runs
// give the same bits. Dropout: the caller's two sites (common.cuh). The
// (R, dh) intermediates make round trips through device memory; where the
// weights fit in shared memory, ffn_fused.cuh keeps them on chip, as the TPU
// kernels do in VMEM (bn_ffn.cu's narrow widths).
#pragma once

#include "common.cuh"

namespace ggps {
namespace {

// z and out from h; a1 (R, dh) stored when not null.
template <class Products>
inline cudaError_t ffn_core_forward(const float* h, const float* w1, const float* b1,
                                    const float* w2, const float* b2, float* out,
                                    float* z, float* a1, int R, int d, int dh, int act,
                                    Drop drop1, Drop drop2, cudaStream_t st) {
  Epi e1;
  e1.bias = b1;
  e1.pre = a1;
  e1.act = act;
  e1.drop = drop1;
  cudaError_t err = Products::nn(h, w1, z, R, dh, d, e1, st);
  if (err != cudaSuccess) return err;
  Epi e2;
  e2.bias = b2;
  e2.res = h;
  e2.drop = drop2;
  return Products::nn(z, w2, out, R, d, dh, e2, st);
}

// floats of scratch ffn_core_backward needs (its passes reuse it in turn)
template <class Products>
inline long long ffn_core_scratch(int R, int d, int dh) {
  const long long chunks = row_chunks(R);
  long long s = chunks * (d > dh ? d : dh);
  const long long w1 = (long long)Products::scratch(d, dh, R);
  const long long w2 = (long long)Products::scratch(dh, d, R);
  s = s > w1 ? s : w1;
  return s > w2 ? s : w2;
}

// dh = g + da1 W1^T (R, d), dw1 (d, dh), db1 (dh,), dw2 (dh, d), db2 (d,).
// Work: da2 (R, d), da1 (R, dh), scratch (ffn_core_scratch floats).
template <class Products>
inline cudaError_t ffn_core_backward(const float* h, const float* a1, const float* z,
                                     const float* g, const float* w1, const float* w2,
                                     float* dh, float* dw1, float* db1, float* dw2,
                                     float* db2, float* da2, float* da1, float* scratch,
                                     int R, int d, int dhid, int act, Drop drop1,
                                     Drop drop2, cudaStream_t st) {
  cudaError_t err;
  const int chunks = row_chunks(R);
  const dim3 blk(COLS, ROW_WARPS);
  // da2 = drop2(g), db2 = sum da2
  drop_grad_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(g, nullptr, da2, scratch,
                                                                 d, R, d, act, drop2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, db2, 1, chunks, d, st)) != cudaSuccess) return err;
  // du = da2 W2^T, then da1 = drop1(du) * act'(a1) in place, db1 = sum da1
  if ((err = Products::nt(da2, w2, da1, R, dhid, d, Epi(), st)) != cudaSuccess) return err;
  drop_grad_kernel<<<dim3(cdiv(dhid, COLS), chunks), blk, 0, st>>>(da1, a1, da1, scratch,
                                                                    dhid, R, dhid, act, drop1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, db1, 1, chunks, dhid, st)) != cudaSuccess)
    return err;
  // dh = g + da1 W1^T: the residual rides h
  Epi eres;
  eres.res = g;
  if ((err = Products::nt(da1, w1, dh, R, d, dhid, eres, st)) != cudaSuccess) return err;
  // weight gradients over all R rows
  if ((err = Products::tn(h, da1, dw1, d, dhid, R, scratch, st)) != cudaSuccess)
    return err;
  return Products::tn(z, da2, dw2, dhid, d, R, scratch, st);
}

}  // namespace
}  // namespace ggps
