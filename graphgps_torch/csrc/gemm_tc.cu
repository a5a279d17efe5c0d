// A C entry to the tensor-core GEMM (gemm_tc.cuh) on its own, for its card
// tests (tests/test_torch_gemm_tc.py). It replaces no TPU kernel and no
// model path calls it: gps_front.cu and gps_attention.cu include the header.
#include "gemm_tc.cuh"

using namespace ggps;

// floats of scratch a TN product of these shapes needs
extern "C" long long gemm_tc_scratch(int M, int N, int K) {
  return (long long)tc::tn_scratch(M, N, K);
}

// layout 0: C = epi(A @ B), A (M, K), B (K, N); 1: C = epi(A @ B^T),
// B (N, K); 2: C = A^T @ B, A (K, M), B (K, N), no epilogue. The epilogue's
// pointers may be null; dropout is site `site` of the (M, N) view.
extern "C" int gemm_tc(int layout, const float* A, const float* B, float* C, int M, int N,
                       int K, const float* bias, const float* res, float* pre, int act,
                       const unsigned int* seed, int site, int t, float sc, float* scratch,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Epi epi;
  epi.bias = bias;
  epi.res = res;
  epi.pre = pre;
  epi.act = act;
  epi.drop = make_drop(seed, site, t, sc);
  if (layout == 0) return tc::gemm_nn(A, B, C, M, N, K, epi, st);
  if (layout == 1) return tc::gemm_nt(A, B, C, M, N, K, epi, st);
  if (layout == 2) return tc::gemm_tn(A, B, C, M, N, K, scratch, st);
  return cudaErrorInvalidValue;
}
