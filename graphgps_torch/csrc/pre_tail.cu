// Edge tail of the GatedGCN layer, forward:
//
//   out = x_in + act(gamma * (v - mu) * inv + beta)        (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:189
// fused_pre_tail (forward at :200). On the main path it is the edge tail
// e_in + act(bn(gate)) with R = B*E.
//
// Bound on the H100: bytes (two (R, d) reads and one write against a handful
// of operations per element). Design: one grid-stride elementwise pass, each
// thread one element per step so neighbouring threads touch neighbouring
// addresses; the four (d,) vectors stay in cache. Dropout is not here: the
// main path evaluates and the wrapper refuses rates above 0.
#include "common.cuh"

namespace ggps {
namespace {

__global__ void pre_tail_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                const float* __restrict__ mu,
                                const float* __restrict__ inv,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float* __restrict__ out,
                                long long total, int d, int act) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int c = (int)(i % d);
    const float z = (v[i] - mu[c]) * inv[c] * gamma[c] + beta[c];
    out[i] = x[i] + apply_act(z, act);
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int pre_tail_forward(const float* x, const float* v, const float* mu,
                                const float* inv, const float* gamma,
                                const float* beta, float* out, long long rows, int d,
                                int act, void* stream) {
  const long long total = rows * d;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
  pre_tail_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, v, mu, inv, gamma, beta, out, total, d, act);
  return cudaGetLastError();
}
