// Residual add of a dropped branch, forward and backward:
//
//   out = x_in + drop(v)                                (R, d) rows
//   dv  = drop(g)  (the same mask),  dx_in = g
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:270
// fused_drop_add (forward pallas_call at :280 over _da_fwd_kernel :256,
// backward _da_vjp_bwd :298 with its pallas_call at :304 over _da_bwd_kernel
// :263). On the unmerged GPS layer it is the attention branch's
// h_in + drop(attn out-projection), R = B*N. Dropout is site 0 of the (R, d)
// view (common.cuh); the backward replays the forward's mask from the seed,
// so nothing is stored. The rate must be above 0, as on the TPU: callers use
// a plain add at rate 0.
//
// Bound on the H100: bytes (forward two (R, d) reads and one write, backward
// one read and one write) against one hash per element. Design: one
// grid-stride elementwise pass each, neighbouring threads on neighbouring
// addresses. dx_in is the incoming cotangent itself and is not touched here.
#include "common.cuh"

namespace ggps {
namespace {

__global__ void drop_add_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                float* __restrict__ out, long long total, Drop drop) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    out[i] = x[i] + drop_apply(drop, i, v[i]);
}

__global__ void drop_add_bwd_kernel(const float* __restrict__ g, float* __restrict__ dv,
                                    long long total, Drop drop) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    dv[i] = drop_apply(drop, i, g[i]);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int drop_add_forward(const float* x, const float* v, float* out,
                                long long total, unsigned int seed, int t, float scale,
                                void* stream) {
  drop_add_kernel<<<elementwise_blocks(total, 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, v, out, total,
                                                         make_drop(seed, 0, t, scale));
  return cudaGetLastError();
}

extern "C" int drop_add_backward(const float* g, float* dv, long long total,
                                 unsigned int seed, int t, float scale, void* stream) {
  drop_add_bwd_kernel<<<elementwise_blocks(total, 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(g, dv, total,
                                                             make_drop(seed, 0, t, scale));
  return cudaGetLastError();
}
