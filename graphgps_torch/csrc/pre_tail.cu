// Edge tail of the GatedGCN layer, forward and backward:
//
//   out = x_in + drop(act(gamma * (v - mu) * inv + beta))      (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:189
// fused_pre_tail (forward pallas_call at :200, backward _pre_vjp_bwd :220 with
// its pallas_call at :226). On the main path it is the edge tail
// e_in + drop(act(bn(gate))) with R = B*E. Dropout is site 0 of the (R, d)
// view (common.cuh); the backward replays the forward's mask from the seed.
//
// Bound on the H100: bytes (forward: two (R, d) reads and one write; backward:
// two reads and one write) against a handful of operations per element.
// Design: the forward is one grid-stride elementwise pass, neighbouring
// threads on neighbouring addresses; the four (d,) vectors stay in cache. The
// backward is one pass over blocks of 32 columns x 8 row-warps per chunk of
// 256 rows, writing dv and per-chunk partials of the four column sums
// (dmu, dinv, dgamma, dbeta), then a second pass that adds the chunks in order
// -- where the TPU kernel accumulated across its sequential grid. dx_in is the
// incoming cotangent itself and is not touched here.
#include "common.cuh"

namespace ggps {
namespace {

__global__ void pre_tail_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                const float* __restrict__ mu,
                                const float* __restrict__ inv,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float* __restrict__ out,
                                long long total, int d, int act, Drop drop) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int c = (int)(i % d);
    const float z = (v[i] - mu[c]) * inv[c] * gamma[c] + beta[c];
    out[i] = x[i] + drop_apply(drop, i, apply_act(z, act));
  }
}

__global__ void __launch_bounds__(COLS* ROW_WARPS)
pre_tail_bwd_kernel(const float* __restrict__ v, const float* __restrict__ mu,
                    const float* __restrict__ inv, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ g,
                    float* __restrict__ dv, float* __restrict__ part, int R, int d,
                    int act, Drop drop) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dmu, dinv, dgamma, dbeta
  if (c < d) {
    const float m = mu[c], iv = inv[c], ga = gamma[c], be = beta[c];
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * d + c;
      const float vc = v[i] - m;
      const float z = vc * iv * ga + be;
      const float dz = drop_apply(drop, i, g[i]) * act_grad(z, act);
      const float dyhat = dz * ga;
      const float dvi = dyhat * iv;
      dv[i] = dvi;
      acc[0] -= dvi;
      acc[1] += dyhat * vc;
      acc[2] += dz * (vc * iv);
      acc[3] += dz;
    }
  }
  store_col_partials<4>(acc, part, blockIdx.y, d, (size_t)gridDim.y * d, d, c);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int pre_tail_forward(const float* x, const float* v, const float* mu,
                                const float* inv, const float* gamma,
                                const float* beta, float* out, long long rows, int d,
                                int act, unsigned int seed, int t, float scale,
                                void* stream) {
  const long long total = rows * d;
  pre_tail_kernel<<<elementwise_blocks(total, 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, v, mu, inv, gamma, beta, out, total, d, act, make_drop(seed, 0, t, scale));
  return cudaGetLastError();
}

// floats of scratch pre_tail_backward needs
extern "C" long long pre_tail_backward_scratch(int rows, int d) {
  return 4LL * row_chunks(rows) * d;
}

// dvec (4, d) = [dmu | dinv | dgamma | dbeta]
extern "C" int pre_tail_backward(const float* v, const float* mu, const float* inv,
                                 const float* gamma, const float* beta, const float* g,
                                 float* dv, float* dvec, float* scratch, int rows, int d,
                                 int act, unsigned int seed, int t, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = row_chunks(rows);
  pre_tail_bwd_kernel<<<dim3(cdiv(d, COLS), chunks), dim3(COLS, ROW_WARPS), 0, st>>>(
      v, mu, inv, gamma, beta, g, dv, scratch, rows, d, act,
      make_drop(seed, 0, t, scale));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(scratch, dvec, 4, chunks, d, st);
}
