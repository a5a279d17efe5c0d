// SAN's attention-norm apply + FFN block, forward and backward:
//
//   h   = (s - mu) * inv * gamma + beta             per column (BatchNorm apply)
//   out = h + drop2(W2 drop1(act(W1 h + b1)) + b2)   (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_combine.py:440
// fused_bn_ffn (forward _bf_fwd :449 with its pallas_call at :455, backward
// _bf_vjp_bwd :483 with its pallas_call at :491, whose body is
// _bf_bwd_kernel :376). The statistics (mu, inv = rsqrt(var + eps)) come from
// the caller's MaskedBatchNorm; the residual rides the normed tensor h. SAN
// applies only the inner dropout (drop2 off); the outer site stays an option
// of the function, as in the JAX package. The TPU kernel pads d = 64 to 128
// lanes; here a row is never padded. Dropout sites (common.cuh): 1 the inner
// (R, dh) view, 2 the outer (R, d) view, both at one rate.
//
// Bound on the H100: the two products (forward 4*R*d*dh f32 operations,
// backward twice that), so operations; at SAN's d = 64 the bytes come close.
// Design, in launches on the caller's stream. Forward: an elementwise pass
// writes h, then the shared FFN block (ffn_core.cuh) computes
// out = h + drop2(W2 drop1(act(W1 h + b1)) + b2). With a backward to follow
// the forward keeps h, z and the pre-activation a1 (recomputing them would
// cost the first product again). Backward: the FFN block's backward gives
// dh, dW1, db1, dW2, db2; then one column pass over dh gives
// ds = dh * inv * gamma and per-chunk partials of the four norm-vector sums
// dmu = -sum ds, dinv = sum dh * gamma * (s - mu), dgamma = sum dh * (s - mu)
// * inv, dbeta = sum dh, added in a fixed order (no float atomics), so two
// runs give the same bits.
#include "gemm.cuh"
#include "ffn_core.cuh"

namespace ggps {
namespace {

__global__ void bn_apply_kernel(const float* __restrict__ s, const float* __restrict__ mu,
                                const float* __restrict__ inv,
                                const float* __restrict__ ga,
                                const float* __restrict__ be, float* __restrict__ h,
                                long long total, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int c = (int)(i % d);
    h[i] = (s[i] - mu[c]) * inv[c] * ga[c] + be[c];
  }
}

// From dh: ds and the four norm-vector sums [dmu, dinv, dgamma, dbeta] as
// per-chunk partials.
__global__ void __launch_bounds__(COLS* ROW_WARPS)
bn_bwd_col_kernel(const float* __restrict__ dh, const float* __restrict__ s,
                  const float* __restrict__ mu, const float* __restrict__ inv,
                  const float* __restrict__ ga, float* __restrict__ ds,
                  float* __restrict__ part, int R, int d) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < d) {
    const float m = mu[c], iv = inv[c], g = ga[c];
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * d + c;
      const float gi = dh[i];
      const float sc = s[i] - m;
      const float dsi = gi * iv * g;
      ds[i] = dsi;
      acc[0] -= dsi;
      acc[1] += gi * g * sc;
      acc[2] += gi * (sc * iv);
      acc[3] += gi;
    }
  }
  store_col_partials<4>(acc, part, blockIdx.y, d, (size_t)gridDim.y * d, d, c);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Work the caller allocates: h (R, d), z (R, dh). With a1 != null the
// forward also stores the pre-activation a1 (R, dh) for the backward.
extern "C" int bn_ffn_forward(const float* s, const float* mu, const float* inv,
                              const float* ga, const float* be, const float* w1,
                              const float* b1, const float* w2, const float* b2,
                              float* out, float* h, float* z, float* a1, int R, int d,
                              int dh, int act, unsigned int seed, int t1, int t2,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)R * d;
  bn_apply_kernel<<<elementwise_blocks(total, 256), 256, 0, st>>>(s, mu, inv, ga, be,
                                                                   h, total, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ffn_core_forward<Gemm>(h, w1, b1, w2, b2, out, z, a1, R, d, dh, act,
                                make_drop(seed, 1, t1, scale),
                                make_drop(seed, 2, t2, scale), st);
}

// floats of scratch bn_ffn_backward needs (reused by its passes in turn)
extern "C" long long bn_ffn_backward_scratch(int R, int d, int dh) {
  const long long part = 4 * (long long)row_chunks(R) * d;
  const long long core = ffn_core_scratch<Gemm>(R, d, dh);
  return part > core ? part : core;
}

// Inputs: s (R, d), mu, inv, gamma (d,), W1 (d, dh), W2 (dh, d), the
// forward's kept h (R, d), a1 (R, dh), z (R, dh), the cotangent g (R, d).
// Outputs: ds (R, d), dvec (4, d) = [dmu, dinv, dgamma, dbeta], dw1 (d, dh),
// db1 (dh,), dw2 (dh, d), db2 (d,). Work: da2 (R, d), da1 (R, dh),
// dhh (R, d), scratch.
extern "C" int bn_ffn_backward(const float* s, const float* mu, const float* inv,
                               const float* ga, const float* w1, const float* w2,
                               const float* h, const float* a1, const float* z,
                               const float* g, float* ds, float* dvec, float* dw1,
                               float* db1, float* dw2, float* db2, float* da2, float* da1,
                               float* dhh, float* scratch, int R, int d, int dh, int act,
                               unsigned int seed, int t1, int t2, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ffn_core_backward<Gemm>(
      h, a1, z, g, w1, w2, dhh, dw1, db1, dw2, db2, da2, da1, scratch, R, d, dh, act,
      make_drop(seed, 1, t1, scale), make_drop(seed, 2, t2, scale), st);
  if (err != cudaSuccess) return err;
  const int chunks = row_chunks(R);
  const dim3 blk(COLS, ROW_WARPS);
  // through the norm's apply: ds per element, the four vector sums per column
  bn_bwd_col_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(dhh, s, mu, inv, ga,
                                                                ds, scratch, R, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, dvec, 4, chunks, d, st);
}
