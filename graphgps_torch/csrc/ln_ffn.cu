// Graphormer's pre-LN FFN block, forward and backward:
//
//   y   = LN(h0) = (h0 - mean) * rstd * gamma + beta     per row, over the d columns
//   out = h0 + drop2(W2 drop1(act(W1 y + b1)) + b2)      (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_combine.py:672
// fused_ln_ffn (forward _lf_fwd :682 with its pallas_call at :688, backward
// _lf_vjp_bwd :713 with its pallas_call at :722; LN as its _ln :581: the row
// is centred first, var = mean((h0 - mean)^2), eps 1e-6). The TPU kernel pads
// d = 80 to 128 lanes and divides by the true width; here a row is never
// padded. Dropout sites (common.cuh): 1 the inner (R, dh) view at rate r1, 2
// the outer (R, d) view at rate r2, each with its own keep threshold.
//
// Bound on the H100: the two products (forward 4*R*d*dh f32 operations,
// backward twice that), so operations. Design, in launches on the caller's
// stream. Forward: one warp per row computes the row's mean and centred
// variance with shuffle sums in a fixed order and writes y (and, when a
// backward follows, the row's mean and rstd); the shared GEMM (gemm.cuh)
// computes z = drop1(act(y W1 + b1)) with activation and dropout in its
// epilogue, then out = drop2(z W2 + b2) + h0. With a backward to follow the
// forward keeps y, z and the pre-activation a1 (recomputing them would cost
// the first product again). Backward: da2 = drop2(g) with its column sum
// (db2); du = da2 W2^T (NT GEMM); da1 = drop1(du) * act'(a1) with its column
// sum (db1); dy = da1 W1^T (NT GEMM); dW1 = y^T da1 and dW2 = z^T da2 (TN
// GEMMs split over rows); then a warp per row takes dy back through the
// LayerNorm, dh0 = g + rstd (dy gamma - mean(dy gamma) - xhat mean(dy gamma
// xhat)), and a column pass gives dgamma = sum dy xhat and dbeta = sum dy as
// per-chunk partials. Every column sum adds partials in a fixed order (no
// float atomics), so two runs give the same bits. The (R, dh) intermediates
// make round trips through device memory; keeping them on chip, as the TPU
// kernel does in VMEM, is later work.
#include "gemm.cuh"

namespace ggps {
namespace {

constexpr int LN_WARPS = 8;  // rows per block, one warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(h0) * gamma + beta per row; stats (R, 2) = [mean, rstd] if given.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ ga,
              const float* __restrict__ be, float* __restrict__ y,
              float* __restrict__ stats, int R, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (r >= R) return;
  const float* x = h0 + (size_t)r * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += x[c];
  const float mean = warp_sum(s) / (float)d;
  float v = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float t = x[c] - mean;
    v += t * t;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / (float)d + eps);
  float* yr = y + (size_t)r * d;
  for (int c = lane; c < d; c += 32) yr[c] = (x[c] - mean) * rstd * ga[c] + be[c];
  if (stats != nullptr && lane == 0) {
    stats[2 * (size_t)r] = mean;
    stats[2 * (size_t)r + 1] = rstd;
  }
}

// dh0 = g + rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)), dyh = dy * gamma,
// one warp per row.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_row_kernel(const float* __restrict__ h0, const float* __restrict__ ga,
                  const float* __restrict__ stats, const float* __restrict__ dy,
                  const float* __restrict__ g, float* __restrict__ dh0, int R, int d) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (r >= R) return;
  const size_t base = (size_t)r * d;
  const float mean = stats[2 * (size_t)r], rstd = stats[2 * (size_t)r + 1];
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float dyh = dy[base + c] * ga[c];
    s1 += dyh;
    s2 += dyh * ((h0[base + c] - mean) * rstd);
  }
  const float m1 = warp_sum(s1) / (float)d;
  const float m2 = warp_sum(s2) / (float)d;
  for (int c = lane; c < d; c += 32) {
    const float xhat = (h0[base + c] - mean) * rstd;
    dh0[base + c] = g[base + c] + rstd * (dy[base + c] * ga[c] - m1 - xhat * m2);
  }
}

// Per-chunk column partials of [dy * xhat, dy] (dgamma, dbeta).
__global__ void __launch_bounds__(COLS* ROW_WARPS)
ln_bwd_col_kernel(const float* __restrict__ h0, const float* __restrict__ stats,
                  const float* __restrict__ dy, float* __restrict__ part, int R, int d) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[2] = {0.0f, 0.0f};
  if (c < d) {
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * d + c;
      const float xhat = (h0[i] - stats[2 * (size_t)r]) * stats[2 * (size_t)r + 1];
      acc[0] += dy[i] * xhat;
      acc[1] += dy[i];
    }
  }
  store_col_partials<2>(acc, part, gridDim.y, d, c);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Work the caller allocates: y (R, d), z (R, dh). With keep != 0 the forward
// also stores the pre-activation a1 (R, dh) and stats (R, 2) = [mean, rstd]
// per row for the backward; a1 and stats may be null otherwise.
extern "C" int ln_ffn_forward(const float* h0, const float* ga, const float* be,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, float* out, float* y, float* z, float* a1,
                              float* stats, int R, int d, int dh, int act,
                              unsigned int seed, int t1, float s1, int t2, float s2,
                              float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ln_fwd_kernel<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, st>>>(h0, ga, be, y, stats, R,
                                                            d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Epi e1;
  e1.bias = b1;
  e1.pre = a1;
  e1.act = act;
  e1.drop = make_drop(seed, 1, t1, s1);
  if ((err = gemm_nn(y, w1, z, R, dh, d, e1, st)) != cudaSuccess) return err;
  Epi e2;
  e2.bias = b2;
  e2.res = h0;
  e2.drop = make_drop(seed, 2, t2, s2);
  return gemm_nn(z, w2, out, R, d, dh, e2, st);
}

// floats of scratch ln_ffn_backward needs (reused by its passes in turn)
extern "C" long long ln_ffn_backward_scratch(int R, int d, int dh) {
  const long long chunks = row_chunks(R);
  long long s = 2 * chunks * d;
  s = s > chunks * dh ? s : chunks * dh;
  s = s > (long long)tn_scratch(d, dh, R) ? s : (long long)tn_scratch(d, dh, R);
  s = s > (long long)tn_scratch(dh, d, R) ? s : (long long)tn_scratch(dh, d, R);
  return s;
}

// Inputs: h0 (R, d), gamma (d,), W1 (d, dh), W2 (dh, d), the forward's kept y
// (R, d), a1 (R, dh), z (R, dh) and stats (R, 2), the cotangent g (R, d).
// Outputs: dh0 (R, d), dgb (2, d) = [dgamma, dbeta], dw1 (d, dh), db1 (dh,),
// dw2 (dh, d), db2 (d,). Work: da2 (R, d), da1 (R, dh), dy (R, d), scratch.
extern "C" int ln_ffn_backward(const float* h0, const float* ga, const float* w1,
                               const float* w2, const float* y, const float* a1,
                               const float* z, const float* stats, const float* g,
                               float* dh0, float* dgb, float* dw1, float* db1, float* dw2,
                               float* db2, float* da2, float* da1, float* dy,
                               float* scratch, int R, int d, int dh, int act,
                               unsigned int seed, int t1, float s1, int t2, float s2,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int chunks = row_chunks(R);
  const dim3 blk(COLS, ROW_WARPS);
  // da2 = drop2(g), db2 = sum da2
  drop_grad_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(
      g, nullptr, da2, scratch, R, d, act, make_drop(seed, 2, t2, s2));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, db2, 1, chunks, d, st)) != cudaSuccess) return err;
  // du = da2 W2^T, then da1 = drop1(du) * act'(a1) in place, db1 = sum da1
  if ((err = gemm_nt(da2, w2, da1, R, dh, d, Epi(), st)) != cudaSuccess) return err;
  drop_grad_kernel<<<dim3(cdiv(dh, COLS), chunks), blk, 0, st>>>(
      da1, a1, da1, scratch, R, dh, act, make_drop(seed, 1, t1, s1));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, db1, 1, chunks, dh, st)) != cudaSuccess) return err;
  // dy = da1 W1^T: the cotangent of the LayerNorm's output
  if ((err = gemm_nt(da1, w1, dy, R, d, dh, Epi(), st)) != cudaSuccess) return err;
  // weight gradients over all R rows
  if ((err = gemm_tn(y, da1, dw1, d, dh, R, scratch, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(z, da2, dw2, dh, d, R, scratch, st)) != cudaSuccess) return err;
  // through the LayerNorm: dh0 per row, then dgamma and dbeta per column
  ln_bwd_row_kernel<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, st>>>(h0, ga, stats, dy, g,
                                                                dh0, R, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ln_bwd_col_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(h0, stats, dy, scratch,
                                                                R, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, dgb, 2, chunks, d, st);
}
