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
// Bound on the H100: the two products (forward 4*R*d*dh operations,
// backward twice that) at the 3xTF32 tensor-core rate (495 / 3 = 165
// TFLOP/s); at ZINC's R = 10,496, d = dh = 80 that is 0.0016 ms forward,
// below the 0.002 ms of h0 in and out, so there bytes bound it. At these
// shapes each launch is a fraction of a wave, so fill, drain and launch
// latency weigh as much as the work, and the design counts launches.
// Forward, 3 launches on the caller's stream: a warp per two rows computes
// each row's mean and centred variance with shuffle sums in a fixed order
// and writes y (and, when a backward follows, the row's mean and rstd); the
// 3xTF32 tensor-core GEMM (gemm_tc.cuh: mma.sync on 64 x 64 tiles, a
// cp.async ring of three stages) computes z = drop1(act(y W1 + b1)) with
// activation and dropout in its epilogue, then out = drop2(z W2 + b2) + h0.
// The LayerNorm stays a launch of its own: the GEMM copies A by cp.async
// straight from device memory, so it has no prologue to fold it into. With
// a backward to follow the forward keeps y, z and the pre-activation a1
// (recomputing them would cost the first product again). Backward, 8
// launches plus a reduce for each TN product split over rows: da2 =
// drop2(g); du = da2 W2^T (NT); da1 = drop1(du) * act'(a1) in place (both
// by common.cuh's drop_grad_kernel, with their column partials); dy =
// da1 W1^T (NT); dW1 = y^T da1 and dW2 = z^T da2 (TN); then one launch
// through the LayerNorm: a warp per row writes dh0 = g + rstd (dy gamma -
// mean(dy gamma) - xhat mean(dy gamma xhat)), and beside those blocks,
// others write each chunk of CHUNK_ROWS rows' column partials of dgamma =
// sum dy xhat and dbeta = sum dy (a block per chunk that also wrote dh0, a
// warp carrying its rows' partials, left 41 blocks at ZINC's R, each warp
// walking 32 rows in turn: PERF.md §6); last one launch adds every chunk's
// partials of db2, db1, dgamma and dbeta, which the passes write into
// disjoint columns of one (chunks, 3d + dh) array, in chunk order. Every
// column sum adds rows in a fixed order (no float atomics), so two runs
// give the same bits. The (R, dh) intermediates make round trips through
// device memory; keeping them on chip, as the TPU kernel does in VMEM, is
// later work.
#include "gemm_tc.cuh"

namespace ggps {
namespace {

constexpr int LN_WARPS = 8;  // warps per block of the forward's LayerNorm
constexpr int LN_ROWS = 2;   // rows a warp of it takes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(h0) * gamma + beta per row; stats (R, 2) = [mean, rstd] if given.
// A warp takes LN_ROWS rows side by side, so that their loads and shuffle
// sums overlap: at a row a warp, ZINC's R = 10,496 rows stood in 1.7 waves
// of warps, each waiting on its loads and shuffles in turn.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ ga,
              const float* __restrict__ be, float* __restrict__ y,
              float* __restrict__ stats, int R, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * LN_WARPS + threadIdx.x / 32) * LN_ROWS;
  if (r0 >= R) return;
  const float* x[LN_ROWS];
  float s[LN_ROWS], v[LN_ROWS], mean[LN_ROWS], rstd[LN_ROWS];
#pragma unroll
  for (int k = 0; k < LN_ROWS; ++k) {
    x[k] = h0 + (size_t)min(r0 + k, R - 1) * d;  // a row past R is read, not written
    s[k] = v[k] = 0.0f;
  }
  for (int c = lane; c < d; c += 32)
#pragma unroll
    for (int k = 0; k < LN_ROWS; ++k) s[k] += x[k][c];
#pragma unroll
  for (int k = 0; k < LN_ROWS; ++k) mean[k] = warp_sum(s[k]) / (float)d;
  for (int c = lane; c < d; c += 32)
#pragma unroll
    for (int k = 0; k < LN_ROWS; ++k) {
      const float t = x[k][c] - mean[k];
      v[k] += t * t;
    }
#pragma unroll
  for (int k = 0; k < LN_ROWS; ++k) rstd[k] = 1.0f / sqrtf(warp_sum(v[k]) / (float)d + eps);
#pragma unroll
  for (int k = 0; k < LN_ROWS && r0 + k < R; ++k) {
    float* yr = y + (size_t)(r0 + k) * d;
    for (int c = lane; c < d; c += 32)
      yr[c] = (x[k][c] - mean[k]) * rstd[k] * ga[c] + be[c];
    if (stats != nullptr && lane == 0) {
      stats[2 * (size_t)(r0 + k)] = mean[k];
      stats[2 * (size_t)(r0 + k) + 1] = rstd[k];
    }
  }
}

// Through the LayerNorm, in one launch of two kinds of block that do not
// wait for each other. The first chunks * cblk blocks each take COLS of
// the d = cblk * COLS (or fewer) columns of a chunk of CHUNK_ROWS rows,
// their ROW_WARPS warps striding the rows, and write the chunk's partials
// [dy * xhat | dy] (dgamma, dbeta) into row `chunk` of part (row stride
// ld). The others take a row a warp: dh0 = g + rstd * (dyh - mean(dyh) -
// xhat * mean(dyh * xhat)), dyh = dy * gamma.
__global__ void __launch_bounds__(COLS* ROW_WARPS)
ln_bwd_kernel(const float* __restrict__ h0, const float* __restrict__ ga,
              const float* __restrict__ stats, const float* __restrict__ dy,
              const float* __restrict__ g, float* __restrict__ dh0,
              float* __restrict__ part, int ld, int chunks, int cblk, int R, int d) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  if ((int)blockIdx.x < chunks * cblk) {
    const int chunk = blockIdx.x / cblk;
    const int c = blockIdx.x % cblk * COLS + lane;
    const int r_end = min(R, (chunk + 1) * CHUNK_ROWS);
    float acc[2] = {0.0f, 0.0f};
    if (c < d) {
#pragma unroll 4
      for (int r = chunk * CHUNK_ROWS + warp; r < r_end; r += ROW_WARPS) {
        const size_t i = (size_t)r * d + c;
        const float xhat = (h0[i] - stats[2 * (size_t)r]) * stats[2 * (size_t)r + 1];
        acc[0] += dy[i] * xhat;
        acc[1] += dy[i];
      }
    }
    store_col_partials<2>(acc, part, chunk, ld, d, d, c);
    return;
  }
  const int r = (blockIdx.x - chunks * cblk) * ROW_WARPS + warp;
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
  ln_fwd_kernel<<<cdiv(R, LN_WARPS * LN_ROWS), LN_WARPS * 32, 0, st>>>(h0, ga, be, y,
                                                                      stats, R, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Epi e1;
  e1.bias = b1;
  e1.pre = a1;
  e1.act = act;
  e1.drop = make_drop(seed, 1, t1, s1);
  if ((err = tc::gemm_nn(y, w1, z, R, dh, d, e1, st)) != cudaSuccess) return err;
  Epi e2;
  e2.bias = b2;
  e2.res = h0;
  e2.drop = make_drop(seed, 2, t2, s2);
  return tc::gemm_nn(z, w2, out, R, d, dh, e2, st);
}

// floats of scratch ln_ffn_backward needs: the (chunks, 3d + dh) column
// partials, then the TN products' split partials
extern "C" long long ln_ffn_backward_scratch(int R, int d, int dh) {
  const long long a = tc::tn_scratch(d, dh, R), b = tc::tn_scratch(dh, d, R);
  return (long long)row_chunks(R) * (3 * d + dh) + (a > b ? a : b);
}

// Inputs: h0 (R, d), gamma (d,), W1 (d, dh), W2 (dh, d), the forward's kept y
// (R, d), a1 (R, dh), z (R, dh) and stats (R, 2), the cotangent g (R, d).
// Outputs: dh0 (R, d), dw1 (d, dh), dw2 (dh, d), dbias (3d + dh) = [db2 |
// db1 | dgamma | dbeta]. Work: da2 (R, d), da1 (R, dh), dy (R, d), scratch.
extern "C" int ln_ffn_backward(const float* h0, const float* ga, const float* w1,
                               const float* w2, const float* y, const float* a1,
                               const float* z, const float* stats, const float* g,
                               float* dh0, float* dbias, float* dw1, float* dw2,
                               float* da2, float* da1, float* dy, float* scratch, int R,
                               int d, int dh, int act, unsigned int seed, int t1,
                               float s1, int t2, float s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int chunks = row_chunks(R), ld = 3 * d + dh;
  float* part = scratch;  // (chunks, ld): [db2 | db1 | dgamma | dbeta]
  float* tn = scratch + (size_t)chunks * ld;
  const dim3 blk(COLS, ROW_WARPS);
  // da2 = drop2(g) and its column partials
  drop_grad_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(
      g, nullptr, da2, part, ld, R, d, act, make_drop(seed, 2, t2, s2));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // du = da2 W2^T, then da1 = drop1(du) * act'(a1) in place and its partials
  if ((err = tc::gemm_nt(da2, w2, da1, R, dh, d, Epi(), st)) != cudaSuccess) return err;
  drop_grad_kernel<<<dim3(cdiv(dh, COLS), chunks), blk, 0, st>>>(
      da1, a1, da1, part + d, ld, R, dh, act, make_drop(seed, 1, t1, s1));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dy = da1 W1^T: the cotangent of the LayerNorm's output
  if ((err = tc::gemm_nt(da1, w1, dy, R, d, dh, Epi(), st)) != cudaSuccess) return err;
  // weight gradients over all R rows
  if ((err = tc::gemm_tn(y, da1, dw1, d, dh, R, tn, st)) != cudaSuccess) return err;
  if ((err = tc::gemm_tn(z, da2, dw2, dh, d, R, tn, st)) != cudaSuccess) return err;
  // through the LayerNorm: the dgamma, dbeta partials beside dh0 per row
  const int cblk = cdiv(d, COLS);
  ln_bwd_kernel<<<chunks * cblk + cdiv(R, ROW_WARPS), blk, 0, st>>>(
      h0, ga, stats, dy, g, dh0, part + d + dh, ld, chunks, cblk, R, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // every bias and norm-vector gradient, chunks added in order
  return reduce_partials(part, dbias, 1, chunks, ld, st);
}
