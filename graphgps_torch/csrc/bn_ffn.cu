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
//
// Design: two routes, by width. Where W1, W2 and a block's row tiles fit in
// shared memory (ffn_fused.cuh's FUSED_SMEM_LIMIT, the H100's 227 KB a
// block; SAN's d = 64, dh = 128 among them), one launch each way:
// - forward (bn_ffn_fused_fwd_kernel): a block of 16 rows applies the norm to
//   get h into shared memory, then ffn_fused.cuh's forward_block runs both
//   products on the tensor cores (3xTF32 mma.sync) with a1 and z on chip,
//   and writes out; with a backward to follow it also keeps h, a1 and z;
// - backward (bn_ffn_fused_bwd_kernel, then ffn_fused.cuh's reduce_blocks):
//   a block of 16 rows stages h, z and da2 = drop2(g), computes da1, dh =
//   g + da1 W1^T and ds = dh * inv * gamma, and writes one row of partials:
//   dW1, dW2, db1, db2 and the four norm-vector sums dmu = -sum ds,
//   dinv = sum dh * gamma * (s - mu), dgamma = sum dh * (s - mu) * inv,
//   dbeta = sum dh; the reduce adds the rows in a fixed order.
// Wider FFNs (molpcba-SAN's d = 304) run as a launch sequence: an elementwise
// pass writes h, then ffn_core.cuh's FFN block over the tensor-core GEMM
// (gemm_tc.cuh) computes out; its backward gives dh, dW1, db1, dW2, db2, and
// a column pass over dh gives ds and per-chunk partials of the four
// norm-vector sums. With a backward to follow the forward keeps h, z and the
// pre-activation a1 (recomputing them would cost the first product again).
// Every sum runs in a fixed order (no float atomics), so two runs give the
// same bits. The route is the wrapper's (ops/kernels/bn_ffn.py
// takes_fused, the same rule as fused::fits).
#include "gemm_tc.cuh"
#include "ffn_core.cuh"
#include "ffn_fused.cuh"

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

// The fused forward of rows [16 b, 16 b + 16): the norm apply into shared
// memory (and into h_keep when not null), then the FFN block.
__global__ void __launch_bounds__(fused::NT)
bn_ffn_fused_fwd_kernel(const float* __restrict__ s, const float* __restrict__ mu,
                        const float* __restrict__ inv, const float* __restrict__ ga,
                        const float* __restrict__ be, const float* __restrict__ w1,
                        const float* __restrict__ w2, float* __restrict__ h_keep,
                        fused::FwdArgs p, int d, int dh, bool vec) {
  p.drop1 = resolved(p.drop1);
  p.drop2 = resolved(p.drop2);
  extern __shared__ float smem[];
  const fused::FfnLayout L = fused::FfnLayout::make(d, dh, false);
  fused::stage_weights(L, smem, w1, w2, vec);
  tc::cp_commit();
  const int row0 = blockIdx.x * fused::BM;
  float* hs = smem + L.h;
  for (int i = threadIdx.x; i < fused::BM * L.dp; i += fused::NT) {
    const int m = i / L.dp, c = i % L.dp, row = row0 + m;
    float v = 0.0f;
    if (row < p.R && c < d) {
      const size_t idx = (size_t)row * d + c;
      v = (s[idx] - mu[c]) * inv[c] * ga[c] + be[c];
      if (h_keep != nullptr) h_keep[idx] = v;
    }
    hs[m * L.ldh + c] = v;
  }
  tc::cp_wait<0>();
  __syncthreads();
  fused::forward_block(L, smem, row0, p);
}

// The fused backward of rows [16 b, 16 b + 16): the FFN block's backward,
// then ds = dh * inv * gamma and the four norm-vector sums of the block's
// rows into the end of its partial row.
__global__ void __launch_bounds__(fused::NT)
bn_ffn_fused_bwd_kernel(const float* __restrict__ s, const float* __restrict__ mu,
                        const float* __restrict__ inv, const float* __restrict__ ga,
                        const float* __restrict__ w1, const float* __restrict__ w2,
                        const float* __restrict__ h, const float* __restrict__ z,
                        float* __restrict__ ds, float* __restrict__ part,
                        fused::BwdArgs p, Drop drop2, int d, int dh, bool vec) {
  p.drop1 = resolved(p.drop1);
  drop2 = resolved(drop2);
  extern __shared__ float smem[];
  const fused::FfnLayout L = fused::FfnLayout::make(d, dh, true);
  const int row0 = blockIdx.x * fused::BM;
  const long long P = fused::ffn_part_floats(d, dh) + 4LL * d;
  p.part = part + (size_t)blockIdx.x * P;
  fused::stage_weights(L, smem, w1, w2, vec);
  fused::stage_rows(L, smem, row0, h, z, p.g, p.R, drop2, vec);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
  fused::backward_block(L, smem, row0, p);
  const float* dhh = smem + L.dhh;
  float* vec4 = p.part + fused::ffn_part_floats(d, dh);
  const int rows = min(fused::BM, p.R - row0);
  for (int c = threadIdx.x; c < d; c += fused::NT) {
    const float m = mu[c], iv = inv[c], gc = ga[c];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < rows; ++r) {
      const size_t i = (size_t)(row0 + r) * d + c;
      const float gi = dhh[r * L.lddh + c];
      const float sc = s[i] - m;
      const float dsi = gi * iv * gc;
      ds[i] = dsi;
      acc[0] -= dsi;
      acc[1] += gi * gc * sc;
      acc[2] += gi * (sc * iv);
      acc[3] += gi;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) vec4[k * d + c] = acc[k];
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Bytes of shared memory a block of the fused route takes (forward, or
// backward when `backward`), and whether the route takes (d, dh) at all.
extern "C" long long bn_ffn_fused_smem(int d, int dh, int backward) {
  return fused::FfnLayout::make(d, dh, backward != 0).bytes();
}
extern "C" int bn_ffn_fused_fits(int d, int dh) { return fused::fits(d, dh) ? 1 : 0; }

// fused != 0: the fused route (the wrapper checked bn_ffn_fused_fits); h, z
// and a1 are then kept when not null. Otherwise the launch sequence, with
// work the caller allocates: h (R, d), z (R, dh), and a1 (R, dh) stored when
// not null, for the backward.
extern "C" int bn_ffn_forward(const float* s, const float* mu, const float* inv,
                              const float* ga, const float* be, const float* w1,
                              const float* b1, const float* w2, const float* b2,
                              float* out, float* h, float* z, float* a1, int R, int d,
                              int dh, int act, const unsigned int* seed, int t1, int t2,
                              float scale, int fused_route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop1 = make_drop(seed, 1, t1, scale), drop2 = make_drop(seed, 2, t2, scale);
  cudaError_t err;
  if (fused_route) {
    if (R <= 0) return 0;
    const fused::FfnLayout L = fused::FfnLayout::make(d, dh, false);
    if ((err = allow_smem(bn_ffn_fused_fwd_kernel, L.bytes())) != cudaSuccess) return err;
    fused::FwdArgs p{b1, b2, out, a1, z, R, act, drop1, drop2};
    const bool vec = d % 4 == 0 && dh % 4 == 0 && aligned16(w1) && aligned16(w2);
    bn_ffn_fused_fwd_kernel<<<cdiv(R, fused::BM), fused::NT, L.bytes(), st>>>(
        s, mu, inv, ga, be, w1, w2, h, p, d, dh, vec);
    return cudaGetLastError();
  }
  const long long total = (long long)R * d;
  bn_apply_kernel<<<elementwise_blocks(total, 256), 256, 0, st>>>(s, mu, inv, ga, be,
                                                                   h, total, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return ffn_core_forward<tc::Gemm>(h, w1, b1, w2, b2, out, z, a1, R, d, dh, act, drop1,
                                    drop2, st);
}

// floats of scratch bn_ffn_backward needs on its route (reused by the
// sequence's passes in turn)
extern "C" long long bn_ffn_backward_scratch(int R, int d, int dh, int fused_route) {
  if (fused_route)
    return (long long)cdiv(R > 0 ? R : 1, fused::BM) *
           (fused::ffn_part_floats(d, dh) + 4LL * d);
  const long long part = 4 * (long long)row_chunks(R) * d;
  const long long core = ffn_core_scratch<tc::Gemm>(R, d, dh);
  return part > core ? part : core;
}

// Inputs: s (R, d), mu, inv, gamma (d,), W1 (d, dh), W2 (dh, d), the
// forward's kept h (R, d), a1 (R, dh), z (R, dh), the cotangent g (R, d).
// Outputs: ds (R, d), dvec (4, d) = [dmu, dinv, dgamma, dbeta], dw1 (d, dh),
// db1 (dh,), dw2 (dh, d), db2 (d,). Work: the sequence's da2 (R, d), da1
// (R, dh), dhh (R, d) (null on the fused route), scratch.
extern "C" int bn_ffn_backward(const float* s, const float* mu, const float* inv,
                               const float* ga, const float* w1, const float* w2,
                               const float* h, const float* a1, const float* z,
                               const float* g, float* ds, float* dvec, float* dw1,
                               float* db1, float* dw2, float* db2, float* da2, float* da1,
                               float* dhh, float* scratch, int R, int d, int dh, int act,
                               const unsigned int* seed, int t1, int t2, float scale,
                               int fused_route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop1 = make_drop(seed, 1, t1, scale), drop2 = make_drop(seed, 2, t2, scale);
  cudaError_t err;
  if (fused_route) {
    const int blocks = R > 0 ? cdiv(R, fused::BM) : 0;
    if (blocks > 0) {
      const fused::FfnLayout L = fused::FfnLayout::make(d, dh, true);
      if ((err = allow_smem(bn_ffn_fused_bwd_kernel, L.bytes())) != cudaSuccess) return err;
      fused::BwdArgs p{a1, g, nullptr, R, act, drop1};
      const bool vec = d % 4 == 0 && dh % 4 == 0 && aligned16(w1) && aligned16(w2) &&
                       aligned16(h) && aligned16(z);
      bn_ffn_fused_bwd_kernel<<<blocks, fused::NT, L.bytes(), st>>>(
          s, mu, inv, ga, w1, w2, h, z, ds, scratch, p, drop2, d, dh, vec);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    // the partial row: [dW1 | dW2 | db1 | db2 | dmu, dinv, dgamma, dbeta]
    fused::Outs outs{};
    const long long dd = (long long)d * dh;
    float* ptrs[5] = {dw1, dw2, db1, db2, dvec};
    const long long lens[5] = {dd, dd, dh, d, 4LL * d};
    long long end = 0;
    for (int i = 0; i < 5; ++i) {
      outs.ptr[i] = ptrs[i];
      outs.end[i] = end += lens[i];
    }
    outs.n = 5;
    return fused::reduce_blocks(scratch, blocks, end, outs, st);
  }
  err = ffn_core_backward<tc::Gemm>(h, a1, z, g, w1, w2, dhh, dw1, db1, dw2, db2, da2, da1,
                                    scratch, R, d, dh, act, drop1, drop2, st);
  if (err != cudaSuccess) return err;
  const int chunks = row_chunks(R);
  const dim3 blk(COLS, ROW_WARPS);
  // through the norm's apply: ds per element, the four vector sums per column
  bn_bwd_col_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(dhh, s, mu, inv, ga,
                                                                ds, scratch, R, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, dvec, 4, chunks, d, st);
}
