// GPS layer combine + FFN, forward and backward:
//
//   h   = x_in + drop0(act(gx * (v - mux) * ivx + bx)) + (ga * (s - mua) * iva + ba)
//   out = h + drop2(W2 drop1(act(W1 h + b1)) + b2)           (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_combine.py:183
// fused_combine_ffn (forward pallas_call at :204, backward _cf_vjp_bwd :235
// with its pallas_call at :245): the GatedGCN x-tail, the attention branch's
// norm apply, the branch sum and the whole FFN block. On the main path
// R = B*N. Dropout sites (common.cuh): 0 the local tail's (R, d) view, 1 the
// FFN inner (R, dh) view, 2 the FFN outer (R, d) view.
//
// Bound on the H100: the FFN's products (forward 4*R*d*dh f32 operations,
// backward twice that), so operations; they run 3xTF32 on the tensor cores
// (gemm_tc.cuh, 165 TFLOP/s). Design, in launches on the caller's stream.
// Forward: an elementwise prologue forms h, then the shared FFN block
// (ffn_core.cuh over tc::Gemm) computes out = h + drop2(W2 drop1(act(W1 h +
// b1)) + b2).
// When a backward will follow, the forward keeps h, the pre-activation
// a1 = h W1 + b1 and z (saving them costs 2*R*dh + R*d floats a layer;
// recomputing would cost a third product). Backward: the FFN block's
// backward gives dh, dW1, db1, dW2, db2; then one pass over dh gives
// ds_attn, dv_loc and per-chunk partials of the eight norm-vector sums,
// added in a fixed order (no float atomics), so two runs give the same bits.
#include "gemm_tc.cuh"
#include "ffn_core.cuh"

namespace ggps {
namespace {

__global__ void combine_prologue_kernel(
    const float* __restrict__ x_in, const float* __restrict__ v,
    const float* __restrict__ mux, const float* __restrict__ ivx,
    const float* __restrict__ gax, const float* __restrict__ bex,
    const float* __restrict__ sa, const float* __restrict__ mua,
    const float* __restrict__ iva, const float* __restrict__ gaa,
    const float* __restrict__ bea, float* __restrict__ h, long long total, int d,
    int act, Drop drop0) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int c = (int)(i % d);
    const float a = drop_apply(
        drop0, i, apply_act((v[i] - mux[c]) * ivx[c] * gax[c] + bex[c], act));
    const float ha = (sa[i] - mua[c]) * iva[c] * gaa[c] + bea[c];
    h[i] = x_in[i] + a + ha;
  }
}

// From dh: ds_attn, dv_loc and the eight norm-vector sums
// [dmux, divx, dgax, dbex, dmua, diva, dgaa, dbea] as per-chunk partials.
__global__ void __launch_bounds__(COLS* ROW_WARPS)
combine_tail_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ v,
                        const float* __restrict__ mux, const float* __restrict__ ivx,
                        const float* __restrict__ gax, const float* __restrict__ bex,
                        const float* __restrict__ sa, const float* __restrict__ mua,
                        const float* __restrict__ iva, const float* __restrict__ gaa,
                        float* __restrict__ dv, float* __restrict__ dsa,
                        float* __restrict__ part, int R, int d, int act, Drop drop0) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (c < d) {
    const float mx = mux[c], ix = ivx[c], gx = gax[c], bx = bex[c];
    const float ma = mua[c], ia = iva[c], ga = gaa[c];
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * d + c;
      const float g = dh[i];
      // attention branch: ha = (sa - mua) * iva * gaa + bea
      const float sc = sa[i] - ma;
      const float dsai = g * ia * ga;
      dsa[i] = dsai;
      acc[4] -= dsai;
      acc[5] += g * ga * sc;
      acc[6] += g * (sc * ia);
      acc[7] += g;
      // local branch: a = drop0(act((v - mux) * ivx * gax + bex))
      const float vc = v[i] - mx;
      const float z = vc * ix * gx + bx;
      const float dz = drop_apply(drop0, i, g) * act_grad(z, act);
      const float dyhat = dz * gx;
      const float dvi = dyhat * ix;
      dv[i] = dvi;
      acc[0] -= dvi;
      acc[1] += dyhat * vc;
      acc[2] += dz * (vc * ix);
      acc[3] += dz;
    }
  }
  store_col_partials<8>(acc, part, blockIdx.y, d, (size_t)gridDim.y * d, d, c);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Scratch the caller allocates: h (R, d), z (R, dh). With keep != 0 the
// forward also stores the pre-activation a1 (R, dh) for the backward.
extern "C" int combine_ffn_forward(
    const float* x_in, const float* v, const float* mux, const float* ivx,
    const float* gax, const float* bex, const float* sa, const float* mua,
    const float* iva, const float* gaa, const float* bea, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, float* h, float* z,
    float* a1, int R, int d, int dh, int act, unsigned int seed, int t, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)R * d;
  combine_prologue_kernel<<<elementwise_blocks(total, 256), 256, 0, st>>>(
      x_in, v, mux, ivx, gax, bex, sa, mua, iva, gaa, bea, h, total, d, act,
      make_drop(seed, 0, t, scale));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ffn_core_forward<tc::Gemm>(h, w1, b1, w2, b2, out, z, a1, R, d, dh, act,
                                    make_drop(seed, 1, t, scale),
                                    make_drop(seed, 2, t, scale), st);
}

// floats of scratch combine_ffn_backward needs (reused by its passes in turn)
extern "C" long long combine_ffn_backward_scratch(int R, int d, int dh) {
  const long long part = 8 * (long long)row_chunks(R) * d;
  const long long core = ffn_core_scratch<tc::Gemm>(R, d, dh);
  return part > core ? part : core;
}

// Inputs: the forward's operands, its saved h (R, d), a1 (R, dh), z (R, dh),
// and the cotangent g (R, d). Outputs: dh (R, d) (= dx_in), dv (R, d),
// dsa (R, d), dvec (8, d) = [dmux, divx, dgax, dbex, dmua, diva, dgaa, dbea],
// dw1 (d, dh), db1 (dh,), dw2 (dh, d), db2 (d,). Work: da2 (R, d),
// da1 (R, dh), scratch.
extern "C" int combine_ffn_backward(
    const float* v, const float* mux, const float* ivx, const float* gax,
    const float* bex, const float* sa, const float* mua, const float* iva,
    const float* gaa, const float* w1, const float* w2, const float* h,
    const float* a1, const float* z, const float* g, float* dh, float* dv, float* dsa,
    float* dvec, float* dw1, float* db1, float* dw2, float* db2, float* da2, float* da1,
    float* scratch, int R, int d, int dhid, int act, unsigned int seed, int t,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ffn_core_backward<tc::Gemm>(
      h, a1, z, g, w1, w2, dh, dw1, db1, dw2, db2, da2, da1, scratch, R, d, dhid, act,
      make_drop(seed, 1, t, scale), make_drop(seed, 2, t, scale), st);
  if (err != cudaSuccess) return err;
  const int chunks = row_chunks(R);
  const dim3 blk(COLS, ROW_WARPS);
  // both branches' elementwise backward and the eight norm-vector sums
  combine_tail_bwd_kernel<<<dim3(cdiv(d, COLS), chunks), blk, 0, st>>>(
      dh, v, mux, ivx, gax, bex, sa, mua, iva, gaa, dv, dsa, scratch, R, d, act,
      make_drop(seed, 0, t, scale));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, dvec, 8, chunks, d, st);
}
