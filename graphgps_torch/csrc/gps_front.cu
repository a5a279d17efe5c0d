// GPS layer front: GatedGCN core + masked multi-head attention + the
// attention branch's residual + masked BatchNorm moment partials, forward.
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_layer.py:270
// fused_gps_front (forward at :319), with the GatedGCN middle of
// fused_gatedgcn.py:94 _core_from_proj and the attention of
// fused_gps_attn.py:121 _attn_fwd_all. Per call, for B graphs of N node slots
// and E edge slots each:
//
//   projall = x @ [A|D|E|B|Wq|Wk|Wv] + b               (B*N, 7d)
//   ce      = e @ C + c                                 (B*E, d)
//   gate    = D x_r + E x_s + ce                        per edge, graph-local ids
//   x_new   = A x + sum_e m*sig(gate)*B x_s / (sum_e m*sig(gate) + 1e-6)
//   attn    = softmax(mask(q k^T * scale)) v           per (graph, head)
//   s_attn  = x + attn @ Wo + bo
//   moments = [sum m(v-c) | sum m(v-c)^2] of x_new, gate, s_attn   (3, 2d)
//
// Bound on the H100: the two projections dominate (about 2*B*N*d*7d +
// 2*B*E*d*d f32 operations), so the call is bound by f32 operations; the
// gather/aggregate and attention stages are bound by bytes. Design, in
// launches on the caller's stream:
//   1-2. the projections through the shared GEMM (gemm.cuh); ce is written
//        straight into the gate output and overwritten in place;
//   3.   ggcn_core_kernel: one block per (graph, 128 columns), one thread per
//        column walks the graph's edges in order, gathers D x_r, E x_s, B x_s
//        by index (no one-hot matmuls: Hopper indexes directly), forms gate and
//        sigma, and accumulates num/den for the N receivers in shared memory
//        (the thread owns its column, so no atomics and a fixed order);
//   4.   mha_kernel: one block per (graph, head), q/k/v and the N x N scores
//        in shared memory (N <= 128), masked keys at -1e30 so a graph with no
//        real node still gives finite, uniform weights;
//   5.   the out-projection through the GEMM with the residual x in its epilogue;
//   6.   per-graph moment partials, then a second pass that sums them over the
//        graphs in a fixed order (the TPU summed across its sequential grid;
//        Hopper blocks run in any order, and float atomics would make the sum
//        order change from run to run).
// Dropout is not here: the main path evaluates, and the wrapper refuses rates
// above 0 (the training slice brings it).
#include "gemm.cuh"

namespace ggps {
namespace {

constexpr int CORE_COLS = 128;   // columns (= threads) per core block
constexpr int MHA_THREADS = 128;

__global__ void __launch_bounds__(CORE_COLS)
ggcn_core_kernel(const float* __restrict__ proj, float* __restrict__ gate,
                 const int* __restrict__ s_loc, const int* __restrict__ r_loc,
                 const float* __restrict__ emask, const float* __restrict__ nmask,
                 const float* __restrict__ cx, const float* __restrict__ cg,
                 float* __restrict__ x_new, float* __restrict__ part_x,
                 float* __restrict__ part_g, int N, int E, int d) {
  extern __shared__ float smem[];
  float* num = smem;                    // [N][CORE_COLS]
  float* den = smem + N * CORE_COLS;    // [N][CORE_COLS]
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int c = blockIdx.y * CORE_COLS + t;
  if (c >= d) return;  // no block-wide barrier below: each thread owns a column
  const size_t P = 7 * (size_t)d;
  const float* pg = proj + (size_t)g * N * P;
  for (int n = 0; n < N; ++n) {
    num[n * CORE_COLS + t] = 0.0f;
    den[n * CORE_COLS + t] = 0.0f;
  }

  const float cgc = cg[c];
  float sg = 0.0f, sgg = 0.0f;
  for (int j = 0; j < E; ++j) {
    const int s = s_loc[g * E + j];
    const int r = r_loc[g * E + j];
    const float m = emask[g * E + j];
    // an index outside the graph gathers zeros and scatters nowhere, as the
    // TPU kernel's one-hot rows do
    const bool s_ok = (unsigned)s < (unsigned)N;
    const bool r_ok = (unsigned)r < (unsigned)N;
    const float dr = r_ok ? pg[(size_t)r * P + d + c] : 0.0f;
    const float ex = s_ok ? pg[(size_t)s * P + 2 * d + c] : 0.0f;
    const float bx = s_ok ? pg[(size_t)s * P + 3 * d + c] : 0.0f;
    float* gp = gate + ((size_t)g * E + j) * d + c;
    const float gt = dr + ex + *gp;   // *gp holds ce on entry
    *gp = gt;
    const float sig = 1.0f / (1.0f + expf(-gt));
    if (r_ok) {
      num[r * CORE_COLS + t] += m * (sig * bx);
      den[r * CORE_COLS + t] += m * sig;
    }
    const float y = gt - cgc;
    sg += m * y;
    sgg += m * y * y;
  }
  part_g[(size_t)g * 2 * d + c] = sg;
  part_g[(size_t)g * 2 * d + d + c] = sgg;

  const float cxc = cx[c];
  float sx = 0.0f, sxx = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float v = pg[(size_t)n * P + c]
                    + num[n * CORE_COLS + t] / (den[n * CORE_COLS + t] + 1e-6f);
    x_new[((size_t)g * N + n) * d + c] = v;
    const float m = nmask[g * N + n];
    const float y = v - cxc;
    sx += m * y;
    sxx += m * y * y;
  }
  part_x[(size_t)g * 2 * d + c] = sx;
  part_x[(size_t)g * 2 * d + d + c] = sxx;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(MHA_THREADS)
mha_kernel(const float* __restrict__ proj, const float* __restrict__ nmask,
           float* __restrict__ out, int N, int d, int H, float scale) {
  extern __shared__ float smem[];
  const int Dh = d / H;
  const int ld = Dh + 1;                // padded rows: conflict-free column reads
  float* q = smem;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* S = v + N * ld;                // [N][N] scores, then probabilities
  const int g = blockIdx.x, h = blockIdx.y;
  const size_t P = 7 * (size_t)d;
  const float* base = proj + (size_t)g * N * P + 4 * d + h * Dh;
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int n = i / Dh, j = i % Dh;
    const float* row = base + (size_t)n * P;
    q[n * ld + j] = row[j];
    k[n * ld + j] = row[d + j];
    v[n * ld + j] = row[2 * d + j];
  }
  __syncthreads();

  const float* nm = nmask + (size_t)g * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i % N;
    float acc = 0.0f;
    for (int j = 0; j < Dh; ++j) acc = fmaf(q[n * ld + j], k[m * ld + j], acc);
    S[n * N + m] = nm[m] > 0.0f ? acc * scale : -1e30f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int n = warp; n < N; n += nwarps) {
    float* row = S + n * N;
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) mx = fmaxf(mx, row[m]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int m = lane; m < N; m += 32) {
      const float ex = expf(row[m] - mx);
      row[m] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < N; m += 32) row[m] = row[m] / sum;
  }
  __syncthreads();

  float* o = out + (size_t)g * N * d + h * Dh;
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int n = i / Dh, j = i % Dh;
    float acc = 0.0f;
    for (int m = 0; m < N; ++m) acc = fmaf(S[n * N + m], v[m * ld + j], acc);
    o[(size_t)n * d + j] = acc;
  }
}

// Per-graph masked moment partials of a (B, R, d) tensor: one thread per
// column, rows in order.
__global__ void __launch_bounds__(CORE_COLS)
moments_kernel(const float* __restrict__ val, const float* __restrict__ mask,
               const float* __restrict__ shift, float* __restrict__ part, int R,
               int d) {
  const int g = blockIdx.x;
  const int c = blockIdx.y * CORE_COLS + threadIdx.x;
  if (c >= d) return;
  const float cc = shift[c];
  float s = 0.0f, ss = 0.0f;
  for (int n = 0; n < R; ++n) {
    const float m = mask[(size_t)g * R + n];
    const float y = val[((size_t)g * R + n) * d + c] - cc;
    s += m * y;
    ss += m * y * y;
  }
  part[(size_t)g * 2 * d + c] = s;
  part[(size_t)g * 2 * d + d + c] = ss;
}

// (T, B, W) per-graph partials -> (T, W) sums over the graphs, in order.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int T, int B,
                                       int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * W) return;
  const int t = i / W, w = i % W;
  const float* p = part + (size_t)t * B * W + w;
  float s = 0.0f;
  for (int g = 0; g < B; ++g) s += p[(size_t)g * W];
  out[i] = s;
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" size_t gps_front_core_smem(int N) {
  return 2 * (size_t)N * CORE_COLS * sizeof(float);
}

extern "C" size_t gps_front_mha_smem(int N, int d, int H) {
  const size_t Dh = d / H;
  return (3 * (size_t)N * (Dh + 1) + (size_t)N * N) * sizeof(float);
}

// Scratch the caller allocates: proj (B*N, 7d), attn (B*N, d),
// part (3, B, 2d). Outputs: x_new, s_attn (B, N, d), gate (B, E, d),
// moments (3, 2d) = [x_new | gate | s_attn] partial sums.
extern "C" int gps_front_forward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* ca, const float* wnq, const float* bnq, const float* wc,
    const float* bc, const float* wo, const float* bo, float* x_new, float* gate,
    float* s_attn, float* moments, float* proj, float* attn, float* part, int B,
    int N, int E, int d, int H, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = gemm_bias_act(x, wnq, bnq, nullptr, proj, B * N, 7 * d, d, ACT_IDENTITY,
                           st)) != cudaSuccess)
    return err;
  if ((err = gemm_bias_act(e, wc, bc, nullptr, gate, B * E, d, d, ACT_IDENTITY, st)) !=
      cudaSuccess)
    return err;

  const size_t part_stride = (size_t)B * 2 * d;
  const dim3 col_grid(B, cdiv(d, CORE_COLS));
  const size_t core_smem = gps_front_core_smem(N);
  if ((err = allow_smem(ggcn_core_kernel, core_smem)) != cudaSuccess) return err;
  ggcn_core_kernel<<<col_grid, CORE_COLS, core_smem, st>>>(
      proj, gate, s_loc, r_loc, emask, nmask, cx, cg, x_new, part, part + part_stride,
      N, E, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t mha_smem = gps_front_mha_smem(N, d, H);
  if ((err = allow_smem(mha_kernel, mha_smem)) != cudaSuccess) return err;
  mha_kernel<<<dim3(B, H), MHA_THREADS, mha_smem, st>>>(proj, nmask, attn, N, d, H,
                                                        scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = gemm_bias_act(attn, wo, bo, x, s_attn, B * N, d, d, ACT_IDENTITY, st)) !=
      cudaSuccess)
    return err;

  moments_kernel<<<col_grid, CORE_COLS, 0, st>>>(s_attn, nmask, ca,
                                                 part + 2 * part_stride, N, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_partials_kernel<<<cdiv(3 * 2 * d, 256), 256, 0, st>>>(part, moments, 3, B,
                                                              2 * d);
  return cudaGetLastError();
}
