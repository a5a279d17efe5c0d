// GPS layer front: GatedGCN core + masked multi-head attention + the
// attention branch's dropout and residual + masked BatchNorm moment partials,
// forward and backward.
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_layer.py:270
// fused_gps_front (forward pallas_call at :319, backward _fl_vjp_bwd :352 with
// its pallas_call at :366), with the GatedGCN middle of fused_gatedgcn.py:94
// _core_from_proj and the attention of fused_gps_attn.py:121 _attn_fwd_all.
// Per call, for B graphs of N node slots and E edge slots each:
//
//   projall = x @ [A|D|E|B|Wq|Wk|Wv] + b               (B*N, 7d)
//   ce      = e @ C + c                                 (B*E, d)
//   gate    = D x_r + E x_s + ce                        per edge, graph-local ids
//   x_new   = A x + sum_e m*sig(gate)*B x_s / (sum_e m*sig(gate) + 1e-6)
//   P       = softmax(mask(q k^T * scale))              per (graph, head)
//   attn    = drop0(P) v
//   s_attn  = x + drop1(attn @ Wo + bo)
//   moments = [sum m(v-c) | sum m(v-c)^2] of x_new, gate, s_attn   (3, 2d)
//
// Dropout (common.cuh): site 0 is the attention probabilities on the
// (B*H*N, N) view, row (g*H + h)*N + n; site 1 the out-projection's (B*N, d)
// view. The backward replays both masks from the seed.
//
// Bound on the H100: the products dominate (forward about 2*B*N*d*7d +
// 2*B*E*d*d f32 operations, backward about twice that), so the call is bound
// by f32 operations; the gather/aggregate and attention stages are bound by
// bytes. Forward, in launches on the caller's stream:
//   1-2. the projections through the shared GEMM (gemm.cuh); ce is written
//        straight into the gate output and overwritten in place;
//   3.   ggcn_core_kernel (ggcn_core.cuh, shared with gatedgcn.cu; row stride
//        7d here): one block per (graph, 128 columns), one thread per
//        column walks the graph's edges in order, gathers D x_r, E x_s, B x_s
//        by index (no one-hot matmuls: Hopper indexes directly), forms gate and
//        sigma, and accumulates num/den for the N receivers in shared memory
//        (the thread owns its column, so no atomics and a fixed order);
//   4.   mha_kernel: one block per (graph, head), q/k/v and the N x N scores
//        in shared memory (N <= 128), masked keys at -1e30 so a graph with no
//        real node still gives finite, uniform weights;
//   5.   the out-projection through the GEMM, dropout and the residual x in
//        its epilogue;
//   6.   per-graph moment partials, then a second pass that sums them over the
//        graphs in a fixed order (the TPU summed across its sequential grid;
//        Hopper blocks run in any order, and float atomics would make the sum
//        order change from run to run).
// Backward: the forward's projall and attn are kept (73 + 10 MB a layer at
// the main shapes; the TPU recomputed them in VMEM, here recomputing would
// cost the forward's largest product again), and so are its outputs; P and
// the core's sigma/num/den are recomputed from them (cheap, per block).
//   1.   fold_sa_kernel: s_attn's moment cotangent folded into its row
//        cotangent (d/dv sum m(v-c) = m, d/dv sum m(v-c)^2 = 2m(v-c)), the
//        site-1 mask replayed, with dbo's column partials;
//   2.   dO = dy Wo^T (NT GEMM);
//   3.   ggcn_core_bwd_kernel (ggcn_core.cuh): one block per (graph, 64
//        columns), one thread
//        per column folds x_new's and gate's moment cotangents, recomputes
//        num/den, and walks the edges in order twice, scattering dD by
//        receiver and dE/dB by sender into shared memory (no atomics);
//   4.   mha_bwd_kernel: one block per (graph, head) recomputes P, replays
//        the site-0 mask on P (for dv) and on dP, and forms dq, dk, dv;
//   5.   dx = dprojall Wnq^T + gsa, de = dgate C^T (NT GEMMs), and the weight
//        gradients x^T dprojall, e^T dgate, attn^T dy as TN GEMMs split over
//        rows, the bias gradients as column sums -- every sum in a fixed
//        order, so two runs give the same bits.
#include "gemm.cuh"
#include "ggcn_core.cuh"

namespace ggps {
namespace {

constexpr int MHA_THREADS = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q/k/v of head h of graph g from projall into padded shared rows, then the
// masked scores and their row softmax into S (N x N). When Pd is non-null the
// site-0 mask is applied to the probabilities in place.
__device__ __forceinline__ void attn_probs(const float* __restrict__ proj,
                                           const float* __restrict__ nmask, float* q,
                                           float* k, float* v, float* S, int g, int h,
                                           int N, int d, int H, float scale,
                                           const Drop* dropP) {
  const int Dh = d / H;
  const int ld = Dh + 1;                // padded rows: conflict-free column reads
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
  const unsigned long long row0 = ((unsigned long long)g * H + h) * N;
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
    for (int m = lane; m < N; m += 32) {
      const float p = row[m] / sum;
      row[m] = dropP != nullptr ? drop_apply(*dropP, (row0 + n) * N + m, p) : p;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MHA_THREADS)
mha_kernel(const float* __restrict__ proj, const float* __restrict__ nmask,
           float* __restrict__ out, int N, int d, int H, float scale, Drop drop) {
  extern __shared__ float smem[];
  const int Dh = d / H;
  const int ld = Dh + 1;
  float* q = smem;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* S = v + N * ld;                // [N][N] scores, then probabilities
  const int g = blockIdx.x, h = blockIdx.y;
  attn_probs(proj, nmask, q, k, v, S, g, h, N, d, H, scale, &drop);

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

// ---- backward --------------------------------------------------------------

// gsa3 = gsa + m (gpa[c] + 2 (s_attn - ca) gpa[d + c]); dy = drop1(gsa3);
// column partials of dy.
__global__ void __launch_bounds__(COLS* ROW_WARPS)
fold_sa_kernel(const float* __restrict__ gsa, const float* __restrict__ sa,
               const float* __restrict__ nmask, const float* __restrict__ ca,
               const float* __restrict__ gpa, float* __restrict__ gsa3,
               float* __restrict__ dy, float* __restrict__ part, int R, int d,
               Drop drop) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  const int r_end = min(R, (blockIdx.y + 1) * CHUNK_ROWS);
  float acc[1] = {0.0f};
  if (c < d) {
    const float g0 = gpa[c], g1 = gpa[d + c], cc = ca[c];
    for (int r = blockIdx.y * CHUNK_ROWS + threadIdx.y; r < r_end; r += ROW_WARPS) {
      const size_t i = (size_t)r * d + c;
      const float g3 = gsa[i] + nmask[r] * (g0 + 2.0f * (sa[i] - cc) * g1);
      gsa3[i] = g3;
      const float y = drop_apply(drop, i, g3);
      dy[i] = y;
      acc[0] += y;
    }
  }
  store_col_partials<1>(acc, part, gridDim.y, d, c);
}

__global__ void __launch_bounds__(MHA_THREADS)
mha_bwd_kernel(const float* __restrict__ proj, const float* __restrict__ nmask,
               const float* __restrict__ dO, float* __restrict__ dproj, int N, int d,
               int H, float scale, Drop drop) {
  extern __shared__ float smem[];
  const int Dh = d / H;
  const int ld = Dh + 1;
  float* q = smem;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* o = v + N * ld;                // dO of this head
  float* Pm = o + N * ld;               // [N][N] probabilities before dropout
  float* dP = Pm + N * N;               // [N][N] dP, then dS
  float* rs = dP + N * N;               // [N] row sums of dP * P
  unsigned char* kp = reinterpret_cast<unsigned char*>(rs + N);  // [N][N] keep
  const int g = blockIdx.x, h = blockIdx.y;
  const size_t P7 = 7 * (size_t)d;
  const float* dob = dO + (size_t)g * N * d + h * Dh;
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int n = i / Dh, j = i % Dh;
    o[n * ld + j] = dob[(size_t)n * d + j];
  }
  attn_probs(proj, nmask, q, k, v, Pm, g, h, N, d, H, scale, nullptr);

  const bool dropping = drop.t > 0;
  const unsigned long long row0 = ((unsigned long long)g * H + h) * N;
  if (dropping)
    for (int i = threadIdx.x; i < N * N; i += blockDim.x)
      kp[i] = drop_keep(drop, row0 * N + i) ? 1 : 0;
  __syncthreads();

  float* dpg = dproj + (size_t)g * N * P7 + h * Dh;
  // dv[m, j] = sum_n drop0(P)[n, m] dO[n, j]
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int m = i / Dh, j = i % Dh;
    float acc = 0.0f;
    for (int n = 0; n < N; ++n) {
      float p = Pm[n * N + m];
      if (dropping) p = kp[n * N + m] ? p * drop.scale : 0.0f;
      acc = fmaf(p, o[n * ld + j], acc);
    }
    dpg[(size_t)m * P7 + 6 * d + j] = acc;
  }
  // dP[n, m] = drop0(sum_j dO[n, j] v[m, j])
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i % N;
    float acc = 0.0f;
    for (int j = 0; j < Dh; ++j) acc = fmaf(o[n * ld + j], v[m * ld + j], acc);
    if (dropping) acc = kp[i] ? acc * drop.scale : 0.0f;
    dP[i] = acc;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n = warp; n < N; n += blockDim.x / 32) {
    float s = 0.0f;
    for (int m = lane; m < N; m += 32) s += dP[n * N + m] * Pm[n * N + m];
    s = warp_sum(s);
    if (lane == 0) rs[n] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * N; i += blockDim.x)
    dP[i] = Pm[i] * (dP[i] - rs[i / N]);   // dS
  __syncthreads();
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int n = i / Dh, j = i % Dh;
    float aq = 0.0f, ak = 0.0f;
    for (int m = 0; m < N; ++m) {
      aq = fmaf(dP[n * N + m], k[m * ld + j], aq);
      ak = fmaf(dP[m * N + n], q[m * ld + j], ak);
    }
    dpg[(size_t)n * P7 + 4 * d + j] = aq * scale;
    dpg[(size_t)n * P7 + 5 * d + j] = ak * scale;
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" size_t gps_front_core_smem(int N) {
  return ggcn_core_smem(N);
}

extern "C" size_t gps_front_mha_smem(int N, int d, int H) {
  const size_t Dh = d / H;
  return (3 * (size_t)N * (Dh + 1) + (size_t)N * N) * sizeof(float);
}

extern "C" size_t gps_front_core_bwd_smem(int N) {
  return ggcn_core_bwd_smem(N);
}

extern "C" size_t gps_front_mha_bwd_smem(int N, int d, int H) {
  const size_t Dh = d / H;
  return (4 * (size_t)N * (Dh + 1) + 2 * (size_t)N * N + N) * sizeof(float)
         + (size_t)N * N;
}

// Scratch the caller allocates: proj (B*N, 7d), attn (B*N, d),
// part (3, B, 2d). Outputs: x_new, s_attn (B, N, d), gate (B, E, d),
// moments (3, 2d) = [x_new | gate | s_attn] partial sums. proj and attn are
// what the backward takes back.
extern "C" int gps_front_forward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* ca, const float* wnq, const float* bnq, const float* wc,
    const float* bc, const float* wo, const float* bo, float* x_new, float* gate,
    float* s_attn, float* moments, float* proj, float* attn, float* part, int B,
    int N, int E, int d, int H, float scale, unsigned int seed, int t_attn,
    float sc_attn, int t_drop, float sc_drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  Epi eb;
  eb.bias = bnq;
  if ((err = gemm_nn(x, wnq, proj, B * N, 7 * d, d, eb, st)) != cudaSuccess) return err;
  eb.bias = bc;
  if ((err = gemm_nn(e, wc, gate, B * E, d, d, eb, st)) != cudaSuccess) return err;

  const size_t part_stride = (size_t)B * 2 * d;
  const dim3 col_grid(B, cdiv(d, CORE_COLS));
  const size_t core_smem = gps_front_core_smem(N);
  if ((err = allow_smem(ggcn_core_kernel, core_smem)) != cudaSuccess) return err;
  ggcn_core_kernel<<<col_grid, CORE_COLS, core_smem, st>>>(
      proj, gate, s_loc, r_loc, emask, nmask, cx, cg, x_new, part, part + part_stride,
      N, E, d, 7 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t mha_smem = gps_front_mha_smem(N, d, H);
  if ((err = allow_smem(mha_kernel, mha_smem)) != cudaSuccess) return err;
  mha_kernel<<<dim3(B, H), MHA_THREADS, mha_smem, st>>>(
      proj, nmask, attn, N, d, H, scale, make_drop(seed, 0, t_attn, sc_attn));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Epi eo;
  eo.bias = bo;
  eo.res = x;
  eo.drop = make_drop(seed, 1, t_drop, sc_drop);
  if ((err = gemm_nn(attn, wo, s_attn, B * N, d, d, eo, st)) != cudaSuccess) return err;

  moments_kernel<<<col_grid, CORE_COLS, 0, st>>>(s_attn, nmask, ca,
                                                 part + 2 * part_stride, N, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, moments, 3, B, 2 * d, st);
}

// floats of scratch gps_front_backward needs (reused by its passes in turn)
extern "C" long long gps_front_backward_scratch(int B, int N, int E, int d) {
  const long long rn = (long long)B * N, re = (long long)B * E;
  long long s = (long long)row_chunks(rn) * 7 * d;
  const long long c[] = {(long long)row_chunks(re) * d,
                         (long long)tn_scratch(d, 7 * d, (int)rn),
                         (long long)tn_scratch(d, d, (int)re),
                         (long long)tn_scratch(d, d, (int)rn)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: the forward's operands, its kept proj (B*N, 7d) and attn (B*N, d),
// its outputs x_new, gate, s_attn, and the cotangents gx (B, N, d),
// gg (B, E, d), gsa (B, N, d), gpx/gpg/gpa (2d,) of the six outputs.
// Outputs: dx (B, N, d), de (B, E, d), dwnq (d, 7d), dbnq (7d,), dwc (d, d),
// dbc (d,), dwo (d, d), dbo (d,). Work: dproj (B*N, 7d), dgate (B*E, d),
// gsa3, dy, dO (B*N, d), scratch.
extern "C" int gps_front_backward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* ca, const float* wnq, const float* wc, const float* wo,
    const float* proj, const float* attn, const float* x_new, const float* gate,
    const float* s_attn, const float* gx, const float* gg, const float* gsa,
    const float* gpx, const float* gpg, const float* gpa, float* dx, float* de,
    float* dwnq, float* dbnq, float* dwc, float* dbc, float* dwo, float* dbo,
    float* dproj, float* dgate, float* gsa3, float* dy, float* dO, float* scratch,
    int B, int N, int E, int d, int H, float scale, unsigned int seed, int t_attn,
    float sc_attn, int t_drop, float sc_drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N, RE = B * E;
  const int chunks = row_chunks(RN);
  fold_sa_kernel<<<dim3(cdiv(d, COLS), chunks), dim3(COLS, ROW_WARPS), 0, st>>>(
      gsa, s_attn, nmask, ca, gpa, gsa3, dy, scratch, RN, d,
      make_drop(seed, 1, t_drop, sc_drop));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, dbo, 1, chunks, d, st)) != cudaSuccess) return err;
  if ((err = gemm_nt(dy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  const size_t core_smem = gps_front_core_bwd_smem(N);
  if ((err = allow_smem(ggcn_core_bwd_kernel, core_smem)) != cudaSuccess) return err;
  ggcn_core_bwd_kernel<<<dim3(B, cdiv(d, CORE_BWD_COLS)), CORE_BWD_COLS, core_smem,
                         st>>>(proj, gate, x_new, s_loc, r_loc, emask, nmask, cx, cg,
                               gx, gg, gpx, gpg, dproj, dgate, N, E, d,
                               7 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t mha_smem = gps_front_mha_bwd_smem(N, d, H);
  if ((err = allow_smem(mha_bwd_kernel, mha_smem)) != cudaSuccess) return err;
  mha_bwd_kernel<<<dim3(B, H), MHA_THREADS, mha_smem, st>>>(
      proj, nmask, dO, dproj, N, d, H, scale, make_drop(seed, 0, t_attn, sc_attn));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Epi eres;
  eres.res = gsa3;
  if ((err = gemm_nt(dproj, wnq, dx, RN, d, 7 * d, eres, st)) != cudaSuccess) return err;
  if ((err = gemm_nt(dgate, wc, de, RE, d, d, Epi(), st)) != cudaSuccess) return err;
  if ((err = gemm_tn(x, dproj, dwnq, d, 7 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  if ((err = colsum(dproj, dbnq, scratch, RN, 7 * d, st)) != cudaSuccess) return err;
  if ((err = gemm_tn(e, dgate, dwc, d, d, RE, scratch, st)) != cudaSuccess) return err;
  if ((err = colsum(dgate, dbc, scratch, RE, d, st)) != cudaSuccess) return err;
  return gemm_tn(attn, dy, dwo, d, d, RN, scratch, st);
}
