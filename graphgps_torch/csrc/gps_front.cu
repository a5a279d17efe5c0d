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
// 2*B*E*d*d operations, backward about twice that), so the call is bound
// by operations, run in 3xTF32 on the tensor cores (165 TFLOP/s); the
// gather/aggregate stages are bound by bytes. Forward, in launches on the
// caller's stream:
//   1-2. the projections on the tensor-core GEMM (gemm_tc.cuh); ce is
//        written straight into the gate output and overwritten in place;
//   3.   ggcn_core_kernel (ggcn_core.cuh, shared with gatedgcn.cu; row stride
//        7d here): one block per (graph, 128 columns), one thread per
//        column walks the graph's edges in order, gathers D x_r, E x_s, B x_s
//        by index (no one-hot matmuls: Hopper indexes directly), forms gate and
//        sigma, and accumulates num/den for the N receivers in shared memory
//        (the thread owns its column, so no atomics and a fixed order);
//   4.   the attention forward, the KMASK mode of the tensor-core body
//        (attn_tc.cuh, shared with gps_attention.cu), read straight out of
//        projall at row stride 7d and q/k/v offsets 4d, 5d, 6d (N <= 128):
//        masked keys at -1e30, so a graph with no real node still gives
//        finite, uniform weights; it writes the row maxima and sums;
//   5.   the out-projection on the GEMM, dropout and the residual x in its
//        epilogue;
//   6.   per-graph moment partials, then a second pass that sums them over the
//        graphs in a fixed order (the TPU summed across its sequential grid;
//        Hopper blocks run in any order, and float atomics would make the sum
//        order change from run to run).
// Backward: the forward's projall, attn and the softmax's row statistics are
// kept (73 + 10 MB a layer at the main shapes; the TPU recomputed them in
// VMEM, here recomputing would cost the forward's largest product again),
// and so are its outputs; P and the core's sigma/num/den are recomputed from
// them (cheap, per block).
//   1.   fold_sa_kernel: s_attn's moment cotangent folded into its row
//        cotangent (d/dv sum m(v-c) = m, d/dv sum m(v-c)^2 = 2m(v-c)), the
//        site-1 mask replayed, with dbo's column partials;
//   2.   dO = dy Wo^T (NT GEMM);
//   3.   ggcn_core_bwd_kernel (ggcn_core.cuh): one block per (graph, 64
//        columns), one thread
//        per column folds x_new's and gate's moment cotangents, recomputes
//        num/den, and walks the edges in order twice, scattering dD by
//        receiver and dE/dB by sender into shared memory (no atomics);
//   4.   the body's dq pass (P from the kept statistics, the site-0 mask
//        replayed on dP, D = dO . attn per row) and its dk/dv pass write dq,
//        dk, dv into dprojall's last 3d columns;
//   5.   dx = dprojall Wnq^T + gsa, de = dgate C^T (NT GEMMs), and the weight
//        gradients x^T dprojall, e^T dgate, attn^T dy as TN GEMMs split over
//        rows, the bias gradients as column sums -- every sum in a fixed
//        order, so two runs give the same bits.
#include "attn_tc.cuh"
#include "gemm_tc.cuh"
#include "ggcn_core.cuh"

namespace ggps {
namespace {

// ops/kernels/gps_front.py MAX_HEAD_DIM: the body's widest padded head
constexpr int FRONT_MAX_DH = 128;

// The attention's views of the joint (B*N, 7d) projection: q, k, v at
// columns 4d, 5d, 6d
tc::Params front_params(const float* proj, const float* nmask, int N, int d, int H,
                        float scale, unsigned int seed, int t_attn, float sc_attn) {
  const int Dh = d / H;
  const long long P7 = 7LL * d;
  tc::Params pr = {};
  pr.q = tc::view(proj + 4 * d, N * P7, Dh, 7 * d);
  pr.k = tc::view(proj + 5 * d, N * P7, Dh, 7 * d);
  pr.v = tc::view(proj + 6 * d, N * P7, Dh, 7 * d);
  pr.kmask = nmask;
  pr.N = N;
  pr.H = H;
  pr.Dh = Dh;
  pr.scale = scale;
  pr.drop = make_drop(seed, 0, t_attn, sc_attn);
  return pr;
}

tc::View rows_d(const float* p, int N, int d, int Dh) {
  return tc::view(p, (long long)N * d, Dh, d);
}

bool in_envelope(int N, int d, int H) {
  return H > 0 && d % H == 0 && d / H <= FRONT_MAX_DH && N <= 128;
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
  store_col_partials<1>(acc, part, blockIdx.y, d, 0, d, c);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" size_t gps_front_core_smem(int N) {
  return ggcn_core_smem(N);
}

extern "C" size_t gps_front_core_bwd_smem(int N) {
  return ggcn_core_bwd_smem(N);
}

// Scratch the caller allocates: proj (B*N, 7d), attn (B*N, d), Mrow and
// Lrow (B*H*N), part (3, B, 2d). Outputs: x_new, s_attn (B, N, d), gate
// (B, E, d), moments (3, 2d) = [x_new | gate | s_attn] partial sums. proj,
// attn, Mrow and Lrow are what the backward takes back.
extern "C" int gps_front_forward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* ca, const float* wnq, const float* bnq, const float* wc,
    const float* bc, const float* wo, const float* bo, float* x_new, float* gate,
    float* s_attn, float* moments, float* proj, float* attn, float* Mrow, float* Lrow,
    float* part, int B, int N, int E, int d, int H, float scale, unsigned int seed,
    int t_attn, float sc_attn, int t_drop, float sc_drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_envelope(N, d, H)) return cudaErrorInvalidValue;
  Epi eb;
  eb.bias = bnq;
  if ((err = tc::gemm_nn(x, wnq, proj, B * N, 7 * d, d, eb, st)) != cudaSuccess) return err;
  eb.bias = bc;
  if ((err = tc::gemm_nn(e, wc, gate, B * E, d, d, eb, st)) != cudaSuccess) return err;

  const size_t part_stride = (size_t)B * 2 * d;
  const dim3 col_grid(B, cdiv(d, CORE_COLS));
  const size_t core_smem = gps_front_core_smem(N);
  if ((err = allow_smem(ggcn_core_kernel, core_smem)) != cudaSuccess) return err;
  ggcn_core_kernel<<<col_grid, CORE_COLS, core_smem, st>>>(
      proj, gate, s_loc, r_loc, emask, nmask, cx, cg, x_new, part, part + part_stride,
      N, E, d, 7 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  tc::Params pr = front_params(proj, nmask, N, d, H, scale, seed, t_attn, sc_attn);
  pr.o = rows_d(attn, N, d, pr.Dh);
  pr.mrow = Mrow;
  pr.lrow = Lrow;
  pr.vec4 = tc::rows_vec4(pr.k, pr.Dh) && tc::rows_vec4(pr.v, pr.Dh);
  if ((err = tc::launch<tc::KMASK, false, FRONT_MAX_DH>(pr, B, st)) != cudaSuccess)
    return err;

  Epi eo;
  eo.bias = bo;
  eo.res = x;
  eo.drop = make_drop(seed, 1, t_drop, sc_drop);
  if ((err = tc::gemm_nn(attn, wo, s_attn, B * N, d, d, eo, st)) != cudaSuccess) return err;

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
                         (long long)tc::tn_scratch(d, 7 * d, (int)rn),
                         (long long)tc::tn_scratch(d, d, (int)re),
                         (long long)tc::tn_scratch(d, d, (int)rn)};
  for (long long v : c) s = v > s ? v : s;
  return s;
}

// Inputs: the forward's operands, its kept proj (B*N, 7d), attn (B*N, d),
// Mrow and Lrow (B*H*N), its outputs x_new, gate, s_attn, and the
// cotangents gx (B, N, d), gg (B, E, d), gsa (B, N, d), gpx/gpg/gpa (2d,) of
// the six outputs. Outputs: dx (B, N, d), de (B, E, d), dwnq (d, 7d), dbnq
// (7d,), dwc (d, d), dbc (d,), dwo (d, d), dbo (d,). Work: dproj (B*N, 7d),
// dgate (B*E, d), gsa3, dy, dO (B*N, d), Drow (B*H*N), scratch.
extern "C" int gps_front_backward(
    const float* x, const float* e, const int* s_loc, const int* r_loc,
    const float* emask, const float* nmask, const float* cx, const float* cg,
    const float* ca, const float* wnq, const float* wc, const float* wo,
    const float* proj, const float* attn, const float* Mrow, const float* Lrow,
    const float* x_new, const float* gate,
    const float* s_attn, const float* gx, const float* gg, const float* gsa,
    const float* gpx, const float* gpg, const float* gpa, float* dx, float* de,
    float* dwnq, float* dbnq, float* dwc, float* dbc, float* dwo, float* dbo,
    float* dproj, float* dgate, float* gsa3, float* dy, float* dO, float* Drow,
    float* scratch, int B, int N, int E, int d, int H, float scale, unsigned int seed,
    int t_attn, float sc_attn, int t_drop, float sc_drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int RN = B * N, RE = B * E;
  if (!in_envelope(N, d, H)) return cudaErrorInvalidValue;
  const int chunks = row_chunks(RN);
  fold_sa_kernel<<<dim3(cdiv(d, COLS), chunks), dim3(COLS, ROW_WARPS), 0, st>>>(
      gsa, s_attn, nmask, ca, gpa, gsa3, dy, scratch, RN, d,
      make_drop(seed, 1, t_drop, sc_drop));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(scratch, dbo, 1, chunks, d, st)) != cudaSuccess) return err;
  if ((err = tc::gemm_nt(dy, wo, dO, RN, d, d, Epi(), st)) != cudaSuccess) return err;

  const size_t core_smem = gps_front_core_bwd_smem(N);
  if ((err = allow_smem(ggcn_core_bwd_kernel, core_smem)) != cudaSuccess) return err;
  ggcn_core_bwd_kernel<<<dim3(B, cdiv(d, CORE_BWD_COLS)), CORE_BWD_COLS, core_smem,
                         st>>>(proj, gate, x_new, s_loc, r_loc, emask, nmask, cx, cg,
                               gx, gg, gpx, gpg, dproj, dgate, N, E, d,
                               7 * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  tc::Params pr = front_params(proj, nmask, N, d, H, scale, seed, t_attn, sc_attn);
  const int Dh = pr.Dh;
  pr.o = rows_d(attn, N, d, Dh);
  pr.dO = rows_d(dO, N, d, Dh);
  pr.mrow = const_cast<float*>(Mrow);
  pr.lrow = const_cast<float*>(Lrow);
  pr.drow = Drow;
  const long long P7 = 7LL * d;
  pr.dq = tc::view(dproj + 4 * d, N * P7, Dh, 7 * d);
  pr.dk = tc::view(dproj + 5 * d, N * P7, Dh, 7 * d);
  pr.dv = tc::view(dproj + 6 * d, N * P7, Dh, 7 * d);
  pr.vec4 = tc::rows_vec4(pr.q, Dh) && tc::rows_vec4(pr.k, Dh) && tc::rows_vec4(pr.v, Dh) &&
            tc::rows_vec4(pr.dO, Dh);
  if ((err = tc::launch<tc::KMASK, true, FRONT_MAX_DH>(pr, B, st)) != cudaSuccess)
    return err;

  Epi eres;
  eres.res = gsa3;
  if ((err = tc::gemm_nt(dproj, wnq, dx, RN, d, 7 * d, eres, st)) != cudaSuccess)
    return err;
  if ((err = tc::gemm_nt(dgate, wc, de, RE, d, d, Epi(), st)) != cudaSuccess) return err;
  if ((err = tc::gemm_tn(x, dproj, dwnq, d, 7 * d, RN, scratch, st)) != cudaSuccess)
    return err;
  if ((err = colsum(dproj, dbnq, scratch, RN, 7 * d, st)) != cudaSuccess) return err;
  if ((err = tc::gemm_tn(e, dgate, dwc, d, d, RE, scratch, st)) != cudaSuccess) return err;
  if ((err = colsum(dgate, dbc, scratch, RE, d, st)) != cudaSuccess) return err;
  return tc::gemm_tn(attn, dy, dwo, d, d, RN, scratch, st);
}
