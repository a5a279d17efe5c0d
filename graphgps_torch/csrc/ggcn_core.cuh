// The GatedGCN gather/gate/aggregate middle, forward and backward, from a
// precomputed node projection: the device code shared by the merged layer
// front (gps_front.cu, projection rows [A|D|E|B|Wq|Wk|Wv], stride 7d) and the
// standalone GatedGCN core (gatedgcn.cu, rows [A|D|E|B], stride 4d). It is the
// counterpart of graphgps_tpu/ops/pallas/fused_gatedgcn.py:94 _core_from_proj
// and of the core part of its _bwd_kernel :172-236, which the TPU's merged
// kernel shares in the same way.
//
//   gate  = D x_r + E x_s + ce                        per edge, graph-local ids
//   x_new = A x + sum_e m*sig(gate)*B x_s / (sum_e m*sig(gate) + 1e-6)
//   part_x, part_g = per-graph [sum m(v-c) | sum m(v-c)^2] of x_new and gate
//
// `ld` is the row stride of the projection (and, in the backward, of its
// gradient); the columns A, D, E, B sit at offsets 0, d, 2d, 3d of a row.
// Forward: one block per (graph, 128 columns); one thread per column walks the
// graph's edges in order, gathers by index (no one-hot products: Hopper
// indexes directly) and accumulates num/den for the N receivers in shared
// memory. The thread owns its column, so there are no atomics and the order
// is fixed. Backward: one block per (graph, 64 columns); the thread folds the
// moment cotangents into the x_new and gate cotangents, recomputes num/den,
// and walks the edges twice, scattering dD by receiver and dE/dB by sender
// into shared memory (five arrays). Both are bound by bytes; d may be any
// width (the last column block is partly idle).
#pragma once

#include "common.cuh"

namespace ggps {
namespace {

constexpr int CORE_COLS = 128;      // columns (= threads) per forward core block
constexpr int CORE_BWD_COLS = 64;   // per backward core block (5 arrays in smem)

inline size_t ggcn_core_smem(int N) {
  return 2 * (size_t)N * CORE_COLS * sizeof(float);
}

inline size_t ggcn_core_bwd_smem(int N) {
  return 5 * (size_t)N * CORE_BWD_COLS * sizeof(float);
}

__global__ void __launch_bounds__(CORE_COLS)
ggcn_core_kernel(const float* __restrict__ proj, float* __restrict__ gate,
                 const int* __restrict__ s_loc, const int* __restrict__ r_loc,
                 const float* __restrict__ emask, const float* __restrict__ nmask,
                 const float* __restrict__ cx, const float* __restrict__ cg,
                 float* __restrict__ x_new, float* __restrict__ part_x,
                 float* __restrict__ part_g, int N, int E, int d, int ld) {
  extern __shared__ float smem[];
  float* num = smem;                    // [N][CORE_COLS]
  float* den = smem + N * CORE_COLS;    // [N][CORE_COLS]
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int c = blockIdx.y * CORE_COLS + t;
  if (c >= d) return;  // no block-wide barrier below: each thread owns a column
  const size_t P = (size_t)ld;
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

__global__ void __launch_bounds__(CORE_BWD_COLS)
ggcn_core_bwd_kernel(const float* __restrict__ proj, const float* __restrict__ gate,
                     const float* __restrict__ x_new, const int* __restrict__ s_loc,
                     const int* __restrict__ r_loc, const float* __restrict__ emask,
                     const float* __restrict__ nmask, const float* __restrict__ cx,
                     const float* __restrict__ cg, const float* __restrict__ gx,
                     const float* __restrict__ gg, const float* __restrict__ gpx,
                     const float* __restrict__ gpg, float* __restrict__ dproj,
                     float* __restrict__ dgate, int N, int E, int d, int ld) {
  constexpr int T = CORE_BWD_COLS;
  extern __shared__ float smem[];
  float* num = smem;          // [N][T], then dnum
  float* den = num + N * T;   // [N][T], then dden
  float* dD = den + N * T;    // receiver scatter of dgate
  float* dE = dD + N * T;     // sender scatter of dgate
  float* dB = dE + N * T;     // sender scatter of dmsgs * sig
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int c = blockIdx.y * T + t;
  if (c >= d) return;  // no block-wide barrier below: each thread owns a column
  const size_t P = (size_t)ld;
  const float* pg = proj + (size_t)g * N * P;
  float* dpg = dproj + (size_t)g * N * P;
  for (int n = 0; n < N; ++n) {
    num[n * T + t] = 0.0f;
    den[n * T + t] = 0.0f;
    dD[n * T + t] = 0.0f;
    dE[n * T + t] = 0.0f;
    dB[n * T + t] = 0.0f;
  }

  // num/den as the forward formed them, in the same order
  for (int j = 0; j < E; ++j) {
    const int s = s_loc[g * E + j];
    const int r = r_loc[g * E + j];
    if ((unsigned)r >= (unsigned)N) continue;
    const float m = emask[g * E + j];
    const float gt = gate[((size_t)g * E + j) * d + c];
    const float sig = 1.0f / (1.0f + expf(-gt));
    const float bx = (unsigned)s < (unsigned)N ? pg[(size_t)s * P + 3 * d + c] : 0.0f;
    num[r * T + t] += m * (sig * bx);
    den[r * T + t] += m * sig;
  }

  // x_new's cotangent with its moment cotangent folded in; dA = gx3
  const float gx0 = gpx[c], gx1 = gpx[d + c], cxc = cx[c];
  for (int n = 0; n < N; ++n) {
    const size_t i = ((size_t)g * N + n) * d + c;
    const float gx3 = gx[i] + nmask[g * N + n] * (gx0 + 2.0f * (x_new[i] - cxc) * gx1);
    const float inv = 1.0f / (den[n * T + t] + 1e-6f);
    const float nm = num[n * T + t];
    num[n * T + t] = gx3 * inv;
    den[n * T + t] = -(gx3 * nm) * inv * inv;
    dpg[(size_t)n * P + c] = gx3;
  }

  const float gg0 = gpg[c], gg1 = gpg[d + c], cgc = cg[c];
  for (int j = 0; j < E; ++j) {
    const int s = s_loc[g * E + j];
    const int r = r_loc[g * E + j];
    const bool s_ok = (unsigned)s < (unsigned)N;
    const bool r_ok = (unsigned)r < (unsigned)N;
    const float m = emask[g * E + j];
    const size_t i = ((size_t)g * E + j) * d + c;
    const float gt = gate[i];
    const float sig = 1.0f / (1.0f + expf(-gt));
    const float bx = s_ok ? pg[(size_t)s * P + 3 * d + c] : 0.0f;
    const float dmsgs = r_ok ? m * num[r * T + t] : 0.0f;
    const float dsig = dmsgs * bx + (r_ok ? m * den[r * T + t] : 0.0f);
    const float gg3 = gg[i] + m * (gg0 + 2.0f * (gt - cgc) * gg1);
    const float dg = dsig * sig * (1.0f - sig) + gg3;
    dgate[i] = dg;
    if (r_ok) dD[r * T + t] += dg;
    if (s_ok) {
      dE[s * T + t] += dg;
      dB[s * T + t] += dmsgs * sig;
    }
  }
  for (int n = 0; n < N; ++n) {
    float* row = dpg + (size_t)n * P + c;
    row[d] = dD[n * T + t];
    row[2 * d] = dE[n * T + t];
    row[3 * d] = dB[n * T + t];
  }
}

}  // namespace
}  // namespace ggps
