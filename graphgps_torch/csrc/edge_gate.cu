// GatedGCN gather/gate/aggregate middle for LONG graphs, forward and backward,
// from projections the caller computed (the five Linears stay outside, as in
// the JAX package).
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_edge_gate.py:120
// fused_edge_gate (forward pallas_call at :145 over _fwd_kernel :61, backward
// _vjp_bwd :167 with its pallas_call at :174 over _bwd_kernel :83). It is the
// local branch of a GPS layer whose graphs have more node slots than the
// small-graph core (ggcn_core.cuh) holds in shared memory. Per call, for B
// graphs of N node slots and E edge slots each, at the true width d:
//
//   gate = pd[r] + peb[s, :d] + ce                       (B, E, d)
//   nd   = [sum_e m*sig(gate)*peb[s, d:] | sum_e m*sig(gate)] per receiver
//                                                        (B, N, 2d)
//
// with pd = D x, peb = [E x | B x], graph-local endpoints s, r and the edge
// mask m. An index outside [0, N) gathers zeros and scatters nowhere, as the
// TPU kernel's one-hot rows do. The TPU's 128-edge tiles, its groups of 8
// tiles and its one-hot matrix products are layout devices of that chip and
// are not made: Hopper gathers and scatters by index.
//
// Bound on the H100: bytes (each of pd, peb, ce read once, gate and nd written
// once, against a handful of operations per element).
//
// Design: one block per (graph, slab of 32 columns) holds the slab's num and
// den for all N receivers in shared memory, 2*N*32 floats; that bounds N at
// 900 node slots (227 KB a block). The block's 16 warps share the graph's
// edges by OWNER: an edge belongs to warp (r mod 16), an edge whose receiver
// is outside the graph to warp (j mod 16). Every warp reads the endpoints 32
// edges at a time, picks its own edges with a ballot and takes them in edge
// order; a lane is one column, so a warp's access to a row is one 128-byte
// line. All edges of one receiver are one warp's, taken in edge order: no
// atomics, a fixed summation order, and two runs give the same bits.
// Backward: sigma is recomputed from the forward's gate (kept). The same
// block makes two owner passes over the edges: by receiver for dgate (= dce)
// and dpd, then, after a block barrier, by sender for dpeb = [scatter dgate |
// scatter dmsgs*sigma], rereading the dgate it just wrote; the shared arrays
// are reused, so the bound on N is the forward's.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int EG_COLS = 32;    // columns (= lanes) per block
constexpr int EG_WARPS = 16;   // warps per block, the owners of the edges

inline size_t eg_smem(int N) { return 2 * (size_t)N * EG_COLS * sizeof(float); }

__device__ __forceinline__ float sigmoidf(float z) { return 1.0f / (1.0f + expf(-z)); }

// The next 32 edges' endpoints and masks, one per lane; `own` is the ballot
// of the edges this warp owns under `by_sender` ? sender : receiver.
struct EdgeChunk {
  int s, r;
  float m;
  unsigned own;
};

__device__ __forceinline__ EdgeChunk load_chunk(const int* __restrict__ s_loc,
                                                const int* __restrict__ r_loc,
                                                const float* __restrict__ emask,
                                                int j0, int E, int N, int warp,
                                                int lane, bool by_sender) {
  EdgeChunk ch;
  const int j = j0 + lane;
  const bool in = j < E;
  ch.s = in ? s_loc[j] : -1;
  ch.r = in ? r_loc[j] : -1;
  ch.m = in ? emask[j] : 0.0f;
  const int key = by_sender ? ch.s : ch.r;
  const bool key_ok = (unsigned)key < (unsigned)N;
  bool mine;
  if (by_sender) mine = in && key_ok && key % EG_WARPS == warp;
  else mine = in && (key_ok ? key % EG_WARPS : j % EG_WARPS) == warp;
  ch.own = __ballot_sync(0xffffffffu, mine);
  return ch;
}

__global__ void __launch_bounds__(EG_COLS* EG_WARPS)
edge_gate_kernel(const float* __restrict__ pd, const float* __restrict__ peb,
                 const float* __restrict__ ce, const int* __restrict__ s_loc,
                 const int* __restrict__ r_loc, const float* __restrict__ emask,
                 float* __restrict__ gate, float* __restrict__ nd, int N, int E, int d) {
  extern __shared__ float smem[];
  float* num = smem;                  // [N][EG_COLS]
  float* den = smem + N * EG_COLS;    // [N][EG_COLS]
  const int g = blockIdx.x;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.y * EG_COLS + lane;
  const bool c_ok = c < d;
  for (int i = warp * EG_COLS + lane; i < 2 * N * EG_COLS; i += EG_COLS * EG_WARPS)
    smem[i] = 0.0f;
  __syncthreads();

  const float* pdg = pd + (size_t)g * N * d;
  const float* pebg = peb + (size_t)g * N * 2 * d;
  const int* sg = s_loc + (size_t)g * E;
  const int* rg = r_loc + (size_t)g * E;
  const float* mg = emask + (size_t)g * E;
  for (int j0 = 0; j0 < E; j0 += 32) {
    const EdgeChunk ch = load_chunk(sg, rg, mg, j0, E, N, warp, lane, false);
    unsigned own = ch.own;
    while (own) {
      const int k = __ffs(own) - 1;
      own &= own - 1;
      const int s = __shfl_sync(0xffffffffu, ch.s, k);
      const int r = __shfl_sync(0xffffffffu, ch.r, k);
      const float m = __shfl_sync(0xffffffffu, ch.m, k);
      if (!c_ok) continue;
      const bool s_ok = (unsigned)s < (unsigned)N;
      const bool r_ok = (unsigned)r < (unsigned)N;
      const size_t i = ((size_t)g * E + j0 + k) * d + c;
      const float dr = r_ok ? pdg[(size_t)r * d + c] : 0.0f;
      const float ex = s_ok ? pebg[(size_t)s * 2 * d + c] : 0.0f;
      const float bx = s_ok ? pebg[(size_t)s * 2 * d + d + c] : 0.0f;
      const float gt = dr + ex + ce[i];
      gate[i] = gt;
      if (r_ok) {
        const float sig = sigmoidf(gt);
        num[r * EG_COLS + lane] += m * (sig * bx);
        den[r * EG_COLS + lane] += m * sig;
      }
    }
  }
  __syncthreads();
  if (!c_ok) return;
  float* ndg = nd + (size_t)g * N * 2 * d;
  for (int n = warp; n < N; n += EG_WARPS) {
    ndg[(size_t)n * 2 * d + c] = num[n * EG_COLS + lane];
    ndg[(size_t)n * 2 * d + d + c] = den[n * EG_COLS + lane];
  }
}

__global__ void __launch_bounds__(EG_COLS* EG_WARPS)
edge_gate_bwd_kernel(const float* __restrict__ peb, const float* __restrict__ gate,
                     const int* __restrict__ s_loc, const int* __restrict__ r_loc,
                     const float* __restrict__ emask, const float* __restrict__ gg,
                     const float* __restrict__ gnd, float* __restrict__ dpd,
                     float* __restrict__ dpeb, float* __restrict__ dce, int N, int E,
                     int d) {
  extern __shared__ float smem[];
  float* acc0 = smem;                 // [N][EG_COLS]: dD, then dE
  float* acc1 = smem + N * EG_COLS;   // [N][EG_COLS]: dB
  const int g = blockIdx.x;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.y * EG_COLS + lane;
  const bool c_ok = c < d;
  const int tid = warp * EG_COLS + lane;
  for (int i = tid; i < 2 * N * EG_COLS; i += EG_COLS * EG_WARPS) smem[i] = 0.0f;
  __syncthreads();

  const float* pebg = peb + (size_t)g * N * 2 * d;
  const float* gndg = gnd + (size_t)g * N * 2 * d;
  const int* sg = s_loc + (size_t)g * E;
  const int* rg = r_loc + (size_t)g * E;
  const float* mg = emask + (size_t)g * E;

  // by receiver: dgate = dsig * sig * (1 - sig) + gg, and its scatter dD
  for (int j0 = 0; j0 < E; j0 += 32) {
    const EdgeChunk ch = load_chunk(sg, rg, mg, j0, E, N, warp, lane, false);
    unsigned own = ch.own;
    while (own) {
      const int k = __ffs(own) - 1;
      own &= own - 1;
      const int s = __shfl_sync(0xffffffffu, ch.s, k);
      const int r = __shfl_sync(0xffffffffu, ch.r, k);
      const float m = __shfl_sync(0xffffffffu, ch.m, k);
      if (!c_ok) continue;
      const bool s_ok = (unsigned)s < (unsigned)N;
      const bool r_ok = (unsigned)r < (unsigned)N;
      const size_t i = ((size_t)g * E + j0 + k) * d + c;
      const float sig = sigmoidf(gate[i]);
      const float bx = s_ok ? pebg[(size_t)s * 2 * d + d + c] : 0.0f;
      const float dmsgs = r_ok ? m * gndg[(size_t)r * 2 * d + c] : 0.0f;
      const float dden = r_ok ? m * gndg[(size_t)r * 2 * d + d + c] : 0.0f;
      const float dg = (dmsgs * bx + dden) * sig * (1.0f - sig) + gg[i];
      dce[i] = dg;
      if (r_ok) acc0[r * EG_COLS + lane] += dg;
    }
  }
  __syncthreads();   // also orders this block's dce writes before its rereads
  if (c_ok) {
    float* dpdg = dpd + (size_t)g * N * d;
    for (int n = warp; n < N; n += EG_WARPS)
      dpdg[(size_t)n * d + c] = acc0[n * EG_COLS + lane];
  }
  __syncthreads();
  for (int i = tid; i < N * EG_COLS; i += EG_COLS * EG_WARPS) acc0[i] = 0.0f;
  __syncthreads();

  // by sender: dE = scatter dgate, dB = scatter dmsgs * sig
  for (int j0 = 0; j0 < E; j0 += 32) {
    const EdgeChunk ch = load_chunk(sg, rg, mg, j0, E, N, warp, lane, true);
    unsigned own = ch.own;
    while (own) {
      const int k = __ffs(own) - 1;
      own &= own - 1;
      const int s = __shfl_sync(0xffffffffu, ch.s, k);
      const int r = __shfl_sync(0xffffffffu, ch.r, k);
      const float m = __shfl_sync(0xffffffffu, ch.m, k);
      if (!c_ok) continue;
      const bool r_ok = (unsigned)r < (unsigned)N;
      const size_t i = ((size_t)g * E + j0 + k) * d + c;
      const float sig = sigmoidf(gate[i]);
      const float dmsgs = r_ok ? m * gndg[(size_t)r * 2 * d + c] : 0.0f;
      acc0[s * EG_COLS + lane] += dce[i];
      acc1[s * EG_COLS + lane] += dmsgs * sig;
    }
  }
  __syncthreads();
  if (!c_ok) return;
  float* dpebg = dpeb + (size_t)g * N * 2 * d;
  for (int n = warp; n < N; n += EG_WARPS) {
    dpebg[(size_t)n * 2 * d + c] = acc0[n * EG_COLS + lane];
    dpebg[(size_t)n * 2 * d + d + c] = acc1[n * EG_COLS + lane];
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// bytes of shared memory a block takes at N node slots per graph
extern "C" long long edge_gate_smem(int N) { return (long long)eg_smem(N); }

// Inputs pd (B, N, d), peb (B, N, 2d), ce (B, E, d), s_loc/r_loc (B, E) int32,
// emask (B, E) float. Outputs gate (B, E, d), nd (B, N, 2d).
extern "C" int edge_gate_forward(const float* pd, const float* peb, const float* ce,
                                 const int* s_loc, const int* r_loc,
                                 const float* emask, float* gate, float* nd, int B,
                                 int N, int E, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = eg_smem(N);
  cudaError_t err;
  if ((err = allow_smem(edge_gate_kernel, smem)) != cudaSuccess) return err;
  edge_gate_kernel<<<dim3(B, cdiv(d, EG_COLS)), dim3(EG_COLS, EG_WARPS), smem, st>>>(
      pd, peb, ce, s_loc, r_loc, emask, gate, nd, N, E, d);
  return cudaGetLastError();
}

// Inputs: peb, the forward's gate, the indices and mask, and the cotangents
// gg (B, E, d) of gate and gnd (B, N, 2d) of nd. Outputs dpd (B, N, d),
// dpeb (B, N, 2d), dce (B, E, d).
extern "C" int edge_gate_backward(const float* peb, const float* gate,
                                  const int* s_loc, const int* r_loc,
                                  const float* emask, const float* gg,
                                  const float* gnd, float* dpd, float* dpeb,
                                  float* dce, int B, int N, int E, int d,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = eg_smem(N);
  cudaError_t err;
  if ((err = allow_smem(edge_gate_bwd_kernel, smem)) != cudaSuccess) return err;
  edge_gate_bwd_kernel<<<dim3(B, cdiv(d, EG_COLS)), dim3(EG_COLS, EG_WARPS), smem,
                         st>>>(peb, gate, s_loc, r_loc, emask, gg, gnd, dpd, dpeb, dce,
                               N, E, d);
  return cudaGetLastError();
}
