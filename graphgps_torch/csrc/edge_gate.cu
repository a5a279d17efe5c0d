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
// Design. The batch's two edge orders (ops/kernels/edge_gate.py EdgeOrders,
// built once per batch by segment_sum.cu's plan kernel after one stable
// argsort of both orders' keys) list the B*E edges by receiver and then by
// sender, graph by graph, each with CSR offsets over the B*N node slots; an
// edge whose endpoint lies outside [0, N) sits in a sink segment after its
// order's node slots. One warp takes one
// segment and one slab of 32 columns, a lane one column: it loads the
// receiver's pd row (backward: its gnd row) once, reads the segment's edge
// numbers, other endpoints and masks 32 at a time (a lane each, passed round
// by shuffles), keeps the gathers of AHEAD edges in flight before their adds,
// and sums in registers. No shared memory: the number of node slots is not
// bounded, and many warps fit on an SM. A long segment (a hub: the loader
// puts every padded edge slot of a graph on its last node) is walked by
// cdiv(d, 32) warps at once, one per slab. Each column's terms are added in
// ascending edge order (the orders are stable), as the earlier kernel's
// owner warps added them, with the same expressions: the outputs keep its
// bits. Sink edges get their gate (forward) and dce (backward) from warps
// of their own, and are summed nowhere. Backward: sigma is recomputed from
// the forward's gate (kept). A receiver pass writes dgate (= dce) and sums
// dpd; a second launch, by sender, sums dpeb = [sum dce | sum dmsgs*sigma],
// reading the dce the first wrote. No atomics: two runs give the same bits.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int EG_WARPS = 8;    // warps (tasks) per block
constexpr int AHEAD = 8;       // edges whose gathers are in flight at once
constexpr int SINK_CHUNK = 256;   // sink edges a warp takes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float z) { return 1.0f / (1.0f + expf(-z)); }

// The edges of one segment, [lo, hi) of an order, 32 at a time: lane k holds
// edge lo + k's number j (B*E flat; the joint perm holds the sender order's
// plus jbase), its other endpoint and its mask.
struct EdgeLanes {
  int j, other;
  float m;
};

__device__ __forceinline__ EdgeLanes load_lanes(const int* __restrict__ perm,
                                                const int* __restrict__ other,
                                                const float* __restrict__ emask, int k,
                                                int hi, int jbase = 0) {
  EdgeLanes e;
  const bool in = k < hi;
  e.j = in ? __ldg(perm + k) - jbase : 0;
  e.other = in ? __ldg(other + e.j) : -1;
  e.m = in ? __ldg(emask + e.j) : 0.0f;
  return e;
}

// A warp's task: segment `seg` (a node slot; -1 for a sink chunk) over edge
// positions [lo, hi), at column c = slab * 32 + lane. Tasks [0, S * slabs)
// take the node slots, a segment's slabs side by side, the graphs' last
// slots first and the graphs interleaved (unit u: graph u % B, slot
// N - 1 - u / B): the loader puts a graph's padded edge slots on its last
// node, and that hub's warps then start in the first wave instead of
// trailing the grid; with `sinks`, the sink's chunks of SINK_CHUNK edges
// follow. False: no work.
struct Task {
  int seg, lo, hi, c;
};

__device__ __forceinline__ bool task_of(const int* __restrict__ ptr, int S, int N, int EB,
                                        int d, bool sinks, Task& t) {
  const int slabs = (d + 31) / 32;
  const int task = blockIdx.x * EG_WARPS + threadIdx.y;
  const int unit = task / slabs;
  t.c = task % slabs * 32 + threadIdx.x;
  if (unit < S) {
    const int B = S / N;
    t.seg = unit % B * N + (N - 1 - unit / B);
    t.lo = ptr[t.seg];
    t.hi = ptr[t.seg + 1];
    return true;
  }
  if (!sinks) return false;
  t.seg = -1;
  t.lo = ptr[S] + (unit - S) * SINK_CHUNK;
  t.hi = min(EB, t.lo + SINK_CHUNK);
  return t.lo < t.hi;
}

// Forward. The node slots' tasks, then the sink's.
__global__ void __launch_bounds__(32 * EG_WARPS)
edge_gate_kernel(const float* __restrict__ pd, const float* __restrict__ peb,
                 const float* __restrict__ ce, const int* __restrict__ s_loc,
                 const float* __restrict__ emask, const int* __restrict__ perm,
                 const int* __restrict__ ptr, float* __restrict__ gate,
                 float* __restrict__ nd, int N, int E, int d, int S, int EB) {
  Task t;
  if (!task_of(ptr, S, N, EB, d, true, t)) return;
  const bool sink = t.seg < 0, c_ok = t.c < d;
  const int c = t.c, g = sink ? 0 : t.seg / N;
  const float dr = !sink && c_ok ? __ldg(pd + (size_t)t.seg * d + c) : 0.0f;
  float num = 0.0f, den = 0.0f;
  for (int base = t.lo; base < t.hi; base += 32) {
    const EdgeLanes el = load_lanes(perm, s_loc, emask, base + threadIdx.x, t.hi);
    const int cnt = min(32, t.hi - base);
    for (int u0 = 0; u0 < cnt; u0 += AHEAD) {
      int js[AHEAD];
      float ms[AHEAD], ex[AHEAD], bx[AHEAD], cv[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int k = min(u0 + u, cnt - 1);
        const int j = __shfl_sync(FULL, el.j, k);
        const int s = __shfl_sync(FULL, el.other, k);
        js[u] = j;
        ms[u] = __shfl_sync(FULL, el.m, k);
        const bool s_ok = (unsigned)s < (unsigned)N;
        const int gj = sink ? j / E : g;
        const float* pebs = peb + ((size_t)gj * N + (s_ok ? s : 0)) * 2 * d;
        const bool ok = c_ok && u0 + u < cnt;
        ex[u] = ok && s_ok ? __ldg(pebs + c) : 0.0f;
        bx[u] = ok && s_ok ? __ldg(pebs + d + c) : 0.0f;
        cv[u] = ok ? __ldg(ce + (size_t)j * d + c) : 0.0f;
      }
      if (!c_ok) continue;
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (u0 + u >= cnt) break;
        const float gt = dr + ex[u] + cv[u];
        gate[(size_t)js[u] * d + c] = gt;
        if (!sink) {
          const float sig = sigmoidf(gt);
          num += ms[u] * (sig * bx[u]);
          den += ms[u] * sig;
        }
      }
    }
  }
  if (sink || !c_ok) return;
  nd[(size_t)t.seg * 2 * d + c] = num;
  nd[(size_t)t.seg * 2 * d + d + c] = den;
}

// Backward, by receiver: dgate = (dmsgs * bx + dden) * sig * (1 - sig) + gg,
// written as dce, and dpd = sum dgate. Tasks as the forward's; a sink edge's
// dmsgs and dden are 0.
__global__ void __launch_bounds__(32 * EG_WARPS)
edge_gate_bwd_recv_kernel(const float* __restrict__ peb, const float* __restrict__ gate,
                          const int* __restrict__ s_loc, const float* __restrict__ emask,
                          const int* __restrict__ perm, const int* __restrict__ ptr,
                          const float* __restrict__ gg, const float* __restrict__ gnd,
                          float* __restrict__ dpd, float* __restrict__ dce, int N, int E,
                          int d, int S, int EB) {
  Task t;
  if (!task_of(ptr, S, N, EB, d, true, t)) return;
  const bool sink = t.seg < 0, c_ok = t.c < d;
  const int c = t.c, g = sink ? 0 : t.seg / N;
  const bool own = !sink && c_ok;
  const float gnum = own ? __ldg(gnd + (size_t)t.seg * 2 * d + c) : 0.0f;
  const float gden = own ? __ldg(gnd + (size_t)t.seg * 2 * d + d + c) : 0.0f;
  float acc = 0.0f;
  for (int base = t.lo; base < t.hi; base += 32) {
    const EdgeLanes el = load_lanes(perm, s_loc, emask, base + threadIdx.x, t.hi);
    const int cnt = min(32, t.hi - base);
    for (int u0 = 0; u0 < cnt; u0 += AHEAD) {
      int js[AHEAD];
      float ms[AHEAD], gt[AHEAD], bx[AHEAD], gv[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int k = min(u0 + u, cnt - 1);
        const int j = __shfl_sync(FULL, el.j, k);
        const int s = __shfl_sync(FULL, el.other, k);
        js[u] = j;
        ms[u] = __shfl_sync(FULL, el.m, k);
        const bool s_ok = (unsigned)s < (unsigned)N;
        const int gj = sink ? j / E : g;
        const float* pebs = peb + ((size_t)gj * N + (s_ok ? s : 0)) * 2 * d;
        const bool ok = c_ok && u0 + u < cnt;
        gt[u] = ok ? __ldg(gate + (size_t)j * d + c) : 0.0f;
        bx[u] = ok && s_ok ? __ldg(pebs + d + c) : 0.0f;
        gv[u] = ok ? __ldg(gg + (size_t)j * d + c) : 0.0f;
      }
      if (!c_ok) continue;
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (u0 + u >= cnt) break;
        const float sig = sigmoidf(gt[u]);
        const float dmsgs = sink ? 0.0f : ms[u] * gnum;
        const float dden = sink ? 0.0f : ms[u] * gden;
        const float dg = (dmsgs * bx[u] + dden) * sig * (1.0f - sig) + gv[u];
        dce[(size_t)js[u] * d + c] = dg;
        acc += dg;
      }
    }
  }
  if (own) dpd[(size_t)t.seg * d + c] = acc;
}

// Backward, by sender: dpeb[s] = [sum dce | sum dmsgs * sig] over the edges
// sent by s, dmsgs = m * gnd[r, :d] (0 where r is outside [0, N)). Node-slot
// tasks only: the sender order's sink is summed nowhere. ptr: the sender
// order's offsets, positions in the joint perm, whose entries are the edge
// numbers plus EB.
__global__ void __launch_bounds__(32 * EG_WARPS)
edge_gate_bwd_send_kernel(const float* __restrict__ gate, const int* __restrict__ r_loc,
                          const float* __restrict__ emask, const int* __restrict__ perm,
                          const int* __restrict__ ptr, const float* __restrict__ gnd,
                          const float* __restrict__ dce, float* __restrict__ dpeb, int N,
                          int d, int S, int EB) {
  Task t;
  if (!task_of(ptr, S, N, EB, d, false, t)) return;
  const bool c_ok = t.c < d;
  const int c = t.c, g = t.seg / N;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int base = t.lo; base < t.hi; base += 32) {
    const EdgeLanes el = load_lanes(perm, r_loc, emask, base + threadIdx.x, t.hi, EB);
    const int cnt = min(32, t.hi - base);
    for (int u0 = 0; u0 < cnt; u0 += AHEAD) {
      float ms[AHEAD], gt[AHEAD], gn[AHEAD], dv[AHEAD];
      bool r_oks[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int k = min(u0 + u, cnt - 1);
        const int j = __shfl_sync(FULL, el.j, k);
        const int r = __shfl_sync(FULL, el.other, k);
        ms[u] = __shfl_sync(FULL, el.m, k);
        const bool r_ok = (unsigned)r < (unsigned)N;
        r_oks[u] = r_ok;
        const float* gndr = gnd + ((size_t)g * N + (r_ok ? r : 0)) * 2 * d;
        const bool ok = c_ok && u0 + u < cnt;
        gt[u] = ok ? __ldg(gate + (size_t)j * d + c) : 0.0f;
        gn[u] = ok && r_ok ? __ldg(gndr + c) : 0.0f;
        dv[u] = ok ? __ldg(dce + (size_t)j * d + c) : 0.0f;
      }
      if (!c_ok) continue;
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (u0 + u >= cnt) break;
        const float sig = sigmoidf(gt[u]);
        const float dmsgs = r_oks[u] ? ms[u] * gn[u] : 0.0f;
        acc0 += dv[u];
        acc1 += dmsgs * sig;
      }
    }
  }
  if (!c_ok) return;
  dpeb[(size_t)t.seg * 2 * d + c] = acc0;
  dpeb[(size_t)t.seg * 2 * d + d + c] = acc1;
}

// warps: a task per (node slot, slab), then with `sinks` per (sink chunk, slab)
inline int eg_blocks(int S, int EB, int d, bool sinks) {
  const long long units = (long long)S + (sinks ? cdiv(EB, SINK_CHUNK) : 0);
  return cdiv(units * cdiv(d, 32), EG_WARPS);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Inputs pd (B, N, d), peb (B, N, 2d), ce (B, E, d), s_loc (B, E) int32,
// emask (B, E) float, and the orders: perm (2 B*E,) int32, the edges by
// g*N + r_loc (stable; out-of-range receivers last), then by g*N + s_loc
// (their numbers plus B*E), and ptr (B*N + 1,) the receiver order's CSR
// offsets (ptr[B*N]: the first sink edge). Outputs gate (B, E, d),
// nd (B, N, 2d).
extern "C" int edge_gate_forward(const float* pd, const float* peb, const float* ce,
                                 const int* s_loc, const float* emask, const int* perm,
                                 const int* ptr, float* gate, float* nd, int B, int N,
                                 int E, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = B * N, EB = B * E;
  if (S <= 0 || d <= 0) return 0;
  edge_gate_kernel<<<eg_blocks(S, EB, d, true), dim3(32, EG_WARPS), 0, st>>>(
      pd, peb, ce, s_loc, emask, perm, ptr, gate, nd, N, E, d, S, EB);
  return cudaGetLastError();
}

// Inputs: peb, the forward's gate, s_loc, r_loc, emask, the orders (perm
// and recv_ptr as the forward's; send_ptr (B*N + 1,) the sender order's
// offsets, positions in perm) and the cotangents gg (B, E, d) of gate and
// gnd (B, N, 2d) of nd.
// Outputs dpd (B, N, d), dpeb (B, N, 2d), dce (B, E, d). Two launches: the
// sender pass reads the dce the receiver pass wrote.
extern "C" int edge_gate_backward(const float* peb, const float* gate, const int* s_loc,
                                  const int* r_loc, const float* emask,
                                  const int* perm, const int* recv_ptr,
                                  const int* send_ptr,
                                  const float* gg, const float* gnd, float* dpd,
                                  float* dpeb, float* dce, int B, int N, int E, int d,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = B * N, EB = B * E;
  if (S <= 0 || d <= 0) return 0;
  const dim3 block(32, EG_WARPS);
  edge_gate_bwd_recv_kernel<<<eg_blocks(S, EB, d, true), block, 0, st>>>(
      peb, gate, s_loc, emask, perm, recv_ptr, gg, gnd, dpd, dce, N, E, d, S, EB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_gate_bwd_send_kernel<<<eg_blocks(S, EB, d, false), block, 0, st>>>(
      gate, r_loc, emask, perm, send_ptr, gnd, dce, dpeb, N, d, S, EB);
  return cudaGetLastError();
}
