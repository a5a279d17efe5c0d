// Segmented row sums over a CSR list, forward only (the backward of both
// callers is a row gather, index_select, as on the TPU):
//
//   out[s] = sum over k in [ptr[s], ptr[s+1]) of data[row(k)]     (S, d) rows
//   row(k) = k            (CSR: edges sorted by segment)
//   row(k) = perm[k]      (tiled: a stable argsort of unsorted ids)
//
// Replaces two TPU kernels:
// - graphgps_tpu/ops/pallas/segment_csr.py:155 segment_sum_csr (forward
//   _segment_sum_csr_fwd_impl :103, pallas_call :146): receiver-sorted edges
//   and row_ptr (row_ptr_from_sorted :172), each 512-segment tile DMA-ing its
//   edge range in 1,024-row chunks and summing them with a one-hot MXU matmul;
// - graphgps_tpu/ops/pallas/segment_tiled.py:100 tiled_segment_sum (_fwd
//   :145, pallas_call :155): unsorted ids, argsort and block pointers in XLA
//   (_prep :108), the sorted rows copied into W-row tiles that each belong to
//   one NB-row output block, and one (NB, W) one-hot contraction per tile.
// The one-hot contractions and the re-tiled row copy are the TPU's way round
// its serial scatter unit; on the H100 a segment sum is a gather-reduce.
//
// Bound on the H100: bytes -- each data row read once (E*d*4), each output
// row written once (S*d*4), the pointers (S+1) and, tiled, the permutation
// (E) read once; one add per element.
//
// Design. The ids' plan (segment_plan_kernel, once per id vector and batch:
// ops/kernels/segment_sum.py SegmentPlan) holds the CSR pointers, the
// permutation (tiled), a ticket per segment and, per chunk of C = 64 edges
// of the sorted list, the segments of its first and last edges. The sum is
// one launch of warp tasks:
// - a chunk task per chunk k sums its edges of the (at most two) segments
//   of more than C edges it meets (hubs, split across warps);
// - a head task per four consecutive segments sums those of at most C edges
//   (empty ones written as zeros): a group of 8 lanes a segment when none
//   holds more than 16 edges (short segments fill the warp), else the whole
//   warp one segment after another, 4 rows at a time.
// A hub's pieces write partial rows to scratch (slot 2k or 2k + 1 of chunk
// k), each fences and takes an int ticket, and the last to arrive resets the
// ticket to 0 (so the plan serves the next call) and sums the partials in
// chunk order. Chunk tasks come first in the grid, so hubs start early.
// A lane holds VPL float4 (or float) columns of a row, 8 lanes a row: d = 96
// fills all 32 lanes with 4 rows of 3 float4 each. Each group of 8 lanes
// keeps 4 rows in flight; the permutation is read one entry a lane, a step
// ahead, and passed round by shuffles. Every add order is fixed (rows in
// groups, a butterfly over the groups, the partials in order): no float
// atomics, and two runs give the same bits. 4 rows a group in flight, not
// 8: at d = 96, 8 take ~150 registers a thread and halve the warps an SM
// holds, which the short segments of a real graph need more. C is chosen on
// the H100 with graphgps_torch/tools/segment_sweep.py.
#include <assert.h>

#include "common.cuh"

namespace ggps {
namespace {

constexpr int SEG_WARPS = 8;                 // tasks per block of 256 threads
constexpr int SEG_GROUPS = 4;                // rows a warp reads at once
constexpr int SEG_LANES = 32 / SEG_GROUPS;   // lanes on one row
constexpr int AHEAD = 4;                     // rows a group keeps in flight
constexpr int GROUP_MAX = 2 * SEG_LANES;     // edges a group sums alone
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void add_to(float& a, float x) { a += x; }
__device__ __forceinline__ void add_to(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(FULL, v, m);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int m) {
  return make_float4(__shfl_xor_sync(FULL, v.x, m), __shfl_xor_sync(FULL, v.y, m),
                     __shfl_xor_sync(FULL, v.z, m), __shfl_xor_sync(FULL, v.w, m));
}

// CG: through L2 (partials other warps wrote in this launch), else read-only
template <bool CG, typename T> __device__ __forceinline__ T load(const T* p) {
  return CG ? __ldcg(p) : __ldg(p);
}

// dst[0, n) = the sum of rows [lo, hi) of a row source, n elements (T) a row.
// Row r is src + row(r) * n, row(r) = idx[r] when IDX, else r; rows_of turns
// a row number into its base pointer. Every lane of the warp calls it with the
// same lo, hi (the shuffles need all 32).
template <typename T, int VPL, bool IDX, bool CG, typename RowsOf>
__device__ __forceinline__ void reduce_rows(RowsOf rows_of, const int* __restrict__ idx,
                                            int lo, int hi, int n, T* dst) {
  constexpr int STEP = SEG_GROUPS * AHEAD;   // rows a step, at most 32
  static_assert(STEP <= 32, "one index a lane a step");
  const int lane = threadIdx.x, g = lane / SEG_LANES, p = lane % SEG_LANES;
  for (int col0 = 0; col0 < n; col0 += SEG_LANES * VPL) {
    T acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = zero<T>();
    int nxt = 0;
    if (IDX && lo + lane < hi && lane < STEP) nxt = __ldg(idx + lo + lane);
    for (int base = lo; base < hi; base += STEP) {
      const int cur = nxt;
      if (IDX) {   // the next step's indices, in flight with this step's rows
        const int e = base + STEP + lane;
        nxt = (e < hi && lane < STEP) ? __ldg(idx + e) : 0;
      }
      T x[AHEAD][VPL];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int r = base + u * SEG_GROUPS + g;
        const int row = IDX ? __shfl_sync(FULL, cur, u * SEG_GROUPS + g) : r;
        if (r < hi) {
          const T* src = rows_of(row);
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int c = col0 + p + j * SEG_LANES;
            x[u][j] = c < n ? load<CG>(src + c) : zero<T>();
          }
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (base + u * SEG_GROUPS + g < hi) {
#pragma unroll
          for (int j = 0; j < VPL; ++j) add_to(acc[j], x[u][j]);
        }
    }
    // butterfly over the 4 groups: every group ends with the same bits
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      add_to(acc[j], shfl_xor(acc[j], SEG_LANES));
      add_to(acc[j], shfl_xor(acc[j], 2 * SEG_LANES));
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = col0 + p + j * SEG_LANES;
      if (j % SEG_GROUPS == g && c < n) dst[c] = acc[j];
    }
  }
}

// Chunk k's piece of a split segment s (edges [e0, e1), more than C): rows
// [lo, hi) summed into scratch slot 2k (s holds the chunk's first edge) or
// 2k + 1 (s starts inside the chunk). Each piece fences and takes a ticket;
// the last of the segment's pieces to arrive resets the ticket and sums the
// partial rows in chunk order into out[s].
template <typename T, int VPL, bool PERM>
__device__ __forceinline__ void sum_piece(const T* __restrict__ data,
                                          const int* __restrict__ perm,
                                          int* __restrict__ tickets, T* __restrict__ out,
                                          T* __restrict__ scratch, int s, int e0, int e1,
                                          int k, int slot, int n, int C) {
  reduce_rows<T, VPL, PERM, false>(
      [&](int row) { return data + (size_t)row * n; }, perm, max(k * C, e0),
      min(k * C + C, e1), n, scratch + (size_t)slot * n);
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(tickets + s, 1);
  ticket = __shfl_sync(FULL, ticket, 0);
  const int k0 = e0 / C;                     // the chunk of the segment's first edge
  const int pieces = (e1 - 1) / C - k0 + 1;
  if (ticket != pieces - 1) return;
  if (threadIdx.x == 0) tickets[s] = 0;
  __threadfence();
  const int first = 2 * k0 + (e0 != k0 * C);
  reduce_rows<T, VPL, false, true>(
      [&](int r) -> const T* {
        return scratch + (size_t)(r == 0 ? first : 2 * (k0 + r)) * n;
      },
      nullptr, 0, pieces, n, out + (size_t)s * n);
}

// Four short segments at once, one a group of 8 lanes: group g sums rows
// [e0, e0 + len) of its own segment (len <= GROUP_MAX; longest: the largest
// len of the four) into dst (null: no segment), its lanes on the row's
// columns.
template <typename T, int VPL, bool PERM>
__device__ __forceinline__ void group_sums(const T* __restrict__ data,
                                           const int* __restrict__ perm, int e0, int len,
                                           int longest, int n, T* dst) {
  const int lane = threadIdx.x, g = lane / SEG_LANES, p = lane % SEG_LANES;
  int i0 = 0, i1 = 0;   // the group's row indices, 8 a register
  if (PERM) {
    if (p < len) i0 = __ldg(perm + e0 + p);
    if (p + SEG_LANES < len) i1 = __ldg(perm + e0 + SEG_LANES + p);
  }
  for (int col0 = 0; col0 < n; col0 += SEG_LANES * VPL) {
    T acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = zero<T>();
    for (int base = 0; base < longest; base += AHEAD) {
      T x[AHEAD][VPL];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int r = base + u;
        const int row = PERM ? __shfl_sync(FULL, r < SEG_LANES ? i0 : i1,
                                           g * SEG_LANES + (r % SEG_LANES))
                             : e0 + r;
        if (r < len) {
          const T* src = data + (size_t)row * n;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int c = col0 + p + j * SEG_LANES;
            x[u][j] = c < n ? __ldg(src + c) : zero<T>();
          }
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (base + u < len) {
#pragma unroll
          for (int j = 0; j < VPL; ++j) add_to(acc[j], x[u][j]);
        }
    }
    if (dst != nullptr) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int c = col0 + p + j * SEG_LANES;
        if (c < n) dst[c] = acc[j];
      }
    }
  }
}

// One warp a task: tasks [0, K) are the chunk tasks, each summing its
// chunk's pieces of the (at most two) split segments it meets; then a head
// task per four consecutive segments, over those of at most C edges.
template <typename T, int VPL, bool PERM>
__global__ void __launch_bounds__(32 * SEG_WARPS)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                   const int* __restrict__ ptr, const int* __restrict__ chunk_seg,
                   int* __restrict__ tickets, T* __restrict__ out, T* __restrict__ scratch,
                   int S, int K, int n, int C) {
  const int task = blockIdx.x * SEG_WARPS + threadIdx.y;
  if (task >= K + (S + SEG_GROUPS - 1) / SEG_GROUPS) return;   // whole warps
  if (task < K) {
    for (int which = 0; which < 2; ++which) {
      const int s = chunk_seg[2 * task + which];
      if (s < 0) continue;
      const int e0 = ptr[s], e1 = ptr[s + 1];
      if (e1 - e0 > C)
        sum_piece<T, VPL, PERM>(data, perm, tickets, out, scratch, s, e0, e1, task,
                                2 * task + which, n, C);
    }
    return;
  }
  const int s0 = (task - K) * SEG_GROUPS;
  const int sg = s0 + threadIdx.x / SEG_LANES;
  const int e0 = sg < S ? ptr[sg] : 0, len = sg < S ? ptr[sg + 1] - e0 : 0;
  int longest = max(len, __shfl_xor_sync(FULL, len, SEG_LANES));
  longest = max(longest, __shfl_xor_sync(FULL, longest, 2 * SEG_LANES));
  if (longest <= GROUP_MAX && GROUP_MAX < C) {
    group_sums<T, VPL, PERM>(data, perm, e0, len, longest, n,
                             sg < S ? out + (size_t)sg * n : nullptr);
    return;
  }
  for (int s = s0; s < min(s0 + SEG_GROUPS, S); ++s) {
    const int e0 = ptr[s], e1 = ptr[s + 1];
    if (e1 - e0 <= C)
      reduce_rows<T, VPL, PERM, false>(
          [&](int row) { return data + (size_t)row * n; }, perm, e0, e1, n,
          out + (size_t)s * n);
  }
}

// The plan of one id vector. Thread i handles the boundary before sorted
// position i (i == E: the end) and writes ptr[s] = i for the segments s in
// (id(i-1), id(i)]; a run of 8 or more (empty segments) is written by the
// whole warp. It also zeroes ticket i, writes chunk i's pair of segments (of
// its first edge, and of its last where that is another) and, tiled,
// perm32[i]. The sort check (CSR) fails the launch with a device-side
// assertion: no host sync.
__global__ void __launch_bounds__(256)
segment_plan_kernel(const int* __restrict__ ids, const long long* __restrict__ perm64,
                    int* __restrict__ perm32, int* __restrict__ ptr,
                    int* __restrict__ tickets, int* __restrict__ chunk_seg, int E,
                    int S, int C, int K, int check) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  auto id_at = [&](int e) { return ids[perm64 != nullptr ? (int)perm64[e] : e]; };
  int lo = 1, hi = 0;   // ptr[lo..hi] = i
  if (i <= E) {
    const int prev = i > 0 ? id_at(i - 1) : -1;
    const int cur = i < E ? id_at(i) : S;
    if (check && i > 0 && i < E) assert(prev <= cur && "receivers must be sorted");
    lo = prev < 0 ? 0 : (prev >= S ? S + 1 : prev + 1);
    hi = cur > S ? S : cur;
  }
  const bool own = hi - lo < 8;
  if (own)
    for (int s = lo; s <= hi; ++s) ptr[s] = i;
  unsigned runs = __ballot_sync(FULL, !own);
  while (runs) {
    const int src = __ffs(runs) - 1;
    runs &= runs - 1;
    const int l = __shfl_sync(FULL, lo, src), h = __shfl_sync(FULL, hi, src);
    const int v = __shfl_sync(FULL, i, src);
    for (int s = l + lane; s <= h; s += 32) ptr[s] = v;
  }
  if (i < S) tickets[i] = 0;
  if (i < K) {   // the segments of the chunk's first and last edges
    const int a = id_at(i * C), b = id_at(min(i * C + C, E) - 1);
    chunk_seg[2 * i] = a >= 0 && a < S ? a : -1;
    chunk_seg[2 * i + 1] = b != a && b >= 0 && b < S ? b : -1;
  }
  if (perm32 != nullptr && i < E) perm32[i] = (int)perm64[i];
}

template <typename T, int VPL>
cudaError_t launch_sum(const float* data, const int* perm, const int* ptr, const int* chunk_seg,
                       int* tickets, float* out, float* scratch, int S, int K, int n, int C,
                       cudaStream_t st) {
  const dim3 block(32, SEG_WARPS);
  const dim3 grid(cdiv((long long)K + cdiv(S, SEG_GROUPS), SEG_WARPS));
  const T* d = reinterpret_cast<const T*>(data);
  T* o = reinterpret_cast<T*>(out);
  T* sc = reinterpret_cast<T*>(scratch);
  if (perm != nullptr)
    segment_sum_kernel<T, VPL, true>
        <<<grid, block, 0, st>>>(d, perm, ptr, chunk_seg, tickets, o, sc, S, K, n, C);
  else
    segment_sum_kernel<T, VPL, false>
        <<<grid, block, 0, st>>>(d, perm, ptr, chunk_seg, tickets, o, sc, S, K, n, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sum(const float* data, const int* perm, const int* ptr,
                         const int* chunk_seg, int* tickets, float* out, float* scratch,
                         int S, int K, int n, int C, cudaStream_t st) {
  // columns a lane: one pass over n when 4 x 8 lanes' worth suffices
  switch (min(4, max(1, cdiv(n, SEG_LANES)))) {
    case 1:
      return launch_sum<T, 1>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K, n, C,
                              st);
    case 2:
      return launch_sum<T, 2>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K, n, C,
                              st);
    case 3:
      return launch_sum<T, 3>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K, n, C,
                              st);
    default:
      return launch_sum<T, 4>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K, n, C,
                              st);
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// The plan of ids (E,) into S segments with tasks of at most C edges. CSR:
// perm64 and perm32 null, ids sorted (checked on the device when check != 0).
// Tiled: perm64 (E,) a stable argsort of ids, copied into perm32 (E,). Writes
// ptr (S + 1,), tickets (S,) zeroed and chunk_seg (cdiv(E, C), 2).
extern "C" int segment_plan(const int* ids, const long long* perm64, int* perm32, int* ptr,
                            int* tickets, int* chunk_seg, int E, int S, int C, int check,
                            void* stream) {
  if (S <= 0 || C <= 0) return 0;
  const int K = cdiv(E, C);
  long long threads = (long long)E + 1;
  if (S > threads) threads = S;
  if (K > threads) threads = K;
  segment_plan_kernel<<<cdiv(threads, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, perm64, perm32, ptr, tickets, chunk_seg, E, S, C, K, check);
  return cudaGetLastError();
}

// perm may be null (CSR: the rows in order). ptr, chunk_seg and tickets are
// the plan's (segment_plan with the same E, S and C); scratch holds
// 2 cdiv(E, C) rows of d (null when E == 0). vec: float4 columns, for
// d % 4 == 0 and 16-byte aligned data, out and scratch. A plan's sums run one
// at a time (its tickets): on one stream.
extern "C" int segment_sum_forward(const float* data, const int* perm, const int* ptr,
                                   const int* chunk_seg, int* tickets, float* out,
                                   float* scratch, int E, int S, int d, int C, int vec,
                                   void* stream) {
  if (S <= 0 || C <= 0) return 0;
  const int K = cdiv(E, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    return dispatch_sum<float4>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K,
                                d / 4, C, st);
  return dispatch_sum<float>(data, perm, ptr, chunk_seg, tickets, out, scratch, S, K, d, C,
                             st);
}
