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
// (E) read once; one add per element. Design: one warp per output row
// (segment), lanes across the columns (float4 where d % 4 == 0), walking the
// segment's range in order: the tiled kernel reads the data rows in place
// through the permutation (no re-tiled copy). Eight rows' loads are issued
// before their adds so a long segment keeps loads in flight, while the adds
// stay in edge order from 0.0f. Every output row, empty ones included, is
// written by its one owner: no atomics, and two runs give the same bits (the
// same bits as a sequential index_add_ in edge order). A hub segment is walked
// by one warp.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int SEG_WARPS = 8;   // segments per block of 256 threads
constexpr int SEG_AHEAD = 8;   // rows loaded before they are added

__device__ __forceinline__ void add4(float4& a, const float4 x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// VEC: float4 columns (d % 4 == 0, 16-byte aligned rows), else scalar
template <bool VEC>
__global__ void __launch_bounds__(32 * SEG_WARPS)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ perm,
                   const int* __restrict__ ptr, float* __restrict__ out, int S, int d) {
  const int s = blockIdx.x * SEG_WARPS + threadIdx.y;
  if (s >= S) return;
  const int lane = threadIdx.x;
  const int e0 = ptr[s], e1 = ptr[s + 1];
  if (VEC) {
    const int d4 = d / 4;
    const float4* src = reinterpret_cast<const float4*>(data);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)s * d);
    for (int c = lane; c < d4; c += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int e = e0;
      for (; e + SEG_AHEAD <= e1; e += SEG_AHEAD) {
        float4 x[SEG_AHEAD];
#pragma unroll
        for (int u = 0; u < SEG_AHEAD; ++u) {
          const int row = perm != nullptr ? perm[e + u] : e + u;
          x[u] = src[(size_t)row * d4 + c];
        }
#pragma unroll
        for (int u = 0; u < SEG_AHEAD; ++u) add4(acc, x[u]);
      }
      for (; e < e1; ++e) {
        const int row = perm != nullptr ? perm[e] : e;
        add4(acc, src[(size_t)row * d4 + c]);
      }
      dst[c] = acc;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      int e = e0;
      for (; e + SEG_AHEAD <= e1; e += SEG_AHEAD) {
        float x[SEG_AHEAD];
#pragma unroll
        for (int u = 0; u < SEG_AHEAD; ++u) {
          const int row = perm != nullptr ? perm[e + u] : e + u;
          x[u] = data[(size_t)row * d + c];
        }
#pragma unroll
        for (int u = 0; u < SEG_AHEAD; ++u) acc += x[u];
      }
      for (; e < e1; ++e) {
        const int row = perm != nullptr ? perm[e] : e;
        acc += data[(size_t)row * d + c];
      }
      out[(size_t)s * d + c] = acc;
    }
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// perm may be null (CSR: the rows in order). ptr has S + 1 entries. vec:
// float4 columns, for d % 4 == 0 and 16-byte aligned data and out.
extern "C" int segment_sum_forward(const float* data, const int* perm, const int* ptr,
                                   float* out, int S, int d, int vec, void* stream) {
  if (S <= 0) return 0;
  const dim3 block(32, SEG_WARPS);
  const dim3 grid((S + SEG_WARPS - 1) / SEG_WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    segment_sum_kernel<true><<<grid, block, 0, st>>>(data, perm, ptr, out, S, d);
  else
    segment_sum_kernel<false><<<grid, block, 0, st>>>(data, perm, ptr, out, S, d);
  return cudaGetLastError();
}
