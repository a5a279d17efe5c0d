// Residual add of a dropped branch, forward and backward:
//
//   out = x_in + drop(v)                                (R, d) rows
//   dv  = drop(g)  (the same mask),  dx_in = g
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:270
// fused_drop_add (forward pallas_call at :280 over _da_fwd_kernel :256,
// backward _da_vjp_bwd :298 with its pallas_call at :304 over _da_bwd_kernel
// :263). On the unmerged GPS layer it is the attention branch's
// h_in + drop(attn out-projection), R = B*N. Dropout is site 0 of the (R, d)
// view (common.cuh); the backward replays the forward's mask from the seed,
// so nothing is stored. The rate must be above 0, as on the TPU: callers use
// a plain add at rate 0.
//
// Bound on the H100: bytes (forward two (R, d) reads and one write, backward
// one read and one write) against one hash per element. Design: one pass
// over the flat (R*d) view each way, which is also the hash's counter, so no
// column is needed. Where every pointer is 16-byte aligned a thread moves
// float4s, U of them in flight (U = 4 where that still gives 2 blocks an SM,
// else 1), and the view's last total % 4 elements take a scalar tail; a
// misaligned view runs the same kernel on floats. Views below 2^31 elements
// take 32-bit indices and the launch's precomputed high word of the hash
// (common.cuh drop_apply_lo); larger ones 64-bit indices and the full hash.
// dx_in is the incoming cotangent itself and is not touched here.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int THREADS = 256;

// out = (RES ? x + : ) drop(v) over elements [0, total): U vectors of V
// floats a thread, vector j at thread j % THREADS of its block's U rounds.
template <typename I, int V, int U, bool RES>
__global__ void __launch_bounds__(THREADS)
drop_add_kernel(const float* __restrict__ x, const float* __restrict__ v,
                float* __restrict__ out, I total, Drop dp) {
  dp = resolved(dp);  // the seed read once a thread
  const uint32_t hi = drop_hi(dp);
  using T = typename VecOf<V>::type;
  const I n = total / V;
  const T* xv = reinterpret_cast<const T*>(x);
  const T* vv = reinterpret_cast<const T*>(v);
  T* ov = reinterpret_cast<T*>(out);
  const I j0 = (I)blockIdx.x * (U * THREADS) + threadIdx.x;
  T a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I j = j0 + (I)(u * THREADS);
    if (j < n) {
      if (RES) a[u] = xv[j];
      b[u] = vv[j];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I j = j0 + (I)(u * THREADS);
    if (j < n) {
      T o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const I e = (I)V * j + (I)k;
        if (RES)
          set_elem(o, k, elem(a[u], k) + drop_at(dp, hi, e, elem(b[u], k)));
        else
          set_elem(o, k, drop_at(dp, hi, e, elem(b[u], k)));
      }
      ov[j] = o;
    }
  }
  if (V > 1 && blockIdx.x == 0 && (I)threadIdx.x < total - n * V) {
    const I e = n * V + threadIdx.x;
    out[e] = RES ? x[e] + drop_at(dp, hi, e, v[e]) : drop_at(dp, hi, e, v[e]);
  }
}

template <typename I, int V, int U, bool RES>
cudaError_t launch(const float* x, const float* v, float* out, long long total,
                   const Drop& dp, cudaStream_t st) {
  const long long n = total / V;
  const int blocks = cdiv(n > 0 ? n : 1, (long long)U * THREADS);
  drop_add_kernel<I, V, U, RES><<<blocks, THREADS, 0, st>>>(x, v, out, (I)total,
                                                            dp);
  return cudaGetLastError();
}

template <typename I, bool RES>
cudaError_t launch_view(const float* x, const float* v, float* out,
                        long long total, const Drop& dp, cudaStream_t st) {
  const bool vec = (!RES || aligned16(x)) && aligned16(v) && aligned16(out);
  const long long n = vec ? total / 4 : total;
  // 4 vectors a thread where that still leaves 2 blocks an SM
  const bool deep = cdiv(n, 4LL * THREADS) >= 2 * 132;
  if (vec)
    return deep ? launch<I, 4, 4, RES>(x, v, out, total, dp, st)
                : launch<I, 4, 1, RES>(x, v, out, total, dp, st);
  return deep ? launch<I, 1, 4, RES>(x, v, out, total, dp, st)
              : launch<I, 1, 1, RES>(x, v, out, total, dp, st);
}

template <bool RES>
cudaError_t drop_add_pass(const float* x, const float* v, float* out,
                          long long total, const Drop& dp, cudaStream_t st) {
  if (total <= 0) return cudaSuccess;
  if (total < NARROW_VIEW)
    return launch_view<uint32_t, RES>(x, v, out, total, dp, st);
  return launch_view<unsigned long long, RES>(x, v, out, total, dp, st);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int drop_add_forward(const float* x, const float* v, float* out,
                                long long total, const unsigned int* seed, int t, float scale,
                                void* stream) {
  return drop_add_pass<true>(x, v, out, total, make_drop(seed, 0, t, scale),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int drop_add_backward(const float* g, float* dv, long long total,
                                 const unsigned int* seed, int t, float scale, void* stream) {
  return drop_add_pass<false>(nullptr, g, dv, total, make_drop(seed, 0, t, scale),
                              static_cast<cudaStream_t>(stream));
}
