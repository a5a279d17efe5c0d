// Edge tail of the GatedGCN layer, forward and backward:
//
//   out = x_in + drop(act(gamma * (v - mu) * inv + beta))      (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:189
// fused_pre_tail (forward pallas_call at :200 over _pre_fwd_kernel :130,
// backward _pre_vjp_bwd :220 with its pallas_call at :226 over
// _pre_bwd_kernel :143). On the main path it is the edge tail
// e_in + drop(act(bn(gate))) with R = B*E. Dropout is site 0 of the (R, d)
// view (common.cuh); the backward replays the forward's mask from the seed.
//
// Bound on the H100: bytes (forward: two (R, d) reads and one write; backward:
// two reads and one write) against a handful of operations per element, so
// the design keeps the integer work an element small and many bytes in
// flight.
//
// Forward: one pass over the flat (R*d) view, as drop_add.cu's: float4s
// where every pointer is 16-byte aligned (U = 4 of them a thread in flight
// where that still gives 2 blocks an SM), a scalar tail for the last
// total % 4 elements, floats where a pointer is misaligned or d < 4. A
// thread takes its first vector's column with one 32-bit division and
// carries it across its vectors (the step between them, (V * THREADS) % d,
// comes from the host); where d % 4 == 0 and the (d,) vectors are aligned,
// a float4 lies in one row and its four norm parameters are float4 loads.
// Views below 2^31 elements take 32-bit indices and the launch's
// precomputed high word of the hash (common.cuh drop_apply_lo).
//
// Backward: one launch, deterministic, no float atomics. Blocks own a slab
// of 32 columns of a chunk of rows (grid: slabs x chunks, chunks sized so the
// grid holds about BWD_BLOCKS blocks, 192 at ogbg-molhiv's 3,072 x 64); a
// thread holds 4 columns (float4, where d % 4 == 0 and every pointer is
// aligned) or 1, walks its rows in order with RU rows' loads in flight and
// writes dv. Its four column sums (dmu, dinv, dgamma, dbeta) are added over
// the block's row lanes in a fixed order (shuffles within a warp, then the
// warps in order) into a partial row of the chunk; each block then fences
// and takes an integer ticket of its slab, and the slab's last block adds the
// chunks' partials in chunk order (8 runs of consecutive chunks, 8 loads in
// flight, then the runs in order), writes its columns of dvec and resets the
// ticket to 0, so a call needs no memset and a captured launch replays. dx_in
// is the incoming cotangent itself and is not touched here. Each element's
// arithmetic is the parent's, so out and dv keep its bits.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int THREADS = 256;
constexpr int SLAB = 32;             // columns a backward block owns
constexpr int CHUNK_QUANTUM = 32;    // a backward chunk is a multiple of this many rows
constexpr int BWD_BLOCKS = 4 * 132;  // the backward grid's aim: 4 an SM
constexpr int RU = 4;                // rows a backward thread has in flight
constexpr int SUMS = 4;              // dmu, dinv, dgamma, dbeta

// ---------------------------------------------------------------------------
// forward

// V floats a vector, U vectors a thread; Q: V = 4 and a vector's four norm
// parameters are one aligned float4 (d % 4 == 0).
template <typename I, int V, int U, bool Q>
__global__ void __launch_bounds__(THREADS)
pre_tail_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ mu, const float* __restrict__ inv,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                float* __restrict__ out, I total, int d, int step, int act,
                Drop dp) {
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
      a[u] = xv[j];
      b[u] = vv[j];
    }
  }
  int c = (int)(((I)V * j0) % (I)d);  // the first vector's first column
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I j = j0 + (I)(u * THREADS);
    if (j < n) {
      T o;
      if (Q) {
        const float4 m = *reinterpret_cast<const float4*>(mu + c);
        const float4 iv = *reinterpret_cast<const float4*>(inv + c);
        const float4 ga = *reinterpret_cast<const float4*>(gamma + c);
        const float4 be = *reinterpret_cast<const float4*>(beta + c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float z = (elem(b[u], k) - elem(m, k)) * elem(iv, k) * elem(ga, k)
                          + elem(be, k);
          set_elem(o, k, elem(a[u], k)
                             + drop_at(dp, hi, (I)V * j + (I)k, apply_act(z, act)));
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int ck = c + k < d ? c + k : c + k - d;  // d >= V
          const float z = (elem(b[u], k) - mu[ck]) * inv[ck] * gamma[ck] + beta[ck];
          set_elem(o, k, elem(a[u], k)
                             + drop_at(dp, hi, (I)V * j + (I)k, apply_act(z, act)));
        }
      }
      ov[j] = o;
    }
    c += step;
    if (c >= d) c -= d;
  }
  if (V > 1 && blockIdx.x == 0 && (I)threadIdx.x < total - n * V) {
    const I e = n * V + threadIdx.x;
    const int ce = (int)(e % (I)d);
    const float z = (v[e] - mu[ce]) * inv[ce] * gamma[ce] + beta[ce];
    out[e] = x[e] + drop_at(dp, hi, e, apply_act(z, act));
  }
}

template <typename I, int V, int U, bool Q>
cudaError_t launch_fwd(const float* x, const float* v, const float* mu,
                       const float* inv, const float* gamma, const float* beta,
                       float* out, long long total, int d, int act, const Drop& dp,
                       cudaStream_t st) {
  const long long n = total / V;
  const int blocks = cdiv(n > 0 ? n : 1, (long long)U * THREADS);
  pre_tail_kernel<I, V, U, Q><<<blocks, THREADS, 0, st>>>(
      x, v, mu, inv, gamma, beta, out, (I)total, d, (V * THREADS) % d, act, dp);
  return cudaGetLastError();
}

template <typename I, int U>
cudaError_t fwd_view(const float* x, const float* v, const float* mu,
                     const float* inv, const float* gamma, const float* beta,
                     float* out, long long total, int d, int act, const Drop& dp,
                     cudaStream_t st) {
  const bool vec = d >= 4 && aligned16(x) && aligned16(v) && aligned16(out);
  const bool quad = vec && d % 4 == 0 && aligned16(mu) && aligned16(inv)
                    && aligned16(gamma) && aligned16(beta);
  if (quad)
    return launch_fwd<I, 4, U, true>(x, v, mu, inv, gamma, beta, out, total, d,
                                     act, dp, st);
  if (vec)
    return launch_fwd<I, 4, U, false>(x, v, mu, inv, gamma, beta, out, total, d,
                                      act, dp, st);
  return launch_fwd<I, 1, U, false>(x, v, mu, inv, gamma, beta, out, total, d,
                                    act, dp, st);
}

template <typename I>
cudaError_t fwd_pass(const float* x, const float* v, const float* mu,
                     const float* inv, const float* gamma, const float* beta,
                     float* out, long long total, int d, int act, const Drop& dp,
                     cudaStream_t st) {
  // 4 vectors a thread where that still leaves 2 blocks an SM
  if (cdiv(total / 4, 4LL * THREADS) >= 2 * 132)
    return fwd_view<I, 4>(x, v, mu, inv, gamma, beta, out, total, d, act, dp, st);
  return fwd_view<I, 1>(x, v, mu, inv, gamma, beta, out, total, d, act, dp, st);
}

// ---------------------------------------------------------------------------
// backward

// rows of a chunk, and chunks, of an (R, d) backward: about BWD_BLOCKS
// blocks over cdiv(d, SLAB) slabs
inline int bwd_chunk_rows(long long R, int d) {
  const int want = cdiv(BWD_BLOCKS, cdiv(d, SLAB));
  const long long per = cdiv(R > 0 ? R : 1, (long long)want * CHUNK_QUANTUM);
  return (int)(per > 0 ? per : 1) * CHUNK_QUANTUM;
}

inline int bwd_chunks(long long R, int d) {
  return cdiv(R > 0 ? R : 1, bwd_chunk_rows(R, d));
}

// W columns a thread (4: one float4, d % 4 == 0 and every pointer aligned;
// or 1); S threads across a slab, L row lanes, RL of them in a warp (added
// by shuffles), H = L / RL rows of the block's sums left after them.
template <typename I, int W>
__global__ void __launch_bounds__(THREADS)
pre_tail_bwd_kernel(const float* __restrict__ v, const float* __restrict__ mu,
                    const float* __restrict__ inv, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ g,
                    float* __restrict__ dv, float* __restrict__ dvec,
                    float* __restrict__ part, unsigned int* __restrict__ tickets,
                    int R, int d, int chunk, int act, Drop dp) {
  dp = resolved(dp);  // the seed read once a thread
  const uint32_t hi = drop_hi(dp);
  using T = typename VecOf<W>::type;
  constexpr int S = SLAB / W;
  constexpr int L = THREADS / S;
  constexpr int RL = S < 32 ? 32 / S : 1;
  constexpr int H = L / RL;
  constexpr int OUT = SUMS * SLAB;  // a block's sums: OUT / SLAB per column
  const int lc = threadIdx.x % S, lr = threadIdx.x / S;
  const int c = blockIdx.x * SLAB + lc * W;
  const int chunks = gridDim.y;
  float acc[SUMS][W];
#pragma unroll
  for (int s = 0; s < SUMS; ++s)
#pragma unroll
    for (int k = 0; k < W; ++k) acc[s][k] = 0.0f;

  if (c < d) {
    float m[W], iv[W], ga[W], be[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      m[k] = mu[c + k];
      iv[k] = inv[c + k];
      ga[k] = gamma[c + k];
      be[k] = beta[c + k];
    }
    const int r_end = min(R, (int)(blockIdx.y + 1) * chunk);
    for (int r = (int)blockIdx.y * chunk + lr; r < r_end; r += RU * L) {
      T vv[RU], gg[RU];
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        const int rq = r + q * L;
        if (rq < r_end) {
          const I i = (I)rq * (I)d + (I)c;
          vv[q] = *reinterpret_cast<const T*>(v + i);
          gg[q] = *reinterpret_cast<const T*>(g + i);
        }
      }
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        const int rq = r + q * L;
        if (rq < r_end) {
          const I i = (I)rq * (I)d + (I)c;
          T o;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const float vc = elem(vv[q], k) - m[k];
            const float z = vc * iv[k] * ga[k] + be[k];
            const float dz = drop_at(dp, hi, i + (I)k, elem(gg[q], k))
                             * act_grad(z, act);
            const float dyhat = dz * ga[k];
            const float dvi = dyhat * iv[k];
            set_elem(o, k, dvi);
            acc[0][k] -= dvi;
            acc[1][k] += dyhat * vc;
            acc[2][k] += dz * (vc * iv[k]);
            acc[3][k] += dz;
          }
          *reinterpret_cast<T*>(dv + i) = o;
        }
      }
    }
  }

  // the block's sums: a warp's RL row lanes by shuffles (lanes S apart),
  // then the H rows left in order, into the chunk's partial row
  __shared__ float red[H][OUT];
#pragma unroll
  for (int s = 0; s < SUMS; ++s)
#pragma unroll
    for (int k = 0; k < W; ++k)
#pragma unroll
      for (int off = S; off < 32; off *= 2)
        acc[s][k] += __shfl_xor_sync(0xffffffffu, acc[s][k], off);
  if (lr % RL == 0) {
#pragma unroll
    for (int s = 0; s < SUMS; ++s)
#pragma unroll
      for (int k = 0; k < W; ++k) red[lr / RL][s * SLAB + lc * W + k] = acc[s][k];
  }
  __syncthreads();
  float* mine = part + ((size_t)blockIdx.x * chunks + blockIdx.y) * OUT;
  for (int o = threadIdx.x; o < OUT; o += THREADS) {
    float t = 0.0f;
#pragma unroll
    for (int h = 0; h < H; ++h) t += red[h][o];
    mine[o] = t;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned int)(chunks - 1);
  __syncthreads();
  if (!last) return;

  // the slab's last block: RUNS runs of consecutive chunks, each read as
  // OUT / 4 float4s a chunk, BATCH chunks' loads in flight at a time (the
  // chunks past the run add zeros), then the runs in order
  constexpr int OUT4 = OUT / 4;
  constexpr int RUNS = THREADS / OUT4;
  constexpr int BATCH = 8;
  __threadfence();
  const float4* rows =
      reinterpret_cast<const float4*>(part + (size_t)blockIdx.x * chunks * OUT);
  const int q = threadIdx.x % OUT4, run = threadIdx.x / OUT4;
  const int per = (chunks + RUNS - 1) / RUNS;
  const int k0 = run * per, k1 = min(chunks, k0 + per);
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = k0; k < k1; k += BATCH) {
    float4 p[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      p[b] = k + b < k1 ? __ldcg(rows + (size_t)(k + b) * OUT4 + q)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      sum.x += p[b].x;
      sum.y += p[b].y;
      sum.z += p[b].z;
      sum.w += p[b].w;
    }
  }
  __shared__ float4 runs[RUNS][OUT4];
  runs[run][q] = sum;
  __syncthreads();
  if (threadIdx.x < OUT4) {
    float4 tot = runs[0][q];
#pragma unroll
    for (int w = 1; w < RUNS; ++w) {
      tot.x += runs[w][q].x;
      tot.y += runs[w][q].y;
      tot.z += runs[w][q].z;
      tot.w += runs[w][q].w;
    }
    const int s = q / (SLAB / 4), col = blockIdx.x * SLAB + (q % (SLAB / 4)) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < d) dvec[(size_t)s * d + col + k] = elem(tot, k);
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

template <typename I, int W>
cudaError_t launch_bwd(const float* v, const float* mu, const float* inv,
                       const float* gamma, const float* beta, const float* g,
                       float* dv, float* dvec, float* part, unsigned int* tickets,
                       int R, int d, int act, const Drop& dp, cudaStream_t st) {
  const dim3 grid(cdiv(d, SLAB), bwd_chunks(R, d));
  pre_tail_bwd_kernel<I, W><<<grid, THREADS, 0, st>>>(
      v, mu, inv, gamma, beta, g, dv, dvec, part, tickets, R, d,
      bwd_chunk_rows(R, d), act, dp);
  return cudaGetLastError();
}

template <typename I>
cudaError_t bwd_pass(const float* v, const float* mu, const float* inv,
                     const float* gamma, const float* beta, const float* g,
                     float* dv, float* dvec, float* part, unsigned int* tickets,
                     int R, int d, int act, const Drop& dp, cudaStream_t st) {
  const bool quad = d % 4 == 0 && aligned16(v) && aligned16(g) && aligned16(dv)
                    && aligned16(mu) && aligned16(inv) && aligned16(gamma)
                    && aligned16(beta);
  if (quad)
    return launch_bwd<I, 4>(v, mu, inv, gamma, beta, g, dv, dvec, part, tickets, R,
                            d, act, dp, st);
  return launch_bwd<I, 1>(v, mu, inv, gamma, beta, g, dv, dvec, part, tickets, R, d,
                          act, dp, st);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int pre_tail_forward(const float* x, const float* v, const float* mu,
                                const float* inv, const float* gamma,
                                const float* beta, float* out, long long rows, int d,
                                int act, const unsigned int* seed, int t, float scale,
                                void* stream) {
  const long long total = rows * d;
  if (total <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(seed, 0, t, scale);
  if (total < NARROW_VIEW)
    return fwd_pass<uint32_t>(x, v, mu, inv, gamma, beta, out, total, d, act, dp, st);
  return fwd_pass<unsigned long long>(x, v, mu, inv, gamma, beta, out, total, d, act,
                                      dp, st);
}

// floats of scratch pre_tail_backward needs: a partial row of the four sums
// per slab and chunk
extern "C" long long pre_tail_backward_scratch(int rows, int d) {
  return (long long)cdiv(d, SLAB) * bwd_chunks(rows, d) * (SUMS * SLAB);
}

// tickets pre_tail_backward needs, zeroed once by their owner: one per slab;
// each launch leaves them at 0
extern "C" int pre_tail_backward_tickets(int d) { return cdiv(d, SLAB); }

// dvec (4, d) = [dmu | dinv | dgamma | dbeta]
extern "C" int pre_tail_backward(const float* v, const float* mu, const float* inv,
                                 const float* gamma, const float* beta, const float* g,
                                 float* dv, float* dvec, float* scratch,
                                 unsigned int* tickets, int rows, int d, int act,
                                 const unsigned int* seed, int t, float scale, void* stream) {
  if (d <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(seed, 0, t, scale);
  if ((long long)rows * d < NARROW_VIEW)
    return bwd_pass<uint32_t>(v, mu, inv, gamma, beta, g, dv, dvec, scratch, tickets,
                              rows, d, act, dp, st);
  return bwd_pass<unsigned long long>(v, mu, inv, gamma, beta, g, dv, dvec, scratch,
                                      tickets, rows, d, act, dp, st);
}
