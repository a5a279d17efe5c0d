// BigBird block-sparse attention over a static block plan, forward and
// backward.
//
// Replaces graphgps_tpu/ops/pallas/splash_bigbird.py:87 splash_bigbird, which
// runs the TPU splash-attention kernel of
// jax.experimental.pallas.ops.tpu.splash_attention over BigBird's block plan
// (graphgps_tpu/ops/bigbird.py:26 _block_plan; its forward and backward
// pallas_calls live in that library). Its semantics as splash_bigbird uses
// it, for q, k, v (B, H, N, Dh) and segment ids ids = key_mask (B, N) as int
// (padded 0, real 1):
//
//   qs  = q * scale,  scale = 1/sqrt(Dh)        (q scaled before q k^T)
//   s   = qs . k   where the plan allows (query block, key block) and
//                  ids[query] == ids[key];
//         MASK     where the plan allows the pair but the ids differ
//                  (MASK = -0.7 * FLT_MAX, assigned, not added);
//         pairs off the plan are never visited
//   o   = softmax(s) v
//
// Bound on the H100: bytes. At wn-squirrel (B 1, H 4, N 5,248, Dh 24, block
// 3, 3 random blocks) about 150 k pairs a head are visited, 4*Dh operations
// each forward (~0.06 GFLOP), against q, k, v and o of 2 MB each.
//
// Design. The plan is turned on the host, once, into two CSR lists: the keys
// of each query block, and transposed, the query rows of each key block
// (ops/kernels/bigbird.py). At block 3 a middle query block sees ~8 key
// blocks (~0.5% of the N^2 pairs), while the two global query blocks see all
// N keys and every node sees the two global key blocks, so each list is cut
// into tasks of at most 64 entries; a block with more than one task writes
// partial results to scratch, and a combine kernel merges them in task order.
// Forward (bb_fwd_kernel): one warp per task, carrying up to 4 query rows of
// its block: per 32 keys a lane holds one key, forms the rows' logits against
// the scaled q rows in shared memory, the warp takes the online softmax step
// (running max m and sum l per row), then a lane holds one column of the head
// and adds p_j * v_j with p_j handed round by shuffle. Each row's
// log-sum-exp m + log(l) is written for the backward.
// Backward, with no float atomics: bb_dq_kernel, the forward's mirror over
// the same tasks, recomputes P = exp(s - lse), forms D = dO . o per row (the
// block's first task writes it out), dS = P (dO v^T - D) on allowed pairs
// and dq = scale * dS k; then bb_dkv_kernel over the transposed tasks, a lane
// holding one query row and the warp up to 4 keys, forms dv = P^T dO and
// dk = dS^T qs. Every sum runs in a fixed order, so two runs give the same
// bits.
#include "common.cuh"

namespace ggps {
namespace {

constexpr int BB_WARPS = 8;   // tasks per block of 256 threads
constexpr int BB_ROWS = 4;    // rows a warp carries at once (queries, or keys in dkv)
constexpr int BB_MAX_DH = 128;  // four column registers per lane
// the library's DEFAULT_MASK_VALUE, -0.7 * float32 max, rounded to f32 once
constexpr float BB_MASK = (float)(-0.7 * 3.4028234663852886e38);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float wmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float wsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The task tables of one side (ops/kernels/bigbird.py _tasks): task t walks
// entries lo[t] .. hi[t] of block blk[t]'s list idx, and writes partial slot
// part[t], or the result itself where part[t] < 0.
struct Tasks {
  const int* idx;
  const int* blk;
  const int* lo;
  const int* hi;
  const int* part;
  int n;
};

// rows r0 .. r0 + nr of one head's (N, Dh) matrix, times mul, into a warp's
// shared rows of stride Dh; the rest of the BB_ROWS rows zero
__device__ __forceinline__ void warp_rows(float* dst, const float* __restrict__ src, int r0,
                                          int nr, int Dh, float mul) {
  for (int i = threadIdx.x; i < BB_ROWS * Dh; i += 32) {
    const int r = i / Dh, t = i % Dh;
    dst[i] = r < nr ? src[(size_t)(r0 + r) * Dh + t] * mul : 0.0f;
  }
}

template <int ACC>
__global__ void __launch_bounds__(32 * BB_WARPS)
bb_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ ids, Tasks tk,
              float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
              int parts, int N, int H, int Dh, int bs, float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int task = blockIdx.x * BB_WARPS + warp;
  if (task >= tk.n) return;   // no block-wide barrier below
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const int* gid = ids + (size_t)b * N;
  const float* kh = k + head * Dh;
  const float* vh = v + head * Dh;
  float* qs = smem + warp * BB_ROWS * Dh;
  const int blk = tk.blk[task], lo = tk.lo[task], hi = tk.hi[task], p = tk.part[task];
  const int rb = blk * bs, re = min(N, rb + bs);

  for (int r0 = rb; r0 < re; r0 += BB_ROWS) {
    const int nr = min(BB_ROWS, re - r0);
    __syncwarp();
    warp_rows(qs, q + head * Dh, r0, nr, Dh, scale);
    __syncwarp();
    float m[BB_ROWS], l[BB_ROWS], acc[BB_ROWS][ACC];
    int qid[BB_ROWS];
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
      qid[r] = r < nr ? gid[r0 + r] : 0;
#pragma unroll
      for (int a = 0; a < ACC; ++a) acc[r][a] = 0.0f;
    }
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const bool valid = c0 + lane < hi;
      const int j = valid ? tk.idx[c0 + lane] : 0;
      const float* kr = kh + (size_t)j * Dh;
      float s[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) s[r] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < Dh; ++t) {
        const float kv = kr[t];
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) s[r] = fmaf(qs[r * Dh + t], kv, s[r]);
      }
      const int kid = gid[j];
      float pr[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) {
        const float sr = valid ? (kid == qid[r] ? s[r] : BB_MASK) : -INFINITY;
        const float mn = fmaxf(m[r], wmax(sr));   // finite: lane 0 is valid
        const float corr = expf(m[r] - mn);
        pr[r] = valid ? expf(sr - mn) : 0.0f;
        l[r] = l[r] * corr + wsum(pr[r]);
#pragma unroll
        for (int a = 0; a < ACC; ++a) acc[r][a] *= corr;
        m[r] = mn;
      }
      const int nk = min(32, hi - c0);
      for (int jj = 0; jj < nk; ++jj) {
        const int jr = __shfl_sync(FULL, j, jj);
        const float* vr = vh + (size_t)jr * Dh;
        float vv[ACC];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          vv[a] = c < Dh ? vr[c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) {
          const float pj = __shfl_sync(FULL, pr[r], jj);
#pragma unroll
          for (int a = 0; a < ACC; ++a) acc[r][a] = fmaf(pj, vv[a], acc[r][a]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      if (r >= nr) continue;
      if (p < 0) {
        const size_t row = head + r0 + r;
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          if (c < Dh) o[row * Dh + c] = acc[r][a] / l[r];
        }
        if (lane == 0) lse[row] = m[r] + logf(l[r]);
      } else {
        // slot (b, h, part, row in block): Dh sums, then m and l
        float* pp = part + ((((size_t)b * H + h) * parts + p) * bs + (r0 - rb + r)) * (Dh + 2);
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          if (c < Dh) pp[c] = acc[r][a];
        }
        if (lane == 0) {
          pp[Dh] = m[r];
          pp[Dh + 1] = l[r];
        }
      }
    }
  }
}

// Merge the partial softmax states of the blocks cut into several tasks,
// in task order: one warp per (combine entry, row of its block).
__global__ void __launch_bounds__(32 * BB_WARPS)
bb_fwd_combine(const float* __restrict__ part, const int* __restrict__ c_blk,
               const int* __restrict__ c_p0, const int* __restrict__ c_np, int n_comb,
               float* __restrict__ o, float* __restrict__ lse, int parts, int N, int H,
               int Dh, int bs) {
  const int lane = threadIdx.x;
  const int item = blockIdx.x * BB_WARPS + threadIdx.y;
  if (item >= n_comb * bs) return;
  const int ci = item / bs, ri = item % bs;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = c_blk[ci] * bs + ri;
  if (row >= N) return;
  const size_t bh = (size_t)b * H + h;
  const int p0 = c_p0[ci], np_ = c_np[ci];
  auto slot = [&](int pi) {
    return part + ((bh * parts + p0 + pi) * bs + ri) * (Dh + 2);
  };
  float M = -INFINITY;
  for (int pi = 0; pi < np_; ++pi) M = fmaxf(M, slot(pi)[Dh]);
  float L = 0.0f;
  for (int pi = 0; pi < np_; ++pi) L += slot(pi)[Dh + 1] * expf(slot(pi)[Dh] - M);
  const size_t orow = bh * N + row;
  for (int c = lane; c < Dh; c += 32) {
    float a = 0.0f;
    for (int pi = 0; pi < np_; ++pi) a += slot(pi)[c] * expf(slot(pi)[Dh] - M);
    o[orow * Dh + c] = a / L;
  }
  if (lane == 0) lse[orow] = M + logf(L);
}

template <int ACC>
__global__ void __launch_bounds__(32 * BB_WARPS)
bb_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ ids,
             const float* __restrict__ o, const float* __restrict__ lse,
             const float* __restrict__ dout, const int* __restrict__ lptr, Tasks tk,
             float* __restrict__ dq, float* __restrict__ drow, float* __restrict__ part,
             int parts, int N, int H, int Dh, int bs, float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int task = blockIdx.x * BB_WARPS + warp;
  if (task >= tk.n) return;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const int* gid = ids + (size_t)b * N;
  const float* kh = k + head * Dh;
  const float* vh = v + head * Dh;
  float* qs = smem + warp * 2 * BB_ROWS * Dh;
  float* dos = qs + BB_ROWS * Dh;
  const int blk = tk.blk[task], lo = tk.lo[task], hi = tk.hi[task], p = tk.part[task];
  const int rb = blk * bs, re = min(N, rb + bs);

  for (int r0 = rb; r0 < re; r0 += BB_ROWS) {
    const int nr = min(BB_ROWS, re - r0);
    __syncwarp();
    warp_rows(qs, q + head * Dh, r0, nr, Dh, scale);
    warp_rows(dos, dout + head * Dh, r0, nr, Dh, 1.0f);
    __syncwarp();
    float D[BB_ROWS], L[BB_ROWS], acc[BB_ROWS][ACC];
    int qid[BB_ROWS];
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      const size_t row = head + r0 + (r < nr ? r : 0);
      float dsum = 0.0f;
      for (int c = lane; c < Dh; c += 32) dsum += dos[r * Dh + c] * o[row * Dh + c];
      D[r] = wsum(dsum);
      L[r] = lse[row];
      qid[r] = r < nr ? gid[r0 + r] : 0;
#pragma unroll
      for (int a = 0; a < ACC; ++a) acc[r][a] = 0.0f;
      if (r < nr && lane == 0 && lo == lptr[blk]) drow[row] = D[r];
    }
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const bool valid = c0 + lane < hi;
      const int j = valid ? tk.idx[c0 + lane] : 0;
      const float* kr = kh + (size_t)j * Dh;
      const float* vr = vh + (size_t)j * Dh;
      float s[BB_ROWS], dp[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) s[r] = dp[r] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < Dh; ++t) {
        const float kv = kr[t], vv = vr[t];
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) {
          s[r] = fmaf(qs[r * Dh + t], kv, s[r]);
          dp[r] = fmaf(dos[r * Dh + t], vv, dp[r]);
        }
      }
      const int kid = gid[j];
      float ds[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) {
        const bool ok = valid && kid == qid[r];
        const float P = valid ? expf((ok ? s[r] : BB_MASK) - L[r]) : 0.0f;
        ds[r] = ok ? P * (dp[r] - D[r]) : 0.0f;
      }
      const int nk = min(32, hi - c0);
      for (int jj = 0; jj < nk; ++jj) {
        const int jr = __shfl_sync(FULL, j, jj);
        const float* krr = kh + (size_t)jr * Dh;
        float kk[ACC];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          kk[a] = c < Dh ? krr[c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) {
          const float dj = __shfl_sync(FULL, ds[r], jj);
#pragma unroll
          for (int a = 0; a < ACC; ++a) acc[r][a] = fmaf(dj, kk[a], acc[r][a]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      if (r >= nr) continue;
      float* dst = p < 0 ? dq + (head + r0 + r) * Dh
                         : part + ((((size_t)b * H + h) * parts + p) * bs + (r0 - rb + r)) * Dh;
      const float mul = p < 0 ? scale : 1.0f;
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int c = lane + 32 * a;
        if (c < Dh) dst[c] = acc[r][a] * mul;
      }
    }
  }
}

template <int ACC>
__global__ void __launch_bounds__(32 * BB_WARPS)
bb_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ ids,
              const float* __restrict__ lse, const float* __restrict__ dout,
              const float* __restrict__ drow, Tasks tk, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ part, int parts, int N, int H,
              int Dh, int bs, float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int task = blockIdx.x * BB_WARPS + warp;
  if (task >= tk.n) return;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const int* gid = ids + (size_t)b * N;
  const float* qh = q + head * Dh;
  const float* dh = dout + head * Dh;
  float* ks = smem + warp * 2 * BB_ROWS * Dh;
  float* vs = ks + BB_ROWS * Dh;
  const int blk = tk.blk[task], lo = tk.lo[task], hi = tk.hi[task], p = tk.part[task];
  const int kb = blk * bs, ke = min(N, kb + bs);

  for (int j0 = kb; j0 < ke; j0 += BB_ROWS) {
    const int nr = min(BB_ROWS, ke - j0);
    __syncwarp();
    warp_rows(ks, k + head * Dh, j0, nr, Dh, 1.0f);
    warp_rows(vs, v + head * Dh, j0, nr, Dh, 1.0f);
    __syncwarp();
    float dka[BB_ROWS][ACC], dva[BB_ROWS][ACC];
    int kid[BB_ROWS];
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      kid[r] = r < nr ? gid[j0 + r] : 0;
#pragma unroll
      for (int a = 0; a < ACC; ++a) dka[r][a] = dva[r][a] = 0.0f;
    }
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const bool valid = c0 + lane < hi;
      const int i = valid ? tk.idx[c0 + lane] : 0;
      const float* qr = qh + (size_t)i * Dh;
      const float* dr = dh + (size_t)i * Dh;
      float s[BB_ROWS], dp[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) s[r] = dp[r] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < Dh; ++t) {
        const float qv = qr[t] * scale, dv_ = dr[t];
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) {
          s[r] = fmaf(qv, ks[r * Dh + t], s[r]);
          dp[r] = fmaf(dv_, vs[r * Dh + t], dp[r]);
        }
      }
      const int qid = gid[i];
      const float Li = lse[head + i], Di = drow[head + i];
      float P[BB_ROWS], ds[BB_ROWS];
#pragma unroll
      for (int r = 0; r < BB_ROWS; ++r) {
        const bool ok = valid && qid == kid[r];
        P[r] = valid ? expf((ok ? s[r] : BB_MASK) - Li) : 0.0f;
        ds[r] = ok ? P[r] * (dp[r] - Di) : 0.0f;
      }
      const int ni = min(32, hi - c0);
      for (int ii = 0; ii < ni; ++ii) {
        const int ir = __shfl_sync(FULL, i, ii);
        const float* qrr = qh + (size_t)ir * Dh;
        const float* drr = dh + (size_t)ir * Dh;
        float qq[ACC], gg[ACC];
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const int c = lane + 32 * a;
          qq[a] = c < Dh ? qrr[c] * scale : 0.0f;
          gg[a] = c < Dh ? drr[c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < BB_ROWS; ++r) {
          const float pi = __shfl_sync(FULL, P[r], ii);
          const float di = __shfl_sync(FULL, ds[r], ii);
#pragma unroll
          for (int a = 0; a < ACC; ++a) {
            dva[r][a] = fmaf(pi, gg[a], dva[r][a]);
            dka[r][a] = fmaf(di, qq[a], dka[r][a]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BB_ROWS; ++r) {
      if (r >= nr) continue;
      const size_t row = head + j0 + r;
      float* pk = p < 0 ? dk + row * Dh
                        : part + ((((size_t)b * H + h) * parts + p) * bs + (j0 - kb + r)) * 2 * Dh;
      float* pv = p < 0 ? dv + row * Dh : pk + Dh;
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int c = lane + 32 * a;
        if (c < Dh) {
          pk[c] = dka[r][a];
          pv[c] = dva[r][a];
        }
      }
    }
  }
}

// Sum the partial gradients of the blocks cut into several tasks, in task
// order: one warp per (combine entry, row of its block). Each slot holds
// `width` columns per row: dq's Dh (then times scale), or dk's and dv's 2*Dh.
__global__ void __launch_bounds__(32 * BB_WARPS)
bb_grad_combine(const float* __restrict__ part, const int* __restrict__ c_blk,
                const int* __restrict__ c_p0, const int* __restrict__ c_np, int n_comb,
                float* __restrict__ out0, float* __restrict__ out1, int parts, int N,
                int H, int Dh, int bs, float mul) {
  const int lane = threadIdx.x;
  const int item = blockIdx.x * BB_WARPS + threadIdx.y;
  if (item >= n_comb * bs) return;
  const int ci = item / bs, ri = item % bs;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = c_blk[ci] * bs + ri;
  if (row >= N) return;
  const size_t bh = (size_t)b * H + h;
  const int width = out1 != nullptr ? 2 * Dh : Dh;
  const int p0 = c_p0[ci], np_ = c_np[ci];
  const size_t orow = bh * N + row;
  for (int c = lane; c < width; c += 32) {
    float a = 0.0f;
    for (int pi = 0; pi < np_; ++pi)
      a += part[((bh * parts + p0 + pi) * bs + ri) * width + c];
    if (c < Dh)
      out0[orow * Dh + c] = a * mul;
    else
      out1[orow * Dh + c - Dh] = a;
  }
}

Tasks make_tasks(const int* idx, const int* blk, const int* lo, const int* hi,
                 const int* part, int n) {
  Tasks t;
  t.idx = idx;
  t.blk = blk;
  t.lo = lo;
  t.hi = hi;
  t.part = part;
  t.n = n;
  return t;
}

// launch K<ACC> for ACC = ceil(Dh / 32) in 1..4
#define BB_DISPATCH(KERNEL, GRID, SMEM, STREAM, ...)                          \
  do {                                                                         \
    const int acc_ = (Dh + 31) / 32;                                           \
    const dim3 block_(32, BB_WARPS);                                           \
    if (acc_ == 1)                                                             \
      KERNEL<1><<<GRID, block_, SMEM, STREAM>>>(__VA_ARGS__);                  \
    else if (acc_ == 2)                                                        \
      KERNEL<2><<<GRID, block_, SMEM, STREAM>>>(__VA_ARGS__);                  \
    else if (acc_ == 3)                                                        \
      KERNEL<3><<<GRID, block_, SMEM, STREAM>>>(__VA_ARGS__);                  \
    else                                                                       \
      KERNEL<4><<<GRID, block_, SMEM, STREAM>>>(__VA_ARGS__);                  \
  } while (0)

dim3 grid_of(int items, int H, int B) {
  return dim3((items + BB_WARPS - 1) / BB_WARPS, H, B);
}

}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int bigbird_forward(const float* q, const float* k, const float* v,
                               const int* ids, const int* idx, const int* t_blk,
                               const int* t_lo, const int* t_hi, const int* t_part,
                               const int* c_blk, const int* c_p0, const int* c_np,
                               float* o, float* lse, float* scratch, int n_tasks,
                               int n_comb, int parts, int B, int H, int N, int Dh, int bs,
                               float scale, void* stream) {
  if (Dh < 1 || Dh > BB_MAX_DH || bs < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tasks tk = make_tasks(idx, t_blk, t_lo, t_hi, t_part, n_tasks);
  const size_t smem = sizeof(float) * BB_WARPS * BB_ROWS * Dh;
  BB_DISPATCH(bb_fwd_kernel, grid_of(n_tasks, H, B), smem, st, q, k, v, ids, tk, o, lse,
              scratch, parts, N, H, Dh, bs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_comb == 0) return err;
  bb_fwd_combine<<<grid_of(n_comb * bs, H, B), dim3(32, BB_WARPS), 0, st>>>(
      scratch, c_blk, c_p0, c_np, n_comb, o, lse, parts, N, H, Dh, bs);
  return cudaGetLastError();
}

extern "C" int bigbird_backward(
    const float* q, const float* k, const float* v, const int* ids, const float* o,
    const float* lse, const float* dout,
    // query side: the keys of each query block
    const int* q_ptr, const int* q_idx, const int* q_blk, const int* q_lo, const int* q_hi,
    const int* q_part, const int* qc_blk, const int* qc_p0, const int* qc_np,
    // key side: the query rows of each key block
    const int* k_ptr, const int* k_idx, const int* k_blk, const int* k_lo, const int* k_hi,
    const int* k_part, const int* kc_blk, const int* kc_p0, const int* kc_np,
    float* dq, float* dk, float* dv, float* drow, float* q_scratch, float* k_scratch,
    int q_tasks, int q_comb, int q_parts, int k_tasks, int k_comb, int k_parts, int B, int H,
    int N, int Dh, int bs, float scale, void* stream) {
  if (Dh < 1 || Dh > BB_MAX_DH || bs < 1) return cudaErrorInvalidValue;
  (void)k_ptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * BB_WARPS * 2 * BB_ROWS * Dh;
  const dim3 cblock(32, BB_WARPS);
  const Tasks qt = make_tasks(q_idx, q_blk, q_lo, q_hi, q_part, q_tasks);
  BB_DISPATCH(bb_dq_kernel, grid_of(q_tasks, H, B), smem, st, q, k, v, ids, o, lse, dout,
              q_ptr, qt, dq, drow, q_scratch, q_parts, N, H, Dh, bs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (q_comb > 0) {
    bb_grad_combine<<<grid_of(q_comb * bs, H, B), cblock, 0, st>>>(
        q_scratch, qc_blk, qc_p0, qc_np, q_comb, dq, nullptr, q_parts, N, H, Dh, bs, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Tasks kt = make_tasks(k_idx, k_blk, k_lo, k_hi, k_part, k_tasks);
  BB_DISPATCH(bb_dkv_kernel, grid_of(k_tasks, H, B), smem, st, q, k, v, ids, lse, dout,
              drow, kt, dk, dv, k_scratch, k_parts, N, H, Dh, bs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess || k_comb == 0) return err;
  bb_grad_combine<<<grid_of(k_comb * bs, H, B), cblock, 0, st>>>(
      k_scratch, kc_blk, kc_p0, kc_np, k_comb, dk, dv, k_parts, N, H, Dh, bs, 1.0f);
  return cudaGetLastError();
}
