// The GPS FFN block with its residual, forward and backward:
//
//   out = h + drop2(W2 drop1(act(W1 h + b1)) + b2)      (R, d) rows
//
// Replaces the TPU kernel graphgps_tpu/ops/pallas/fused_tail.py:387 fused_ffn
// (forward _ffn_fwd :402 with its pallas_call at :408 over _ffn_fwd_kernel,
// backward _ffn_vjp_bwd :433 with its pallas_call at :441 over
// _ffn_bwd_kernel :343). A GPS layer with no deferred combine takes it in
// training with dropout (the GCN+Transformer recipes). The TPU wrapper
// fused_ffn_padded (:525) pads d = 96 to 128 lanes and dh = 192 to 256; here
// a row is never padded. Dropout sites (common.cuh): 1 the inner (R, dh)
// view, 2 the outer (R, d) view (with drop2), both at one rate.
//
// Bound on the H100: the products, forward 4*R*d*dh operations and backward
// 10*R*d*dh (the first product recomputed), at the 3xTF32 tensor-core rate
// (495 / 3 = 165 TFLOP/s); the bytes (h, g, out, dh once) come below them.
//
// Design: two routes, by width, with bn_ffn.cu's rule (fused::fits; in
// Python ops/kernels/ffn_fused.py takes_fused, which both wrappers import).
// - Fused (wn-squirrel's d = 96 and actor's d = 64 among them): one launch
//   forward, two backward. The blocks are persistent, about one an SM, each
//   walking its consecutive share of the 16-row tiles; a block stages W1 and
//   W2 once with cp.async (W2 lands while the first tile's first product
//   runs) and double-buffers the next tile's rows while it computes the
//   current one. The products are ffn_fused.cuh's 3xTF32 mma.sync slabs, at
//   the task width that balances the block's 8 warps.
//   - Forward (ffn_fused_fwd_kernel): ffn_fused.cuh's forward_hidden and
//     forward_out with h staged as it is (no prologue); a1 and z stay on
//     chip and nothing is kept for the backward.
//   - Backward (ffn_fused_bwd_kernel, then ffn_fused.cuh's reduce_blocks):
//     per tile, stage h and g; da2 = drop2(g); recompute a1 = h W1 + b1 and
//     z = drop1(act(a1)) on chip, as the TPU kernel does (one product more
//     instead of 8 MB of a1 and z written and read back at wn-squirrel's
//     shape); da1 = drop1(da2 W2^T) * act'(a1); dh = g + da1 W1^T to device
//     memory; then dW1 += h^T da1 and dW2^T += da2^T z, both d x dh, into
//     accumulators each warp holds in registers across the block's tiles
//     (a warp owns every 8th 8-column fragment of dh over all of d, so a
//     B fragment is split once for every 16 rows of d), and db1, db2 into
//     per-column sums in shared memory. A block writes one row of partials
//     at its end (110 rows at wn-squirrel's 328 tiles, not one a tile), and
//     the reduce adds the rows in block order.
// - Sequence (wider FFNs, where the fused blocks do not fit): ffn_core.cuh's
//   launch sequence over the tensor-core GEMM (gemm_tc.cuh), the backward
//   recomputing a1 and z with one more GEMM.
// Every sum runs in a fixed order (no float atomics), so two runs give the
// same bits.
#include "gemm_tc.cuh"
#include "ffn_core.cuh"
#include "ffn_fused.cuh"

namespace ggps {
namespace {

using fused::BM;
using fused::NT;
using fused::WARPS;

// the weight gradients a warp holds: up to BWD_MF 16-row fragments of d by
// BWD_NJ 8-column fragments of dh, for each of dW1 and dW2^T (144 floats a
// lane at wn-squirrel's d = 96, dh = 192)
constexpr int BWD_MF = 6, BWD_NJ = 3;

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Tiles of BM rows per persistent block: the fewest that keep the tiles'
// waves (ceil(tiles / SMs)), so fewer blocks stage the weights and write
// partials at the same makespan.
inline int tiles_per_block(int R) {
  const int tiles = cdiv(R, BM);
  return cdiv(tiles, tc::SMS);
}

// The forward's layout: FfnLayout's, and a second h tile when `bufs` is 2.
inline long long fwd_floats(int d, int dh, int bufs) {
  const fused::FfnLayout L = fused::FfnLayout::make(d, dh, false);
  return L.floats + (bufs - 1) * (long long)BM * L.ldh;
}

inline int fwd_bufs(int d, int dh) {
  return fwd_floats(d, dh, 2) * 4 <= fused::FUSED_SMEM_LIMIT ? 2 : 1;
}

// The backward's shared memory (offsets and strides in floats): W1 [dp][ld4
// (dhp)] (B of the recomputed product, B^T of dh's), W2 [dhp][ld4(dp)] (B^T
// of da1's); `bufs` tiles of h [BM][ld4(dp)] and of g, turned into da2 in
// place, [BM][ld4(dp)]; z [BM][ld8(dhp)] (A^T of dW2), da1 [BM][ld4(dhp)]
// (holding act'(a1) until da1 replaces it); the column sums [dhp + dp].
struct BwdLayout {
  int d, dh, dp, dhp, bufs;
  int w1, ldw1, w2, ldw2, h, ldh, g, ldg, z, ldz, da1, ldda1, bsum;
  int floats;

  __host__ __device__ static BwdLayout make(int d, int dh, int bufs) {
    BwdLayout L{};
    L.d = d;
    L.dh = dh;
    L.dp = fused::pad16(d);
    L.dhp = fused::pad16(dh);
    L.bufs = bufs;
    L.ldw1 = fused::ld4(L.dhp);
    L.ldw2 = fused::ld4(L.dp);
    L.ldh = L.ldg = fused::ld4(L.dp);
    L.ldz = fused::ld8(L.dhp);
    L.ldda1 = fused::ld4(L.dhp);
    int o = 0;
    L.w1 = o;
    o += L.dp * L.ldw1;
    L.w2 = o;
    o += L.dhp * L.ldw2;
    L.h = o;
    o += bufs * BM * L.ldh;
    L.g = o;
    o += bufs * BM * L.ldg;
    L.z = o;
    o += BM * L.ldz;
    L.da1 = o;
    o += BM * L.ldda1;
    L.bsum = o;
    o += L.dhp + L.dp;
    L.floats = o;
    return L;
  }
  __host__ __device__ long long bytes() const { return (long long)floats * 4; }
};

// Whether the fused backward takes (d, dh): its layout fits with one row
// buffer, and a warp's share of the weight gradients fits its registers
// (d <= 96, dh <= 192: the GPS widths d = dh / 2 up to wn-squirrel's).
inline bool bwd_fits(int d, int dh) {
  const BwdLayout L = BwdLayout::make(d, dh, 1);
  return fused::fits(d, dh) && L.bytes() <= fused::FUSED_SMEM_LIMIT &&
         L.dp / 16 <= BWD_MF && cdiv(L.dhp / 8, WARPS) <= BWD_NJ;
}

inline int bwd_bufs(int d, int dh) {
  return BwdLayout::make(d, dh, 2).bytes() <= fused::FUSED_SMEM_LIMIT ? 2 : 1;
}

// Rows [row0, row0 + BM) of a (R, cols) matrix into a tile [BM][ld] (zeros
// past R and cols up to cols_pad); cp.async, committed by the caller.
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, int row0,
                                           int R, int cols, int cols_pad, bool vec) {
  fused::stage(dst, ld, src + (size_t)row0 * cols, cols, min(BM, R - row0), cols, BM,
               cols_pad, vec);
}

// The fused forward: block b walks tiles [b per, b per + per). Copy groups:
// W1 with the first tile's h, then W2, then one group a tile (the next
// tile's h, or nothing), so the first product waits for W1 only.
__global__ void __launch_bounds__(NT, 1)
ffn_fused_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w1,
                     const float* __restrict__ w2, fused::FwdArgs p, int d, int dh,
                     int per, int bufs, bool vec) {
  extern __shared__ float smem[];
  const fused::FfnLayout L = fused::FfnLayout::make(d, dh, false);
  const int tiles = (p.R + BM - 1) / BM;
  const int t0 = blockIdx.x * per, t1 = min(tiles, t0 + per);
  auto tile = [&](int i) { return smem + (i == 0 ? L.h : L.floats); };
  fused::stage(smem + L.w1, L.ldw1, w1, dh, d, dh, L.dp, L.dhp, vec);
  stage_tile(tile(0), L.ldh, h, t0 * BM, p.R, d, L.dp, vec);
  tc::cp_commit();
  fused::stage(smem + L.w2, L.ldw2, w2, d, dh, d, L.dhp, L.dp, vec);
  tc::cp_commit();
  for (int t = t0; t < t1; ++t) {
    const int i = (t - t0) % bufs, row0 = t * BM;
    if (bufs == 2 && t + 1 < t1) stage_tile(tile(i ^ 1), L.ldh, h, row0 + BM, p.R, d, L.dp, vec);
    tc::cp_commit();
    if (t == t0)
      tc::cp_wait<2>();
    else
      tc::cp_wait<1>();
    __syncthreads();
    fused::forward_hidden<true>(L, smem, tile(i), row0, p);
    if (t == t0) tc::cp_wait<1>();
    __syncthreads();
    fused::forward_out<true>(L, smem, tile(i), row0, p);
    __syncthreads();
    if (bufs == 1 && t + 1 < t1) stage_tile(tile(0), L.ldh, h, row0 + BM, p.R, d, L.dp, vec);
    if (bufs == 1) tc::cp_commit();
  }
}

struct BwdPtrs {
  const float* h;    // (R, d)
  const float* b1;   // (dh,)
  const float* g;    // (R, d) the cotangent of out
  float* dx;         // (R, d)
  float* part;       // (blocks, ffn_part_floats) partial rows
  int R, act;
  Drop drop1, drop2;
};

// The fused backward: block b walks tiles [b per, b per + per), copy groups
// as in the forward (W1 with the first tile's h and g, then W2).
__global__ void __launch_bounds__(NT, 1)
ffn_fused_bwd_kernel(const float* __restrict__ w1, const float* __restrict__ w2, BwdPtrs p,
                     int d, int dh, int per, int bufs, bool vec) {
  extern __shared__ float smem[];
  const BwdLayout L = BwdLayout::make(d, dh, bufs);
  const int tiles = (p.R + BM - 1) / BM;
  const int t0 = blockIdx.x * per, t1 = min(tiles, t0 + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* w1s = smem + L.w1;
  const float* w2s = smem + L.w2;
  float* zs = smem + L.z;
  float* da1 = smem + L.da1;
  float* bsum = smem + L.bsum;
  auto hs = [&](int i) { return smem + L.h + i * BM * L.ldh; };
  auto gs = [&](int i) { return smem + L.g + i * BM * L.ldg; };
  auto stage_rows = [&](int i, int row0) {
    stage_tile(hs(i), L.ldh, p.h, row0, p.R, d, L.dp, vec);
    stage_tile(gs(i), L.ldg, p.g, row0, p.R, d, L.dp, vec);
  };
  fused::stage(smem + L.w1, L.ldw1, w1, dh, d, dh, L.dp, L.dhp, vec);
  stage_rows(0, t0 * BM);
  tc::cp_commit();
  fused::stage(smem + L.w2, L.ldw2, w2, d, dh, d, L.dhp, L.dp, vec);
  tc::cp_commit();
  for (int c = threadIdx.x; c < L.dhp + L.dp; c += NT) bsum[c] = 0.0f;

  // this warp's weight gradients: [dW1, dW2^T][16-row fragment of d][its
  // 8-column fragments of dh, j = warp + WARPS i]
  const int MF = L.dp / 16, NJ = L.dhp / 8;
  float acc[2][BWD_MF][BWD_NJ][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int mi = 0; mi < BWD_MF; ++mi)
#pragma unroll
      for (int i = 0; i < BWD_NJ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][mi][i][e] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int i = (t - t0) % bufs, row0 = t * BM;
    if (bufs == 2 && t + 1 < t1) stage_rows(i ^ 1, row0 + BM);
    tc::cp_commit();
    if (t == t0)
      tc::cp_wait<2>();
    else
      tc::cp_wait<1>();
    __syncthreads();
    const float* hb = hs(i);
    float* gb = gs(i);
    // da2 = drop2(g) in place (zeros past R and d stay zeros)
    for (int e = threadIdx.x; e < BM * d; e += NT) {
      const int m = e / d, c = e % d;
      float& v = gb[m * L.ldg + c];
      v = drop_apply(p.drop2, (size_t)(row0 + m) * d + c, v);
    }
    // a1 = h W1 + b1 recomputed: z = drop1(act(a1)) into zs, act'(a1) into
    // da1's tile (zeros past R and dh)
    fused::products<true>(
        BM, L.dhp, L.dp, [&](int m, int k) { return hb[m * L.ldh + k]; },
        [&](int k, int n) { return w1s[k * L.ldw1 + n]; },
        [&](int m, int n, float acc_) {
          const int row = row0 + m;
          float zv = 0.0f, dv = 0.0f;
          if (row < p.R && n < dh) {
            const float v = acc_ + p.b1[n];
            zv = drop_apply(p.drop1, (size_t)row * dh + n, apply_act(v, p.act));
            dv = act_grad(v, p.act);
          }
          zs[m * L.ldz + n] = zv;
          da1[m * L.ldda1 + n] = dv;
        });
    if (t == t0) tc::cp_wait<1>();
    __syncthreads();
    // da1 = drop1(da2 W2^T) * act'(a1), each entry read and written by the
    // one lane that owns it
    fused::products<true>(
        BM, L.dhp, L.dp, [&](int m, int k) { return gb[m * L.ldg + k]; },
        [&](int k, int n) { return w2s[n * L.ldw2 + k]; },
        [&](int m, int n, float acc_) {
          float& v = da1[m * L.ldda1 + n];
          v = drop_apply(p.drop1, (size_t)(row0 + m) * dh + n, acc_) * v;
        });
    __syncthreads();
    // dh = g + da1 W1^T
    fused::products<true>(
        BM, L.dp, L.dhp, [&](int m, int k) { return da1[m * L.ldda1 + k]; },
        [&](int k, int n) { return w1s[n * L.ldw1 + k]; },
        [&](int m, int n, float acc_) {
          const int row = row0 + m;
          if (row < p.R && n < d) {
            const size_t idx = (size_t)row * d + n;
            p.dx[idx] = acc_ + p.g[idx];
          }
        });
    // dW1 += h^T da1 and dW2^T += da2^T z over the tile's rows, k in order:
    // each B fragment split once for all of d's 16-row fragments
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float* A = w == 0 ? hb : gb;
      const float* B = w == 0 ? da1 : zs;
      const int lda = w == 0 ? L.ldh : L.ldg, ldb = w == 0 ? L.ldda1 : L.ldz;
#pragma unroll
      for (int k0 = 0; k0 < BM; k0 += 8) {
        tc::BFrag bf[BWD_NJ];
#pragma unroll
        for (int i = 0; i < BWD_NJ; ++i) {
          const int n = 8 * (warp + WARPS * i) + gq;
          if (warp + WARPS * i < NJ) {
            tc::split(B[(k0 + tq) * ldb + n], bf[i].h[0], bf[i].l[0]);
            tc::split(B[(k0 + tq + 4) * ldb + n], bf[i].h[1], bf[i].l[1]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < BWD_MF; ++mi) {
          if (mi >= MF) break;
          tc::AFrag af;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tc::split(A[(k0 + tq + 4 * (e >> 1)) * lda + 16 * mi + gq + 8 * (e & 1)],
                      af.h[e], af.l[e]);
#pragma unroll
          for (int i = 0; i < BWD_NJ; ++i)
            if (warp + WARPS * i < NJ) tc::mma3(acc[w][mi][i], af, bf[i]);
        }
      }
    }
    // db1, db2: each thread its columns, the tile's rows in order
    for (int c = threadIdx.x; c < L.dhp + L.dp; c += NT) {
      const bool one = c < L.dhp;
      const float* src = one ? da1 + c : gb + (c - L.dhp);
      const int ld = one ? L.ldda1 : L.ldg;
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < BM; ++m) s += src[m * ld];
      bsum[c] += s;
    }
    __syncthreads();
    if (bufs == 1 && t + 1 < t1) stage_rows(0, row0 + BM);
    if (bufs == 1) tc::cp_commit();
  }

  // the block's partial row: [dW1 (d, dh) | dW2 (dh, d) | db1 (dh) | db2 (d)]
  float* part = p.part + (size_t)blockIdx.x * fused::ffn_part_floats(d, dh);
#pragma unroll
  for (int mi = 0; mi < BWD_MF; ++mi)
#pragma unroll
    for (int i = 0; i < BWD_NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * mi + gq + 8 * (e >> 1), n = 8 * (warp + WARPS * i) + 2 * tq + (e & 1);
        if (m < d && n < dh) {
          part[(size_t)m * dh + n] = acc[0][mi][i][e];
          part[(size_t)d * dh + (size_t)n * d + m] = acc[1][mi][i][e];
        }
      }
  for (int c = threadIdx.x; c < dh + d; c += NT)
    part[2 * (size_t)d * dh + c] = c < dh ? bsum[c] : bsum[L.dhp + c - dh];
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Bytes of shared memory a fused block takes (forward, or backward when
// `backward`) at the row buffers it runs with, and whether the shared route
// rule (fused::fits) takes (d, dh); and whether the fused backward does
// (its layout and the warps' registers), which the wrapper asks before it
// allocates the sequence's work.
extern "C" long long ffn_fused_smem(int d, int dh, int backward) {
  return backward ? BwdLayout::make(d, dh, bwd_bufs(d, dh)).bytes()
                  : fwd_floats(d, dh, fwd_bufs(d, dh)) * 4;
}
extern "C" int ffn_fused_fits(int d, int dh) { return fused::fits(d, dh) ? 1 : 0; }
extern "C" int ffn_fused_backward_fits(int d, int dh) { return bwd_fits(d, dh) ? 1 : 0; }

// fused != 0: the fused route (the wrapper checked ffn_fused_fits), a1
// stored when not null. Otherwise the launch sequence, with work the caller
// allocates: z (R, dh), and a1 (R, dh) stored when not null.
extern "C" int ffn_forward(const float* h, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* out, float* z,
                           float* a1, int R, int d, int dh, int act, unsigned int seed,
                           int t1, int t2, float scale, int fused_route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop1 = make_drop(seed, 1, t1, scale), drop2 = make_drop(seed, 2, t2, scale);
  if (!fused_route)
    return ffn_core_forward<tc::Gemm>(h, w1, b1, w2, b2, out, z, a1, R, d, dh, act, drop1,
                                      drop2, st);
  if (R <= 0) return 0;
  const int bufs = fwd_bufs(d, dh), per = tiles_per_block(R);
  const size_t bytes = fwd_floats(d, dh, bufs) * 4;
  cudaError_t err = allow_smem(ffn_fused_fwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  fused::FwdArgs p{b1, b2, out, a1, nullptr, R, act, drop1, drop2};
  const bool vec = d % 4 == 0 && dh % 4 == 0 && aligned16(h) && aligned16(w1) &&
                   aligned16(w2);
  ffn_fused_fwd_kernel<<<cdiv(cdiv(R, BM), per), NT, bytes, st>>>(h, w1, w2, p, d, dh, per,
                                                                 bufs, vec);
  return cudaGetLastError();
}

// floats of scratch ffn_backward needs on its route
extern "C" long long ffn_backward_scratch(int R, int d, int dh, int fused_route) {
  if (fused_route && bwd_fits(d, dh))
    return (long long)cdiv(cdiv(R > 0 ? R : 1, BM), tiles_per_block(R > 0 ? R : 1)) *
           fused::ffn_part_floats(d, dh);
  return ffn_core_scratch<tc::Gemm>(R, d, dh);
}

// Inputs: h (R, d), W1 (d, dh), b1 (dh,), W2 (dh, d), the cotangent g (R, d).
// Outputs: dh (R, d), dw1 (d, dh), db1 (dh,), dw2 (dh, d), db2 (d,).
// fused != 0 and ffn_fused_backward_fits: the fused route; otherwise the
// launch sequence with its work: a1, z, da1 (R, dh), da2 (R, d); scratch.
extern "C" int ffn_backward(const float* h, const float* w1, const float* b1,
                            const float* w2, const float* g, float* dh, float* dw1,
                            float* db1, float* dw2, float* db2, float* a1, float* z,
                            float* da1, float* da2, float* scratch, int R, int d,
                            int dhid, int act, unsigned int seed, int t1, int t2,
                            float scale, int fused_route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop1 = make_drop(seed, 1, t1, scale), drop2 = make_drop(seed, 2, t2, scale);
  cudaError_t err;
  if (fused_route && bwd_fits(d, dhid)) {
    const int per = tiles_per_block(R > 0 ? R : 1);
    const int blocks = R > 0 ? cdiv(cdiv(R, BM), per) : 0;
    if (blocks > 0) {
      const int bufs = bwd_bufs(d, dhid);
      const size_t bytes = BwdLayout::make(d, dhid, bufs).bytes();
      if ((err = allow_smem(ffn_fused_bwd_kernel, bytes)) != cudaSuccess) return err;
      BwdPtrs p{h, b1, g, dh, scratch, R, act, drop1, drop2};
      const bool vec = d % 4 == 0 && dhid % 4 == 0 && aligned16(h) && aligned16(g) &&
                       aligned16(w1) && aligned16(w2);
      ffn_fused_bwd_kernel<<<blocks, NT, bytes, st>>>(w1, w2, p, d, dhid, per, bufs, vec);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    fused::Outs outs{};
    const long long dd = (long long)d * dhid;
    float* ptrs[4] = {dw1, dw2, db1, db2};
    const long long lens[4] = {dd, dd, dhid, d};
    long long end = 0;
    for (int i = 0; i < 4; ++i) {
      outs.ptr[i] = ptrs[i];
      outs.end[i] = end += lens[i];
    }
    outs.n = 4;
    return fused::reduce_blocks(scratch, blocks, end, outs, st);
  }
  // recompute a1 and z = drop1(act(a1)), as the forward made them
  Epi e1;
  e1.bias = b1;
  e1.pre = a1;
  e1.act = act;
  e1.drop = drop1;
  if ((err = tc::gemm_nn(h, w1, z, R, dhid, d, e1, st)) != cudaSuccess) return err;
  return ffn_core_backward<tc::Gemm>(h, a1, z, g, w1, w2, dh, dw1, db1, dw2, db2, da2, da1,
                                     scratch, R, d, dhid, act, drop1, drop2, st);
}
