// The long-graph attention body on Hopper's tensor cores, shared by
// flash_mha.cu and wide_attention.cu: online-softmax attention of one
// (graph, head) over a tile of query rows, forward (wide_attention) and
// backward (both).
//
// It stands for the attention of two TPU kernels:
// graphgps_tpu/ops/pallas/flash_mha.py:67 flash_mha (the library's flash
// kernel; here its backward, the forward staying on flash_mha.cu's CUDA-core
// loop, whose notes say why) and fused_attn_wide.py:244
// fused_wide_attention with its backward _vjp_bwd :297 (whose four
// projections stay on gemm.cuh). Each caller's semantics are a mode of the
// body, and only the logits, the mask, the dropout and the row statistics
// differ between them:
//   FLASH  s = (q k^T + bias) * scale, plus FA_MASK (added, not assigned)
//          where the query's and the key's segment ids differ; P from the
//          forward's lse per row.
//   WIDE   s = (q * scale) k^T, set to -1e30 for keys j >= counts[b]; key
//          tiles wholly beyond counts[b] are skipped unless it is 0; dropout
//          on P by the counter hash of common.cuh (site 0, row
//          (b*H + h)*N + i, column j: no tile in the counter, so the bits do
//          not depend on this layout); the normaliser sums P before dropout;
//          row maxima and sums.
//
// Products. q k^T, P v and in the backward dO v^T, dS k, k q^T, v dO^T,
// dS^T q and P^T dO all run on mma.sync.m16n8k8 tf32 with f32 accumulation
// and the 3xTF32 split: x = hi + lo, hi = tf32(x) (round to nearest),
// lo = tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi. One tf32 pass
// keeps ~3 decimal digits; the split keeps about f32's, at three
// tensor-core products a step. The tensor cores truncate as they add, so
// the three products of a k-step are summed in a zeroed fragment and added
// to the running sum by a rounded f32 add (mma3): every truncation is at the
// size of 8 products, none at the running sum's. With the products
// accumulated in place, wide_attention's backward at VOC's shape lay 10x
// further from its plain version than the f32 loops it replaced
// (graphgps_torch/tools/kernel_ab.py), and one VOC training step's
// gradients, amplified ~150x by an ill-conditioned norm, moved further
// from f64 in chip_smoke.py's card-vs-CPU step (4c).
//
// Bound on the H100: operations, 4 N^2 Dh per (graph, head) forward and ~10
// N^2 Dh backward over the pairs with weight, at the 3xTF32 rate (495 / 3 =
// 165 TFLOP/s); with a bias, its N^2 floats read (and dbias written) at
// 3.35 TB/s are the larger term. In practice the softmax's per-logit work
// on the CUDA cores (exp, max, the P split; WIDE's dropout hash) and the
// shared-memory fragment reads share the time with the tensor cores, so
// exp is __expf (relative error ~1e-6 over the logits' range) and the bias
// values of a step are read before its products.
//
// Layout. A block owns R = 16 * WARPS rows (queries; keys in the dk/dv
// pass), a warp 16 of them; up to 64 head columns WARPS = 4 and tiles of
// KT = 64, beyond that 2 and 32 (shared memory). The other side comes
// through shared memory in tiles of KT rows, double-buffered by cp.async;
// once a tile has landed the block splits it in place into a hi plane and a
// lo plane (once, not in every warp). A warp's own rows are split once as
// they are staged: for heads up to 32 columns straight into register
// fragments, wider into shared planes. The head is zero-padded to DP
// columns in shared memory and registers only: a multiple of 8 up to 64
// (24 stays 24: 3 k-steps), then 96 or 128 (no recipe runs those widths;
// two of them keep the build short). Rows have a stride of DP + 4 floats,
// so that both fragment reads below hit 32 distinct banks. S stays in
// registers as mma C fragments: a row's max reduces within its lane quad
// (2 shuffles), its sum is kept per lane and reduced once at the end. P
// goes from the C layout (lane holds keys 2t, 2t+1) to the A layout (lane
// holds columns t, t+4) with no data movement: the k index of P v is
// permuted, column t standing for key 2t and t+4 for key 2t+1, and v's B
// fragment reads keys 2t and 2t+1 to match (b_cols). The backward has no
// float atomics: a dq pass per query tile writes dq (and FLASH's dbias,
// each element by its one owner) and D = dO . o per row; a dk/dv pass per
// key tile forms S^T = k q^T and dP^T = v dO^T directly. Every sum runs in
// a fixed order: two runs, same bits.
#pragma once

#include "common.cuh"

namespace ggps {
namespace tc {

enum Mode { FLASH = 0, WIDE = 1 };

// the library's DEFAULT_MASK_VALUE, -0.7 * float32 max, rounded to f32 once
constexpr float FA_MASK = (float)(-0.7 * 3.4028234663852886e38);
constexpr float WA_NEG = -1e30f;
constexpr int SUB = 32;  // keys (queries in the dk/dv pass) per register step
constexpr unsigned FULL = 0xffffffffu;

// One tensor's rows of a head: element (b, h, i, c) at p + b*sb + h*sh + i*ld + c.
struct View {
  float* p;
  long long sb, sh;
  int ld;
  __device__ __forceinline__ float* at(int b, int h) const { return p + b * sb + h * sh; }
};

inline View view(const float* p, long long sb, long long sh, int ld) {
  return View{const_cast<float*>(p), sb, sh, ld};
}

struct Params {
  View q, k, v, o, dO, dq, dk, dv;
  const int* ids;      // FLASH: (B, N) segment ids
  const float* bias;   // FLASH: (B, H, N, N) or null
  float* dbias;        // FLASH backward: like bias, or null
  const int* counts;   // WIDE: (B,) real nodes
  float* lse;          // FLASH: (B*H*N) row log-sum-exps
  float* mrow;         // WIDE: row maxima
  float* lrow;         // WIDE: row sums before dropout
  float* drow;         // backward: D = dO . o per row
  int N, H, Dh;
  float scale;
  Drop drop;           // WIDE: site 0 of the (B*H*N, N) view
  bool vec4;           // rows copied by cp.async are 16-byte chunks
};

// Shapes of a head width padded to DP columns.
template <int DP>
struct Cfg {
  static constexpr int KS = DP / 8;                 // k-steps over the head
  static constexpr int LD = DP + 4;                 // shared row stride (floats)
  static constexpr int WARPS = DP <= 64 ? 4 : 2;
  static constexpr int NT = 32 * WARPS;
  static constexpr int R = 16 * WARPS;              // rows a block owns
  static constexpr int KT = DP <= 64 ? 64 : 32;     // rows of a staged tile
  // a warp's own rows as A fragments in registers (narrow heads) or in
  // shared hi/lo planes
  static constexpr bool AREG = KS <= 4;
  static constexpr size_t own = AREG ? 0 : (size_t)2 * R * LD * 4;  // a tensor's planes
  // two raw/hi stages and one lo plane per tiled tensor
  static constexpr size_t tiles = (size_t)6 * KT * LD * 4;
  static constexpr size_t fwd_smem = own + tiles;
  static constexpr size_t bwd_smem = 2 * own + tiles + 3 * KT * 4;
};

// The padded widths: multiples of 8 up to 64, then 96 and 128 (wider heads
// run on no recipe; two widths there keep the build short).
constexpr int pad_width(int Dh) { return Dh <= 64 ? (Dh + 7) / 8 * 8 : Dh <= 96 ? 96 : 128; }
constexpr int next_width(int DP) { return DP < 64 ? DP + 8 : DP < 96 ? 96 : DP + 32; }

// ---------------------------------------------------------------------------
// tf32 and the tensor-core product

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct AFrag { uint32_t h[4], l[4]; };  // 16 x 8 A operand, hi and lo
struct BFrag { uint32_t h[2], l[2]; };  // 8 x 8 B operand, hi and lo

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32. The tensor cores truncate as they add, so the three
// products go into a zeroed fragment, the small terms first (each
// truncation at the size of one k-step's 8 products, not of the running
// sum), and one rounded f32 add takes them into d.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, const BFrag& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(t, a.l, b.h[0], b.h[1]);
  mma(t, a.h, b.l[0], b.l[1]);
  mma(t, a.h, b.h[0], b.h[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Fragment lanes: g = lane / 4 (row group), t = lane % 4. A (16 x 8, row):
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4). B (8 x 8, col): b0 (t,
// g), b1 (t+4, g). C (16 x 8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3
// (g+8, 2t+1).

// A = 16 rows of a plane (from its row 0) at columns 8kk ..
template <int LD>
__device__ __forceinline__ AFrag a_rows(const float* hi, const float* lo, int kk, int g,
                                        int t) {
  const int o = g * LD + 8 * kk + t;
  const int off[4] = {o, o + 8 * LD, o + 4, o + 8 * LD + 4};
  AFrag a;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.h[e] = __float_as_uint(hi[off[e]]);
    a.l[e] = __float_as_uint(lo[off[e]]);
  }
  return a;
}

// B = (8 rows n0 .. of a plane)^T at columns 8kk ..: for q k^T, k rows
template <int LD>
__device__ __forceinline__ BFrag b_rows(const float* hi, const float* lo, int n0, int kk,
                                        int g, int t) {
  const int o = (n0 + g) * LD + 8 * kk + t;
  BFrag b;
  b.h[0] = __float_as_uint(hi[o]);
  b.h[1] = __float_as_uint(hi[o + 4]);
  b.l[0] = __float_as_uint(lo[o]);
  b.l[1] = __float_as_uint(lo[o + 4]);
  return b;
}

// B = 8 rows k0 .. of a plane at columns n0 ..., the k index permuted as
// a_from_c lays P out: k = t is row k0 + 2t, k = t + 4 row k0 + 2t + 1
template <int LD>
__device__ __forceinline__ BFrag b_cols(const float* hi, const float* lo, int k0, int n0,
                                        int g, int t) {
  const int o = (k0 + 2 * t) * LD + n0 + g;
  BFrag b;
  b.h[0] = __float_as_uint(hi[o]);
  b.h[1] = __float_as_uint(hi[o + LD]);
  b.l[0] = __float_as_uint(lo[o]);
  b.l[1] = __float_as_uint(lo[o + LD]);
  return b;
}

// A warp's 16 own rows as A operand: register fragments, split once as they
// are loaded from device memory (Cfg::AREG), or hi/lo planes in shared
// memory read at each use.
template <int DP>
struct WarpRows {
  static constexpr int KS = Cfg<DP>::KS, LD = Cfg<DP>::LD;
  static constexpr bool REG = Cfg<DP>::AREG;
  AFrag f[REG ? KS : 1];
  const float* hi;
  const float* lo;

  // REG: rows row0 .. row0 + 16 of a head (stride ld), times mul; rows from
  // N on and columns from Dh on are 0
  __device__ __forceinline__ void load(const float* src, int ld, int row0, int N, int Dh,
                                       float mul, int g, int t) {
    if constexpr (REG) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + g + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
          const float x = r < N && c < Dh ? src[(size_t)r * ld + c] * mul : 0.0f;
          split(x, f[kk].h[e], f[kk].l[e]);
        }
    }
  }

  __device__ __forceinline__ AFrag get(int kk, int g, int t) const {
    if constexpr (REG)
      return f[kk];
    else
      return a_rows<LD>(hi, lo, kk, g, t);
  }
};

// A from a C fragment (16 rows x 8 keys), split: a0 = c0, a1 = c2, a2 = c1,
// a3 = c3, with b_cols' permutation of k
__device__ __forceinline__ AFrag a_from_c(const float (&c)[4]) {
  AFrag a;
  split(c[0], a.h[0], a.l[0]);
  split(c[2], a.h[1], a.l[1]);
  split(c[1], a.h[2], a.l[2]);
  split(c[3], a.h[3], a.l[3]);
  return a;
}

// ---------------------------------------------------------------------------
// Staging

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// Copies of rows row0 .. row0 + ROWS (those below N) of a head, row stride
// ld, into dst (stride LD). split_rows zeroes what is not copied.
template <int ROWS, int LD, int NT>
__device__ __forceinline__ void issue_rows(float* dst, const float* src, int ld, int row0,
                                           int N, int Dh, bool vec4) {
  const int rows = min(ROWS, N - row0);
  if (vec4) {
    const int w = Dh >> 2;
    for (int i = threadIdx.x; i < rows * w; i += NT) {
      const int r = i / w, c = (i - r * w) * 4;
      cp_async16(dst + r * LD + c, src + (size_t)(row0 + r) * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dh; i += NT) {
      const int r = i / Dh, c = i - r * Dh;
      cp_async4(dst + r * LD + c, src + (size_t)(row0 + r) * ld + c);
    }
  }
}

// A landed tile split in place: hi over the raw values (times mul), lo
// beside; rows from N on and columns from Dh on become 0.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int row0, int N, int Dh,
                                           float mul) {
  constexpr int LD = DP + 4;
  for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    const float x = row0 + r < N && c < Dh ? hi[r * LD + c] * mul : 0.0f;
    uint32_t h, l;
    split(x, h, l);
    hi[r * LD + c] = __uint_as_float(h);
    lo[r * LD + c] = __uint_as_float(l);
  }
}

// A block's own rows straight from device memory into hi and lo planes.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_split(float* hi, float* lo, const float* src, int ld,
                                           int row0, int N, int Dh, float mul) {
  constexpr int LD = DP + 4;
  for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    const float x =
        row0 + r < N && c < Dh ? src[(size_t)(row0 + r) * ld + c] * mul : 0.0f;
    uint32_t h, l;
    split(x, h, l);
    hi[r * LD + c] = __uint_as_float(h);
    lo[r * LD + c] = __uint_as_float(l);
  }
}

// The tile loop: tile it + 1's copies are in flight while tile it is split
// (prep) and used (body). own() stages the block's rows after tile 0's
// copies are issued.
template <class Issue, class Own, class Prep, class Body>
__device__ __forceinline__ void pipeline(int ntiles, Issue issue, Own own, Prep prep,
                                         Body body) {
  if (ntiles > 0) issue(0, 0);
  cp_commit();
  own();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    prep(it, it & 1);
    __syncthreads();
    body(it, it & 1);
    __syncthreads();
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// FLASH's logit of a (query, key) pair from its dot product and bias value,
// as the library forms it
__device__ __forceinline__ float flash_logit(float dot, float bias, float scale, bool same) {
  const float s = (dot + bias) * scale;
  return same ? s : s + FA_MASK;
}

// WIDE: keys a (graph, head) attends to: its real nodes, or all N slots when
// it has none (uniform weights)
__device__ __forceinline__ int wide_count(const Params& pr, int b) {
  return min(max(pr.counts[b], 0), pr.N);
}

// ---------------------------------------------------------------------------
// Forward (WIDE): o and the row maxima and sums. (flash_mha.cu keeps its
// CUDA-core forward; its notes say why.)

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NT) attn_fwd(const Params pr) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, KS = C::KS, R = C::R, KT = C::KT, NT = C::NT;
  constexpr int NS = SUB / 8;
  extern __shared__ float smem[];
  float* Qh = smem;                                 // [R][LD] q rows unless AREG
  float* Kb = Qh + C::own / 4;                      // [2][KT][LD] raw, then hi
  float* Kl = Kb + 2 * KT * LD;                     // [KT][LD]
  float* Vb = Kl + KT * LD;
  float* Vl = Vb + 2 * KT * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int N = pr.N, Dh = pr.Dh;
  const size_t stat0 = ((size_t)b * pr.H + h) * N;
  const float* kb = pr.k.at(b, h);
  const float* vb = pr.v.at(b, h);
  const int cnt = wide_count(pr, b);
  const int kend = cnt == 0 ? N : cnt;

  int row[2];
  float m[2] = {WA_NEG, WA_NEG}, l[2] = {0.0f, 0.0f}, acc[KS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = q0 + warp * 16 + g + 8 * r;
#pragma unroll
  for (int dd = 0; dd < KS; ++dd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dd][e] = 0.0f;
  WarpRows<DP> qa;
  qa.hi = Qh + warp * 16 * LD;
  qa.lo = Qh + R * LD + warp * 16 * LD;

  auto issue = [&](int it, int s) {
    issue_rows<KT, LD, NT>(Kb + s * KT * LD, kb, pr.k.ld, it * KT, N, Dh, pr.vec4);
    issue_rows<KT, LD, NT>(Vb + s * KT * LD, vb, pr.v.ld, it * KT, N, Dh, pr.vec4);
  };
  auto own = [&]() {
    if constexpr (C::AREG)
      qa.load(pr.q.at(b, h), pr.q.ld, q0 + warp * 16, N, Dh, pr.scale, g, t);
    else
      load_split<R, DP, NT>(Qh, Qh + R * LD, pr.q.at(b, h), pr.q.ld, q0, N, Dh, pr.scale);
  };
  auto prep = [&](int it, int s) {
    split_rows<KT, DP, NT>(Kb + s * KT * LD, Kl, it * KT, N, Dh, 1.0f);
    split_rows<KT, DP, NT>(Vb + s * KT * LD, Vl, it * KT, N, Dh, 1.0f);
  };
  auto body = [&](int it, int s) {
    const float* kh = Kb + s * KT * LD;
    const float* vh = Vb + s * KT * LD;
    const int k0 = it * KT;
    for (int kc = 0; kc < KT && k0 + kc < kend; kc += SUB) {
      float sc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const AFrag a = qa.get(kk, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) mma3(sc[n], a, b_rows<LD>(kh, Kl, kc + 8 * n, kk, g, t));
      }
      // logits, then the online-softmax step per row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + kc + 8 * n + 2 * t + (e & 1);
          float& x = sc[n][e];
          x = j < cnt ? x : WA_NEG;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = k0 + kc + 8 * n + 2 * t + (e & 1);
          const float pv = j < N ? __expf(sc[n][e] - m[r]) : 0.0f;
          l[r] += pv;
          sc[n][e] = drop_apply(pr.drop, (stat0 + row[r]) * (unsigned long long)N + j, pv);
        }
#pragma unroll
      for (int dd = 0; dd < KS; ++dd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dd][e] *= corr[e >> 1];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const AFrag a = a_from_c(sc[n]);
#pragma unroll
        for (int dd = 0; dd < KS; ++dd)
          mma3(acc[dd], a, b_cols<LD>(vh, Vl, kc + 8 * n, 8 * dd, g, t));
      }
    }
  };
  pipeline((kend + KT - 1) / KT, issue, own, prep, body);

  float* ob = pr.o.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    if (row[r] >= N) continue;
    const float inv = 1.0f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < KS; ++dd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dd + 2 * t + e;
        if (c < Dh) ob[(size_t)row[r] * pr.o.ld + c] = acc[dd][2 * r + e] * inv;
      }
    if (t == 0) {
      pr.mrow[stat0 + row[r]] = m[r];
      pr.lrow[stat0 + row[r]] = lt;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 1: dq (FLASH: and dbias) of a tile of query rows over the
// key tiles, and D = dO . o per row, written for pass 2.

template <int MODE, int DP>
__global__ void __launch_bounds__(Cfg<DP>::NT) attn_dq(const Params pr) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, KS = C::KS, R = C::R, KT = C::KT, NT = C::NT;
  constexpr int NS = SUB / 8;
  extern __shared__ float smem[];
  float* Qh = smem;                                 // [R][LD] q rows unless AREG
  float* Gh = Qh + C::own / 4;                      // [R][LD] dO rows unless AREG
  float* Kb = Gh + C::own / 4;                      // [2][KT][LD] raw, then hi
  float* Kl = Kb + 2 * KT * LD;
  float* Vb = Kl + KT * LD;
  float* Vl = Vb + 2 * KT * LD;
  int* Tk = reinterpret_cast<int*>(Vl + KT * LD);  // [KT] key segment ids (FLASH)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int N = pr.N, Dh = pr.Dh;
  const size_t stat0 = ((size_t)b * pr.H + h) * N;
  const float* kb = pr.k.at(b, h);
  const float* vb = pr.v.at(b, h);
  const int cnt = MODE == WIDE ? wide_count(pr, b) : N;
  const int kend = MODE == WIDE && cnt == 0 ? N : cnt;
  const float qmul = MODE == WIDE ? pr.scale : 1.0f;

  int row[2], qid[2] = {0, 0};
  const float* brow[2] = {nullptr, nullptr};
  float* dbrow[2] = {nullptr, nullptr};
  // FLASH: Lr = lse; WIDE: Lr = row max, inv = 1 / row sum
  float Lr[2], inv[2], D[2], acc[KS][4];
  const float* ob = pr.o.at(b, h);
  const float* gb = pr.dO.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + g + 8 * r;
    const bool ok = row[r] < N;
    Lr[r] = inv[r] = 0.0f;
    if (ok) {
      if (MODE == FLASH) {
        Lr[r] = pr.lse[stat0 + row[r]];
        qid[r] = pr.ids[(size_t)b * N + row[r]];
        if (pr.bias != nullptr) brow[r] = pr.bias + (stat0 + row[r]) * N;
        if (pr.dbias != nullptr) dbrow[r] = pr.dbias + (stat0 + row[r]) * N;
      } else {
        Lr[r] = pr.mrow[stat0 + row[r]];
        inv[r] = 1.0f / fmaxf(pr.lrow[stat0 + row[r]], 1e-30f);
      }
    }
    float part = 0.0f;
    if (ok)
      for (int c = t; c < Dh; c += 4)
        part = fmaf(gb[(size_t)row[r] * pr.dO.ld + c], ob[(size_t)row[r] * pr.o.ld + c],
                    part);
    D[r] = quad_sum(part);
    if (ok && t == 0) pr.drow[stat0 + row[r]] = D[r];
  }
#pragma unroll
  for (int dd = 0; dd < KS; ++dd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dd][e] = 0.0f;
  WarpRows<DP> qa, ga;
  qa.hi = Qh + warp * 16 * LD;
  qa.lo = Qh + R * LD + warp * 16 * LD;
  ga.hi = Gh + warp * 16 * LD;
  ga.lo = Gh + R * LD + warp * 16 * LD;

  auto issue = [&](int it, int s) {
    issue_rows<KT, LD, NT>(Kb + s * KT * LD, kb, pr.k.ld, it * KT, N, Dh, pr.vec4);
    issue_rows<KT, LD, NT>(Vb + s * KT * LD, vb, pr.v.ld, it * KT, N, Dh, pr.vec4);
  };
  auto own = [&]() {
    if constexpr (C::AREG) {
      qa.load(pr.q.at(b, h), pr.q.ld, q0 + warp * 16, N, Dh, qmul, g, t);
      ga.load(gb, pr.dO.ld, q0 + warp * 16, N, Dh, 1.0f, g, t);
    } else {
      load_split<R, DP, NT>(Qh, Qh + R * LD, pr.q.at(b, h), pr.q.ld, q0, N, Dh, qmul);
      load_split<R, DP, NT>(Gh, Gh + R * LD, gb, pr.dO.ld, q0, N, Dh, 1.0f);
    }
  };
  auto prep = [&](int it, int s) {
    split_rows<KT, DP, NT>(Kb + s * KT * LD, Kl, it * KT, N, Dh, 1.0f);
    split_rows<KT, DP, NT>(Vb + s * KT * LD, Vl, it * KT, N, Dh, 1.0f);
    if (MODE == FLASH)
      for (int i = threadIdx.x; i < KT; i += NT)
        Tk[i] = it * KT + i < N ? pr.ids[(size_t)b * N + it * KT + i] : 0;
  };
  auto body = [&](int it, int s) {
    const float* kh = Kb + s * KT * LD;
    const float* vh = Vb + s * KT * LD;
    const int k0 = it * KT;
    for (int kc = 0; kc < KT && k0 + kc < kend; kc += SUB) {
      float bv[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + kc + 8 * n + 2 * t + (e & 1);
          bv[n][e] = MODE == FLASH && brow[e >> 1] != nullptr && j < N ? brow[e >> 1][j] : 0.0f;
        }
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const AFrag aq = qa.get(kk, g, t);
        const AFrag ag = ga.get(kk, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mma3(sc[n], aq, b_rows<LD>(kh, Kl, kc + 8 * n, kk, g, t));
          mma3(dp[n], ag, b_rows<LD>(vh, Vl, kc + 8 * n, kk, g, t));
        }
      }
      // dS = P (dP' - D), P from the kept statistics (WIDE: dP' the dropped dP)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, jt = kc + 8 * n + 2 * t + (e & 1), j = k0 + jt;
          float ds;
          if (MODE == FLASH) {
            const float pv =
                j < N ? __expf(flash_logit(sc[n][e], bv[n][e], pr.scale, Tk[jt] == qid[r]) -
                               Lr[r])
                      : 0.0f;
            ds = pv * (dp[n][e] - D[r]);
            if (j < N && dbrow[r] != nullptr) dbrow[r][j] = ds * pr.scale;
          } else {
            const float sv = j < cnt ? sc[n][e] : WA_NEG;
            const float pv = j < N ? __expf(sv - Lr[r]) * inv[r] : 0.0f;
            const unsigned long long idx = (stat0 + row[r]) * (unsigned long long)N + j;
            ds = pv * (drop_apply(pr.drop, idx, dp[n][e]) - D[r]);
          }
          sc[n][e] = ds;
        }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const AFrag a = a_from_c(sc[n]);
#pragma unroll
        for (int dd = 0; dd < KS; ++dd)
          mma3(acc[dd], a, b_cols<LD>(kh, Kl, kc + 8 * n, 8 * dd, g, t));
      }
    }
  };
  pipeline((kend + KT - 1) / KT, issue, own, prep, body);

  float* qg = pr.dq.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= N) continue;
#pragma unroll
    for (int dd = 0; dd < KS; ++dd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dd + 2 * t + e;
        if (c < Dh) qg[(size_t)row[r] * pr.dq.ld + c] = acc[dd][2 * r + e] * pr.scale;
      }
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 2: dk and dv of a tile of keys over the query tiles, from
// S^T = k q^T and dP^T = v dO^T (C fragments: lane holds key g / g+8 and
// queries 2t, 2t+1).

template <int MODE, int DP>
__global__ void __launch_bounds__(Cfg<DP>::NT) attn_dkv(const Params pr) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, KS = C::KS, R = C::R, KT = C::KT, NT = C::NT;
  constexpr int NS = SUB / 8;
  extern __shared__ float smem[];
  float* Kh = smem;                 // [R][LD] the block's keys unless AREG
  float* Vh = Kh + C::own / 4;      // [R][LD] their values unless AREG
  float* Qb = Vh + C::own / 4;      // [2][KT][LD] q rows raw, then hi (WIDE: times scale)
  float* Ql = Qb + 2 * KT * LD;
  float* Gb = Ql + KT * LD;         // [2][KT][LD] dO rows
  float* Gl = Gb + 2 * KT * LD;
  float* Ls = Gl + KT * LD;         // [KT] FLASH: lse; WIDE: row max
  float* Ds = Ls + KT;              // [KT] D
  float* Xs = Ds + KT;              // [KT] FLASH: query segment ids; WIDE: 1 / row sum
  int* Xi = reinterpret_cast<int*>(Xs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * R;
  const int N = pr.N, Dh = pr.Dh;
  const size_t stat0 = ((size_t)b * pr.H + h) * N;
  const float* qb = pr.q.at(b, h);
  const float* gb = pr.dO.at(b, h);
  const int cnt = MODE == WIDE ? wide_count(pr, b) : N;
  // WIDE: keys beyond the real ones get no weight, so no gradient: zeros
  const bool live = MODE == FLASH || k0 < (cnt == 0 ? N : cnt);

  int key[2], kid[2] = {0, 0};
  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + warp * 16 + g + 8 * r;
    if (MODE == FLASH && key[r] < N) kid[r] = pr.ids[(size_t)b * N + key[r]];
  }
#pragma unroll
  for (int dd = 0; dd < KS; ++dd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dd][e] = dv[dd][e] = 0.0f;
  WarpRows<DP> ka, va;
  ka.hi = Kh + warp * 16 * LD;
  ka.lo = Kh + R * LD + warp * 16 * LD;
  va.hi = Vh + warp * 16 * LD;
  va.lo = Vh + R * LD + warp * 16 * LD;
  const float qmul = MODE == WIDE ? pr.scale : 1.0f;

  auto issue = [&](int it, int s) {
    issue_rows<KT, LD, NT>(Qb + s * KT * LD, qb, pr.q.ld, it * KT, N, Dh, pr.vec4);
    issue_rows<KT, LD, NT>(Gb + s * KT * LD, gb, pr.dO.ld, it * KT, N, Dh, pr.vec4);
  };
  auto own = [&]() {
    if constexpr (C::AREG) {
      ka.load(pr.k.at(b, h), pr.k.ld, k0 + warp * 16, N, Dh, 1.0f, g, t);
      va.load(pr.v.at(b, h), pr.v.ld, k0 + warp * 16, N, Dh, 1.0f, g, t);
    } else {
      load_split<R, DP, NT>(Kh, Kh + R * LD, pr.k.at(b, h), pr.k.ld, k0, N, Dh, 1.0f);
      load_split<R, DP, NT>(Vh, Vh + R * LD, pr.v.at(b, h), pr.v.ld, k0, N, Dh, 1.0f);
    }
  };
  auto prep = [&](int it, int s) {
    split_rows<KT, DP, NT>(Qb + s * KT * LD, Ql, it * KT, N, Dh, qmul);
    split_rows<KT, DP, NT>(Gb + s * KT * LD, Gl, it * KT, N, Dh, 1.0f);
    for (int i = threadIdx.x; i < KT; i += NT) {
      const int q = it * KT + i;
      const bool ok = q < N;
      Ds[i] = ok ? pr.drow[stat0 + q] : 0.0f;
      if (MODE == FLASH) {
        Ls[i] = ok ? pr.lse[stat0 + q] : 0.0f;
        Xi[i] = ok ? pr.ids[(size_t)b * N + q] : 0;
      } else {
        Ls[i] = ok ? pr.mrow[stat0 + q] : 0.0f;
        Xs[i] = ok ? 1.0f / fmaxf(pr.lrow[stat0 + q], 1e-30f) : 0.0f;
      }
    }
  };
  auto body = [&](int it, int s) {
    const float* qh = Qb + s * KT * LD;
    const float* gh = Gb + s * KT * LD;
    const int q0 = it * KT;
    for (int qc = 0; qc < KT && q0 + qc < N; qc += SUB) {
      // FLASH: the bias values of this step (query 2t(+1) rows, key g/g+8)
      float bv[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + qc + 8 * n + 2 * t + (e & 1), j = key[e >> 1];
          bv[n][e] = MODE == FLASH && pr.bias != nullptr && i < N && j < N
                         ? pr.bias[(stat0 + i) * N + j]
                         : 0.0f;
        }
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const AFrag ak = ka.get(kk, g, t);
        const AFrag av = va.get(kk, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mma3(st[n], ak, b_rows<LD>(qh, Ql, qc + 8 * n, kk, g, t));
          mma3(dpt[n], av, b_rows<LD>(gh, Gl, qc + 8 * n, kk, g, t));
        }
      }
      // st becomes dS^T, dpt the (dropped) P^T
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, iq = qc + 8 * n + 2 * t + (e & 1), i = q0 + iq, j = key[r];
          const bool ok = i < N && j < N;
          float pv, pd, dpd;
          if (MODE == FLASH) {
            pv = ok ? __expf(flash_logit(st[n][e], bv[n][e], pr.scale, Xi[iq] == kid[r]) -
                             Ls[iq])
                    : 0.0f;
            pd = pv;
            dpd = dpt[n][e];
          } else {
            const float sv = j < cnt ? st[n][e] : WA_NEG;
            pv = ok ? __expf(sv - Ls[iq]) * Xs[iq] : 0.0f;
            const bool keep =
                pr.drop.t <= 0 ||
                drop_keep(pr.drop, (stat0 + i) * (unsigned long long)N + j);
            const float sc = pr.drop.t <= 0 ? 1.0f : pr.drop.scale;
            pd = keep ? pv * sc : 0.0f;
            dpd = keep ? dpt[n][e] * sc : 0.0f;
          }
          st[n][e] = pv * (dpd - Ds[iq]);
          dpt[n][e] = pd;
        }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const AFrag as = a_from_c(st[n]);
        const AFrag ap = a_from_c(dpt[n]);
#pragma unroll
        for (int dd = 0; dd < KS; ++dd) {
          mma3(dk[dd], as, b_cols<LD>(qh, Ql, qc + 8 * n, 8 * dd, g, t));
          mma3(dv[dd], ap, b_cols<LD>(gh, Gl, qc + 8 * n, 8 * dd, g, t));
        }
      }
    }
  };
  pipeline(live ? (N + KT - 1) / KT : 0, issue, own, prep, body);

  // FLASH's dk carries the scale here; WIDE's q rows carried it already
  const float kmul = MODE == FLASH ? pr.scale : 1.0f;
  float* kg = pr.dk.at(b, h);
  float* vg = pr.dv.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
#pragma unroll
    for (int dd = 0; dd < KS; ++dd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dd + 2 * t + e;
        if (c >= Dh) continue;
        kg[(size_t)key[r] * pr.dk.ld + c] = dk[dd][2 * r + e] * kmul;
        vg[(size_t)key[r] * pr.dv.ld + c] = dv[dd][2 * r + e];
      }
  }
}

// ---------------------------------------------------------------------------
// Launches on the caller's stream, at the head width padded to DP.

inline bool rows_vec4(const View& v, int Dh) {
  return Dh % 4 == 0 && v.ld % 4 == 0 && v.sb % 4 == 0 && v.sh % 4 == 0 &&
         ((uintptr_t)v.p & 15) == 0;
}

template <int DP>
cudaError_t launch_fwd_dp(const Params& pr, int B, cudaStream_t st) {
  using C = Cfg<DP>;
  const dim3 grid(cdiv(pr.N, C::R), pr.H, B), block(C::NT);
  cudaError_t err;
  if ((err = allow_smem(attn_fwd<DP>, C::fwd_smem)) != cudaSuccess) return err;
  attn_fwd<DP><<<grid, block, C::fwd_smem, st>>>(pr);
  return cudaGetLastError();
}

template <int MODE, int DP>
cudaError_t launch_bwd_dp(const Params& pr, int B, cudaStream_t st) {
  using C = Cfg<DP>;
  const dim3 grid(cdiv(pr.N, C::R), pr.H, B), block(C::NT);
  cudaError_t err;
  if ((err = allow_smem(attn_dq<MODE, DP>, C::bwd_smem)) != cudaSuccess) return err;
  attn_dq<MODE, DP><<<grid, block, C::bwd_smem, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attn_dkv<MODE, DP>, C::bwd_smem)) != cudaSuccess) return err;
  attn_dkv<MODE, DP><<<grid, block, C::bwd_smem, st>>>(pr);
  return cudaGetLastError();
}

// The forward kernel (BWD false; WIDE only) or the two backward passes, for
// pr.Dh up to MAX_DP, at the padded width pad_width(pr.Dh).
template <int MODE, bool BWD, int MAX_DP, int DP = 8>
cudaError_t launch(const Params& pr, int B, cudaStream_t st) {
  if constexpr (DP > MAX_DP) {
    return cudaErrorInvalidValue;
  } else {
    if (pad_width(pr.Dh) == DP) {
      if constexpr (BWD)
        return launch_bwd_dp<MODE, DP>(pr, B, st);
      else
        return launch_fwd_dp<DP>(pr, B, st);
    }
    return launch<MODE, BWD, MAX_DP, next_width(DP)>(pr, B, st);
  }
}

}  // namespace tc
}  // namespace ggps
