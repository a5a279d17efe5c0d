// Segment-masked multi-head attention with an optional additive bias, by an
// online softmax over key tiles (flash attention), forward and backward.
//
// Replaces graphgps_tpu/ops/pallas/flash_mha.py:67 flash_mha, which calls the
// TPU flash kernel of jax.experimental.pallas.ops.tpu.flash_attention (its
// forward and backward pallas_calls live in that library). Its semantics are
// copied, not re-invented: for q, k, v (B, H, N, Dh), segment ids
// ids = key_mask (B, N) as int (padded 0, real 1) and bias (B, H, N, N),
//
//   s   = (q k^T + bias) * scale,  scale = 1/sqrt(Dh)   (the scale multiplies
//                                                        the bias too)
//   s  += MASK where ids[query] != ids[key],  MASK = -0.7 * FLT_MAX (added,
//         not assigned: a padded query row attends over the padded keys of
//         its graph; real rows see the real keys only)
//   o   = softmax(s) v
//
// The TPU wrapper pads Dh to 128 lanes (pad_head_dim, flash_mha.py:51); here
// the kernels run at the true head width (24 on VOC superpixels).
//
// Bound on the H100: operations, 4*N^2*Dh per (graph, head) forward and
// about 2.5 times that backward; with a bias the (B, H, N, N) bias read (and
// dbias written) is the larger term in bytes.
//
// Forward (flash_fwd_dmma), in f64 on the FP64 tensor cores: the f32
// inputs are exact in f64, and the logits (q k^T on DMMA, tc_mma.cuh dmma;
// the bias, the scale 1/sqrt(Dh) in f64 and the mask value added in f64),
// the online softmax (row max, CUDA's f64 exp, row sum) and P v (DMMA)
// all run in f64; only o and the rows' log-sum-exps m + log(l) are rounded
// to f32, once. So o is the exact attention correctly rounded to within f64
// rounding: the bits of the plain version evaluated in f64 and rounded
// (chip_smoke.py 3i holds every entry within 1 f32 ulp of them). On VOC
// under flash that matters: its training step has relu units within
// rounding of the kink, which side they fall on follows the attention
// output's bits, and every f32 tensor-core forward (3xTF32, more accurate
// than the f32 loop it would replace, other bits) moved one clean weight
// entry of chip_smoke.py's card-vs-CPU step (4c) out of its tolerance; the
// f64 output rounded to f32 passes (PERF.md §6).
//
// Layout: a block owns R = 16 * WARPS query rows of one (graph, head), a
// warp 16; keys and values come through shared memory in tiles of KT rows,
// copied raw by cp.async (double-buffered) and, once landed, widened once
// into an f64 k plane [KT][LDK] and an f64 v^T plane [DP][LDV] that every
// warp reads, with the tile's key segment ids. The head is zero-padded to
// DP columns (a multiple of 8; 96 or 128 above 64). Both products permute
// their k index so that a lane's two B values are neighbours in shared
// memory, read as one 16-byte load: in q k^T k = t stands for head column
// 2t and t + 4 for 2t + 1 (q's A fragment follows); in P v k = t stands for
// key 2t and t + 4 for 2t + 1, which is also how P leaves the C fragment of
// q k^T (a lane holds keys 2t, 2t + 1), so P becomes the A operand without
// data movement. LDK and LDV are 8 mod 16 doubles: a quarter warp's eight
// 16-byte reads hit distinct banks. A warp's q rows sit in registers up to
// 32 columns, wider in an f64 shared plane. S stays in registers as DMMA C
// fragments: a row's max reduces within its lane quad, its sum is kept per
// lane and reduced once at the end. Bound: operations, 4 N^2 Dh per (graph,
// head) on the FP64 tensor cores (67 TFLOP/s) plus the f64 exp of every
// logit on the f64 CUDA cores; with a bias its N^2 floats read.
//
// Backward, the FLASH mode of the tensor-core body attn_tc.cuh (3xTF32
// mma.sync; its notes give the layout), with no float atomics: a dq pass per
// query tile recomputes P = exp(s - lse), forms D = dO . o per row,
// dS = P (dO v^T - D), dq = scale * dS k and, with a bias, dbias = scale * dS
// (each element written by its one owner); then a dk/dv pass per key tile
// forms dk = scale * dS^T q and dv = P^T dO. Every sum runs in a fixed order,
// so two runs give the same bits. Bound at the 3xTF32 rate (165 TFLOP/s).
#include "attn_tc.cuh"

namespace ggps {
namespace {

// ops/kernels/flash_mha.py MAX_HEAD_DIM: the widest padded head of the
// forward's instantiations and of the body's backward
constexpr int FA_MAX_DH = 128;
// the library's DEFAULT_MASK_VALUE in f64, as the plain version adds it
constexpr double FA_MASK_F64 = -0.7 * 3.4028234663852886e38;
using tc::FULL;

// Shapes of the f64 forward at a head width padded to DP columns.
template <int DP>
struct Fwd {
  static constexpr int KS = DP / 8;                 // k-steps over the head
  static constexpr int WARPS = DP <= 64 ? 4 : 2;
  static constexpr int NT = 32 * WARPS;
  static constexpr int R = 16 * WARPS;              // query rows a block owns
  // keys of a staged tile and of a register step: fewer for wide heads, so
  // that two blocks fit an SM's shared memory and the sums its registers
  static constexpr int KT = DP <= 32 ? 64 : DP <= 64 ? 32 : 16;
  static constexpr int SUB = DP <= 64 ? 32 : 16;
  static constexpr bool QREG = DP <= 32;            // q fragments in registers
  static constexpr int LDR = DP + 4;                // raw f32 row stride
  static constexpr int LDK = DP % 16 == 8 ? DP : DP + 8;  // f64 k and q rows
  static constexpr int LDV = KT + 8;                // f64 v^T rows
  static constexpr size_t smem = ((size_t)KT * LDK + (size_t)DP * LDV +
                                  (QREG ? 0 : (size_t)R * LDK)) * 8 +
                                 (size_t)4 * KT * LDR * 4 + (size_t)KT * 4;
};

__device__ __forceinline__ double quad_max(double v) {
  v = fmax(v, __shfl_xor_sync(FULL, v, 1));
  return fmax(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Two neighbouring f64 values of a shared plane (p 16-byte aligned).
__device__ __forceinline__ double2 pair(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

template <int DP>
__global__ void __launch_bounds__(Fwd<DP>::NT)
flash_fwd_dmma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ ids,
               const float* __restrict__ bias, float* __restrict__ o,
               float* __restrict__ lse, int N, int H, int Dh, double scale, bool vec4) {
  using C = Fwd<DP>;
  constexpr int KS = C::KS, R = C::R, KT = C::KT, NT = C::NT, NS = C::SUB / 8;
  constexpr int LDK = C::LDK, LDV = C::LDV, LDR = C::LDR;
  extern __shared__ __align__(16) double fsmem[];
  double* Kp = fsmem;                                   // [KT][LDK] k rows
  double* Vt = Kp + KT * LDK;                           // [DP][LDV] v columns
  double* Qs = Vt + DP * LDV;                           // [R][LDK] unless QREG
  float* raw = reinterpret_cast<float*>(Qs + (C::QREG ? 0 : R * LDK));  // [2][k, v][KT][LDR]
  int* Is = reinterpret_cast<int*>(raw + 4 * KT * LDR);  // [KT] key segment ids

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const size_t head = ((size_t)b * H + h) * N;     // this (graph, head)'s first row
  const float* qb = q + head * Dh;
  const float* kb = k + head * Dh;
  const float* vb = v + head * Dh;
  const int* gid = ids + (size_t)b * N;

  int row[2], qid[2];
  const float* brow[2];
  double m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0, 0.0}, acc[KS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + g + 8 * r;
    const bool ok = row[r] < N;
    qid[r] = ok ? gid[row[r]] : 0;
    brow[r] = bias != nullptr && ok ? bias + (head + row[r]) * N : nullptr;
  }
#pragma unroll
  for (int dd = 0; dd < KS; ++dd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dd][e] = 0.0;
  // q's A fragments, k index t standing for head column 2t and t + 4 for
  // 2t + 1: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+1), a3 (g+8, 2t+1)
  double qa[C::QREG ? KS : 1][4];
  const double* qw = Qs + warp * 16 * LDK + g * LDK + 2 * t;

  auto issue = [&](int it, int s) {
    float* st = raw + s * 2 * KT * LDR;
    tc::issue_rows<KT, LDR, NT>(st, kb, Dh, it * KT, N, Dh, vec4);
    tc::issue_rows<KT, LDR, NT>(st + KT * LDR, vb, Dh, it * KT, N, Dh, vec4);
  };
  auto own = [&]() {
    if constexpr (C::QREG) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e & 1], c = 8 * kk + 2 * t + (e >> 1);
          qa[kk][e] = r < N && c < Dh ? (double)qb[(size_t)r * Dh + c] : 0.0;
        }
    } else {
      for (int i = threadIdx.x; i < R * DP; i += NT) {
        const int r = i / DP, c = i - r * DP;
        Qs[r * LDK + c] = q0 + r < N && c < Dh ? (double)qb[(size_t)(q0 + r) * Dh + c] : 0.0;
      }
    }
  };
  // the landed tile widened to f64 once: rows from N on and columns from Dh
  // on become 0; v transposed (consecutive threads on consecutive keys)
  auto prep = [&](int it, int s) {
    const float* rk = raw + s * 2 * KT * LDR;
    const float* rv = rk + KT * LDR;
    const int r0 = it * KT;
    for (int i = threadIdx.x; i < KT * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      Kp[r * LDK + c] = r0 + r < N && c < Dh ? (double)rk[r * LDR + c] : 0.0;
    }
    for (int i = threadIdx.x; i < KT * DP; i += NT) {
      const int c = i / KT, r = i - c * KT;
      Vt[c * LDV + r] = r0 + r < N && c < Dh ? (double)rv[r * LDR + c] : 0.0;
    }
    if (threadIdx.x < KT) Is[threadIdx.x] = r0 + threadIdx.x < N ? gid[r0 + threadIdx.x] : 0;
  };
  auto body = [&](int it, int) {
    const int k0 = it * KT;
    for (int kc = 0; kc < KT && k0 + kc < N; kc += C::SUB) {
      // this step's bias values first: their reads overlap the products
      float bv[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + kc + 8 * n + 2 * t + (e & 1);
          const float* br = brow[e >> 1];
          bv[n][e] = br != nullptr && j < N ? br[j] : 0.0f;
        }
      double sc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        double a[4];
        if constexpr (C::QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          const double2 lo = pair(qw + 8 * kk), hi = pair(qw + 8 * LDK + 8 * kk);
          a[0] = lo.x;
          a[1] = hi.x;
          a[2] = lo.y;
          a[3] = hi.y;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const double2 kv = pair(Kp + (kc + 8 * n + g) * LDK + 8 * kk + 2 * t);
          tc::dmma(sc[n], a, kv.x, kv.y);
        }
      }
      // logits as the library forms them, then the online-softmax step
      double mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * n + 2 * t + (e & 1);
          double x = -INFINITY;
          if (k0 + key < N) {
            x = (sc[n][e] + (double)bv[n][e]) * scale;
            if (Is[key] != qid[e >> 1]) x += FA_MASK_F64;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmax(mx[e >> 1], x);
        }
      double corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const double p = exp(sc[n][e] - m[e >> 1]);  // 0 past N (-inf)
          l[e >> 1] += p;
          sc[n][e] = p;
        }
#pragma unroll
      for (int dd = 0; dd < KS; ++dd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dd][e] *= corr[e >> 1];
      // P v: P's C fragment is the A operand with k = t standing for key 2t
      // and t + 4 for 2t + 1; v^T's two values for them are neighbours
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const double a[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
#pragma unroll
        for (int dd = 0; dd < KS; ++dd) {
          const double2 vv = pair(Vt + (8 * dd + g) * LDV + kc + 8 * n + 2 * t);
          tc::dmma(acc[dd], a, vv.x, vv.y);
        }
      }
    }
  };
  tc::pipeline((N + KT - 1) / KT, issue, own, prep, body);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const double lt = quad_sum(l[r]);
    if (row[r] >= N) continue;
    float* orow = o + (head + row[r]) * Dh;
#pragma unroll
    for (int dd = 0; dd < KS; ++dd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dd + 2 * t + e;
        if (c < Dh) orow[c] = __double2float_rn(acc[dd][2 * r + e] / lt);
      }
    if (t == 0) lse[head + row[r]] = __double2float_rn(m[r] + log(lt));
  }
}

// The forward at the head width padded to DP (tc::pad_width's widths).
template <int DP = 8>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const int* ids,
                       const float* bias, float* o, float* lse, int B, int H, int N,
                       int Dh, double scale, bool vec4, cudaStream_t st) {
  if constexpr (DP > FA_MAX_DH) {
    return cudaErrorInvalidValue;
  } else {
    if (tc::pad_width(Dh) != DP)
      return launch_fwd<tc::next_width(DP)>(q, k, v, ids, bias, o, lse, B, H, N, Dh, scale,
                                             vec4, st);
    using C = Fwd<DP>;
    cudaError_t err = allow_smem(flash_fwd_dmma<DP>, C::smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(cdiv(N, C::R), H, B);
    flash_fwd_dmma<DP><<<grid, C::NT, C::smem, st>>>(q, k, v, ids, bias, o, lse, N, H, Dh,
                                                      scale, vec4);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace ggps

using namespace ggps;

// Inputs q, k, v (B, H, N, Dh), ids (B, N) int32 segment ids, bias
// (B, H, N, N) or null, the scale in f64. Outputs o (B, H, N, Dh) and lse
// (B*H*N), the rows' log-sum-exps the backward takes back.
extern "C" int flash_mha_forward(const float* q, const float* k, const float* v,
                                 const int* ids, const float* bias, float* o, float* lse,
                                 int B, int H, int N, int Dh, double scale, void* stream) {
  if (Dh <= 0 || Dh > FA_MAX_DH) return cudaErrorInvalidValue;
  const bool vec4 = Dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  return launch_fwd(q, k, v, ids, bias, o, lse, B, H, N, Dh, scale, vec4,
                    static_cast<cudaStream_t>(stream));
}

// Inputs: the forward's q, k, v, ids, bias (or null), o and lse, and the
// cotangent dO (B, H, N, Dh). Outputs dq, dk, dv (B, H, N, Dh) and, with a
// bias, dbias (B, H, N, N). Work: Drow (B*H*N).
extern "C" int flash_mha_backward(const float* q, const float* k, const float* v,
                                  const int* ids, const float* bias, const float* o,
                                  const float* lse, const float* dO, float* dq, float* dk,
                                  float* dv, float* dbias, float* Drow, int B, int H,
                                  int N, int Dh, float scale, void* stream) {
  if (Dh <= 0 || Dh > FA_MAX_DH) return cudaErrorInvalidValue;
  const long long sh = (long long)N * Dh, sb = sh * H;
  tc::Params pr = {};
  pr.q = tc::view(q, sb, sh, Dh);
  pr.k = tc::view(k, sb, sh, Dh);
  pr.v = tc::view(v, sb, sh, Dh);
  pr.o = tc::view(o, sb, sh, Dh);
  pr.dO = tc::view(dO, sb, sh, Dh);
  pr.dq = tc::view(dq, sb, sh, Dh);
  pr.dk = tc::view(dk, sb, sh, Dh);
  pr.dv = tc::view(dv, sb, sh, Dh);
  pr.ids = ids;
  pr.bias = bias;
  pr.dbias = dbias;
  pr.lse = const_cast<float*>(lse);
  pr.drow = Drow;
  pr.N = N;
  pr.H = H;
  pr.Dh = Dh;
  pr.scale = scale;
  pr.vec4 = tc::rows_vec4(pr.q, Dh) && tc::rows_vec4(pr.k, Dh) && tc::rows_vec4(pr.v, Dh) &&
            tc::rows_vec4(pr.dO, Dh);
  return tc::launch<tc::FLASH, true, FA_MAX_DH>(pr, B, static_cast<cudaStream_t>(stream));
}
