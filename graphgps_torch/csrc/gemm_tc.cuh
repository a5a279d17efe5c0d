// f32 GEMM on Hopper's tensor cores (3xTF32 mma.sync), in the three layouts
// of gemm.cuh and with its epilogue (common.cuh Epi):
//
//   NN  C[M, N] = epi(A[M, K] @ W[K, N])        forward products, W (in, out)
//   NT  C[M, N] = epi(A[M, K] @ B[N, K]^T)      input gradients G @ W^T
//   TN  C[M, N] = A[K, M]^T @ G[K, N]           weight gradients X^T @ G, K = rows
//
// All operands row-major and contiguous; weights keep the JAX package's
// (in, out) layout, so no transpose is made anywhere. These are the products
// of the GPS layer front (gps_front.cu: the joint (B*N, d) x (d, 7d)
// projection, the edge projection, the out-projection and their input and
// weight gradients), of the GPS attention (gps_attention.cu: the QKV and
// out-projections), of the FFN block of combine_ffn.cu (ffn_core.cuh), of
// the GatedGCN core (gatedgcn.cu) and of the Graphormer MLP block
// (ln_ffn.cu) and of the FFN of bn_ffn.cu and ffn.cu at widths beyond
// their fused route, which the TPU kernels compute in their own bodies
// (_dot, _dot_nt, _dot_tn of ops/pallas/fused_gatedgcn.py); wide_attention's
// projections keep gemm.cuh's CUDA-core loop.
//
// Bound on the H100: at the main path's shapes operations, at the 3xTF32
// rate (495 / 3 = 165 TFLOP/s). Design: a block of 64 x 64
// outputs, 4 warps of 32 x 32, four blocks an SM (128 registers a thread);
// K in tiles of 32 through a ring of three shared-memory stages filled by
// cp.async (16-byte copies, with zero fill past the edges, where every row
// is 16-byte aligned; 4-byte copies otherwise), so any M, N and K work, and
// one barrier a tile. Each thread's copies and each lane's fragment reads
// are a base fixed once plus compile-time offsets. A tile whose k runs along
// device memory is stored [64][32 + 4], one whose rows do [32][64 + 8]: both
// strides make a fragment's 32 reads hit 32 distinct banks. Every warp
// splits the fragments it reads into hi and lo in registers (tc_mma.cuh's
// split) and runs mma3 on them: the three products of a k-step summed in a
// zeroed fragment, then one rounded f32 add. Splitting each landed tile once
// into hi and lo planes instead, as the attention body does, measured slower
// at every main-path shape (PERF.md §6): a tile here is read by two
// warps, not by all of them, so the split saves less than its extra pass,
// stores and second plane of fragment reads cost. The epilogue works on the C
// fragments in registers, its bias and residual loaded ahead of the stores.
// A weight gradient has few output tiles and a long K (all rows), so TN
// splits K over blockIdx.z into partials that a second pass adds in split
// order: no float atomics, and two runs give the same bits.
#pragma once

#include "tc_mma.cuh"

namespace ggps {
namespace tc {

constexpr int SMS = 132;

// The tile: a block of BM x BN outputs in warps of WM x WN, K in tiles of BK
// through a ring of STAGES, MIN_BLOCKS blocks an SM (the registers' launch
// bound). In a sweep over 128 x 128, 128 x 64 and 64 x 128 blocks, warps of
// 64 x 64, tiles of 16 and rings of 2 and 4, this one was the fastest over
// the main path's shapes (PERF.md §6).
struct GemmTile {
  static constexpr int BM = 64, BN = 64, WM = 32, WN = 32, BK = 32, STAGES = 3;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = 32 * (BM / WM) * WARPS_N;  // 128
  static constexpr int MI = WM / 16, NI = WN / 8;      // fragments a warp holds
  static constexpr int MIN_BLOCKS = 4;
};

// One operand's tile: ROWS rows p (A: m; B: n) by BK of k. KC: k is
// contiguous in device memory (X is P x K; else K x P, row-major): the tile
// is stored [ROWS][BK + 4], else [BK][ROWS + 8]; both strides make a
// fragment's 32 reads hit 32 distinct banks. off() is linear, so a lane's
// fragment reads are its base plus compile-time offsets.
template <bool KC, int ROWS, int BK, int NT>
struct Operand {
  static constexpr int LD = KC ? BK + 4 : ROWS + 8;
  static constexpr int SIZE = KC ? ROWS * LD : BK * LD;
  // 16-byte chunks a line of device memory holds, chunks a thread copies
  static constexpr int CH = KC ? BK / 4 : ROWS / 4;
  static constexpr int NCOPY = ROWS * BK / 4 / NT;
  static_assert(NCOPY >= 1 && NT % CH == 0 && NT % (KC ? BK : ROWS) == 0, "tile shape");

  static constexpr __host__ __device__ int off(int p, int k) {
    return KC ? p * LD + k : k * LD + p;
  }

  // A thread's copies: chunk j at line (KC: row p0 + p + j * NT / CH, column
  // kc; else k row k + j * NT / CH, columns pc ..). Device pointers advance
  // by `step` a tile.
  const float* src;   // chunk 0 of tile 0
  long long jstep;    // between chunks
  long long step;     // between tiles
  int soff;           // chunk 0's shared offset
  int kq;             // KC: the chunks' k; else chunk 0's k row
  uint32_t pok;       // KC: bit j, chunk j's row is below P; else all or none

  __device__ __forceinline__ void plan(const float* X, int P, int K, int p0, int k_begin) {
    const int tid = threadIdx.x;
    if (KC) {
      const int p = tid / CH, kc = tid % CH * 4;
      src = X + (size_t)(p0 + p) * K + k_begin + kc;
      jstep = (long long)(NT / CH) * K;
      step = BK;
      soff = off(p, kc);
      kq = kc;
      pok = 0;
#pragma unroll
      for (int j = 0; j < NCOPY; ++j) pok |= (p0 + p + j * (NT / CH) < P ? 1u : 0u) << j;
    } else {
      const int k = tid / CH, pc = tid % CH * 4;
      src = X + (size_t)(k_begin + k) * P + p0 + pc;
      jstep = (long long)(NT / CH) * P;
      step = (long long)BK * P;
      soff = off(pc, k);
      kq = k;
      pok = p0 + pc < P ? ~0u : 0u;
    }
  }

  // Tile it's copies into dst (16-byte chunks, zero fill past the edges)
  __device__ __forceinline__ void issue16(float* dst, const float* X, int it, int k0,
                                          int k_end) const {
    const float* s0 = src + it * step;
#pragma unroll
    for (int j = 0; j < NCOPY; ++j) {
      const int k = KC ? k0 + kq : k0 + kq + j * (NT / CH);
      const bool ok = ((pok >> (KC ? j : 0)) & 1u) && k < k_end;
      cp_async16_zfill(dst + soff + j * (NT / CH) * LD, ok ? s0 + j * jstep : X,
                       ok ? 16 : 0);
    }
  }

  // The same with 4-byte copies, for rows that are not 16-byte aligned
  __device__ __forceinline__ static void issue4(float* dst, const float* X, int P, int K,
                                                int p0, int k0, int k_end) {
    for (int i = threadIdx.x; i < ROWS * BK; i += NT) {
      const int p = KC ? i / BK : i % ROWS;
      const int k = KC ? i % BK : i / ROWS;
      const int gp = p0 + p, gk = k0 + k;
      const bool ok = gp < P && gk < k_end;
      const float* s = ok ? X + (KC ? (size_t)gp * K + gk : (size_t)gk * P + gp) : X;
      cp_async4_zfill(dst + off(p, k), s, ok ? 4 : 0);
    }
  }
};

// A element (m, k): TA ? A[k * M + m] : A[m * K + k]
// B element (k, n): TB ? B[n * K + k] : B[k * N + n]
// blockIdx.z selects a K range of k_split; with gridDim.z > 1 the raw sums go
// to C + z * M * N and the epilogue is not applied.
template <bool TA, bool TB>
__global__ void __launch_bounds__(GemmTile::NT, GemmTile::MIN_BLOCKS)
gemm_tc_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K, int k_split, Epi epi,
               bool vec4) {
  using G = GemmTile;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK;
  using OA = Operand<!TA, BM, BK, G::NT>;
  using OB = Operand<TB, BN, BK, G::NT>;
  constexpr int MI = G::MI, NI = G::NI, S = G::STAGES;
  extern __shared__ float smem[];
  float* Ab = smem;               // [S][OA::SIZE]
  float* Bb = Ab + S * OA::SIZE;  // [S][OB::SIZE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp / G::WARPS_N * G::WM, wn0 = warp % G::WARPS_N * G::WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int ntiles = (k_end - k_begin + BK - 1) / BK;
  // the lane's fragment bases: A rows wm0 + g, B columns wn0 + g, k = t
  const int a_lane = OA::off(wm0 + g, t), b_lane = OB::off(wn0 + g, t);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  OA ca;
  OB cb;
  if (vec4) {
    ca.plan(A, M, K, row0, k_begin);
    cb.plan(B, N, K, col0, k_begin);
  }
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int k0 = k_begin + it * BK, s = it % S;
      if (vec4) {
        ca.issue16(Ab + s * OA::SIZE, A, it, k0, k_end);
        cb.issue16(Bb + s * OB::SIZE, B, it, k0, k_end);
      } else {
        OA::issue4(Ab + s * OA::SIZE, A, M, K, row0, k0, k_end);
        OB::issue4(Bb + s * OB::SIZE, B, N, K, col0, k0, k_end);
      }
    }
    cp_commit();
  };
  auto compute = [&](int it) {
    const float* ah = Ab + it % S * OA::SIZE + a_lane;
    const float* bh = Bb + it % S * OB::SIZE + b_lane;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      BFrag bf[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int o0 = OB::off(8 * j, 8 * kk), o1 = OB::off(8 * j, 8 * kk + 4);
        split(bh[o0], bf[j].h[0], bf[j].l[0]);
        split(bh[o1], bf[j].h[1], bf[j].l[1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        AFrag a;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(ah[OA::off(16 * i + 8 * (e & 1), 8 * kk + 4 * (e >> 1))], a.h[e], a.l[e]);
#pragma unroll
        for (int j = 0; j < NI; ++j) mma3(acc[i][j], a, bf[j]);
      }
    }
  };

  // One barrier a tile: tiles it + 1 .. it + S - 1 are in flight while tile
  // it's fragments are split and used; the barrier also frees the stage
  // that tile it + S - 1 fills (tile it - 1's).
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<S - 2>();
    __syncthreads();
    issue(it + S - 1);
    compute(it);
  }

  const bool split_k = gridDim.z > 1;
  float* Cz = C + (split_k ? (size_t)blockIdx.z * M * N : 0);
  // The epilogue loads its bias, and a fragment's residual, ahead of that
  // fragment's stores: C may alias them as far as the compiler knows, so a
  // load after a store waits for it, and loaded in turn the residual's 32
  // loads a thread ran one after another (ln_ffn's second product at ZINC's
  // shapes: PERF.md §6). A fragment at a time keeps the registers in
  // bounds (a row of fragments at a time spilled).
  float bv[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + wn0 + 8 * j + 2 * t + e;
      bv[j][e] = !split_k && epi.bias != nullptr && c < N ? epi.bias[c] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float rv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + 16 * i + g + 8 * (e >> 1);
        const int c = col0 + wn0 + 8 * j + 2 * t + (e & 1);
        rv[e] = !split_k && epi.res != nullptr && r < M && c < N
                    ? epi.res[(size_t)r * N + c]
                    : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + 16 * i + g + 8 * (e >> 1);
        const int c = col0 + wn0 + 8 * j + 2 * t + (e & 1);
        if (r >= M || c >= N) continue;
        const size_t idx = (size_t)r * N + c;
        if (split_k) {
          Cz[idx] = acc[i][j][e];
          continue;
        }
        float v = acc[i][j][e];
        if (epi.bias != nullptr) v += bv[j][e & 1];
        if (epi.pre != nullptr) epi.pre[idx] = v;
        v = drop_apply(epi.drop, idx, apply_act(v, epi.act));
        if (epi.res != nullptr) v += rv[e];
        C[idx] = v;
      }
    }
}

template <bool TA, bool TB>
inline bool gemm_vec4(const float* A, const float* B, int M, int N, int K) {
  return ((uintptr_t)A & 15) == 0 && ((uintptr_t)B & 15) == 0 && (TA ? M : K) % 4 == 0 &&
         (TB ? K : N) % 4 == 0;
}

template <bool TA, bool TB>
inline cudaError_t gemm_launch(const float* A, const float* B, float* C, int M, int N,
                               int K, int k_split, const Epi& epi, cudaStream_t st) {
  using G = GemmTile;
  constexpr size_t smem = G::STAGES *
                          (Operand<!TA, G::BM, G::BK, G::NT>::SIZE +
                           Operand<TB, G::BN, G::BK, G::NT>::SIZE) *
                          sizeof(float);
  cudaError_t err = allow_smem(gemm_tc_kernel<TA, TB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(N, G::BN), cdiv(M, G::BM), cdiv(K > 0 ? K : 1, k_split));
  gemm_tc_kernel<TA, TB><<<grid, G::NT, smem, st>>>(A, B, C, M, N, K, k_split, epi,
                                                    gemm_vec4<TA, TB>(A, B, M, N, K));
  return cudaGetLastError();
}

// C = epi(A @ W), W (K, N)
inline cudaError_t gemm_nn(const float* A, const float* W, float* C, int M, int N,
                           int K, const Epi& epi, cudaStream_t st) {
  return gemm_launch<false, false>(A, W, C, M, N, K, K > 0 ? K : 1, epi, st);
}

// C = epi(A @ B^T), B (N, K): an input gradient G @ W^T with W (in=N, out=K)
inline cudaError_t gemm_nt(const float* A, const float* B, float* C, int M, int N,
                           int K, const Epi& epi, cudaStream_t st) {
  return gemm_launch<false, true>(A, B, C, M, N, K, K > 0 ? K : 1, epi, st);
}

// K rows a split of a TN product takes: enough blocks for two waves over
// the SMs, at least 256 rows each, a multiple of the tile's 32.
inline int tn_k_split(int M, int N, int K) {
  const int tiles = cdiv(M, GemmTile::BM) * cdiv(N, GemmTile::BN);
  int s = cdiv(2 * SMS, tiles);
  s = max(1, min(min(s, max(1, K / 256)), 64));
  return cdiv(cdiv(K > 0 ? K : 1, s), GemmTile::BK) * GemmTile::BK;
}

// floats of scratch gemm_tn needs for these shapes
inline size_t tn_scratch(int M, int N, int K) {
  const int s = cdiv(K > 0 ? K : 1, tn_k_split(M, N, K));
  return s > 1 ? (size_t)s * M * N : 0;
}

// C (M, N) = A^T @ G with A (K, M), G (K, N): a weight gradient X^T @ G over
// K rows. scratch holds tn_scratch(M, N, K) floats.
inline cudaError_t gemm_tn(const float* A, const float* G, float* C, int M, int N,
                           int K, float* scratch, cudaStream_t st) {
  const int k_split = tn_k_split(M, N, K);
  const int s = cdiv(K > 0 ? K : 1, k_split);
  if (s == 1) return gemm_launch<true, false>(A, G, C, M, N, K, k_split, Epi(), st);
  cudaError_t err = gemm_launch<true, false>(A, G, scratch, M, N, K, k_split, Epi(), st);
  if (err != cudaSuccess) return err;
  return reduce_partials(scratch, C, 1, s, (long long)M * N, st);
}

// The three products as one type, as gemm.cuh's Gemm (ffn_core.cuh).
struct Gemm {
  static cudaError_t nn(const float* A, const float* W, float* C, int M, int N, int K,
                        const Epi& epi, cudaStream_t st) {
    return gemm_nn(A, W, C, M, N, K, epi, st);
  }
  static cudaError_t nt(const float* A, const float* B, float* C, int M, int N, int K,
                        const Epi& epi, cudaStream_t st) {
    return gemm_nt(A, B, C, M, N, K, epi, st);
  }
  static cudaError_t tn(const float* A, const float* G, float* C, int M, int N, int K,
                        float* scratch, cudaStream_t st) {
    return gemm_tn(A, G, C, M, N, K, scratch, st);
  }
  static size_t scratch(int M, int N, int K) { return tn_scratch(M, N, K); }
};

}  // namespace tc
}  // namespace ggps
