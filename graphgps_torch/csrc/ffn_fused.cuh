// The GPS FFN block with its residual fused into one launch each way, for
// widths whose weights fit in shared memory beside a block of rows:
//
//   a1  = h W1 + b1                      (R, dh)
//   z   = drop1(act(a1))                 (R, dh)
//   out = h + drop2(z W2 + b2)           (R, d)
//
// the function of ffn_core.cuh, which runs it as a sequence of GEMM and
// column-sum launches with the (R, dh) intermediates in device memory. Here a
// block of BM = 16 rows stages W1 and W2 in shared memory (cp.async), takes h
// from its includer's prologue (bn_ffn.cu: the norm apply), and keeps a1 and z
// on chip, as the TPU kernels keep them in VMEM; its includer's kernels
// surround the block functions below. The products are 16-row slabs of
// mma.sync on the tensor cores in 3xTF32 (tc_mma.cuh's split and mma3), dealt
// out to the block's warps as 16 x 16 output tiles; dropout is common.cuh's
// counter hash on the same (row, column) views as the sequence's epilogues,
// so the masks do not change.
//
// Backward, given the cotangent g of out and the forward's kept h, a1 and z
// (R rows each): da2 = drop2(g); da1 = drop1(da2 W2^T) * act'(a1);
// dh = g + da1 W1^T, handed to the includer in shared memory; and the block's
// partials of dW1 = h^T da1, dW2 = z^T da2, db1 and db2 (with the includer's
// own) in one row of a (blocks, P) scratch array. One more launch
// (reduce_blocks) adds the rows in block order: no float atomics, and two
// runs give the same bits.
//
// Bound: the fused limit. The forward stages W1, W2 and the block's h and z,
// the backward W1, W2 and five row tiles (FfnLayout); a block may take
// FUSED_SMEM_LIMIT bytes, the H100's 227 KB. SAN's d = 64, dh = 128 takes 84
// KB forward and 99 KB backward, two blocks an SM. Wider FFNs (molpcba-SAN's
// d = 304) stay on ffn_core.cuh's sequence.
#pragma once

#include "tc_mma.cuh"

namespace ggps {
namespace fused {

constexpr int BM = 16;                        // rows a block
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr long long FUSED_SMEM_LIMIT = 232448;   // the H100's 227 KB a block

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
// Row strides (floats, >= n) that spread a fragment's 32 reads over 32 banks:
// lane (g, t) reading element (g, t) of a row-major tile wants a stride of 4
// mod 32, reading (t, g) one of 8 mod 32.
__host__ __device__ constexpr int ld4(int n) { return n + ((4 - n % 32) % 32 + 32) % 32; }
__host__ __device__ constexpr int ld8(int n) { return n + ((8 - n % 32) % 32 + 32) % 32; }

// The shared-memory layout of one block (offsets and strides in floats).
// Forward: W1 [dp][ld8(dhp)], W2 [dhp][ld8(dp)] read as B (k, n); h
// [BM][ld4(dp)], z [BM][ld4(dhp)] read as A (m, k). Backward: W1 and W2 read
// transposed ([dp][ld4(dhp)], [dhp][ld4(dp)]), h and z transposed as the A of
// the weight gradients ([BM][ld8]), and da2, da1 and dh tiles.
struct FfnLayout {
  int d, dh, dp, dhp;
  int w1, ldw1, w2, ldw2, h, ldh, z, ldz;   // both ways
  int da2, ldda2, da1, ldda1, dhh, lddh;    // backward
  int floats;

  __host__ __device__ static FfnLayout make(int d, int dh, bool backward) {
    FfnLayout L{};
    L.d = d;
    L.dh = dh;
    L.dp = pad16(d);
    L.dhp = pad16(dh);
    L.ldw1 = backward ? ld4(L.dhp) : ld8(L.dhp);
    L.ldw2 = backward ? ld4(L.dp) : ld8(L.dp);
    L.ldh = backward ? ld8(L.dp) : ld4(L.dp);
    L.ldz = backward ? ld8(L.dhp) : ld4(L.dhp);
    int o = 0;
    L.w1 = o;
    o += L.dp * L.ldw1;
    L.w2 = o;
    o += L.dhp * L.ldw2;
    L.h = o;
    o += BM * L.ldh;
    L.z = o;
    o += BM * L.ldz;
    if (backward) {
      L.ldda2 = ld4(L.dp);
      L.ldda1 = ld4(L.dhp);
      L.lddh = ld4(L.dp);
      L.da2 = o;
      o += BM * L.ldda2;
      L.da1 = o;
      o += BM * L.ldda1;
      L.dhh = o;
      o += BM * L.lddh;
    }
    L.floats = o;
    return L;
  }
  __host__ __device__ long long bytes() const { return (long long)floats * 4; }
};

// Whether the block functions take (d, dh): both ways' layouts fit.
inline bool fits(int d, int dh) {
  return FfnLayout::make(d, dh, false).bytes() <= FUSED_SMEM_LIMIT &&
         FfnLayout::make(d, dh, true).bytes() <= FUSED_SMEM_LIMIT;
}

// Floats of the FFN's partials in a block's scratch row: dW1, dW2, db1, db2.
__host__ __device__ inline long long ffn_part_floats(int d, int dh) {
  return 2LL * d * dh + dh + d;
}

// rows x cols of a row-major source (row stride ld_src) into dst [rows_pad]
// [ld_dst], zeros past (rows, cols) up to (rows_pad, cols_pad); cp.async, to
// be committed by the caller. vec: 16-byte copies (cols % 4 == 0, 16-byte
// aligned rows), else 4-byte ones.
__device__ __forceinline__ void stage(float* dst, int ld_dst, const float* src, int ld_src,
                                      int rows, int cols, int rows_pad, int cols_pad,
                                      bool vec) {
  if (vec) {
    const int c4 = cols_pad / 4;
    for (int i = threadIdx.x; i < rows_pad * c4; i += NT) {
      const int r = i / c4, c = i % c4 * 4;
      const bool ok = r < rows && c < cols;
      tc::cp_async16_zfill(dst + r * ld_dst + c, ok ? src + (size_t)r * ld_src + c : src,
                           ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += NT) {
      const int r = i / cols_pad, c = i % cols_pad;
      const bool ok = r < rows && c < cols;
      tc::cp_async4_zfill(dst + r * ld_dst + c, ok ? src + (size_t)r * ld_src + c : src,
                          ok ? 4 : 0);
    }
  }
}

// C (M x N) = A (M x K) B (K x N) on the tensor cores in 3xTF32, M and N
// multiples of 16, K of 8: 16 x 16 output tiles (two 16 x 8 fragments)
// dealt out to the block's warps in turn, K in steps of 8 in order. a(m, k)
// and b(k, n) read shared memory; epi(m, n, v) takes each output once.
template <class FA, class FB, class Epi>
__device__ __forceinline__ void products(int M, int N, int K, FA a, FB b, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tn = N / 16, tasks = M / 16 * tn;
  for (int task = warp; task < tasks; task += WARPS) {
    const int m0 = task / tn * 16, n0 = task % tn * 16;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k0 = 0; k0 < K; k0 += 8) {
      // A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B: b0 (t, g),
      // b1 (t+4, g) (tc_mma.cuh's fragment lanes)
      tc::AFrag af;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tc::split(a(m0 + g + 8 * (e & 1), k0 + t + 4 * (e >> 1)), af.h[e], af.l[e]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tc::BFrag bf;
        tc::split(b(k0 + t, n0 + 8 * j + g), bf.h[0], bf.l[0]);
        tc::split(b(k0 + t + 4, n0 + 8 * j + g), bf.h[1], bf.l[1]);
        tc::mma3(acc[j], af, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi(m0 + g + 8 * (e >> 1), n0 + 8 * j + 2 * t + (e & 1), acc[j][e]);
  }
}

// Stage W1 (d, dh) and W2 (dh, d) in the layout's weight arrays.
__device__ __forceinline__ void stage_weights(const FfnLayout& L, float* smem,
                                              const float* w1, const float* w2, bool vec) {
  stage(smem + L.w1, L.ldw1, w1, L.dh, L.d, L.dh, L.dp, L.dhp, vec);
  stage(smem + L.w2, L.ldw2, w2, L.d, L.dh, L.d, L.dhp, L.dp, vec);
}

struct FwdArgs {
  const float* b1;   // (dh,)
  const float* b2;   // (d,)
  float* out;        // (R, d)
  float* a1;         // (R, dh) kept, or null
  float* z;          // (R, dh) kept, or null
  int R, act;
  Drop drop1, drop2;
};

// The forward of rows [row0, row0 + BM): h staged in smem + L.h (zeros past
// R and d), the weights staged and the block synchronised.
__device__ __forceinline__ void forward_block(const FfnLayout& L, float* smem, int row0,
                                              const FwdArgs& p) {
  const float* hs = smem + L.h;
  float* zs = smem + L.z;
  const float* w1s = smem + L.w1;
  const float* w2s = smem + L.w2;
  const int d = L.d, dh = L.dh;
  products(
      BM, L.dhp, L.dp, [&](int m, int k) { return hs[m * L.ldh + k]; },
      [&](int k, int n) { return w1s[k * L.ldw1 + n]; },
      [&](int m, int n, float acc) {
        const int row = row0 + m;
        float zv = 0.0f;
        if (n < dh) {
          const size_t idx = (size_t)row * dh + n;
          const float v = acc + p.b1[n];
          zv = drop_apply(p.drop1, idx, apply_act(v, p.act));
          if (row < p.R) {
            if (p.a1 != nullptr) p.a1[idx] = v;
            if (p.z != nullptr) p.z[idx] = zv;
          }
        }
        zs[m * L.ldz + n] = zv;
      });
  __syncthreads();
  products(
      BM, L.dp, L.dhp, [&](int m, int k) { return zs[m * L.ldz + k]; },
      [&](int k, int n) { return w2s[k * L.ldw2 + n]; },
      [&](int m, int n, float acc) {
        const int row = row0 + m;
        if (row >= p.R || n >= d) return;
        const size_t idx = (size_t)row * d + n;
        float v = acc + p.b2[n];
        v = drop_apply(p.drop2, idx, apply_act(v, ACT_IDENTITY));
        p.out[idx] = v + hs[m * L.ldh + n];
      });
}

// Stage the backward's row tiles of rows [row0, row0 + BM): the kept h and
// z, and da2 = drop2(g) (zeros past R); cp.async to be committed and waited
// for by the caller, before a block barrier.
__device__ __forceinline__ void stage_rows(const FfnLayout& L, float* smem, int row0,
                                           const float* h, const float* z, const float* g,
                                           int R, Drop drop2, bool vec) {
  const int rows = min(BM, R - row0), d = L.d;
  stage(smem + L.h, L.ldh, h + (size_t)row0 * d, d, rows, d, BM, L.dp, vec);
  stage(smem + L.z, L.ldz, z + (size_t)row0 * L.dh, L.dh, rows, L.dh, BM, L.dhp, vec);
  float* da2 = smem + L.da2;
  for (int i = threadIdx.x; i < BM * L.dp; i += NT) {
    const int m = i / L.dp, c = i % L.dp, row = row0 + m;
    const size_t idx = (size_t)row * d + c;
    da2[m * L.ldda2 + c] = row < R && c < d ? drop_apply(drop2, idx, g[idx]) : 0.0f;
  }
}

struct BwdArgs {
  const float* a1;   // (R, dh) the forward's pre-activation
  const float* g;    // (R, d) the cotangent of out
  float* part;       // this block's scratch row
  int R, act;
  Drop drop1;
};

// The backward of rows [row0, row0 + BM), the weights and stage_rows' tiles
// in place and the block synchronised: da1 and dh = g + da1 W1^T into
// smem + L.da1 and smem + L.dhh (zeros past R and d), the FFN's partials into
// p.part: [dW1 (d, dh) | dW2 (dh, d) | db1 (dh) | db2 (d)]. Ends with a block
// barrier.
__device__ __forceinline__ void backward_block(const FfnLayout& L, float* smem, int row0,
                                               const BwdArgs& p) {
  const float* w1s = smem + L.w1;
  const float* w2s = smem + L.w2;
  const float* hs = smem + L.h;
  const float* zs = smem + L.z;
  const float* da2 = smem + L.da2;
  float* da1 = smem + L.da1;
  float* dhh = smem + L.dhh;
  const int d = L.d, dh = L.dh;
  // du = da2 W2^T, da1 = drop1(du) * act'(a1)
  products(
      BM, L.dhp, L.dp, [&](int m, int k) { return da2[m * L.ldda2 + k]; },
      [&](int k, int n) { return w2s[n * L.ldw2 + k]; },
      [&](int m, int n, float acc) {
        const int row = row0 + m;
        float v = 0.0f;
        if (row < p.R && n < dh) {
          const size_t idx = (size_t)row * dh + n;
          v = drop_apply(p.drop1, idx, acc) * act_grad(p.a1[idx], p.act);
        }
        da1[m * L.ldda1 + n] = v;
      });
  __syncthreads();
  // dh = g + da1 W1^T
  products(
      BM, L.dp, L.dhp, [&](int m, int k) { return da1[m * L.ldda1 + k]; },
      [&](int k, int n) { return w1s[n * L.ldw1 + k]; },
      [&](int m, int n, float acc) {
        const int row = row0 + m;
        float v = 0.0f;
        if (row < p.R && n < d) v = acc + p.g[(size_t)row * d + n];
        dhh[m * L.lddh + n] = v;
      });
  // the block's weight gradients: dW1 = h^T da1, dW2 = z^T da2 over its rows
  float* part = p.part;
  products(
      L.dp, L.dhp, BM, [&](int m, int k) { return hs[k * L.ldh + m]; },
      [&](int k, int n) { return da1[k * L.ldda1 + n]; },
      [&](int m, int n, float acc) {
        if (m < d && n < dh) part[(size_t)m * dh + n] = acc;
      });
  products(
      L.dhp, L.dp, BM, [&](int m, int k) { return zs[k * L.ldz + m]; },
      [&](int k, int n) { return da2[k * L.ldda2 + n]; },
      [&](int m, int n, float acc) {
        if (m < dh && n < d) part[(size_t)d * dh + (size_t)m * d + n] = acc;
      });
  // db1, db2: the block's column sums, rows in order
  for (int c = threadIdx.x; c < dh + d; c += NT) {
    const bool one = c < dh;
    const float* src = one ? da1 + c : da2 + (c - dh);
    const int ld = one ? L.ldda1 : L.ldda2;
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < BM; ++m) s += src[m * ld];
    part[2 * (size_t)d * dh + c] = s;
  }
  __syncthreads();
}

// Up to MAX_OUTS outputs that take consecutive ranges of a scratch row.
constexpr int MAX_OUTS = 8;
struct Outs {
  float* ptr[MAX_OUTS];
  long long end[MAX_OUTS];   // exclusive end of output i's range in the row
  int n;
};

// out = the sum of the `blocks` rows of part (blocks, P), in block order
// within each of a block's warps' strides and then in warp order: a fixed
// order, so two runs give the same bits. A block owns 32 columns; its 8
// warps take every 8th row.
__global__ void __launch_bounds__(NT)
reduce_blocks_kernel(const float* __restrict__ part, int blocks, long long P, Outs outs) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < P)
    for (int b = warp; b < blocks; b += WARPS) s += part[(size_t)b * P + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= P) return;
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w][lane];
  long long begin = 0;
  for (int i = 0; i < outs.n; ++i) {
    if (c < outs.end[i]) {
      outs.ptr[i][c - begin] = t;
      return;
    }
    begin = outs.end[i];
  }
}

inline cudaError_t reduce_blocks(const float* part, int blocks, long long P, const Outs& outs,
                                 cudaStream_t st) {
  reduce_blocks_kernel<<<cdiv(P, 32), NT, 0, st>>>(part, blocks, P, outs);
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace ggps
