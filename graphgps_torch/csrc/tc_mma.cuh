// The 3xTF32 tensor-core product and cp.async staging shared by the
// attention body (attn_tc.cuh) and the tensor-core GEMM (gemm_tc.cuh), and
// the f64 tensor-core product of flash_mha.cu's forward.
//
// Products run on mma.sync.m16n8k8 tf32 with f32 accumulation and the
// 3xTF32 split: x = hi + lo, hi = tf32(x) (round to nearest),
// lo = tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi. One tf32 pass
// keeps ~3 decimal digits; the split keeps about f32's, at three tensor-core
// products a step. The tensor cores truncate as they add, so the three
// products of a k-step are summed in a zeroed fragment and added to the
// running sum by a rounded f32 add (mma3): every truncation is at the size of
// 8 products, none at the running sum's. With the products accumulated in
// place, wide_attention's backward at VOC's shape lay 10x further from its
// plain version than the f32 loops it replaced (PERF.md §6).
//
// Where an operand is split is the caller's choice: the attention body, whose
// staged tiles every warp of the block reads, splits each once as it lands
// into a hi plane (over the raw values) and a lo plane; the GEMM, whose tiles
// two warps read, splits the fragments each warp reads in registers.
#pragma once

#include "common.cuh"

namespace ggps {
namespace tc {

// x rounded to tf32, to nearest with ties away from zero, as cvt.rna.tf32.f32
// rounds a finite x: half a unit of the 10-bit mantissa added to the
// magnitude's bits, then the 13 bits below it cleared (a carry into the
// exponent is the rounding up to the next binade). Two integer instructions;
// sm_90a's cvt.rna.tf32.f32 also checks for NaN and infinity.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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

// d += a b (16 x 8 x 8) on the FP64 tensor cores (DMMA; mma.sync m16n8k8
// .f64, sm_90), in the same fragment layout as the tf32 product above, one
// f64 value a register. Hopper has no f64 wgmma; its f64 mma.sync shapes
// m16n8k4, m16n8k8 and m16n8k16 all reach the card's f64 tensor rate, and
// sm_80's m8n8k4 half of it (graphgps_torch/tools/dmma_probe.py, PERF.md
// §6). One m16n8k8 a step, not two dependent m16n8k4: the attention's
// chains of products are latency-bound at its occupancy.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], double b0,
                                     double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
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

// The same copies with zero fill: only the first `bytes` (0 or all) are
// read, the rest of the destination becomes 0.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The tile loop: tile it + 1's copies are in flight while tile it is split
// (prep) and used (body). own() runs after tile 0's copies are issued.
template <class Issue, class Own, class Prep, class Body>
__device__ __forceinline__ void pipeline(int ntiles, Issue issue, Own own, Prep prep,
                                         Body body) {
  if (ntiles > 0) issue(0, 0);
  cp_commit();
  own();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    prep(it, it & 1);
    __syncthreads();
    body(it, it & 1);
    __syncthreads();
  }
}

}  // namespace tc
}  // namespace ggps
