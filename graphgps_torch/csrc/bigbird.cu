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
// each forward (~0.06 GFLOP), against q, k, v and o of 2 MB each. The
// parent walked the plan a warp per (query block, <= 64 keys), read each key
// row from L2 a lane at a time and took the values one key after another
// with shuffles: latency-bound, 18x its bound.
//
// Design. The plan is turned on the host, once, into items for each side
// (ops/kernels/bigbird.py plan_tables): the query side (the keys of each
// query block: forward and dq) and the key side, transposed (the query rows
// of each key block: dk and dv). An item is one CUDA block of 4 warps, per
// (graph, head), 8 to an SM (64 registers a thread, <= 27 KB): wn-squirrel's
// ~1,000 items in about one wave. It first copies its tables into shared
// memory (one round of loads), then stages the rows of the other side that
// its lists name, with 16-byte cp.async copies: for a run of up to 10
// consecutive blocks (at block 3, 30 own rows) their window, the two global
// blocks and their random blocks, <= 128 rows of k and v, which the run's
// rows share where the parent's warps read them again from L2. Each own row
// of a task is a unit, run by a group of 4 lanes, each lane a quarter of
// the head's columns (6 at Dh 24, an instance with no column guards): 8
// entries a step, the lanes' partial dots summed in the group by two
// shuffles, one online-softmax rescale a step, and p v into the lane's
// columns from shared memory; no warp-wide reduction and no per-key
// shuffle of the values. A list longer than an item stages (the two global
// query blocks see all N keys; the two global key blocks are seen by all N
// queries) is cut into chunks of 128 consecutive rows, tasks of 16 entries
// whose states the chunk's item merges in task order into one partial slot
// (33 a row at wn-squirrel); the chunks come last in the grid, and a
// combine kernel, a block per row, merges the slots in a fixed order. The
// products stay on the CUDA cores: at ~0.06 GFLOP the work is bound by
// bytes and latency, and a list of ~24 entries fills no tensor-core tile.
// Each row's log-sum-exp m + log(l) is written for the backward. The
// segment ids are the key mask's bytes.
// Backward, with no float atomics: bb_dq_kernel over the query side's
// items recomputes P = exp(s - lse), forms D = dO . o per row (its block's
// first task writes it out), dS = P (dO v^T - D) on allowed pairs and dq =
// scale * dS k, k and v staged; then bb_dkv_kernel over the key side's
// items, q, dO, lse and D of the query rows staged, a group per key row,
// forms dv = P^T dO and dk = dS^T qs. Every sum runs in a fixed order, so
// two runs give the same bits.
#include "tc_mma.cuh"

namespace ggps {
namespace {

constexpr int BB_WARPS = 4;     // a block of 128 threads
constexpr int BB_NT = 32 * BB_WARPS;
// item blocks an SM holds (64 registers a thread; the staged rows, at most
// MAX_ROWS = 128 of k and v at Dh 24, take 27 KB): wn-squirrel's ~1,000
// items in about one wave
constexpr int BB_MIN_BLOCKS = 8;
constexpr int GL = 4;           // lanes of a group: one row, a quarter of its columns each
constexpr int KPS = 8;          // entries a group takes a step (one softmax rescale)
constexpr int BB_GROUPS = BB_NT / GL;
constexpr int BB_MAX_DH = 128;  // 32 columns a lane
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

// x summed over a group's 4 lanes; every lane gets the same bits (each add
// is of the same two values on both of its lanes)
__device__ __forceinline__ float gsum(unsigned mask, float x) {
  x += __shfl_xor_sync(mask, x, 1, GL);
  return x + __shfl_xor_sync(mask, x, 2, GL);
}

// A staged row's stride (ops/kernels/bigbird.py stage_ld): Dh rounded up to
// 16 bytes, the cp.async copies' size.
__host__ __device__ inline int bb_ld(int Dh) { return (Dh + 3) / 4 * 4; }

// Columns a lane of a group holds: a quarter of Dh, rounded up to even
// (8-byte reads), at most C.
__host__ __device__ inline int lane_cols(int Dh) { return ((Dh + GL - 1) / GL + 1) / 2 * 2; }

// The item tables of one side (ops/kernels/bigbird.py Side): item i stages
// rows row[item_row[i] .. item_row[i + 1]) in order; its tasks are
// task[item_task[i] ..], each (own block, entries [lo, hi) of slot, partial
// slot or -1, first of its block), an entry naming a staged row. A task's
// own rows are units dealt out to the block's groups.
struct Items {
  const int* row;
  const int* item_row;
  const int* task;
  const int* item_task;
  const int* slot;
  int rows;   // the most rows an item stages
};

constexpr int BB_MAX_TASKS = BB_GROUPS;   // tasks an item holds at most

// An item block's shared memory: the staged rows (two matrices [rows][ld],
// then ids and up to two scalars a row), and the item's tables (its staged
// rows' indices, tasks with entries relative to the item's first, entries).
struct Stage {
  float* a;
  float* b;
  int* id;
  float* s0;
  float* s1;
  int* rows;
  int* task;
  int* slot;
  int n_rows, n_tasks;

  __device__ Stage(float* smem, const Items& it, int ld, int Dh, int scalars) {
    const int r4 = (it.rows + 3) / 4 * 4;
    const int stage = max(it.rows * ld, BB_GROUPS * Dh);
    a = smem;
    b = a + stage;
    id = reinterpret_cast<int*>(b + stage);
    s0 = reinterpret_cast<float*>(id + r4);
    s1 = s0 + r4;
    rows = id + scalars * r4;
    task = rows + r4;
    slot = task + 5 * BB_MAX_TASKS;
  }
};

// Bytes of an item block's Stage; a chunk item's merge (at most BB_GROUPS
// units of up to 2 Dh floats) reuses its staged rows, at least that large.
__host__ __device__ inline size_t item_smem(int rows, int entries, int Dh, int scalars) {
  const int r4 = (rows + 3) / 4 * 4;
  const int stage = max(rows * bb_ld(Dh), BB_GROUPS * Dh);
  return 4 * ((size_t)2 * stage + (size_t)(scalars + 1) * r4 + 5 * BB_MAX_TASKS + entries);
}

// Stage item `item` of a head: its tables first (one round of loads), then
// rows of src_a and src_b (cp.async, 16-byte copies where vec: Dh % 4 == 0
// and 16-byte aligned rows), their ids and, where s0src is not null, two
// scalars of the (B*H*N) row vectors (lse and D), all landed and the block
// synchronised on return.
__device__ __forceinline__ void stage_item(Stage& S, const Items& it, int item, int ld,
                                           const float* __restrict__ src_a,
                                           const float* __restrict__ src_b,
                                           const unsigned char* __restrict__ gid,
                                           const float* __restrict__ s0src,
                                           const float* __restrict__ s1src, int Dh,
                                           bool vec) {
  const int r0 = it.item_row[item];
  S.n_rows = it.item_row[item + 1] - r0;
  const int t0 = it.item_task[item];
  S.n_tasks = it.item_task[item + 1] - t0;
  const int e0 = it.task[5 * t0 + 1];
  for (int i = threadIdx.x; i < S.n_rows; i += BB_NT) S.rows[i] = it.row[r0 + i];
  for (int i = threadIdx.x; i < 5 * S.n_tasks; i += BB_NT) {
    const int v = it.task[5 * t0 + i];
    S.task[i] = i % 5 == 1 || i % 5 == 2 ? v - e0 : v;
  }
  const int n_e = it.task[5 * (t0 + S.n_tasks) - 3] - e0;
  for (int i = threadIdx.x; i < n_e; i += BB_NT) S.slot[i] = it.slot[e0 + i];
  __syncthreads();
  const int n = S.n_rows;
  if (vec) {
    const int c4 = Dh / 4;
    for (int i = threadIdx.x; i < n * c4; i += BB_NT) {
      const int r = i / c4, c = i % c4 * 4;
      const size_t src = (size_t)S.rows[r] * Dh + c;
      tc::cp_async16(S.a + r * ld + c, src_a + src);
      tc::cp_async16(S.b + r * ld + c, src_b + src);
    }
  } else {
    for (int i = threadIdx.x; i < n * Dh; i += BB_NT) {
      const int r = i / Dh, c = i % Dh;
      const size_t src = (size_t)S.rows[r] * Dh + c;
      tc::cp_async4(S.a + r * ld + c, src_a + src);
      tc::cp_async4(S.b + r * ld + c, src_b + src);
    }
  }
  tc::cp_commit();
  for (int r = threadIdx.x; r < n; r += BB_NT) {
    S.id[r] = gid[S.rows[r]];
    if (s0src != nullptr) {
      S.s0[r] = s0src[S.rows[r]];
      S.s1[r] = s1src[S.rows[r]];
    }
  }
  tc::cp_wait<0>();
  __syncthreads();
}

// A lane's C columns [c0, c0 + nc) of a row, times mul, zeros past nc;
// 8-byte reads where pair (c0 and nc even, the row 8-byte aligned).
template <int C>
__device__ __forceinline__ void load_cols(float (&x)[C], const float* row, int nc, bool pair,
                                          float mul) {
  if (pair) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      float2 v = c < nc ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.f, 0.f);
      x[c] = v.x * mul;
      x[c + 1] = v.y * mul;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = c < nc ? row[c] * mul : 0.0f;
  }
}

template <int C>
__device__ __forceinline__ float dot(const float (&a)[C], const float (&b)[C]) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// Walk the units u = (task, own row) of the staged item dealt to this
// thread's group: f(u, task (in shared memory), own row index r, own row,
// group lane mask).
template <class F>
__device__ __forceinline__ void for_units(const Stage& S, int N, int bs, F f) {
  const int lane = threadIdx.x & 31, grp = threadIdx.x / GL;
  const unsigned mask = 0xfu << (lane & ~(GL - 1));
  for (int u = grp; u < S.n_tasks * bs; u += BB_GROUPS) {
    const int* tk = S.task + 5 * (u / bs);
    const int r = u % bs, row = tk[0] * bs + r;
    if (row < N) f(u, tk, r, row, mask);
  }
}

// A chunk item (its tasks slices of one block's long list, sharing one
// partial slot) adds up its tasks in the block: whether this item does.
__device__ __forceinline__ bool merges(const Stage& S) {
  return S.n_tasks > 1 && S.task[3] >= 0;
}

// The merge of a chunk item, after each group has put its one unit (a
// chunk item has at most BB_GROUPS) at buf + u width and the block has
// synchronised: f(r, c) for each own row r below N and column c < width,
// the block's threads over the pairs; f adds the tasks' row r in order.
template <class F>
__device__ __forceinline__ void merge_rows(const Stage& S, int bs, int N, int width, F f) {
  for (int i = threadIdx.x; i < bs * width; i += BB_NT) {
    const int r = i / width, c = i % width;
    if (S.task[0] * bs + r < N) f(r, c);
  }
}

// Forward: each group runs one query row over its task's entries, KPS keys
// a step: its lanes' partial dots over their columns, summed in the group,
// the online softmax step over the KPS (no warp-wide reduction), and p v
// into the lane's columns.
template <int C, bool FULL>
__global__ void __launch_bounds__(BB_NT, BB_MIN_BLOCKS)
bb_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const unsigned char* __restrict__ ids, Items it,
              float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
              int parts, int N, int H, int Dh, int bs, float scale, bool vec) {
  extern __shared__ float smem[];
  const int item = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const unsigned char* gid = ids + (size_t)b * N;
  const int ld = bb_ld(Dh);
  Stage S(smem, it, ld, Dh, 1);
  stage_item(S, it, item, ld, k + head * Dh, v + head * Dh, gid, nullptr, nullptr, Dh, vec);
  const int gl = threadIdx.x % GL, lc = lane_cols(Dh), c0 = gl * lc;
  // FULL: Dh = GL C, every lane's C columns real (no guards)
  const int nc = FULL ? C : max(0, min(lc, Dh - c0));
  const bool pair = FULL || Dh % 2 == 0;
  const bool merge = merges(S);
  float st[C], st_m = 0.0f, st_l = 0.0f;   // a merging group's unit
  int st_u = -1;
  for_units(S, N, bs, [&](int u, const int* tk, int r, int row, unsigned mask) {
    const int lo = tk[1], hi = tk[2], p = tk[3];
    float qv[C], acc[C], kv[C];
    load_cols(qv, q + (head + row) * Dh + c0, nc, pair, scale);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    const int qid = gid[row];
    float m = -INFINITY, l = 0.0f;
    for (int e = lo; e < hi; e += KPS) {
      int mine[KPS / GL], j[KPS];
      float s[KPS];
#pragma unroll
      for (int x = 0; x < KPS / GL; ++x)
        mine[x] = e + GL * x + gl < hi ? S.slot[e + GL * x + gl] : -1;
#pragma unroll
      for (int i = 0; i < KPS; ++i) {
        j[i] = __shfl_sync(mask, mine[i / GL], i % GL, GL);
        s[i] = 0.0f;
        if (j[i] >= 0) {
          load_cols(kv, S.a + j[i] * ld + c0, nc, pair, 1.0f);
          s[i] = dot(qv, kv);
        }
        s[i] = gsum(mask, s[i]);
      }
      float mn = m;
#pragma unroll
      for (int i = 0; i < KPS; ++i) {
        s[i] = j[i] < 0 ? -INFINITY : (S.id[j[i]] == qid ? s[i] : BB_MASK);
        mn = fmaxf(mn, s[i]);   // finite: the step's first key is real
      }
      const float corr = __expf(m - mn);
      l *= corr;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= corr;
#pragma unroll
      for (int i = 0; i < KPS; ++i) {
        if (j[i] < 0) continue;
        const float pi = __expf(s[i] - mn);
        l += pi;
        load_cols(kv, S.b + j[i] * ld + c0, nc, pair, 1.0f);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(pi, kv[c], acc[c]);
      }
      m = mn;
    }
    if (merge) {
      st_u = u;
      st_m = m;
      st_l = l;
#pragma unroll
      for (int c = 0; c < C; ++c) st[c] = acc[c];
    } else if (p < 0) {
      float* dst = o + (head + row) * Dh + c0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < nc) dst[c] = acc[c] / l;
      if (gl == 0) lse[head + row] = m + logf(l);
    } else {
      // slot (b, h, part, row in block): Dh sums, then m and l
      float* pp = part + ((((size_t)b * H + h) * parts + p) * bs + r) * (Dh + 2);
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < nc) pp[c0 + c] = acc[c];
      if (gl == 0) {
        pp[Dh] = m;
        pp[Dh + 1] = l;
      }
    }
  });
  if (!merge) return;
  // the chunk's tasks merged in order into its one partial slot
  const int W = Dh + 2;
  float* buf = S.a;
  __syncthreads();
  if (st_u >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < nc) buf[st_u * W + c0 + c] = st[c];
    if (gl == 0) {
      buf[st_u * W + Dh] = st_m;
      buf[st_u * W + Dh + 1] = st_l;
    }
  }
  __syncthreads();
  float* pp = part + (((size_t)b * H + h) * parts + S.task[3]) * bs * W;
  merge_rows(S, bs, N, W, [&](int r, int c) {
    float M = -INFINITY;
    for (int t = 0; t < S.n_tasks; ++t) M = fmaxf(M, buf[(t * bs + r) * W + Dh]);
    float a = 0.0f;
    for (int t = 0; t < S.n_tasks; ++t) {
      const float* x = buf + (t * bs + r) * W;
      a += (c == Dh ? 0.0f : c < Dh ? x[c] : x[Dh + 1]) * expf(x[Dh] - M);
    }
    pp[r * W + c] = c == Dh ? M : a;
  });
}

constexpr int CW = 8;   // warps of a combine block, one block a row

// max (max_ = true) or sum of v over a combine block, warps in order; every
// thread gets the result
__device__ __forceinline__ float block_reduce(float v, bool max_, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = max_ ? wmax(v) : wsum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < CW; ++w) t = max_ ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();
  return t;
}

// Merge the partial softmax states of the blocks cut into several tasks:
// a block per (combine entry, row of its block); warp w sums partial slots
// w, w + CW, ... with its lanes on the columns, then the warps' sums are
// added in warp order (a fixed order: the same bits every run).
__global__ void __launch_bounds__(32 * CW)
bb_fwd_combine(const float* __restrict__ part, const int* __restrict__ c_blk,
               const int* __restrict__ c_p0, const int* __restrict__ c_np,
               float* __restrict__ o, float* __restrict__ lse, int parts, int N, int H,
               int Dh, int bs) {
  __shared__ float red[CW];
  __shared__ float cols[CW][BB_MAX_DH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ci = blockIdx.x / bs, ri = blockIdx.x % bs;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = c_blk[ci] * bs + ri;
  if (row >= N) return;
  const size_t bh = (size_t)b * H + h;
  const int p0 = c_p0[ci], np_ = c_np[ci];
  auto slot = [&](int pi) {
    return part + ((bh * parts + p0 + pi) * bs + ri) * (Dh + 2);
  };
  float m = -INFINITY;
  for (int pi = threadIdx.x; pi < np_; pi += 32 * CW) m = fmaxf(m, slot(pi)[Dh]);
  const float M = block_reduce(m, true, red);
  float l = 0.0f;
  for (int pi = threadIdx.x; pi < np_; pi += 32 * CW)
    l += slot(pi)[Dh + 1] * expf(slot(pi)[Dh] - M);
  const float L = block_reduce(l, false, red);
  for (int c = lane; c < Dh; c += 32) {
    float a = 0.0f;
#pragma unroll 4
    for (int pi = warp; pi < np_; pi += CW) a += slot(pi)[c] * expf(slot(pi)[Dh] - M);
    cols[warp][c] = a;
  }
  __syncthreads();
  const size_t orow = bh * N + row;
  for (int c = threadIdx.x; c < Dh; c += 32 * CW) {
    float t = cols[0][c];
    for (int w = 1; w < CW; ++w) t += cols[w][c];
    o[orow * Dh + c] = t / L;
  }
  if (threadIdx.x == 0) lse[orow] = M + logf(L);
}

// dq over the query side's units: P = exp(s - lse), D = dO . o (the
// block's first task writes it out), dS = P (dO v^T - D) on allowed pairs,
// dq = scale * dS k, KPS keys a step as in the forward.
template <int C, bool FULL>
__global__ void __launch_bounds__(BB_NT, BB_MIN_BLOCKS)
bb_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const unsigned char* __restrict__ ids,
             const float* __restrict__ o, const float* __restrict__ lse,
             const float* __restrict__ dout, Items it, float* __restrict__ dq,
             float* __restrict__ drow, float* __restrict__ part, int parts, int N, int H,
             int Dh, int bs, float scale, bool vec) {
  extern __shared__ float smem[];
  const int item = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const unsigned char* gid = ids + (size_t)b * N;
  const int ld = bb_ld(Dh);
  Stage S(smem, it, ld, Dh, 1);
  stage_item(S, it, item, ld, k + head * Dh, v + head * Dh, gid, nullptr, nullptr, Dh, vec);
  const int gl = threadIdx.x % GL, lc = lane_cols(Dh), c0 = gl * lc;
  // FULL: Dh = GL C, every lane's C columns real (no guards)
  const int nc = FULL ? C : max(0, min(lc, Dh - c0));
  const bool pair = FULL || Dh % 2 == 0;
  const bool merge = merges(S);
  float st[C];   // a merging group's unit
  int st_u = -1;
  for_units(S, N, bs, [&](int u, const int* tk, int r, int row, unsigned mask) {
    const int lo = tk[1], hi = tk[2], p = tk[3], first = tk[4];
    float qv[C], dov[C], acc[C], kv[C];
    load_cols(qv, q + (head + row) * Dh + c0, nc, pair, scale);
    load_cols(dov, dout + (head + row) * Dh + c0, nc, pair, 1.0f);
    load_cols(kv, o + (head + row) * Dh + c0, nc, pair, 1.0f);
    const float D = gsum(mask, dot(dov, kv));
    const float L = lse[head + row];
    if (first && gl == 0) drow[head + row] = D;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    const int qid = gid[row];
    for (int e = lo; e < hi; e += KPS) {
      int mine[KPS / GL];
#pragma unroll
      for (int x = 0; x < KPS / GL; ++x)
        mine[x] = e + GL * x + gl < hi ? S.slot[e + GL * x + gl] : -1;
#pragma unroll
      for (int i = 0; i < KPS; ++i) {
        const int j = __shfl_sync(mask, mine[i / GL], i % GL, GL);
        float s = 0.0f, dp = 0.0f;
        if (j >= 0) {
          load_cols(kv, S.a + j * ld + c0, nc, pair, 1.0f);
          s = dot(qv, kv);
          float vv[C];
          load_cols(vv, S.b + j * ld + c0, nc, pair, 1.0f);
          dp = dot(dov, vv);
        }
        s = gsum(mask, s);
        dp = gsum(mask, dp);
        if (j < 0) continue;
        const bool ok = S.id[j] == qid;
        const float P = __expf((ok ? s : BB_MASK) - L);
        const float ds = ok ? P * (dp - D) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(ds, kv[c], acc[c]);
      }
    }
    if (merge) {
      st_u = u;
#pragma unroll
      for (int c = 0; c < C; ++c) st[c] = acc[c];
      return;
    }
    float* dst = p < 0 ? dq + (head + row) * Dh
                       : part + ((((size_t)b * H + h) * parts + p) * bs + r) * Dh;
    const float mul = p < 0 ? scale : 1.0f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < nc) dst[c0 + c] = acc[c] * mul;
  });
  if (!merge) return;
  float* buf = S.a;
  __syncthreads();
  if (st_u >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < nc) buf[st_u * Dh + c0 + c] = st[c];
  }
  __syncthreads();
  float* pp = part + (((size_t)b * H + h) * parts + S.task[3]) * bs * Dh;
  merge_rows(S, bs, N, Dh, [&](int r, int c) {
    float a = 0.0f;
    for (int t = 0; t < S.n_tasks; ++t) a += buf[(t * bs + r) * Dh + c];
    pp[r * Dh + c] = a;
  });
}

// dk and dv over the key side's units: each group one key row over its
// task's query rows (q, dO, lse and D staged), KPS a step: dv = P^T dO and
// dk = dS^T qs.
template <int C, bool FULL>
__global__ void __launch_bounds__(BB_NT, BB_MIN_BLOCKS)
bb_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const unsigned char* __restrict__ ids,
              const float* __restrict__ lse, const float* __restrict__ dout,
              const float* __restrict__ drow, Items it, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ part, int parts, int N, int H,
              int Dh, int bs, float scale, bool vec) {
  extern __shared__ float smem[];
  const int item = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  const size_t head = ((size_t)b * H + h) * N;
  const unsigned char* gid = ids + (size_t)b * N;
  const int ld = bb_ld(Dh);
  Stage S(smem, it, ld, Dh, 3);
  stage_item(S, it, item, ld, q + head * Dh, dout + head * Dh, gid, lse + head, drow + head,
             Dh, vec);
  const int gl = threadIdx.x % GL, lc = lane_cols(Dh), c0 = gl * lc;
  // FULL: Dh = GL C, every lane's C columns real (no guards)
  const int nc = FULL ? C : max(0, min(lc, Dh - c0));
  const bool pair = FULL || Dh % 2 == 0;
  const bool merge = merges(S);
  float st_k[C], st_v[C];   // a merging group's unit
  int st_u = -1;
  for_units(S, N, bs, [&](int u, const int* tk, int r, int row, unsigned mask) {
    const int lo = tk[1], hi = tk[2], p = tk[3];
    float kv[C], vv[C], dka[C], dva[C], qx[C], gx[C];
    load_cols(kv, k + (head + row) * Dh + c0, nc, pair, 1.0f);
    load_cols(vv, v + (head + row) * Dh + c0, nc, pair, 1.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.0f;
    const int kid = gid[row];
    for (int e = lo; e < hi; e += KPS) {
      int mine[KPS / GL];
#pragma unroll
      for (int x = 0; x < KPS / GL; ++x)
        mine[x] = e + GL * x + gl < hi ? S.slot[e + GL * x + gl] : -1;
#pragma unroll
      for (int x = 0; x < KPS; ++x) {
        const int i = __shfl_sync(mask, mine[x / GL], x % GL, GL);
        float s = 0.0f, dp = 0.0f;
        if (i >= 0) {
          load_cols(qx, S.a + i * ld + c0, nc, pair, scale);
          s = dot(qx, kv);
          load_cols(gx, S.b + i * ld + c0, nc, pair, 1.0f);
          dp = dot(gx, vv);
        }
        s = gsum(mask, s);
        dp = gsum(mask, dp);
        if (i < 0) continue;
        const bool ok = S.id[i] == kid;
        const float P = __expf((ok ? s : BB_MASK) - S.s0[i]);
        const float ds = ok ? P * (dp - S.s1[i]) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dva[c] = fmaf(P, gx[c], dva[c]);
          dka[c] = fmaf(ds, qx[c], dka[c]);
        }
      }
    }
    if (merge) {
      st_u = u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        st_k[c] = dka[c];
        st_v[c] = dva[c];
      }
      return;
    }
    float* pk = p < 0 ? dk + (head + row) * Dh
                      : part + ((((size_t)b * H + h) * parts + p) * bs + r) * 2 * Dh;
    float* pv = p < 0 ? dv + (head + row) * Dh : pk + Dh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < nc) {
        pk[c0 + c] = dka[c];
        pv[c0 + c] = dva[c];
      }
    }
  });
  if (!merge) return;
  const int W = 2 * Dh;
  float* buf = S.a;
  __syncthreads();
  if (st_u >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < nc) {
        buf[st_u * W + c0 + c] = st_k[c];
        buf[st_u * W + Dh + c0 + c] = st_v[c];
      }
    }
  }
  __syncthreads();
  float* pp = part + (((size_t)b * H + h) * parts + S.task[3]) * bs * W;
  merge_rows(S, bs, N, W, [&](int r, int c) {
    float a = 0.0f;
    for (int t = 0; t < S.n_tasks; ++t) a += buf[(t * bs + r) * W + c];
    pp[r * W + c] = a;
  });
}

// Sum the partial gradients of the blocks cut into several tasks: a block
// per (combine entry, row of its block), warp w summing partial slots w,
// w + CW, ... with its lanes on the columns, the warps' sums added in warp
// order. Each slot holds `width` columns per row: dq's Dh (then times
// scale), or dk's and dv's 2*Dh.
__global__ void __launch_bounds__(32 * CW)
bb_grad_combine(const float* __restrict__ part, const int* __restrict__ c_blk,
                const int* __restrict__ c_p0, const int* __restrict__ c_np,
                float* __restrict__ out0, float* __restrict__ out1, int parts, int N,
                int H, int Dh, int bs, float mul) {
  __shared__ float cols[CW][2 * BB_MAX_DH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ci = blockIdx.x / bs, ri = blockIdx.x % bs;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = c_blk[ci] * bs + ri;
  if (row >= N) return;
  const size_t bh = (size_t)b * H + h;
  const int width = out1 != nullptr ? 2 * Dh : Dh;
  const int p0 = c_p0[ci], np_ = c_np[ci];
  for (int c = lane; c < width; c += 32) {
    float a = 0.0f;
#pragma unroll 4
    for (int pi = warp; pi < np_; pi += CW)
      a += part[((bh * parts + p0 + pi) * bs + ri) * width + c];
    cols[warp][c] = a;
  }
  __syncthreads();
  const size_t orow = bh * N + row;
  for (int c = threadIdx.x; c < width; c += 32 * CW) {
    float t = cols[0][c];
    for (int w = 1; w < CW; ++w) t += cols[w][c];
    if (c < Dh)
      out0[orow * Dh + c] = t * mul;
    else
      out1[orow * Dh + c - Dh] = t;
  }
}

Items make_items(const int* row, const int* item_row, const int* task, const int* item_task,
                 const int* slot, int rows) {
  Items t;
  t.row = row;
  t.item_row = item_row;
  t.task = task;
  t.item_task = item_task;
  t.slot = slot;
  t.rows = rows;
  return t;
}

// launch K<C, FULL> for C >= lane_cols(Dh): 6 with no column guards at
// Dh = 24 (wn-squirrel's heads), else 8, 16 or 32, after setting the
// instance into SMEM bytes
#define BB_LAUNCH_AT(KERNEL, C_, FULL_, GRID, SMEM, STREAM, ...)              \
  do {                                                                         \
    cudaError_t e_ = allow_smem(KERNEL<C_, FULL_>, SMEM);                      \
    if (e_ != cudaSuccess) return e_;                                          \
    KERNEL<C_, FULL_><<<GRID, BB_NT, SMEM, STREAM>>>(__VA_ARGS__);             \
  } while (0)
#define BB_LAUNCH(KERNEL, GRID, SMEM, STREAM, ...)                            \
  do {                                                                         \
    const int lc_ = lane_cols(Dh);                                             \
    if (Dh == GL * 6)                                                          \
      BB_LAUNCH_AT(KERNEL, 6, true, GRID, SMEM, STREAM, __VA_ARGS__);          \
    else if (lc_ <= 8)                                                         \
      BB_LAUNCH_AT(KERNEL, 8, false, GRID, SMEM, STREAM, __VA_ARGS__);         \
    else if (lc_ <= 16)                                                        \
      BB_LAUNCH_AT(KERNEL, 16, false, GRID, SMEM, STREAM, __VA_ARGS__);        \
    else                                                                       \
      BB_LAUNCH_AT(KERNEL, 32, false, GRID, SMEM, STREAM, __VA_ARGS__);        \
  } while (0)


}  // namespace
}  // namespace ggps

using namespace ggps;

extern "C" int bigbird_forward(const float* q, const float* k, const float* v,
                               const unsigned char* ids, const int* row,
                               const int* item_row,
                               const int* task, const int* item_task, const int* slot,
                               const int* c_blk, const int* c_p0, const int* c_np,
                               float* o, float* lse, float* scratch, int n_items,
                               int n_comb, int parts, int rows, int entries, int B, int H,
                               int N, int Dh, int bs, float scale, void* stream) {
  if (Dh < 1 || Dh > BB_MAX_DH || bs < 1) return cudaErrorInvalidValue;
  if (n_items == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Items it = make_items(row, item_row, task, item_task, slot, rows);
  const size_t smem = item_smem(rows, entries, Dh, 1);
  const bool vec = Dh % 4 == 0 && aligned16(k) && aligned16(v);
  BB_LAUNCH(bb_fwd_kernel, dim3(n_items, H, B), smem, st, q, k, v, ids, it, o, lse, scratch,
            parts, N, H, Dh, bs, scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_comb == 0) return err;
  bb_fwd_combine<<<dim3(n_comb * bs, H, B), 32 * CW, 0, st>>>(scratch, c_blk, c_p0, c_np, o,
                                                              lse, parts, N, H, Dh, bs);
  return cudaGetLastError();
}

extern "C" int bigbird_backward(
    const float* q, const float* k, const float* v, const unsigned char* ids, const float* o,
    const float* lse, const float* dout,
    // query side: the keys of each query block
    const int* q_row, const int* q_item_row, const int* q_task, const int* q_item_task,
    const int* q_slot, const int* qc_blk, const int* qc_p0, const int* qc_np,
    // key side: the query rows of each key block
    const int* k_row, const int* k_item_row, const int* k_task, const int* k_item_task,
    const int* k_slot, const int* kc_blk, const int* kc_p0, const int* kc_np,
    float* dq, float* dk, float* dv, float* drow, float* q_scratch, float* k_scratch,
    int q_items, int q_comb, int q_parts, int q_rows, int q_entries, int k_items, int k_comb,
    int k_parts, int k_rows, int k_entries, int B, int H, int N, int Dh, int bs, float scale,
    void* stream) {
  if (Dh < 1 || Dh > BB_MAX_DH || bs < 1) return cudaErrorInvalidValue;
  if (q_items == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Items qi = make_items(q_row, q_item_row, q_task, q_item_task, q_slot, q_rows);
  const bool vec = Dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  const size_t q_smem = item_smem(q_rows, q_entries, Dh, 1);
  BB_LAUNCH(bb_dq_kernel, dim3(q_items, H, B), q_smem, st, q, k, v, ids, o, lse, dout, qi, dq,
            drow, q_scratch, q_parts, N, H, Dh, bs, scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (q_comb > 0) {
    bb_grad_combine<<<dim3(q_comb * bs, H, B), 32 * CW, 0, st>>>(
        q_scratch, qc_blk, qc_p0, qc_np, dq, nullptr, q_parts, N, H, Dh, bs, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const Items ki = make_items(k_row, k_item_row, k_task, k_item_task, k_slot, k_rows);
  const size_t k_smem = item_smem(k_rows, k_entries, Dh, 3);
  BB_LAUNCH(bb_dkv_kernel, dim3(k_items, H, B), k_smem, st, q, k, v, ids, lse, dout, drow, ki,
            dk, dv, k_scratch, k_parts, N, H, Dh, bs, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess || k_comb == 0) return err;
  bb_grad_combine<<<dim3(k_comb * bs, H, B), 32 * CW, 0, st>>>(
      k_scratch, kc_blk, kc_p0, kc_np, dk, dv, k_parts, N, H, Dh, bs, 1.0f);
  return cudaGetLastError();
}
