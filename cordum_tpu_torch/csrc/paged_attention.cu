// Ragged paged GQA attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the gather-and-attend core of the JAX package's ragged serving
// step (cordum_tpu/models/llama.py, ragged_step: `k_pages[li][pt_tok]`
// followed by `_attention(..., q_offset=pos2)`), which materialises every
// token's whole page-table row, [T, P*ps, kvh, hd], per layer.  Here each
// page a sequence needs is read once per KV head.
//
// Bound: device-memory bytes.  The work is the K/V pages each sequence
// needs, counted once, over 3.35 TB/s; the arithmetic (4*hd flops per key
// and query head) is far below the card's rate at any batch this step runs.
//
// Design (work items over sequences, not tokens):
//   * the host builds a plan once per step (ops/paged_attention.py
//     build_plan): a sequence's tokens in the step are cut into groups of at
//     most 16 (at most 64 query rows = tokens x the GQA group), and a group's
//     pages 0 .. max position / page_size into runs whose length comes from
//     the whole step's page count, so that the items are near-equal in pages
//     and a long row gets many runs while a short row gets one;
//   * one block per (item, KV head), four warps of 16 query rows each: the
//     block stages its query rows once, then streams its run of pages
//     through a ring of kStages shared-memory stages filled with cp.async,
//     so every page is read once for all the group's tokens and heads;
//   * bf16: QK^T and PV on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate; K fragments by ldmatrix, V by ldmatrix.trans; shared rows
//     padded by 8 elements so ldmatrix is free of bank conflicts).  Scores
//     are rounded to bf16 before the fp32 scale, as the reference's einsum
//     output is; the probabilities go from the accumulator fragments into
//     the A operand of PV as bf16 without a trip through shared memory.
//     Decode groups pad M from the GQA group to 16 rows (bytes bound the
//     call, not the tensor cores); a 16-key tile past every position of a
//     warp's rows is skipped;
//   * fp32: CUDA cores in full fp32 (no TF32); keys across lanes: a lane
//     scores one key of the 16-key tile over half the head dims out of
//     shared memory and one shuffle joins the two halves (no reduction tree
//     over the head dims); the group's rows go round the four warps (a
//     decode group's 4 rows keep all four busy), and for PV each lane owns
//     4 head dims.  The rows a warp takes are a compile-time bucket (1, 2,
//     4, 8 or 16), chosen once per block, so the loops over rows unroll
//     with no per-row guard.  A page costs a warp time in proportion to its
//     rows here, so build_plan weights a float32 group's pages by its
//     rows;
//   * online softmax in fp32 (running max and sum per query row); a causal
//     mask per row (k_pos <= pos).  The scale is a multiply by 1/sqrt(HD)
//     and the final normalisation a fast reciprocal: no IEEE division in
//     the loops;
//   * an item that covers its group's whole row writes the normalised
//     output; only the items of a split group write fp32 partials
//     (acc, max, sum), and a second pass merges them, over the split
//     groups only: one block per (split group, KV head, 4 query rows);
// Not done yet: TMA with a producer warp, a persistent schedule.
//
// The K/V append is NOT done here: tokens of one prefill chunk attend to
// each other's slots, which other blocks of the same grid would write in no
// order.  The caller writes the step's K/V into the arena first, on the
// same stream.
//
// Layouts (all contiguous):
//   q            [T, n_heads, HD]
//   k/v pages    [num_pages, page_size, n_kv_heads, HD]
//   page_tables  [S + 1, pages_per_seq] int32
//   positions    [T] int32  (token t attends to keys 0 .. positions[t])
//   items        [cap_items, 4] int32: group, first page, end page, slot
//   groups       [cap_groups, 2 + 16] int32: table row, n tokens, tokens
//   splits       [cap_groups, 3] int32: group, first item, n items
//   out          [T, n_heads, HD]
//   scratch      [cap_items, n_kv_heads, 64, HD + 2] fp32: acc, max, sum
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 64;      // query rows a block holds (MAX_GROUP_ROWS)
constexpr int kMaxTok = 16;    // tokens a group holds (MAX_GROUP_TOKENS)
constexpr int kStages = 4;     // ring stages: pages in flight per block
constexpr int kMinBlocks = 3;  // bf16 blocks an SM (<= 168 registers, no spills)
constexpr int kTile = 16;      // keys per tile
constexpr int kItemCols = 4;
constexpr int kGroupCols = 2 + kMaxTok;
constexpr int kSplitCols = 3;

// shared-memory row strides, in elements
template <typename T, int HD> struct Strides;
template <int HD> struct Strides<__nv_bfloat16, HD> {
  static constexpr int q = HD + 8, k = HD + 8, v = HD + 8;
};
template <int HD> struct Strides<float, HD> {
  static constexpr int q = HD + 4, k = HD + 4, v = HD;
};

__host__ __device__ __forceinline__ int tile_keys(int page_size) {
  return (page_size + kTile - 1) / kTile * kTile;
}

template <typename T, int HD>
size_t smem_bytes(int page_size) {
  using S = Strides<T, HD>;
  return sizeof(T) * ((size_t)kRows * S::q +
                      (size_t)kStages * tile_keys(page_size) * (S::k + S::v));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The grid is (KV head, item): the blocks of one item's KV heads are
// launched side by side, so they read the rows of the same pages together.
__device__ __forceinline__ int block_head() { return blockIdx.x; }
__device__ __forceinline__ int block_item() { return blockIdx.y; }

// What a block works on: its item, its group's tokens and their positions.
struct Work {
  int first, n_pages, slot, n_rows, group_size;
  const int* table;
};

__device__ __forceinline__ bool read_work(const int* items, const int* groups,
                                          const int* page_tables,
                                          const int* positions, int n_heads,
                                          int n_kv_heads, int pages_per_seq,
                                          int* s_tok, int* s_pos, Work* w) {
  const int* item = items + (size_t)block_item() * kItemCols;
  const int grp = item[0];
  if (grp < 0) return false;  // past the plan's items
  const int* gr = groups + (size_t)grp * kGroupCols;
  const int n_tok = gr[1];
  if (threadIdx.x < n_tok) {
    const int t = gr[2 + threadIdx.x];
    s_tok[threadIdx.x] = t;
    s_pos[threadIdx.x] = positions[t];
  }
  w->first = item[1];
  w->n_pages = item[2] - item[1];
  w->slot = item[3];
  w->group_size = n_heads / n_kv_heads;
  w->n_rows = n_tok * w->group_size;
  w->table = page_tables + (size_t)gr[0] * pages_per_seq;
  __syncthreads();
  return true;
}

// Stage the block's query rows (row r = token r / G, head g*G + r % G) into
// Qs; rows n_rows .. 63 are zeros.  16-byte chunks, all threads.
template <typename T, int HD>
__device__ __forceinline__ void load_q(T* qs, const T* q, const int* s_tok,
                                       const Work& w, int n_heads) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = HD / kChunk;
  const int g = block_head();
  for (int c = threadIdx.x; c < kRows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int d = (c - r * kPerRow) * kChunk;
    T* dst = qs + r * Strides<T, HD>::q + d;
    if (r < w.n_rows) {
      const int head = g * w.group_size + r % w.group_size;
      cp_async16(dst, q + ((size_t)s_tok[r / w.group_size] * n_heads + head) * HD + d);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Stage one page's K and V rows of KV head g into a ring stage.
template <typename T, int HD>
__device__ __forceinline__ void load_page(T* ks, T* vs, const T* k_pages,
                                          const T* v_pages, int page,
                                          int page_size, int n_kv_heads) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = HD / kChunk;
  const int g = block_head();
  for (int c = threadIdx.x; c < page_size * kPerRow; c += kThreads) {
    const int j = c / kPerRow;
    const int d = (c - j * kPerRow) * kChunk;
    const size_t off = (((size_t)page * page_size + j) * n_kv_heads + g) * HD + d;
    cp_async16(ks + j * Strides<T, HD>::k + d, k_pages + off);
    cp_async16(vs + j * Strides<T, HD>::v + d, v_pages + off);
  }
}

// Rows page_size .. tile_keys - 1 of every stage are zeros: they are never
// loaded, always masked, and must not hold NaNs that a product would carry.
template <typename T, int HD>
__device__ __forceinline__ void zero_tail_rows(T* stages, int page_size) {
  using S = Strides<T, HD>;
  const int keys = tile_keys(page_size);
  const int stage = keys * (S::k + S::v);
  const int n = (keys - page_size) * (S::k + S::v);
  for (int i = threadIdx.x; i < kStages * n; i += kThreads) {
    const int st = i / n, e = i % n;
    const int kn = (keys - page_size) * S::k;
    T* p = stages + st * stage +
           (e < kn ? page_size * S::k + e : keys * S::k + page_size * S::v + (e - kn));
    *p = T(0.f);
  }
}

// The page ring around a per-page compute step: `page_fn(ks, vs, p)` runs
// for page p of the run once it has landed.
template <typename T, int HD, typename F>
__device__ __forceinline__ void stream_pages(T* stages, const T* k_pages,
                                             const T* v_pages, const Work& w,
                                             int page_size, int n_kv_heads,
                                             F&& page_fn) {
  using S = Strides<T, HD>;
  const int keys = tile_keys(page_size);
  const int stage = keys * (S::k + S::v);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < w.n_pages) {
      T* st = stages + s * stage;
      load_page<T, HD>(st, st + keys * S::k, k_pages, v_pages, w.table[w.first + s],
                       page_size, n_kv_heads);
    }
    cp_async_commit();  // one group per stage, empty past the run's end
  }
  // the page id of the next load, read one iteration ahead
  int next_page = kStages - 1 < w.n_pages ? w.table[w.first + kStages - 1] : 0;
  for (int p = 0; p < w.n_pages; ++p) {
    cp_async_wait_stages();  // page p (and the query rows) landed: this thread
    __syncthreads();         // ... and every thread; stage p-1 is free again
    const int nxt = p + kStages - 1;
    if (nxt < w.n_pages) {
      T* st = stages + (nxt % kStages) * stage;
      load_page<T, HD>(st, st + keys * S::k, k_pages, v_pages, next_page, page_size,
                       n_kv_heads);
      if (nxt + 1 < w.n_pages) next_page = w.table[w.first + nxt + 1];
    }
    cp_async_commit();
    const T* ks = stages + (p % kStages) * stage;
    page_fn(ks, ks + keys * S::k, p);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks) paged_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_tables,
    const int* __restrict__ positions, const int* __restrict__ items,
    const int* __restrict__ groups, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int n_heads, int n_kv_heads, int page_size,
    int pages_per_seq, float inv_scale) {
  using T = __nv_bfloat16;
  using S = Strides<T, HD>;
  constexpr int kK = HD / 16;  // k-steps of QK, n-tile pairs of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_tok[kMaxTok], s_pos[kMaxTok];
  Work w;
  if (!read_work(items, groups, page_tables, positions, n_heads, n_kv_heads,
                 pages_per_seq, s_tok, s_pos, &w))
    return;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* stages = qs + kRows * S::q;
  if (page_size % kTile) zero_tail_rows<T, HD>(stages, page_size);
  load_q<T, HD>(qs, q, s_tok, w, n_heads);  // lands with page 0's group

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int r0 = warp * 16;
  const bool busy = r0 < w.n_rows;
  // this lane's two accumulator rows and their positions (-1: a pad row)
  const int ra = r0 + lane / 4, rb = ra + 8;
  const int pos_a = ra < w.n_rows ? s_pos[ra / w.group_size] : -1;
  const int pos_b = rb < w.n_rows ? s_pos[rb / w.group_size] : -1;
  int warp_max = max(pos_a, pos_b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) warp_max = max(warp_max, __shfl_xor_sync(~0u, warp_max, o));

  uint32_t qa[kK][4];
  float acc[2 * kK][4];
#pragma unroll
  for (int n = 0; n < 2 * kK; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const int keys = tile_keys(page_size);

  stream_pages<T, HD>(stages, k_pages, v_pages, w, page_size, n_kv_heads,
                      [&](const T* ks, const T* vs, int p) {
    if (!busy) return;
    if (p == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        ldsm_x4(qa[kk], qs + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * S::q +
                            kk * 16 + (lane / 16) * 8);
    }
    const int page_k0 = (w.first + p) * page_size;
    for (int kt = 0; kt < keys; kt += kTile) {
      if (page_k0 + kt > warp_max) break;  // past every row of this warp
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, ks + (kt + (lane % 8) + (lane / 16) * 8) * S::k + kk * 16 +
                       ((lane / 8) % 2) * 8);
        mma_bf16(s[0], qa[kk], b[0], b[1]);
        mma_bf16(s[1], qa[kk], b[2], b[3]);
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt + nt * 8 + (lane % 4) * 2 + (e & 1);
          const int lim = e < 2 ? pos_a : pos_b;
          const bool ok = j < page_size && page_k0 + j <= lim;
          s[nt][e] = ok ? round_bf16(s[nt][e]) * inv_scale : -INFINITY;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row with no key yet keeps max -inf: no rescale, zero weights
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = expf(m_a - base_a), corr_b = expf(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= corr_a;
      l_b *= corr_b;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = expf(s[nt][0] - base_a);
        s[nt][1] = expf(s[nt][1] - base_a);
        s[nt][2] = expf(s[nt][2] - base_b);
        s[nt][3] = expf(s[nt][3] - base_b);
        l_a += s[nt][0] + s[nt][1];
        l_b += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int n = 0; n < 2 * kK; ++n) {
        acc[n][0] *= corr_a;
        acc[n][1] *= corr_a;
        acc[n][2] *= corr_b;
        acc[n][3] *= corr_b;
      }
      // accumulator fragments -> the A operand of PV, as bf16
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < kK; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kt + (lane % 8) + ((lane / 8) % 2) * 8) * S::v + dp * 16 +
                         (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  });
  if (busy) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_a += __shfl_xor_sync(~0u, l_a, o);
      l_b += __shfl_xor_sync(~0u, l_b, o);
    }
    const int g = block_head();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= w.n_rows) continue;
      const float m = half ? m_b : m_a, l = half ? l_b : l_a;
      const int col = (lane % 4) * 2;
      if (w.slot < 0) {
        const int head = g * w.group_size + r % w.group_size;
        T* dst = out + ((size_t)s_tok[r / w.group_size] * n_heads + head) * HD + col;
        const float il = __fdividef(1.f, l);
#pragma unroll
        for (int n = 0; n < 2 * kK; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * half] * il, acc[n][2 * half + 1] * il);
        }
      } else {
        float* dst = part + (((size_t)w.slot * n_kv_heads + g) * kRows + r) * (HD + 2);
#pragma unroll
        for (int n = 0; n < 2 * kK; ++n)
          *reinterpret_cast<float2*>(dst + n * 8 + col) =
              make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
        if (lane % 4 == 0) {
          dst[HD] = m;
          dst[HD + 1] = l;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, keys across lanes
// ---------------------------------------------------------------------------

// The block's work for R rows a warp (rows warp, warp + 4, ...): R is a
// compile-time bucket, so every loop over rows is unrolled with no guard;
// rows past the group's are zeros, masked, and never stored.
template <int HD, int R>
__device__ __forceinline__ void f32_rows(const float* __restrict__ k_pages,
                                         const float* __restrict__ v_pages,
                                         float* __restrict__ out, float* __restrict__ part,
                                         const Work& w, const float* qs, float* stages,
                                         const int* s_tok, const int* s_pos, int n_heads,
                                         int n_kv_heads, int page_size, float inv_scale) {
  using T = float;
  using S = Strides<T, HD>;
  constexpr int kHalf = HD / 2;             // head dims a lane scores
  constexpr int kDims = HD >= 128 ? 4 : 1;  // head dims a lane owns in PV
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int jl = lane % 16, dh = lane / 16;  // this lane's key, half of the dims
  const int d_own = lane * kDims;            // this lane's dims in PV
  const bool busy = warp < w.n_rows;
  int pos[R];
  int warp_max = -1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + kWarps * i;
    pos[i] = r < w.n_rows ? s_pos[r / w.group_size] : -1;  // -1: a pad row
    warp_max = max(warp_max, pos[i]);
  }
  float acc[R][kDims];
  float m[R], l[R];  // l: the sum over this lane's keys
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }
  const int keys = tile_keys(page_size);

  stream_pages<T, HD>(stages, k_pages, v_pages, w, page_size, n_kv_heads,
                      [&](const T* ks, const T* vs, int p) {
    if (!busy) return;
    const int page_k0 = (w.first + p) * page_size;
    for (int kt = 0; kt < keys; kt += kTile) {
      if (page_k0 + kt > warp_max) break;
      const int j = kt + jl;
      const float* kr = ks + j * S::k + dh * kHalf;
      float s[R];
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kHalf; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(
              qs + (warp + kWarps * i) * S::q + dh * kHalf + d);
          s[i] = fmaf(q4.x, k4.x, s[i]);
          s[i] = fmaf(q4.y, k4.y, s[i]);
          s[i] = fmaf(q4.z, k4.z, s[i]);
          s[i] = fmaf(q4.w, k4.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] += __shfl_xor_sync(~0u, s[i], 16);  // the other half's dims
        const float x = j < page_size && page_k0 + j <= pos[i] ? s[i] * inv_scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
        const float mn = fmaxf(m[i], mx);
        const float base = mn == -INFINITY ? 0.f : mn;
        const float corr = expf(m[i] - base);
        m[i] = mn;
        s[i] = expf(x - base);
        l[i] = l[i] * corr + s[i];
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[i][c] *= corr;
      }
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        float v[kDims];
        if constexpr (kDims == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vs + (kt + jj) * S::v + d_own);
          v[0] = v4.x;
          v[1] = v4.y;
          v[2] = v4.z;
          v[3] = v4.w;
        } else {
          v[0] = d_own < HD ? vs[(kt + jj) * S::v + d_own] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pij = __shfl_sync(~0u, s[i], jj);
#pragma unroll
          for (int c = 0; c < kDims; ++c) acc[i][c] = fmaf(pij, v[c], acc[i][c]);
        }
      }
    }
  });
  if (!busy) return;
  const int g = block_head();
#pragma unroll
  for (int i = 0; i < R; ++i) {  // both halves hold the same keys' weights: sum one
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) l[i] += __shfl_xor_sync(~0u, l[i], o);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float li = l[i];
    const int r = warp + kWarps * i;
    if (r >= w.n_rows || d_own >= HD) continue;
    if (w.slot < 0) {
      const int head = g * w.group_size + r % w.group_size;
      float* dst = out + ((size_t)s_tok[r / w.group_size] * n_heads + head) * HD + d_own;
      const float il = __fdividef(1.f, li);
#pragma unroll
      for (int c = 0; c < kDims; ++c) dst[c] = acc[i][c] * il;
    } else {
      float* dst = part + (((size_t)w.slot * n_kv_heads + g) * kRows + r) * (HD + 2);
#pragma unroll
      for (int c = 0; c < kDims; ++c) dst[d_own + c] = acc[i][c];
      if (lane == 0) {
        dst[HD] = m[i];
        dst[HD + 1] = li;
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ page_tables,
    const int* __restrict__ positions, const int* __restrict__ items,
    const int* __restrict__ groups, float* __restrict__ out,
    float* __restrict__ part, int n_heads, int n_kv_heads, int page_size,
    int pages_per_seq, float inv_scale) {
  using S = Strides<float, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_tok[kMaxTok], s_pos[kMaxTok];
  Work w;
  if (!read_work(items, groups, page_tables, positions, n_heads, n_kv_heads,
                 pages_per_seq, s_tok, s_pos, &w))
    return;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* stages = qs + kRows * S::q;
  if (page_size % kTile) zero_tail_rows<float, HD>(stages, page_size);
  load_q<float, HD>(qs, q, s_tok, w, n_heads);
  // rows a warp takes, rounded up to a bucket (the same for the whole block)
  const int per_warp = (w.n_rows + kWarps - 1) / kWarps;
#define PA_F32_ROWS(R)                                                          \
  f32_rows<HD, R>(k_pages, v_pages, out, part, w, qs, stages, s_tok, s_pos, n_heads, \
                  n_kv_heads, page_size, inv_scale)
  if (per_warp <= 1) PA_F32_ROWS(1);
  else if (per_warp <= 2) PA_F32_ROWS(2);
  else if (per_warp <= 4) PA_F32_ROWS(4);
  else if (per_warp <= 8) PA_F32_ROWS(8);
  else PA_F32_ROWS(16);
#undef PA_F32_ROWS
}

// ---------------------------------------------------------------------------
// merge: only the split groups' partials
// ---------------------------------------------------------------------------

constexpr int kMergeRows = 4;     // query rows a merge block takes
// runs a group may have: the plan caps them at MAX_MERGE_RUNS (ops/
// paged_attention.py plan_capacity), whatever the page-table width
constexpr int kMaxRuns = 1024;

// One block per (split group, KV head, 4 query rows).  First each row's
// max over the runs and each run's weight exp(max_z - max) into shared
// memory (runs across threads), then one thread per (row, head dim) sums
// the weighted accumulators with its loads independent across runs.
template <typename T, int HD>
__global__ void __launch_bounds__(kMergeRows * HD) paged_attention_merge_kernel(
    const float* __restrict__ part, const int* __restrict__ groups,
    const int* __restrict__ splits, T* __restrict__ out, int n_heads,
    int n_kv_heads) {
  __shared__ float s_w[kMergeRows][kMaxRuns];
  __shared__ float s_den[kMergeRows];
  const int* sp = splits + (size_t)blockIdx.x * kSplitCols;
  const int first = sp[1], n = min(sp[2], kMaxRuns);
  const int* gr = groups + (size_t)sp[0] * kGroupCols;
  const int group_size = n_heads / n_kv_heads;
  const int n_rows = gr[1] * group_size;
  const int r0 = blockIdx.z * kMergeRows, g = blockIdx.y;
  if (r0 >= n_rows) return;
  const size_t item_stride = (size_t)n_kv_heads * kRows * (HD + 2);
  const float* p0 = part + (((size_t)first * n_kv_heads + g) * kRows + r0) * (HD + 2);
  for (int i = threadIdx.x; i < kMergeRows * n; i += blockDim.x) {
    const int r = i / n, z = i % n;
    s_w[r][z] = p0[z * item_stride + r * (HD + 2) + HD];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < kMergeRows; r += blockDim.x / 32) {  // a warp a row
    float mx = -INFINITY;
    for (int z = lane; z < n; z += 32) mx = fmaxf(mx, s_w[r][z]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float den = 0.f;
    for (int z = lane; z < n; z += 32) {
      // 0 for a run with no key of the row (its max is -inf)
      const float wz = expf(s_w[r][z] - mx);
      s_w[r][z] = wz;
      den += wz * p0[z * item_stride + r * (HD + 2) + HD + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(~0u, den, o);
    if (lane == 0) s_den[r] = den;
  }
  __syncthreads();
  const int r = threadIdx.x / HD, d = threadIdx.x % HD;
  if (r0 + r >= n_rows) return;
  const float* pr = p0 + r * (HD + 2) + d;
  float num = 0.f;
#pragma unroll 8
  for (int z = 0; z < n; ++z) num = fmaf(s_w[r][z], pr[z * item_stride], num);
  const int row = r0 + r;
  const int head = g * group_size + row % group_size;
  const float o = num / s_den[r];
  T* dst = out + ((size_t)gr[2 + row / group_size] * n_heads + head) * HD + d;
  if constexpr (sizeof(T) == 2) {
    *dst = __float2bfloat16(o);
  } else {
    *dst = o;
  }
}

template <typename T, int HD, typename K>
cudaError_t launch(K kernel, const void* q, const void* k, const void* v,
                   const void* pt, const void* pos, const void* items,
                   const void* groups, const void* splits, void* out,
                   void* scratch, int cap_items, int n_splits, int n_heads,
                   int n_kv_heads, int page_size, int pages_per_seq,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(page_size);
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(n_kv_heads, cap_items), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pt), static_cast<const int*>(pos),
      static_cast<const int*>(items), static_cast<const int*>(groups), static_cast<T*>(out),
      static_cast<float*>(scratch), n_heads, n_kv_heads, page_size, pages_per_seq,
      1.f / sqrtf((float)HD));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 0) return e;
  paged_attention_merge_kernel<T, HD>
      <<<dim3(n_splits, n_kv_heads, kRows / kMergeRows), kMergeRows * HD, 0, stream>>>(
          static_cast<const float*>(scratch), static_cast<const int*>(groups),
          static_cast<const int*>(splits), static_cast<T*>(out), n_heads, n_kv_heads);
  return cudaGetLastError();
}

#define PA_ARGS                                                               \
  q, k, v, pt, pos, items, groups, splits, out, scratch, cap_items, n_splits,  \
      n_heads, n_kv_heads, page_size, pages_per_seq, stream

template <int HD>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v,
                         const void* pt, const void* pos, const void* items,
                         const void* groups, const void* splits, void* out,
                         void* scratch, int cap_items, int n_splits, int n_heads,
                         int n_kv_heads, int page_size, int pages_per_seq,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD>(paged_attention_f32_kernel<HD>, PA_ARGS);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD>(paged_attention_bf16_kernel<HD>, PA_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16 or 128; the plan's tensors
// (items, groups, splits) as ops/paged_attention.py build_plan lays them
// out; n_splits = the plan's count of split groups (0: no merge launch);
// scratch holds [cap_items, n_kv_heads, 64, head_dim + 2] floats when
// n_splits > 0.  Returns the launches' cudaGetLastError() (0 =
// cudaSuccess); the caller checks every argument.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* pt, const void* pos, const void* items,
    const void* groups, const void* splits, void* out, void* scratch,
    int cap_items, int n_splits, int n_heads, int n_kv_heads, int head_dim,
    int page_size, int pages_per_seq, int tokens_per_group, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_kv_heads < 1 || n_heads % n_kv_heads ||
      tokens_per_group * (n_heads / n_kv_heads) > kRows ||
      tokens_per_group > kMaxTok || page_size < 1 || cap_items < 1) {
    return (int)cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 16:
      return (int)launch_dtype<16>(dtype, PA_ARGS);
    case 128:
      return (int)launch_dtype<128>(dtype, PA_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
