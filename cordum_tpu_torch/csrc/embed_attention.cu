// Masked bidirectional attention of the context-engine embedder, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the attention core of the JAX package's embedder
// (cordum_tpu/models/embedder.py, forward: the `scores` einsum, the -1e30
// key-mask bias, the fp32 softmax and the `probs @ v` einsum), which XLA
// runs as two batched products around a softmax over [B, h, L, L] scores
// kept in device memory.  Here a head's scores never leave the block.
//
// Numerics, held to the reference in this order:
//   1. scores q.k accumulated in fp32 and rounded to the input dtype (the
//      reference's einsum output), then cast to fp32 and divided by
//      sqrt(head_dim) (8: a power of two, so exact);
//   2. plus an fp32 bias of -1e30 on keys whose mask is 0;
//   3. an fp32 softmax (max, exp, sum, divide);
//   4. probabilities rounded to the input dtype before the fp32-accumulated
//      PV product, whose result is rounded to the input dtype.
//
// The masked-tile skip, exact: keys are taken in tiles of 16.  When a batch
// row has at least one real key, a masked key's score is exactly -1e30
// after the bias and its weight exp(-1e30 - max) is exactly 0, so a tile
// whose keys are all masked is neither loaded nor scored nor multiplied,
// and no bit changes.  A row with no real key (batch padding) skips
// nothing: every score is exactly -1e30 and its softmax is uniform over its
// L keys.  Keys past L (the padding of the last tile out to 16) are never
// part of any softmax.
//
// Bound: at the embedder's shapes (B <= 256, L <= 128, h 4, head_dim 64)
// the bytes (q, k, v and out, read or written once, plus the mask) bound
// the call in bf16; in fp32 the operations (4 * head_dim per query,
// attended key and head) outweigh them on the card's fp32 rate.
//
// Design: warps of 16 query rows; the batch row's mask and tile flags
// first, then q and the live tiles of k and v staged into shared memory
// with 16-byte cp.async.
//   * bf16: two blocks of four warps per (batch row, head), each taking 64
//     query rows (four blocks an SM at staggered phases: one block's loads
//     overlap another's products).  Staged as bf16, rows padded by 8
//     elements so ldmatrix is free of bank conflicts; v lands in a cp.async
//     group of its own while the scores and softmax run.  QK^T with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate) over the live tiles; the softmax runs in registers,
//     reduced across the 4 lanes that share an accumulator row, with the
//     scale as an exact multiply by 0.125, the fast exponential and one
//     reciprocal of each row's sum; the normalised probabilities are
//     rounded to bf16 and repacked from the accumulator fragments into the
//     A operand of PV, which runs with mma.sync on V fragments from
//     ldmatrix.trans.
//   * fp32: one block of eight warps per (batch row, head), so one pass
//     covers L 128.  CUDA cores in full fp32 (TF32 would break parity).  q and k
//     staged transposed ([dim][row]), so a lane's 4 query rows and 4 keys
//     are one float4 each; a lane holds a 4-row x 4-key score tile per
//     32-key chunk, and for PV a 4-row x 8-dim accumulator, taking the
//     probabilities from the lanes that hold them by shuffles.
//
// Layouts: q, k, v [B, L, h, 64] with any batch and row strides (the
// embedder passes views of its fused qkv projection, [B, L, 3, h, 64], so
// no copy is made), head stride 64, unit element stride and 16-byte aligned
// rows; mask [B, L] fp32 contiguous; out [B, L, h, 64] contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kHD = 64;        // head width of the embedder (d 256 / h 4)
constexpr int kMaxL = 128;     // the embedder's max_len
constexpr int kTile = 16;      // keys per tile
constexpr int kTiles = kMaxL / kTile;
constexpr int kWarps = kMaxL / 16;  // fp32: 16 query rows a warp, all of L
constexpr int kThreads = kWarps * kWarp;
constexpr int kStrideBF = kHD + 8;  // bf16 smem row, in elements
constexpr float kMasked = -1e30f;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// The batch row's key bias (0 or -1e30) and which 16-key tiles are live:
// every tile below L when the row has no real key, else the tiles holding
// one.  Returns the live-tile bit mask; ends with a barrier.
__device__ __forceinline__ unsigned read_mask(const float* mask, int b, int L,
                                              float* bias, int* tile_real) {
  if (threadIdx.x < kTiles) tile_real[threadIdx.x] = 0;
  __syncthreads();
  bool real = false;
  if (threadIdx.x < L) {
    real = mask[(long long)b * L + threadIdx.x] > 0.f;
    bias[threadIdx.x] = real ? 0.f : kMasked;
    if (real) tile_real[threadIdx.x / kTile] = 1;
  }
  const bool any_real = __syncthreads_or(real);
  const int n_tiles = (L + kTile - 1) / kTile;
  unsigned live = 0;
  for (int t = 0; t < n_tiles; ++t)
    if (!any_real || tile_real[t]) live |= 1u << t;
  return live;
}

// One 16-key tile of scores for a warp's 16 query rows: s[nt][e], keys
// t*16 + nt*8 + (lane%4)*2 + (e&1), rows r0 + lane/4 (e 0, 1) and + 8
// (e 2, 3): q.k on the tensor cores, rounded to bf16, times 1/sqrt(64) =
// 0.125 (a power of two: the same bits as the reference's division), plus
// the key's bias; -inf past L.
__device__ __forceinline__ void tile_scores(float (&s)[2][4], const uint32_t (&qa)[kHD / 16][4],
                                            const __nv_bfloat16* ks, int t, int lane, int L,
                                            const float* bias, float inv_scale) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    uint32_t bf[4];
    ldsm_x4(bf, ks + (t * kTile + (lane % 8) + (lane / 16) * 8) * kStrideBF + kk * 16 +
                    ((lane / 8) % 2) * 8);
    mma_bf16(s[0], qa[kk], bf[0], bf[1]);
    mma_bf16(s[1], qa[kk], bf[2], bf[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = t * kTile + nt * 8 + (lane % 4) * 2 + (e & 1);
      s[nt][e] = j < L ? round_bf16(s[nt][e]) * inv_scale + bias[j] : -INFINITY;
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTensorElems = kMaxL * kStrideBF;  // one staged k or v

// Stage rows of one tensor: rows < L by cp.async, rows L .. the end of the
// last tile as zeros; the rows of tiles not in `live` are skipped.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long base, long long stride_l, int L,
                                           unsigned live, int n_threads) {
  const int rows = (L + kTile - 1) / kTile * kTile;
  constexpr int kChunks = kHD * 2 / 16;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += n_threads) {
    const int r = c / kChunks, d = (c % kChunks) * 8;
    if (!(live >> (r / kTile) & 1u)) continue;  // a skipped tile: never read
    __nv_bfloat16* p = dst + r * kStrideBF + d;
    if (r < L) cp_async16(p, src + base + (long long)r * stride_l + d);
    else *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
  }
}

// A warp's 16 query rows (r0 ..): the normalised probabilities of every
// live tile, rounded to bf16, as the A operand of PV.
__device__ __forceinline__ void warp_probs(uint32_t (&pa)[kTiles][4], const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks, const float* bias,
                                           unsigned live, int L, int r0, int lane,
                                           float inv_scale) {
  uint32_t qa[kHD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    ldsm_x4(qa[kk], qs + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * kStrideBF + kk * 16 +
                        (lane / 16) * 8);
  float s[kTiles][2][4];
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    if (!(live >> t & 1u)) continue;
    tile_scores(s[t], qa, ks, t, lane, L, bias, inv_scale);
    mx_a = fmaxf(mx_a, fmaxf(fmaxf(s[t][0][0], s[t][0][1]), fmaxf(s[t][1][0], s[t][1][1])));
    mx_b = fmaxf(mx_b, fmaxf(fmaxf(s[t][0][2], s[t][0][3]), fmaxf(s[t][1][2], s[t][1][3])));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o));
  }
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    if (!(live >> t & 1u)) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[t][nt][0] = __expf(s[t][nt][0] - mx_a);
      s[t][nt][1] = __expf(s[t][nt][1] - mx_a);
      s[t][nt][2] = __expf(s[t][nt][2] - mx_b);
      s[t][nt][3] = __expf(s[t][nt][3] - mx_b);
      sum_a += s[t][nt][0] + s[t][nt][1];
      sum_b += s[t][nt][2] + s[t][nt][3];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum_a += __shfl_xor_sync(~0u, sum_a, o);
    sum_b += __shfl_xor_sync(~0u, sum_b, o);
  }
  const float ia = __fdividef(1.f, sum_a), ib = __fdividef(1.f, sum_b);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    pa[t][0] = pack_bf16(s[t][0][0] * ia, s[t][0][1] * ia);
    pa[t][1] = pack_bf16(s[t][0][2] * ib, s[t][0][3] * ib);
    pa[t][2] = pack_bf16(s[t][1][0] * ia, s[t][1][1] * ia);
    pa[t][3] = pack_bf16(s[t][1][2] * ib, s[t][1][3] * ib);
  }
}

// PV over the live tiles for a warp's 16 rows, and their output rows below
// n_rows (rows of `out` are out_row elements apart).
__device__ __forceinline__ void warp_pv_store(const uint32_t (&pa)[kTiles][4],
                                              const __nv_bfloat16* vs, unsigned live, int n_rows,
                                              int r0, int lane, __nv_bfloat16* out,
                                              int out_row) {
  float acc[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    if (!(live >> t & 1u)) continue;
#pragma unroll
    for (int dp = 0; dp < kHD / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, vs + (t * kTile + (lane % 8) + ((lane / 8) % 2) * 8) * kStrideBF +
                        dp * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * dp], pa[t], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], pa[t], bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lane / 4 + 8 * half;
    if (r >= n_rows) continue;
    __nv_bfloat16* dst = out + (long long)r * out_row + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// A (batch row, head) is split across two blocks of 64 query rows (each
// stages its own rows of q and all live tiles of k and v; the second read
// of k and v comes mostly from L2): four smaller blocks an SM, at staggered
// phases, overlap one block's loads with another's products.
constexpr int kBfSplit = 2;
constexpr int kBfRows = kMaxL / kBfSplit;      // query rows a bf16 block takes
constexpr int kBfThreads = kBfRows / 16 * kWarp;

__global__ void __launch_bounds__(kBfThreads, 16 / (kBfRows / 16))
embed_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int L, int H,
                            long long stride_b, long long stride_l, float scale_div) {
  using T = __nv_bfloat16;
  const float inv_scale = 1.f / scale_div;  // 0.125: exact
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [128][kStrideBF]
  T* vs = ks + kTensorElems;
  T* qs = vs + kTensorElems;                // [kBfRows][kStrideBF]: this block's rows
  __shared__ float bias[kMaxL];
  __shared__ int tile_real[kTiles];

  const int bh = blockIdx.x / kBfSplit;  // (batch row, head)
  const int row0 = (blockIdx.x % kBfSplit) * kBfRows;  // this block's first query row
  if (row0 >= L) return;  // the whole block: no query row here
  const int b = bh / H, head = bh % H;
  const long long base = (long long)b * stride_b + (long long)head * kHD;
  // q first (always needed), so its loads fly while the mask is read
  stage_bf16(qs, q, base + (long long)row0 * stride_l, stride_l, min(kBfRows, L - row0), ~0u,
             kBfThreads);
  const unsigned live = read_mask(mask, b, L, bias, tile_real);
  stage_bf16(ks, k, base, stride_l, L, live, kBfThreads);
  cp_async_commit();
  stage_bf16(vs, v, base, stride_l, L, live, kBfThreads);
  cp_async_commit();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int r0 = warp * 16;               // within this block's rows
  const bool busy = row0 + r0 < L;        // every warp still meets the barrier
  uint32_t pa[kTiles][4];
  cp_async_wait<1>();  // q and k
  __syncthreads();
  if (busy) warp_probs(pa, qs, ks, bias, live, L, r0, lane, inv_scale);
  cp_async_wait<0>();  // v
  __syncthreads();
  if (busy)
    warp_pv_store(pa, vs, live, L - row0, r0, lane,
                  out + (((long long)b * L + row0) * H + head) * kHD, H * kHD);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kChunk32 = 32;  // keys a lane group scores together (2 tiles)

__global__ void __launch_bounds__(kThreads, 2)
embed_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ mask,
                           float* __restrict__ out, int L, int H, long long stride_b,
                           long long stride_l, float scale_div) {
  const float inv_scale = 1.f / scale_div;  // 0.125: exact
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [64][128]: q transposed
  float* kt = qt + kHD * kMaxL;                     // [64][128]: k transposed
  float* vs = kt + kHD * kMaxL;                     // [128][64]
  __shared__ float bias[kMaxL];
  __shared__ int tile_real[kTiles];

  const int b = blockIdx.x / H;
  const int head = blockIdx.x % H;
  const long long base = (long long)b * stride_b + (long long)head * kHD;
  const int rows = (L + kTile - 1) / kTile * kTile;
  constexpr int kChunks = kHD / 4;  // float4s a row

  // q, transposed: consecutive threads take consecutive rows of one chunk
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c % rows, d = (c / rows) * 4;
    const float4 x = r < L ? *reinterpret_cast<const float4*>(q + base + (long long)r * stride_l + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    qt[(d + 0) * kMaxL + r] = x.x;
    qt[(d + 1) * kMaxL + r] = x.y;
    qt[(d + 2) * kMaxL + r] = x.z;
    qt[(d + 3) * kMaxL + r] = x.w;
  }
  const unsigned live = read_mask(mask, b, L, bias, tile_real);
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c % rows, d = (c / rows) * 4;
    if (!(live >> (r / kTile) & 1u)) continue;  // a skipped tile: never read
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < L) {
      const long long off = base + (long long)r * stride_l + d;
      x = *reinterpret_cast<const float4*>(k + off);
      cp_async16(vs + r * kHD + d, v + off);
    } else {
      *reinterpret_cast<float4*>(vs + r * kHD + d) = x;
    }
    kt[(d + 0) * kMaxL + r] = x.x;
    kt[(d + 1) * kMaxL + r] = x.y;
    kt[(d + 2) * kMaxL + r] = x.z;
    kt[(d + 3) * kMaxL + r] = x.w;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int r0 = warp * 16;
  if (r0 >= L) return;
  const int lr = lane / 8, lc = lane % 8;  // rows r0 + lr*4 + i; keys lc*4 + jj
  const int my_rows = r0 + lr * 4;

  // s[c][i][jj]: row my_rows + i, key c*32 + lc*4 + jj
  float s[kMaxL / kChunk32][4][4];
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < kMaxL / kChunk32; ++c) {
    const unsigned chunk_live = live >> (2 * c) & 3u;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[c][i][0] = s[c][i][1] = s[c][i][2] = s[c][i][3] = 0.f;
    if (!chunk_live) continue;
    const int key0 = c * kChunk32 + lc * 4;
#pragma unroll 8
    for (int d = 0; d < kHD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kMaxL + my_rows);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kMaxL + key0);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[c][i][jj] = fmaf(qa[i], ka[jj], s[c][i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = key0 + jj;
      const bool ok = j < L && (live >> (j / kTile) & 1u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[c][i][jj] = ok ? s[c][i][jj] * inv_scale + bias[j] : -INFINITY;
        mx[i] = fmaxf(mx[i], s[c][i][jj]);
      }
    }
  }
  float sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], o));
    sum[i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kMaxL / kChunk32; ++c) {
    if (!(live >> (2 * c) & 3u)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[c][i][jj] = expf(s[c][i][jj] - mx[i]);
        sum[i] += s[c][i][jj];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum[i] += __shfl_xor_sync(~0u, sum[i], o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] = __fdividef(1.f, sum[i]);
#pragma unroll
  for (int c = 0; c < kMaxL / kChunk32; ++c) {
    if (!(live >> (2 * c) & 3u)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[c][i][jj] *= sum[i];
  }

  // PV: this lane's rows my_rows + i, dims lc*4 + e and 32 + lc*4 + e
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxL / kChunk32; ++c) {
#pragma unroll
    for (int src = 0; src < 8; ++src) {  // the lane (of this row group) holding the keys
      const int key0 = c * kChunk32 + src * 4;
      if (!(live >> (key0 / kTile) & 1u)) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(~0u, s[c][i][jj], lr * 8 + src);
        const float* vr = vs + (key0 + jj) * kHD;
        const float4 v0 = *reinterpret_cast<const float4*>(vr + lc * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 32 + lc * 4);
        const float va[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p[i], va[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = my_rows + i;
    if (r >= L) continue;
    float* dst = out + (((long long)b * L + r) * H + head) * kHD;
    *reinterpret_cast<float4*>(dst + lc * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 32 + lc * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above 48 KB only after an opt-in
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim must be 64 and 1 <= L <= 128;
// rows 16-byte aligned.  Strides are in elements.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess); the caller checks every argument.
extern "C" int embed_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int L, int H,
                                      int head_dim, long long stride_b,
                                      long long stride_l, float scale_div,
                                      void* stream) {
  if (head_dim != kHD || L < 1 || L > kMaxL || B < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = sizeof(float) * 3 * kHD * kMaxL;
    cudaError_t e = set_smem((const void*)embed_attention_f32_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    embed_attention_f32_kernel<<<B * H, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(mask),
        static_cast<float*>(out), L, H, stride_b, stride_l, scale_div);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const size_t smem = sizeof(T) * (2 * kTensorElems + kBfRows * kStrideBF);
    cudaError_t e = set_smem((const void*)embed_attention_bf16_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    embed_attention_bf16_kernel<<<B * H * kBfSplit, kBfThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<T*>(out), L, H, stride_b, stride_l,
        scale_div);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
