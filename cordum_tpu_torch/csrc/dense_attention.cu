// Dense causal GQA self-attention, forward and backward, for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the attention core of the JAX package's Llama forward
// (cordum_tpu/models/llama.py, _attention: the `scores` einsum, the causal
// -1e30 mask, the fp32 softmax and the `probs @ v` einsum) as _block calls it
// with q_offset = positions, and the gradient XLA derives for it under
// jax.value_and_grad in loss_fn.  That includes the sequence-parallel call
// (_block's all-gather flavour over an sp mesh axis): a rank's queries are
// its Tq = T / sp chunk at their global positions, its keys and values the
// whole gathered Tk = T; so queries and keys have lengths of their own.  XLA keeps [B, H, T, T] fp32 scores and
// probabilities in device memory (and autograd keeps them for every layer);
// here a block's scores never leave it, and the backward recomputes them from
// the row statistics the forward saves (lse = max + log(sum), fp32 [B, H, T]).
//
// Numerics, held to the reference:
//   * scores q.k accumulated in fp32 and rounded to the input dtype (the
//     reference's einsum output), then cast to fp32 and multiplied by
//     1/sqrt(head_dim) (the reference divides; the two differ by at most one
//     fp32 ulp);
//   * the mask is k_index <= positions[b, q] (k_index < Tk: a position at or
//     past Tk reaches every key); a masked score is left out of
//     the softmax (weight exactly 0, which is what exp(-1e30 - max) gives
//     the reference when the row has a live key).  A row whose position is
//     negative has no live key: the reference's softmax over Tk equal -1e30s
//     is uniform over all Tk keys, and so it is here (every score counts as
//     0), with no gradient into q or k (the reference's `where` blocks it);
//   * an fp32 online softmax (running max and sum per row); the weights
//     exp(s - max) are rounded to the input dtype before the PV product and
//     the sum is divided out at the end (the reference rounds the
//     normalised probabilities: a few bf16 ulps apart);
//   * the backward: P = exp(s - lse) in fp32, dP = dO V^T accumulated in
//     fp32 and not rounded, dS = P * (dP - D) / sqrt(head_dim) rounded to
//     the input dtype before the dQ = dS K and dK = dS^T Q products.  dP - D
//     cancels where a row's weight sits on few keys (one live key: dS is 0),
//     so D must be the sum of that same row's own P dP, as the reference's
//     softmax gradient takes it from its probabilities: in bf16, D = sum_k P
//     dP over the row's live keys, from the P and dP the backward forms (a D
//     pass: the dQ sweep without its product, before dK/dV and dQ).  D =
//     rowsum(dO * O) equals it only in exact arithmetic: the bf16 output is
//     built from weights rounded to bf16, and on a three-key row the dq it
//     gives is twice the plain version's worst row from exact.  A sequence
//     chunk's row sees all its live keys (K and V are the gathered whole),
//     so its D is the row's own, as at Tq == Tk.  A ring chunk's row sees
//     only the visiting chunk's keys, so the ring
//     (cordum_tpu_torch/ops/ring_attention.py) takes the two halves apart:
//     "D only" (dense_attention_d) runs the D pass alone over the chunk
//     under the row's lse over the whole ring, a partial the ring sums
//     over its chunks, and "D given" (dense_attention_bwd_given) runs
//     dK/dV and dQ with the caller's D.  fp32 keeps
//     D = rowsum(dO * O) (a pre-pass, one warp a row), where O carries the
//     fp32 weights (in the ring, the merged output's; "D only" runs it
//     alone).
//
// Bound: at the training shapes (T 256 .. 2048, head_dim 64 / 128) the
// operations (4 * head_dim per live (query, key) pair forward, 10 * head_dim
// backward, counting QK^T once) outweigh the bytes of q, k, v, out and the
// gradients, so the kernels are bound by the tensor cores in bf16 and by the
// CUDA cores in fp32.  Key tiles past a block's largest position (wholly
// above the causal diagonal) are neither loaded nor multiplied, which halves
// the work; only tiles that cross a row's position (or Tk, for keys) are
// masked, and rows past Tq are neither stored nor counted.  The
// backward recomputes P in both of its passes (14 * head_dim a pair; bf16's
// D pass forms S and dP once more, 18 * head_dim).  In bf16 two more costs
// rival the products: the softmax's exponentials (the special-function units
// run at a few percent of the tensor cores' rate), and the K/V tiles each
// 128-row block reads again from L2.
//
// Design.  The first design (four warps of mma.sync, 64-row blocks, cp.async,
// fp32 emulating the bf16 fragments from shared memory) left the tensor cores
// mostly idle in bf16 and was bound by shared-memory loads in fp32.
//   * bf16, head_dim 64 and 128: warp-specialised blocks of three
//     warpgroups.  A producer warpgroup (its registers handed to the others
//     with setmaxnreg) keeps rings of tiles in flight with TMA, completion
//     counted on mbarriers; two consumer warpgroups each own 64 rows and run
//     every product with wgmma (bf16 in, fp32 accumulate) on operands in
//     shared memory, 128-byte swizzled by the TMA boxes (64 columns: a
//     head_dim-128 row is two boxes) and read by descriptors that match them.
//     The causal span of a block is read from `positions` before the warps
//     split into their roles, so any positions work.  Each consumer keeps one
//     tile's second product running while it forms the next tile's weights
//     (FlashAttention-3's overlap within a warpgroup), and every elementwise
//     step rounds scores to bf16 in pairs (one packing conversion; a
//     conversion of one value is a slow instruction, and with it the
//     softmax, not the products, set the forward's pace).
//     - forward: a block per (batch, g query heads of one KV head, 128 / g
//       query positions of Tq); a consumer's 64 rows are (position, head) pairs, g heads
//       a position (g the largest power of two dividing H / KVH, at most 16:
//       rows (t, head) of one KV head are adjacent in [B, T, H, hd]), so
//       each K/V tile feeds the group's heads at once.  S = Q K^T with wgmma
//       m64n128k16 (B the K tile, K-major as it lies), the softmax in
//       registers, P rounded to bf16 from the accumulator into the A
//       registers of O += P V (B the V tile, transposed by the instruction).
//       128-key tiles; K and V in rings of their own (2 and 4 stages): a K
//       tile is free as soon as QK^T has read it, a V tile a step later.
//     - dK/dV: a block per (batch, KV head, 128 keys of Tk), 64 keys a consumer,
//       K and V resident in shared memory.  The producer streams the 32-row
//       Q and dO tiles of every query head of the group that reach those
//       keys (marked per tile from `positions`), with their positions,
//       lse and D (3 stages).  S^T = K Q^T and dP^T = V dO^T (m64n32k16), so
//       that P^T and dS^T come out as the A registers of dV += P^T dO and
//       dK += dS^T Q; P^T is formed while dP^T runs.  dK and dV are summed
//       over the group's query heads in registers: no atomics, and two calls
//       give the same bits.  Both consumers compute every item, also one
//       that reaches none of a consumer's keys (its weights are exactly 0).
//       32-row tiles: the four accumulators of 64-row ones left no registers
//       for the overlap at head_dim 128.
//     - dQ: its own pass (deterministic), blocks as the forward's, over
//       64-key tiles (3 stages): S = Q K^T, dP = dO V^T, dQ += dS K.  Rows at
//       a negative position send no gradient into q, so its span is the
//       largest non-negative position.
//     ptxas serialises every wgmma of a kernel (a wait after each) when it
//     cannot prove the warpgroup convergent around a product, or when a
//     register of a running product (accumulator or A) is written or read
//     inside its stage.  So: the mbarrier wait loop stays inside its asm;
//     branch conditions are broadcast from lane 0 (`uniform`); each product
//     has a wgmma.fence of its own, with its operands pinned before it and
//     after its wait (`keep`); A registers are written only when no product
//     runs; first and last tiles are peeled so the loop body holds no branch
//     around a product.  The build log (-Xptxas -v) names the cause when it
//     does this ("Potential Performance Loss").
//   * bf16, head_dim 16 (llama-tiny): a 32-byte row is narrower than the
//     128-byte swizzle atom the tiling above is built on, so it keeps the
//     first design: four warps of mma.sync m16n8k16 a block, 64 rows,
//     operands by ldmatrix from padded rows with cp.async.
//   * fp32 (every head_dim): full fp32 on CUDA cores (TF32 would break
//     parity), blocks of 256 threads over 64 rows with register tiles: a
//     thread owns 4 rows x 2 to 4 columns of a score tile, strided by 16
//     columns so that a warp's reads of padded shared rows hit distinct
//     banks, and 4 rows x head_dim / 16 columns of its output; a score or
//     weight tile is one float4 load for 4 rows, so each shared-memory load
//     feeds 8 to 16 FMAs.  The weights pass to the second product through a
//     transposed tile in shared memory.  Forward, dK/dV and dQ as above
//     (dK/dV summed over the group in registers).
//   * D: in bf16 the dQ kernels with their product compiled out (kD), over
//     the same blocks and key tiles, a row's sum reduced across its quad;
//     in fp32 a pre-pass, one warp per (batch, position, head) row.
//
// Layouts: q [B, Tq, H, hd], k and v [B, Tk, KVH, hd], contiguous; positions
// [B, Tq] int32; out, dO and dq [B, Tq, H, hd]; dk, dv [B, Tk, KVH, hd]; lse
// and D [B, H, Tq] fp32.  head_dim 16, 64 or 128; any Tq, Tk >= 1.  The TMA
// maps are encoded on the host at every call, Q, out and dO over Tq rows, K
// and V over Tk (cuTensorMapEncodeTiled found through the CUDA runtime: no
// libcuda link).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;

// a padded shared-memory row: head_dim elements plus 16 bytes, so ldmatrix
// and float4 reads of 8 consecutive rows fall in distinct banks
template <typename T, int HD>
constexpr int kSrow = HD + 16 / (int)sizeof(T);

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
__device__ __forceinline__ float round_bf16(float x) {  // x rounded to bf16, as fp32
  return __bfloat162float(__float2bfloat16(x));
}
// a and b rounded to bf16, as fp32: one packing conversion for the pair and
// two integer ops (a conversion of one value is a slow instruction)
__device__ __forceinline__ void round2_bf16(float& a, float& b) {
  const uint32_t p = pack_bf16(a, b);  // a in the low half
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xFFFF0000u);
}
// two adjacent bf16 outputs of one row
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Rows g0 .. g0 + n of one head of a [.., T, heads, HD] tensor into padded
// shared rows with cp.async, by NT threads; rows at or past T are zero.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long base,
                                          long long row_stride, int g0, int n, int T_len) {
  constexpr int kChunk = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = HD / kChunk;
  constexpr int S = kSrow<T, HD>;
  for (int c = threadIdx.x; c < n * kChunks; c += NT) {
    const int r = c / kChunks, d = (c % kChunks) * kChunk;
    T* p = dst + r * S + d;
    if (g0 + r < T_len) {
      cp_async16(p, src + base + (long long)(g0 + r) * row_stride + d);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The positions of query rows q0 .. q0 + n into s_pos (0 past Tq) and the
// number of keys they reach: Tk when a row has no live key (it attends to
// all), else the largest position + 1, at most Tk.  NT threads; ends with a
// barrier.
template <int NT>
__device__ __forceinline__ int key_span(const int* pos_b, int q0, int n, int Tq, int Tk,
                                        int* s_pos, int* s_span) {
  if (threadIdx.x == 0) {
    s_span[0] = -1;
    s_span[1] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += NT) {
    const bool ok = q0 + r < Tq;
    const int p = ok ? pos_b[q0 + r] : 0;
    s_pos[r] = p;
    if (ok) {
      atomicMax(&s_span[0], p);
      if (p < 0) s_span[1] = 1;
    }
  }
  __syncthreads();
  return s_span[1] ? Tk : min(Tk, s_span[0] + 1);
}

// Which of the n_qt query tiles of `tile` rows (of Tq) reach keys from k0 on
// (a row with no live key reaches all), a bit each in `need`; by NT threads
// of warps, ends with a barrier.
template <int NT>
__device__ __forceinline__ void mark_tiles(unsigned* need, const int* pos_b, int n_qt, int tile,
                                           int k0, int Tq) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int w = threadIdx.x; w < (n_qt + 31) / 32; w += NT) need[w] = 0u;
  __syncthreads();
  for (int t = warp; t < n_qt; t += NT / kWarp) {
    bool reach = false;
    for (int i = lane; i < tile; i += kWarp) {
      const int r = t * tile + i;
      const int p = r < Tq ? pos_b[r] : 0;
      reach |= r < Tq && (p < 0 || p >= k0);
    }
    if (__any_sync(~0u, reach) && lane == 0) atomicOr(&need[t / 32], 1u << (t % 32));
  }
  __syncthreads();
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above 48 KB only after an opt-in
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ===========================================================================
// bf16, head_dim 16: the first design's mma.sync kernels
// ===========================================================================

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * kWarp;
constexpr int kRows = 16 * kMmaWarps;  // query rows (forward, dQ) or keys (dK/dV) a block owns
constexpr int kFwdKeys = 64;           // keys a forward step takes
constexpr int kBwdTile = 32;           // query rows a dK/dV step takes; keys a dQ step takes

// acc[n][e] += A[r] . B[n*8 + c] over HD, in the m16n8 accumulator layout
// (r = lane/4 for e 0, 1 and lane/4 + 8 for e 2, 3; c = (lane%4)*2 + (e&1)):
// 16 rows of A against 8*NT rows of B, both padded shared rows.
template <int NT, int HD>
__device__ __forceinline__ void warp_nt(float (&acc)[NT][4], const bf16* A, const bf16* B,
                                        int lane) {
  constexpr int S = kSrow<bf16, HD>;
  static_assert(NT % 2 == 0, "n tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + ((lane % 8) + ((lane / 8) % 2) * 8) * S + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (lane % 8) + (lane / 16) * 8) * S + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n][e] += sum_k P[r][k] * B[k][n*8 + c]: P is the warp's 16 x 8*KT
// block in the accumulator layout (p[kt][e]), rounded to bf16 and repacked
// into A fragments (the C layout of two n8 tiles is the A layout of one k16
// step); B the first 8*KT padded shared rows of a [k][HD] tile.
template <int KT, int HD>
__device__ __forceinline__ void warp_nn(float (&acc)[HD / 8][4], const float (&p)[KT][4],
                                        const bf16* B, int lane) {
  constexpr int S = kSrow<bf16, HD>;
  static_assert(KT % 2 == 0, "k tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * S + dp * 16 +
                       (lane / 16) * 8);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
constexpr size_t mma_fwd_smem() {
  return sizeof(bf16) * (kRows + 4 * kFwdKeys) * kSrow<bf16, HD>;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dense_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ pos, bf16* __restrict__ out,
               float* __restrict__ lse, int Tq, int Tk, int H, int KVH, float scale) {
  constexpr int S = kSrow<bf16, HD>;
  constexpr int NT = kFwdKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][S]
  bf16* ks = qs + kRows * S;                      // [2][64][S]
  bf16* vs = ks + 2 * kFwdKeys * S;               // [2][64][S]
  __shared__ int s_pos[kRows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest rows first
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;

  load_rows<bf16, HD, kMmaThreads>(qs, q, qbase, qstride, q0, kRows, Tq);
  const int kv_end =
      key_span<kMmaThreads>(pos + (long long)b * Tq, q0, kRows, Tq, Tk, s_pos, s_span);
  const int n_tiles = (kv_end + kFwdKeys - 1) / kFwdKeys;
  load_rows<bf16, HD, kMmaThreads>(ks, k, kbase, kstride, 0, kFwdKeys, Tk);
  load_rows<bf16, HD, kMmaThreads>(vs, v, kbase, kstride, 0, kFwdKeys, Tk);
  cp_async_commit();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int ra = warp * 16 + lane / 4;  // this lane's rows: ra and ra + 8
  const int prow[2] = {s_pos[ra], s_pos[ra + 8]};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<bf16, HD, kMmaThreads>(ks + (buf ^ 1) * kFwdKeys * S, k, kbase, kstride,
                                       (j + 1) * kFwdKeys, kFwdKeys, Tk);
      load_rows<bf16, HD, kMmaThreads>(vs + (buf ^ 1) * kFwdKeys * S, v, kbase, kstride,
                                       (j + 1) * kFwdKeys, kFwdKeys, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_nt<NT, HD>(s, qs + warp * 16 * S, ks + buf * kFwdKeys * S, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kFwdKeys + n * 8 + (lane % 4) * 2 + (e & 1);
        const int p = prow[e / 2];
        float x;
        if (key >= Tk) x = -INFINITY;  // not a key
        else if (p < 0) x = 0.f;          // no live key: uniform, as the reference
        else x = key <= p ? round_bf16(s[n][e]) * scale : -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = __expf(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mu[e / 2]);
        l[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    warp_nn<NT, HD>(acc, s, vs + buf * kFwdKeys * S, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(~0u, l[i], 1);
    l[i] += __shfl_xor_sync(~0u, l[i], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + ra + 8 * half;
    if (row >= Tq) continue;
    const float inv = 1.f / l[half];
    const long long at = qbase + (long long)row * qstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(out + at + n * 8, acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    if (lane % 4 == 0) lse[((long long)b * H + h) * Tq + row] = m[half] + logf(l[half]);
  }
}

template <int HD>
constexpr size_t mma_dkv_smem_fixed() {
  return sizeof(bf16) * (2 * kRows + 4 * kBwdTile) * kSrow<bf16, HD> +
         sizeof(float) * 2 * 2 * kBwdTile + sizeof(int) * 2 * kBwdTile;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dense_attention_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ pos,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv,
               int Tq, int Tk, int H, int KVH, float scale) {
  constexpr int S = kSrow<bf16, HD>;
  constexpr int QT = kBwdTile;
  constexpr int NT = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][S]: this block's keys
  bf16* vs = ks + kRows * S;                      // [64][S]
  bf16* qs = vs + kRows * S;                      // [2][32][S]
  bf16* dos = qs + 2 * QT * S;                    // [2][32][S]
  float* rowf = reinterpret_cast<float*>(dos + 2 * QT * S);        // [2][lse 32, D 32]
  int* rowpos = reinterpret_cast<int*>(rowf + 2 * 2 * QT);         // [2][32]
  unsigned* need = reinterpret_cast<unsigned*>(rowpos + 2 * QT);  // a bit per query tile

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;  // the keys most queries reach first
  const int rep = H / KVH;
  const int n_qt = (Tq + QT - 1) / QT;
  const int total = rep * n_qt;  // (query head of the group, query tile) items
  const int* pos_b = pos + (long long)b * Tq;
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  mark_tiles<kMmaThreads>(need, pos_b, n_qt, QT, k0, Tq);
  auto next_item = [&](int item) {
    for (++item; item < total; ++item) {
      const int t = item % n_qt;
      if (need[t / 32] >> (t % 32) & 1u) break;
    }
    return item;
  };
  auto stage = [&](int item, int buf) {
    const int h = kvh * rep + item / n_qt, r0 = (item % n_qt) * QT;
    const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
    load_rows<bf16, HD, kMmaThreads>(qs + buf * QT * S, q, qbase, qstride, r0, QT, Tq);
    load_rows<bf16, HD, kMmaThreads>(dos + buf * QT * S, dout, qbase, qstride, r0, QT, Tq);
    for (int i = threadIdx.x; i < QT; i += kMmaThreads) {
      const int r = r0 + i;
      const bool ok = r < Tq;
      const long long at = ((long long)b * H + h) * Tq + r;
      rowpos[buf * QT + i] = ok ? pos_b[r] : 0;
      rowf[buf * 2 * QT + i] = ok ? lse[at] : 0.f;
      rowf[buf * 2 * QT + QT + i] = ok ? D[at] : 0.f;
    }
  };

  load_rows<bf16, HD, kMmaThreads>(ks, k, kbase, kstride, k0, kRows, Tk);
  load_rows<bf16, HD, kMmaThreads>(vs, v, kbase, kstride, k0, kRows, Tk);
  int item = next_item(-1);
  if (item < total) stage(item, 0);
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + lane / 4, k0 + warp * 16 + lane / 4 + 8};
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int buf = 0;
  while (item < total) {
    const int nxt = next_item(item);
    if (nxt < total) {
      stage(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (item % n_qt) * QT;
    const bf16* qb = qs + buf * QT * S;
    const bf16* dob = dos + buf * QT * S;
    const float* lse_s = rowf + buf * 2 * QT;
    const float* d_s = lse_s + QT;
    const int* pos_s = rowpos + buf * QT;
    float st[NT][4], dpt[NT][4];  // S^T and dP^T: this warp's 16 keys x 32 queries
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    warp_nt<NT, HD>(st, ks + warp * 16 * S, qb, lane);
    warp_nt<NT, HD>(dpt, vs + warp * 16 * S, dob, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + (lane % 4) * 2 + (e & 1);
        const int kj = key[e / 2];
        const int p = pos_s[qi];
        const bool valid = r0 + qi < Tq && kj < Tk;
        const bool live = valid && p >= 0 && kj <= p;
        const float x = live ? round_bf16(st[n][e]) * scale : 0.f;
        const float prob = (live || (valid && p < 0)) ? __expf(x - lse_s[qi]) : 0.f;
        st[n][e] = prob;
        dpt[n][e] = live ? prob * (dpt[n][e] - d_s[qi]) * scale : 0.f;
      }
    warp_nn<NT, HD>(dv_acc, st, dob, lane);   // dV += P^T dO
    warp_nn<NT, HD>(dk_acc, dpt, qb, lane);   // dK += dS^T Q
    __syncthreads();
    item = nxt;
    buf ^= 1;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= Tk) continue;
    const long long at = kbase + (long long)key[half] * kstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store2(dk + at + n * 8, dk_acc[n][2 * half], dk_acc[n][2 * half + 1]);
      store2(dv + at + n * 8, dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <int HD>
constexpr size_t mma_dq_smem() {
  return sizeof(bf16) * (2 * kRows + 4 * kBwdTile) * kSrow<bf16, HD>;
}

// kD: the D pass — the same sweep without the dQ product, D = sum_k P dP per
// row written into D (the dQ pass then reads it)
template <int HD, bool kD>
__global__ void __launch_bounds__(kMmaThreads)
dense_attention_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ pos,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ D, bf16* __restrict__ dq, int Tq, int Tk, int H, int KVH,
              float scale) {
  constexpr int S = kSrow<bf16, HD>;
  constexpr int KT = kBwdTile;
  constexpr int NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][S]
  bf16* dos = qs + kRows * S;                     // [64][S]
  bf16* ks = dos + kRows * S;                     // [2][32][S]
  bf16* vs = ks + 2 * KT * S;                     // [2][32][S]
  __shared__ int s_pos[kRows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;

  load_rows<bf16, HD, kMmaThreads>(qs, q, qbase, qstride, q0, kRows, Tq);
  load_rows<bf16, HD, kMmaThreads>(dos, dout, qbase, qstride, q0, kRows, Tq);
  const int kv_end =
      key_span<kMmaThreads>(pos + (long long)b * Tq, q0, kRows, Tq, Tk, s_pos, s_span);
  const int n_tiles = (kv_end + KT - 1) / KT;
  load_rows<bf16, HD, kMmaThreads>(ks, k, kbase, kstride, 0, KT, Tk);
  load_rows<bf16, HD, kMmaThreads>(vs, v, kbase, kstride, 0, KT, Tk);
  cp_async_commit();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int ra = warp * 16 + lane / 4;
  int prow[2];
  float lrow[2], drow[2];
  bool vrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ra + 8 * i;
    vrow[i] = row < Tq;
    prow[i] = s_pos[ra + 8 * i];
    const long long at = ((long long)b * H + h) * Tq + row;
    lrow[i] = vrow[i] ? lse[at] : 0.f;
    drow[i] = vrow[i] && !kD ? D[at] : 0.f;
  }
  float dsum[2] = {0.f, 0.f};  // kD: sum_k P dP of this lane's keys
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<bf16, HD, kMmaThreads>(ks + (buf ^ 1) * KT * S, k, kbase, kstride,
                                       (j + 1) * KT, KT, Tk);
      load_rows<bf16, HD, kMmaThreads>(vs + (buf ^ 1) * KT * S, v, kbase, kstride,
                                       (j + 1) * KT, KT, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_nt<NT, HD>(s, qs + warp * 16 * S, ks + buf * KT * S, lane);
    warp_nt<NT, HD>(dp, dos + warp * 16 * S, vs + buf * KT * S, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * KT + n * 8 + (lane % 4) * 2 + (e & 1);
        const int i = e / 2;
        const bool live = vrow[i] && kj < Tk && prow[i] >= 0 && kj <= prow[i];
        const float prob = live ? __expf(round_bf16(s[n][e]) * scale - lrow[i]) : 0.f;
        if constexpr (kD) dsum[i] = fmaf(prob, dp[n][e], dsum[i]);
        s[n][e] = live ? prob * (dp[n][e] - drow[i]) * scale : 0.f;
      }
    if constexpr (!kD) warp_nn<NT, HD>(acc, s, ks + buf * KT * S, lane);  // dQ += dS K
    __syncthreads();
  }
  if constexpr (kD) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dsum[i] += __shfl_xor_sync(~0u, dsum[i], 1);
      dsum[i] += __shfl_xor_sync(~0u, dsum[i], 2);
      const int row = q0 + ra + 8 * i;
      if (vrow[i] && lane % 4 == 0) D[((long long)b * H + h) * Tq + row] = dsum[i];
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!vrow[half]) continue;
    bf16* dst = dq + qbase + (long long)(q0 + ra + 8 * half) * qstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) store2(dst + n * 8, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ===========================================================================
// fp32: register tiles on CUDA cores
// ===========================================================================

constexpr int kF32Threads = 256;  // 16 x 16 threads: tr = tid / 16, tc = tid % 16
constexpr int kF32Rows = 64;      // query rows (forward, dQ) or keys (dK/dV) a block owns
constexpr int kWT = kF32Rows + 4;  // row stride of a transposed weight tile [column][row]
// keys a forward step takes, keys a dQ step takes, query rows a dK/dV step
// takes: as wide as shared memory allows (a score tile of 64 x 16 NJ is
// NJ columns a thread; wider tiles feed more FMAs a load)
template <int HD>
constexpr int kF32FwdKeys = HD == 128 ? 32 : 64;
template <int HD>
constexpr int kF32DqKeys = 64;
template <int HD>
constexpr int kF32DkvRows = HD == 128 ? 48 : 64;

// acc[i][j] += A[i] . B[16 j] over HD: A this thread's first of 4
// consecutive padded rows, B its first of NJ padded rows 16 apart (16
// threads of a warp read 16 consecutive rows: distinct banks)
template <int HD, int NJ>
__device__ __forceinline__ void f32_nt(float (&acc)[4][NJ], const float* A, const float* B) {
  constexpr int S = kSrow<float, HD>;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], c[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * S + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[j] = *reinterpret_cast<const float4*>(B + 16 * j * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = fmaf(a[i].w, c[j].w,
                         fmaf(a[i].z, c[j].z, fmaf(a[i].y, c[j].y, fmaf(a[i].x, c[j].x, acc[i][j]))));
  }
}

// the head_dim columns a thread owns: HD >= 64, float4 chunks at 64 jj + tc*4;
// HD 16, column tc
template <int HD>
__device__ __forceinline__ int f32_col(int tc, int e) {
  if constexpr (HD >= 64) {
    return (e / 4) * 64 + tc * 4 + e % 4;
  } else {
    return tc;
  }
}

// acc[i][e] += sum_k W[k][i] * B[k][f32_col(e)] over K: W this thread's
// first row in a transposed weight tile ([K][kWT]; 4 rows a float4), B a
// padded [K][HD] tile offset to f32_col(tc, 0)
template <int HD, int K>
__device__ __forceinline__ void f32_nn(float (&acc)[4][HD / 16], const float* W, const float* B) {
  constexpr int S = kSrow<float, HD>;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 w4 = *reinterpret_cast<const float4*>(W + k * kWT);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    if constexpr (HD >= 64) {
#pragma unroll
      for (int jj = 0; jj < HD / 64; ++jj) {
        const float4 b4 = *reinterpret_cast<const float4*>(B + k * S + jj * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(w[i], b4.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(w[i], b4.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(w[i], b4.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(w[i], b4.w, acc[i][4 * jj + 3]);
        }
      }
    } else {
      const float bv = B[k * S];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = fmaf(w[i], bv, acc[i][0]);
    }
  }
}

// a thread's 4 x NJ weights into the transposed tile: column tc + 16 j, rows tr*4 ..
template <int NJ>
__device__ __forceinline__ void f32_put(float* wt, const float (&w)[4][NJ], int tr, int tc) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    *reinterpret_cast<float4*>(wt + (tc + 16 * j) * kWT + tr * 4) =
        make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
}

template <int HD>
__device__ __forceinline__ void f32_store_rows(float* dst, long long stride, const float (&acc)[4][HD / 16],
                                               int r0, int T_len, int tc, const float* inv) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= T_len) continue;
    float* row = dst + (long long)(r0 + i) * stride;
    const float f = inv == nullptr ? 1.f : inv[i];
    if constexpr (HD >= 64) {
#pragma unroll
      for (int jj = 0; jj < HD / 64; ++jj)
        *reinterpret_cast<float4*>(row + jj * 64 + tc * 4) =
            make_float4(acc[i][4 * jj] * f, acc[i][4 * jj + 1] * f, acc[i][4 * jj + 2] * f,
                        acc[i][4 * jj + 3] * f);
    } else {
      row[tc] = acc[i][0] * f;
    }
  }
}

template <int HD>
constexpr size_t f32_fwd_smem() {
  return sizeof(float) * ((kF32Rows + 4 * kF32FwdKeys<HD>) * kSrow<float, HD> + kF32FwdKeys<HD> * kWT);
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
dense_attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ pos,
               float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H, int KVH,
               float scale) {
  constexpr int S = kSrow<float, HD>;
  constexpr int KT = kF32FwdKeys<HD>, NJ = KT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [64][S]
  float* ks = qs + kF32Rows * S;                    // [2][KT][S]
  float* vs = ks + 2 * KT * S;                      // [2][KT][S]
  float* wt = vs + 2 * KT * S;                      // [KT][kWT]: the weights, transposed
  __shared__ int s_pos[kF32Rows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;  // the longest rows first
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;

  load_rows<float, HD, kF32Threads>(qs, q, qbase, qstride, q0, kF32Rows, Tq);
  const int kv_end =
      key_span<kF32Threads>(pos + (long long)b * Tq, q0, kF32Rows, Tq, Tk, s_pos, s_span);
  const int n_tiles = (kv_end + KT - 1) / KT;
  load_rows<float, HD, kF32Threads>(ks, k, kbase, kstride, 0, KT, Tk);
  load_rows<float, HD, kF32Threads>(vs, v, kbase, kstride, 0, KT, Tk);
  cp_async_commit();

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  int prow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) prow[i] = s_pos[tr * 4 + i];
  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<float, HD, kF32Threads>(ks + (buf ^ 1) * KT * S, k, kbase, kstride,
                                        (j + 1) * KT, KT, Tk);
      load_rows<float, HD, kF32Threads>(vs + (buf ^ 1) * KT * S, v, kbase, kstride,
                                        (j + 1) * KT, KT, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[i][jj] = 0.f;
    f32_nt<HD, NJ>(s, qs + tr * 4 * S, ks + buf * KT * S + tc * S);
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int key = j * KT + tc + 16 * jj;
        const int p = prow[i];
        float x;
        if (key >= Tk) x = -INFINITY;  // not a key
        else if (p < 0) x = 0.f;          // no live key: uniform, as the reference
        else x = key <= p ? s[i][jj] * scale : -INFINITY;
        s[i][jj] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], o));
      const float mn = fmaxf(m[i], mx[i]);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[i] - mu);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        s[i][jj] = expf(s[i][jj] - mu);
        l[i] += s[i][jj];
      }
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) acc[i][e] *= alpha;
    }
    f32_put<NJ>(wt, s, tr, tc);
    __syncthreads();
    f32_nn<HD, KT>(acc, wt + tr * 4, vs + buf * KT * S + f32_col<HD>(tc, 0));
    __syncthreads();  // every thread is done with this buffer and the weights
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) l[i] += __shfl_xor_sync(~0u, l[i], o);
    inv[i] = 1.f / l[i];
    const int row = q0 + tr * 4 + i;
    if (tc == 0 && row < Tq) lse[((long long)b * H + h) * Tq + row] = m[i] + logf(l[i]);
  }
  f32_store_rows<HD>(out + qbase, qstride, acc, q0 + tr * 4, Tq, tc, inv);
}

template <int HD>
constexpr size_t f32_dq_smem() {
  return sizeof(float) *
         ((2 * kF32Rows + 4 * kF32DqKeys<HD>) * kSrow<float, HD> + kF32DqKeys<HD> * kWT);
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)  // shared memory allows one block an SM
dense_attention_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ pos,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ D, float* __restrict__ dq, int Tq, int Tk, int H, int KVH,
              float scale) {
  constexpr int S = kSrow<float, HD>;
  constexpr int KT = kF32DqKeys<HD>, NJ = KT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [64][S]
  float* dos = qs + kF32Rows * S;                   // [64][S]
  float* ks = dos + kF32Rows * S;                   // [2][KT][S]
  float* vs = ks + 2 * KT * S;                      // [2][KT][S]
  float* wt = vs + 2 * KT * S;                      // [KT][kWT]: dS, transposed
  __shared__ int s_pos[kF32Rows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;

  load_rows<float, HD, kF32Threads>(qs, q, qbase, qstride, q0, kF32Rows, Tq);
  load_rows<float, HD, kF32Threads>(dos, dout, qbase, qstride, q0, kF32Rows, Tq);
  const int kv_end =
      key_span<kF32Threads>(pos + (long long)b * Tq, q0, kF32Rows, Tq, Tk, s_pos, s_span);
  const int n_tiles = (kv_end + KT - 1) / KT;
  load_rows<float, HD, kF32Threads>(ks, k, kbase, kstride, 0, KT, Tk);
  load_rows<float, HD, kF32Threads>(vs, v, kbase, kstride, 0, KT, Tk);
  cp_async_commit();

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  int prow[4];
  float lrow[4], drow[4], acc[4][HD / 16];
  bool vrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    vrow[i] = row < Tq;
    prow[i] = s_pos[tr * 4 + i];
    const long long at = ((long long)b * H + h) * Tq + row;
    lrow[i] = vrow[i] ? lse[at] : 0.f;
    drow[i] = vrow[i] ? D[at] : 0.f;
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<float, HD, kF32Threads>(ks + (buf ^ 1) * KT * S, k, kbase, kstride,
                                        (j + 1) * KT, KT, Tk);
      load_rows<float, HD, kF32Threads>(vs + (buf ^ 1) * KT * S, v, kbase, kstride,
                                        (j + 1) * KT, KT, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    f32_nt<HD, NJ>(s, qs + tr * 4 * S, ks + buf * KT * S + tc * S);
    f32_nt<HD, NJ>(dp, dos + tr * 4 * S, vs + buf * KT * S + tc * S);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int kj = j * KT + tc + 16 * jj;
        const bool live = vrow[i] && kj < Tk && prow[i] >= 0 && kj <= prow[i];
        const float prob = live ? expf(s[i][jj] * scale - lrow[i]) : 0.f;
        s[i][jj] = live ? prob * (dp[i][jj] - drow[i]) * scale : 0.f;
      }
    f32_put<NJ>(wt, s, tr, tc);
    __syncthreads();
    f32_nn<HD, KT>(acc, wt + tr * 4, ks + buf * KT * S + f32_col<HD>(tc, 0));  // dQ += dS K
    __syncthreads();
  }
  f32_store_rows<HD>(dq + qbase, qstride, acc, q0 + tr * 4, Tq, tc, nullptr);
}

template <int HD>
constexpr size_t f32_dkv_smem_fixed() {
  constexpr int QT = kF32DkvRows<HD>;
  return sizeof(float) * ((2 * kF32Rows + 4 * QT) * kSrow<float, HD> + 2 * QT * kWT + 2 * 2 * QT) +
         sizeof(int) * 2 * QT;
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)  // shared memory allows one block an SM
dense_attention_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ pos,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, float* __restrict__ dk, float* __restrict__ dv,
               int Tq, int Tk, int H, int KVH, float scale) {
  constexpr int S = kSrow<float, HD>;
  constexpr int QT = kF32DkvRows<HD>, NJ = QT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [64][S]: this block's keys
  float* vs = ks + kF32Rows * S;                    // [64][S]
  float* qs = vs + kF32Rows * S;                    // [2][QT][S]
  float* dos = qs + 2 * QT * S;                     // [2][QT][S]
  float* pt = dos + 2 * QT * S;                     // [QT][kWT]: P^T, transposed
  float* dst = pt + QT * kWT;                       // [QT][kWT]: dS^T, transposed
  float* rowf = dst + QT * kWT;                     // [2][lse QT, D QT]
  int* rowpos = reinterpret_cast<int*>(rowf + 2 * 2 * QT);         // [2][QT]
  unsigned* need = reinterpret_cast<unsigned*>(rowpos + 2 * QT);  // a bit per query tile

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kF32Rows;  // the keys most queries reach first
  const int rep = H / KVH;
  const int n_qt = (Tq + QT - 1) / QT;
  const int total = rep * n_qt;
  const int* pos_b = pos + (long long)b * Tq;
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;

  mark_tiles<kF32Threads>(need, pos_b, n_qt, QT, k0, Tq);
  auto next_item = [&](int item) {
    for (++item; item < total; ++item) {
      const int t = item % n_qt;
      if (need[t / 32] >> (t % 32) & 1u) break;
    }
    return item;
  };
  auto stage = [&](int item, int buf) {
    const int h = kvh * rep + item / n_qt, r0 = (item % n_qt) * QT;
    const long long qbase = (long long)b * Tq * qstride + (long long)h * HD;
    load_rows<float, HD, kF32Threads>(qs + buf * QT * S, q, qbase, qstride, r0, QT, Tq);
    load_rows<float, HD, kF32Threads>(dos + buf * QT * S, dout, qbase, qstride, r0, QT, Tq);
    for (int i = threadIdx.x; i < QT; i += kF32Threads) {
      const int r = r0 + i;
      const bool ok = r < Tq;
      const long long at = ((long long)b * H + h) * Tq + r;
      rowpos[buf * QT + i] = ok ? pos_b[r] : 0;
      rowf[buf * 2 * QT + i] = ok ? lse[at] : 0.f;
      rowf[buf * 2 * QT + QT + i] = ok ? D[at] : 0.f;
    }
  };

  load_rows<float, HD, kF32Threads>(ks, k, kbase, kstride, k0, kF32Rows, Tk);
  load_rows<float, HD, kF32Threads>(vs, v, kbase, kstride, k0, kF32Rows, Tk);
  int item = next_item(-1);
  if (item < total) stage(item, 0);
  cp_async_commit();

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  int buf = 0;
  while (item < total) {
    const int nxt = next_item(item);
    if (nxt < total) {
      stage(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (item % n_qt) * QT;
    const float* qb = qs + buf * QT * S;
    const float* dob = dos + buf * QT * S;
    const float* lse_s = rowf + buf * 2 * QT;
    const float* d_s = lse_s + QT;
    const int* pos_s = rowpos + buf * QT;
    float st[4][NJ], dpt[4][NJ];  // S^T and dP^T: keys tr*4 + i x queries tc + 16 jj
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) st[i][jj] = dpt[i][jj] = 0.f;
    f32_nt<HD, NJ>(st, ks + tr * 4 * S, qb + tc * S);
    f32_nt<HD, NJ>(dpt, vs + tr * 4 * S, dob + tc * S);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int qi = tc + 16 * jj;
        const int kj = k0 + tr * 4 + i;
        const int p = pos_s[qi];
        const bool valid = r0 + qi < Tq && kj < Tk;
        const bool live = valid && p >= 0 && kj <= p;
        const float x = live ? st[i][jj] * scale : 0.f;
        const float prob = (live || (valid && p < 0)) ? expf(x - lse_s[qi]) : 0.f;
        st[i][jj] = prob;
        dpt[i][jj] = live ? prob * (dpt[i][jj] - d_s[qi]) * scale : 0.f;
      }
    f32_put<NJ>(pt, st, tr, tc);
    f32_put<NJ>(dst, dpt, tr, tc);
    __syncthreads();
    f32_nn<HD, QT>(dv_acc, pt + tr * 4, dob + f32_col<HD>(tc, 0));   // dV += P^T dO
    f32_nn<HD, QT>(dk_acc, dst + tr * 4, qb + f32_col<HD>(tc, 0));   // dK += dS^T Q
    __syncthreads();
    item = nxt;
    buf ^= 1;
  }
  f32_store_rows<HD>(dk + kbase, kstride, dk_acc, k0 + tr * 4, Tk, tc, nullptr);
  f32_store_rows<HD>(dv + kbase, kstride, dv_acc, k0 + tr * 4, Tk, tc, nullptr);
}

// ===========================================================================
// bf16, head_dim 64 and 128: wgmma and TMA
// ===========================================================================

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kHopperThreads = 3 * kWG;  // a producer warpgroup, two consumer warpgroups
constexpr int kBox = 64;                 // bf16 columns of a TMA box: one 128-byte swizzled row
constexpr int kBoxRowBytes = kBox * 2;
// registers a thread after setmaxnreg: the producer warpgroup gives what it
// does not need to the two consumers (128 x P + 256 x C <= 65536)
constexpr int kFwdProducerRegs = 24;  // the forward's consumers hold O, S and P at hd 128
constexpr int kFwdConsumerRegs = 240;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kDkvProducerRegs = 56;  // the dK/dV producer also stages lse, D and positions
constexpr int kDkvConsumerRegs = 224;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// the wait loop stays inside the asm: a loop the compiler sees would leave the
// products after it on a path it cannot prove convergent
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// v as every lane of the warp holds it: lane 0's, broadcast, so that the
// compiler knows a branch on it is warp-uniform
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(~0u, v, 0); }
// a box of a 4-D map (columns, heads, positions, batch) into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still running
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator (or of A
// registers) across the asynchronous products: called before wgmma.fence and
// after the wait.  Register work that the compiler sinks past the fence puts
// non-wgmma instructions inside the pipeline stage, and ptxas then serialises
// every wgmma (a wait after each one).
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A registers: a product still reading them keeps them live
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
constexpr float kLog2e = 1.4426950408889634f;
// 2^x, the approximation __expf is built on (exp(y) = ex2(y log2 e)): the
// scale and log2 e fold into one multiply-add of the rounded score
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// a consumer warpgroup is done with a stage: one arrival a warp (lane 0's,
// predicated rather than branched)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(lane)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled tile (the TMA
// boxes' layout): start address, leading and stride byte offsets.  K-major
// operands (the product's depth runs along the 128-byte rows): 8-row groups
// 1024 bytes apart (sbo), lbo unused; a k16 step inside a box starts 32
// bytes further.  MN-major operands (transposed by the instruction; depth
// runs down the rows): 8-row groups 1024 bytes apart (sbo), the next 64
// columns one box further (lbo); a k16 step starts 16 rows (2048 bytes)
// further.
__device__ __forceinline__ uint64_t sdesc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// a K-major operand's k16 step kk: box kk / 4 (of box_bytes), 32 bytes a step inside it
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int box_bytes, int kk) {
  return sdesc(reinterpret_cast<const unsigned char*>(tile) + (kk / 4) * box_bytes + (kk % 4) * 32,
               16, 1024);
}
// an MN-major operand's k16 step kk (rows 16 kk ..), boxes box_bytes apart
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int box_bytes, int kk) {
  return sdesc(reinterpret_cast<const unsigned char*>(tile) + kk * 16 * kBoxRowBytes, box_bytes,
               1024);
}

// wgmma m64nNk16, bf16 in, fp32 accumulate: d (+)= A B with A and B in shared
// memory (both K-major), or A in registers and B MN-major; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, acc);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, acc);
  } else {
    wgmma_ss_n128(d, a, b, acc);
  }
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, 1);
  } else {
    wgmma_rs_n128(d, a, b, 1);
  }
}

// The k16 steps of a 64 x N accumulator as A registers: rounded to bf16, the
// C layout of two n8 chunks is the A layout of one k16 step.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// acc += A B over NK rows of an MN-major tile (boxes of NK rows): the
// second product of each kernel, A the weights in registers; not committed
template <int HD, int NK>
__device__ __forceinline__ void issue_nn(float (&acc)[HD / 2], const uint32_t (&a)[NK / 16][4],
                                         const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs<HD>(acc, a[kk], mnmajor(tile, NK * kBoxRowBytes, kk));
}

template <typename T>
__device__ __forceinline__ T* align1024(unsigned char* p) {
  return reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The forward and dQ blocks: two consumers of 64 rows, each row a (position,
// head) pair with g heads a position.  Per consumer: the smallest position
// over its rows (any row with no live key makes it negative) and its key
// span (largest position + 1, or Tk when a row has no live key, at most Tk;
// in dQ rows at a negative position are left out: they send no gradient);
// rows at or past Tq are not rows.
struct RowStats {
  int lo[2], span[2];
};

__device__ __forceinline__ void row_stats(RowStats* st, const int* pos_b, int t0, int per_wg,
                                          int Tq, int Tk, bool dq) {
  if (threadIdx.x < 2) {
    st->lo[threadIdx.x] = INT_MAX;
    st->span[threadIdx.x] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < 2 * per_wg; r += kHopperThreads) {
    const int t = t0 + r;
    if (t >= Tq) continue;
    const int p = pos_b[t], c = r / per_wg;
    atomicMin(&st->lo[c], p);
    atomicMax(&st->span[c], p < 0 ? (dq ? 0 : Tk) : min(Tk, p + 1));
  }
  __syncthreads();
}

// The online softmax of one forward tile in registers: sc (the tile's fp32
// scores, keys key0 ..) in, its fp32 weights out (rounded to bf16 into the A
// registers of PV by the caller, once no product that reads A registers is
// running: a write to them inside a running stage serialises every wgmma);
// the running max m and sum l updated, alpha the factor for O.  Scores are rounded to bf16 unscaled (scale > 0 keeps the max); a
// tile whose every key is live for every row (`open`) is not masked.
template <int BN>
__device__ __forceinline__ void tile_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             int key0, int Tk, int lo, const int (&prow)[2],
                                             int lane, float scale, float sl2) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) round2_bf16(sc[2 * i], sc[2 * i + 1]);
  if (!(key0 + BN <= Tk && key0 + BN - 1 <= lo)) {  // a key of the tile is dead for a row
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + (lane % 4) * 2 + (e & 1);
        const int p = prow[e / 2];
        float& x = sc[4 * n + e];
        // past Tk: not a key; p < 0: no live key, uniform as the reference
        x = key >= Tk ? -INFINITY : p < 0 ? 0.f : key <= p ? x : -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float mu2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
    const float mn = fmaxf(m[i], mx[i] * scale);
    const float mu = mn == -INFINITY ? 0.f : mn;
    alpha[i] = __expf(m[i] - mu);
    mu2[i] = mu * kLog2e;
    m[i] = mn;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], sl2, -mu2[e / 2]));
      l[e / 2] += sc[4 * n + e];
    }
}

// dS of one dQ tile (keys key0 ..) from its scores sc and dP in registers,
// into sc (fp32; rounded into A registers by the caller, as the forward's
// weights).  lrow is lse * log2 e.
template <int BK>
__device__ __forceinline__ void tile_ds(float (&sc)[BK / 2], const float (&dp)[BK / 2],
                                        int key0, int Tk, int lo,
                                        const int (&prow)[2], const float (&lrow)[2],
                                        const float (&drow)[2], int lane, float scale, float sl2) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) round2_bf16(sc[2 * i], sc[2 * i + 1]);
  if (key0 + BK <= Tk && key0 + BK - 1 <= lo) {  // every key of the tile live for every row
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = ex2(fmaf(sc[i], sl2, -lrow[h])) * (dp[i] - drow[h]) * scale;
    }
  } else {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e, h = e / 2;
        const int kj = key0 + n * 8 + (lane % 4) * 2 + (e & 1);
        const bool live = kj < Tk && prow[h] >= 0 && kj <= prow[h];
        const float ds = ex2(fmaf(sc[i], sl2, -lrow[h])) * (dp[i] - drow[h]) * scale;
        sc[i] = live ? ds : 0.f;
      }
  }
}

template <int HD>
struct HopperFwd {
  static constexpr int BN = 128;  // keys a tile
  // K and V have rings of their own: a K tile is free once QK^T has read it,
  // a V tile only after PV, a step later
  static constexpr int KSTAGES = 2;
  static constexpr int VSTAGES = 4;
  static constexpr int Q_EL = 64 * HD;   // a consumer's rows
  static constexpr int KV_EL = BN * HD;  // a K or V tile
  static constexpr size_t smem() {
    return 1024 + sizeof(bf16) * (2 * Q_EL + (KSTAGES + VSTAGES) * KV_EL) +
           8 * (2 + 2 * (KSTAGES + VSTAGES));
  }
};

template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
dense_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const int* __restrict__ pos,
                  bf16* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H, int KVH,
                  int g, float scale) {
  using C = HopperFwd<HD>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024<bf16>(smem_raw);  // [2][HD/64 boxes][64][64]
  bf16* ks = qs + 2 * C::Q_EL;            // [KSTAGES][HD/64 boxes][BN][64]
  bf16* vs = ks + C::KSTAGES * C::KV_EL;  // [VSTAGES][HD/64 boxes][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + C::VSTAGES * C::KV_EL);
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + C::KSTAGES;
  uint64_t* v_full = k_empty + C::KSTAGES;
  uint64_t* v_empty = v_full + C::VSTAGES;
  __shared__ RowStats st;

  const int per_wg = 64 / g;  // positions of a consumer's rows
  const int b = blockIdx.z, h0 = blockIdx.y * g, kvh = h0 / (H / KVH);
  const int t0 = (gridDim.x - 1 - blockIdx.x) * 2 * per_wg;  // the longest rows first
  const int* pos_b = pos + (long long)b * Tq;
  const int n_wg = t0 + per_wg < Tq ? 2 : 1;  // consumers with rows
  row_stats(&st, pos_b, t0, per_wg, Tq, Tk, false);
  const int n_tiles = uniform((max(st.span[0], st.span[1]) + BN - 1) / BN);
  if (threadIdx.x == 0) {
    mbar_init(&q_full[0], 1);
    mbar_init(&q_full[1], 1);
    for (int s = 0; s < C::KSTAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 4 * n_wg);  // a consumer warp's lane 0 each
    }
    for (int s = 0; s < C::VSTAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 4 * n_wg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / kWG);
  if (wg == 0) {  // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 0) {
      for (int c = 0; c < n_wg; ++c) {
        mbar_expect_tx(&q_full[c], C::Q_EL * sizeof(bf16));
        for (int x = 0; x < HD / kBox; ++x)
          tma_load(qs + c * C::Q_EL + x * 64 * kBox, &tq, &q_full[c], x * kBox, h0,
                   t0 + c * per_wg, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int sk = j % C::KSTAGES, sv = j % C::VSTAGES;
        if (j >= C::KSTAGES) mbar_wait(&k_empty[sk], (j / C::KSTAGES - 1) & 1);
        mbar_expect_tx(&k_full[sk], C::KV_EL * sizeof(bf16));
        for (int x = 0; x < HD / kBox; ++x)
          tma_load(ks + sk * C::KV_EL + x * BN * kBox, &tk, &k_full[sk], x * kBox, kvh, j * BN,
                   b);
        if (j >= C::VSTAGES) mbar_wait(&v_empty[sv], (j / C::VSTAGES - 1) & 1);
        mbar_expect_tx(&v_full[sv], C::KV_EL * sizeof(bf16));
        for (int x = 0; x < HD / kBox; ++x)
          tma_load(vs + sv * C::KV_EL + x * BN * kBox, &tv, &v_full[sv], x * kBox, kvh, j * BN,
                   b);
      }
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int tid = threadIdx.x % kWG, warp = tid / kWarp, lane = tid % kWarp;
  const int tw0 = t0 + c * per_wg;
  const int lo = uniform(st.lo[c]);
  const int n_mine = uniform((st.span[c] + BN - 1) / BN);
  const float sl2 = scale * kLog2e;
  int prow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = tw0 + (warp * 16 + lane / 4 + 8 * i) / g;
    prow[i] = t < Tq ? pos_b[t] : 0;
  }
  const bf16* qc = qs + c * C::Q_EL;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(&q_full[c], 0);
  // The first tile alone; then each step issues tile j's QK^T and tile
  // j - 1's PV (a stage each), frees K_j once QK^T is done, runs tile j's
  // softmax while PV runs, waits for it and frees V_{j-1}; then the last PV.
  // The loop body holds no branch around a product: ptxas would serialise
  // them all.
  float sc[BN / 2];
  uint32_t pc[BN / 16][4];
  float alpha[2];
  mbar_wait(&k_full[0], 0);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<BN>(sc, kmajor(qc, 64 * kBoxRowBytes, kk), kmajor(ks, BN * kBoxRowBytes, kk), kk > 0);
  wg_commit();
  wg_wait<0>();
  keep(sc);
  release(&k_empty[0], lane);
  tile_softmax<BN>(sc, m, l, alpha, 0, Tk, lo, prow, lane, scale, sl2);
  to_a<BN>(pc, sc);
  for (int j = 1; j < n_mine; ++j) {
    const int sk = j % C::KSTAGES, pv = (j - 1) % C::VSTAGES;
    mbar_wait(&k_full[sk], (j / C::KSTAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BN>(sc, kmajor(qc, 64 * kBoxRowBytes, kk),
                   kmajor(ks + sk * C::KV_EL, BN * kBoxRowBytes, kk), kk > 0);
    wg_commit();
    keep(sc);
    mbar_wait(&v_full[pv], ((j - 1) / C::VSTAGES) & 1);
    keep(o);
    keep(pc);
    wg_fence();
    issue_nn<HD, BN>(o, pc, vs + pv * C::KV_EL);
    wg_commit();
    keep(o);
    wg_wait<1>();
    keep(sc);
    release(&k_empty[sk], lane);
    tile_softmax<BN>(sc, m, l, alpha, j * BN, Tk, lo, prow, lane, scale, sl2);
    wg_wait<0>();
    keep(o);
    keep(pc);
    release(&v_empty[pv], lane);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    to_a<BN>(pc, sc);
  }
  {
    const int pv = (n_mine - 1) % C::VSTAGES;
    mbar_wait(&v_full[pv], ((n_mine - 1) / C::VSTAGES) & 1);
    keep(o);
    keep(pc);
    wg_fence();
    issue_nn<HD, BN>(o, pc, vs + pv * C::KV_EL);
    wg_commit();
    wg_wait<0>();
    keep(o);
    keep(pc);
    release(&v_empty[pv], lane);
  }
  for (int j = n_mine; j < n_tiles; ++j) {  // past this consumer's rows
    mbar_wait(&k_full[j % C::KSTAGES], (j / C::KSTAGES) & 1);
    release(&k_empty[j % C::KSTAGES], lane);
    mbar_wait(&v_full[j % C::VSTAGES], (j / C::VSTAGES) & 1);
    release(&v_empty[j % C::VSTAGES], lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(~0u, l[i], 1);
    l[i] += __shfl_xor_sync(~0u, l[i], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + 8 * half;
    const int t = tw0 + r / g, head = h0 + r % g;
    if (t >= Tq) continue;
    const float inv = 1.f / l[half];
    const long long at = (((long long)b * Tq + t) * H + head) * HD + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(out + at + n * 8, o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
    if (lane % 4 == 0) lse[((long long)b * H + head) * Tq + t] = m[half] + logf(l[half]);
  }
}

template <int HD>
struct HopperDkv {
  static constexpr int BK = 128;  // keys a block (64 a consumer)
  static constexpr int BQ = 32;  // query rows a tile: dK, dV, S^T, dP^T fit the registers
  static constexpr int STAGES = 3;
  static constexpr int K_EL = BK * HD;  // the block's K (or V)
  static constexpr int T_EL = BQ * HD;  // a Q (or dO) tile
  static constexpr int LO_SLOTS = (STAGES + 1) / 2 * 2;  // even: the barriers stay 8-byte aligned
  // after the tiles: per stage the rows' positions, lse * log2 e and D (BQ
  // each), and their smallest position; then the barriers and a bit per
  // query tile
  static constexpr size_t fixed() {
    return 1024 + sizeof(bf16) * (2 * K_EL + 2 * STAGES * T_EL) +
           (STAGES * 3 * BQ + LO_SLOTS) * sizeof(int) + 8 * (1 + 2 * STAGES);
  }
};

template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
dense_attention_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const int* __restrict__ pos, const float* __restrict__ lse,
                  const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int Tq, int Tk, int H, int KVH, float scale) {
  using C = HopperDkv<HD>;
  constexpr int BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = align1024<bf16>(smem_raw);  // [HD/64 boxes][BK][64]
  bf16* vs = ks + C::K_EL;
  bf16* qs = vs + C::K_EL;               // [STAGES][HD/64 boxes][BQ][64]
  bf16* dos = qs + C::STAGES * C::T_EL;
  int* rpos = reinterpret_cast<int*>(dos + C::STAGES * C::T_EL);  // [STAGES][BQ]
  float* rlse = reinterpret_cast<float*>(rpos + C::STAGES * BQ);  // [STAGES][BQ], * log2 e
  float* rd = rlse + C::STAGES * BQ;                               // [STAGES][BQ]
  int* rlo = reinterpret_cast<int*>(rd + C::STAGES * BQ);          // [LO_SLOTS]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rlo + C::LO_SLOTS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;
  unsigned* need = reinterpret_cast<unsigned*>(empty + C::STAGES);

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * C::BK;  // the keys most queries reach first
  const int rep = H / KVH;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int* pos_b = pos + (long long)b * Tq;
  const int n_wg = k0 + 64 < Tk ? 2 : 1;  // consumers with keys
  mark_tiles<kHopperThreads>(need, pos_b, n_qt, BQ, k0, Tq);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], kWarp);      // the producer warp's lanes
      mbar_init(&empty[s], 4 * n_wg);  // a consumer warp's lane 0 each
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / kWG);
  if (wg == 0) {  // the producer: its first warp
    setmaxnreg_dec<kDkvProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::K_EL * sizeof(bf16));
      for (int x = 0; x < HD / kBox; ++x) {
        tma_load(ks + x * C::BK * kBox, &tk, kv_full, x * kBox, kvh, k0, b);
        tma_load(vs + x * C::BK * kBox, &tv, kv_full, x * kBox, kvh, k0, b);
      }
    }
    int it = 0;
    for (int r = 0; r < rep; ++r) {
      const int h = kvh * rep + r;
      for (int qt = 0; qt < n_qt; ++qt) {
        if (!(need[qt / 32] >> (qt % 32) & 1u)) continue;
        const int s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], (it / C::STAGES - 1) & 1);
        int lo = INT_MAX;
        for (int i = lane; i < BQ; i += kWarp) {
          const int row = qt * BQ + i;
          const bool ok = row < Tq;
          const int p = ok ? pos_b[row] : 0;
          const long long at = ((long long)b * H + h) * Tq + row;
          rpos[s * BQ + i] = p;
          rlse[s * BQ + i] = ok ? lse[at] * kLog2e : 0.f;
          rd[s * BQ + i] = ok ? D[at] : 0.f;
          lo = min(lo, ok ? p : -1);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) lo = min(lo, __shfl_xor_sync(~0u, lo, o));
        if (lane == 0) {
          rlo[s] = lo;  // the smallest position (-1 where the tile passes Tq)
          mbar_expect_tx(&full[s], 2 * C::T_EL * sizeof(bf16));
          for (int x = 0; x < HD / kBox; ++x) {
            tma_load(qs + s * C::T_EL + x * BQ * kBox, &tq, &full[s], x * kBox, h, qt * BQ, b);
            tma_load(dos + s * C::T_EL + x * BQ * kBox, &tdo, &full[s], x * kBox, h, qt * BQ,
                     b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        ++it;
      }
    }
    return;
  }
  setmaxnreg_inc<kDkvConsumerRegs>();
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int tid = threadIdx.x % kWG, warp = tid / kWarp, lane = tid % kWarp;
  const int kc = k0 + 64 * c;  // this consumer's first key
  const int key[2] = {kc + warp * 16 + lane / 4, kc + warp * 16 + lane / 4 + 8};
  const bf16* kw = ks + 64 * kBox * c;  // this consumer's rows of each box
  const bf16* vw = vs + 64 * kBox * c;
  const float sl2 = scale * kLog2e;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);

  // Each item issues its S^T and dP^T (a stage each) while the previous
  // item's dV and dK still run, waits for those and frees their stage, forms
  // P^T while dP^T runs, then dS^T, and issues its own dV and dK.  Only the
  // packed weights of the running dV/dK stay live beside the four
  // accumulators.  Every item is computed, also one that reaches none of
  // this consumer's keys (its weights are exactly 0): no branch around a
  // product, which ptxas would answer by serialising them all.
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  int ps = -1;  // the stage of the running dV/dK (-1: none)
  int it = 0;
  for (int r = 0; r < rep; ++r) {
    for (int qt = 0; qt < n_qt; ++qt) {
      if (!(uniform(need[qt / 32]) >> (qt % 32) & 1u)) continue;
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      ++it;
      const int lo = uniform(rlo[s]);
      const bf16* qt_s = qs + s * C::T_EL;
      const bf16* dot_s = dos + s * C::T_EL;
      float sct[BQ / 2], dpt[BQ / 2];  // S^T, dP^T: 64 keys x BQ queries
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(sct, kmajor(kw, C::BK * kBoxRowBytes, kk),
                     kmajor(qt_s, BQ * kBoxRowBytes, kk), kk > 0);
      wg_commit();
      keep(sct);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(dpt, kmajor(vw, C::BK * kBoxRowBytes, kk),
                     kmajor(dot_s, BQ * kBoxRowBytes, kk), kk > 0);
      wg_commit();
      keep(dpt);
      wg_wait<2>();  // the previous item's dV and dK
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      if (ps >= 0) release(&empty[ps], lane);
      wg_wait<1>();  // S^T
      keep(sct);
      const int* pq = rpos + s * BQ;
      const float* lq = rlse + s * BQ;
      const float* dd = rd + s * BQ;  // D of the tile's rows
      // every row of the tile is in Tq and reaches every key of this consumer
      const bool open = lo >= kc + 63 && kc + 63 < Tk;
      const int q0 = qt * BQ;
      unsigned dead = 0u;  // a bit per weight that sends no dS
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) round2_bf16(sct[2 * i], sct[2 * i + 1]);
      if (open) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int qi = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
          sct[i] = ex2(fmaf(sct[i], sl2, -lq[qi]));
        }
      } else {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = n * 8 + (lane % 4) * 2 + (e & 1);
            const int i = 4 * n + e;
            const int kj = key[e / 2], p = pq[qi];
            const bool valid = q0 + qi < Tq && kj < Tk;
            const bool live = valid && p >= 0 && kj <= p;
            // a row without a live key (p < 0) attends uniformly (score 0)
            // but sends no dS
            const float prob = ex2((live ? sct[i] * sl2 : 0.f) - lq[qi]);
            sct[i] = live || (valid && p < 0) ? prob : 0.f;
            dead |= (live ? 0u : 1u) << i;
          }
      }
      wg_wait<0>();  // dP^T
      keep(dpt);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + (lane % 4) * 2 + (e & 1);
          const int i = 4 * n + e;
          dpt[i] = (dead >> i & 1u) ? 0.f : sct[i] * (dpt[i] - dd[qi]) * scale;
        }
      to_a<BQ>(pa, sct);
      to_a<BQ>(da, dpt);
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      wg_fence();
      issue_nn<HD, BQ>(dva, pa, dot_s);  // dV += P^T dO
      issue_nn<HD, BQ>(dka, da, qt_s);   // dK += dS^T Q
      wg_commit();
      keep(dva);
      keep(dka);
      ps = s;
    }
  }
  wg_wait<0>();
  keep(dva);
  keep(dka);
  keep(pa);
  keep(da);
  if (ps >= 0) release(&empty[ps], lane);
  const long long kstride = (long long)KVH * HD;
  const long long kbase = (long long)b * Tk * kstride + (long long)kvh * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= Tk) continue;
    const long long at = kbase + (long long)key[half] * kstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store2(dk + at + n * 8, dka[4 * n + 2 * half], dka[4 * n + 2 * half + 1]);
      store2(dv + at + n * 8, dva[4 * n + 2 * half], dva[4 * n + 2 * half + 1]);
    }
  }
}

// The D pass's share of one dQ tile: sum_k P dP of this thread's two rows
// over the tile's live keys, added into dsum, from the same P as tile_ds.
template <int BK>
__device__ __forceinline__ void tile_dsum(float (&dsum)[2], float (&sc)[BK / 2],
                                          const float (&dp)[BK / 2], int key0, int Tk, int lo,
                                          const int (&prow)[2], const float (&lrow)[2], int lane,
                                          float sl2) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) round2_bf16(sc[2 * i], sc[2 * i + 1]);
  const bool open = key0 + BK <= Tk && key0 + BK - 1 <= lo;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, h = e / 2;
      const int kj = key0 + n * 8 + (lane % 4) * 2 + (e & 1);
      const bool live = open || (kj < Tk && prow[h] >= 0 && kj <= prow[h]);
      const float pdp = ex2(fmaf(sc[i], sl2, -lrow[h])) * dp[i];
      dsum[h] += live ? pdp : 0.f;
    }
}

template <int HD>
struct HopperDq {
  static constexpr int BK = 64;  // keys a tile
  static constexpr int STAGES = 3;
  static constexpr int Q_EL = 64 * HD;   // a consumer's rows of Q (or dO)
  static constexpr int KV_EL = BK * HD;  // a K or V tile
  static constexpr size_t smem() {
    return 1024 + sizeof(bf16) * (4 * Q_EL + 2 * STAGES * KV_EL) + 8 * (2 + 2 * STAGES);
  }
};

// kD: the D pass — the same sweep of S and dP without the dQ product, D =
// sum_k P dP per row written into D (the dK/dV and dQ passes then read it)
template <int HD, bool kD>
__global__ void __launch_bounds__(kHopperThreads, 1)
dense_attention_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const int* __restrict__ pos, const float* __restrict__ lse,
                 float* __restrict__ D, bf16* __restrict__ dq, int Tq, int Tk, int H, int KVH,
                 int g, float scale) {
  using C = HopperDq<HD>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = align1024<bf16>(smem_raw);  // [2][HD/64 boxes][64][64]
  bf16* dos = qs + 2 * C::Q_EL;
  bf16* ks = dos + 2 * C::Q_EL;           // [STAGES][HD/64 boxes][BK][64]
  bf16* vs = ks + C::STAGES * C::KV_EL;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV_EL);
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + C::STAGES;
  __shared__ RowStats st;

  const int per_wg = 64 / g;
  const int b = blockIdx.z, h0 = blockIdx.y * g, kvh = h0 / (H / KVH);
  const int t0 = (gridDim.x - 1 - blockIdx.x) * 2 * per_wg;
  const int* pos_b = pos + (long long)b * Tq;
  const int n_wg = t0 + per_wg < Tq ? 2 : 1;
  row_stats(&st, pos_b, t0, per_wg, Tq, Tk, true);
  const int n_tiles = uniform((max(st.span[0], st.span[1]) + BK - 1) / BK);
  if (threadIdx.x == 0) {
    mbar_init(&q_full[0], 1);
    mbar_init(&q_full[1], 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_wg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / kWG);
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int c = 0; c < n_wg; ++c) {
        mbar_expect_tx(&q_full[c], 2 * C::Q_EL * sizeof(bf16));
        for (int x = 0; x < HD / kBox; ++x) {
          tma_load(qs + c * C::Q_EL + x * 64 * kBox, &tq, &q_full[c], x * kBox, h0,
                   t0 + c * per_wg, b);
          tma_load(dos + c * C::Q_EL + x * 64 * kBox, &tdo, &q_full[c], x * kBox, h0,
                   t0 + c * per_wg, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        if (j >= C::STAGES) mbar_wait(&empty[s], (j / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_EL * sizeof(bf16));
        for (int x = 0; x < HD / kBox; ++x) {
          tma_load(ks + s * C::KV_EL + x * BK * kBox, &tk, &full[s], x * kBox, kvh, j * BK, b);
          tma_load(vs + s * C::KV_EL + x * BK * kBox, &tv, &full[s], x * kBox, kvh, j * BK, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int tid = threadIdx.x % kWG, warp = tid / kWarp, lane = tid % kWarp;
  const int tw0 = t0 + c * per_wg;
  const int lo = uniform(st.lo[c]);
  const int n_mine = uniform((st.span[c] + BK - 1) / BK);
  const float sl2 = scale * kLog2e;
  int prow[2], trow[2], hrow[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    trow[i] = tw0 + r / g;
    hrow[i] = h0 + r % g;
    const bool ok = trow[i] < Tq;
    const long long at = ((long long)b * H + hrow[i]) * Tq + trow[i];
    prow[i] = ok ? pos_b[trow[i]] : -1;  // a row past Tq takes no key
    lrow[i] = ok ? lse[at] * kLog2e : 0.f;
    drow[i] = ok && !kD ? D[at] : 0.f;
  }
  const bf16* qc = qs + c * C::Q_EL;
  const bf16* doc = dos + c * C::Q_EL;  // this consumer's dO rows
  mbar_wait(&q_full[c], 0);
  float sc[BK / 2], dp[BK / 2];
  if constexpr (kD) {
    // tile j + 1's S and dP run while tile j's P dP is summed into the rows
    // (two register sets, the loop unrolled by two so that each stays put)
    float dsum[2] = {0.f, 0.f};
    float sc2[BK / 2], dp2[BK / 2];
    auto issue = [&](float (&s_)[BK / 2], float (&d_)[BK / 2], int j) {
      const int s = j % C::STAGES;
      mbar_wait(&full[s], (j / C::STAGES) & 1);
      keep(s_);  // pinned before the fence; read again only after the wait
      keep(d_);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss<BK>(s_, kmajor(qc, 64 * kBoxRowBytes, kk),
                     kmajor(ks + s * C::KV_EL, BK * kBoxRowBytes, kk), kk > 0);
        wgmma_ss<BK>(d_, kmajor(doc, 64 * kBoxRowBytes, kk),
                     kmajor(vs + s * C::KV_EL, BK * kBoxRowBytes, kk), kk > 0);
      }
      wg_commit();
    };
    auto sum = [&](float (&s_)[BK / 2], float (&d_)[BK / 2], int j) {  // its products done
      keep(s_);
      keep(d_);
      release(&empty[j % C::STAGES], lane);
      tile_dsum<BK>(dsum, s_, d_, j * BK, Tk, lo, prow, lrow, lane, sl2);
    };
    if (n_mine > 0) {
      issue(sc, dp, 0);
      int j = 0;
      for (; j + 2 < n_mine; j += 2) {  // no branch around a product in here
        issue(sc2, dp2, j + 1);
        wg_wait<1>();
        sum(sc, dp, j);
        issue(sc, dp, j + 2);
        wg_wait<1>();
        sum(sc2, dp2, j + 1);
      }
      if (j + 1 < n_mine) {  // the last one or two tiles, peeled
        issue(sc2, dp2, j + 1);
        wg_wait<1>();
        sum(sc, dp, j);
        wg_wait<0>();
        sum(sc2, dp2, j + 1);
      } else {
        wg_wait<0>();
        sum(sc, dp, j);
      }
    }
    for (int j = n_mine; j < n_tiles; ++j) {
      mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
      release(&empty[j % C::STAGES], lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dsum[i] += __shfl_xor_sync(~0u, dsum[i], 1);
      dsum[i] += __shfl_xor_sync(~0u, dsum[i], 2);
      if (trow[i] < Tq && lane % 4 == 0)
        D[((long long)b * H + hrow[i]) * Tq + trow[i]] = dsum[i];
    }
    return;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // as the forward: tile j's S and dP, then tile j - 1's dQ += dS K (a stage
  // each); tile j's dS is formed while that runs
  uint32_t dc[BK / 16][4];
  if (n_mine > 0) {
    mbar_wait(&full[0], 0);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<BK>(sc, kmajor(qc, 64 * kBoxRowBytes, kk), kmajor(ks, BK * kBoxRowBytes, kk),
                   kk > 0);
      wgmma_ss<BK>(dp, kmajor(doc, 64 * kBoxRowBytes, kk), kmajor(vs, BK * kBoxRowBytes, kk),
                   kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    keep(sc);
    keep(dp);
    tile_ds<BK>(sc, dp, 0, Tk, lo, prow, lrow, drow, lane, scale, sl2);
    to_a<BK>(dc, sc);
    for (int j = 1; j < n_mine; ++j) {
      const int s = j % C::STAGES, ps = (j - 1) % C::STAGES;
      mbar_wait(&full[s], (j / C::STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss<BK>(sc, kmajor(qc, 64 * kBoxRowBytes, kk),
                     kmajor(ks + s * C::KV_EL, BK * kBoxRowBytes, kk), kk > 0);
        wgmma_ss<BK>(dp, kmajor(doc, 64 * kBoxRowBytes, kk),
                     kmajor(vs + s * C::KV_EL, BK * kBoxRowBytes, kk), kk > 0);
      }
      wg_commit();
      keep(sc);
      keep(dp);
      keep(acc);
      keep(dc);
      wg_fence();
      issue_nn<HD, BK>(acc, dc, ks + ps * C::KV_EL);  // dQ += dS K
      wg_commit();
      keep(acc);
      wg_wait<1>();
      keep(sc);
      keep(dp);
      tile_ds<BK>(sc, dp, j * BK, Tk, lo, prow, lrow, drow, lane, scale, sl2);
      wg_wait<0>();
      keep(acc);
      keep(dc);
      release(&empty[ps], lane);
      to_a<BK>(dc, sc);
    }
    keep(acc);
    keep(dc);
    wg_fence();
    issue_nn<HD, BK>(acc, dc, ks + (n_mine - 1) % C::STAGES * C::KV_EL);
    wg_commit();
    wg_wait<0>();
    keep(acc);
    keep(dc);
    release(&empty[(n_mine - 1) % C::STAGES], lane);
  }
  for (int j = n_mine; j < n_tiles; ++j) {  // no row of this consumer reaches these keys
    mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    release(&empty[j % C::STAGES], lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (trow[half] >= Tq) continue;
    bf16* dst = dq + (((long long)b * Tq + trow[half]) * H + hrow[half]) * HD + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(dst + n * 8, acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

// ===========================================================================
// the pre-pass and the launches
// ===========================================================================

constexpr int kPreWarps = 8;

// fp32: D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one warp a row
template <int HD>
__global__ void __launch_bounds__(kPreWarps * kWarp)
dense_attention_pre_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                           float* __restrict__ D, long long rows, int Tq, int H) {
  const long long row = (long long)blockIdx.x * kPreWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < HD; d += kWarp) acc = fmaf(out[row * HD + d], dout[row * HD + d], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bt = row / H;
    const long long b = bt / Tq, t = bt % Tq;
    D[(b * H + h) * Tq + t] = acc;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a bf16 [B, rows, heads, HD] tensor (rows Tq for Q, out and dO,
// Tk for K and V) whose boxes are 64 columns x box_heads heads x box_rows
// positions of one batch row, 128-byte swizzled; positions past the rows
// read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int HD, int heads, int rows, int B,
              int box_heads, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)rows * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// query heads a Hopper forward or dQ row tile packs per position: the
// largest power of two dividing H / KVH, at most 16
int group_of(int H, int KVH) {
  const int low = (H / KVH) & -(H / KVH);
  return low < 16 ? low : 16;
}

template <int HD>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const int* pos, void* out,
                    float* lse, int B, int Tq, int Tk, int H, int KVH, float scale, cudaStream_t s) {
  if constexpr (HD == 16) {
    constexpr size_t smem = mma_fwd_smem<HD>();
    cudaError_t e = set_smem((const void*)dense_attention_fwd_mma_kernel<HD>, smem);
    if (e != cudaSuccess) return (int)e;
    dense_attention_fwd_mma_kernel<HD><<<dim3((Tq + kRows - 1) / kRows, H, B), kMmaThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        pos, static_cast<bf16*>(out), lse, Tq, Tk, H, KVH, scale);
  } else {
    using C = HopperFwd<HD>;
    const int g = group_of(H, KVH);
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, HD, H, Tq, B, g, 64 / g) ||
        !make_map(&tk, k, HD, KVH, Tk, B, 1, C::BN) ||
        !make_map(&tv, v, HD, KVH, Tk, B, 1, C::BN))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem((const void*)dense_attention_fwd_wgmma_kernel<HD>, C::smem());
    if (e != cudaSuccess) return (int)e;
    const int rows_t = 128 / g;  // positions a block covers
    dense_attention_fwd_wgmma_kernel<HD><<<dim3((Tq + rows_t - 1) / rows_t, H / g, B), kHopperThreads,
                            C::smem(), s>>>(tq, tk, tv, pos, static_cast<bf16*>(out), lse,
                                            Tq, Tk, H, KVH, g, scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_f32(const void* q, const void* k, const void* v, const int* pos, void* out,
                   float* lse, int B, int Tq, int Tk, int H, int KVH, float scale, cudaStream_t s) {
  constexpr size_t smem = f32_fwd_smem<HD>();
  cudaError_t e = set_smem((const void*)dense_attention_fwd_f32_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  dense_attention_fwd_f32_kernel<HD><<<dim3((Tq + kF32Rows - 1) / kF32Rows, H, B), kF32Threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos, static_cast<float*>(out), lse, Tq, Tk, H, KVH, scale);
  return (int)cudaGetLastError();
}

// What a backward launch runs: D (bf16: the D pass, the dQ kernel without its
// product; fp32: the pre-pass from the output), then the gradients (dK/dV,
// then dQ).  The backward runs both; a ring chunk's "D only" the first alone
// and its "D given" the second alone, with the caller's D.
enum BwdPart { kBwdAll = 3, kBwdD = 1, kBwdGrads = 2 };

// bf16: the D pass (the dQ kernel without its product), then dK/dV, then dQ
template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const int* pos,
                    const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                    int B, int Tq, int Tk, int H, int KVH, float scale, int parts,
                    cudaStream_t s) {
  cudaError_t e;
  if constexpr (HD == 16) {
    constexpr size_t dqs = mma_dq_smem<HD>();
    const dim3 dq_grid((Tq + kRows - 1) / kRows, H, B);
    if (parts & kBwdD) {
      e = set_smem((const void*)dense_attention_dq_mma_kernel<HD, true>, dqs);
      if (e != cudaSuccess) return (int)e;
      dense_attention_dq_mma_kernel<HD, true><<<dq_grid, kMmaThreads, dqs, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          pos, static_cast<const bf16*>(dout), lse, D, nullptr, Tq, Tk, H, KVH, scale);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (!(parts & kBwdGrads)) return (int)cudaSuccess;
    const int n_qt = (Tq + kBwdTile - 1) / kBwdTile;
    const size_t dkv = mma_dkv_smem_fixed<HD>() + sizeof(unsigned) * ((n_qt + 31) / 32);
    e = set_smem((const void*)dense_attention_dkv_mma_kernel<HD>, dkv);
    if (e != cudaSuccess) return (int)e;
    dense_attention_dkv_mma_kernel<HD><<<dim3((Tk + kRows - 1) / kRows, KVH, B), kMmaThreads, dkv, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        pos, static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Tq, Tk, H, KVH, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = set_smem((const void*)dense_attention_dq_mma_kernel<HD, false>, dqs);
    if (e != cudaSuccess) return (int)e;
    dense_attention_dq_mma_kernel<HD, false><<<dq_grid, kMmaThreads, dqs, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        pos, static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), Tq, Tk, H, KVH,
        scale);
  } else {
    using K = HopperDkv<HD>;
    using Q = HopperDq<HD>;
    const int g = group_of(H, KVH);
    CUtensorMap tq1, tdo1, tkb, tvb, tqg, tdog, tkt, tvt;
    if (!make_map(&tq1, q, HD, H, Tq, B, 1, K::BQ) ||
        !make_map(&tdo1, dout, HD, H, Tq, B, 1, K::BQ) ||
        !make_map(&tkb, k, HD, KVH, Tk, B, 1, K::BK) ||
        !make_map(&tvb, v, HD, KVH, Tk, B, 1, K::BK) ||
        !make_map(&tqg, q, HD, H, Tq, B, g, 64 / g) ||
        !make_map(&tdog, dout, HD, H, Tq, B, g, 64 / g) ||
        !make_map(&tkt, k, HD, KVH, Tk, B, 1, Q::BK) ||
        !make_map(&tvt, v, HD, KVH, Tk, B, 1, Q::BK))
      return (int)cudaErrorInvalidValue;
    const int rows_t = 128 / g;
    const dim3 dq_grid((Tq + rows_t - 1) / rows_t, H / g, B);
    if (parts & kBwdD) {
      e = set_smem((const void*)dense_attention_dq_wgmma_kernel<HD, true>, Q::smem());
      if (e != cudaSuccess) return (int)e;
      dense_attention_dq_wgmma_kernel<HD, true><<<dq_grid, kHopperThreads, Q::smem(), s>>>(
          tqg, tkt, tvt, tdog, pos, lse, D, nullptr, Tq, Tk, H, KVH, g, scale);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (!(parts & kBwdGrads)) return (int)cudaSuccess;
    const int n_qt = (Tq + K::BQ - 1) / K::BQ;
    const size_t dkv = K::fixed() + sizeof(unsigned) * ((n_qt + 31) / 32);
    e = set_smem((const void*)dense_attention_dkv_wgmma_kernel<HD>, dkv);
    if (e != cudaSuccess) return (int)e;
    dense_attention_dkv_wgmma_kernel<HD><<<dim3((Tk + K::BK - 1) / K::BK, KVH, B), kHopperThreads, dkv, s>>>(
        tq1, tkb, tvb, tdo1, pos, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq,
        Tk, H, KVH, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = set_smem((const void*)dense_attention_dq_wgmma_kernel<HD, false>, Q::smem());
    if (e != cudaSuccess) return (int)e;
    dense_attention_dq_wgmma_kernel<HD, false><<<dq_grid, kHopperThreads, Q::smem(), s>>>(
        tqg, tkt, tvt, tdog, pos, lse, D, static_cast<bf16*>(dq), Tq, Tk, H, KVH, g, scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v, const int* pos, const void* out,
                   const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                   int B, int Tq, int Tk, int H, int KVH, float scale, int parts,
                   cudaStream_t s) {
  cudaError_t e;
  if (parts & kBwdD) {
    const long long rows = (long long)B * Tq * H;
    dense_attention_pre_kernel<HD><<<(unsigned)((rows + kPreWarps - 1) / kPreWarps),
                                     kPreWarps * kWarp, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), D, rows, Tq, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!(parts & kBwdGrads)) return (int)cudaSuccess;
  const int n_qt = (Tq + kF32DkvRows<HD> - 1) / kF32DkvRows<HD>;
  const size_t dkv = f32_dkv_smem_fixed<HD>() + sizeof(unsigned) * ((n_qt + 31) / 32);
  e = set_smem((const void*)dense_attention_dkv_f32_kernel<HD>, dkv);
  if (e != cudaSuccess) return (int)e;
  dense_attention_dkv_f32_kernel<HD><<<dim3((Tk + kF32Rows - 1) / kF32Rows, KVH, B), kF32Threads, dkv, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos, static_cast<const float*>(dout), lse, D, static_cast<float*>(dk),
      static_cast<float*>(dv), Tq, Tk, H, KVH, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr size_t dqs = f32_dq_smem<HD>();
  e = set_smem((const void*)dense_attention_dq_f32_kernel<HD>, dqs);
  if (e != cudaSuccess) return (int)e;
  dense_attention_dq_f32_kernel<HD><<<dim3((Tq + kF32Rows - 1) / kF32Rows, H, B), kF32Threads, dqs, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos, static_cast<const float*>(dout), lse, D, static_cast<float*>(dq), Tq, Tk, H, KVH,
      scale);
  return (int)cudaGetLastError();
}

bool args_ok(int dtype, int head_dim, int B, int Tq, int Tk, int H, int KVH) {
  return (dtype == 0 || dtype == 1) && (head_dim == 16 || head_dim == 64 || head_dim == 128) &&
         B >= 1 && B <= 65535 && Tq >= 1 && Tk >= 1 && H >= 1 && H <= 65535 && KVH >= 1 &&
         H % KVH == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 64 or 128.  Every pointer is
// a contiguous tensor of the layouts above on the stream's device; scale is
// 1/sqrt(head_dim).  Returns
// the launch's cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// when a TMA map cannot be made; the caller checks every argument.
extern "C" int dense_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* pos, void* out, void* lse, int B,
                                   int Tq, int Tk, int H, int KVH, float scale, void* stream) {
  if (!args_ok(dtype, head_dim, B, Tq, Tk, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
#define CORDUM_FWD(HD) return launch_fwd_f32<HD>(q, k, v, p, out, l, B, Tq, Tk, H, KVH, scale, s)
    if (head_dim == 16) CORDUM_FWD(16);
    if (head_dim == 64) CORDUM_FWD(64);
    CORDUM_FWD(128);
#undef CORDUM_FWD
  }
#define CORDUM_FWD(HD) \
  return launch_fwd_bf16<HD>(q, k, v, p, out, l, B, Tq, Tk, H, KVH, scale, s)
  if (head_dim == 16) CORDUM_FWD(16);
  if (head_dim == 64) CORDUM_FWD(64);
  CORDUM_FWD(128);
#undef CORDUM_FWD
}

namespace {

int backward(int dtype, int head_dim, const void* q, const void* k, const void* v,
             const void* pos, const void* out, const void* dout, const void* lse, void* D,
             void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H, int KVH, float scale,
             int parts, void* stream) {
  if (!args_ok(dtype, head_dim, B, Tq, Tk, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (dtype == 0) {
#define CORDUM_BWD(HD)                                                                     \
  return launch_bwd_f32<HD>(q, k, v, p, out, dout, l, d, dq, dk, dv, B, Tq, Tk, H, KVH, scale, \
                            parts, s)
    if (head_dim == 16) CORDUM_BWD(16);
    if (head_dim == 64) CORDUM_BWD(64);
    CORDUM_BWD(128);
#undef CORDUM_BWD
  }
#define CORDUM_BWD(HD)                                                                        \
  return launch_bwd_bf16<HD>(q, k, v, p, dout, l, d, dq, dk, dv, B, Tq, Tk, H, KVH, scale, parts, \
                             s)
  if (head_dim == 16) CORDUM_BWD(16);
  if (head_dim == 64) CORDUM_BWD(64);
  CORDUM_BWD(128);
#undef CORDUM_BWD
}

}  // namespace

// The backward: D into an fp32 [B, H, Tq] scratch the caller allocates (fp32:
// the pre-pass from out; bf16: the D pass, which does not read out), then
// dK/dV and dQ, all on `stream`.
extern "C" int dense_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* pos, const void* out,
                                   const void* dout, const void* lse, void* D, void* dq,
                                   void* dk, void* dv, int B, int Tq, int Tk, int H, int KVH,
                                   float scale, void* stream) {
  return backward(dtype, head_dim, q, k, v, pos, out, dout, lse, D, dq, dk, dv, B, Tq, Tk, H,
                  KVH, scale, kBwdAll, stream);
}

// A ring chunk's "D only": the backward's D alone, into the caller's fp32
// [B, H, Tq] D.  bf16: the D pass over this chunk's keys under the caller's
// lse (the row's, over the whole ring), sum_k P dP over the chunk's live
// keys, a partial the caller sums over the ring's chunks; q, k, v, pos, dout
// and lse are read, out is not.  fp32: the pre-pass, rowsum(dO * out) of the
// whole row (out the ring's merged output), which reads out and dout only.
extern "C" int dense_attention_d(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* pos, const void* out,
                                 const void* dout, const void* lse, void* D, int B, int Tq,
                                 int Tk, int H, int KVH, float scale, void* stream) {
  return backward(dtype, head_dim, q, k, v, pos, out, dout, lse, D, nullptr, nullptr, nullptr,
                  B, Tq, Tk, H, KVH, scale, kBwdD, stream);
}

// A ring chunk's "D given": dK/dV and dQ of this chunk's keys under the
// caller's lse and D (the row's over the whole ring), with no D pass or
// pre-pass; out is not read.
extern "C" int dense_attention_bwd_given(int dtype, int head_dim, const void* q, const void* k,
                                         const void* v, const void* pos, const void* dout,
                                         const void* lse, const void* D, void* dq, void* dk,
                                         void* dv, int B, int Tq, int Tk, int H, int KVH,
                                         float scale, void* stream) {
  return backward(dtype, head_dim, q, k, v, pos, nullptr, dout, lse, const_cast<void*>(D), dq,
                  dk, dv, B, Tq, Tk, H, KVH, scale, kBwdGrads, stream);
}
