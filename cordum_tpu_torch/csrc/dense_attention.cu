// Dense causal GQA self-attention, forward and backward, for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the attention core of the JAX package's Llama forward
// (cordum_tpu/models/llama.py, _attention: the `scores` einsum, the causal
// -1e30 mask, the fp32 softmax and the `probs @ v` einsum) as _block calls it
// with q_offset = positions, and the gradient XLA derives for it under
// jax.value_and_grad in loss_fn.  XLA keeps [B, H, T, T] fp32 scores and
// probabilities in device memory (and autograd keeps them for every layer);
// here a block's scores never leave it, and the backward recomputes them from
// the row statistics the forward saves (lse = max + log(sum), fp32 [B, H, T]).
//
// Numerics, held to the reference:
//   * scores q.k accumulated in fp32 and rounded to the input dtype (the
//     reference's einsum output), then cast to fp32 and multiplied by
//     1/sqrt(head_dim) (the reference divides; the two differ by at most one
//     fp32 ulp);
//   * the mask is k_index <= positions[b, q]; a masked score is left out of
//     the softmax (weight exactly 0, which is what exp(-1e30 - max) gives
//     the reference when the row has a live key).  A row whose position is
//     negative has no live key: the reference's softmax over T equal -1e30s
//     is uniform over all T keys, and so it is here (every score counts as
//     0), with no gradient into q or k (the reference's `where` blocks it);
//   * an fp32 online softmax (running max and sum per row); the weights
//     exp(s - max) are rounded to the input dtype before the PV product and
//     the sum is divided out at the end (the reference rounds the
//     normalised probabilities: a few bf16 ulps apart);
//   * the backward: D = rowsum(dO * O) in fp32 (a pre-pass), P = exp(s -
//     lse), dS = P * (dP - D) / sqrt(head_dim) rounded to the input dtype
//     before the dQ = dS K and dK = dS^T Q products.  dP - D cancels where a
//     row's weight sits on few keys (one live key: dS is 0), so both stay
//     near fp32: dP = dO V^T is not rounded (the reference rounds its
//     einsum output, but its D sums that same rounded dP, which rowsum(dO *
//     O) cannot), and in bf16 the forward also writes the output's rounding
//     residual, out_lo = bf16(O - bf16(O)), which the pre-pass adds back:
//     D from the bf16 output alone is off by a bf16 ulp of |dO| |O|, which
//     on such a row is the size of dQ itself.
//
// Bound: at the training shapes (T 256 .. 2048, head_dim 64 / 128) the
// operations (4 * head_dim per live (query, key) pair forward, 2.5 times that
// backward) outweigh the bytes of q, k, v, out and the gradients, so the
// kernels are bound by the tensor cores in bf16 and by the CUDA cores in
// fp32.  Key tiles past a query tile's largest position (wholly above the
// causal diagonal) are neither loaded nor multiplied, which halves the work.
//
// Design (FlashAttention-2's split; simple first, no wgmma, TMA or
// persistent schedule yet): four warps a block, each warp 16 rows.
//   * forward: one block per (batch, head, 64 query rows); 64-key tiles of K
//     and V double-buffered in shared memory with 16-byte cp.async.
//   * pre-pass: one warp per (batch, position, head) row for D.
//   * dK/dV: one block per (batch, KV head, 64 keys); it loops over the H/KVH
//     query heads that share the KV head and over the 32-row query tiles that
//     reach its keys (read from `positions`, so any positions work), with
//     dK and dV summed in fp32 registers across the whole loop and written
//     once: the GQA sum needs no atomics and the result is deterministic.
//   * dQ: one block per (batch, head, 64 query rows), over 32-key tiles.
//   * bf16: every product on the tensor cores with mma.sync m16n8k16 (fp32
//     accumulate), operands by ldmatrix from padded rows; the weights P and
//     dS go from the accumulator fragments straight into the A operand.
//   * fp32: the same tiles and fragment layout, the products in full fp32 on
//     CUDA cores (TF32 would break parity); P and dS pass through a
//     per-warp scratch in shared memory.
//
// Layouts: q [B, T, H, hd], k and v [B, T, KVH, hd], contiguous; positions
// [B, T] int32; out, out_lo (bf16 only; null in fp32), dO and dq [B, T, H,
// hd]; dk, dv [B, T, KVH, hd]; lse and D [B, H, T] fp32.  head_dim 16, 64 or
// 128; any T >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 16 * kWarps;  // query rows (forward, dQ) or keys (dK/dV) a block owns
constexpr int kFwdKeys = 64;        // keys a forward step takes
constexpr int kBwdTile = 32;        // query rows a dK/dV step takes; keys a dQ step takes

// a shared-memory row: head_dim elements plus 16 bytes, so ldmatrix and the
// fp32 float4 reads of 8 rows fall in distinct banks
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

template <typename T>
__device__ __forceinline__ float round_in(float x) {  // x rounded to T, as fp32
  if constexpr (std::is_same_v<T, bf16>) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}
template <typename T>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __expf(x);
  } else {
    return expf(x);
  }
}
template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __bfloat162float(x);
  } else {
    return x;
  }
}
// two adjacent outputs of one row
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (std::is_same_v<T, bf16>) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
}
// the same, and in bf16 (lo not null) what rounding left out, rounded into lo
template <typename T>
__device__ __forceinline__ void store2_split(T* dst, T* lo, float a, float b) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(dst) = hi;
    if (lo != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(lo) =
          __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi));
  } else {
    store2<T>(dst, a, b);
  }
}

// Rows g0 .. g0 + n of one head of a [.., T, heads, HD] tensor into padded
// shared rows with cp.async; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long base,
                                          long long row_stride, int g0, int n, int T_len) {
  constexpr int kChunk = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = HD / kChunk;
  constexpr int S = kSrow<T, HD>;
  for (int c = threadIdx.x; c < n * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * kChunk;
    T* p = dst + r * S + d;
    if (g0 + r < T_len) {
      cp_async16(p, src + base + (long long)(g0 + r) * row_stride + d);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The positions of query rows q0 .. q0 + n into s_pos (0 past T) and the
// number of keys they reach: T when a row has no live key (it attends to
// all), else the largest position + 1, at most T.  Ends with a barrier.
__device__ __forceinline__ int key_span(const int* pos_b, int q0, int n, int T_len,
                                        int* s_pos, int* s_span) {
  if (threadIdx.x == 0) {
    s_span[0] = -1;
    s_span[1] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool ok = q0 + r < T_len;
    const int p = ok ? pos_b[q0 + r] : 0;
    s_pos[r] = p;
    if (ok) {
      atomicMax(&s_span[0], p);
      if (p < 0) s_span[1] = 1;
    }
  }
  __syncthreads();
  return s_span[1] ? T_len : min(T_len, s_span[0] + 1);
}

// acc[n][e] += A[r] . B[n*8 + c] over HD, in the m16n8 accumulator layout
// (r = lane/4 for e 0, 1 and lane/4 + 8 for e 2, 3; c = (lane%4)*2 + (e&1)):
// 16 rows of A against 8*NT rows of B, both padded shared rows.
template <typename T, int NT, int HD>
__device__ __forceinline__ void warp_nt(float (&acc)[NT][4], const T* A, const T* B, int lane) {
  constexpr int S = kSrow<T, HD>;
  if constexpr (std::is_same_v<T, bf16>) {
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
  } else {
    const float* ra = A + (lane / 4) * S;
    const float* rb = ra + 8 * S;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(ra + d);
      const float4 xb = *reinterpret_cast<const float4*>(rb + d);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* c0 = B + (n * 8 + (lane % 4) * 2) * S + d;
        const float4 y0 = *reinterpret_cast<const float4*>(c0);
        const float4 y1 = *reinterpret_cast<const float4*>(c0 + S);
        float* o = acc[n];
        o[0] = fmaf(xa.x, y0.x, fmaf(xa.y, y0.y, fmaf(xa.z, y0.z, fmaf(xa.w, y0.w, o[0]))));
        o[1] = fmaf(xa.x, y1.x, fmaf(xa.y, y1.y, fmaf(xa.z, y1.z, fmaf(xa.w, y1.w, o[1]))));
        o[2] = fmaf(xb.x, y0.x, fmaf(xb.y, y0.y, fmaf(xb.z, y0.z, fmaf(xb.w, y0.w, o[2]))));
        o[3] = fmaf(xb.x, y1.x, fmaf(xb.y, y1.y, fmaf(xb.z, y1.z, fmaf(xb.w, y1.w, o[3]))));
      }
    }
  }
}

// acc[n][e] += sum_k P[r][k] * B[k][n*8 + c]: P is the warp's 16 x 8*KT
// block in the accumulator layout (p[kt][e]), B the first 8*KT padded shared
// rows of a [k][HD] tile.  bf16: P rounded to bf16 and repacked into A
// fragments (the C layout of two n8 tiles is the A layout of one k16 step);
// fp32: P goes through the warp's scratch rows (16 x (8*KT + 4) floats).
template <typename T, int KT, int HD>
__device__ __forceinline__ void warp_nn(float (&acc)[HD / 8][4], const float (&p)[KT][4],
                                        const T* B, float* scratch, int lane) {
  constexpr int S = kSrow<T, HD>;
  if constexpr (std::is_same_v<T, bf16>) {
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
  } else {
    constexpr int PS = KT * 8 + 4;
    float* wa = scratch + (lane / 4) * PS + (lane % 4) * 2;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      *reinterpret_cast<float2*>(wa + kt * 8) = make_float2(p[kt][0], p[kt][1]);
      *reinterpret_cast<float2*>(wa + 8 * PS + kt * 8) = make_float2(p[kt][2], p[kt][3]);
    }
    __syncwarp();
    const float* pa = scratch + (lane / 4) * PS;
    const float* pb = pa + 8 * PS;
#pragma unroll 1
    for (int k = 0; k < KT * 8; k += 4) {
      const float4 xa4 = *reinterpret_cast<const float4*>(pa + k);
      const float4 xb4 = *reinterpret_cast<const float4*>(pb + k);
      const float xa[4] = {xa4.x, xa4.y, xa4.z, xa4.w};
      const float xb[4] = {xb4.x, xb4.y, xb4.z, xb4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* brow = B + (k + j) * S + (lane % 4) * 2;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(brow + n * 8);
          acc[n][0] = fmaf(xa[j], y.x, acc[n][0]);
          acc[n][1] = fmaf(xa[j], y.y, acc[n][1]);
          acc[n][2] = fmaf(xb[j], y.x, acc[n][2]);
          acc[n][3] = fmaf(xb[j], y.y, acc[n][3]);
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return sizeof(T) * (kRows + 4 * kFwdKeys) * kSrow<T, HD> +
         (std::is_same_v<T, float> ? sizeof(float) * kWarps * 16 * (kFwdKeys + 4) : 0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dense_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ pos,
                           T* __restrict__ out, T* __restrict__ out_lo, float* __restrict__ lse,
                           int T_len, int H, int KVH, float scale) {
  constexpr int S = kSrow<T, HD>;
  constexpr int NT = kFwdKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][S]
  T* ks = qs + kRows * S;                   // [2][64][S]
  T* vs = ks + 2 * kFwdKeys * S;             // [2][64][S]
  float* scratch = reinterpret_cast<float*>(vs + 2 * kFwdKeys * S);  // fp32 only
  __shared__ int s_pos[kRows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest rows first
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * T_len * qstride + (long long)h * HD;
  const long long kbase = (long long)b * T_len * kstride + (long long)kvh * HD;

  load_rows<T, HD>(qs, q, qbase, qstride, q0, kRows, T_len);
  const int kv_end = key_span(pos + (long long)b * T_len, q0, kRows, T_len, s_pos, s_span);
  const int n_tiles = (kv_end + kFwdKeys - 1) / kFwdKeys;
  load_rows<T, HD>(ks, k, kbase, kstride, 0, kFwdKeys, T_len);
  load_rows<T, HD>(vs, v, kbase, kstride, 0, kFwdKeys, T_len);
  cp_async_commit();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int ra = warp * 16 + lane / 4;  // this lane's rows: ra and ra + 8
  const int prow[2] = {s_pos[ra], s_pos[ra + 8]};
  float* wscratch = scratch + warp * 16 * (kFwdKeys + 4);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<T, HD>(ks + (buf ^ 1) * kFwdKeys * S, k, kbase, kstride, (j + 1) * kFwdKeys,
                       kFwdKeys, T_len);
      load_rows<T, HD>(vs + (buf ^ 1) * kFwdKeys * S, v, kbase, kstride, (j + 1) * kFwdKeys,
                       kFwdKeys, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_nt<T, NT, HD>(s, qs + warp * 16 * S, ks + buf * kFwdKeys * S, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kFwdKeys + n * 8 + (lane % 4) * 2 + (e & 1);
        const int p = prow[e / 2];
        float x;
        if (key >= T_len) x = -INFINITY;  // not a key
        else if (p < 0) x = 0.f;          // no live key: uniform, as the reference
        else x = key <= p ? round_in<T>(s[n][e]) * scale : -INFINITY;
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
      alpha[i] = exp_of<T>(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp_of<T>(s[n][e] - mu[e / 2]);
        l[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    warp_nn<T, NT, HD>(acc, s, vs + buf * kFwdKeys * S, wscratch, lane);
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
    if (row >= T_len) continue;
    const float inv = 1.f / l[half];
    const long long at = qbase + (long long)row * qstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2_split<T>(out + at + n * 8, out_lo == nullptr ? nullptr : out_lo + at + n * 8,
                      acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    if (lane % 4 == 0) lse[((long long)b * H + h) * T_len + row] = m[half] + logf(l[half]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kPreWarps = 8;

// D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one warp a row; O is
// out + out_lo where out_lo is given
template <typename T, int HD>
__global__ void __launch_bounds__(kPreWarps * kWarp)
dense_attention_pre_kernel(const T* __restrict__ out, const T* __restrict__ out_lo,
                           const T* __restrict__ dout, float* __restrict__ D, long long rows,
                           int T_len, int H) {
  const long long row = (long long)blockIdx.x * kPreWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < HD; d += kWarp) {
    const float o = to_f32(out[row * HD + d]) +
                    (out_lo == nullptr ? 0.f : to_f32(out_lo[row * HD + d]));
    acc = fmaf(o, to_f32(dout[row * HD + d]), acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bt = row / H;
    const long long b = bt / T_len, t = bt % T_len;
    D[(b * H + h) * T_len + t] = acc;
  }
}

template <typename T, int HD>
constexpr size_t dkv_smem_fixed() {
  return sizeof(T) * (2 * kRows + 4 * kBwdTile) * kSrow<T, HD> +
         (std::is_same_v<T, float> ? sizeof(float) * kWarps * 16 * (kBwdTile + 4) : 0) +
         sizeof(float) * 2 * 2 * kBwdTile + sizeof(int) * 2 * kBwdTile;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dense_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ pos,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ D, T* __restrict__ dk,
                           T* __restrict__ dv, int T_len, int H, int KVH, float scale) {
  constexpr int S = kSrow<T, HD>;
  constexpr int QT = kBwdTile;
  constexpr int NT = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [64][S]: this block's keys
  T* vs = ks + kRows * S;                   // [64][S]
  T* qs = vs + kRows * S;                   // [2][32][S]
  T* dos = qs + 2 * QT * S;                 // [2][32][S]
  float* scratch = reinterpret_cast<float*>(dos + 2 * QT * S);  // fp32 only
  float* rowf = scratch + (std::is_same_v<T, float> ? kWarps * 16 * (QT + 4) : 0);  // [2][lse 32, D 32]
  int* rowpos = reinterpret_cast<int*>(rowf + 2 * 2 * QT);  // [2][32]
  unsigned* need = reinterpret_cast<unsigned*>(rowpos + 2 * QT);  // a bit per query tile

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;  // the keys most queries reach first
  const int rep = H / KVH;
  const int n_qt = (T_len + QT - 1) / QT;
  const int total = rep * n_qt;  // (query head of the group, query tile) items
  const int* pos_b = pos + (long long)b * T_len;
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long kbase = (long long)b * T_len * kstride + (long long)kvh * HD;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // which query tiles reach these keys: a row with no live key reaches all
  for (int w = threadIdx.x; w < (n_qt + 31) / 32; w += kThreads) need[w] = 0u;
  __syncthreads();
  for (int t = warp; t < n_qt; t += kWarps) {
    const int r = t * QT + lane;
    const int p = r < T_len ? pos_b[r] : 0;
    const bool reach = r < T_len && (p < 0 || p >= k0);
    if (__any_sync(~0u, reach) && lane == 0) atomicOr(&need[t / 32], 1u << (t % 32));
  }
  __syncthreads();
  auto next_item = [&](int item) {
    for (++item; item < total; ++item) {
      const int t = item % n_qt;
      if (need[t / 32] >> (t % 32) & 1u) break;
    }
    return item;
  };
  auto stage = [&](int item, int buf) {
    const int h = kvh * rep + item / n_qt, r0 = (item % n_qt) * QT;
    const long long qbase = (long long)b * T_len * qstride + (long long)h * HD;
    load_rows<T, HD>(qs + buf * QT * S, q, qbase, qstride, r0, QT, T_len);
    load_rows<T, HD>(dos + buf * QT * S, dout, qbase, qstride, r0, QT, T_len);
    for (int i = threadIdx.x; i < QT; i += kThreads) {
      const int r = r0 + i;
      const bool ok = r < T_len;
      const long long at = ((long long)b * H + h) * T_len + r;
      rowpos[buf * QT + i] = ok ? pos_b[r] : 0;
      rowf[buf * 2 * QT + i] = ok ? lse[at] : 0.f;
      rowf[buf * 2 * QT + QT + i] = ok ? D[at] : 0.f;
    }
  };

  load_rows<T, HD>(ks, k, kbase, kstride, k0, kRows, T_len);
  load_rows<T, HD>(vs, v, kbase, kstride, k0, kRows, T_len);
  int item = next_item(-1);
  if (item < total) stage(item, 0);
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + lane / 4, k0 + warp * 16 + lane / 4 + 8};
  float* wscratch = scratch + warp * 16 * (QT + 4);
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
    const T* qb = qs + buf * QT * S;
    const T* dob = dos + buf * QT * S;
    const float* lse_s = rowf + buf * 2 * QT;
    const float* d_s = lse_s + QT;
    const int* pos_s = rowpos + buf * QT;
    float st[NT][4], dpt[NT][4];  // S^T and dP^T: this warp's 16 keys x 32 queries
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    warp_nt<T, NT, HD>(st, ks + warp * 16 * S, qb, lane);
    warp_nt<T, NT, HD>(dpt, vs + warp * 16 * S, dob, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + (lane % 4) * 2 + (e & 1);
        const int kj = key[e / 2];
        const int p = pos_s[qi];
        const bool valid = r0 + qi < T_len && kj < T_len;
        const bool live = valid && p >= 0 && kj <= p;
        const float x = live ? round_in<T>(st[n][e]) * scale : 0.f;
        const float prob = (live || (valid && p < 0)) ? exp_of<T>(x - lse_s[qi]) : 0.f;
        st[n][e] = prob;
        dpt[n][e] = live ? prob * (dpt[n][e] - d_s[qi]) * scale : 0.f;
      }
    warp_nn<T, NT, HD>(dv_acc, st, dob, wscratch, lane);   // dV += P^T dO
    warp_nn<T, NT, HD>(dk_acc, dpt, qb, wscratch, lane);   // dK += dS^T Q
    __syncthreads();
    item = nxt;
    buf ^= 1;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= T_len) continue;
    const long long at = kbase + (long long)key[half] * kstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store2<T>(dk + at + n * 8, dk_acc[n][2 * half], dk_acc[n][2 * half + 1]);
      store2<T>(dv + at + n * 8, dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  return sizeof(T) * (2 * kRows + 4 * kBwdTile) * kSrow<T, HD> +
         (std::is_same_v<T, float> ? sizeof(float) * kWarps * 16 * (kBwdTile + 4) : 0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dense_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ pos,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ D, T* __restrict__ dq, int T_len, int H,
                          int KVH, float scale) {
  constexpr int S = kSrow<T, HD>;
  constexpr int KT = kBwdTile;
  constexpr int NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][S]
  T* dos = qs + kRows * S;                  // [64][S]
  T* ks = dos + kRows * S;                  // [2][32][S]
  T* vs = ks + 2 * KT * S;                  // [2][32][S]
  float* scratch = reinterpret_cast<float*>(vs + 2 * KT * S);  // fp32 only
  __shared__ int s_pos[kRows];
  __shared__ int s_span[2];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int kvh = h / (H / KVH);
  const long long qstride = (long long)H * HD, kstride = (long long)KVH * HD;
  const long long qbase = (long long)b * T_len * qstride + (long long)h * HD;
  const long long kbase = (long long)b * T_len * kstride + (long long)kvh * HD;

  load_rows<T, HD>(qs, q, qbase, qstride, q0, kRows, T_len);
  load_rows<T, HD>(dos, dout, qbase, qstride, q0, kRows, T_len);
  const int kv_end = key_span(pos + (long long)b * T_len, q0, kRows, T_len, s_pos, s_span);
  const int n_tiles = (kv_end + KT - 1) / KT;
  load_rows<T, HD>(ks, k, kbase, kstride, 0, KT, T_len);
  load_rows<T, HD>(vs, v, kbase, kstride, 0, KT, T_len);
  cp_async_commit();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int ra = warp * 16 + lane / 4;
  int prow[2];
  float lrow[2], drow[2];
  bool vrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ra + 8 * i;
    vrow[i] = row < T_len;
    prow[i] = s_pos[ra + 8 * i];
    const long long at = ((long long)b * H + h) * T_len + row;
    lrow[i] = vrow[i] ? lse[at] : 0.f;
    drow[i] = vrow[i] ? D[at] : 0.f;
  }
  float* wscratch = scratch + warp * 16 * (KT + 4);
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<T, HD>(ks + (buf ^ 1) * KT * S, k, kbase, kstride, (j + 1) * KT, KT, T_len);
      load_rows<T, HD>(vs + (buf ^ 1) * KT * S, v, kbase, kstride, (j + 1) * KT, KT, T_len);
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
    warp_nt<T, NT, HD>(s, qs + warp * 16 * S, ks + buf * KT * S, lane);
    warp_nt<T, NT, HD>(dp, dos + warp * 16 * S, vs + buf * KT * S, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * KT + n * 8 + (lane % 4) * 2 + (e & 1);
        const int i = e / 2;
        const bool live = vrow[i] && kj < T_len && prow[i] >= 0 && kj <= prow[i];
        const float prob = live ? exp_of<T>(round_in<T>(s[n][e]) * scale - lrow[i]) : 0.f;
        s[n][e] = live ? prob * (dp[n][e] - drow[i]) * scale : 0.f;
      }
    warp_nn<T, NT, HD>(acc, s, ks + buf * KT * S, wscratch, lane);  // dQ += dS K
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!vrow[half]) continue;
    T* dst = dq + qbase + (long long)(q0 + ra + 8 * half) * qstride + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2<T>(dst + n * 8, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above 48 KB only after an opt-in
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* pos, void* out,
               void* out_lo, float* lse, int B, int T_len, int H, int KVH, float scale,
               cudaStream_t s) {
  constexpr size_t smem = fwd_smem<T, HD>();
  cudaError_t e = set_smem((const void*)dense_attention_fwd_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + kRows - 1) / kRows, H, B);
  dense_attention_fwd_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), static_cast<T*>(out_lo), lse, T_len, H, KVH, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const int* pos, const void* out,
               const void* out_lo, const void* dout, const float* lse, float* D, void* dq,
               void* dk, void* dv, int B, int T_len, int H, int KVH, float scale,
               cudaStream_t s) {
  const long long rows = (long long)B * T_len * H;
  dense_attention_pre_kernel<T, HD><<<(unsigned)((rows + kPreWarps - 1) / kPreWarps),
                                       kPreWarps * kWarp, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(out_lo), static_cast<const T*>(dout),
      D, rows, T_len, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int n_qt = (T_len + kBwdTile - 1) / kBwdTile;
  const size_t dkv = dkv_smem_fixed<T, HD>() + sizeof(unsigned) * ((n_qt + 31) / 32);
  e = set_smem((const void*)dense_attention_dkv_kernel<T, HD>, dkv);
  if (e != cudaSuccess) return (int)e;
  dense_attention_dkv_kernel<T, HD><<<dim3((T_len + kRows - 1) / kRows, KVH, B), kThreads,
                                      dkv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dk), static_cast<T*>(dv), T_len,
      H, KVH, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t dqs = dq_smem<T, HD>();
  e = set_smem((const void*)dense_attention_dq_kernel<T, HD>, dqs);
  if (e != cudaSuccess) return (int)e;
  dense_attention_dq_kernel<T, HD><<<dim3((T_len + kRows - 1) / kRows, H, B), kThreads, dqs,
                                     s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dq), T_len, H, KVH, scale);
  return (int)cudaGetLastError();
}

bool args_ok(int dtype, int head_dim, int B, int T_len, int H, int KVH) {
  return (dtype == 0 || dtype == 1) && (head_dim == 16 || head_dim == 64 || head_dim == 128) &&
         B >= 1 && B <= 65535 && T_len >= 1 && H >= 1 && H <= 65535 && KVH >= 1 &&
         H % KVH == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 64 or 128.  Every pointer is
// a contiguous tensor of the layouts above on the stream's device (out_lo
// may be null: no residual is written); scale is 1/sqrt(head_dim).  Returns
// the launch's cudaGetLastError() (0 = cudaSuccess); the caller checks every
// argument.
extern "C" int dense_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* pos, void* out, void* out_lo,
                                   void* lse, int B, int T_len, int H, int KVH, float scale,
                                   void* stream) {
  if (!args_ok(dtype, head_dim, B, T_len, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* l = static_cast<float*>(lse);
#define CORDUM_FWD(TYPE, HD) \
  return launch_fwd<TYPE, HD>(q, k, v, p, out, out_lo, l, B, T_len, H, KVH, scale, s)
  if (dtype == 0) {
    if (head_dim == 16) CORDUM_FWD(float, 16);
    if (head_dim == 64) CORDUM_FWD(float, 64);
    CORDUM_FWD(float, 128);
  }
  if (head_dim == 16) CORDUM_FWD(bf16, 16);
  if (head_dim == 64) CORDUM_FWD(bf16, 64);
  CORDUM_FWD(bf16, 128);
#undef CORDUM_FWD
}

// The backward: the pre-pass into D (fp32 [B, H, T] scratch the caller
// allocates; out_lo as the forward wrote it, or null), then dK/dV and dQ, all
// on `stream`.
extern "C" int dense_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* pos, const void* out,
                                   const void* out_lo, const void* dout, const void* lse,
                                   void* D, void* dq, void* dk, void* dv, int B, int T_len,
                                   int H, int KVH, float scale, void* stream) {
  if (!args_ok(dtype, head_dim, B, T_len, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
#define CORDUM_BWD(TYPE, HD)                                                                 \
  return launch_bwd<TYPE, HD>(q, k, v, p, out, out_lo, dout, l, d, dq, dk, dv, B, T_len, H, \
                              KVH, scale, s)
  if (dtype == 0) {
    if (head_dim == 16) CORDUM_BWD(float, 16);
    if (head_dim == 64) CORDUM_BWD(float, 64);
    CORDUM_BWD(float, 128);
  }
  if (head_dim == 16) CORDUM_BWD(bf16, 16);
  if (head_dim == 64) CORDUM_BWD(bf16, 64);
  CORDUM_BWD(bf16, 128);
#undef CORDUM_BWD
}
