// Ragged paged GQA attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the gather-and-attend core of the JAX package's ragged serving
// step (cordum_tpu/models/llama.py, ragged_step: `k_pages[li][pt_tok]`
// followed by `_attention(..., q_offset=pos2)`), which materialises every
// token's whole page-table row, [T, P*ps, kvh, hd], per layer.  Here each
// token reads only the pages its position reaches.
//
// Bound: device-memory bytes.  The work is the K/V pages each sequence
// needs, counted once, over 3.35 TB/s; the arithmetic (4*hd flops per key
// and query head) is far below the card's rate at any batch this step runs.
//
// Design (the simple one):
//   * one block per (token, kv head, split); one warp per query head of the
//     GQA group, so each K/V page is staged through shared memory once per
//     block and read by all the query heads that share it;
//   * a token's pages 0 .. pos / page_size are cut into at most n_splits
//     contiguous runs, one per block (the run length follows the token's
//     own position, so short rows use few blocks and long rows many); each
//     block streams its run through a ring of kStages shared-memory stages
//     filled with cp.async, so the next pages' loads are in flight while a
//     page is computed;
//   * per page, a warp scores up to 16 keys at once (lanes over head dims,
//     the 16 warp reductions interleaved), then does one online softmax
//     update (running max, running sum) and the PV accumulation; scores,
//     softmax and accumulator are fp32;
//   * each block writes its unnormalised partial (acc, max, sum) to fp32
//     scratch, and a second kernel merges a token's partials per head.
// Not done yet: tensor-core products, TMA, a persistent schedule.
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
//   token_seq    [T] int32  (row of page_tables of each token)
//   positions    [T] int32  (attends to keys 0 .. positions[t])
//   out          [T, n_heads, HD]
//   scratch      [T, n_heads, n_splits, HD + 2] fp32: acc, max, sum
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kStages = 4;      // pages in flight per block
constexpr int kKeyChunk = 16;   // keys scored together by one warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// Stage page `page`'s K and V rows of kv head g into one smem stage:
// [page_size, HD] each, row j at j * HD.  16-byte chunks, all threads.
template <typename T, int HD>
__device__ __forceinline__ void load_page(T* ks, T* vs, const T* k_pages,
                                          const T* v_pages, int page, int g,
                                          int page_size, int n_kv_heads) {
  constexpr int kChunk = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int kChunksPerRow = HD / kChunk;
  const int n = page_size * kChunksPerRow;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int j = c / kChunksPerRow;
    const int d = (c - j * kChunksPerRow) * kChunk;
    const size_t off = (((size_t)page * page_size + j) * n_kv_heads + g) * HD + d;
    cp_async16(ks + j * HD + d, k_pages + off);
    cp_async16(vs + j * HD + d, v_pages + off);
  }
}

// pages of token t's row (0 .. n_pages) and the run length of one split
__device__ __forceinline__ void row_split(int pos, int page_size,
                                          int pages_per_seq, int n_splits,
                                          int* n_pages, int* span) {
  *n_pages = min(pos / page_size + 1, pages_per_seq);
  *span = (*n_pages + n_splits - 1) / n_splits;
}

template <typename T, int HD>
__global__ void paged_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_tables,
    const int* __restrict__ token_seq, const int* __restrict__ positions,
    float* __restrict__ part, int n_heads, int n_kv_heads, int page_size,
    int pages_per_seq, int n_splits, float scale) {
  constexpr int kDims = (HD + kWarp - 1) / kWarp;  // head dims per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = 2 * page_size * HD;  // K then V

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int head = g * (n_heads / n_kv_heads) + warp;
  const int pos = positions[t];
  int n_row, span;
  row_split(pos, page_size, pages_per_seq, n_splits, &n_row, &span);
  const int first = blockIdx.z * span;  // this block's run: first .. +n_pages
  if (first >= n_row) return;           // the whole block: no run left
  const int n_pages = min(span, n_row - first);
  const int* table =
      page_tables + (size_t)token_seq[t] * pages_per_seq + first;

  // prologue: the first kStages - 1 pages in flight (one commit group each,
  // empty past the row's end, so the group count stays uniform)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_pages) {
      T* st = smem + s * stage_elems;
      load_page<T, HD>(st, st + page_size * HD, k_pages, v_pages, table[s], g,
                       page_size, n_kv_heads);
    }
    cp_async_commit();
  }

  // this lane's head dims: lane, lane + 32, ...; query row and accumulator
  float qr[kDims];
  float acc[kDims];
  const T* qrow = q + ((size_t)t * n_heads + head) * HD;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = lane + i * kWarp;
    qr[i] = d < HD ? to_f(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores seen so far
  float l = 0.f;        // running sum of exp(score - m)

  for (int p = 0; p < n_pages; ++p) {
    cp_async_wait_stages();  // page p has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; stage p-1 is free
    const int nxt = p + kStages - 1;
    if (nxt < n_pages) {
      T* st = smem + (nxt % kStages) * stage_elems;
      load_page<T, HD>(st, st + page_size * HD, k_pages, v_pages, table[nxt],
                       g, page_size, n_kv_heads);
    }
    cp_async_commit();

    const T* ks = smem + (p % kStages) * stage_elems;
    const T* vs = ks + page_size * HD;
    const int n_keys = min(page_size, pos - (first + p) * page_size + 1);
    for (int j0 = 0; j0 < n_keys; j0 += kKeyChunk) {
      float s[kKeyChunk];
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        float dot = 0.f;
        if (j0 + jj < n_keys) {
          const T* kr = ks + (j0 + jj) * HD;
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            const int d = lane + i * kWarp;
            if (d < HD) dot = fmaf(qr[i], to_f(kr[d]), dot);
          }
        }
        s[jj] = dot;
      }
      // the chunk's warp reductions, interleaved level by level
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int jj = 0; jj < kKeyChunk; ++jj)
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], o);
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        s[jj] = j0 + jj < n_keys ? s[jj] * scale : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        if (j0 + jj < n_keys) {  // masked keys are skipped, never multiplied
          const float w = expf(s[jj] - m_new);
          l += w;
          const T* vr = vs + (j0 + jj) * HD;
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            const int d = lane + i * kWarp;
            if (d < HD) acc[i] = fmaf(w, to_f(vr[d]), acc[i]);
          }
        }
      }
      m = m_new;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float* prow =
      part + (((size_t)t * n_heads + head) * n_splits + blockIdx.z) * (HD + 2);
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = lane + i * kWarp;
    if (d < HD) prow[d] = acc[i];
  }
  if (lane == 0) {
    prow[HD] = m;
    prow[HD + 1] = l;
  }
}

// Merge token t's partials for one query head: one thread per head dim.
template <typename T, int HD>
__global__ void paged_attention_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ positions,
    T* __restrict__ out, int n_heads, int page_size, int pages_per_seq,
    int n_splits) {
  const int t = blockIdx.x;
  const int head = blockIdx.y;
  const int d = threadIdx.x;
  int n_row, span;
  row_split(positions[t], page_size, pages_per_seq, n_splits, &n_row, &span);
  const int n_active = (n_row + span - 1) / span;
  const float* prow = part + ((size_t)t * n_heads + head) * n_splits * (HD + 2);
  float m = -INFINITY;
  for (int z = 0; z < n_active; ++z) m = fmaxf(m, prow[z * (HD + 2) + HD]);
  float l = 0.f, o = 0.f;
  for (int z = 0; z < n_active; ++z) {
    const float* pz = prow + z * (HD + 2);
    const float w = expf(pz[HD] - m);
    l = fmaf(w, pz[HD + 1], l);
    o = fmaf(w, pz[d], o);
  }
  store_f(out + ((size_t)t * n_heads + head) * HD + d, o / l);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pt,
                   const void* ts, const void* pos, void* out, void* scratch,
                   int n_tokens, int n_heads, int n_kv_heads, int page_size,
                   int pages_per_seq, int n_splits, cudaStream_t stream) {
  const dim3 grid(n_tokens, n_kv_heads, n_splits);
  const dim3 block((n_heads / n_kv_heads) * kWarp);
  const size_t smem = (size_t)kStages * 2 * page_size * HD * sizeof(T);
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  float* part = static_cast<float*>(scratch);
  paged_attention_split_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(ts), static_cast<const int*>(pos), part,
      n_heads, n_kv_heads, page_size, pages_per_seq, n_splits,
      1.f / sqrtf((float)HD));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attention_combine_kernel<T, HD><<<dim3(n_tokens, n_heads), HD, 0, stream>>>(
      part, static_cast<const int*>(pos), static_cast<T*>(out), n_heads,
      page_size, pages_per_seq, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k,
                      const void* v, const void* pt, const void* ts,
                      const void* pos, void* out, void* scratch, int n_tokens,
                      int n_heads, int n_kv_heads, int page_size,
                      int pages_per_seq, int n_splits, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, pt, ts, pos, out, scratch, n_tokens,
                           n_heads, n_kv_heads, page_size, pages_per_seq,
                           n_splits, stream);
    case 128:
      return launch<T, 128>(q, k, v, pt, ts, pos, out, scratch, n_tokens,
                            n_heads, n_kv_heads, page_size, pages_per_seq,
                            n_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16 or 128; scratch holds
// [n_tokens, n_heads, n_splits, head_dim + 2] floats.  Returns the launches'
// cudaGetLastError() (0 = cudaSuccess); the caller checks every argument.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* token_seq, const void* positions,
    void* out, void* scratch, int n_tokens, int n_heads, int n_kv_heads,
    int head_dim, int page_size, int pages_per_seq, int n_splits,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    e = launch_hd<float>(head_dim, q, k_pages, v_pages, page_tables, token_seq,
                         positions, out, scratch, n_tokens, n_heads,
                         n_kv_heads, page_size, pages_per_seq, n_splits, s);
  } else if (dtype == 1) {
    e = launch_hd<__nv_bfloat16>(head_dim, q, k_pages, v_pages, page_tables,
                                 token_seq, positions, out, scratch, n_tokens,
                                 n_heads, n_kv_heads, page_size, pages_per_seq,
                                 n_splits, s);
  }
  return (int)e;
}
