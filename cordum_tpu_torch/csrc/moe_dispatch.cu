// Top-k routing, capacity-bounded dispatch and weighted combine of the
// Mixture-of-Experts FFN, for Hopper (sm_90a), bound with ctypes.
//
// Replaces the routing and data movement of the JAX package's MoE FFN
// (cordum_tpu/models/moe.py, moe_ffn, lines 80-107): lax.top_k over the
// fp32 router probabilities, each (token, slot)'s position in its expert's
// queue from an exclusive cumsum of the one-hot mask in (token, slot) order,
// the capacity drop, and the dispatch and combine einsums against the dense
// one-hot tensor [N, k, E, C] (`nkec,nd->ecd` and `nkec,ecd->nd`, fp32) with
// their gradients.  XLA runs those einsums as products over the one-hot
// tensor: 2 N k E C D operations each (2.75e12 at Mixtral-8x7B's layer
// widths: N 8192, k 2, E 8, C 2560, D 4096) to move a few hundred MB of
// rows.  Here they are what they compute: gathers.
//
// Three kernel bodies:
//   * moe_route_kernel — one block per expert e walks the tokens in order,
//     a chunk of blockDim tokens at a time.  A token picks e at slot s when
//     e's rank in the token's row is s < k, the rank being the number of
//     experts before e in descending order with ties to the lower index
//     (lax.top_k's order; NaN counts as the largest value, as in
//     torch.sort): so every (token, slot) is written by exactly one block.
//     The chunk's picks are numbered by a ballot scan across the block, the
//     count carried from chunk to chunk in registers: that is the
//     reference's exclusive cumsum in (token, slot) order (a token holds an
//     expert in at most one slot).  No atomics: two calls give the same
//     bits.  Writes idx, pos (the queue position before capacity), keep =
//     pos < C, counts[e] (hits before capacity), and slot_token / slot_k
//     (the token and slot of each kept capacity row, -1 in the rows past
//     the expert's kept count).
//   * moe_slot_gather_kernel — one warp per capacity row (e, c): the row is
//     scale * src[slot_token[e, c]] in fp32, rounded to the dtype, or zeros
//     where the row is empty (the expert FFN runs over every row, and a NaN
//     left in an empty row would reach the weights' gradients through
//     NaN * 0).  Dispatch forward: scale 1, src the tokens.  Combine
//     backward (d_out): scale w[n, slot_k[e, c]], src dy.
//   * moe_token_gather_kernel — one warp per token n.  Mode 0: the fp32 sum
//     over the token's kept slots s, in slot order, of w[n, s] *
//     src[idx[n, s], pos[n, s]] (fmaf), rounded to the dtype.  Combine
//     forward: w the routing weights, src the expert outputs; dispatch
//     backward: w = 1, src d_expert_in.  Mode 1 (the combine backward's
//     d_w): dw[n, s] = keep * <dy[n], src[idx[n, s], pos[n, s]]>, fp32, each
//     lane's partial sum then a butterfly across the warp.
//
// Bound: the bytes.  At the widths above each gather moves one capacity
// buffer [E, C, D] and one token buffer [N, D] (bf16: 168 + 67 MB, about
// 0.07 ms at 3.35 TB/s); the route reads N E fp32 probabilities (0.26 MB)
// and is bound by its latency (one block per expert, N / blockDim chunks).
// Design for a first version that is right: 16-byte vector loads and stores
// along D (8 bf16 or 4 fp32 a lane; a scalar loop when D or a pointer does
// not allow them), a warp per row, no TMA, no shared-memory staging.
//
// Layouts (all contiguous): probs [N, E] fp32; idx, pos [N, k] int32; keep
// [N, k] uint8 (torch.bool); counts [E] int32; slot_token, slot_k [E, C]
// int32; w [N, k] fp32; tokens, dy, y [N, D] and the capacity buffers
// [E, C, D] in the dtype (0 fp32, 1 bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRouteThreads = 1024;
constexpr int kRowsPerBlock = 8;  // warps a gather block, one row each
constexpr int kGatherThreads = kRowsPerBlock * kWarp;
constexpr unsigned kFull = 0xffffffffu;

// True when value a at index ia comes before value b at index ib in
// lax.top_k's descending order (ties to the lower index; NaN largest).
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const float* __restrict__ probs, int N, int E, int k, int C,
                 int* __restrict__ idx, int* __restrict__ pos,
                 uint8_t* __restrict__ keep, int* __restrict__ counts,
                 int* __restrict__ slot_token, int* __restrict__ slot_k) {
  __shared__ int warp_incl[kRouteThreads / kWarp];
  __shared__ int chunk_total;
  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  int base = 0;  // picks of e by the tokens of earlier chunks
  for (int start = 0; start < N; start += blockDim.x) {
    const int n = start + tid;
    int slot = -1;
    if (n < N) {
      const float* row = probs + (size_t)n * E;
      const float pe = row[e];
      int rank = 0;
      for (int j = 0; j < E; ++j) rank += before(row[j], j, pe, e) ? 1 : 0;
      if (rank < k) slot = rank;
    }
    const unsigned picks = __ballot_sync(kFull, slot >= 0);
    const int in_warp = __popc(picks & ((1u << lane) - 1u));
    if (lane == 0) warp_incl[warp] = __popc(picks);
    __syncthreads();
    if (warp == 0) {
      int v = lane < n_warps ? warp_incl[lane] : 0;
      for (int o = 1; o < kWarp; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      if (lane < n_warps) warp_incl[lane] = v;
      if (lane == kWarp - 1) chunk_total = v;
    }
    __syncthreads();
    if (slot >= 0) {
      const int p = base + (warp ? warp_incl[warp - 1] : 0) + in_warp;
      const size_t at = (size_t)n * k + slot;
      idx[at] = e;
      pos[at] = p;
      keep[at] = p < C ? 1 : 0;
      if (p < C) {
        slot_token[(size_t)e * C + p] = n;
        slot_k[(size_t)e * C + p] = slot;
      }
    }
    base += chunk_total;
    __syncthreads();  // warp_incl and chunk_total are rewritten next chunk
  }
  if (tid == 0) counts[e] = base;
  for (int c = min(base, C) + tid; c < C; c += blockDim.x) {
    slot_token[(size_t)e * C + c] = -1;
    slot_k[(size_t)e * C + c] = -1;
  }
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte vector of T: kVec elements.
template <typename T> struct alignas(16) Vec {
  static constexpr int kVec = 16 / sizeof(T);
  T v[kVec];
};
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  Vec<T> out;
  *reinterpret_cast<uint4*>(out.v) = __ldg(reinterpret_cast<const uint4*>(p));
  return out;
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& x) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(x.v);
}

template <typename T, bool kScaled, bool kVectors>
__global__ void __launch_bounds__(kGatherThreads)
moe_slot_gather_kernel(const T* __restrict__ src, const int* __restrict__ slot_token,
                       const int* __restrict__ slot_k, const float* __restrict__ w, int k,
                       T* __restrict__ out, long long rows, int D) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  T* o = out + row * D;
  const int n = slot_token[row];
  constexpr int V = Vec<T>::kVec;
  if (n < 0) {  // an empty capacity row: zeros, never what the allocator left
    if (kVectors) {
      Vec<T> z;
#pragma unroll
      for (int i = 0; i < V; ++i) z.v[i] = from_f32<T>(0.f);
      for (int c = lane; c < D / V; c += kWarp) store_vec(o + c * V, z);
    } else {
      for (int c = lane; c < D; c += kWarp) o[c] = from_f32<T>(0.f);
    }
    return;
  }
  const T* s = src + (size_t)n * D;
  const float scale = kScaled ? w[(size_t)n * k + slot_k[row]] : 1.f;
  if (kVectors) {
    for (int c = lane; c < D / V; c += kWarp) {
      Vec<T> x = load_vec(s + c * V);
      if (kScaled) {
#pragma unroll
        for (int i = 0; i < V; ++i) x.v[i] = from_f32<T>(to_f32(x.v[i]) * scale);
      }
      store_vec(o + c * V, x);
    }
  } else {
    for (int c = lane; c < D; c += kWarp) {
      o[c] = kScaled ? from_f32<T>(to_f32(s[c]) * scale) : s[c];
    }
  }
}

// Mode 0: out[n] = sum_s keep w src[row_s] (w null: 1).  Mode 1:
// dw[n, s] = keep <dy[n], src[row_s]>.
template <typename T, int kMode, bool kVectors>
__global__ void __launch_bounds__(kGatherThreads)
moe_token_gather_kernel(const T* __restrict__ src, const T* __restrict__ dy,
                        const int* __restrict__ idx, const int* __restrict__ pos,
                        const uint8_t* __restrict__ keep, const float* __restrict__ w,
                        int N, int k, int C, int D, T* __restrict__ out,
                        float* __restrict__ dw) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int n = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (n >= N) return;
  const size_t at = (size_t)n * k;
  constexpr int V = Vec<T>::kVec;
  if (kMode == 0) {
    T* o = out + (size_t)n * D;
    if (kVectors) {
      for (int c = lane; c < D / V; c += kWarp) {
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.f;
        for (int s = 0; s < k; ++s) {
          if (!keep[at + s]) continue;
          const float ws = w ? w[at + s] : 1.f;
          const T* r = src + ((size_t)idx[at + s] * C + pos[at + s]) * D;
          const Vec<T> x = load_vec(r + c * V);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(ws, to_f32(x.v[i]), acc[i]);
        }
        Vec<T> y;
#pragma unroll
        for (int i = 0; i < V; ++i) y.v[i] = from_f32<T>(acc[i]);
        store_vec(o + c * V, y);
      }
    } else {
      for (int c = lane; c < D; c += kWarp) {
        float acc = 0.f;
        for (int s = 0; s < k; ++s) {
          if (!keep[at + s]) continue;
          const float ws = w ? w[at + s] : 1.f;
          acc = fmaf(ws, to_f32(src[((size_t)idx[at + s] * C + pos[at + s]) * D + c]), acc);
        }
        o[c] = from_f32<T>(acc);
      }
    }
    return;
  }
  const T* g = dy + (size_t)n * D;
  for (int s = 0; s < k; ++s) {
    float part = 0.f;
    if (keep[at + s]) {
      const T* r = src + ((size_t)idx[at + s] * C + pos[at + s]) * D;
      if (kVectors) {
        for (int c = lane; c < D / V; c += kWarp) {
          const Vec<T> a = load_vec(g + c * V);
          const Vec<T> b = load_vec(r + c * V);
#pragma unroll
          for (int i = 0; i < V; ++i) part = fmaf(to_f32(a.v[i]), to_f32(b.v[i]), part);
        }
      } else {
        for (int c = lane; c < D; c += kWarp) part = fmaf(to_f32(g[c]), to_f32(r[c]), part);
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    if (lane == 0) dw[at + s] = part;
  }
}

// 16-byte vectors need D a whole number of them and 16-byte aligned rows.
bool vectors_fit(int D, int elem, const void* a, const void* b) {
  return (D * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

unsigned blocks_for(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
int slot_gather(const void* src, const int* slot_token, const int* slot_k, const float* w,
                int k, void* out, long long rows, int D, cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const unsigned grid = blocks_for(rows);
  const bool vec = vectors_fit(D, sizeof(T), src, out);
  if (w != nullptr) {
    if (vec) moe_slot_gather_kernel<T, true, true><<<grid, kGatherThreads, 0, s>>>(x, slot_token, slot_k, w, k, o, rows, D);
    else moe_slot_gather_kernel<T, true, false><<<grid, kGatherThreads, 0, s>>>(x, slot_token, slot_k, w, k, o, rows, D);
  } else {
    if (vec) moe_slot_gather_kernel<T, false, true><<<grid, kGatherThreads, 0, s>>>(x, slot_token, slot_k, w, k, o, rows, D);
    else moe_slot_gather_kernel<T, false, false><<<grid, kGatherThreads, 0, s>>>(x, slot_token, slot_k, w, k, o, rows, D);
  }
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int token_gather(const void* src, const void* dy, const int* idx, const int* pos,
                 const uint8_t* keep, const float* w, int N, int k, int C, int D, void* out,
                 float* dw, cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  const T* g = static_cast<const T*>(dy);
  T* o = static_cast<T*>(out);
  const unsigned grid = blocks_for(N);
  const bool vec = vectors_fit(D, sizeof(T), src, kMode == 0 ? out : dy);
  if (vec) moe_token_gather_kernel<T, kMode, true><<<grid, kGatherThreads, 0, s>>>(x, g, idx, pos, keep, w, N, k, C, D, o, dw);
  else moe_token_gather_kernel<T, kMode, false><<<grid, kGatherThreads, 0, s>>>(x, g, idx, pos, keep, w, N, k, C, D, o, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// Routing of fp32 probs [N, E] to top-k experts with capacity C.
extern "C" int moe_route(const void* probs, int N, int E, int k, int C, void* idx, void* pos,
                         void* keep, void* counts, void* slot_token, void* slot_k,
                         void* stream) {
  if (N < 1 || E < 1 || k < 1 || k > E || C < 1) return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<E, kRouteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), N, E, k, C, static_cast<int*>(idx),
      static_cast<int*>(pos), static_cast<uint8_t*>(keep), static_cast<int*>(counts),
      static_cast<int*>(slot_token), static_cast<int*>(slot_k));
  return (int)cudaGetLastError();
}

// out [rows, D] = (w ? w[n, slot_k] : 1) * src[slot_token] per row, zeros
// where slot_token < 0; w [N, k] or null.
extern "C" int moe_slot_gather(int dtype, const void* src, const void* slot_token,
                               const void* slot_k, const void* w, int k, void* out,
                               long long rows, int D, void* stream) {
  if (rows < 1 || D < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(slot_token);
  const int* sk = static_cast<const int*>(slot_k);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return slot_gather<float>(src, st, sk, wf, k, out, rows, D, s);
  if (dtype == 1) return slot_gather<__nv_bfloat16>(src, st, sk, wf, k, out, rows, D, s);
  return (int)cudaErrorInvalidValue;
}

// out [N, D] = sum over kept slots of (w ? w : 1) * src [E * C, D] rows.
extern "C" int moe_token_gather(int dtype, const void* src, const void* idx, const void* pos,
                                const void* keep, const void* w, int N, int k, int C, int D,
                                void* out, void* stream) {
  if (N < 1 || k < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  const int* ps = static_cast<const int*>(pos);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return token_gather<float, 0>(src, nullptr, ix, ps, kp, wf, N, k, C, D, out, nullptr, s);
  if (dtype == 1)
    return token_gather<__nv_bfloat16, 0>(src, nullptr, ix, ps, kp, wf, N, k, C, D, out,
                                          nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// dw [N, k] fp32 = keep * <dy[n], src row of (idx, pos)>.
extern "C" int moe_token_dot(int dtype, const void* dy, const void* src, const void* idx,
                             const void* pos, const void* keep, int N, int k, int C, int D,
                             void* dw, void* stream) {
  if (N < 1 || k < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  const int* ps = static_cast<const int*>(pos);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  float* d = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return token_gather<float, 1>(src, dy, ix, ps, kp, nullptr, N, k, C, D, nullptr, d, s);
  if (dtype == 1)
    return token_gather<__nv_bfloat16, 1>(src, dy, ix, ps, kp, nullptr, N, k, C, D, nullptr,
                                          d, s);
  return (int)cudaErrorInvalidValue;
}
