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
// Four kernel bodies:
//   * moe_route_pick_kernel and moe_route_place_kernel — the route, two
//     launches over tiles of kRouteTile tokens, a thread a token.  Pick:
//     the tile's rows go to shared memory ([E][kRouteTile], so a warp's
//     reads are conflict-free); k passes over a row find the token's picks
//     in lax.top_k's order (descending, ties to the lower index, NaN the
//     largest, as in torch.sort), each the first expert after the last:
//     idx.  The token picks e when e is not after its k-th pick; its
//     position among its tile's picks of e is numbered in token order by a
//     ballot a warp and the counts of the earlier warps (the tile's share
//     of the reference's exclusive cumsum in (token, slot) order: a token
//     holds an expert in at most one slot), stored at slot rank(e); the
//     tile's count of each expert goes to a scratch table [n_tiles, E].
//     Place: each tile adds the sum of the earlier tiles' counts to its
//     positions and writes pos (the queue position before capacity), keep
//     = pos < C, slot_token / slot_k (the token and slot of each kept
//     capacity row); from the table's totals, counts[e] (hits before
//     capacity) and -1 in the rows past the expert's kept count, spread
//     over the grid.  The place launch is the pick's programmatic
//     dependent (Hopper): its blocks start while the pick runs and wait at
//     griddepcontrol.wait for its writes, so no launch gap sits between
//     the two.  A data-parallel rank routes with a room [E]: the rows of
//     each expert's queue that the lower dp ranks' tokens leave it,
//     max(0, C - prefix[e]) (the reference routes the whole batch at once,
//     dp rank r's tokens behind every lower rank's).  Its pairs keep while
//     pos < min(room[e], C), rows stay local (row pos of expert e, filled
//     from 0 up) and the empty rows start at min(counts[e], room[e]).  The
//     prefix needs every rank's counts, which the pick computes, so such a
//     route is two host entries, pick then place, with the caller's
//     all-gather of the counts between them; without a room the pair
//     launches as before.  Experts are numbered 32 at a time; a row must fit in
//     shared memory (kRouteMaxExperts).  No atomics, nothing depends on the
//     order the blocks run in: two calls give the same bits.
//   * moe_slot_gather_kernel — token-major: one block a token n reads
//     src[n] once and writes it to each kept slot's capacity row
//     (idx[n, s], pos[n, s]), times w[n, s] in fp32 rounded to the dtype in
//     the scaled mode; a token with no kept slot is not read.  The grid's
//     first blocks write the empty rows (c >= min(counts[e], C), or
//     min(counts[e], room[e]) under a room) as zeros
//     (the expert FFN runs over every row, and a NaN left in an empty row
//     would reach the weights' gradients through NaN * 0).  Each row is
//     written by one block.  Dispatch forward: w null, src the tokens.
//     Combine backward (d_out): w the routing weights, src dy.
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
// 0.07 ms at 3.35 TB/s).  A capacity-major slot gather (a warp a capacity
// row) reads a token once a kept slot: 134 MB where the bound counts 67.
// Token-major, each routed token is read once; a token with more than 32
// kept slots is read once a group of 32.  A block of kSlotThreads holds
// kSlotUnroll 16-byte vectors a thread (a bf16 row of 4096 in one pass)
// and stores them to every kept row: many short blocks, several waves of
// them on the card.  A warp a token walking its row in the same chunk
// order as every other warp ran twice as slow (bf16 at N 8192: all 1024
// blocks resident at once, every warp at the same offset of its row at
// the same time).  The zero-row blocks come first in the grid, so they
// run beside the token blocks and not after them.  The route reads N E
// fp32 probabilities (0.26 MB) and is bound by its latency: two launches
// of N / kRouteTile blocks (64 at N 8192), each block one step deep,
// against one block an expert walking every token; a thread's work is
// O(k E) compares from shared memory.  The place pass sums
// a column of the count table a block, so its reads grow as n_tiles^2 E
// (2 KB a block at N 8192).  The token gathers: 16-byte vector loads and
// stores along D (8 bf16 or 4 fp32 a lane; a scalar loop when D or a
// pointer does not allow them), a warp a token.
//
// Layouts (all contiguous): probs [N, E] fp32; idx, pos [N, k] int32; keep
// [N, k] uint8 (torch.bool); counts, room [E] int32 (room may be null);
// slot_token, slot_k [E, C] int32; tile_counts [n_tiles, E] int32 scratch; w [N, k] fp32; tokens,
// dy, y [N, D] and the capacity buffers [E, C, D] in the dtype (0 fp32, 1
// bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kRouteTile = 128;  // tokens a route block, a thread each
constexpr int kRouteWarps = kRouteTile / kWarp;
constexpr int kExpertChunk = kWarp;  // experts numbered a pass over shared memory
// a route block's rows in shared memory, E kRouteTile fp32, within the
// 227 KB a block can have
constexpr int kRouteMaxExperts = 448;
constexpr int kRowsPerBlock = 8;  // warps a token-gather block, a token each
constexpr int kGatherThreads = kRowsPerBlock * kWarp;
constexpr int kSlotThreads = 128;  // a slot-gather block: one token
constexpr int kSlotUnroll = 4;  // 16-byte vectors a thread a pass (a bf16 row of 4096: one)
constexpr int kZeroBlocks = 256;  // slot-gather blocks writing the empty rows
constexpr unsigned kFull = 0xffffffffu;

// True when value a at index ia comes before value b at index ib in
// lax.top_k's descending order (ties to the lower index; NaN largest).
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// Expert e's place in its token's descending order (row[j] at stride
// kRouteTile): the slot it takes when that is < k.
__device__ __forceinline__ int rank_of(const float* row, int E, int e) {
  const float pe = row[e * kRouteTile];
  int rank = 0;
  for (int j = 0; j < E; ++j) rank += before(row[j * kRouteTile], j, pe, e) ? 1 : 0;
  return rank;
}

// Dynamic shared memory: each token's row, [E][kRouteTile] floats.
__global__ void __launch_bounds__(kRouteTile)
moe_route_pick_kernel(const float* __restrict__ probs, int N, int E, int k,
                      int* __restrict__ idx, int* __restrict__ pos,
                      int* __restrict__ tile_counts) {
  // the place launch may start now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ float rows[];
  __shared__ unsigned picks[kExpertChunk][kRouteWarps];  // a ballot an expert a warp
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int n = blockIdx.x * kRouteTile + tid;
  const bool valid = n < N;
  const float* row = rows + tid;
  // the k-th pick (kv, ki), k passes each taking the first expert after
  // the last in lax.top_k's order; a token picks e when e is not after it
  float kv = 0.f;
  int ki = -1;
  if (valid) {
    for (int j = 0; j < E; ++j) rows[j * kRouteTile + tid] = probs[(size_t)n * E + j];
    for (int s = 0; s < k; ++s) {
      float bv = 0.f;
      int bi = -1;
      for (int j = 0; j < E; ++j) {
        const float v = row[j * kRouteTile];
        if ((ki < 0 || before(kv, ki, v, j)) && (bi < 0 || before(v, j, bv, bi))) {
          bv = v;
          bi = j;
        }
      }
      idx[(size_t)n * k + s] = bi;
      kv = bv;
      ki = bi;
    }
  }
  const unsigned lower = (1u << lane) - 1u;
  for (int e0 = 0; e0 < E; e0 += kExpertChunk) {
    const int ne = min(kExpertChunk, E - e0);
    unsigned mine = 0;  // bit j: this token picks expert e0 + j
    for (int j = 0; j < ne; ++j) {
      const int e = e0 + j;
      const bool hit = valid && (e == ki || before(row[e * kRouteTile], e, kv, ki));
      const unsigned b = __ballot_sync(kFull, hit);
      if (lane == 0) picks[j][warp] = b;
      mine |= hit ? 1u << j : 0u;
    }
    __syncthreads();
    if (tid < ne) {
      int total = 0;
      for (int w = 0; w < kRouteWarps; ++w) total += __popc(picks[tid][w]);
      tile_counts[(size_t)blockIdx.x * E + e0 + tid] = total;
    }
    for (unsigned m = mine; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      int p = __popc(picks[j][warp] & lower);
      for (int w = 0; w < warp; ++w) p += __popc(picks[j][w]);
      // within the tile; the place pass adds the earlier tiles'
      pos[(size_t)n * k + rank_of(row, E, e0 + j)] = p;
    }
    __syncthreads();  // picks is rewritten for the next experts
  }
}

// The row limit of an expert: C, or its room (at most C) under a room.
__device__ __forceinline__ int row_limit(const int* room, int e, int C) {
  return room ? max(0, min(room[e], C)) : C;
}

// Launched as the pick kernel's programmatic dependent: it may start
// early and waits for the pick grid's writes before reading them (a
// no-op when it is launched alone, after the caller's exchange).
__global__ void __launch_bounds__(kRouteTile)
moe_route_place_kernel(int N, int E, int k, int C, const int* __restrict__ tile_counts,
                       int n_tiles, const int* __restrict__ room,
                       const int* __restrict__ idx, int* __restrict__ pos,
                       uint8_t* __restrict__ keep, int* __restrict__ counts,
                       int* __restrict__ slot_token, int* __restrict__ slot_k) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ int base[kExpertChunk], total[kExpertChunk], limit[kExpertChunk];
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int tile = blockIdx.x, n = tile * kRouteTile + tid;
  for (int e0 = 0; e0 < E; e0 += kExpertChunk) {
    const int ne = min(kExpertChunk, E - e0);
    // a warp an expert: the counts of the tiles before this one, and of all
    for (int j = warp; j < ne; j += kRouteWarps) {
      int earlier = 0, all = 0;
      for (int t = lane; t < n_tiles; t += kWarp) {
        const int c = tile_counts[(size_t)t * E + e0 + j];
        all += c;
        earlier += t < tile ? c : 0;
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        earlier += __shfl_xor_sync(kFull, earlier, o);
        all += __shfl_xor_sync(kFull, all, o);
      }
      if (lane == 0) {
        base[j] = earlier;
        total[j] = all;
        limit[j] = row_limit(room, e0 + j, C);
      }
    }
    __syncthreads();
    if (n < N) {
      for (int s = 0; s < k; ++s) {
        const size_t at = (size_t)n * k + s;
        const int j = idx[at] - e0;
        if (j < 0 || j >= ne) continue;
        const int p = base[j] + pos[at];
        pos[at] = p;
        keep[at] = p < limit[j] ? 1 : 0;
        if (p < limit[j]) {
          slot_token[(size_t)(e0 + j) * C + p] = n;
          slot_k[(size_t)(e0 + j) * C + p] = s;
        }
      }
    }
    if (tile == 0 && tid < ne) counts[e0 + tid] = total[tid];
    const int rows = ne * C;  // the empty rows: -1, over the grid (E C < 2^31)
    for (long long f = (long long)tile * kRouteTile + tid; f < rows;
         f += (long long)gridDim.x * kRouteTile) {
      const int j = (int)f / C, c = (int)f - j * C;
      if (c >= min(total[j], limit[j])) {
        slot_token[(size_t)(e0 + j) * C + c] = -1;
        slot_k[(size_t)(e0 + j) * C + c] = -1;
      }
    }
    __syncthreads();  // base, total and limit are rewritten for the next experts
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

template <typename T, bool kScaled>
__device__ __forceinline__ Vec<T> times(Vec<T> x, float scale) {
  if (kScaled) {
#pragma unroll
    for (int i = 0; i < Vec<T>::kVec; ++i) x.v[i] = from_f32<T>(to_f32(x.v[i]) * scale);
  }
  return x;
}

// Blocks [0, zero_blocks): the empty capacity rows (past min(counts, C), or
// min(counts, room) under a room), a warp a row over those blocks, zeros.  The rest: a block a token, src[n] to each kept
// slot's row (times w[n, s] when kScaled).
template <typename T, bool kScaled, bool kVectors>
__global__ void __launch_bounds__(kSlotThreads)
moe_slot_gather_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                       const int* __restrict__ pos, const uint8_t* __restrict__ keep,
                       const int* __restrict__ counts, const int* __restrict__ room,
                       const float* __restrict__ w, int k, int E, int C, int D,
                       int zero_blocks, T* __restrict__ out) {
  __shared__ long long rows[kWarp];  // the kept slots of a group of 32
  __shared__ float scales[kWarp];
  __shared__ int n_kept;
  constexpr int V = Vec<T>::kVec;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < zero_blocks) {  // zeros, never what the allocator left
    constexpr int kWarps = kSlotThreads / kWarp;
    const int lane = tid & (kWarp - 1), warp = tid / kWarp;
    for (long long r = (long long)blockIdx.x * kWarps + warp; r < (long long)E * C;
         r += (long long)zero_blocks * kWarps) {
      const int e = (int)r / C, c = (int)r - e * C;  // r < E C < 2^31
      if (c < min(counts[e], row_limit(room, e, C))) continue;  // a kept row
      T* o = out + r * D;
      if (kVectors) {
        Vec<T> z;
#pragma unroll
        for (int i = 0; i < V; ++i) z.v[i] = from_f32<T>(0.f);
        for (int i = lane; i < D / V; i += kWarp) store_vec(o + (size_t)i * V, z);
      } else {
        for (int i = lane; i < D; i += kWarp) o[i] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const int n = blockIdx.x - zero_blocks;
  const T* x = src + (size_t)n * D;
  for (int s0 = 0; s0 < k; s0 += kWarp) {  // one pass unless k > 32
    if (tid < kWarp) {  // the first warp lists the group's kept slots in slot order
      const int s = s0 + tid;
      long long row = -1;
      float scale = 1.f;
      if (s < k && keep[(size_t)n * k + s]) {
        row = (long long)idx[(size_t)n * k + s] * C + pos[(size_t)n * k + s];
        if (kScaled) scale = w[(size_t)n * k + s];
      }
      const unsigned kept = __ballot_sync(kFull, row >= 0);
      if (row >= 0) {
        const int j = __popc(kept & ((1u << tid) - 1u));
        rows[j] = row;
        scales[j] = scale;
      }
      if (tid == 0) n_kept = __popc(kept);
    }
    __syncthreads();
    const int m = n_kept;  // a token no expert keeps is not read
    if (kVectors) {
      const int nv = D / V;
      for (int c0 = tid; m && c0 < nv; c0 += kSlotThreads * kSlotUnroll) {
        Vec<T> v[kSlotUnroll];
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) {
          const int c = c0 + u * kSlotThreads;
          if (c < nv) v[u] = load_vec(x + (size_t)c * V);
        }
        for (int j = 0; j < m; ++j) {
          T* o = out + rows[j] * D;
          const float sc = scales[j];
#pragma unroll
          for (int u = 0; u < kSlotUnroll; ++u) {
            const int c = c0 + u * kSlotThreads;
            if (c < nv) store_vec(o + (size_t)c * V, times<T, kScaled>(v[u], sc));
          }
        }
      }
    } else {
      for (int c = tid; m && c < D; c += kSlotThreads) {
        const T v = x[c];
        for (int j = 0; j < m; ++j)
          out[rows[j] * D + c] = kScaled ? from_f32<T>(to_f32(v) * scales[j]) : v;
      }
    }
    __syncthreads();  // rows, scales and n_kept are rewritten for the next group
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
int slot_gather(const void* src, const int* idx, const int* pos, const uint8_t* keep,
                const int* counts, const int* room, const float* w, int N, int k, int E, int C,
                int D, void* out, cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const int zero = (int)std::min<long long>(((long long)E * C - 1) / (kSlotThreads / kWarp) + 1,
                                            kZeroBlocks);
  if (N > INT_MAX - zero) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(zero + N);
  const bool vec = vectors_fit(D, sizeof(T), src, out);
  if (w != nullptr) {
    if (vec) moe_slot_gather_kernel<T, true, true><<<grid, kSlotThreads, 0, s>>>(x, idx, pos, keep, counts, room, w, k, E, C, D, zero, o);
    else moe_slot_gather_kernel<T, true, false><<<grid, kSlotThreads, 0, s>>>(x, idx, pos, keep, counts, room, w, k, E, C, D, zero, o);
  } else {
    if (vec) moe_slot_gather_kernel<T, false, true><<<grid, kSlotThreads, 0, s>>>(x, idx, pos, keep, counts, room, w, k, E, C, D, zero, o);
    else moe_slot_gather_kernel<T, false, false><<<grid, kSlotThreads, 0, s>>>(x, idx, pos, keep, counts, room, w, k, E, C, D, zero, o);
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

bool route_shape_ok(int N, int E, int k, int n_tiles) {
  return N >= 1 && E >= 1 && E <= kRouteMaxExperts && k >= 1 && k <= E &&
         n_tiles == (N - 1) / kRouteTile + 1;
}

int launch_pick(const void* probs, int N, int E, int k, void* idx, void* pos,
                void* tile_counts, int n_tiles, cudaStream_t s) {
  const size_t smem = (size_t)E * kRouteTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      moe_route_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe_route_pick_kernel<<<n_tiles, kRouteTile, smem, s>>>(
      static_cast<const float*>(probs), N, E, k, static_cast<int*>(idx),
      static_cast<int*>(pos), static_cast<int*>(tile_counts));
  return (int)cudaGetLastError();
}

// dependent: as the pick launch's programmatic dependent (right after it).
int launch_place(int N, int E, int k, int C, void* idx, void* pos, void* keep, void* counts,
                 void* slot_token, void* slot_k, const void* tile_counts, int n_tiles,
                 const void* room, bool dependent, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles);
  cfg.blockDim = dim3(kRouteTile);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = dependent ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, moe_route_place_kernel, N, E, k, C, static_cast<const int*>(tile_counts), n_tiles,
      static_cast<const int*>(room), static_cast<const int*>(idx), static_cast<int*>(pos),
      static_cast<uint8_t*>(keep), static_cast<int*>(counts), static_cast<int*>(slot_token),
      static_cast<int*>(slot_k));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Routing of fp32 probs [N, E] to top-k experts with capacity C, the pick
// and place launches as a programmatic-dependent pair; tile_counts is
// [n_tiles, E] int32 scratch, n_tiles = ceil(N / kRouteTile).
extern "C" int moe_route(const void* probs, int N, int E, int k, int C, void* idx, void* pos,
                         void* keep, void* counts, void* slot_token, void* slot_k,
                         void* tile_counts, int n_tiles, void* stream) {
  if (!route_shape_ok(N, E, k, n_tiles) || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_pick(probs, N, E, k, idx, pos, tile_counts, n_tiles, s);
  if (err != 0) return err;
  return launch_place(N, E, k, C, idx, pos, keep, counts, slot_token, slot_k, tile_counts,
                      n_tiles, nullptr, true, s);
}

// The route's first half alone: idx, each slot's position within its tile,
// and the tiles' counts (their column sums are the counts a room is
// computed from).
extern "C" int moe_route_pick(const void* probs, int N, int E, int k, void* idx, void* pos,
                              void* tile_counts, int n_tiles, void* stream) {
  if (!route_shape_ok(N, E, k, n_tiles)) return (int)cudaErrorInvalidValue;
  return launch_pick(probs, N, E, k, idx, pos, tile_counts, n_tiles,
                     static_cast<cudaStream_t>(stream));
}

// The route's second half after moe_route_pick on the same idx, pos and
// tile_counts, with room [E].
extern "C" int moe_route_place(int N, int E, int k, int C, void* idx, void* pos, void* keep,
                               void* counts, void* slot_token, void* slot_k,
                               const void* tile_counts, int n_tiles, const void* room,
                               void* stream) {
  if (!route_shape_ok(N, E, k, n_tiles) || C < 1) return (int)cudaErrorInvalidValue;
  return launch_place(N, E, k, C, idx, pos, keep, counts, slot_token, slot_k, tile_counts,
                      n_tiles, room, false, static_cast<cudaStream_t>(stream));
}

// out [E, C, D]: (w ? w[n, s] : 1) * src[n] in each kept slot (n, s)'s row
// (idx, pos), zeros in the rows c >= min(counts[e], C) (min(counts[e],
// room[e]) under a room); w [N, k] or null, room [E] or null.
extern "C" int moe_slot_gather(int dtype, const void* src, const void* idx, const void* pos,
                               const void* keep, const void* counts, const void* room,
                               const void* w, int N, int k, int E, int C, int D, void* out,
                               void* stream) {
  if (N < 1 || k < 1 || E < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  const int* ps = static_cast<const int*>(pos);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const int* ct = static_cast<const int*>(counts);
  const int* rm = static_cast<const int*>(room);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return slot_gather<float>(src, ix, ps, kp, ct, rm, wf, N, k, E, C, D, out, s);
  if (dtype == 1)
    return slot_gather<__nv_bfloat16>(src, ix, ps, kp, ct, rm, wf, N, k, E, C, D, out, s);
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
