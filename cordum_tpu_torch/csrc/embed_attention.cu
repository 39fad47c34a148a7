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
//      sqrt(head_dim);
//   2. plus an fp32 bias of -1e30 on keys whose mask is 0.  The sum is
//      taken literally, never by skipping masked keys: on a row whose keys
//      are all masked (a batch-padding row) every score rounds to exactly
//      -1e30 and the softmax is uniform over all L keys, as in the
//      reference; skipping them would divide 0 by 0;
//   3. an fp32 softmax (max, exp, sum, divide);
//   4. probabilities rounded to the input dtype before the fp32-accumulated
//      PV product, whose result is rounded to the input dtype.
//
// Bound: at the embedder's shapes (B <= 256, L <= 128, h 4, head_dim 64)
// the bytes (q, k, v and out, read or written once, plus the mask) bound
// the call in bf16; in fp32 the operations (4 * head_dim per query, key
// and head) outweigh them on the card's fp32 rate.
//
// Design (the simple one):
//   * one block per (batch row, head); the head's K and V, [L, 64], are
//     staged once into shared memory as fp32 (K rows padded to 65 floats so
//     the 32 lanes of a warp, each on its own key, hit 32 banks);
//   * eight warps; a warp takes 4 query rows at a time, so every K value it
//     loads from shared memory serves 4 rows: lane i scores keys i, i + 32,
//     i + 64, i + 96, the softmax reduces over the warp with shuffles, and
//     the probabilities go to a per-warp shared-memory row that all lanes
//     read back (broadcast) for the PV product, lane i owning output dims
//     i and i + 32;
//   * scores, softmax and accumulators are fp32 registers.
// Not done yet: tensor-core products (mma/wgmma), loading K/V with cp.async
// or TMA, a persistent schedule.
//
// Layouts: q, k, v [B, L, h, 64] with any batch and row strides (the
// embedder passes views of its fused qkv projection, [B, L, 3, h, 64], so
// no copy is made), head stride 64 and unit element stride; mask [B, L]
// fp32 contiguous; out [B, L, h, 64] contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kHD = 64;        // head width of the embedder (d 256 / h 4)
constexpr int kKStride = kHD + 1;
constexpr int kMaxL = 128;     // the embedder's max_len
constexpr int kKeys = kMaxL / kWarp;  // keys a lane scores
constexpr int kRows = 4;       // query rows a warp takes at a time
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and read back as fp32 (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int L) {
  return sizeof(float) * ((size_t)L * kKStride + (size_t)L * kHD + L +
                          (size_t)kWarps * kRows * kHD + (size_t)kWarps * kRows * L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ mask,
                       T* __restrict__ out, int L, int H, long long stride_b,
                       long long stride_l, float scale_div) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [L][kKStride]
  float* vs = ks + L * kKStride;          // [L][kHD]
  float* bias = vs + L * kHD;             // [L]
  float* qs = bias + L;                   // [kWarps][kRows][kHD]
  float* ps = qs + kWarps * kRows * kHD;  // [kWarps][kRows][L]

  const int b = blockIdx.x / H;
  const int head = blockIdx.x % H;
  const long long base = (long long)b * stride_b + (long long)head * kHD;

  for (int i = threadIdx.x; i < L * kHD; i += kThreads) {
    const int r = i / kHD, d = i % kHD;
    const long long off = base + (long long)r * stride_l + d;
    ks[r * kKStride + d] = to_f(k[off]);
    vs[r * kHD + d] = to_f(v[off]);
  }
  for (int r = threadIdx.x; r < L; r += kThreads) {
    bias[r] = mask[(long long)b * L + r] > 0.f ? 0.f : -1e30f;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* my_q = qs + warp * kRows * kHD;
  float* my_p = ps + warp * kRows * L;

  for (int row0 = warp * kRows; row0 < L; row0 += kWarps * kRows) {
    // this pass's query rows; rows past L are zeros and are never stored
    for (int i = lane; i < kRows * kHD; i += kWarp) {
      const int r = row0 + i / kHD, d = i % kHD;
      my_q[i] = r < L ? to_f(q[base + (long long)r * stride_l + d]) : 0.f;
    }
    __syncwarp();

    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHD; ++d) {
      float kd[kKeys];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int j = lane + c * kWarp;
        kd[c] = j < L ? ks[j * kKStride + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qd = my_q[r * kHD + d];
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] = fmaf(qd, kd[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int j = lane + c * kWarp;
        if (j < L) {
          s[r][c] = round_to<T>(s[r][c]) / scale_div + bias[j];
          m = fmaxf(m, s[r][c]);
        }
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int j = lane + c * kWarp;
        if (j < L) {
          s[r][c] = expf(s[r][c] - m);
          sum += s[r][c];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int j = lane + c * kWarp;
        if (j < L) my_p[r * L + j] = round_to<T>(s[r][c] / sum);
      }
    }
    __syncwarp();

    float o[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r][0] = o[r][1] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float v0 = vs[j * kHD + lane];
      const float v1 = vs[j * kHD + lane + kWarp];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = my_p[r * L + j];
        o[r][0] = fmaf(p, v0, o[r][0]);
        o[r][1] = fmaf(p, v1, o[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < L) {
        T* dst = out + (((long long)b * L + row) * H + head) * kHD;
        store_f(dst + lane, o[r][0]);
        store_f(dst + lane + kWarp, o[r][1]);
      }
    }
    __syncwarp();  // my_q / my_p are rewritten by the next pass
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int L, int H,
                   long long stride_b, long long stride_l, float scale_div,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        embed_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  embed_attention_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), L, H, stride_b, stride_l, scale_div);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim must be 64 and 1 <= L <= 128.
// Strides are in elements.  Returns the launch's cudaGetLastError()
// (0 = cudaSuccess); the caller checks every argument.
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
    return (int)launch<float>(q, k, v, mask, out, B, L, H, stride_b, stride_l,
                              scale_div, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, mask, out, B, L, H, stride_b,
                                      stride_l, scale_div, s);
  }
  return (int)cudaErrorInvalidValue;
}
