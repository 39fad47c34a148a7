// The merge of ring attention's chunks, for Hopper (sm_90a), bound with
// ctypes.
//
// Replaces the online-softmax update of the JAX package's ring attention
// (cordum_tpu/ops/ring_attention.py, _ring_attention_local: the running max
// m, the sum l and the accumulator folded over the chunks the sp ring brings,
// then acc / l).  Here each visiting chunk's attention is one B9 call
// (csrc/dense_attention.cu), which returns the chunk's normalised output
// out_c and its per-row log-sum-exp lse_c; this kernel folds that pair into
// the rank's fp32 accumulator acc and running lse, in place:
//
//   lse' = logaddexp(lse, lse_c)
//   acc' = acc * exp(lse - lse') + out_c * exp(lse_c - lse')
//
// so acc stays the output normalised over every key seen so far and lse that
// row's log-sum-exp; the ring casts acc once at the end.  `first` makes the
// call initialise (acc = out_c, lse = lse_c).  A term whose lse is -inf
// weighs 0, and two -inf terms give acc' = 0, lse' = -inf (the plain version
// does the same; a ring never makes one: its first chunk, the rank's own
// diagonal, gives every row a live key).  expf and log1pf, not the fast
// intrinsics: the plain version is torch's fp32 exp and log1p.
//
// Bound: bytes.  A row of head_dim values is read twice (acc fp32, out_c
// bf16 or fp32) and written once (acc), with 4 bytes of lse read and written
// and 4 of lse_c read; a handful of operations a row.  Design: one thread a
// vector of 4 consecutive values (16-byte loads of acc and of fp32 out_c,
// 8-byte of bf16), a row's head_dim / 4 threads (4, 16 or 32) lying in one
// warp; each reads its row's two lse values, the warp synchronises, and the
// row's first thread writes lse' after every thread of the row has read lse.
//
// Layouts: acc and out_c [B, Tq, H, head_dim], contiguous; lse and lse_c
// [B, H, Tq] fp32.  head_dim 16, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(float* __restrict__ acc, float* __restrict__ lse, const T* __restrict__ out_c,
                  const float* __restrict__ lse_c, long long n_vec, int Tq, int H, int first) {
  constexpr int kPerRow = HD / 4;  // threads a row: 4, 16 or 32, all in one warp
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_vec;
  const long long row = i / kPerRow;  // (b, t, h) in [B, Tq, H] order
  const int h = (int)(row % H);
  const long long bt = row / H;
  const long long b = bt / Tq, t = bt % Tq;
  const long long li = (b * H + h) * Tq + t;
  float l_old = 0.f, l_new = 0.f;
  if (live) {
    l_old = lse[li];
    l_new = lse_c[li];
  }
  __syncwarp();  // every thread of the row has read lse before it is written
  if (!live) return;
  float o[4];
  load4(out_c + i * 4, o);
  float4 r;
  float merged;
  if (first) {
    merged = l_new;
    r = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    const float m = fmaxf(l_old, l_new);
    float wa = 0.f, wb = 0.f;
    if (m == -INFINITY) {
      merged = -INFINITY;
    } else {
      merged = m + log1pf(expf(-fabsf(l_old - l_new)));
      wa = l_old == -INFINITY ? 0.f : expf(l_old - merged);
      wb = l_new == -INFINITY ? 0.f : expf(l_new - merged);
    }
    float a[4];
    load4(acc + i * 4, a);
    r = make_float4(a[0] * wa + o[0] * wb, a[1] * wa + o[1] * wb, a[2] * wa + o[2] * wb,
                    a[3] * wa + o[3] * wb);
  }
  *reinterpret_cast<float4*>(acc + i * 4) = r;
  if (i % kPerRow == 0) lse[li] = merged;
}

template <typename T, int HD>
int launch(void* acc, void* lse, const void* out_c, const void* lse_c, int B, int Tq, int H,
           int first, cudaStream_t s) {
  const long long n_vec = (long long)B * Tq * H * (HD / 4);
  ring_merge_kernel<T, HD><<<(unsigned)((n_vec + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<float*>(acc), static_cast<float*>(lse), static_cast<const T*>(out_c),
      static_cast<const float*>(lse_c), n_vec, Tq, H, first);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of out_c: 0 = float32, 1 = bfloat16; head_dim 16, 64 or 128.  Every
// pointer is a contiguous, 16-byte aligned tensor of the layouts above on the
// stream's device; the caller checks every argument.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int ring_merge(int dtype, int head_dim, void* acc, void* lse, const void* out_c,
                          const void* lse_c, int B, int Tq, int H, int first, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || Tq < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CORDUM_MERGE(T, HD) return launch<T, HD>(acc, lse, out_c, lse_c, B, Tq, H, first, s)
  if (dtype == 0) {
    if (head_dim == 16) CORDUM_MERGE(float, 16);
    if (head_dim == 64) CORDUM_MERGE(float, 64);
    if (head_dim == 128) CORDUM_MERGE(float, 128);
  } else {
    if (head_dim == 16) CORDUM_MERGE(__nv_bfloat16, 16);
    if (head_dim == 64) CORDUM_MERGE(__nv_bfloat16, 64);
    if (head_dim == 128) CORDUM_MERGE(__nv_bfloat16, 128);
  }
#undef CORDUM_MERGE
  return (int)cudaErrorInvalidValue;
}
