// Batch-invariant RMSNorm for Hopper (sm_90a).
//
// A port-internal kernel: the JAX package leaves rms_norm
// (tpuslo/models/llama.py, rms_norm) to XLA, with no Pallas kernel.  It
// computes the same function as the plain version
// (tpuslo_torch/ops/rms_norm.py, rms_norm_reference) for one row of D
// elements: the f32 sum of squares, rms = rsqrt(sum / D + eps), the row
// times rms rounded to the input type, then times the weight, rounded
// once more (y = T(T(x * rms) * w), the product taken in f32).
//
// Why a kernel.  PyTorch's reduction sets its block shape, and with it
// the order in which a row's squares are summed, from the number of rows
// as well as from D, so a row's bits depend on how many rows share its
// call: a decode round for one stream and the same row inside a batch of
// slots round differently, and greedy streams part at near-ties.  Here
// one CTA of a fixed 256 threads owns one row: thread t sums elements
// t, t + 256, ... in order, the 32 lanes of a warp are reduced by one
// fixed butterfly, and thread 0 adds the 8 warp sums in order.  That
// order depends on D alone, never on the number of rows or on the other
// rows' values.  It also fuses the eight eager kernels one norm costs
// (cast, square, mean, add, rsqrt, multiply, cast, multiply).
//
// What bounds it on an H100: bytes.  A row reads D inputs and writes D
// outputs (the weight, D more, stays in L2 across rows) for about 4 D
// operations: far under the card's ~20 f32 operations per byte.  The
// second read of the row (for the output) comes from L1/L2.  At the
// main path's shapes (a few to a few hundred rows of 2,048 or 3,072) the
// call is short and its time is mostly the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// One CTA per row.  x rows are x_sr elements apart, y rows y_sr; the
// weight is D contiguous elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int D,
                    long long x_sr, long long y_sr, float inv_d, float eps) {
  __shared__ float warp_sum[kWarps];
  __shared__ float rms_sh;
  const long long row = blockIdx.x;
  const T* xr = x + row * x_sr;
  T* yr = y + row * y_sr;
  const int tid = threadIdx.x;

  float acc = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sum[i];
    rms_sh = rsqrtf(s * inv_d + eps);
  }
  __syncthreads();
  const float rms = rms_sh;
  for (int i = tid; i < D; i += kThreads) {
    const T normed = from_f32<T>(to_f32(xr[i]) * rms);
    yr[i] = from_f32<T>(to_f32(normed) * to_f32(w[i]));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int D, long long x_sr,
           long long y_sr, float eps, cudaStream_t stream) {
  rms_norm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), D, x_sr, y_sr,
      1.0f / static_cast<float>(D), eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 f32, 1 bf16, 2 f16 (x, the
// weight and y share it).  Strides in elements.  The wrapper has checked
// the device, the dtypes, unit inner strides and 1 <= rows < 2^31.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tpuslo_rms_norm(const void* x, const void* w, void* y, int rows, int D,
                               long long x_sr, long long y_sr, float eps, int dtype,
                               void* stream) {
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, y, rows, D, x_sr, y_sr, eps, st);
    case 1: return launch<__nv_bfloat16>(x, w, y, rows, D, x_sr, y_sr, eps, st);
    case 2: return launch<__half>(x, w, y, rows, D, x_sr, y_sr, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
