// Batch-invariant RMSNorm, and the residual add fused into it, for Hopper
// (sm_90a).
//
// Port-internal kernels: the JAX package leaves rms_norm
// (tpuslo/models/llama.py, rms_norm) and the residual adds around it to
// XLA, with no Pallas kernel.  They compute the plain versions
// (tpuslo_torch/ops/rms_norm.py, rms_norm_reference and
// add_rms_norm_reference) for one row of D elements:
//
//   add + norm:  h' = T(f32(h) + f32(d))       (what the eager h + d gives)
//                y  = T(T(h' * rms) * w),   rms = rsqrt(sum(h'^2) / D + eps)
//   norm alone:  the same with h' = h, and no h' written.
//
// The norm is taken over the rounded h', never over the f32 sum, so that
// y is the norm of the residual stream the next layer reads.
//
// Why a kernel.  PyTorch's reduction sets its block shape, and with it
// the order in which a row's squares are summed, from the number of rows
// as well as from D, so a row's bits would depend on how many rows share
// its call: a decode round for one stream and the same row inside a
// batch of slots would round differently, and greedy streams part at
// near-ties.  Here everything is a function of D alone.  A row is nvec
// packs of VEC elements (16 bytes, or one element when D is no whole
// number of packs).  One CTA owns one row, with P = ceil(nvec / 256)
// packs a thread over as few whole warps as hold them (D 2,048 bf16: 256
// threads of one pack; D 3,072 bf16: 192 threads of two).  Thread t sums
// the squares of its packs t, t + threads, ... in that order, each
// pack's elements in order; a warp's 32 sums are reduced by one fixed
// butterfly, and thread 0 adds the warp sums in order.  Each step rounds
// as the plain version's does (a square, then a sum; the mean, then
// + eps: no fused multiply-add), so the two rms part only where the
// orders of summation do: y = T(T(h' * rms) * w) rounds twice, and one
// ulp of T(h' * rms) becomes up to two of y where the weight takes y a
// binade lower.
//
// What bounds it on an H100: bytes, and at the main path's shapes the
// latency of one launch.  The add + norm reads h, d and the weight and
// writes h' and y (about 4 D elements of traffic a row, the weight from
// L2 after the first row) for ~6 D operations: far under the card's
// operations per byte.  The design: 16-byte vector loads and stores;
// every load of a row (h, d and the weight) issued before the first is
// used; h' summed and normalised from registers, so global memory is
// read once; one launch where the eager path had two (the add, then the
// norm).  A row of more than kMaxPerThread packs a thread (bf16 D over
// 8,192, f32 over 4,096, the scalar path over 1,024) does not fit the
// registers: it takes a second pass over global memory, in the same
// order of summation.  At a few to a few hundred rows of 2,048 or 3,072
// the call's time is mostly the launch and one memory round trip.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPerThread = 4;  // packs a thread holds in registers

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

// VEC elements moved as one load or store (16 bytes when VEC * sizeof(T)
// is 16, one element on the scalar path).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// a = T(a + b), element by element.
template <typename T, int VEC>
__device__ __forceinline__ void add_in(Pack<T, VEC>& a, const Pack<T, VEC>& b) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) a.v[j] = from_f32<T>(to_f32(a.v[j]) + to_f32(b.v[j]));
}

// acc plus the squares of a pack's elements, in order, each rounded.
template <typename T, int VEC>
__device__ __forceinline__ float sum_squares(float acc, const Pack<T, VEC>& a) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f32(a.v[j]);
    acc = __fadd_rn(acc, __fmul_rn(f, f));
  }
  return acc;
}

// y = T(T(h' * rms) * w) of one pack.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> normed(const Pack<T, VEC>& a, const Pack<T, VEC>& w,
                                               float rms) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const T n = from_f32<T>(to_f32(a.v[j]) * rms);
    out.v[j] = from_f32<T>(to_f32(n) * to_f32(w.v[j]));
  }
  return out;
}

// The row's rms from each thread's sum: one fixed butterfly per warp,
// then thread 0 adds the warp sums in order.
__device__ __forceinline__ float row_rms(float acc, float inv_d, float eps) {
  __shared__ float warp_sum[kMaxWarps];
  __shared__ float rms_sh;
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    const int warps = static_cast<int>(blockDim.x >> 5);
    for (int i = 0; i < warps; ++i) s += warp_sum[i];
    rms_sh = rsqrtf(__fadd_rn(__fmul_rn(s, inv_d), eps));
  }
  __syncthreads();
  return rms_sh;
}

// The CTA of one row; row pointers are `*_sr` elements apart.  nvec packs
// of VEC elements make a row of D; thread t owns packs t, t + blockDim.x,
// ...  HELD: at most kMaxPerThread of them, held in registers from the
// load to the store, so the row is read once; otherwise a first pass
// sums (and writes h') and a second reads the row again.  ADD:
// h' = h + d is written to ho and normalised; otherwise h is normalised
// and d, ho are unused.
template <typename T, int VEC, bool ADD, bool HELD>
__device__ __forceinline__ void norm_row(const T* __restrict__ h, const T* __restrict__ d,
                                         const T* __restrict__ w, T* __restrict__ ho,
                                         T* __restrict__ y, int nvec, long long h_sr,
                                         long long d_sr, long long ho_sr, long long y_sr,
                                         float inv_d, float eps) {
  using P = Pack<T, VEC>;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const P* hr = reinterpret_cast<const P*>(h + row * h_sr);
  const P* dr = reinterpret_cast<const P*>(d + (ADD ? row * d_sr : 0));
  const P* wr = reinterpret_cast<const P*>(w);
  P* hor = reinterpret_cast<P*>(ho + (ADD ? row * ho_sr : 0));
  P* yr = reinterpret_cast<P*>(y + row * y_sr);
  float acc = 0.f;
  if (HELD) {
    // Every load first, so that they are in flight together.
    P x[kMaxPerThread];
    P u[kMaxPerThread];
    P wv[kMaxPerThread];
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int v = tid + k * nt;
      if (v < nvec) {
        x[k] = hr[v];
        if (ADD) u[k] = dr[v];
        wv[k] = wr[v];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      if (tid + k * nt < nvec) {
        if (ADD) add_in(x[k], u[k]);
        acc = sum_squares(acc, x[k]);
      }
    }
    const float rms = row_rms(acc, inv_d, eps);
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int v = tid + k * nt;
      if (v < nvec) {
        if (ADD) hor[v] = x[k];
        yr[v] = normed(x[k], wv[k], rms);
      }
    }
  } else {
    for (int v = tid; v < nvec; v += nt) {
      P x = hr[v];
      if (ADD) {
        add_in(x, dr[v]);
        hor[v] = x;  // read back below, by this thread alone
      }
      acc = sum_squares(acc, x);
    }
    const float rms = row_rms(acc, inv_d, eps);
    for (int v = tid; v < nvec; v += nt) yr[v] = normed(ADD ? hor[v] : hr[v], wr[v], rms);
  }
}

// The norm alone: y = rms_norm(x) * w.
template <typename T, int VEC, bool HELD>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    int nvec, long long x_sr, long long y_sr, float inv_d, float eps) {
  norm_row<T, VEC, false, HELD>(x, nullptr, w, nullptr, y, nvec, x_sr, 0, 0, y_sr, inv_d, eps);
}

// The residual add fused into the norm: ho = h + d, y = rms_norm(ho) * w.
template <typename T, int VEC, bool HELD>
__global__ void __launch_bounds__(kMaxThreads)
    add_norm_kernel(const T* __restrict__ h, const T* __restrict__ d, const T* __restrict__ w,
                    T* __restrict__ ho, T* __restrict__ y, int nvec, long long h_sr,
                    long long d_sr, long long ho_sr, long long y_sr, float inv_d, float eps) {
  norm_row<T, VEC, true, HELD>(h, d, w, ho, y, nvec, h_sr, d_sr, ho_sr, y_sr, inv_d, eps);
}

template <typename T, int VEC, bool ADD, bool HELD>
void start_as(int rows, int threads, cudaStream_t stream, const T* h, const T* d, const T* w,
              T* ho, T* y, int nvec, long long h_sr, long long d_sr, long long ho_sr,
              long long y_sr, float inv_d, float eps) {
  if (ADD) {
    add_norm_kernel<T, VEC, HELD><<<rows, threads, 0, stream>>>(h, d, w, ho, y, nvec, h_sr,
                                                                d_sr, ho_sr, y_sr, inv_d, eps);
  } else {
    rms_norm_kernel<T, VEC, HELD><<<rows, threads, 0, stream>>>(h, w, y, nvec, h_sr, y_sr,
                                                                inv_d, eps);
  }
}

// The CTA shape and the held path, both functions of D alone.
template <typename T, int VEC, bool ADD>
int start(int rows, cudaStream_t stream, const T* h, const T* d, const T* w, T* ho, T* y,
          int D, long long h_sr, long long d_sr, long long ho_sr, long long y_sr, float inv_d,
          float eps) {
  const int nvec = D / VEC;
  const int per = (nvec + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((nvec + per - 1) / per + 31) / 32 * 32;
  if (per <= kMaxPerThread) {
    start_as<T, VEC, ADD, true>(rows, threads, stream, h, d, w, ho, y, nvec, h_sr, d_sr, ho_sr,
                                y_sr, inv_d, eps);
  } else {
    start_as<T, VEC, ADD, false>(rows, threads, stream, h, d, w, ho, y, nvec, h_sr, d_sr, ho_sr,
                                 y_sr, inv_d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool ADD>
int launch(const void* h, const void* d, const void* w, void* ho, void* y, int rows, int D,
           long long h_sr, long long d_sr, long long ho_sr, long long y_sr, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const float inv_d = 1.0f / static_cast<float>(D);
  const T* hp = static_cast<const T*>(h);
  const T* dp = static_cast<const T*>(d);
  const T* wp = static_cast<const T*>(w);
  T* hop = static_cast<T*>(ho);
  T* yp = static_cast<T*>(y);
  if (D % VEC == 0) {
    // The vector path is a function of D alone: the wrapper hands it
    // 16-byte aligned rows (it copies any that are not), checked here.
    bool ok = aligned(h) && aligned(w) && aligned(y) && h_sr % VEC == 0 && y_sr % VEC == 0;
    if (ADD) ok = ok && aligned(d) && aligned(ho) && d_sr % VEC == 0 && ho_sr % VEC == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return start<T, VEC, ADD>(rows, stream, hp, dp, wp, hop, yp, D, h_sr, d_sr, ho_sr, y_sr,
                              inv_d, eps);
  }
  return start<T, 1, ADD>(rows, stream, hp, dp, wp, hop, yp, D, h_sr, d_sr, ho_sr, y_sr, inv_d,
                          eps);
}

template <bool ADD>
int dispatch(const void* h, const void* d, const void* w, void* ho, void* y, int rows, int D,
             long long h_sr, long long d_sr, long long ho_sr, long long y_sr, float eps,
             int dtype, void* stream) {
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, ADD>(h, d, w, ho, y, rows, D, h_sr, d_sr, ho_sr, y_sr, eps, st);
    case 1:
      return launch<__nv_bfloat16, ADD>(h, d, w, ho, y, rows, D, h_sr, d_sr, ho_sr, y_sr, eps,
                                        st);
    case 2: return launch<__half, ADD>(h, d, w, ho, y, rows, D, h_sr, d_sr, ho_sr, y_sr, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 f32, 1 bf16, 2 f16 (every
// tensor shares it).  Strides in elements.  The wrapper has checked the
// device, the dtypes, unit inner strides, 16-byte alignment where D is a
// multiple of 16 bytes, and 1 <= rows < 2^31.  Each launches on `stream`
// and returns cudaGetLastError() (0 on success).

// y = rms_norm(x) * w.
extern "C" int tpuslo_rms_norm(const void* x, const void* w, void* y, int rows, int D,
                               long long x_sr, long long y_sr, float eps, int dtype,
                               void* stream) {
  return dispatch<false>(x, nullptr, w, nullptr, y, rows, D, x_sr, 0, 0, y_sr, eps, dtype,
                         stream);
}

// h_out = h + d; y = rms_norm(h_out) * w.
extern "C" int tpuslo_add_rms_norm(const void* h, const void* d, const void* w, void* h_out,
                                   void* y, int rows, int D, long long h_sr, long long d_sr,
                                   long long ho_sr, long long y_sr, float eps, int dtype,
                                   void* stream) {
  return dispatch<true>(h, d, w, h_out, y, rows, D, h_sr, d_sr, ho_sr, y_sr, eps, dtype,
                        stream);
}
