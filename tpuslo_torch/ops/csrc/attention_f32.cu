// Full-f32 attention for Hopper (sm_90a): the inputs the two tensor-core
// kernels do not take.
//
// Replaces, for these inputs:
//  * tpuslo/ops/flash_attention.py::_flash_kernel (K1-f32).  The Pallas
//    kernel casts any input to f32 and computes the attention forward in
//    f32 (q (B,S,H,D), k/v (B,S,KV,D), GQA by h / n_rep, online softmax,
//    fully masked causal tiles skipped, output in q's dtype).  The wgmma
//    kernel in flash_attention.cu takes bf16 at head dims 128 and 256; this
//    one takes f32, bf16 or f16 inputs at head dims 128, 256, 384 and 512.
//  * tpuslo/ops/paged_attention.py::_paged_kernel (K2-f32).  One decode
//    query per lane, q (B,H,HD), against the lane's blocks of the pool
//    (N,BS,KV,HD) through its page table (B,MB) (0 = the null block);
//    positions j*BS + s <= lengths[b] are visible, a length past the
//    table's last position keeps every block visible, a table entry
//    outside [0, N) hides its block; query head h reads kv head h / n_rep;
//    the softmax has the l == 0 guard.  The split kernel in
//    paged_attention.cu takes a bf16 q over bf16 or int8 pools; this one
//    takes an f32 q over an f32 pool, head dims 64 and 128.
//
// Precision.  Every product is an f32 FFMA on the CUDA cores: no tensor
// core, no TF32.  The exponentials are expf.  What differs from the plain
// versions (flash_attention_reference, paged_decode_attention_reference)
// is only the order of the sums (an online softmax over tiles of keys),
// which moves an output by a few f32 ulps of its size.
//
// What bounds them on an H100.  In f32 the card has no tensor-core rate
// to lean on: 67 TFLOP/s of FFMA against 3.35 TB/s of HBM, about 20
// operations per byte.  K1-f32 does 4*D operations per visible (query,
// key) pair and reads each input once, so at S 256 it needs ~100
// operations per byte of its inputs: bound by operations.  K2-f32 reads
// every visible position's K and V once (8*HD bytes in f32) for
// 4*HD*n_rep operations: n_rep / 2 operations per byte, bound by bytes.
//
// What the design does about it: the simplest layout that is right and
// keeps each CUDA core busy with FFMAs from shared memory.
//  * K1-f32: one CTA of 4 warps per (16 query rows, head, batch row); each
//    warp owns 4 query rows.  Per tile of 32 keys the CTA stages K and V in
//    shared memory as f32, each thread issuing up to 8 vector loads (four
//    elements each) before it stores any, so that a tile costs one or a
//    few trips to memory rather than one per element.  Lane j scores key j
//    against the warp's 4 rows with 16-byte shared reads (16 FFMA per 5
//    reads; K rows padded by four floats, so 8 lanes' reads hit 32
//    banks); the online softmax runs with warp shuffles and leaves p in
//    shared memory; for p.v each lane owns four adjacent columns per 128
//    of the 4 output rows (16 FFMA per V read at D 128).  Both sums run
//    in order over d and over keys.  A causal CTA stops at its last query
//    row's key, so fully masked tiles are never loaded, and the CTAs of
//    the last rows, which see the most keys, start first.  At D 512 the
//    tiles take 162 KB of shared memory (Q 32 KB, K and V 64 KB each):
//    one CTA per SM.
//  * K2-f32: one CTA of 4 warps per (kv head, lane); the warps take turns
//    over chunks of 32 positions of the lane's walk, each keeping its own
//    (max, sum, accumulator) per query row, and the four partials are
//    merged in shared memory at the end.  A chunk's K rows are gathered
//    through the page table by the whole warp (one coalesced row at a
//    time) into shared memory; V rows are read straight from the pool,
//    lanes on consecutive columns.  The grid comes from shapes alone and
//    the lengths and table are read on the device, so a call replays in a
//    CUDA graph.
//  * Left for later: wider tiles and tensor-core paths (3xTF32 split
//    products) if an f32 model ever reaches the serving path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows of a K1-f32 CTA
constexpr int kBlockK = 32;                     // keys of a tile (one per lane)

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---- K1-f32 -------------------------------------------------------------

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, n_rep;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Four consecutive elements as f32: one 16-byte load for f32, one 8-byte
// load for bf16 and f16 (the wrapper hands over 16-byte aligned rows).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float elem(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float4 fma4(float a, const float4& b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

// q.k over four elements, in order.
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

template <int D>
struct FlashSmem {
  // Q [kBlockQ][D], K [kBlockK][D + 4] (padded), V [kBlockK][D], and each
  // warp's p [kRowsPerWarp][kBlockK], f32.
  static constexpr int kKStride = D + 4;
  static constexpr int kFloats =
      kBlockQ * D + kBlockK * kKStride + kBlockK * D + kWarps * kRowsPerWarp * kBlockK;
  static constexpr int kBytes = 4 * kFloats;
};

// The largest divisor of n that is at most 8.
__host__ __device__ constexpr int chunk_of(int n, int c = 8) {
  return c <= 1 ? 1 : (n % c == 0 ? c : chunk_of(n, c - 1));
}

// Copy `rows` x D elements from global rows (first at `src`, `stride`
// elements apart; rows at or past `valid` are zeros) into shared rows
// `dst_stride` floats apart.  Each thread issues its vector loads in
// chunks of up to 8 before it stores any, so a tile costs one or a few
// trips to memory.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride, const T* src,
                                           long long stride, int valid, int tid) {
  constexpr int kVecs = ROWS * D / 4;
  static_assert(kVecs % kThreads == 0, "whole vectors per thread");
  constexpr int kPer = kVecs / kThreads;
  constexpr int kChunk = chunk_of(kPer);
#pragma unroll
  for (int c0 = 0; c0 < kPer; c0 += kChunk) {
    float4 x[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = tid + (c0 + u) * kThreads;
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      x[u] = r < valid ? load4(src + r * stride + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = tid + (c0 + u) * kThreads;
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(dst + r * dst_stride + d) = x[u];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const FlashArgs a) {
  constexpr int kGroups = D / 128;  // float4 column groups a lane owns
  constexpr int kKS = FlashSmem<D>::kKStride;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * kKS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pw = vs + kBlockK * D + warp * kRowsPerWarp * kBlockK;
  // The last query rows first: under a causal mask they see the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / a.n_rep;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;

  stage_rows<T, D, kBlockQ>(qs, D, q + q0 * a.q_ss, a.q_ss, a.S - q0, tid);

  float4 acc[kRowsPerWarp][kGroups];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* qrow = reinterpret_cast<const float4*>(qs + warp * kRowsPerWarp * D);
  const int row0 = q0 + warp * kRowsPerWarp;
  // A causal CTA sees keys up to its last query row and no further.
  const int k_end = a.causal ? min(q0 + kBlockQ, a.S) : a.S;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // Q is written; the previous tile's readers are done
    stage_rows<T, D, kBlockK>(ks, kKS, k + k0 * a.k_ss, a.k_ss, a.S - k0, tid);
    stage_rows<T, D, kBlockK>(vs, D, v + k0 * a.v_ss, a.v_ss, a.S - k0, tid);
    __syncthreads();

    // Scores: lane j against key k0 + j, for the warp's 4 rows, over d in
    // order (the K rows' padding puts 8 lanes' 16-byte reads on 32 banks).
    const int t = k0 + lane;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * kKS);
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kd = krow[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dot4(qrow[r * (D / 4) + d4], kd, s[r]);
    }

    // Online softmax over the tile; p goes to the warp's row of shared
    // memory for the p.v product.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool visible = t < a.S && (!a.causal || t <= row0 + r);
      const float sc = visible ? s[r] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      // Nothing visible yet in this row: the accumulator stays zero.
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      const float p = visible ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      pw[r * kBlockK + lane] = p;
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        acc[r][c].x *= alpha;
        acc[r][c].y *= alpha;
        acc[r][c].z *= alpha;
        acc[r][c].w *= alpha;
      }
    }
    __syncwarp();

    // p.v over keys in order: lane owns columns 128 c + 4 lane .. + 3 of
    // the warp's 4 rows.
#pragma unroll 2
    for (int j4 = 0; j4 < kBlockK / 4; ++j4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p4[r] = reinterpret_cast<const float4*>(pw + r * kBlockK)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* vrow = reinterpret_cast<const float4*>(vs + (j4 * 4 + jj) * D);
#pragma unroll
        for (int c = 0; c < kGroups; ++c) {
          const float4 vv = vrow[lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fma4(elem(p4[r], jj), vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= a.S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* o = static_cast<T*>(a.o) + b * a.o_sb + row * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      T* at = o + 128 * c + 4 * lane;
      store(at + 0, acc[r][c].x / denom);
      store(at + 1, acc[r][c].y / denom);
      store(at + 2, acc[r][c].z / denom);
      store(at + 3, acc[r][c].w / denom);
    }
  }
}

template <typename T, int D>
int launch_flash(const FlashArgs& a, int B, int H, cudaStream_t stream) {
  auto kernel = &flash_f32_kernel<T, D>;
  constexpr int bytes = FlashSmem<D>::kBytes;
  // Above 48 KB of shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash(const FlashArgs& a, int B, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 128: return launch_flash<T, 128>(a, B, H, stream);
    case 256: return launch_flash<T, 256>(a, B, H, stream);
    case 384: return launch_flash<T, 384>(a, B, H, stream);
    case 512: return launch_flash<T, 512>(a, B, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- K2-f32 -------------------------------------------------------------

struct PagedArgs {
  const float* q;
  const float* k;
  const float* v;
  const int* pt;
  const int* lens;
  void* out;
  int N, BS, MB;
  long long q_sb, q_sh, p_sn, p_ss, p_sg, pt_sb, o_sb, o_sh;
  float scale;
  int out_f32;
};

template <int HD, int NREP>
struct PagedSmem {
  // Q [NREP][HD]; per warp a chunk's K rows [32][HD + 1] (padded), reused
  // at the end for the warps' partials [kWarps][NREP][HD + 2].
  static constexpr int kBytes = 4 * (NREP * HD + kWarps * 32 * (HD + 1));
  static_assert(kWarps * NREP * (HD + 2) <= kWarps * 32 * (HD + 1), "partials fit");
};

template <int HD, int NREP>
__global__ void __launch_bounds__(kThreads) paged_f32_kernel(const PagedArgs a) {
  constexpr int kCols = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + NREP * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x, b = blockIdx.y;
  const float* q = a.q + b * a.q_sb;
  for (int i = tid; i < NREP * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    qs[i] = q[(g * NREP + r) * a.q_sh + d];
  }
  __syncthreads();

  // Visible positions 0 .. T-1 (none for a negative length).
  const int T = min(a.lens[b] + 1, a.MB * a.BS);
  const int* pt = a.pt + b * a.pt_sb;
  float* kw = ks + warp * 32 * (HD + 1);
  float acc[NREP][kCols];
  float m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  for (int c0 = warp * 32; c0 < T; c0 += kWarps * 32) {
    // Lane j's position, and where its K/V row starts (-1: not visible).
    const int t = c0 + lane;
    long long row = -1;
    if (t < T) {
      const int blk = pt[t / a.BS];
      if (blk >= 0 && blk < a.N) row = blk * a.p_sn + (t % a.BS) * a.p_ss + g * a.p_sg;
    }
    for (int j = 0; j < 32; ++j) {
      const long long off = __shfl_sync(kFull, row, j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        kw[j * (HD + 1) + d] = off >= 0 ? a.k[off + d] : 0.f;
      }
    }
    __syncwarp();

    const float* krow = kw + lane * (HD + 1);
    float s[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < NREP; ++r) s[r] = fmaf(qs[r * HD + d], kd, s[r]);
    }
    float p[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const bool visible = row >= 0;
      const float sc = visible ? s[r] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      p[r] = visible ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < 32; ++j) {
      const long long off = __shfl_sync(kFull, row, j);
      float pj[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
      if (off < 0) continue;  // the same for every lane of the warp
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = a.v[off + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < NREP; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
    __syncwarp();  // the chunk's K rows are read before the next overwrite
  }

  // Merge the warps' partials: weights exp(m_w - M), 0 for a warp that saw
  // nothing; a row that saw nothing at all divides by 1 and writes zeros.
  __syncthreads();
  float* part = ks;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float* at = part + (warp * NREP + r) * (HD + 2);
    if (lane == 0) {
      at[0] = m[r];
      at[1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) at[2 + lane + 32 * c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < NREP * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, part[(w * NREP + r) * (HD + 2)]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* at = part + (w * NREP + r) * (HD + 2);
      if (at[0] == -INFINITY) continue;
      const float e = expf(at[0] - M);
      L += e * at[1];
      O += e * at[2 + d];
    }
    const float val = O / (L == 0.f ? 1.f : L);
    const long long o = b * a.o_sb + static_cast<long long>(g * NREP + r) * a.o_sh + d;
    if (a.out_f32) {
      static_cast<float*>(a.out)[o] = val;
    } else {
      static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(val);
    }
  }
}

template <int HD, int NREP>
int launch_paged(const PagedArgs& a, int B, int KV, cudaStream_t stream) {
  auto kernel = &paged_f32_kernel<HD, NREP>;
  constexpr int bytes = PagedSmem<HD, NREP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(KV, B), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_paged(const PagedArgs& a, int B, int KV, int n_rep, cudaStream_t stream) {
  switch (n_rep) {
    case 1: return launch_paged<HD, 1>(a, B, KV, stream);
    case 2: return launch_paged<HD, 2>(a, B, KV, stream);
    case 3: return launch_paged<HD, 3>(a, B, KV, stream);
    case 4: return launch_paged<HD, 4>(a, B, KV, stream);
    case 8: return launch_paged<HD, 8>(a, B, KV, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, loaded with ctypes.  Pointers and the stream arrive as
// void*, strides in elements.  Each returns cudaGetLastError() after its
// launch (0 on success), or cudaErrorInvalidValue for a head dim, dtype or
// group size it is not built for.

// K1-f32.  dtype: 0 f32, 1 bf16, 2 f16, the same for q, k, v and the
// output.  The wrapper has checked: D in {128, 256, 384, 512}, H % KV ==
// 0, unit inner strides, one device.
extern "C" int tpuslo_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int S, int H,
    int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  if (KV < 1 || H % KV || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q, k, v, o, S, H / KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                    v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_flash<float>(a, B, H, D, st);
    case 1: return dispatch_flash<bf16>(a, B, H, D, st);
    case 2: return dispatch_flash<__half>(a, B, H, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2-f32.  The wrapper has checked: f32 q (B,H,HD) and f32 pools
// (N,BS,KV,HD) of one layout with unit inner strides, int32 page table
// (B,MB) with unit inner stride, contiguous int32 lengths (B,), HD in
// {64, 128}, n_rep in {1, 2, 3, 4, 8}; the output is f32 (out_f32) or bf16.
extern "C" int tpuslo_paged_decode_attention_f32(
    const void* q, const void* k, const void* v, const void* pt, const void* lens,
    void* out, int B, int KV, int n_rep, int HD, int N, int BS, int MB, long long q_sb,
    long long q_sh, long long p_sn, long long p_ss, long long p_sg, long long pt_sb,
    long long o_sb, long long o_sh, float scale, int out_f32, void* stream) {
  if (B > 65535 || KV < 1 || BS < 1 || MB < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const int*>(pt),
                    static_cast<const int*>(lens), out, N, BS, MB, q_sb, q_sh, p_sn,
                    p_ss, p_sg, pt_sb, o_sb, o_sh, scale, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return dispatch_paged<128>(a, B, KV, n_rep, st);
  if (HD == 64) return dispatch_paged<64>(a, B, KV, n_rep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
