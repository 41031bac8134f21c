// Block-sparse paged decode attention for Hopper (sm_90a).
//
// Replaces: tpuslo/ops/paged_attention.py::_paged_kernel, the Pallas TPU
// kernel launched by paged_decode_attention (pallas_call).  It computes the
// same function: one decode query per lane, q (B,H,HD), against that lane's
// own blocks of the physical pool (N,BS,KV,HD), found through its page
// table (B,MB) (0 = the null block); positions j*BS + s <= lengths[b] are
// visible (the step's own token included), a length past the table's last
// position keeps every block visible; query head h reads kv head h / n_rep;
// the softmax runs online in f32 (running max, normaliser, accumulator,
// with the m_prev == -inf guard); int8 pools are dequantized in the kernel
// with one f32 scale per (position, kv head); the output is
// acc / (l == 0 ? 1 : l) in bf16 or f32.
//
// What bounds it on an H100.  A lane reads its live K/V once: each visible
// position brings 4*HD bytes of bf16 K and V and serves the n_rep query
// rows of its kv head at 4*HD operations each, so the kernel does about
// n_rep operations per byte (3 at Llama-3.2-3B), two orders of magnitude
// under the ~295 operations per byte at which the tensor cores would become
// the limit.  It is bound by bytes, and tensor cores would not help.
//
// What the design does about it.
//  * The TPU kernel walks a sequential grid (B, MB) and carries its softmax
//    state across grid steps in VMEM scratch.  Here one thread block owns
//    one (lane b, kv head g) and a loop inside the block takes the place of
//    the block axis; the n_rep query rows' state stays in registers and
//    shared memory for the whole walk.  The grid is (B, KV).
//  * The block reads the lane's length and page-table entries from device
//    memory itself: the loop runs j = 0 .. min(len / BS, MB - 1), so nothing
//    is sized from a host read, and blocks past the length are never read
//    (the TPU kernel's pl.when skip and _live_block clamp).  Positions past
//    the length in the last block are not loaded either.
//  * Scores: HD/8 lanes of a warp share one position, each loading 8
//    contiguous elements of the k row (16 bytes of bf16, or 8 int8 codes
//    scaled by s[phys, pos, g]), taking the dot product with each query row
//    in f32 and reducing with shuffles.  Probabilities: one warp per query
//    row runs the online-softmax update over the block.  p.v: one thread
//    per head-dim column, so each v row is read coalesced.
//  * Left for later: split-K over blocks (flash-decoding) for more blocks in
//    flight at small batch (the grid has only B*KV blocks of HD threads,
//    so each SM holds a few warps and load latency is barely hidden; the
//    loops are unrolled so that each warp keeps several loads in flight),
//    and cp.async / TMA staging of the next block.
//  * A page-table entry outside [0, N) is skipped instead of read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned kFull = 0xffffffffu;

// Eight consecutive elements of a row, as f32.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load1(const int8_t* p) {
  return static_cast<float>(*p);
}

// Everything one launch reads: pointers, sizes, strides in elements.  ks
// and vs are null for a bf16 pool.
struct Args {
  const bf16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* lens;
  void* out;
  int N, BS, MB;
  long long q_sb, q_sh;        // q (B, H, HD)
  long long p_sn, p_ss, p_sg;  // pools (N, BS, KV, HD)
  long long s_sn, s_ss, s_sg;  // int8 scales (N, BS, KV)
  long long pt_sb;             // page table (B, MB)
  long long o_sb, o_sh;        // out (B, H, HD)
  float scale;
  int out_f32;
};

// T: pool element type (bf16 or int8 codes); HD: head dim (64 or 128);
// NREP: query rows per kv head.  HD threads per block.
template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(HD) paged_decode_kernel(const Args a) {
  const bf16* __restrict__ q = a.q;
  const T* __restrict__ kp = static_cast<const T*>(a.k);
  const T* __restrict__ vp = static_cast<const T*>(a.v);
  const float* __restrict__ ksc = a.ks;
  const float* __restrict__ vsc = a.vs;
  const int N = a.N, BS = a.BS, MB = a.MB;
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kLanesPerPos = HD / 8;            // 16 at HD 128
  constexpr int kPosPerWarp = 32 / kLanesPerPos;  // 2 at HD 128
  constexpr int kWarps = HD / 32;
  constexpr int kPosPerIter = kWarps * kPosPerWarp;

  extern __shared__ float smem[];
  float* p_sh = smem;                // [NREP][BS]: scores, then probabilities
  float* vs_sh = smem + NREP * BS;   // [BS]: v scales of the block (int8)
  __shared__ float m_sh[NREP];       // running max per query row
  __shared__ float l_sh[NREP];       // running normaliser
  __shared__ float alpha_sh[NREP];   // rescale of this block

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / kLanesPerPos;   // which position of the warp's
  const int part = lane % kLanesPerPos;  // which 8 elements of the row

  const int len = a.lens[b];
  const int last_block = min(len / BS, MB - 1);

  // This lane's 8 dims of the block's query rows, in f32.
  float qr[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    load8(q + b * a.q_sb + static_cast<long long>(g * NREP + r) * a.q_sh + part * 8,
          qr[r]);
  }
  float acc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  if (tid < NREP) {
    m_sh[tid] = -INFINITY;
    l_sh[tid] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j <= last_block; ++j) {
    const int phys = a.pt[b * a.pt_sb + j];
    // Visible positions of this block: at least one, since j * BS <= len.
    const int n_valid = ((unsigned)phys < (unsigned)N)
                            ? min(BS, len - j * BS + 1)
                            : 0;
    const long long blk = static_cast<long long>(phys) * a.p_sn + g * a.p_sg;
    const long long sblk = static_cast<long long>(phys) * a.s_sn + g * a.s_sg;

    // Scores of every position of the block against the NREP rows.  The
    // unroll lets the loads of several positions be in flight at once.
#pragma unroll 4
    for (int s0 = 0; s0 < BS; s0 += kPosPerIter) {
      const int s = s0 + warp * kPosPerWarp + sub;
      float dot[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) dot[r] = 0.f;
      if (s < n_valid) {
        float kx[8];
        load8(kp + blk + s * a.p_ss + part * 8, kx);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
#pragma unroll
          for (int i = 0; i < 8; ++i) dot[r] = fmaf(qr[r][i], kx[i], dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
#pragma unroll
        for (int off = kLanesPerPos / 2; off > 0; off >>= 1) {
          dot[r] += __shfl_xor_sync(kFull, dot[r], off);
        }
      }
      if (part == 0 && s < BS) {
        const bool ok = s < n_valid;
        float kscale = 1.f;
        if (kInt8 && ok) kscale = ksc[sblk + s * a.s_ss];
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          p_sh[r * BS + s] = ok ? dot[r] * kscale * a.scale : -INFINITY;
        }
        if (kInt8) vs_sh[s] = ok ? vsc[sblk + s * a.s_ss] : 0.f;
      }
    }
    __syncthreads();

    // Online-softmax update, one warp per query row.
    for (int r = warp; r < NREP; r += kWarps) {
      float mx = -INFINITY;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, p_sh[r * BS + s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const float x = p_sh[r * BS + s];
        const float p = (x == -INFINITY) ? 0.f : expf(x - m_new);
        p_sh[r * BS + s] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      if (lane == 0) {
        m_sh[r] = m_new;
        l_sh[r] = alpha * l_sh[r] + sum;
        alpha_sh[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, thread tid owning head-dim column tid.
#pragma unroll
    for (int r = 0; r < NREP; ++r) acc[r] *= alpha_sh[r];
    const T* vcol = vp + blk + tid;
#pragma unroll 8
    for (int s = 0; s < n_valid; ++s) {
      float x = load1(vcol + s * a.p_ss);
      if (kInt8) x *= vs_sh[s];
#pragma unroll
      for (int r = 0; r < NREP; ++r) acc[r] = fmaf(p_sh[r * BS + s], x, acc[r]);
    }
    __syncthreads();  // every thread is done with p_sh before it is rewritten
  }

  // Epilogue: divide by the normaliser, guarding a row that saw nothing.
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const float l = l_sh[r];
    const float o = acc[r] / (l == 0.f ? 1.f : l);
    const long long at = b * a.o_sb + static_cast<long long>(g * NREP + r) * a.o_sh + tid;
    if (a.out_f32) {
      static_cast<float*>(a.out)[at] = o;
    } else {
      static_cast<bf16*>(a.out)[at] = __float2bfloat16_rn(o);
    }
  }
}

template <typename T, int HD, int NREP>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  const dim3 grid(B, KV);
  const size_t smem = static_cast<size_t>(NREP + 1) * a.BS * sizeof(float);
  paged_decode_kernel<T, HD, NREP><<<grid, HD, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch(const Args& a, int B, int KV, int n_rep, cudaStream_t stream) {
  switch (n_rep) {
    case 1: return launch<T, HD, 1>(a, B, KV, stream);
    case 2: return launch<T, HD, 2>(a, B, KV, stream);
    case 3: return launch<T, HD, 3>(a, B, KV, stream);
    case 4: return launch<T, HD, 4>(a, B, KV, stream);
    case 8: return launch<T, HD, 8>(a, B, KV, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers and the stream arrive as
// void*, strides in elements; ks/vs are null for a bf16 pool.  The wrapper
// has checked: bf16 q; bf16 or int8 pools of one layout with unit inner
// stride and rows aligned for 8-element loads; f32 scales (N,BS,KV) of one
// layout; int32 page table (unit inner stride) and contiguous int32 lengths;
// HD in {64, 128}; n_rep in {1, 2, 3, 4, 8}; 1 <= BS <= 1024.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuslo_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* lens, void* out, int B, int KV,
    int n_rep, int HD, int N, int BS, int MB, int int8_pool, long long q_sb,
    long long q_sh, long long p_sn, long long p_ss, long long p_sg,
    long long s_sn, long long s_ss, long long s_sg, long long pt_sb,
    long long o_sb, long long o_sh, float scale, int out_f32, void* stream) {
  const Args a{static_cast<const bf16*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(pt), static_cast<const int*>(lens), out,
               N, BS, MB, q_sb, q_sh, p_sn, p_ss, p_sg, s_sn, s_ss, s_sg,
               pt_sb, o_sb, o_sh, scale, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) {
    return int8_pool ? dispatch<int8_t, 128>(a, B, KV, n_rep, st)
                     : dispatch<bf16, 128>(a, B, KV, n_rep, st);
  }
  if (HD == 64) {
    return int8_pool ? dispatch<int8_t, 64>(a, B, KV, n_rep, st)
                     : dispatch<bf16, 64>(a, B, KV, n_rep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
