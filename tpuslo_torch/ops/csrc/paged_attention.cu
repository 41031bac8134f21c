// Block-sparse paged decode attention for Hopper (sm_90a), split over
// pool blocks (flash-decoding).
//
// Replaces: tpuslo/ops/paged_attention.py::_paged_kernel, the Pallas TPU
// kernel launched by paged_decode_attention (pallas_call).  It computes the
// same function: one decode query per lane, q (B,H,HD), against that lane's
// own blocks of the physical pool (N,BS,KV,HD), found through its page
// table (B,MB) (0 = the null block); positions j*BS + s <= lengths[b] are
// visible (the step's own token included), a length past the table's last
// position keeps every block visible; query head h reads kv head h / n_rep;
// the softmax runs in f32 with the m == -inf guard; int8 pools are
// dequantized in the kernel with one f32 scale per (position, kv head); the
// output is acc / (l == 0 ? 1 : l) in bf16 or f32.
//
// What bounds it on an H100.  A lane reads its live K/V once: each visible
// position brings 4*HD bytes of bf16 K and V and serves the n_rep query
// rows of its kv head at 4*HD operations each, so the kernel does about
// n_rep operations per byte (3 at Llama-3.2-3B), two orders of magnitude
// under the ~295 operations per byte at which the tensor cores would become
// the limit.  It is bound by bytes, and tensor cores would not help: what
// matters is how much of the live K/V is in flight at once.
//
// What the design does about it.
//  * The TPU kernel walks a sequential grid (B, MB) and carries its softmax
//    state across grid steps in VMEM scratch.  Here the walk is split: the
//    grid is (KV, B, n_split) and each block (CTA) owns one fixed span of at
//    most 64 logical positions of one (lane b, kv head g): one pool block,
//    a 64-position chunk of a larger block, or 64 / BS whole smaller
//    blocks.  The span, and so n_split, comes from BS and MB alone (the
//    wrapper's split_plan); a CTA whose span starts past the lane's length
//    (or its last block, min(len / BS, MB - 1)) exits at once.  So every
//    live span of every lane is loaded at the same time instead of one
//    block after another, and nothing is sized from a host read: one call
//    can be captured in a CUDA graph and replayed with new lengths and
//    tables.  The split is the slowest grid axis, so the spans that are
//    live for every lane are dispatched first.
//  * Loads: the CTA reads its length and page-table entries on the device,
//    then issues every K and V row of its span as 16-byte cp.async copies
//    (8 bytes for int8 codes) into shared memory, K and V in two groups,
//    before any compute: the scores wait only for K, and V's copy overlaps
//    them.  A row that is not visible, or whose table entry lies outside
//    [0, N), is zero-filled instead of read.
//  * Scores: one mma.sync m16n8k16 tile per 8 positions and 16 dims, the
//    n_rep query rows padded to the MMA's 16 rows (bf16 products are exact
//    in the f32 accumulator; int8 codes are exact in bf16, their scales
//    multiply the score).  k rows are padded in shared memory so that the
//    fragment loads do not conflict.  One warp per query row then takes
//    the span's max and exp2 sums.  p.v stays in f32 on the CUDA cores:
//    each thread owns 8 contiguous columns (one 16-byte piece of a v row)
//    for a subset of the positions, and the position groups are reduced
//    with shuffles and shared memory.
//  * Partials go to an f32 scratch (B, KV, n_split, n_rep, HD + 2): the
//    span's max (log2 units), its sum and its unnormalised accumulator.  A
//    second small kernel, grid (KV, B), merges the partials of the spans
//    that ran (a prefix of the split index, which both kernels compute
//    from the length the same way), loading a batch of spans at a time,
//    with the usual rescale: a span that saw nothing (max -inf, sum 0)
//    adds nothing, and a row that saw nothing at all divides by 1 and
//    writes zeros.  A second kernel rather than a last-CTA ticket: the
//    ticket needs a counter that is zero before the call, and the
//    wrapper's scratch comes from torch.empty.
//  * Left for later: fewer, larger copies (a TMA box or a bulk copy per
//    row instead of sixteen 16-byte cp.async per row), which the
//    per-CTA phase timings point at: a live CTA spends most of its time
//    issuing and waiting for copies under load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // threads of a split CTA
constexpr int kSpan = 64;      // positions a split CTA holds at most
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

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

// Asynchronous copy of 8 elements (16 bytes of bf16, 8 of int8 codes)
// from device memory into shared memory, or a zero fill.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src) {
  hopper::cp_async16(dst, src);
}

__device__ __forceinline__ void copy8(int8_t* dst, const int8_t* src) {
  hopper::cp_async8(dst, src);
}

__device__ __forceinline__ void zero8(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void zero8(int8_t* dst) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
}

// Two consecutive elements of a row as one register of two bf16 (the B
// fragment of an MMA); int8 codes convert exactly.
__device__ __forceinline__ uint32_t pair_bf16(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(c.x), static_cast<float>(c.y));
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A B for a 16 x 16 A (rows 8-15 zero: a1 = a3 = 0) and a 16 x 8 B,
// bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Everything one launch reads: pointers, sizes, strides in elements.  ks
// and vs are null for a bf16 pool.  part is the f32 scratch
// (B, KV, n_split, n_rep, HD + 2).
struct Args {
  const bf16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* lens;
  void* out;
  float* part;
  int N, BS, MB;
  int n_split;  // spans per (lane, kv head)
  int bps;      // whole pool blocks per span (BS < 64), else 1
  int cps;      // 64-position chunks per pool block (BS > 64), else 1
  int chunk;    // positions of one pool block in a span: min(BS, 64)
  long long q_sb, q_sh;        // q (B, H, HD)
  long long p_sn, p_ss, p_sg;  // pools (N, BS, KV, HD)
  long long s_sn, s_ss, s_sg;  // int8 scales (N, BS, KV)
  long long pt_sb;             // page table (B, MB)
  long long o_sb, o_sh;        // out (B, H, HD)
  float scale_log2;            // HD^-0.5 * log2(e)
  int out_f32;
};

// How many spans of a lane of length `len` hold a visible position.  Span
// i starts at logical position (i / cps) * bps * BS + (i % cps) * chunk,
// which grows with i, and the spans tile the table's positions, so the
// live spans are a prefix: every span when the length reaches past the
// table (every block stays visible), else those up to the one holding
// position len.  Both kernels decide by this one count.
__device__ __forceinline__ int live_spans(const Args& a, int len) {
  if (len < 0) return 0;
  if (len >= a.MB * a.BS) return a.n_split;
  return (len / a.BS / a.bps) * a.cps + (len % a.BS) / a.chunk + 1;
}

__device__ __forceinline__ float* part_row(const Args& a, int b, int g, int split,
                                           int r, int nrep, int hd) {
  const long long row =
      ((static_cast<long long>(b) * gridDim.x + g) * a.n_split + split) * nrep + r;
  return a.part + row * (hd + 2);
}

// T: pool element type (bf16 or int8 codes); HD: head dim (64 or 128);
// NREP: query rows per kv head.  Grid (KV, B, n_split), 128 threads.
template <typename T, int HD, int NREP>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kCols = HD / 8;                  // 8-element pieces per row
  constexpr int kPosGroups = kThreads / kCols;   // p.v position groups
  // k rows are padded by 16 bytes so that the score MMA's fragment loads
  // (8 rows at a time) fall on distinct banks.
  constexpr int kKRow = HD + 16 / static_cast<int>(sizeof(T));
  constexpr int kKvBytes = kSpan * kKRow * static_cast<int>(sizeof(T));
  constexpr int kRedBytes = kWarps * NREP * HD * 4;
  constexpr int kKBytes = kKvBytes > kRedBytes ? kKvBytes : kRedBytes;
  static_assert(NREP <= 8, "query rows of a kv head fill at most half an MMA tile");

  // k rows, later the per-warp p.v sums; v rows; scores, then probabilities.
  __shared__ __align__(16) unsigned char k_raw[kKBytes];
  __shared__ __align__(16) T v_sh[kSpan * HD];
  __shared__ float p_sh[NREP][kSpan];
  __shared__ long long row_off[kSpan];  // row offset in the pools, -1: not visible
  __shared__ float ksc_sh[kInt8 ? kSpan : 1];
  __shared__ float vsc_sh[kInt8 ? kSpan : 1];
  __shared__ float m_sh[NREP];
  __shared__ float l_sh[NREP];
  T* k_sh = reinterpret_cast<T*>(k_raw);

  // The split is the slowest grid axis: every lane's first spans (live
  // whenever the lane is) are dispatched before the later ones, which are
  // live only for long lanes and otherwise exit at once.
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int j0 = (split / a.cps) * a.bps;   // first logical block of the span
  const int s_lo = (split % a.cps) * a.chunk;  // first position in each block
  const int width = min(a.chunk, a.BS - s_lo);  // positions per block
  const int nb = min(a.bps, a.MB - j0);         // blocks in the span
  // Thread p < 64 reads the table entry of row p's block together with the
  // length (the entry exists whatever the length is).
  const int jj = tid / width;
  const bool in_table = tid < kSpan && jj < nb;
  const int phys = in_table ? a.pt[b * a.pt_sb + j0 + jj] : -1;
  const int len = a.lens[b];
  if (split >= live_spans(a, len)) return;

  // Where each row of the span lives, if it is visible (thread p < 64
  // decides for row p and keeps its int8 scale offset).
  long long so = -1;
  if (tid < kSpan) {
    const int s = s_lo + tid % width;
    const int j = j0 + jj;
    long long off = -1;
    if (in_table && j * a.BS + s <= len) {
      if ((unsigned)phys < (unsigned)a.N) {
        off = static_cast<long long>(phys) * a.p_sn + s * a.p_ss + g * a.p_sg;
        so = static_cast<long long>(phys) * a.s_sn + s * a.s_ss + g * a.s_sg;
      }
    }
    row_off[tid] = off;
  }
  __syncthreads();

  // Issue every copy of the span before any compute: K, then V.
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  constexpr int kPieces = kSpan * kCols / kThreads;  // per thread and side
#pragma unroll
  for (int it = 0; it < kPieces; ++it) {
    const int i = tid + it * kThreads;
    const int p = i / kCols;
    const int c = (i % kCols) * 8;
    const long long off = row_off[p];
    if (off >= 0) {
      copy8(k_sh + p * kKRow + c, kp + off + c);
    } else {
      zero8(k_sh + p * kKRow + c);
    }
  }
  hopper::cp_async_commit();
#pragma unroll
  for (int it = 0; it < kPieces; ++it) {
    const int i = tid + it * kThreads;
    const int p = i / kCols;
    const int c = (i % kCols) * 8;
    const long long off = row_off[p];
    if (off >= 0) {
      copy8(v_sh + p * HD + c, vp + off + c);
    } else {
      zero8(v_sh + p * HD + c);
    }
  }
  hopper::cp_async_commit();
  if (kInt8 && tid < kSpan) {
    ksc_sh[tid] = so >= 0 ? a.ks[so] : 0.f;
    vsc_sh[tid] = so >= 0 ? a.vs[so] : 0.f;
  }

  // The query rows as the A operand of m16n8k16 MMAs (row gq of the tile
  // is query row gq of this kv head; rows NREP.. are zero), loaded while
  // the copies fly.
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread within the group
  uint32_t qa[HD / 16][2];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (gq < NREP) {
      const bf16* qrow = a.q + b * a.q_sb +
                         static_cast<long long>(g * NREP + gq) * a.q_sh + ks * 16 + 2 * tq;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qrow);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qrow + 8);
    }
  }

  hopper::cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();     // and everyone's

  // Scores on the tensor cores (bf16 in, f32 accumulate; an int8 code is
  // exact in bf16 and its scale is applied to the score): warp w takes
  // positions [16w, 16w + 16) as two n8 tiles.  Log2 units.
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int p0 = 16 * warp + 8 * nt;
    const T* krow = k_sh + (p0 + gq) * kKRow + 2 * tq;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      mma_16816(c, qa[ks][0], qa[ks][1], pair_bf16(krow + ks * 16), pair_bf16(krow + ks * 16 + 8));
    }
    if (gq < NREP) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = p0 + 2 * tq + e;
        const float f = (kInt8 ? ksc_sh[p] : 1.f) * a.scale_log2;
        p_sh[gq][p] = row_off[p] >= 0 ? c[e] * f : -INFINITY;
      }
    }
  }
  __syncthreads();

  // The span's max and sum per query row, one warp per row; scores become
  // probabilities relative to the span's max.
  for (int r = warp; r < NREP; r += kWarps) {
    float mx = -INFINITY;
#pragma unroll
    for (int p = lane; p < kSpan; p += 32) mx = fmaxf(mx, p_sh[r][p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int p = lane; p < kSpan; p += 32) {
      const float x = p_sh[r][p];
      const float e = (x == -INFINITY) ? 0.f : exp2f(x - mx);
      p_sh[r][p] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      m_sh[r] = mx;
      l_sh[r] = sum;
    }
  }
  hopper::cp_async_wait<0>();  // V has landed
  __syncthreads();

  // p.v: thread owns columns [cg*8, cg*8+8) for positions pg, pg +
  // kPosGroups, ...; invisible rows of v are zeros with probability 0.
  const int cg = tid % kCols;
  const int pg = tid / kCols;
  float acc[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }
#pragma unroll
  for (int it = 0; it < kSpan / kPosGroups; ++it) {
    const int p = pg + it * kPosGroups;
    float vx[8];
    load8(v_sh + p * HD + cg * 8, vx);
    if (kInt8) {
      const float s = vsc_sh[p];
#pragma unroll
      for (int i = 0; i < 8; ++i) vx[i] *= s;
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float pr = p_sh[r][p];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pr, vx[i], acc[r][i]);
    }
  }
  // Sum the position groups: inside the warp by shuffles, across warps in
  // shared memory (k's buffer, free since the scores).
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = kCols; off < 32; off <<= 1) {
        acc[r][i] += __shfl_xor_sync(kFull, acc[r][i], off);
      }
    }
  }
  float* red = reinterpret_cast<float*>(k_raw);  // [kWarps][NREP][HD]
  if (lane < kCols) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float4* dst = reinterpret_cast<float4*>(red + (warp * NREP + r) * HD + cg * 8);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NREP * (HD + 2); idx += kThreads) {
    const int r = idx / (HD + 2);
    const int c = idx % (HD + 2);
    float x;
    if (c == 0) {
      x = m_sh[r];
    } else if (c == 1) {
      x = l_sh[r];
    } else {
      x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += red[(w * NREP + r) * HD + c - 2];
    }
    part_row(a, b, g, split, r, NREP, HD)[c] = x;
  }
}

// Merge the partials of one (kv head g, lane b): thread d owns output
// column d of the NREP rows.  The live spans are read in batches whose
// loads are all issued before any of them is used, then merged into a
// running max, sum and accumulator (rescaled as the max grows).  Grid
// (KV, B), HD threads.
template <int HD, int NREP>
__global__ void __launch_bounds__(HD) paged_combine_kernel(const Args a) {
  constexpr int kRow = HD + 2;
  constexpr int kBatch = NREP >= 8 ? 2 : 16 / NREP;  // spans per batch of loads
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int n_live = live_spans(a, a.lens[b]);
  const float* base =
      a.part + (static_cast<long long>(b) * gridDim.x + g) * a.n_split * NREP * kRow;
  float mx[NREP], l[NREP], o[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    mx[r] = -INFINITY;
    l[r] = o[r] = 0.f;
  }
  for (int s0 = 0; s0 < n_live; s0 += kBatch) {
    float m[kBatch][NREP], sum[kBatch][NREP], x[kBatch][NREP];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool live = s0 + i < n_live;
      const float* sp = base + (s0 + i) * NREP * kRow;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        m[i][r] = live ? sp[r * kRow] : -INFINITY;
        sum[i][r] = live ? sp[r * kRow + 1] : 0.f;
        x[i][r] = live ? sp[r * kRow + 2 + d] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float m_new = fmaxf(mx[r], m[i][r]);
        // A span that saw nothing (m = -inf) adds nothing; the running
        // sums are rescaled only once something has been seen.
        const float keep = (mx[r] == -INFINITY) ? 0.f : exp2f(mx[r] - m_new);
        const float w = (m[i][r] == -INFINITY) ? 0.f : exp2f(m[i][r] - m_new);
        l[r] = fmaf(l[r], keep, w * sum[i][r]);
        o[r] = fmaf(o[r], keep, w * x[i][r]);
        mx[r] = m_new;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const float out = o[r] / (l[r] == 0.f ? 1.f : l[r]);
    const long long at = b * a.o_sb + static_cast<long long>(g * NREP + r) * a.o_sh + d;
    if (a.out_f32) {
      static_cast<float*>(a.out)[at] = out;
    } else {
      static_cast<bf16*>(a.out)[at] = __float2bfloat16_rn(out);
    }
  }
}

template <typename T, int HD, int NREP>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  paged_split_kernel<T, HD, NREP><<<dim3(KV, B, a.n_split), kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<HD, NREP><<<dim3(KV, B), HD, 0, stream>>>(a);
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
// HD in {64, 128}; n_rep in {1, 2, 3, 4, 8}; 1 <= BS <= 1024; and it passes
// the split plan (n_split, bps, cps, chunk) and an f32 scratch `part` of
// B * KV * n_split * n_rep * (HD + 2) elements, both from shapes alone.
// Launches the split kernel, then the combine kernel, on `stream`; returns
// the first non-zero cudaGetLastError() (0 on success).
extern "C" int tpuslo_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* lens, void* out, void* part,
    int B, int KV, int n_rep, int HD, int N, int BS, int MB, int int8_pool,
    int n_split, int bps, int cps, int chunk, long long q_sb, long long q_sh,
    long long p_sn, long long p_ss, long long p_sg, long long s_sn,
    long long s_ss, long long s_sg, long long pt_sb, long long o_sb,
    long long o_sh, float scale, int out_f32, void* stream) {
  const Args a{static_cast<const bf16*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(pt), static_cast<const int*>(lens), out,
               static_cast<float*>(part), N, BS, MB, n_split, bps, cps, chunk,
               q_sb, q_sh, p_sn, p_ss, p_sg, s_sn, s_ss, s_sg, pt_sb, o_sb,
               o_sh, scale * kLog2e, out_f32};
  if (chunk * bps > kSpan || chunk < 1 || bps < 1 || cps < 1 || n_split < 1 ||
      n_split > 65535 || B > 65535) {  // grid y and z limits
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
