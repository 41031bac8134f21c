// Attention for Hopper (sm_90a) on the inputs the two bf16 kernels do not
// take, at f32 accuracy.
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
//    int8 pools are dequantized with one f32 scale per (position, kv
//    head); the softmax has the l == 0 guard.  The split kernel in
//    paged_attention.cu takes a bf16 q over bf16 or int8 pools at head dims
//    64 and 128 with a bf16 or f32 output; this one takes everything else
//    the Pallas kernel does in the repo's configs: an f32, bf16 or f16 q
//    over f32, bf16, f16 or int8 pools, head dims 16 to 256, an f32, bf16
//    or f16 output.  Mixed types are read as f32, exactly, as Pallas casts.
//
// Precision.  The plain versions (flash_attention_reference,
// paged_decode_attention_reference) compute in f32; both kernels hold them
// within 1e-4.  TF32 alone keeps 10 mantissa bits and would not, so
// K1-f32's products on the tensor cores are split (torch's TF32 switch,
// which resolve_device turns off for cuBLAS, does not govern this kernel):
//  * f32 inputs: 3xTF32.  Each operand is a = a_hi + a_lo with a_hi = a
//    rounded to TF32 and a_lo = a - a_hi (exact; the MMA reads it
//    truncated to TF32); a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, on
//    mma.sync m16n8k8 .tf32 with f32 accumulation.  The dropped a_lo.b_lo
//    and the truncation of the low pieces are ~2^-20 of each product.
//  * bf16 and f16 inputs: q.k on mma.sync m16n8k16 with f32 accumulation,
//    exact (a product of two 8- or 11-bit significands fits in f32).  p is
//    f32, so p.v takes p in two pieces of the input type, p_hi = T(p) and
//    p_lo = T(p - p_hi), against the exact V: ~2^-17 of p for bf16.
// K2-f32 computes on the CUDA cores in f32 (FFMA), as the plain version.
// What is left differs from the plain versions in the order of the sums.
//
// What bounds them on an H100.
//  * K1-f32 does 4*D operations per visible (query, key) pair and reads
//    each input once: at S 256 ~100 operations per byte of f32 input, so
//    it is bound by operations.  The least time for those f32-accurate
//    products is 3xTF32's: three TF32 products at 495 TFLOP/s, 165
//    effective (bf16 inputs: q.k at 989, p.v in two pieces at 989 / 2),
//    against 67 TFLOP/s of FFMA.
//  * K2-f32 reads every visible position's K and V once for 4*HD*n_rep
//    operations: n_rep / 2 operations per f32 byte, far under the f32
//    ridge of ~20, so it is bound by bytes, and tensor cores would not
//    help.  What matters is how much of the live K/V is in flight.
//
// What the design does about it.
//  * K1-f32: a CTA holds 16 * RG query rows of one (head, batch row), RG
//    in {1, 2}, with four warps per 16 rows.  The two warps of a pair own
//    one half of d for q.k and the same half of the output columns for
//    p.v, so that at D 512 a thread holds 128 accumulator registers and
//    nothing spills; they add their halves of the scores through shared
//    memory (a named barrier of 64 threads) and run the same online
//    softmax.  The two pairs (key groups) of a row group take one half
//    each of every K/V tile's keys with a softmax state of their own,
//    merged at the end, which halves the chain of dependent MMAs a CTA
//    runs per tile.  Both products run on the tensor
//    cores as above; Q, K and V fragments come from shared memory with
//    ldmatrix (f32 rows read as pairs of 16-bit halves: an 8x8 b16 matrix
//    is an 8x4 f32 one), and p.v's TF32 A operand is the score
//    accumulator itself, its keys taken in the order (0, 2, 4, 6, 1, 3,
//    5, 7) on both operands.  K and V come in tiles of 32 keys (16 for
//    f32 at D 512) through a two-stage ring of cp.async copies: tile j + 1
//    is in flight while tile j is multiplied.  RG is chosen from the
//    shape alone: 2 where that still gives every SM a CTA (and the tiles
//    fit), else 1 (the f32 path's B2 S128 H2: 32 CTAs).  A causal CTA
//    stops at its last query row's key, a warp skips keys entirely above
//    its rows, and the CTAs with the most keys start first.  The
//    exponentials are ex2.approx, and the accumulator is rescaled only
//    when a row's max moved.  Left for later: wgmma (64-row warpgroup
//    tiles, V transposed while staged for TF32); mma.sync leaves each
//    tile's phases (scores, softmax, p.v, the wait for the next tile)
//    latency-bound at two warps per SM sub-partition.
//  * K2-f32: K2's flash-decoding split.  The grid is (KV, B, n_split) from
//    split_plan's shapes; each CTA owns a span of at most 64 positions of
//    one (lane, kv head) and exits at once if the span starts past the
//    lane's length.  It issues every K and V row of its span as 16-byte
//    cp.async copies (zero fills for rows that are not visible), K and V
//    in two commit groups, before any arithmetic: a span's whole 2 x 64
//    rows are in flight at once.  Scores take two threads per position
//    over halves of the row; the softmax one warp per query row; p.v one
//    thread per four columns and a group of positions.  Partials go to
//    K2's f32 scratch layout (B, KV, n_split, n_rep, HD + 2) and a combine
//    kernel, grid (KV, B), merges the live spans.  The pool's element type
//    and HD are template arguments; q's and the output's types and n_rep
//    are read at run time, so 20 split and 5 combine instantiations serve
//    every pairing.  The grid and scratch come from shapes alone, so a
//    call is captured in a CUDA graph and replayed with new lengths and
//    tables.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a CTA may take

// ---- PTX wrappers ---------------------------------------------------------

// Four 8x8 matrices of 16-bit elements from shared memory, one row address
// per lane (lanes 8i..8i+7 give the rows of matrix i, which lands in r[i]).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// Two 8x8 matrices (lanes 0-7 and 8-15 give the rows) into r[0], r[1].
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits by integer
// rounding of its bit pattern (cvt.rna.tf32 issues at a sixteenth of the
// FMA rate and bound the first version of this kernel), lo = x - hi
// exactly; the MMA reads lo's leading 10 mantissa bits and drops the rest.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a b: 16x8 A (row), 8x8 B (col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: 16x16 A (row), 16x8 B (col), bf16 or f16 in, f32 accumulate.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (sizeof(T) == 2 && std::is_same<T, bf16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 values as one register of two T (x in the low half), and the
// residuals x - T(x), y - T(y) likewise: p = hi + lo in two pieces of T.
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// 2^x on the special-function unit (ex2.approx, subnormal results
// flushed to zero: a probability under 2^-126 adds nothing at 1e-4).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier over `threads` threads of the block under id `id` (0 is
// __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16-byte cp.async that reads `src` when `valid`, else fills zeros.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// ---- K1-f32 -------------------------------------------------------------

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, n_rep;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
  int causal;
};

constexpr int kMaxRG = 2;                    // 16-row groups of a CTA at most
constexpr int kFlashThreads = 128 * kMaxRG;  // four warps per row group

// Shared-memory bytes of a K1-f32 CTA with `rg` 16-row groups and a
// two-stage ring of K/V tiles of `bk` keys: Q rows [16 rg][row], the ring
// [stage][K, V][bk][row] (rows padded by 16 bytes, so that the eight rows
// an ldmatrix phase reads fall on distinct banks), and each warp's half of
// the scores [warp][bk / 4][32] f32.
template <typename T, int D>
__host__ __device__ constexpr int flash_smem_bytes(int rg, int bk) {
  return static_cast<int>(sizeof(T)) * (D + 16 / static_cast<int>(sizeof(T))) *
             (16 * rg + 2 * 2 * bk) +
         4 * rg * (bk / 4) * 32 * 4;
}

// Keys of a tile: 32, 16 for each key group, or 16 where a ring of 32
// would leave no room for 16 query rows (f32 at D 512).
template <typename T, int D>
__host__ __device__ constexpr int flash_block_k() {
  return flash_smem_bytes<T, D>(1, 32) <= kMaxSmem ? 32 : 16;
}

template <typename T, int D>
struct FlashTile {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  static constexpr int kRow = D + kPer;
  static constexpr int kCols = D / 2;       // a warp's d's and output columns
  static constexpr int kChunks = D / kPer;  // 16-byte pieces of a row
  static constexpr int kBK = flash_block_k<T, D>();
  static constexpr int kKeys = kBK / 2;     // keys of a tile one key group takes
  static constexpr int kNT = kKeys / 8;     // its 8-key MMA groups
  static constexpr int kTile = kBK * kRow;
  static constexpr int kMaxRows = flash_smem_bytes<T, D>(2, kBK) <= kMaxSmem ? 2 : 1;
  static_assert(sizeof(T) == 4 || kKeys == 16, "16-bit p.v takes 16 keys per k-step");
  static_assert(kCols % 16 == 0, "whole MMA tiles per warp");
  // The key groups' merge at the end reuses the ring.
  static_assert(2 * kMaxRG * (4 + kCols / 2) * 32 * 4 <= 2 * 2 * kTile * sizeof(T), "merge fits");
};

// A warp's half of the scores of its kKeys keys of a tile: s[nt][i] holds
// rows (gq, gq, gq + 8, gq + 8) x keys (2 tq, 2 tq + 1, 2 tq, 2 tq + 1) of
// keys 8 nt .. 8 nt + 7, summed over d in [c0, c0 + D / 2).
template <typename T, int D>
__device__ __forceinline__ void tile_scores(float (&s)[FlashTile<T, D>::kNT][4], const T* qw,
                                            const T* ks, int c0, int lane) {
  using G = FlashTile<T, D>;
  constexpr int kNT = G::kNT;
  const int mi = lane >> 3, ri = lane & 7;
  if constexpr (sizeof(T) == 4) {
    // Two partial sums over k-steps per key group and, where the registers
    // allow it (D <= 256), one accumulator per product of the three.
    constexpr int kTerms = D <= 256 ? 3 : 1;
    constexpr int kMid = kTerms == 3 ? 1 : 0, kBig = kTerms - 1;
    float acc[2][kTerms][kNT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][t][nt][i] = 0.f;
    // A: (rows 0-7 | 8-15) x (d 0-3 | 4-7) -> a0..a3; B: keys (0-7 |
    // 8-15) x (d 0-3 | 4-7) -> b0, b1 of each key group.
    const T* qa = qw + ((mi & 1) * 8 + ri) * G::kRow + c0 + (mi >> 1) * 4;
    const T* kb = ks + ((kNT == 2 ? mi >> 1 : 0) * 8 + ri) * G::kRow + c0 + (mi & 1) * 4;
#pragma unroll
    for (int kk = 0; kk < G::kCols / 8; ++kk) {
      uint32_t a[4], b[4], ah[4], al[4], bh[4], bl[4];
      ldsm_x4(a, qa + kk * 8);
      if constexpr (kNT == 2) {
        ldsm_x4(b, kb + kk * 8);
      } else {
        ldsm_x2(b, kb + kk * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
      for (int i = 0; i < 2 * kNT; ++i) split_tf32(b[i], bh[i], bl[i]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float(&c)[kTerms][kNT][4] = acc[kk & 1];
        mma_tf32(c[0][nt], al, bh[2 * nt], bh[2 * nt + 1]);
        mma_tf32(c[kMid][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
        mma_tf32(c[kBig][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = 0.f;
#pragma unroll
        for (int t = 0; t < kTerms; ++t) x += acc[0][t][nt][i] + acc[1][t][nt][i];
        s[nt][i] = x;
      }
  } else {
    // A: (rows 0-7 | 8-15) x (d 0-7 | 8-15); B: keys (0-7 | 8-15) x (d
    // 0-7 | 8-15).  Products of bf16 or f16 values are exact in f32.  Two
    // partial sums over k-steps per key group.
    float acc[2][2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0.f;
    const T* qa = qw + ((mi & 1) * 8 + ri) * G::kRow + c0 + (mi >> 1) * 8;
    const T* kb = ks + ((mi >> 1) * 8 + ri) * G::kRow + c0 + (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < G::kCols / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qa + kk * 16);
      ldsm_x4(b, kb + kk * 16);
      mma_16816<T>(acc[kk & 1][0], a, b[0], b[1]);
      mma_16816<T>(acc[kk & 1][1], a, b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = acc[0][nt][i] + acc[1][nt][i];
  }
}

// o[nn] += p . V for the warp's output columns [c0, c0 + D / 2): p holds
// the probabilities of its kKeys keys in the score layout.
template <typename T, int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 16][4],
                                        const float (&p)[FlashTile<T, D>::kNT][4], const T* vs,
                                        int c0, int lane) {
  using G = FlashTile<T, D>;
  const int gq = lane >> 2, tq = lane & 3;
  if constexpr (sizeof(T) == 4) {
    // k-step ks covers keys 8 ks .. 8 ks + 7 with k-index tq <-> key 2 tq
    // and tq + 4 <-> key 2 tq + 1, on A (the score fragment as it is) and
    // on B (V rows 2 tq and 2 tq + 1).
#pragma unroll
    for (int ks = 0; ks < G::kNT; ++ks) {
      uint32_t a[4] = {__float_as_uint(p[ks][0]), __float_as_uint(p[ks][2]),
                       __float_as_uint(p[ks][1]), __float_as_uint(p[ks][3])};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
      const T* vr = vs + (8 * ks + 2 * tq) * G::kRow + c0 + gq;
#pragma unroll
      for (int nn = 0; nn < G::kCols / 8; ++nn) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(__float_as_uint(vr[8 * nn]), bh0, bl0);
        split_tf32(__float_as_uint(vr[G::kRow + 8 * nn]), bh1, bl1);
        mma_tf32(o[nn], al, bh0, bh1);
        mma_tf32(o[nn], ah, bl0, bl1);
        mma_tf32(o[nn], ah, bh0, bh1);
      }
    }
  } else {
    // A: p in two pieces of T; B: V through ldmatrix.trans, matrices keys
    // (0-7 | 8-15) x columns (8 nn | 8 nn + 8).
    uint32_t ah[4], al[4];
    split_pair<T>(p[0][0], p[0][1], ah[0], al[0]);
    split_pair<T>(p[0][2], p[0][3], ah[1], al[1]);
    split_pair<T>(p[1][0], p[1][1], ah[2], al[2]);
    split_pair<T>(p[1][2], p[1][3], ah[3], al[3]);
    const int mi = lane >> 3, ri = lane & 7;
    const T* vb = vs + ((mi & 1) * 8 + ri) * G::kRow + c0 + (mi >> 1) * 8;
#pragma unroll
    for (int nn = 0; nn < G::kCols / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, vb + 16 * nn);
      mma_16816<T>(o[2 * nn], al, b[0], b[1]);
      mma_16816<T>(o[2 * nn], ah, b[0], b[1]);
      mma_16816<T>(o[2 * nn + 1], al, b[2], b[3]);
      mma_16816<T>(o[2 * nn + 1], ah, b[2], b[3]);
    }
  }
}

// Warp w of a CTA: side w & 1 (its half of d and of the output columns),
// key group (w >> 1) & 1 (its half of every tile's keys), row group w >> 2.
template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_f32_kernel(const FlashArgs a) {
  using G = FlashTile<T, D>;
  constexpr int kNT = G::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 16 * (blockDim.x / 128);
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + rows * G::kRow;
  float* sx = reinterpret_cast<float*>(ring + 2 * 2 * G::kTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int side = warp & 1, kg = (warp >> 1) & 1, rg = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  // The last query rows first: under a causal mask they see the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.n_rep;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  // A causal CTA sees keys up to its last query row and no further.
  const int k_end = a.causal ? min(q0 + rows, a.S) : a.S;
  const int n_tiles = (k_end + G::kBK - 1) / G::kBK;

  // A thread copies one 16-byte piece of every (blockDim.x / kChunks)-th
  // row of a tile, from row tid / kChunks on.
  const int r_first = tid / G::kChunks, c_own = (tid % G::kChunks) * G::kPer;
  const int r_step = blockDim.x / G::kChunks;
  auto load_tile = [&](int j) {
    T* kt = ring + (j & 1) * 2 * G::kTile + r_first * G::kRow + c_own;
    const T* ksrc = k + (static_cast<long long>(j) * G::kBK + r_first) * a.k_ss + c_own;
    const T* vsrc = v + (static_cast<long long>(j) * G::kBK + r_first) * a.v_ss + c_own;
    for (int r = r_first; r < G::kBK; r += r_step) {
      hopper::cp_async16(kt, ksrc);
      hopper::cp_async16(kt + G::kTile, vsrc);
      kt += r_step * G::kRow;
      ksrc += r_step * a.k_ss;
      vsrc += r_step * a.v_ss;
    }
  };
  // Q and the first tile in one commit group, then one group per tile.
  for (int i = tid; i < rows * G::kChunks; i += blockDim.x) {
    const int r = i / G::kChunks, c = (i % G::kChunks) * G::kPer;
    hopper::cp_async16(qs + r * G::kRow + c, q + static_cast<long long>(q0 + r) * a.q_ss + c);
  }
  load_tile(0);
  hopper::cp_async_commit();

  const int row0 = q0 + 16 * rg;   // the warp's first query row
  const int c0 = side * G::kCols;  // its first d and output column
  const T* qw = qs + 16 * rg * G::kRow;
  float o[G::kCols / 8][4];
#pragma unroll
  for (int nn = 0; nn < G::kCols / 8; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nn][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile j (and Q) have landed for this thread
    __syncthreads();             // and for every thread
    const int k0 = j * G::kBK + kg * G::kKeys;  // the warp's first key
    if (!a.causal || k0 <= row0 + 15) {  // else every key it holds is above its rows
      const T* kt = ring + (j & 1) * 2 * G::kTile + kg * G::kKeys * G::kRow;
      const T* vt = kt + G::kTile;
      float s[kNT][4];
      tile_scores<T, D>(s, qw, kt, c0, lane);
      // Add the pair's other half of d.
      float* mine = sx + warp * (kNT * 128);
      const float* other = sx + (warp ^ 1) * (kNT * 128);
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) mine[i * 32 + lane] = s[i >> 2][i & 3];
      bar_sync(1 + 2 * rg + kg, 64);
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) s[i >> 2][i & 3] += other[i * 32 + lane];

      // Online softmax in log2 units; rows gq (i = 0, 1) and gq + 8 (i = 2, 3).
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * nt + 2 * tq + (i & 1);
          const int row = row0 + gq + 8 * (i >> 1);
          const float x = s[nt][i] * a.scale_log2;
          s[nt][i] = (a.causal && key > row) ? -INFINITY : x;
        }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        // Nothing visible yet in this row: the accumulator stays zero.
        alpha[rr] = m_new == -INFINITY ? 1.f : fast_exp2(m[rr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[nt][2 * rr + e];
            const float pe = x == -INFINITY ? 0.f : fast_exp2(x - m_new);
            s[nt][2 * rr + e] = pe;
            sum += pe;
          }
        l[rr] = l[rr] * alpha[rr] + sum;  // this thread's share; the quad's sum at the end
        m[rr] = m_new;
      }
      // Rescale the accumulator only where a row's max moved (once the
      // first tiles have set it, rarely).
      if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nn = 0; nn < G::kCols / 8; ++nn) {
          o[nn][0] *= alpha[0];
          o[nn][1] *= alpha[0];
          o[nn][2] *= alpha[1];
          o[nn][3] *= alpha[1];
        }
      }
      tile_pv<T, D>(o, s, vt, c0, lane);
    }
    __syncthreads();  // the stage is read before tile j + 2 overwrites it
  }

  // Merge the key groups: group 1 hands its max, sums and accumulator to
  // group 0 through shared memory (the ring, read by now), lane by lane:
  // both hold the same rows and columns in the same registers.
  float* xs = reinterpret_cast<float*>(ring) + (2 * rg + side) * (4 + G::kCols / 2) * 32;
  if (kg == 1) {
    xs[lane] = m[0];
    xs[32 + lane] = m[1];
    xs[64 + lane] = l[0];
    xs[96 + lane] = l[1];
#pragma unroll
    for (int nn = 0; nn < G::kCols / 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[(4 + 4 * nn + i) * 32 + lane] = o[nn][i];
  }
  __syncthreads();
  if (kg == 1) return;
  T* out = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + c0 + 2 * tq;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m1 = xs[32 * rr + lane];
    const float mx = fmaxf(m[rr], m1);
    const float w0 = m[rr] == -INFINITY ? 0.f : fast_exp2(m[rr] - mx);
    const float w1 = m1 == -INFINITY ? 0.f : fast_exp2(m1 - mx);
    float sum = l[rr] * w0 + xs[(2 + rr) * 32 + lane] * w1;
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float denom = sum == 0.f ? 1.f : sum;
    T* at = out + static_cast<long long>(row0 + gq + 8 * rr) * a.o_ss;
#pragma unroll
    for (int nn = 0; nn < G::kCols / 8; ++nn) {
      const float x0 = o[nn][2 * rr] * w0 + xs[(4 + 4 * nn + 2 * rr) * 32 + lane] * w1;
      const float x1 = o[nn][2 * rr + 1] * w0 + xs[(5 + 4 * nn + 2 * rr) * 32 + lane] * w1;
      store2(at + 8 * nn, x0 / denom, x1 / denom);
    }
  }
}

template <typename T, int D>
int launch_flash(const FlashArgs& a, int B, int H, cudaStream_t stream) {
  using G = FlashTile<T, D>;
  auto kernel = &flash_f32_kernel<T, D>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Above 48 KB of shared memory only after opting in.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               flash_smem_bytes<T, D>(G::kMaxRows, G::kBK));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 32 rows per CTA where that still gives every SM a CTA, else 16.
  int rg = G::kMaxRows;
  if (rg == 2 && static_cast<long long>(a.S / 32) * H * B < sms) rg = 1;
  const dim3 grid(a.S / (16 * rg), H, B);
  kernel<<<grid, 128 * rg, flash_smem_bytes<T, D>(rg, G::kBK), stream>>>(a);
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

constexpr int kThreads = 128;  // threads of a K2-f32 split CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 64;      // positions a split CTA holds at most
constexpr int kMaxRep = 8;     // query rows per kv head at most

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* lens;
  void* out;
  float* part;  // f32 scratch (B, KV, n_split, n_rep, HD + 2)
  int N, BS, MB, n_rep;
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
  int q_dtype, out_dtype;      // 0 f32, 1 bf16, 2 f16
};

// How many spans of a lane of length `len` hold a visible position: a
// prefix of the split index (K2's rule; both kernels decide by it).
__device__ __forceinline__ int live_spans(const PagedArgs& a, int len) {
  if (len < 0) return 0;
  if (len >= a.MB * a.BS) return a.n_split;
  return (len / a.BS / a.bps) * a.cps + (len % a.BS) / a.chunk + 1;
}

__device__ __forceinline__ float load_elem(const void* p, long long i, int dtype) {
  switch (dtype) {
    case 1: return __bfloat162float(static_cast<const bf16*>(p)[i]);
    case 2: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_elem(void* p, long long i, int dtype, float x) {
  switch (dtype) {
    case 1: static_cast<bf16*>(p)[i] = __float2bfloat16_rn(x); break;
    case 2: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(p)[i] = x;
  }
}

// 16 bytes of a row as f32: 4 f32, 8 bf16 or f16, or 16 int8 codes.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(c[i]);
}

// Four consecutive elements as f32.
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
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of one split instantiation (byte offsets).  K rows
// are padded by 16 bytes where a row is an even number of 16-byte pieces,
// so that the score loop's 16-byte reads (thread p on row p) fall on
// distinct banks; V rows are read by consecutive threads along a row and
// stay unpadded.
template <typename T, int HD>
struct PagedTile {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  static constexpr int kChunks = HD / kPer;                      // 16-byte pieces of a row
  static constexpr int kKRow = HD + (kChunks % 2 == 0 ? kPer : 0);
  static constexpr int kColGroups = HD / 4;                      // p.v: 4 columns a thread
  static constexpr int kPosGroups = kThreads / kColGroups;
  static constexpr int kK = 0;
  static constexpr int kV = kK + align16(kSpan * kKRow * static_cast<int>(sizeof(T)));
  static constexpr int kQ = kV + align16(kSpan * HD * static_cast<int>(sizeof(T)));
  // The two halves of the scores [2][kMaxRep][kSpan], later the p.v
  // partials [kPosGroups][kMaxRep][HD].
  static constexpr int kRed = kQ + kMaxRep * HD * 4;
  static constexpr int kRedBytes = 2 * kMaxRep * kSpan * 4 > kPosGroups * kMaxRep * HD * 4
                                       ? 2 * kMaxRep * kSpan * 4
                                       : kPosGroups * kMaxRep * HD * 4;
  static constexpr int kP = kRed + kRedBytes;               // [kMaxRep][kSpan] f32
  static constexpr int kOff = kP + kMaxRep * kSpan * 4;     // [kSpan] row offsets
  static constexpr int kScales = kOff + kSpan * 8;          // [2][kSpan] int8 scales
  static constexpr int kStats = kScales + 2 * kSpan * 4;    // m, l [2][kMaxRep]
  static constexpr int kBytes = kStats + 2 * kMaxRep * 4;
  static_assert(HD % kPer == 0 && kChunks >= 1, "whole 16-byte pieces per row");
  static_assert(kThreads % kColGroups == 0 && kSpan % kPosGroups == 0, "p.v tiling");
  static_assert(kBytes <= kMaxSmem, "fits in shared memory");
};

// T: pool element type (f32, bf16, f16 or int8 codes); HD: head dim.  Grid
// (KV, B, n_split), 128 threads.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_f32_kernel(const PagedArgs a) {
  using G = PagedTile<T, HD>;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sh = reinterpret_cast<T*>(smem + G::kK);
  T* v_sh = reinterpret_cast<T*>(smem + G::kV);
  float* q_sh = reinterpret_cast<float*>(smem + G::kQ);
  float* red = reinterpret_cast<float*>(smem + G::kRed);
  float* p_sh = reinterpret_cast<float*>(smem + G::kP);
  long long* row_off = reinterpret_cast<long long*>(smem + G::kOff);
  float* ksc = reinterpret_cast<float*>(smem + G::kScales);
  float* vsc = ksc + kSpan;
  float* m_sh = reinterpret_cast<float*>(smem + G::kStats);
  float* l_sh = m_sh + kMaxRep;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nrep = a.n_rep;

  const int j0 = (split / a.cps) * a.bps;       // first logical block of the span
  const int s_lo = (split % a.cps) * a.chunk;   // first position in each block
  const int width = min(a.chunk, a.BS - s_lo);  // positions per block
  const int nb = min(a.bps, a.MB - j0);         // blocks in the span
  // Thread p < 64 reads the table entry of row p's block together with the
  // length (the entry exists whatever the length is).
  const int jj = tid / width;
  const bool in_table = tid < kSpan && jj < nb;
  const int phys = in_table ? a.pt[b * a.pt_sb + j0 + jj] : -1;
  const int len = a.lens[b];
  if (split >= live_spans(a, len)) return;

  // Where each row of the span lives, if it is visible (-1 if not).
  long long so = -1;
  if (tid < kSpan) {
    const int s = s_lo + tid % width;
    long long off = -1;
    if (in_table && (j0 + jj) * a.BS + s <= len && (unsigned)phys < (unsigned)a.N) {
      off = static_cast<long long>(phys) * a.p_sn + s * a.p_ss + g * a.p_sg;
      so = static_cast<long long>(phys) * a.s_sn + s * a.s_ss + g * a.s_sg;
    }
    row_off[tid] = off;
  }
  __syncthreads();

  // Every copy of the span before any arithmetic: K, then V; rows that are
  // not visible are zero-filled, never read.
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  for (int i = tid; i < kSpan * G::kChunks; i += kThreads) {
    const int p = i / G::kChunks, c = (i % G::kChunks) * G::kPer;
    const long long off = row_off[p];
    cp_async16_zfill(k_sh + p * G::kKRow + c, off >= 0 ? kp + off + c : kp, off >= 0);
  }
  hopper::cp_async_commit();
  for (int i = tid; i < kSpan * G::kChunks; i += kThreads) {
    const int p = i / G::kChunks, c = (i % G::kChunks) * G::kPer;
    const long long off = row_off[p];
    cp_async16_zfill(v_sh + p * HD + c, off >= 0 ? vp + off + c : vp, off >= 0);
  }
  hopper::cp_async_commit();
  if (kInt8 && tid < kSpan) {
    ksc[tid] = so >= 0 ? a.ks[so] : 0.f;
    vsc[tid] = so >= 0 ? a.vs[so] : 0.f;
  }
  // The kv head's query rows as f32, while the copies fly.
  for (int i = tid; i < nrep * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    q_sh[i] = load_elem(a.q, b * a.q_sb + static_cast<long long>(g * nrep + r) * a.q_sh + d,
                        a.q_dtype);
  }
  hopper::cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();             // and everyone's

  // Scores: thread (position p, half hf) over the 16-byte pieces c = hf,
  // hf + 2, ... of k row p, for every query row.
  {
    const int p = tid % kSpan, hf = tid / kSpan;
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
    for (int c = hf; c < G::kChunks; c += 2) {
      float x[G::kPer];
      load16(k_sh + p * G::kKRow + c * G::kPer, x);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < nrep) {
          const float* qr = q_sh + r * HD + c * G::kPer;
#pragma unroll
          for (int e = 0; e < G::kPer; ++e) s[r] = fmaf(qr[e], x[e], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < nrep) red[(hf * kMaxRep + r) * kSpan + p] = s[r];
  }
  __syncthreads();
  // Scaled (log2 units; an int8 code's scale multiplies its score) and
  // masked: thread (p, hf) takes query rows hf, hf + 2, ...
  {
    const int p = tid % kSpan, hf = tid / kSpan;
    const bool visible = row_off[p] >= 0;
    const float f = (kInt8 ? ksc[p] : 1.f) * a.scale_log2;
    for (int r = hf; r < nrep; r += 2) {
      const float x = red[r * kSpan + p] + red[(kMaxRep + r) * kSpan + p];
      p_sh[r * kSpan + p] = visible ? x * f : -INFINITY;
    }
  }
  __syncthreads();

  // The span's max and sum per query row, one warp per row; scores become
  // probabilities relative to the span's max.
  for (int r = warp; r < nrep; r += kWarps) {
    float* pr = p_sh + r * kSpan;
    float mx = fmaxf(pr[lane], pr[lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x = pr[lane + 32 * i];
      const float e = x == -INFINITY ? 0.f : exp2f(x - mx);
      pr[lane + 32 * i] = e;
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

  // p.v: thread (cg, pg) owns columns 4 cg .. 4 cg + 3 over positions pg,
  // pg + kPosGroups, ...; rows that are not visible are zeros with
  // probability 0.
  {
    const int cg = tid % G::kColGroups, pg = tid / G::kColGroups;
    float acc[kMaxRep][4];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
#pragma unroll 4
    for (int p = pg; p < kSpan; p += G::kPosGroups) {
      const float4 vv = load4(v_sh + p * HD + 4 * cg);
      const float f = kInt8 ? vsc[p] : 1.f;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < nrep) {
          const float w = p_sh[r * kSpan + p] * f;
          acc[r][0] = fmaf(w, vv.x, acc[r][0]);
          acc[r][1] = fmaf(w, vv.y, acc[r][1]);
          acc[r][2] = fmaf(w, vv.z, acc[r][2]);
          acc[r][3] = fmaf(w, vv.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < nrep)
        *reinterpret_cast<float4*>(red + (pg * kMaxRep + r) * HD + 4 * cg) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  // The span's partial per query row: max (log2 units), sum, accumulator.
  float* part = a.part + ((static_cast<long long>(b) * gridDim.x + g) * a.n_split + split) *
                             nrep * (HD + 2);
  for (int idx = tid; idx < nrep * (HD + 2); idx += kThreads) {
    const int r = idx / (HD + 2), c = idx % (HD + 2);
    float x;
    if (c == 0) {
      x = m_sh[r];
    } else if (c == 1) {
      x = l_sh[r];
    } else {
      x = 0.f;
      for (int pg = 0; pg < G::kPosGroups; ++pg) x += red[(pg * kMaxRep + r) * HD + c - 2];
    }
    part[idx] = x;
  }
}

// Merge the partials of one (kv head g, lane b): thread d owns output
// column d.  The live spans are read in batches whose loads are all issued
// before any is used, and merged into a running max, sum and accumulator
// (rescaled as the max grows).  Grid (KV, B), HD threads.
template <int HD>
__global__ void __launch_bounds__(HD) paged_f32_combine_kernel(const PagedArgs a) {
  constexpr int kRow = HD + 2;
  constexpr int kBatch = 8;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int nrep = a.n_rep;
  const int n_live = live_spans(a, a.lens[b]);
  const float* base =
      a.part + (static_cast<long long>(b) * gridDim.x + g) * a.n_split * nrep * kRow;
  for (int r = 0; r < nrep; ++r) {
    float mx = -INFINITY, l = 0.f, o = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += kBatch) {
      float m[kBatch], sum[kBatch], x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool live = s0 + i < n_live;
        const float* sp = base + ((s0 + i) * nrep + r) * kRow;
        m[i] = live ? sp[0] : -INFINITY;
        sum[i] = live ? sp[1] : 0.f;
        x[i] = live ? sp[2 + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float m_new = fmaxf(mx, m[i]);
        // A span that saw nothing (m = -inf) adds nothing; the running
        // sums are rescaled only once something has been seen.
        const float keep = mx == -INFINITY ? 0.f : exp2f(mx - m_new);
        const float w = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_new);
        l = fmaf(l, keep, w * sum[i]);
        o = fmaf(o, keep, w * x[i]);
        mx = m_new;
      }
    }
    store_elem(a.out, b * a.o_sb + static_cast<long long>(g * nrep + r) * a.o_sh + d,
               a.out_dtype, o / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
int launch_paged(const PagedArgs& a, int B, int KV, cudaStream_t stream) {
  auto kernel = &paged_f32_kernel<T, HD>;
  constexpr int bytes = PagedTile<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(KV, B, a.n_split), kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_f32_combine_kernel<HD><<<dim3(KV, B), HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_paged(const PagedArgs& a, int B, int KV, int HD, cudaStream_t stream) {
  switch (HD) {
    case 16: return launch_paged<T, 16>(a, B, KV, stream);
    case 32: return launch_paged<T, 32>(a, B, KV, stream);
    case 64: return launch_paged<T, 64>(a, B, KV, stream);
    case 128: return launch_paged<T, 128>(a, B, KV, stream);
    case 256: return launch_paged<T, 256>(a, B, KV, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, loaded with ctypes.  Pointers and the stream arrive as
// void*, strides in elements.  Each returns cudaGetLastError() after its
// launches (0 on success), or cudaErrorInvalidValue for a head dim, dtype,
// group size or geometry it is not built for.

// K1-f32.  dtype: 0 f32, 1 bf16, 2 f16, the same for q, k, v and the
// output.  The wrapper has checked: D in {128, 256, 384, 512}, S a
// multiple of 128, H % KV == 0, unit inner strides, rows and starts
// 16-byte aligned, one device.
extern "C" int tpuslo_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int S, int H,
    int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  if (KV < 1 || H % KV || S < 64 || S % 64 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q, k, v, o, S, H / KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                    v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale * kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_flash<float>(a, B, H, D, st);
    case 1: return dispatch_flash<bf16>(a, B, H, D, st);
    case 2: return dispatch_flash<__half>(a, B, H, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2-f32.  q_dtype and out_dtype: 0 f32, 1 bf16, 2 f16; pool_dtype: 0 f32,
// 1 bf16, 2 f16, 3 int8 codes (ks/vs: their f32 scales (N, BS, KV), else
// null).  The wrapper has checked: q (B, H, HD) with unit inner stride;
// pools (N, BS, KV, HD) of one layout with unit inner stride and rows
// 16-byte aligned; int32 page table (B, MB) with unit inner stride and
// contiguous int32 lengths (B,); HD in {16, 32, 64, 128, 256}; n_rep in
// {1, 2, 3, 4, 8}; 1 <= BS <= 1024; and it passes the split plan (n_split,
// bps, cps, chunk) and an f32 scratch `part` of B * KV * n_split * n_rep *
// (HD + 2) elements, both from shapes alone.  Launches the split kernel,
// then the combine kernel, on `stream`.
extern "C" int tpuslo_paged_decode_attention_f32(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* pt, const void* lens, void* out, void* part, int q_dtype, int pool_dtype,
    int out_dtype, int B, int KV, int n_rep, int HD, int N, int BS, int MB, int n_split,
    int bps, int cps, int chunk, long long q_sb, long long q_sh, long long p_sn,
    long long p_ss, long long p_sg, long long s_sn, long long s_ss, long long s_sg,
    long long pt_sb, long long o_sb, long long o_sh, float scale, void* stream) {
  const PagedArgs a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                    static_cast<const int*>(pt), static_cast<const int*>(lens), out,
                    static_cast<float*>(part), N, BS, MB, n_rep, n_split, bps, cps, chunk,
                    q_sb, q_sh, p_sn, p_ss, p_sg, s_sn, s_ss, s_sg, pt_sb, o_sb, o_sh,
                    scale * kLog2e, q_dtype, out_dtype};
  if (chunk * bps > kSpan || chunk < 1 || bps < 1 || cps < 1 || n_split < 1 ||
      n_split > 65535 || B > 65535 || KV < 1 || n_rep < 1 || n_rep > kMaxRep ||
      q_dtype < 0 || q_dtype > 2 || out_dtype < 0 || out_dtype > 2 ||
      (pool_dtype == 3) != (ks != nullptr && vs != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case 0: return dispatch_paged<float>(a, B, KV, HD, st);
    case 1: return dispatch_paged<bf16>(a, B, KV, HD, st);
    case 2: return dispatch_paged<__half>(a, B, KV, HD, st);
    case 3: return dispatch_paged<int8_t>(a, B, KV, HD, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
