// Fused causal / non-causal attention forward for Hopper (sm_90a):
// warpgroup products over an asynchronous K/V ring.
//
// Replaces: tpuslo/ops/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel driven by _flash_forward_kernel (pallas_call) and reached through
// flash_attention.  It computes the same function: for q (B,S,H,D) and
// k/v (B,S,KV,D) in bf16, softmax(q k^T / sqrt(D)) v per head, with head h
// reading kv head h / (H/KV) (grouped-query attention), an optional causal
// mask, f32 running max / normaliser / accumulator, and the output in bf16.
// It is instantiated for head dims 128 and 256 (the TPU kernel takes any
// multiple of 128; no model of the repo goes past 256).
//
// What bounds it on an H100.  Causal attention does 2*B*H*S^2*D operations
// (q k^T and p v, each 2*S^2*D per head, halved by the mask) on
// 2*(2*B*S*H*D + 2*B*S*KV*D) bytes (q and o, k and v, each read or written
// once in bf16).  That is about S/3 operations per byte at H=24, KV=8,
// D=128: below the card's ~295 op/byte ridge up to S ~ 900 (bytes bound),
// above it beyond (tensor-core bound).  At the serve shapes (S 128-256) a
// call is a few microseconds, so what costs is the latency of the first
// loads and of each key tile's products; at S 2048 it is the tensor-core
// rate, which on Hopper only wgmma reaches.
//
// What the design does about it.
//  * The (S,S) logits and probabilities never reach device memory: one
//    CTA owns a 64-row query tile of one (b, h) and walks the 64-key tiles
//    with the online-softmax recurrence.  Key tiles past the causal
//    diagonal are never visited, which halves the work as the TPU kernel's
//    pl.when skip does; query tiles are scheduled heaviest first so that
//    the long causal rows start early.
//  * A CTA is one consumer warpgroup (128 threads, the products and the
//    softmax) and one producer warp.  Loads are TMA tile copies: the
//    wrapper's strided (B,S,H,D) tensors are described by 4-D tensor maps
//    (encoded on the host per call by cuTensorMapEncodeTiled, looked up at
//    run time with cudaGetDriverEntryPoint, so nothing links libcuda); a
//    64 x D tile is D / 64 boxes of 64 x 64, since the 128-byte swizzle
//    allows 128-byte rows.  The producer issues Q and the first two K and V tiles
//    before anyone waits, then refills each stage of the two-stage K ring
//    and V ring as soon as the consumers release it (K of tile t after tile
//    t-2's scores, V after tile t-2's p v), so issuing copies never sits on
//    the consumers' path.  Each stage has a "full" mbarrier that counts the
//    TMA bytes and an "empty" one that counts the 4 consumer warps.
//  * Both products are warpgroup MMAs (wgmma.mma_async, bf16 in, f32
//    accumulate).  S = Q K^T: m64n64k16, A and B from shared memory through
//    128-byte-swizzled descriptors (D / 16 k-steps across the D boxes).
//    O += P V: m64n128k16 per 128 output columns with P from registers
//    (the RS form): the S
//    accumulator's layout per warp is the A fragment's, so the
//    probabilities are rounded to bf16 in registers and never touch shared
//    memory; V is the B operand read transposed through its descriptor
//    (legal for 16-bit types).  The TPU kernel keeps p in f32 for that
//    product; this rounding of p to bf16 is the one arithmetic difference,
//    and the normaliser is still summed from the f32 p.
//  * Inside the warpgroup, tile kt's Q K^T is issued together with tile
//    kt-1's P V, and tile kt's softmax runs while that P V is on the tensor
//    cores.  The softmax costs one FFMA and one ex2 per score (the scale is
//    folded into the exponent), and the accumulator's rescale is skipped
//    when no row of a warp has a new max.
//  * The epilogue rounds the output tile into Q's buffer in the swizzled
//    layout and writes it with two TMA stores.
//  * Shared memory: Q 16 KB + 2 stages x (K 16 KB + V 16 KB) at D 128,
//    dynamic, so two CTAs fit on an SM and one's softmax also overlaps the
//    other's products.  At D 256 every tile doubles (160 KB, one CTA per
//    SM) and the accumulator takes 128 registers a thread.
//  * Left for later: 128-row query tiles over two consumer warpgroups with
//    setmaxnreg, which would share each K/V tile between twice the rows.

#include <cuda.h>  // CUtensorMap and the tensor-map enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;    // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 128;  // the consumer warpgroup; a producer warp comes on top
constexpr int kStages = 2;     // K/V ring depth
constexpr int kBox = 64 * 64;  // elements of one 64 x 64 swizzled box
static_assert(kStages == 2, "the ring's refill order below assumes two stages");

// The shapes of one head dim kD (128 or 256): a 64 x kD tile of Q, K, V
// or O is kD / 64 boxes; the accumulator is kD / 128 blocks of 64 x 128.
template <int kD>
struct Dims {
  static_assert(kD == 128 || kD == 256, "instantiated for head dims 128 and 256");
  static constexpr int kBoxes = kD / 64;
  static constexpr int kTileElems = kBoxes * kBox;
  static constexpr int kTileBytes = kTileElems * 2;  // 16 or 32 KB
  static constexpr int kAccBlocks = kD / 128;
  static constexpr int kSmemBytes =
      (1 + 2 * kStages) * kTileBytes + 128 + 1024;  // + barriers, alignment
};

typedef __nv_bfloat16 bf16;

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define TPUSLO_F8(d, i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPUSLO_F8(d, 0), TPUSLO_F8(d, 8), TPUSLO_F8(d, 16), TPUSLO_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 fragments),
// B in shared memory, MN-major (transposed through the descriptor).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TPUSLO_F8(d, 0), TPUSLO_F8(d, 8), TPUSLO_F8(d, 16), TPUSLO_F8(d, 24),
        TPUSLO_F8(d, 32), TPUSLO_F8(d, 40), TPUSLO_F8(d, 48), TPUSLO_F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef TPUSLO_F8

// Issue s = q k^T for one key tile (not waited for): kD / 16 k-steps of
// 16 over D; a step moves 32 bytes inside a 128-byte swizzled row, and
// every fourth step starts the next D box.  The first step overwrites s.
template <int kD>
__device__ __forceinline__ void issue_scores(float (&s)[32], const bf16* q_s, const bf16* k_s) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 16;
    wgmma_ss_m64n64k16(s, hopper::sw128_desc(q_s + off, 16, 1024),
                       hopper::sw128_desc(k_s + off, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// Issue acc += p v for one key tile (not waited for): the accumulator of
// key columns [16kk, 16kk + 16) is the A fragment pa[4kk .. 4kk+3] of one
// 16-key slice; v's 16 rows of that slice start 2048 bytes apart, and the
// two D boxes of one 128-column accumulator block 8192 bytes apart (the
// leading offset); block c reads boxes 2c and 2c + 1.
template <int kD>
__device__ __forceinline__ void issue_pv(float (&acc)[kD / 128][64], const uint32_t (&pa)[16],
                                         const bf16* v_s) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < kD / 128; ++c) {
      wgmma_rs_m64n128k16(acc[c], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          hopper::sw128_desc(v_s + 2 * c * kBox + kk * 16 * 64, kBox * 2, 1024));
    }
  }
  hopper::wgmma_commit();
}

// 2^x on the special-function unit (inputs of -inf give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one tile of scores, in place.  s[4j + i] holds row
// g (i < 2) or g + 8, key column 8j + 2t + (i & 1).  Masks keys past the
// diagonal, updates the running max (log2 units) and sum of rows g and
// g + 8, turns the scores into probabilities exp2(s * scale - max) (one
// FFMA and one ex2 each) and returns the rescale of the older accumulator
// in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             bool diag, int row0, int k0, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (diag) {
        const int row = row0 + (i >= 2 ? 8 : 0);
        const int col = k0 + 8 * j + 2 * t + (i & 1);
        if (col > row) s[4 * j + i] = -INFINITY;
      }
      mx[i >> 1] = fmaxf(mx[i >> 1], s[4 * j + i]);
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * scale_log2);  // scale > 0 keeps the order
    // A row with nothing visible yet keeps max -inf; exp2(-inf - 0) = 0.
    m_use[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
    alpha[r] = (m_run[r] == -INFINITY) ? 0.f : ex2(m_run[r] - m_use[r]);
    m_run[r] = mx[r];
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
    s[i] = p;
    rsum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    l_run[r] = alpha[r] * l_run[r] + rsum[r];
  }
}

// The probabilities as bf16 A fragments: pa[4kk + m] holds columns
// 16kk + 8(m / 2) + 2t, +1 of row g (m even) or g + 8 (m odd).
__device__ __forceinline__ void pack_probs(const float (&s)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// acc *= alpha per row; skipped when no row of the warp has a new max.
template <int kD>
__device__ __forceinline__ void rescale(float (&acc)[kD / 128][64], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int c = 0; c < kD / 128; ++c) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[c][4 * j + 0] *= alpha[0];
      acc[c][4 * j + 1] *= alpha[0];
      acc[c][4 * j + 2] *= alpha[1];
      acc[c][4 * j + 3] *= alpha[1];
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads + 32)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, int S, int n_rep,
                     float scale_log2, int causal) {
  using T = Dims<kD>;
  constexpr int kTileElems = T::kTileElems;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms want 1024-byte alignment.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // later the output tile
  bf16* k_s = q_s + kTileElems;              // stage st: k_s + st * kTileElems
  bf16* v_s = k_s + kStages * kTileElems;    // stage st: v_s + st * kTileElems
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kTileElems);
  // A stage's "full" barrier counts the TMA bytes of its tile; its "empty"
  // barrier counts the 4 consumer warps done reading it.
  const uint32_t bar_q = hopper::smem_u32(bars);
  const uint32_t full_k = hopper::smem_u32(bars + 1);   // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  // Blocks are issued in order of linear index (x fastest), so the query
  // tile is the slowest grid axis, reversed: the heaviest causal tiles of
  // every head start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_tile = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / n_rep;
  const int q0 = q_tile * kBlockM;
  const int n_tiles = causal ? q_tile + 1 : S / kBlockN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Key tile `tile` of K (or V) into ring stage tile % 2, box by box.
  auto load = [&](const CUtensorMap* map, bf16* ring, uint32_t full, int tile) {
    const int stage = tile % kStages;
    const uint32_t bar = full + 8 * stage;
    bf16* dst = ring + stage * kTileElems;
    hopper::mbar_expect_tx(bar, T::kTileBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      hopper::tma_load_4d(dst + x * kBox, map, bar, 64 * x, kvh, tile * kBlockN, b);
    }
  };
  // The (tile / 2)-th use of a stage completes phase parity (tile / 2) & 1.
  auto wait_tile = [&](uint32_t full, int tile) {
    hopper::mbar_wait(full + 8 * (tile % kStages), (tile / kStages) & 1);
  };

  // The producer (warp 4, one lane) sets up the barriers and issues Q and
  // the first two K/V tiles before anyone waits.
  const bool producer = warp == kThreads / 32;
  if (producer && lane == 0) {
    hopper::prefetch_tensormap(&tm_q);
    hopper::prefetch_tensormap(&tm_k);
    hopper::prefetch_tensormap(&tm_v);
    hopper::mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full_k + 8 * st, 1);
      hopper::mbar_init(full_v + 8 * st, 1);
      hopper::mbar_init(empty_k + 8 * st, kThreads / 32);
      hopper::mbar_init(empty_v + 8 * st, kThreads / 32);
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(bar_q, T::kTileBytes);
    for (int x = 0; x < T::kBoxes; ++x) {
      hopper::tma_load_4d(q_s + x * kBox, &tm_q, bar_q, 64 * x, h, q0, b);
    }
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) {
      load(&tm_k, k_s, full_k, tile);
      load(&tm_v, v_s, full_v, tile);
    }
  }
  __syncthreads();  // the barriers are initialised

  if (producer) {
    // Refill each stage once the consumers have released it: K of tile t
    // after tile t-2's scores, V of tile t after tile t-2's p v.
    if (lane == 0) {
      hopper::prefetch_tensormap(&tm_o);
      for (int tile = kStages; tile < n_tiles; ++tile) {
        const uint32_t parity = ((tile / kStages) + 1) & 1;
        hopper::mbar_wait(empty_k + 8 * (tile % kStages), parity);
        load(&tm_k, k_s, full_k, tile);
        hopper::mbar_wait(empty_v + 8 * (tile % kStages), parity);
        load(&tm_v, v_s, full_v, tile);
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  auto release = [&](uint32_t empty, int tile) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + 8 * (tile % kStages));
  };
  float acc[T::kAccBlocks][64];  // O: 64 rows x kD columns over the warpgroup
#pragma unroll
  for (int c = 0; c < T::kAccBlocks; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[c][i] = 0.f;
  }
  // Rows g and g+8 of this warp's 16: running max (log2 units) and sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;
  float s[32];
  float alpha[2];
  uint32_t pa[16];  // probabilities of the previous tile, bf16 A fragments

  // Tile 0: scores and probabilities.
  hopper::mbar_wait(bar_q, 0);
  wait_tile(full_k, 0);
  issue_scores<kD>(s, q_s, k_s);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  release(empty_k, 0);
  softmax_tile(s, m_run, l_run, alpha, causal && n_tiles == 1, row0, 0, t, scale_log2);
  pack_probs(s, pa);

  // Tile kt's scores run on the tensor cores together with tile kt-1's
  // p v, and tile kt's softmax overlaps that p v.  Between the two issues
  // the accumulator takes the rescale of tile kt-1's softmax.  Nothing
  // between the issues and the last wait writes a register that an
  // in-flight wgmma reads (the probabilities are packed after it), or
  // ptxas would serialise the wgmmas.
  for (int kt = 1; kt < n_tiles; ++kt) {
    wait_tile(full_k, kt);
    wait_tile(full_v, kt - 1);
    issue_scores<kD>(s, q_s, k_s + (kt % kStages) * kTileElems);
    rescale<kD>(acc, alpha);
    issue_pv<kD>(acc, pa, v_s + ((kt - 1) % kStages) * kTileElems);
    hopper::wgmma_wait<1>();  // the scores (the older group) are done
    hopper::fence_regs(s);
    release(empty_k, kt);
    softmax_tile(s, m_run, l_run, alpha, causal && kt == n_tiles - 1, row0, kt * kBlockN, t,
                 scale_log2);
    hopper::wgmma_wait<0>();  // p v of tile kt-1 is done
#pragma unroll
    for (int c = 0; c < T::kAccBlocks; ++c) hopper::fence_regs(acc[c]);
    hopper::fence_regs(pa);
    release(empty_v, kt - 1);
    pack_probs(s, pa);
  }
  wait_tile(full_v, n_tiles - 1);
  rescale<kD>(acc, alpha);
  issue_pv<kD>(acc, pa, v_s + ((n_tiles - 1) % kStages) * kTileElems);
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < T::kAccBlocks; ++c) hopper::fence_regs(acc[c]);

  // Epilogue: divide by the normaliser (guarding rows that saw nothing),
  // round to bf16 into Q's buffer in the 128-byte swizzled layout of the
  // output's tensor map (row r's 16-byte piece c sits at piece c ^ (r % 8)
  // of its 128-byte line), and store the tile with TMA.
  const float inv0 = 1.f / ((l_run[0] == 0.f) ? 1.f : l_run[0]);
  const float inv1 = 1.f / ((l_run[1] == 0.f) ? 1.f : l_run[1]);
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  unsigned char* out_s = reinterpret_cast<unsigned char*>(q_s);
  hopper::named_barrier_sync<1, kThreads>();  // every warp is past its last read of Q
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    unsigned char* box = out_s + (j / 8) * kBox * 2;
    const int piece = j % 8;
    const float* a = &acc[j / 16][4 * (j % 16)];
    *reinterpret_cast<uint32_t*>(box + r0 * 128 + ((piece ^ (r0 % 8)) * 16) + 4 * t) =
        pack_bf16(a[0] * inv0, a[1] * inv0);
    const int r1 = r0 + 8;
    *reinterpret_cast<uint32_t*>(box + r1 * 128 + ((piece ^ (r1 % 8)) * 16) + 4 * t) =
        pack_bf16(a[2] * inv1, a[3] * inv1);
  }
  hopper::fence_async_smem();
  hopper::named_barrier_sync<1, kThreads>();
  if (tid == 0) {
    for (int x = 0; x < T::kBoxes; ++x) {
      hopper::tma_store_4d(&tm_o, q_s + x * kBox, 64 * x, h, q0, b);
    }
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map of a (B, S, heads, D) bf16 tensor with element strides (dims
// innermost first: D, heads, S, B), read in 64 x 64 boxes of (D, S) with
// the 128-byte swizzle.  A size-1 dim's stride is never used; TMA wants it
// to be a non-zero multiple of 16 bytes.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int S,
              int heads, int D, long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1 && strides[i] == 0) strides[i] = 16;
  }
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers and the stream arrive as
// void*, strides in elements.  The wrapper has checked: bf16, D 128 or
// 256, S % 128 == 0, H % KV == 0, unit inner stride, 16-byte aligned base
// and rows (what TMA needs).  Returns cudaGetLastError() after the launch
// (0 on success), cudaErrorSymbolNotFound if cuTensorMapEncodeTiled cannot
// be found, cudaErrorInvalidValue for another head dim or if a tensor map
// cannot describe an input.
extern "C" int tpuslo_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (D != 128 && D != 256) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(encode, &tm_q, q, B, S, H, D, q_sb, q_ss, q_sh) ||
      !make_map(encode, &tm_k, k, B, S, KV, D, k_sb, k_ss, k_sh) ||
      !make_map(encode, &tm_v, v, B, S, KV, D, v_sb, v_ss, v_sh) ||
      !make_map(encode, &tm_o, o, B, S, H, D, o_sb, o_ss, o_sh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = D == 256;
  auto kernel = wide ? &flash_fwd_kernel<256> : &flash_fwd_kernel<128>;
  const int smem_bytes = wide ? Dims<256>::kSmemBytes : Dims<128>::kSmemBytes;
  // Above 48 KB of shared memory only after opting in (per device and
  // instantiation).
  static unsigned opted_in[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 32 && !(opted_in[wide] & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[wide] |= 1u << dev;
  }
  const dim3 grid(H, B, S / kBlockM);
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  kernel<<<grid, kThreads + 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_o, S, H / KV, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}
