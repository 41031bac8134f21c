// Fused causal / non-causal attention forward for Hopper (sm_90a).
//
// Replaces: tpuslo/ops/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel driven by _flash_forward_kernel (pallas_call) and reached through
// flash_attention.  It computes the same function: for q (B,S,H,D) and
// k/v (B,S,KV,D) in bf16, softmax(q k^T / sqrt(D)) v per head, with head h
// reading kv head h / (H/KV) (grouped-query attention), an optional causal
// mask, f32 running max / normaliser / accumulator, and the output in bf16.
//
// What bounds it on an H100.  Causal attention does 2*B*H*S^2*D operations
// (q k^T and p v, each 2*S^2*D per head, halved by the mask) on
// 2*(2*B*S*H*D + 2*B*S*KV*D) bytes (q and o, k and v, each read or written
// once in bf16).  That is about S/3 operations per byte at H=24, KV=8,
// D=128: below the card's ~295 op/byte ridge up to S ~ 900 (bytes bound),
// above it beyond (tensor-core bound).
//
// What the design does about it.
//  * The (S,S) logits and probabilities never reach device memory: one
//    thread block owns a 64-row query tile of one (b, h) and walks the
//    64-key tiles with the online-softmax recurrence, so device traffic is
//    O(S*D) per head.  Fully masked key tiles past the causal diagonal are
//    never visited (the loop ends at the diagonal tile), which halves the
//    work as the TPU kernel's pl.when skip does.  Query tiles are scheduled
//    heaviest first so that the long causal rows start early.
//  * Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    f32 accumulate).  Each of the 4 warps owns 16 query rows; its q
//    fragments stay in registers for the whole key loop.  The probability
//    tile is converted to bf16 in registers and fed straight back as the A
//    operand of the p v product (the S x S tile is never written to shared
//    memory either).  The TPU kernel keeps p in f32 for that product; this
//    rounding of p to bf16 is the one arithmetic difference, and the
//    normaliser is still summed from the f32 p.
//  * q, k and v are read in their (B,S,H,D) layout through strides, 16
//    bytes per thread per load, with no transpose copy; rows of the shared
//    tiles are padded to 136 elements so that fragment loads (32-bit loads
//    for q and k, ldmatrix.trans for v) are free of bank conflicts.  The
//    query tile is staged through the same shared buffer that the key tile
//    later occupies, so the block uses 2 x 17 KB of static shared memory.
//  * Left for later: cp.async / TMA double buffering of the k/v tiles and
//    wgmma.  This first kernel loads a tile, synchronises, computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;         // head dim (the only one the wrapper admits)
constexpr int kBlockM = 64;     // query rows per block, 16 per warp
constexpr int kBlockN = 64;     // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kD + 8;  // padded shared-memory row, in bf16 elements

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a 64 x 128 tile whose rows are `row_stride` elements apart (rows of
// one head at consecutive positions) into a padded shared tile.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < (kBlockN * kChunks) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * kStride + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int n_rep, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     float scale_log2, int causal) {
  __shared__ __align__(16) bf16 k_s[kBlockN * kStride];  // q tile first
  __shared__ __align__(16) bf16 v_s[kBlockN * kStride];

  // Blocks are issued in order of linear index (x fastest), so the query
  // tile is the slowest grid axis, reversed: the heaviest causal tiles of
  // every head start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_tile = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / n_rep;
  const int q0 = q_tile * kBlockM;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int wrow = warp * 16;

  const bf16* k_base = k + b * k_sb + kvh * k_sh;
  const bf16* v_base = v + b * v_sb + kvh * v_sh;

  // q fragments (A operand of q k^T) for this warp's 16 rows, all of D.
  load_tile(k_s, q + b * q_sb + static_cast<long long>(q0) * q_ss + h * q_sh,
            q_ss);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const bf16* p0 = k_s + (wrow + g) * kStride + ks * 16 + t * 2;
    const bf16* p1 = p0 + 8 * kStride;
    qf[ks][0] = lds32(p0);
    qf[ks][1] = lds32(p1);
    qf[ks][2] = lds32(p0 + 8);
    qf[ks][3] = lds32(p1 + 8);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // Rows g and g+8 of the warp's 16: running max (log2 units) and sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + wrow + g;

  const int n_tiles = causal ? (q0 + kBlockM - 1) / kBlockN + 1 : S / kBlockN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // every warp is done with the previous tiles (and q)
    load_tile(k_s, k_base + static_cast<long long>(k0) * k_ss, k_ss);
    load_tile(v_s, v_base + static_cast<long long>(k0) * v_ss, v_ss);
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const bf16* kp = k_s + (nt * 8 + g) * kStride + ks * 16 + t * 2;
        mma_16816(s[nt], qf[ks], lds32(kp), lds32(kp + 8));
      }
    }

    // Scale into log2 units and mask keys past the diagonal.
    const bool on_diag = causal && (k0 + kBlockN - 1 > q0 + wrow);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (on_diag) {
          const int row = row0 + (i >= 2 ? 8 : 0);
          const int col = k0 + nt * 8 + t * 2 + (i & 1);
          if (col > row) x = -INFINITY;
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with nothing visible yet keeps max -inf; exp2(-inf - 0) = 0.
      m_use[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
      alpha[r] = (m_run[r] == -INFINITY) ? 0.f : exp2f(m_run[r] - m_use[r]);
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[nt][i] - m_use[i >> 1]);
        s[nt][i] = p;
        rsum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += p v: the C fragments of two adjacent key n-tiles are the A
    // fragment of one 16-key slice; v's B fragments come by ldmatrix.trans.
    const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
    const int mr = lane & 7;   // which row of it
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        const bf16* vp = v_s + (kk * 16 + (mi & 1) * 8 + mr) * kStride +
                         dp * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(vb, vp);
        mma_16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Epilogue: divide by the normaliser (guarding rows that saw nothing).
  const float d0 = (l_run[0] == 0.f) ? 1.f : l_run[0];
  const float d1 = (l_run[1] == 0.f) ? 1.f : l_run[1];
  bf16* o_row = o + b * o_sb + static_cast<long long>(row0) * o_ss + h * o_sh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    bf16* p = o_row + j * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    *reinterpret_cast<uint32_t*>(p + 8 * o_ss) =
        pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers and the stream arrive as
// void*, strides in elements.  The wrapper has checked: bf16, D == 128,
// S % 64 == 0, H % KV == 0, unit inner stride, 16-byte aligned rows.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuslo_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  const dim3 grid(H, B, S / kBlockM);
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H / KV, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}
