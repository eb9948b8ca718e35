// Flash attention for Hopper (sm_90a): kernels K3 (forward) and K4
// (backward: dQ, and dK/dV) of the port.
//
//   K3      S = Q K^T * scale (masked),  online softmax over k tiles,
//           out = acc / max(l, 1e-30),   lse = m + log(max(l, 1e-30))
//   K4-dQ   P = exp(S - lse),  dS = P * (dO V^T - delta) * scale,
//           dQ = dS K
//   K4-dKV  dV = P^T dO,  dK = dS^T Q
//
// Replaces singa_tpu/ops/attention.py::_flash_fwd_kernel (the pallas_call
// of _pallas_flash_fwd) and _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel
// (the two pallas_calls of _pallas_flash_bwd). delta = rowsum(dO * O) is
// computed outside the kernels, as there (ops/attention.py, flash_bwd).
// Each of the three has two kernels here: one for f32 inputs on the CUDA
// cores, one for bf16 inputs on the tensor cores.
//
// Inputs q, k, v (and dO) are (B*H, S, D) contiguous, all f32 or all bf16;
// out, dq, dk, dv are written in the inputs' type, lse in f32. Masked
// scores are -1e30, not -inf (_NEG_INF); causal masking is top-left
// aligned, k_pos <= q_pos. Rows and keys past Sq / Sk (a ragged last tile)
// are masked here: there is no divisibility requirement. pos_delta
// (forward only) adds a global-position delta to q_pos for ring attention:
// the k loop is then not pruned and a fully masked row gets p = 0 (out 0,
// lse -1e30), as in the JAX kernel. Here p is zeroed on every masked entry
// in every mode; without a delta that is the value exp(-1e30 - m) already
// has, since tile 0 always holds an unmasked key. No atomics: each output
// tile is written by one block, so the result is deterministic. Causal
// k (q) tiles wholly above the diagonal are never loaded.
//
// f32 (flash_*_kernel). Every product is an f32 FMA on the CUDA cores (the
// JAX kernels compute in f32; TF32, or 3xTF32 on the tensor cores, would
// change the rounding). Bound: at the LM shape (B8 H8 S1024 D64, causal)
// the work is f32 arithmetic, not bytes: K3 does 4*D flops per unmasked
// (q, k) pair (8.6 GFLOP, 0.128 ms at the data sheet's 67 TFLOP/s against
// 0.010-0.020 ms for its 34-67 MB at 3.35 TB/s), K4-dQ 6*D (0.193 ms) and
// K4-dKV 8*D (0.257 ms). An SM's shared memory hands out 32 floats per
// clock while the SM does 128 FMAs, so a lane has to do 4 FMAs per float
// it loads from shared memory to keep the FMA units busy. The timings
// below behave as if a 16-byte load costs 4 of those clocks (one per
// quarter-warp) however many lanes share its address: what counts is FMAs
// per float loaded, and that is set by a lane's register tile.
// Design:
// - The TPU grid's sequential k (or q) dimension is a loop inside one block
//   of 128 threads (4 warps). A lane (lane = 8 lr + lc) owns 4 rows of its
//   warp's 16 (rows lr + 4 i), keys lc + 8 j of each score tile, and 16-byte
//   column groups 32 h + 4 lc of the output. Its score tile is 4 x 8 (K3
//   at DMAX 64) or 4 x 4 (a 32-wide tile), its output tile 4 rows x DMAX/8
//   columns. FMAs per float loaded: 2.67 in the 4 x 8 score loop, 2 in
//   the 4 x 4 ones, 2.67 / 3.2 / 3.6 in the P V style products at DMAX 64 /
//   128 / 256 (the earlier 4 x 4 design: 2 everywhere). 8 x 8 lane tiles
//   (4 FMAs per float) need nearly all 255 registers and 2-warp blocks at
//   DMAX 64, which halves the warps per SM; tried, they ran slower. The
//   4-row tiles keep 8 warps per SM (2 blocks).
// - Tiles: K3 64 q rows x 64 keys (32 keys above DMAX 64); dQ 64 q rows x
//   32 keys (16 at DMAX 256); dKV 64 key rows (32 at DMAX 256, where the 4
//   warps are 2 row groups x 2 halves of the head dim, each warp computing
//   its row group's P^T and dS^T) x 32 q rows.
// - Operands are read from shared memory as float4 along the head dim (Q,
//   K, V, dO tiles) or along the keys (P, dS). Rows have stride DMAX + 4
//   floats, so every row is 16-byte aligned and rows r and r + 1 start 4
//   banks apart: in a quarter-warp the 8 lanes read one Q row (one
//   address) and 8 K rows lc = 0..7 (banks 4 lc..4 lc + 3, all 32), or one
//   P row and 8 consecutive float4 of a V row. P and dS tiles have stride
//   BN + 8, 8 banks apart, so a warp's scalar P stores (bank 8 lr + lc +
//   8 j) hit 32 banks. No access has a bank conflict (counted by hand).
//   Each warp keeps its own
//   16 rows of P and dS, so only __syncwarp separates their stores from
//   their loads.
// - Loops run to DMAX (steps of 4 at or past D are skipped: their columns
//   are zero) and over the whole tile (keys past S have p = 0 and zero
//   rows), unrolled by 4 steps; full unrolling ran slower.
// - K and V (K3, dQ), Q, dO, lse and delta (dKV) are double-buffered with
//   16-byte cp.async: one barrier per tile, after which the next tile's
//   copy goes into the stage the previous tile used. Where D % 4 != 0 or a
//   pointer is not 16-byte aligned, the tiles are copied by 4-byte
//   cp.async and the outputs stored as floats (chosen per launch); else
//   out, dq, dk and dv are stored as float4, 8 lanes per 128-byte row.
// - p is expf of the same argument as in the plain version, so that both
//   compute the same p; tiles that need no mask skip it. (exp2f of
//   log2e-scaled arguments, as in the bf16 kernels, is faster, but dq and
//   dk, sums that cancel, amplify its last-bit differences: at D = 1 a
//   value moved past the per-element gate.)
// - Dynamic shared memory, DMAX 64 / 128 / 256: K3 105,472 / 111,616 /
//   209,920 bytes; dQ 79,872 / 145,408 / 205,824; dKV 90,624 / 156,160 /
//   220,672 (2 blocks per SM at DMAX 64). Registers per thread
//   (cudaFuncGetAttributes, sm_90a; no local memory): K3 163 / 165 / 221,
//   dQ 128 / 168 / 222, dKV 168 / 250 / 250.
// - Measured at the LM shape, causal, on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py; flash_gate_check.py --alternatives, device time): K3
//   0.3022, dQ 0.4623, dKV 0.6607 ms, 0.43 / 0.42 / 0.39 of the f32 bound
//   (the earlier design 0.3922 / 0.6049 / 0.7339). Taking K3's score loop or
//   its P V loop out saves 0.115 ms each (about 40 TFLOP/s in each loop);
//   taking both out leaves 0.097 ms of copies, softmax, barriers and
//   stores. Those two, 2-2.67 FMAs per float and the work between the
//   loops, hold the kernels under half the bound. dKV with Q, dO, lse and
//   delta in one stage (3 blocks per SM): 0.6581 ms against 0.6888 causal
//   but 1.3346 against 1.2841 not causal; in one stage of 64-row q tiles
//   (2 blocks per SM): 0.6594 and 1.2362. Double buffering is kept.
//
// bf16 (flash_*_mma_kernel), FlashAttention-2 in shape. Bound at the LM
// shape: K3 0.0101 ms by bytes (33.8 MB at 3.35 TB/s; 8.6 GFLOP take
// 0.0087 ms at 989 TFLOP/s), K4-dQ 0.0130 ms and K4-dKV 0.0174 ms by
// operations (12.9 and 17.2 GFLOP). Every product is
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with f32 sums; a block has 4
// warps (128 threads) and each warp owns 16 rows of the block's tile.
// - K3 and K4-dQ: a block owns 64 q rows and loops over k tiles of 64 keys
//   (32 when D > 128). Q (and dO) are loaded once; K and V tiles are
//   double-buffered in shared memory with 16-byte cp.async, so the next
//   tile's load overlaps this tile's products. S = Q K^T takes its B
//   fragments from the K tile by ldmatrix; the scale, the mask and the
//   online softmax (K3) or P = exp(S - lse) and dS (dQ) run in f32 on the
//   accumulator fragments, each thread holding 2 rows, so a row max takes
//   2 shuffles within the quad. The f32 C fragments of P (dS) are packed
//   to bf16 straight into A fragments (the m16n8 C layout is the m16n8k16
//   A layout) for P V (dS K), whose B fragments come by ldmatrix.trans.
//   With D <= 64 the Q (and dO) fragments stay in registers.
// - K4-dKV: a block owns 64 key rows (32 when D > 64) and loops over q
//   tiles of 64 rows (32 when D > 128), Q, dO, lse and delta
//   double-buffered. It computes S^T = K Q^T and dP^T = V dO^T directly,
//   so that P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale are
//   already A fragments of dV += P^T dO and dK += dS^T Q; dK and dV sum in
//   f32 registers. When D > 64 the 4 warps are 2 row groups of 16 keys by
//   2 column halves of the head dim: each warp recomputes its row group's
//   S^T and dP^T and keeps dK and dV for its half only (64 + 64 f32
//   registers at D = 128, 128 + 128 at D = 256, where 64-row tiles over
//   the whole head dim would need 256 for dK and dV alone).
// - Shared memory rows are padded by 16 bytes (DMAX + 8 bf16), so the 8
//   rows of each ldmatrix phase fall in distinct banks. The head dim is
//   padded with zeros up to the DMAX bucket (64 / 128 / 256), as are rows
//   past Sq / Sk, so that padded products are 0 and never NaN. Where
//   D % 8 != 0 (a row is not 16-byte aligned) or a pointer is not 16-byte
//   aligned, the tiles are loaded by 2-byte loads instead (chosen per
//   launch). Bytes of dynamic shared memory per block, DMAX 64 / 128 /
//   256: K3 46,080 / 87,040 / 101,376; dQ 55,296 / 104,448 / 135,168; dKV
//   56,320 / 88,064 / 101,888. Registers per thread (ptxas -v, sm_90a; no
//   spills): K3 124 / 153 / 197, dQ 168 / 194 / 216, dKV 195 / 191 / 218.
// - Rounding. A product of two bf16 values is exact in f32 and the sums
//   are f32, so S, dP and their transposes are the f32 kernels' values up
//   to summation order. Only two operands are rounded to bf16 before the
//   tensor cores: P (for P V in K3 and P^T dO for dV) and dS (for dS K in
//   dQ and dS^T Q for dK). The row sum l, and with it lse, is taken over
//   the f32 p before it is rounded. Rounding P moves an output row by at
//   most about 2^-9 max|v|, inside the bf16 tolerance of 2e-2 of the
//   largest reference value.
// - wgmma (Hopper's warpgroup products) and TMA tile copies are the next
//   step.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;

// ==================================================== bf16: tensor cores ==

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// -- tensor-core primitives (PTX of sm_80 and later) ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// -- end of tensor-core primitives ------------------------------------------

// tile shapes by head-dim bucket
template <int DMAX>
struct Tc {
  static constexpr int BM = 64;                    // q rows (K3, dQ)
  static constexpr int BN = DMAX > 128 ? 32 : 64;  // keys of a k tile
  static constexpr int WN = DMAX > 64 ? 2 : 1;     // dKV column groups
  static constexpr int BKV = 64 / WN;              // key rows (dKV)
  static constexpr int BQ = DMAX > 128 ? 32 : 64;  // q rows of a q tile
  static constexpr int LDS = DMAX + 8;             // smem row stride
  static constexpr int KS = DMAX / 16;             // k16 steps over D
  static constexpr int NT = DMAX / 8;              // n8 tiles over D
};

// rows [row0, row0 + ROWS) of one (S, D) slice into a ROWS x (DMAX + 8)
// tile; columns past D and rows past S are zero. vec: 16-byte cp.async
// (D % 8 == 0 and 16-byte aligned rows), else 2-byte loads.
template <int ROWS, int DMAX>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int S, int D,
                                               bool vec) {
  constexpr int LDS = DMAX + 8;
  if (vec) {
    constexpr int CH = DMAX / 8;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < ROWS * CH; i += kTcThreads) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = row0 + r < S && c * 8 < D;
      cp_async16(dst + r * LDS + c * 8,
                 ok ? src + (long long)(row0 + r) * D + c * 8 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DMAX; i += kTcThreads) {
      const int r = i / DMAX, d = i - r * DMAX;
      dst[r * LDS + d] = (row0 + r < S && d < D)
                             ? src[(long long)(row0 + r) * D + d]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// rows [row0, row0 + ROWS) of an f32 row statistic; rows past S are zero
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kTcThreads) {
    const bool ok = row0 + r < S;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok ? 4 : 0);
  }
}

// A fragment: rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles whose n index runs along the tile's rows
// [n0, n0 + 16) (K for Q K^T): b[0..1] for rows n0.., b[2..3] for n0 + 8..
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], const bf16* t,
                                            int ld, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles whose k index runs along the tile's rows
// [k0, k0 + 16) (V for P V): columns [n0, n0 + 8) and [n0 + 8, n0 + 16)
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const bf16* t,
                                            int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, t + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// acc[NR][4] += A B over the 16 rows of a warp: A is packed from the f32
// C fragments p[NK][4] (NK n8 tiles = NK / 2 k16 steps), B from the tile t
// (k along its rows) at columns [c0, c0 + 8 NR); column groups at or past
// D are skipped
template <int NK, int NR>
__device__ __forceinline__ void mma_pc(float (&acc)[NR][4],
                                       const float (&p)[NK][4], const bf16* t,
                                       int ld, int c0, int D) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < NR / 2; ++n) {
      if (c0 + n * 16 < D) {
        uint32_t b[4];
        frag_b_cols(b, t, ld, kk * 16, c0 + n * 16);
        mma_bf16(acc[2 * n], a, b[0], b[1]);
        mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
      }
    }
  }
}

// s[NS][4] = A B^T over the warp's 16 rows: A from the tile a_t (rows
// [ar, ar + 16)) or from registers af, B from the tile b_t whose rows
// [0, 8 NS) are the n index; k runs over the head dim up to D
template <int NS, int KS, bool AREG>
__device__ __forceinline__ void mma_rows(float (&s)[NS][4],
                                         const uint32_t (*af)[4],
                                         const bf16* a_t, int ar,
                                         const bf16* b_t, int ld, int D) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks * 16 < D) {
      uint32_t a[4];
      if (AREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = af[ks][e];
      } else {
        frag_a(a, a_t, ld, ar, ks * 16);
      }
#pragma unroll
      for (int n = 0; n < NS / 2; ++n) {
        uint32_t b[4];
        frag_b_rows(b, b_t, ld, n * 16, ks * 16);
        mma_bf16(s[2 * n], a, b[0], b[1]);
        mma_bf16(s[2 * n + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the two rows (r = 0, 1: fragment rows g and g + 8) of a warp's C
// fragments acc[NR][4], columns [c0, c0 + 8 NR), times mul[r], into row
// rows[r] of a (S, D) bf16 slice where rows[r] < S
template <int NR>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[NR][4],
                                           const int (&rows)[2],
                                           const float (&mul)[2], int c0,
                                           int S, int D) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* row = dst + (long long)rows[r] * D;
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const int d = c0 + n * 8 + 2 * tig;
      const float v0 = acc[n][2 * r] * mul[r], v1 = acc[n][2 * r + 1] * mul[r];
      if (d + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < D) row[d] = __float2bfloat16_rn(v0);
        if (d + 1 < D) row[d + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ------------------------------------------------------------ K3 bf16 -----
// grid (B*H, q tiles of 64); the heaviest causal q tiles are dispatched
// first. Warp w owns rows [16 w, 16 w + 16) of the q tile.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int D, float scale, int causal,
    int has_delta, int pos_delta, int vec) {
  using C = Tc<DMAX>;
  constexpr int BM = C::BM, BN = C::BN, LDS = C::LDS, KS = C::KS, NT = C::NT;
  constexpr int SN = BN / 8;            // n8 tiles of a score block
  constexpr bool QREG = DMAX <= 64;     // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x LDS
  bf16* sK = sQ + BM * LDS;                      // 2 x BN x LDS
  bf16* sV = sK + 2 * BN * LDS;                  // 2 x BN x LDS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  const int delta = has_delta ? pos_delta : 0;
  const int nkb = (Sk + BN - 1) / BN;
  const int kend =
      (causal && !has_delta) ? min(nkb, (q0 + BM - 1) / BN + 1) : nkb;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};

  load_tile_bf16<BM, DMAX>(sQ, q + bh * Sq * D, q0, Sq, D, vec);
  load_tile_bf16<BN, DMAX>(sK, kb, 0, Sk, D, vec);
  load_tile_bf16<BN, DMAX>(sV, vb, 0, Sk, D, vec);
  cp_async_commit();

  uint32_t qf[QREG ? KS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < kend; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kend) {
      load_tile_bf16<BN, DMAX>(sK + (st ^ 1) * BN * LDS, kb, (kt + 1) * BN,
                               Sk, D, vec);
      load_tile_bf16<BN, DMAX>(sV + (st ^ 1) * BN * LDS, vb, (kt + 1) * BN,
                               Sk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? KS : 0); ++ks)
        frag_a(qf[ks], sQ, LDS, wr, ks * 16);
    }
    const bf16* tK = sK + st * BN * LDS;
    const bf16* tV = sV + st * BN * LDS;
    const int k0 = kt * BN;

    float s[SN][4];
    mma_rows<SN, KS, QREG>(s, qf, sQ, wr, tK, LDS, D);

    // scale and mask, then the online softmax of the warp's two rows
    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + delta);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[j][e] * scale;
        if (masked && !(kc < Sk && (!causal || kc <= rows[r] + delta)))
          x = kNegInf;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      ml[r] = mx[r] * kLog2e;
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok =
            !masked || (kc < Sk && (!causal || kc <= rows[r] + delta));
        const float p = ok ? exp2f(fmaf(s[j][e], kLog2e, -ml[r])) : 0.f;
        s[j][e] = p;
        sum[r] += p;  // l sums the f32 p, before P is rounded to bf16
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma_pc<SN, NT>(acc, s, tV, LDS, 0, D);  // acc += bf16(P) V
    __syncthreads();  // this stage is free for the load after next
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / ls;
    if ((lane & 3) == 0 && rows[r] < Sq) lse[bh * Sq + rows[r]] = m[r] + logf(ls);
  }
  store_rows<NT>(out + bh * Sq * D, acc, rows, inv, 0, Sq, D);
}

// --------------------------------------------------------- K4-dQ bf16 -----
// grid (B*H, q tiles of 64): loops over k tiles up to the diagonal.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal,
    int vec) {
  using C = Tc<DMAX>;
  constexpr int BM = C::BM, BN = C::BN, LDS = C::LDS, KS = C::KS, NT = C::NT;
  constexpr int SN = BN / 8;
  constexpr bool QREG = DMAX <= 64;     // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x LDS
  bf16* sG = sQ + BM * LDS;                      // BM x LDS (dO)
  bf16* sK = sG + BM * LDS;                      // 2 x BN x LDS
  bf16* sV = sK + 2 * BN * LDS;                  // 2 x BN x LDS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  const int nkb = (Sk + BN - 1) / BN;
  const int kend = causal ? min(nkb, (q0 + BM - 1) / BN + 1) : nkb;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < Sq ? lse[bh * Sq + rows[r]] : 0.f;
    delta_r[r] = rows[r] < Sq ? delta[bh * Sq + rows[r]] : 0.f;
  }

  load_tile_bf16<BM, DMAX>(sQ, q + bh * Sq * D, q0, Sq, D, vec);
  load_tile_bf16<BM, DMAX>(sG, g + bh * Sq * D, q0, Sq, D, vec);
  load_tile_bf16<BN, DMAX>(sK, kb, 0, Sk, D, vec);
  load_tile_bf16<BN, DMAX>(sV, vb, 0, Sk, D, vec);
  cp_async_commit();

  uint32_t qf[QREG ? KS : 1][4], gf[QREG ? KS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kend) {
      load_tile_bf16<BN, DMAX>(sK + (st ^ 1) * BN * LDS, kb, (kt + 1) * BN,
                               Sk, D, vec);
      load_tile_bf16<BN, DMAX>(sV + (st ^ 1) * BN * LDS, vb, (kt + 1) * BN,
                               Sk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? KS : 0); ++ks) {
        frag_a(qf[ks], sQ, LDS, wr, ks * 16);
        frag_a(gf[ks], sG, LDS, wr, ks * 16);
      }
    }
    const bf16* tK = sK + st * BN * LDS;
    const bf16* tV = sV + st * BN * LDS;
    const int k0 = kt * BN;

    float s[SN][4], dp[SN][4];
    mma_rows<SN, KS, QREG>(s, qf, sQ, wr, tK, LDS, D);   // Q K^T
    mma_rows<SN, KS, QREG>(dp, gf, sG, wr, tV, LDS, D);  // dO V^T

    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = !masked || (kc < Sk && (!causal || kc <= rows[r]));
        const float p =
            ok ? exp2f((s[j][e] * scale - lse_r[r]) * kLog2e) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;  // dS
      }
    mma_pc<SN, NT>(acc, s, tK, LDS, 0, D);  // dQ += bf16(dS) K
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows<NT>(dq + bh * Sq * D, acc, rows, one, 0, Sq, D);
}

// -------------------------------------------------------- K4-dKV bf16 -----
// grid (B*H, k tiles of BKV): loops over q tiles from the diagonal. Warp w
// owns key rows [16 (w % RG), +16) and head columns [DW (w / RG), +DW).
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int D,
    float scale, int causal, int vec) {
  using C = Tc<DMAX>;
  constexpr int BKV = C::BKV, BQ = C::BQ, LDS = C::LDS, KS = C::KS;
  constexpr int RG = 4 / C::WN;         // row groups of 16 keys
  constexpr int DW = DMAX / C::WN;      // head columns of a warp's dK, dV
  constexpr int NW = DW / 8;            // their n8 tiles
  constexpr int SQ = BQ / 8;            // n8 tiles of a score block (q)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // BKV x LDS
  bf16* sV = sK + BKV * LDS;                     // BKV x LDS
  bf16* sQ = sV + BKV * LDS;                     // 2 x BQ x LDS
  bf16* sG = sQ + 2 * BQ * LDS;                  // 2 x BQ x LDS (dO)
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ * LDS);  // 2 x BQ
  float* sD = sL + 2 * BQ;                                  // 2 x BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp % RG) * 16, c0 = (warp / RG) * DW;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;
  const bf16* qb = q + bh * Sq * D;
  const bf16* gb = g + bh * Sq * D;
  const float* lb = lse + bh * Sq;
  const float* db = delta + bh * Sq;
  const int nqb = (Sq + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  const int keys[2] = {k0 + wr + (lane >> 2), k0 + wr + (lane >> 2) + 8};

  load_tile_bf16<BKV, DMAX>(sK, k + bh * Sk * D, k0, Sk, D, vec);
  load_tile_bf16<BKV, DMAX>(sV, v + bh * Sk * D, k0, Sk, D, vec);
  if (qstart < nqb) {
    load_tile_bf16<BQ, DMAX>(sQ, qb, qstart * BQ, Sq, D, vec);
    load_tile_bf16<BQ, DMAX>(sG, gb, qstart * BQ, Sq, D, vec);
    load_rows<BQ>(sL, lb, qstart * BQ, Sq);
    load_rows<BQ>(sD, db, qstart * BQ, Sq);
  }
  cp_async_commit();

  float dk_acc[NW][4], dv_acc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qstart; qt < nqb; ++qt) {
    const int st = (qt - qstart) & 1;
    if (qt + 1 < nqb) {
      const int nq0 = (qt + 1) * BQ;
      load_tile_bf16<BQ, DMAX>(sQ + (st ^ 1) * BQ * LDS, qb, nq0, Sq, D, vec);
      load_tile_bf16<BQ, DMAX>(sG + (st ^ 1) * BQ * LDS, gb, nq0, Sq, D, vec);
      load_rows<BQ>(sL + (st ^ 1) * BQ, lb, nq0, Sq);
      load_rows<BQ>(sD + (st ^ 1) * BQ, db, nq0, Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + st * BQ * LDS;
    const bf16* tG = sG + st * BQ * LDS;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    const int q0 = qt * BQ;

    float s[SQ][4], dp[SQ][4];
    mma_rows<SQ, KS, false>(s, nullptr, sK, wr, tQ, LDS, D);   // K Q^T
    mma_rows<SQ, KS, false>(dp, nullptr, sV, wr, tG, LDS, D);  // V dO^T

    const bool masked = q0 + BQ > Sq || k0 + BKV > Sk ||
                        (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < SQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qc = j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = !masked || (q0 + qc < Sq && keys[r] < Sk &&
                                    (!causal || keys[r] <= q0 + qc));
        const float p =
            ok ? exp2f((s[j][e] * scale - tL[qc]) * kLog2e) : 0.f;
        s[j][e] = p;                                   // P^T
        dp[j][e] = p * (dp[j][e] - tD[qc]) * scale;    // dS^T
      }
    mma_pc<SQ, NW>(dv_acc, s, tG, LDS, c0, D);   // dV += bf16(P^T) dO
    mma_pc<SQ, NW>(dk_acc, dp, tQ, LDS, c0, D);  // dK += bf16(dS^T) Q
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows<NW>(dk + bh * Sk * D, dk_acc, keys, one, c0, Sk, D);
  store_rows<NW>(dv + bh * Sk * D, dv_acc, keys, one, c0, Sk, D);
}

// ===================================================== f32: CUDA cores ==

constexpr int kF32Threads = 128;  // 4 warps; lane = 8 lr + lc

// tile shapes by head-dim bucket (the source note gives the reasons)
template <int DMAX>
struct F32Tile {
  static constexpr int LD = DMAX + 4;              // Q, K, V, dO row stride
  static constexpr int NH = DMAX / 32;             // float4 columns of a lane
  static constexpr int BM = 64;                    // q rows (K3, dQ)
  static constexpr int BN = DMAX == 64 ? 64 : 32;  // keys of a K3 k tile
  static constexpr int BNQ = DMAX == 256 ? 16 : 32;  // keys of a dQ k tile
  static constexpr int WN = DMAX == 256 ? 2 : 1;   // dKV head-dim groups
  static constexpr int BKV = 64 / WN;              // key rows (dKV)
  static constexpr int BQ = 32;                    // q rows of a dKV q tile
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int E>
__device__ __forceinline__ float elem(float4 v) {
  return E == 0 ? v.x : E == 1 ? v.y : E == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// max / sum over the 8 lanes (lc = 0..7) that share a row
__device__ __forceinline__ float lane8_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float lane8_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [row0, row0 + ROWS) of one (S, D) f32 slice into a ROWS x (DMAX + 4)
// tile, asynchronously; columns past D and rows past S are zero. vec:
// 16-byte cp.async (D % 4 == 0 and 16-byte aligned rows), else 4-byte.
template <int ROWS, int DMAX>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int S, int D,
                                              bool vec) {
  constexpr int LD = DMAX + 4;
  if (vec) {
    constexpr int CH = DMAX / 4;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < ROWS * CH; i += kF32Threads) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = row0 + r < S && c * 4 < D;
      cp_async16(dst + r * LD + c * 4,
                 ok ? src + (long long)(row0 + r) * D + c * 4 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DMAX; i += kF32Threads) {
      const int r = i / DMAX, d = i - r * DMAX;
      const bool ok = row0 + r < S && d < D;
      cp_async4(dst + r * LD + d,
                ok ? src + (long long)(row0 + r) * D + d : src, ok ? 4 : 0);
    }
  }
}

// s[i][j] = a_(4 i) . b_(8 j) over the head dim: a and b point at a lane's
// first row of two tiles of stride DMAX + 4; steps of 4 at or past D are
// skipped (their columns are zero). Each sum runs over d in order.
template <int NJ, int DMAX>
__device__ __forceinline__ void scores(float (&s)[4][NJ], const float* a,
                                       const float* b, int D) {
  constexpr int LD = DMAX + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DMAX; d += 4) {
    if (d < D) {
      float4 av[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ld4(a + 4 * i * LD + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = ld4(b + 8 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
          s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
          s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
          s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
        }
    }
  }
}

// acc[i][h] += sum over the BN keys c of p[4 i][c] t[c][32 h]: p points at
// a lane's first row of a BN-wide tile of stride BN + 8, t at a lane's
// first column of a tile of stride DMAX + 4; column groups whose first
// column c0 + 32 h is at or past D are skipped.
template <int BN, int NH, int DMAX>
__device__ __forceinline__ void mul_acc(float4 (&acc)[4][NH], const float* p,
                                        const float* t, int c0, int D) {
  constexpr int LD = DMAX + 4, LP = BN + 8;
#pragma unroll 4
  for (int c = 0; c < BN; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = ld4(p + 4 * i * LP + c);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (c0 + 32 * h < D) {
        const float4 t0 = ld4(t + c * LD + 32 * h);
        const float4 t1 = ld4(t + (c + 1) * LD + 32 * h);
        const float4 t2 = ld4(t + (c + 2) * LD + 32 * h);
        const float4 t3 = ld4(t + (c + 3) * LD + 32 * h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma4(acc[i][h], elem<0>(pv[i]), t0);
          fma4(acc[i][h], elem<1>(pv[i]), t1);
          fma4(acc[i][h], elem<2>(pv[i]), t2);
          fma4(acc[i][h], elem<3>(pv[i]), t3);
        }
      }
    }
  }
}

// acc[i][h] / div[i] into row rows[i] (where < S) of an (S, D) slice,
// columns c0 + 32 h + 4 lc (where < D): one 16-byte store each where vec
template <int NH>
__device__ __forceinline__ void store_f32(float* dst,
                                          const float4 (&acc)[4][NH],
                                          const int (&rows)[4],
                                          const float (&div)[4], int c0,
                                          int S, int D, bool vec) {
  const int lc = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rows[i] >= S) continue;
    float* row = dst + (long long)rows[i] * D;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int d = c0 + 32 * h + 4 * lc;
      const float4 a = acc[i][h];
      const float4 o = make_float4(a.x / div[i], a.y / div[i], a.z / div[i],
                                   a.w / div[i]);
      if (vec) {
        if (d < D) *reinterpret_cast<float4*>(row + d) = o;
      } else {
        if (d < D) row[d] = o.x;
        if (d + 1 < D) row[d + 1] = o.y;
        if (d + 2 < D) row[d + 2] = o.z;
        if (d + 3 < D) row[d + 3] = o.w;
      }
    }
  }
}

// ------------------------------------------------------------- K3 f32 -----
// grid (B*H, q tiles of 64); the heaviest causal q tiles are dispatched
// first. Warp w owns rows [16 w, 16 w + 16) of the q tile; a lane owns rows
// 16 w + lr + 4 i (i < 4), keys lc + 8 j of each k tile and head columns
// 32 h + 4 lc.
template <int DMAX>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int D, float scale, int causal,
    int has_delta, int pos_delta, int vec) {
  using C = F32Tile<DMAX>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NH = C::NH;
  constexpr int NJ = BN / 8, LP = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BM x LD
  float* sK = sQ + BM * LD;                         // 2 x BN x LD
  float* sV = sK + 2 * BN * LD;                     // 2 x BN x LD
  float* sP = sV + 2 * BN * LD;                     // BM x LP

  const int lane = threadIdx.x & 31, lr = lane >> 3, lc = lane & 7;
  const int wr = (threadIdx.x >> 5) * 16 + lr;  // the lane's first tile row
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int shift = has_delta ? pos_delta : 0;
  const int nkt = (Sk + BN - 1) / BN;
  const int kt_end =
      causal && !has_delta ? min(nkt, (q0 + BM - 1) / BN + 1) : nkt;
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = q0 + wr + 4 * i;

  load_tile_f32<BM, DMAX>(sQ, q + bh * Sq * D, q0, Sq, D, vec);
  load_tile_f32<BN, DMAX>(sK, kb, 0, Sk, D, vec);
  load_tile_f32<BN, DMAX>(sV, vb, 0, Sk, D, vec);
  cp_async_commit();

  float4 acc[4][NH];
  float m[4], l[4];  // l: this lane's part of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    // tile kt has arrived, and every warp is done with tile kt - 1, whose
    // stage the next copy overwrites
    __syncthreads();
    if (kt + 1 < kt_end) {
      load_tile_f32<BN, DMAX>(sK + (st ^ 1) * BN * LD, kb, (kt + 1) * BN,
                              Sk, D, vec);
      load_tile_f32<BN, DMAX>(sV + (st ^ 1) * BN * LD, vb, (kt + 1) * BN,
                              Sk, D, vec);
      cp_async_commit();
    }
    const float* tK = sK + st * BN * LD;
    const float* tV = sV + st * BN * LD;
    const int k0 = kt * BN;

    float s[4][NJ];
    scores<NJ, DMAX>(s, sQ + wr * LD, tK + lc * LD, D);  // Q K^T
    float* pw = sP + wr * LP;
    // only a ragged last tile and tiles across the diagonal are masked
    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + shift);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = rows[i] + shift;
      bool ok[NJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + lc + 8 * j;
        ok[j] = !masked || (kp < Sk && (!causal || kp <= qpos));
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], lane8_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        pw[4 * i * LP + lc + 8 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        acc[i][h].x *= alpha;
        acc[i][h].y *= alpha;
        acc[i][h].z *= alpha;
        acc[i][h].w *= alpha;
      }
    }
    __syncwarp();  // a row's P comes from its 8 lanes
    mul_acc<BN, NH, DMAX>(acc, pw, tV + 4 * lc, 0, D);  // acc += P V
  }

  float ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = fmaxf(lane8_sum(l[i]), 1e-30f);
    if (lc == 0 && rows[i] < Sq) lse[bh * Sq + rows[i]] = m[i] + logf(ls[i]);
  }
  store_f32<NH>(out + bh * Sq * D, acc, rows, ls, 0, Sq, D, vec);
}

// ---------------------------------------------------------- K4-dQ f32 -----
// grid (B*H, q tiles of 64): loops over k tiles up to the diagonal; rows,
// keys and columns of a lane as in K3.
template <int DMAX>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal,
    int vec) {
  using C = F32Tile<DMAX>;
  constexpr int BM = C::BM, BN = C::BNQ, LD = C::LD, NH = C::NH;
  constexpr int NJ = BN / 8, LP = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // BM x LD
  float* sG = sQ + BM * LD;                         // BM x LD (dO)
  float* sK = sG + BM * LD;                         // 2 x BN x LD
  float* sV = sK + 2 * BN * LD;                     // 2 x BN x LD
  float* sS = sV + 2 * BN * LD;                     // BM x LP (dS)

  const int lane = threadIdx.x & 31, lr = lane >> 3, lc = lane & 7;
  const int wr = (threadIdx.x >> 5) * 16 + lr;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int nkt = (Sk + BN - 1) / BN;
  const int kt_end = causal ? min(nkt, (q0 + BM - 1) / BN + 1) : nkt;
  int rows[4];
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = q0 + wr + 4 * i;
    lse_r[i] = rows[i] < Sq ? lse[bh * Sq + rows[i]] : 0.f;
    delta_r[i] = rows[i] < Sq ? delta[bh * Sq + rows[i]] : 0.f;
  }

  load_tile_f32<BM, DMAX>(sQ, q + bh * Sq * D, q0, Sq, D, vec);
  load_tile_f32<BM, DMAX>(sG, g + bh * Sq * D, q0, Sq, D, vec);
  load_tile_f32<BN, DMAX>(sK, kb, 0, Sk, D, vec);
  load_tile_f32<BN, DMAX>(sV, vb, 0, Sk, D, vec);
  cp_async_commit();

  float4 acc[4][NH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    // tile kt has arrived, and every warp is done with tile kt - 1, whose
    // stage the next copy overwrites
    __syncthreads();
    if (kt + 1 < kt_end) {
      load_tile_f32<BN, DMAX>(sK + (st ^ 1) * BN * LD, kb, (kt + 1) * BN,
                              Sk, D, vec);
      load_tile_f32<BN, DMAX>(sV + (st ^ 1) * BN * LD, vb, (kt + 1) * BN,
                              Sk, D, vec);
      cp_async_commit();
    }
    const float* tK = sK + st * BN * LD;
    const float* tV = sV + st * BN * LD;
    const int k0 = kt * BN;

    float s[4][NJ], dp[4][NJ];
    scores<NJ, DMAX>(s, sQ + wr * LD, tK + lc * LD, D);   // Q K^T
    scores<NJ, DMAX>(dp, sG + wr * LD, tV + lc * LD, D);  // dO V^T
    float* sw = sS + wr * LP;
    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + lc + 8 * j;
        const bool ok = !masked || (kp < Sk && (!causal || kp <= rows[i]));
        const float p =
            ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sw[4 * i * LP + lc + 8 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncwarp();
    mul_acc<BN, NH, DMAX>(acc, sw, tK + 4 * lc, 0, D);  // dQ += dS K
  }

  const float unit[4] = {1.f, 1.f, 1.f, 1.f};
  store_f32<NH>(dq + bh * Sq * D, acc, rows, unit, 0, Sq, D, vec);
}

// --------------------------------------------------------- K4-dKV f32 -----
// grid (B*H, k tiles of BKV): loops over q tiles of 32 from the diagonal.
// Warp w owns key rows [16 (w % RG), +16) and head columns [DW (w / RG),
// +DW) of dK and dV (RG = 4 / WN, DW = DMAX / WN); a lane owns key rows
// lr + 4 i of its warp's 16, queries lc + 8 j of each q tile and columns
// 32 h + 4 lc of its warp's DW. Where WN = 2 the two warps of a row group
// compute the same P^T and dS^T, each into its own rows of sPt / sSt.
template <int DMAX>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int D,
    float scale, int causal, int vec) {
  using C = F32Tile<DMAX>;
  constexpr int BKV = C::BKV, BQ = C::BQ, LD = C::LD;
  constexpr int RG = 4 / C::WN, DW = DMAX / C::WN, NW = DW / 32;
  constexpr int NJ = BQ / 8, LQ = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // BKV x LD
  float* sV = sK + BKV * LD;                        // BKV x LD
  float* sQ = sV + BKV * LD;                        // 2 x BQ x LD
  float* sG = sQ + 2 * BQ * LD;                     // 2 x BQ x LD (dO)
  float* sPt = sG + 2 * BQ * LD;                    // 64 x LQ (P^T)
  float* sSt = sPt + 64 * LQ;                       // 64 x LQ (dS^T)
  float* sL = sSt + 64 * LQ;                        // 2 x BQ
  float* sD = sL + 2 * BQ;                          // 2 x BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 3, lc = lane & 7;
  const int kr = (warp % RG) * 16 + lr, c0 = (warp / RG) * DW;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;
  const float* qb = q + bh * Sq * D;
  const float* gb = g + bh * Sq * D;
  const float* lb = lse + bh * Sq;
  const float* db = delta + bh * Sq;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  int keys[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) keys[i] = k0 + kr + 4 * i;

  load_tile_f32<BKV, DMAX>(sK, k + bh * Sk * D, k0, Sk, D, vec);
  load_tile_f32<BKV, DMAX>(sV, v + bh * Sk * D, k0, Sk, D, vec);
  if (qt0 < nqt) {
    load_tile_f32<BQ, DMAX>(sQ, qb, qt0 * BQ, Sq, D, vec);
    load_tile_f32<BQ, DMAX>(sG, gb, qt0 * BQ, Sq, D, vec);
    load_rows<BQ>(sL, lb, qt0 * BQ, Sq);
    load_rows<BQ>(sD, db, qt0 * BQ, Sq);
  }
  cp_async_commit();

  float4 dk_acc[4][NW], dv_acc[4][NW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < NW; ++h)
      dk_acc[i][h] = dv_acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int qt = qt0; qt < nqt; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // as in K3: one barrier per tile
    if (qt + 1 < nqt) {
      const int nq0 = (qt + 1) * BQ;
      load_tile_f32<BQ, DMAX>(sQ + (st ^ 1) * BQ * LD, qb, nq0, Sq, D, vec);
      load_tile_f32<BQ, DMAX>(sG + (st ^ 1) * BQ * LD, gb, nq0, Sq, D, vec);
      load_rows<BQ>(sL + (st ^ 1) * BQ, lb, nq0, Sq);
      load_rows<BQ>(sD + (st ^ 1) * BQ, db, nq0, Sq);
      cp_async_commit();
    }
    const float* tQ = sQ + st * BQ * LD;
    const float* tG = sG + st * BQ * LD;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    const int q0 = qt * BQ;

    float s[4][NJ], dp[4][NJ];
    scores<NJ, DMAX>(s, sK + kr * LD, tQ + lc * LD, D);   // K Q^T
    scores<NJ, DMAX>(dp, sV + kr * LD, tG + lc * LD, D);  // V dO^T
    float* pt = sPt + (warp * 16 + lr) * LQ;
    float* dsw = sSt + (warp * 16 + lr) * LQ;
    const bool masked =
        q0 + BQ > Sq || k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = lc + 8 * j, qpos = q0 + qc;
        const bool ok = !masked || (qpos < Sq && keys[i] < Sk &&
                                    (!causal || keys[i] <= qpos));
        const float p =
            ok ? expf(s[i][j] * scale - tL[qc]) : 0.f;
        pt[4 * i * LQ + qc] = p;                                // P^T
        dsw[4 * i * LQ + qc] = p * (dp[i][j] - tD[qc]) * scale;  // dS^T
      }
    __syncwarp();
    mul_acc<BQ, NW, DMAX>(dv_acc, pt, tG + c0 + 4 * lc, c0, D);   // P^T dO
    mul_acc<BQ, NW, DMAX>(dk_acc, dsw, tQ + c0 + 4 * lc, c0, D);  // dS^T Q
  }
  cp_async_wait<0>();  // no copy is left in flight where no q tile ran

  const float unit[4] = {1.f, 1.f, 1.f, 1.f};
  store_f32<NW>(dk + bh * Sk * D, dk_acc, keys, unit, c0, Sk, D, vec);
  store_f32<NW>(dv + bh * Sk * D, dv_acc, keys, unit, c0, Sk, D, vec);
}

// -- host side -------------------------------------------------------------

template <int DMAX>
inline size_t fwd_smem() {
  using C = F32Tile<DMAX>;
  return sizeof(float) *
         ((C::BM + 4 * C::BN) * C::LD + C::BM * (C::BN + 8));
}

template <int DMAX>
inline size_t dq_smem() {
  using C = F32Tile<DMAX>;
  return sizeof(float) *
         ((2 * C::BM + 4 * C::BNQ) * C::LD + C::BM * (C::BNQ + 8));
}

template <int DMAX>
inline size_t dkv_smem() {
  using C = F32Tile<DMAX>;
  return sizeof(float) * ((2 * C::BKV + 4 * C::BQ) * C::LD +
                          2 * 64 * (C::BQ + 8) + 4 * C::BQ);
}

// Each kernel needs more than the default 48 KB of dynamic shared memory;
// the attribute is set on every call (it is per function and cheap).
template <class K>
inline int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool shapes_ok(int bh, int sq, int sk, int d) {
  return bh > 0 && sq > 0 && sk > 0 && d >= 1 && d <= 256;
}

// 16-byte cp.async and stores need every f32 row 16-byte aligned
inline int vec_f32(int d, std::initializer_list<const void*> ptrs) {
  if (d % 4) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <int DMAX>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int sq, int sk, int d, float scale, int causal,
        int has_delta, int pos_delta, cudaStream_t st) {
  const size_t bytes = fwd_smem<DMAX>();
  auto kernel = flash_fwd_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + F32Tile<DMAX>::BM - 1) / F32Tile<DMAX>::BM);
  kernel<<<grid, kF32Threads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, sq, sk, d, scale, causal, has_delta, pos_delta,
      vec_f32(d, {q, k, v, out}));
  return (int)cudaGetLastError();
}

template <int DMAX>
int bwd_dq(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int bh, int sq,
           int sk, int d, float scale, int causal, cudaStream_t st) {
  const size_t bytes = dq_smem<DMAX>();
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + F32Tile<DMAX>::BM - 1) / F32Tile<DMAX>::BM);
  kernel<<<grid, kF32Threads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (float*)dq, sq, sk, d, scale,
      causal, vec_f32(d, {q, k, v, g, dq}));
  return (int)cudaGetLastError();
}

template <int DMAX>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int sq, int sk, int d, float scale, int causal,
            cudaStream_t st) {
  const size_t bytes = dkv_smem<DMAX>();
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sk + F32Tile<DMAX>::BKV - 1) / F32Tile<DMAX>::BKV);
  kernel<<<grid, kF32Threads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, sq, sk,
      d, scale, causal, vec_f32(d, {q, k, v, g, dk, dv}));
  return (int)cudaGetLastError();
}

template <int DMAX>
struct Dim {
  static constexpr int value = DMAX;
};

// Calls f(DMAX tag) for the head dim's bucket of the f32 kernels (dtype
// 0), or returns cudaErrorInvalidValue.
template <class F>
int dispatch(int dtype, int d, F f) {
  if (dtype == 0) {
    if (d <= 64) return f(Dim<64>());
    if (d <= 128) return f(Dim<128>());
    return f(Dim<256>());
  }
  return (int)cudaErrorInvalidValue;
}

// -- host side, bf16 -------------------------------------------------------

template <int DMAX>
inline size_t fwd_mma_smem() {
  using C = Tc<DMAX>;
  return sizeof(bf16) * (C::BM + 4 * C::BN) * C::LDS;
}

template <int DMAX>
inline size_t dq_mma_smem() {
  using C = Tc<DMAX>;
  return sizeof(bf16) * (2 * C::BM + 4 * C::BN) * C::LDS;
}

template <int DMAX>
inline size_t dkv_mma_smem() {
  using C = Tc<DMAX>;
  return sizeof(bf16) * (2 * C::BKV + 4 * C::BQ) * C::LDS +
         sizeof(float) * 4 * C::BQ;
}

// 16-byte cp.async needs every row 16-byte aligned
inline int vec_rows(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <int DMAX>
int fwd_mma(const void* q, const void* k, const void* v, void* out,
            void* lse, int bh, int sq, int sk, int d, float scale,
            int causal, int has_delta, int pos_delta, cudaStream_t st) {
  const size_t bytes = fwd_mma_smem<DMAX>();
  auto kernel = flash_fwd_mma_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + Tc<DMAX>::BM - 1) / Tc<DMAX>::BM);
  kernel<<<grid, kTcThreads, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, sq, sk, d, scale, causal, has_delta, pos_delta,
      vec_rows(d, {q, k, v}));
  return (int)cudaGetLastError();
}

template <int DMAX>
int bwd_dq_mma(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq, int bh, int sq,
               int sk, int d, float scale, int causal, cudaStream_t st) {
  const size_t bytes = dq_mma_smem<DMAX>();
  auto kernel = flash_bwd_dq_mma_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + Tc<DMAX>::BM - 1) / Tc<DMAX>::BM);
  kernel<<<grid, kTcThreads, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (bf16*)dq, sq, sk, d, scale,
      causal, vec_rows(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

template <int DMAX>
int bwd_dkv_mma(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int bh, int sq, int sk, int d, float scale, int causal,
                cudaStream_t st) {
  const size_t bytes = dkv_mma_smem<DMAX>();
  auto kernel = flash_bwd_dkv_mma_kernel<DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sk + Tc<DMAX>::BKV - 1) / Tc<DMAX>::BKV);
  kernel<<<grid, kTcThreads, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, sq, sk,
      d, scale, causal, vec_rows(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

// Calls f(DMAX tag) for the head dim's bucket of the bf16 kernels.
template <class F>
int dispatch_bf16(int d, F f) {
  if (d <= 64) return f(Dim<64>());
  if (d <= 128) return f(Dim<128>());
  return f(Dim<256>());
}


}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, dO and the outputs share it); lse and
// delta are f32 (B*H, Sq). bh = B*H; 1 <= d <= 256. Each returns
// cudaGetLastError() after the launch.

extern "C" int singa_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int bh,
                               int sq, int sk, int d, float scale,
                               int causal, int has_delta, int pos_delta,
                               void* stream) {
  if (!shapes_ok(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bf16(d, [&](auto dim) {
      return fwd_mma<decltype(dim)::value>(q, k, v, out, lse, bh, sq, sk, d,
                                           scale, causal, has_delta,
                                           pos_delta, st);
    });
  return dispatch(dtype, d, [&](auto dim) {
    return fwd<decltype(dim)::value>(q, k, v, out, lse, bh, sq, sk, d, scale,
                                     causal, has_delta, pos_delta, st);
  });
}

extern "C" int singa_flash_bwd_dq(int dtype, const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* delta,
                                  void* dq, int bh, int sq, int sk, int d,
                                  float scale, int causal, void* stream) {
  if (!shapes_ok(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bf16(d, [&](auto dim) {
      return bwd_dq_mma<decltype(dim)::value>(q, k, v, g, lse, delta, dq, bh,
                                              sq, sk, d, scale, causal, st);
    });
  return dispatch(dtype, d, [&](auto dim) {
    return bwd_dq<decltype(dim)::value>(q, k, v, g, lse, delta, dq, bh, sq,
                                        sk, d, scale, causal, st);
  });
}

extern "C" int singa_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int sq,
                                   int sk, int d, float scale, int causal,
                                   void* stream) {
  if (!shapes_ok(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bf16(d, [&](auto dim) {
      return bwd_dkv_mma<decltype(dim)::value>(q, k, v, g, lse, delta, dk, dv,
                                               bh, sq, sk, d, scale, causal,
                                               st);
    });
  return dispatch(dtype, d, [&](auto dim) {
    return bwd_dkv<decltype(dim)::value>(q, k, v, g, lse, delta, dk, dv, bh,
                                         sq, sk, d, scale, causal, st);
  });
}

// The f32 kernel `which` (0 K3, 1 K4-dQ, 2 K4-dKV) of head dim d's bucket:
// out[0] registers per thread, out[1] local memory per thread in bytes
// (spills), out[2] dynamic shared memory per block in bytes. Returns the
// error of cudaFuncGetAttributes.
extern "C" int singa_flash_f32_resources(int which, int d, int* out) {
  if (which < 0 || which > 2 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  return dispatch(0, d, [&](auto dim) {
    constexpr int DMAX = decltype(dim)::value;
    cudaFuncAttributes a;
    cudaError_t err;
    size_t bytes;
    if (which == 0) {
      err = cudaFuncGetAttributes(&a, flash_fwd_kernel<DMAX>);
      bytes = fwd_smem<DMAX>();
    } else if (which == 1) {
      err = cudaFuncGetAttributes(&a, flash_bwd_dq_kernel<DMAX>);
      bytes = dq_smem<DMAX>();
    } else {
      err = cudaFuncGetAttributes(&a, flash_bwd_dkv_kernel<DMAX>);
      bytes = dkv_smem<DMAX>();
    }
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)bytes;
    return (int)err;
  });
}
