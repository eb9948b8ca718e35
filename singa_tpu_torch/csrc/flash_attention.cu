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
// JAX kernels compute in f32; TF32 would change the result). Bound: at the
// LM shape (B8 H8 S1024 D64, causal) the work is f32 arithmetic, not
// bytes: K3 does 4*D flops per unmasked (q, k) pair (8.6 GFLOP) against
// 34-67 MB of traffic, 0.128 ms at the data sheet's 67 TFLOP/s f32 against
// 0.010-0.020 ms at 3.35 TB/s; K4 does 6*D (dQ) and 8*D (dK/dV) flops per
// pair. Design: the TPU grid's sequential k (or q) dimension is a loop
// inside one block of 256 threads. A block owns a 64-row tile (32 when
// D > 128); the far-side tiles are staged through shared memory as f32,
// rows padded to an odd stride so that the column walks are free of bank
// conflicts; each thread holds a 4x4 (2x2) register tile of scores and
// RD = DMAX/16 output columns of its rows. The kernels are
// instruction-bound short of the f32 peak.
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
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct F32 {
  using T = float;
  static __device__ __forceinline__ float to_f(T v) { return v; }
  static __device__ __forceinline__ T from_f(float f) { return f; }
};

// tile rows by head-dim bucket: 64 up to D = 128, 32 above (shared memory)
template <int DMAX>
struct Cfg {
  static constexpr int B = DMAX > 128 ? 32 : 64;  // rows of a q or k tile
  static constexpr int R = B / 16;                // tile rows per thread
  static constexpr int RD = DMAX / 16;            // head columns per thread
  static constexpr int LD = DMAX + 1;             // padded row stride
  static constexpr int LP = B + 1;                // stride of a B x B tile
};

// rows [row0, row0 + rows) of one (S, D) slice into smem as f32, stride
// ld; rows past S are zero. The rows are contiguous in memory.
template <class P>
__device__ __forceinline__ void load_tile(float* dst,
                                          const typename P::T* src,
                                          int row0, int rows, int S, int D,
                                          int ld) {
  const int valid = min(rows, S - row0);
  const int n = rows * D;
  const int nvalid = valid > 0 ? valid * D : 0;
  const typename P::T* base = src + (long long)row0 * D;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = i < nvalid ? P::to_f(base[i]) : 0.f;
  }
}

// sum / max over the 16 lanes of a tile row (lanes tx = 0..15 of one ty)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- K3 -----
// grid (B*H, q tiles); the heaviest causal q tiles are dispatched first.
template <class P, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
    const typename P::T* __restrict__ v, typename P::T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int D, float scale, int causal,
    int has_delta, int pos_delta) {
  using C = Cfg<DMAX>;
  constexpr int BT = C::B, R = C::R, RD = C::RD, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sQ = smem;            // BT x LD
  float* sK = sQ + BT * LD;    // BT x LD
  float* sV = sK + BT * LD;    // BT x LD
  float* sP = sV + BT * LD;    // BT x LP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const typename P::T* kb = k + bh * Sk * D;
  const typename P::T* vb = v + bh * Sk * D;
  load_tile<P>(sQ, q + bh * Sq * D, q0, BT, Sq, D, LD);

  float m[R], l[R], acc[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }
  const int delta = has_delta ? pos_delta : 0;
  const int nkb = (Sk + BT - 1) / BT;
  const int kend =
      (causal && !has_delta) ? min(nkb, (q0 + BT - 1) / BT + 1) : nkb;

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<P>(sK, kb, k0, BT, Sk, D, LD);
    load_tile<P>(sV, vb, k0, BT, Sk, D, LD);
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i + delta;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && (!causal || kp <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BT, Sk - k0);  // keys past Sk have p = 0
    for (int c = 0; c < kn; ++c) {
      float vv[RD];
#pragma unroll
      for (int cc = 0; cc < RD; ++cc) vv[cc] = sV[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sP[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int cc = 0; cc < RD; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

  const long long obase = bh * Sq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < RD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) out[(obase + row) * D + d] = P::from_f(acc[i][cc] / ls);
    }
    if (tx == 0) lse[obase + row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------------- K4-dQ -----
// grid (B*H, q tiles): loops over k tiles up to the diagonal.
template <class P, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
    const typename P::T* __restrict__ v, const typename P::T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    typename P::T* __restrict__ dq, int Sq, int Sk, int D, float scale,
    int causal) {
  using C = Cfg<DMAX>;
  constexpr int BT = C::B, R = C::R, RD = C::RD, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sQ = smem;            // BT x LD
  float* sG = sQ + BT * LD;    // BT x LD (dO)
  float* sK = sG + BT * LD;    // BT x LD
  float* sV = sK + BT * LD;    // BT x LD
  float* sS = sV + BT * LD;    // BT x LP (dS)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const typename P::T* kb = k + bh * Sk * D;
  const typename P::T* vb = v + bh * Sk * D;
  load_tile<P>(sQ, q + bh * Sq * D, q0, BT, Sq, D, LD);
  load_tile<P>(sG, g + bh * Sq * D, q0, BT, Sq, D, LD);

  float lse_r[R], delta_r[R], acc[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }
  const int nkb = (Sk + BT - 1) / BT;
  const int kend = causal ? min(nkb, (q0 + BT - 1) / BT + 1) : nkb;

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile<P>(sK, kb, k0, BT, Sk, D, LD);
    load_tile<P>(sV, vb, k0, BT, Sk, D, LD);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + d];
        gv[i] = sG[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < Sk && (!causal || kp <= qpos);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sS[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

    const int kn = min(BT, Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float kv[RD];
#pragma unroll
      for (int cc = 0; cc < RD; ++cc) kv[cc] = sK[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = sS[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int cc = 0; cc < RD; ++cc) acc[i][cc] = fmaf(ds, kv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int cc = 0; cc < RD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) dq[(bh * Sq + row) * D + d] = P::from_f(acc[i][cc]);
    }
  }
}

// ------------------------------------------------------------ K4-dKV -----
// grid (B*H, k tiles): loops over q tiles from the diagonal. Here a thread
// owns key rows ty + 16 i and query columns tx + 16 j of each score tile.
template <class P, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
    const typename P::T* __restrict__ v, const typename P::T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    typename P::T* __restrict__ dk, typename P::T* __restrict__ dv, int Sq,
    int Sk, int D, float scale, int causal) {
  using C = Cfg<DMAX>;
  constexpr int BT = C::B, R = C::R, RD = C::RD, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sK = smem;            // BT x LD
  float* sV = sK + BT * LD;    // BT x LD
  float* sQ = sV + BT * LD;    // BT x LD
  float* sG = sQ + BT * LD;    // BT x LD (dO)
  float* sPt = sG + BT * LD;   // BT x LP (P^T: key rows, query columns)
  float* sSt = sPt + BT * LP;  // BT x LP (dS^T)
  float* sLse = sSt + BT * LP; // BT
  float* sDelta = sLse + BT;   // BT

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const typename P::T* qb = q + bh * Sq * D;
  const typename P::T* gb = g + bh * Sq * D;
  load_tile<P>(sK, k + bh * Sk * D, k0, BT, Sk, D, LD);
  load_tile<P>(sV, v + bh * Sk * D, k0, BT, Sk, D, LD);

  float dk_acc[R][RD], dv_acc[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < RD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nqb = (Sq + BT - 1) / BT;
  const int qstart = causal ? k0 / BT : 0;

  for (int qt = qstart; qt < nqb; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile<P>(sQ, qb, q0, BT, Sq, D, LD);
    load_tile<P>(sG, gb, q0, BT, Sq, D, LD);
    for (int r = threadIdx.x; r < BT; r += kThreads) {
      const bool in = q0 + r < Sq;
      sLse[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
      sDelta[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[R], vv[R], qv[R], gv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = sK[(ty + 16 * i) * LD + d];
        vv[i] = sV[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + d];
        gv[j] = sG[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(gv[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = tx + 16 * j;
        const int qpos = q0 + r;
        const bool ok = qpos < Sq && kp < Sk && (!causal || kp <= qpos);
        const float p = ok ? expf(s[i][j] * scale - sLse[r]) : 0.f;
        sPt[(ty + 16 * i) * LP + r] = p;
        sSt[(ty + 16 * i) * LP + r] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();

    const int qn = min(BT, Sq - q0);  // rows past Sq have p = dS = 0
    for (int r = 0; r < qn; ++r) {
      float qv[RD], gv[RD];
#pragma unroll
      for (int cc = 0; cc < RD; ++cc) {
        qv[cc] = sQ[r * LD + tx + 16 * cc];
        gv[cc] = sG[r * LD + tx + 16 * cc];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sPt[(ty + 16 * i) * LP + r];
        const float ds = sSt[(ty + 16 * i) * LP + r];
#pragma unroll
        for (int cc = 0; cc < RD; ++cc) {
          dv_acc[i][cc] = fmaf(p, gv[cc], dv_acc[i][cc]);
          dk_acc[i][cc] = fmaf(ds, qv[cc], dk_acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int cc = 0; cc < RD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dk[(bh * Sk + row) * D + d] = P::from_f(dk_acc[i][cc]);
        dv[(bh * Sk + row) * D + d] = P::from_f(dv_acc[i][cc]);
      }
    }
  }
}

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

// -- host side -------------------------------------------------------------

template <int DMAX>
inline size_t fwd_smem() {
  using C = Cfg<DMAX>;
  return sizeof(float) * (3 * C::B * C::LD + C::B * C::LP);
}

template <int DMAX>
inline size_t dq_smem() {
  using C = Cfg<DMAX>;
  return sizeof(float) * (4 * C::B * C::LD + C::B * C::LP);
}

template <int DMAX>
inline size_t dkv_smem() {
  using C = Cfg<DMAX>;
  return sizeof(float) * (4 * C::B * C::LD + 2 * C::B * C::LP + 2 * C::B);
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

template <class P, int DMAX>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int sq, int sk, int d, float scale, int causal,
        int has_delta, int pos_delta, cudaStream_t st) {
  using T = typename P::T;
  const size_t bytes = fwd_smem<DMAX>();
  auto kernel = flash_fwd_kernel<P, DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + Cfg<DMAX>::B - 1) / Cfg<DMAX>::B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, sq, sk,
      d, scale, causal, has_delta, pos_delta);
  return (int)cudaGetLastError();
}

template <class P, int DMAX>
int bwd_dq(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int bh, int sq,
           int sk, int d, float scale, int causal, cudaStream_t st) {
  using T = typename P::T;
  const size_t bytes = dq_smem<DMAX>();
  auto kernel = flash_bwd_dq_kernel<P, DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sq + Cfg<DMAX>::B - 1) / Cfg<DMAX>::B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
      (const float*)delta, (T*)dq, sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <class P, int DMAX>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int sq, int sk, int d, float scale, int causal,
            cudaStream_t st) {
  using T = typename P::T;
  const size_t bytes = dkv_smem<DMAX>();
  auto kernel = flash_bwd_dkv_kernel<P, DMAX>;
  int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (sk + Cfg<DMAX>::B - 1) / Cfg<DMAX>::B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

// Calls f(P(), std::integral_constant-like DMAX tag) for f32 (dtype 0) and
// the head dim, or returns cudaErrorInvalidValue.
template <int DMAX>
struct Dim {
  static constexpr int value = DMAX;
};

template <class F>
int dispatch(int dtype, int d, F f) {
  if (dtype == 0) {
    if (d <= 64) return f(F32(), Dim<64>());
    if (d <= 128) return f(F32(), Dim<128>());
    return f(F32(), Dim<256>());
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
  return dispatch(dtype, d, [&](auto p, auto dim) {
    return fwd<decltype(p), decltype(dim)::value>(
        q, k, v, out, lse, bh, sq, sk, d, scale, causal, has_delta,
        pos_delta, st);
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
  return dispatch(dtype, d, [&](auto p, auto dim) {
    return bwd_dq<decltype(p), decltype(dim)::value>(
        q, k, v, g, lse, delta, dq, bh, sq, sk, d, scale, causal, st);
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
  return dispatch(dtype, d, [&](auto p, auto dim) {
    return bwd_dkv<decltype(p), decltype(dim)::value>(
        q, k, v, g, lse, delta, dk, dv, bh, sq, sk, d, scale, causal, st);
  });
}
