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
//
// Inputs q, k, v (and dO) are (B*H, S, D) contiguous, all f32 or all bf16;
// every product is taken in f32 of the upcast inputs and every sum is f32
// (the JAX kernels compute in f32; TF32 would change the result, and a
// product of two bf16 values is exact in f32). out, dq, dk, dv are written
// in the inputs' type, lse in f32. Masked scores are -1e30, not -inf
// (_NEG_INF); causal masking is top-left aligned, k_pos <= q_pos. Rows and
// keys past Sq / Sk (a ragged last tile) are masked here: there is no
// divisibility requirement. pos_delta (forward only) adds a global-position
// delta to q_pos for ring attention: the k loop is then not pruned and a
// fully masked row gets p = 0 (out 0, lse -1e30), as in the JAX kernel.
// Here p is zeroed on every masked entry in every mode; without a delta
// that is the value exp(-1e30 - m) already has, since tile 0 always holds
// an unmasked key.
//
// Bound: at the LM shape (B8 H8 S1024 D64, causal) the work is f32
// arithmetic, not bytes: K3 does 4*D flops per unmasked (q, k) pair (8.6
// GFLOP) against 34-67 MB of traffic, 0.128 ms at the data sheet's 67
// TFLOP/s f32 against 0.010-0.020 ms at 3.35 TB/s; K4 does 6*D (dQ) and
// 8*D (dK/dV) flops per pair. Design: the TPU grid's sequential k (or q)
// dimension is a loop inside one block of 256 threads. A block owns a
// 64-row tile (32 when D > 128); the far-side tiles are staged through
// shared memory as f32, rows padded to an odd stride so that the column
// walks are free of bank conflicts; each thread holds a 4x4 (2x2) register
// tile of scores and RD = DMAX/16 output columns of its rows. Causal k
// tiles wholly above the diagonal are never loaded. No atomics: each output
// tile is written by one block, so the result is deterministic. The f32
// FMAs run on the CUDA cores, so the kernels are instruction-bound short of
// the f32 peak; wgmma (bf16) and TMA are the next step.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct F32 {
  using T = float;
  static __device__ __forceinline__ float to_f(T v) { return v; }
  static __device__ __forceinline__ T from_f(float f) { return f; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float to_f(T v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ T from_f(float f) {
    return __float2bfloat16_rn(f);
  }
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

// Calls f(P(), std::integral_constant-like DMAX tag) for the runtime dtype
// (0 = f32, 1 = bf16) and head dim, or returns cudaErrorInvalidValue.
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
  if (dtype == 1) {
    if (d <= 64) return f(BF16(), Dim<64>());
    if (d <= 128) return f(BF16(), Dim<128>());
    return f(BF16(), Dim<256>());
  }
  return (int)cudaErrorInvalidValue;
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
  return dispatch(dtype, d, [&](auto p, auto dim) {
    return bwd_dkv<decltype(p), decltype(dim)::value>(
        q, k, v, g, lse, delta, dk, dv, bh, sq, sk, d, scale, causal, st);
  });
}
