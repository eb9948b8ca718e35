// Fused optimizer updates for Hopper (sm_90a): one pass over a parameter,
// in place. Kernels K1 (SGD momentum), K5 (Adam), K6 (RMSProp) and K7
// (AdaGrad) of the port:
//
//   K1  g += wd*p;  m' = mu*m + (1-d)*g;  p' = p - lr*(nesterov ? g + mu*m' : m')
//   K5  g += wd*p;  m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g;
//       p' = p - lr*(m'/bc1) / (sqrt(v'/bc2) + eps)
//   K6  g += wd*p;  r' = rho*r + (1-rho)*g*g, stored;  p' = p - lr*g / sqrt(r'+eps)
//   K7  g += wd*p;  h' = h + g*g, stored;              p' = p - lr*g / sqrt(h'+eps)
//
// Replaces singa_tpu/ops/fused_optim.py::_sgd_kernel, _adam_kernel,
// _rmsprop_kernel and _adagrad_kernel (the pallas_call sites of
// sgd_momentum_update, adam_update, rmsprop_update and adagrad_update).
// All arithmetic is f32; the parameter p and the gradient g are f32, bf16
// or f16 (g in p's type: the wrapper casts it, as opt.py does), and the
// state (m, v, r, h) is f32, bf16 or f16, stored back in its own type. K6
// and K7 store the new state and read the stored value back for the
// parameter update, so a 16-bit state rounds at the same point as in the
// reference (singa_tpu/ops/fused_optim.py:270-278, 323-328).
//
// The learning rate, and K5's bias corrections 1 - b^t, are read from
// device pointers (0-d f32 tensors the optimizer computes from its step
// counter on the card), so a schedule costs no host sync and no rebuild.
// The hyperparameters JAX bakes into the kernel (mu, 1-d, wd, nesterov,
// the betas, rho, eps) are arguments here; the 1-x terms are computed in
// double on the host and rounded once to f32, as JAX folds its constants.
//
// Bound: HBM bytes. Per element K1, K6 and K7 read p, g and one state and
// write p and the state: 20 B in f32 against under 10 flops. K5 reads
// p, g, m, v and writes p, m, v: 28 B. ResNet-50 (10 classes) has
// 23,528,522 parameters in 161 tensors, so one step moves 470.6 MB
// (K1/K6/K7) or 658.8 MB (K5): 0.140 ms / 0.197 ms at the H100 SXM
// data-sheet 3.35 TB/s. 106 of the 161 tensors are BN vectors of 64-2048
// elements, so one launch per tensor makes a step's update cost the
// launches (and their host work), not the bytes.
//
// Design, per tensor (singa_*_update): one flat grid-stride loop over n
// elements. When every pointer is aligned to a 4-element vector, each
// thread moves 4 elements per access (16 B per f32 array), then a scalar
// loop covers the rest (all of it when a pointer is not aligned). The TPU
// kernel's (rows, 128) tiles and zero padding are Mosaic details with no
// counterpart here.
//
// Design, multi-tensor (singa_sgd_update_multi, singa_adam_update_multi,
// singa_rmsprop_update_multi, singa_adagrad_update_multi: K1, K5, K6 and
// K7 over all of a step's parameters at once): the host passes an array
// of per-tensor entries (pointers, n, the tensor's own lr pointer and
// weight decay). The table reaches the device BY VALUE, as the kernel's
// one parameter (a __grid_constant__ struct of at most 4 KB, the limit
// every toolkit and card take). K1, K6 and K7 carry one state each and
// share one table (OneStateTable, SGD_MULTI_MAX = 83 entries per launch);
// K5 has its own (ADAM_MULTI_MAX = 70). So a ResNet-50 step is 2 (K1,
// K6, K7) or 3 (K5) launches in place of 161. No device table, no copy and
// no allocation, so stream order alone orders one step's launch after the
// last; the table is rebuilt from the current gradients every call. Each
// tensor gets ceil(n / TILE) blocks of 256 threads, TILE = 4096 elements;
// a block finds its tensor by a binary search of the cumulative block
// counts in the table and its range from its rank among that tensor's
// blocks, so a 64-element BN vector and a 2.36 M-element conv weight share
// one grid. The 4-wide path is chosen per tensor from its own pointers'
// alignment (a tile starts at a multiple of TILE, so it keeps it). Both
// designs run the same per-element update (sgd_elem / adam_elem /
// scaled_elem) through the same span loop (sgd_span / adam_span /
// scaled_span), so a multi-tensor launch is bitwise-equal to one launch
// per tensor and to the plain version.
//
// Skip flag (the multi-tensor kernels only): a guarded training step
// (resilience.GuardedOptimizer, dynamic loss scaling) decides on the card
// whether its gradients are finite, and the host never reads the verdict.
// The table carries a pointer to that verdict, a 0-d f32 device tensor
// `ok` (null: no flag). Each block reads it first and returns at once
// when it is 0, so a bad step writes nothing, as the reference's
// where(ok, new, old) leaves every state as it was
// (singa_tpu/resilience/guards.py:350-362); with ok = 1 or no flag the
// block runs the element loop unchanged, so the result stays bitwise. A
// skipped launch costs a launch and one 4-byte read per block.
//
// Numerics: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn
// keep the compiler from contracting a multiply and an add into an FMA,
// and every operation happens in the reference's order, so the result is
// bitwise-equal to the plain PyTorch version (ops/fused_optim.py), which
// runs one rounded elementwise op at a time.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// One tensor of a multi-tensor update, as the host passes it: its
// pointers, its element count (> 0), a device pointer to its own f32
// learning rate and its own weight decay. SingaSgdEntry serves every
// one-state kernel: m is K1's momentum, K6's mean square or K7's history.
struct SingaSgdEntry {
  void* p;
  const void* g;
  void* m;
  const void* lr;
  long long n;
  float weight_decay;
};

struct SingaAdamEntry {
  void* p;
  const void* g;
  void* m;
  void* v;
  const void* lr;
  long long n;
  float weight_decay;
};

// entries per multi-tensor launch: as many as fit the 4 KB table (one
// state: K1, K6, K7; two states: K5)
#define SGD_MULTI_MAX 83
#define ADAM_MULTI_MAX 70

namespace {

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

struct F16 {
  using T = __half;
  static __device__ __forceinline__ float to_f(T v) { return __half2float(v); }
  static __device__ __forceinline__ T from_f(float f) {
    return __float2half_rn(f);
  }
};

constexpr int V = 4;  // elements per vector access

template <class T>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

// host side: whether a pointer allows whole-vector accesses
template <class T>
inline bool aligned(const T* ptr) {
  return (uintptr_t)ptr % (sizeof(T) * V) == 0;
}

// -- the per-element updates, in the reference's operation order --------

struct SgdArgs {
  float momentum, one_minus_dampening, weight_decay;
  int nesterov;
};

// returns the new parameter; m is updated in place
__device__ __forceinline__ float sgd_elem(float p, float g, float& m,
                                          float lr, const SgdArgs& a) {
  if (a.weight_decay != 0.f) g = __fadd_rn(g, __fmul_rn(a.weight_decay, p));
  const float mn = __fadd_rn(__fmul_rn(a.momentum, m),
                             __fmul_rn(a.one_minus_dampening, g));
  const float upd = a.nesterov ? __fadd_rn(g, __fmul_rn(a.momentum, mn)) : mn;
  m = mn;
  return __fsub_rn(p, __fmul_rn(lr, upd));
}

struct AdamArgs {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay;
};

__device__ __forceinline__ float adam_elem(float p, float g, float& m,
                                           float& v, float lr, float bc1,
                                           float bc2, const AdamArgs& a) {
  if (a.weight_decay != 0.f) g = __fadd_rn(g, __fmul_rn(a.weight_decay, p));
  const float mn = __fadd_rn(__fmul_rn(a.beta1, m),
                             __fmul_rn(a.one_minus_beta1, g));
  const float vn = __fadd_rn(__fmul_rn(a.beta2, v),
                             __fmul_rn(__fmul_rn(a.one_minus_beta2, g), g));
  const float mhat = __fdiv_rn(mn, bc1);
  const float vhat = __fdiv_rn(vn, bc2);
  m = mn;
  v = vn;
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, mhat),
                                __fadd_rn(__fsqrt_rn(vhat), a.eps)));
}

struct RmsArgs {
  float rho, one_minus_rho, eps, weight_decay;
};

// K6 (ADAGRAD = false) and K7 (ADAGRAD = true): returns the new
// parameter; r is replaced by the new state, rounded to its own type,
// and the step reads that stored value back
template <class S, bool ADAGRAD>
__device__ __forceinline__ float scaled_elem(float p, float g,
                                             typename S::T& r, float lr,
                                             const RmsArgs& a) {
  if (a.weight_decay != 0.f) g = __fadd_rn(g, __fmul_rn(a.weight_decay, p));
  const float rf = S::to_f(r);
  r = S::from_f(ADAGRAD ? __fadd_rn(rf, __fmul_rn(g, g))
                        : __fadd_rn(__fmul_rn(a.rho, rf),
                                    __fmul_rn(__fmul_rn(a.one_minus_rho, g),
                                              g)));
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                                __fsqrt_rn(__fadd_rn(S::to_f(r), a.eps))));
}

// -- the span loops -----------------------------------------------------
// Elements [0, n) of one tensor, thread `tid` of `stride`: whole vectors
// first (when `vec`), then single elements from `nvec * V` on. The
// per-tensor kernels run them over the whole tensor with a grid-stride,
// the multi-tensor kernels over one block's tile with a block-stride.

template <class P, class S>
__device__ __forceinline__ void sgd_span(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, float lr, long long n,
    const SgdArgs& a, bool vec, long long tid, long long stride) {
  const long long nvec = vec ? n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    Vec<typename P::T> pv = reinterpret_cast<Vec<typename P::T>*>(p)[i];
    const Vec<typename P::T> gv =
        reinterpret_cast<const Vec<typename P::T>*>(g)[i];
    Vec<typename S::T> mv = reinterpret_cast<Vec<typename S::T>*>(m)[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float mf = S::to_f(mv.e[k]);
      pv.e[k] = P::from_f(
          sgd_elem(P::to_f(pv.e[k]), P::to_f(gv.e[k]), mf, lr, a));
      mv.e[k] = S::from_f(mf);
    }
    reinterpret_cast<Vec<typename P::T>*>(p)[i] = pv;
    reinterpret_cast<Vec<typename S::T>*>(m)[i] = mv;
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    float mf = S::to_f(m[i]);
    p[i] = P::from_f(sgd_elem(P::to_f(p[i]), P::to_f(g[i]), mf, lr, a));
    m[i] = S::from_f(mf);
  }
}

template <class P, class S>
__device__ __forceinline__ void adam_span(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, typename S::T* __restrict__ v,
    float lr, float bc1, float bc2, long long n, const AdamArgs& a,
    bool vec, long long tid, long long stride) {
  const long long nvec = vec ? n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    Vec<typename P::T> pv = reinterpret_cast<Vec<typename P::T>*>(p)[i];
    const Vec<typename P::T> gv =
        reinterpret_cast<const Vec<typename P::T>*>(g)[i];
    Vec<typename S::T> mv = reinterpret_cast<Vec<typename S::T>*>(m)[i];
    Vec<typename S::T> vv = reinterpret_cast<Vec<typename S::T>*>(v)[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float mf = S::to_f(mv.e[k]), vf = S::to_f(vv.e[k]);
      pv.e[k] = P::from_f(adam_elem(P::to_f(pv.e[k]), P::to_f(gv.e[k]), mf,
                                    vf, lr, bc1, bc2, a));
      mv.e[k] = S::from_f(mf);
      vv.e[k] = S::from_f(vf);
    }
    reinterpret_cast<Vec<typename P::T>*>(p)[i] = pv;
    reinterpret_cast<Vec<typename S::T>*>(m)[i] = mv;
    reinterpret_cast<Vec<typename S::T>*>(v)[i] = vv;
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    float mf = S::to_f(m[i]), vf = S::to_f(v[i]);
    p[i] = P::from_f(
        adam_elem(P::to_f(p[i]), P::to_f(g[i]), mf, vf, lr, bc1, bc2, a));
    m[i] = S::from_f(mf);
    v[i] = S::from_f(vf);
  }
}

template <class P, class S, bool ADAGRAD>
__device__ __forceinline__ void scaled_span(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ r, float lr, long long n,
    const RmsArgs& a, bool vec, long long tid, long long stride) {
  const long long nvec = vec ? n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    Vec<typename P::T> pv = reinterpret_cast<Vec<typename P::T>*>(p)[i];
    const Vec<typename P::T> gv =
        reinterpret_cast<const Vec<typename P::T>*>(g)[i];
    Vec<typename S::T> rv = reinterpret_cast<Vec<typename S::T>*>(r)[i];
#pragma unroll
    for (int k = 0; k < V; ++k)
      pv.e[k] = P::from_f(scaled_elem<S, ADAGRAD>(
          P::to_f(pv.e[k]), P::to_f(gv.e[k]), rv.e[k], lr, a));
    reinterpret_cast<Vec<typename P::T>*>(p)[i] = pv;
    reinterpret_cast<Vec<typename S::T>*>(r)[i] = rv;
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    typename S::T rs = r[i];
    p[i] = P::from_f(
        scaled_elem<S, ADAGRAD>(P::to_f(p[i]), P::to_f(g[i]), rs, lr, a));
    r[i] = rs;
  }
}

// -- the kernels --------------------------------------------------------

template <class P, class S>
__global__ void __launch_bounds__(256) sgd_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, const float* __restrict__ lr_ptr,
    long long n, SgdArgs a, bool vec) {
  sgd_span<P, S>(p, g, m, __ldg(lr_ptr), n, a, vec,
                 (long long)blockIdx.x * blockDim.x + threadIdx.x,
                 (long long)gridDim.x * blockDim.x);
}

// RMSProp (ADAGRAD = false) and AdaGrad (ADAGRAD = true): one state r
template <class P, class S, bool ADAGRAD>
__global__ void __launch_bounds__(256) scaled_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ r, const float* __restrict__ lr_ptr,
    long long n, RmsArgs a, bool vec) {
  scaled_span<P, S, ADAGRAD>(p, g, r, __ldg(lr_ptr), n, a, vec,
                             (long long)blockIdx.x * blockDim.x + threadIdx.x,
                             (long long)gridDim.x * blockDim.x);
}

template <class P, class S>
__global__ void __launch_bounds__(256) adam_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, typename S::T* __restrict__ v,
    const float* __restrict__ lr_ptr, const float* __restrict__ bc1_ptr,
    const float* __restrict__ bc2_ptr, long long n, AdamArgs a, bool vec) {
  adam_span<P, S>(p, g, m, v, __ldg(lr_ptr), __ldg(bc1_ptr), __ldg(bc2_ptr),
                  n, a, vec,
                  (long long)blockIdx.x * blockDim.x + threadIdx.x,
                  (long long)gridDim.x * blockDim.x);
}

// -- the multi-tensor kernels -------------------------------------------
// The table is the kernel's only parameter. block_end[i] is the number of
// blocks of entries 0..i together; entry i takes ceil(n[i] / TILE) blocks.

constexpr int TILE = 4096;  // elements per block of a multi-tensor launch

// K1, K6 and K7: one state per entry (m: the momentum, the mean square or
// the history); the hyperparameters the entries share follow the entries
struct SgdShared {
  float momentum, one_minus_dampening;
  int nesterov;
};

struct ScaledShared {
  float rho, one_minus_rho, eps;
};

struct OneStateTable {
  void* p[SGD_MULTI_MAX];
  const void* g[SGD_MULTI_MAX];
  void* m[SGD_MULTI_MAX];
  const float* lr[SGD_MULTI_MAX];
  long long n[SGD_MULTI_MAX];
  float weight_decay[SGD_MULTI_MAX];
  int block_end[SGD_MULTI_MAX];
  unsigned char vec[SGD_MULTI_MAX];
  int count;
  union {
    SgdShared sgd;        // K1
    ScaledShared scaled;  // K6, K7 (rho unused by K7)
  } shared;
  const float* ok;        // the skip flag, or null
};

struct AdamTable {
  void* p[ADAM_MULTI_MAX];
  const void* g[ADAM_MULTI_MAX];
  void* m[ADAM_MULTI_MAX];
  void* v[ADAM_MULTI_MAX];
  const float* lr[ADAM_MULTI_MAX];
  long long n[ADAM_MULTI_MAX];
  float weight_decay[ADAM_MULTI_MAX];
  int block_end[ADAM_MULTI_MAX];
  unsigned char vec[ADAM_MULTI_MAX];
  int count;
  const float* bc1;
  const float* bc2;
  const float* ok;        // the skip flag, or null
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

static_assert(sizeof(OneStateTable) <= 4096 && sizeof(AdamTable) <= 4096,
              "a multi-tensor table must fit the 4 KB kernel parameter "
              "space");

// whether a guarded step's verdict tells the block to write nothing
__device__ __forceinline__ bool skipped(const float* ok) {
  return ok != nullptr && __ldg(ok) == 0.f;
}

// the entry whose blocks hold block b: the first i with b < block_end[i]
template <int N>
__device__ __forceinline__ int find_entry(const int (&block_end)[N],
                                          int count, int b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b < block_end[mid]) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// this block's tile of entry e: its first element and its length
template <int N>
__device__ __forceinline__ void tile_of(const int (&block_end)[N],
                                        const long long (&n)[N], int e,
                                        int b, long long& begin,
                                        long long& len) {
  begin = (long long)(b - (e ? block_end[e - 1] : 0)) * TILE;
  const long long rest = n[e] - begin;
  len = rest < TILE ? rest : TILE;
}

template <class P, class S>
__global__ void __launch_bounds__(256) sgd_multi_kernel(
    const __grid_constant__ OneStateTable t) {
  using PT = typename P::T;
  using ST = typename S::T;
  if (skipped(t.ok)) return;
  const int b = blockIdx.x;
  const int e = find_entry(t.block_end, t.count, b);
  long long begin, len;
  tile_of(t.block_end, t.n, e, b, begin, len);
  const SgdArgs a{t.shared.sgd.momentum, t.shared.sgd.one_minus_dampening,
                  t.weight_decay[e], t.shared.sgd.nesterov};
  sgd_span<P, S>(static_cast<PT*>(t.p[e]) + begin,
                 static_cast<const PT*>(t.g[e]) + begin,
                 static_cast<ST*>(t.m[e]) + begin, __ldg(t.lr[e]), len, a,
                 t.vec[e] != 0, threadIdx.x, blockDim.x);
}

template <class P, class S, bool ADAGRAD>
__global__ void __launch_bounds__(256) scaled_multi_kernel(
    const __grid_constant__ OneStateTable t) {
  using PT = typename P::T;
  using ST = typename S::T;
  if (skipped(t.ok)) return;
  const int b = blockIdx.x;
  const int e = find_entry(t.block_end, t.count, b);
  long long begin, len;
  tile_of(t.block_end, t.n, e, b, begin, len);
  const RmsArgs a{t.shared.scaled.rho, t.shared.scaled.one_minus_rho,
                  t.shared.scaled.eps, t.weight_decay[e]};
  scaled_span<P, S, ADAGRAD>(static_cast<PT*>(t.p[e]) + begin,
                             static_cast<const PT*>(t.g[e]) + begin,
                             static_cast<ST*>(t.m[e]) + begin,
                             __ldg(t.lr[e]), len, a, t.vec[e] != 0,
                             threadIdx.x, blockDim.x);
}

template <class P, class S>
__global__ void __launch_bounds__(256) adam_multi_kernel(
    const __grid_constant__ AdamTable t) {
  using PT = typename P::T;
  using ST = typename S::T;
  if (skipped(t.ok)) return;
  const int b = blockIdx.x;
  const int e = find_entry(t.block_end, t.count, b);
  long long begin, len;
  tile_of(t.block_end, t.n, e, b, begin, len);
  const AdamArgs a{t.beta1, t.one_minus_beta1, t.beta2, t.one_minus_beta2,
                   t.eps, t.weight_decay[e]};
  adam_span<P, S>(static_cast<PT*>(t.p[e]) + begin,
                  static_cast<const PT*>(t.g[e]) + begin,
                  static_cast<ST*>(t.m[e]) + begin,
                  static_cast<ST*>(t.v[e]) + begin, __ldg(t.lr[e]),
                  __ldg(t.bc1), __ldg(t.bc2), len, a, t.vec[e] != 0,
                  threadIdx.x, blockDim.x);
}

int max_resident_blocks() {
  // enough 256-thread blocks to fill every SM (2048 threads each); the
  // grid-stride loop covers the rest. Cached per device: a ResNet-50
  // step launches 161 updates.
  static int cached[64] = {0};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = (sms > 0 ? sms : 132) * 8;
  }
  return cached[dev];
}

unsigned grid_for(long long n, bool vec) {
  const long long work = vec ? n / V + n % V : n;
  long long blocks = (work + 255) / 256;
  const long long cap = max_resident_blocks();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// -- dtype dispatch: 0 = f32, 1 = bf16, 2 = f16 --------------------------

template <class P, class S>
struct Launch {
  static int sgd(void* p, const void* g, void* m, const float* lr,
                 long long n, SgdArgs a, cudaStream_t st) {
    using PT = typename P::T;
    using ST = typename S::T;
    const bool vec = aligned((PT*)p) && aligned((const PT*)g) &&
                     aligned((ST*)m);
    sgd_kernel<P, S><<<grid_for(n, vec), 256, 0, st>>>(
        (PT*)p, (const PT*)g, (ST*)m, lr, n, a, vec);
    return (int)cudaGetLastError();
  }
  static int adam(void* p, const void* g, void* m, void* v, const float* lr,
                  const float* bc1, const float* bc2, long long n,
                  AdamArgs a, cudaStream_t st) {
    using PT = typename P::T;
    using ST = typename S::T;
    const bool vec = aligned((PT*)p) && aligned((const PT*)g) &&
                     aligned((ST*)m) && aligned((ST*)v);
    adam_kernel<P, S><<<grid_for(n, vec), 256, 0, st>>>(
        (PT*)p, (const PT*)g, (ST*)m, (ST*)v, lr, bc1, bc2, n, a, vec);
    return (int)cudaGetLastError();
  }
  template <bool ADAGRAD>
  static int scaled(void* p, const void* g, void* r, const float* lr,
                    long long n, RmsArgs a, cudaStream_t st) {
    using PT = typename P::T;
    using ST = typename S::T;
    const bool vec = aligned((PT*)p) && aligned((const PT*)g) &&
                     aligned((ST*)r);
    scaled_kernel<P, S, ADAGRAD><<<grid_for(n, vec), 256, 0, st>>>(
        (PT*)p, (const PT*)g, (ST*)r, lr, n, a, vec);
    return (int)cudaGetLastError();
  }
  // the entries of a one-state table; the grid's block count, or -1 for
  // a count or an entry the kernels do not take
  static long long fill(OneStateTable& t, const SingaSgdEntry* es,
                        int count) {
    using PT = typename P::T;
    using ST = typename S::T;
    if (count < 1 || count > SGD_MULTI_MAX) return -1;
    long long blocks = 0;
    for (int i = 0; i < count; ++i) {
      const SingaSgdEntry& e = es[i];
      if (e.n <= 0) return -1;
      t.p[i] = e.p;
      t.g[i] = e.g;
      t.m[i] = e.m;
      t.lr[i] = static_cast<const float*>(e.lr);
      t.n[i] = e.n;
      t.weight_decay[i] = e.weight_decay;
      t.vec[i] = aligned((PT*)e.p) && aligned((const PT*)e.g) &&
                 aligned((ST*)e.m);
      blocks += (e.n + TILE - 1) / TILE;
      if (blocks > INT_MAX) return -1;
      t.block_end[i] = (int)blocks;
    }
    t.count = count;
    return blocks;
  }
  // one launch over `count` entries (1..SGD_MULTI_MAX)
  static int sgd_multi(const SingaSgdEntry* es, int count, SgdShared a,
                       const float* ok, cudaStream_t st) {
    OneStateTable t{};
    const long long blocks = fill(t, es, count);
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    t.shared.sgd = a;
    t.ok = ok;
    sgd_multi_kernel<P, S><<<(unsigned)blocks, 256, 0, st>>>(t);
    return (int)cudaGetLastError();
  }
  template <bool ADAGRAD>
  static int scaled_multi(const SingaSgdEntry* es, int count,
                          ScaledShared a, const float* ok, cudaStream_t st) {
    OneStateTable t{};
    const long long blocks = fill(t, es, count);
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    t.shared.scaled = a;
    t.ok = ok;
    scaled_multi_kernel<P, S, ADAGRAD><<<(unsigned)blocks, 256, 0, st>>>(t);
    return (int)cudaGetLastError();
  }
  // one launch over `count` entries (1..ADAM_MULTI_MAX)
  static int adam_multi(const SingaAdamEntry* es, int count,
                        const float* bc1, const float* bc2, AdamArgs a,
                        const float* ok, cudaStream_t st) {
    using PT = typename P::T;
    using ST = typename S::T;
    if (count < 1 || count > ADAM_MULTI_MAX)
      return (int)cudaErrorInvalidValue;
    AdamTable t{};
    long long blocks = 0;
    for (int i = 0; i < count; ++i) {
      const SingaAdamEntry& e = es[i];
      if (e.n <= 0) return (int)cudaErrorInvalidValue;
      t.p[i] = e.p;
      t.g[i] = e.g;
      t.m[i] = e.m;
      t.v[i] = e.v;
      t.lr[i] = static_cast<const float*>(e.lr);
      t.n[i] = e.n;
      t.weight_decay[i] = e.weight_decay;
      t.vec[i] = aligned((PT*)e.p) && aligned((const PT*)e.g) &&
                 aligned((ST*)e.m) && aligned((ST*)e.v);
      blocks += (e.n + TILE - 1) / TILE;
      if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
      t.block_end[i] = (int)blocks;
    }
    t.count = count;
    t.bc1 = bc1;
    t.bc2 = bc2;
    t.ok = ok;
    t.beta1 = a.beta1;
    t.one_minus_beta1 = a.one_minus_beta1;
    t.beta2 = a.beta2;
    t.one_minus_beta2 = a.one_minus_beta2;
    t.eps = a.eps;
    adam_multi_kernel<P, S><<<(unsigned)blocks, 256, 0, st>>>(t);
    return (int)cudaGetLastError();
  }
};

// Calls f(Launch<P, S>()) for the runtime dtypes, or returns
// cudaErrorInvalidValue for a dtype code the kernels do not take.
template <class F, class P>
int with_state(int s_dtype, F f) {
  switch (s_dtype) {
    case 0: return f(Launch<P, F32>());
    case 1: return f(Launch<P, BF16>());
    case 2: return f(Launch<P, F16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int with_types(int p_dtype, int s_dtype, F f) {
  switch (p_dtype) {
    case 0: return with_state<F, F32>(s_dtype, f);
    case 1: return with_state<F, BF16>(s_dtype, f);
    case 2: return with_state<F, F16>(s_dtype, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// p_dtype, s_dtype: 0 = f32, 1 = bf16, 2 = f16 (g has p's type). lr, bc1
// and bc2 point to one f32 each on the device. n > 0. Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// argument the kernels do not take.

extern "C" int singa_sgd_update(int p_dtype, int s_dtype, void* p,
                                const void* g, void* m, const void* lr,
                                long long n, float momentum,
                                float one_minus_dampening,
                                float weight_decay, int nesterov,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const SgdArgs a{momentum, one_minus_dampening, weight_decay, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lrf = static_cast<const float*>(lr);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.sgd(p, g, m, lrf, n, a, st);
  });
}

extern "C" int singa_adam_update(int p_dtype, int s_dtype, void* p,
                                 const void* g, void* m, void* v,
                                 const void* lr, const void* bc1,
                                 const void* bc2, long long n, float beta1,
                                 float one_minus_beta1, float beta2,
                                 float one_minus_beta2, float eps,
                                 float weight_decay, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const AdamArgs a{beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                   weight_decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.adam(p, g, m, v, static_cast<const float*>(lr),
                  static_cast<const float*>(bc1),
                  static_cast<const float*>(bc2), n, a, st);
  });
}

extern "C" int singa_rmsprop_update(int p_dtype, int s_dtype, void* p,
                                    const void* g, void* r, const void* lr,
                                    long long n, float rho,
                                    float one_minus_rho, float eps,
                                    float weight_decay, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const RmsArgs a{rho, one_minus_rho, eps, weight_decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.template scaled<false>(p, g, r, static_cast<const float*>(lr),
                                    n, a, st);
  });
}

extern "C" int singa_adagrad_update(int p_dtype, int s_dtype, void* p,
                                    const void* g, void* h, const void* lr,
                                    long long n, float eps,
                                    float weight_decay, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const RmsArgs a{0.f, 0.f, eps, weight_decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.template scaled<true>(p, g, h, static_cast<const float*>(lr),
                                   n, a, st);
  });
}

// entries: a host array of `count` entries of one (p, state) dtype pair;
// any count > 0, at most SGD_MULTI_MAX (K1, K6, K7) / ADAM_MULTI_MAX (K5),
// each with n > 0.
// One launch each; the hyperparameters shared by the entries are
// arguments, as for the per-tensor functions. ok: null, or a device
// pointer to one f32, a guarded step's verdict: where it holds 0 the
// launch writes nothing.

extern "C" int singa_sgd_update_multi(int p_dtype, int s_dtype,
                                      const SingaSgdEntry* entries,
                                      int count, float momentum,
                                      float one_minus_dampening,
                                      int nesterov, const void* ok,
                                      void* stream) {
  const SgdShared a{momentum, one_minus_dampening, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* okf = static_cast<const float*>(ok);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.sgd_multi(entries, count, a, okf, st);
  });
}

extern "C" int singa_adam_update_multi(int p_dtype, int s_dtype,
                                       const SingaAdamEntry* entries,
                                       int count, const void* bc1,
                                       const void* bc2, float beta1,
                                       float one_minus_beta1, float beta2,
                                       float one_minus_beta2, float eps,
                                       const void* ok, void* stream) {
  const AdamArgs a{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* okf = static_cast<const float*>(ok);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.adam_multi(entries, count, static_cast<const float*>(bc1),
                        static_cast<const float*>(bc2), a, okf, st);
  });
}

// entries: SingaSgdEntry, m the mean square (K6) or the history (K7)
extern "C" int singa_rmsprop_update_multi(int p_dtype, int s_dtype,
                                          const SingaSgdEntry* entries,
                                          int count, float rho,
                                          float one_minus_rho, float eps,
                                          const void* ok, void* stream) {
  const ScaledShared a{rho, one_minus_rho, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* okf = static_cast<const float*>(ok);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.template scaled_multi<false>(entries, count, a, okf, st);
  });
}

extern "C" int singa_adagrad_update_multi(int p_dtype, int s_dtype,
                                          const SingaSgdEntry* entries,
                                          int count, float eps,
                                          const void* ok, void* stream) {
  const ScaledShared a{0.f, 0.f, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* okf = static_cast<const float*>(ok);
  return with_types(p_dtype, s_dtype, [&](auto l) {
    return l.template scaled_multi<true>(entries, count, a, okf, st);
  });
}

// the most entries one multi-tensor launch takes, by kind: 0 = SGD (K1),
// 1 = Adam (K5), 2 = RMSProp (K6), 3 = AdaGrad (K7); 0 for another code
extern "C" int singa_optim_multi_capacity(int kind) {
  switch (kind) {
    case 0: return SGD_MULTI_MAX;
    case 1: return ADAM_MULTI_MAX;
    case 2: return SGD_MULTI_MAX;
    case 3: return SGD_MULTI_MAX;
    default: return 0;
  }
}
