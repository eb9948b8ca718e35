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
// elements, so a step's update time is set by the launches, not the bytes.
//
// Design: one flat grid-stride loop over n elements. When every pointer
// is aligned to a 4-element vector, each thread moves 4 elements per
// access (16 B per f32 array), then a scalar loop covers the rest (all of
// it when a pointer is not aligned). The TPU kernel's (rows, 128) tiles
// and zero padding are Mosaic details with no counterpart here.
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
#include <stdint.h>

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

// K6 and K7 share the tail p - lr*g / sqrt(stored + eps); the state is
// rounded to its own type before it is read back
template <class S>
__device__ __forceinline__ float scaled_step(float p, float g, float lr,
                                             typename S::T stored,
                                             float eps) {
  return __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                                __fsqrt_rn(__fadd_rn(S::to_f(stored), eps))));
}

// -- the kernels --------------------------------------------------------
// Each thread takes whole vectors (when `vec`), then single elements from
// `nvec * V` on.

template <class P, class S>
__global__ void __launch_bounds__(256) sgd_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, const float* __restrict__ lr_ptr,
    long long n, SgdArgs a, bool vec) {
  const float lr = __ldg(lr_ptr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
__global__ void __launch_bounds__(256) adam_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ m, typename S::T* __restrict__ v,
    const float* __restrict__ lr_ptr, const float* __restrict__ bc1_ptr,
    const float* __restrict__ bc2_ptr, long long n, AdamArgs a, bool vec) {
  const float lr = __ldg(lr_ptr), bc1 = __ldg(bc1_ptr), bc2 = __ldg(bc2_ptr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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

// RMSProp (ADAGRAD = false) and AdaGrad (ADAGRAD = true): one state r
template <class P, class S, bool ADAGRAD>
__global__ void __launch_bounds__(256) scaled_kernel(
    typename P::T* __restrict__ p, const typename P::T* __restrict__ g,
    typename S::T* __restrict__ r, const float* __restrict__ lr_ptr,
    long long n, RmsArgs a, bool vec) {
  const float lr = __ldg(lr_ptr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? n / V : 0;
  auto state = [&](float rf, float gf) {
    return ADAGRAD ? __fadd_rn(rf, __fmul_rn(gf, gf))
                   : __fadd_rn(__fmul_rn(a.rho, rf),
                               __fmul_rn(__fmul_rn(a.one_minus_rho, gf), gf));
  };
  for (long long i = tid; i < nvec; i += stride) {
    Vec<typename P::T> pv = reinterpret_cast<Vec<typename P::T>*>(p)[i];
    const Vec<typename P::T> gv =
        reinterpret_cast<const Vec<typename P::T>*>(g)[i];
    Vec<typename S::T> rv = reinterpret_cast<Vec<typename S::T>*>(r)[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float pf = P::to_f(pv.e[k]);
      float gf = P::to_f(gv.e[k]);
      if (a.weight_decay != 0.f)
        gf = __fadd_rn(gf, __fmul_rn(a.weight_decay, pf));
      rv.e[k] = S::from_f(state(S::to_f(rv.e[k]), gf));
      pv.e[k] = P::from_f(scaled_step<S>(pf, gf, lr, rv.e[k], a.eps));
    }
    reinterpret_cast<Vec<typename P::T>*>(p)[i] = pv;
    reinterpret_cast<Vec<typename S::T>*>(r)[i] = rv;
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    const float pf = P::to_f(p[i]);
    float gf = P::to_f(g[i]);
    if (a.weight_decay != 0.f)
      gf = __fadd_rn(gf, __fmul_rn(a.weight_decay, pf));
    const typename S::T rs = S::from_f(state(S::to_f(r[i]), gf));
    r[i] = rs;
    p[i] = P::from_f(scaled_step<S>(pf, gf, lr, rs, a.eps));
  }
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
