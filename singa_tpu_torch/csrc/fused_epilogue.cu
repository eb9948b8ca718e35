// Fused inference-BN epilogue for Hopper (sm_90a):
//
//     out[i] = max(x[i] * s[c] + b[c] (+ r[i]), 0)
//
// with c = (i / HW) % C for NCHW and c = i % C for NHWC, all arithmetic in
// f32, x and r in f32, bf16 or f16, and the output in x's dtype. s and b
// are the per-channel f32 scale and shift of the folded frozen BN
// (ops/fused_epilogue.py fold_bn).
//
// Replaces singa_tpu/ops/fused_epilogue.py::_affine_relu_rows_kernel,
// _affine_relu_cols_kernel, _affine_add_relu_rows_kernel and
// _affine_add_relu_cols_kernel (the pallas_call sites of
// _scale_shift_relu_impl): the plain (conv -> BN -> ReLU) and residual
// (conv -> BN -> add -> ReLU) tails of every ResNet block, in both layouts.
//
// Bound: HBM bytes. The kernel does 2-3 flops per element and moves 8 B
// (plain) or 12 B (residual) per f32 element, far below the card's
// operations-per-byte balance. One ResNet-50 forward runs 49 tails
// (33 plain, 16 residual); per image they move 4,089,344 elements through
// the plain tails and 5,519,360 through the residual ones: about 98.9 MB
// per image in f32, 3.17 GB per batch-32 forward, which at the H100 SXM
// data-sheet 3.35 TB/s is about 0.95 ms (half that in bf16).
//
// Design: a single pass. Each element is read once and written once, so
// the BN output and the residual sum never exist in device memory. A
// grid-stride loop over 16-byte vectors (4 f32 or 8 bf16/f16 elements)
// when every pointer is 16-byte aligned, then a masked scalar tail (the
// whole range when a pointer is not aligned). The channel index is
// computed once per vector and walked forward element by element, so a
// vector may straddle a channel boundary (HW = 49 in ResNet-50's last
// stage). The TPU kernel's VMEM row-block budget has no counterpart here.
//
// Numerics: x * s + b is computed with __fmul_rn / __fadd_rn so the
// compiler cannot contract it into an FMA. The f32 result is then
// bitwise-equal to the plain PyTorch version, which multiplies, rounds,
// and adds. NaN propagates through the ReLU as it does in torch.relu.
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct F32 {
  using Bits = unsigned int;
  static __device__ __forceinline__ float to_f(Bits v) {
    return __uint_as_float(v);
  }
  static __device__ __forceinline__ Bits from_f(float f) {
    return __float_as_uint(f);
  }
};

struct BF16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float to_f(Bits v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ Bits from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float to_f(Bits v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ Bits from_f(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

// Channel of flat element i, walked forward one element at a time.
template <bool NHWC>
struct Channel {
  int c;
  long long p;  // position inside the (H, W) plane; NCHW only

  __device__ __forceinline__ Channel(long long i, int C, long long HW) {
    if (NHWC) {
      c = (int)(i % C);
      p = 0;
    } else {
      long long q = i / HW;
      c = (int)(q % C);
      p = i - q * HW;
    }
  }

  __device__ __forceinline__ void next(int C, long long HW) {
    if (NHWC) {
      if (++c == C) c = 0;
    } else if (++p == HW) {
      p = 0;
      if (++c == C) c = 0;
    }
  }
};

__device__ __forceinline__ float relu(float y) {
  return (y > 0.f || y != y) ? y : 0.f;
}

template <class Tr, bool NHWC, bool RES>
__global__ void __launch_bounds__(256) affine_relu_kernel(
    const typename Tr::Bits* __restrict__ x,
    const typename Tr::Bits* __restrict__ r,
    const float* __restrict__ s, const float* __restrict__ b,
    typename Tr::Bits* __restrict__ out, long long n, int C, long long HW,
    bool vectorised) {
  using Bits = typename Tr::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack {
    uint4 u;
    Bits e[V];
  };

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vectorised ? n / V : 0;

  for (long long v = tid; v < nvec; v += stride) {
    Pack xv, rv, ov;
    xv.u = reinterpret_cast<const uint4*>(x)[v];
    if (RES) rv.u = reinterpret_cast<const uint4*>(r)[v];
    Channel<NHWC> ch(v * V, C, HW);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = __fadd_rn(__fmul_rn(Tr::to_f(xv.e[k]), __ldg(s + ch.c)),
                          __ldg(b + ch.c));
      if (RES) y = __fadd_rn(y, Tr::to_f(rv.e[k]));
      ov.e[k] = Tr::from_f(relu(y));
      ch.next(C, HW);
    }
    reinterpret_cast<uint4*>(out)[v] = ov.u;
  }

  // masked tail: what the vectors did not cover (all of it when a
  // pointer is not 16-byte aligned)
  for (long long i = nvec * V + tid; i < n; i += stride) {
    Channel<NHWC> ch(i, C, HW);
    float y = __fadd_rn(__fmul_rn(Tr::to_f(x[i]), __ldg(s + ch.c)),
                        __ldg(b + ch.c));
    if (RES) y = __fadd_rn(y, Tr::to_f(r[i]));
    out[i] = Tr::from_f(relu(y));
  }
}

int max_resident_blocks() {
  // enough 256-thread blocks to fill every SM (2048 threads each); the
  // grid-stride loop covers the rest. Cached per device: the attribute
  // query is not free, and the epilogue launches 49 times per forward.
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

template <class Tr, bool NHWC, bool RES>
int launch(const void* x, const void* r, const float* s, const float* b,
           void* out, long long n, int C, long long HW,
           cudaStream_t stream) {
  using Bits = typename Tr::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const bool vectorised =
      (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
      (!RES || (uintptr_t)r % 16 == 0);
  const long long work = vectorised ? n / V + n % V : n;
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  const long long cap = max_resident_blocks();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  affine_relu_kernel<Tr, NHWC, RES><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const Bits*>(x), static_cast<const Bits*>(r), s, b,
      static_cast<Bits*>(out), n, C, HW, vectorised);
  return (int)cudaGetLastError();
}

template <class Tr>
int dispatch_layout(int nhwc, const void* x, const void* r, const float* s,
                    const float* b, void* out, long long n, int C,
                    long long HW, cudaStream_t stream) {
  if (nhwc) {
    return r ? launch<Tr, true, true>(x, r, s, b, out, n, C, HW, stream)
             : launch<Tr, true, false>(x, r, s, b, out, n, C, HW, stream);
  }
  return r ? launch<Tr, false, true>(x, r, s, b, out, n, C, HW, stream)
           : launch<Tr, false, false>(x, r, s, b, out, n, C, HW, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. nhwc: 0 = NCHW, 1 = NHWC.
// r == NULL selects the plain tail, otherwise the residual tail.
// HW = H * W (read only for NCHW). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int singa_affine_relu(int dtype, int nhwc, const void* x,
                                 const void* r, const void* s, const void* b,
                                 void* out, long long n, int C, long long HW,
                                 void* stream) {
  if (n <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(s);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_layout<F32>(nhwc, x, r, sf, bf, out, n, C, HW, st);
    case 1:
      return dispatch_layout<BF16>(nhwc, x, r, sf, bf, out, n, C, HW, st);
    case 2:
      return dispatch_layout<F16>(nhwc, x, r, sf, bf, out, n, C, HW, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
