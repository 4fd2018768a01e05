// E1, the CRN's post-convolution chain for Hopper (sm_90a), NHWC:
//
//   out[u, c] = store(leaky(bn(s[u, c]))),   s = bf16(bf16(a0 + a1) + a2)
//
// over a tensor of C channels (a channels_last NCHW tensor on the PyTorch
// side): the sum of 1 to 3 bf16 addends (the convolutions that one CRN
// conv0 adds), rounded to bf16 after each add as the eager chain rounds
// it; eval BatchNorm in float32 from the raw running mean and variance,
// weight and bias (eps given), or no norm; LeakyReLU in float32 with the
// slope given; a bf16 or float32 store.  The eager chain it replaces,
// add -> float() -> batch_norm -> leaky_relu -> to(bf16), is five passes
// over the activations (ops/crn_epilogue.py).
//
// It replaces no TPU kernel: on the TPU, XLA fused this chain into the
// consumers of the convolutions; the port's eager PyTorch ran it op by op
// and moved about five times the bytes.
//
// What bounds it on the card: bytes.  It does a few float operations an
// element (about half an operation a byte), far under the ~20 a byte at
// which an H100's float32 units would be the limit.  The least it moves
// is each addend read once in bf16 and the output written once, 4 to 8
// bytes an element (utils/roofline.py's crn_epilogue_bytes).  The design:
//   * 16-byte loads and stores: a unit is 8 channels (bf16 in; bf16 out, or
//     two 16-byte float32 stores), where C is a multiple of 8 and every
//     pointer 16-byte aligned; else units of one channel;
//   * a block's threads are a multiple of the C / unit channel groups, and
//     so is the grid's stride: a thread keeps one group for its walk, and
//     its BatchNorm scale and shift stay in registers, formed once from
//     the four raw vectors (no launch on the host for them);
//   * each thread issues the loads of all its kUnroll units (4 with a bf16
//     output, 1 with the head's float32 one) before it computes, and the
//     grid covers the tensor in one trip of the threads.
// Measured on the H100 at vg128's eleven b128 chains (PERF.md, E1):
// with 2, 4 or 8 units a thread, persistent blocks walking grid-stride (as
// many as the card holds, or twice that) ran 1-7% slower than one trip of
// a full grid; in one trip, 1, 2 and 8 units a thread ran slower than 4
// with a bf16 output, 2 and 4 slower than 1 with the head's float32 one;
// streaming cache hints changed nothing beyond the runs' spread.  The
// BatchNorm's terms are formed as near as its outputs show to how cuDNN's
// inference kernel forms them (scale = weight x rsqrt(var + eps), shift =
// bias - mean x scale fused, y = x scale + shift fused): of the five forms
// tried, this one's float32 outputs agree with the eager chain's bit for
// bit at the most elements (96%, the rest by float32 roundings), and after
// the bf16 store at all but 2.4 in a million, each one bf16 step off.
//
// Plain C interface (loaded with ctypes): sg2im_crn_epilogue takes the
// pointers and the plan of ops/crn_epilogue.py (struct Plan) and returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

// The launch: ops/crn_epilogue.py's EpiloguePlan, field for field.
struct Plan {
  int64_t units;     // elements / vec
  int32_t addends;   // 1 to 3 bf16 inputs
  int32_t vec;       // channels a unit: 8 or 1
  int32_t out_f32;   // 1: float32 output, 0: bf16
  int32_t bn;        // 1: eval BatchNorm, 0: no norm
  int32_t channels;  // C
  int32_t threads;   // a block: a multiple of C / vec
  int32_t grid;
  float slope;
  float eps;
};

struct Args {
  const void* in[3];
  void* out;
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  int64_t units;
  int groups;  // C / vec
  float slope;
  float eps;
};

template <int kVec>
struct Unit;

template <>
struct Unit<8> {
  using T = uint4;
  static __device__ __forceinline__ void to_float(const T& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store_bf16(void* out, int64_t u,
                                                    const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    reinterpret_cast<uint4*>(out)[u] = v;
  }
  static __device__ __forceinline__ void store_f32(void* out, int64_t u,
                                                   const float* f) {
    float4* o = reinterpret_cast<float4*>(out) + 2 * u;
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <>
struct Unit<1> {
  using T = unsigned short;
  static __device__ __forceinline__ void to_float(const T& v, float* f) {
    f[0] = __uint_as_float((unsigned)v << 16);
  }
  static __device__ __forceinline__ void store_bf16(void* out, int64_t u,
                                                    const float* f) {
    reinterpret_cast<__nv_bfloat16*>(out)[u] = __float2bfloat16_rn(f[0]);
  }
  static __device__ __forceinline__ void store_f32(void* out, int64_t u,
                                                   const float* f) {
    reinterpret_cast<float*>(out)[u] = f[0];
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int kAddends, int kVec, bool kOutF32, bool kBn>
__global__ void __launch_bounds__(kMaxThreads)
    crn_epilogue_kernel(const Args a) {
  constexpr int kUnroll = kOutF32 ? 1 : 4;
  using U = Unit<kVec>;
  using T = typename U::T;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // blockDim.x and the stride are multiples of the groups: every unit this
  // thread visits holds channels c0 .. c0 + kVec - 1.
  const int c0 = (int)(threadIdx.x % a.groups) * kVec;
  float scale[kVec], shift[kVec];
  if (kBn) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      scale[j] = __fmul_rn(a.weight[c0 + j],
                           rsqrtf(__fadd_rn(a.var[c0 + j], a.eps)));
      shift[j] = __fmaf_rn(-a.mean[c0 + j], scale[j], a.bias[c0 + j]);
    }
  }
  const T* in[kAddends];
#pragma unroll
  for (int i = 0; i < kAddends; ++i)
    in[i] = reinterpret_cast<const T*>(a.in[i]);
  for (int64_t u0 = first; u0 < a.units; u0 += stride * kUnroll) {
    T v[kUnroll][kAddends];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = u0 + k * stride;
      if (u < a.units) {
#pragma unroll
        for (int i = 0; i < kAddends; ++i) v[k][i] = __ldg(in[i] + u);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = u0 + k * stride;
      if (u >= a.units) break;
      float x[kVec];
      U::to_float(v[k][0], x);
#pragma unroll
      for (int i = 1; i < kAddends; ++i) {
        float y[kVec];
        U::to_float(v[k][i], y);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          x[j] = round_bf16(__fadd_rn(x[j], y[j]));
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float t = x[j];
        if (kBn) t = __fmaf_rn(t, scale[j], shift[j]);
        x[j] = t > 0.f ? t : __fmul_rn(t, a.slope);
      }
      if (kOutF32)
        U::store_f32(a.out, u, x);
      else
        U::store_bf16(a.out, u, x);
    }
  }
}

// The kernel instance of a plan: by template, field by field.
template <int kAddends, int kVec, bool kOutF32>
const void* pick_bn(const Plan* p) {
  return p->bn ? (const void*)crn_epilogue_kernel<kAddends, kVec, kOutF32,
                                                  true>
               : (const void*)crn_epilogue_kernel<kAddends, kVec, kOutF32,
                                                  false>;
}

template <int kAddends, int kVec>
const void* pick_out(const Plan* p) {
  return p->out_f32 ? pick_bn<kAddends, kVec, true>(p)
                    : pick_bn<kAddends, kVec, false>(p);
}

template <int kAddends>
const void* pick_vec(const Plan* p) {
  return p->vec == 8 ? pick_out<kAddends, 8>(p) : pick_out<kAddends, 1>(p);
}

// The plan's kernel, or null for a plan out of its bounds.
const void* kernel_of(const Plan* p) {
  if (!p || (p->vec != 8 && p->vec != 1) || p->channels < 1 ||
      p->channels % p->vec || p->threads < 1 || p->threads > kMaxThreads ||
      p->threads % (p->channels / p->vec) || p->units < 1 || p->grid < 1 ||
      (p->out_f32 != 0 && p->out_f32 != 1) || (p->bn != 0 && p->bn != 1))
    return nullptr;
  switch (p->addends) {
    case 1:
      return pick_vec<1>(p);
    case 2:
      return pick_vec<2>(p);
    case 3:
      return pick_vec<3>(p);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// out = store(leaky(bn(sum of the addends))) by the plan (a struct Plan);
// a1 and a2 are read only where the plan has that many addends, and the
// four BatchNorm vectors (float32, C each) only with bn.
int sg2im_crn_epilogue(const void* a0, const void* a1, const void* a2,
                       const void* mean, const void* var, const void* weight,
                       const void* bias, void* out, const void* plan,
                       void* stream) {
  const Plan* p = (const Plan*)plan;
  const void* kernel = kernel_of(p);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const void* ins[3] = {a0, a1, a2};
  const uintptr_t align = p->vec == 8 ? 16 : 2;
  if ((uintptr_t)out % (p->vec == 8 ? 16 : p->out_f32 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p->addends; ++i)
    if (!ins[i] || (uintptr_t)ins[i] % align)
      return (int)cudaErrorInvalidValue;
  if (p->bn && !(mean && var && weight && bias))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < 3; ++i) a.in[i] = i < p->addends ? ins[i] : a0;
  a.out = out;
  a.mean = (const float*)mean;
  a.var = (const float*)var;
  a.weight = (const float*)weight;
  a.bias = (const float*)bias;
  a.units = p->units;
  a.groups = p->channels / p->vec;
  a.slope = p->slope;
  a.eps = p->eps;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3(p->grid), dim3(p->threads), params, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
