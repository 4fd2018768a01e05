// Threefry-2x32 normals for Hopper (sm_90a): the JAX package's layout noise,
// jax.random.normal(key, (N, H / f, W / f, C)) with partitionable threefry,
// drawn on the card and nearest-upsampled by f into the (N, C, H, W) noise
// the generator takes.
//
// Element (n, c, y, x) of the output is the JAX draw's NHWC element
// (n, y / f, x / f, c), whose counter is its flat index in the (N, H / f,
// W / f, C) draw plus `offset`, a 64-bit number split into the (hi, lo)
// words that threefry2x32(key, hi, lo) hashes; the two output words XORed
// are the element's 32 random bits (jax._src.prng.
// _threefry_random_bits_partitionable).  Then, as jax.random._normal_real:
//   float32:  u = ((bits >> 9) | 0x3F800000) as float - 1, times 2, plus
//             nextafter(-1, 0); normal = sqrt(2) * erf_inv(u);
//   bfloat16: 8 bits, ((bits & 0xFF) >> 1) | 0x3F80 as bfloat16, the same
//             steps rounded to bfloat16 where JAX's bfloat16 arithmetic
//             rounds; erf_inv runs in float32 and is rounded;
//   bits:     the 32 bits themselves (int32), for checking the hash.
// erf_inv is XLA's float32 polynomial (Giles), with its Horner steps as
// fused multiply-adds, as XLA emits them; every other float operation is
// an explicit IEEE intrinsic, so that nvcc contracts nothing the plain
// version (ops/prng.py) does not.
//
// It replaces no TPU kernel: on the TPU, XLA expands jax.random.normal into
// its own fused loop.  It was added because the port draws the JAX
// package's noise (sg2im_tpu/inference.py: same graph + seed -> same image,
// on any device) and no PyTorch call computes threefry; the plain version in
// tensor ops takes about 170 elementwise passes over int64 tensors.
//
// What bounds it on the card: integer issue.  Each drawn value costs one
// threefry2x32 call, 20 rounds of add / rotate / xor plus 5 key
// injections, about 80 32-bit integer instructions (rotations are one
// funnel shift, SHF), against 4 bytes (bf16: 2) written f * f times.  At
// the 67.1 M values of a vg128 batch of 128 that is about 0.3 ms of
// integer issue against 0.08 ms of stores.  The design: one thread per
// drawn value, no shared memory, the key and offset passed by value (or the
// key read from device memory, for a key split on the card, so that no
// launch waits for the host), stores coalesced along the output's innermost
// dimension (C for a channels_last output, W for NCHW).  This is the simple
// version: no values per thread beyond one, no vector stores.
//
// A second entry, sg2im_threefry_split, is jax.random.split on the card:
// one thread a key, so that the train step splits its key on the card in
// one launch (in tensor ops the hash is about 180 launches of two
// elements, issue time a host-bound step pays).
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // threads along the output's innermost dim
constexpr int kBlockY = 8;
constexpr unsigned kMaxGridZ = 65535;

enum Mode { kBits = 0, kNormalF32 = 1, kNormalBF16 = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32-20 of the counter (hi, lo) under key (k0, k1): the two
// output words in y0, y1.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t hi, uint32_t lo,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define SG2IM_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r) ^ x0;
#define SG2IM_ROUNDS_A \
  SG2IM_ROUND(13) SG2IM_ROUND(15) SG2IM_ROUND(26) SG2IM_ROUND(6)
#define SG2IM_ROUNDS_B \
  SG2IM_ROUND(17) SG2IM_ROUND(29) SG2IM_ROUND(16) SG2IM_ROUND(24)
  SG2IM_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  SG2IM_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  SG2IM_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  SG2IM_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  SG2IM_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef SG2IM_ROUNDS_B
#undef SG2IM_ROUNDS_A
#undef SG2IM_ROUND
  y0 = x0;
  y1 = x1;
}

// The element's 32 random bits: the two output words XORed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, hi, lo, y0, y1);
  return y0 ^ y1;
}

// XLA's float32 erf_inv: +-inf at |x| = 1.
__device__ __forceinline__ float erf_inv_f32(float x) {
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool small = w < 5.0f;
  const float t = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = small ? 2.81022636e-08f : -0.000200214257f;
  p = __fmaf_rn(p, t, small ? 3.43273939e-07f : 0.000100950558f);
  p = __fmaf_rn(p, t, small ? -3.5233877e-06f : 0.00134934322f);
  p = __fmaf_rn(p, t, small ? -4.39150654e-06f : -0.00367342844f);
  p = __fmaf_rn(p, t, small ? 0.00021858087f : 0.00573950773f);
  p = __fmaf_rn(p, t, small ? -0.00125372503f : -0.0076224613f);
  p = __fmaf_rn(p, t, small ? -0.00417768164f : 0.00943887047f);
  p = __fmaf_rn(p, t, small ? 0.246640727f : 1.00167406f);
  p = __fmaf_rn(p, t, small ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000))
                          : __fmul_rn(p, x);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kMode>
struct Out;
template <>
struct Out<kBits> {
  using T = int32_t;
  static __device__ __forceinline__ T value(uint32_t bits) {
    return (int32_t)bits;
  }
};
template <>
struct Out<kNormalF32> {
  using T = float;
  static __device__ __forceinline__ T value(uint32_t bits) {
    const float lo = -0.99999994f;  // nextafter(-1, 0) in float32
    const float unit = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                                 1.0f);
    const float u = fmaxf(lo, __fadd_rn(__fmul_rn(unit, 2.0f), lo));
    return __fmul_rn(1.41421356f, erf_inv_f32(u));
  }
};
template <>
struct Out<kNormalBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T value(uint32_t bits) {
    const float lo = -0.99609375f;  // nextafter(-1, 0) in bfloat16
    const float unit = __fsub_rn(
        __uint_as_float((((bits & 0xFFu) >> 1) | 0x3F80u) << 16), 1.0f);
    // unit * 2 + lo is exact in float32: one rounding, as bfloat16's.
    const float u =
        fmaxf(lo, round_bf16(__fadd_rn(__fmul_rn(unit, 2.0f), lo)));
    return __float2bfloat16_rn(__fmul_rn(1.4140625f,
                                         round_bf16(erf_inv_f32(u))));
  }
};

struct Params {
  const uint32_t* key;  // device words, or null: k0, k1 below
  uint32_t k0, k1;
  uint64_t offset;
  int N, C, Hd, Wd;
  int64_t sn, sc, sy, sx;  // output strides (elements) of (N, C, H, W)
  int c_inner;             // 1: threads run along C (channels_last)
};

// Block (kBlockX, kBlockY), grid (inner tiles, middle tiles, outer):
//   c_inner: inner = c, middle = x / f, outer = n * Hd + y / f;
//   else:    inner = x / f, middle = y / f, outer = n * C + c.
template <int kMode, int kF>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    threefry_normal_kernel(typename Out<kMode>::T* __restrict__ out,
                           Params p) {
  uint32_t k0 = p.k0, k1 = p.k1;
  if (p.key != nullptr) {
    k0 = __ldg(p.key);
    k1 = __ldg(p.key + 1);
  }
  const int a = blockIdx.x * kBlockX + threadIdx.x;
  const int b = blockIdx.y * kBlockY + threadIdx.y;
  const int inner = p.c_inner ? p.C : p.Wd;
  const int middle = p.c_inner ? p.Wd : p.Hd;
  const int outer_div = p.c_inner ? p.Hd : p.C;
  const int outers = p.N * outer_div;  // the wrapper checks < 2^31
  if (a >= inner || b >= middle) return;
  for (int z = blockIdx.z; z < outers; z += gridDim.z) {
    const int n = z / outer_div;
    const int r = z - n * outer_div;
    int c, yd, xd;
    if (p.c_inner) {
      c = a, xd = b, yd = r;
    } else {
      xd = a, yd = b, c = r;
    }
    const uint64_t flat =
        (((uint64_t)n * p.Hd + yd) * p.Wd + xd) * p.C + c + p.offset;
    const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(flat >> 32),
                                        (uint32_t)flat);
    const typename Out<kMode>::T v = Out<kMode>::value(bits);
    typename Out<kMode>::T* dst = out + n * p.sn + c * p.sc +
                                  (int64_t)yd * kF * p.sy +
                                  (int64_t)xd * kF * p.sx;
#pragma unroll
    for (int dy = 0; dy < kF; ++dy)
#pragma unroll
      for (int dx = 0; dx < kF; ++dx) dst[dy * p.sy + dx * p.sx] = v;
  }
}

// Key i of jax.random.split(key, num) (partitionable): the two output
// words of threefry2x32(key, 0, i), written to out[2 i], out[2 i + 1].
__global__ void threefry_split_kernel(uint32_t* __restrict__ out,
                                      const uint32_t* key, uint32_t k0,
                                      uint32_t k1, int num) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num) return;
  if (key != nullptr) {
    k0 = __ldg(key);
    k1 = __ldg(key + 1);
  }
  threefry2x32(k0, k1, 0u, (uint32_t)i, out[2 * i], out[2 * i + 1]);
}

template <int kMode>
void launch(typename Out<kMode>::T* out, const Params& p, int f, dim3 grid,
            dim3 block, cudaStream_t s) {
  if (f == 1)
    threefry_normal_kernel<kMode, 1><<<grid, block, 0, s>>>(out, p);
  else if (f == 2)
    threefry_normal_kernel<kMode, 2><<<grid, block, 0, s>>>(out, p);
  else
    threefry_normal_kernel<kMode, 4><<<grid, block, 0, s>>>(out, p);
}

}  // namespace

extern "C" {

// mode 0: int32 bits, 1: float32 normals, 2: bfloat16 normals, written to
// the (N, C, Hd * f, Wd * f) tensor at `out` with strides (sn, sc, sy, sx);
// f in {1, 2, 4}.
int sg2im_threefry_normal(void* out, const void* key, unsigned k0,
                          unsigned k1, unsigned long long offset, int mode,
                          int N, int C, int Hd, int Wd, int f, long long sn,
                          long long sc, long long sy, long long sx,
                          int c_inner, void* stream) {
  if (N < 1 || C < 1 || Hd < 1 || Wd < 1 || mode < 0 || mode > 2 ||
      (f != 1 && f != 2 && f != 4))
    return (int)cudaErrorInvalidValue;
  const Params p{(const uint32_t*)key, k0, k1, offset, N, C, Hd, Wd,
                 sn, sc, sy, sx, c_inner};
  const int inner = c_inner ? C : Wd;
  const int middle = c_inner ? Wd : Hd;
  const int outers = N * (c_inner ? Hd : C);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((inner + kBlockX - 1) / kBlockX,
                  (middle + kBlockY - 1) / kBlockY,
                  (unsigned)outers < kMaxGridZ ? (unsigned)outers
                                               : kMaxGridZ);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kBits:
      launch<kBits>((int32_t*)out, p, f, grid, block, s);
      break;
    case kNormalF32:
      launch<kNormalF32>((float*)out, p, f, grid, block, s);
      break;
    default:
      launch<kNormalBF16>((__nv_bfloat16*)out, p, f, grid, block, s);
  }
  return (int)cudaGetLastError();
}

// jax.random.split(key, num): num keys of two uint32 words at `out`; the
// key read from `key` on the card when it is not null, else (k0, k1).
int sg2im_threefry_split(void* out, const void* key, unsigned k0,
                         unsigned k1, int num, void* stream) {
  if (num < 1) return (int)cudaErrorInvalidValue;
  const int block = 128;
  threefry_split_kernel<<<(num + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)key, k0, k1, num);
  return (int)cudaGetLastError();
}

}  // extern "C"
