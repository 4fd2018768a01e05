// Threefry-2x32 normals for Hopper (sm_90a): the JAX package's layout noise,
// jax.random.normal(key, (N, H / f, W / f, C)) with partitionable threefry,
// drawn on the card and nearest-upsampled by f into the (N, C, H, W) noise
// the generator takes (NCHW or channels_last).
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
// on any device) and no PyTorch call computes threefry.
//
// What bounds it on the card: instruction issue.  A value costs one
// threefry2x32-20 call, 20 rounds of add / rotate (one funnel shift, SHF) /
// xor and the key injections, and erf_inv's float work: at least 83
// instructions a value (utils/roofline.THREEFRY_OPS), against 4 bytes
// (bf16: 2) written f * f times.  At the 67.1 M values of a vg128 batch of
// 128 that is about 0.17 ms of the SMs' issue (128 thread instructions a
// clock) against 0.08 ms of stores; the kernel's own instructions a value
// set its time.  So the design issues little besides the hash and erf_inv:
//   * V values a thread (4 in float32 and int32, 8 in bfloat16), one
//     16-byte store each along the output's innermost dimension: the key
//     schedule (k2 and the injection constants), the counter's hi word,
//     the address and the bounds checks are paid once a thread, and the V
//     hashes run as independent chains, interleaved round by round;
//   * the walk (ops/prng_kernel.normal_plan, which also gives the grid):
//     kFlat for channels_last at f 1, where the output's bytes are the
//     draw's flat order, so a thread's counters are base + i; kPixel for
//     channels_last at f > 1, blockIdx (z, y) = (n, y / f) and a thread a
//     run of V channels of one drawn pixel, stored f x f times; kRow for
//     NCHW, blockIdx (z, y) = (n, c) and a thread a run of V drawn columns
//     of one row (counters base + i C), each stored f times along the row
//     and in f rows.  The one index split a thread makes (x / f or y / f
//     from its thread index) is a multiply-high by the plan's magic number,
//     not a division; there is no per-value 64-bit arithmetic;
//   * the counter's hi word is one a thread: a launch whose counters cross
//     a multiple of 2^32 runs the kCarry instance, which adds the carry of
//     each value's lo word;
//   * erf_inv evaluates the central polynomial (w < 5) for every value on
//     the float pipes and the tail polynomial only where w >= 5 (a branch:
//     0.34% of values), rather than choosing each of its nine
//     coefficients with a select, which issues on the integer lanes.  The
//     clamp of u to nextafter(-1, 0) and the |u| = 1 test are left out:
//     u >= -1 + 2^-24 and |u| < 1 hold for every input bit pattern (u =
//     2 unit + lo with unit in [0, 1 - 2^-23] rounds to [lo, 1 - 3 2^-24];
//     bfloat16 to [lo, 1 - 3 2^-8]), so both would be identities.
// No shared memory; 256 threads a block and at most 64 registers, so that
// four blocks (1024 threads) stay resident on an SM.  The key is passed by
// value, or read from device memory for a key split on the card, so that no
// launch waits for the host; the 64-bit offset by value.
//
// A second entry, sg2im_threefry_split, is jax.random.split on the card:
// one thread a key, so that the train step splits its key on the card in
// one launch (in tensor ops the hash is about 180 launches of two
// elements, issue time a host-bound step pays).  Its time is the host's
// issue of one launch; no kernel design moves it.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block (ops/prng_kernel.THREADS)
constexpr int kMinBlocks = 4;  // resident blocks an SM: <= 64 registers

enum Mode { kBits = 0, kNormalF32 = 1, kNormalBF16 = 2 };
enum Walk { kFlat = 0, kPixel = 1, kRow = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32-20 of V counters (hi_i, lo + i * step) under the key (k0,
// k1): V chains, interleaved round by round, their two output words in x0,
// x1.  Without kCarry every hi_i is hi.
template <int V, bool kCarry>
__device__ __forceinline__ void threefry2x32_run(uint32_t k0, uint32_t k1,
                                                 uint32_t hi, uint32_t lo,
                                                 uint32_t step,
                                                 uint32_t (&x0)[V],
                                                 uint32_t (&x1)[V]) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint32_t l = lo + i * step;
    x0[i] = (kCarry ? hi + (l < lo ? 1u : 0u) : hi) + k0;
    x1[i] = l + k1;
  }
#define SG2IM_ROUND(r)                              \
  _Pragma("unroll") for (int i = 0; i < V; ++i) { \
    x0[i] += x1[i];                                 \
    x1[i] = rotl(x1[i], r) ^ x0[i];                 \
  }
#define SG2IM_ROUNDS_A \
  SG2IM_ROUND(13) SG2IM_ROUND(15) SG2IM_ROUND(26) SG2IM_ROUND(6)
#define SG2IM_ROUNDS_B \
  SG2IM_ROUND(17) SG2IM_ROUND(29) SG2IM_ROUND(16) SG2IM_ROUND(24)
#define SG2IM_INJECT(a, b, n)                       \
  _Pragma("unroll") for (int i = 0; i < V; ++i) { \
    x0[i] += a;                                     \
    x1[i] += b + n;                                 \
  }
  SG2IM_ROUNDS_A
  SG2IM_INJECT(k1, k2, 1u)
  SG2IM_ROUNDS_B
  SG2IM_INJECT(k2, k0, 2u)
  SG2IM_ROUNDS_A
  SG2IM_INJECT(k0, k1, 3u)
  SG2IM_ROUNDS_B
  SG2IM_INJECT(k1, k2, 4u)
  SG2IM_ROUNDS_A
  SG2IM_INJECT(k2, k0, 5u)
#undef SG2IM_INJECT
#undef SG2IM_ROUNDS_B
#undef SG2IM_ROUNDS_A
#undef SG2IM_ROUND
}

// XLA's float32 erf_inv times x, for V values x in (-1, 1): the central
// polynomial in w - 2.5 for all of them, the tail polynomial in sqrt(w) - 3
// only where w = -log1p(-x^2) >= 5.
__device__ __forceinline__ float erf_inv_central(float t) {
  float p = 2.81022636e-08f;
  p = __fmaf_rn(p, t, 3.43273939e-07f);
  p = __fmaf_rn(p, t, -3.5233877e-06f);
  p = __fmaf_rn(p, t, -4.39150654e-06f);
  p = __fmaf_rn(p, t, 0.00021858087f);
  p = __fmaf_rn(p, t, -0.00125372503f);
  p = __fmaf_rn(p, t, -0.00417768164f);
  p = __fmaf_rn(p, t, 0.246640727f);
  return __fmaf_rn(p, t, 1.50140941f);
}

__device__ __forceinline__ float erf_inv_tail(float w) {
  const float t = __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = -0.000200214257f;
  p = __fmaf_rn(p, t, 0.000100950558f);
  p = __fmaf_rn(p, t, 0.00134934322f);
  p = __fmaf_rn(p, t, -0.00367342844f);
  p = __fmaf_rn(p, t, 0.00573950773f);
  p = __fmaf_rn(p, t, -0.0076224613f);
  p = __fmaf_rn(p, t, 0.00943887047f);
  p = __fmaf_rn(p, t, 1.00167406f);
  return __fmaf_rn(p, t, 2.83297682f);
}

template <int V>
__device__ __forceinline__ void erf_inv_run(const float (&x)[V],
                                            float (&out)[V]) {
  float w[V], p[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    w[i] = -log1pf(__fmul_rn(x[i], -x[i]));
    p[i] = erf_inv_central(__fsub_rn(w[i], 2.5f));
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (!(w[i] < 5.0f)) p[i] = erf_inv_tail(w[i]);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = __fmul_rn(p[i], x[i]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Each mode's output type, its values a thread (one 16-byte store) and the
// values of V random words.
template <int kMode>
struct Out;
template <>
struct Out<kBits> {
  using T = int32_t;
  static constexpr int V = 4;
  static __device__ __forceinline__ void values(const uint32_t (&bits)[V],
                                                T (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (int32_t)bits[i];
  }
};
template <>
struct Out<kNormalF32> {
  using T = float;
  static constexpr int V = 4;
  static __device__ __forceinline__ void values(const uint32_t (&bits)[V],
                                                T (&v)[V]) {
    const float lo = -0.99999994f;  // nextafter(-1, 0) in float32
    float u[V], e[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float unit = __fsub_rn(
          __uint_as_float((bits[i] >> 9) | 0x3F800000u), 1.0f);
      u[i] = __fadd_rn(__fmul_rn(unit, 2.0f), lo);
    }
    erf_inv_run<V>(u, e);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __fmul_rn(1.41421356f, e[i]);
  }
};
template <>
struct Out<kNormalBF16> {
  using T = __nv_bfloat16;
  static constexpr int V = 8;
  static __device__ __forceinline__ void values(const uint32_t (&bits)[V],
                                                T (&v)[V]) {
    const float lo = -0.99609375f;  // nextafter(-1, 0) in bfloat16
    float u[V], e[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float unit = __fsub_rn(
          __uint_as_float((((bits[i] & 0xFFu) >> 1) | 0x3F80u) << 16), 1.0f);
      // unit * 2 + lo is exact in float32: one rounding, as bfloat16's.
      u[i] = round_bf16(__fadd_rn(__fmul_rn(unit, 2.0f), lo));
    }
    erf_inv_run<V>(u, e);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __float2bfloat16_rn(__fmul_rn(1.4140625f, round_bf16(e[i])));
  }
};

// V values of T as one 16-byte word.
template <typename T, int V>
struct alignas(16) Vec {
  T v[V];
};

struct Params {
  const uint32_t* key;  // device words, or null: k0, k1 below
  uint32_t k0, k1;
  uint64_t offset;
  uint64_t total;        // values drawn (kFlat)
  int C, Hd, Wd;
  int J;                 // V-runs a drawn pixel (kPixel) or row (kRow)
  uint32_t j_mul;        // q / J = (umulhi(q, j_mul) + q) >> j_shift
  int j_shift;
  int vec;               // 16-byte stores: the rows are 16-byte aligned
};

__device__ __forceinline__ int div_j(int q, const Params& p) {
  return (int)((__umulhi((uint32_t)q, p.j_mul) + (uint32_t)q) >> p.j_shift);
}

// One thread: V values of the draw (see the walks in the file's notes),
// stored where the output holds them.
template <int kMode, int kWalk, int kF, bool kCarry>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    threefry_normal_kernel(typename Out<kMode>::T* __restrict__ out,
                           const Params p) {
  using T = typename Out<kMode>::T;
  constexpr int V = Out<kMode>::V;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  uint64_t counter;  // the first value's
  uint32_t step;     // between the thread's values
  int valid;         // of its V values, those inside the draw
  T* dst;            // the first value's first copy
  if (kWalk == kFlat) {
    const uint64_t first = (uint64_t)q * V;
    if (first >= p.total) return;
    counter = p.offset + first;
    step = 1;
    valid = p.total - first < V ? (int)(p.total - first) : V;
    dst = out + first;
  } else if (kWalk == kPixel) {
    // (n, y / f) = (blockIdx.z, blockIdx.y); q = x / f * J + channel run.
    if (q >= p.Wd * p.J) return;
    const int xd = div_j(q, p);
    const int c = (q - xd * p.J) * V;
    const uint32_t row = blockIdx.z * p.Hd + blockIdx.y;
    counter = p.offset + (uint64_t)row * (uint32_t)(p.Wd * p.C) +
              (uint32_t)(xd * p.C + c);
    step = 1;
    valid = min(V, p.C - c);
    dst = out + (uint64_t)row * (uint32_t)(kF * kF * p.Wd * p.C) +
          (uint32_t)(xd * kF * p.C + c);
  } else {
    // (n, c) = (blockIdx.z, blockIdx.y); q = y / f * J + column run.
    if (q >= p.Hd * p.J) return;
    const int yd = div_j(q, p);
    const int x = (q - yd * p.J) * V;
    counter = p.offset + (uint64_t)blockIdx.z * (uint32_t)(p.Hd * p.Wd * p.C)
              + (uint32_t)((yd * p.Wd + x) * p.C) + blockIdx.y;
    step = (uint32_t)p.C;
    valid = min(V, p.Wd - x);
    dst = out + ((uint64_t)blockIdx.z * p.C + blockIdx.y) *
                    (uint32_t)(kF * kF * p.Hd * p.Wd) +
          (uint32_t)(yd * kF * kF * p.Wd + x * kF);
  }
  uint32_t k0 = p.k0, k1 = p.k1;
  if (p.key != nullptr) {
    k0 = __ldg(p.key);
    k1 = __ldg(p.key + 1);
  }
  uint32_t x0[V], x1[V], bits[V];
  threefry2x32_run<V, kCarry>(k0, k1, (uint32_t)(counter >> 32),
                              (uint32_t)counter, step, x0, x1);
#pragma unroll
  for (int i = 0; i < V; ++i) bits[i] = x0[i] ^ x1[i];
  Vec<T, V> v;
  Out<kMode>::values(bits, v.v);

  if (kWalk == kFlat) {
    if (valid == V) {
      *reinterpret_cast<Vec<T, V>*>(dst) = v;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < valid) dst[i] = v.v[i];
    }
  } else if (kWalk == kPixel) {
    const int rowstep = kF * p.Wd * p.C;  // one output row, in elements
#pragma unroll 1
    for (int dy = 0; dy < kF; ++dy)
#pragma unroll
      for (int dx = 0; dx < kF; ++dx) {
        T* d = dst + dy * rowstep + dx * p.C;
        if (p.vec) {
          *reinterpret_cast<Vec<T, V>*>(d) = v;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (i < valid) d[i] = v.v[i];
        }
      }
  } else {
    const int W = kF * p.Wd;
    if (p.vec && valid == V) {
      // The run's V * f values as f 16-byte words: word m holds values
      // (m V + e) / f.
      Vec<T, V> w[kF];
#pragma unroll
      for (int m = 0; m < kF; ++m)
#pragma unroll
        for (int e = 0; e < V; ++e) w[m].v[e] = v.v[(m * V + e) / kF];
#pragma unroll
      for (int dy = 0; dy < kF; ++dy)
#pragma unroll
        for (int m = 0; m < kF; ++m)
          *reinterpret_cast<Vec<T, V>*>(dst + dy * W + m * V) = w[m];
    } else {
#pragma unroll
      for (int dy = 0; dy < kF; ++dy)
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (i < valid)
#pragma unroll
            for (int dx = 0; dx < kF; ++dx) dst[dy * W + i * kF + dx] = v.v[i];
    }
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
  uint32_t x0[1], x1[1];
  threefry2x32_run<1, false>(k0, k1, 0u, (uint32_t)i, 0u, x0, x1);
  out[2 * i] = x0[0];
  out[2 * i + 1] = x1[0];
}

template <int kMode, int kWalk, int kF>
void launch_walk(typename Out<kMode>::T* out, const Params& p, bool carry,
                 dim3 grid, cudaStream_t s) {
  if (carry)
    threefry_normal_kernel<kMode, kWalk, kF, true>
        <<<grid, kThreads, 0, s>>>(out, p);
  else
    threefry_normal_kernel<kMode, kWalk, kF, false>
        <<<grid, kThreads, 0, s>>>(out, p);
}

template <int kMode>
int launch(void* out, const Params& p, int walk, int f, int V, bool carry,
           dim3 grid, cudaStream_t s) {
  using T = typename Out<kMode>::T;
  if (V != Out<kMode>::V) return (int)cudaErrorInvalidValue;
  T* o = (T*)out;
  if (walk == kFlat && f == 1)
    launch_walk<kMode, kFlat, 1>(o, p, carry, grid, s);
  else if (walk == kPixel && f == 2)
    launch_walk<kMode, kPixel, 2>(o, p, carry, grid, s);
  else if (walk == kPixel && f == 4)
    launch_walk<kMode, kPixel, 4>(o, p, carry, grid, s);
  else if (walk == kRow && f == 1)
    launch_walk<kMode, kRow, 1>(o, p, carry, grid, s);
  else if (walk == kRow && f == 2)
    launch_walk<kMode, kRow, 2>(o, p, carry, grid, s);
  else if (walk == kRow && f == 4)
    launch_walk<kMode, kRow, 4>(o, p, carry, grid, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: int32 bits, 1: float32 normals, 2: bfloat16 normals, written to
// the (N, C, Hd * f, Wd * f) tensor at `out` (NCHW for walk kRow, else
// channels_last), by the walk, values a thread V, runs J and grid of
// ops/prng_kernel.normal_plan; `carry`: the launch's counters cross a
// multiple of 2^32.
int sg2im_threefry_normal(void* out, const void* key, unsigned k0,
                          unsigned k1, unsigned long long offset, int mode,
                          int walk, int carry, int N, int C, int Hd, int Wd,
                          int f, int V, int J, unsigned j_mul, int j_shift,
                          int vec, unsigned gx, unsigned gy, unsigned gz,
                          void* stream) {
  if (N < 1 || C < 1 || Hd < 1 || Wd < 1 || J < 1 || gx < 1 || gy < 1 ||
      gz < 1 || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{(const uint32_t*)key, k0, k1, offset,
                 (uint64_t)N * C * Hd * Wd, C, Hd, Wd, J, j_mul, j_shift,
                 vec};
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kBits:
      return launch<kBits>(out, p, walk, f, V, carry != 0, grid, s);
    case kNormalF32:
      return launch<kNormalF32>(out, p, walk, f, V, carry != 0, grid, s);
    case kNormalBF16:
      return launch<kNormalBF16>(out, p, walk, f, V, carry != 0, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
