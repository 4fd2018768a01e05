// R1, the CRN's 2x resampling for Hopper (sm_90a), NHWC: two entries over
// tensors whose C channels fill whole 16-byte vectors (8 bf16 or 4 float32
// channels; a channels_last NCHW tensor on the PyTorch side).
//
//   sg2im_pool_pyramid: the layout pyramid.  One launch reads level 0 once
//     and writes levels 1 .. L, level l + 1 the 2x2 average of level l:
//     each window summed in float32 from 0 in the order (0,0), (0,1),
//     (1,0), (1,1), divided by 4 and rounded to the storage type before
//     the next level is formed from it.  That is what successive
//     F.avg_pool2d(x, 2) computes (aten's avg_pool2d kernels, bit for bit).
//   sg2im_upsample2: the nearest-2x upsample, each coarse vector stored to
//     its four fine pixels: a copy, bit-equal to F.interpolate.
//
// It replaces no TPU kernel: XLA fused the CRN's pooling and upsampling
// into the convolutions that consume them; the port ran aten's
// avg_pool2d once a level and upsample_nearest2d once a stage, one 2-byte
// element a thread with index arithmetic, at about an eighth of the card's
// memory rate.
//
// What bounds it on the card: bytes.  The pyramid does 4 float operations
// a pooled element and the upsample none.  The least they move is the
// pyramid's level 0 read once and its levels written once, and each
// upsample's coarse tensor read once and its fine one written once
// (utils/roofline.py's crn_resample_bytes).  The design:
//   * every load and store moves a 16-byte vector of one pixel's channels,
//     neighbouring threads on neighbouring vectors of a pixel (then the
//     next tile or pixel), so a warp's access covers whole 32-byte sectors;
//   * the pyramid: a thread holds one vector of a 2^L x 2^L tile of level 0
//     and walks it in Z order, a 4x4 block (16 loads in flight) at a time,
//     so that each level's four windows complete in the order aten sums
//     them; a pooled value lives in registers until its parent takes it,
//     and is stored once.  Level 0 is read once, with no staging in shared
//     memory;
//   * the upsample: a thread loads one coarse vector and stores it to its
//     four fine pixels with streaming stores (the fine tensor is read next
//     by a convolution, not from L2).
// Measured on the H100 at both cells' b128 shapes (PERF.md, R1): 2x2
// blocks ran 3-12% slower than 4x4 ones, and blocks of 64 threads up to 9%
// faster than of 256 (the coco64 pyramid is 40960 threads); for the
// upsample, 1, 2 or 4 vectors a thread and 128 to 512 threads a block
// were within 1.5% of each other.
//
// Plain C interface (loaded with ctypes): each entry takes its pointers and
// the plan of ops/resample.py (struct PoolPlan, UpPlan) and returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxThreads = 512;
// The pyramid's launch bound: up to 255 registers a thread, for a 4x4
// block's sixteen vectors in flight.
constexpr int kMaxPoolThreads = 256;

// ops/resample.py's PoolPlan, field for field.
struct PoolPlan {
  int64_t tasks;    // N x (H >> L) x (W >> L) x vecs: one a thread
  int32_t height;   // level 0's H and W, multiples of 2^L
  int32_t width;
  int32_t vecs;     // 16-byte vectors a pixel
  int32_t levels;   // L, 1 .. kMaxLevels
  int32_t f32;      // 1: float32 storage, 0: bf16
  int32_t threads;
  int32_t grid;
};

// ops/resample.py's UpPlan, field for field.
struct UpPlan {
  int64_t units;    // N x H x W x vecs coarse vectors
  int32_t row_units;  // W x vecs
  int32_t vecs;
  int32_t threads;
  int32_t grid;
};

struct PoolArgs {
  const uint4* x;
  uint4* out[kMaxLevels];
  int64_t tasks;
  int height;
  int width;
  int vecs;
};

struct UpArgs {
  const uint4* x;
  uint4* out;
  int64_t units;
  int row_units;
  int vecs;
};

// A 16-byte vector of storage type S as floats, and back (rounded to
// nearest even, as aten's cast rounds).
template <typename S>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void to_float(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
  }
  // f rounded to bf16 in place (the value the next level pools), and packed.
  static __device__ __forceinline__ uint4 round(float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
    return v;
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_float(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 round(float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// The mean of four windows in aten's order: float32 sum from 0, / 4.
template <int kN>
__device__ __forceinline__ void mean4(const float* a, const float* b,
                                      const float* c, const float* d,
                                      float* out) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float s = 0.f;
    s = __fadd_rn(s, a[j]);
    s = __fadd_rn(s, b[j]);
    s = __fadd_rn(s, c[j]);
    s = __fadd_rn(s, d[j]);
    out[j] = __fdiv_rn(s, 4.f);
  }
}

// Level l's vector v of pixel (y, x) of image n, as a uint4 index.
__device__ __forceinline__ int64_t at(const PoolArgs& a, int l, int64_t n,
                                      int y, int x, int v) {
  return ((n * (a.height >> l) + y) * (a.width >> l) + x) * a.vecs + v;
}

// Z order within a 2^k x 2^k block: position p's row and column, bit 2d
// of p the column's bit d, bit 2d + 1 the row's.  Each run of four
// positions is a 2x2 window in aten's order (0,0), (0,1), (1,0), (1,1).
__host__ __device__ constexpr int z_row(int p) {
  return ((p >> 1) & 1) | (((p >> 3) & 1) << 1) | (((p >> 5) & 1) << 2);
}
__host__ __device__ constexpr int z_col(int p) {
  return (p & 1) | (((p >> 2) & 1) << 1) | (((p >> 4) & 1) << 2);
}

// The mean of the 2x2 window of level 0 whose four vectors raw holds.
template <typename S>
__device__ __forceinline__ void window_mean(const uint4* raw, float* out) {
  constexpr int kN = Vec<S>::kN;
  float f[4][kN];
#pragma unroll
  for (int k = 0; k < 4; ++k) Vec<S>::to_float(raw[k], f[k]);
  mean4<kN>(f[0], f[1], f[2], f[3], out);
}

// The 2^kB x 2^kB block of level 0 at (y0, x0), kB 1 or 2: its levels
// 1 .. kB stored, and its level-kB value returned in val (rounded).
template <typename S, int kB>
__device__ __forceinline__ void pool_block(const PoolArgs& a, int64_t n,
                                           int y0, int x0, int v,
                                           float* val) {
  static_assert(kB == 1 || kB == 2, "blocks of 2x2 or 4x4 pixels");
  using V = Vec<S>;
  constexpr int kN = V::kN;
  constexpr int kPix = 1 << (2 * kB);
  // The whole block's loads first: 4^kB of them in flight.
  uint4 raw[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
    raw[p] = __ldcs(a.x + at(a, 0, n, y0 + z_row(p), x0 + z_col(p), v));
  float l1[kPix / 4][kN];
#pragma unroll
  for (int k = 0; k < kPix / 4; ++k) {
    window_mean<S>(raw + 4 * k, l1[k]);
    const uint4 packed = V::round(l1[k]);
    __stcs(a.out[0] + at(a, 1, n, (y0 + z_row(4 * k)) >> 1,
                         (x0 + z_col(4 * k)) >> 1, v),
           packed);
  }
  if constexpr (kB == 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j) val[j] = l1[0][j];
  } else {
    mean4<kN>(l1[0], l1[1], l1[2], l1[3], val);
    const uint4 packed = V::round(val);
    __stcs(a.out[1] + at(a, 2, n, y0 >> 2, x0 >> 2, v), packed);
  }
}

template <typename S, int kL>
__global__ void __launch_bounds__(kMaxPoolThreads)
    crn_resample_kernel_pool(const PoolArgs a) {
  using V = Vec<S>;
  constexpr int kN = V::kN;
  constexpr int kBlk = kL < 2 ? kL : 2;  // 4x4 blocks, 2x2 at one level
  constexpr int kDigits = kL - kBlk;  // Z-order digits above a block
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.tasks) return;
  const int v = (int)(t % a.vecs);
  int64_t r = t / a.vecs;
  const int tiles_w = a.width >> kL;
  const int tiles_h = a.height >> kL;
  const int tx = (int)(r % tiles_w);
  r /= tiles_w;
  const int ty = (int)(r % tiles_h);
  const int64_t n = r / tiles_h;
  // acc[d]: the running sum of the windows of level kBlk + d + 1.
  float acc[kDigits + 1][kN];
#pragma unroll
  for (int d = 0; d < kDigits + 1; ++d)
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[d][j] = 0.f;
#pragma unroll 1
  for (int q = 0; q < (1 << (2 * kDigits)); ++q) {
    // q's Z-order digits: bit 2d the column, bit 2d + 1 the row.
    int qy = 0, qx = 0;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      qx |= ((q >> (2 * d)) & 1) << d;
      qy |= ((q >> (2 * d + 1)) & 1) << d;
    }
    const int y0 = (ty << kL) + (qy << kBlk);
    const int x0 = (tx << kL) + (qx << kBlk);
    float val[kN];
    pool_block<S, kBlk>(a, n, y0, x0, v, val);
    // Up the levels while this block closes their windows.
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[d][j] = __fadd_rn(acc[d][j], val[j]);
      if (((q >> (2 * d)) & 3) != 3) break;
      const int l = kBlk + d + 1;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        val[j] = __fdiv_rn(acc[d][j], 4.f);
        acc[d][j] = 0.f;
      }
      const uint4 packed = V::round(val);
      __stcs(a.out[l - 1] + at(a, l, n, y0 >> l, x0 >> l, v), packed);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    crn_resample_kernel_up2(const UpArgs a) {
  // One coarse vector a thread (units < 2^31: the plan's bound).
  const unsigned u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= a.units) return;
  const uint4 v = __ldcs(a.x + u);
  // Coarse row r (n H + y) holds row_units vectors; pixel x's vector lands
  // at fine pixels (2y + i, 2x + j) of fine rows 2r and 2r + 1.
  const unsigned row = u / (unsigned)a.row_units;
  const unsigned t = u - row * (unsigned)a.row_units;
  const unsigned x = t / (unsigned)a.vecs;
  uint4* o = a.out + 4 * (int64_t)row * a.row_units + t + (int64_t)x * a.vecs;
  __stcs(o, v);
  __stcs(o + a.vecs, v);
  __stcs(o + 2 * (int64_t)a.row_units, v);
  __stcs(o + 2 * (int64_t)a.row_units + a.vecs, v);
}

template <typename S>
const void* pool_pick_levels(const PoolPlan* p) {
  switch (p->levels) {
    case 1:
      return (const void*)crn_resample_kernel_pool<S, 1>;
    case 2:
      return (const void*)crn_resample_kernel_pool<S, 2>;
    case 3:
      return (const void*)crn_resample_kernel_pool<S, 3>;
    case 4:
      return (const void*)crn_resample_kernel_pool<S, 4>;
    case 5:
      return (const void*)crn_resample_kernel_pool<S, 5>;
    default:
      return nullptr;
  }
}

// The plan's kernel, or null for a plan out of its bounds.
const void* pool_kernel_of(const PoolPlan* p) {
  if (!p || p->levels < 1 || p->levels > kMaxLevels || p->vecs < 1 ||
      p->height < 1 || p->width < 1 ||
      p->height % (1 << p->levels) || p->width % (1 << p->levels) ||
      (p->f32 != 0 && p->f32 != 1) ||
      p->threads < 1 || p->threads > kMaxPoolThreads || p->tasks < 1 ||
      p->grid < 1 || (int64_t)p->grid * p->threads < p->tasks)
    return nullptr;
  return p->f32 ? pool_pick_levels<float>(p)
                : pool_pick_levels<__nv_bfloat16>(p);
}

const void* up_kernel_of(const UpPlan* p) {
  if (!p || p->units < 1 || p->units > INT32_MAX || p->vecs < 1 ||
      p->row_units < p->vecs || p->row_units % p->vecs ||
      p->units % p->row_units || p->threads < 1 ||
      p->threads > kMaxThreads || p->grid < 1 ||
      (int64_t)p->grid * p->threads < p->units)
    return nullptr;
  return (const void*)crn_resample_kernel_up2;
}

cudaError_t launch(const void* kernel, int grid, int threads, void* args,
                   void* stream) {
  void* params[] = {args};
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3(grid), dim3(threads), params, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// Levels 1 .. L of x by the plan (a struct PoolPlan): outs is a host array
// of L device pointers, level l's channels_last output at outs[l - 1].
int sg2im_pool_pyramid(const void* x, const void* const* outs,
                       const void* plan, void* stream) {
  const PoolPlan* p = (const PoolPlan*)plan;
  const void* kernel = pool_kernel_of(p);
  if (!kernel || !x || !outs || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  PoolArgs a;
  a.x = (const uint4*)x;
  for (int l = 0; l < kMaxLevels; ++l) {
    a.out[l] = nullptr;
    if (l < p->levels) {
      if (!outs[l] || (uintptr_t)outs[l] % 16)
        return (int)cudaErrorInvalidValue;
      a.out[l] = (uint4*)outs[l];
    }
  }
  a.tasks = p->tasks;
  a.height = p->height;
  a.width = p->width;
  a.vecs = p->vecs;
  return (int)launch(kernel, p->grid, p->threads, &a, stream);
}

// The nearest-2x upsample of x into out by the plan (a struct UpPlan).
int sg2im_upsample2(const void* x, void* out, const void* plan,
                    void* stream) {
  const UpPlan* p = (const UpPlan*)plan;
  const void* kernel = up_kernel_of(p);
  if (!kernel || !x || !out || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  UpArgs a;
  a.x = (const uint4*)x;
  a.out = (uint4*)out;
  a.units = p->units;
  a.row_units = p->row_units;
  a.vecs = p->vecs;
  return (int)launch(kernel, p->grid, p->threads, &a, stream);
}

}  // extern "C"
