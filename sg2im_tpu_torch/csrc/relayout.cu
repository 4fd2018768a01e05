// Space-to-depth / depth-to-space relayout for Hopper (sm_90a), NHWC.
//
//   packed[n, i, j, (2a + b) * C + c] = fine[n, 2i + a, 2j + b, c]
//
// fine is (N, 2R, 2Rw, C) and packed (N, R, Rw, 4C), both NHWC in memory (a
// channels_last NCHW tensor on the PyTorch side); any element type, the
// kernel moves bytes.  Replaces the Pallas TPU kernels of
// sg2im_tpu/ops/pallas/relayout_kernel.py:
//   sg2im_space_to_depth  <- space_to_depth_pallas / _s2d_kernel
//   sg2im_depth_to_space  <- depth_to_space_pallas / _d2s_kernel
//
// What bounds it on the card: bytes.  The relayout does no arithmetic; it
// reads every byte once and writes it once, so its ceiling is the card's
// copy rate (a copy_ of the same bytes is measured beside it).  Packed row
// (n, i) and fine rows 2i and 2i + 1 hold the same S = 4 Rw C elsize bytes
// from the same offset (n R + i) S (a segment), so the relayout permutes
// runs of L = 2 C elsize bytes (the two horizontal phases b) inside
// contiguous segments: fine order (a, j), packed order (j, a).
//
// The first version ran one 256-thread block a packed row, in units of the
// largest size dividing the run, with a runtime division a unit.  On the
// device it already came within 2-5% of copy_ at the CRN's wide shapes and
// matched it at the head's f32 d2s (C 3, 24-byte runs); where it lost to
// one PyTorch copy (the head, 0.0379 against 0.0230 ms a call) it lost on
// the host, whose enqueue of a launch took longer than the kernel.  Rows
// that are no multiple of a block's trip left trips part empty (s2d at the
// 32x32 and 64x64 levels: 1.25 and 2.5 trips a row).  The design now:
//   * a flat walk of the output in units of the largest size (16 bytes at
//     every path shape but the head's 8) that divides the run and both
//     pointers' alignment; each block takes `span` consecutive units, one
//     full trip of its threads, wherever in a segment it starts (one 64-bit
//     division a block), so no trip runs part empty;
//   * each thread makes kUnroll gathered loads through the read-only path,
//     then kUnroll stores to neighbouring addresses;
//   * the segment and the run are divided by the plan's multiply-high
//     constants (ops/relayout.py::relayout_plan), not a runtime division;
//   * the host passes the cached plan as one struct pointer: the wrapper's
//     part of a launch is most of a small shape's time.
// Measured and withdrawn (tools/relayout_ab.py, PERF.md): a persistent ring
// of tiles in shared memory filled by 1-D bulk async copies (cp.async.bulk
// on mbarriers), stored from shared memory by the threads, or gathered a
// run a bulk copy and stored by bulk copies, ran 2-4% slower than this walk
// on the device at the wide shapes and 8-10% slower at the head; spans of
// two and four trips ran slower than one.
// Offsets are 64-bit to a block's first segment and 32-bit from there (the
// plan keeps 2 S / unit + span < 2^31).
//
// Plain C interface (loaded with ctypes): each entry takes the plan as a
// struct Plan pointer and returns cudaGetLastError() after its launch, on
// the caller's stream.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// The launch: ops/relayout.py's RelayoutPlan, field for field.
struct Plan {
  int32_t route;  // 0 direct (16-byte units), 1 units (off 16-byte alignment)
  int32_t unit;   // bytes a unit
  int32_t segs;   // N R
  int32_t Rw;
  int32_t run;    // L bytes
  int32_t seg;    // S bytes
  int32_t span;   // units a block
  int32_t grid;
  uint32_t run_mul;  // L / unit and S / unit as multiply-highs
  int32_t run_shift;
  uint32_t seg_mul;
  int32_t seg_shift;
};

// q / d for 0 <= q < 2^31 by the plan's (mul, shift) (magic_divisor).
__device__ __forceinline__ int divide(int q, uint32_t mul, int shift) {
  return (int)((__umulhi((uint32_t)q, mul) + (uint32_t)q) >> shift);
}

struct Args {
  int64_t total;  // units of the tensor
  int span;       // units a block
  int Rw;
  int Lu, Su;     // units of a run and of a segment
  uint32_t run_mul, seg_mul;
  int run_shift, seg_shift;
};

// Offset, in units from the block's first segment, of the unit that output
// unit o (counted from that segment's start) reads: segment o / Su, run
// q, unit cu of the run.
template <bool kToDepth>
__device__ __forceinline__ int source(const Args& d, int o) {
  const int seg = divide(o, d.seg_mul, d.seg_shift);
  const int r = o - seg * d.Su;
  const int row = d.Rw * d.Lu;
  if (kToDepth) {
    // Output: packed, r = (2j + a) Lu + cu; input: fine, a Rw Lu + j Lu + cu.
    const int q = divide(r, d.run_mul, d.run_shift);
    return seg * d.Su + (q & 1) * row + (q >> 1) * d.Lu + (r - q * d.Lu);
  }
  // Output: fine, r = a Rw Lu + j Lu + cu; input: packed, (2j + a) Lu + cu.
  const int a = r >= row;
  const int rem = r - a * row;
  const int j = divide(rem, d.run_mul, d.run_shift);
  return seg * d.Su + (2 * j + a) * d.Lu + (rem - j * d.Lu);
}

template <typename T, bool kToDepth>
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const Args d) {
  const int64_t base = (int64_t)blockIdx.x * d.span;
  const int span = (int)min((int64_t)d.span, d.total - base);
  // The block may start inside a segment: one 64-bit division a block.
  const int64_t seg0 = base / d.Su;
  const int off = (int)(base - seg0 * d.Su);
  const T* src = in + seg0 * d.Su;
  T* dst = out + base;
  for (int o0 = threadIdx.x; o0 < span; o0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int o = o0 + k * kThreads;
      if (o < span) v[k] = __ldg(src + source<kToDepth>(d, off + o));
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int o = o0 + k * kThreads;
      if (o < span) dst[o] = v[k];
    }
  }
}

template <typename T, bool kToDepth>
int launch_as(const void* in, void* out, const Args& d, int grid,
              cudaStream_t s) {
  relayout_kernel<T, kToDepth><<<grid, kThreads, 0, s>>>((const T*)in,
                                                         (T*)out, d);
  return (int)cudaGetLastError();
}

template <bool kToDepth>
int launch(const void* in, void* out, const Plan* p, void* stream) {
  if (!p) return (int)cudaErrorInvalidValue;
  const int unit = p->unit;
  if ((p->route != 0 && p->route != 1) || unit < 1 || unit > 16 ||
      (unit & (unit - 1)) || p->segs < 1 || p->Rw < 1 || p->run < 1 ||
      p->run % unit || p->seg != 2 * (int64_t)p->Rw * p->run ||
      (((uintptr_t)in | (uintptr_t)out) % unit) || p->span < 1)
    return (int)cudaErrorInvalidValue;
  Args d;
  d.Lu = p->run / unit;
  d.Su = p->seg / unit;
  d.total = (int64_t)p->segs * d.Su;
  d.span = p->span;
  d.Rw = p->Rw;
  d.run_mul = p->run_mul;
  d.seg_mul = p->seg_mul;
  d.run_shift = p->run_shift;
  d.seg_shift = p->seg_shift;
  // Offsets from a block's first segment stay under 2 Su + span.
  if (2 * (int64_t)d.Su + d.span > 0x7fffffff ||
      p->grid != (d.total + d.span - 1) / d.span)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 16:
      return launch_as<uint4, kToDepth>(in, out, d, p->grid, s);
    case 8:
      return launch_as<uint2, kToDepth>(in, out, d, p->grid, s);
    case 4:
      return launch_as<uint32_t, kToDepth>(in, out, d, p->grid, s);
    case 2:
      return launch_as<uint16_t, kToDepth>(in, out, d, p->grid, s);
    default:
      return launch_as<uint8_t, kToDepth>(in, out, d, p->grid, s);
  }
}

}  // namespace

extern "C" {

// K3 s2d: fine x (N, 2R, 2Rw, C) -> packed out (N, R, Rw, 4C), by the plan
// of ops/relayout.py::relayout_plan (a struct Plan).
int sg2im_space_to_depth(const void* x, void* out, const void* plan,
                         void* stream) {
  return launch<true>(x, out, (const Plan*)plan, stream);
}

// K3 d2s: packed x (N, R, Rw, 4C) -> fine out (N, 2R, 2Rw, C).
int sg2im_depth_to_space(const void* x, void* out, const void* plan,
                         void* stream) {
  return launch<false>(x, out, (const Plan*)plan, stream);
}

}  // extern "C"
