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
// copy rate (a copy_ of the same bytes is measured beside it).  The design:
//   * the two horizontal phases b = 0, 1 of one fine row pair a sit side by
//     side on both sides: fine pixels (2i + a, 2j) and (2i + a, 2j + 1) are
//     2C consecutive elements of fine row 2i + a, and packed channels
//     [2aC, 2aC + 2C) of packed pixel (i, j).  So the kernel copies runs of
//     2C * elsize bytes, in units of 16, 8, 4, 2 or 1 bytes: the largest
//     unit that divides the run and both pointers' alignment.  bf16 with
//     C % 4 == 0 and f32 with C % 2 == 0 move as 16-byte vector loads and
//     stores; the CRN head's d2s (C = 3 in f32, a 24-byte run) moves in
//     8-byte units;
//   * one block per packed row (n, i).  The packed row and the two fine rows
//     2i and 2i + 1 hold the same 2 * Rw runs and start at the same offset,
//     (n * R + i) * 4 * Rw * C elements.  Threads walk the OUTPUT row in
//     order, so neighbouring threads store to neighbouring addresses; the
//     reads are gathered runs of the same length;
//   * each thread makes kUnroll loads through the read-only path before its
//     kUnroll stores, to keep more bytes in flight;
//   * row offsets are 64-bit (the 128x128 CRN level at batch 128 is 671 M
//     bf16 elements); offsets inside a row are 32-bit, and the wrapper checks
//     that 4 * Rw * C * elsize < 2^31.
// This is the simple version: no TMA bulk copies.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// Offset, in units, inside the block's row of the unit that output unit o
// reads.  Cu units make one run: the 2C elements of a row pair a at
// packed column j.
template <bool kToDepth>
__device__ __forceinline__ int source_offset(int o, int Rw, int Cu) {
  if (kToDepth) {
    // Output: packed row, o = (2j + a) * Cu + cu.
    // Input: fine rows 2i + a, o_in = a * Rw * Cu + j * Cu + cu.
    const int q = o / Cu;
    const int cu = o - q * Cu;
    return (q & 1) * (Rw * Cu) + (q >> 1) * Cu + cu;
  }
  // Output: fine rows 2i + a, o = a * Rw * Cu + j * Cu + cu.
  // Input: packed row, o_in = (2j + a) * Cu + cu.
  const int fine_row = Rw * Cu;
  const int a = o >= fine_row;
  const int rem = o - a * fine_row;
  const int j = rem / Cu;
  return (2 * j + a) * Cu + (rem - j * Cu);
}

template <typename T, bool kToDepth>
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const T* __restrict__ in, T* __restrict__ out, int Rw,
                    int Cu) {
  const int row_units = 2 * Rw * Cu;
  const int64_t base = (int64_t)blockIdx.x * row_units;
  const T* src = in + base;
  T* dst = out + base;
  for (int o0 = threadIdx.x; o0 < row_units; o0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int o = o0 + k * kThreads;
      if (o < row_units)
        v[k] = __ldg(src + source_offset<kToDepth>(o, Rw, Cu));
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int o = o0 + k * kThreads;
      if (o < row_units) dst[o] = v[k];
    }
  }
}

template <bool kToDepth>
int launch(const void* in, void* out, int N, int R, int Rw, int C, int elsize,
           void* stream) {
  if (N < 1 || R < 1 || Rw < 1 || C < 1 || elsize < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t run = 2 * (int64_t)C * elsize;
  const uintptr_t align = (uintptr_t)in | (uintptr_t)out;
  int unit = 1;
  for (int u = 16; u > 1; u >>= 1) {
    if (run % u == 0 && align % u == 0) {
      unit = u;
      break;
    }
  }
  const int Cu = (int)(run / unit);
  const dim3 grid((unsigned)(N * R));  // the wrapper checks N * R < 2^31
  cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 16:
      relayout_kernel<uint4, kToDepth><<<grid, kThreads, 0, s>>>(
          (const uint4*)in, (uint4*)out, Rw, Cu);
      break;
    case 8:
      relayout_kernel<uint2, kToDepth><<<grid, kThreads, 0, s>>>(
          (const uint2*)in, (uint2*)out, Rw, Cu);
      break;
    case 4:
      relayout_kernel<uint32_t, kToDepth><<<grid, kThreads, 0, s>>>(
          (const uint32_t*)in, (uint32_t*)out, Rw, Cu);
      break;
    case 2:
      relayout_kernel<uint16_t, kToDepth><<<grid, kThreads, 0, s>>>(
          (const uint16_t*)in, (uint16_t*)out, Rw, Cu);
      break;
    default:
      relayout_kernel<uint8_t, kToDepth><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)in, (uint8_t*)out, Rw, Cu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 s2d: fine x (N, 2R, 2Rw, C) -> packed out (N, R, Rw, 4C), elements of
// elsize bytes.
int sg2im_space_to_depth(const void* x, void* out, int N, int R, int Rw,
                         int C, int elsize, void* stream) {
  return launch<true>(x, out, N, R, Rw, C, elsize, stream);
}

// K3 d2s: packed x (N, R, Rw, 4C) -> fine out (N, 2R, 2Rw, C).
int sg2im_depth_to_space(const void* x, void* out, int N, int R, int Rw,
                         int C, int elsize, void* stream) {
  return launch<false>(x, out, N, R, Rw, C, elsize, stream);
}

}  // extern "C"
