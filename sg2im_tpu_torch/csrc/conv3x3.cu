// 3x3 'same' convolution for Hopper (sm_90a), NHWC, on the tensor cores.
//
//   out[n, y, x, co] = epilogue( sum_{ky, kx, ci} xpad[n, y + ky, x + kx, ci]
//                                                 * w[(ky * 3 + kx) * Cin + ci, co] )
//
// x is (N, H, W, Cin) with a zero border of one pixel ('same' padding), w is
// (9 * Cin, Co), tap-major: the OIHW weight permuted to (kh, kw, Cin, Co).
//
// Replaces the Pallas TPU kernel of scripts/proto_pallas_conv.py
// (make_conv_kernel, built and called by build): a row tile with its halo in
// fast memory, im2col built on chip, one matrix product per tile, and an
// optional scale * acc + bias -> LeakyReLU(0.2) epilogue.  Two entries:
//   sg2im_conv3x3_bf16  that kernel: bf16 in, f32 sums, optional epilogue,
//                       f32 or bf16 out;
//   sg2im_conv3x3_s8    the int8 conv of the turbo tier (sg2im_tpu/nn/crn.py
//                       _conv_int8): int8 in, exact int32 sums, out = f32
//                       acc * dq[co] (dq = activation scale * weight scale).
//
// What bounds it on this card: arithmetic.  The CRN shapes have K = 9 * Cin
// of 1152 to 6048 and 64 to 256 output channels; at 2 * K operations per
// input element read once, they are far above the card's ~295 operations per
// byte, so the tensor cores are the limit and the design keeps them fed from
// shared memory:
//   * one block owns one image, a tile of TH output rows by TW columns
//     (TH * TW <= 128 pixels) and 64 output channels;
//   * the Cin loop walks chunks of 64 bytes (32 bf16 or 64 int8 channels).
//     For each chunk the block stages the (TH + 2) x (TW + 2) halo window
//     and the 9 x 64 weight slice in shared memory, zero outside the image
//     and beyond Cin / Co;
//   * im2col is implicit: the A operand of tap (ky, kx) for output pixel
//     (r, c) is window pixel (r + ky, c + kx), read from shared memory.
//     Nothing of the im2col matrix goes to device memory;
//   * 8 warps, each 32 pixels x 32 channels, run mma.sync m16n8k16 (bf16)
//     or m16n8k32 (s8); the sums stay in registers over the whole Cin loop;
//   * rows of 80 bytes (64 + 16 padding) in shared memory make every
//     fragment load of a warp hit 32 distinct banks.
// This is the simple version: no TMA, no wgmma, no pipelining of the next
// chunk's loads behind this chunk's products.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: 4 along pixels x 2 along channels
constexpr int kTilePix = 128;   // output pixels per block
constexpr int kTileCo = 64;     // output channels per block
constexpr int kChunkWords = 16; // 64 bytes of channels per Cin chunk
constexpr int kRowWords = 20;   // shared-memory row stride (80 bytes)
constexpr int kWeightWords = 9 * kTileCo * kRowWords;

enum Epilogue { kNone = 0, kScaleBiasLeaky = 1, kDequant = 2 };

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Raw: uint16_t (bf16 bits) or uint8_t (int8 bits); Acc: float or int.
template <typename Raw, typename Acc, typename OutT, int kEpi>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const Raw* __restrict__ x,       // (N, H, W, Cin)
               const Raw* __restrict__ w,       // (9 * Cin, Co)
               const float* __restrict__ p0,    // scale or dq (Co,)
               const float* __restrict__ p1,    // bias (Co,)
               OutT* __restrict__ out,          // (N, H, W, Co)
               int H, int W, int Cin, int Co, int TH, int TW, int tiles_h,
               int tiles_w, int vec_ok) {
  constexpr int kPerWord = 4 / sizeof(Raw);      // elements per 32-bit word
  constexpr int kChunk = kChunkWords * kPerWord; // channels per chunk
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* w_s = smem;                 // [9][kTileCo][kRowWords]
  uint32_t* x_s = smem + kWeightWords;  // [(TH + 2) * (TW + 2)][kRowWords]

  const int tiles = tiles_h * tiles_w;
  const int n = blockIdx.x / tiles;
  const int t = blockIdx.x - n * tiles;
  const int h0 = (t / tiles_w) * TH;
  const int w0 = (t % tiles_w) * TW;
  const int co0 = blockIdx.y * kTileCo;
  const int WW = TW + 2;
  const int win_pix = (TH + 2) * WW;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // group id: fragment row / column
  const int tig = lane & 3;  // thread in group: fragment word
  const int pix_base = (warp & 3) * 32;
  const int co_base = (warp >> 2) * 32;

  // Window offset of this thread's four A rows (pixel slots); slots past
  // the tile read pixel 0 and are never stored.
  int a_off[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pix_base + mt * 16 + h * 8 + g;
      const int r = p / TW, c = p - (p / TW) * TW;
      a_off[mt][h] = (r < TH) ? (r * WW + c) * kRowWords : 0;
    }

  Acc acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = Acc(0);

  const int64_t img = (int64_t)n * H * W;
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk's products are done with smem
    // Halo window of this chunk.
    if (vec_ok) {
      // Cin * sizeof(Raw) % 16 == 0: each 16-byte quarter of the chunk is
      // wholly inside or wholly beyond Cin.
      for (int i = tid; i < win_pix * 4; i += kThreads) {
        const int pix = i >> 2, q = i & 3;
        const int wr = pix / WW, wc = pix - (pix / WW) * WW;
        const int y = h0 - 1 + wr, xc = w0 - 1 + wc;
        const int ch = c0 + q * (16 / sizeof(Raw));
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (y >= 0 && y < H && xc >= 0 && xc < W && ch < Cin)
          v = __ldg(reinterpret_cast<const uint4*>(
              x + (img + (int64_t)y * W + xc) * Cin + ch));
        *reinterpret_cast<uint4*>(x_s + pix * kRowWords + q * 4) = v;
      }
    } else {
      for (int i = tid; i < win_pix * kChunkWords; i += kThreads) {
        const int pix = i / kChunkWords, wd = i - pix * kChunkWords;
        const int wr = pix / WW, wc = pix - (pix / WW) * WW;
        const int y = h0 - 1 + wr, xc = w0 - 1 + wc;
        uint32_t v = 0u;
        if (y >= 0 && y < H && xc >= 0 && xc < W) {
          const Raw* src = x + (img + (int64_t)y * W + xc) * Cin;
#pragma unroll
          for (int e = 0; e < kPerWord; ++e) {
            const int ch = c0 + wd * kPerWord + e;
            if (ch < Cin)
              v |= (uint32_t)__ldg(src + ch) << (8 * sizeof(Raw) * e);
          }
        }
        x_s[pix * kRowWords + wd] = v;
      }
    }
    // Weight slice: w_s[tap][co][k] from w[(tap * Cin + k) * Co + co], co
    // fastest over threads so the global reads are coalesced.
    for (int i = tid; i < 9 * kChunkWords * kTileCo; i += kThreads) {
      const int co = i % kTileCo;
      const int wd = (i / kTileCo) % kChunkWords;
      const int tap = i / (kTileCo * kChunkWords);
      uint32_t v = 0u;
      if (co0 + co < Co) {
#pragma unroll
        for (int e = 0; e < kPerWord; ++e) {
          const int k = c0 + wd * kPerWord + e;
          if (k < Cin)
            v |= (uint32_t)__ldg(w + ((int64_t)tap * Cin + k) * Co + co0 +
                                 co)
                 << (8 * sizeof(Raw) * e);
        }
      }
      w_s[(tap * kTileCo + co) * kRowWords + wd] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * WW + tap % 3) * kRowWords;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kw = ks * 8 + tig;
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* row =
              w_s + (tap * kTileCo + co_base + nt * 8 + g) * kRowWords;
          b[nt][0] = row[kw];
          b[nt][1] = row[kw + 4];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* r0 = x_s + a_off[mt][0] + toff;
          const uint32_t* r1 = x_s + a_off[mt][1] + toff;
          const uint32_t a0 = r0[kw], a1 = r1[kw];
          const uint32_t a2 = r0[kw + 4], a3 = r1[kw + 4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
      }
    }
  }

  // Epilogue: c0, c1 at fragment row g, c2, c3 at row g + 8; columns
  // 2 * tig and 2 * tig + 1 of each 8-channel tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pix_base + mt * 16 + h * 8 + g;
      const int r = p / TW, c = p - (p / TW) * TW;
      const int y = h0 + r, xc = w0 + c;
      if (r >= TH || y >= H || xc >= W) continue;
      OutT* dst = out + (img + (int64_t)y * W + xc) * Co;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + co_base + nt * 8 + 2 * tig + j;
          if (co >= Co) continue;
          float v = (float)acc[mt][nt][2 * h + j];
          if (kEpi == kScaleBiasLeaky) {
            v = __fadd_rn(__fmul_rn(v, __ldg(p0 + co)), __ldg(p1 + co));
            v = v > 0.f ? v : __fmul_rn(0.2f, v);
          } else if (kEpi == kDequant) {
            v = __fmul_rn(v, __ldg(p0 + co));
          }
          if constexpr (sizeof(OutT) == 2)
            dst[co] = __float2bfloat16_rn(v);
          else
            dst[co] = v;
        }
    }
}

template <typename Raw, typename Acc, typename OutT, int kEpi>
int launch(const void* x, const void* w, const void* p0, const void* p1,
           void* out, int N, int H, int W, int Cin, int Co, void* stream) {
  const int TW = W < kTilePix ? W : kTilePix;
  const int TH = kTilePix / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long blocks = (long long)N * tiles_h * tiles_w;
  const int co_tiles = (Co + kTileCo - 1) / kTileCo;
  if (blocks >= (1LL << 31) || co_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)(kWeightWords + (TH + 2) * (TW + 2) * kRowWords) * 4;
  auto kernel = conv3x3_kernel<Raw, Acc, OutT, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_ok = ((Cin * (int)sizeof(Raw)) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  kernel<<<dim3((unsigned)blocks, (unsigned)co_tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(w),
      static_cast<const float*>(p0), static_cast<const float*>(p1),
      static_cast<OutT*>(out), H, W, Cin, Co, TH, TW, tiles_h, tiles_w,
      vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: bf16 x (N, H, W, Cin), w (9 * Cin, Co); with `epilogue` the f32 sums
// go through scale * acc + bias -> LeakyReLU(0.2) (scale, bias (Co,) f32).
int sg2im_conv3x3_bf16(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W,
                       int Cin, int Co, int epilogue, int out_bf16,
                       void* stream) {
  if (epilogue) {
    if (out_bf16)
      return launch<uint16_t, float, __nv_bfloat16, kScaleBiasLeaky>(
          x, w, scale, bias, out, N, H, W, Cin, Co, stream);
    return launch<uint16_t, float, float, kScaleBiasLeaky>(
        x, w, scale, bias, out, N, H, W, Cin, Co, stream);
  }
  if (out_bf16)
    return launch<uint16_t, float, __nv_bfloat16, kNone>(
        x, w, nullptr, nullptr, out, N, H, W, Cin, Co, stream);
  return launch<uint16_t, float, float, kNone>(x, w, nullptr, nullptr, out,
                                               N, H, W, Cin, Co, stream);
}

// The turbo tier's int8 conv: int8 x (N, H, W, Cin), w (9 * Cin, Co); out =
// f32(int32 sum) * dq[co], f32 (N, H, W, Co).
int sg2im_conv3x3_s8(const void* x, const void* w, const void* dq, void* out,
                     int N, int H, int W, int Cin, int Co, void* stream) {
  return launch<uint8_t, int, float, kDequant>(x, w, dq, nullptr, out, N, H,
                                               W, Cin, Co, stream);
}

}  // extern "C"
