// M1, the mask head's eval forward for Hopper (sm_90a), one launch a step.
// The head (models/sg2im.py MaskNet) is, for each doubling step,
//
//   y = relu(conv3x3(batch_norm(upsample_nearest_2x(x))) + bias)
//
// from (slots, C) vectors to (slots, M, M, C) grids, then a 1x1 conv to one
// channel and the sigmoid.  A launch reads the step's coarse input (S x S,
// NHWC float32, S = 1 at the first step), applies the eval BatchNorm as it
// loads (a per-channel affine map commutes with nearest upsampling, so it
// is applied on the coarse grid), and writes the fine 2S x 2S grid with its
// four phases interleaved.  The last step writes no grid: its epilogue
// applies the 1x1 conv, its bias and the sigmoid and stores the masks.
//
// The phase form.  Output pixel (2i + a, 2j + b) of a 3x3 conv over the
// upsampled grid reads coarse rows {i - 1: W[0], i: W[1] + W[2]} for a = 0
// and {i: W[0] + W[1], i + 1: W[2]} for a = 1, and the columns alike: per
// phase (a, b) a 2x2 conv on the coarse grid with taps at offsets
// (a + ti - 1, b + tj - 1) and folded weights (ops/mask_head.py
// phase_weights, (phase, tap, C_in, C_out)).  Zero padding of the fine
// grid is zero padding of the coarse one, so the form is exact in real
// arithmetic: 16 C^2 multiply-adds a coarse position against the direct
// form's 36 C^2 on the four fine ones.  At S = 1 only the tap at offset
// (0, 0) reads the grid; it is the only one the launch runs.
//
// It replaces no TPU kernel: on the TPU XLA compiled the head's
// convolutions (sg2im_tpu/models/sg2im.py MaskNet); the port ran cuDNN's
// float32 convolutions, an FFT algorithm at the vg128 b128 shapes, with the
// upsample, BatchNorm and ReLU as passes of their own.
//
// What bounds it on the card: float32 FMAs.  All arithmetic is float32 on
// the FMA pipes: no TF32, no tensor cores.  Per step a phase is a GEMM of
// (slots S^2 rows) x (4 C) x C; a block computes 128 rows x 128 output
// channels of one phase, each of its 256 threads an 8 x 8 tile held in
// registers (a warp 4 x 8 threads, so a k's four 16-byte shared loads of a
// warp take one wavefront each), over the K loop of 4 taps x C channels in
// chunks of 16 channels, double-buffered in shared memory: while a chunk
// is multiplied, the next one's input rows are gathered into registers and
// its weights copied by cp.async.  The input rows are gathered with the
// tap's offset from the NHWC grid (zeros off the grid), normalised on the
// way into shared memory and stored transposed, rows fastest.  The bytes
// are few: the grids between steps (67 MB at b128 into the last step) and
// the weights (1 MB a step) against 44 MFLOP a slot.
//
// Measured on the H100 at vg128's b128 head (2048 slots; PERF.md, M1),
// against this design's 2.24 ms for the four steps (60% of the FMA peak):
// with the weights staged through registers 2.33-2.35 (2.67 in a build
// that spilled), and with rows of 16 threads a warp besides 2.35-2.40; one
// block an SM (up to 159 registers, with or without the next k's shared
// loads held ahead) 2.73-2.81; chunks of 8 channels 2.56-2.66; the four
// phases of a row tile as neighbouring blocks 2.38.  The eager head (cuDNN's FFT convolutions)
// took 7.88, the phase form in cuBLAS matmuls 4.94.
//
// Plain C interface (loaded with ctypes): sg2im_mask_head_step takes the
// pointers and the plan of ops/mask_head.py (struct Plan) and returns
// cudaGetLastError() after its launch, on the caller's stream.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kC = 128;        // channels: the kernel's only width
constexpr int kBM = 128;       // rows a block
constexpr int kBK = 16;        // channels a chunk of the K loop
constexpr int kThreads = 256;  // 16 x 16 threads of 8 x 8 outputs
constexpr int kPadM = kBM + 4; // the transposed rows' stride in shared memory

// The launch: ops/mask_head.py's StepPlan, field for field.
struct Plan {
  int64_t rows;       // slots * side * side
  int32_t side;       // S, the coarse grid's side, a power of 2
  int32_t log2_side;
  int32_t channels;   // 128
  int32_t last;       // 1: the 1x1 conv and sigmoid, masks out
  int32_t grid;       // row tiles: ceil(rows / 128)
  int32_t threads;    // 256
  float eps;
};

struct Args {
  const float* x;       // (rows, C): the coarse grid, NHWC
  const float* mean;    // the BatchNorm's four vectors, C each
  const float* var;
  const float* weight;
  const float* bias_bn;
  const float* wf;      // (4 phases, 4 taps, C in, C out)
  const float* bias;    // (C): the 3x3 conv's
  const float* w1;      // (C): the 1x1 conv's, at the last step
  const float* b1;      // (1)
  float* out;           // (slots, 2S, 2S, C), or the masks (slots, 2S, 2S)
  int64_t rows;
  int side;
  int log2_side;
  float eps;
};

template <bool kLast>
__global__ void __launch_bounds__(kThreads, 2)
    mask_head_kernel(const Args a) {
  __shared__ __align__(16) float As[2][kBK][kPadM];
  __shared__ __align__(16) float Bs[2][kBK][kC];
  __shared__ __align__(16) float scale_s[kC], shift_s[kC];

  const int tid = threadIdx.x;
  const int phase = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * kBM;
  const int pa = phase >> 1, pb = phase & 1;
  const int S = a.side, L = a.log2_side;

  if (tid < kC) {
    const float s = __fmul_rn(a.weight[tid],
                              rsqrtf(__fadd_rn(a.var[tid], a.eps)));
    scale_s[tid] = s;
    shift_s[tid] = __fmaf_rn(-a.mean[tid], s, a.bias_bn[tid]);
  }

  // The loads of a chunk: row lr of the tile, channels lh * 8 .. + 7 of
  // the chunk; two 16-byte copies of the weights' 16 x 128 chunk.
  const int lr = tid & (kBM - 1);
  const int lh = tid >> 7;
  const int64_t row = r0 + lr;
  const bool row_ok = row < a.rows;
  const int64_t slot = row >> (2 * L);
  const int pos = (int)(row & ((1 << (2 * L)) - 1));
  const int pi = pos >> L, pj = pos & (S - 1);

  const int ntaps = S == 1 ? 1 : 4;
  const int tap0 = S == 1 ? (1 - pa) * 2 + (1 - pb) : 0;
  const int nchunks = ntaps * (kC / kBK);

  constexpr int kAV = kBK / 8;  // float4 of the input a thread and chunk
  constexpr int kBV = kBK / 8;  // float4 of the weights a thread and chunk
  float4 ra[kAV];
  auto load_a = [&](int chunk) {
    const int t = tap0 + chunk / (kC / kBK);
    const int c = (chunk % (kC / kBK)) * kBK + lh * (kBK / 2);
    const int si = pi + pa + (t >> 1) - 1;
    const int sj = pj + pb + (t & 1) - 1;
    if (row_ok && si >= 0 && si < S && sj >= 0 && sj < S) {
      const float4* src = reinterpret_cast<const float4*>(
          a.x + ((slot << (2 * L)) + (si << L) + sj) * kC + c);
#pragma unroll
      for (int q = 0; q < kAV; ++q) {
        float4 v = __ldg(src + q);
        const float4 sc = *reinterpret_cast<const float4*>(&scale_s[c + 4 * q]);
        const float4 sh = *reinterpret_cast<const float4*>(&shift_s[c + 4 * q]);
        v.x = __fmaf_rn(v.x, sc.x, sh.x);
        v.y = __fmaf_rn(v.y, sc.y, sh.y);
        v.z = __fmaf_rn(v.z, sc.z, sh.z);
        v.w = __fmaf_rn(v.w, sc.w, sh.w);
        ra[q] = v;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kAV; ++q) ra[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto weights = [&](int chunk) {
    const int t = tap0 + chunk / (kC / kBK);
    const int c0 = (chunk % (kC / kBK)) * kBK;
    return reinterpret_cast<const float4*>(
        a.wf + ((int64_t)(phase * 4 + t) * kC + c0) * kC);
  };
  auto load_b = [&](int chunk, int buf) {
    const float4* w = weights(chunk);
#pragma unroll
    for (int q = 0; q < kBV; ++q) {
      const int idx = q * kThreads + tid;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          &Bs[buf][idx >> 5][(idx & 31) * 4]);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(w + (idx >> 5) * (kC / 4) + (idx & 31)));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto store = [&](int buf) {
    float* dst = &As[buf][lh * (kBK / 2)][lr];
#pragma unroll
    for (int q = 0; q < kAV; ++q) {
      dst[(4 * q + 0) * kPadM] = ra[q].x;
      dst[(4 * q + 1) * kPadM] = ra[q].y;
      dst[(4 * q + 2) * kPadM] = ra[q].z;
      dst[(4 * q + 3) * kPadM] = ra[q].w;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  };

  // A warp: 4 thread rows x 8 thread columns.
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  __syncthreads();  // the BatchNorm's terms
  load_a(0);
  load_b(0, 0);
  store(0);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) {
      load_a(c + 1);
      load_b(c + 1, buf ^ 1);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          acc[m][n] = __fmaf_rn(av[m], bv[n], acc[m][n]);
    }
    if (c + 1 < nchunks) store(buf ^ 1);
    __syncthreads();
  }

  // The epilogue: thread (ty, tx) holds rows ty * 4 + {0..3} and 64 + ty *
  // 4 + {0..3}, channels tx * 4 + {0..3} and 64 + tx * 4 + {0..3}.
  float bias[8], w1[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int co = (n < 4 ? 0 : 64) + tx * 4 + (n & 3);
    bias[n] = a.bias[co];
    if (kLast) w1[n] = a.w1[co];
  }
  const int L2 = L + 1;  // log2 of the fine side
  // At the last step each thread's partial 1x1 sums of its rows, by its
  // column of threads: red[tx][row] (the K loop's buffers, free now).
  float* red = &As[0][0][0];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int lrow = (m < 4 ? 0 : 64) + ty * 4 + (m & 3);
    const int64_t r = r0 + lrow;
    float v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float t = __fadd_rn(acc[m][n], bias[n]);
      v[n] = t > 0.f ? t : 0.f;
    }
    if (kLast) {
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) part = __fmaf_rn(w1[n], v[n], part);
      red[tx * (kBM + 1) + lrow] = part;
    } else if (r < a.rows) {
      const int64_t s = r >> (2 * L);
      const int p = (int)(r & ((1 << (2 * L)) - 1));
      const int64_t fine = (s << (2 * L2)) +
                           ((int64_t)(2 * (p >> L) + pa) << L2) +
                           2 * (p & (S - 1)) + pb;
      float4* o = reinterpret_cast<float4*>(a.out + fine * kC);
      o[tx] = make_float4(v[0], v[1], v[2], v[3]);
      o[16 + tx] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  if (kLast) {
    __syncthreads();
    const int64_t r = r0 + tid;
    if (tid < kBM && r < a.rows) {
      float z = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) z = __fadd_rn(z, red[t * (kBM + 1) + tid]);
      z = __fadd_rn(z, a.b1[0]);
      const int64_t s = r >> (2 * L);
      const int p = (int)(r & ((1 << (2 * L)) - 1));
      const int64_t fine = (s << (2 * L2)) +
                           ((int64_t)(2 * (p >> L) + pa) << L2) +
                           2 * (p & (S - 1)) + pb;
      a.out[fine] = 1.f / (1.f + expf(-z));
    }
  }
}

}  // namespace

extern "C" {

// One step of the head by the plan (a struct Plan): x the coarse grid, the
// BatchNorm's four vectors, the folded weights and the conv's bias; w1 and
// b1 (the 1x1 conv) are read only at the last step.
int sg2im_mask_head_step(const void* x, const void* mean, const void* var,
                         const void* weight, const void* bias_bn,
                         const void* wf, const void* bias, const void* w1,
                         const void* b1, void* out, const void* plan,
                         void* stream) {
  const Plan* p = (const Plan*)plan;
  if (!p || p->channels != kC || p->threads != kThreads || p->side < 1 ||
      p->side != (1 << p->log2_side) || p->rows < 1 ||
      p->rows % ((int64_t)p->side * p->side) ||
      p->grid != (p->rows + kBM - 1) / kBM || (p->last != 0 && p->last != 1))
    return (int)cudaErrorInvalidValue;
  if (!x || !mean || !var || !weight || !bias_bn || !wf || !bias || !out ||
      (p->last && !(w1 && b1)) || (uintptr_t)x % 16 || (uintptr_t)wf % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.mean = (const float*)mean;
  a.var = (const float*)var;
  a.weight = (const float*)weight;
  a.bias_bn = (const float*)bias_bn;
  a.wf = (const float*)wf;
  a.bias = (const float*)bias;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.out = (float*)out;
  a.rows = p->rows;
  a.side = p->side;
  a.log2_side = p->log2_side;
  a.eps = p->eps;
  void* params[] = {&a};
  const void* kernel = p->last ? (const void*)mask_head_kernel<true>
                               : (const void*)mask_head_kernel<false>;
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3(p->grid, 4), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
