// Layout compose for Hopper (sm_90a): the mask-modulated scene layout.
//
//   out[n, y, x, d] = sum_o warp[n, o, y, x] * vecs[n, o, d]
//   warp[n, o]      = Wy[n, o] @ mask[n, o] @ Wx[n, o]^T      (H, W)
//
// Replaces the two Pallas TPU kernels of
// sg2im_tpu/ops/pallas/layout_kernel.py, one kernel each:
//   sg2im_layout_compose_boxes   <- fused_layout_compose_v2 / _pallas_compose_v2
//     (:265, :241; tent weights built in the kernel from the raw boxes):
//     compose_boxes_kernel below (K1, on every forward of the model);
//   sg2im_layout_compose_weights <- fused_layout_compose / _pallas_compose
//     (:125, :89; dense Wy (N,O,H,M) and Wx (N,O,W,M) given):
//     compose_weights_kernel below (K2).
//
// The work at the flagship shape (N=128, O=16, M=16, H=W=128, D=128): the
// output is 1.07 GB in f32 or 0.54 GB in bf16, against 8.6 GFLOP of f32
// FMAs in the sum over objects.  At 3.35 TB/s and 67 TFLOP/s the f32 write
// takes 0.32 ms and the FMAs 0.13, so an f32 output is bound by its write;
// a bf16 write takes 0.16 ms, the same size as the FMAs, so a bf16 output
// is bound by how well the two overlap.  What bounds each kernel on the
// card, measured, is written at its own section.  Neither kernel
// materialises the (N, O, H, W) warp tensor in device memory.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch, on the caller's stream, or a
// cudaError_t for a launch it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTileD = 128;  // channels per block (grid.y walks the rest)
constexpr int kMaxM = 32;    // mask side
// Two blocks per SM: (228 KB - 2 x 1 KB reserved) / 2.
constexpr int kSmemBudget = 115712;

__device__ __forceinline__ void store4(float* dst, const float (&v)[4],
                                       int n_valid, bool vec_ok) {
  if (vec_ok && n_valid == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int b = 0; b < n_valid; ++b) dst[b] = v[b];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&v)[4], int n_valid,
                                       bool vec_ok) {
  if (vec_ok && n_valid == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  } else {
    for (int b = 0; b < n_valid; ++b) dst[b] = __float2bfloat16_rn(v[b]);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Eight bf16 channels of one pixel: one 16-byte store (``vec`` 2: D % 8 ==
// 0), two 8-byte ones (``vec`` 1: D % 4 == 0), else element stores.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8],
                                       int n_valid, int vec) {
  if (vec == 2 && n_valid == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
        bf16x2(v[6], v[7]));
  } else if (vec && n_valid >= 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2(v[0], v[1]),
                                                bf16x2(v[2], v[3]));
    if (n_valid == 8)
      *reinterpret_cast<uint2*>(dst + 4) = make_uint2(bf16x2(v[4], v[5]),
                                                      bf16x2(v[6], v[7]));
  } else {
    for (int b = 0; b < n_valid; ++b) dst[b] = __float2bfloat16_rn(v[b]);
  }
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Division by a divisor fixed for the launch as a multiply and a shift: a
// division by a runtime value is a long dependent chain, and the index
// arithmetic of the copies and work items is on the kernel's critical path.
// mul = ceil(2^(32 + l) / d) with 2^l >= d gives the exact quotient for
// every 0 <= n < 2^31.
struct FastDiv {
  unsigned long long mul;
  int shift;
};

inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const int shift = 32 + l;
  return FastDiv{((1ULL << shift) + d - 1) / d, shift};
}

__device__ __forceinline__ int div_by(int n, const FastDiv& f) {
  return (int)(((unsigned long long)(unsigned)n * f.mul) >> f.shift);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// ---------------------------------------------------------------------------
// The boxes entry (K1).
//
// Tent weights (sg2im_tpu/ops/sampling.py:32-50): w[j] = max(0, 1 - |s - j|)
// with non-finite values set to 0.  For one source coordinate s at most two
// taps are non-zero, at floor(s) and floor(s) + 1, and taps outside
// [0, M - 1] are zero; a non-finite s (a degenerate box, hi == lo, gives
// 0/0 or x/0) gives an all-zero row.  So the warp is a 2x2 bilinear sample
// of the mask, each tap weight computed with the same expression as the
// reference.  Build without fast math: the non-finite test is part of the
// contract.
//
// What held the first port back (0.61 ms at b128 in f32 and in bf16 alike
// on an H100 80GB HBM3 at 700 W: 52% of the f32 bound, 26% of the bf16
// one, so not the write): one block per output row walked four column
// tiles of 32, and before each ran a barrier-separated coefficient stage
// that recomputed the x taps (two IEEE divisions each) for every row of
// the image and gathered four mask values per coefficient from L2, then
// did 256 FMAs a thread before the next barrier, and stored bf16 in 8-byte
// pieces.  The design:
//
//   * blocks over tiles: one block per (image n, band of TH rows, tile of
//     TX columns, channel tile of 128), TH and TX powers of two; the
//     wrapper's boxes_plan picks them (16 x 32 at b128) and G below, and
//     passes them to the launch;
//   * the group's masks and object vectors staged once per block with
//     cp.async (16-byte copies where M and D allow), only the objects there
//     are;
//   * the taps once per block: the y taps of (object, row of the band) and
//     the x taps of (object, column of the tile) into shared memory, with
//     the reference's expressions; a tap index outside [0, M - 1] has
//     weight 0 and is clamped into the mask, so it reads a finite value
//     (the masks are finite) and adds 0;
//   * coefficients from shared memory only: warp[o, r, x], the 2x2 sample
//     of the staged mask, into a (G, TH, TX) tile; a work item is one
//     column by 4 rows, so a warp's tap reads are consecutive;
//   * the output stage on registers: a thread owns 4 consecutive pixels of
//     a row by 8 channels (32 sums, no spills at 80 registers), so per
//     object one broadcast 16-byte load of coefficients and two of the
//     vector feed 32 FMAs; stores go straight from registers, 16 bytes a
//     thread: in bf16 a thread's 8 channels are consecutive (one store a
//     pixel), in f32 its two halves of 4 lie 4 d_groups channels apart, so
//     each store instruction of a warp covers whole 32-byte sectors;
//   * at most kBSmemBudget bytes of shared memory: three blocks per SM.
//     Where the objects do not fit at once the plan takes groups of G < O
//     objects whose sums carry over in registers, on a tile of one pass
//     (kGroups, so the one-group path carries nothing across groups).
//
// What bounds it now (PERF.md, measured with variants of this kernel that
// leave a stage out): in f32 the write, 0.358 ms at b128, 90% of the bound
// and within 1.1x of a fill_ of the same bytes.  In bf16, 0.310 ms, 52% of
// the bound: instruction issue in the FMA loop, stores included (0.25 ms
// alone, where its FMAs at the f32 peak take 0.13), to which staging, taps
// and coefficients (0.06 ms alone) add rather than hide under it.  Tried and
// withdrawn, none faster: 8 pixels by 8 channels a thread (128 registers,
// spills: 0.42 ms in bf16), a warp of 8 pixel groups by 4 channel groups,
// unrolling the object loop by 1 or 4, a grid of three blocks per SM
// walking the tiles, four blocks per SM (64 registers, spills), and
// streaming stores (f32 1% faster, bf16 not; evict-first would drop a
// small batch's layout from L2 before the next layer reads it).
//
// Objects are summed in f32 in the order o = 0 ... O - 1, and the result is
// rounded once to the output type.
// ---------------------------------------------------------------------------

constexpr int kBThreads = 256;
constexpr int kBXPer = 4;     // output pixels per thread (along a row)
constexpr int kBDPer = 8;     // channels per thread
constexpr int kBMaxTH = 32;   // output rows per block
constexpr int kBMaxTX = 128;  // output columns per block
// Three blocks per SM: 228 KB / 3 less the 1 KB the card keeps per block.
constexpr int kBSmemBudget = 76800;

struct Taps {
  int j0;    // first tap index
  float w0;  // weight of tap j0
  float w1;  // weight of tap j0 + 1
};

// Source coordinate of output pixel p along one axis of a box warp:
// t = p / (size - 1), s = (t - lo) / (hi - lo) * (M - 1).
__device__ __forceinline__ float src_coord(int p, int size, float lo,
                                           float hi, int M) {
  const float t = (float)p / (float)(size - 1);
  return (t - lo) / (hi - lo) * (float)(M - 1);
}

__device__ __forceinline__ Taps tent_taps(float s, int M) {
  Taps t{0, 0.f, 0.f};
  // NaN and +-inf fail this test, as does any s whose taps all lie outside
  // [0, M - 1]; both give the all-zero row of the reference.
  if (!(s > -1.f && s < (float)M)) return t;
  const float f = floorf(s);
  t.j0 = (int)f;
  if (t.j0 >= 0) t.w0 = fmaxf(1.f - fabsf(s - f), 0.f);
  if (t.j0 + 1 <= M - 1) t.w1 = fmaxf(1.f - fabsf(s - (f + 1.f)), 0.f);
  return t;
}

// The taps of output coordinate p as a float4 {base + stride j0, base +
// stride j1 (int bits), w0, w1}: j0 and j0 + 1 clamped into [0, M - 1],
// where a tap outside has weight 0, so it reads a finite mask value and
// adds 0; past the image's edge both weights are 0.
__device__ __forceinline__ float4 taps_at(int p, int size, float lo,
                                          float hi, int M, int base,
                                          int stride) {
  Taps t{0, 0.f, 0.f};
  if (p < size) t = tent_taps(src_coord(p, size, lo, hi, M), M);
  const int j0 = max(t.j0, 0), j1 = min(t.j0 + 1, M - 1);
  return make_float4(__int_as_float(base + stride * j0),
                     __int_as_float(base + stride * j1), t.w0, t.w1);
}

// How one call is cut.  The tile choice (TH, TX, G) is the caller's:
// ops/layout_kernel.py boxes_plan picks it, with the shared memory formula
// of make_boxes_plan, and passes it to the launch.
struct BPlan {
  int TH, TX, G;
  int th_log, tx_log, gx_log;  // log2 of TH, TX and TX / kBXPer
  int rb_log;     // log2 of the rows of one coefficient work item
  int d_groups;   // threads along the channel tile (8 channels each)
  int pgs;        // pixel groups (4 pixels of a row) a block holds at once
  int threads;    // d_groups * pgs
  int n_bands, x_tiles, d_tiles, groups;
  int smem;       // dynamic shared memory bytes
  int off_xt, off_yt, off_vec, off_mask;  // offsets in floats
  FastDiv by_dg, by_dg2, by_dt;
};

inline int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The plan of a tile choice, and whether the kernel can run it: TH and TX
// powers of two within bounds, groups only with a tile of one pass, shared
// memory within kBSmemBudget.
bool make_boxes_plan(int O, int H, int W, int M, int D, int TH, int TX,
                     int G, BPlan* out) {
  BPlan p{};
  p.TH = TH, p.TX = TX, p.G = G;
  p.th_log = log2_exact(TH);
  p.tx_log = log2_exact(TX);
  if (p.th_log < 0 || p.tx_log < 0 || TH > kBMaxTH || TX < kBXPer ||
      TX > kBMaxTX || G < 1 || G > O)
    return false;
  p.gx_log = p.tx_log - 2;
  p.rb_log = min(p.th_log, 2);
  p.d_groups = ceil_div(min(D, kTileD), kBDPer);
  const int tile_groups = TH * TX / kBXPer;
  p.pgs = min(kBThreads / p.d_groups, tile_groups);
  p.threads = p.d_groups * p.pgs;
  p.n_bands = ceil_div(H, TH);
  p.x_tiles = ceil_div(W, TX);
  p.d_tiles = ceil_div(D, kTileD);
  p.groups = ceil_div(O, G);
  if (p.groups > 1 && tile_groups > p.pgs) return false;
  const int dt = kBDPer * p.d_groups;
  p.off_xt = G * TH * TX;
  p.off_yt = p.off_xt + 4 * G * TX;
  p.off_vec = p.off_yt + 4 * G * TH;
  p.off_mask = p.off_vec + G * dt;
  const long long smem = 4LL * (p.off_mask + (long long)G * M * M);
  if (smem > kBSmemBudget) return false;
  p.smem = (int)smem;
  p.by_dg = fast_div(p.d_groups);
  p.by_dg2 = fast_div(2 * p.d_groups);
  p.by_dt = fast_div(dt);
  *out = p;
  return true;
}

// The channel of element e of half h of channel group dg: in bf16 a
// thread's 8 channels are consecutive (one 16-byte store a pixel); in f32
// its two halves lie 4 d_groups apart, so each 16-byte store instruction
// of a warp covers whole 32-byte sectors.
template <typename OutT>
__device__ __forceinline__ int channel_of(int dg, int h, int d_groups) {
  return sizeof(OutT) == 4 ? 4 * (h * d_groups + dg) : 8 * dg + 4 * h;
}

// Shared memory (floats): coefficients [G][TH][TX], x taps [G][TX] and y
// taps [G][TH] (float4 each), vectors [G][2][d_groups][4] (half h of
// channel group dg at [h][dg], so a warp's 16-byte reads of one half are
// consecutive), masks [G][M][M].  Thread tid owns channel group
// tid % d_groups and pixel group tid / d_groups.  kGroups: more than one
// object group, on a tile of one pass, the sums carried over the groups.
template <typename OutT, bool kGroups>
__global__ void __launch_bounds__(kBThreads, 3)
compose_boxes_kernel(const float* __restrict__ boxes,  // (N, O, 4)
                     const float* __restrict__ masks,  // (N, O, M, M)
                     const float* __restrict__ vecs,   // (N, O, D)
                     OutT* __restrict__ out,           // (N, H, W, D)
                     int O, int H, int W, int M, int D, const BPlan p,
                     int copy16, int vec16, int store_vec) {
  extern __shared__ __align__(16) float smem[];
  float* coef_s = smem;
  float4* xt_s = reinterpret_cast<float4*>(smem + p.off_xt);
  float4* yt_s = reinterpret_cast<float4*>(smem + p.off_yt);
  float* vec_s = smem + p.off_vec;
  const float* mask_s = smem + p.off_mask;
  const uint32_t vec_u = smem_u32(vec_s);
  const uint32_t mask_u = smem_u32(mask_s);

  const int TH = p.TH, TX = p.TX, tile = TH * TX;
  const int d_groups = p.d_groups, nthreads = p.threads;
  const int dt = kBDPer * d_groups, MM = M * M;
  const int tile_groups = tile / kBXPer;

  const int tid = threadIdx.x;
  const int per_img = p.n_bands * p.x_tiles;
  const int n = blockIdx.x / per_img;
  const int rem = blockIdx.x - n * per_img;
  const int band = rem / p.x_tiles;
  const int y0 = band * TH;
  const int x0 = (rem - band * p.x_tiles) * TX;
  const int th = min(TH, H - y0), tx = min(TX, W - x0);
  const int d_base = blockIdx.y * kTileD;
  const int d_len = min(kTileD, D - d_base);
  const int pg = div_by(tid, p.by_dg);
  const int dg = tid - pg * d_groups;
  const int n_valid = min(kBDPer, d_len - kBDPer * dg);

  float acc[kBXPer][kBDPer];

  for (int g = 0; g < (kGroups ? p.groups : 1); ++g) {
    const int ob = g * p.G;
    const int gn = min(p.G, O - ob);
    const size_t no_g = (size_t)n * O + ob;
    if (g > 0) __syncthreads();  // the last group's readers are done

    // The group's masks, as they lie in device memory.
    if (copy16) {  // M % 4 == 0
      for (int k = tid; k < gn * MM / 4; k += nthreads)
        cp_async16(mask_u + 16 * k, masks + no_g * MM + 4 * k, 16);
    } else {
      for (int k = tid; k < gn * MM; k += nthreads)
        cp_async4(mask_u + 4 * k, masks + no_g * MM + k, 4);
    }
    // The group's vectors, zero past the channel tile.
    if (vec16) {  // D % 4 == 0: a half of a channel group is in or out
      for (int k = tid; k < gn * 2 * d_groups; k += nthreads) {
        const int o = div_by(k, p.by_dg2), e = k - o * 2 * d_groups;
        const int h = div_by(e, p.by_dg), q = e - h * d_groups;
        const int d = channel_of<OutT>(q, h, d_groups);
        const bool ok = d < d_len;
        cp_async16(vec_u + 16 * k,
                   ok ? vecs + (no_g + o) * D + d_base + d : vecs,
                   ok ? 16 : 0);
      }
    } else {
      for (int k = tid; k < gn * dt; k += nthreads) {
        const int o = div_by(k, p.by_dt), d = k - o * dt;
        // The slot of channel d: [h][dg][e].
        const int slot = sizeof(OutT) == 4
                             ? d
                             : (((d >> 2) & 1) * d_groups + (d >> 3)) * 4 +
                                   (d & 3);
        const bool ok = d < d_len;
        cp_async4(vec_u + 4 * (o * dt + slot),
                  ok ? vecs + (no_g + o) * D + d_base + d : vecs,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();

    // The taps, while the copies fly: x taps as mask columns, y taps as
    // offsets of mask rows in the staged group.
    for (int k = tid; k < gn * TX; k += nthreads) {
      const int o = k >> p.tx_log, x = k & (TX - 1);
      const float* b = boxes + (no_g + o) * 4;
      xt_s[k] = taps_at(x0 + x, W, __ldg(b), __ldg(b + 2), M, 0, 1);
    }
    for (int k = tid; k < gn * TH; k += nthreads) {
      const int o = k >> p.th_log, r = k & (TH - 1);
      const float* b = boxes + (no_g + o) * 4;
      yt_s[k] = taps_at(y0 + r, H, __ldg(b + 1), __ldg(b + 3), M, o * MM, M);
    }
    cp_async_wait<0>();
    __syncthreads();

    // warp[o, r .. r + 3, x]: the 2x2 samples of the mask, in the order of
    // the first port (the two rows at each x tap, then the x taps); zero
    // past the image's edge, where the taps are zero.  Consecutive threads
    // take consecutive columns.
    for (int k = tid; k < (gn * tile) >> p.rb_log; k += nthreads) {
      const int x = k & (TX - 1), t = k >> p.tx_log;
      const int r0 = (t << p.rb_log) & (TH - 1);
      const int o = t >> (p.th_log - p.rb_log);
      const float4 xt = xt_s[(o << p.tx_log) + x];
      const int j0 = __float_as_int(xt.x), j1 = __float_as_int(xt.y);
      float* dst = coef_s + ((o << p.th_log) + r0) * TX + x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < (1 << p.rb_log)) {
          const float4 yt = yt_s[(o << p.th_log) + r0 + e];
          const float* m0 = mask_s + __float_as_int(yt.x);
          const float* m1 = mask_s + __float_as_int(yt.y);
          const float t0 = yt.z * m0[j0] + yt.w * m1[j0];
          const float t1 = yt.z * m0[j1] + yt.w * m1[j1];
          dst[e * TX] = t0 * xt.z + t1 * xt.w;
        }
      }
    }
    __syncthreads();

    // Output stage: pixel group q is 4 pixels of row q / (TX / 4).
    for (int q = pg; q < tile_groups; q += p.pgs) {
      const int r = q >> p.gx_log, c = (q & ((TX >> 2) - 1)) << 2;
      if (r >= th || c >= tx) continue;  // past the image's edge
      if (!kGroups || g == 0) {
#pragma unroll
        for (int a = 0; a < kBXPer; ++a)
#pragma unroll
          for (int b = 0; b < kBDPer; ++b) acc[a][b] = 0.f;
      }
      const float* wp = coef_s + r * TX + c;
      const float* vp = vec_s + 4 * dg;
#pragma unroll 2
      for (int o = 0; o < gn; ++o) {
        const float4 w = *reinterpret_cast<const float4*>(wp);
        const float4 v0 = *reinterpret_cast<const float4*>(vp);
        const float4 v1 = *reinterpret_cast<const float4*>(vp + 4 * d_groups);
        const float wa[kBXPer] = {w.x, w.y, w.z, w.w};
        const float vb[kBDPer] = {v0.x, v0.y, v0.z, v0.w,
                                  v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int a = 0; a < kBXPer; ++a)
#pragma unroll
          for (int b = 0; b < kBDPer; ++b)
            acc[a][b] = fmaf(wa[a], vb[b], acc[a][b]);
        wp += tile;
        vp += dt;
      }
      if (kGroups && g != p.groups - 1) continue;

      OutT* dst = out + (((size_t)n * H + y0 + r) * W + x0 + c) * D + d_base;
#pragma unroll
      for (int a = 0; a < kBXPer; ++a) {
        if (c + a >= tx) break;
        if constexpr (sizeof(OutT) == 4) {  // halves 4 d_groups channels apart
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = channel_of<OutT>(dg, h, d_groups);
            const float v[4] = {acc[a][4 * h], acc[a][4 * h + 1],
                                acc[a][4 * h + 2], acc[a][4 * h + 3]};
            if (d < d_len)
              store4(dst + (size_t)a * D + d, v, min(4, d_len - d),
                     store_vec != 0);
          }
        } else if (n_valid > 0) {
          store8(dst + (size_t)a * D + kBDPer * dg, acc[a], n_valid,
                 store_vec);
        }
      }
    }
  }
}

template <typename OutT>
int launch_boxes(const void* boxes, const void* masks, const void* vecs,
                 void* out, int N, int O, int H, int W, int M, int D,
                 const BPlan& p, void* stream) {
  const long long blocks = (long long)N * p.n_bands * p.x_tiles;
  if (blocks >= (1LL << 31) || p.d_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int copy16 = M % 4 == 0 && aligned16(masks);
  const int vec16 = D % 4 == 0 && aligned16(vecs);
  // 2: one 16-byte store per pixel's 8 bf16 channels; 1: 16-byte f32 or
  // 8-byte bf16 stores; 0: element stores.
  int store_vec = 0;
  if (aligned16(out)) {
    if (sizeof(OutT) == 2 && D % 8 == 0) store_vec = 2;
    else if (D % 4 == 0) store_vec = 1;
  }
  auto kernel = p.groups > 1 ? compose_boxes_kernel<OutT, true>
                             : compose_boxes_kernel<OutT, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)blocks, (unsigned)p.d_tiles), p.threads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(boxes), static_cast<const float*>(masks),
          static_cast<const float*>(vecs), static_cast<OutT*>(out), O, H, W,
          M, D, p, copy16, vec16, store_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The weights entry (K2): dense, signed Wy and Wx given; nothing assumes
// tents.  Sums in f32 on the CUDA cores (the TPU kernel asks for HIGHEST
// precision; no TF32).
//
// What held the first port of this entry back (1.48 ms at b128 on an H100
// 80GB HBM3 at 700 W, 22% of its bound, slower than one torch.einsum): one
// block per output row recomputed every coefficient from device memory, so
// all of wx[n] (O * W * M * 4 = 131 KB) crossed L2 once per output row
// (2.15 GB at b128, twice the output), in loads 64 B apart across a warp's
// threads and in chains of M dependent loads; and each block's stores
// waited on its own arithmetic.  The design:
//
//   * blocks over tiles: one block per (image n, band of TH output rows,
//     tile of TX columns, channel tile of 128).  A block stages Wx once for
//     its band (TX columns), Wy once for its tile (TH rows) and the masks
//     once, so the bytes staged per output pixel are O * M * 4 * (M + TH +
//     TX) / (TH * TX).  The wrapper's weights_plan picks the (TH, TX)
//     with the least of them that fits; at b128 TH = TX = 32: 80 KB per
//     block, 0.17 GB in all, against 2.15 GB crossing L2 before;
//   * Wx, the masks and the tile's Wy rows staged in shared memory per
//     chunk of oc objects with coalesced cp.async copies (16 bytes where M
//     is a multiple of 4), two chunks in flight; each Wx row padded to S
//     floats, S / 4 odd, so the coefficient loop's 16-byte reads of eight
//     neighbouring rows hit eight distinct bank quads;
//   * coefficients from shared memory only: R = Wy[tile rows] @ mask (oc x
//     TH x M, four columns of R per thread), then warp[o, r, x] = R[o, r,
//     :] . Wx[o, x, :], one (o, x, 8 rows) per thread with eight
//     independent sums and R read by broadcast, into a (G, TH, TX) tile
//     that holds every object of the group;
//   * the output stage on registers: passes of PX consecutive pixels of the
//     tile (a row segment, or PX / TX whole rows), an 8 (x) by 4 (d) tile of
//     sums per thread, K = the group's objects, two broadcast and one
//     16-byte shared load feeding 32 FMAs;
//   * the write straight from registers with coalesced 16-byte st.global: a
//     thread does not wait for its stores, so the stores of one pass
//     overlap the FMAs of the next.  Staging each pass in shared memory for
//     cp.async.bulk stores was measured slower at b128 (0.6027 against
//     0.5433 ms, PERF.md): it adds a shared write, a proxy fence and a
//     barrier per pass, and its two stage buffers take the shared memory
//     that lets the plan stage fewer bytes;
//   * the index arithmetic of the copies and work items divides by no
//     runtime value: FastDiv multiplies and shifts;
//   * shared memory at most kSmemBudget bytes, two blocks per SM.  For very
//     many objects the plan falls back to groups of G < O objects whose
//     sums carry over in registers (a tile of one pass).
//
// What bounds it now (PERF.md, measured with variants of this kernel): the
// output stage alone runs near the write's rate, and the coefficient stage,
// short chains of shared loads, FMAs and barriers, adds to it rather than
// hiding under it; the two blocks of an SM do not overlap them.  Tried and
// withdrawn, none faster: bands of whole rows (more bytes staged), one
// persistent block per SM whose coefficient warps fill one of two buffers
// while its output warps store the other (handed over by mbarriers), bulk
// stores from shared memory, blocks started out of phase, the object
// vectors held in registers and coarser coefficient work items.
//
// No mbarrier: the only waits are the hardware's cp.async group waits.
// ---------------------------------------------------------------------------

constexpr int kWThreads = 256;
constexpr int kXPer = 8;        // output pixels per thread (along a row)
constexpr int kDPer = 4;        // channels per thread
constexpr int kMaxBand = 32;    // output rows per block
constexpr int kRowBlk = 8;      // rows of one coefficient work item
constexpr int kMaxChunk = 8;    // objects per staged chunk
constexpr int kMaxPX = 128;     // output pixels per pass

// How one call is cut.  The tile choice (TH, TX, G, oc, PX) is the
// caller's: ops/layout_kernel.py weights_plan picks it, with the shared
// memory formula of make_plan, and passes it to the launch.
struct WPlan {
  int TH;        // output rows per block
  int TX;        // output columns per block
  int G;         // objects per group (O but for very many objects)
  int oc;        // objects per staged chunk
  int PX;        // output pixels per pass
  int threads;   // d_groups * PX / kXPer
  int n_bands, x_tiles, d_tiles, groups;
  int smem;      // dynamic shared memory bytes
  int Mr;        // M rounded up to 4
  int S;         // padded Wx row, floats
  int d_groups;  // threads along the channel tile (4 channels each)
  int chunk_bytes;
  // The divisors of the kernel's index arithmetic.
  FastDiv by_q, by_tx, by_th, by_rb, by_dg, by_dt4, by_mr;
};

// The plan of a tile choice, and whether the kernel can run it: a thread's
// pixels in one row, passes tiling the tile, groups only with a tile of one
// pass, shared memory within kSmemBudget.
bool make_plan(int O, int H, int W, int M, int D, int TH, int TX, int G,
               int oc, int PX, WPlan* out) {
  WPlan p{};
  p.TH = TH, p.TX = TX, p.G = G, p.oc = oc, p.PX = PX;
  p.Mr = ceil_div(M, 4) * 4;
  p.S = p.Mr + ((p.Mr / 4) % 2 == 0 ? 4 : 0);
  p.d_tiles = ceil_div(D, kTileD);
  p.d_groups = ceil_div(min(D, kTileD), kDPer);
  p.threads = p.d_groups * (PX / kXPer);
  if (TH < 1 || TH > kMaxBand || TX < kXPer || TX % kXPer != 0 ||
      PX < kXPer || PX > kMaxPX || PX % kXPer != 0 ||
      p.threads > kWThreads || (TX % PX != 0 && PX % TX != 0) ||
      (TH * TX) % PX != 0 || G < 1 || G > O || oc < 1 ||
      oc > min(kMaxChunk, G))
    return false;
  p.n_bands = ceil_div(H, TH);
  p.x_tiles = ceil_div(W, TX);
  p.groups = ceil_div(O, G);
  if (p.groups > 1 && (TH != 1 || TX != PX)) return false;
  const long long chunk = 4LL * oc * (TX * p.S + M * p.Mr + TH * p.Mr);
  const long long smem = 4LL * G * TH * TX + 4LL * G * kDPer * p.d_groups +
                         2 * chunk + 4LL * oc * TH * p.Mr;
  if (smem > kSmemBudget) return false;
  p.chunk_bytes = (int)chunk;
  p.smem = (int)smem;
  p.by_q = fast_div(p.Mr / 4);
  p.by_tx = fast_div(TX);
  p.by_th = fast_div(TH);
  p.by_rb = fast_div(ceil_div(TH, kRowBlk));
  p.by_dg = fast_div(p.d_groups);
  p.by_dt4 = fast_div(kDPer * p.d_groups);
  p.by_mr = fast_div(p.Mr);
  *out = p;
  return true;
}

// Shared memory (floats): warp [G][TH][TX], vecs [G][4 d_groups], two
// staged chunks ({Wx [oc][TX][S], masks [oc][M][Mr], Wy [oc][TH][Mr]} each)
// and R [oc][TH][Mr].  Pixel p of the tile is (row p / TX, column p % TX).
template <typename OutT>
__global__ void __launch_bounds__(kWThreads, 2)
compose_weights_kernel(const float* __restrict__ wy,     // (N, O, H, M)
                       const float* __restrict__ wx,     // (N, O, W, M)
                       const float* __restrict__ masks,  // (N, O, M, M)
                       const float* __restrict__ vecs,   // (N, O, D)
                       OutT* __restrict__ out,           // (N, H, W, D)
                       int O, int H, int W, int M, int D, const WPlan p,
                       int copy16, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int TH = p.TH, TX = p.TX, Mr = p.Mr, S = p.S;
  const int d_groups = p.d_groups, nthreads = p.threads, PX = p.PX;
  const int row_blks = ceil_div(TH, kRowBlk);
  const int tile = TH * TX;
  const int Dt4 = kDPer * d_groups;
  float* warp_s = smem;
  float* vec_s = warp_s + p.G * tile;
  float* region = vec_s + p.G * Dt4;
  float* r_s = region + 2 * (p.chunk_bytes / 4);
  const uint32_t region_u = smem_u32(region);
  const uint32_t vec_u = smem_u32(vec_s);

  const int tid = threadIdx.x;
  const int per_img = p.n_bands * p.x_tiles;
  const int n = blockIdx.x / per_img;
  const int rem = blockIdx.x - n * per_img;
  const int band = rem / p.x_tiles;
  const int y0 = band * TH;
  const int x0 = (rem - band * p.x_tiles) * TX;
  const int th = min(TH, H - y0), tx = min(TX, W - x0);
  const int d_base = blockIdx.y * kTileD;
  const int d_len = min(kTileD, D - d_base);
  const int xgi = div_by(tid, p.by_dg);
  const int dgi = tid - xgi * d_groups;
  const int d0 = kDPer * dgi;
  const bool vec_ok = (D % 4) == 0;
  const int Q = Mr / 4;

  float acc[kXPer][kDPer];

  for (int g = 0; g < p.groups; ++g) {
    const int ob = g * p.G;
    const int gn = min(p.G, O - ob);
    const int n_chunks = ceil_div(gn, p.oc);
    const size_t no_g = (size_t)n * O + ob;
    if (g > 0) __syncthreads();  // the last group's readers are done

    // Chunk c of the group (objects c * oc ...) into staging buffer b.
    auto issue_chunk = [&](int c, int b) {
      const int ocn = min(p.oc, gn - c * p.oc);
      const size_t no = no_g + (size_t)c * p.oc;
      const uint32_t wx_d = region_u + b * p.chunk_bytes;
      const uint32_t mask_d = wx_d + 4 * p.oc * TX * S;
      const uint32_t wy_d = mask_d + 4 * p.oc * M * Mr;
      // Items k = (o, x or r, q or j): the copies past the tile's last
      // column or row are skipped.
      if (copy16) {  // M % 4 == 0, so Mr == M
        for (int k = tid; k < ocn * TX * Q; k += nthreads) {
          const int t = div_by(k, p.by_q), q = k - t * Q;
          const int o = div_by(t, p.by_tx), x = t - o * TX;
          if (x < tx)
            cp_async16(wx_d + 4 * ((o * TX + x) * S + 4 * q),
                       wx + ((no + o) * W + x0 + x) * M + 4 * q, 16);
        }
        for (int k = tid; k < ocn * M * Q; k += nthreads)
          cp_async16(mask_d + 16 * k, masks + no * M * M + 4 * k, 16);
        for (int k = tid; k < ocn * TH * Q; k += nthreads) {
          const int t = div_by(k, p.by_q), q = k - t * Q;
          const int o = div_by(t, p.by_th), r = t - o * TH;
          if (r < th)
            cp_async16(wy_d + 4 * ((o * TH + r) * Mr + 4 * q),
                       wy + ((no + o) * H + y0 + r) * M + 4 * q, 16);
        }
      } else {  // element copies; the row padding j >= M is zero-filled
        for (int k = tid; k < ocn * TX * Mr; k += nthreads) {
          const int t = div_by(k, p.by_mr), j = k - t * Mr;
          const int o = div_by(t, p.by_tx), x = t - o * TX;
          const bool ok = j < M;
          if (x < tx)
            cp_async4(wx_d + 4 * ((o * TX + x) * S + j),
                      ok ? wx + ((no + o) * W + x0 + x) * M + j : wx,
                      ok ? 4 : 0);
        }
        for (int k = tid; k < ocn * M * Mr; k += nthreads) {
          const int t = div_by(k, p.by_mr), j = k - t * Mr;  // t = o * M + i
          const bool ok = j < M;
          cp_async4(mask_d + 4 * k, ok ? masks + (no * M + t) * M + j : masks,
                    ok ? 4 : 0);
        }
        for (int k = tid; k < ocn * TH * Mr; k += nthreads) {
          const int t = div_by(k, p.by_mr), j = k - t * Mr;
          const int o = div_by(t, p.by_th), r = t - o * TH;
          const bool ok = j < M;
          if (r < th)
            cp_async4(wy_d + 4 * ((o * TH + r) * Mr + j),
                      ok ? wy + ((no + o) * H + y0 + r) * M + j : wy,
                      ok ? 4 : 0);
        }
      }
    };

    // The group's object vectors (zero past the channel tile), with chunk 0.
    if (vec16) {
      for (int k = tid; k < gn * d_groups; k += nthreads) {
        const int o = div_by(k, p.by_dg), q = k - o * d_groups;
        const bool ok = 4 * q < d_len;
        cp_async16(vec_u + 4 * (o * Dt4 + 4 * q),
                   ok ? vecs + (no_g + o) * D + d_base + 4 * q : vecs,
                   ok ? 16 : 0);
      }
    } else {
      for (int k = tid; k < gn * Dt4; k += nthreads) {
        const int o = div_by(k, p.by_dt4), dd = k - o * Dt4;
        const bool ok = dd < d_len;
        cp_async4(vec_u + 4 * k, ok ? vecs + (no_g + o) * D + d_base + dd : vecs,
                  ok ? 4 : 0);
      }
    }
    issue_chunk(0, 0);
    cp_async_commit();

    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        issue_chunk(c + 1, (c + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c has landed
      const int ocn = min(p.oc, gn - c * p.oc);
      const float* wx_c = region + (c & 1) * (p.chunk_bytes / 4);
      const float* mask_c = wx_c + p.oc * TX * S;
      const float* wy_c = mask_c + p.oc * M * Mr;

      // R[o, r, 4 jq .. 4 jq + 3] = Wy[o, r, :] @ mask[o][:, 4 jq ..], zero
      // past the image's last row (and past M: the mask's padding is 0).
      for (int k = tid; k < ocn * TH * Q; k += nthreads) {
        const int t = div_by(k, p.by_q);
        const int o = div_by(t, p.by_th), r = t - o * TH;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < th) {
          const float* a = wy_c + (o * TH + r) * Mr;
          const float* b = mask_c + o * M * Mr + 4 * (k - t * Q);
#pragma unroll 4
          for (int i = 0; i < M; ++i) {
            const float ai = a[i];
            const float4 bi = *reinterpret_cast<const float4*>(b + i * Mr);
            s.x = fmaf(ai, bi.x, s.x);
            s.y = fmaf(ai, bi.y, s.y);
            s.z = fmaf(ai, bi.z, s.z);
            s.w = fmaf(ai, bi.w, s.w);
          }
        }
        *reinterpret_cast<float4*>(r_s + 4 * k) = s;
      }
      __syncthreads();

      // warp[o, r, x] = R[o, r, :] . Wx[o, x, :] for kRowBlk rows at a
      // time, zero past the tile's last column.
      for (int k = tid; k < ocn * row_blks * TX; k += nthreads) {
        const int t = div_by(k, p.by_tx), x = k - t * TX;
        const int o = div_by(t, p.by_rb), r0 = (t - o * row_blks) * kRowBlk;
        const int nr = min(kRowBlk, TH - r0);
        float w[kRowBlk];
#pragma unroll
        for (int r = 0; r < kRowBlk; ++r) w[r] = 0.f;
        if (x < tx) {
          const float* src = wx_c + (o * TX + x) * S;
          const float* rr = r_s + (o * TH + r0) * Mr;
#pragma unroll
          for (int q = 0; q < kMaxM / 4; ++q) {
            if (q < Q) {
              const float4 v = *reinterpret_cast<const float4*>(src + 4 * q);
#pragma unroll
              for (int r = 0; r < kRowBlk; ++r) {
                if (r < nr) {
                  const float4 u =
                      *reinterpret_cast<const float4*>(rr + r * Mr + 4 * q);
                  w[r] = fmaf(u.x, v.x, w[r]);
                  w[r] = fmaf(u.y, v.y, w[r]);
                  w[r] = fmaf(u.z, v.z, w[r]);
                  w[r] = fmaf(u.w, v.w, w[r]);
                }
              }
            }
          }
        }
        float* dst = warp_s + (c * p.oc + o) * tile + r0 * TX + x;
#pragma unroll
        for (int r = 0; r < kRowBlk; ++r)
          if (r < nr) dst[r * TX] = w[r];
      }
      __syncthreads();  // buffer c & 1 and R are free again
    }

    // Output stage: passes of PX consecutive pixels of the tile.
    for (int p0 = 0; p0 < tile; p0 += PX) {
      const int p_row = div_by(p0, p.by_tx);
      if (p_row >= th) break;                              // past the last row
      if (TX >= PX && p0 - p_row * TX >= tx) continue;     // past the last column
      if (g == 0) {
#pragma unroll
        for (int a = 0; a < kXPer; ++a)
#pragma unroll
          for (int b = 0; b < kDPer; ++b) acc[a][b] = 0.f;
      }
      const float* wp = warp_s + p0 + kXPer * xgi;
      const float* vp = vec_s + d0;
#pragma unroll 4
      for (int o = 0; o < gn; ++o) {
        const float4 w0 = *reinterpret_cast<const float4*>(wp);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
        const float4 vv = *reinterpret_cast<const float4*>(vp);
        const float wa[kXPer] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
        const float vb[kDPer] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int a = 0; a < kXPer; ++a)
#pragma unroll
          for (int b = 0; b < kDPer; ++b)
            acc[a][b] = fmaf(wa[a], vb[b], acc[a][b]);
        wp += tile;
        vp += Dt4;
      }
      if (g != p.groups - 1) continue;

      // This thread's kXPer pixels lie in one row (TX % kXPer == 0).
      const int pix = p0 + kXPer * xgi;
      const int r = div_by(pix, p.by_tx), c = pix - r * TX;
      if (r < th) {
        const int n_valid = min(kDPer, d_len - d0);
        if (n_valid > 0) {
#pragma unroll
          for (int a = 0; a < kXPer; ++a) {
            if (c + a < tx)
              store4(out + (((size_t)n * H + y0 + r) * W + x0 + c + a) * D +
                         d_base + d0,
                     acc[a], n_valid, vec_ok);
          }
        }
      }
    }
  }
}

template <typename OutT>
int launch_weights(const void* wy, const void* wx, const void* masks,
                   const void* vecs, void* out, int N, int O, int H, int W,
                   int M, int D, const WPlan& p, void* stream) {
  const long long blocks = (long long)N * p.n_bands * p.x_tiles;
  if (blocks >= (1LL << 31) || p.d_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int copy16 =
      M % 4 == 0 && aligned16(wy) && aligned16(wx) && aligned16(masks);
  const int vec16 = D % 4 == 0 && aligned16(vecs);
  const cudaError_t err = cudaFuncSetAttribute(
      compose_weights_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  compose_weights_kernel<OutT>
      <<<dim3((unsigned)blocks, (unsigned)p.d_tiles), p.threads, p.smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(wy), static_cast<const float*>(wx),
          static_cast<const float*>(masks), static_cast<const float*>(vecs),
          static_cast<OutT*>(out), O, H, W, M, D, p, copy16, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tent weights from the boxes (N, O, 4) [x0, y0, x1, y1]; the tile choice
// TH, TX, G of ops/layout_kernel.py boxes_plan.  A choice the kernel cannot
// run is refused with cudaErrorInvalidValue.
int sg2im_layout_compose_boxes(const void* boxes, const void* masks,
                               const void* vecs, void* out, int N, int O,
                               int H, int W, int M, int D, int out_bf16,
                               int TH, int TX, int G, void* stream) {
  BPlan p;
  if (M < 1 || M > kMaxM || !make_boxes_plan(O, H, W, M, D, TH, TX, G, &p))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_boxes<__nv_bfloat16>(boxes, masks, vecs, out, N, O, H, W,
                                       M, D, p, stream);
  return launch_boxes<float>(boxes, masks, vecs, out, N, O, H, W, M, D, p,
                             stream);
}

// Dense weights given: wy (N, O, H, M), wx (N, O, W, M); the tile choice
// TH, TX, G, oc, PX of ops/layout_kernel.py weights_plan.  A choice
// the kernel cannot run is refused with cudaErrorInvalidValue.
int sg2im_layout_compose_weights(const void* wy, const void* wx,
                                 const void* masks, const void* vecs,
                                 void* out, int N, int O, int H, int W, int M,
                                 int D, int out_bf16, int TH, int TX, int G,
                                 int oc, int PX, void* stream) {
  WPlan p;
  if (M < 1 || M > kMaxM || !make_plan(O, H, W, M, D, TH, TX, G, oc, PX, &p))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_weights<__nv_bfloat16>(wy, wx, masks, vecs, out, N, O, H, W,
                                         M, D, p, stream);
  return launch_weights<float>(wy, wx, masks, vecs, out, N, O, H, W, M, D, p,
                               stream);
}

}  // extern "C"
