// Layout compose for Hopper (sm_90a): the mask-modulated scene layout.
//
//   out[n, y, x, d] = sum_o warp[n, o, y, x] * vecs[n, o, d]
//   warp[n, o]      = Wy[n, o] @ mask[n, o] @ Wx[n, o]^T      (H, W)
//
// Replaces the two Pallas TPU kernels of
// sg2im_tpu/ops/pallas/layout_kernel.py, one kernel each:
//   sg2im_layout_compose_boxes   <- fused_layout_compose_v2 / _pallas_compose_v2
//     (:265, :241; tent weights built in the kernel from the raw boxes):
//     compose_boxes_kernel below;
//   sg2im_layout_compose_weights <- fused_layout_compose / _pallas_compose
//     (:125, :89; dense Wy (N,O,H,M) and Wx (N,O,W,M) given):
//     compose_weights_kernel below.
//
// What bounds both on the card: the output write.  At the flagship shape
// (N=128, O=16, H=W=128, D=128) the f32 output is 1.07 GB against about
// 10 GFLOP of f32 FMAs, so at 3.35 TB/s the write alone takes ~0.32 ms
// while the arithmetic, at 67 TFLOP/s, takes ~0.15 ms.  Neither kernel
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

// ---------------------------------------------------------------------------
// The boxes entry (K1).
//
//   * each block builds the warp coefficients of its output row in shared
//     memory;
//   * stages the image's object vectors (O x D) in shared memory and keeps a
//     4 (x) by 4 (d) tile of sums per thread in registers, so each pair of
//     16-byte shared loads feeds 16 FMAs;
//   * walks (x, d) with d fastest, so a warp's NHWC stores are whole
//     contiguous 16-byte runs (coalesced), in f32 or bf16.
//
// Tent weights (sg2im_tpu/ops/sampling.py:32-50): w[j] = max(0, 1 - |s - j|)
// with non-finite values set to 0.  For one source coordinate s at most two
// taps are non-zero, at floor(s) and floor(s) + 1, and taps outside
// [0, M - 1] are zero; a non-finite s (a degenerate box, hi == lo, gives
// 0/0 or x/0) gives an all-zero row.  So the warp is a 2x2 bilinear sample
// of the mask, each tap weight computed with the same expression as the
// reference.  Build without fast math: the non-finite test is part of the
// contract.
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 256;
constexpr int kObjChunk = 32;   // objects staged in shared memory at once
constexpr int kMaxTileX = 128;  // output columns per tile

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

__device__ __forceinline__ float mask_at(const float* __restrict__ m, int M,
                                         int i, int j) {
  return (i >= 0 && i < M && j >= 0 && j < M) ? __ldg(m + i * M + j) : 0.f;
}

// One block per (image n, output row y, channel tile).  Threads form a
// (tile_x / 4) x (d groups) grid; each owns 4 columns x 4 channels.
template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
compose_boxes_kernel(const float* __restrict__ boxes,  // (N, O, 4)
                     const float* __restrict__ masks,  // (N, O, M, M)
                     const float* __restrict__ vecs,   // (N, O, D)
                     OutT* __restrict__ out,           // (N, H, W, D)
                     int O, int H, int W, int M, int D, int tile_x,
                     int d_groups) {
  __shared__ __align__(16) float warp_s[kObjChunk][kMaxTileX];
  __shared__ __align__(16) float vec_s[kObjChunk][kTileD];
  __shared__ int ytap_j0[kObjChunk];  // the row's taps
  __shared__ float ytap_w0[kObjChunk];
  __shared__ float ytap_w1[kObjChunk];

  const int n = blockIdx.x / H;
  const int y = blockIdx.x - n * H;
  const int d_base = blockIdx.y * kTileD;
  const int d_len = min(kTileD, D - d_base);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int dgi = tid % d_groups;
  const int xgi = tid / d_groups;
  const int n_chunks = (O + kObjChunk - 1) / kObjChunk;
  const bool vec_ok = (D % 4) == 0;
  const int d0 = 4 * dgi;  // within the channel tile

  for (int xt = 0; xt < W; xt += tile_x) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int ob = c * kObjChunk;
      const int oc_n = min(kObjChunk, O - ob);
      __syncthreads();  // every reader of the previous shared tiles is done

      // Per-object staging: the vectors and the row's taps.  They depend
      // on y but not on the column tile, so with one chunk they are staged
      // once per block.
      if (n_chunks > 1 || xt == 0) {
        for (int k = tid; k < kObjChunk * kTileD; k += nthreads) {
          const int oc = k / kTileD, dd = k - oc * kTileD;
          float v = 0.f;
          if (oc < oc_n && dd < d_len)
            v = __ldg(vecs + ((size_t)n * O + ob + oc) * D + d_base + dd);
          vec_s[oc][dd] = v;
        }
        for (int oc = tid; oc < oc_n; oc += nthreads) {
          const float* b = boxes + ((size_t)n * O + ob + oc) * 4;
          const Taps t = tent_taps(src_coord(y, H, b[1], b[3], M), M);
          ytap_j0[oc] = t.j0;
          ytap_w0[oc] = t.w0;
          ytap_w1[oc] = t.w1;
        }
        __syncthreads();
      }

      // Warp coefficients of this row, chunk and column tile.
      for (int k = tid; k < oc_n * tile_x; k += nthreads) {
        const int oc = k / tile_x, xx = k - oc * tile_x;
        const int x = xt + xx;
        float w = 0.f;
        if (x < W) {
          const size_t no = (size_t)n * O + ob + oc;
          const float* b = boxes + no * 4;
          const Taps tx = tent_taps(src_coord(x, W, b[0], b[2], M), M);
          const float* m = masks + no * M * M;
          const int i0 = ytap_j0[oc];
          const float wy0 = ytap_w0[oc], wy1 = ytap_w1[oc];
          const float t0 = wy0 * mask_at(m, M, i0, tx.j0) +
                           wy1 * mask_at(m, M, i0 + 1, tx.j0);
          const float t1 = wy0 * mask_at(m, M, i0, tx.j0 + 1) +
                           wy1 * mask_at(m, M, i0 + 1, tx.j0 + 1);
          w = t0 * tx.w0 + t1 * tx.w1;
        }
        warp_s[oc][xx] = w;
      }
      __syncthreads();

      for (int oc = 0; oc < oc_n; ++oc) {
        const float4 wv = *reinterpret_cast<const float4*>(&warp_s[oc][4 * xgi]);
        const float4 vv = *reinterpret_cast<const float4*>(&vec_s[oc][d0]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        const float vb[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += wa[a] * vb[b];
      }
    }

    const int n_valid = min(4, d_len - d0);
    if (n_valid > 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int x = xt + 4 * xgi + a;
        if (x < W) {
          OutT* dst = out + (((size_t)n * H + y) * W + x) * D + d_base + d0;
          store4(dst, acc[a], n_valid, vec_ok);
        }
      }
    }
  }
}

int launch_boxes(const void* boxes, const void* masks, const void* vecs,
                 void* out, int N, int O, int H, int W, int M, int D,
                 int out_bf16, void* stream) {
  // Threads: d_groups (4 channels each, up to one 128-channel tile) times
  // x groups (4 columns each), at most 256.
  const int d_groups = (min(D, kTileD) + 3) / 4;
  const int x_groups = min(kMaxTileX / 4, max(1, kMaxThreads / d_groups));
  const dim3 block(d_groups * x_groups);
  const dim3 grid((unsigned)(N * H), (unsigned)((D + kTileD - 1) / kTileD));
  const int tile_x = 4 * x_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const float* m = static_cast<const float*>(masks);
  const float* v = static_cast<const float*>(vecs);
  if (out_bf16) {
    compose_boxes_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        b, m, v, static_cast<__nv_bfloat16*>(out), O, H, W, M, D, tile_x,
        d_groups);
  } else {
    compose_boxes_kernel<float><<<grid, block, 0, s>>>(
        b, m, v, static_cast<float*>(out), O, H, W, M, D, tile_x, d_groups);
  }
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
// Two blocks per SM: (228 KB - 2 x 1 KB reserved) / 2.
constexpr int kSmemBudget = 115712;

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

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
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

// Tent weights from the boxes (N, O, 4) [x0, y0, x1, y1].
int sg2im_layout_compose_boxes(const void* boxes, const void* masks,
                               const void* vecs, void* out, int N, int O,
                               int H, int W, int M, int D, int out_bf16,
                               void* stream) {
  return launch_boxes(boxes, masks, vecs, out, N, O, H, W, M, D, out_bf16,
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
