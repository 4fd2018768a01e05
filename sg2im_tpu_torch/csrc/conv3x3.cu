// 3x3 'same' convolution for Hopper (sm_90a), NHWC, on the tensor cores.
//
//   out[n, y, x, co] = epilogue( sum_{ky, kx, ci}
//                          x[n, y + ky - 1, x + kx - 1, ci] * w[co, ci, ky, kx] )
//
// with x zero outside the image ('same' padding).  Replaces the Pallas TPU
// kernel of scripts/proto_pallas_conv.py (make_conv_kernel, built and called
// by build): a row tile with its halo in fast memory, im2col built on chip,
// one matrix product per tile, and an optional scale * acc + bias ->
// LeakyReLU(0.2) epilogue.  Two entries, one template:
//   sg2im_conv3x3_bf16  that kernel: bf16 in, f32 sums, optional epilogue,
//                       f32 or bf16 out;
//   sg2im_conv3x3_s8    the int8 conv of the turbo tier (sg2im_tpu/nn/crn.py
//                       _conv_int8): int8 in, exact int32 sums, out = f32
//                       acc * dq[co] (dq = activation scale * weight scale).
//
// What bounds it on this card: the tensor cores.  The CRN shapes have
// K = 9 * Cin of 1152 to 6048 and 64 to 256 output channels, far above the
// card's ~295 (bf16) or ~590 (int8) operations per byte of device memory,
// except the int8 s4 conv1, whose f32 output write bounds it.  So the design
// is a GEMM mainloop that keeps the tensor cores fed:
//   * implicit GEMM: M = 128 output pixels (a TH x TW tile of one image,
//     TH * TW <= 128), N = all of Co in one tile where Co <= 256 (BN = 128
//     or 256), K = 9 taps x Cin, walked as (Cin chunk of 128 bytes, tap)
//     steps.  Nothing of the im2col matrix goes to device memory;
//   * A, the activations, by TMA: one 4-D box (128 bytes of channels, TW,
//     TH, 1) of a tensor map over the NHWC input per step, its origin
//     already shifted by the tap (w0 - 1 + kx, h0 - 1 + ky).  TMA fills
//     coordinates outside the tensor (-1, H, W, channels past Cin) with
//     zeros: that is the 'same' padding and the Cin tail.  Every tap's A is
//     then a plain 128-row K-major tile in the 128-byte swizzled layout that
//     wgmma reads by descriptor.  The cost: the window is read from L2
//     nine times per chunk (from device memory about once).  The other
//     route, A from registers through ldmatrix (wgmma's RS form), would
//     spend the consumer warps' issue slots on loads;
//   * B, the weights, packed once per call by the wrapper
//     (ops/conv_kernel.py pack_weights) as (Co tile, chunk, tap, BN, 128 B)
//     tiles, zero-padded and pre-swizzled, so each step's B arrives with one
//     bulk copy: no per-element loads, no ragged-edge branches;
//   * a ring of 4 (BN 256, one block per SM) or 3 (BN 128, two blocks
//     per SM) stages of (A, B) tiles in shared memory with
//     full / empty mbarriers; one producer warp keeps
//     the copies in flight, two consumer warpgroups each run
//     wgmma.mma_async m64nBNk16 (bf16 -> f32) or m64nBNk32 (s8 -> s32) on
//     64 of the 128 pixels, one wgmma group in flight behind the next;
//   * epilogue in registers (dq, or scale + bias + LeakyReLU, with the same
//     roundings as the plain version), staged through the ring's shared
//     memory so the stores run along a pixel's channels, 16 bytes a thread
//     where Co allows it.
// Tried on the card and withdrawn, since neither was faster on the turbo
// shapes (PERF.md, Findings): clusters of two blocks multicasting each weight
// tile (half the L2 reads of B), and a persistent grid whose ring runs on
// across tiles with the epilogue stored from registers.
//
// Plain C interface (loaded with ctypes).  Each entry returns
// cudaGetLastError() after its launch on the caller's stream, a cudaError_t
// for arguments it refuses, or minus the CUresult of cuTensorMapEncodeTiled.
// The wrapper passes the tile plan (TH, TW, BN) it packed the weights for.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kTileM = 128;        // output pixels per block
constexpr int kChunkBytes = 128;   // channel bytes per step: one swizzle row
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kATileBytes = kTileM * kChunkBytes;

template <int BN>
struct Cfg {
  static constexpr int kBTileBytes = BN * kChunkBytes;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  // BN 256: one block per SM, 4 stages (its 128 accumulators per consumer
  // thread leave no registers for a second block).  BN 128: two blocks per
  // SM, 3 stages each, so one block's ring fill and epilogue overlap the
  // other's products.
  static constexpr int kBlocksPerSM = BN == 256 ? 1 : 2;
  static constexpr int kStages = BN == 256 ? 4 : 3;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kStageLd = BN + 4;  // epilogue staging row (floats)
  // 1024 for aligning the ring (the 128-byte swizzle repeats every 1 KB),
  // then the full and empty barriers.
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(kTileM * kStageLd * 4 <= kRingBytes,
                "the epilogue staging fits in the ring");
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// outlasts ~2^35 clocks (some 20 s) traps, so a broken pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    if (clock64() - start > (1LL << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Descriptor of a K-major operand of 128-byte rows in the 128-byte swizzle
// (what TMA's SWIZZLE_128B writes): 8-row groups 1024 bytes apart.  A
// k-step of 32 bytes advances the start address within the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16 bf16 -> f32 (float accumulators) and m64nNk32
// s8 -> s32 (int accumulators), N = 2 * registers, both operands K-major in
// shared memory, D += A * B.

__device__ __forceinline__ void wgmma(uint64_t da, uint64_t db, float (&d)[64]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(uint64_t da, uint64_t db, float (&d)[128]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(uint64_t da, uint64_t db, int (&d)[64]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(uint64_t da, uint64_t db, int (&d)[128]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The kernel.
// ---------------------------------------------------------------------------

enum Epilogue { kNone = 0, kScaleBiasLeaky = 1, kDequant = 2 };

// Elem: uint16_t (bf16 bits) or int8_t.
template <typename Elem, int BN>
__global__ void __launch_bounds__(kThreads, Cfg<BN>::kBlocksPerSM)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,  // NHWC input
               const uint8_t* __restrict__ wpack,  // packed weight tiles
               const float* __restrict__ p0,       // scale or dq (Co,)
               const float* __restrict__ p1,       // bias (Co,)
               void* __restrict__ out,             // (N, H, W, Co)
               int H, int W, int Co, int TH, int TW, int tiles_h,
               int tiles_w, int n_chunks, int epi, int out_bf16) {
  using C = Cfg<BN>;
  constexpr bool kInt8 = std::is_same<Elem, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kRegs = BN / 2;  // accumulators per thread: 64 x BN / 128
  constexpr int kChunkElems = kChunkBytes / (int)sizeof(Elem);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full_s = ring_s + C::kRingBytes;  // kStages barriers
  const uint32_t empty_s = full_s + C::kStages * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles = tiles_h * tiles_w;
  const int n = blockIdx.x / tiles;
  const int t = blockIdx.x - n * tiles;
  const int h0 = (t / tiles_w) * TH;
  const int w0 = (t % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int steps = n_chunks * 9;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_s + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty_s + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring's copies in flight.
    if (lane == 0) {
      const uint8_t* wsrc =
          wpack + (size_t)blockIdx.y * steps * C::kBTileBytes;
      const uint32_t bytes = (uint32_t)(TH * TW * kChunkBytes) +
                             (uint32_t)C::kBTileBytes;
      for (int it = 0; it < steps; ++it) {
        const int s = it % C::kStages;
        const uint32_t round = (uint32_t)(it / C::kStages);
        mbar_wait(empty_s + 8 * s, (round & 1u) ^ 1u);
        const uint32_t a_dst = ring_s + s * C::kStageBytes;
        const int chunk = it / 9, tap = it - chunk * 9;
        const int ky = tap / 3, kx = tap - ky * 3;
        mbar_expect_tx(full_s + 8 * s, bytes);
        tma_load_4d(a_dst, &xmap, full_s + 8 * s, chunk * kChunkElems,
                    w0 - 1 + kx, h0 - 1 + ky, n);
        bulk_load(a_dst + kATileBytes, wsrc + (size_t)it * C::kBTileBytes,
                  C::kBTileBytes, full_s + 8 * s);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns pixel rows 64 wg .. 64 wg + 63.
  const int wg = warp >> 2;
  Acc acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = Acc(0);

  for (int it = 0; it < steps; ++it) {
    const int s = it % C::kStages;
    mbar_wait(full_s + 8 * s, (uint32_t)(it / C::kStages) & 1u);
    const uint32_t a = ring_s + s * C::kStageBytes + wg * 64 * kChunkBytes;
    const uint32_t b = ring_s + s * C::kStageBytes + kATileBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunkBytes / 32; ++k)
      wgmma(desc_sw128(a + 32 * k), desc_sw128(b + 32 * k), acc);
    wgmma_commit();
    fence_acc(acc);
    // The group before this one has finished reading its stage.
    wgmma_wait<1>();
    fence_acc(acc);
    if (it > 0 && lane == 0)
      mbar_arrive(empty_s + 8 * ((it - 1) % C::kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue.  Accumulator i of a thread: row 16 (warp % 4) + lane / 4
  // (+ 8 for i % 4 >= 2) of its warpgroup's 64, column 8 (i / 4) +
  // 2 (lane % 4) + i % 2.
  consumers_sync();  // every wgmma has finished reading the ring
  float* stage = reinterpret_cast<float*>(ring);
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)acc[4 * j + i];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + col + e;
      if (co >= Co) continue;
      if (kInt8) {
        const float dq = __ldg(p0 + co);
        v[e] = __fmul_rn(v[e], dq);
        v[e + 2] = __fmul_rn(v[e + 2], dq);
      } else if (epi == kScaleBiasLeaky) {
        const float sc = __ldg(p0 + co), bi = __ldg(p1 + co);
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          float y = __fadd_rn(__fmul_rn(v[e + h], sc), bi);
          v[e + h] = y > 0.f ? y : __fmul_rn(0.2f, y);
        }
      }
    }
    *reinterpret_cast<float2*>(stage + row * C::kStageLd + col) =
        make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(stage + (row + 8) * C::kStageLd + col) =
        make_float2(v[2], v[3]);
  }
  consumers_sync();

  // Stores: consecutive threads along a pixel's channels, then the next
  // pixel; 16-byte units where Co keeps every row 16-byte aligned.
  const int nco = Co - co0 < BN ? Co - co0 : BN;
  const int64_t img = (int64_t)n * H * W;
  const int unit = out_bf16 ? 8 : 4;  // elements per 16 bytes
  const bool vec = Co % unit == 0;
  const int per_row = vec ? nco / unit : nco;
  for (int idx = tid; idx < kTileM * per_row; idx += kConsumers) {
    const int m = idx / per_row, u = idx - m * per_row;
    const int r = m / TW, c = m - r * TW;
    const int y = h0 + r, xc = w0 + c;
    if (r >= TH || y >= H || xc >= W) continue;
    const int64_t base = (img + (int64_t)y * W + xc) * Co + co0;
    const float* src = stage + m * C::kStageLd;
    if (vec && out_bf16) {
      const float4 lo = *reinterpret_cast<const float4*>(src + 8 * u);
      const float4 hi = *reinterpret_cast<const float4*>(src + 8 * u + 4);
      __nv_bfloat162 p[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                             __floats2bfloat162_rn(lo.z, lo.w),
                             __floats2bfloat162_rn(hi.x, hi.y),
                             __floats2bfloat162_rn(hi.z, hi.w)};
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + base +
                                8 * u) = *reinterpret_cast<uint4*>(p);
    } else if (vec) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + base + 4 * u) =
          *reinterpret_cast<const float4*>(src + 4 * u);
    } else if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[base + u] = __float2bfloat16_rn(src[u]);
    } else {
      static_cast<float*>(out)[base + u] = src[u];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename Elem, int BN>
int launch(const void* x, const void* w, const void* p0, const void* p1,
           void* out, int N, int H, int W, int Cin, int Co, int TH, int TW,
           int epi, int out_bf16, void* stream) {
  using C = Cfg<BN>;
  constexpr int es = (int)sizeof(Elem);
  // TMA wants a 16-byte aligned base and row pitch (the wrapper pads the
  // input otherwise); the weight tiles are copied in 16-byte units.
  if (TH < 1 || TW < 1 || TH * TW > kTileM || (Cin * es) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const long long blocks = (long long)N * tiles_h * tiles_w;
  const int co_tiles = (Co + BN - 1) / BN;
  const int n_chunks = (Cin * es + kChunkBytes - 1) / kChunkBytes;
  if (blocks >= (1LL << 31) || co_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * es,
                                 (cuuint64_t)W * Cin * es,
                                 (cuuint64_t)H * W * Cin * es};
  const cuuint32_t box[4] = {(cuuint32_t)(kChunkBytes / es), (cuuint32_t)TW,
                             (cuuint32_t)TH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult res = encode(
      &xmap,
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      4, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = conv3x3_kernel<Elem, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)blocks, (unsigned)co_tiles), kThreads,
           C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const uint8_t*>(w), static_cast<const float*>(p0),
      static_cast<const float*>(p1), out, H, W, Co, TH, TW, tiles_h, tiles_w,
      n_chunks, epi, out_bf16);
  return (int)cudaGetLastError();
}

template <typename Elem>
int launch_bn(int BN, const void* x, const void* w, const void* p0,
              const void* p1, void* out, int N, int H, int W, int Cin, int Co,
              int TH, int TW, int epi, int out_bf16, void* stream) {
  switch (BN) {
    case 128:
      return launch<Elem, 128>(x, w, p0, p1, out, N, H, W, Cin, Co, TH, TW,
                               epi, out_bf16, stream);
    case 256:
      return launch<Elem, 256>(x, w, p0, p1, out, N, H, W, Cin, Co, TH, TW,
                               epi, out_bf16, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4: bf16 x (N, H, W, Cin), weight tiles packed for (TH, TW, BN); with
// `epilogue` the f32 sums go through scale * acc + bias -> LeakyReLU(0.2)
// (scale, bias (Co,) f32).  out (N, H, W, Co) f32, or bf16 with out_bf16.
int sg2im_conv3x3_bf16(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W,
                       int Cin, int Co, int TH, int TW, int BN, int epilogue,
                       int out_bf16, void* stream) {
  return launch_bn<uint16_t>(BN, x, w, scale, bias, out, N, H, W, Cin, Co, TH,
                             TW, epilogue ? kScaleBiasLeaky : kNone,
                             out_bf16, stream);
}

// The turbo tier's int8 conv: int8 x (N, H, W, Cin), weight tiles packed
// for (TH, TW, BN); out = f32(int32 sum) * dq[co], f32 (N, H, W, Co).
int sg2im_conv3x3_s8(const void* x, const void* w, const void* dq, void* out,
                     int N, int H, int W, int Cin, int Co, int TH, int TW,
                     int BN, void* stream) {
  return launch_bn<int8_t>(BN, x, w, dq, nullptr, out, N, H, W, Cin, Co, TH,
                           TW, kDequant, 0, stream);
}

}  // extern "C"
