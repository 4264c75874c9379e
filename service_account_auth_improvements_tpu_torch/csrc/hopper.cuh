// Hopper (sm_90a) building blocks shared by the port's attention kernels
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu): mbarriers, TMA loads, wgmma
// descriptors and instructions, setmaxnreg, and the host-side tensor maps.
// Raw inline PTX, no CUTLASS: the whole header compiles in seconds.
//
// Conventions of the kernels that use it:
// - A tile of R rows of bf16 with a head dim D (a multiple of 64, up to
//   512) lies in shared memory as D / 64 "column blocks" of R rows x 128
//   bytes, each written by one TMA box (or all of them by one box of a
//   5-D map, tmap_bf16_tile) with the 128-byte swizzle; every column block
//   starts on a 1024-byte boundary (one swizzle atom = 8 rows x 128 bytes).
// - K-major operand (the reduced dimension is the head dim, contiguous):
//   SBO = 1024 bytes (next group of 8 rows), LBO unused; a k step of 16
//   bf16 adds 32 bytes to the start address inside a column block.
// - MN-major B operand (the reduced dimension is the row index, e.g. keys
//   for P V): SBO = 1024 bytes (next 8 rows along k), LBO = the column
//   block stride (next 64 columns along n); a k step of 16 rows adds 2048
//   bytes; the instruction's transpose bit for B is set.
// - Accumulator fragments (PTX ISA, wgmma .m64nNk16, f32 D): warp w of the
//   warpgroup owns rows 16w + g and 16w + g + 8 (g = lane / 4); register
//   4j + e holds column 8j + 2 (lane % 4) + (e & 1) of row 16w + g + 8 (e / 2).
//   The bf16 A fragment of k chunk kk (registers a0..a3) is the same
//   layout re-packed: a0 = {d[8kk], d[8kk+1]}, a1 = {d[8kk+2], d[8kk+3]},
//   a2 = {d[8kk+4], d[8kk+5]}, a3 = {d[8kk+6], d[8kk+7]}: no shuffles.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace hopper {

// ------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A waiter that spins longer than this many SM cycles (over two seconds on
// an H100; every kernel here runs for milliseconds) traps instead of
// hanging: a wrong phase parity becomes a launch error, not a stuck card.
constexpr long long kWaitTrapCycles = 1ll << 32;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Raise the transaction count of the current phase without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Whether the phase of `bar` whose parity is `parity` has completed, without
// waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of `bar` whose parity is `parity` has completed
// (a fresh barrier is in phase 0, so waiting on parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// TMA: one box of `map` at the given coordinates (innermost first) into
// shared memory at `dst`, completing `bytes` of `bar`'s transaction count.
// Rows outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TMA through a 5-D map (tmap_bf16_tile): one box is a whole tile, every
// column block of it.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Register rebalancing between warpgroups; every warp of the warpgroup
// executes it, in a branch that never reconverges with the other role.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Pin registers in program order around the asynchronous wgmma: the
// compiler may neither read an accumulator before the wait that completes
// it, nor write one (or an A fragment) after the fence that orders it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// One wgmma m64nNk16, bf16 in, f32 accumulate. The descriptors' start
// addresses are advanced inside the asm by compile-time offsets (in 16-byte
// units), so a chain of k steps holds one base descriptor per operand in
// registers, not one per step.
//   WgmmaSS<N, OA, OB>: A and B from shared memory, both K-major;
//                       `accumulate` 0 overwrites D.
//   WgmmaRST<N, OB>:    A from registers, B from shared memory MN-major (the
//                       transpose bit is set).
template <int N, int OA, int OB>
struct WgmmaSS;
template <int N, int OB>
struct WgmmaRST;

template <int OA, int OB>
struct WgmmaSS<8, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "add.s64 da, %4, %7;\nadd.s64 db, %5, %8;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OA, int OB>
struct WgmmaSS<16, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "add.s64 da, %8, %11;\nadd.s64 db, %9, %12;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OA, int OB>
struct WgmmaSS<32, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "add.s64 da, %16, %19;\nadd.s64 db, %17, %20;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OA, int OB>
struct WgmmaSS<64, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "add.s64 da, %32, %35;\nadd.s64 db, %33, %36;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OA, int OB>
struct WgmmaSS<80, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %42, 0;\n"
        "add.s64 da, %40, %43;\nadd.s64 db, %41, %44;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39}, "
        "da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OA, int OB>
struct WgmmaSS<96, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "add.s64 da, %48, %51;\nadd.s64 db, %49, %52;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47}, "
        "da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OB>
struct WgmmaRST<64, OB> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "add.s64 db, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB),
          "r"(accumulate));
  }
};

template <int OA, int OB>
struct WgmmaSS<128, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

template <int OB>
struct WgmmaRST<128, OB> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "add.s64 db, %68, %69;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB),
          "r"(accumulate));
  }
};

// D (64 x N) (+)= A (64 x 16 KSTEPS) B (16 KSTEPS x N), both K-major in
// shared memory, the reduced dim cut into column blocks of 64 (CBA and CBB
// bytes apart) of which each k step of 16 takes a quarter (32 bytes).
template <int N, int CBA, int CBB, int... KK>
__device__ __forceinline__ void wgmma_ss_chain(
    float (&d)[N / 2], uint64_t da, uint64_t db,
    std::integer_sequence<int, KK...>) {
  (WgmmaSS<N, (KK / 4) * (CBA >> 4) + (KK % 4) * 2,
           (KK / 4) * (CBB >> 4) + (KK % 4) * 2>::run(d, da, db, KK > 0),
   ...);
}

template <int N, int KSTEPS, int CBA, int CBB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  wgmma_ss_chain<N, CBA, CBB>(d, da, db,
                              std::make_integer_sequence<int, KSTEPS>{});
}

// D (64 x N) += A (64 x 16 KSTEPS; a[k] is the fragment of k chunk k) B,
// B MN-major in shared memory with rows of 128 bytes (16 rows of k per step).
template <int N, int KSTEPS, int... KK>
__device__ __forceinline__ void wgmma_rs_t_chain(
    float (&d)[N / 2], const uint32_t (&a)[KSTEPS][4], uint64_t db,
    std::integer_sequence<int, KK...>) {
  (WgmmaRST<N, KK * (16 * 128 >> 4)>::run(d, a[KK], db, 1), ...);
}

template <int N, int KSTEPS>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2],
                                           const uint32_t (&a)[KSTEPS][4],
                                           uint64_t db) {
  wgmma_rs_t_chain<N, KSTEPS>(d, a, db,
                              std::make_integer_sequence<int, KSTEPS>{});
}

// D (64 x N) += A B as above, for any N a multiple of 64 up to 256: B lies
// MN-major at `b_addr` with its 64-column blocks CB bytes apart. N <= 128 is
// one chain; a wider N (192, 256) is one m64n128 chain per 128 columns and
// an m64n64 chain for a last 64, since the accumulator of a 64 x N tile is
// its column chunks' accumulators side by side (register 4j + e holds
// column 8j + ...), all fed the same A fragments.
template <int N, int KSTEPS, int CB, int... C>
__device__ __forceinline__ void wgmma_rs_t_wide(
    float (&d)[N / 2], const uint32_t (&a)[KSTEPS][4], uint32_t b_addr,
    std::integer_sequence<int, C...>) {
  (wgmma_rs_t<128, KSTEPS>(*reinterpret_cast<float(*)[64]>(d + 64 * C), a,
                           desc_sw128(b_addr + 2 * C * CB, CB, 1024)),
   ...);
  if constexpr (N % 128 != 0)
    wgmma_rs_t<64, KSTEPS>(*reinterpret_cast<float(*)[32]>(d + N / 2 - 32),
                           a, desc_sw128(b_addr + (N / 64 - 1) * CB, CB, 1024));
}

template <int N, int KSTEPS, int CB>
__device__ __forceinline__ void wgmma_rs_t_cols(float (&d)[N / 2],
                                                const uint32_t (&a)[KSTEPS][4],
                                                uint32_t b_addr) {
  static_assert(N % 64 == 0 && N <= 256, "N: a multiple of 64 up to 256");
  if constexpr (N <= 128)
    wgmma_rs_t<N, KSTEPS>(d, a, desc_sw128(b_addr, CB, 1024));
  else
    wgmma_rs_t_wide<N, KSTEPS, CB>(d, a, b_addr,
                                   std::make_integer_sequence<int, N / 128>{});
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared memory, asynchronously (cp.async); with
// `bytes` 0 nothing is read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously, cached in L2 only
// (cp.async.cg); both addresses 16-byte aligned. With `bytes` 0 nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Close this thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed (.noinc: the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Named barrier `id` (1 to 15; 0 is __syncthreads) over `threads` threads,
// whole warps: orders their shared-memory accesses like __syncthreads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting for it: the warps that
// bar_sync on it with the same count go on once these arrivals are in.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The split kernels' score exchange. Both consumer warpgroups own the
// same 64 rows; warpgroup c computed columns [c N/2, (c + 1) N/2) of an
// N-column score tile, R = N / 4 accumulator registers a thread. put_half
// writes a thread's R values to `buf` ([2 warpgroups][R][128 threads],
// f32: conflict-free, coalesced); after a named barrier over both
// consumers (bar_sync(1, 256)), join_half reads the other warpgroup's R
// values of the same thread index, which by the fragment layout are the
// same rows' other columns, straight into the whole tile's registers:
// register 4j + e holds column 8j + ..., so warpgroup 0's half is the
// first R registers and warpgroup 1's the last R. Selects, not a branch:
// both warpgroups run one instruction stream. The caller double-buffers
// `buf`, so one barrier per tile suffices: a warpgroup reaches tile
// i + 2's write only after the other passed tile i + 1's barrier, i.e.
// after it read tile i.
template <int R>
__device__ __forceinline__ void put_half(const float* own, float* buf, int c,
                                         int t) {
#pragma unroll
  for (int r = 0; r < R; ++r) buf[(c * R + r) * 128 + t] = own[r];
}

template <int R>
__device__ __forceinline__ void join_half(const float* own, const float* buf,
                                          float (&full)[2 * R], int c,
                                          int t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float other = buf[((1 - c) * R + r) * 128 + t];
    full[r] = c == 0 ? own[r] : other;
    full[R + r] = c == 0 ? other : own[r];
  }
}

// Store a 64-row accumulator of NC columns (a thread's rows row0 and
// row1) as bf16 at columns col0 + 8j + 2 (t % 4) of `out` (element row
// stride `ss`), times `scale`, skipping rows at or past `rows` and columns
// below `skip` (the columns the other warpgroup stores).
template <int NC>
__device__ __forceinline__ void store_cols(__nv_bfloat16* out, int64_t ss,
                                           const float (&acc)[NC / 2],
                                           float scale, int row0, int row1,
                                           int rows, int tq, int col0,
                                           int skip) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tq;
    if (col < skip) continue;
    if (row0 < rows)
      *reinterpret_cast<uint32_t*>(out + row0 * ss + col) =
          pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (row1 < rows)
      *reinterpret_cast<uint32_t*>(out + row1 * ss + col) =
          pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// ------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry points,
// so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 map of `rank` dims with the 128-byte swizzle, element strides 1.
// Returns a cudaError_t (0 on success).
inline cudaError_t tmap_encode(CUtensorMap* map, const void* base,
                               cuuint32_t rank, const cuuint64_t* dims,
                               const cuuint64_t* strides,
                               const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorInitializationError;
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A 4-D map over a bf16 [b, heads, s, d] tensor given by element strides
// (head dim contiguous), read in boxes of 64 columns x `rows` rows with the
// 128-byte swizzle. Returns a cudaError_t (0 on success).
inline cudaError_t tmap_bf16(CUtensorMap* map, const void* base, int d, int s,
                             int heads, int b, int64_t ss, int64_t sh,
                             int64_t sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return tmap_encode(map, base, 4, dims, strides, box);
}

// The same tensor as a 5-D map whose box is a whole tile of `rows` rows:
// dims (64 columns, s, d / 64 column blocks, heads, b), the column block's
// stride 128 bytes, box (64, rows, d / 64, 1, 1). One copy (coordinates
// {0, row, 0, head, batch}) lands the tile as its d / 64 column blocks of
// rows x 128 bytes side by side, the layout above, with the 128-byte
// swizzle: one TMA instruction a tile instead of one a column block.
inline cudaError_t tmap_bf16_tile(CUtensorMap* map, const void* base, int d,
                                  int s, int heads, int b, int64_t ss,
                                  int64_t sh, int64_t sb, int rows) {
  const cuuint64_t dims[5] = {64, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(d / 64),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(ss) * 2, 128,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(d / 64), 1, 1};
  return tmap_encode(map, base, 5, dims, strides, box);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory and its
// arguments by value (tensor maps included); returns the launch's error.
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem,
                   cudaStream_t stream, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace hopper
