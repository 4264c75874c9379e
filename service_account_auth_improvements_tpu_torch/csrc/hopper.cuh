// Hopper (sm_90a) building blocks shared by the port's attention kernels
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/flash_wide.cu): mbarriers,
// TMA loads, thread block clusters (remote stores and arrivals, the cluster
// barrier, the pairs' PairExchange and the n-block ClusterSum), wgmma
// descriptors and instructions, setmaxnreg, and the host-side tensor maps
// and launches.
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

#include <type_traits>
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

// ------------------------------------------------------------ clusters
//
// A thread block cluster is a group of blocks launched together on
// neighbouring SMs (launch_cluster below); each can store into the others'
// shared memory and arrive on their mbarriers through the cluster's shared
// window ("distributed shared memory").

// This block's rank in its cluster (0 to the cluster's size - 1).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster-window address of shared-memory address `addr` in the block
// of rank `rank` (the same offset in that block's shared memory): what
// st_async_16 and mbar_arrive_remote_cta take.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Store 16 bytes into another block's shared memory at `dst` (a
// cluster_map address), completing 16 bytes of the transaction count of
// that block's mbarrier `bar` (a cluster_map address too): the receiver
// waits on its own barrier (mbar_wait_cluster) as for a TMA load, after
// raising the count by the bytes it expects (mbar_arrive_expect_tx).
__device__ __forceinline__ void st_async_16(uint32_t dst, float x, float y,
                                            float z, float w, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(x), "f"(y), "f"(z), "f"(w), "r"(bar)
      : "memory");
}

// One arrival on another block's mbarrier (a cluster_map address), with
// mbarrier.arrive's default release at CTA scope, as CUTLASS's cluster
// pipelines hand a buffer back to the block that refills it. Made only by
// PairExchange::release (below), whose comment says why CTA scope is
// enough there.
__device__ __forceinline__ void mbar_arrive_remote_cta(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cta.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
      : "memory");
}

// mbar_wait for a barrier that another block of the cluster completes (by
// st_async_16 or mbar_arrive_remote_cta): acquires at cluster scope, so the
// peer's stores, or its reads before the arrival, are ordered before what
// follows.
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar,
                                                      uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try_wait_cluster(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait_cluster(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// The cluster-wide barrier, split: every thread of every block of the
// cluster arrives (releasing its accesses), and wait returns once all
// have; a block may work between the two. At the start it makes the
// blocks' mbarrier initialisation visible to each other before the first
// remote access; at the end it keeps a block resident until its peers no
// longer touch its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// ------------------------------------------------------------ pairs
//
// The pair kernels (flash_fwd_pair, dq_pair, dkv_pair) run on a cluster
// of two 8-warp blocks, the block of rank r holding columns [r D/2, (r +
// 1) D/2) of every tensor. A score product over half the head dim is a
// partial sum: each warpgroup stores its partial, in fragment order, into
// its twin's receive buffer in the peer (the twin: the warpgroup of the
// same index there), waits for the twin's in its own and adds it, one f32
// add per element of the same two values on both blocks, so IEEE addition
// (commutative) gives both blocks the same sum bit for bit. PairExchange
// is that protocol, the one place the pair kernels touch the peer's
// shared memory or barriers:
//   init      thread 0, before the kernel's fence_mbar_init: the two
//             `recv` barriers (the twin's partial has landed; armed with
//             the first round's bytes if `first`) and the `freed`
//             barriers (the peer has read what this block stored there);
//   begin     the cluster barrier once every block's barriers are set up,
//             before the first remote store;
//   send      a round of this thread's CHUNKS 16-byte register chunks to
//             16-byte slots k 128 + t of the twin's buffer (st.async,
//             completing the bytes of the twin's `recv`), once the twin
//             has read the last round's;
//   recv_add  wait for the twin's round, re-arm `recv` for the next one
//             (`rearm`), add the twin's chunks to this thread's;
//   release   hand the receive buffers back (when `more` rounds follow);
//   end       the cluster barrier at the end, around the block's own
//             stores: no block leaves while its peer may still touch its
//             shared memory.
// READERS is who reads a receive buffer: 128, its warpgroup alone (one
// `freed` barrier a warpgroup, named barrier 2 + c); 256, both
// warpgroups (dkv_pair, whose P^T goes through warpgroup 0's buffer to
// both: stash, unstash; one `freed` barrier, named barrier 2). A round's
// phase parity is the kernel's round count & 1, the same on both blocks.
// Shared memory: two receive buffers of BYTES (warpgroup c's at x + c
// BYTES), and BARS mbarriers at `bar`: recv[2], then freed[FREED].
template <int CHUNKS, int READERS = 128>
struct PairExchange {
  static_assert(READERS == 128 || READERS == 256, "a warpgroup or both");
  static constexpr int BYTES = CHUNKS * 16 * 128;  // one receive buffer
  static constexpr int FREED = READERS == 128 ? 2 : 1;
  static constexpr int BARS = 2 + FREED;

  uint32_t rx_peer;           // the twin's receive buffer (cluster window)
  uint32_t recv, recv_peer;   // this warpgroup's `recv`, and the twin's
  uint32_t freed, freed_peer;  // this warpgroup's `freed`, and the peer's
  unsigned char* buf;         // the block's receive buffers
  const float4* in;           // this warpgroup's receive buffer
  int c, t;                   // warpgroup, thread in it

  // Warpgroup c's view, in the block whose peer is `peer`: its receive
  // buffers at shared address x_addr (generic pointer x), its barriers at
  // bar.
  __device__ __forceinline__ PairExchange(uint32_t x_addr, unsigned char* x,
                                          uint32_t bar, uint32_t peer, int c,
                                          int t)
      : recv(bar + 8 * c),
        freed(bar + 16 + 8 * (FREED == 2 ? c : 0)),
        buf(x),
        in(reinterpret_cast<const float4*>(x + c * BYTES)),
        c(c),
        t(t) {
    rx_peer = cluster_map(x_addr + c * BYTES, peer);
    recv_peer = cluster_map(recv, peer);
    freed_peer = cluster_map(freed, peer);
  }

  static __device__ __forceinline__ void init(uint32_t bar, bool first) {
    for (int c = 0; c < 2; ++c) {
      mbar_init(bar + 8 * c, 1);
      if (first) mbar_arrive_expect_tx(bar + 8 * c, BYTES);
    }
    for (int f = 0; f < FREED; ++f)
      mbar_init(bar + 16 + 8 * f, 1);  // one arrival: the peer's release
  }

  static __device__ __forceinline__ void begin() {
    cluster_arrive();
    cluster_wait();
  }

  template <typename F>
  static __device__ __forceinline__ void end(F&& stores) {
    cluster_arrive();  // no more stores into the peer, nor reads of its data
    stores();
    cluster_wait();
  }

  // Round x of r: its chunks x CHUNKS + k (r[4j] .. r[4j + 3] is chunk j)
  // to slots k.
  template <int N>
  __device__ __forceinline__ void send(const float (&r)[N], uint32_t phase,
                                       int x = 0) const {
    mbar_wait_cluster(freed, phase ^ 1);
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) put(k, r, x * CHUNKS + k);
  }

  // Round x of two arrays (S and dP): CHUNKS / 2 chunks of each, r's to
  // the first slots.
  template <int N>
  __device__ __forceinline__ void send(const float (&r)[N],
                                       const float (&u)[N], uint32_t phase,
                                       int x = 0) const {
    constexpr int H = CHUNKS / 2;
    mbar_wait_cluster(freed, phase ^ 1);
#pragma unroll
    for (int k = 0; k < H; ++k) put(k, r, x * H + k);
#pragma unroll
    for (int k = 0; k < H; ++k) put(H + k, u, x * H + k);
  }

  template <int N>
  __device__ __forceinline__ void recv_add(float (&r)[N], uint32_t phase,
                                           bool rearm, int x = 0) const {
    arrived(phase, rearm);
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) add(r, x * CHUNKS + k, in[k * 128 + t]);
  }

  template <int N>
  __device__ __forceinline__ void recv_add(float (&r)[N], float (&u)[N],
                                           uint32_t phase, bool rearm,
                                           int x = 0) const {
    constexpr int H = CHUNKS / 2;
    arrived(phase, rearm);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float4 a = in[k * 128 + t], b = in[(H + k) * 128 + t];
      add(r, x * H + k, a);
      add(u, x * H + k, b);
    }
  }

  // READERS 256 only: after recv_add, warpgroup 0's receive buffer
  // (read by then) carries 16 bytes a thread to both warpgroups of the
  // block, slot k 128 + t: stash (warpgroup 0), a named barrier of both
  // (the kernel's), unstash (both), before release.
  __device__ __forceinline__ void stash(int k, uint4 v) const {
    static_assert(READERS == 256, "both warpgroups read the buffers");
    reinterpret_cast<uint4*>(buf)[k * 128 + t] = v;
  }

  __device__ __forceinline__ uint4 unstash(int k) const {
    static_assert(READERS == 256, "both warpgroups read the buffers");
    return reinterpret_cast<const uint4*>(buf)[k * 128 + t];
  }

  // The receive buffers back to the peer: a named barrier of their
  // READERS threads, then one arrival by the first of them on the peer's
  // `freed`, which the peer waits on before it stores the next round
  // there. The arrival is released at CTA scope (mbar_arrive_remote_cta),
  // and that is enough because of the rule this helper keeps: every read
  // of a receive buffer is a shared-memory load into a register (recv_add
  // and unstash are the only reads; no receive buffer feeds a wgmma from
  // shared memory, whose reads would still be in flight after it was
  // issued), all of them issued by the READERS threads before this named
  // barrier, and bar.sync returns once their loads are performed: no read
  // is outstanding when the peer's next st.async lands. A release at
  // cluster scope would also wait for the arriving thread's own st.async
  // stores into the peer to complete (900 to 1,100 cycles a tile at 16 KB
  // on an H100, PERF.md §6).
  __device__ __forceinline__ void release(bool more) const {
    if (more) {
      bar_sync(READERS == 128 ? 2 + c : 2, READERS);
      if (threadIdx.x % READERS == 0) mbar_arrive_remote_cta(freed_peer);
    }
  }

 private:
  template <int N>
  __device__ __forceinline__ void put(int slot, const float (&r)[N],
                                      int j) const {
    st_async_16(rx_peer + (slot * 128 + t) * 16, r[4 * j], r[4 * j + 1],
                r[4 * j + 2], r[4 * j + 3], recv_peer);
  }

  __device__ __forceinline__ void arrived(uint32_t phase, bool rearm) const {
    mbar_wait_cluster(recv, phase);
    if (t == 0 && rearm) mbar_arrive_expect_tx(recv, BYTES);
  }

  template <int N>
  static __device__ __forceinline__ void add(float (&r)[N], int j,
                                             float4 v) {
    r[4 * j] += v.x;
    r[4 * j + 1] += v.y;
    r[4 * j + 2] += v.z;
    r[4 * j + 3] += v.w;
  }
};

// ------------------------------------------------------------ clusters of n
//
// csrc/flash_wide.cu's f32 K1, K2 and K3 (flash_fwd_wide_f32, dq_wide_f32,
// dkv_wide_f32) and bf16 K3 (dkv_wide, on wgmma accumulators of both
// warpgroups) run a row tile on a cluster of n blocks (1 <= n <= NMAX = 8,
// the portable cluster size), the block of rank r holding a share of the
// head dim. Each thread
// forms a partial sum of its score registers over that share: the same
// registers, by thread and index, in every block. ClusterSum adds the n
// partials and hands every block the sum, as a reduce-scatter then an
// all-gather through distributed shared memory:
//   units     a thread's scores are UNITS 16-byte units; unit k of thread t
//             is u = k 256 + t, of TOTAL = 256 UNITS; rank r owns units
//             [lo(r), lo(r + 1)), lo(r) = r TOTAL / n, at most
//             ceil(TOTAL / n);
//   init      thread 0, before the kernel's fence_mbar_init: the `rs`
//             barrier (every peer's partials of the units this block owns
//             have landed) and the `ag` barrier (every sum it does not
//             own has), each armed with its first round's bytes;
//   begin     the cluster barrier once every block's barriers are set up;
//   scatter   each thread st.asyncs each unit it does not own into its
//             owner's `rs` buffer (row: the sender among the owner's
//             peers, column u - lo(owner)), completing the owner's `rs`;
//   gather    each thread that owns units waits for `rs` and adds the n
//             partials of each in rank order, rank 0's first (its own from
//             its registers), keeps the sum and st.asyncs it into every
//             peer's `ag` buffer at u, completing the peer's `ag`;
//   collect   every thread waits for `ag` and loads the sums it does not
//             own into its registers;
//   end       the cluster barrier around the block's own stores.
// Each sum is formed once, by its owner, so every block holds the same bits;
// there are no atomics, and a rerun gives the same bits. A round's phase
// parity is the kernel's round count & 1, the same in every block. Between
// scatter and gather, and between gather and collect, the kernel works on
// (the last tile's output product), while the stores land.
//
// No buffer is handed back by an arrival of its own, because every read of
// a receive buffer is a load into a register (gather's and collect's only)
// whose value the thread has used before its next store into a peer: a
// partial read in gather feeds the sum that gather then sends; a sum read
// in collect feeds the scores the kernel stores to shared memory before the
// __syncthreads of its next tile's first chunk, which comes before that
// tile's scatter (dkv_wide: P^T stored before a named barrier, dS^T into
// the A fragments of a product issued before the next scatter). So a
// peer stores into `rs` again only after its `ag` wait has seen every sum
// this block owns, each sent after that sum's partials
// were loaded, and into `ag` again only after its `rs` wait has seen this
// block's next partials, sent after the last sums were loaded: no read is
// outstanding when the next store lands. The same orders keep a waiter
// from missing a phase: `rs` (waited on by the owners alone) and `ag`
// (every thread) cannot complete a second round before each of their
// waiters has passed the first.
// Shared memory: the `rs` buffer (RS_UNITS 16-byte slots, the most any n
// needs), the `ag` buffer (TOTAL slots), then BARS mbarriers at `bar`.
template <int UNITS, int NMAX = 8>
struct ClusterSum {
  static constexpr int THREADS = 256;
  static constexpr int TOTAL = UNITS * THREADS;  // units of a block
  __host__ __device__ static constexpr int share(int n) {
    return (TOTAL + n - 1) / n;
  }
  __host__ __device__ static constexpr int rs_units(int n) {
    return (n - 1) * share(n);
  }
  // the largest rs_units up to n
  __host__ __device__ static constexpr int most(int n) {
    return n < 2 ? 0
                 : (rs_units(n) > most(n - 1) ? rs_units(n) : most(n - 1));
  }
  static constexpr int RS_UNITS = most(NMAX);
  static constexpr int BYTES = (RS_UNITS + TOTAL) * 16;
  static constexpr int BARS = 2;  // rs, ag
  static_assert(NMAX >= 1 && NMAX <= 8, "a portable cluster");

  uint32_t rs_addr, ag_addr;  // this block's buffers (shared addresses)
  uint32_t bar;               // its `rs` barrier; `ag` at bar + 8
  const float4* rs;           // the same buffers, generic
  const float4* ag;
  int n, rank, t, lo;  // cluster size, this block, thread, first owned

  static __device__ __forceinline__ int first(int r, int n) {
    return r * TOTAL / n;
  }
  static __device__ __forceinline__ int owner(int u, int n) {
    return ((u + 1) * n - 1) / TOTAL;
  }
  // the bytes of one round into `rs` and into `ag` of rank r
  static __device__ __forceinline__ uint32_t rs_bytes(int r, int n) {
    return (n - 1) * (first(r + 1, n) - first(r, n)) * 16;
  }
  static __device__ __forceinline__ uint32_t ag_bytes(int r, int n) {
    return (TOTAL - (first(r + 1, n) - first(r, n))) * 16;
  }

  // Thread t's view in the block of rank `rank` of n: the buffers at
  // shared address x_addr (generic pointer x), the barriers at bar.
  __device__ __forceinline__ ClusterSum(uint32_t x_addr, const void* x,
                                        uint32_t bar, int n, int rank, int t)
      : rs_addr(x_addr),
        ag_addr(x_addr + RS_UNITS * 16),
        bar(bar),
        rs(static_cast<const float4*>(x)),
        ag(static_cast<const float4*>(x) + RS_UNITS),
        n(n),
        rank(rank),
        t(t),
        lo(first(rank, n)) {}

  static __device__ __forceinline__ void init(uint32_t bar, int n, int r) {
    mbar_init(bar, 1);
    mbar_arrive_expect_tx(bar, rs_bytes(r, n));
    mbar_init(bar + 8, 1);
    mbar_arrive_expect_tx(bar + 8, ag_bytes(r, n));
  }

  static __device__ __forceinline__ void begin() {
    cluster_arrive();
    cluster_wait();
  }

  template <typename F>
  static __device__ __forceinline__ void end(F&& stores) {
    cluster_arrive();  // no more stores into a peer
    stores();
    cluster_wait();
  }

  // This thread's partials (r[4k] .. r[4k + 3] is unit k) that it does not
  // own, to their owners.
  template <int N>
  __device__ __forceinline__ void scatter(const float (&r)[N]) const {
    static_assert(N == 4 * UNITS, "UNITS units a thread");
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = k * THREADS + t, o = owner(u, n);
      if (o == rank) continue;
      const int row = rank < o ? rank : rank - 1;
      const int slot = row * share(n) + u - first(o, n);
      st_async_16(cluster_map(rs_addr + slot * 16, o), r[4 * k],
                  r[4 * k + 1], r[4 * k + 2], r[4 * k + 3],
                  cluster_map(bar, o));
    }
  }

  // The sums of the units this thread owns, in rank order, into r and to
  // every peer; `more`: another round follows (re-arm `rs`).
  template <int N>
  __device__ __forceinline__ void gather(float (&r)[N], uint32_t phase,
                                         bool more) const {
    bool mine = false;
#pragma unroll
    for (int k = 0; k < UNITS; ++k) mine |= owner(k * THREADS + t, n) == rank;
    if (!mine) return;
    mbar_wait_cluster(bar, phase);
    // the thread that holds the first owned unit re-arms: an owner, so it
    // has passed this round's wait
    if (more && lo % THREADS == t)
      mbar_arrive_expect_tx(bar, rs_bytes(rank, n));
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = k * THREADS + t;
      if (owner(u, n) != rank) continue;
      const float4 own = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2],
                                     r[4 * k + 3]);
      float4 s = rank == 0 ? own : rs[u - lo];
#pragma unroll
      for (int src = 1; src < NMAX; ++src) {
        if (src >= n) break;
        const float4 v =
            src == rank ? own
                        : rs[(src < rank ? src : src - 1) * share(n) + u - lo];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      r[4 * k] = s.x, r[4 * k + 1] = s.y, r[4 * k + 2] = s.z,
      r[4 * k + 3] = s.w;
#pragma unroll
      for (int p = 0; p < NMAX; ++p) {
        if (p >= n) break;
        if (p != rank)
          st_async_16(cluster_map(ag_addr + u * 16, p), s.x, s.y, s.z, s.w,
                      cluster_map(bar + 8, p));
      }
    }
  }

  // The sums this thread does not own, from `ag` into r; `more`: another
  // round follows (thread 0 re-arms `ag`). Every unit's slot is loaded and
  // the owned ones' values (a slot no peer writes) are selected away: r
  // written under a branch made ptxas serialise the wgmmas of a kernel
  // whose r are wgmma accumulators (C7511, csrc/flash_wide.cu's dkv_wide).
  template <int N>
  __device__ __forceinline__ void collect(float (&r)[N], uint32_t phase,
                                          bool more) const {
    mbar_wait_cluster(bar + 8, phase);
    if (more && t == 0) mbar_arrive_expect_tx(bar + 8, ag_bytes(rank, n));
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = k * THREADS + t;
      const bool own = owner(u, n) == rank;
      const float4 v = ag[u];
      r[4 * k] = own ? r[4 * k] : v.x;
      r[4 * k + 1] = own ? r[4 * k + 1] : v.y;
      r[4 * k + 2] = own ? r[4 * k + 2] : v.z;
      r[4 * k + 3] = own ? r[4 * k + 3] : v.w;
    }
  }
};

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

// The same tensor as a 5-D map whose box is `cols` columns (cols / 64
// column blocks) of `rows` rows: dims (64 columns, s, d / 64 column
// blocks, heads, b), the column block's stride 128 bytes, box (64, rows,
// cols / 64, 1, 1). One copy (coordinates {0, row, block, head, batch})
// lands the box as its cols / 64 column blocks of rows x 128 bytes side by
// side, the layout above, with the 128-byte swizzle: one TMA instruction a
// tile instead of one a column block. Column blocks of the box past d
// arrive as zeros (a box may be wider than the tensor).
inline cudaError_t tmap_cols(CUtensorMap* map, const void* base, int d, int s,
                             int heads, int b, int64_t ss, int64_t sh,
                             int64_t sb, int rows, int cols) {
  const cuuint64_t dims[5] = {64, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(d / 64),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(ss) * 2, 128,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(cols / 64), 1, 1};
  return tmap_encode(map, base, 5, dims, strides, box);
}

// tmap_cols with the box a whole tile of `rows` rows: all d columns.
inline cudaError_t tmap_bf16_tile(CUtensorMap* map, const void* base, int d,
                                  int s, int heads, int b, int64_t ss,
                                  int64_t sh, int64_t sb, int rows) {
  return tmap_cols(map, base, d, s, heads, b, ss, sh, sb, rows, d);
}

// `p` with each named pointer (a bf16 tensor's, `const void*` or `void*`
// members of a kernel's Params) moved `col` elements along its rows: the
// block of rank r of a pair is launched on columns [r D/2, (r + 1) D/2)
// of every tensor, at_column(p, r D / 2, &Params::q, ...).
template <typename P, typename... T>
P at_column(const P& p, int64_t col, T* P::*... ptrs) {
  P h = p;
  ((h.*ptrs = static_cast<std::conditional_t<std::is_const_v<T>,
                                             const __nv_bfloat16,
                                             __nv_bfloat16>*>(p.*ptrs) +
              col),
   ...);
  return h;
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

// The same as a grid of clusters of `cluster` blocks along x (`blocks` a
// multiple of it). A launch the card cannot place (no `cluster` SMs of one
// GPC with room for a block each) is refused: its error is returned.
template <typename Kernel, typename Args>
cudaError_t launch_cluster(Kernel kernel, int blocks, int cluster,
                           int threads, size_t smem, cudaStream_t stream,
                           const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel` (with `threads` threads
// and `smem` bytes of dynamic shared memory each) the current card holds
// at once (cudaOccupancyMaxActiveClusters); 0: a launch would be refused;
// -2: the query failed.
template <typename Kernel>
int max_clusters(Kernel kernel, int cluster, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, reinterpret_cast<const void*>(kernel), &cfg) != cudaSuccess)
    return -2;
  return n;
}

}  // namespace hopper
