#!/usr/bin/env python3
"""Build the design alternatives of K1 (``flash_fwd_twin`` at d 64,
``flash_fwd_rows8`` at d 256, ``flash_fwd_pair`` at d 384 and 512,
``flash_fwd_f32`` at d 128 in f32, in
``service_account_auth_improvements_tpu_torch/csrc/flash_fwd.cu``),
K2 (``dq_wgmma`` at d 128, ``dq_rows8`` at d 64, 192 and 256, ``dq_pair`` at
d 512 and, in the other build, 384, ``dq_f32`` at d 128 in f32) and K3
(``dkv_keys8`` at d 64,
``dkv_onepass`` at d 192 and 256, ``dkv_pair`` at d 320 to 512,
``dkv_f32`` at d 128 in f32, all in ``csrc/flash_bwd.cu``), and the
streamed kernels above d 512 on a cluster (``flash_fwd_wide_f32``,
``dq_wide_f32`` and ``dkv_wide_f32`` and bf16's ``dkv_wide`` at d 768 and
2048, in ``csrc/flash_wide.cu``: the exchange's overlap) and bf16's column
groups there (``flash_fwd_wide``, ``dq_wide``: the ring's layout, where
its refills are issued, and the groups launched as clusters), and time
them against the committed kernels on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 kernel_variants.py [--baseline DIR] [--no-variants] [kernel
...]`` (the kernels of ``KERNEL_HEADS`` whose variants to run, e.g.
``'dkv_pair<512>' 'dkv_pair<384>'``; all without arguments). With
``--baseline DIR`` the sources of another tree's csrc/ directory (say the
parent commit's, unpacked by ``git archive`` into a gitignored directory)
are built too and checked and timed as one more variant, ``baseline``;
``--no-variants`` leaves out the edited builds, so only the committed
source and the baseline are timed. Each
variant is the committed source of
the kernel it edits with the text edits listed in ``VARIANTS``, each
made in the source or in a header beside it (an edit whose text is not
found exactly once among them fails the run). Every source is built
with the flags of ``ops/_build.py`` into
``build/kernel_variants/<name>/<source>/``, one nvcc each, all started
together; ptxas's lines for the kernel each variant edits are printed.
Each build is held against the kernel's plain version
(``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``) at a ragged shape and at the timed shape of
the kernel (``KERNEL_HEADS``, ``KERNEL_SHAPES``, in the kernel's dtype,
``KERNEL_DTYPES``; chip_smoke.py's ``TOL``, ``LSE_ATOL`` and
``BWD_TOL``) and twice on one input (bitwise), then each kernel's variants
are timed at its timed shape in turns with the committed source
(committed, variants, variants in reverse, committed), queued behind a
spin on the card as chip_smoke.py times its kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

OUT = cs.ROOT / "build" / "kernel_variants"
# another tree's csrc/ (``--baseline``), built as the variant "baseline"
BASELINE: list[Path] = []

# edits shared by several variants: K3 at d 192 on the one pass; K3 at d
# 64's stage count; K1 f32's key tiles and stages
ONEPASS_D192 = ("         : d == 192 ? (FLASH_OTHER_DESIGNS ? kOnePass : "
                "kRowSplit)\n", "         : d == 192 ? kOnePass\n")
KEYS8_STAGES = ("  static constexpr int STAGES = FIT < 4 ? FIT : 4;\n"
                "  static constexpr int V_OFF = KV_BYTES;\n")
F32_K1_TILES = ("  static constexpr int BK = D <= 256 ? 64 : 32;\n"
                "  static constexpr int ST = D <= 64 ? 3 : D <= 128 ? 2 : "
                "1;\n")

# K3 at d 320 to 512 (dkv_pair): its stage size, stages, the prefetch
# (keyed on the columns a block holds, DH: 192 at d 320 and 384, 256 at d
# 448 and 512), and the design ids there (the pair ships; dkv_split, the
# other build's)
PAIR_BQ = "  static constexpr int BQ = 64;     // queries a stage\n"
PAIR_STAGES = "  static constexpr int STAGES = DH == 192 ? 3 : 2;  // Q and dO stages\n"
PAIR_PREFETCH = "  static constexpr bool PREFETCH = DH == 192;\n"
# the prefetch on two stages reads the next tile before the exchange
# barrier that a deferred refill waits for: the first warp then waits for
# the other warpgroup's release instead of deferring
PAIR_PREFETCH_WAIT = (
    "    if (threadIdx.x < 32 && m + STAGES < tiles) {\n      if (__shfl_sync(",
    "    if (threadIdx.x < 32 && m + STAGES < tiles) {\n"
    "      if (L::PREFETCH && STAGES == 2)\n"
    "        mbar_wait(q_empty + 8 * (m % STAGES), (m / STAGES) & 1);\n"
    "      if (__shfl_sync(")
# the arrival on the peer's `freed` barrier (hopper::PairExchange, every
# pair's), by the first of the buffer's readers past a named barrier of
# them, or by every warp once its own reads are issued; the barrier's count
# for every warp of the readers
PAIR_ARRIVE = """      bar_sync(READERS == 128 ? 2 + c : 2, READERS);
      if (threadIdx.x % READERS == 0) mbar_arrive_remote_cta(freed_peer);
"""
PAIR_WARP_ARRIVE = """      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive_remote_cta(freed_peer);
"""
PAIR_WARP_COUNT = (
    "      mbar_init(bar + 16 + 8 * f, 1);  // one arrival: the peer's "
    "release\n",
    "      mbar_init(bar + 16 + 8 * f, READERS / 32);\n")
PAIR_WARP_ARRIVALS = [PAIR_WARP_COUNT, (PAIR_ARRIVE, PAIR_WARP_ARRIVE)]
# dkv_pair's release, made before its dV/dK product is issued instead of
# after it
PAIR_RELEASE = "    xc.release(next);\n"
PAIR_PRODUCT = ("    // dV[:, half] += P^T dO[:, half] (warpgroup 0) or dK[:, half] +=\n"
                "    // dS^T Q[:, half] (warpgroup 1)\n")
# the prefetch issued on the last stage too (its own scores again), and
# its result taken only while there is a next stage
PAIR_PREFETCH_EVERY = (
    "    if constexpr (L::PREFETCH)\n      if (next) scores(sn, n + 1);\n",
    "    if constexpr (L::PREFETCH) scores(sn, next ? n + 1 : n);\n")
PAIR_PREFETCH_TAKE = ("    if constexpr (L::PREFETCH) {\n      fence_regs(sn);\n",
                      "    if (L::PREFETCH && next) {\n      fence_regs(sn);\n")


def design_at(kernel: str, d: int, design: str = "kDSplit") -> tuple:
    """The edit that makes ``kernel``'s design rule (``fwd_design``,
    ``dq_design``, ``dkv_design``) return ``design`` at head dim ``d`` in
    either build."""
    head = f"constexpr int {kernel}_design(int d) {{\n"
    return head, f"{head}  if (d == {d}) return {design};\n"



# K1 and K2 at d 384 and 512 on a pair of blocks (flash_fwd_pair,
# dq_pair): K1's stages and prefetch; K2's key tiles and stages (one
# stage of 64 keys, exchanged in two rounds, against two of 32 at d 512;
# two of 64 against four of 32 at d 384)
ROWS_PAIR_STAGES = "  static constexpr int STAGES = D == 384 ? 3 : 2;\n"
ROWS_PAIR_PREFETCH = "  static constexpr bool PREFETCH = D == 384;\n"
FWD_PAIR_BK = "  static constexpr int BK = 64;     // keys per K/V stage\n"
# an m64n48k16 wgmma (hopper.cuh has N 8 to 128 but 48), for 48-key tiles
WGMMA_N64 = "template <int OA, int OB>\nstruct WgmmaSS<64, OA, OB> {\n"
WGMMA_N48 = (WGMMA_N64, """template <int OA, int OB>
struct WgmmaSS<48, OA, OB> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\\n.reg .pred p;\\n.reg .b64 da, db;\\n"
        "setp.ne.b32 p, %26, 0;\\n"
        "add.s64 da, %24, %27;\\nadd.s64 db, %25, %28;\\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "da, db, p, 1, 1, 0, 0;\\n}\\n"
        : REGS
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
};

""".replace("REGS", ", ".join(f'"+f"(d[{i}])' for i in range(24)))
    + WGMMA_N64)
DQ_PAIR_PREFETCH = "  static constexpr bool PREFETCH = STAGES > 2;\n"
DQ_PAIR_BK = "  static constexpr int BK = 32;     // keys per K/V stage\n"
DQ_PAIR_STAGES = "  static constexpr int STAGES = D == 384 ? 4 : 2;\n"


def pair_at(d: int, **edits) -> list:
    """dkv_pair's constants at head dim ``d`` only (the other dims'
    instances keep their own): ``bq``, ``stages``, ``prefetch``."""
    texts = {"bq": PAIR_BQ, "stages": PAIR_STAGES, "prefetch": PAIR_PREFETCH}
    out = []
    for key, value in edits.items():
        text = texts[key]
        old = text.split("= ", 1)[1].split(";")[0]
        new = str(value).lower() if isinstance(value, bool) else str(value)
        out.append((text, text.replace(f"= {old};",
                                       f"= D == {d} ? {new} : {old};")))
    return out


# K1 at d 64: flash_fwd_twin's tiles and blocks a SM; the design ids at d
# 64 (the twin blocks ship; the row split, or the d 256 design's rows on
# 8 warps)
TWIN_BK = "  static constexpr int BK = 128;  // keys per K/V stage\n"
TWIN_BLOCKS = ("  static constexpr int BLOCKS = 2;  // blocks an SM holds\n")
FWD_D64 = "  return d == 64    ? (FLASH_OTHER_DESIGNS ? kRowSplit : kTwin)\n"
# flash_fwd_rows8 at d 64: its tiles, and two blocks a SM
ROWS8_BK = ("  static constexpr int BK = D <= 192 ? 96 : 80;  // keys per K/V "
            "stage")
ROWS8_BOUNDS = ("__global__ void __launch_bounds__(SPLIT_THREADS, 1)\n"
                "flash_fwd_rows8(")

# d 64 K1's S = Q K^T with Q in registers: hopper.cuh gains m64n64 and
# m64n128 wgmmas with A from registers and B K-major (WgmmaRS), a chain and a
# loader of A fragments from a 128-byte-swizzled tile; flash_fwd_twin
# loads its warpgroup's Q once and issues S from the fragments
FWD_Q_REGS = [
    ("template <int OB>\nstruct WgmmaRST<128, OB> {",
     r"""template <int OB>
struct WgmmaRS<128, OB> {
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
        "{%64, %65, %66, %67}, db, p, 1, 1, 0;\n}\n"
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

template <int OB>
struct WgmmaRS<64, OB> {
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
        "{%32, %33, %34, %35}, db, p, 1, 1, 0;\n}\n"
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

""" + "template <int OB>\nstruct WgmmaRST<128, OB> {"),
    ("template <int N, int KSTEPS>\n__device__ __forceinline__ void "
     "wgmma_rs_t(float (&d)[N / 2],",
     r"""// D (64 x N) (+)= A (64 x 16 KSTEPS; a[k] the fragment of k chunk k) B,
// B K-major in shared memory as wgmma_ss's B (column blocks of 64 of the
// reduced dim, CBB bytes apart); `accumulate` 0 on the first step.
template <int N, int CBB, int KSTEPS, int... KK>
__device__ __forceinline__ void wgmma_rs_chain(
    float (&d)[N / 2], const uint32_t (&a)[KSTEPS][4], uint64_t db,
    std::integer_sequence<int, KK...>) {
  (WgmmaRS<N, (KK / 4) * (CBB >> 4) + (KK % 4) * 2>::run(d, a[KK], db,
                                                          KK > 0),
   ...);
}

template <int N, int KSTEPS, int CBB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[KSTEPS][4],
                                         uint64_t db) {
  wgmma_rs_chain<N, CBB>(d, a, db, std::make_integer_sequence<int, KSTEPS>{});
}

// The A fragments of a 64 x 16 KSTEPS tile that lies in shared memory as
// a TMA tile with the 128-byte swizzle (column blocks of 64, CB bytes
// apart, rows of 128 bytes, 1024-byte aligned), for this thread (warp w,
// lane group g, quad lane tq): a[k][r] holds row 16 w + g + 8 (r & 1),
// columns 16 k + 2 tq + 8 (r >> 1) and the next.
template <int KSTEPS, int CB>
__device__ __forceinline__ void lds_a_frags(uint32_t (&a)[KSTEPS][4],
                                            uint32_t tile, int w, int g,
                                            int tq) {
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * w + g + 8 * (r & 1);
      const int col = 16 * k + 2 * tq + 8 * (r >> 1);
      const int byte = (col % 64) * 2;
      const uint32_t addr = tile + (col / 64) * CB + row * 128 +
                            ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[k][r]) : "r"(addr));
    }
}

""" + "template <int N, int KSTEPS>\n"
     "__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2],"),
    ("template <int N, int OB>\nstruct WgmmaRST;\n",
     "template <int N, int OB>\nstruct WgmmaRST;\n"
     "template <int N, int OB>\nstruct WgmmaRS;\n"),
    ("  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;\n\n"
     "  mbar_wait(q_full, 0);\n#pragma unroll 1\n",
     "  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;\n"
     "  uint32_t qf[D / 16][4];  // this warpgroup's Q\n\n"
     "  mbar_wait(q_full, 0);\n"
     "  lds_a_frags<D / 16, L::Q_CB>(qf, q_addr, w, g, tq);\n"
     "#pragma unroll 1\n"),
    ("    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(\n"
     "        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, "
     "1024));\n    wgmma_commit();\n    // while it is in flight",
     "    wgmma_rs<BK, D / 16, L::KV_CB>(sc, qf, desc_sw128(k_addr, 16, "
     "1024));\n    wgmma_commit();\n    // while it is in flight")]


def fwd_d64_rows8(bk: int = 96, blocks: int = 1) -> list:
    """K1 at d 64 on flash_fwd_rows8 (turns, S(i) beside P V(i - 1)) with
    ``bk``-key tiles on ``blocks`` blocks a SM."""
    edits = [(FWD_D64, "  return d == 64    ? kRows8\n")]
    if bk != 96:
        edits.append((ROWS8_BK, ROWS8_BK.replace("D <= 192 ? 96",
                                                 f"D == 64 ? {bk} : D <= 192 "
                                                 "? 96")))
    if blocks != 1:
        edits.append((ROWS8_BOUNDS, ROWS8_BOUNDS.replace(
            "SPLIT_THREADS, 1", f"SPLIT_THREADS, D == 64 ? {blocks} : 1")))
    return edits


# K1's softmax step (fwd_softmax, every head dim of the build; the d 64
# variants time it at d 64) with its row maxima and sums as four
# independent chains each, and with every ``emu``-th group of 8 keys'
# exp2 on the FMA pipes (exp2_fma, FlashAttention-4's polynomial: the
# exponent by the 1.5 * 2^23 rounding trick, 2^f on [-0.5, 0.5] by a
# degree-3 minimax polynomial, largest relative error 7.5e-5 = 2^-13.7 on
# [-125, 0] in f32, 0 below -125)
FWD_EXP2_FMA = (
    "// One online-softmax step on a score tile of BK keys starting at key "
    "k0,\n", """__device__ __forceinline__ float exp2_fma(float x) {
  const float t = __fadd_rn(x, 12582912.f);  // round(x) in the low bits
  const float f = __fsub_rn(x, __fsub_rn(t, 12582912.f));
  float p = fmaf(0.0551716685f, f, 0.2426111251f);
  p = fmaf(p, f, 0.6932609677f);
  p = fmaf(p, f, 0.9999280572f);
  const int r = __float_as_int(p) + (__float_as_int(t) << 23);
  return x < -125.f ? 0.f : __int_as_float(r);
}

// One online-softmax step on a score tile of BK keys starting at key k0,
""")
FWD_MAX_CHAINS = ("""  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
""", """  float c0[4] = {m0, m0, m0, m0}, c1[4] = {m1, m1, m1, m1};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    c0[j % 4] = fmaxf(c0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    c1[j % 4] = fmaxf(c1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mx0 = fmaxf(fmaxf(c0[0], c0[1]), fmaxf(c0[2], c0[3]));
  float mx1 = fmaxf(fmaxf(c1[0], c1[1]), fmaxf(c1[2], c1[3]));
""")


def fwd_sum_chains(emu: int) -> tuple:
    """fwd_softmax's exponentials and row sums: four chains a row, and
    (``emu`` > 0) every ``emu``-th group of 8 keys through exp2_fma."""
    exp2 = ("fast_exp2(x)" if not emu else
            f"j % {emu} == {emu - 1} ? exp2_fma(x) : fast_exp2(x)")
    return ("""  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], a.scale_log2, -ms0));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], a.scale_log2, -ms0));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], a.scale_log2, -ms1));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], a.scale_log2, -ms1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
""", """  float s0[4] = {}, s1[4] = {};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(sc[4 * j + e], a.scale_log2, e < 2 ? -ms0 : -ms1);
      sc[4 * j + e] = """ + exp2 + """;
    }
    s0[j % 4] += sc[4 * j] + sc[4 * j + 1];
    s1[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + ((s0[0] + s0[1]) + (s0[2] + s0[3]));
  l1 = l1 * alpha1 + ((s1[0] + s1[1]) + (s1[2] + s1[3]));
""")

# K2 at d 192: its design, stages, key tiles and commit groups
DQ_DESIGN = ("  return d == 64 || d == 192 || d == 256\n"
             "             ? (FLASH_OTHER_DESIGNS ? kRowSplit : kRows8)\n"
             "         : d <= 128 ? kRowSplit\n")
DQ_ROWS8_STAGES = ("  static constexpr int STAGES = FIT < 4 ? FIT : 4;\n"
                   "  static constexpr int DO_OFF = Q_BYTES;\n")
DQ_SPLIT = "  static constexpr bool SPLIT = D == 192;\n"
DQ_ROWS8_BK = ("  static constexpr int BK = D <= 64 || D == 192 ? 64 : 32;\n",
               "  static constexpr int BK = D <= 64 ? 64 : 32;\n")

# K2 on 8 warps: the next key tile's S and dP in flight with dQ += dS K
NEXT_SCORES = [("""  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;
    // thread 0 refills""",
                """  mbar_wait(q_full, 0);
  float sc[BK / 2], dp[BK / 2];
  mbar_wait(kv_full, 0);
  wgmma_fence();
  wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
      sc, desc_sw128(q_addr, 16, 1024),
      desc_sw128(base + L::K_OFF, 16, 1024));
  wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
      dp, desc_sw128(do_addr, 16, 1024),
      desc_sw128(base + L::V_OFF, 16, 1024));
  wgmma_commit();
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dq);
    if (i > 0) mbar_arrive(kv_empty + 8 * ((i - 1) % STAGES));
    // thread 0 refills"""),
               ("        if (next > i && !mbar_test(e, par)) break;\n",
                "        if (next > i + 1 && !mbar_test(e, par)) break;\n"),
               ("""    // S = Q K^T and dP = dO V^T: 64 rows x BK keys each (SPLIT: in two
    // commit groups, P formed while dP is in flight)
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(kv_full + 8 * s, (i / STAGES) & 1);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    if constexpr (L::SPLIT) wgmma_commit();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        dp, desc_sw128(do_addr, 16, 1024), desc_sw128(v_addr, 16, 1024));
    wgmma_commit();
    wgmma_wait<L::SPLIT ? 1 : 0>();
    fence_regs(sc);
    if constexpr (!L::SPLIT) fence_regs(dp);

""", "    float ds[BK / 2];\n"),
               ("""        if constexpr (L::SPLIT)
          sc[4 * j + e] = p;
        else
          sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    if constexpr (L::SPLIT) {  // dP is in now
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] *= dp[4 * j + e] - (e < 2 ? dl0 : dl1);
    }

    // dS in K's dtype, re-packed as the A operand; keys 16kk .. 16kk + 15
    uint32_t f[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
""", """        ds[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    uint32_t f[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[kk][r] = pack_bf16x2(ds[8 * kk + 2 * r], ds[8 * kk + 2 * r + 1]);
"""),
               ("""    // dQ += dS K
    fence_regs(dq);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(dq, f, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(kv_empty + 8 * s);
  }
  store_cols<D>(""",
                """    // the next tile's scores (this one's again at the last), in flight
    // with dQ += dS K
    const int in = i + 1 < nk ? i + 1 : i;
    const int sn = in % STAGES;
    mbar_wait(kv_full + 8 * sn, (in / STAGES) & 1);
    fence_regs(f);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024),
        desc_sw128(base + L::K_OFF + sn * L::KV_BYTES, 16, 1024));
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        dp, desc_sw128(do_addr, 16, 1024),
        desc_sw128(base + L::V_OFF + sn * L::KV_BYTES, 16, 1024));
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(dq, f, k_addr);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dq);
  store_cols<D>(""")]

# name -> (what it changes, [(text of the committed source, replacement)],
# the kernel it edits, as a key of KERNEL_HEADS[, the kernel whose ptxas
# lines to print when the edit runs another in its place])
VARIANTS = {
    **{f"{kernel}_in_line": (
        "f32 K1 / K2 / K3 on a cluster: the exchange's two rounds in a row, "
        "the last tile's output product after them (not between them: what "
        "the overlap hides)",
        [(f"""    xc.scatter(r);
    if ({i} > 0) {fn}({i} - 1, 0);
    xc.gather(r, {i} & 1, more);
    if ({i} > 0) {fn}({i} - 1, {half});
    xc.collect(r, {i} & 1, more);
""", f"""    xc.scatter(r);
    xc.gather(r, {i} & 1, more);
    xc.collect(r, {i} & 1, more);
    if ({i} > 0) {fn}({i} - 1, 0);
    if ({i} > 0) {fn}({i} - 1, {half});
""")],
        kernel)
       for kernel, i, half, fn in (("flash_fwd_wide_f32", "ik", "HK", "pv"),
                                   ("dq_wide_f32", "ik", "HK", "product"),
                                   ("dkv_wide_f32", "n", "HQ", "product"))},
    "dkv_wide_product_in_flight": (
        "bf16 K3 on a cluster: the last stage's dV / dK product in flight "
        "through this stage's exchange, waited for (and its stage refilled) "
        "after the sums are collected",
        [("""    wgmma_wait<0>();  // the scores and the last stage's product
    fence_regs(sn);
    fence_regs(acc);""", """    wgmma_wait<1>();  // the scores; the product in flight
    fence_regs(sn);"""),
         ("""    bar_sync(2, THREADS);
    load_stage(lead && n >= 1 && n - 1 + STAGES < tiles, n - 1 + STAGES);
    if (next) xc(n + 1).scatter(sn);""", """    if (next) xc(n + 1).scatter(sn);"""),
         ("""      x_n.collect(st, (n >> 1) & 1, n + 2 < tiles);
    }
""", """      x_n.collect(st, (n >> 1) & 1, n + 2 < tiles);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_sync(2, THREADS);
    load_stage(lead && n >= 1 && n - 1 + STAGES < tiles, n - 1 + STAGES);
""")],
        "dkv_wide"),
    "bk128": (
        "128-key K/V stages (m64n128 score products), 2 in the ring",
        [("constexpr int DQ_BK = 64;", "constexpr int DQ_BK = 128;")],
        "dq_wgmma"),
    "s_before_v": (
        "K and V on separate full barriers: S issued once K lands, dP in a "
        "second commit group once V has",
        [("8 * (1 + 2 * DQ_STAGES) + 1024;",
          "8 * (1 + 3 * DQ_STAGES) + 1024;"),
         ("    wgmma_ss<DQ_BK, D / 16, L::Q_CB, L::KV_CB>(\n        dp,",
          "    wgmma_commit();\n"
          "    mbar_wait(empty + 8 * DQ_STAGES + 8 * s, ph);\n"
          "    wgmma_ss<DQ_BK, D / 16, L::Q_CB, L::KV_CB>(\n        dp,"),
         ("      mbar_init(full + 8 * s, 1);\n",
          "      mbar_init(full + 8 * s, 1);\n"
          "      mbar_init(empty + 8 * DQ_STAGES + 8 * s, 1);\n"),
         ("        mbar_arrive_expect_tx(fb, 2 * L::KV_BYTES);\n",
          "        mbar_arrive_expect_tx(fb, L::KV_BYTES);\n"
          "        mbar_arrive_expect_tx(empty + 8 * DQ_STAGES + 8 * s,\n"
          "                              L::KV_BYTES);\n"),
         ("                      &a.tv, fb, cb * 64,",
          "                      &a.tv, empty + 8 * DQ_STAGES + 8 * s, "
          "cb * 64,")],
        "dq_wgmma"),
    "next_scores_in_flight": (
        "d 256: the next key tile's S and dP issued with dQ += dS K (one "
        "commit group, waited for at the next tile), dS in registers of "
        "its own; the last tile's scores formed twice",
        NEXT_SCORES, "dq_rows8"),
    "rows8_d64_next_scores": (
        "d 64 K2: the next key tile's S and dP issued with dQ += dS K, as "
        "next_scores_in_flight at d 256",
        NEXT_SCORES, "dq_rows8<64>"),
    "split_barrier": (
        "d 256 K3: the P^T exchange on a split barrier pair a buffer "
        "(warpgroup 0 arrives once it wrote P^T, warpgroup 1 once it read "
        "it) instead of one bar.sync a stage, so the warpgroups drift and "
        "one's exponentials overlap the other's products",
        [("""    uint32_t* buf = xbuf + (n & 1) * L::XCH;
    {
      float p[BQ / 2];
      dkv_probs<BQ>(p, st, ls, a, q0, key0, key1, tq, need_mask);
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < BQ / 4; ++r)
          buf[r * WG + t] = pack_bf16x2(p[2 * r], p[2 * r + 1]);
      }
    }
    bar_sync(1, 2 * WG);
    if (refill) {  // past the barrier both warpgroups released stage n - 1
""", """    uint32_t* buf = xbuf + (n & 1) * L::XCH;
    if (c == 0) {
      float p[BQ / 2];
      dkv_probs<BQ>(p, st, ls, a, q0, key0, key1, tq, need_mask);
      if (n >= 2) bar_sync(3 + (n & 1), 2 * WG);  // stage n - 2's read
#pragma unroll
      for (int r = 0; r < BQ / 4; ++r)
        buf[r * WG + t] = pack_bf16x2(p[2 * r], p[2 * r + 1]);
      asm volatile("bar.arrive %0, %1;" ::"r"(1 + (n & 1)), "r"(2 * WG)
                   : "memory");
    } else {
      bar_sync(1 + (n & 1), 2 * WG);
    }
    if (refill) {  // once warpgroup 1 released stage n - 1
"""),
         ("""    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
""", """    if (c == 1)  // this buffer is read
      asm volatile("bar.arrive %0, %1;" ::"r"(3 + (n & 1)), "r"(2 * WG)
                   : "memory");
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
"""),
         ("""  bf16* out = static_cast<bf16*>(c == 0 ? a.dv : a.dk) +
""", """  if (c == 0)  // the reads of the last two stages
    for (int m = tiles > 2 ? tiles - 2 : 0; m < tiles; ++m)
      bar_sync(3 + (m & 1), 2 * WG);
  bf16* out = static_cast<bf16*>(c == 0 ? a.dv : a.dk) +
""")],
        "dkv_onepass"),
    "no_turns": (
        "d 256 K1: the warpgroups without the turn barriers, each issuing "
        "its products as soon as its tiles are in",
        [("  if (c == 1) bar_arrive(kTurn, 2 * WG);  // warpgroup 0 issues "
          "first\n", ""),
         ("  mbar_wait(k_full, 0);\n  bar_sync(kTurn + c, 2 * WG);\n",
          "  mbar_wait(k_full, 0);\n"),
         ("  wgmma_commit();\n  bar_arrive(kTurn + 1 - c, 2 * WG);  // the "
          "other warpgroup's turn\n", "  wgmma_commit();\n"),
         ("in one turn\n    bar_sync(kTurn + c, 2 * WG);\n", "\n"),
         ("    wgmma_commit();\n    bar_arrive(kTurn + 1 - c, 2 * WG);  // "
          "the other warpgroup's turn\n", "    wgmma_commit();\n"),
         ("  // warpgroup 1's hand-over after its last issue, which no turn "
          "takes\n  if (c == 0) bar_sync(kTurn, 2 * WG);\n", "")],
        "flash_fwd_rows8"),
    "scores_after": (
        "d 256 K1: no overlap inside a warpgroup: each tile's S, its "
        "softmax, then its P V (the loads still issued while a product is "
        "in flight)",
        [("""  float sc[BK / 2], alpha0, alpha1;
  uint32_t pf[BK / 16][4];  // the last tile's P

  if (c == 1) bar_arrive(kTurn, 2 * WG);  // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  // tile 0: its scores, in this warpgroup's turn, and its P
  mbar_wait(k_full, 0);
  bar_sync(kTurn + c, 2 * WG);
  wgmma_fence();
  wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
      sc, desc_sw128(q_addr, 16, 1024), desc_sw128(base + L::K_OFF, 16, 1024));
  wgmma_commit();
  bar_arrive(kTurn + 1 - c, 2 * WG);  // the other warpgroup's turn
  wgmma_wait<0>();
  fence_regs(sc);
  if (t == 0) mbar_arrive(k_empty);
  fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                  (a.causal && BK - 1 > r0) || BK > a.sk, 0, row0, row1, tq);
  fwd_pack<BK>(pf, sc);
#pragma unroll 1
  for (int i = 1; i < nk; ++i) {
    const int s = i % STAGES, sp = (i - 1) % STAGES;
    const uint32_t ph = (i / STAGES) & 1, php = ((i - 1) / STAGES) & 1;
    const int k0 = i * BK;
    fwd_rescale(o, alpha0, alpha1);
    mbar_wait(k_full + 8 * s, ph);
    mbar_wait(v_full + 8 * sp, php);

    // this tile's S = Q K^T and the last tile's O += P V, in one turn
    bar_sync(kTurn + c, 2 * WG);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024),
        desc_sw128(base + L::K_OFF + s * L::KV_BYTES, 16, 1024));
    wgmma_commit();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(
        o, pf, base + L::V_OFF + sp * L::KV_BYTES);
    wgmma_commit();
    bar_arrive(kTurn + 1 - c, 2 * WG);  // the other warpgroup's turn

    // while both are in flight: K of the next tile and V of this one now,
    // and (testing only) the later tiles whose stages this warpgroup has
    // released
    if (threadIdx.x == 0) {
      next_k = fwd_rows8_refill<D>(a, base, 0, next_k, i + 1,
                                   min(nk, i + STAGES), ikv, ib);
      next_v = fwd_rows8_refill<D>(a, base, 1, next_v, i,
                                   min(nk, i - 1 + STAGES), ikv, ib);
    }

    // this tile's softmax once S is in, P V still in flight (mask only
    // tiles that cross the diagonal or the ragged end)
    wgmma_wait<1>();
    fence_regs(sc);
    if (t == 0) mbar_arrive(k_empty + 8 * s);
    fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(v_empty + 8 * sp);
    fwd_pack<BK>(pf, sc);
  }
  // the last tile's P V
  const int sl = (nk - 1) % STAGES;
  fwd_rescale(o, alpha0, alpha1);
  mbar_wait(v_full + 8 * sl, ((nk - 1) / STAGES) & 1);
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(
      o, pf, base + L::V_OFF + sl * L::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  // warpgroup 1's hand-over after its last issue, which no turn takes
  if (c == 0) bar_sync(kTurn, 2 * WG);
""", """  float alpha0, alpha1;

  if (c == 1) bar_arrive(kTurn, 2 * WG);  // warpgroup 0 issues first
  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = i * BK;
    float sc[BK / 2];
    mbar_wait(k_full + 8 * s, ph);
    bar_sync(kTurn + c, 2 * WG);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024),
        desc_sw128(base + L::K_OFF + s * L::KV_BYTES, 16, 1024));
    wgmma_commit();
    bar_arrive(kTurn + 1 - c, 2 * WG);
    if (threadIdx.x == 0) {
      next_k = fwd_rows8_refill<D>(a, base, 0, next_k, i,
                                   min(nk, i + STAGES), ikv, ib);
      next_v = fwd_rows8_refill<D>(a, base, 1, next_v, i,
                                   min(nk, i + STAGES), ikv, ib);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    if (t == 0) mbar_arrive(k_empty + 8 * s);
    fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    uint32_t pf[BK / 16][4];
    fwd_pack<BK>(pf, sc);
    fwd_rescale(o, alpha0, alpha1);
    mbar_wait(v_full + 8 * s, ph);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(
        o, pf, base + L::V_OFF + s * L::KV_BYTES);
    wgmma_commit();
    if (threadIdx.x == 0) {
      next_k = fwd_rows8_refill<D>(a, base, 0, next_k, i + 1,
                                   min(nk, i + 1 + STAGES), ikv, ib);
      next_v = fwd_rows8_refill<D>(a, base, 1, next_v, i,
                                   min(nk, i + STAGES), ikv, ib);
    }
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(v_empty + 8 * s);
  }
  if (c == 0) bar_sync(kTurn, 2 * WG);
""")],
        "flash_fwd_rows8"),
    "bk64": (
        "d 256 K1: 64-key K/V tiles (m64n64 scores) instead of 80",
        [("  static constexpr int BK = D <= 192 ? 96 : 80;  // keys per K/V "
          "stage", "  static constexpr int BK = 64;")],
        "flash_fwd_rows8"),
    "thread_releases": (
        "d 256 K1: every thread of a warpgroup arrives on the empty "
        "barriers (256 arrivals a release) instead of its thread 0",
        [("      mbar_init(k_empty + 8 * s, 2);  // one arrival a warpgroup\n"
          "      mbar_init(v_empty + 8 * s, 2);\n",
          "      mbar_init(k_empty + 8 * s, 2 * WG);\n"
          "      mbar_init(v_empty + 8 * s, 2 * WG);\n"),
         ("  if (t == 0) mbar_arrive(k_empty);\n", "  mbar_arrive(k_empty);\n"),
         ("    if (t == 0) mbar_arrive(k_empty + 8 * s);\n",
          "    mbar_arrive(k_empty + 8 * s);\n"),
         ("    if (t == 0) mbar_arrive(v_empty + 8 * sp);\n",
          "    mbar_arrive(v_empty + 8 * sp);\n")],
        "flash_fwd_rows8"),
    "refill_in_line": (
        "d 256 K1: thread 0 refills at the top of each tile, before its "
        "warpgroup's turn, instead of while the products are in flight",
        [("""    // while both are in flight: K of the next tile and V of this one now,
    // and (testing only) the later tiles whose stages this warpgroup has
    // released
    if (threadIdx.x == 0) {
      next_k = fwd_rows8_refill<D>(a, base, 0, next_k, i + 1,
                                   min(nk, i + STAGES), ikv, ib);
      next_v = fwd_rows8_refill<D>(a, base, 1, next_v, i,
                                   min(nk, i - 1 + STAGES), ikv, ib);
    }

""", ""),
         ("    fwd_rescale(o, alpha0, alpha1);\n    mbar_wait(k_full + 8 * s, "
          "ph);\n", """    if (threadIdx.x == 0) {
      next_k = fwd_rows8_refill<D>(a, base, 0, next_k, i + 1,
                                   min(nk, i + STAGES), ikv, ib);
      next_v = fwd_rows8_refill<D>(a, base, 1, next_v, i,
                                   min(nk, i - 1 + STAGES), ikv, ib);
    }
""" + "    fwd_rescale(o, alpha0, "
          "alpha1);\n    mbar_wait(k_full + 8 * s, ph);\n")],
        "flash_fwd_rows8"),
    "f32_k2_bk32": (
        "f32 K2 at d 128: 32-key K/V tiles in 3 stages (4 x 2 score tiles "
        "a thread) instead of 64 keys in 2",
        [("  static constexpr int BK = D <= 128 ? 64 : D <= 384 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 64 ? 3 : D <= 192 ? 2 : 1;",
          "  static constexpr int BK = D <= 64 ? 64 : D <= 384 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 128 ? 3 : D <= 192 ? 2 : 1;")],
        "dq_f32"),
    "f32_k2_two_stages_wide": (
        "f32 K2 at d 256 to 384: two stages of 16 keys (4 x 1 and 2 x 1 "
        "score tiles) instead of one of 32",
        [("  static constexpr int BK = D <= 128 ? 64 : D <= 384 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 64 ? 3 : D <= 192 ? 2 : 1;",
          "  static constexpr int BK = D <= 128 ? 64 : D <= 192 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 64 ? 3 : D <= 384 ? 2 : 1;")],
        "dq_f32"),
    "f32_k2_sync_loads": (
        "f32 K2 (and K3) up to d 192: each streamed tile waited for right "
        "after its copies are issued (no load overlapped with arithmetic)",
        [("    if (i + ST - 1 < n) issue(i + ST - 1);\n"
          "    hopper::cp_async_commit();\n  }",
          "    if (i + ST - 1 < n) issue(i + ST - 1);\n"
          "    hopper::cp_async_commit();\n"
          "    hopper::cp_async_wait<0>();\n    __syncthreads();\n  }")],
        "dq_f32"),
    "f32_k3_st3": (
        "f32 K3 at d 128: 3 Q/dO stages instead of 2",
        [("  static constexpr int ST = D <= 192 ? 2 : 1;",
          "  static constexpr int ST = D == 128 ? 3 : D <= 192 ? 2 : 1;")],
        "dkv_f32"),
    "f32_k3_two_stages_wide": (
        "f32 K3 from d 256: two stages of half the query rows (16 at d 256 "
        "to 384, 8 above) instead of one",
        [("  static constexpr int BQ = D <= 64 ? 64 : D <= 384 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 192 ? 2 : 1;",
          "  static constexpr int BQ = D <= 64 ? 64 : D <= 192 ? 32 : D <= "
          "384 ? 16 : 8;\n  static constexpr int ST = 2;")],
        "dkv_f32"),
    "f32_k3_sync_loads": (
        "f32 K3 (and K2) up to d 192: each streamed tile waited for right "
        "after its copies are issued (no load overlapped with arithmetic)",
        [("    if (i + ST - 1 < n) issue(i + ST - 1);\n"
          "    hopper::cp_async_commit();\n  }",
          "    if (i + ST - 1 < n) issue(i + ST - 1);\n"
          "    hopper::cp_async_commit();\n"
          "    hopper::cp_async_wait<0>();\n    __syncthreads();\n  }")],
        "dkv_f32"),
    "f32_no_split": (
        "f32 K3 (and K2): no splits (K3: 128 blocks at b 2 s 1000, 4 KV "
        "heads)",
        [("constexpr int F32_MAX_SPLITS = 4;",
          "constexpr int F32_MAX_SPLITS = 1;")],
        "dkv_f32"),
    "f32_k2_no_split": (
        "f32 K2: no key-range splits (192 blocks at b 2 s 1000 d 256 and "
        "512, where it takes 2)",
        [("  return f32_splits((sq + DqF32<D>::BQ - 1) / DqF32<D>::BQ * h * "
          "batch,\n                    true);",
          "  return 1;")],
        "dq_f32"),
    "f32_split_ceil": (
        "f32 K3: splits rounded up, as K2's (3 at b 2 s 1000 instead of 2)",
        [("                    false);", "                    true);")],
        "dkv_f32"),
    "f32_unroll8": (
        "f32 K2 and K3: the score and output loops unrolled 8 deep "
        "instead of 4",
        [("#pragma unroll 4\n  for (int d = 0; d < D; d += 4) {",
          "#pragma unroll 8\n  for (int d = 0; d < D; d += 4) {"),
         ("#pragma unroll 4\n  for (int r = 0; r < RED; ++r) {",
          "#pragma unroll 8\n  for (int r = 0; r < RED; ++r) {")],
        "dkv_f32"),
    "f32_k1_bk32": (
        "f32 K1 at d 128: 32-key K/V tiles (4 x 2 score tiles a thread) "
        "instead of 64, in 2 stages",
        [("  static constexpr int BK = D <= 256 ? 64 : 32;\n",
          "  static constexpr int BK = D == 128 ? 32 : D <= 256 ? 64 : 32;\n")],
        "flash_fwd_f32"),
    "f32_k1_bk32_st3": (
        "f32 K1 at d 128: 32-key K/V tiles in 3 stages instead of 64 keys "
        "in 2 (3 stages of 64 keys exceed 227 KB)",
        [(F32_K1_TILES,
          "  static constexpr int BK = D == 128 ? 32 : D <= 256 ? 64 : 32;\n"
          "  static constexpr int ST = D <= 128 ? 3 : 1;\n")],
        "flash_fwd_f32"),
    "f32_k1_tiles_8x2": (
        "f32 K1 at d 128: 8 x 2 score tiles a thread (a warp's 32 lanes "
        "share a row; 8 rows and 4 output columns a thread) instead of "
        "4 x 4",
        [("  static constexpr int CT = 16;\n",
          "  static constexpr int CT = D == 128 ? 32 : 16;\n")],
        "flash_fwd_f32"),
    "onepass_d192": (
        "K3 at d 192 on the one pass (dkv_onepass<192>, the other build's "
        "design there) instead of the row split's dkv_wgmma<192>",
        [ONEPASS_D192], "dkv_onepass"),
    "onepass_d192_3_stages": (
        "K3 at d 192 on the one pass with 3 Q/dO stages (3 do not fit at "
        "d 256)",
        [ONEPASS_D192,
         ("  static constexpr int STAGES = 2;\n"
          "  static constexpr int KV_CB = BK * 128;\n",
          "  static constexpr int STAGES = D <= 192 ? 3 : 2;\n"
          "  static constexpr int KV_CB = BK * 128;\n")],
        "dkv_onepass"),
    "onepass_d192_bq96": (
        "K3 at d 192 on the one pass with 96-query stages (m64n96 S^T and "
        "dP^T, two thirds of the stages)",
        [ONEPASS_D192,
         ("  static constexpr int BQ = 64;  // query rows per stage\n",
          "  static constexpr int BQ = D == 192 ? 96 : 64;  // query rows "
          "per stage\n")],
        "dkv_onepass"),
    "f32_k1_d256_bk32_st2": (
        "f32 K1 at d 256: 32-key K/V tiles in 2 stages instead of 64 in 1",
        [(F32_K1_TILES,
          "  static constexpr int BK = D <= 192 ? 64 : 32;\n"
          "  static constexpr int ST = D <= 64 ? 3 : D <= 128 || D == 256 ? "
          "2 : 1;\n")],
        "flash_fwd_f32"),
    "f32_k1_d512_bk16_st2": (
        "f32 K1 at d 512: 16-key K/V tiles in 2 stages instead of 32 in 1",
        [(F32_K1_TILES,
          "  static constexpr int BK = D <= 256 ? 64 : D < 512 ? 32 : 16;\n"
          "  static constexpr int ST = D <= 64 ? 3 : D <= 128 || D == 512 ? "
          "2 : 1;\n")],
        "flash_fwd_f32"),
    "keys8_scores_in_stage": (
        "d 64 K3: each stage issues its own scores, after the first warp's "
        "refill, instead of the last stage issuing them once released",
        [("  if (tiles > 0) mbar_wait(q_full, 0);  // else no stage: nothing "
          "is read\n  dkv_keys8_scores<D>(st, dpt, base, k_addr, 0);\n", ""),
         ("        if (next > n + 1 && !__shfl_sync(",
          "        if (next > n && !__shfl_sync("),
         ("""    // P^T in dO's dtype, as A fragments, once S^T is in (dP^T still in
    // flight)
""", """    mbar_wait(q_full + 8 * s, (n / STAGES) & 1);
    dkv_keys8_scores<D>(st, dpt, base, k_addr, s);
"""),
         ("""    mbar_arrive(q_empty + 8 * s);
    const int nn = n + 1 < tiles ? n + 1 : n;
    mbar_wait(q_full + 8 * (nn % STAGES), (nn / STAGES) & 1);
    fence_regs(st);
    fence_regs(dpt);
    dkv_keys8_scores<D>(st, dpt, base, k_addr, nn % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
""", """    mbar_arrive(q_empty + 8 * s);
  }
""")],
        "dkv_keys8"),
    "keys8_ds_first": (
        "d 64 K3: dS^T formed before dV += P^T dO is issued (both products "
        "then issued together)",
        [("""    // dV += P^T dO, in flight while dS^T forms
    fence_regs(dv);
    fence_regs(fp);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dv, fp, do_addr);
    wgmma_commit();

""", ""),
         ("""    fence_regs(dk);
    fence_regs(fds);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dk, fds, q_addr);
""", """    fence_regs(dv);
    fence_regs(fp);
    fence_regs(dk);
    fence_regs(fds);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dv, fp, do_addr);
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dk, fds, q_addr);
""")],
        "dkv_keys8"),
    "keys8_bq64": (
        "d 64 K3: 64-query stages (m64n64 S^T and dP^T) instead of 128",
        [("  static constexpr int BK = 128;  // keys per block: 64 a "
          "warpgroup\n  static constexpr int BQ = 128;  // query rows per "
          "stage\n",
          "  static constexpr int BK = 128;  // keys per block: 64 a "
          "warpgroup\n  static constexpr int BQ = 64;  // query rows per "
          "stage\n")],
        "dkv_keys8"),
    "keys8_2_stages": (
        "d 64 K3: 2 Q/dO stages instead of 4",
        [(KEYS8_STAGES, KEYS8_STAGES.replace("FIT < 4 ? FIT : 4", "2"))],
        "dkv_keys8"),
    "keys8_5_stages": (
        "d 64 K3: as many Q/dO stages as fit (5 of 128 queries) instead of 4",
        [(KEYS8_STAGES, KEYS8_STAGES.replace("FIT < 4 ? FIT : 4", "FIT"))],
        "dkv_keys8"),
    "onepass_d64": (
        "K3 at d 64 on PR 13's one pass (dkv_onepass<64>: 64 keys a block, "
        "dV on warpgroup 0 and dK on 1, P^T exchanged through shared "
        "memory) instead of dkv_keys8<64>",
        [("  return d == 64 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kKeys8)\n",
          "  return d == 64 ? kOnePass\n")],
        "dkv_keys8", "dkv_onepass"),
    "rows8_d64_bk128": (
        "d 64 K2: 128-key K/V stages (m64n128 S and dP: 186 registers, one "
        "block a SM) instead of 64 (122: two blocks a SM)",
        [(DQ_ROWS8_BK[0], "  static constexpr int BK = D <= 64 ? 128 : D "
          "== 192 ? 64 : 32;\n")],
        "dq_rows8<64>"),
    "rows8_d64_2_stages": (
        "d 64 K2: 2 K/V stages instead of 4",
        [("  static constexpr int STAGES = FIT < 4 ? FIT : 4;\n"
          "  static constexpr int DO_OFF = Q_BYTES;\n",
          "  static constexpr int STAGES = D == 64 ? 2 : FIT < 4 ? FIT : 4;\n"
          "  static constexpr int DO_OFF = Q_BYTES;\n")],
        "dq_rows8<64>"),
    "rows8_split_commit": (
        "K2 on 8 warps: S and dP in two commit groups, P formed while dP "
        "is in flight (SPLIT, shipped at d 192)",
        [(DQ_SPLIT, DQ_SPLIT.replace("D == 192", "true"))],
        "dq_rows8<64>"),
    "f32_k1_d512_bq64": (
        "f32 K1 at d 512: 64-row blocks (4 x 1 score tiles, 128 output "
        "floats a thread) over one stage of 16 keys, instead of 32 rows "
        "over 32 keys",
        [("  static constexpr int BQ = D <= 256 ? 64 : 32;\n"
          "  static constexpr int BK = D <= 256 ? 64 : 32;\n",
          "  static constexpr int BQ = D <= 256 || D == 512 ? 64 : 32;\n"
          "  static constexpr int BK = D <= 256 ? 64 : D < 512 ? 32 : 16;\n")],
        "flash_fwd_f32"),
    "fwd_d64_wgmma": (
        "d 64 K1 on the row split (flash_fwd_wgmma<64>: 12 warps, one block "
        "a SM, 128-key stages, each consumer's softmax between its "
        "products; the other build's)",
        [(FWD_D64, "  return d == 64    ? kRowSplit\n")], "flash_fwd_twin",
        "flash_fwd_wgmma"),
    "fwd_d64_rows8": (
        "d 64 K1 on the d 256 design as it is (flash_fwd_rows8<64>: one "
        "block a SM, 96-key tiles, turns, S(i) beside P V(i - 1))",
        fwd_d64_rows8(), "flash_fwd_twin", "flash_fwd_rows8"),
    "fwd_d64_rows8_bk128": (
        "d 64 K1 on flash_fwd_rows8 with 128-key tiles (one block a SM)",
        fwd_d64_rows8(128), "flash_fwd_twin", "flash_fwd_rows8"),
    "fwd_d64_rows8_two_blocks": (
        "d 64 K1 on flash_fwd_rows8 at two blocks a SM (at most 128 "
        "registers a thread), 64-key tiles, with the turns",
        fwd_d64_rows8(64, 2), "flash_fwd_twin", "flash_fwd_rows8"),
    "twin_bk64": (
        "d 64 K1: flash_fwd_twin on 64-key tiles instead of 128",
        [(TWIN_BK, TWIN_BK.replace("128", "64"))], "flash_fwd_twin"),
    "twin_bk96": (
        "d 64 K1: flash_fwd_twin on 96-key tiles instead of 128",
        [(TWIN_BK, TWIN_BK.replace("128", "96"))], "flash_fwd_twin"),
    "twin_one_block": (
        "d 64 K1: flash_fwd_twin at one block a SM (no register cap)",
        [(TWIN_BLOCKS, TWIN_BLOCKS.replace("= 2", "= 1"))],
        "flash_fwd_twin"),
    "twin_three_blocks_bk32": (
        "d 64 K1: flash_fwd_twin at three blocks a SM (at most 85 registers "
        "a thread) on 32-key tiles",
        [(TWIN_BK, TWIN_BK.replace("128", "32")),
         (TWIN_BLOCKS, TWIN_BLOCKS.replace("= 2", "= 3"))],
        "flash_fwd_twin"),
    "twin_turns": (
        "d 64 K1: flash_fwd_twin with a block's two warpgroups taking turns "
        "at issuing S (FlashAttention-3's ping-pong)",
        [("  mbar_wait(q_full, 0);\n#pragma unroll 1\n",
          "  if (c == 1) bar_arrive(kTurn, 2 * WG);  // warpgroup 0 first\n"
          "  mbar_wait(q_full, 0);\n#pragma unroll 1\n"),
         ("    mbar_wait(k_full + 8 * s, ph);\n    wgmma_fence();\n"
          "    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(\n"
          "        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, "
          "1024));\n    wgmma_commit();\n    // while it is in flight",
          "    mbar_wait(k_full + 8 * s, ph);\n"
          "    bar_sync(kTurn + c, 2 * WG);\n    wgmma_fence();\n"
          "    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(\n"
          "        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, "
          "1024));\n    wgmma_commit();\n"
          "    bar_arrive(kTurn + 1 - c, 2 * WG);\n    // while it is in "
          "flight"),
         ("  fwd_finish<D>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0, "
          "true);\n}\n\n// ------------------------------------------------ "
          "f32",
          "  if (c == 0) bar_sync(kTurn, 2 * WG);\n"
          "  fwd_finish<D>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0, "
          "true);\n}\n\n// ------------------------------------------------ "
          "f32")],
        "flash_fwd_twin"),
    "twin_q_regs": (
        "d 64 K1: S = Q K^T with Q's fragments in registers (loaded once "
        "from the swizzled tile; wgmma with A from registers, B K-major) "
        "instead of both operands from shared memory",
        FWD_Q_REGS, "flash_fwd_twin"),
    "twin_short_chains": (
        "d 64 K1: the softmax's row maxima and sums as four independent "
        "chains a row each instead of one",
        [FWD_MAX_CHAINS, fwd_sum_chains(0)], "flash_fwd_twin"),
    "twin_exp2_fma_4": (
        "d 64 K1: twin_short_chains, and a quarter of the exp2 (every 4th "
        "group of 8 keys) on the FMA pipes by a degree-3 polynomial",
        [FWD_EXP2_FMA, FWD_MAX_CHAINS, fwd_sum_chains(4)], "flash_fwd_twin"),
    "twin_exp2_fma_8": (
        "d 64 K1: twin_short_chains, and an eighth of the exp2 (every 8th "
        "group of 8 keys) on the FMA pipes",
        [FWD_EXP2_FMA, FWD_MAX_CHAINS, fwd_sum_chains(8)], "flash_fwd_twin"),
    "dq_d192_wgmma": (
        "d 192 K2 on the row split (dq_wgmma<192>: 12 warps, 5 stages of "
        "32 keys) instead of dq_rows8<192>",
        [(DQ_DESIGN, "  return d == 64 || d == 256\n"
                     "             ? (FLASH_OTHER_DESIGNS ? kRowSplit : "
                     "kRows8)\n"
                     "         : d <= 192 ? kRowSplit\n")],
        "dq_rows8<192>", "dq_wgmma"),
    "dq_d192_bk32": (
        "d 192 K2: 32-key K/V stages (m64n32 S and dP), 4 in the ring, "
        "instead of 2 of 64",
        [DQ_ROWS8_BK], "dq_rows8<192>"),
    "dq_d192_bk32_5_stages": (
        "d 192 K2: 5 K/V stages of 32 keys (as many as fit) instead of 2 "
        "of 64",
        [DQ_ROWS8_BK, (DQ_ROWS8_STAGES, DQ_ROWS8_STAGES.replace(
            "= FIT < 4", "= D == 192 ? FIT : FIT < 4"))],
        "dq_rows8<192>"),
}
# flash_fwd_rows8 at d 64 on two blocks a SM without the turns (no_turns'
# edits), on 64- and 80-key tiles
for _bk in (64, 80):
    VARIANTS[f"fwd_d64_rows8_two_blocks_bk{_bk}_no_turns"] = (
        f"d 64 K1 on flash_fwd_rows8 at two blocks a SM, {_bk}-key tiles, "
        "without the turns",
        [*fwd_d64_rows8(_bk, 2), *VARIANTS["no_turns"][1]], "flash_fwd_twin",
        "flash_fwd_rows8")
# K3 at d 384 and 512: dkv_pair's variants, and dkv_split (the other
# build's design) timed in the same turns
VARIANTS.update({
    "pair_d384_plain": (
        "d 384 K3 as first built: two stages, no prefetch (but one receive "
        "buffer)",
        pair_at(384, stages=2, prefetch=False), "dkv_pair<384>"),
    "pair_d384_plain_3_stages": (
        "d 384 K3: three stages without the prefetch",
        pair_at(384, prefetch=False), "dkv_pair<384>"),
    "pair_d384_prefetch_2_stages": (
        "d 384 K3: the prefetch on two stages",
        [*pair_at(384, stages=2), PAIR_PREFETCH_WAIT], "dkv_pair<384>"),
    "pair_d384_bq32": (
        "d 384 K3: 32-query stages (m64n32 partials, 8 KB a warpgroup to "
        "exchange), 4, no prefetch",
        pair_at(384, bq=32, stages=4, prefetch=False), "dkv_pair<384>"),
    "pair_d384_split": (
        "d 384 K3 on the D split (dkv_split<384>: two passes, 32-query "
        "stages; the other build's design)",
        [design_at("dkv", 384)], "dkv_pair<384>", "dkv_split"),
    "pair_d512_bq32": (
        "d 512 K3: 32-query stages, 4",
        pair_at(512, bq=32, stages=4), "dkv_pair<512>"),
    "pair_d512_prefetch": (
        "d 512 K3: the next stage's partial in flight during the exchange "
        "(32 more registers a thread beside the 128 of the accumulator)",
        [*pair_at(512, prefetch=True), PAIR_PREFETCH_WAIT], "dkv_pair<512>"),
    **{f"pair_d{_d}_warp_arrivals": (
        f"d {_d} K3: every warp arrives on the peer's freed barrier once it "
        "has issued its product (8 arrivals, no named barrier)",
        PAIR_WARP_ARRIVALS, f"dkv_pair<{_d}>") for _d in (384, 512)},
    **{f"pair_d{_d}_warp_arrivals_first": (
        f"d {_d} K3: every warp arrives on the peer's freed barrier before "
        "it issues its product",
        [*PAIR_WARP_ARRIVALS, (PAIR_RELEASE, ""),
         (PAIR_PRODUCT, PAIR_RELEASE + PAIR_PRODUCT)],
        f"dkv_pair<{_d}>") for _d in (384, 512)},
    "pair_d384_prefetch_every_stage": (
        "d 384 K3: the prefetch issued on the last stage too (that stage's "
        "scores again, unused)",
        [PAIR_PREFETCH_EVERY], "dkv_pair<384>"),
    "pair_d384_prefetch_taken_if_next": (
        "d 384 K3: the prefetch's result taken only while there is a next "
        "stage (C7515)",
        [PAIR_PREFETCH_TAKE], "dkv_pair<384>"),
    "pair_d512_split": (
        "d 512 K3 on the D split (dkv_split<512>: two passes, 16-query "
        "stages; the other build's design)",
        [design_at("dkv", 512)], "dkv_pair<512>", "dkv_split"),
})
# K3 at d 320 and 448: the pair padded to d 384's and d 512's columns a
# block (rank 1's last 64 are TMA's zeros), its stages and prefetch as at
# those dims and the other way, and dkv_split (the other build's design)
VARIANTS.update({
    "pair_d320_plain_3_stages": (
        "d 320 K3: three stages without the prefetch",
        pair_at(320, prefetch=False), "dkv_pair<320>"),
    "pair_d320_plain": (
        "d 320 K3: two stages, no prefetch",
        pair_at(320, stages=2, prefetch=False), "dkv_pair<320>"),
    "pair_d320_prefetch_2_stages": (
        "d 320 K3: the prefetch on two stages",
        [*pair_at(320, stages=2), PAIR_PREFETCH_WAIT], "dkv_pair<320>"),
    "pair_d320_split": (
        "d 320 K3 on the D split (dkv_split<320>: two passes, 32-query "
        "stages; the other build's design)",
        [design_at("dkv", 320)], "dkv_pair<320>", "dkv_split"),
    "pair_d448_prefetch": (
        "d 448 K3: the next stage's partial in flight during the exchange "
        "(32 more registers a thread beside the 128 of the accumulator)",
        [*pair_at(448, prefetch=True), PAIR_PREFETCH_WAIT], "dkv_pair<448>"),
    "pair_d448_bq32": (
        "d 448 K3: 32-query stages, 4",
        pair_at(448, bq=32, stages=4), "dkv_pair<448>"),
    "pair_d448_split": (
        "d 448 K3 on the D split (dkv_split<448>: two passes, 16-query "
        "stages; the other build's design)",
        [design_at("dkv", 448)], "dkv_pair<448>", "dkv_split"),
})
# K1 and K2 at d 384 and 512 on a pair of blocks (flash_fwd_pair,
# dq_pair): K1's stages, key tiles and prefetch; who arrives on the twin's
# `freed` barrier (thread 0 of the warpgroup past a named barrier of it,
# or every warp); K2's key tiles and prefetch; and the other build's
# designs, timed in the same turns
VARIANTS.update({
    "fwd_pair_2_stages": (
        "d 384 K1 on the pair: two K/V stages of 64 keys, not three",
        [(ROWS_PAIR_STAGES, ROWS_PAIR_STAGES.replace("D == 384 ? 3 : 2",
                                                     "2"))],
        "flash_fwd_pair<384>"),
    "fwd_pair_no_prefetch": (
        "d 384 K1 on the pair: each tile's partial S issued only once the "
        "last tile's P V is in (no prefetch during the exchange)",
        [(ROWS_PAIR_PREFETCH, ROWS_PAIR_PREFETCH.replace("D == 384",
                                                         "false"))],
        "flash_fwd_pair<384>"),
    **{f"fwd_pair_d512_bk48{'_prefetch' * _p}": (
        "d 512 K1 on the pair: 48-key tiles in two stages (a third does not "
        "fit either; 24 score registers a thread instead of 32)"
        + (", the next tile's partial S during the exchange" if _p else ""),
        [WGMMA_N48,
         (FWD_PAIR_BK,
          FWD_PAIR_BK.replace("BK = 64", "BK = D == 512 ? 48 : 64")),
         *([(ROWS_PAIR_PREFETCH, ROWS_PAIR_PREFETCH.replace("D == 384",
                                                            "true"))]
           if _p else [])],
        "flash_fwd_pair<512>") for _p in (False, True)},
    "fwd_pair_d512_prefetch": (
        "d 512 K1 on the pair: the next tile's partial S issued during this "
        "one's exchange, on two stages (thread 0 waits every tile for the "
        "other warpgroup's release of the tile before)",
        [(ROWS_PAIR_PREFETCH, ROWS_PAIR_PREFETCH.replace("D == 384",
                                                         "true"))],
        "flash_fwd_pair<512>"),
    **{f"fwd_pair{'' if _d == 384 else '_d512'}_warp_arrivals": (
        f"d {_d} K1 on the pair: every warp arrives on the twin's freed "
        "barrier once it has issued its P V (4 arrivals, no named barrier)",
        PAIR_WARP_ARRIVALS, f"flash_fwd_pair<{_d}>") for _d in (384, 512)},
    **{f"fwd_pair{'' if _d == 384 else '_d512'}_split": (
        f"d {_d} K1 on the D split (flash_fwd_split<{_d}>: 64 rows a block, "
        "32-key stages; the other build's design)",
        [design_at("fwd", _d)], f"flash_fwd_pair<{_d}>", "flash_fwd_split")
        for _d in (384, 512)},
    "dq_pair_warp_arrivals": (
        "d 512 K2 on the pair: every warp arrives on the twin's freed "
        "barrier once it has issued its dQ product",
        PAIR_WARP_ARRIVALS, "dq_pair<512>"),
    "dq_pair_bk64_one_stage": (
        "d 512 K2 on the pair: one K/V stage of 64 keys (m64n64 score "
        "products), the exchange in two rounds of 32 keys",
        [(DQ_PAIR_BK,
          DQ_PAIR_BK.replace("BK = 32", "BK = D == 512 ? 64 : 32")),
         (DQ_PAIR_STAGES, DQ_PAIR_STAGES.replace("4 : 2", "4 : 1"))],
        "dq_pair<512>"),
    "dq_pair_split": (
        "d 512 K2 on the D split (dq_split<512>: 64 rows a block, 16-key "
        "stages; the other build's design)",
        [design_at("dq", 512)], "dq_pair<512>", "dq_split"),
    # K2 at d 384 ships dq_split (the committed build's), the pair lost
    # to it: each variant runs the pair there
    "dq_pair_d384": (
        "d 384 K2 on the pair (the other build's design): four stages of 32 "
        "keys, the next tile's partial S and dP during the exchange",
        [design_at("dq", 384, "kPair")], "dq_pair<384>", "dq_pair"),
    "dq_pair_d384_no_prefetch": (
        "d 384 K2 on the pair: four stages of 32 keys, each tile's partial "
        "S and dP issued only once the last tile's dQ product is in",
        [design_at("dq", 384, "kPair"),
         (DQ_PAIR_PREFETCH, DQ_PAIR_PREFETCH.replace("STAGES > 2", "false"))],
        "dq_pair<384>", "dq_pair"),
    "dq_pair_d384_bk64": (
        "d 384 K2 on the pair: two K/V stages of 64 keys (dq_rows8<192>'s "
        "tiles), the exchange in two rounds of 32 keys, no prefetch",
        [design_at("dq", 384, "kPair"),
         (DQ_PAIR_BK,
          DQ_PAIR_BK.replace("BK = 32", "BK = D == 384 ? 64 : 32")),
         (DQ_PAIR_STAGES, DQ_PAIR_STAGES.replace("D == 384 ? 4 : 2", "2"))],
        "dq_pair<384>", "dq_pair"),
    "dq_pair_d384_warp_arrivals": (
        "d 384 K2 on the pair: every warp arrives on the twin's freed "
        "barrier once it has issued its dQ product",
        [design_at("dq", 384, "kPair"), *PAIR_WARP_ARRIVALS], "dq_pair<384>",
        "dq_pair"),
})
# K2's SPLIT flag off at d 192
VARIANTS["dq_d192_one_commit"] = (
    "d 192 K2: S and dP in one commit group, waited for together (SPLIT "
    "off), as at d 64 and 256",
    [(DQ_SPLIT, DQ_SPLIT.replace("D == 192", "false"))], "dq_rows8<192>")
# the streamed bf16 K1 and K2 (column groups): their ring's layout and
# refill, and the cost of launching a row tile's groups as one cluster
# (the placement a cluster design of them would have)
WIDE_K1_RING = """  static constexpr int V_STAGES = 1;
  static constexpr int FIT = (SMEM_MAX - 2048 - V_STAGES * V_BYTES) / STEP;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;"""
WIDE_K1_TILE = """  static constexpr int BK = 128;  // keys a tile
  static constexpr int Q_BYTES = BQ * ROW;  // a chunk of Q"""
WIDE_K2_RING = """  static constexpr int KG_STAGES = 1;
  static constexpr int FIT =
      (SMEM_MAX - 2048 - KG_STAGES * KG_BYTES) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;"""


def wide_refill_after_barrier(own: str, product: str) -> list:
    """The streamed K1's (``own`` "v") or K2's ("kg") refills after the
    step's named barrier, of the step's own stage (as before they moved
    into the next step's wgmma window), and its output product's tile
    loaded at the tile's first step."""
    fill, pad = ("VS", 13) if own == "v" else ("KS", 14)
    return [(f"""      // while they run: step j - 1's stage (both warpgroups read it before
      // the named barrier that ended step j - 1) takes step j - 1 + STAGES,
      // and past the last tile's {product} in both (step j - 1's barrier at cc
      // 1), its {"V stage" if own == "v" else "stage of K"} takes tile i + {fill} - 1
      load_step(issuer && j >= 1 && j - 1 + STAGES < steps, j - 1 + STAGES);
      load_{own}(issuer && part == 1 && cc == 1 && i >= 1 && i + {fill} - 1 < nk,
{" " * pad}i + {fill} - 1);
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other
""", f"""      wgmma_wait<0>();
      bar_sync(1, THREADS);
      // (variant: the refills after the barrier)
      load_step(issuer && j + STAGES < steps, j + STAGES);
      load_{own}(issuer && part == 1 && cc == 0 && i >= 1 && i + {fill} - 1 < nk,
{" " * pad}i + {fill} - 1);
""")]


VARIANTS.update({
    "flash_fwd_wide_two_v": (
        "streamed K1 with two V tiles and 3 ring steps",
        [(WIDE_K1_RING, WIDE_K1_RING.replace("V_STAGES = 1", "V_STAGES = 2")
          .replace("FIT < 8 ? FIT : 8", "FIT < 6 ? FIT : 6"))],
        "flash_fwd_wide"),
    "flash_fwd_wide_refill_after_barrier": (
        "streamed K1 refilling past the named barrier",
        wide_refill_after_barrier("v", "P V"), "flash_fwd_wide"),
    **{f"flash_fwd_wide_bk{bk}": (
        f"streamed K1 on {bk}-key tiles (m64n{bk} scores)",
        [(WIDE_K1_TILE, WIDE_K1_TILE.replace("BK = 128;", f"BK = {bk};"))],
        "flash_fwd_wide") for bk in (64, 96)},
    "flash_fwd_wide_bk64_two_v_after_barrier": (
        "streamed K1 as it was on 64-key tiles: two V tiles, 6 ring steps, "
        "the refills after the named barrier",
        [(WIDE_K1_TILE, WIDE_K1_TILE.replace("BK = 128;", "BK = 64; ")),
         (WIDE_K1_RING, WIDE_K1_RING.replace("V_STAGES = 1", "V_STAGES = 2")
          .replace("FIT < 8 ? FIT : 8", "FIT < 6 ? FIT : 6")),
         *wide_refill_after_barrier("v", "P V")],
        "flash_fwd_wide"),
    "flash_fwd_wide_on_clusters": (
        "streamed K1's column groups launched as clusters of a row tile's "
        "groups (a cluster's placement, nothing shared)",
        [("  return launch(flash_fwd_wide<FWD_W>, a.nq * a.groups * h * "
          "batch, THREADS,\n                L::BYTES, stream, a);",
          "  return launch_cluster(flash_fwd_wide<FWD_W>, a.nq * a.groups * "
          "h * batch,\n                        a.groups, THREADS, L::BYTES, "
          "stream, a);")],
        "flash_fwd_wide"),
    "dq_wide_two_kg": (
        "streamed K2 with two tiles of K's columns and 4 ring steps",
        [(WIDE_K2_RING, WIDE_K2_RING.replace("KG_STAGES = 1",
                                             "KG_STAGES = 2"))],
        "dq_wide"),
    "dq_wide_refill_after_barrier": (
        "streamed K2 refilling past the named barrier",
        wide_refill_after_barrier("kg", "dS K"), "dq_wide"),
    "dq_wide_on_clusters": (
        "streamed K2's column groups launched as clusters of a row tile's "
        "groups (a cluster's placement, nothing shared)",
        [("  return launch(dq_wide<DQ_W>, a.nq * a.groups * h * batch, "
          "THREADS,\n                L::BYTES, stream, a);",
          "  return launch_cluster(dq_wide<DQ_W>, a.nq * a.groups * h * "
          "batch,\n                        a.groups, THREADS, L::BYTES, "
          "stream, a);")],
        "dq_wide"),
})
# the heads (query, KV, head dim) each edited kernel is checked and timed
# at: bench_800m's, phase 12's, chip_smoke.py's KERNEL_ONLY_HEADS' (d 320
# and 448) and Llama-3.2-1B's (a kernel template at a
# head dim other than its first, or timed at two, is keyed
# "<kernel><<d>>", quoted on the command line)
KERNEL_HEADS = {"dq_wgmma": (12, 4, 128), "dq_rows8": (6, 2, 256),
                "dq_rows8<64>": (32, 8, 64), "dkv_keys8": (32, 8, 64),
                "dkv_onepass": (6, 2, 256), "flash_fwd_rows8": (6, 2, 256),
                "flash_fwd_twin": (32, 8, 64),
                "dq_rows8<192>": cs.WIDE_HEADS["bench_800m_d192"],
                "dkv_pair<512>": cs.WIDE_HEADS["bench_800m_d512"],
                "dkv_pair<384>": cs.WIDE_HEADS["bench_800m_d384"],
                "dkv_pair<320>": cs.KERNEL_ONLY_HEADS["d320"],
                "dkv_pair<448>": cs.KERNEL_ONLY_HEADS["d448"],
                "flash_fwd_pair<384>": cs.WIDE_HEADS["bench_800m_d384"],
                "flash_fwd_pair<512>": cs.WIDE_HEADS["bench_800m_d512"],
                "dq_pair<512>": cs.WIDE_HEADS["bench_800m_d512"],
                "dq_pair<384>": cs.WIDE_HEADS["bench_800m_d384"],
                "dq_f32": (12, 4, 128), "dkv_f32": (12, 4, 128),
                "flash_fwd_f32": (12, 4, 128),
                **{key: cs.WIDE_HEADS["bench_800m_d768"]
                   for key in (*cs.WIDE_F32_KERNELS.values(), "dkv_wide",
                               "flash_fwd_wide", "dq_wide")}}
# the dtype each kernel runs in (bf16 unless named) and the shapes (b, s,
# heads, KV heads, head dim) it is timed at (the training shape at its
# KERNEL_HEADS unless named: the f32 kernels at chip_smoke.py's
# F32_SHAPES, the first of which holds their targets; dkv_onepass also at
# bench_800m_d192's heads; the d 64 kernels at the fine-tuning shape, b 4
# s 2048; the streamed f32 kernels at b 2 s 1000, as phase 3 times them,
# at bench_800m_d768's heads and at d 2048's: K1's group width changes its
# recompute most there (4.5x at W 256, 2.5x at W 512), and K2 and K3 run
# their largest cluster, 8 blocks; bf16's dkv_wide at the training shape
# at the same heads)
KERNEL_DTYPES = {"dq_f32": torch.float32, "dkv_f32": torch.float32,
                 "flash_fwd_f32": torch.float32,
                 **{key: torch.float32
                    for key in cs.WIDE_F32_KERNELS.values()}}
WIDE_F32_SHAPES = [(2, cs.PROMPT, *cs.WIDE_HEADS["bench_800m_d768"]),
                   (2, cs.PROMPT, *cs.KERNEL_ONLY_HEADS["d2048"])]
KERNEL_SHAPES = {
    "dq_f32": list(cs.F32_SHAPES.values()),
    "dkv_f32": list(cs.F32_SHAPES.values()),
    "flash_fwd_f32": list(cs.F32_SHAPES.values()),
    "dq_rows8<64>": [(cs.FT_BATCH, cs.FT_SEQ, *KERNEL_HEADS["dq_rows8<64>"])],
    "flash_fwd_twin": [(cs.FT_BATCH, cs.FT_SEQ,
                        *KERNEL_HEADS["flash_fwd_twin"])],
    "dq_rows8<192>": [(cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                       *KERNEL_HEADS["dq_rows8<192>"])],
    **{key: [(cs.TRAIN_BATCH, cs.TRAIN_SEQ, *KERNEL_HEADS[key])]
       for key in ("dkv_pair<512>", "dkv_pair<384>", "dkv_pair<320>",
                   "dkv_pair<448>", "flash_fwd_pair<384>",
                   "flash_fwd_pair<512>", "dq_pair<512>", "dq_pair<384>")},
    "dkv_keys8": [(cs.FT_BATCH, cs.FT_SEQ, *KERNEL_HEADS["dkv_keys8"])],
    "dkv_onepass": [(cs.TRAIN_BATCH, cs.TRAIN_SEQ, *KERNEL_HEADS[
        "dkv_onepass"]), (cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                          *cs.WIDE_HEADS["bench_800m_d192"])],
    **{key: WIDE_F32_SHAPES for key in cs.WIDE_F32_KERNELS.values()},
    **{key: [(cs.TRAIN_BATCH, cs.TRAIN_SEQ, *shape[2:])
             for shape in WIDE_F32_SHAPES]
       for key in ("dkv_wide", "flash_fwd_wide", "dq_wide")}}


def template_of(kernel: str) -> str:
    """The kernel template a KERNEL_HEADS key names (``dq_rows8<64>``:
    ``dq_rows8``)."""
    return kernel.split("<")[0]


def source_of(kernel: str) -> str:
    """The csrc/ source (without .cu) that holds ``kernel``."""
    if "_wide" in kernel:
        return cs.WIDE_SOURCE
    return "flash_fwd" if kernel.startswith("flash_fwd") else "flash_bwd"


def committed_files(source: str, csrc: Path | None = None) -> dict:
    """``<csrc>/<source>.cu`` and the headers beside it (the kernels' shared
    building blocks), {file name: text}; ``csrc`` is the port's csrc/
    unless given."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    csrc = csrc or _build.CSRC
    return {f.name: f.read_text()
            for f in (csrc / f"{source}.cu", *sorted(csrc.glob("*.cuh")))}


def variant_files(name: str, files: dict) -> dict:
    """The committed files ({file name: text}, ``committed_files``) with
    variant ``name``'s edits applied, each to the one file that holds its
    text: every edit's text must be found exactly once among them."""
    files = dict(files)
    for old, new in VARIANTS[name][1]:
        counts = {f: text.count(old) for f, text in files.items()}
        if sum(counts.values()) != 1:
            raise ValueError(f"{name}: {old!r} is not in the source and its "
                             "headers exactly once; update VARIANTS")
        f = max(counts, key=counts.get)
        files[f] = files[f].replace(old, new)
    return files


def _compile(job: tuple[str, str]) -> tuple[Path, str]:
    """Build ``source`` as committed, with variant ``name``'s edits, or
    (``baseline``) from the ``--baseline`` tree's csrc/."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    name, source = job
    d = OUT / name / source
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(BASELINE[0] if name == "baseline" else _build.CSRC, d)
    if name in VARIANTS:
        for f, text in variant_files(name,
                                     committed_files(source, d)).items():
            (d / f).write_text(text)
    lib = d / f"lib{source}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(d / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name} {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas's lines for ``kernel``: registers, spills and C75xx notes."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
            if keep:
                out.append(line.strip())
        elif "C75" in line and kernel in line:
            out.append(line.strip())
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def _use(lib: Path, source: str) -> None:
    """Route the port's wrappers of ``source``'s kernels to this build."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    _build._libs[source] = ctypes.CDLL(str(lib))


def _calls(kind: str, fa, dtype=torch.bfloat16):
    """The wrapper of a kernel kind (K1 "fwd", K2 "dq", K3 "dkv") and its
    plain version, each taking (q, k, v, do, lse, delta) and returning a
    tuple of outputs, and their tolerances [(atol, rtol)] per output in
    ``dtype``."""
    if kind == "fwd":
        return ((lambda q, k, v, *_: fa.flash_fwd(q, k, v, True)),
                (lambda q, k, v, *_: fa.flash_fwd_reference(q, k, v, True)),
                [cs.TOL[dtype], (cs.LSE_ATOL, 0.0)])
    fn = getattr(fa, f"flash_bwd_{kind}")
    plain = getattr(fa, f"flash_bwd_{kind}_reference")

    def tupled(f):
        def call(*args):
            out = f(*args, True)
            return out if isinstance(out, tuple) else (out,)
        return call
    return (tupled(fn), tupled(plain),
            [cs.BWD_TOL[dtype]] * (2 if kind == "dkv" else 1))


def main() -> int:
    from service_account_auth_improvements_tpu_torch.ops import (
        _build,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kernels", nargs="*", metavar="kernel")
    parser.add_argument("--baseline", type=Path, metavar="DIR",
                        help="another tree's csrc/ directory, built, checked "
                             "and timed as the variant 'baseline'")
    parser.add_argument("--no-variants", action="store_true",
                        help="time only the committed source (and the "
                             "baseline)")
    args = parser.parse_args()
    cs.phase_device()
    chosen = args.kernels or list(KERNEL_HEADS)
    unknown = set(chosen) - set(KERNEL_HEADS)
    if unknown:
        raise SystemExit(f"kernel_variants: no such kernels {unknown}")
    names = [] if args.no_variants else [
        n for n in VARIANTS if VARIANTS[n][2] in chosen]
    sources = [src for src in ("flash_fwd", "flash_bwd", cs.WIDE_SOURCE)
               if any(source_of(k) == src for k in chosen)]
    if args.baseline:
        BASELINE.append(args.baseline.resolve())
    jobs = [*(("committed", src) for src in sources),
            *(("baseline", src) for src in sources if BASELINE),
            *((name, source_of(VARIANTS[name][2])) for name in names)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(_compile, jobs)))
    for name, source in jobs:
        what = (VARIANTS[name][0] if name in VARIANTS else
                f"as in {BASELINE[0]}" if name == "baseline" else
                "as committed")
        cs._log(f"variant {name} ({source}.cu): {what}")
        kernels = ([VARIANTS[name][-1]] if name in VARIANTS else
                   [k for k in chosen if source_of(k) == source])
        for kernel in dict.fromkeys(map(template_of, kernels)):
            for line in _ptxas_lines(built[name, source][1], kernel):
                cs._log(f"  ptxas: {line}")

    gen = torch.Generator(device="cuda").manual_seed(5)
    for kernel in chosen:
        h, hkv, d = KERNEL_HEADS[kernel]
        timed = KERNEL_SHAPES.get(
            kernel, [(cs.TRAIN_BATCH, cs.TRAIN_SEQ, h, hkv, d)])
        dtype = KERNEL_DTYPES.get(kernel, torch.bfloat16)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        group = [*(["baseline"] if BASELINE else []),
                 *(n for n in names if VARIANTS[n][2] == kernel)]
        source = source_of(kernel)
        # K1 (O, LSE), K2 (dQ) or K3 (dK, dV): the wrapper, its plain
        # version, the tolerances and the bound
        kind = ("fwd" if kernel.startswith("flash_fwd") else
                "dkv" if kernel.startswith("dkv") else "dq")
        fn, plain, tols = _calls(kind, fa, dtype)
        for name in ["committed", *group]:
            _use(built[name, source][0], source)
            per_dim = source != cs.WIDE_SOURCE
            if kind == "fwd" and dtype == torch.bfloat16 and per_dim:
                cs._log(f"variant {name}: K1 at d{d} holds "
                        f"{_build._libs[source].flash_fwd_blocks_per_sm(d)} "
                        "blocks a SM")
            if dtype == torch.bfloat16 and per_dim:
                n = getattr(_build._libs[source],
                            "flash_fwd_clusters" if kind == "fwd" else
                            f"flash_bwd_{kind}_clusters")(d)
                if n >= 0:
                    cs._log(f"variant {name}: {kind} at d{d} holds {n} "
                            "clusters of two blocks")
            ragged = 1000 if dtype == torch.bfloat16 else 129
            # a ragged length at the heads of each timed shape
            heads = dict.fromkeys(shape[2:] for shape in timed)
            for shape in (*((2, ragged, *hd) for hd in heads), *timed):
                q, k, v, do, o, lse = cs._bwd_inputs(*shape, dtype, gen,
                                                     True)
                delta = fa.flash_bwd_delta(o, do)
                inputs = (q, k, v, do, lse, delta)
                got, again, want = (f(*inputs)
                                    for f in (fn, fn, plain))
                err = max(cs._check(f"{name} {shape}", g, w, *tol)
                          for g, w, tol in zip(got, want, tols))
                if not all(map(torch.equal, got, again)):
                    raise AssertionError(f"{name} {shape}: not "
                                         "deterministic")
                cs._log(f"variant {name} b{shape[0]} s{shape[1]} "
                        f"d{shape[4]}: "
                        f"{kind} max abs err {err:.3e} (tolerances "
                        f"{tols}), twice bitwise equal")
                del q, k, v, do, o, lse, delta, inputs, got, again, want

        for b, s, h, hkv, d in timed:
            q, k, v, do, o, lse = cs._bwd_inputs(b, s, h, hkv, d, dtype,
                                                 gen, True)
            delta = fa.flash_bwd_delta(o, do)
            inputs = (q, k, v, do, lse, delta)
            bound_ms, bound_by = cs.kernel_bound(b, h, hkv, s, s, d, dtype,
                                                 True, kind)
            flops = cs.kernel_flops(b, h, s, s, d, True, kind)
            for name in ["committed", *group, *reversed(group),
                         "committed"]:
                _use(built[name, source][0], source)
                ms = cs._time_ms(lambda: fn(*inputs), queue_ahead=True)
                cs._log(f"time variant {name} ({kernel}) {kind} b{b} s{s} "
                        f"h{h} hkv{hkv} d{d} {tag} causal: {ms:.4f} ms "
                        f"({flops / ms / 1e9:.1f} TF/s, {bound_ms / ms:.3f} "
                        f"of bound {bound_ms:.4f} ms, {bound_by})")
            del q, k, v, do, o, lse, delta, inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
