// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels `_dq_kernel` (K2) and `_dkv_kernel` (K3), both
// launched by `_flash_bwd`, in
// service_account_auth_improvements_tpu/ops/flash_attention.py (212-388).
//
// What they compute, with S = scale * Q K^T (start-aligned causal mask),
// P = exp(S - LSE) recomputed from the forward's LSE, and
// delta = rowsum(dO * O) (computed by the caller, as the reference does it
// outside its kernels):
//   K2:  dQ = scale * sum_k dS K,             dS = P * (dO V^T - delta)
//   K3:  dV = sum_{g, q} P^T dO,              (P rounded to dO's dtype first)
//        dK = scale * sum_{g, q} dS^T Q,      dS = P * (dO V^T - delta)
// where K3's sums run over the g query heads that share the KV head and over
// every query row. Numerical rules kept from the reference: products take
// operands in the input dtype and accumulate in f32; K2 forms dS from the f32
// P and rounds dS to K's dtype; K3 rounds P to dO's dtype, uses that rounded P
// for dV and (upcast again) for dS, and rounds dS to Q's dtype; masked scores
// are -2e38, so P is exactly 0 there.
//
// Parallelism: the TPU carries the f32 accumulators across sequential grid
// steps in VMEM scratch. Here one thread block owns one output tile and loops
// over the other axis itself, with the accumulator in registers:
//   K2: one block per (batch, head, 128-row query tile), looping over the
//       key tiles up to the diagonal of the block's last row (heaviest
//       query tiles launch first, as in K1);
//   K3: one block per (batch, KV head, 128-key tile), looping over the g
//       query heads of the group and over the query tiles from the diagonal
//       on (heaviest key tiles launch first).
// Each sum is taken inside one block in a fixed order: deterministic, no
// atomics, and dQ and dK/dV stay two passes, as in the reference.
//
// Layout and ragged tails as in csrc/flash_fwd.cu: element strides for the
// batch, head and sequence axes (head dim contiguous), so the model's
// [b, s, h, d] tensors are read and written in place; rows past s load as
// zero, keys past s get P = 0, query rows past s get P = 0 in K3 and are
// not written by K2. On the real rows that is the reference's zero-padded
// computation exactly (its padded rows have dO = 0 and delta = 0).
//
// What bounds it on an H100: at the training shape (s 2048, d 128) K2 does
// 3 and K3 4 products of 2 s^2 d / 2 flops per (b, h) against ~6 s d bytes:
// hundreds of flops per byte, so both are bound by operations. In bf16 (every
// d % 64 == 0 from 64 to 512) both are built for Hopper, as K1 is: tiles
// stream by TMA through a ring of shared-memory stages tracked by
// mbarriers, and two consumer warpgroups run every product on wgmma with
// the scores in registers; see BwdDesign below and the notes above
// `dq_wgmma` (d 128), `dkv_wgmma` (d 128 and 192), `dq_rows8` (d 64, 192
// and 256), `dkv_keys8` (d 64) and `dkv_onepass` (d 256) and `dq_split`
// and `dkv_split` (d 320 to 512, the output's D columns split between the
// consumers).
//
// float32 inputs take register-tiled FFMA kernels (dq_f32, dkv_f32): true
// f32 FMA on CUDA cores, no TF32, so f32 parity with the reference holds;
// see F32Design below.

#include "f32_tiles.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using namespace f32tile;

constexpr float kNegInf = -2.0e38f;

// Strides are given in this order, three (batch, head, seq) per tensor.
enum { Q, K, V, DO, DQ, DK, DV, NSTRIDE };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b, h, sq] contiguous
  const float* delta;  // [b, h, sq] contiguous
  void* dq;
  void* dk;
  void* dv;
  int64_t st[NSTRIDE][3];
  int h, hkv, sq, sk, causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const int64_t (&s)[3], int ib,
                                             int ih) {
  return static_cast<const T*>(base) + ib * s[0] + ih * s[1];
}

template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* base, const int64_t (&s)[3],
                                           int ib, int ih) {
  return static_cast<T*>(base) + ib * s[0] + ih * s[1];
}

// ------------------------------------------------ bf16: wgmma

using bf16 = __nv_bfloat16;

constexpr int WG = 128;  // threads per warpgroup
// shared memory a block may use on an H100 (227 KB)
constexpr int SMEM_MAX = 232448;

// The bf16 designs of K2 and K3 (the C functions flash_bwd_dq_design and
// flash_bwd_dkv_design report the one a head dim runs; chip_smoke.py labels
// its timings by them):
//   kRowSplit  dq_wgmma, dkv_wgmma: 12-warp blocks of 128 rows or keys, 64
//              a consumer warpgroup, a producer warpgroup (K2 at d 128,
//              K3 at d 128 and 192);
//   kDSplit    dq_split, dkv_split: 8-warp blocks of 64 rows or keys, the
//              output's columns split between the warpgroups (d 320 to 512);
//   kRows8     dq_rows8: dq_wgmma's rows on an 8-warp block (d 64, 192,
//              256);
//   kOnePass   dkv_onepass: 8-warp blocks of 64 keys, warpgroup 0 owning dV
//              and warpgroup 1 dK, one pass (d 256);
//   kKeys8     dkv_keys8: 8-warp blocks of 128 keys, 64 a warpgroup, each
//              owning dK and dV of its keys, one pass (d 64).
// At d 64, 192 and 256 each of K2 and K3 ships the faster of two designs
// on the H100 (chip_smoke.py's phase_wide_designs, in turns on one card;
// PERF.md §6): dq_rows8 and dkv_keys8 at d 64, dq_rows8 and the row
// split's dkv_wgmma at d 192 (dkv_onepass<192> lost to it in turns),
// dq_rows8 and dkv_onepass at d 256. A build with -DFLASH_OTHER_DESIGNS=1
// takes the other design at each (and K1's other design at d 64, 192 and
// 256, and the scalar f32 kernels at d 128: F32Design).
enum BwdDesign {
  kRowSplit = 0, kDSplit = 1, kRows8 = 2, kOnePass = 3, kKeys8 = 4
};

#ifndef FLASH_OTHER_DESIGNS
#define FLASH_OTHER_DESIGNS 0
#endif
constexpr int dq_design(int d) {
  return d == 64 || d == 192 || d == 256
             ? (FLASH_OTHER_DESIGNS ? kRowSplit : kRows8)
         : d <= 128 ? kRowSplit
                    : kDSplit;
}
constexpr int dkv_design(int d) {
  return d == 64 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kKeys8)
         : d <= 128 ? kRowSplit
         : d == 192 ? (FLASH_OTHER_DESIGNS ? kOnePass : kRowSplit)
         : d == 256 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kOnePass)
                    : kDSplit;
}

// K2, bf16: dQ for one (b, head, 128-row query tile), on wgmma.
//
// Warp specialisation, as K1 (csrc/flash_fwd.cu): warpgroup 0 is the
// producer (24 registers): one thread loads Q and dO of the block's rows
// once by TMA, to stay in shared memory, and streams K and V tiles of DQ_BK
// keys by TMA through a ring of DQ_STAGES stages, one full and one empty
// mbarrier per stage. Warpgroups 1 and 2 are consumers that own 64 query
// rows each (240 registers); each thread holds the lse (times log2 e) and
// delta of its two rows in registers. Per key tile:
//   S = Q K^T, dP = dO V^T    wgmma m64nBKk16, both operands from shared
//                             memory (K-major), one commit and one wait
//   P = exp2(S scale log2e - lse log2e) in f32 (masked only on the tiles
//       that cross the diagonal or the ragged end), dS = P (dP - delta),
//       rounded to bf16 and re-packed in place as A fragments
//   dQ += dS K                wgmma m64nDk16, A from registers, K read
//                             MN-major (as K1 reads V), one wait
// so no score tile reaches shared or global memory. The key tiles run up to
// the diagonal of the block's last row for both consumers: a tile wholly in
// the future of consumer 0's rows is computed with P = 0, never skipped,
// since ptxas serialises every wgmma of a kernel with a branch around one
// that depends on the warpgroup. The dQ product is waited for before the
// next tile's scores, for the same reason. dQ is scaled once, at the end,
// and each block writes its own rows: deterministic, no atomics.
// What ptxas and the card allowed shaped this (kernel_variants.py builds
// and times the alternatives; PERF.md has their numbers): 64-key stages
// hold S and dP in 32 registers each beside dQ's D / 2 and compile clean;
// 128-key stages (m64n128 score products) hold 64 each, spill and serialise
// every wgmma. Issuing S as soon as K lands, with dP in a second commit
// group once V has, is no faster than one group for both: with four stages
// in the ring V has landed long before. Above d 128 the dQ accumulator is
// D / 2 registers (128 at d 256), so the key tiles are 32 (dq_bk: S and dP
// m64n32, 16 registers each) and dQ += dS K runs as one m64n128 chain per
// 128 columns.

constexpr int DQ_BQ = 128;           // query rows per block: 64 per consumer
constexpr int DQ_BK = 64;            // keys per K/V stage up to d 128
constexpr int DQ_THREADS = 3 * WG;   // producer + two consumers

// Keys per K/V stage: DQ_BK up to d 128, 32 above, where S and dP of 64
// keys beside dQ's D / 2 registers made ptxas spill and serialise the
// wgmmas. Stages in the ring: 256 keys' worth (4 of 64 keys or 2 of 128),
// or as many as fit beside the resident Q and dO (d 192: 5, d 256: 3).
// At d 64, 192 and 256 K2 ships as dq_rows8 and from d 320 it is dq_split
// (BwdDesign): at d 192 this kernel runs only in the -DFLASH_OTHER_DESIGNS=1
// build.
constexpr int dq_bk(int d) { return d <= 128 ? DQ_BK : 32; }
constexpr int dq_stages(int d) {
  const int fit =
      (SMEM_MAX - 2048 - 2 * DQ_BQ * d * 2) / (2 * dq_bk(d) * d * 2);
  return fit >= 256 / dq_bk(d) ? 256 / dq_bk(d) : fit > 1 ? fit : 1;
}

// K2's arguments, for each bf16 design (dq_args fills them)
struct DqArgs {
  CUtensorMap tq, tdo;  // boxes of the design's query rows
  CUtensorMap tk, tv;   // boxes of the design's keys a stage
  const float* lse;     // [b, h, sq] contiguous
  const float* delta;
  void* dq;
  int64_t dq_sb, dq_sh, dq_ss;
  int h, hkv, batch, sq, sk, causal, nq;
  float scale, scale_log2;
};

// Shared memory: Q, dO, the K stages, the V stages and the mbarriers. Each
// tile is D / 64 column blocks of (rows x 128 bytes).
template <int D>
struct DqSmem {
  static constexpr int DQ_BK = dq_bk(D);
  static constexpr int DQ_STAGES = dq_stages(D);
  static constexpr int Q_CB = DQ_BQ * 128;  // column block stride
  static constexpr int KV_CB = DQ_BK * 128;
  static constexpr int Q_BYTES = DQ_BQ * D * 2;
  static constexpr int KV_BYTES = DQ_BK * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + DQ_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + DQ_STAGES * KV_BYTES;
  // mbarriers: q_full, full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

template <int D>
__device__ __forceinline__ void dq_consumer(const DqArgs& a, uint32_t base,
                                            int q0, int ih, int ib, int nk) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int DQ_BK = L::DQ_BK, DQ_STAGES = L::DQ_STAGES;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, full = bar + 8, empty = full + 8 * DQ_STAGES;
  const int c = threadIdx.x / WG - 1;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + L::Q_OFF + c * 64 * 128;
  const uint32_t do_addr = base + L::DO_OFF + c * 64 * 128;

  // rows past sq read lse = delta = 0 (and Q = dO = 0): dS = 0 there, and
  // those rows are not written
  const int64_t rows = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  const float ls0 = row0 < a.sq ? a.lse[rows + row0] * kLog2e : 0.f;
  const float ls1 = row1 < a.sq ? a.lse[rows + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.sq ? a.delta[rows + row0] : 0.f;
  const float dl1 = row1 < a.sq ? a.delta[rows + row1] : 0.f;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % DQ_STAGES;
    const uint32_t ph = (i / DQ_STAGES) & 1;
    const int k0 = i * DQ_BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T and dP = dO V^T: 64 rows x DQ_BK keys each
    float sc[DQ_BK / 2], dp[DQ_BK / 2];
    mbar_wait(full + 8 * s, ph);
    wgmma_fence();
    wgmma_ss<DQ_BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    wgmma_ss<DQ_BK, D / 16, L::Q_CB, L::KV_CB>(
        dp, desc_sw128(do_addr, 16, 1024), desc_sw128(v_addr, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) with P = exp2(S scale log2e - lse log2e) in f32,
    // in place in sc; P = 0 past sk and (causal) after the row
    const bool need_mask =
        (a.causal && k0 + DQ_BK - 1 > r0) || k0 + DQ_BK > a.sk;
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], a.scale_log2,
                                 -(e < 2 ? ls0 : ls1)));
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          if (col >= a.sk || (a.causal && col > (e < 2 ? row0 : row1)))
            p = 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }

    // dS in K's dtype, re-packed as the A operand; keys 16kk .. 16kk + 15
    uint32_t f[DQ_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // dQ += dS K
    fence_regs(dq);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<D, DQ_BK / 16, L::KV_CB>(dq, f, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty + 8 * s);
  }

  bf16* out = static_cast<bf16*>(a.dq) + ib * a.dq_sb + ih * a.dq_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (row0 < a.sq)
      *reinterpret_cast<uint32_t*>(out + row0 * a.dq_ss + col) = pack_bf16x2(
          dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (row1 < a.sq)
      *reinterpret_cast<uint32_t*>(out + row1 * a.dq_ss + col) = pack_bf16x2(
          dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_wgmma(const __grid_constant__ DqArgs a) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int DQ_BK = L::DQ_BK, DQ_STAGES = L::DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, full = bar + 8, empty = full + 8 * DQ_STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV head
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int q0 = iq * DQ_BQ;
  // the same key tiles for both consumers: up to the diagonal of the
  // block's last row (the reference's `ik * bk < (iq + 1) * bq`)
  int nk = (a.sk + DQ_BK - 1) / DQ_BK;
  if (a.causal) nk = min(nk, (q0 + DQ_BQ + DQ_BK - 1) / DQ_BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {  // producer warpgroup: one thread issues TMA
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int ikv = ih / (a.h / a.hkv);
      mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_4d(base + L::Q_OFF + cb * L::Q_CB, &a.tq, q_full, cb * 64,
                    q0, ih, ib);
        tma_load_4d(base + L::DO_OFF + cb * L::Q_CB, &a.tdo, q_full,
                    cb * 64, q0, ih, ib);
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % DQ_STAGES;
        const uint32_t fb = full + 8 * s;
        mbar_wait(empty + 8 * s, ((i / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(fb, 2 * L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tk, fb, cb * 64, i * DQ_BK, ikv, ib);
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tv, fb, cb * 64, i * DQ_BK, ikv, ib);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    dq_consumer<D>(a, base, q0, ih, ib, nk);
  }
}

// K3, bf16: dK and dV for one (b, KV head, 128-key tile), on wgmma.
//
// Warp specialisation: warpgroup 0 is the producer (40 registers): one
// thread loads K and V of the block's keys once by TMA, to stay in shared
// memory, and streams Q and dO for BQ query rows at a time by TMA through a
// ring of STAGES stages (see DkvSmem), while the warp's 32 lanes copy the
// rows' lse and delta beside them (a TMA box of those would start off a
// 16-byte boundary whenever s_q is odd). It walks the group's query heads
// and, for each, the query tiles from the diagonal on, and does so twice.
// Warpgroups 1 and 2 are consumers that own 64 keys each (232 registers)
// and make two passes over that sequence, one accumulator in f32 registers
// per pass:
//   dV pass:  S^T = K Q^T                 wgmma m64nBQk16, both from shared
//             P^T = exp2(S^T scale log2e - lse log2e), masked, rounded to
//             bf16
//             dV += P^T dO                 wgmma m64nDk16, A = P^T from
//                                          registers (the S^T fragment
//                                          re-packed), B = dO read MN-major
//   dK pass:  per part of the stage (64 queries, or the stage if less):
//             S^T = K Q^T, dP^T = V dO^T   both wgmma m64n64k16
//             dS^T = P^T (dP^T - delta), P rounded first, dS rounded to bf16
//             dK += dS^T Q                 as dV
// What ptxas allowed shaped this (measured on the H100 with -Xptxas -v and
// the SASS): holding dK and dV together (128 registers at d 128) beside
// S^T, dP^T and the A fragments made it spill and serialise every wgmma;
// so does any branch around a wgmma that depends on the warpgroup (a
// causal tile wholly before a warpgroup's keys is therefore computed, with
// P = 0, not skipped), and so does leaving a product in flight across the
// next tile's scores. Two passes cost one more product (S^T again) and a
// second stream of Q and dO (from L2); 128-row stages halve the waits per
// query row and make the dV pass's S^T an m64n128 product, which shared
// memory can feed at the tensor cores' rate (m64n64 with both operands in
// shared memory cannot).
// Above d 128 the same design takes 32-row stages (BQ: S^T and dP^T are
// m64n32, 16 registers each), as many as fit beside K and V (d 192: 4,
// d 256: 3; K and V of 128 keys take 128 KB at d 256): with 64 rows
// beside the D / 2 accumulator registers ptxas spilled and serialised the
// wgmmas. The dK and dV accumulators stay one per pass; a wide product
// dV += P^T dO or dK += dS^T Q is one m64n128 chain per 128 columns
// (hopper::wgmma_rs_t_cols).
// dK is scaled once, at the end. Every sum runs in one block in a fixed
// order: deterministic.

constexpr int DKV_BK = 128;         // keys per block: 64 per consumer
constexpr int DKV_THREADS = 3 * WG;  // producer + two consumers

struct DkvArgs {
  CUtensorMap tq, tdo;     // boxes of 64 columns x DkvSmem<D>::BQ rows
  CUtensorMap tk, tv;      // boxes of 64 columns x DKV_BK rows
  const float* lse;        // [b, h, sq] contiguous
  const float* delta;
  void* dk;
  void* dv;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int h, hkv, batch, sq, sk, causal;
  float scale, scale_log2;
};

// Shared memory: K, V (the block's keys), the Q and dO stages, the lse and
// delta stages and the mbarriers. Each bf16 tile is D / 64 column blocks of
// (rows x 128 bytes). A stage holds BQ query rows: 128 in 2 stages up to
// d 128, 32 above in as many stages as fit (at most 4). At d 256 K3
// ships as dkv_onepass and from d 320 it is dkv_split (BwdDesign).
template <int D>
struct DkvSmem {
  static constexpr int BQ = D <= 128 ? 128 : 32;  // query rows per stage
  static constexpr int KV_CB = DKV_BK * 128;  // column block stride
  static constexpr int QT_CB = BQ * 128;
  static constexpr int KV_BYTES = DKV_BK * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int ROW_BYTES = BQ * 4;  // lse or delta of a tile
  static constexpr int FIT =
      (SMEM_MAX - 2048 - 2 * KV_BYTES) / (2 * QT_BYTES + 2 * ROW_BYTES);
  static constexpr int STAGES = D <= 128 ? 2 : FIT < 4 ? FIT : 4;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int L_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int DL_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = DL_OFF + STAGES * ROW_BYTES;
  // mbarriers: kv_full, full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// Per consumer thread, from an S^T accumulator of NQ queries (columns):
// P^T = exp2(S^T scale log2e - lse log2e), masked (queries past sq, and keys
// after the query under causal masking, get 0). ls holds the queries' lse,
// q0 is the first query.
template <int NQ>
__device__ __forceinline__ void dkv_probs(float (&p)[NQ / 2],
                                          const float (&st)[NQ / 2],
                                          const float* ls, const DkvArgs& a,
                                          int q0, int key0, int key1, int tq,
                                          bool need_mask) {
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 lj = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? lj.y : lj.x;
      float x = hopper::fast_exp2(
          fmaf(st[4 * j + e], a.scale_log2, -lse * hopper::kLog2e));
      if (need_mask) {
        const int query = q0 + col + (e & 1);
        const int key = e < 2 ? key0 : key1;
        if (query >= a.sq || (a.causal && key > query)) x = 0.f;
      }
      p[4 * j + e] = x;
    }
  }
}

// The bf16 A fragments (keys x 16-query chunks) of an accumulator-shaped
// tile v of NQ queries: 8-query chunk j holds registers 2 (j % 2) and
// 2 (j % 2) + 1 of chunk j / 2.
template <int NQ>
__device__ __forceinline__ void dkv_pack(uint32_t (&f)[NQ / 16][4],
                                         const float (&v)[NQ / 2]) {
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    f[j / 2][2 * (j % 2)] = hopper::pack_bf16x2(v[4 * j], v[4 * j + 1]);
    f[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16x2(v[4 * j + 2], v[4 * j + 3]);
  }
}

// Write a consumer's 64 keys x D accumulator, times `scale`, as bf16 rows
// of `out` (element row stride `ss`), skipping keys at or past sk.
template <int D>
__device__ __forceinline__ void dkv_store(bf16* out, int64_t ss,
                                          const float (&acc)[D / 2],
                                          float scale, int key0, int key1,
                                          int sk, int tq) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (key0 < sk)
      *reinterpret_cast<uint32_t*>(out + key0 * ss + col) = hopper::pack_bf16x2(
          acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (key1 < sk)
      *reinterpret_cast<uint32_t*>(out + key1 * ss + col) = hopper::pack_bf16x2(
          acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// One consumer pass over the block's stage sequence (`tiles` stages of
// BQ queries, ring positions from i0), one f32 accumulator:
//   PASS 0, dV: S^T of the whole stage (m64nBQ), P^T, dV += P^T dO;
//   PASS 1, dK: per part of H queries, S^T and dP^T (m64nH), dS^T,
//               dK += dS^T Q.
// No branch encloses a wgmma (ptxas serialises wgmma on paths it cannot
// prove uniform), so a causal part wholly before this warpgroup's keys is
// computed, with P = 0.
template <int D, int PASS>
__device__ __forceinline__ void dkv_pass(const DkvArgs& a, uint32_t base,
                                         const unsigned char* smem, int i0,
                                         int tiles, int nqt, int iq0, int kw0,
                                         int key0, int key1, int tq,
                                         bf16* out, int64_t ss) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  constexpr int H = BQ < 64 ? BQ : 64;  // queries per part in the dK pass
  const uint32_t full = base + L::BAR_OFF + 8, empty = full + 8 * STAGES;
  const uint32_t k_addr = base + L::K_OFF + (kw0 % DKV_BK) * 128;
  const uint32_t v_addr = base + L::V_OFF + (kw0 % DKV_BK) * 128;
  float acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int i = i0 + n;
    const int s = i % STAGES;
    const int q0 = (iq0 + n % nqt) * BQ;
    const uint32_t q_addr = base + L::Q_OFF + s * L::QT_BYTES;
    const uint32_t do_addr = base + L::DO_OFF + s * L::QT_BYTES;
    const float* ls =
        reinterpret_cast<const float*>(smem + L::L_OFF + s * L::ROW_BYTES);
    const float* dl =
        reinterpret_cast<const float*>(smem + L::DL_OFF + s * L::ROW_BYTES);
    mbar_wait(full + 8 * s, (i / STAGES) & 1);

    if constexpr (PASS == 0) {
      const bool need_mask = (a.causal && q0 < kw0 + 64) || q0 + BQ > a.sq;
      float st[BQ / 2];
      wgmma_fence();
      wgmma_ss<BQ, D / 16, L::KV_CB, L::QT_CB>(
          st, desc_sw128(k_addr, 16, 1024), desc_sw128(q_addr, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      dkv_probs<BQ>(st, st, ls, a, q0, key0, key1, tq, need_mask);
      uint32_t f[BQ / 16][4];
      dkv_pack<BQ>(f, st);  // rounds P to dO's dtype
      fence_regs(acc);
      fence_regs(f);
      wgmma_fence();
      wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(acc, f, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
#pragma unroll
      for (int h = 0; h < BQ / H; ++h) {
        const int qh = q0 + h * H;
        const bool need_mask = (a.causal && qh < kw0 + 64) || qh + H > a.sq;
        float st[H / 2], dpt[H / 2];
        wgmma_fence();
        wgmma_ss<H, D / 16, L::KV_CB, L::QT_CB>(
            st, desc_sw128(k_addr, 16, 1024),
            desc_sw128(q_addr + h * H * 128, 16, 1024));
        wgmma_ss<H, D / 16, L::KV_CB, L::QT_CB>(
            dpt, desc_sw128(v_addr, 16, 1024),
            desc_sw128(do_addr + h * H * 128, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        // dS^T = P^T (dP^T - delta), P rounded to dO's dtype first; packing
        // rounds dS to Q's dtype
        dkv_probs<H>(st, st, ls + h * H, a, qh, key0, key1, tq, need_mask);
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const float2 dj =
              *reinterpret_cast<const float2*>(dl + h * H + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * j + e] = round_bf16(st[4 * j + e]) *
                            (dpt[4 * j + e] - ((e & 1) ? dj.y : dj.x));
        }
        uint32_t f[H / 16][4];
        dkv_pack<H>(f, st);
        fence_regs(acc);
        fence_regs(f);
        wgmma_fence();
        wgmma_rs_t_cols<D, H / 16, L::QT_CB>(acc, f, q_addr + h * H * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
    }
    mbar_arrive(empty + 8 * s);
  }
  dkv_store<D>(out, ss, acc, PASS == 1 ? a.scale : 1.f, key0, key1, a.sk,
               tq);
}

template <int D>
__device__ __forceinline__ void dkv_consumer(const DkvArgs& a, uint32_t base,
                                             const unsigned char* smem,
                                             int k0, int ikv, int ib) {
  const int c = threadIdx.x / WG - 1;  // this warpgroup's 64 keys
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int kw0 = k0 + 64 * c;
  const int key0 = kw0 + 16 * w + g, key1 = key0 + 8;
  constexpr int BQ = DkvSmem<D>::BQ;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int tiles = a.h / a.hkv * (nq - iq0);  // per pass

  hopper::mbar_wait(base + DkvSmem<D>::BAR_OFF, 0);  // K and V
  dkv_pass<D, 0>(a, base, smem, 0, tiles, nq - iq0, iq0, kw0, key0, key1,
                 tq, static_cast<bf16*>(a.dv) + ib * a.dv_sb + ikv * a.dv_sh,
                 a.dv_ss);
  dkv_pass<D, 1>(a, base, smem, tiles, tiles, nq - iq0, iq0, kw0, key0, key1,
                 tq, static_cast<bf16*>(a.dk) + ib * a.dk_sb + ikv * a.dk_sh,
                 a.dk_ss);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
dkv_wgmma(const __grid_constant__ DkvArgs a) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t kv_full = bar, full = bar + 8, empty = full + 8 * STAGES;

  // heaviest key tiles (the first, under causal masking) first
  const int hb = a.hkv * a.batch;
  const int ik = static_cast<int>(blockIdx.x) / hb;
  const int ikv = static_cast<int>(blockIdx.x) % hb % a.hkv;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.hkv;
  const int k0 = ik * DKV_BK;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {  // producer warpgroup: its first warp loads
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_4d(base + L::K_OFF + cb * L::KV_CB, &a.tk, kv_full,
                      cb * 64, k0, ikv, ib);
          tma_load_4d(base + L::V_OFF + cb * L::KV_CB, &a.tv, kv_full,
                      cb * 64, k0, ikv, ib);
        }
      }
      const int group = a.h / a.hkv;
      const int nq = (a.sq + BQ - 1) / BQ;
      const int iq0 = a.causal ? k0 / BQ : 0;
      int i = 0;
      for (int pass = 0; pass < 2; ++pass)  // the consumers' dV, then dK pass
      for (int hg = 0; hg < group; ++hg) {
        const int ih = ikv * group + hg;
        const int64_t row = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
        for (int iq = iq0; iq < nq; ++iq, ++i) {
          const int s = i % STAGES;
          const uint32_t fb = full + 8 * s;
          mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
          if (lane == 0) {  // Q and dO by TMA
            mbar_expect_tx(fb, 2 * L::QT_BYTES);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb) {
              tma_load_4d(base + L::Q_OFF + s * L::QT_BYTES + cb * L::QT_CB,
                          &a.tq, fb, cb * 64, iq * BQ, ih, ib);
              tma_load_4d(base + L::DO_OFF + s * L::QT_BYTES + cb * L::QT_CB,
                          &a.tdo, fb, cb * 64, iq * BQ, ih, ib);
            }
          }
          // lse and delta by the warp's lanes (rows past sq read as 0),
          // then every lane arrives: the stage is full once all 32 have
          // and the TMA bytes have landed
          float* ls = reinterpret_cast<float*>(smem + L::L_OFF +
                                               s * L::ROW_BYTES);
          float* dl = reinterpret_cast<float*>(smem + L::DL_OFF +
                                               s * L::ROW_BYTES);
#pragma unroll
          for (int r = lane; r < BQ; r += 32) {
            const int q = iq * BQ + r;
            ls[r] = q < a.sq ? a.lse[row + q] : 0.f;
            dl[r] = q < a.sq ? a.delta[row + q] : 0.f;
          }
          mbar_arrive(fb);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    dkv_consumer<D>(a, base, smem, k0, ikv, ib);
  }
}

// ------------------------------------------------ bf16: the D-split kernels
//
// From d 320 K2 is `dq_split<D>` and K3 `dkv_split<D>`. dq_wgmma and
// dkv_wgmma hold a D / 2-register accumulator a thread (256 at d 512, past
// the 255 a thread may have), and their resident tiles (Q and dO of 128
// rows, K and V of 128 keys: 256 KB at d 512) overflow 227 KB. The split
// kernels follow K1's (csrc/flash_fwd.cu, flash_fwd_split):
// - a block owns 64 rows (K2: query rows; K3: keys) and BOTH consumer
//   warpgroups own all 64; the D columns of the output are split between
//   them: warpgroup c accumulates NC = ceil(D / 128) * 64 columns from
//   c (D - NC) (at d 320 and 448 the middle 64 are computed by both and
//   stored by warpgroup 0), at most 128 registers a thread;
// - the score products are split by their columns instead (K2: the tile's
//   keys; K3: the stage's queries): warpgroup c forms S and dP (K3's dV
//   pass: S^T only) for its half over the whole head dim, and the two
//   exchange halves through shared memory in fragment order
//   (hopper::put_half, join_half; one named barrier per tile). Every
//   product runs once; both warpgroups hold the same scores, form the same
//   dS (P) and run one instruction stream (no branch on the warpgroup
//   around a wgmma);
// - a block is just the two consumer warpgroups, as in flash_fwd_split (8
//   warps: 255 registers a thread, where 9 to 12 warps get 168 and
//   spilled); thread 0 (K3: the first warp, which also copies lse and
//   delta with cp.async) loads whole tiles by TMA, each stage's next one
//   as soon as both warpgroups have released it, never waiting;
// - K2: dQ[:, own] += dS K[:, own]; K3 keeps its two passes (dV, then dK,
//   one accumulator each): dV[:, own] += P^T dO[:, own] and dK[:, own] +=
//   dS^T Q[:, own], with the rounding rules of dq_wgmma and dkv_wgmma;
// - tiles: the largest of 64, 32 and 16 keys (K2) or queries (K3) a stage
//   for which two stages fit beside the resident tiles and the exchange
//   buffers, with as many stages as fit (at most 4): DqSplit, DkvSplit.
// Every sum still runs inside one block in a fixed order: deterministic.

constexpr int SPLIT_THREADS = 2 * WG;  // the two consumer warpgroups

// Stages of `t` rows (two bf16 tiles of t x d each, plus `extra` bytes a
// row) that fit beside `resident` bytes, the exchange buffers (2 buffers x
// 2 warpgroups x two 64 x t / 2 f32 halves: 1024 t bytes) and the
// mbarriers; and the largest of 64, 32, 16 rows for which two fit.
__host__ __device__ constexpr int split_fit(int d, int resident, int t,
                                            int extra) {
  return (SMEM_MAX - 2048 - resident - 1024 * t) / (4 * t * d + extra * t);
}
__host__ __device__ constexpr int split_tile(int d, int resident,
                                             int extra) {
  return split_fit(d, resident, 64, extra) >= 2   ? 64
         : split_fit(d, resident, 32, extra) >= 2 ? 32
                                                  : 16;
}

// Shared memory: Q and dO (64 rows, resident), the K stages, the V stages,
// the two exchange buffers and the mbarriers.
template <int D>
struct DqSplit {
  static constexpr int BQ = 64;
  static constexpr int NC = (D + 127) / 128 * 64;
  static constexpr int Q_CB = BQ * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int BK = split_tile(D, 2 * Q_BYTES, 0);
  static constexpr int FIT = split_fit(D, 2 * Q_BYTES, BK, 0);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int XCH = 2 * 2 * (BK / 4) * WG;  // f32 a buffer
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * XCH * 4;
  // mbarriers: q_full, kv_full[S], kv_empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(D % 64 == 0 && NC <= 256, "dQ: 256 columns a consumer");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// K and V of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void dq_split_load(const DqArgs& a,
                                              uint32_t base, int i, int ikv,
                                              int ib) {
  using namespace hopper;
  using L = DqSplit<D>;
  const int s = i % L::STAGES;
  const uint32_t full_s = base + L::BAR_OFF + 8 + 8 * s;
  mbar_arrive_expect_tx(full_s, 2 * L::KV_BYTES);
  tma_load_5d(base + L::K_OFF + s * L::KV_BYTES, &a.tk, full_s, 0,
              i * L::BK, 0, ikv, ib);
  tma_load_5d(base + L::V_OFF + s * L::KV_BYTES, &a.tv, full_s, 0,
              i * L::BK, 0, ikv, ib);
}

template <int D>
__device__ __forceinline__ void dq_split_consumer(const DqArgs& a,
                                                  uint32_t base, float* xbuf,
                                                  int q0, int ih, int ib,
                                                  int nk) {
  using namespace hopper;
  using L = DqSplit<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NC = L::NC, HALF = BK / 2;
  constexpr int R = HALF / 2;  // registers of one half tile
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, kv_full = bar + 8,
                 kv_empty = kv_full + 8 * STAGES;
  const int c = threadIdx.x / WG;  // this warpgroup's keys and columns
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int row0 = q0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t k_cols = c * ((D - NC) / 64) * L::KV_CB;

  const int64_t rows = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  const float ls0 = row0 < a.sq ? a.lse[rows + row0] * kLog2e : 0.f;
  const float ls1 = row1 < a.sq ? a.lse[rows + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.sq ? a.delta[rows + row0] : 0.f;
  const float dl1 = row1 < a.sq ? a.delta[rows + row1] : 0.f;

  float dq[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dq[i] = 0.f;
  const int ikv = ih / (a.h / a.hkv);
  bool refill = false;  // thread 0: tile i - 1's stage still to refill

  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // this warpgroup's halves of S = Q K^T and dP = dO V^T (64 rows x
    // BK / 2 keys each), side by side in `own`
    float own[2 * R];
    mbar_wait(kv_full + 8 * s, (i / STAGES) & 1);
    wgmma_fence();
    wgmma_ss<HALF, D / 16, L::Q_CB, L::KV_CB>(
        *reinterpret_cast<float(*)[R]>(own), desc_sw128(base, 16, 1024),
        desc_sw128(k_addr + c * HALF * 128, 16, 1024));
    wgmma_ss<HALF, D / 16, L::Q_CB, L::KV_CB>(
        *reinterpret_cast<float(*)[R]>(own + R),
        desc_sw128(base + L::DO_OFF, 16, 1024),
        desc_sw128(v_addr + c * HALF * 128, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(own);
    float sc[BK / 2], dp[BK / 2];
    float* buf = xbuf + (i & 1) * L::XCH;  // [S, dP][warpgroup][R][128]
    put_half<R>(own, buf, c, t);
    put_half<R>(own + R, buf + 2 * R * WG, c, t);
    bar_sync(1, 2 * WG);
    if (refill) {  // past the barrier both warpgroups released tile i - 1
      mbar_wait(kv_empty + 8 * ((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      dq_split_load<D>(a, base, i - 1 + STAGES, ikv, ib);
      refill = false;
    }
    join_half<R>(own, buf, sc, c, t);
    join_half<R>(own + R, buf + 2 * R * WG, dp, c, t);

    // dS = P (dP - delta), P = exp2(S scale log2e - lse log2e) in f32
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], a.scale_log2,
                                 -(e < 2 ? ls0 : ls1)));
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          if (col >= a.sk || (a.causal && col > (e < 2 ? row0 : row1)))
            p = 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    uint32_t f[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // dQ[:, own columns] += dS K[:, own columns]
    fence_regs(dq);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<NC, BK / 16, L::KV_CB>(dq, f, k_addr + k_cols);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(kv_empty + 8 * s);
    // the stage's next tile: now if the other warpgroup has released the
    // stage too, else at the next tile's exchange
    if (threadIdx.x == 0 && i + STAGES < nk) {
      refill = !mbar_test(kv_empty + 8 * s, (i / STAGES) & 1);
      if (!refill) dq_split_load<D>(a, base, i + STAGES, ikv, ib);
    }
  }
  store_cols<NC>(static_cast<bf16*>(a.dq) + ib * a.dq_sb + ih * a.dq_sh,
                 a.dq_ss, dq, a.scale, row0, row1, a.sq, tq,
                 c * (D - NC), c == 0 ? 0 : NC);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
dq_split(const __grid_constant__ DqArgs a) {
  using namespace hopper;
  using L = DqSplit<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* xbuf = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::X_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, kv_full = bar + 8,
                 kv_empty = kv_full + 8 * STAGES;

  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int q0 = iq * BQ;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // Q and dO, and the first STAGES key tiles
    mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
    tma_load_5d(base, &a.tq, q_full, 0, q0, 0, ih, ib);
    tma_load_5d(base + L::DO_OFF, &a.tdo, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < STAGES && i < nk; ++i)
      dq_split_load<D>(a, base, i, ih / (a.h / a.hkv), ib);
  }
  dq_split_consumer<D>(a, base, xbuf, q0, ih, ib, nk);
}

// K3 split: shared memory holds K and V of the block's 64 keys (resident),
// the Q and dO stages of BQ queries, their lse and delta, the two exchange
// buffers and the mbarriers.
template <int D>
struct DkvSplit {
  static constexpr int BK = 64;  // keys per block
  static constexpr int NC = (D + 127) / 128 * 64;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BQ = split_tile(D, 2 * KV_BYTES, 8);
  static constexpr int FIT = split_fit(D, 2 * KV_BYTES, BQ, 8);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int QT_CB = BQ * 128;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int ROW_BYTES = BQ * 4;
  static constexpr int XCH = 2 * 2 * (BQ / 4) * WG;  // f32 a buffer
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int L_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int DL_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int X_OFF = DL_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * XCH * 4;
  // mbarriers: kv_full, q_full[S], q_empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(D % 64 == 0 && NC <= 256, "dK, dV: at most 256 columns");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// Stage j of the block's sequence (the group's query heads, each from
// query tile iq0 on, nqt tiles: `tiles` stages a pass; dkv_split's two
// passes stream the same sequence twice) into shared memory laid out as L
// (DkvSplit<D> or DkvOnePass<D>), by the first warp: Q and dO by TMA from
// lane 0, the rows' lse and delta by the lanes with cp.async (rows past sq
// fill with 0), each lane's arrival on the stage's barrier made when its
// copies land. The stage is full once all 32 lanes' copies and the TMA
// bytes have landed; the warp (which also computes) never waits on a
// global load.
template <class L>
__device__ __forceinline__ void dkv_stage_load(const DkvArgs& a,
                                               uint32_t base,
                                               unsigned char* smem, int j,
                                               int tiles, int nqt, int iq0,
                                               int ikv, int ib, int lane) {
  using namespace hopper;
  const int s = j % L::STAGES, jj = j % tiles;
  const int ih = ikv * (a.h / a.hkv) + jj / nqt;
  const int iq = iq0 + jj % nqt;
  const uint32_t full_s = base + L::BAR_OFF + 8 + 8 * s;
  if (lane == 0) {
    mbar_expect_tx(full_s, 2 * L::QT_BYTES);
    tma_load_5d(base + L::Q_OFF + s * L::QT_BYTES, &a.tq, full_s, 0,
                iq * L::BQ, 0, ih, ib);
    tma_load_5d(base + L::DO_OFF + s * L::QT_BYTES, &a.tdo, full_s, 0,
                iq * L::BQ, 0, ih, ib);
  }
  const int64_t row = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  float* ls = reinterpret_cast<float*>(smem + L::L_OFF + s * L::ROW_BYTES);
  float* dl = reinterpret_cast<float*>(smem + L::DL_OFF + s * L::ROW_BYTES);
  for (int r = lane; r < L::BQ; r += 32) {
    const int q = iq * L::BQ + r;
    const int64_t at = row + (q < a.sq ? q : 0);
    cp_async_4(smem_u32(ls + r), a.lse + at, q < a.sq ? 4 : 0);
    cp_async_4(smem_u32(dl + r), a.delta + at, q < a.sq ? 4 : 0);
  }
  cp_async_arrive(full_s);
}

// One pass of a K3 split consumer over the block's stage sequence (`tiles`
// stages of BQ queries, ring positions from i0), one accumulator of NC
// columns: PASS 0, dV[:, own] += P^T dO[:, own]; PASS 1, dK[:, own] +=
// dS^T Q[:, own]. The first warp refills the stages (dkv_stage_load).
template <int D, int PASS>
__device__ __forceinline__ void dkv_split_pass(const DkvArgs& a,
                                               uint32_t base,
                                               unsigned char* smem,
                                               float* xbuf, int i0, int tiles,
                                               int nqt, int iq0, int k0,
                                               int ikv, int ib, int key0,
                                               int key1, int c, int t,
                                               bool& refill, bf16* out,
                                               int64_t ss) {
  using namespace hopper;
  using L = DkvSplit<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES, NC = L::NC, HALF = BQ / 2;
  constexpr int R = HALF / 2;  // registers of one half tile
  const int tq = t % 4;
  const uint32_t q_full = base + L::BAR_OFF + 8, q_empty = q_full + 8 * STAGES;
  const uint32_t own_cols = c * ((D - NC) / 64) * L::QT_CB;
  float acc[NC / 2];
#pragma unroll
  for (int r = 0; r < NC / 2; ++r) acc[r] = 0.f;
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int i = i0 + n;
    const int s = i % STAGES;
    const int q0 = (iq0 + n % nqt) * BQ;
    const uint32_t q_addr = base + L::Q_OFF + s * L::QT_BYTES;
    const uint32_t do_addr = base + L::DO_OFF + s * L::QT_BYTES;
    const float* ls =
        reinterpret_cast<const float*>(smem + L::L_OFF + s * L::ROW_BYTES);
    const float* dl =
        reinterpret_cast<const float*>(smem + L::DL_OFF + s * L::ROW_BYTES);
    const bool need_mask = (a.causal && q0 < k0 + L::BK) || q0 + BQ > a.sq;
    mbar_wait(q_full + 8 * s, (i / STAGES) & 1);

    // this warpgroup's half of the stage's queries: S^T = K Q^T (and, for
    // dK, dP^T = V dO^T), 64 keys x BQ / 2 queries each
    float own[(PASS + 1) * R];
    wgmma_fence();
    wgmma_ss<HALF, D / 16, L::KV_CB, L::QT_CB>(
        *reinterpret_cast<float(*)[R]>(own), desc_sw128(base, 16, 1024),
        desc_sw128(q_addr + c * HALF * 128, 16, 1024));
    if constexpr (PASS == 1)
      wgmma_ss<HALF, D / 16, L::KV_CB, L::QT_CB>(
          *reinterpret_cast<float(*)[R]>(own + R),
          desc_sw128(base + L::V_OFF, 16, 1024),
          desc_sw128(do_addr + c * HALF * 128, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(own);
    float* buf = xbuf + (i & 1) * L::XCH;  // [S^T, dP^T][warpgroup][R][128]
    put_half<R>(own, buf, c, t);
    if constexpr (PASS == 1) put_half<R>(own + R, buf + 2 * R * WG, c, t);
    bar_sync(1, 2 * WG);
    if (refill) {  // past the barrier both warpgroups released stage i - 1
      mbar_wait(q_empty + 8 * ((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      dkv_stage_load<L>(a, base, smem, i - 1 + STAGES, tiles, nqt, iq0, ikv,
                        ib, t);
      refill = false;
    }
    float st[BQ / 2];
    join_half<R>(own, buf, st, c, t);
    // P^T = exp2(S^T scale log2e - lse log2e), masked
    dkv_probs<BQ>(st, st, ls, a, q0, key0, key1, tq, need_mask);
    if constexpr (PASS == 1) {
      // dS^T = P^T (dP^T - delta), P rounded to dO's dtype first; packing
      // rounds dS to Q's dtype
      float dpt[BQ / 2];
      join_half<R>(own + R, buf + 2 * R * WG, dpt, c, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dj =
            *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = round_bf16(st[4 * j + e]) *
                          (dpt[4 * j + e] - ((e & 1) ? dj.y : dj.x));
      }
    }
    uint32_t f[BQ / 16][4];
    dkv_pack<BQ>(f, st);  // PASS 0 rounds P to dO's dtype
    fence_regs(acc);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<NC, BQ / 16, L::QT_CB>(
        acc, f, (PASS == 0 ? do_addr : q_addr) + own_cols);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(q_empty + 8 * s);
    // the first warp loads the stage's next tile: now if the other
    // warpgroup has released the stage too (lane 0 decides for the warp),
    // else at the next tile's exchange
    if (threadIdx.x < 32 && i + STAGES < 2 * tiles) {
      refill = !__shfl_sync(0xffffffffu,
                            mbar_test(q_empty + 8 * s, (i / STAGES) & 1), 0);
      if (!refill)
        dkv_stage_load<L>(a, base, smem, i + STAGES, tiles, nqt, iq0, ikv,
                          ib, t);
    }
  }
  store_cols<NC>(out, ss, acc, PASS == 1 ? a.scale : 1.f, key0, key1, a.sk,
                 tq, c * (D - NC), c == 0 ? 0 : NC);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
dkv_split(const __grid_constant__ DkvArgs a) {
  using namespace hopper;
  using L = DkvSplit<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  float* xbuf = reinterpret_cast<float*>(smem + L::X_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t kv_full = bar, q_full = bar + 8,
                 q_empty = q_full + 8 * STAGES;

  const int hb = a.hkv * a.batch;
  const int ik = static_cast<int>(blockIdx.x) / hb;
  const int ikv = static_cast<int>(blockIdx.x) % hb % a.hkv;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.hkv;
  const int k0 = ik * L::BK;
  const int group = a.h / a.hkv;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 32);  // the first warp's lanes
      mbar_init(q_empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int tiles = group * (nq - iq0);  // per pass
  if (threadIdx.x < 32) {  // K and V, and the first STAGES stages
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      tma_load_5d(base, &a.tk, kv_full, 0, k0, 0, ikv, ib);
      tma_load_5d(base + L::V_OFF, &a.tv, kv_full, 0, k0, 0, ikv, ib);
    }
    for (int j = 0; j < STAGES && j < 2 * tiles; ++j)
      dkv_stage_load<L>(a, base, smem, j, tiles, nq - iq0, iq0, ikv, ib,
                        threadIdx.x);
  }
  bool refill = false;  // the first warp: a stage still to refill
  const int c = threadIdx.x / WG;  // this warpgroup's queries and columns
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4;
  const int key0 = k0 + 16 * w + g, key1 = key0 + 8;
  mbar_wait(kv_full, 0);
  dkv_split_pass<D, 0>(a, base, smem, xbuf, 0, tiles, nq - iq0, iq0, k0,
                       ikv, ib, key0, key1, c, t, refill,
                       static_cast<bf16*>(a.dv) + ib * a.dv_sb +
                           ikv * a.dv_sh,
                       a.dv_ss);
  dkv_split_pass<D, 1>(a, base, smem, xbuf, tiles, tiles, nq - iq0, iq0, k0,
                       ikv, ib, key0, key1, c, t, refill,
                       static_cast<bf16*>(a.dk) + ib * a.dk_sb +
                           ikv * a.dk_sh,
                       a.dk_ss);
}

// ------------------------------------------------ bf16 at d 256: 8-warp blocks
//
// At d 256 PR 10's 12-warp blocks (dq_wgmma, dkv_wgmma) get 168 registers
// a thread from ptxas whatever setmaxnreg asks for, while a 64 x 256 f32
// accumulator alone is 128 a thread: both spilled and had every wgmma
// serialised (ptxas C7512), and K3 made two passes (dK and dV together do
// not fit one warpgroup), forming S^T twice and streaming Q and dO twice.
// The D split (dq_split, dkv_split at d 256) cured the spills but split
// the output's columns, so each score product was cut in halves and
// exchanged, and lost in turns (PERF.md §6). The designs here keep the
// 8-warp block (two consumer warpgroups, 255 registers a thread; one
// computing thread issues the TMA loads, as in the split kernels) and
// split the work by output instead.
//
// K3, `dkv_onepass<D>` (replaces `_dkv_kernel` in the JAX package's
// ops/flash_attention.py): one block per (batch, KV head, 64 keys), K and V
// of the keys resident (64 KB at d 256), Q and dO streamed in stages of
// BQ = 64 query rows (each query head of the group, from the diagonal on).
// Warpgroup 0 owns dV[64 keys x D], warpgroup 1 dK[64 x D], 128 f32
// registers a thread each. Per stage, one instruction stream for both,
// the operands chosen by address (never a branch around a wgmma):
//   t = A_c B_c^T   m64n64k16 x D/16, both from shared memory: S^T = K Q^T
//                   on warpgroup 0, dP^T = V dO^T on warpgroup 1
//   P^T = exp2(t scale log2e - lse log2e), masked, rounded to dO's dtype,
//       written by warpgroup 0 to a double-buffered exchange buffer in
//       fragment order (one named barrier a stage)
//   f = P^T (warpgroup 0), or dS^T = P^T (dP^T - delta) rounded to Q's
//       dtype (warpgroup 1, reading P^T from the buffer)
//   acc += f Y_c    m64nDk16 x 4, A from registers, Y_0 = dO and Y_1 = Q
//                   read MN-major (wgmma_rs_t_cols)
// Four products a stage, each formed once (dkv_wgmma's two passes form
// five), and Q and dO streamed once. Bound on an H100: operations (four
// products of 2 s^2 d / 2 flops per head, hundreds of flops per byte);
// per stage 8.4 MFLOP against 64 KB of Q and dO from L2, so the two
// stages must overlap each other's loads, which the 64 KB of resident K
// and V and 16 KB of exchange leave room for (about 210 KB).
// At d 192 the same kernel (48 KB of K and V, 96 accumulator registers a
// thread, 183 registers, clean) lost to dkv_wgmma<192> in turns
// (PERF.md §6) and is built only with -DFLASH_OTHER_DESIGNS=1: with h d
// kept, d 192 has 4/3 the heads of d 256, so 4/3 the 64 x 64 stages, each
// with 3/4 of the products, and the per-stage serial part (S^T's wait, the
// exponentials, the exchange barrier, P V's wait: the tensor cores idle)
// weighs more; 96-query stages or a third stage did not pay
// (kernel_variants.py).
//
// K2, `dq_rows8<D>` (replaces `_dq_kernel`): dq_wgmma's rows, 128 query
// rows a block with Q and dO resident, 64 a warpgroup, K and V streamed in
// 32-key stages at d 256 (3 fit beside Q and dO), 64-key stages at d 192
// (2) and d 64 (4, see below), without the producer warpgroup:
// S = Q K^T and dP = dO V^T (m64nBK), dS = P (dP - delta), dQ += dS K
// (m64nDk16, K read MN-major), as dq_consumer does. Bound on an H100:
// operations (three products); what held dq_wgmma<256> back was ptxas's
// 168 registers a thread (a 12-warp block) beside the 128-register dQ,
// so every wgmma ran serialised: this block has 255. Thread 0 refills a
// stage once both warpgroups have released it, testing without waiting,
// and waits only when the stage's next tile is due. At d 192 it replaces
// dq_wgmma<192> (12 warps at 168 registers, 5 stages of 32 keys, the
// other build's design there): with 255 registers a thread S and dP take
// 64 keys a stage (32 registers each beside dQ's 96; 188 in all), which
// halves the stages, their mbarrier round trips and the exp2/dS chains
// paid per key, and S and dP go in two commit groups, P's exponentials
// formed while dP is in flight (SPLIT; +-1% at d 64); on 32-key stages
// it lost to dq_wgmma<192> (kernel_variants.py; PERF.md §6).
//
// Both keep dkv_wgmma's and dq_wgmma's rounding rules, scale dK or dQ once
// at the end and write their own rows: every sum runs in one block in a
// fixed order, deterministic, no atomics.

// K3 one pass: K and V of the block's 64 keys (resident), the Q and dO
// stages, their lse and delta, two exchange buffers of P^T (bf16 pairs in
// fragment order) and the mbarriers (kv_full, q_full[S], q_empty[S], as
// DkvSplit, so dkv_stage_load fills both).
template <int D>
struct DkvOnePass {
  static constexpr int BK = 64;  // keys per block
  static constexpr int BQ = 64;  // query rows per stage
  static constexpr int STAGES = 2;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int QT_CB = BQ * 128;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int ROW_BYTES = BQ * 4;
  static constexpr int XCH = BQ / 4 * WG;  // 32-bit words a buffer
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int L_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int DL_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int X_OFF = DL_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * XCH * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(D % 64 == 0 && D <= 256, "dK, dV: 256 columns a warpgroup");
  static_assert(BYTES <= SMEM_MAX, "227 KB a block");
};

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
dkv_onepass(const __grid_constant__ DkvArgs a) {
  using namespace hopper;
  using L = DkvOnePass<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + L::X_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t kv_full = bar, q_full = bar + 8,
                 q_empty = q_full + 8 * STAGES;

  // heaviest key tiles (the first, under causal masking) first
  const int hb = a.hkv * a.batch;
  const int ik = static_cast<int>(blockIdx.x) / hb;
  const int ikv = static_cast<int>(blockIdx.x) % hb % a.hkv;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.hkv;
  const int k0 = ik * L::BK;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int nqt = nq - iq0;
  const int tiles = a.h / a.hkv * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 32);  // the first warp's lanes
      mbar_init(q_empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // K and V, and the first STAGES stages
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      tma_load_5d(base, &a.tk, kv_full, 0, k0, 0, ikv, ib);
      tma_load_5d(base + L::V_OFF, &a.tv, kv_full, 0, k0, 0, ikv, ib);
    }
    for (int j = 0; j < STAGES && j < tiles; ++j)
      dkv_stage_load<L>(a, base, smem, j, tiles, nqt, iq0, ikv, ib,
                        threadIdx.x);
  }

  const int c = threadIdx.x / WG;  // 0: dV, 1: dK
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int key0 = k0 + 16 * w + g, key1 = key0 + 8;
  // this warpgroup's operands, by address: the score product's A (K or V)
  // and B (Q or dO), and the accumulated product's B (dO or Q)
  const uint32_t a_addr = base + c * L::V_OFF;
  const uint32_t b_off = c * (L::DO_OFF - L::Q_OFF);
  const uint32_t y_off = (1 - c) * (L::DO_OFF - L::Q_OFF);
  float acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
  bool refill = false;  // the first warp: a stage still to refill

  mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int s = n % STAGES;
    const int q0 = (iq0 + n % nqt) * BQ;
    const uint32_t q_addr = base + L::Q_OFF + s * L::QT_BYTES;
    const float* ls =
        reinterpret_cast<const float*>(smem + L::L_OFF + s * L::ROW_BYTES);
    const float* dl =
        reinterpret_cast<const float*>(smem + L::DL_OFF + s * L::ROW_BYTES);
    const bool need_mask = (a.causal && q0 < k0 + L::BK) || q0 + BQ > a.sq;
    mbar_wait(q_full + 8 * s, (n / STAGES) & 1);

    // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x BQ queries
    float st[BQ / 2];
    wgmma_fence();
    wgmma_ss<BQ, D / 16, L::KV_CB, L::QT_CB>(
        st, desc_sw128(a_addr, 16, 1024),
        desc_sw128(q_addr + b_off, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    // P^T in dO's dtype, from warpgroup 0's S^T, through the buffer: the
    // register pair r of the A fragments (dkv_pack's order) is word
    // r * 128 + t. Warpgroup 1's arithmetic on dP^T here is discarded.
    uint32_t* buf = xbuf + (n & 1) * L::XCH;
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
      mbar_wait(q_empty + 8 * ((n - 1) % STAGES), ((n - 1) / STAGES) & 1);
      dkv_stage_load<L>(a, base, smem, n - 1 + STAGES, tiles, nqt, iq0, ikv,
                        ib, t);
      refill = false;
    }

    // f = P^T (warpgroup 0) or dS^T = P^T (dP^T - delta), P rounded to
    // dO's dtype first and dS to Q's by the packing (warpgroup 1)
    uint32_t f[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t pk = buf[(2 * j + h) * WG + t];
        const float p0 = __uint_as_float(pk << 16);
        const float p1 = __uint_as_float(pk & 0xffff0000u);
        const uint32_t ds = pack_bf16x2(p0 * (st[4 * j + 2 * h] - dj.x),
                                        p1 * (st[4 * j + 2 * h + 1] - dj.y));
        f[j / 2][2 * (j % 2) + h] = c == 0 ? pk : ds;
      }
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
    fence_regs(acc);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(acc, f, q_addr + y_off);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(q_empty + 8 * s);
    // the first warp loads the stage's next tile: now if the other
    // warpgroup has released the stage too (lane 0 decides for the warp),
    // else past the next stage's exchange barrier
    if (threadIdx.x < 32 && n + STAGES < tiles) {
      refill = !__shfl_sync(0xffffffffu,
                            mbar_test(q_empty + 8 * s, (n / STAGES) & 1), 0);
      if (!refill)
        dkv_stage_load<L>(a, base, smem, n + STAGES, tiles, nqt, iq0, ikv,
                          ib, t);
    }
  }
  bf16* out = static_cast<bf16*>(c == 0 ? a.dv : a.dk) +
              ib * (c == 0 ? a.dv_sb : a.dk_sb) +
              ikv * (c == 0 ? a.dv_sh : a.dk_sh);
  dkv_store<D>(out, c == 0 ? a.dv_ss : a.dk_ss, acc, c == 0 ? 1.f : a.scale,
               key0, key1, a.sk, tq);
}

// ------------------------------------------------ bf16 at d 64: 8-warp blocks
//
// At d 64 every product reduces over few k16 steps (the score products
// over d: four), so a stage carries little tensor-core work beside its
// serial part: the full/empty round trip, the waits on the products, and
// per score the exp2, the masks, dS and the bf16 re-packs, which do not
// shrink with d. PR 10's row split reached 0.193 (dkv_wgmma<64>: 12 warps,
// two passes, S^T and the exponentials formed twice) and 0.283
// (dq_wgmma<64>) of its bound there; both are the other build's design at
// d 64 now. What the H100 decided in turns (kernel_variants.py, PERF.md
// §6): larger score tiles, more warpgroups a SM, and S^T issued before
// the stage's bookkeeping.
//
// K3, `dkv_keys8<D>` (replaces `_dkv_kernel` in the JAX package's
// ops/flash_attention.py): dK and dV of 64 keys are 32 f32 registers each
// at d 64, so one warpgroup holds both. One block per (batch, KV head, 128
// keys), K and V of the keys resident (32 KB), Q and dO streamed in stages
// of 128 query rows (each query head of the group, from the diagonal on)
// through 4 stages, the first warp loading them as dkv_onepass's does.
// Two warpgroups, 64 keys each; no named barrier, no exchange: they meet
// only at the stages' empty barriers. Per stage, on each warpgroup:
//   S^T = K Q^T, dP^T = V dO^T  m64n128k16 x 4 each, both from shared
//                               memory, two commit groups, issued by the
//                               stage before once it has released its own
//                               (while the first warp refills)
//   P^T = exp2(S^T scale log2e - lse log2e), masked, once S^T is in (dP^T
//       still in flight), rounded to dO's dtype and packed as A fragments
//   dV += P^T dO                m64n64k16 x 8, dO read MN-major, in flight
//                               while
//   dS^T = P^T (dP^T - delta)   (P as rounded) forms, rounded to Q's dtype
//   dK += dS^T Q                as dV
// Four products a stage, each formed once, and Q and dO streamed once;
// 237 registers a thread, clean. Bound on an H100: operations (2 d flops
// a causal pair a product, 4 products; 8.4 MFLOP a stage against 32 KB
// of Q and dO from L2). 64-query stages (m64n64 scores, 165 registers)
// lost by a quarter, the scores issued inside their own stage by 5%, 2
// or 5 stages and dS before dV's product changed nothing, and
// dkv_onepass<64> (dV and dK on different warpgroups, P^T exchanged) lost
// by half. dK is scaled once, at the end; every sum runs in one block in
// a fixed order, deterministic, no atomics.
//
// K2 at d 64 is dq_rows8<64> (below) on 64-key stages: 122 registers a
// thread, so two blocks (four warpgroups) share an SM; 128-key stages
// (186 registers, one block) lost by 40%.

// K3 at d 64: K and V of the block's 128 keys (resident), the Q and dO
// stages, their lse and delta and the mbarriers (kv_full, q_full[S],
// q_empty[S], as DkvSplit, so dkv_stage_load fills them).
template <int D>
struct DkvKeys8 {
  static constexpr int BK = 128;  // keys per block: 64 a warpgroup
  static constexpr int BQ = 128;  // query rows per stage
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int QT_CB = BQ * 128;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int ROW_BYTES = BQ * 4;
  static constexpr int FIT =
      (SMEM_MAX - 2048 - 2 * KV_BYTES) / (2 * QT_BYTES + 2 * ROW_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int L_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int DL_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = DL_OFF + STAGES * ROW_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(D == 64, "dK and dV of 64 keys beside the scores: d 64");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// S^T = K Q^T and dP^T = V dO^T of the stage in ring slot `s` (64 keys x
// BQ queries each, both operands from shared memory; `k_addr`: this
// warpgroup's K rows), one commit group each.
template <int D>
__device__ __forceinline__ void dkv_keys8_scores(
    float (&st)[DkvKeys8<D>::BQ / 2], float (&dpt)[DkvKeys8<D>::BQ / 2],
    uint32_t base, uint32_t k_addr, int s) {
  using namespace hopper;
  using L = DkvKeys8<D>;
  wgmma_fence();
  wgmma_ss<L::BQ, D / 16, L::KV_CB, L::QT_CB>(
      st, desc_sw128(k_addr, 16, 1024),
      desc_sw128(base + L::Q_OFF + s * L::QT_BYTES, 16, 1024));
  wgmma_commit();
  wgmma_ss<L::BQ, D / 16, L::KV_CB, L::QT_CB>(
      dpt, desc_sw128(k_addr + L::V_OFF, 16, 1024),
      desc_sw128(base + L::DO_OFF + s * L::QT_BYTES, 16, 1024));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
dkv_keys8(const __grid_constant__ DkvArgs a) {
  using namespace hopper;
  using L = DkvKeys8<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t kv_full = bar, q_full = bar + 8,
                 q_empty = q_full + 8 * STAGES;

  // heaviest key tiles (the first, under causal masking) first
  const int hb = a.hkv * a.batch;
  const int ik = static_cast<int>(blockIdx.x) / hb;
  const int ikv = static_cast<int>(blockIdx.x) % hb % a.hkv;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.hkv;
  const int k0 = ik * L::BK;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int nqt = nq - iq0;
  const int tiles = a.h / a.hkv * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 32);  // the first warp's lanes
      mbar_init(q_empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // K and V, and the first STAGES stages
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      tma_load_5d(base, &a.tk, kv_full, 0, k0, 0, ikv, ib);
      tma_load_5d(base + L::V_OFF, &a.tv, kv_full, 0, k0, 0, ikv, ib);
    }
    for (int j = 0; j < STAGES && j < tiles; ++j)
      dkv_stage_load<L>(a, base, smem, j, tiles, nqt, iq0, ikv, ib,
                        threadIdx.x);
  }
  int next = STAGES;  // the first warp: the next stage to load

  const int c = threadIdx.x / WG;  // this warpgroup's 64 keys
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int kw0 = k0 + 64 * c;
  const int key0 = kw0 + 16 * w + g, key1 = key0 + 8;
  const uint32_t k_addr = base + c * 64 * 128;
  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dv[r] = dk[r] = 0.f;

  // stage 0's scores; each stage issues the next one's (the last stage
  // its own again, unused: no branch encloses a wgmma) as soon as it has
  // released its own, so they run while the first warp refills
  float st[BQ / 2], dpt[BQ / 2];
  mbar_wait(kv_full, 0);
  if (tiles > 0) mbar_wait(q_full, 0);  // else no stage: nothing is read
  dkv_keys8_scores<D>(st, dpt, base, k_addr, 0);
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int s = n % STAGES;
    // the first warp refills each stage that both warpgroups have released
    // (stage `next` reuses the ring slot of stage next - STAGES, which this
    // warpgroup released if next - STAGES < n), testing without waiting
    // (lane 0 decides for the warp); it waits only when the stage is due:
    // stage n + 1, whose scores this stage issues
    if (threadIdx.x < 32) {
      for (; next < tiles && next < n + STAGES; ++next) {
        const uint32_t e = q_empty + 8 * (next % STAGES);
        const uint32_t par = ((next - STAGES) / STAGES) & 1;
        if (next > n + 1 && !__shfl_sync(0xffffffffu, mbar_test(e, par), 0))
          break;
        mbar_wait(e, par);
        dkv_stage_load<L>(a, base, smem, next, tiles, nqt, iq0, ikv, ib,
                          threadIdx.x);
      }
    }
    const int q0 = (iq0 + n % nqt) * BQ;
    const uint32_t q_addr = base + L::Q_OFF + s * L::QT_BYTES;
    const uint32_t do_addr = base + L::DO_OFF + s * L::QT_BYTES;
    const float* ls =
        reinterpret_cast<const float*>(smem + L::L_OFF + s * L::ROW_BYTES);
    const float* dl =
        reinterpret_cast<const float*>(smem + L::DL_OFF + s * L::ROW_BYTES);
    const bool need_mask = (a.causal && q0 < kw0 + 64) || q0 + BQ > a.sq;

    // P^T in dO's dtype, as A fragments, once S^T is in (dP^T still in
    // flight)
    wgmma_wait<1>();
    fence_regs(st);
    dkv_probs<BQ>(st, st, ls, a, q0, key0, key1, tq, need_mask);
    uint32_t fp[BQ / 16][4];
    dkv_pack<BQ>(fp, st);
    wgmma_wait<0>();
    fence_regs(dpt);

    // dV += P^T dO, in flight while dS^T forms
    fence_regs(dv);
    fence_regs(fp);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dv, fp, do_addr);
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) from the rounded P^T (fragment j / 2's
    // registers 2 (j % 2) and 2 (j % 2) + 1 hold columns 8j .. 8j + 7, as
    // dkv_pack lays them), rounded to Q's dtype by the packing
    uint32_t fds[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t pk = fp[j / 2][2 * (j % 2) + h];
        fds[j / 2][2 * (j % 2) + h] =
            pack_bf16x2(__uint_as_float(pk << 16) *
                            (dpt[4 * j + 2 * h] - dj.x),
                        __uint_as_float(pk & 0xffff0000u) *
                            (dpt[4 * j + 2 * h + 1] - dj.y));
      }
    }

    // dK += dS^T Q; once both products are in the stage is released and
    // the next one's scores go out
    fence_regs(dk);
    fence_regs(fds);
    wgmma_fence();
    wgmma_rs_t_cols<D, BQ / 16, L::QT_CB>(dk, fds, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(fp);
    fence_regs(fds);
    mbar_arrive(q_empty + 8 * s);
    const int nn = n + 1 < tiles ? n + 1 : n;
    mbar_wait(q_full + 8 * (nn % STAGES), (nn / STAGES) & 1);
    fence_regs(st);
    fence_regs(dpt);
    dkv_keys8_scores<D>(st, dpt, base, k_addr, nn % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  dkv_store<D>(static_cast<bf16*>(a.dv) + ib * a.dv_sb + ikv * a.dv_sh,
               a.dv_ss, dv, 1.f, key0, key1, a.sk, tq);
  dkv_store<D>(static_cast<bf16*>(a.dk) + ib * a.dk_sb + ikv * a.dk_sh,
               a.dk_ss, dk, a.scale, key0, key1, a.sk, tq);
}

// K2 on 8 warps: Q and dO (128 rows, resident), the K stages, the V stages
// and the mbarriers (q_full, kv_full[S], kv_empty[S]).
template <int D>
struct DqRows8 {
  static constexpr int BQ = 128;  // query rows per block: 64 a warpgroup
  // keys per K/V stage
  static constexpr int BK = D <= 64 || D == 192 ? 64 : 32;
  // S and dP in two commit groups (the softmax's exp2 under dP's product)
  static constexpr bool SPLIT = D == 192;
  static constexpr int Q_CB = BQ * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int FIT = (SMEM_MAX - 2048 - 2 * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(D % 64 == 0 && D <= 256, "dQ: 256 columns a warpgroup");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// K and V of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void dq_rows8_load(const DqArgs& a, uint32_t base,
                                              int i, int ikv, int ib) {
  using namespace hopper;
  using L = DqRows8<D>;
  const int s = i % L::STAGES;
  const uint32_t full_s = base + L::BAR_OFF + 8 + 8 * s;
  mbar_arrive_expect_tx(full_s, 2 * L::KV_BYTES);
  tma_load_5d(base + L::K_OFF + s * L::KV_BYTES, &a.tk, full_s, 0,
              i * L::BK, 0, ikv, ib);
  tma_load_5d(base + L::V_OFF + s * L::KV_BYTES, &a.tv, full_s, 0,
              i * L::BK, 0, ikv, ib);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
dq_rows8(const __grid_constant__ DqArgs a) {
  using namespace hopper;
  using L = DqRows8<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, kv_full = bar + 8,
                 kv_empty = kv_full + 8 * STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV head
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = iq * BQ;
  // the same key tiles for both warpgroups: up to the diagonal of the
  // block's last row
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // Q and dO, and the first STAGES key tiles
    mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
    tma_load_5d(base, &a.tq, q_full, 0, q0, 0, ih, ib);
    tma_load_5d(base + L::DO_OFF, &a.tdo, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < STAGES && i < nk; ++i)
      dq_rows8_load<D>(a, base, i, ikv, ib);
  }
  int next = STAGES;  // thread 0: the next key tile to load

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + c * 64 * 128;
  const uint32_t do_addr = base + L::DO_OFF + c * 64 * 128;

  // rows past sq read lse = delta = 0 (and Q = dO = 0): dS = 0 there, and
  // those rows are not written
  const int64_t rows = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  const float ls0 = row0 < a.sq ? a.lse[rows + row0] * kLog2e : 0.f;
  const float ls1 = row1 < a.sq ? a.lse[rows + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.sq ? a.delta[rows + row0] : 0.f;
  const float dl1 = row1 < a.sq ? a.delta[rows + row1] : 0.f;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;
    // thread 0 refills each stage that both warpgroups have released
    // (tile `next` reuses the stage of tile next - STAGES, which this
    // warpgroup released if next - STAGES < i), testing without waiting;
    // it waits only when the tile is due now
    if (threadIdx.x == 0) {
      for (; next < nk && next < i + STAGES; ++next) {
        const uint32_t e = kv_empty + 8 * (next % STAGES);
        const uint32_t par = ((next - STAGES) / STAGES) & 1;
        if (next > i && !mbar_test(e, par)) break;
        mbar_wait(e, par);
        dq_rows8_load<D>(a, base, next, ikv, ib);
      }
    }

    // S = Q K^T and dP = dO V^T: 64 rows x BK keys each (SPLIT: in two
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

    // dS = P (dP - delta) with P = exp2(S scale log2e - lse log2e) in f32,
    // in place in sc; P = 0 past sk and (causal) after the row
    const bool need_mask = (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], a.scale_log2,
                                 -(e < 2 ? ls0 : ls1)));
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          if (col >= a.sk || (a.causal && col > (e < 2 ? row0 : row1)))
            p = 0.f;
        }
        if constexpr (L::SPLIT)
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

    // dQ += dS K
    fence_regs(dq);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(dq, f, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(kv_empty + 8 * s);
  }
  store_cols<D>(static_cast<bf16*>(a.dq) + ib * a.dq_sb + ih * a.dq_sh,
                a.dq_ss, dq, a.scale, row0, row1, a.sq, tq, 0, 0);
}

// ------------------------------------------------ f32: CUDA cores
//
// float32 inputs run on the CUDA cores in true f32 FMA (no TF32), so f32
// parity with the reference holds. Two designs (F32Design; the C function
// flash_bwd_f32_design reports the one a build runs, and chip_smoke.py
// labels its f32 timings by it):
//   kF32Tiled   dq_f32, dkv_f32 (below): register-tiled FFMA kernels with
//               cp.async loads through a ring of stages;
//   kF32Scalar  dq_f32_scalar, dkv_f32_scalar (PR 2's): each thread forms
//               whole length-D dots from shared memory, loads synchronous.
// The tiled kernels ship at every head dim; a build with
// -DFLASH_OTHER_DESIGNS=1 runs the scalar ones at d 128 instead.
//
// What bounds them: the f32 FMA rate (67 TF/s on an H100; the bytes are
// ~1% of it). An SM's FP32 pipes do 128 FMAs a clock and its shared memory
// delivers 32 words a clock, so a kernel that reads an operand from shared
// memory for every FMA or two (the scalar design: 2 loads a FMA in the
// score products) is capped at 1/4 to 1/8 of the rate. The tiled design:
//   - 256 threads (8 warps) a block; every product is register-tiled. A
//     score tile (R rows x C columns: K2 query rows x keys, K3 keys x query
//     rows) gives each thread SR x SC scores (K2: of S and of dP; K3: of S
//     on warps 0-3, of dP on warps 4-7), rows gr + GR i and columns
//     gc + GC j (interleaved, so the rows a warp reads are consecutive and
//     fall in distinct bank groups); per 4 of D it reads one float4 a row
//     and a column (16-byte loads, each shared by the 8 or 4 lanes of the
//     warp that own the same row or column: broadcast) and does 4 SR SC
//     FMAs a product. The output product (K2 dQ += dS K; K3 dV += P^T dO on
//     warps 0-3 and dK += dS^T Q on warps 4-7) gives each thread TR rows (a
//     float4 or float2 of the score operand a step) and D / 16 (K2) or
//     D / 8 (K3) columns (float4s of the row operand a step). At d 128: 16
//     float4s for 128 FMAs in K2's scores (8 FMAs a delivered word with the
//     broadcasts), 3 for 32 in its dQ product; K3 8 for 64 and 5 for 64.
//   - dS (K2) or P and dS (K3) go through shared memory once, stored as
//     [reduction index][output row] (pitch + 4: conflict-free stores), the
//     layout the output product reads in float4s.
//   - The streamed tiles (K2: K and V; K3: Q, dO and their lse and delta)
//     fill a ring of ST stages by cp.async 16-byte copies (cp.async.cg,
//     zero-filled past the sequence's end), one commit group a tile: the
//     copies of tile i + ST - 1 are in flight while tile i is computed
//     (from d 256 ST = 1: there the shared memory holds one stage of
//     twice the keys or query rows, and the larger score tiles win over
//     the overlap, which is worth a few percent). The resident tile (K2:
//     Q and dO; K3: K and V) is loaded once, in the first group. Rows are
//     padded to D + 4 floats: consecutive rows fall in distinct 16-byte
//     bank groups.
//   - P = exp2(S scale log2e - lse log2e), the scale folded in (a masked
//     score gets P = 0 by a select), dS = P (dP - delta), as the bf16
//     kernels form them.
//   - Tiles per head dim (DqF32, DkvF32) keep a block within 227 KB of
//     shared memory and a thread within 255 registers: from d 320 blocks
//     of 32 query rows (K2) or keys (K3), so that a thread's output block
//     (BQ D / 256 floats in K2, BK D / 128 in K3) stays at most 128.
//   - K3's parallelism is (s / BK) hkv b blocks, under one wave of 132 SMs
//     at b 2 s 1000 with 4 KV heads; with causal masking the first key
//     tiles also carry the most query tiles. So when a launch has fewer
//     than two blocks a SM, each key tile's (group head, query tile) items
//     are split into NS = 2 SMs / blocks (at most 4) contiguous ranges,
//     one block each, whose partial dK and dV go to a workspace;
//     f32_reduce sums them in split order. K2 splits its blocks' key
//     ranges the same way (NS rounded up: its 192 blocks at d 256 and 512
//     are 1.45 waves). No atomics anywhere: launched twice on one input
//     the kernels give the same bits.
//   - Heaviest tiles launch first (K2: the last query tiles; K3: the first
//     key tiles), as in the bf16 kernels.

enum F32Design { kF32Scalar = 0, kF32Tiled = 1 };

constexpr int f32_design(int d) {
  return FLASH_OTHER_DESIGNS && d == 128 ? kF32Scalar : kF32Tiled;
}

// at most this many query-range splits of a K3 key tile
constexpr int F32_MAX_SPLITS = 4;

// K2's tiles at head dim D: BQ query rows a block (resident Q and dO), K/V
// tiles of BK keys in ST stages (from d 256 one: the larger key tile a
// single stage leaves room for beat two stages of half of it in turns,
// kernel_variants.py), SR x SC scores a thread (query rows gr + 16 i, keys
// gc + 16 j), TR = BQ / 16 rows and D / 16 columns of dQ.
template <int D>
struct DqF32 {
  static constexpr int BQ = D <= 256 ? 64 : 32;
  static constexpr int BK = D <= 128 ? 64 : D <= 384 ? 32 : 16;
  static constexpr int ST = D <= 64 ? 3 : D <= 192 ? 2 : 1;
  static constexpr int SR = BQ / 16, SC = BK / 16;
  static constexpr int P = D + 4;       // row pitch, floats
  static constexpr int XP = BQ + 4;     // dS^T [BK][XP]
  static constexpr int Q_OFF = 0, DO_OFF = BQ * P, KV_OFF = 2 * BQ * P;
  static constexpr int X_OFF = KV_OFF + ST * 2 * BK * P;
  static constexpr int BYTES = (X_OFF + BK * XP) * 4;
  static_assert(BYTES <= SMEM_MAX, "227 KB a block");
};

// K3's tiles at head dim D: BK keys a block (resident K and V), Q/dO tiles
// of BQ query rows in ST stages (from d 256 one, as in K2). Each warp half
// (128 threads) computes one score product, SR x SC scores a thread (keys
// gr + 16 i, queries gc + 8 j), and owns one output (TR rows, D / 32
// float4 columns).
template <int D>
struct DkvF32 {
  static constexpr int BK = D <= 256 ? 64 : 32;
  static constexpr int BQ = D <= 64 ? 64 : D <= 384 ? 32 : 16;
  static constexpr int ST = D <= 192 ? 2 : 1;
  static constexpr int SR = BK / 16, SC = BQ / 8;
  static constexpr int P = D + 4;
  static constexpr int XP = BK + 4;     // P and dS, each [BQ][XP]
  static constexpr int K_OFF = 0, V_OFF = BK * P, QO_OFF = 2 * BK * P;
  static constexpr int L_OFF = QO_OFF + ST * 2 * BQ * P;  // lse, delta
  static constexpr int X_OFF = L_OFF + ST * 2 * BQ;
  static constexpr int BYTES = (X_OFF + 2 * BQ * XP) * 4;
  static_assert(BYTES <= SMEM_MAX, "227 KB a block");
};

// ROWS floats of a [b, h, s] row (lse or delta) from `src` + r0 into `dst`,
// zero past `limit`, by 4-byte cp.async (the rows need not be aligned).
template <int ROWS>
__device__ __forceinline__ void f32_vec_async(float* dst, const float* src,
                                              int r0, int limit, int tid) {
  if (tid < ROWS) {
    const bool in = r0 + tid < limit;
    hopper::cp_async_4(hopper::smem_u32(dst + tid), src + (in ? r0 + tid : 0),
                       in ? 4 : 0);
  }
}

// Store a thread's TR output rows (rows row0 + i, stride ss) at float4
// columns oc + OC n, times `scale`, skipping rows at or past `rows`.
template <int D, int TR, int OC>
__device__ __forceinline__ void f32_store(float* out, int64_t ss,
                                          const float (&acc)[TR][D / OC],
                                          float scale, int row0, int rows,
                                          int oc) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (row0 + i >= rows) continue;
    float* o = out + (row0 + i) * ss + 4 * oc;
#pragma unroll
    for (int n = 0; n < D / (4 * OC); ++n)
      *reinterpret_cast<float4*>(o + 4 * OC * n) =
          make_float4(acc[i][4 * n] * scale, acc[i][4 * n + 1] * scale,
                      acc[i][4 * n + 2] * scale, acc[i][4 * n + 3] * scale);
  }
}

// K2, f32: dQ for one (b, head, BQ-row query tile), or with ns > 1 its
// part of it over one of ns contiguous ranges of the tile's key tiles,
// written unscaled to the workspace `ws` ([ns][b h][sq][D]). Grid:
// blockIdx.x = t (ns h b) + split (h b) + ib h + ih, the query tile
// nq - 1 - t under causal masking (heaviest first).
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    dq_f32(const Params p, float* ws, int ns) {
  using L = DqF32<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = BQ / 16, P = L::P;
  static_assert(BQ == 16 * SR && BK == 16 * SC, "a 16 x 16 thread grid");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qs = sm + L::Q_OFF;
  float* Os = sm + L::DO_OFF;
  float* Xs = sm + L::X_OFF;

  const int tid = threadIdx.x;
  // a 16 x 16 thread grid, lane (lane / 8, lane % 8) of each warp at (gr,
  // gc): score rows gr + 16 i and columns gc + 16 j (the rows a warp reads
  // consecutive, in distinct bank groups), dQ rows TR gr .. + TR - 1 and
  // float4 columns gc + 16 n
  const int gr = 4 * (tid >> 6) + ((tid >> 3) & 3);
  const int gc = 8 * ((tid >> 5) & 1) + (tid & 7);
  const int nq = (p.sq + BQ - 1) / BQ;
  const int per_t = gridDim.x / nq;  // ns h b
  const int hb = per_t / ns;         // h b
  const int t = blockIdx.x / per_t;
  const int split = blockIdx.x % per_t / hb;
  const int ih = blockIdx.x % hb % p.h, ib = blockIdx.x % hb / p.h;
  const int q0 = (p.causal ? nq - 1 - t : t) * BQ;
  const int ikv = ih / (p.h / p.hkv);
  const float* k = head_ptr<float>(p.k, p.st[K], ib, ikv);
  const float* v = head_ptr<float>(p.v, p.st[V], ib, ikv);
  int nk = (p.sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int beg = split * nk / ns, end = (split + 1) * nk / ns;

  auto issue = [&](int ik) {
    float* kv = sm + L::KV_OFF + (ik - beg) % ST * 2 * BK * P;
    f32_rows_async<D, BK>(kv, k, p.st[K][2], ik * BK, p.sk, tid);
    f32_rows_async<D, BK>(kv + BK * P, v, p.st[V][2], ik * BK, p.sk, tid);
  };
  f32_rows_async<D, BQ>(Qs, head_ptr<float>(p.q, p.st[Q], ib, ih),
                        p.st[Q][2], q0, p.sq, tid);
  f32_rows_async<D, BQ>(Os, head_ptr<float>(p.dout, p.st[DO], ib, ih),
                        p.st[DO][2], q0, p.sq, tid);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (beg + s < end) issue(beg + s);
    hopper::cp_async_commit();
  }

  // the thread's score rows: lse (log2 domain) and delta
  const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
  float ls[SR], dl[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int row = q0 + gr + 16 * i;
    ls[i] = row < p.sq ? p.lse[rowbase + row] * hopper::kLog2e : 0.f;
    dl[i] = row < p.sq ? p.delta[rowbase + row] : 0.f;
  }
  const float scale_log2 = p.scale * hopper::kLog2e;

  float acc[TR][D / 16];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

#pragma unroll 1
  for (int ik = beg; ik < end; ++ik) {
    f32_next_stage<ST>(ik, end, issue);  // tile ik is in

    const float* Ks = sm + L::KV_OFF + (ik - beg) % ST * 2 * BK * P;
    const float* Vs = Ks + BK * P;
    const int k0 = ik * BK;

    // S = Q K^T (sd[0]) and dP = dO V^T (sd[1])
    float sd[2][SR][SC];
    f32_dots<D, SR, SC, 16, 16, 2>(sd, {Qs, Os}, {Ks, Vs}, gr, gc);

    // dS = P (dP - delta), P = 0 past sk and (causal) after the row
    const bool need_mask =
        (p.causal && k0 + BK - 1 > q0) || k0 + BK > p.sk;
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float pr = hopper::fast_exp2(fmaf(sd[0][i][j], scale_log2, -ls[i]));
        if (need_mask) {
          const int col = k0 + gc + 16 * j;
          if (col >= p.sk || (p.causal && col > q0 + gr + 16 * i))
            pr = 0.f;
        }
        Xs[(gc + 16 * j) * L::XP + gr + 16 * i] =
            pr * (sd[1][i][j] - dl[i]);
      }
    __syncthreads();

    // dQ += dS K
    f32_outer<D, TR, BK, L::XP, 16>(acc, Xs, Ks, TR * gr, gc);
  }
  // nothing in flight at exit (an ST = 1 block whose range was empty has
  // its resident copies uncommitted)
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  if (ns == 1) {
    f32_store<D, TR, 16>(
        head_ptr_mut<float>(p.dq, p.st[DQ], ib, ih) + q0 * p.st[DQ][2],
        p.st[DQ][2], acc, p.scale, TR * gr, p.sq - q0, gc);
  } else {
    f32_store<D, TR, 16>(
        ws + ((static_cast<int64_t>(split) * hb + ib * p.h + ih) * p.sq +
              q0) * D,
        D, acc, 1.f, TR * gr, p.sq - q0, gc);
  }
}

// The number of splits a launch of `blocks` blocks takes on the current
// device: 1 from two blocks a SM up, else about two a SM, the quotient
// rounded up or down (at most F32_MAX_SPLITS).
inline int f32_splits(int blocks, bool up) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks >= 2 * sms) return 1;
  const int ns = up ? (2 * sms + blocks - 1) / blocks : 2 * sms / blocks;
  return std::max(1, std::min(F32_MAX_SPLITS, ns));
}

// K2's key-range splits: rounded up (192 blocks at b 2 s 1000 d 256 or 512,
// 1.45 waves, take 2). K3's query-range splits: rounded down (128 blocks
// at b 2 s 1000 d 128 take 2; 3 and 4 were slower in turns,
// kernel_variants.py).
template <int D>
int dq_f32_splits(int batch, int h, int sq) {
  return f32_splits((sq + DqF32<D>::BQ - 1) / DqF32<D>::BQ * h * batch,
                    true);
}
template <int D>
int dkv_f32_splits(int batch, int hkv, int sk) {
  return f32_splits((sk + DkvF32<D>::BK - 1) / DkvF32<D>::BK * hkv * batch,
                    false);
}

// K3, f32: dK and dV for one (b, KV head, BK-key tile), or with ns > 1 its
// part of them over one of ns contiguous ranges of the tile's (group head,
// query tile) items, written to the workspace `ws` ([ns][2][b hkv][sk][D]:
// dK unscaled, then dV). Grid: blockIdx.x = t (ns hkv b) + split (hkv b) +
// ib hkv + ikv, the key tile t (heaviest first under causal masking).
//
// The warp halves split the work as dkv_onepass splits its warpgroups:
// warps 0-3 form S^T = K Q^T, P^T (masked) into shared memory and own dV
// += P^T dO; warps 4-7 form dP^T = V dO^T, read P^T back for dS^T =
// P^T (dP^T - delta) and own dK += dS^T Q. A thread's score tile is then
// 4 x 4 at d 128 (8 float4s for 64 FMAs, where both products on 4 x 2
// took 12), and its output D / 32 float4 columns of one matrix.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    dkv_f32(const Params p, float* ws, int ns) {
  using L = DkvF32<D>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = BK / 16, P = L::P, HALF = F32_THREADS / 2;
  static_assert(BK == 16 * SR && BQ == 8 * SC, "a 16 x 8 grid a half");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Ps = sm + L::X_OFF;
  float* Ss = Ps + BQ * L::XP;

  const int tid = threadIdx.x;
  const int half = tid / HALF, ht = tid % HALF;
  // keys gr + 16 i and queries gc + 8 j of the scores; output rows
  // TR gr .. + TR - 1 and float4 columns gc + 8 n
  const int gr = 4 * (ht >> 5) + ((ht >> 3) & 3), gc = ht & 7;
  const int nkt = (p.sk + BK - 1) / BK;
  const int per_t = gridDim.x / nkt;  // ns hkv b
  const int hb = per_t / ns;          // hkv b
  const int t = blockIdx.x / per_t;
  const int split = blockIdx.x % per_t / hb;
  const int ikv = blockIdx.x % hb % p.hkv, ib = blockIdx.x % hb / p.hkv;
  const int k0 = t * BK;
  const int group = p.h / p.hkv;
  const int nq = (p.sq + BQ - 1) / BQ;
  const int iq0 = p.causal ? k0 / BQ : 0;
  const int per_head = nq - iq0;
  const int items = group * per_head;
  const int beg = split * items / ns, end = (split + 1) * items / ns;

  auto issue = [&](int it) {
    const int hg = it / per_head, q0 = (iq0 + it % per_head) * BQ;
    const int ih = ikv * group + hg, stage = (it - beg) % ST;
    float* qo = sm + L::QO_OFF + stage * 2 * BQ * P;
    f32_rows_async<D, BQ>(qo, head_ptr<float>(p.q, p.st[Q], ib, ih),
                          p.st[Q][2], q0, p.sq, tid);
    f32_rows_async<D, BQ>(qo + BQ * P,
                          head_ptr<float>(p.dout, p.st[DO], ib, ih),
                          p.st[DO][2], q0, p.sq, tid);
    const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
    float* lv = sm + L::L_OFF + stage * 2 * BQ;
    f32_vec_async<BQ>(lv, p.lse + rowbase, q0, p.sq, tid);
    f32_vec_async<BQ>(lv + BQ, p.delta + rowbase, q0, p.sq, tid);
  };
  f32_rows_async<D, BK>(sm + L::K_OFF, head_ptr<float>(p.k, p.st[K], ib, ikv),
                        p.st[K][2], k0, p.sk, tid);
  f32_rows_async<D, BK>(sm + L::V_OFF, head_ptr<float>(p.v, p.st[V], ib, ikv),
                        p.st[V][2], k0, p.sk, tid);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (beg + s < end) issue(beg + s);
    hopper::cp_async_commit();
  }
  const float scale_log2 = p.scale * hopper::kLog2e;
  // K (half 0) or V (half 1): this half's resident score operand
  const float* KV = sm + (half ? L::V_OFF : L::K_OFF);

  float acc[TR][D / 8];  // dV (half 0) or dK (half 1)
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

#pragma unroll 1
  for (int it = beg; it < end; ++it) {
    f32_next_stage<ST>(it, end, issue);  // item it is in

    const int stage = (it - beg) % ST;
    const float* Qs = sm + L::QO_OFF + stage * 2 * BQ * P;
    const float* Os = Qs + BQ * P;
    const float* Ls = sm + L::L_OFF + stage * 2 * BQ;
    const float* Ds = Ls + BQ;
    const int q0 = (iq0 + it % per_head) * BQ;

    // S^T = K Q^T (half 0) or dP^T = V dO^T (half 1)
    float sd[1][SR][SC];
    f32_dots<D, SR, SC, 16, 8, 1>(sd, {KV}, {half ? Os : Qs}, gr, gc);

    if (half == 0) {
      // P^T; 0 for queries past sq and (causal) keys after the query
      const bool need_mask =
          (p.causal && q0 < k0 + BK - 1) || q0 + BQ > p.sq;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
        const float lq = Ls[c] * hopper::kLog2e;
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          float pr = hopper::fast_exp2(fmaf(sd[0][i][j], scale_log2, -lq));
          if (need_mask &&
              (q0 + c >= p.sq || (p.causal && k0 + gr + 16 * i > q0 + c)))
            pr = 0.f;
          Ps[c * L::XP + gr + 16 * i] = pr;
        }
      }
    }
    __syncthreads();  // P^T is in
    if (half == 1) {
      // dS^T = P^T (dP^T - delta), at the same elements
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
        const float dq = Ds[c];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          Ss[c * L::XP + gr + 16 * i] =
              Ps[c * L::XP + gr + 16 * i] * (sd[0][i][j] - dq);
      }
      hopper::bar_sync(1, HALF);  // this half's dS^T is in
    }

    // dV += P^T dO (half 0) or dK += dS^T Q (half 1)
    f32_outer<D, TR, BQ, L::XP, 8>(acc, half ? Ss : Ps, half ? Qs : Os,
                                   TR * gr, gc);
  }
  // nothing in flight at exit (an ST = 1 block whose range was empty has
  // its resident copies uncommitted)
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  const int rows = p.sk - k0, row0 = TR * gr;
  if (ns == 1) {
    float* out = half ? head_ptr_mut<float>(p.dk, p.st[DK], ib, ikv)
                      : head_ptr_mut<float>(p.dv, p.st[DV], ib, ikv);
    const int64_t ss = half ? p.st[DK][2] : p.st[DV][2];
    f32_store<D, TR, 8>(out + k0 * ss, ss, acc, half ? p.scale : 1.f, row0,
                        rows, gc);
  } else {
    const int64_t plane = static_cast<int64_t>(hb) * p.sk * D;
    float* part = ws + (2 * split + (half ? 0 : 1)) * plane +
                  ((static_cast<int64_t>(ib) * p.hkv + ikv) * p.sk + k0) * D;
    f32_store<D, TR, 8>(part, D, acc, 1.f, row0, rows, gc);
  }
}

// The second pass of a split f32 launch: each output row the sum of its
// ns parts in split order; K2 (KV false, parts [ns][b h][sq][D]): dQ =
// scale sum; K3 (KV true, parts [ns][2][b hkv][sk][D]): dK = scale sum,
// dV = sum. One float4 a thread.
template <int D, bool KV>
__global__ void __launch_bounds__(F32_THREADS)
    f32_reduce(const Params p, const float* ws, int ns, int batch) {
  constexpr int NOUT = KV ? 2 : 1;
  const int heads = KV ? p.hkv : p.h, seq = KV ? p.sk : p.sq;
  const int64_t rows = static_cast<int64_t>(batch) * heads * seq;
  const int64_t plane = rows * D;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(F32_THREADS) +
                   threadIdx.x;
       i < rows * (D / 4); i += static_cast<int64_t>(gridDim.x) * F32_THREADS) {
    const int64_t row = i / (D / 4);
    const int c = 4 * static_cast<int>(i % (D / 4));
    const int r = static_cast<int>(row % seq);
    const int bh = static_cast<int>(row / seq);
    const int ih = bh % heads, ib = bh / heads;
    // the outputs: dQ, or dK and dV
    float* out[NOUT];
    if constexpr (KV) {
      out[0] = head_ptr_mut<float>(p.dk, p.st[DK], ib, ih) + r * p.st[DK][2];
      out[NOUT - 1] =
          head_ptr_mut<float>(p.dv, p.st[DV], ib, ih) + r * p.st[DV][2];
    } else {
      out[0] = head_ptr_mut<float>(p.dq, p.st[DQ], ib, ih) + r * p.st[DQ][2];
    }
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < ns; ++sp) {
        const float4 a = *reinterpret_cast<const float4*>(
            ws + (NOUT * sp + o) * plane + row * D + c);
        sum.x += a.x, sum.y += a.y, sum.z += a.z, sum.w += a.w;
      }
      const float scale = o == 0 ? p.scale : 1.f;
      *reinterpret_cast<float4*>(out[o] + c) = make_float4(
          sum.x * scale, sum.y * scale, sum.z * scale, sum.w * scale);
    }
  }
}

// The workspace K2 (`dkv` 0) or K3 (`dkv` 1) needs at head dim D in f32:
// its parts when it splits, else none.
template <int D>
int64_t f32_workspace(int dkv, int batch, int h, int hkv, int sq, int sk) {
  if constexpr (f32_design(D) != kF32Tiled) {
    return 0;
  } else {
    const int ns = dkv ? dkv_f32_splits<D>(batch, hkv, sk)
                       : dq_f32_splits<D>(batch, h, sq);
    const int64_t part = static_cast<int64_t>(batch) *
                         (dkv ? 2 * hkv * sk : h * sq) * D * sizeof(float);
    return ns > 1 ? ns * part : 0;
  }
}

// PR 2's scalar f32 kernels (kF32Scalar), built only where f32_design
// names them.

constexpr int SC_BQ = 32;  // rows per tile: 4 threads per row
constexpr int SC_BK = 32;
constexpr int SC_THREADS = 128;

// Copy `rows` rows of D floats into shared memory with row pitch D + 1,
// zero-filling rows at or past `limit`.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t ss, int r0, int limit,
                                              int rows, int tid) {
  for (int i = tid; i < rows * D; i += SC_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < limit ? src[(r0 + r) * ss + c] : 0.f;
  }
}

// Above d 256 a block of the f32 kernels owns half the output columns,
// in two blocks that each compute the whole scores (a thread's
// accumulators stay at most 64 floats each, where D / 4 would spill), and
// above d 384 the streamed tiles are 16 rows, so the tiles fit in 227 KB.
__host__ __device__ constexpr int f32_cols(int d) {
  return d > 256 ? d / 2 : d;
}
__host__ __device__ constexpr int f32_tile(int d) {
  return d > 384 ? 16 : 32;
}

// K2, f32. Thread (r, c4) = (tid / 4, tid % 4) owns query row r, the scores
// of keys c4 + 4j of each tile of BK keys, and dQ columns cb + c4 + 4jj of
// the block's COLS columns starting at cb.
template <int D>
__global__ void __launch_bounds__(SC_THREADS) dq_f32_scalar(const Params p) {
  constexpr int BK = f32_tile(D), COLS = f32_cols(D), PARTS = D / COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [SC_BQ][D + 1]
  float* Os = Qs + SC_BQ * (D + 1);            // dO, [SC_BQ][D + 1]
  float* Ks = Os + SC_BQ * (D + 1);            // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);               // [BK][D + 1]
  float* Ss = Vs + BK * (D + 1);               // dS, [SC_BQ][BK + 1]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (p.h / p.hkv);
  const int q0 = blockIdx.x / PARTS * SC_BQ;
  const int cb = blockIdx.x % PARTS * COLS;
  const int row = q0 + r;
  const float* k = head_ptr<float>(p.k, p.st[K], ib, ikv);
  const float* v = head_ptr<float>(p.v, p.st[V], ib, ikv);
  load_tile_f32<D>(Qs, head_ptr<float>(p.q, p.st[Q], ib, ih), p.st[Q][2], q0,
                   p.sq, SC_BQ, tid);
  load_tile_f32<D>(Os, head_ptr<float>(p.dout, p.st[DO], ib, ih),
                   p.st[DO][2], q0, p.sq, SC_BQ, tid);
  const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
  const float lse = row < p.sq ? p.lse[rowbase + row] : 0.f;
  const float dl = row < p.sq ? p.delta[rowbase + row] : 0.f;

  float acc[COLS / 4];
#pragma unroll
  for (int jj = 0; jj < COLS / 4; ++jj) acc[jj] = 0.f;

  int nk = (p.sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + SC_BQ + BK - 1) / BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_tile_f32<D>(Ks, k, p.st[K][2], k0, p.sk, BK, tid);
    load_tile_f32<D>(Vs, v, p.st[V][2], k0, p.sk, BK, tid);
    __syncthreads();

    const float* qr = Qs + r * (D + 1);
    const float* orow = Os + r * (D + 1);
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = c4 + 4 * j;
      const float* kr = Ks + c * (D + 1);
      const float* vr = Vs + c * (D + 1);
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      float x = s * p.scale;
      const int col = k0 + c;
      if (col >= p.sk || (p.causal && col > row)) x = kNegInf;
      Ss[r * (BK + 1) + c] = expf(x - lse) * (dp - dl);
    }
    __syncwarp();  // row r's dS is written and read by the same four lanes
    for (int c = 0; c < BK; ++c) {
      const float ds = Ss[r * (BK + 1) + c];
      const float* kr = Ks + c * (D + 1) + cb + c4;
#pragma unroll
      for (int jj = 0; jj < COLS / 4; ++jj)
        acc[jj] = fmaf(ds, kr[4 * jj], acc[jj]);
    }
  }

  if (row < p.sq) {
    float* dq = head_ptr_mut<float>(p.dq, p.st[DQ], ib, ih) +
                row * p.st[DQ][2] + cb;
#pragma unroll
    for (int jj = 0; jj < COLS / 4; ++jj)
      dq[c4 + 4 * jj] = acc[jj] * p.scale;
  }
}

// K3, f32. Thread (r, c4) owns key r of the tile, the scores of query rows
// c4 + 4j of each query tile of BQ rows, and dK/dV columns cb + c4 + 4jj of
// the block's COLS columns starting at cb.
template <int D>
__global__ void __launch_bounds__(SC_THREADS) dkv_f32_scalar(const Params p) {
  constexpr int BQ = f32_tile(D), COLS = f32_cols(D), PARTS = D / COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [SC_BK][D + 1]
  float* Vs = Ks + SC_BK * (D + 1);            // [SC_BK][D + 1]
  float* Qs = Vs + SC_BK * (D + 1);            // [BQ][D + 1]
  float* Os = Qs + BQ * (D + 1);               // dO, [BQ][D + 1]
  float* Ps = Os + BQ * (D + 1);               // [SC_BK][BQ + 1]
  float* Ss = Ps + SC_BK * (BQ + 1);           // dS, [SC_BK][BQ + 1]
  float* Ls = Ss + SC_BK * (BQ + 1);           // [BQ]
  float* Ds = Ls + BQ;                         // [BQ]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int ikv = blockIdx.y, ib = blockIdx.z;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.x / PARTS * SC_BK;
  const int cb = blockIdx.x % PARTS * COLS;
  const int key = k0 + r;
  load_tile_f32<D>(Ks, head_ptr<float>(p.k, p.st[K], ib, ikv), p.st[K][2],
                   k0, p.sk, SC_BK, tid);
  load_tile_f32<D>(Vs, head_ptr<float>(p.v, p.st[V], ib, ikv), p.st[V][2],
                   k0, p.sk, SC_BK, tid);

  float dk[COLS / 4], dv[COLS / 4];
#pragma unroll
  for (int jj = 0; jj < COLS / 4; ++jj) dk[jj] = dv[jj] = 0.f;

  const int nq = (p.sq + BQ - 1) / BQ;
  const int iq0 = p.causal ? k0 / BQ : 0;
  const float* kr = Ks + r * (D + 1);
  const float* vr = Vs + r * (D + 1);
  for (int hg = 0; hg < group; ++hg) {
    const int ih = ikv * group + hg;
    const float* q = head_ptr<float>(p.q, p.st[Q], ib, ih);
    const float* dout = head_ptr<float>(p.dout, p.st[DO], ib, ih);
    const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();
      load_tile_f32<D>(Qs, q, p.st[Q][2], q0, p.sq, BQ, tid);
      load_tile_f32<D>(Os, dout, p.st[DO][2], q0, p.sq, BQ, tid);
      for (int i = tid; i < BQ; i += SC_THREADS) {
        const bool in = q0 + i < p.sq;
        Ls[i] = in ? p.lse[rowbase + q0 + i] : 0.f;
        Ds[i] = in ? p.delta[rowbase + q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < BQ / 4; ++j) {
        const int c = c4 + 4 * j;
        const float* qr = Qs + c * (D + 1);
        const float* orow = Os + c * (D + 1);
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(kr[d], qr[d], s);
          dp = fmaf(vr[d], orow[d], dp);
        }
        float x = s * p.scale;
        if (q0 + c >= p.sq || (p.causal && key > q0 + c)) x = kNegInf;
        const float pr = expf(x - Ls[c]);  // f32: dO's dtype already
        Ps[r * (BQ + 1) + c] = pr;
        Ss[r * (BQ + 1) + c] = pr * (dp - Ds[c]);
      }
      __syncwarp();  // key r's P and dS are written and read by its lanes
      for (int c = 0; c < BQ; ++c) {
        const float pc = Ps[r * (BQ + 1) + c];
        const float sc = Ss[r * (BQ + 1) + c];
        const float* orow = Os + c * (D + 1) + cb + c4;
        const float* qr = Qs + c * (D + 1) + cb + c4;
#pragma unroll
        for (int jj = 0; jj < COLS / 4; ++jj) {
          dv[jj] = fmaf(pc, orow[4 * jj], dv[jj]);
          dk[jj] = fmaf(sc, qr[4 * jj], dk[jj]);
        }
      }
    }
  }

  if (key < p.sk) {
    float* dkp = head_ptr_mut<float>(p.dk, p.st[DK], ib, ikv) +
                 key * p.st[DK][2] + cb;
    float* dvp = head_ptr_mut<float>(p.dv, p.st[DV], ib, ikv) +
                 key * p.st[DV][2] + cb;
#pragma unroll
    for (int jj = 0; jj < COLS / 4; ++jj) {
      dkp[c4 + 4 * jj] = dk[jj] * p.scale;
      dvp[c4 + 4 * jj] = dv[jj];
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// An f32 kernel (dq_f32 or dkv_f32: KV) over `blocks` blocks a split, in
// `ns` splits, and with ns > 1 its second pass, f32_reduce, over the `rows`
// output rows.
template <int D, bool KV, typename Kernel>
cudaError_t launch_f32(Kernel kernel, const Params& p, int batch, int blocks,
                       int ns, size_t smem, int64_t rows, void* ws,
                       cudaStream_t stream) {
  if (ns > 1 && !ws) return cudaErrorInvalidValue;
  if (cudaError_t err = launch(kernel, dim3(blocks * ns), F32_THREADS, smem,
                               stream, p, static_cast<float*>(ws), ns))
    return err;
  if (ns == 1) return cudaSuccess;
  const int64_t vecs = rows * D / 4;
  const int grid = static_cast<int>(
      std::min<int64_t>((vecs + F32_THREADS - 1) / F32_THREADS, 4096));
  return launch(f32_reduce<D, KV>, dim3(grid), F32_THREADS, 0, stream, p,
                static_cast<const float*>(ws), ns, batch);
}

// The tensor maps and arguments K2 takes, for each bf16 design: Q and dO
// in boxes of BQ rows, K and V in boxes of BK keys; one column block a box
// (dq_wgmma), or with TILE whole tiles (hopper::tmap_bf16_tile, dq_rows8
// and dq_split).
template <int BQ, int BK, bool TILE>
cudaError_t dq_args(DqArgs& a, const Params& p, int batch, int d) {
  const auto map = TILE ? hopper::tmap_bf16_tile : hopper::tmap_bf16;
  const int64_t(&st)[NSTRIDE][3] = p.st;
  cudaError_t err;
  if ((err = map(&a.tq, p.q, d, p.sq, p.h, batch, st[Q][2], st[Q][1],
                 st[Q][0], BQ)) ||
      (err = map(&a.tdo, p.dout, d, p.sq, p.h, batch, st[DO][2], st[DO][1],
                 st[DO][0], BQ)) ||
      (err = map(&a.tk, p.k, d, p.sk, p.hkv, batch, st[K][2], st[K][1],
                 st[K][0], BK)) ||
      (err = map(&a.tv, p.v, d, p.sk, p.hkv, batch, st[V][2], st[V][1],
                 st[V][0], BK)))
    return err;
  a.lse = p.lse;
  a.delta = p.delta;
  a.dq = p.dq;
  a.dq_sb = st[DQ][0];
  a.dq_sh = st[DQ][1];
  a.dq_ss = st[DQ][2];
  a.h = p.h;
  a.hkv = p.hkv;
  a.batch = batch;
  a.sq = p.sq;
  a.sk = p.sk;
  a.causal = p.causal;
  a.nq = (p.sq + BQ - 1) / BQ;
  a.scale = p.scale;
  a.scale_log2 = p.scale * hopper::kLog2e;
  return cudaSuccess;
}

template <int D>
cudaError_t run_dq(const Params& p, int batch, int bf16_in, void* ws,
                   cudaStream_t stream) {
  if (bf16_in) {
    DqArgs a;
    if constexpr (dq_design(D) == kDSplit) {
      using L = DqSplit<D>;
      if (cudaError_t err = dq_args<L::BQ, L::BK, true>(a, p, batch, D))
        return err;
      return hopper::launch(dq_split<D>, a.nq * p.h * batch, SPLIT_THREADS,
                            L::BYTES, stream, a);
    } else if constexpr (dq_design(D) == kRows8) {
      using L = DqRows8<D>;
      if (cudaError_t err = dq_args<L::BQ, L::BK, true>(a, p, batch, D))
        return err;
      return hopper::launch(dq_rows8<D>, a.nq * p.h * batch, SPLIT_THREADS,
                            L::BYTES, stream, a);
    } else {
      if (cudaError_t err =
              dq_args<DQ_BQ, DqSmem<D>::DQ_BK, false>(a, p, batch, D))
        return err;
      return hopper::launch(dq_wgmma<D>, a.nq * p.h * batch, DQ_THREADS,
                            DqSmem<D>::BYTES, stream, a);
    }
  }
  if constexpr (f32_design(D) == kF32Tiled) {
    using L = DqF32<D>;
    return launch_f32<D, false>(
        dq_f32<D>, p, batch, (p.sq + L::BQ - 1) / L::BQ * p.h * batch,
        dq_f32_splits<D>(batch, p.h, p.sq), L::BYTES,
        static_cast<int64_t>(batch) * p.h * p.sq, ws, stream);
  } else {
    constexpr int BK = f32_tile(D);
    const dim3 grid((p.sq + SC_BQ - 1) / SC_BQ * (D / f32_cols(D)), p.h,
                    batch);
    const size_t smem =
        ((2 * SC_BQ + 2 * BK) * (D + 1) + SC_BQ * (BK + 1)) * sizeof(float);
    return launch(dq_f32_scalar<D>, grid, SC_THREADS, smem, stream, p);
  }
}

// The tensor maps and arguments K3 takes, for each bf16 design: Q and dO
// in boxes of BQ rows, K and V in boxes of BK keys; one column block a box
// (dkv_wgmma), or with TILE whole tiles (hopper::tmap_bf16_tile,
// dkv_keys8, dkv_onepass and dkv_split).
template <int BQ, int BK, bool TILE>
cudaError_t dkv_args(DkvArgs& a, const Params& p, int batch, int d) {
  const auto map = TILE ? hopper::tmap_bf16_tile : hopper::tmap_bf16;
  const int64_t(&st)[NSTRIDE][3] = p.st;
  cudaError_t err;
  if ((err = map(&a.tq, p.q, d, p.sq, p.h, batch, st[Q][2], st[Q][1],
                 st[Q][0], BQ)) ||
      (err = map(&a.tdo, p.dout, d, p.sq, p.h, batch, st[DO][2], st[DO][1],
                 st[DO][0], BQ)) ||
      (err = map(&a.tk, p.k, d, p.sk, p.hkv, batch, st[K][2], st[K][1],
                 st[K][0], BK)) ||
      (err = map(&a.tv, p.v, d, p.sk, p.hkv, batch, st[V][2], st[V][1],
                 st[V][0], BK)))
    return err;
  a.lse = p.lse;
  a.delta = p.delta;
  a.dk = p.dk;
  a.dv = p.dv;
  a.dk_sb = st[DK][0];
  a.dk_sh = st[DK][1];
  a.dk_ss = st[DK][2];
  a.dv_sb = st[DV][0];
  a.dv_sh = st[DV][1];
  a.dv_ss = st[DV][2];
  a.h = p.h;
  a.hkv = p.hkv;
  a.batch = batch;
  a.sq = p.sq;
  a.sk = p.sk;
  a.causal = p.causal;
  a.scale = p.scale;
  a.scale_log2 = p.scale * hopper::kLog2e;
  return cudaSuccess;
}

template <int D>
cudaError_t run_dkv(const Params& p, int batch, int bf16_in, void* ws,
                    cudaStream_t stream) {
  if (bf16_in) {
    DkvArgs a;
    if constexpr (dkv_design(D) == kDSplit || dkv_design(D) == kOnePass) {
      using L = std::conditional_t<dkv_design(D) == kDSplit, DkvSplit<D>,
                                   DkvOnePass<D>>;
      if (cudaError_t err = dkv_args<L::BQ, L::BK, true>(a, p, batch, D))
        return err;
      const int blocks = (p.sk + L::BK - 1) / L::BK * p.hkv * batch;
      if constexpr (dkv_design(D) == kDSplit)
        return hopper::launch(dkv_split<D>, blocks, SPLIT_THREADS, L::BYTES,
                              stream, a);
      else
        return hopper::launch(dkv_onepass<D>, blocks, SPLIT_THREADS,
                              L::BYTES, stream, a);
    } else if constexpr (dkv_design(D) == kKeys8) {
      using L = DkvKeys8<D>;
      if (cudaError_t err = dkv_args<L::BQ, L::BK, true>(a, p, batch, D))
        return err;
      return hopper::launch(dkv_keys8<D>,
                            (p.sk + L::BK - 1) / L::BK * p.hkv * batch,
                            SPLIT_THREADS, L::BYTES, stream, a);
    } else {
      if (cudaError_t err =
              dkv_args<DkvSmem<D>::BQ, DKV_BK, false>(a, p, batch, D))
        return err;
      const int blocks = (p.sk + DKV_BK - 1) / DKV_BK * p.hkv * batch;
      return hopper::launch(dkv_wgmma<D>, blocks, DKV_THREADS,
                            DkvSmem<D>::BYTES, stream, a);
    }
  }
  if constexpr (f32_design(D) == kF32Tiled) {
    using L = DkvF32<D>;
    return launch_f32<D, true>(
        dkv_f32<D>, p, batch, (p.sk + L::BK - 1) / L::BK * p.hkv * batch,
        dkv_f32_splits<D>(batch, p.hkv, p.sk), L::BYTES,
        static_cast<int64_t>(batch) * p.hkv * p.sk, ws, stream);
  } else {
    constexpr int BQ = f32_tile(D);
    const dim3 grid((p.sk + SC_BK - 1) / SC_BK * (D / f32_cols(D)), p.hkv,
                    batch);
    const size_t smem = ((2 * SC_BK + 2 * BQ) * (D + 1) +
                         2 * SC_BK * (BQ + 1) + 2 * BQ) *
                        sizeof(float);
    return launch(dkv_f32_scalar<D>, grid, SC_THREADS, smem, stream, p);
  }
}

bool fill(Params& p, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta, void* dq,
          void* dk, void* dv, const int64_t* strides, int batch, int h,
          int hkv, int sq, int sk, int causal, float scale) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return false;
  p = Params{q, k, v, dout, lse, delta, dq, dk, dv, {}, h, hkv, sq, sk,
             causal, scale};
  for (int i = 0; i < NSTRIDE; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  return true;
}

}  // namespace

// Both entry points take the same arguments. q/dO [b, h, sq, d], k/v
// [b, hkv, sk, d], and the outputs dq [b, h, sq, d], dk/dv [b, hkv, sk, d],
// are given by element strides: `strides` holds 21 int64, (batch, head,
// seq) for q, k, v, dO, dq, dk, dv in that order (head dim contiguous; in
// f32 rows 16-byte aligned). lse and delta are [b, h, sq] f32 contiguous.
// bf16 = 1 for bfloat16 tensors, 0 for float32. flash_bwd_dq writes dq and
// ignores dk/dv; flash_bwd_dkv writes dk/dv and ignores dq. `ws` is a
// workspace of at least the flash_bwd_workspace bytes of the same kernel
// and shape (16-byte aligned; may be null where that is 0). Each launches
// its kernels on `stream` (in f32 with split tiles also the second pass)
// and returns the launches' cudaError_t (0 on success); neither
// synchronises.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk, void* dv,
                            const int64_t* strides, int bf16_in, int batch,
                            int h, int hkv, int sq, int sk, int d, int causal,
                            float scale, void* ws, void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, dq, dk, dv, strides, batch, h, hkv,
            sq, sk, causal, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(run_dq<64>(p, batch, bf16_in, ws, st));
    case 128: return static_cast<int>(run_dq<128>(p, batch, bf16_in, ws, st));
    case 192: return static_cast<int>(run_dq<192>(p, batch, bf16_in, ws, st));
    case 256: return static_cast<int>(run_dq<256>(p, batch, bf16_in, ws, st));
    case 320: return static_cast<int>(run_dq<320>(p, batch, bf16_in, ws, st));
    case 384: return static_cast<int>(run_dq<384>(p, batch, bf16_in, ws, st));
    case 448: return static_cast<int>(run_dq<448>(p, batch, bf16_in, ws, st));
    case 512: return static_cast<int>(run_dq<512>(p, batch, bf16_in, ws, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             const int64_t* strides, int bf16_in, int batch,
                             int h, int hkv, int sq, int sk, int d,
                             int causal, float scale, void* ws,
                             void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, dq, dk, dv, strides, batch, h, hkv,
            sq, sk, causal, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(run_dkv<64>(p, batch, bf16_in, ws, st));
    case 128: return static_cast<int>(run_dkv<128>(p, batch, bf16_in, ws, st));
    case 192: return static_cast<int>(run_dkv<192>(p, batch, bf16_in, ws, st));
    case 256: return static_cast<int>(run_dkv<256>(p, batch, bf16_in, ws, st));
    case 320: return static_cast<int>(run_dkv<320>(p, batch, bf16_in, ws, st));
    case 384: return static_cast<int>(run_dkv<384>(p, batch, bf16_in, ws, st));
    case 448: return static_cast<int>(run_dkv<448>(p, batch, bf16_in, ws, st));
    case 512: return static_cast<int>(run_dkv<512>(p, batch, bf16_in, ws, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bytes of workspace flash_bwd_dq (`dkv` 0) or flash_bwd_dkv (`dkv` 1)
// needs for these inputs on the current device (K2 or K3 in f32 when it
// splits), else 0.
extern "C" int64_t flash_bwd_workspace(int dkv, int bf16_in, int batch,
                                       int h, int hkv, int sq, int sk,
                                       int d) {
  if (bf16_in || batch <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || sk <= 0)
    return 0;
  switch (d) {
    case 64: return f32_workspace<64>(dkv, batch, h, hkv, sq, sk);
    case 128: return f32_workspace<128>(dkv, batch, h, hkv, sq, sk);
    case 192: return f32_workspace<192>(dkv, batch, h, hkv, sq, sk);
    case 256: return f32_workspace<256>(dkv, batch, h, hkv, sq, sk);
    case 320: return f32_workspace<320>(dkv, batch, h, hkv, sq, sk);
    case 384: return f32_workspace<384>(dkv, batch, h, hkv, sq, sk);
    case 448: return f32_workspace<448>(dkv, batch, h, hkv, sq, sk);
    case 512: return f32_workspace<512>(dkv, batch, h, hkv, sq, sk);
    default: return 0;
  }
}

// The design (BwdDesign) K2 and K3 run for bf16 inputs of head dim d
// (chip_smoke.py labels its d 256 timings by them), and the one (F32Design)
// both run for float32 inputs.
extern "C" int flash_bwd_dq_design(int d) { return dq_design(d); }
extern "C" int flash_bwd_dkv_design(int d) { return dkv_design(d); }
extern "C" int flash_bwd_f32_design(int d) { return f32_design(d); }
