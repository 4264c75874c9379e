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
// `dq_wgmma` and `dkv_wgmma` (d 64 to 192), `dq_rows8` and `dkv_onepass`
// (d 256) and `dq_split` and `dkv_split` (d 320 to 512, the output's D
// columns split between the consumers).
//
// float32 inputs take scalar kernels: true f32 FMA on CUDA cores, no TF32, so
// f32 parity with the reference holds.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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
//              a consumer warpgroup, a producer warpgroup (d 64 to 192);
//   kDSplit    dq_split, dkv_split: 8-warp blocks of 64 rows or keys, the
//              output's columns split between the warpgroups (d 320 to 512);
//   kRows8     dq_rows8: dq_wgmma's rows on an 8-warp block (d 256);
//   kOnePass   dkv_onepass: 8-warp blocks of 64 keys, warpgroup 0 owning dV
//              and warpgroup 1 dK, one pass (d 256).
// At d 256 each of K2 and K3 ships the faster of two designs on the H100
// (chip_smoke.py's phase_wide_designs, in turns on one card; PERF.md §6):
// dq_rows8 and dkv_onepass. A build with -DFLASH_OTHER_WIDE=1 takes PR 10's
// tiles (dq_wgmma, dkv_wgmma) there instead (and K1's at d 192 and 256).
enum BwdDesign { kRowSplit = 0, kDSplit = 1, kRows8 = 2, kOnePass = 3 };

#ifndef FLASH_OTHER_WIDE
#define FLASH_OTHER_WIDE 0
#endif
constexpr int dq_design(int d) {
  return d <= 192 ? kRowSplit
         : d == 256 ? (FLASH_OTHER_WIDE ? kRowSplit : kRows8)
                    : kDSplit;
}
constexpr int dkv_design(int d) {
  return d <= 192 ? kRowSplit
         : d == 256 ? (FLASH_OTHER_WIDE ? kRowSplit : kOnePass)
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
// At d 256 K2 ships as dq_rows8 and from d 320 it is dq_split (BwdDesign).
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
//
// K2, `dq_rows8<D>` (replaces `_dq_kernel`): dq_wgmma's rows, 128 query
// rows a block with Q and dO resident, 64 a warpgroup, K and V streamed in
// 32-key stages (3 fit beside Q and dO), without the producer warpgroup:
// S = Q K^T and dP = dO V^T (m64n32), dS = P (dP - delta), dQ += dS K
// (m64nDk16, K read MN-major), as dq_consumer does. Bound on an H100:
// operations (three products); what held dq_wgmma<256> back was ptxas's
// 168 registers a thread (a 12-warp block) beside the 128-register dQ,
// so every wgmma ran serialised: this block has 255. Thread 0 refills a
// stage once both warpgroups have released it, testing without waiting,
// and waits only when the stage's next tile is due.
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

// K2 on 8 warps: Q and dO (128 rows, resident), the K stages, the V stages
// and the mbarriers (q_full, kv_full[S], kv_empty[S]).
template <int D>
struct DqRows8 {
  static constexpr int BQ = 128;  // query rows per block: 64 a warpgroup
  static constexpr int BK = 32;   // keys per K/V stage
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

    // S = Q K^T and dP = dO V^T: 64 rows x BK keys each
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(kv_full + 8 * s, (i / STAGES) & 1);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        dp, desc_sw128(do_addr, 16, 1024), desc_sw128(v_addr, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

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
        sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
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
__global__ void __launch_bounds__(SC_THREADS) dq_f32(const Params p) {
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
__global__ void __launch_bounds__(SC_THREADS) dkv_f32(const Params p) {
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
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
cudaError_t run_dq(const Params& p, int batch, int bf16_in,
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
  constexpr int BK = f32_tile(D);
  const dim3 grid((p.sq + SC_BQ - 1) / SC_BQ * (D / f32_cols(D)), p.h,
                  batch);
  const size_t smem =
      ((2 * SC_BQ + 2 * BK) * (D + 1) + SC_BQ * (BK + 1)) * sizeof(float);
  return launch(dq_f32<D>, grid, SC_THREADS, smem, stream, p);
}

// The tensor maps and arguments K3 takes, for each bf16 design: Q and dO
// in boxes of BQ rows, K and V in boxes of BK keys; one column block a box
// (dkv_wgmma), or with TILE whole tiles (hopper::tmap_bf16_tile,
// dkv_onepass and dkv_split).
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
cudaError_t run_dkv(const Params& p, int batch, int bf16_in,
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
    } else {
      if (cudaError_t err =
              dkv_args<DkvSmem<D>::BQ, DKV_BK, false>(a, p, batch, D))
        return err;
      const int blocks = (p.sk + DKV_BK - 1) / DKV_BK * p.hkv * batch;
      return hopper::launch(dkv_wgmma<D>, blocks, DKV_THREADS,
                            DkvSmem<D>::BYTES, stream, a);
    }
  }
  constexpr int BQ = f32_tile(D);
  const dim3 grid((p.sk + SC_BK - 1) / SC_BK * (D / f32_cols(D)), p.hkv,
                  batch);
  const size_t smem = ((2 * SC_BK + 2 * BQ) * (D + 1) +
                       2 * SC_BK * (BQ + 1) + 2 * BQ) *
                      sizeof(float);
  return launch(dkv_f32<D>, grid, SC_THREADS, smem, stream, p);
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
// are given by element strides: `strides` holds 21 int64, (batch, head, seq)
// for q, k, v, dO, dq, dk, dv in that order (head dim contiguous). lse and
// delta are [b, h, sq] f32 contiguous. bf16 = 1 for bfloat16 tensors, 0 for
// float32. flash_bwd_dq writes dq and ignores dk/dv; flash_bwd_dkv writes
// dk/dv and ignores dq. Each launches one kernel on `stream` and returns the
// launch's cudaError_t (0 on success); neither synchronises.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk, void* dv,
                            const int64_t* strides, int bf16_in, int batch,
                            int h, int hkv, int sq, int sk, int d, int causal,
                            float scale, void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, dq, dk, dv, strides, batch, h, hkv,
            sq, sk, causal, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(run_dq<64>(p, batch, bf16_in, st));
    case 128: return static_cast<int>(run_dq<128>(p, batch, bf16_in, st));
    case 192: return static_cast<int>(run_dq<192>(p, batch, bf16_in, st));
    case 256: return static_cast<int>(run_dq<256>(p, batch, bf16_in, st));
    case 320: return static_cast<int>(run_dq<320>(p, batch, bf16_in, st));
    case 384: return static_cast<int>(run_dq<384>(p, batch, bf16_in, st));
    case 448: return static_cast<int>(run_dq<448>(p, batch, bf16_in, st));
    case 512: return static_cast<int>(run_dq<512>(p, batch, bf16_in, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             const int64_t* strides, int bf16_in, int batch,
                             int h, int hkv, int sq, int sk, int d,
                             int causal, float scale, void* stream) {
  Params p;
  if (!fill(p, q, k, v, dout, lse, delta, dq, dk, dv, strides, batch, h, hkv,
            sq, sk, causal, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(run_dkv<64>(p, batch, bf16_in, st));
    case 128: return static_cast<int>(run_dkv<128>(p, batch, bf16_in, st));
    case 192: return static_cast<int>(run_dkv<192>(p, batch, bf16_in, st));
    case 256: return static_cast<int>(run_dkv<256>(p, batch, bf16_in, st));
    case 320: return static_cast<int>(run_dkv<320>(p, batch, bf16_in, st));
    case 384: return static_cast<int>(run_dkv<384>(p, batch, bf16_in, st));
    case 448: return static_cast<int>(run_dkv<448>(p, batch, bf16_in, st));
    case 512: return static_cast<int>(run_dkv<512>(p, batch, bf16_in, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The design (BwdDesign) K2 and K3 run for bf16 inputs of head dim d
// (chip_smoke.py labels its d 256 timings by them).
extern "C" int flash_bwd_dq_design(int d) { return dq_design(d); }
extern "C" int flash_bwd_dkv_design(int d) { return dkv_design(d); }
