// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd`, in
// service_account_auth_improvements_tpu/ops/flash_attention.py (113-207).
//
// What it computes, per (batch, head, query tile):
//   O   = softmax(scale * Q K^T + start-aligned causal mask) V
//   LSE = m + log l
// with an online softmax over key tiles whose state (acc, m, l) is f32.
// GQA: query head h reads kv head h / (h_q / h_kv); K/V are never repeated.
// Numerical rules kept from the reference: both products take operands in
// the input dtype and accumulate in f32; P is cast to the V dtype before
// the PV product; masked scores are -2e38 (not -inf); O is written in the
// input dtype and LSE in f32, as [b, h, s] (not lane-replicated).
//
// Layout: the caller passes element strides for the batch, head and
// sequence axes of q, k, v and o (the head dim is contiguous), so the
// model's [b, s, h, d] tensors are read and written in place through
// [b, h, s, d] views: no transposes and no copies.
//
// Ragged tails: the TPU wrapper zero-pads causal inputs to 128 and slices
// the output. Here the kernel masks the tail itself: key rows past s_k load
// as zero and score -2e38, query rows past s_q load as zero and are not
// written. On the real rows that is the padded computation exactly.
//
// Parallelism: the TPU runs the key axis as a sequential grid dimension with
// the softmax state in VMEM scratch. Here one thread block owns one
// (b, h, query tile) and loops over the key tiles itself, holding m, l and
// acc in registers; blocks are independent. Causal key tiles wholly in the
// future of the block's last row are skipped; the tiles that cross the
// diagonal or the ragged end are masked, the others are not. Every
// processed row sees key 0 in the first tile, so no row is ever fully
// masked (the reference relies on this too).
//
// What bounds it on an H100: at the serving and training shapes (s 1000 and
// 2048, d 128, 12 query heads) a causal forward does ~2 s^2 d flops per
// (b, h) against 4 s d bytes of q/k/v/o, hundreds of flops per byte: it is
// bound by the tensor cores. The bf16 kernels are built for them, one
// design per head dim (FwdDesign, below): at d 320 and 448
// `flash_fwd_split<D>`, at d 384 and 512 `flash_fwd_pair<D>`
// (flash_fwd_wgmma at D / 2 on each block of a cluster of two), at d 256
// `flash_fwd_rows8<D>`, at d 64 `flash_fwd_twin<D>` (their notes are above
// them), and at d 128 and 192 `flash_fwd_wgmma<D>`:
// - a block owns 128 query rows: one producer warpgroup and two consumer
//   warpgroups of 64 rows each (one wgmma M tile); setmaxnreg gives the
//   producer 24 registers and each consumer thread 240;
// - one producer thread issues TMA loads: Q once, then K and V tiles of BK
//   keys into a ring of shared-memory stages, each stage with `full`
//   mbarriers (K and V apart, so QK^T starts before V lands) and an `empty`
//   mbarrier the consumers release (FwdSmem: 2 stages of 128 keys up to
//   d 128, 3 of 64 at d 192);
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory
//   (K-major, 128-byte swizzle); the online softmax runs in registers with
//   exp2 and log2(e) folded into the scale, the row max over a quad of
//   lanes, and the row sum reduced across lanes only once, at the end;
// - P is rounded to bf16 and re-packed in registers as the A operand of
//   O += P V (wgmma m64nDk16 up to d 128; above, one m64n128 chain per 128
//   columns of V and an m64n64 chain for a last 64, on the same A): S never
//   reaches shared memory. The O accumulator is D / 2 registers a thread
//   beside S's BK / 2;
// - heaviest causal query tiles launch first, and neighbouring blocks take
//   the heads of one KV group, which then share K/V in L2.
//
// float32 inputs take a register-tiled FFMA kernel, flash_fwd_f32: true
// f32 FMA on CUDA cores, no TF32, so f32 parity with the reference holds;
// see F32Design below.

#include "f32_tiles.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using namespace f32tile;

constexpr float kNegInf = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int h, hkv, sq, sk, causal;
  float scale;
};

// Number of key tiles a query tile starting at q0 needs: all of them, or
// (causal) those that start before the tile's last row + 1 — the
// reference's `ik * bk < (iq + 1) * bq`.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int bq,
                                         int bk) {
  int nk = (p.sk + bk - 1) / bk;
  if (p.causal) nk = min(nk, (q0 + bq + bk - 1) / bk);
  return nk;
}

// ------------------------------------------------ bf16: wgmma

constexpr int WG = 128;            // threads per warpgroup
constexpr int FWD_BQ = 128;        // query rows per block: 64 per consumer
constexpr int FWD_THREADS = 3 * WG;  // producer + two consumers
constexpr int SPLIT_THREADS = 2 * WG;  // the two consumer warpgroups alone
constexpr int SMEM_MAX = 232448;   // shared memory a block may use (227 KB)

// The bf16 designs of K1 (the C function flash_fwd_design reports the one
// a head dim runs; chip_smoke.py labels its timings by it):
//   kRowSplit  flash_fwd_wgmma: 12-warp blocks of 128 rows, 64 a consumer
//              warpgroup, a producer warpgroup (d 64 to 192);
//   kDSplit    flash_fwd_split: 8-warp blocks of 64 rows, the output's
//              columns split between the warpgroups (d 320 and 448);
//   kRows8     flash_fwd_rows8: 8-warp blocks of 128 rows, 64 a
//              warpgroup, the two taking turns at the tensor cores (d 256);
//   kTwin      flash_fwd_twin: 8-warp blocks of 128 rows, 64 a warpgroup,
//              two blocks a SM, each warpgroup's tile in series (d 64);
//   kPair      flash_fwd_pair: flash_fwd_wgmma's 128 rows on a cluster of
//              two blocks, each holding half of the head dim (d 384 and
//              512);
//   kWide      flash_fwd_wide, in csrc/flash_wide.cu: 8-warp blocks of 128
//              rows and 256 output columns, the head dim streamed in
//              64-column chunks (every multiple of 64 above 512; this
//              library builds no kernel past 512, the wrapper calls that
//              one's, and the id only names it).
// (kTwin's and kPair's ids follow BwdDesign's, and kWide's is the same as
// K2's and K3's there, so that no id names two designs.)
// At d 64, 192, 256, 384 and 512 K1 ships the faster of two designs on
// the H100 (chip_smoke.py's phase_wide_designs, in turns on one card;
// PERF.md §6): flash_fwd_twin at d 64, flash_fwd_wgmma at d 192,
// flash_fwd_rows8 at d 256, flash_fwd_pair at d 384 and 512. A build with
// -DFLASH_OTHER_DESIGNS=1 takes the other one at each (flash_fwd_wgmma at
// d 64, flash_fwd_split at d 384 and 512; and the scalar f32 kernel at d
// 128: F32Design).
enum FwdDesign { kRowSplit = 0, kDSplit = 1, kRows8 = 2, kTwin = 5,
                 kPair = 7, kWide = 8 };

#ifndef FLASH_OTHER_DESIGNS
#define FLASH_OTHER_DESIGNS 0
#endif
constexpr int fwd_design(int d) {
  return d == 64    ? (FLASH_OTHER_DESIGNS ? kRowSplit : kTwin)
         : d <= 128 ? kRowSplit
         : d == 192 ? (FLASH_OTHER_DESIGNS ? kRows8 : kRowSplit)
         : d == 256 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kRows8)
         : d == 384 || d == 512 ? (FLASH_OTHER_DESIGNS ? kDSplit : kPair)
         : d > 512              ? kWide
                                : kDSplit;
}

struct FwdArgs {
  CUtensorMap tq, tk, tv;  // boxes of 64 columns (or whole tiles) of rows
  void* o;
  float* lse;
  int64_t o_sb, o_sh, o_ss;
  int h, hkv, batch, sq, sk, causal, nq;
  float scale, scale_log2;
};

// One online-softmax step on a score tile of BK keys starting at key k0,
// held as wgmma accumulator fragments (this thread's rows row0 and row1;
// register 4j + e is key k0 + 8j + 2 tq + (e & 1)): with `mask`, keys past
// sk and (causal) after the row score -2e38; the running maxima m (raw
// score units) and partial row sums l move on, sc becomes P = exp2((S - m)
// scale log2 e) in f32, and alpha gets the factors that rescale O.
template <int BK>
__device__ __forceinline__ void fwd_softmax(const FwdArgs& a,
                                            float (&sc)[BK / 2], float& m0,
                                            float& m1, float& l0, float& l1,
                                            float& alpha0, float& alpha1,
                                            bool mask, int k0, int row0,
                                            int row1, int tq) {
  using hopper::fast_exp2;
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * tq + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if (col >= a.sk || (a.causal && col > row)) sc[4 * j + e] = kNegInf;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  alpha0 = fast_exp2((m0 - mx0) * a.scale_log2);
  alpha1 = fast_exp2((m1 - mx1) * a.scale_log2);
  const float ms0 = mx0 * a.scale_log2, ms1 = mx1 * a.scale_log2;
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
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
}

// P in V's dtype, re-packed as the A operand of P V; keys 16kk .. 16kk + 15
template <int BK>
__device__ __forceinline__ void fwd_pack(uint32_t (&pf)[BK / 16][4],
                                         const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kk][r] =
          hopper::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// O's rows row0 and row1 times alpha0 and alpha1
template <int R>
__device__ __forceinline__ void fwd_rescale(float (&o)[R], float alpha0,
                                            float alpha1) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// The rows' end: the row sums reduced over the quad, O / l stored in bf16
// at columns col0 + 8j + ... (skipping those below `skip`, which the other
// warpgroup stores) and, with `lse_too`, LSE = m scale + log l in f32.
template <int NC>
__device__ __forceinline__ void fwd_finish(const FwdArgs& a,
                                           float (&o)[NC / 2], float m0,
                                           float m1, float l0, float l1,
                                           int row0, int row1, int ih,
                                           int ib, int tq, int col0,
                                           int skip, bool lse_too) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    o[4 * j] /= l0;
    o[4 * j + 1] /= l0;
    o[4 * j + 2] /= l1;
    o[4 * j + 3] /= l1;
  }
  hopper::store_cols<NC>(
      static_cast<__nv_bfloat16*>(a.o) + ib * a.o_sb + ih * a.o_sh, a.o_ss,
      o, 1.f, row0, row1, a.sq, tq, col0, skip);
  if (lse_too && tq == 0) {
    float* lse = a.lse + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    if (row0 < a.sq) lse[row0] = m0 * a.scale + logf(l0);
    if (row1 < a.sq) lse[row1] = m1 * a.scale + logf(l1);
  }
}

// Shared memory of flash_fwd_wgmma: Q, then the K stages, the V stages and
// the mbarriers. Each tile is D / 64 column blocks of (rows x 128 bytes).
// Keys per stage (BK) and stages: 128 and 2 up to d 128; above (PR 10's
// tiles), as many stages as fit (at most 4) of 64 keys at d 192 and of 32
// at d 256, where a 64-key S tile beside the 128 registers of O made ptxas
// spill and serialise the wgmmas. At d 64 and 256 only the
// -DFLASH_OTHER_DESIGNS=1 build runs this kernel.
template <int D>
struct FwdSmem {
  static constexpr int BK = D <= 128 ? 128 : D <= 192 ? 64 : 32;
  static constexpr int Q_CB = FWD_BQ * 128;   // column block stride
  static constexpr int KV_CB = BK * 128;
  static constexpr int Q_BYTES = FWD_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int FIT = (SMEM_MAX - 2048 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = D <= 128 ? 2 : FIT < 4 ? FIT : 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // mbarriers: q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int D>
__device__ __forceinline__ void fwd_consumer(const FwdArgs& a, uint32_t base,
                                             int q0, int ih, int ib, int nk) {
  using namespace hopper;
  using L = FwdSmem<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const int c = threadIdx.x / WG - 1;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + L::Q_OFF + c * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T: 64 rows x BK keys
    float sc[BK / 2];
    mbar_wait(k_full + 8 * s, ph);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask only tiles that cross the diagonal or the ragged end
    float alpha0, alpha1;
    fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    uint32_t pf[BK / 16][4];
    fwd_pack<BK>(pf, sc);
    fwd_rescale(o, alpha0, alpha1);

    // O += P V
    mbar_wait(v_full + 8 * s, ph);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(o, pf, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + 8 * s);
  }
  fwd_finish<D>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0, true);
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ FwdArgs a) {
  using namespace hopper;
  using L = FwdSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV group
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int q0 = iq * FWD_BQ;
  int nk = (a.sk + L::BK - 1) / L::BK;
  if (a.causal) nk = min(nk, (q0 + FWD_BQ + L::BK - 1) / L::BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {  // producer warpgroup: one thread issues TMA
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int ikv = ih / (a.h / a.hkv);
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_4d(base + L::Q_OFF + cb * L::Q_CB, &a.tq, q_full, cb * 64,
                    q0, ih, ib);
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tk, k_full + 8 * s, cb * 64, i * L::BK, ikv, ib);
        mbar_arrive_expect_tx(v_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tv, v_full + 8 * s, cb * 64, i * L::BK, ikv, ib);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    fwd_consumer<D>(a, base, q0, ih, ib, nk);
  }
}

// ------------------------------------------------ bf16: the D-split kernel
//
// At d 320 and 448 K1 is `flash_fwd_split<D>` (kDSplit; at d 384 and 512
// it runs only in the -DFLASH_OTHER_DESIGNS=1 build, flash_fwd_pair ships
// there): `flash_fwd_wgmma` cannot hold O (D / 2 registers a thread: 256
// at d 512, past the 255 a thread may have) and its 128-row Q tile plus
// two K/V stages overflow 227 KB. Here:
// - a block is just the two consumer warpgroups, 8 warps, so a thread may
//   hold 255 registers: ptxas gives each thread of a 9- to 12-warp block
//   (a producer warp or warpgroup beside them; three warps then share a
//   sub-partition's 16K registers) 168, setmaxnreg notwithstanding, and
//   at d 384 to 512 the consumers spilled there. Thread 0 issues the
//   loads, each one TMA copy of a whole tile (hopper::tmap_bf16_tile): Q
//   and the first STAGES key tiles, then each stage's next tile as soon
//   as both warpgroups have released it, without ever waiting: right
//   after its own warpgroup's release if the other's is already in
//   (mbar_test), else just past the next tile's exchange barrier, where
//   it must be;
// - a block owns 64 query rows, and BOTH consumer warpgroups own all 64;
//   the D columns of O are split between them: warpgroup c accumulates NC
//   = ceil(D / 128) * 64 columns starting at c (D - NC) (at d 320 and 448
//   the middle 64 columns are computed by both and stored by warpgroup 0),
//   so O is at most 128 registers a thread;
// - the scores are split by keys instead: warpgroup c forms S for keys
//   [c BK / 2, (c + 1) BK / 2) of the tile over the whole head dim (wgmma
//   m64n(BK/2), both operands in shared memory), and the two exchange their
//   halves through shared memory in fragment order (hopper::put_half,
//   join_half; one named barrier per tile). Each product runs once; both
//   warpgroups then hold the same S and run the same online softmax on
//   it, so m, l and P agree bit for bit and every instruction stream is
//   the same (no branch on the warpgroup around a wgmma, which makes
//   ptxas serialise);
// - O[:, own columns] += P V[:, own columns], P re-packed in registers as
//   the A operand (wgmma_rs_t_cols), as in flash_fwd_wgmma;
// - BK is 32 keys, with as many stages (at most 4) as fit beside Q and the
//   exchange buffers (FwdSplit). (At d 256, with 64-key tiles, this design
//   lost to PR 10's flash_fwd_wgmma in turns in PRs 10 and 12.)
// The masking, the LSE and the heaviest-first order are flash_fwd_wgmma's.

// K/V stages of `bk` keys that fit beside a 64-row Q tile, the exchange
// buffers (2 x 2 warpgroups x 64 rows x bk / 2 f32) and the mbarriers
__host__ __device__ constexpr int fwd_split_fit(int d, int bk) {
  return (SMEM_MAX - 2048 - 64 * d * 2 - 512 * bk) / (4 * bk * d);
}

template <int D>
struct FwdSplit {
  static constexpr int BQ = 64;                  // query rows per block
  static constexpr int NC = (D + 127) / 128 * 64;  // O columns a consumer
  static constexpr int Q_CB = BQ * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int BK = 32;
  static constexpr int FIT = fwd_split_fit(D, BK);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int XCH = 2 * (BK / 4) * WG;  // f32 a buffer
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * XCH * 4;
  // mbarriers: q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(D % 64 == 0 && NC <= 256, "O: 256 columns a consumer");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// K and V of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void fwd_split_load(const FwdArgs& a,
                                               uint32_t base, int i, int ikv,
                                               int ib) {
  using namespace hopper;
  using L = FwdSplit<D>;
  const int s = i % L::STAGES;
  const uint32_t k_full = base + L::BAR_OFF + 8 + 8 * s;
  const uint32_t v_full = k_full + 8 * L::STAGES;
  mbar_arrive_expect_tx(k_full, L::KV_BYTES);
  tma_load_5d(base + L::K_OFF + s * L::KV_BYTES, &a.tk, k_full, 0,
              i * L::BK, 0, ikv, ib);
  mbar_arrive_expect_tx(v_full, L::KV_BYTES);
  tma_load_5d(base + L::V_OFF + s * L::KV_BYTES, &a.tv, v_full, 0,
              i * L::BK, 0, ikv, ib);
}

template <int D>
__device__ __forceinline__ void fwd_split_consumer(const FwdArgs& a,
                                                   uint32_t base,
                                                   float* xbuf, int q0,
                                                   int ih, int ib, int nk) {
  using namespace hopper;
  using L = FwdSplit<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NC = L::NC, HALF = BK / 2;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const int c = threadIdx.x / WG;  // this warpgroup's keys and columns
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int row0 = q0 + 16 * w + g, row1 = row0 + 8;
  const int col0 = c * (D - NC);  // this warpgroup's first O column
  const uint32_t q_addr = base + L::Q_OFF;
  const uint32_t v_cols = c * ((D - NC) / 64) * L::KV_CB;

  float o[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int ikv = ih / (a.h / a.hkv);
  bool refill = false;  // thread 0: tile i - 1's stage still to refill

  mbar_wait(q_full, 0);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // this warpgroup's half of S = Q K^T: 64 rows x BK / 2 keys
    float own[HALF / 2];
    mbar_wait(k_full + 8 * s, ph);
    wgmma_fence();
    wgmma_ss<HALF, D / 16, L::Q_CB, L::KV_CB>(
        own, desc_sw128(q_addr, 16, 1024),
        desc_sw128(k_addr + c * HALF * 128, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(own);
    float sc[BK / 2];
    float* buf = xbuf + (i & 1) * L::XCH;
    put_half<HALF / 2>(own, buf, c, t);
    bar_sync(1, 2 * WG);
    if (refill) {  // past the barrier both warpgroups released tile i - 1
      mbar_wait(empty + 8 * ((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      fwd_split_load<D>(a, base, i - 1 + STAGES, ikv, ib);
      refill = false;
    }
    join_half<HALF / 2>(own, buf, sc, c, t);

    float alpha0, alpha1;
    fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    uint32_t pf[BK / 16][4];
    fwd_pack<BK>(pf, sc);
    fwd_rescale(o, alpha0, alpha1);

    // O[:, own columns] += P V[:, own columns]
    mbar_wait(v_full + 8 * s, ph);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<NC, BK / 16, L::KV_CB>(o, pf, v_addr + v_cols);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + 8 * s);
    // the stage's next tile: now if the other warpgroup has released the
    // stage too, else at the next tile's exchange
    if (threadIdx.x == 0 && i + STAGES < nk) {
      refill = !mbar_test(empty + 8 * s, ph);
      if (!refill) fwd_split_load<D>(a, base, i + STAGES, ikv, ib);
    }
  }
  fwd_finish<NC>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, col0,
                 c == 0 ? 0 : NC, c == 0);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_fwd_split(const __grid_constant__ FwdArgs a) {
  using namespace hopper;
  using L = FwdSplit<D>;
  constexpr int STAGES = L::STAGES, BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* xbuf = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::X_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

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
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // Q and the first STAGES key tiles
    mbar_arrive_expect_tx(q_full, L::Q_BYTES);
    tma_load_5d(base + L::Q_OFF, &a.tq, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < STAGES && i < nk; ++i)
      fwd_split_load<D>(a, base, i, ih / (a.h / a.hkv), ib);
  }
  fwd_split_consumer<D>(a, base, xbuf, q0, ih, ib, nk);
}

// ------------------------------------------------ bf16 at d 384, 512: clusters
//
// At d 384 and 512 K1 is `flash_fwd_pair<D>` (kPair; flash_fwd_split<D>
// is the -DFLASH_OTHER_DESIGNS=1 build's). What held flash_fwd_split back
// there: with Q resident at the full head dim a block holds 64 rows and
// 32-key stages; each warpgroup forms its half of S over all D columns as
// m64n16 products (a 64 x 16 slice of Q read from shared memory for every
// 16 output columns), P V is two k16 steps a tile, and every 32-key tile
// runs its chain (S, the exchange and its barrier, the softmax, P V,
// waited for) in series. Bound on an H100: operations (QK^T and PV, 4 s^2
// d flops per causal (b, h) against 4 s d bytes). Here, as K3's dkv_pair
// (csrc/flash_bwd.cu) does for K3:
// - a pair (two blocks on neighbouring SMs, launched as one cluster by
//   hopper::launch_cluster) owns 128 query rows of one (batch, head); the
//   block of rank r holds columns [r D/2, (r + 1) D/2) of Q, K, V and O
//   (its tensor maps and O pointer start at its half: FwdPairArgs);
// - within a block: flash_fwd_wgmma's rows at D / 2 (two warpgroups of 64
//   rows, Q resident, 64-key K and V tiles in 3 stages at d 384 and 2 at
//   d 512, where a third does not fit beside Q and the receive buffers; K
//   apart from V) on 8 warps, thread 0 issuing the loads (each tile one
//   TMA copy) at the top of a tile, so a thread may hold 255 registers (on
//   flash_fwd_wgmma's 12 warps, 168 registers, the prefetch below does
//   not fit; at d 512 O alone is 128 registers a thread);
// - S over half the head dim (m64n64k16 x D/32) is a partial sum, summed
//   with the twin warpgroup's in the peer by hopper::PairExchange (one
//   round of 16 KB a tile: st.async into the twin's receive buffer, the
//   twin's added in a fixed order), so both blocks hold the same S bit
//   for bit, and the same online softmax then gives the same m, l and P;
// - the exchange moves 32 KB each way a tile between the two SMs (about
//   1.4 us on an H100 with nothing else to do, as long as the tile's
//   products): at d 384 (PREFETCH) the next tile's partial S is issued as
//   soon as this one's is sent, so it is on the tensor cores while the
//   exchange runs (32 more registers a thread); at d 512 that lost on two
//   stages;
// - O[:, own half] += P V[:, own half] (P re-packed in registers, as in
//   flash_fwd_wgmma); both blocks store their half of O, rank 0 the LSE.
// The receive buffers: one a warpgroup (16 KB), whose only readers are
// that warpgroup's 128 threads (the adds right after the wait on its
// `recv`); the warpgroup releases it once all 128 have issued the tile's
// P V (PairExchange::release; at cluster scope the release cost a tenth
// of the kernel's time, PERF.md §6). Every sum runs in a fixed order in
// one pair, with no atomics. The masking and the heaviest-first order are
// flash_fwd_wgmma's, by pair.
template <int D>
struct FwdPair {
  static constexpr int DH = D / 2;  // head-dim columns a block holds
  static constexpr int BK = 64;     // keys per K/V stage
  // K/V stages: 3 at d 384 (2 leave 48 KB unused); at d 512 a third does
  // not fit beside Q and the receive buffers
  static constexpr int STAGES = D == 384 ? 3 : 2;
  // the next tile's partial S issued during this one's exchange, at d 384
  // (at d 512, on two stages, thread 0 then waits every tile for the other
  // warpgroup's release of the tile before: 0.38 ms against 0.32 without,
  // PERF.md §6)
  static constexpr bool PREFETCH = D == 384;
  static constexpr int Q_CB = FWD_BQ * 128;
  static constexpr int KV_CB = BK * 128;
  static constexpr int Q_BYTES = FWD_BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  // the exchange: a thread's BK / 2 partial scores, BK / 8 chunks a round
  using X = hopper::PairExchange<BK / 8>;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * X::BYTES;
  // mbarriers: q_full, k_full[S], v_full[S], empty[S], then the exchange's
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES + X::BARS) + 1024;
  static_assert(DH % 64 == 0 && DH <= 256, "O: 128 registers a thread");
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

// Each block's arguments: FwdArgs over its half of the head dim.
struct FwdPairArgs {
  FwdArgs half[2];
};

// K and V of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void fwd_pair_load(const FwdArgs& a,
                                              uint32_t base, int i, int ikv,
                                              int ib) {
  using namespace hopper;
  using L = FwdPair<D>;
  const int s = i % L::STAGES;
  const uint32_t k_full = base + L::BAR_OFF + 8 + 8 * s;
  const uint32_t v_full = k_full + 8 * L::STAGES;
  mbar_arrive_expect_tx(k_full, L::KV_BYTES);
  tma_load_5d(base + L::K_OFF + s * L::KV_BYTES, &a.tk, k_full, 0,
              i * L::BK, 0, ikv, ib);
  mbar_arrive_expect_tx(v_full, L::KV_BYTES);
  tma_load_5d(base + L::V_OFF + s * L::KV_BYTES, &a.tv, v_full, 0,
              i * L::BK, 0, ikv, ib);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_fwd_pair(const __grid_constant__ FwdPairArgs pa) {
  using namespace hopper;
  using L = FwdPair<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, DH = L::DH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const FwdArgs& a = pa.half[rank];
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const uint32_t xbar = empty + 8 * STAGES;

  // heaviest query tiles first; neighbouring pairs share a KV group; the
  // pair's index is its cluster's
  const int pair = static_cast<int>(blockIdx.x) / 2;
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - pair / hb;
  const int ih = pair % hb % a.h;
  const int ib = pair % hb / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = iq * FWD_BQ;
  // the same key tiles for both warpgroups (and both blocks): up to the
  // diagonal of the pair's last row; at least one
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + FWD_BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    L::X::init(xbar, true);
    fence_mbar_init();
  }
  L::X::begin();

  if (threadIdx.x == 0) {  // Q and the first STAGES key tiles
    mbar_arrive_expect_tx(q_full, L::Q_BYTES);
    tma_load_5d(base, &a.tq, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < STAGES && i < nk; ++i)
      fwd_pair_load<D>(a, base, i, ikv, ib);
  }
  int next = STAGES;  // thread 0: the next key tile to load

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + c * 64 * 128;
  // this warpgroup's side of the exchange with its twin in the peer
  const typename L::X xc(base + L::X_OFF, smem + L::X_OFF, xbar, peer, c,
                         t);

  // this block's partial S = Q[:, half] K[:, half]^T of tile m (64 rows x
  // BK keys), issued
  auto scores = [&](float (&out)[BK / 2], int m) {
    mbar_wait(k_full + 8 * (m % STAGES), (m / STAGES) & 1);
    wgmma_fence();
    wgmma_ss<BK, DH / 16, L::Q_CB, L::KV_CB>(
        out, desc_sw128(q_addr, 16, 1024),
        desc_sw128(base + L::K_OFF + (m % STAGES) * L::KV_BYTES, 16, 1024));
    wgmma_commit();
  };

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float st[BK / 2];

  mbar_wait(q_full, 0);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t xph = i & 1;
    const int k0 = i * BK;
    const bool more = i + 1 < nk;
    // thread 0 loads each tile whose stage both warpgroups have released
    // (tile `next` reuses the stage of tile next - STAGES, which this
    // warpgroup released if next - STAGES < i), testing without waiting;
    // it waits only for the tile read now (PREFETCH: the next one). Here,
    // before this tile's send, and not during the exchange (the twin waits
    // on that: 30% slower, PERF.md §6), and all by thread 0 (V by thread
    // 128: 15% slower)
    if (threadIdx.x == 0) {
      for (; next < nk && next < i + STAGES; ++next) {
        const uint32_t e = empty + 8 * (next % STAGES);
        const uint32_t par = ((next - STAGES) / STAGES) & 1;
        if (next > i + L::PREFETCH && !mbar_test(e, par)) break;
        mbar_wait(e, par);
        fwd_pair_load<D>(a, base, next, ikv, ib);
      }
    }
    if (!L::PREFETCH || i == 0) scores(st, i);  // PREFETCH: in st already
    wgmma_wait<0>();
    fence_regs(st);

    // to the twin, once it has read the last tile's
    xc.send(st, xph);
    // PREFETCH: the next tile's partial, meanwhile (taken into st below
    // on every tile, unused after the last)
    float sn[L::PREFETCH ? BK / 2 : 1];
    if constexpr (L::PREFETCH)
      if (more) scores(sn, i + 1);
    // from the twin: its partial, added to this one's
    xc.recv_add(st, xph, more);

    float alpha0, alpha1;
    fwd_softmax<BK>(a, st, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    uint32_t pf[BK / 16][4];
    fwd_pack<BK>(pf, st);
    fwd_rescale(o, alpha0, alpha1);

    // O[:, own half] += P V[:, own half]
    mbar_wait(v_full + 8 * s, (i / STAGES) & 1);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<DH, BK / 16, L::KV_CB>(o, pf,
                                           base + L::V_OFF + s * L::KV_BYTES);
    wgmma_commit();
    // every thread of the warpgroup has read its receive buffer once all
    // have issued the product: the twin may store the next partial
    xc.release(more);
    wgmma_wait<0>();  // and the next tile's partial (PREFETCH)
    fence_regs(o);
    if constexpr (L::PREFETCH) {
      fence_regs(sn);
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) st[r] = sn[r];
    }
    mbar_arrive(empty + 8 * s);
  }
  L::X::end([&] {
    fwd_finish<DH>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0,
                   rank == 0);
  });
}

// ------------------------------------------------ bf16: rows on 8 warps
//
// At d 256 K1 is `flash_fwd_rows8<D>` (kRows8; at d 192 it lost to
// flash_fwd_wgmma in turns and is built only with -DFLASH_OTHER_DESIGNS=1).
// What held PR 10's flash_fwd_wgmma back at d 256: a 12-warp block gets 168
// registers a thread from ptxas, setmaxnreg notwithstanding, so beside O
// (D / 2 = 128 registers) its S tile had to shrink to 32 keys, and it still
// spilled and serialised every wgmma (C7512); each 32-key tile paid two
// mbarrier waits, two full wgmma drains, a quad max and the rescale of all
// of O. Bound on an H100: operations (QK^T and PV, 4 s^2 d flops per causal
// (b, h) against 4 s d bytes). Here:
// - a block is the two consumer warpgroups alone, 8 warps, 255 registers a
//   thread; it owns 128 query rows, 64 a warpgroup (one wgmma M tile),
//   with Q resident;
// - K and V stream in tiles of BK keys (80 at d 256, 96 at d 192: S is BK
//   / 2 registers beside O), two stages beside Q (224 KB and 192 KB of the
//   227), each tile one TMA copy (hopper::tmap_bf16_tile) with its own full
//   and empty mbarriers, K apart from V: a warpgroup releases K once its
//   scores are in and V once its P V is, one arrival a warpgroup (its
//   thread 0, past the wgmma wait that covers all of its reads);
// - thread 0 issues the loads: Q and the first stages, then once a tile,
//   while its warpgroup's products are in flight (so the issue costs that
//   warpgroup nothing), every K or V tile whose stage both warpgroups have
//   released, testing without waiting (mbar_test); it waits for a release
//   only for the tiles the next iteration reads;
// - the warpgroups take turns at the tensor cores (FlashAttention-3's
//   ping-pong): warpgroup c issues its products once named barrier kTurn +
//   c completes (its own bar_sync and the other's bar_arrive) and hands the
//   turn over right after, so one warpgroup's softmax runs while the
//   other's products do;
// - inside a warpgroup (FlashAttention-3's overlap): tile i's S = Q K^T
//   (m64nBK, both operands in shared memory) and tile i - 1's O += P V (P
//   re-packed in registers, wgmma_rs_t_cols) are issued in one turn as two
//   commit groups; tile i's online softmax runs once S is in, while P V is
//   still in flight, and O takes tile i's rescale just before the next
//   issue. There is no branch on the warpgroup around a wgmma: both run one
//   instruction stream (the barrier id is a register);
// - both warpgroups run the block's key tiles up to the diagonal of its last
//   row, warpgroup 0's last ones fully masked.
// The masking, the LSE and the heaviest-first order are flash_fwd_wgmma's.
constexpr int kTurn = 2;  // named barriers kTurn, kTurn + 1 (1: exchanges)

template <int D>
struct FwdRows8 {
  static constexpr int BQ = 128;  // query rows per block: 64 a warpgroup
  static constexpr int BK = D <= 192 ? 96 : 80;  // keys per K/V stage
  static constexpr int STAGES = 2;
  static constexpr int Q_CB = BQ * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // mbarriers: q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(D % 64 == 0 && D <= 256, "O: 256 columns a warpgroup");
  static_assert(BK % 16 == 0 && BYTES <= SMEM_MAX, "227 KB a block");
};

// K (v = 0) or V (v = 1) of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void fwd_rows8_load(const FwdArgs& a,
                                               uint32_t base, int v, int i,
                                               int ikv, int ib) {
  using namespace hopper;
  using L = FwdRows8<D>;
  const int s = i % L::STAGES;
  const uint32_t full = base + L::BAR_OFF + 8 + 8 * (v * L::STAGES + s);
  mbar_arrive_expect_tx(full, L::KV_BYTES);
  tma_load_5d(base + (v ? L::V_OFF : L::K_OFF) + s * L::KV_BYTES,
              v ? &a.tv : &a.tk, full, 0, i * L::BK, 0, ikv, ib);
}

// Thread 0: K (v = 0) or V (v = 1) of tiles next, next + 1, ... below
// `end`, each once both warpgroups have released its stage: waiting for
// that release up to tile `due`, only testing for it past `due`. Returns
// the next tile still to load.
template <int D>
__device__ __forceinline__ int fwd_rows8_refill(const FwdArgs& a,
                                                uint32_t base, int v,
                                                int next, int due, int end,
                                                int ikv, int ib) {
  using namespace hopper;
  using L = FwdRows8<D>;
  const uint32_t empty = base + L::BAR_OFF + 8 + 8 * (2 + v) * L::STAGES;
  for (; next < end; ++next) {
    const uint32_t e = empty + 8 * (next % L::STAGES);
    const uint32_t par = ((next - L::STAGES) / L::STAGES) & 1;
    if (next > due && !mbar_test(e, par)) break;
    mbar_wait(e, par);
    fwd_rows8_load<D>(a, base, v, next, ikv, ib);
  }
  return next;
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
flash_fwd_rows8(const __grid_constant__ FwdArgs a) {
  using namespace hopper;
  using L = FwdRows8<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, k_empty = v_full + 8 * STAGES,
                 v_empty = k_empty + 8 * STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV group
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
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);  // one arrival a warpgroup
      mbar_init(v_empty + 8 * s, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // thread 0: the next K and V tiles to load
  int next_k = min(STAGES, nk), next_v = next_k;
  if (threadIdx.x == 0) {  // Q, and K and V of the first STAGES tiles
    mbar_arrive_expect_tx(q_full, L::Q_BYTES);
    tma_load_5d(base, &a.tq, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < next_k; ++i) {
      fwd_rows8_load<D>(a, base, 0, i, ikv, ib);
      fwd_rows8_load<D>(a, base, 1, i, ikv, ib);
    }
  }

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + c * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[BK / 2], alpha0, alpha1;
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
  fwd_finish<D>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0, true);
}

// ------------------------------------------------ bf16: twin blocks (d 64)
//
// At d 64 (Llama-3.2-1B's heads) K1 is `flash_fwd_twin<D>` (kTwin; the
// row split's flash_fwd_wgmma<64> is the -DFLASH_OTHER_DESIGNS=1 build's).
// What held flash_fwd_wgmma<64> back: a 128 x 128 tile's 16K exp2 take
// ~1,024 clocks on an SM's 16 MUFU lanes, as long as the tile's two
// products on the tensor cores, and its 12-warp block (one a SM) ran
// each consumer's S, softmax and P V in series. Bound on an H100:
// operations (4 s^2 d flops per causal (b, h) against 4 s d bytes). Here:
// - a block is flash_fwd_rows8's: two warpgroups of 64 query rows, 8
//   warps, Q resident, thread 0 issuing the loads; but at most 128
//   registers a thread (__launch_bounds__(256, 2)), so two blocks, four
//   warpgroups, share an SM and the warp schedulers run one warpgroup's
//   exponentials while another's products are on the tensor cores;
// - each warpgroup runs a tile's S = Q K^T (m64n128, both operands in
//   shared memory), its online softmax and O += P V (P re-packed in
//   registers) in series: S's 64 registers are free again once P is
//   packed, which is what fits 128-key tiles beside O in 128 registers.
//   flash_fwd_rows8's overlap (S(i) in flight beside P V(i - 1)) holds S
//   and the last P at once and fits only 64- or 80-key tiles there; it
//   lost to this by 15% or more, and the turns between the two
//   warpgroups by 8% (kernel_variants.py; PERF.md §6);
// - K and V stream in 2 stages of 128 keys (80 KB a block with Q), each
//   tile one TMA copy with its own full mbarrier (S starts before V
//   lands) and one empty mbarrier for the stage, one arrival a warpgroup
//   past its P V's wait; thread 0 loads a tile into a stage both
//   warpgroups have released: right after its own release if the other's
//   is in (mbar_test), else while the next tile's S is in flight, where
//   it waits for it;
// - BQ = BK = 128: the last key tile of a causal block is its diagonal
//   one, half masked for warpgroup 0 and never wholly.
// The masking, the LSE and the heaviest-first order are flash_fwd_wgmma's.
template <int D>
struct FwdTwin {
  static constexpr int BQ = 128;  // query rows per block: 64 a warpgroup
  static constexpr int BK = 128;  // keys per K/V stage
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS = 2;  // blocks an SM holds
  static constexpr int Q_CB = BQ * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_CB = BK * 128;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // mbarriers: q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(D == 64, "O, S and P in 128 registers a thread");
  static_assert(BLOCKS * BYTES <= SMEM_MAX, "two blocks a SM");
};

// K and V of key tile i into its stage, by TMA (one thread).
template <int D>
__device__ __forceinline__ void fwd_twin_load(const FwdArgs& a,
                                              uint32_t base, int i, int ikv,
                                              int ib) {
  using namespace hopper;
  using L = FwdTwin<D>;
  const int s = i % L::STAGES;
  const uint32_t k_full = base + L::BAR_OFF + 8 + 8 * s;
  const uint32_t v_full = k_full + 8 * L::STAGES;
  mbar_arrive_expect_tx(k_full, L::KV_BYTES);
  tma_load_5d(base + L::K_OFF + s * L::KV_BYTES, &a.tk, k_full, 0,
              i * L::BK, 0, ikv, ib);
  mbar_arrive_expect_tx(v_full, L::KV_BYTES);
  tma_load_5d(base + L::V_OFF + s * L::KV_BYTES, &a.tv, v_full, 0,
              i * L::BK, 0, ikv, ib);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, FwdTwin<D>::BLOCKS)
flash_fwd_twin(const __grid_constant__ FwdArgs a) {
  using namespace hopper;
  using L = FwdTwin<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV group
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = iq * BQ;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // Q, and K and V of the first STAGES tiles
    mbar_arrive_expect_tx(q_full, L::Q_BYTES);
    tma_load_5d(base, &a.tq, q_full, 0, q0, 0, ih, ib);
    for (int i = 0; i < STAGES && i < nk; ++i)
      fwd_twin_load<D>(a, base, i, ikv, ib);
  }
  int next = STAGES;  // thread 0: the next key tile to load

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;
  const uint32_t q_addr = base + c * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = i * BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T: 64 rows x BK keys
    float sc[BK / 2];
    mbar_wait(k_full + 8 * s, ph);
    wgmma_fence();
    wgmma_ss<BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    wgmma_commit();
    // while it is in flight: the next tile, if it is due and its stage was
    // not refilled at the end of the last tile (waiting for the release)
    if (threadIdx.x == 0 && next == i + 1 && next < nk) {
      mbar_wait(empty + 8 * (next % STAGES), ((next - STAGES) / STAGES) & 1);
      fwd_twin_load<D>(a, base, next++, ikv, ib);
    }
    wgmma_wait<0>();
    fence_regs(sc);

    // mask only tiles that cross the diagonal or the ragged end
    float alpha0, alpha1;
    fwd_softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                    (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0,
                    row0, row1, tq);
    uint32_t pf[BK / 16][4];
    fwd_pack<BK>(pf, sc);
    fwd_rescale(o, alpha0, alpha1);

    // O += P V
    mbar_wait(v_full + 8 * s, ph);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<D, BK / 16, L::KV_CB>(o, pf, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(empty + 8 * s);
    // the stage's next tile now if the other warpgroup released it too
    if (threadIdx.x == 0 && next == i + STAGES && next < nk &&
        mbar_test(empty + 8 * s, ph))
      fwd_twin_load<D>(a, base, next++, ikv, ib);
  }
  fwd_finish<D>(a, o, m0, m1, l0, l1, row0, row1, ih, ib, tq, 0, 0, true);
}

// ------------------------------------------------ f32: CUDA cores
//
// float32 inputs run on the CUDA cores in true f32 FMA (no TF32), so f32
// parity with the reference holds. Two designs (F32Design; the C function
// flash_fwd_f32_design reports the one a build runs, and chip_smoke.py
// labels its f32 timings by it):
//   kF32Tiled   flash_fwd_f32 (below): register-tiled FFMA with cp.async
//               loads through a ring of stages, at every head dim;
//   kF32Scalar  flash_fwd_f32_scalar: each thread forms whole length-D
//               dots from shared memory, two shared loads an FMA, loads
//               synchronous; built only with -DFLASH_OTHER_DESIGNS=1, at
//               d 128.
//
// What bounds them: the f32 FMA rate (67 TF/s on an H100; two products of
// 2 s^2 d / 2 flops per causal (b, h) against 4 s d floats, hundreds of
// flops a byte). An SM's FP32 pipes do 128 FMAs a clock and its shared
// memory delivers 32 words a clock, so the products are register-tiled as
// in dq_f32 (csrc/flash_bwd.cu, the note above its F32Design), whose
// structure this is, less the dP product and plus the online softmax:
//   - 256 threads (8 warps) a block own BQ query rows, Q resident; K and V
//     stream in tiles of BK keys through a ring of ST stages by cp.async
//     16-byte copies (zero-filled past sk), rows padded to D + 4 floats;
//   - S = Q K^T: thread (gr, gc) = (tid / CT, tid % CT) holds SR x SC
//     scores at query rows gr + RT i and keys gc + CT j; per 4 of D it reads
//     one float4 a row and a key, shared by broadcast (f32_dots). The CT =
//     16 threads of a row are one half-warp, so the row max and the row sum
//     are four shuffles and m and l never touch shared memory;
//   - the online softmax folds the scale and log2 e into exp2; a masked
//     score gets P = 0 by a select; O is rescaled by alpha per row a tile;
//     l is summed over the row's lanes once, at the end;
//   - P goes to shared memory once, as P^T [key][row] with pitch BQ + 4 and
//     a thread's SR rows contiguous (one float4 store a key at SR 4, four
//     wavefronts a warp: conflict-free), and O += P V gives each thread the
//     same SR rows (so alpha, m and l stay in its registers) and D / CT
//     columns, float4s gc + CT n (f32_outer): 32 floats at d 128, 64 at
//     d 256 and at d 512, where the blocks are 32 rows;
//   - no column split (two blocks would both form the scores) and no
//     key-range split (it would need a merge of (m, l, O)): each block
//     writes its own rows, deterministic;
//   - heaviest causal query tiles launch first, as in the bf16 kernels;
//     neighbouring blocks take the heads of one KV group.

enum F32Design { kF32Scalar = 0, kF32Tiled = 1 };

constexpr int f32_design(int d) {
  return FLASH_OTHER_DESIGNS && d == 128 ? kF32Scalar : kF32Tiled;
}

// K1's f32 tiles at head dim D: BQ query rows a block (Q resident), K/V
// tiles of BK keys in ST stages (from d 192 one stage of 64 keys, then of
// 32 keys beside 32 rows), CT threads a query row (a half-warp), SR x SC
// scores a thread, P^T [BK][XP].
template <int D>
struct FwdF32 {
  static constexpr int BQ = D <= 256 ? 64 : 32;
  static constexpr int BK = D <= 256 ? 64 : 32;
  static constexpr int ST = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int CT = 16;
  static constexpr int RT = F32_THREADS / CT;
  static constexpr int SR = BQ / RT, SC = BK / CT;
  static constexpr int P = D + 4;    // row pitch, floats
  static constexpr int XP = BQ + 4;  // P^T [BK][XP]
  static constexpr int Q_OFF = 0, KV_OFF = BQ * P;
  static constexpr int X_OFF = KV_OFF + ST * 2 * BK * P;
  static constexpr int BYTES = (X_OFF + BK * XP) * 4;
  static_assert(SR * RT == BQ && SC * CT == BK && CT <= 32 &&
                    D % (4 * CT) == 0,
                "thread grid");
  static_assert(BYTES <= SMEM_MAX, "227 KB a block");
};

// K1, f32: O and LSE for one (b, head, BQ-row query tile). Grid:
// blockIdx.x = t h b + ib h + ih, the query tile nq - 1 - t under causal
// masking (heaviest first), else t.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_fwd_f32(const Params p) {
  using L = FwdF32<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int CT = L::CT, RT = L::RT, P = L::P, XP = L::XP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qs = sm + L::Q_OFF;
  float* Xs = sm + L::X_OFF;

  const int tid = threadIdx.x, gr = tid / CT, gc = tid % CT;
  const int nq = (p.sq + BQ - 1) / BQ;
  const int hb = gridDim.x / nq;  // h b
  const int t = blockIdx.x / hb;
  const int ih = blockIdx.x % hb % p.h, ib = blockIdx.x % hb / p.h;
  const int q0 = (p.causal ? nq - 1 - t : t) * BQ;
  const int ikv = ih / (p.h / p.hkv);
  const float* k = static_cast<const float*>(p.k) + ib * p.k_sb + ikv * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + ib * p.v_sb + ikv * p.v_sh;
  const int nk = key_tiles(p, q0, BQ, BK);

  auto issue = [&](int ik) {
    float* kv = sm + L::KV_OFF + ik % ST * 2 * BK * P;
    f32_rows_async<D, BK>(kv, k, p.k_ss, ik * BK, p.sk, tid);
    f32_rows_async<D, BK>(kv + BK * P, v, p.v_ss, ik * BK, p.sk, tid);
  };
  f32_rows_async<D, BQ>(
      Qs, static_cast<const float*>(p.q) + ib * p.q_sb + ih * p.q_sh, p.q_ss,
      q0, p.sq, tid);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) issue(s);
    hopper::cp_async_commit();
  }
  const float scale_log2 = p.scale * hopper::kLog2e;

  float o[SR][D / CT];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int c = 0; c < D / CT; ++c) o[i][c] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) m[i] = kNegInf, l[i] = 0.f;

#pragma unroll 1
  for (int ik = 0; ik < nk; ++ik) {
    f32_next_stage<ST>(ik, nk, issue);  // tile ik is in

    const float* Ks = sm + L::KV_OFF + ik % ST * 2 * BK * P;
    const float* Vs = Ks + BK * P;
    const int k0 = ik * BK;

    // S = Q K^T
    float s[1][SR][SC];
    f32_dots<D, SR, SC, RT, CT, 1>(s, {Qs}, {Ks}, gr, gc);

    // mask only tiles that cross the diagonal or the ragged end
    const bool need_mask = (p.causal && k0 + BK - 1 > q0) || k0 + BK > p.sk;
    float alpha[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = q0 + gr + RT * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + gc + CT * j;
        if (need_mask && (col >= p.sk || (p.causal && col > row)))
          s[0][i][j] = kNegInf;
        mx = fmaxf(mx, s[0][i][j]);
      }
#pragma unroll
      for (int off = CT / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = hopper::fast_exp2((m[i] - mx) * scale_log2);
      m[i] = mx;
      l[i] *= alpha[i];
    }
    // P = exp2((S - m) scale log2 e), 0 where masked, into P^T
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      float pr[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float x = s[0][i][j];
        pr[i] = x == kNegInf
                    ? 0.f
                    : hopper::fast_exp2(fmaf(x, scale_log2,
                                             -m[i] * scale_log2));
        l[i] += pr[i];
      }
      f32_xstore<SR>(Xs + (gc + CT * j) * XP + SR * gr, pr);
    }
    __syncthreads();  // P^T is in

    // O = alpha O + P V
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int c = 0; c < D / CT; ++c) o[i][c] *= alpha[i];
    f32_outer<D, SR, BK, XP, CT>(o, Xs, Vs, SR * gr, gc);
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  // the row sums over the row's lanes; O / l and LSE = m scale + log l
  float* out = static_cast<float*>(p.o) + ib * p.o_sb + ih * p.o_sh;
  float* lse = p.lse + (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int off = CT / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + gr + RT * i;
    if (row >= p.sq) continue;
    const float inv = 1.f / l[i];
    float* orow = out + row * p.o_ss + 4 * gc;
#pragma unroll
    for (int n = 0; n < D / (4 * CT); ++n)
      *reinterpret_cast<float4*>(orow + 4 * CT * n) =
          make_float4(o[i][4 * n] * inv, o[i][4 * n + 1] * inv,
                      o[i][4 * n + 2] * inv, o[i][4 * n + 3] * inv);
    if (gc == 0) lse[row] = m[i] * p.scale + logf(l[i]);
  }
}

// The scalar f32 kernel (kF32Scalar), built only where f32_design names it
// (d 128).

constexpr int SC_BQ = 32;  // query rows per block: 4 threads per row
constexpr int SC_BK = 32;  // keys per tile
constexpr int SC_THREADS = 128;

// Thread (r, c4) = (tid / 4, tid % 4) owns query row r, the scores of
// keys c4 + 4j of each tile, and output columns c4 + 4jj.
template <int D>
__global__ void __launch_bounds__(SC_THREADS)
flash_fwd_f32_scalar(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [SC_BQ][D + 1]
  float* Ks = Qs + SC_BQ * (D + 1);            // [SC_BK][D + 1]
  float* Vs = Ks + SC_BK * (D + 1);            // [SC_BK][D]
  float* Ps = Vs + SC_BK * D;                  // [SC_BQ][SC_BK + 1]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q0 = blockIdx.x * SC_BQ;
  const int row = q0 + r;
  const float* q = static_cast<const float*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const int ikv = ih / (p.h / p.hkv);
  const float* k = static_cast<const float*>(p.k) + ib * p.k_sb + ikv * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + ib * p.v_sb + ikv * p.v_sh;

  for (int i = tid; i < SC_BQ * D; i += SC_THREADS) {
    const int rr = i / D, cc = i % D;
    Qs[rr * (D + 1) + cc] = q0 + rr < p.sq ? q[(q0 + rr) * p.q_ss + cc] : 0.f;
  }

  float acc[D / 4];
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) acc[jj] = 0.f;
  float m = kNegInf, l = 0.f;

  const int nk = key_tiles(p, q0, SC_BQ, SC_BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * SC_BK;
    __syncthreads();
    for (int i = tid; i < SC_BK * D; i += SC_THREADS) {
      const int rr = i / D, cc = i % D;
      const bool in = k0 + rr < p.sk;
      Ks[rr * (D + 1) + cc] = in ? k[(k0 + rr) * p.k_ss + cc] : 0.f;
      Vs[rr * D + cc] = in ? v[(k0 + rr) * p.v_ss + cc] : 0.f;
    }
    __syncthreads();

    float s[SC_BK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < SC_BK / 4; ++j) {
      const int c = c4 + 4 * j;
      const float* qr = Qs + r * (D + 1);
      const float* kr = Ks + c * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * p.scale;
      const int col = k0 + c;
      if (col >= p.sk || (p.causal && col > row)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SC_BK / 4; ++j) {
      const float pj = expf(s[j] - mn);
      sum += pj;
      Ps[r * (SC_BK + 1) + c4 + 4 * j] = pj;  // f32: the V dtype already
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = mn;
    __syncwarp();  // row r's P is written and read by the same four lanes
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) acc[jj] *= alpha;
    for (int c = 0; c < SC_BK; ++c) {
      const float pc = Ps[r * (SC_BK + 1) + c];
      const float* vr = Vs + c * D + c4;
#pragma unroll
      for (int jj = 0; jj < D / 4; ++jj)
        acc[jj] = fmaf(pc, vr[4 * jj], acc[jj]);
    }
  }

  if (row < p.sq) {
    float* o = static_cast<float*>(p.o) + ib * p.o_sb + ih * p.o_sh +
               row * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) o[c4 + 4 * jj] = acc[jj] / l;
    if (c4 == 0)
      p.lse[(static_cast<int64_t>(ib) * p.h + ih) * p.sq + row] =
          m + logf(l);
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

// The tensor maps and arguments K1 takes in bf16: Q in boxes of BQ rows, K
// and V in boxes of BK keys; one column block a box (flash_fwd_wgmma), or
// with TILE whole tiles (hopper::tmap_bf16_tile, flash_fwd_split,
// flash_fwd_rows8 and flash_fwd_twin).
template <int BQ, int BK, bool TILE>
cudaError_t fwd_args(FwdArgs& a, const Params& p, int batch, int d) {
  const auto map = TILE ? hopper::tmap_bf16_tile : hopper::tmap_bf16;
  cudaError_t err;
  if ((err = map(&a.tq, p.q, d, p.sq, p.h, batch, p.q_ss, p.q_sh, p.q_sb,
                 BQ)) ||
      (err = map(&a.tk, p.k, d, p.sk, p.hkv, batch, p.k_ss, p.k_sh, p.k_sb,
                 BK)) ||
      (err = map(&a.tv, p.v, d, p.sk, p.hkv, batch, p.v_ss, p.v_sh, p.v_sb,
                 BK)))
    return err;
  a.o = p.o;
  a.lse = p.lse;
  a.o_sb = p.o_sb;
  a.o_sh = p.o_sh;
  a.o_ss = p.o_ss;
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

// flash_fwd_pair's arguments: for the block of rank r, fwd_args over
// columns [r D / 2, (r + 1) D / 2) of Q, K, V and O (each pointer moved to
// its half; the tensor maps D / 2 columns wide).
template <int D>
cudaError_t fwd_pair_args(FwdPairArgs& pa, const Params& p, int batch) {
  using L = FwdPair<D>;
  for (int r = 0; r < 2; ++r)
    if (cudaError_t err = fwd_args<FWD_BQ, L::BK, true>(
            pa.half[r],
            hopper::at_column(p, int64_t{r} * L::DH, &Params::q, &Params::k,
                              &Params::v, &Params::o),
            batch, L::DH))
      return err;
  return cudaSuccess;
}

template <int D>
cudaError_t run(const Params& p, int batch, int bf16, cudaStream_t stream) {
  if (bf16) {
    FwdArgs a;
    cudaError_t err;
    if constexpr (fwd_design(D) == kPair) {
      using L = FwdPair<D>;
      FwdPairArgs pa;
      if ((err = fwd_pair_args<D>(pa, p, batch))) return err;
      return hopper::launch_cluster(flash_fwd_pair<D>,
                                    2 * pa.half[0].nq * p.h * batch, 2,
                                    SPLIT_THREADS, L::BYTES, stream, pa);
    } else if constexpr (fwd_design(D) == kDSplit) {
      using L = FwdSplit<D>;
      if ((err = fwd_args<L::BQ, L::BK, true>(a, p, batch, D))) return err;
      return hopper::launch(flash_fwd_split<D>, a.nq * p.h * batch,
                            SPLIT_THREADS, L::BYTES, stream, a);
    } else if constexpr (fwd_design(D) == kRows8) {
      using L = FwdRows8<D>;
      if ((err = fwd_args<L::BQ, L::BK, true>(a, p, batch, D))) return err;
      return hopper::launch(flash_fwd_rows8<D>, a.nq * p.h * batch,
                            SPLIT_THREADS, L::BYTES, stream, a);
    } else if constexpr (fwd_design(D) == kTwin) {
      using L = FwdTwin<D>;
      if ((err = fwd_args<L::BQ, L::BK, true>(a, p, batch, D))) return err;
      return hopper::launch(flash_fwd_twin<D>, a.nq * p.h * batch,
                            SPLIT_THREADS, L::BYTES, stream, a);
    } else {
      using L = FwdSmem<D>;
      if ((err = fwd_args<FWD_BQ, L::BK, false>(a, p, batch, D))) return err;
      return hopper::launch(flash_fwd_wgmma<D>, a.nq * p.h * batch,
                            FWD_THREADS, L::BYTES, stream, a);
    }
  }
  if constexpr (f32_design(D) == kF32Tiled) {
    using L = FwdF32<D>;
    return launch(flash_fwd_f32<D>,
                  dim3((p.sq + L::BQ - 1) / L::BQ * p.h * batch), F32_THREADS,
                  L::BYTES, stream, p);
  } else {
    const dim3 grid((p.sq + SC_BQ - 1) / SC_BQ, p.h, batch);
    const size_t smem =
        ((SC_BQ + SC_BK) * (D + 1) + SC_BK * D + SC_BQ * (SC_BK + 1)) *
        sizeof(float);
    return launch(flash_fwd_f32_scalar<D>, grid, SC_THREADS, smem, stream,
                  p);
  }
}

// Blocks of `kernel` (threads, smem bytes) that one SM holds at once, or
// -1 if the runtime refuses the query.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

template <int D>
int fwd_blocks_per_sm() {
  if constexpr (fwd_design(D) == kPair)
    return blocks_per_sm(flash_fwd_pair<D>, SPLIT_THREADS,
                         FwdPair<D>::BYTES);
  else if constexpr (fwd_design(D) == kDSplit)
    return blocks_per_sm(flash_fwd_split<D>, SPLIT_THREADS,
                         FwdSplit<D>::BYTES);
  else if constexpr (fwd_design(D) == kRows8)
    return blocks_per_sm(flash_fwd_rows8<D>, SPLIT_THREADS,
                         FwdRows8<D>::BYTES);
  else if constexpr (fwd_design(D) == kTwin)
    return blocks_per_sm(flash_fwd_twin<D>, SPLIT_THREADS,
                         FwdTwin<D>::BYTES);
  else
    return blocks_per_sm(flash_fwd_wgmma<D>, FWD_THREADS,
                         FwdSmem<D>::BYTES);
}

template <int D>
int fwd_clusters() {
  if constexpr (fwd_design(D) == kPair)
    return hopper::max_clusters(flash_fwd_pair<D>, 2, SPLIT_THREADS,
                                FwdPair<D>::BYTES);
  else
    return -1;
}

}  // namespace

// q [b, h, sq, d], k/v [b, hkv, sk, d], o [b, h, sq, d] given by element
// strides (head dim contiguous); lse [b, h, sq] f32 contiguous. bf16 = 1 for
// bfloat16 tensors, 0 for float32. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bf16, int batch, int h, int hkv,
                         int sq, int sk, int d, int64_t q_sb, int64_t q_sh,
                         int64_t q_ss, int64_t k_sb, int64_t k_sh,
                         int64_t k_ss, int64_t v_sb, int64_t v_sh,
                         int64_t v_ss, int64_t o_sb, int64_t o_sh,
                         int64_t o_ss, int causal, float scale,
                         void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, lse,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 h, hkv, sq, sk, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(run<64>(p, batch, bf16, st));
    case 128: return static_cast<int>(run<128>(p, batch, bf16, st));
    case 192: return static_cast<int>(run<192>(p, batch, bf16, st));
    case 256: return static_cast<int>(run<256>(p, batch, bf16, st));
    case 320: return static_cast<int>(run<320>(p, batch, bf16, st));
    case 384: return static_cast<int>(run<384>(p, batch, bf16, st));
    case 448: return static_cast<int>(run<448>(p, batch, bf16, st));
    case 512: return static_cast<int>(run<512>(p, batch, bf16, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The design (FwdDesign) K1 runs for bf16 inputs of head dim d
// (chip_smoke.py labels its d 192 and 256 timings by it), and the one
// (F32Design) it runs for float32 inputs.
extern "C" int flash_fwd_design(int d) { return fwd_design(d); }
extern "C" int flash_fwd_f32_design(int d) { return f32_design(d); }

// Blocks of K1's bf16 kernel at head dim d that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; chip_smoke.py prints it
// beside the designs' times), or -1.
extern "C" int flash_fwd_blocks_per_sm(int d) {
  switch (d) {
    case 64: return fwd_blocks_per_sm<64>();
    case 128: return fwd_blocks_per_sm<128>();
    case 192: return fwd_blocks_per_sm<192>();
    case 256: return fwd_blocks_per_sm<256>();
    case 320: return fwd_blocks_per_sm<320>();
    case 384: return fwd_blocks_per_sm<384>();
    case 448: return fwd_blocks_per_sm<448>();
    case 512: return fwd_blocks_per_sm<512>();
    default: return -1;
  }
}

// The clusters of two blocks K1's bf16 kernel at head dim d holds on the
// current card at once (cudaOccupancyMaxActiveClusters; 0: its launch
// would be refused), or -1 where that kernel is not launched in clusters.
extern "C" int flash_fwd_clusters(int d) {
  switch (d) {
    case 384: return fwd_clusters<384>();
    case 512: return fwd_clusters<512>();
    default: return -1;
  }
}
