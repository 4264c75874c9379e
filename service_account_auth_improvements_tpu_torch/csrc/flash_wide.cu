// Flash attention at every head dim above 512 for Hopper (sm_90a), in bf16
// and f32, with a plain C interface: K1, K2 and K3 with the head dim
// streamed.
//
// Replaces, at the head dims past csrc/flash_fwd.cu's and
// csrc/flash_bwd.cu's per-dim kernels (every multiple of 64 above 512, in
// both dtypes), the TPU kernels `_fwd_kernel` (K1), `_dq_kernel` (K2) and
// `_dkv_kernel` (K3) in service_account_auth_improvements_tpu/ops/
// flash_attention.py (113-168, 212-258, 261-310), whose rules set no upper
// bound on the head dim. What they compute, and the numerical rules, are
// the per-dim kernels' (the notes at the top of flash_fwd.cu and
// flash_bwd.cu): bf16 products take bf16 operands and accumulate in f32;
// K1 rounds P to bf16 before P V, K2 forms dS = P (dP - delta) from the
// f32 P and rounds it before dS K, K3 rounds P before P^T dO and dS before
// dS^T Q; f32 runs in true f32 FMA with no rounding between (the section
// "f32" below); masked scores are -2e38; rows and keys past s load as
// zeros and are masked or not written; the causal mask is start-aligned.
//
// The bf16 kernels first; the f32 ones after them. Two designs: the
// column groups below (bf16 flash_fwd_wide, dq_wide and dkv_wide_groups;
// f32 flash_fwd_wide_f32_groups, dq_wide_f32_groups, dkv_wide_f32_groups),
// and a row tile on a cluster of ceil(d / W) blocks that form the scores
// once (bf16 dkv_wide, the K3 section; f32 flash_fwd_wide_f32, dq_wide_f32
// and dkv_wide_f32, the section "f32 clusters"), up to CLUSTER_MAX blocks.
//
// Why a design of its own: every per-dim kernel keeps Q (K2: and dO; K3: K
// and V) resident at the whole head dim, in one block or by halves in the
// two blocks of a pair, and holds its output rows' D or D / 2 columns in
// registers: both grow with d. Past d 512 a warpgroup's share of the output
// would pass 256 columns (128 registers a thread), and a resident 64-row
// tile beside two K/V stages passes the 227 KB of shared memory a block may
// have. Here nothing a block holds grows with d:
// - a block owns a tile of rows (query rows in K1 and K2, keys in K3) and
//   one group of at most W output columns; ceil(d / W) groups, each its own
//   block, cover the head dim; d is a run-time argument and one launch
//   covers any d;
// - every score tile (S; K2's dP; K3's S^T and dP^T) is formed over the
//   whole head dim as a chain of wgmma m64nNk16 products, one 64-column
//   chunk of each operand at a time, the chunks brought by TMA through a
//   ring of shared-memory stages (a `full` mbarrier each: the chunks have
//   landed);
// - the block multiplies only against its own columns (V's in K1, K's in
//   K2, dO's and Q's in K3), a tile of W columns brought by one TMA box.
//   In the last group of a d that is no multiple of W the box reaches past
//   d, where TMA brings zeros, and those columns are not stored: every
//   block runs one instruction stream, with no branch around a wgmma
//   (ptxas serialises the wgmmas of a kernel that has one).
// The price is recomputation: each of the ceil(d / W) groups forms the same
// scores again (PERF.md states the factor at each d it times). Every group
// streams the chunks in one order, chunk 0 first, through the same
// instructions, so the groups' scores agree bit for bit: K1's groups reach
// the same m and l, and group 0 alone stores the LSE. The scale is d^-1/2
// of the whole head dim, as the caller passes it. Every output element
// belongs to one block and every sum runs in a fixed order, with no
// atomics: a rerun on the same input gives the same bits.
//
// A block is two warpgroups, 8 warps, so a thread may hold 255 registers
// (a producer warp beside them makes ptxas give every thread 168, and the
// accumulators spill). Per chunk step each warpgroup waits for its chunk's
// wgmmas, then a named barrier of both says the step is read. The stage is
// refilled during the next step, while its wgmmas run: the first thread
// of each warpgroup issues its share of the step's TMA copies, predicated
// inside the instruction (tma_4d_if), not behind a branch: the ring needs
// no `empty` barriers, and no thread branches beside a wgmma in flight
// (ptxas serialised every wgmma when thread 0 refilled the ring behind a
// branch with a wgmma in flight).
// In the wgmma window rather than after the named barrier, K2 is 1.5-3.7%
// faster at d 768 and 2048 on an H100 and K1 no slower (PERF.md §6).
// Keeping one chunk's wgmmas in flight while the next one's are issued
// made ptxas inject waits (C7517) and ran 3-6% slower, with the chunk loop
// unrolled twice, at d 768 on an H100 (PERF.md §6).
//
// What bounds it on an H100: the useful work is operations, 2 d flops per
// causal pair for each product (K1 2, K2 3, K3 4), hundreds of flops per
// byte of q, k, v and dO. The streamed design also reads each score tile's
// operands from L2 once per tile and group, tens of flops per byte: at d
// 768 the three load 7-8 TB/s from L2 (counted from their loads) and reach
// 0.10-0.16 of their bound (PERF.md §6). Yet K1's and K2's blocks wait on
// their chunks for a small share of their time: a step is a chain of four
// small wgmmas, a wait and a named barrier, and the chain, not L2, takes
// most of it. Reading each chunk once a row tile and multicasting it to
// the tile's groups on a cluster lost to these groups at every d (the
// cluster's placement leaves SMs idle, and freeing a stage across blocks
// costs every step), while K1's 128-key tiles (half the steps a key) took
// a third off K1 (PERF.md §6). A cluster of ceil(d / 256) blocks that add
// their partial scores through distributed shared memory reads each chunk
// and forms the scores once: K3's dkv_wide; it pays an exchange of 16 KB a
// 32-query stage a block instead (PERF.md §6 has the times of both
// designs).

#include "f32_tiles.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

using namespace hopper;
using namespace f32tile;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -2.0e38f;
constexpr int WG = 128;           // threads per warpgroup
constexpr int THREADS = 2 * WG;   // the two warpgroups
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (227 KB)
constexpr int ROW = 128;          // bytes of a 64-column chunk's row

// The output columns a block owns (W), per kernel: 256, one wgmma N a
// warpgroup (128 accumulator registers a thread). flash_wide_columns
// reports them; ops/flash_attention.py's WIDE_COLUMNS says the same.
constexpr int FWD_W = 256;
constexpr int DQ_W = 256;
constexpr int DKV_W = 256;

// The most blocks a cluster of the streamed kernels has, the portable
// cluster size: a row tile on a cluster of ceil(d / W) blocks (the f32 K1,
// K2 and K3, the bf16 K3) reaches d 8 W = 2048.
constexpr int CLUSTER_MAX = 8;

// S (64 x N) = A B^T over one 64-column chunk (four k steps of 16), or
// S += A B^T with `acc`: A (64 rows) and B (N rows), both K-major with the
// 128-byte swizzle, one TMA box of 64 columns each.
template <int N, int... KK>
__device__ __forceinline__ void chunk_ss_steps(
    float (&d)[N / 2], uint64_t da, uint64_t db, int acc,
    std::integer_sequence<int, KK...>) {
  (WgmmaSS<N, 2 * KK, 2 * KK>::run(d, da, db, KK > 0 || acc), ...);
}

template <int N>
__device__ __forceinline__ void chunk_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b, int acc) {
  chunk_ss_steps<N>(d, desc_sw128(a, 16, 1024), desc_sw128(b, 16, 1024), acc,
                    std::make_integer_sequence<int, 4>{});
}

// mbar_arrive_expect_tx and TMA loads (hopper::tma_load_4d, _5d) made by
// the threads where `p` holds, the predicate inside the instruction: the
// loads issued inside a score chain, where no thread may branch.
__device__ __forceinline__ void expect_tx_if(bool p, uint32_t bar,
                                             uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::
          "r"(bar),
      "r"(bytes), "r"(static_cast<int>(p))
      : "memory");
}

__device__ __forceinline__ void tma_4d_if(bool p, uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %7, 0;\n"
      "@q cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(static_cast<int>(p))
      : "memory");
}

__device__ __forceinline__ void tma_5d_if(bool p, uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %8, 0;\n"
      "@q cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n}\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4), "r"(static_cast<int>(p))
      : "memory");
}

// The blocks' order: heaviest row tiles first (`rev`: the last tile
// first), then for each tile its column groups side by side (they stream
// the same chunks from L2 at about the same time), then the heads (of a
// KV group, neighbours) and the batch, `heads` of them in all.
struct Block {
  int tile, grp, head;
  __device__ __forceinline__ Block(int tiles, int groups, int heads,
                                   bool rev) {
    const int x = static_cast<int>(blockIdx.x), per_tile = groups * heads;
    tile = rev ? tiles - 1 - x / per_tile : x / per_tile;
    grp = x % groups;
    head = x / groups % heads;
  }
};

// Store a 64-row accumulator of W columns (this thread's rows or keys r0
// and r1), times `scale`, as bf16 at columns col0 +
// 8j + 2 (t % 4) of `out` (element row stride `ss`), skipping rows at or
// past `rows` and columns at or past `d`.
template <int W>
__device__ __forceinline__ void store_group(bf16* out, int64_t ss,
                                            const float (&acc)[W / 2],
                                            float scale, int r0, int r1,
                                            int rows, int tq, int col0,
                                            int d) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tq;
    if (col >= d) continue;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(out + r0 * ss + col) =
          pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(out + r1 * ss + col) =
          pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// ------------------------------------------------------------ K1
//
// `flash_fwd_wide<W>`: a block owns 128 query rows (64 a warpgroup) of one
// (b, h) and columns [grp W, grp W + W) of O. Per key tile of 128 keys:
//   S = Q K^T   over the head dim, chunk by chunk (wgmma m64n128k16 x 4 a
//               chunk, Q's and K's chunks of the step from one stage);
//   the online softmax of flash_fwd_wgmma in f32 (exp2, log2 e folded into
//   the scale, the row max over a quad of lanes, the row sum reduced once,
//   at the end);
//   O[:, own] += P V[:, own]   P rounded to bf16 and re-packed in
//               registers as the A operand, V's W columns of the tile one
//               TMA box.
// Shared memory: STAGES steps of (a 128-row chunk of Q, a 128-key chunk
// of K) and one V tile of 128 keys x W columns, loaded at the tile's
// second step (past the last tile's P V). 128-key tiles halve the chunk
// steps, their waits and named barriers a key, and the shared-memory
// bytes the score wgmmas read a flop (m64n128 against m64n64): 0.41 ms
// against 0.61 at d 768 (PERF.md §6; S takes 64 registers, 250 in all, no
// spill). One V tile rather than two leaves room for 5 ring steps rather
// than 3: 8-11% faster.

struct FwdArgs {
  CUtensorMap tq, tk;  // 64-column chunks of 128 query rows, of BK keys
  CUtensorMap tv;      // a group's W columns of BK keys
  void* o;
  float* lse;
  int64_t o_sb, o_sh, o_ss;
  int h, hkv, batch, sq, sk, d, causal, nq, groups, chunks;
  float scale, scale_log2;
};

template <int W>
struct FwdWide {
  static constexpr int BQ = 128;  // query rows a block: 64 a warpgroup
  static constexpr int BK = 128;  // keys a tile
  static constexpr int Q_BYTES = BQ * ROW;  // a chunk of Q
  static constexpr int K_BYTES = BK * ROW;  // a chunk of K
  static constexpr int STEP = Q_BYTES + K_BYTES;
  static constexpr int V_CB = BK * ROW;  // V's column block stride
  static constexpr int V_BYTES = W / 64 * V_CB;
  static constexpr int V_STAGES = 1;
  static constexpr int FIT = (SMEM_MAX - 2048 - V_STAGES * V_BYTES) / STEP;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int V_OFF = STAGES * STEP;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * V_BYTES;
  // mbarriers: full[STAGES], v_full[V_STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + V_STAGES) + 1024;
  static_assert(W % 64 == 0 && W <= 256, "O: 256 columns a warpgroup");
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "227 KB a block");
};

// One online-softmax step on a score tile of BK keys from key k0 (this
// thread's rows row0 and row1; register 4j + e is key k0 + 8j + 2 tq +
// (e & 1)): with `mask`, keys past sk and (causal) after the row score
// -2e38; m (raw score units) and the partial row sums l move on, sc
// becomes P = exp2((S - m) scale log2 e), and alpha gets the factors that
// rescale O. The same arithmetic as flash_fwd.cu's fwd_softmax, whose
// text kernel_variants.py edits in place, on this file's FwdArgs.
template <int BK>
__device__ __forceinline__ void softmax(const FwdArgs& a, float (&sc)[BK / 2],
                                        float& m0, float& m1, float& l0,
                                        float& l1, float& alpha0,
                                        float& alpha1, bool mask, int k0,
                                        int row0, int row1, int tq) {
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

// An accumulator-shaped tile of N columns as bf16 A fragments, re-packed
// in registers: columns 16kk .. 16kk + 15 are fragment kk.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&f)[N / 16][4],
                                       const float (&v)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16x2(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1]);
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide(const __grid_constant__ FwdArgs a) {
  using L = FwdWide<W>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES,
                VS = L::V_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR_OFF, v_full = full + 8 * STAGES;

  const Block blk(a.nq, a.groups, a.h * a.batch, true);
  const int grp = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int nc = a.chunks, steps = nk * nc;
  const bool lead = threadIdx.x == 0;
  // a step's loads are split between the first threads of the two
  // warpgroups (`part` 0 and 1), each issuing in its own warpgroup's wgmma
  // window
  const int part = threadIdx.x / WG;
  const bool issuer = threadIdx.x % WG == 0;

  // step j (where p holds): chunk j % nc of the block's Q rows and of key
  // tile j / nc's keys
  auto load_step = [&](bool p, int j) {
    const int s = j % STAGES, col = j % nc * 64;
    const uint32_t dst = base + s * L::STEP, bar = full + 8 * s;
    const bool p0 = p && part == 0, p1 = p && part == 1;
    expect_tx_if(p0, bar, L::STEP);
    tma_4d_if(p0, dst, &a.tq, bar, col, q0, ih, ib);
    tma_4d_if(p1, dst + L::Q_BYTES, &a.tk, bar, col, j / nc * BK, ikv, ib);
  };
  // key tile i's W columns of V
  auto load_v = [&](bool p, int i) {
    const int s = i % VS;
    expect_tx_if(p, v_full + 8 * s, L::V_BYTES);
    tma_5d_if(p, base + L::V_OFF + s * L::V_BYTES, &a.tv, v_full + 8 * s, 0,
              i * BK, grp * (W / 64), ikv, ib);
  };

  if (lead) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    for (int s = 0; s < VS; ++s) mbar_init(v_full + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (issuer) {
    for (int j = 0; j < STAGES && j < steps; ++j) load_step(true, j);
    for (int i = 0; i < VS && i < nk; ++i) load_v(part == 1, i);
  }

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int k0 = i * BK;
    // S = Q K^T over the head dim: 64 rows x BK keys
    float sc[BK / 2];
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc) {
      const int j = i * nc + cc, s = j % STAGES;
      const uint32_t at = base + s * L::STEP;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      wgmma_fence();
      chunk_ss<BK>(sc, at + c * 64 * ROW, at + L::Q_BYTES, cc);
      wgmma_commit();
      // while they run: step j - 1's stage (both warpgroups read it before
      // the named barrier that ended step j - 1) takes step j - 1 + STAGES,
      // and past the last tile's P V in both (step j - 1's barrier at cc
      // 1), its V stage takes tile i + VS - 1
      load_step(issuer && j >= 1 && j - 1 + STAGES < steps, j - 1 + STAGES);
      load_v(issuer && part == 1 && cc == 1 && i >= 1 && i + VS - 1 < nk,
             i + VS - 1);
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other
    }
    fence_regs(sc);

    // mask only tiles that cross the diagonal or the ragged end
    float alpha0, alpha1;
    softmax<BK>(a, sc, m0, m1, l0, l1, alpha0, alpha1,
                (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.sk, k0, row0,
                row1, tq);
    uint32_t pf[BK / 16][4];
    pack_a<BK>(pf, sc);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O[:, own] += P V[:, own]
    const int sv = i % VS;
    mbar_wait(v_full + 8 * sv, (i / VS) & 1);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t_cols<W, BK / 16, L::V_CB>(o, pf,
                                         base + L::V_OFF + sv * L::V_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // the rows' end: the row sums reduced over the quad, O / l in bf16 and
  // (group 0) LSE = m scale + log l in f32
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    o[4 * j] /= l0;
    o[4 * j + 1] /= l0;
    o[4 * j + 2] /= l1;
    o[4 * j + 3] /= l1;
  }
  store_group<W>(static_cast<bf16*>(a.o) + ib * a.o_sb + ih * a.o_sh,
                 a.o_ss, o, 1.f, row0, row1, a.sq, tq, grp * W, a.d);
  if (grp == 0 && tq == 0) {
    float* lse = a.lse + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    if (row0 < a.sq) lse[row0] = m0 * a.scale + logf(l0);
    if (row1 < a.sq) lse[row1] = m1 * a.scale + logf(l1);
  }
}

// ------------------------------------------------------------ K2
//
// `dq_wide<W>`: a block owns 128 query rows (64 a warpgroup) of one
// (b, h) and columns [grp W, grp W + W) of dQ; each thread holds the lse
// (times log2 e) and delta of its two rows. Per key tile of 32 keys:
//   S = Q K^T and dP = dO V^T   over the head dim, chunk by chunk (wgmma
//       m64n32k16 x 4 each a chunk, one commit group a step);
//   P = exp2(S scale log2 e - lse log2 e) in f32 (masked only on the tiles
//       that cross the diagonal or the ragged end), dS = P (dP - delta),
//       rounded to bf16 and re-packed in registers as A fragments;
//   dQ[:, own] += dS K[:, own]  K's W columns of the tile one TMA box, read
//       MN-major, loaded at the tile's second step (past the last tile's
//       dS K).
// 32-key tiles keep S and dP at 16 registers each beside dQ's 128
// (dq_rows8<256>'s choice). dQ is scaled once, at the end. Shared memory:
// STAGES steps of (128-row chunks of Q and dO, 32-key chunks of K and V)
// and one tile of K's W columns: one tile rather than two leaves room for
// a fifth ring step, 4.5-6.5% faster at d 768 and 2048 (PERF.md §6).

struct DqArgs {
  CUtensorMap tq, tdo;  // 64-column chunks of 128 query rows
  CUtensorMap tk, tv;   // 64-column chunks of 32 keys
  CUtensorMap tkg;      // a group's W columns of 32 keys of K
  const float* lse;     // [b, h, sq] contiguous
  const float* delta;
  void* dq;
  int64_t dq_sb, dq_sh, dq_ss;
  int h, hkv, batch, sq, sk, d, causal, nq, groups, chunks;
  float scale, scale_log2;
};

template <int W>
struct DqWide {
  static constexpr int BQ = 128;  // query rows a block: 64 a warpgroup
  static constexpr int BK = 32;   // keys a tile
  static constexpr int Q_BYTES = BQ * ROW;  // a chunk of Q or dO
  static constexpr int K_BYTES = BK * ROW;  // a chunk of K or V
  static constexpr int DO_OFF = Q_BYTES;    // in a step
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + K_BYTES;
  static constexpr int STEP = 2 * Q_BYTES + 2 * K_BYTES;
  static constexpr int KG_CB = BK * ROW;  // K tile's column block stride
  static constexpr int KG_BYTES = W / 64 * KG_CB;
  static constexpr int KG_STAGES = 1;
  static constexpr int FIT =
      (SMEM_MAX - 2048 - KG_STAGES * KG_BYTES) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int KG_OFF = STAGES * STEP;
  static constexpr int BAR_OFF = KG_OFF + KG_STAGES * KG_BYTES;
  // mbarriers: full[STAGES], kg_full[KG_STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + KG_STAGES) + 1024;
  static_assert(W % 64 == 0 && W <= 256, "dQ: 256 columns a warpgroup");
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
dq_wide(const __grid_constant__ DqArgs a) {
  using L = DqWide<W>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES,
                KS = L::KG_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR_OFF, kg_full = full + 8 * STAGES;

  const Block blk(a.nq, a.groups, a.h * a.batch, true);
  const int grp = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ;
  // the same key tiles for both warpgroups: up to the diagonal of the
  // block's last row
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int nc = a.chunks, steps = nk * nc;
  const bool lead = threadIdx.x == 0;
  // a step's loads are split between the first threads of the two
  // warpgroups (`part` 0 and 1), each issuing in its own warpgroup's wgmma
  // window
  const int part = threadIdx.x / WG;
  const bool issuer = threadIdx.x % WG == 0;

  // step j (where p holds): chunk j % nc of the block's Q and dO rows and
  // of key tile j / nc's K and V
  auto load_step = [&](bool p, int j) {
    const int s = j % STAGES, col = j % nc * 64, k0 = j / nc * BK;
    const uint32_t dst = base + s * L::STEP, bar = full + 8 * s;
    const bool p0 = p && part == 0, p1 = p && part == 1;
    expect_tx_if(p0, bar, L::STEP);
    tma_4d_if(p0, dst, &a.tq, bar, col, q0, ih, ib);
    tma_4d_if(p1, dst + L::DO_OFF, &a.tdo, bar, col, q0, ih, ib);
    tma_4d_if(p0, dst + L::K_OFF, &a.tk, bar, col, k0, ikv, ib);
    tma_4d_if(p1, dst + L::V_OFF, &a.tv, bar, col, k0, ikv, ib);
  };
  // key tile i's W columns of K
  auto load_kg = [&](bool p, int i) {
    const int s = i % KS;
    expect_tx_if(p, kg_full + 8 * s, L::KG_BYTES);
    tma_5d_if(p, base + L::KG_OFF + s * L::KG_BYTES, &a.tkg,
              kg_full + 8 * s, 0, i * BK, grp * (W / 64), ikv, ib);
  };

  if (lead) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    for (int s = 0; s < KS; ++s) mbar_init(kg_full + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (issuer) {
    for (int j = 0; j < STAGES && j < steps; ++j) load_step(true, j);
    for (int i = 0; i < KS && i < nk; ++i) load_kg(part == 1, i);
  }

  const int c = threadIdx.x / WG;  // this warpgroup's 64 query rows
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + 16 * w + g, row1 = row0 + 8;

  // rows past sq read lse = delta = 0 (and Q = dO = 0): dS = 0 there, and
  // those rows are not written
  const int64_t rows = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  const float ls0 = row0 < a.sq ? a.lse[rows + row0] * kLog2e : 0.f;
  const float ls1 = row1 < a.sq ? a.lse[rows + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.sq ? a.delta[rows + row0] : 0.f;
  const float dl1 = row1 < a.sq ? a.delta[rows + row1] : 0.f;

  float dq[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dq[i] = 0.f;

#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int k0 = i * BK;
    // S = Q K^T and dP = dO V^T over the head dim: 64 rows x BK keys each
    float sc[BK / 2], dp[BK / 2];
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc) {
      const int j = i * nc + cc, s = j % STAGES;
      const uint32_t at = base + s * L::STEP;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      wgmma_fence();
      chunk_ss<BK>(sc, at + c * 64 * ROW, at + L::K_OFF, cc);
      chunk_ss<BK>(dp, at + L::DO_OFF + c * 64 * ROW, at + L::V_OFF, cc);
      wgmma_commit();
      // while they run: step j - 1's stage (both warpgroups read it before
      // the named barrier that ended step j - 1) takes step j - 1 + STAGES,
      // and past the last tile's dS K in both (step j - 1's barrier at cc
      // 1), its stage of K takes tile i + KS - 1
      load_step(issuer && j >= 1 && j - 1 + STAGES < steps, j - 1 + STAGES);
      load_kg(issuer && part == 1 && cc == 1 && i >= 1 && i + KS - 1 < nk,
              i + KS - 1);
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other
    }
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
    // dS in K's dtype, re-packed as the A operand
    uint32_t f[BK / 16][4];
    pack_a<BK>(f, sc);

    // dQ[:, own] += dS K[:, own]
    const int skg = i % KS;
    mbar_wait(kg_full + 8 * skg, (i / KS) & 1);
    fence_regs(dq);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<W, BK / 16, L::KG_CB>(
        dq, f, base + L::KG_OFF + skg * L::KG_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  store_group<W>(static_cast<bf16*>(a.dq) + ib * a.dq_sb + ih * a.dq_sh,
                 a.dq_ss, dq, a.scale, row0, row1, a.sq, tq, grp * W, a.d);
}

// ------------------------------------------------------------ K3
//
// `dkv_wide_groups<W>`: a block owns 64 keys of one (b, KV head) and
// columns [grp W, grp W + W) of dK and dV: warpgroup 0 holds dV, warpgroup 1 dK
// (dkv_onepass's split, 128 registers a thread each). It runs over stages
// of 64 query rows, each query head of the KV group from the diagonal on,
// in a fixed order. Per stage, one instruction stream for both warpgroups,
// the operands chosen by address (never a branch around a wgmma):
//   t = A B^T   over the head dim, chunk by chunk (wgmma m64n64k16 x 4 a
//               chunk): S^T = K Q^T on warpgroup 0, dP^T = V dO^T on
//               warpgroup 1 (the four chunks of a step from one stage);
//   P^T = exp2(t scale log2 e - lse log2 e), masked, rounded to bf16, by
//       warpgroup 0 into a double-buffered exchange buffer in fragment
//       order (one named barrier a stage);
//   f = P^T (warpgroup 0), or dS^T = P^T (dP^T - delta) rounded to bf16
//       (warpgroup 1, reading P^T from the buffer);
//   acc += f Y   Y the stage's W columns of dO (warpgroup 0) or of Q
//               (warpgroup 1), one TMA box each, read MN-major.
// Each thread loads the lse (warpgroup 0) or delta (warpgroup 1) of its
// columns of the stage's queries from global memory before the stage's
// chain (rows past sq: 0, and masked). dK is scaled once, at the end.
// Shared memory: STAGES steps of (64-key chunks of K and V, 64-row chunks
// of Q and dO), one stage's W columns of Q and dO, the exchange buffers.

struct DkvArgs {
  CUtensorMap tk, tv;     // 64-column chunks of 64 keys
  CUtensorMap tq, tdo;    // 64-column chunks of 64 query rows
  CUtensorMap tqg, tdog;  // a group's W columns of the stage's query rows
  CUtensorMap tkg, tvg;   // dkv_wide: a block's W columns of 64 keys
  const float* lse;       // [b, h, sq] contiguous
  const float* delta;
  void* dk;
  void* dv;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int h, hkv, batch, sq, sk, d, causal, nk, groups, chunks;
  float scale, scale_log2;
};

template <int W>
struct DkvWideGroups {
  static constexpr int BK = 64;  // keys a block
  static constexpr int BQ = 64;  // query rows a stage
  static constexpr int CH = 64 * ROW;  // a chunk of K, V, Q or dO
  static constexpr int STEP = 4 * CH;  // K, V, Q, dO
  static constexpr int G_CB = BQ * ROW;  // Q's and dO's column block stride
  static constexpr int G_BYTES = W / 64 * G_CB;  // W columns of Q or dO
  static constexpr int XCH = BQ / 4 * WG;  // 32-bit words an exchange buffer
  static constexpr int FIT =
      (SMEM_MAX - 2048 - 2 * G_BYTES - 2 * XCH * 4) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int G_OFF = STAGES * STEP;  // Q's columns, then dO's
  static constexpr int X_OFF = G_OFF + 2 * G_BYTES;
  static constexpr int BAR_OFF = X_OFF + 2 * XCH * 4;
  // mbarriers: full[STAGES], g_full
  static constexpr int BYTES = BAR_OFF + 8 * (STAGES + 1) + 1024;
  static_assert(W % 64 == 0 && W <= 256, "dK, dV: 256 columns a warpgroup");
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
dkv_wide_groups(const __grid_constant__ DkvArgs a) {
  using L = DkvWideGroups<W>;
  constexpr int BK = L::BK, BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + L::X_OFF);
  const uint32_t full = base + L::BAR_OFF, g_full = full + 8 * STAGES;

  // heaviest key tiles (the first, under causal masking) first
  const Block blk(a.nk, a.groups, a.hkv * a.batch, false);
  const int grp = blk.grp, ikv = blk.head % a.hkv, ib = blk.head / a.hkv;
  const int k0 = blk.tile * BK;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int nqt = nq - iq0;
  const int group = a.h / a.hkv;
  const int tiles = group * nqt;  // stages: each query head, each tile
  const int nc = a.chunks, steps = tiles * nc;
  const bool lead = threadIdx.x == 0;

  // step j (where p holds): chunk j % nc of the block's K and V and of
  // stage j / nc's Q and dO rows
  auto load_step = [&](bool p, int j) {
    const int s = j % STAGES, col = j % nc * 64, n = j / nc;
    const int ih = ikv * group + n / nqt, q0 = (iq0 + n % nqt) * BQ;
    const uint32_t dst = base + s * L::STEP, bar = full + 8 * s;
    expect_tx_if(p, bar, L::STEP);
    tma_4d_if(p, dst, &a.tk, bar, col, k0, ikv, ib);
    tma_4d_if(p, dst + L::CH, &a.tv, bar, col, k0, ikv, ib);
    tma_4d_if(p, dst + 2 * L::CH, &a.tq, bar, col, q0, ih, ib);
    tma_4d_if(p, dst + 3 * L::CH, &a.tdo, bar, col, q0, ih, ib);
  };
  // stage n's W columns of Q and dO
  auto load_g = [&](bool p, int n) {
    const int ih = ikv * group + n / nqt, q0 = (iq0 + n % nqt) * BQ;
    expect_tx_if(p, g_full, 2 * L::G_BYTES);
    tma_5d_if(p, base + L::G_OFF, &a.tqg, g_full, 0, q0, grp * (W / 64), ih,
              ib);
    tma_5d_if(p, base + L::G_OFF + L::G_BYTES, &a.tdog, g_full, 0, q0,
              grp * (W / 64), ih, ib);
  };

  if (lead) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    mbar_init(g_full, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (lead) {
    for (int j = 0; j < STAGES && j < steps; ++j) load_step(true, j);
    load_g(true, 0);
  }

  const int c = threadIdx.x / WG;  // 0: dV, 1: dK
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int key0 = k0 + 16 * w + g, key1 = key0 + 8;
  // this warpgroup's operands, by address: the score product's A (K or V)
  // and B (Q or dO) in a step, and the accumulated product's B (the
  // stage's columns of dO or of Q)
  const uint32_t a_off = c * L::CH, b_off = (2 + c) * L::CH;
  const uint32_t y_addr = base + L::G_OFF + (1 - c) * L::G_BYTES;
  const float* xs = c == 0 ? a.lse : a.delta;
  float acc[W / 2];
#pragma unroll
  for (int r = 0; r < W / 2; ++r) acc[r] = 0.f;

#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int ih = ikv * group + n / nqt, q0 = (iq0 + n % nqt) * BQ;
    // the lse (warpgroup 0) or delta (warpgroup 1) of this thread's
    // queries q0 + 8j + 2 tq and the next
    const float* xr = xs + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    float2 x[BQ / 8];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int q = q0 + 8 * j + 2 * tq;
      x[j].x = q < a.sq ? xr[q] : 0.f;
      x[j].y = q + 1 < a.sq ? xr[q + 1] : 0.f;
    }

    // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x BQ queries
    float st[BQ / 2];
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc) {
      const int j = n * nc + cc, s = j % STAGES;
      const uint32_t at = base + s * L::STEP;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      wgmma_fence();
      chunk_ss<BQ>(st, at + a_off, at + b_off, cc);
      wgmma_commit();
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other: its stage takes
      load_step(lead && j + STAGES < steps, j + STAGES);
      // past the last stage's product in both: Q's and dO's columns of
      // this one
      load_g(lead && cc == 0 && n >= 1, n);
    }
    fence_regs(st);

    // P^T in bf16, from warpgroup 0's S^T, through the buffer: the register
    // pair r of the A fragments is word r * 128 + t. Warpgroup 1's
    // arithmetic here (on dP^T and delta) is discarded.
    const bool need_mask = (a.causal && q0 < k0 + BK) || q0 + BQ > a.sq;
    uint32_t* buf = xbuf + (n & 1) * L::XCH;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xl = (e & 1) ? x[j].y : x[j].x;
        p[e] = fast_exp2(fmaf(st[4 * j + e], a.scale_log2, -xl * kLog2e));
        if (need_mask) {
          const int query = q0 + 8 * j + 2 * tq + (e & 1);
          const int key = e < 2 ? key0 : key1;
          if (query >= a.sq || (a.causal && key > query)) p[e] = 0.f;
        }
      }
      if (c == 0) {
        buf[(2 * j) * WG + t] = pack_bf16x2(p[0], p[1]);
        buf[(2 * j + 1) * WG + t] = pack_bf16x2(p[2], p[3]);
      }
    }
    bar_sync(1, THREADS);

    // f = P^T (warpgroup 0) or dS^T = P^T (dP^T - delta), P rounded to
    // bf16 first and dS by the packing (warpgroup 1)
    uint32_t f[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t pk = buf[(2 * j + hh) * WG + t];
        const float p0 = __uint_as_float(pk << 16);
        const float p1 = __uint_as_float(pk & 0xffff0000u);
        const uint32_t ds =
            pack_bf16x2(p0 * (st[4 * j + 2 * hh] - x[j].x),
                        p1 * (st[4 * j + 2 * hh + 1] - x[j].y));
        f[j / 2][2 * (j % 2) + hh] = c == 0 ? pk : ds;
      }

    // dV[:, own] += P^T dO[:, own] (warpgroup 0) or dK[:, own] += dS^T
    // Q[:, own] (warpgroup 1)
    mbar_wait(g_full, n & 1);
    fence_regs(acc);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<W, BQ / 16, L::G_CB>(acc, f, y_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  bf16* out = static_cast<bf16*>(c == 0 ? a.dv : a.dk) +
              ib * (c == 0 ? a.dv_sb : a.dk_sb) +
              ikv * (c == 0 ? a.dv_sh : a.dk_sh);
  const float scale = c == 0 ? 1.f : a.scale;
  store_group<W>(out, c == 0 ? a.dv_ss : a.dk_ss, acc, scale, key0, key1,
                 a.sk, tq, grp * W, a.d);
}

// `dkv_wide<W>`: K3 on a cluster of n = ceil(d / W) blocks (launched by
// hopper::launch_cluster, the n column groups of a key tile as consecutive
// blocks; Block's `grp` is the cluster rank), dkv_pair's layout (csrc/
// flash_bwd.cu) from a pair to n blocks. A cluster owns 64 keys of one (b,
// KV head); the block of rank r holds columns [r W, min(r W + W, d)) of K,
// V, Q, dO, dK and dV: its K and V columns resident, one TMA box each, and
// per stage of BQ query rows its Q and dO columns, one box each, in a ring.
// Per stage, dkv_wide_groups's split and instruction stream, on the
// block's columns only:
//   t = A B^T   over the block's W columns (wgmma m64nBQk16 x W / 16): the
//               partial S^T = K Q^T on warpgroup 0, dP^T = V dO^T on
//               warpgroup 1;
//   ClusterSum (hopper.cuh) adds the n partials of both warpgroups' 256
//               threads in rank order, rank 0 first, so every block holds
//               the same S^T and dP^T bit for bit;
//   P^T, f = P^T or dS^T as dkv_wide_groups (bf16 rounding in the same
//               places; P^T through a buffer of its own, never a
//               ClusterSum buffer);
//   acc += f Y  Y the stage's dO (warpgroup 0) or Q (warpgroup 1) columns,
//               the chunks its scores read, read MN-major: no second load.
// The exchange is two hops between the cluster's SMs a stage (the
// partials to their owners, the sums back), longer than the stage's
// products, so two stages' exchanges overlap, on two ClusterSums (stage m
// takes instance m & 1): stage n + 1's scores and the last stage's product
// are issued together, and stage n + 1's partials scattered, before stage
// n's sums are gathered and collected. Every read of a ClusterSum buffer
// still comes before this block's next store into the same instance:
// stage n's sums feed P^T and f before stage n + 2's partials are sent,
// one loop turn later. The last stage's Q and dO are refilled once both
// warpgroups have waited for its product, before the exchange, a loop turn
// ahead of their use (waiting for that product after the exchange, so that
// it ran through it, left the refill half a turn and was slower:
// kernel_variants.py's dkv_wide_product_in_flight); the first turn's
// product takes f = 0 (it adds zeros: no branch around a wgmma), the last
// turn's scores form their own stage again, unused. Recompute 1.0: every score is formed
// once, over each block's own columns. A block narrower than W (the last
// at d 704) multiplies the zeros TMA brings past d, in both products
// (exact: they add zeros), and does not store them; where it would hold
// only 64 or 128 columns the port runs the column groups (wide_design). Stages of 32
// query rows: 64 KB of resident K and V, three 32 KB stages, two
// ClusterSum<4>s of 30 KB and a 4 KB P^T buffer fit (64-row stages: 64 KB a
// stage and ClusterSum<8>'s 60 KB leave room for one).
template <int W>
struct DkvWide {
  static constexpr int BK = 64;  // keys a cluster
  static constexpr int BQ = 32;  // query rows a stage
  using X = ClusterSum<BQ / 8, CLUSTER_MAX>;  // S^T or dP^T, BQ / 2 a thread
  static constexpr int KV_CB = BK * ROW;  // K's and V's column block stride
  static constexpr int KV_BYTES = W / 64 * KV_CB;
  static constexpr int G_CB = BQ * ROW;  // Q's and dO's column block stride
  static constexpr int G_BYTES = W / 64 * G_CB;
  static constexpr int STEP = 2 * G_BYTES;  // Q, dO
  static constexpr int XCH = BQ / 4 * WG;   // 32-bit words of P^T
  static constexpr int FIXED = 2 * KV_BYTES + 2 * X::BYTES + XCH * 4 +
                               8 * (1 + 6 + 2 * X::BARS) + 1024;
  static constexpr int FIT = (SMEM_MAX - FIXED) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int Q_OFF = 2 * KV_BYTES;  // K, V, then the stages
  static constexpr int XCH_OFF = Q_OFF + STAGES * STEP;  // two ClusterSums
  static constexpr int P_OFF = XCH_OFF + 2 * X::BYTES;
  static constexpr int BAR_OFF = P_OFF + XCH * 4;
  // mbarriers: kv_full, full[STAGES], then the two ClusterSums'
  static constexpr int BYTES =
      BAR_OFF + 8 * (1 + STAGES + 2 * X::BARS) + 1024;
  static_assert(W % 64 == 0 && W <= 256, "dK, dV: 256 columns a warpgroup");
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
dkv_wide(const __grid_constant__ DkvArgs a) {
  using L = DkvWide<W>;
  constexpr int BK = L::BK, BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + L::P_OFF);
  const uint32_t kv_full = base + L::BAR_OFF, full = kv_full + 8;
  const uint32_t xbar = full + 8 * STAGES;

  // heaviest key tiles (the first, under causal masking) first
  const Block blk(a.nk, a.groups, a.hkv * a.batch, false);
  const int rank = blk.grp, ikv = blk.head % a.hkv, ib = blk.head / a.hkv;
  const int k0 = blk.tile * BK, cb0 = rank * (W / 64);
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int nqt = nq - iq0;
  const int group = a.h / a.hkv;
  const int tiles = group * nqt;  // stages: each query head, each tile
  const bool lead = threadIdx.x == 0;

  // stage n's Q and dO columns (where p holds)
  auto load_stage = [&](bool p, int n) {
    const int s = n % STAGES, ih = ikv * group + n / nqt;
    const int q0 = (iq0 + n % nqt) * BQ;
    const uint32_t dst = base + L::Q_OFF + s * L::STEP, bar = full + 8 * s;
    expect_tx_if(p, bar, L::STEP);
    tma_5d_if(p, dst, &a.tqg, bar, 0, q0, cb0, ih, ib);
    tma_5d_if(p, dst + L::G_BYTES, &a.tdog, bar, 0, q0, cb0, ih, ib);
  };

  if (lead) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    L::X::init(xbar, a.groups, rank);
    L::X::init(xbar + 8 * L::X::BARS, a.groups, rank);
    fence_mbar_init();
  }
  L::X::begin();
  if (lead) {
    mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
    tma_load_5d(base, &a.tkg, kv_full, 0, k0, cb0, ikv, ib);
    tma_load_5d(base + L::KV_BYTES, &a.tvg, kv_full, 0, k0, cb0, ikv, ib);
    for (int n = 0; n < STAGES && n < tiles; ++n) load_stage(true, n);
  }

  const int c = threadIdx.x / WG;  // 0: dV, 1: dK
  const int t = threadIdx.x % WG, w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int key0 = k0 + 16 * w + g, key1 = key0 + 8;
  // this warpgroup's operands, by address: the score product's A (K or V)
  // and B (Q or dO in a stage), and the accumulated product's B (dO or Q)
  const uint32_t a_addr = base + c * L::KV_BYTES;
  const uint32_t b_off = c * L::G_BYTES, y_off = (1 - c) * L::G_BYTES;
  const float* xs = c == 0 ? a.lse : a.delta;
  float acc[W / 2];
#pragma unroll
  for (int r = 0; r < W / 2; ++r) acc[r] = 0.f;
  // the last stage's P^T or dS^T, its product's A (zeros before the first)
  uint32_t f[BQ / 16][4] = {};

  // stage m's side of the exchange, ClusterSum instance m & 1, built where
  // it is used: its indices and addresses hoisted out of the loop held
  // registers beside the 128 of acc, and ptxas spilled
  auto xc = [&](int m) {
    const uint32_t off = (m & 1) * L::X::BYTES;
    return typename L::X(base + L::XCH_OFF + off, smem + L::XCH_OFF + off,
                         xbar + (m & 1) * 8 * L::X::BARS, a.groups, rank,
                         threadIdx.x);
  };
  // this block's partial S^T (warpgroup 0) or dP^T (warpgroup 1) of stage
  // n over its W columns, issued (one unrolled chain: a chain over a
  // run-time count of chunks made ptxas serialise the wgmmas, C7511)
  auto scores = [&](float (&st)[BQ / 2], int n) {
    const int s = n % STAGES;
    mbar_wait(full + 8 * s, (n / STAGES) & 1);
    wgmma_fence();
    wgmma_ss<BQ, W / 16, L::KV_CB, L::G_CB>(
        st, desc_sw128(a_addr, 16, 1024),
        desc_sw128(base + L::Q_OFF + s * L::STEP + b_off, 16, 1024));
    wgmma_commit();
  };
  // dV[:, own] += P^T dO[:, own] (warpgroup 0) or dK[:, own] += dS^T
  // Q[:, own] (warpgroup 1) of stage n, issued
  auto product = [&](int n) {
    fence_regs(acc);
    fence_regs(f);
    wgmma_fence();
    wgmma_rs_t_cols<W, BQ / 16, L::G_CB>(
        acc, f, base + L::Q_OFF + (n % STAGES) * L::STEP + y_off);
    wgmma_commit();
  };

  mbar_wait(kv_full, 0);
  // stage n's partials, then its sums; stage n + 1's partials
  float st[BQ / 2], sn[BQ / 2];
  scores(st, 0);
  wgmma_wait<0>();
  fence_regs(st);
  xc(0).scatter(st);
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int ih = ikv * group + n / nqt, q0 = (iq0 + n % nqt) * BQ;
    const bool next = n + 1 < tiles;
    // stage n + 1's partials, and the last stage's product, issued
    scores(sn, next ? n + 1 : n);
    product(n > 0 ? n - 1 : 0);
    // the lse (warpgroup 0) or delta (warpgroup 1) of this thread's
    // queries q0 + 8j + 2 tq and the next
    const float* xr = xs + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    float2 x[BQ / 8];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int q = q0 + 8 * j + 2 * tq;
      x[j].x = q < a.sq ? xr[q] : 0.f;
      x[j].y = q + 1 < a.sq ? xr[q + 1] : 0.f;
    }
    wgmma_wait<0>();  // the scores and the last stage's product
    fence_regs(sn);
    fence_regs(acc);
    // both warpgroups are past that product (its stage is free) and past
    // their reads of the last P^T: thread 0 refills the stage, a whole loop
    // turn ahead of its scores
    bar_sync(2, THREADS);
    load_stage(lead && n >= 1 && n - 1 + STAGES < tiles, n - 1 + STAGES);
    if (next) xc(n + 1).scatter(sn);
    // stage n's sums
    {
      const auto x_n = xc(n);
      x_n.gather(st, (n >> 1) & 1, n + 2 < tiles);
      x_n.collect(st, (n >> 1) & 1, n + 2 < tiles);
    }

    // P^T in bf16, from warpgroup 0's S^T, through the buffer: the register
    // pair r of the A fragments is word r * 128 + t. Warpgroup 1's
    // arithmetic here (on dP^T and delta) is discarded.
    const bool need_mask = (a.causal && q0 < k0 + BK) || q0 + BQ > a.sq;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xl = (e & 1) ? x[j].y : x[j].x;
        p[e] = fast_exp2(fmaf(st[4 * j + e], a.scale_log2, -xl * kLog2e));
        if (need_mask) {
          const int query = q0 + 8 * j + 2 * tq + (e & 1);
          const int key = e < 2 ? key0 : key1;
          if (query >= a.sq || (a.causal && key > query)) p[e] = 0.f;
        }
      }
      if (c == 0) {
        pbuf[(2 * j) * WG + t] = pack_bf16x2(p[0], p[1]);
        pbuf[(2 * j + 1) * WG + t] = pack_bf16x2(p[2], p[3]);
      }
    }
    bar_sync(1, THREADS);

    // f = P^T (warpgroup 0) or dS^T = P^T (dP^T - delta), P rounded to
    // bf16 first and dS by the packing (warpgroup 1)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t pk = pbuf[(2 * j + hh) * WG + t];
        const float p0 = __uint_as_float(pk << 16);
        const float p1 = __uint_as_float(pk & 0xffff0000u);
        const uint32_t ds =
            pack_bf16x2(p0 * (st[4 * j + 2 * hh] - x[j].x),
                        p1 * (st[4 * j + 2 * hh + 1] - x[j].y));
        f[j / 2][2 * (j % 2) + hh] = c == 0 ? pk : ds;
      }
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) st[r] = sn[r];
  }
  product(tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  bf16* out = static_cast<bf16*>(c == 0 ? a.dv : a.dk) +
              ib * (c == 0 ? a.dv_sb : a.dk_sb) +
              ikv * (c == 0 ? a.dv_sh : a.dk_sh);
  const float scale = c == 0 ? 1.f : a.scale;
  L::X::end([&] {
    store_group<W>(out, c == 0 ? a.dv_ss : a.dk_ss, acc, scale, key0, key1,
                   a.sk, tq, rank * W, a.d);
  });
}

// ------------------------------------------------------------ f32
//
// float32 inputs run on the CUDA cores in true f32 FMA (no TF32, no tensor
// cores), as csrc/flash_fwd.cu's flash_fwd_f32 and csrc/flash_bwd.cu's
// dq_f32 and dkv_f32 do at the head dims they are built for, from the
// register-tiled pieces of csrc/f32_tiles.cuh. Two designs (F32Design; the
// C function flash_wide_f32_design reports the one a build runs):
//   kF32Tiled    flash_fwd_wide_f32_groups, dq_wide_f32_groups,
//                dkv_wide_f32_groups: this file's bf16 layout, one block a
//                group of W output columns, each forming the scores over
//                the whole head dim;
//   kF32Cluster  flash_fwd_wide_f32, dq_wide_f32, dkv_wide_f32: a row tile
//                on a cluster of ceil(d / W) blocks, each holding W
//                columns of the head dim, the partial scores summed through
//                distributed shared memory (hopper::ClusterSum), so that
//                they are formed once.
// K1, K2 and K3 run kF32Cluster up to d CLUSTER_MAX W = 2048 (a portable
// cluster of at most 8 blocks) and kF32Tiled above it, a route chosen by
// the head dim, not a fallback; a build with -DFLASH_OTHER_DESIGNS=1 runs
// kF32Tiled at every d, so that chip_smoke.py times both in turns.
//
// What both share:
// - a block owns a tile of rows (K1, K2: query rows; K3: keys) and one
//   group of W output columns (FWD_W_F32, DQ_W_F32, DKV_W_F32); d is a
//   run-time argument;
// - the score operands stream in chunks of F32_C = 32 columns (row pitch
//   F32_C + 4 floats) through a ring of ST cp.async stages, one commit group
//   a chunk step (f32_next_stage); each thread's scores are register-tiled
//   as in the per-dim kernel (f32_dots, the chain carried on chunk by
//   chunk in column order), rows and keys past s loading as zeros;
// - softmax, P and dS take the per-dim kernels' arithmetic in the same
//   order (flash_fwd_f32: the scale and log2 e folded into exp2, masked
//   scores P = 0 by a select, O rescaled by alpha, l summed over the row's
//   half-warp at the end; dq_f32 and dkv_f32: P = exp2(S scale log2 e - lse
//   log2 e), dS = P (dP - delta)), masked scores -2e38, through shared
//   memory once as in them;
// - every output element belongs to one block and every sum runs in a
//   fixed order, with no atomics: a rerun gives the same bits, and K3 sums
//   its KV group's query heads in a fixed order. Neither splits a row tile
//   over a workspace as the per-dim f32 kernels do: flash_wide_workspace is
//   0 bytes.
// kF32Tiled: every score tile (K1 S; K2 S and dP; K3 S^T on warps 0-3 and
// dP^T on warps 4-7, split as in dkv_f32) is formed over the whole head dim
// in every group, the same instructions on the same chunks in the same
// order, so the groups agree bit for bit (K1's reach the same m and l, and
// group 0 alone stores the LSE); the row operand of the output product (V
// in K1, K in K2, dO and Q in K3) is the block's own W columns of the tile,
// brought by the ring's step ST - 1 of the tile into one buffer (the tile
// before has finished its product at the barrier of the step that issues
// it), zero-filled past d (f32_rows_async's `cols`), and the last group of
// a d that is no multiple of W multiplies those zeros and does not store
// them. The price is recomputation: each group forms the same scores, so
// the work is recompute(d) times the function's, 2.0 (K1, K3) and 2.33 (K2)
// at d 768, 4.5 and 5.67 at d 2048.
// kF32Cluster: the block of rank r of a cluster streams only its own
// chunks, columns [r W, min(r W + W, d)), of both score operands and forms
// partial scores over them; ClusterSum adds the cluster's partials in rank
// order, rank 0 first, once, and every block takes the same sums; each
// block then multiplies against its own columns of the row operand, which
// are the chunks it streamed (K1's V streams beside Q and K): each chunk is
// copied from its stage into a buffer of the tile's W columns as it is
// used, so each chunk of each operand is read from L2 once a tile, and a
// block narrower than W forms only its own columns (f32_outer's LIMIT).
// Recompute 1.0 at every d.
//
// What bounds them on an H100: the f32 FMA rate (67 TF/s), not L2 as in
// bf16 (per 4 columns a thread's 8 float4 loads from shared memory feed 64
// FMAs in K1's scores): kF32Tiled pays for every score it recomputes;
// kF32Cluster pays for the exchange instead, 8 KB of partials a K1 tile, 16
// KB a K2 tile and 8 KB a K3 item, hidden behind half of the last tile's
// output product each way (PERF.md §6 states the times, the share of bound
// and the factor at each dim it measures).

constexpr int F32_C = 32;           // columns a chunk
constexpr int F32_CP = F32_C + 4;   // a chunk's row pitch, floats
constexpr int F32_MAX_ST = 4;       // ring stages, at most
constexpr int F32_MIN_D = F32_MAX_ST * F32_C;  // a tile has >= ST steps

// The output columns a block owns in f32 (W): flash_wide_columns reports
// them beside the bf16 ones; ops/flash_attention.py's WIDE_COLUMNS says
// the same. 256, as in bf16: at 512 (recompute 1.67x at d 768 against
// 2.0x) all three kF32Tiled kernels reach 255 registers and spill, and run
// slower at d 768 (kernel_variants.py's `*_w512` variants; PERF.md §6 has
// the times, on an NVIDIA H100 80GB HBM3 at 700 W). In kF32Cluster it is a
// block's share of the head dim, so a cluster has ceil(d / W) blocks.
constexpr int FWD_W_F32 = 256;
constexpr int DQ_W_F32 = 256;
constexpr int DKV_W_F32 = 256;

// The f32 designs (the notes above).
enum F32Design { kF32Tiled = 1, kF32Cluster = 2 };

#ifndef FLASH_OTHER_DESIGNS
#define FLASH_OTHER_DESIGNS 0
#endif
// The design f32 K1 (`kernel` 0), K2 (1) or K3 (2) runs at head dim d:
// kF32Cluster while ceil(d / W) blocks make a portable cluster, kF32Tiled
// above (and at every d in the other build), the same rule for all three.
constexpr int f32_design(int kernel, int d) {
  return FLASH_OTHER_DESIGNS ||
                 (d + DQ_W_F32 - 1) / DQ_W_F32 > CLUSTER_MAX
             ? kF32Tiled
             : kF32Cluster;
}
static_assert(FWD_W_F32 == DQ_W_F32 && DQ_W_F32 == DKV_W_F32,
              "one cluster rule for K1, K2 and K3");

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // K2, K3
  const float* lse;    // K2, K3: [b, h, sq] contiguous
  const float* delta;  // K2, K3
  float* o;            // K1 O, K2 dQ, K3 dK
  float* o2;           // K3 dV
  float* lse_out;      // K1
  // element strides (batch, head, seq) of q, k, v, dO, o and o2
  int64_t q_s[3], k_s[3], v_s[3], do_s[3], o_s[3], o2_s[3];
  int h, hkv, batch, sq, sk, d, causal, tiles, groups, chunks;
  float scale, scale_log2;
};

// (b, head) ib, ih's rows of a [b, heads, s, d] tensor with strides s
template <typename T>
__device__ __forceinline__ T* f32_head(T* p, const int64_t (&s)[3], int ib,
                                       int ih) {
  return p + ib * s[0] + ih * s[1];
}

// The ring's step j brings the group of columns of tile (or item) g / nc
// where g = j - (ST - 1) is a tile's first step (g % nc == 0): its tile's
// step ST - 1.
template <int ST>
__device__ __forceinline__ bool group_step(int j, int nc, int& tile) {
  const int g = j - (ST - 1);
  tile = g / nc;
  return g >= 0 && g % nc == 0;
}

// `flash_fwd_wide_f32_groups<W>` (kF32Tiled's K1): a block owns 64 query
// rows of one (b, h) and columns [grp W, grp W + W) of O; key tiles of 64.
// flash_fwd_f32's thread grid: a query row's 16 threads are one half-warp
// (row max and sum by shuffles), 4 x 4 scores and 4 rows x W / 16 columns
// of O a thread. Shared memory: ST steps of (a chunk of Q's 64 rows, of the
// tile's 64 keys of K), the tile's W columns of V, P^T.
template <int W>
struct FwdWideF32Groups {
  static constexpr int BQ = 64, BK = 64;  // query rows a block, keys a tile
  static constexpr int CT = 16, RT = F32_THREADS / CT;
  static constexpr int SR = BQ / RT, SC = BK / CT;
  static constexpr int STEP = (BQ + BK) * F32_CP;  // floats
  static constexpr int VP = W + 4;                 // V's columns, [BK][VP]
  static constexpr int XP = BQ + 4;                // P^T, [BK][XP]
  static constexpr int FIT = (SMEM_MAX / 4 - BK * VP - BK * XP) / STEP;
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  static constexpr int V_OFF = ST * STEP, X_OFF = V_OFF + BK * VP;
  static constexpr int BYTES = (X_OFF + BK * XP) * 4;
  static_assert(W % 64 == 0 && SR * RT == BQ && SC * CT == BK, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_fwd_wide_f32_groups(const __grid_constant__ F32Args a) {
  using L = FwdWideF32Groups<W>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int CT = L::CT, RT = L::RT, XP = L::XP, C = F32_C, CP = F32_CP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Vs = sm + L::V_OFF;
  float* Xs = sm + L::X_OFF;

  const Block blk(a.tiles, a.groups, a.h * a.batch, true);
  const int grp = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ, col0 = grp * W;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int nc = a.chunks, steps = nk * nc;
  const int tid = threadIdx.x, gr = tid / CT, gc = tid % CT;
  const float* q = f32_head(a.q, a.q_s, ib, ih);
  const float* k = f32_head(a.k, a.k_s, ib, ikv);
  const float* v = f32_head(a.v, a.v_s, ib, ikv) + col0;

  // step j: chunk j % nc of the block's Q rows and of key tile j / nc;
  // at a tile's step ST - 1 also the tile's W columns of V
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C;
    f32_rows_async<C, BQ, CP>(s, q + c0, a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BK, CP>(s + BQ * CP, k + c0, a.k_s[2], j / nc * BK,
                              a.sk, tid);
    int t;
    if (group_step<ST>(j, nc, t))
      f32_rows_async<W, BK>(Vs, v, a.v_s[2], t * BK, a.sk, tid, a.d - col0);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }

  float o[SR][W / CT];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int c = 0; c < W / CT; ++c) o[i][c] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) m[i] = kNegInf, l[i] = 0.f;

#pragma unroll 1
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // S = Q K^T over the head dim, chunk by chunk
    float s[1][SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[0][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = ik * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* Qs = sm + j % ST * L::STEP;
      f32_dots<C, SR, SC, RT, CT, 1, CP, true>(s, {Qs}, {Qs + BQ * CP}, gr,
                                               gc);
    }

    // mask only tiles that cross the diagonal or the ragged end
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk;
    float alpha[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = q0 + gr + RT * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + gc + CT * j;
        if (need_mask && (col >= a.sk || (a.causal && col > row)))
          s[0][i][j] = kNegInf;
        mx = fmaxf(mx, s[0][i][j]);
      }
#pragma unroll
      for (int off = CT / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = fast_exp2((m[i] - mx) * a.scale_log2);
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
                    : fast_exp2(fmaf(x, a.scale_log2, -m[i] * a.scale_log2));
        l[i] += pr[i];
      }
      f32_xstore<SR>(Xs + (gc + CT * j) * XP + SR * gr, pr);
    }
    __syncthreads();  // P^T is in (V came with the tile's step ST - 1)

    // O[:, own] = alpha O[:, own] + P V[:, own]
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int c = 0; c < W / CT; ++c) o[i][c] *= alpha[i];
    f32_outer<W, SR, BK, XP, CT>(o, Xs, Vs, SR * gr, gc);
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  // the row sums over the row's lanes; O / l and (group 0) LSE = m scale +
  // log l
  float* out = f32_head(a.o, a.o_s, ib, ih);
  float* lse = a.lse_out + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int off = CT / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + gr + RT * i;
    if (row >= a.sq) continue;
    const float inv = 1.f / l[i];
    float* orow = out + row * a.o_s[2];
#pragma unroll
    for (int n = 0; n < W / (4 * CT); ++n) {
      const int col = col0 + 4 * (gc + CT * n);
      if (col < a.d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][4 * n] * inv, o[i][4 * n + 1] * inv,
                        o[i][4 * n + 2] * inv, o[i][4 * n + 3] * inv);
    }
    if (grp == 0 && gc == 0) lse[row] = m[i] * a.scale + logf(l[i]);
  }
}

// `dq_wide_f32_groups<W>` (kF32Tiled's K2): a block owns 64 query
// rows of one (b, h) and columns [grp W, grp W + W) of dQ; key tiles of
// 32. dq_f32's 16 x 16 thread grid: 4 x 2 scores of S and of dP a thread at
// query rows gr + 16 i and keys gc + 16 j, dQ rows 4 gr .. 4 gr + 3 and
// W / 16 columns. Shared memory: ST steps of (chunks of Q's and dO's 64
// rows, of the tile's 32 keys of K and V), the tile's W columns of K,
// dS^T.
template <int W>
struct DqWideF32Groups {
  static constexpr int BQ = 64, BK = 32;  // query rows a block, keys a tile
  static constexpr int SR = BQ / 16, SC = BK / 16, TR = BQ / 16;
  static constexpr int STEP = 2 * (BQ + BK) * F32_CP;  // Q, dO, K, V
  static constexpr int DO_OFF = BQ * F32_CP, K_OFF = 2 * BQ * F32_CP,
                       V_OFF = K_OFF + BK * F32_CP;  // in a step
  static constexpr int KP = W + 4;   // K's columns, [BK][KP]
  static constexpr int XP = BQ + 4;  // dS^T, [BK][XP]
  static constexpr int FIT = (SMEM_MAX / 4 - BK * KP - BK * XP) / STEP;
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  static constexpr int KG_OFF = ST * STEP, X_OFF = KG_OFF + BK * KP;
  static constexpr int BYTES = (X_OFF + BK * XP) * 4;
  static_assert(W % 64 == 0 && BQ == 16 * SR && BK == 16 * SC, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
dq_wide_f32_groups(const __grid_constant__ F32Args a) {
  using L = DqWideF32Groups<W>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = L::TR, XP = L::XP, C = F32_C, CP = F32_CP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Kg = sm + L::KG_OFF;
  float* Xs = sm + L::X_OFF;

  const Block blk(a.tiles, a.groups, a.h * a.batch, true);
  const int grp = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ, col0 = grp * W;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int nc = a.chunks, steps = nk * nc;
  const int tid = threadIdx.x;
  const int gr = 4 * (tid >> 6) + ((tid >> 3) & 3);
  const int gc = 8 * ((tid >> 5) & 1) + (tid & 7);
  const float* q = f32_head(a.q, a.q_s, ib, ih);
  const float* dout = f32_head(a.dout, a.do_s, ib, ih);
  const float* k = f32_head(a.k, a.k_s, ib, ikv);
  const float* v = f32_head(a.v, a.v_s, ib, ikv);

  // step j: chunk j % nc of the block's Q and dO rows and of key tile
  // j / nc's K and V; at a tile's step ST - 1 also its W columns of K
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C, k0 = j / nc * BK;
    f32_rows_async<C, BQ, CP>(s, q + c0, a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BQ, CP>(s + L::DO_OFF, dout + c0, a.do_s[2], q0, a.sq,
                              tid);
    f32_rows_async<C, BK, CP>(s + L::K_OFF, k + c0, a.k_s[2], k0, a.sk, tid);
    f32_rows_async<C, BK, CP>(s + L::V_OFF, v + c0, a.v_s[2], k0, a.sk, tid);
    int t;
    if (group_step<ST>(j, nc, t))
      f32_rows_async<W, BK>(Kg, k + col0, a.k_s[2], t * BK, a.sk, tid,
                            a.d - col0);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }

  // the thread's score rows: lse (log2 domain) and delta; rows past sq
  // read 0 (and Q = dO = 0): dS = 0 there, and they are not written
  const int64_t rowbase = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  float ls[SR], dl[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int row = q0 + gr + 16 * i;
    ls[i] = row < a.sq ? a.lse[rowbase + row] * kLog2e : 0.f;
    dl[i] = row < a.sq ? a.delta[rowbase + row] : 0.f;
  }

  float acc[TR][W / 16];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < W / 16; ++c) acc[i][c] = 0.f;

#pragma unroll 1
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // S = Q K^T (sd[0]) and dP = dO V^T (sd[1]) over the head dim
    float sd[2][SR][SC];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) sd[n][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = ik * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* s = sm + j % ST * L::STEP;
      f32_dots<C, SR, SC, 16, 16, 2, CP, true>(
          sd, {s, s + L::DO_OFF}, {s + L::K_OFF, s + L::V_OFF}, gr, gc);
    }

    // dS = P (dP - delta), P = 0 past sk and (causal) after the row
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk;
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float pr = fast_exp2(fmaf(sd[0][i][j], a.scale_log2, -ls[i]));
        if (need_mask) {
          const int col = k0 + gc + 16 * j;
          if (col >= a.sk || (a.causal && col > q0 + gr + 16 * i)) pr = 0.f;
        }
        Xs[(gc + 16 * j) * XP + gr + 16 * i] = pr * (sd[1][i][j] - dl[i]);
      }
    __syncthreads();  // dS^T is in (K's columns came with step ST - 1)

    // dQ[:, own] += dS K[:, own]
    f32_outer<W, TR, BK, XP, 16>(acc, Xs, Kg, TR * gr, gc);
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  f32_store<W, TR, 16>(f32_head(a.o, a.o_s, ib, ih) + q0 * a.o_s[2] + col0,
                       a.o_s[2], acc, a.scale, TR * gr, a.sq - q0, gc,
                       a.d - col0);
}

// `dkv_wide_f32_groups<W>` (kF32Tiled's K3): a block owns 32 keys
// of one (b, KV head) and columns [grp W, grp W + W) of dK and dV; items of
// 32 query rows, each query head of the KV group from the diagonal on, in a
// fixed order. dkv_f32's split:
// warps 0-3 form S^T = K Q^T, write P^T and own dV += P^T dO; warps 4-7
// form dP^T = V dO^T, read P^T back for dS^T = P^T (dP^T - delta) and own
// dK += dS^T Q; a half's 16 x 8 grid holds 2 x 4 scores (keys gr + 16 i,
// queries gc + 8 j) and 2 rows x W / 8 columns of its output. Each thread
// loads its queries' lse (warps 0-3) or delta (4-7) from global memory at
// the item's start. Shared memory: ST steps of (chunks of the block's 32
// keys of K and V, of the item's 32 rows of Q and dO), the item's W
// columns of Q and of dO, P^T and dS^T.
template <int W>
struct DkvWideF32Groups {
  static constexpr int BK = 32, BQ = 32;  // keys a block, query rows an item
  static constexpr int HALF = F32_THREADS / 2;
  static constexpr int SR = BK / 16, SC = BQ / 8, TR = BK / 16;
  static constexpr int STEP = 2 * (BK + BQ) * F32_CP;  // K, V, Q, dO
  static constexpr int V_OFF = BK * F32_CP, Q_OFF = 2 * BK * F32_CP,
                       DO_OFF = Q_OFF + BQ * F32_CP;  // in a step
  static constexpr int GP = W + 4;  // Q's and dO's columns, [BQ][GP] each
  static constexpr int XP = BK + 4;  // P^T and dS^T, [BQ][XP] each
  static constexpr int FIT =
      (SMEM_MAX / 4 - 2 * BQ * GP - 2 * BQ * XP) / STEP;
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  static constexpr int G_OFF = ST * STEP, X_OFF = G_OFF + 2 * BQ * GP;
  static constexpr int BYTES = (X_OFF + 2 * BQ * XP) * 4;
  static_assert(W % 64 == 0 && BK == 16 * SR && BQ == 8 * SC, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
dkv_wide_f32_groups(const __grid_constant__ F32Args a) {
  using L = DkvWideF32Groups<W>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = L::TR, XP = L::XP, GP = L::GP, HALF = L::HALF;
  constexpr int C = F32_C, CP = F32_CP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qg = sm + L::G_OFF;
  float* Og = Qg + BQ * GP;
  float* Ps = sm + L::X_OFF;
  float* Ss = Ps + BQ * XP;

  // heaviest key tiles (the first, under causal masking) first
  const Block blk(a.tiles, a.groups, a.hkv * a.batch, false);
  const int grp = blk.grp, ikv = blk.head % a.hkv, ib = blk.head / a.hkv;
  const int k0 = blk.tile * BK, col0 = grp * W;
  const int group = a.h / a.hkv;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int per_head = nq - iq0;
  const int items = group * per_head;
  const int nc = a.chunks, steps = items * nc;
  const int tid = threadIdx.x, half = tid / HALF, ht = tid % HALF;
  const int gr = 4 * (ht >> 5) + ((ht >> 3) & 3), gc = ht & 7;
  const float* k = f32_head(a.k, a.k_s, ib, ikv);
  const float* v = f32_head(a.v, a.v_s, ib, ikv);

  // step j: chunk j % nc of the block's K and V and of item j / nc's Q and
  // dO rows; at an item's step ST - 1 also its W columns of Q and dO
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C, n = j / nc;
    const int ih = ikv * group + n / per_head;
    const int q0 = (iq0 + n % per_head) * BQ;
    f32_rows_async<C, BK, CP>(s, k + c0, a.k_s[2], k0, a.sk, tid);
    f32_rows_async<C, BK, CP>(s + L::V_OFF, v + c0, a.v_s[2], k0, a.sk, tid);
    f32_rows_async<C, BQ, CP>(s + L::Q_OFF, f32_head(a.q, a.q_s, ib, ih) + c0,
                              a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BQ, CP>(s + L::DO_OFF,
                              f32_head(a.dout, a.do_s, ib, ih) + c0,
                              a.do_s[2], q0, a.sq, tid);
    int t;
    if (group_step<ST>(j, nc, t)) {
      const int gh = ikv * group + t / per_head;
      const int g0 = (iq0 + t % per_head) * BQ;
      f32_rows_async<W, BQ>(Qg, f32_head(a.q, a.q_s, ib, gh) + col0, a.q_s[2],
                            g0, a.sq, tid, a.d - col0);
      f32_rows_async<W, BQ>(Og, f32_head(a.dout, a.do_s, ib, gh) + col0,
                            a.do_s[2], g0, a.sq, tid, a.d - col0);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }
  // this half's score operands in a step: K and Q (half 0), V and dO
  const int a_off = half ? L::V_OFF : 0, b_off = half ? L::DO_OFF : L::Q_OFF;
  const float* xs = half ? a.delta : a.lse;

  float acc[TR][W / 8];  // dV (half 0) or dK (half 1)
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < W / 8; ++c) acc[i][c] = 0.f;

#pragma unroll 1
  for (int n = 0; n < items; ++n) {
    const int ih = ikv * group + n / per_head;
    const int q0 = (iq0 + n % per_head) * BQ;
    // the lse (half 0) or delta (half 1) of this thread's queries
    // q0 + gc + 8 j (past sq: 0, and masked)
    const float* xr = xs + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    float x[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int qi = q0 + gc + 8 * j;
      x[j] = qi < a.sq ? xr[qi] : 0.f;
    }

    // S^T = K Q^T (half 0) or dP^T = V dO^T (half 1) over the head dim
    float sd[1][SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) sd[0][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = n * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* s = sm + j % ST * L::STEP;
      f32_dots<C, SR, SC, 16, 8, 1, CP, true>(sd, {s + a_off}, {s + b_off},
                                              gr, gc);
    }

    if (half == 0) {
      // P^T; 0 for queries past sq and (causal) keys after the query
      const bool need_mask =
          (a.causal && q0 < k0 + BK - 1) || q0 + BQ > a.sq;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
        const float lq = x[j] * kLog2e;
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          float pr = fast_exp2(fmaf(sd[0][i][j], a.scale_log2, -lq));
          if (need_mask &&
              (q0 + c >= a.sq || (a.causal && k0 + gr + 16 * i > q0 + c)))
            pr = 0.f;
          Ps[c * XP + gr + 16 * i] = pr;
        }
      }
    }
    __syncthreads();  // P^T is in (Q's and dO's columns came with step
                      // ST - 1)
    if (half == 1) {
      // dS^T = P^T (dP^T - delta), at the same elements
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
#pragma unroll
        for (int i = 0; i < SR; ++i)
          Ss[c * XP + gr + 16 * i] =
              Ps[c * XP + gr + 16 * i] * (sd[0][i][j] - x[j]);
      }
      bar_sync(1, HALF);  // this half's dS^T is in
    }

    // dV[:, own] += P^T dO[:, own] (half 0) or dK[:, own] += dS^T Q[:, own]
    f32_outer<W, TR, BQ, XP, 8>(acc, half ? Ss : Ps, half ? Qg : Og, TR * gr,
                                gc);
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();

  float* out = half ? f32_head(a.o, a.o_s, ib, ikv)
                    : f32_head(a.o2, a.o2_s, ib, ikv);
  const int64_t ss = half ? a.o_s[2] : a.o2_s[2];
  f32_store<W, TR, 8>(out + k0 * ss + col0, ss, acc, half ? a.scale : 1.f,
                      TR * gr, a.sk - k0, gc, a.d - col0);
}

// ------------------------------------------------------------ f32 clusters
//
// kF32Cluster: a row tile on a cluster of n = ceil(d / W) blocks,
// launched by hopper::launch_cluster with the n column groups of a tile as
// consecutive blocks (Block's `grp` is the cluster rank). The block of rank
// r holds columns [r W, min(r W + W, d)) of the reduction and of its
// outputs (cols of them, nc = cols / F32_C chunks) and streams only those.
// Per tile (K1, K2) or item (K3):
//   the partial scores over its chunks, the chain carried on as in
//   kF32Tiled, each chunk of the output product's row operand copied from
//   its stage into the tile's W columns of it as the step uses it;
//   ClusterSum: scatter, the first half of the last tile's output product
//   (its first 16 keys or query rows), gather (the partials of the owned
//   units added in rank order), the second half, collect;
//   P and dS from the summed scores, as in kF32Tiled, into one of two
//   buffers: the next tile takes their product while its own exchange
//   lands, and the last tile's follows the loop.
// Every block of the cluster holds the same sums, so the same P and dS.

// Copy a chunk of ROWS rows (F32_C columns at pitch F32_CP, a stage's) to
// columns [c0, c0 + F32_C) of `dst` (pitch P): one float4 a thread.
template <int ROWS, int P>
__device__ __forceinline__ void chunk_to_cols(float* dst, const float* src,
                                              int c0, int tid) {
  static_assert(ROWS * F32_C / 4 == F32_THREADS, "a float4 a thread");
  const int row = tid / (F32_C / 4), c = 4 * (tid % (F32_C / 4));
  *reinterpret_cast<float4*>(dst + row * P + c0 + c) =
      *reinterpret_cast<const float4*>(src + row * F32_CP + c);
}

// `flash_fwd_wide_f32<W>`: a cluster owns 64 query rows of one (b, h);
// key tiles of 32; flash_fwd_f32's thread grid (a query row's 16 threads one
// half-warp, row max and sum by shuffles; 4 x 2 scores a thread, 2 units;
// O rows gr + 16 i, P^T's columns 4 gr + i, and W / 16 columns). The row
// operand of its output product, V, is no score operand: each step brings
// the block's chunk of V's tile beside Q's and K's, copied into the tile's
// W columns as the step uses it. The online softmax needs a tile's whole S
// before its max, so the last tile's P V runs in this tile's exchange, and
// O is rescaled by this tile's alpha after it: the arithmetic and order of
// flash_fwd_wide_f32_groups. Shared memory: ST steps of (chunks of the
// block's columns of Q's 64 rows and of the tile's 32 keys of K and V), two
// tiles' W columns of V, two P^T, the exchange's buffers and barriers (at
// 64-key tiles two V tiles, two P^T and ClusterSum<4> leave room for one
// stage).
template <int W>
struct FwdWideF32 {
  static constexpr int BQ = 64, BK = 32;  // query rows a cluster, keys a tile
  static constexpr int CT = 16, RT = F32_THREADS / CT;
  static constexpr int SR = BQ / RT, SC = BK / CT;
  using X = ClusterSum<SR * SC / 4, CLUSTER_MAX>;  // S
  static constexpr int STEP = (BQ + 2 * BK) * F32_CP;  // Q, K, V
  static constexpr int K_OFF = BQ * F32_CP, V_OFF = K_OFF + BK * F32_CP;
  static constexpr int VP = W + 4;   // the block's columns of V, [BK][VP]
  static constexpr int XP = BQ + 4;  // P^T, [BK][XP]
  static constexpr int FIXED = 4 * 2 * BK * (VP + XP) + X::BYTES + 8 * X::BARS;
  static constexpr int FIT = (SMEM_MAX - FIXED) / (4 * STEP);
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  static constexpr int VG_OFF = ST * STEP, X_OFF = VG_OFF + 2 * BK * VP;
  static constexpr int XCH_OFF = X_OFF + 2 * BK * XP;     // floats
  static constexpr int BAR_OFF = 4 * XCH_OFF + X::BYTES;  // bytes
  static constexpr int BYTES = BAR_OFF + 8 * X::BARS;
  static_assert(W % 64 == 0 && SR * RT == BQ && SC * CT == BK, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_fwd_wide_f32(const __grid_constant__ F32Args a) {
  using L = FwdWideF32<W>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int CT = L::CT, RT = L::RT, XP = L::XP, VP = L::VP;
  constexpr int C = F32_C, CP = F32_CP;
  constexpr int HK = BK / 2;  // keys of each half of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const uint32_t bar = smem_u32(smem_raw) + L::BAR_OFF;

  const Block blk(a.tiles, a.groups, a.h * a.batch, true);
  const int rank = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ, col0 = rank * W;
  const int cols = min(W, a.d - col0), nc = cols / C;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int steps = nk * nc;
  const int tid = threadIdx.x, gr = tid / CT, gc = tid % CT;
  // the block's columns of each operand
  const float* q = f32_head(a.q, a.q_s, ib, ih) + col0;
  const float* k = f32_head(a.k, a.k_s, ib, ikv) + col0;
  const float* v = f32_head(a.v, a.v_s, ib, ikv) + col0;

  if (tid == 0) {
    L::X::init(bar, a.groups, rank);
    fence_mbar_init();
  }
  L::X::begin();
  const typename L::X xc(smem_u32(sm + L::XCH_OFF), sm + L::XCH_OFF, bar,
                         a.groups, rank, tid);

  // step j: chunk j % nc of the block's columns of its Q rows and of key
  // tile j / nc's K and V
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C, k0 = j / nc * BK;
    f32_rows_async<C, BQ, CP>(s, q + c0, a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BK, CP>(s + L::K_OFF, k + c0, a.k_s[2], k0, a.sk, tid);
    f32_rows_async<C, BK, CP>(s + L::V_OFF, v + c0, a.v_s[2], k0, a.sk, tid);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }

  float o[SR][W / CT];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int c = 0; c < W / CT; ++c) o[i][c] = 0.f;
  // running max in raw (unscaled) score units; per-thread partial row sums
  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) m[i] = kNegInf, l[i] = 0.f;
  // O[:, own] += P V[:, own] over keys [r0, r0 + HK) of tile t
  auto pv = [&](int t, int r0) {
    const float* x = sm + L::X_OFF + (t % 2 * BK + r0) * XP;
    const float* y = sm + L::VG_OFF + (t % 2 * BK + r0) * VP;
    if (cols == W)
      f32_outer<W, SR, HK, XP, CT>(o, x, y, SR * gr, gc);
    else
      f32_outer<W, SR, HK, XP, CT, true>(o, x, y, SR * gr, gc, cols);
  };

#pragma unroll 1
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    float* vg = sm + L::VG_OFF + ik % 2 * BK * VP;
    // the partial S = Q K^T over the block's columns; the tile's V chunks
    // kept for its product
    float s[1][SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[0][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = ik * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* st = sm + j % ST * L::STEP;
      chunk_to_cols<BK, VP>(vg, st + L::V_OFF, cc * C, tid);
      f32_dots<C, SR, SC, RT, CT, 1, CP, true>(s, {st}, {st + L::K_OFF}, gr,
                                               gc);
    }

    // the cluster's sums, the last tile's P V while they land
    auto& r = reinterpret_cast<float(&)[SR * SC]>(s);
    const bool more = ik + 1 < nk;
    xc.scatter(r);
    if (ik > 0) pv(ik - 1, 0);
    xc.gather(r, ik & 1, more);
    if (ik > 0) pv(ik - 1, HK);
    xc.collect(r, ik & 1, more);

    // mask only tiles that cross the diagonal or the ragged end
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk;
    float alpha[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = q0 + gr + RT * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + gc + CT * j;
        if (need_mask && (col >= a.sk || (a.causal && col > row)))
          s[0][i][j] = kNegInf;
        mx = fmaxf(mx, s[0][i][j]);
      }
#pragma unroll
      for (int off = CT / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = fast_exp2((m[i] - mx) * a.scale_log2);
      m[i] = mx;
      l[i] *= alpha[i];
    }
    // O[:, own] = alpha O[:, own] (the last tile's P V is in it), then P =
    // exp2((S - m) scale log2 e), 0 where masked, into P^T
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int c = 0; c < W / CT; ++c) o[i][c] *= alpha[i];
    float* xs = sm + L::X_OFF + ik % 2 * BK * XP;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      float pr[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float x = s[0][i][j];
        pr[i] = x == kNegInf
                    ? 0.f
                    : fast_exp2(fmaf(x, a.scale_log2, -m[i] * a.scale_log2));
        l[i] += pr[i];
      }
      f32_xstore<SR>(xs + (gc + CT * j) * XP + SR * gr, pr);
    }
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();  // the last tile's P^T and V columns are in
  pv(nk - 1, 0);
  pv(nk - 1, HK);

  // the row sums over the row's lanes; O / l and (rank 0) LSE = m scale +
  // log l
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int off = CT / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  L::X::end([&] {
    float* out = f32_head(a.o, a.o_s, ib, ih) + col0;
    float* lse = a.lse_out + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = q0 + gr + RT * i;
      if (row >= a.sq) continue;
      const float inv = 1.f / l[i];
      float* orow = out + row * a.o_s[2];
#pragma unroll
      for (int n = 0; n < W / (4 * CT); ++n) {
        const int col = 4 * (gc + CT * n);
        if (col < cols)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(o[i][4 * n] * inv, o[i][4 * n + 1] * inv,
                          o[i][4 * n + 2] * inv, o[i][4 * n + 3] * inv);
      }
      if (rank == 0 && gc == 0) lse[row] = m[i] * a.scale + logf(l[i]);
    }
  });
}

// `dq_wide_f32<W>`: a cluster owns 64 query rows of one (b, h); key tiles
// of 32; dq_f32's 16 x 16 thread grid (4 x 2 scores of S and of dP a
// thread, 4 units; dQ rows 4 gr .. 4 gr + 3 and W / 16 columns). Shared
// memory: ST steps of (chunks of Q's and dO's 64 rows, of the tile's 32
// keys of K and V), two tiles' W columns of K, two dS^T, the exchange's
// buffers and barriers.
template <int W>
struct DqWideF32 {
  static constexpr int BQ = 64, BK = 32;  // query rows a cluster, keys a tile
  static constexpr int SR = BQ / 16, SC = BK / 16, TR = BQ / 16;
  using X = ClusterSum<2 * SR * SC / 4, CLUSTER_MAX>;  // S and dP
  static constexpr int STEP = 2 * (BQ + BK) * F32_CP;  // Q, dO, K, V
  static constexpr int DO_OFF = BQ * F32_CP, K_OFF = 2 * BQ * F32_CP,
                       V_OFF = K_OFF + BK * F32_CP;  // in a step
  static constexpr int KP = W + 4;   // the block's columns of K, [BK][KP]
  static constexpr int XP = BQ + 4;  // dS^T, [BK][XP]
  static constexpr int FIXED = 4 * 2 * BK * (KP + XP) + X::BYTES + 8 * X::BARS;
  static constexpr int FIT = (SMEM_MAX - FIXED) / (4 * STEP);
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  static constexpr int KG_OFF = ST * STEP, X_OFF = KG_OFF + 2 * BK * KP;
  static constexpr int XCH_OFF = X_OFF + 2 * BK * XP;     // floats
  static constexpr int BAR_OFF = 4 * XCH_OFF + X::BYTES;  // bytes
  static constexpr int BYTES = BAR_OFF + 8 * X::BARS;
  static_assert(W % 64 == 0 && BQ == 16 * SR && BK == 16 * SC, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
dq_wide_f32(const __grid_constant__ F32Args a) {
  using L = DqWideF32<W>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = L::TR, XP = L::XP, KP = L::KP, C = F32_C, CP = F32_CP;
  constexpr int HK = BK / 2;  // keys of each half of the output product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const uint32_t bar = smem_u32(smem_raw) + L::BAR_OFF;

  const Block blk(a.tiles, a.groups, a.h * a.batch, true);
  const int rank = blk.grp, ih = blk.head % a.h, ib = blk.head / a.h;
  const int ikv = ih / (a.h / a.hkv);
  const int q0 = blk.tile * BQ, col0 = rank * W;
  const int cols = min(W, a.d - col0), nc = cols / C;
  int nk = (a.sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  const int steps = nk * nc;
  const int tid = threadIdx.x;
  const int gr = 4 * (tid >> 6) + ((tid >> 3) & 3);
  const int gc = 8 * ((tid >> 5) & 1) + (tid & 7);
  // the block's columns of each operand
  const float* q = f32_head(a.q, a.q_s, ib, ih) + col0;
  const float* dout = f32_head(a.dout, a.do_s, ib, ih) + col0;
  const float* k = f32_head(a.k, a.k_s, ib, ikv) + col0;
  const float* v = f32_head(a.v, a.v_s, ib, ikv) + col0;

  if (tid == 0) {
    L::X::init(bar, a.groups, rank);
    fence_mbar_init();
  }
  L::X::begin();
  const typename L::X xc(smem_u32(sm + L::XCH_OFF), sm + L::XCH_OFF, bar,
                         a.groups, rank, tid);

  // step j: chunk j % nc of the block's columns of its Q and dO rows and of
  // key tile j / nc's K and V
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C, k0 = j / nc * BK;
    f32_rows_async<C, BQ, CP>(s, q + c0, a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BQ, CP>(s + L::DO_OFF, dout + c0, a.do_s[2], q0, a.sq,
                              tid);
    f32_rows_async<C, BK, CP>(s + L::K_OFF, k + c0, a.k_s[2], k0, a.sk, tid);
    f32_rows_async<C, BK, CP>(s + L::V_OFF, v + c0, a.v_s[2], k0, a.sk, tid);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }

  // the thread's score rows: lse (log2 domain) and delta; rows past sq
  // read 0 (and Q = dO = 0): dS = 0 there, and they are not written
  const int64_t rowbase = (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
  float ls[SR], dl[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int row = q0 + gr + 16 * i;
    ls[i] = row < a.sq ? a.lse[rowbase + row] * kLog2e : 0.f;
    dl[i] = row < a.sq ? a.delta[rowbase + row] : 0.f;
  }

  float acc[TR][W / 16];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < W / 16; ++c) acc[i][c] = 0.f;
  // dQ[:, own] += dS K[:, own] over keys [r0, r0 + HK) of tile t
  auto product = [&](int t, int r0) {
    const float* x = sm + L::X_OFF + (t % 2 * BK + r0) * XP;
    const float* y = sm + L::KG_OFF + (t % 2 * BK + r0) * KP;
    if (cols == W)
      f32_outer<W, TR, HK, XP, 16>(acc, x, y, TR * gr, gc);
    else
      f32_outer<W, TR, HK, XP, 16, true>(acc, x, y, TR * gr, gc, cols);
  };

#pragma unroll 1
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    float* kg = sm + L::KG_OFF + ik % 2 * BK * KP;
    // the partial S = Q K^T (sd[0]) and dP = dO V^T (sd[1]) over the
    // block's columns
    float sd[2][SR][SC];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) sd[n][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = ik * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* s = sm + j % ST * L::STEP;
      chunk_to_cols<BK, KP>(kg, s + L::K_OFF, cc * C, tid);
      f32_dots<C, SR, SC, 16, 16, 2, CP, true>(
          sd, {s, s + L::DO_OFF}, {s + L::K_OFF, s + L::V_OFF}, gr, gc);
    }

    // the cluster's sums, the last tile's product while they land
    auto& r = reinterpret_cast<float(&)[2 * SR * SC]>(sd);
    const bool more = ik + 1 < nk;
    xc.scatter(r);
    if (ik > 0) product(ik - 1, 0);
    xc.gather(r, ik & 1, more);
    if (ik > 0) product(ik - 1, HK);
    xc.collect(r, ik & 1, more);

    // dS = P (dP - delta), P = 0 past sk and (causal) after the row
    float* xs = sm + L::X_OFF + ik % 2 * BK * XP;
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.sk;
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float pr = fast_exp2(fmaf(sd[0][i][j], a.scale_log2, -ls[i]));
        if (need_mask) {
          const int col = k0 + gc + 16 * j;
          if (col >= a.sk || (a.causal && col > q0 + gr + 16 * i)) pr = 0.f;
        }
        xs[(gc + 16 * j) * XP + gr + 16 * i] = pr * (sd[1][i][j] - dl[i]);
      }
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();  // the last tile's dS^T and K columns are in
  product(nk - 1, 0);
  product(nk - 1, HK);

  L::X::end([&] {
    f32_store<W, TR, 16>(f32_head(a.o, a.o_s, ib, ih) + q0 * a.o_s[2] + col0,
                         a.o_s[2], acc, a.scale, TR * gr, a.sq - q0, gc,
                         cols);
  });
}

// `dkv_wide_f32<W>`: a cluster owns 32 keys of one (b, KV head); items of
// 32 query rows, each query head of the KV group from the diagonal on, in a
// fixed order; dkv_f32's split (warps 0-3: S^T, P^T, dV; warps 4-7: dP^T,
// dS^T, dK; 2 x 4 scores a thread, 2 units; 2 rows x W / 8 columns of its
// output). Shared memory: ST steps of (chunks of the block's 32 keys of K
// and V, of the item's 32 rows of Q and dO), two items' W columns of Q and
// of dO, two items' P^T and dS^T, the exchange's buffers and barriers.
template <int W>
struct DkvWideF32 {
  static constexpr int BK = 32, BQ = 32;  // keys a cluster, query rows an item
  static constexpr int HALF = F32_THREADS / 2;
  static constexpr int SR = BK / 16, SC = BQ / 8, TR = BK / 16;
  using X = ClusterSum<SR * SC / 4, CLUSTER_MAX>;  // S^T or dP^T
  static constexpr int STEP = 2 * (BK + BQ) * F32_CP;  // K, V, Q, dO
  static constexpr int V_OFF = BK * F32_CP, Q_OFF = 2 * BK * F32_CP,
                       DO_OFF = Q_OFF + BQ * F32_CP;  // in a step
  static constexpr int GP = W + 4;   // Q's and dO's columns, [BQ][GP] each
  static constexpr int XP = BK + 4;  // P^T and dS^T, [BQ][XP] each
  static constexpr int FIXED = 4 * 4 * BQ * (GP + XP) + X::BYTES + 8 * X::BARS;
  static constexpr int FIT = (SMEM_MAX - FIXED) / (4 * STEP);
  static constexpr int ST = FIT < F32_MAX_ST ? FIT : F32_MAX_ST;
  // [2 items][Q, dO][BQ][GP], then [2 items][P^T, dS^T][BQ][XP]
  static constexpr int G_OFF = ST * STEP, X_OFF = G_OFF + 4 * BQ * GP;
  static constexpr int XCH_OFF = X_OFF + 4 * BQ * XP;     // floats
  static constexpr int BAR_OFF = 4 * XCH_OFF + X::BYTES;  // bytes
  static constexpr int BYTES = BAR_OFF + 8 * X::BARS;
  static_assert(W % 64 == 0 && BK == 16 * SR && BQ == 8 * SC, "threads");
  static_assert(ST >= 2 && BYTES <= SMEM_MAX, "227 KB a block");
};

template <int W>
__global__ void __launch_bounds__(F32_THREADS, 1)
dkv_wide_f32(const __grid_constant__ F32Args a) {
  using L = DkvWideF32<W>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::ST, SR = L::SR, SC = L::SC;
  constexpr int TR = L::TR, XP = L::XP, GP = L::GP, HALF = L::HALF;
  constexpr int C = F32_C, CP = F32_CP;
  constexpr int HQ = BQ / 2;  // query rows of each half of the products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const uint32_t bar = smem_u32(smem_raw) + L::BAR_OFF;

  // heaviest key tiles (the first, under causal masking) first
  const Block blk(a.tiles, a.groups, a.hkv * a.batch, false);
  const int rank = blk.grp, ikv = blk.head % a.hkv, ib = blk.head / a.hkv;
  const int k0 = blk.tile * BK, col0 = rank * W;
  const int cols = min(W, a.d - col0), nc = cols / C;
  const int group = a.h / a.hkv;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int per_head = nq - iq0;
  const int items = group * per_head;
  const int steps = items * nc;
  const int tid = threadIdx.x, half = tid / HALF, ht = tid % HALF;
  const int gr = 4 * (ht >> 5) + ((ht >> 3) & 3), gc = ht & 7;
  const float* k = f32_head(a.k, a.k_s, ib, ikv) + col0;
  const float* v = f32_head(a.v, a.v_s, ib, ikv) + col0;

  if (tid == 0) {
    L::X::init(bar, a.groups, rank);
    fence_mbar_init();
  }
  L::X::begin();
  const typename L::X xc(smem_u32(sm + L::XCH_OFF), sm + L::XCH_OFF, bar,
                         a.groups, rank, tid);

  // step j: chunk j % nc of the block's columns of its K and V and of item
  // j / nc's Q and dO rows
  auto issue = [&](int j) {
    float* s = sm + j % ST * L::STEP;
    const int c0 = j % nc * C, n = j / nc;
    const int ih = ikv * group + n / per_head;
    const int q0 = (iq0 + n % per_head) * BQ;
    f32_rows_async<C, BK, CP>(s, k + c0, a.k_s[2], k0, a.sk, tid);
    f32_rows_async<C, BK, CP>(s + L::V_OFF, v + c0, a.v_s[2], k0, a.sk, tid);
    f32_rows_async<C, BQ, CP>(s + L::Q_OFF,
                              f32_head(a.q, a.q_s, ib, ih) + col0 + c0,
                              a.q_s[2], q0, a.sq, tid);
    f32_rows_async<C, BQ, CP>(s + L::DO_OFF,
                              f32_head(a.dout, a.do_s, ib, ih) + col0 + c0,
                              a.do_s[2], q0, a.sq, tid);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    hopper::cp_async_commit();
  }
  // this half's score operands in a step: K and Q (half 0), V and dO
  const int a_off = half ? L::V_OFF : 0, b_off = half ? L::DO_OFF : L::Q_OFF;
  const float* xs = half ? a.delta : a.lse;

  float acc[TR][W / 8];  // dV (half 0) or dK (half 1)
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < W / 8; ++c) acc[i][c] = 0.f;
  // dV[:, own] += P^T dO[:, own] (half 0) or dK[:, own] += dS^T Q[:, own]
  // (half 1) over query rows [r0, r0 + HQ) of item n
  auto product = [&](int n, int r0) {
    const float* x = sm + L::X_OFF + ((n % 2 * 2 + half) * BQ + r0) * XP;
    const float* g = sm + L::G_OFF + ((n % 2 * 2 + 1 - half) * BQ + r0) * GP;
    if (cols == W)
      f32_outer<W, TR, HQ, XP, 8>(acc, x, g, TR * gr, gc);
    else
      f32_outer<W, TR, HQ, XP, 8, true>(acc, x, g, TR * gr, gc, cols);
  };

#pragma unroll 1
  for (int n = 0; n < items; ++n) {
    const int ih = ikv * group + n / per_head;
    const int q0 = (iq0 + n % per_head) * BQ;
    // the lse (half 0) or delta (half 1) of this thread's queries
    // q0 + gc + 8 j (past sq: 0, and masked)
    const float* xr = xs + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    float x[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int qi = q0 + gc + 8 * j;
      x[j] = qi < a.sq ? xr[qi] : 0.f;
    }

    // the partial S^T = K Q^T (half 0) or dP^T = V dO^T (half 1) over the
    // block's columns; the item's Q and dO chunks kept for its products
    float* qg = sm + L::G_OFF + n % 2 * 2 * BQ * GP;
    float sd[1][SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) sd[0][i][j] = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int j = n * nc + cc;
      f32_next_stage<ST>(j, steps, issue);  // step j is in
      const float* s = sm + j % ST * L::STEP;
      chunk_to_cols<BQ, GP>(qg, s + L::Q_OFF, cc * C, tid);
      chunk_to_cols<BQ, GP>(qg + BQ * GP, s + L::DO_OFF, cc * C, tid);
      f32_dots<C, SR, SC, 16, 8, 1, CP, true>(sd, {s + a_off}, {s + b_off},
                                              gr, gc);
    }

    // the cluster's sums, the last item's products while they land
    auto& r = reinterpret_cast<float(&)[SR * SC]>(sd);
    const bool more = n + 1 < items;
    xc.scatter(r);
    if (n > 0) product(n - 1, 0);
    xc.gather(r, n & 1, more);
    if (n > 0) product(n - 1, HQ);
    xc.collect(r, n & 1, more);

    float* ps = sm + L::X_OFF + n % 2 * 2 * BQ * XP;  // P^T, then dS^T
    if (half == 0) {
      // P^T; 0 for queries past sq and (causal) keys after the query
      const bool need_mask =
          (a.causal && q0 < k0 + BK - 1) || q0 + BQ > a.sq;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
        const float lq = x[j] * kLog2e;
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          float pr = fast_exp2(fmaf(sd[0][i][j], a.scale_log2, -lq));
          if (need_mask &&
              (q0 + c >= a.sq || (a.causal && k0 + gr + 16 * i > q0 + c)))
            pr = 0.f;
          ps[c * XP + gr + 16 * i] = pr;
        }
      }
    }
    __syncthreads();  // P^T is in
    if (half == 1) {
      // dS^T = P^T (dP^T - delta), at the same elements
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = gc + 8 * j;
#pragma unroll
        for (int i = 0; i < SR; ++i)
          ps[BQ * XP + c * XP + gr + 16 * i] =
              ps[c * XP + gr + 16 * i] * (sd[0][i][j] - x[j]);
      }
    }
  }
  // nothing in flight at exit
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();  // the last item's dS^T and Q and dO columns are in
  product(items - 1, 0);
  product(items - 1, HQ);

  float* out = half ? f32_head(a.o, a.o_s, ib, ikv)
                    : f32_head(a.o2, a.o2_s, ib, ikv);
  const int64_t ss = half ? a.o_s[2] : a.o2_s[2];
  L::X::end([&] {
    f32_store<W, TR, 8>(out + k0 * ss + col0, ss, acc, half ? a.scale : 1.f,
                        TR * gr, a.sk - k0, gc, cols);
  });
}

// ------------------------------------------------------------ host

// The tensors' (batch, head, seq) element strides, three a tensor: the
// forward's q, k, v, o, the backward's q, k, v, dO, dQ, dK, dV (flash_bwd's
// order).
enum { FQ, FK, FV, FO };
enum { Q, K, V, DO, DQ, DK, DV };

// A tensor's chunk map (boxes of 64 columns x `rows` rows), from its
// strides st (batch, head, seq).
cudaError_t chunk_map(CUtensorMap* map, const void* base, const int64_t* st,
                      int d, int s, int heads, int b, int rows) {
  return tmap_bf16(map, base, d, s, heads, b, st[2], st[1], st[0], rows);
}

// Its group map: boxes of W columns x `rows` rows (tmap_cols).
cudaError_t group_map(CUtensorMap* map, const void* base, const int64_t* st,
                      int d, int s, int heads, int b, int rows, int w) {
  return tmap_cols(map, base, d, s, heads, b, st[2], st[1], st[0], rows, w);
}

// The arguments every kernel takes beside its tensors, for groups of w
// columns and chunks of `chunk` (the bf16 kernels' 64, f32's F32_C).
template <typename Args>
void fill_shape(Args& a, int batch, int h, int hkv, int sq, int sk, int d,
                int causal, float scale, int w, int chunk = 64) {
  a.h = h;
  a.hkv = hkv;
  a.batch = batch;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.causal = causal;
  a.groups = (d + w - 1) / w;
  a.chunks = d / chunk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
}

// bf16 and f32 at any multiple of 64 from two chunks (bf16: a tile's
// second step loads the output product's tile; f32 from F32_MIN_D: a
// tile's steps must outnumber the ring's stages)
bool shape_ok(int bf16_in, int batch, int h, int hkv, int sq, int sk, int d) {
  return batch > 0 && sq > 0 && sk > 0 && hkv > 0 && h % hkv == 0 &&
         d >= 128 && d % 64 == 0 && (bf16_in || d >= F32_MIN_D);
}

cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, const int64_t (&st)[4][3], int batch, int h,
                    int hkv, int sq, int sk, int d, int causal, float scale,
                    cudaStream_t stream) {
  using L = FwdWide<FWD_W>;
  FwdArgs a;
  fill_shape(a, batch, h, hkv, sq, sk, d, causal, scale, FWD_W);
  a.nq = (sq + L::BQ - 1) / L::BQ;
  a.o = o;
  a.lse = lse;
  a.o_sb = st[FO][0];
  a.o_sh = st[FO][1];
  a.o_ss = st[FO][2];
  cudaError_t err;
  if ((err = chunk_map(&a.tq, q, st[FQ], d, sq, h, batch, L::BQ)) ||
      (err = chunk_map(&a.tk, k, st[FK], d, sk, hkv, batch, L::BK)) ||
      (err = group_map(&a.tv, v, st[FV], d, sk, hkv, batch, L::BK, FWD_W)))
    return err;
  return launch(flash_fwd_wide<FWD_W>, a.nq * a.groups * h * batch, THREADS,
                L::BYTES, stream, a);
}

cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const int64_t (*st)[3], int batch, int h,
                   int hkv, int sq, int sk, int d, int causal, float scale,
                   cudaStream_t stream) {
  using L = DqWide<DQ_W>;
  DqArgs a;
  fill_shape(a, batch, h, hkv, sq, sk, d, causal, scale, DQ_W);
  a.nq = (sq + L::BQ - 1) / L::BQ;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dq_sb = st[DQ][0];
  a.dq_sh = st[DQ][1];
  a.dq_ss = st[DQ][2];
  cudaError_t err;
  if ((err = chunk_map(&a.tq, q, st[Q], d, sq, h, batch, L::BQ)) ||
      (err = chunk_map(&a.tdo, dout, st[DO], d, sq, h, batch, L::BQ)) ||
      (err = chunk_map(&a.tk, k, st[K], d, sk, hkv, batch, L::BK)) ||
      (err = chunk_map(&a.tv, v, st[V], d, sk, hkv, batch, L::BK)) ||
      (err = group_map(&a.tkg, k, st[K], d, sk, hkv, batch, L::BK, DQ_W)))
    return err;
  return launch(dq_wide<DQ_W>, a.nq * a.groups * h * batch, THREADS,
                L::BYTES, stream, a);
}

// The bf16 designs (WideDesign; the C function flash_wide_design reports
// the one a build runs): K1 and K2 the column groups at every d; K3 on a
// cluster of ceil(d / W) blocks (dkv_wide) while that makes a portable
// cluster and its last block holds at least 3 W / 4 columns, the column
// groups (dkv_wide_groups) otherwise and, at every d, in a build with
// -DFLASH_OTHER_DESIGNS=1, so that chip_smoke.py times both in turns. A
// narrower last block forms both products over W columns of zeros past d,
// and the cluster lost in turns where it holds 64 or 128 (d 576, 640;
// PERF.md §6). K1's and K2's groups of a row tile on one cluster, each
// chunk read from L2 once and multicast to them, lost to the groups at
// every d from 576 to 2048 (PERF.md §6), and are not kept.
enum WideDesign { kWideGroups = 1, kWideCluster = 2 };
constexpr int wide_design(int kernel, int d) {
  return kernel == 2 && !FLASH_OTHER_DESIGNS &&
                 (d + DKV_W - 1) / DKV_W <= CLUSTER_MAX &&
                 (d % DKV_W == 0 || d % DKV_W >= 3 * DKV_W / 4)
             ? kWideCluster
             : kWideGroups;
}

cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const int64_t (*st)[3], int batch,
                    int h, int hkv, int sq, int sk, int d, int causal,
                    float scale, cudaStream_t stream) {
  using L = DkvWideGroups<DKV_W>;
  static_assert(DkvWide<DKV_W>::BK == L::BK, "key tiles");
  DkvArgs a;
  fill_shape(a, batch, h, hkv, sq, sk, d, causal, scale, DKV_W);
  a.nk = (sk + L::BK - 1) / L::BK;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.dk_sb = st[DK][0];
  a.dk_sh = st[DK][1];
  a.dk_ss = st[DK][2];
  a.dv_sb = st[DV][0];
  a.dv_sh = st[DV][1];
  a.dv_ss = st[DV][2];
  const int blocks = a.nk * a.groups * hkv * batch;
  cudaError_t err;
  // kWideCluster: a cluster of a.groups blocks a key tile (consecutive
  // blocks); a launch the card cannot place is refused and returned
  if (wide_design(2, d) == kWideCluster) {
    using C = DkvWide<DKV_W>;
    if ((err = group_map(&a.tkg, k, st[K], d, sk, hkv, batch, C::BK,
                         DKV_W)) ||
        (err = group_map(&a.tvg, v, st[V], d, sk, hkv, batch, C::BK,
                         DKV_W)) ||
        (err = group_map(&a.tqg, q, st[Q], d, sq, h, batch, C::BQ, DKV_W)) ||
        (err = group_map(&a.tdog, dout, st[DO], d, sq, h, batch, C::BQ,
                         DKV_W)))
      return err;
    return launch_cluster(dkv_wide<DKV_W>, blocks, a.groups, THREADS,
                          C::BYTES, stream, a);
  }
  if ((err = chunk_map(&a.tk, k, st[K], d, sk, hkv, batch, L::BK)) ||
      (err = chunk_map(&a.tv, v, st[V], d, sk, hkv, batch, L::BK)) ||
      (err = chunk_map(&a.tq, q, st[Q], d, sq, h, batch, L::BQ)) ||
      (err = chunk_map(&a.tdo, dout, st[DO], d, sq, h, batch, L::BQ)) ||
      (err = group_map(&a.tqg, q, st[Q], d, sq, h, batch, L::BQ, DKV_W)) ||
      (err = group_map(&a.tdog, dout, st[DO], d, sq, h, batch, L::BQ,
                       DKV_W)))
    return err;
  return launch(dkv_wide_groups<DKV_W>, blocks, THREADS, L::BYTES, stream,
                a);
}

// The f32 kernels' arguments: the strides (batch, head, seq) of q, k, v,
// dO and the outputs.
void f32_strides(int64_t (&dst)[3], const int64_t* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

cudaError_t run_fwd_f32(const void* q, const void* k, const void* v,
                        void* o, float* lse, const int64_t (&st)[4][3],
                        int batch, int h, int hkv, int sq, int sk, int d,
                        int causal, float scale, cudaStream_t stream) {
  using L = FwdWideF32<FWD_W_F32>;
  F32Args a = {};
  fill_shape(a, batch, h, hkv, sq, sk, d, causal, scale, FWD_W_F32, F32_C);
  a.tiles = (sq + L::BQ - 1) / L::BQ;
  const int blocks = a.tiles * a.groups * h * batch;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse_out = lse;
  f32_strides(a.q_s, st[FQ]);
  f32_strides(a.k_s, st[FK]);
  f32_strides(a.v_s, st[FV]);
  f32_strides(a.o_s, st[FO]);
  // kF32Cluster: a cluster of a.groups blocks a row tile (consecutive
  // blocks); a launch the card cannot place is refused and returned
  if (f32_design(0, d) == kF32Cluster)
    return launch_cluster(flash_fwd_wide_f32<FWD_W_F32>, blocks, a.groups,
                          F32_THREADS, L::BYTES, stream, a);
  static_assert(FwdWideF32Groups<FWD_W_F32>::BQ == L::BQ, "row tiles");
  return launch(flash_fwd_wide_f32_groups<FWD_W_F32>, blocks, F32_THREADS,
                FwdWideF32Groups<FWD_W_F32>::BYTES, stream, a);
}

// K2 (`dkv` false: dQ into `out`) or K3 (dK into `out`, dV into `out2`)
// in f32, from flash_bwd's 21 strides
cudaError_t run_bwd_f32(bool dkv, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* out, void* out2,
                        const int64_t (*st)[3], int batch, int h, int hkv,
                        int sq, int sk, int d, int causal, float scale,
                        cudaStream_t stream) {
  F32Args a = {};
  fill_shape(a, batch, h, hkv, sq, sk, d, causal, scale,
             dkv ? DKV_W_F32 : DQ_W_F32, F32_C);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.o = static_cast<float*>(out);
  a.o2 = static_cast<float*>(out2);
  f32_strides(a.q_s, st[Q]);
  f32_strides(a.k_s, st[K]);
  f32_strides(a.v_s, st[V]);
  f32_strides(a.do_s, st[DO]);
  f32_strides(a.o_s, st[dkv ? DK : DQ]);
  if (dkv) f32_strides(a.o2_s, st[DV]);
  // kF32Cluster: a cluster of a.groups blocks a row tile (consecutive
  // blocks); a launch the card cannot place is refused and returned
  if (dkv) {
    using L = DkvWideF32<DKV_W_F32>;
    a.tiles = (sk + L::BK - 1) / L::BK;
    const int blocks = a.tiles * a.groups * hkv * batch;
    if (f32_design(2, d) == kF32Cluster)
      return launch_cluster(dkv_wide_f32<DKV_W_F32>, blocks, a.groups,
                            F32_THREADS, L::BYTES, stream, a);
    static_assert(DkvWideF32Groups<DKV_W_F32>::BK == L::BK, "key tiles");
    return launch(dkv_wide_f32_groups<DKV_W_F32>, blocks, F32_THREADS,
                  DkvWideF32Groups<DKV_W_F32>::BYTES, stream, a);
  }
  using L = DqWideF32<DQ_W_F32>;
  a.tiles = (sq + L::BQ - 1) / L::BQ;
  const int blocks = a.tiles * a.groups * h * batch;
  if (f32_design(1, d) == kF32Cluster)
    return launch_cluster(dq_wide_f32<DQ_W_F32>, blocks, a.groups,
                          F32_THREADS, L::BYTES, stream, a);
  static_assert(DqWideF32Groups<DQ_W_F32>::BQ == L::BQ, "row tiles");
  return launch(dq_wide_f32_groups<DQ_W_F32>, blocks, F32_THREADS,
                DqWideF32Groups<DQ_W_F32>::BYTES, stream, a);
}

}  // namespace

// The entry points take the per-dim kernels' arguments
// (csrc/flash_fwd.cu's flash_fwd, csrc/flash_bwd.cu's flash_bwd_dq and
// flash_bwd_dkv): element strides for the batch, head and sequence axes
// (head dim contiguous, rows 16-byte aligned; the backward's 21 in
// flash_bwd's order), lse and delta [b, h, sq] f32 contiguous, d any
// multiple of 64 (f32 from F32_MIN_D); each picks its kernel by `bf16_in`:
// bf16 (1) the wgmma kernels, f32 (0) the FFMA ones (the per-dim f32
// kernels' workspace is not needed: `ws` is ignored). Each launches one
// kernel on `stream` and returns the launch's cudaError_t (0 on success);
// none synchronises.
extern "C" int flash_wide_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bf16_in, int batch,
                              int h, int hkv, int sq, int sk, int d,
                              int64_t q_sb, int64_t q_sh, int64_t q_ss,
                              int64_t k_sb, int64_t k_sh, int64_t k_ss,
                              int64_t v_sb, int64_t v_sh, int64_t v_ss,
                              int64_t o_sb, int64_t o_sh, int64_t o_ss,
                              int causal, float scale, void* stream) {
  if (!shape_ok(bf16_in, batch, h, hkv, sq, sk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[4][3] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                            {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16_in ? run_fwd(q, k, v, o, lse, st, batch, h, hkv, sq, sk, d,
                        causal, scale, s)
              : run_fwd_f32(q, k, v, o, lse, st, batch, h, hkv, sq, sk, d,
                            causal, scale, s));
}

extern "C" int flash_wide_dq(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk,
                             void* dv, const int64_t* strides, int bf16_in,
                             int batch, int h, int hkv, int sq, int sk,
                             int d, int causal, float scale, void* ws,
                             void* stream) {
  (void)dk, (void)dv, (void)ws;
  if (!shape_ok(bf16_in, batch, h, hkv, sq, sk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = reinterpret_cast<const int64_t(*)[3]>(strides);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16_in ? run_dq(q, k, v, dout, lse, delta, dq, st, batch, h, hkv, sq,
                       sk, d, causal, scale, s)
              : run_bwd_f32(false, q, k, v, dout, lse, delta, dq, nullptr, st,
                            batch, h, hkv, sq, sk, d, causal, scale, s));
}

extern "C" int flash_wide_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, void* dk,
                              void* dv, const int64_t* strides, int bf16_in,
                              int batch, int h, int hkv, int sq, int sk,
                              int d, int causal, float scale, void* ws,
                              void* stream) {
  (void)dq, (void)ws;
  if (!shape_ok(bf16_in, batch, h, hkv, sq, sk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = reinterpret_cast<const int64_t(*)[3]>(strides);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16_in ? run_dkv(q, k, v, dout, lse, delta, dk, dv, st, batch, h, hkv,
                        sq, sk, d, causal, scale, s)
              : run_bwd_f32(true, q, k, v, dout, lse, delta, dk, dv, st,
                            batch, h, hkv, sq, sk, d, causal, scale, s));
}

// The output columns one block owns (W) in bf16's K1 (`kernel` 0), K2 (1)
// and K3 (2) and in f32's (3, 4, 5), or -1: ceil(d / W) blocks cover a row
// tile's head dim.
extern "C" int flash_wide_columns(int kernel) {
  const int w[6] = {FWD_W, DQ_W, DKV_W, FWD_W_F32, DQ_W_F32, DKV_W_F32};
  return kernel >= 0 && kernel < 6 ? w[kernel] : -1;
}

// The bf16 design (WideDesign: kWideGroups 1, kWideCluster 2) K1 (`kernel`
// 0), K2 (1) or K3 (2) runs at head dim d in this build; chip_smoke.py
// labels its timings by it.
extern "C" int flash_wide_design(int kernel, int d) {
  return wide_design(kernel, d);
}

// The clusters of ceil(d / W) blocks the bf16 K3 (`kernel` 2) of head dim d
// holds on the current card at once (0: its launch would be refused), or
// -1 where that kernel is not launched in clusters.
extern "C" int flash_wide_clusters(int kernel, int d) {
  if (wide_design(kernel, d) != kWideCluster) return -1;
  return max_clusters(dkv_wide<DKV_W>, (d + DKV_W - 1) / DKV_W, THREADS,
                      DkvWide<DKV_W>::BYTES);
}

// The f32 design (F32Design: kF32Tiled 1, kF32Cluster 2) K1 (`kernel` 0),
// K2 (1) or K3 (2) runs at head dim d in this build; chip_smoke.py labels
// its timings by it.
extern "C" int flash_wide_f32_design(int kernel, int d) {
  return f32_design(kernel, d);
}

// The clusters of ceil(d / W) blocks the f32 K1 (`kernel` 0), K2 (1) or
// K3 (2) of head dim d holds on the current card at once
// (cudaOccupancyMaxActiveClusters; 0: its launch would be refused), or -1
// where that kernel is not launched in clusters.
extern "C" int flash_wide_f32_clusters(int kernel, int d) {
  if (kernel < 0 || kernel > 2 || f32_design(kernel, d) != kF32Cluster)
    return -1;
  const int n = (d + DQ_W_F32 - 1) / DQ_W_F32;
  return kernel == 0   ? max_clusters(flash_fwd_wide_f32<FWD_W_F32>, n,
                                      F32_THREADS,
                                      FwdWideF32<FWD_W_F32>::BYTES)
         : kernel == 1 ? max_clusters(dq_wide_f32<DQ_W_F32>, n, F32_THREADS,
                                      DqWideF32<DQ_W_F32>::BYTES)
                       : max_clusters(dkv_wide_f32<DKV_W_F32>, n,
                                      F32_THREADS,
                                      DkvWideF32<DKV_W_F32>::BYTES);
}

// The workspace K2 (`dkv` 0) or K3 (1) takes here: none, in either dtype
// (the streamed kernels do not split; csrc/flash_bwd.cu's
// flash_bwd_workspace answers for the per-dim ones).
extern "C" int64_t flash_wide_workspace(int dkv, int bf16_in, int batch,
                                        int h, int hkv, int sq, int sk,
                                        int d) {
  (void)dkv, (void)bf16_in, (void)batch, (void)h, (void)hkv, (void)sq,
      (void)sk, (void)d;
  return 0;
}
