// Flash attention in bf16 at every head dim above 512 for Hopper (sm_90a),
// with a plain C interface: K1, K2 and K3 with the head dim streamed.
//
// Replaces, at the head dims past csrc/flash_fwd.cu's and
// csrc/flash_bwd.cu's per-dim kernels (every multiple of 64 above 512, in
// bf16), the TPU kernels `_fwd_kernel` (K1), `_dq_kernel` (K2) and
// `_dkv_kernel` (K3) in service_account_auth_improvements_tpu/ops/
// flash_attention.py (113-168, 212-258, 261-310), whose rules set no upper
// bound on the head dim. What they compute, and the numerical rules, are
// the per-dim kernels' (the notes at the top of flash_fwd.cu and
// flash_bwd.cu): products take bf16 operands and accumulate in f32; K1
// rounds P to bf16 before P V, K2 forms dS = P (dP - delta) from the f32 P
// and rounds it before dS K, K3 rounds P before P^T dO and dS before
// dS^T Q; masked scores are -2e38; rows and keys past s load as zeros and
// are masked or not written; the causal mask is start-aligned.
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
// wgmmas, then a named barrier of both says the step is read, and thread 0
// reloads its stage with a TMA copy predicated inside the instruction
// (tma_4d_if), not behind a branch: the ring needs no `empty` barriers,
// and no thread branches in a score chain (ptxas serialised every wgmma
// when thread 0 refilled the ring behind a branch with a wgmma in flight).
// Keeping one chunk's wgmmas in flight while the next one's are issued
// made ptxas inject waits (C7517) and ran 3-6% slower than this, with the
// chunk loop unrolled twice, at d 768 on an H100 (PERF.md §6).
//
// What bounds it on an H100: the useful work is operations, 2 d flops per
// causal pair for each product (K1 2, K2 3, K3 4), hundreds of flops per
// byte of q, k, v and dO. The streamed design also reads each score tile's
// operands from L2 once per tile and group, tens of flops per byte, and
// that bounds it: at d 768 the three load 7-8 TB/s from L2 (counted from
// their loads) and reach 0.10-0.16 of their bound (PERF.md §6). ROADMAP
// queue 2's lever 8, a cluster of ceil(d / 256) blocks that add their
// partial scores through distributed shared memory, would read each chunk
// and form the scores once.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

using namespace hopper;
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

// A 5-D map over a bf16 [b, heads, s, d] tensor whose box is `cols`
// columns (cols / 64 column blocks) of `rows` rows: hopper::tmap_bf16_tile's
// layout for one group of columns, the group's first column block at
// coordinate 2. Column blocks past d arrive as zeros.
cudaError_t tmap_cols(CUtensorMap* map, const void* base, int d, int s,
                      int heads, int b, int64_t ss, int64_t sh, int64_t sb,
                      int rows, int cols) {
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
// (b, h) and columns [grp W, grp W + W) of O. Per key tile of 64 keys:
//   S = Q K^T   over the head dim, chunk by chunk (wgmma m64n64k16 x 4 a
//               chunk, Q's and K's chunks of the step from one stage);
//   the online softmax of flash_fwd_wgmma in f32 (exp2, log2 e folded into
//   the scale, the row max over a quad of lanes, the row sum reduced once,
//   at the end);
//   O[:, own] += P V[:, own]   P rounded to bf16 and re-packed in
//               registers as the A operand, V's W columns of the tile one
//               TMA box in a ring of two.
// Shared memory: STAGES steps of (a 128-row chunk of Q, a 64-key chunk of
// K) and two V tiles of 64 keys x W columns.

struct FwdArgs {
  CUtensorMap tq, tk;  // 64-column chunks of 128 query rows, of 64 keys
  CUtensorMap tv;      // a group's W columns of 64 keys
  void* o;
  float* lse;
  int64_t o_sb, o_sh, o_ss;
  int h, hkv, batch, sq, sk, d, causal, nq, groups, chunks;
  float scale, scale_log2;
};

template <int W>
struct FwdWide {
  static constexpr int BQ = 128;  // query rows a block: 64 a warpgroup
  static constexpr int BK = 64;   // keys a tile
  static constexpr int Q_BYTES = BQ * ROW;  // a chunk of Q
  static constexpr int K_BYTES = BK * ROW;  // a chunk of K
  static constexpr int STEP = Q_BYTES + K_BYTES;
  static constexpr int V_CB = BK * ROW;  // V's column block stride
  static constexpr int V_BYTES = W / 64 * V_CB;
  static constexpr int V_STAGES = 2;
  static constexpr int FIT = (SMEM_MAX - 2048 - V_STAGES * V_BYTES) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int V_OFF = STAGES * STEP;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * V_BYTES;
  // mbarriers: full[STAGES], v_full[2]
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

  // step j (where p holds): chunk j % nc of the block's Q rows and of key
  // tile j / nc's keys
  auto load_step = [&](bool p, int j) {
    const int s = j % STAGES, col = j % nc * 64;
    const uint32_t dst = base + s * L::STEP, bar = full + 8 * s;
    expect_tx_if(p, bar, L::STEP);
    tma_4d_if(p, dst, &a.tq, bar, col, q0, ih, ib);
    tma_4d_if(p, dst + L::Q_BYTES, &a.tk, bar, col, j / nc * BK, ikv, ib);
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
  if (lead) {
    for (int j = 0; j < STAGES && j < steps; ++j) load_step(true, j);
    for (int i = 0; i < VS && i < nk; ++i) load_v(true, i);
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
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other: its stage takes
      load_step(lead && j + STAGES < steps, j + STAGES);
      // past the last tile's P V in both: its V stage takes tile i + 1
      load_v(lead && cc == 0 && i >= 1 && i + 1 < nk, i + 1);
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
//       MN-major, in a ring of two.
// 32-key tiles keep S and dP at 16 registers each beside dQ's 128
// (dq_rows8<256>'s choice). dQ is scaled once, at the end. Shared memory:
// STAGES steps of (128-row chunks of Q and dO, 32-key chunks of K and V)
// and two tiles of K's W columns.

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
  static constexpr int KG_STAGES = 2;
  static constexpr int FIT =
      (SMEM_MAX - 2048 - KG_STAGES * KG_BYTES) / STEP;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int KG_OFF = STAGES * STEP;
  static constexpr int BAR_OFF = KG_OFF + KG_STAGES * KG_BYTES;
  // mbarriers: full[STAGES], kg_full[2]
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

  // step j (where p holds): chunk j % nc of the block's Q and dO rows and
  // of key tile j / nc's K and V
  auto load_step = [&](bool p, int j) {
    const int s = j % STAGES, col = j % nc * 64, k0 = j / nc * BK;
    const uint32_t dst = base + s * L::STEP, bar = full + 8 * s;
    expect_tx_if(p, bar, L::STEP);
    tma_4d_if(p, dst, &a.tq, bar, col, q0, ih, ib);
    tma_4d_if(p, dst + L::DO_OFF, &a.tdo, bar, col, q0, ih, ib);
    tma_4d_if(p, dst + L::K_OFF, &a.tk, bar, col, k0, ikv, ib);
    tma_4d_if(p, dst + L::V_OFF, &a.tv, bar, col, k0, ikv, ib);
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
  if (lead) {
    for (int j = 0; j < STAGES && j < steps; ++j) load_step(true, j);
    for (int i = 0; i < KS && i < nk; ++i) load_kg(true, i);
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
      wgmma_wait<0>();       // this warpgroup has read step j
      bar_sync(1, THREADS);  // and so has the other: its stage takes
      load_step(lead && j + STAGES < steps, j + STAGES);
      // past the last tile's dS K in both: its stage of K takes tile i + 1
      load_kg(lead && cc == 0 && i >= 1 && i + 1 < nk, i + 1);
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
// `dkv_wide<W>`: a block owns 64 keys of one (b, KV head) and columns
// [grp W, grp W + W) of dK and dV: warpgroup 0 holds dV, warpgroup 1 dK
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
  CUtensorMap tqg, tdog;  // a group's W columns of 64 query rows
  const float* lse;       // [b, h, sq] contiguous
  const float* delta;
  void* dk;
  void* dv;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int h, hkv, batch, sq, sk, d, causal, nk, groups, chunks;
  float scale, scale_log2;
};

template <int W>
struct DkvWide {
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
dkv_wide(const __grid_constant__ DkvArgs a) {
  using L = DkvWide<W>;
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
// columns.
template <typename Args>
void fill_shape(Args& a, int batch, int h, int hkv, int sq, int sk, int d,
                int causal, float scale, int w) {
  a.h = h;
  a.hkv = hkv;
  a.batch = batch;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.causal = causal;
  a.groups = (d + w - 1) / w;
  a.chunks = d / 64;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
}

bool shape_ok(int bf16_in, int batch, int h, int hkv, int sq, int sk, int d) {
  return bf16_in && batch > 0 && sq > 0 && sk > 0 && hkv > 0 &&
         h % hkv == 0 && d > 0 && d % 64 == 0;
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

cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const int64_t (*st)[3], int batch,
                    int h, int hkv, int sq, int sk, int d, int causal,
                    float scale, cudaStream_t stream) {
  using L = DkvWide<DKV_W>;
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
  cudaError_t err;
  if ((err = chunk_map(&a.tk, k, st[K], d, sk, hkv, batch, L::BK)) ||
      (err = chunk_map(&a.tv, v, st[V], d, sk, hkv, batch, L::BK)) ||
      (err = chunk_map(&a.tq, q, st[Q], d, sq, h, batch, L::BQ)) ||
      (err = chunk_map(&a.tdo, dout, st[DO], d, sq, h, batch, L::BQ)) ||
      (err = group_map(&a.tqg, q, st[Q], d, sq, h, batch, L::BQ, DKV_W)) ||
      (err = group_map(&a.tdog, dout, st[DO], d, sq, h, batch, L::BQ,
                       DKV_W)))
    return err;
  return launch(dkv_wide<DKV_W>, a.nk * a.groups * hkv * batch, THREADS,
                L::BYTES, stream, a);
}

}  // namespace

// The entry points take the per-dim kernels' arguments
// (csrc/flash_fwd.cu's flash_fwd, csrc/flash_bwd.cu's flash_bwd_dq and
// flash_bwd_dkv): element strides for the batch, head and sequence axes
// (head dim contiguous, rows 16-byte aligned; the backward's 21 in
// flash_bwd's order), lse and delta [b, h, sq] f32 contiguous, d any
// multiple of 64; bf16 only (bf16 = 0 is refused). Each launches one
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
  return static_cast<int>(run_fwd(q, k, v, o, lse, st, batch, h, hkv, sq,
                                  sk, d, causal, scale,
                                  static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(run_dq(
      q, k, v, dout, lse, delta, dq,
      reinterpret_cast<const int64_t(*)[3]>(strides), batch, h, hkv, sq, sk,
      d, causal, scale, static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(run_dkv(
      q, k, v, dout, lse, delta, dk, dv,
      reinterpret_cast<const int64_t(*)[3]>(strides), batch, h, hkv, sq, sk,
      d, causal, scale, static_cast<cudaStream_t>(stream)));
}

// The output columns one block owns (W) in K1 (`kernel` 0), K2 (1) and
// K3 (2), or -1: ceil(d / W) blocks cover a row tile's head dim.
extern "C" int flash_wide_columns(int kernel) {
  return kernel == 0 ? FWD_W : kernel == 1 ? DQ_W : kernel == 2 ? DKV_W : -1;
}
