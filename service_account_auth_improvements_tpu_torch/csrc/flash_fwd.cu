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
// bound by the tensor cores. The bf16 kernel for d 64 and 128
// (`flash_fwd_wgmma`) is built for them:
// - a block owns 128 query rows: one producer warpgroup and two consumer
//   warpgroups of 64 rows each (one wgmma M tile); setmaxnreg gives the
//   producer 24 registers and each consumer thread 240;
// - one producer thread issues TMA loads: Q once, then K and V tiles of 128
//   keys into a 2-stage ring of shared memory, each stage with `full`
//   mbarriers (K and V apart, so QK^T starts before V lands) and an `empty`
//   mbarrier the consumers release;
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (K-major, 128-byte swizzle); the online softmax runs in registers with
//   exp2 and log2(e) folded into the scale, the row max over a quad of
//   lanes, and the row sum reduced across lanes only once, at the end;
// - P is rounded to bf16 and re-packed in registers as the A operand of
//   O += P V (wgmma m64nDk16, V read MN-major from shared memory): S never
//   reaches shared memory;
// - heaviest causal query tiles launch first, and neighbouring blocks take
//   the heads of one KV group, which then share K/V in L2.
// bf16 d 192 and 256 (no preset uses them) keep the first kernel,
// `flash_fwd_bf16` (mma.sync m16n8k16, one 64-row tile per 4-warp block,
// K/V staged through registers): the entry point dispatches on d.
//
// float32 inputs take a third, scalar kernel: true f32 FMA on CUDA cores,
// no TF32, so f32 parity with the reference holds.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ------------------------------------------------ bf16, d 64 and 128: wgmma

constexpr int WG = 128;            // threads per warpgroup
constexpr int FWD_BQ = 128;        // query rows per block: 64 per consumer
constexpr int FWD_BK = 128;        // keys per K/V stage
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 3 * WG;  // producer + two consumers

struct FwdArgs {
  CUtensorMap tq, tk, tv;  // boxes of 64 columns x 128 rows
  void* o;
  float* lse;
  int64_t o_sb, o_sh, o_ss;
  int h, hkv, batch, sq, sk, causal, nq;
  float scale, scale_log2;
};

// Shared memory: Q, then the K stages, the V stages and the mbarriers. Each
// tile is D / 64 column blocks of (rows x 128 bytes).
template <int D>
struct FwdSmem {
  static constexpr int Q_CB = FWD_BQ * 128;   // column block stride
  static constexpr int KV_CB = FWD_BK * 128;
  static constexpr int Q_BYTES = FWD_BQ * D * 2;
  static constexpr int KV_BYTES = FWD_BK * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + FWD_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + FWD_STAGES * KV_BYTES;
  // mbarriers: q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * FWD_STAGES) + 1024;
};

template <int D>
__device__ __forceinline__ void fwd_consumer(const FwdArgs& a, uint32_t base,
                                             int q0, int ih, int ib, int nk) {
  using namespace hopper;
  using L = FwdSmem<D>;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * FWD_STAGES,
                 empty = v_full + 8 * FWD_STAGES;
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
    const int s = i % FWD_STAGES;
    const uint32_t ph = (i / FWD_STAGES) & 1;
    const int k0 = i * FWD_BK;
    const uint32_t k_addr = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_addr = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T: 64 rows x 128 keys
    float sc[FWD_BK / 2];
    mbar_wait(k_full + 8 * s, ph);
    wgmma_fence();
    wgmma_ss<FWD_BK, D / 16, L::Q_CB, L::KV_CB>(
        sc, desc_sw128(q_addr, 16, 1024), desc_sw128(k_addr, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask (only tiles that cross the diagonal or the ragged end)
    if ((a.causal && k0 + FWD_BK - 1 > r0) || k0 + FWD_BK > a.sk) {
#pragma unroll
      for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= a.sk || (a.causal && col > row)) sc[4 * j + e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < FWD_BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = fast_exp2((m0 - mx0) * a.scale_log2);
    const float alpha1 = fast_exp2((m1 - mx1) * a.scale_log2);
    const float ms0 = mx0 * a.scale_log2, ms1 = mx1 * a.scale_log2;
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_BK / 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], a.scale_log2, -ms0));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], a.scale_log2, -ms0));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], a.scale_log2, -ms1));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], a.scale_log2, -ms1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // P in V's dtype, re-packed as the A operand; keys 16kk .. 16kk + 15
    uint32_t pf[FWD_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V
    mbar_wait(v_full + 8 * s, ph);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    wgmma_rs_t<D, FWD_BK / 16>(o, pf, desc_sw128(v_addr, L::KV_CB, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + ib * a.o_sb + ih * a.o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (row0 < a.sq)
      *reinterpret_cast<uint32_t*>(op + row0 * a.o_ss + col) =
          pack_bf16x2(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (row1 < a.sq)
      *reinterpret_cast<uint32_t*>(op + row1 * a.o_ss + col) =
          pack_bf16x2(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
  if (tq == 0) {
    float* lse = a.lse + (static_cast<int64_t>(ib) * a.h + ih) * a.sq;
    if (row0 < a.sq) lse[row0] = m0 * a.scale + logf(l0);
    if (row1 < a.sq) lse[row1] = m1 * a.scale + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ FwdArgs a) {
  using namespace hopper;
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t q_full = bar, k_full = bar + 8,
                 v_full = k_full + 8 * FWD_STAGES,
                 empty = v_full + 8 * FWD_STAGES;

  // heaviest query tiles first; neighbouring blocks share a KV group
  const int hb = a.h * a.batch;
  const int iq = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int ih = static_cast<int>(blockIdx.x) % hb % a.h;
  const int ib = static_cast<int>(blockIdx.x) % hb / a.h;
  const int q0 = iq * FWD_BQ;
  int nk = (a.sk + FWD_BK - 1) / FWD_BK;
  if (a.causal) nk = min(nk, (q0 + FWD_BQ + FWD_BK - 1) / FWD_BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
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
        const int s = i % FWD_STAGES;
        mbar_wait(empty + 8 * s, ((i / FWD_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tk, k_full + 8 * s, cb * 64, i * FWD_BK, ikv, ib);
        mbar_arrive_expect_tx(v_full + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + cb * L::KV_CB,
                      &a.tv, v_full + 8 * s, cb * 64, i * FWD_BK, ikv, ib);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    fwd_consumer<D>(a, base, q0, ih, ib, nk);
  }
}

// ---------------------------------------------- bf16, d 192 and 256: mma.sync

constexpr int TC_BQ = 64;   // query rows per block: 16 per warp
constexpr int TC_BK = 64;   // keys per tile
constexpr int TC_THREADS = 128;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment ownership (PTX m16n8k16): lane = 4 * g + t. In a 16x8 f32
// accumulator, c[0], c[1] are row g, columns 2t, 2t+1 and c[2], c[3] are
// row g + 8. Each warp owns 16 query rows: row0 = its base + g, row1 =
// row0 + 8; the four lanes sharing g hold one row between them.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const Params p) {
  constexpr int LDS = D + 8;  // padded shared row: conflict-free fragments
  constexpr int NT = TC_BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + TC_BK * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q0 = blockIdx.x * TC_BQ;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const int ikv = ih / (p.h / p.hkv);
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + ib * p.k_sb + ikv * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + ib * p.v_sb + ikv * p.v_sh;

  // Q as A fragments for the whole head dim, in registers for all tiles.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool in0 = row0 < p.sq, in1 = row1 < p.sq;
    qf[kk][0] = in0 ? ld32(q + row0 * p.q_ss + c) : 0u;
    qf[kk][1] = in1 ? ld32(q + row1 * p.q_ss + c) : 0u;
    qf[kk][2] = in0 ? ld32(q + row0 * p.q_ss + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(q + row1 * p.q_ss + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nk = key_tiles(p, q0, TC_BQ, TC_BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * TC_BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < TC_BK * D / 8; c += TC_THREADS) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const uint4*>(k + (k0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + col) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDS + col) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // scale, mask, and the tile's row maxima
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[nt][e] * p.scale;
        if (col >= p.sk || (p.causal && col > row)) x = kNegInf;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P V: P (cast to bf16, the V dtype) is S's accumulator
    // fragment re-packed as A; keys 16j..16j+15 are S tiles 2j and 2j+1.
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      const uint32_t a[4] = {
          pack_f32(s[2 * j][0], s[2 * j][1]),
          pack_f32(s[2 * j][2], s[2 * j][3]),
          pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]),
      };
      const __nv_bfloat16* vr = Vs + (j * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vc = vr + dt * 8;
        mma_bf16(acc[dt], a, pack_bf16(vc[0], vc[LDS]),
                 pack_bf16(vc[8 * LDS], vc[9 * LDS]));
      }
    }
  }

  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + ib * p.o_sb + ih * p.o_sh;
  float* lse = p.lse + (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(o + row0 * p.o_ss + c) =
          pack_f32(acc[dt][0] / l0, acc[dt][1] / l0);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(o + row1 * p.o_ss + c) =
          pack_f32(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (t == 0) {
    if (row0 < p.sq) lse[row0] = m0 + logf(l0);
    if (row1 < p.sq) lse[row1] = m1 + logf(l1);
  }
}

// ------------------------------------------------ f32: CUDA cores

constexpr int SC_BQ = 32;  // query rows per block: 4 threads per row
constexpr int SC_BK = 32;  // keys per tile
constexpr int SC_THREADS = 128;

// Thread (r, c4) = (tid / 4, tid % 4) owns query row r, the scores of
// keys c4 + 4j of each tile, and output columns c4 + 4jj.
template <int D>
__global__ void __launch_bounds__(SC_THREADS)
flash_fwd_f32(const Params p) {
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

template <int D>
cudaError_t run_wgmma(const Params& p, int batch, cudaStream_t stream) {
  FwdArgs a;
  cudaError_t err;
  if ((err = hopper::tmap_bf16(&a.tq, p.q, D, p.sq, p.h, batch, p.q_ss,
                               p.q_sh, p.q_sb, FWD_BQ)) ||
      (err = hopper::tmap_bf16(&a.tk, p.k, D, p.sk, p.hkv, batch, p.k_ss,
                               p.k_sh, p.k_sb, FWD_BK)) ||
      (err = hopper::tmap_bf16(&a.tv, p.v, D, p.sk, p.hkv, batch, p.v_ss,
                               p.v_sh, p.v_sb, FWD_BK)))
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
  a.nq = (p.sq + FWD_BQ - 1) / FWD_BQ;
  a.scale = p.scale;
  a.scale_log2 = p.scale * hopper::kLog2e;
  return hopper::launch(flash_fwd_wgmma<D>, a.nq * p.h * batch, FWD_THREADS,
                        FwdSmem<D>::BYTES, stream, a);
}

template <int D>
cudaError_t run(const Params& p, int batch, int bf16, cudaStream_t stream) {
  if constexpr (D == 64 || D == 128) {
    if (bf16) return run_wgmma<D>(p, batch, stream);
  } else if (bf16) {
    const dim3 grid((p.sq + TC_BQ - 1) / TC_BQ, p.h, batch);
    const size_t smem = 2 * TC_BK * (D + 8) * sizeof(__nv_bfloat16);
    return launch(flash_fwd_bf16<D>, grid, TC_THREADS, smem, stream, p);
  }
  const dim3 grid((p.sq + SC_BQ - 1) / SC_BQ, p.h, batch);
  const size_t smem =
      ((SC_BQ + SC_BK) * (D + 1) + SC_BK * D + SC_BQ * (SC_BK + 1)) *
      sizeof(float);
  return launch(flash_fwd_f32<D>, grid, SC_THREADS, smem, stream, p);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
