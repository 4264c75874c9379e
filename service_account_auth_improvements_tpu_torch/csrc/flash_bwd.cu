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
//   K2: one block per (batch, head, 64-row query tile), looping over the key
//       tiles up to the diagonal (causal tiles wholly in the future are
//       skipped, as in K1);
//   K3: one block per (batch, KV head, 64-key tile), looping over the g query
//       heads of the group and over the query tiles from the diagonal on.
// Each sum is taken inside one block in a fixed order: deterministic, no
// atomics, and dQ and dK/dV stay two passes, as in the reference.
//
// Layout and ragged tails as in csrc/flash_fwd.cu: element strides for the
// batch, head and sequence axes (head dim contiguous), so the model's
// [b, s, h, d] tensors are read and written in place; rows past s load as
// zero, keys past s score -2e38, query rows past s get P = 0 in K3 and are
// not written by K2. On the real rows that is the reference's zero-padded
// computation exactly (its padded rows have dO = 0 and delta = 0).
//
// What bounds it on an H100: at the training shape (s 2048, d 128) K2 does
// 3 and K3 4 products of 2 s^2 d / 2 flops per (b, h) against ~6 s d bytes:
// hundreds of flops per byte, so both are bound by operations. The bf16
// kernels run every product on the tensor cores with mma.sync m16n8k16 (f32
// accumulate). K2 keeps Q and dO as A fragments in registers for the whole key
// loop; K3 keeps its K/V tile in shared memory and streams Q/dO tiles through
// it. The key (K2) or query (K3) tile is walked in 16-wide chunks: S and dP of
// one chunk are re-packed in registers as the A operand of the next product,
// so no score tile ever reaches shared or global memory. This first version
// is simple on purpose: no cp.async/TMA pipelining, no wgmma.
//
// float32 inputs take scalar kernels: true f32 FMA on CUDA cores, no TF32, so
// f32 parity with the reference holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------ bf16: tensor cores

constexpr int TC_BQ = 64;  // query rows per tile
constexpr int TC_BK = 64;  // keys per tile (K3's tile equals K2's)
constexpr int TC_THREADS = 128;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
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

// Copy `rows` rows of D bf16 (stride `ss` elements) into shared memory with
// row pitch LDS, zero-filling rows at or past `limit`.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ss, int r0, int limit,
                                          int rows, int tid) {
  constexpr int LDS = D + 8;
  for (int c = tid; c < rows * D / 8; c += TC_THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + col);
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = x;
  }
}

// Fragment ownership (PTX m16n8k16): lane = 4 * g + t. In a 16x8 f32
// accumulator, c[0], c[1] are row g, columns 2t, 2t+1 and c[2], c[3] are row
// g + 8. An A fragment holds rows g and g + 8, columns 2t, 2t+1 and
// 2t+8, 2t+9; a B fragment holds column g, rows 2t, 2t+1 and 2t+8, 2t+9.

// K2: dQ for one (b, h, 64-row query tile). Warp w owns query rows
// q0 + 16w + {g, g + 8}.
template <int D>
__global__ void __launch_bounds__(TC_THREADS) dq_bf16(const Params p) {
  constexpr int LDS = D + 8;  // padded shared row: conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TC_BK * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (p.h / p.hkv);
  const int q0 = blockIdx.x * TC_BQ;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bool in0 = row0 < p.sq, in1 = row1 < p.sq;

  const bf16* q = head_ptr<bf16>(p.q, p.st[Q], ib, ih);
  const bf16* dout = head_ptr<bf16>(p.dout, p.st[DO], ib, ih);
  const bf16* k = head_ptr<bf16>(p.k, p.st[K], ib, ikv);
  const bf16* v = head_ptr<bf16>(p.v, p.st[V], ib, ikv);
  const int64_t q_ss = p.st[Q][2], o_ss = p.st[DO][2];

  // Q and dO as A fragments for the whole head dim, in registers.
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = in0 ? ld32(q + row0 * q_ss + c) : 0u;
    qf[kk][1] = in1 ? ld32(q + row1 * q_ss + c) : 0u;
    qf[kk][2] = in0 ? ld32(q + row0 * q_ss + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(q + row1 * q_ss + c + 8) : 0u;
    of[kk][0] = in0 ? ld32(dout + row0 * o_ss + c) : 0u;
    of[kk][1] = in1 ? ld32(dout + row1 * o_ss + c) : 0u;
    of[kk][2] = in0 ? ld32(dout + row0 * o_ss + c + 8) : 0u;
    of[kk][3] = in1 ? ld32(dout + row1 * o_ss + c + 8) : 0u;
  }
  const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
  const float lse0 = in0 ? p.lse[rowbase + row0] : 0.f;
  const float lse1 = in1 ? p.lse[rowbase + row1] : 0.f;
  const float dl0 = in0 ? p.delta[rowbase + row0] : 0.f;
  const float dl1 = in1 ? p.delta[rowbase + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int nk = (p.sk + TC_BK - 1) / TC_BK;
  if (p.causal) nk = min(nk, (q0 + TC_BQ + TC_BK - 1) / TC_BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * TC_BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(Ks, k, p.st[K][2], k0, p.sk, TC_BK, tid);
    load_tile<D>(Vs, v, p.st[V][2], k0, p.sk, TC_BK, tid);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      // S and dP for this warp's 16 rows and keys k0 + 16j .. + 15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        const bf16* kr = Ks + (j * 16 + nt * 8 + g) * LDS + 2 * t;
        const bf16* vr = Vs + (j * 16 + nt * 8 + g) * LDS + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_bf16(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
          mma_bf16(dp[nt], of[kk], ld32(vr + kk * 16),
                   ld32(vr + kk * 16 + 8));
        }
      }
      // dS = P (f32) * (dP - delta), then rounded to K's dtype as the A
      // operand of dS K
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 16 + nt * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          const int row = hi ? row1 : row0;
          float x = s[nt][e] * p.scale;
          if (col >= p.sk || (p.causal && col > row)) x = kNegInf;
          const float pr = expf(x - (hi ? lse1 : lse0));
          s[nt][e] = pr * (dp[nt][e] - (hi ? dl1 : dl0));
        }
      }
      const uint32_t a[4] = {
          pack_f32(s[0][0], s[0][1]), pack_f32(s[0][2], s[0][3]),
          pack_f32(s[1][0], s[1][1]), pack_f32(s[1][2], s[1][3]),
      };
      const bf16* kc = Ks + (j * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* c = kc + dt * 8;
        mma_bf16(acc[dt], a, pack_bf16(c[0], c[LDS]),
                 pack_bf16(c[8 * LDS], c[9 * LDS]));
      }
    }
  }

  bf16* dq = head_ptr_mut<bf16>(p.dq, p.st[DQ], ib, ih);
  const int64_t dq_ss = p.st[DQ][2];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<uint32_t*>(dq + row0 * dq_ss + c) =
          pack_f32(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(dq + row1 * dq_ss + c) =
          pack_f32(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
  }
}

// K3: dK and dV for one (b, KV head, 64-key tile). Warp w owns keys
// k0 + 16w + {g, g + 8}; the block walks the group's query heads and the
// query tiles from the diagonal on, accumulating in registers.
template <int D>
__global__ void __launch_bounds__(TC_THREADS) dkv_bf16(const Params p) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TC_BK * LDS;
  bf16* Qs = Vs + TC_BK * LDS;
  bf16* Os = Qs + TC_BQ * LDS;  // dO
  float* Ls = reinterpret_cast<float*>(Os + TC_BQ * LDS);
  float* Ds = Ls + TC_BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ikv = blockIdx.y, ib = blockIdx.z;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.x * TC_BK;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;

  load_tile<D>(Ks, head_ptr<bf16>(p.k, p.st[K], ib, ikv), p.st[K][2], k0,
               p.sk, TC_BK, tid);
  load_tile<D>(Vs, head_ptr<bf16>(p.v, p.st[V], ib, ikv), p.st[V][2], k0,
               p.sk, TC_BK, tid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  const int nq = (p.sq + TC_BQ - 1) / TC_BQ;
  // causal: query tiles whose last row reaches this tile's first key
  const int iq0 = p.causal ? k0 / TC_BQ : 0;
  const bf16* ka = Ks + (warp * 16 + g) * LDS + 2 * t;
  const bf16* va = Vs + (warp * 16 + g) * LDS + 2 * t;
  for (int hg = 0; hg < group; ++hg) {
    const int ih = ikv * group + hg;
    const bf16* q = head_ptr<bf16>(p.q, p.st[Q], ib, ih);
    const bf16* dout = head_ptr<bf16>(p.dout, p.st[DO], ib, ih);
    const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * TC_BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D>(Qs, q, p.st[Q][2], q0, p.sq, TC_BQ, tid);
      load_tile<D>(Os, dout, p.st[DO][2], q0, p.sq, TC_BQ, tid);
      for (int r = tid; r < TC_BQ; r += TC_THREADS) {
        const bool in = q0 + r < p.sq;
        Ls[r] = in ? p.lse[rowbase + q0 + r] : 0.f;
        Ds[r] = in ? p.delta[rowbase + q0 + r] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int j = 0; j < TC_BQ / 16; ++j) {
        // S^T = K Q^T and dP^T = V dO^T for 16 keys x query rows
        // q0 + 16j .. + 15
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kf[4] = {
              ld32(ka + kk * 16), ld32(ka + 8 * LDS + kk * 16),
              ld32(ka + kk * 16 + 8), ld32(ka + 8 * LDS + kk * 16 + 8)};
          const uint32_t vf[4] = {
              ld32(va + kk * 16), ld32(va + 8 * LDS + kk * 16),
              ld32(va + kk * 16 + 8), ld32(va + 8 * LDS + kk * 16 + 8)};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int r = (j * 16 + nt * 8 + g) * LDS + kk * 16 + 2 * t;
            mma_bf16(s[nt], kf, ld32(Qs + r), ld32(Qs + r + 8));
            mma_bf16(dp[nt], vf, ld32(Os + r), ld32(Os + r + 8));
          }
        }
        // P rounded to dO's dtype; dS = P * (dP - delta) from that P
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = j * 16 + nt * 8 + 2 * t + (e & 1);
            const int key = e < 2 ? key0 : key1;
            float x = s[nt][e] * p.scale;
            if (q0 + ql >= p.sq || (p.causal && key > q0 + ql)) x = kNegInf;
            const float pr =
                __bfloat162float(__float2bfloat16_rn(expf(x - Ls[ql])));
            s[nt][e] = pr;
            dp[nt][e] = pr * (dp[nt][e] - Ds[ql]);
          }
        }
        const uint32_t pa[4] = {
            pack_f32(s[0][0], s[0][1]), pack_f32(s[0][2], s[0][3]),
            pack_f32(s[1][0], s[1][1]), pack_f32(s[1][2], s[1][3]),
        };
        const uint32_t da[4] = {
            pack_f32(dp[0][0], dp[0][1]), pack_f32(dp[0][2], dp[0][3]),
            pack_f32(dp[1][0], dp[1][1]), pack_f32(dp[1][2], dp[1][3]),
        };
        // dV += P^T dO, dK += dS^T Q over these 16 query rows
        const bf16* oc = Os + (j * 16 + 2 * t) * LDS + g;
        const bf16* qc = Qs + (j * 16 + 2 * t) * LDS + g;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const bf16* o = oc + dt * 8;
          const bf16* c = qc + dt * 8;
          mma_bf16(dv[dt], pa, pack_bf16(o[0], o[LDS]),
                   pack_bf16(o[8 * LDS], o[9 * LDS]));
          mma_bf16(dk[dt], da, pack_bf16(c[0], c[LDS]),
                   pack_bf16(c[8 * LDS], c[9 * LDS]));
        }
      }
    }
  }

  bf16* dkp = head_ptr_mut<bf16>(p.dk, p.st[DK], ib, ikv);
  bf16* dvp = head_ptr_mut<bf16>(p.dv, p.st[DV], ib, ikv);
  const int64_t dk_ss = p.st[DK][2], dv_ss = p.st[DV][2];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (key0 < p.sk) {
      *reinterpret_cast<uint32_t*>(dkp + key0 * dk_ss + c) =
          pack_f32(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + key0 * dv_ss + c) =
          pack_f32(dv[dt][0], dv[dt][1]);
    }
    if (key1 < p.sk) {
      *reinterpret_cast<uint32_t*>(dkp + key1 * dk_ss + c) =
          pack_f32(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + key1 * dv_ss + c) =
          pack_f32(dv[dt][2], dv[dt][3]);
    }
  }
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

// K2, f32. Thread (r, c4) = (tid / 4, tid % 4) owns query row r, the scores
// of keys c4 + 4j of each tile, and dQ columns c4 + 4jj.
template <int D>
__global__ void __launch_bounds__(SC_THREADS) dq_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [SC_BQ][D + 1]
  float* Os = Qs + SC_BQ * (D + 1);            // dO, [SC_BQ][D + 1]
  float* Ks = Os + SC_BQ * (D + 1);            // [SC_BK][D + 1]
  float* Vs = Ks + SC_BK * (D + 1);            // [SC_BK][D + 1]
  float* Ss = Vs + SC_BK * (D + 1);            // dS, [SC_BQ][SC_BK + 1]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (p.h / p.hkv);
  const int q0 = blockIdx.x * SC_BQ;
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

  float acc[D / 4];
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) acc[jj] = 0.f;

  int nk = (p.sk + SC_BK - 1) / SC_BK;
  if (p.causal) nk = min(nk, (q0 + SC_BQ + SC_BK - 1) / SC_BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * SC_BK;
    __syncthreads();
    load_tile_f32<D>(Ks, k, p.st[K][2], k0, p.sk, SC_BK, tid);
    load_tile_f32<D>(Vs, v, p.st[V][2], k0, p.sk, SC_BK, tid);
    __syncthreads();

    const float* qr = Qs + r * (D + 1);
    const float* orow = Os + r * (D + 1);
#pragma unroll
    for (int j = 0; j < SC_BK / 4; ++j) {
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
      Ss[r * (SC_BK + 1) + c] = expf(x - lse) * (dp - dl);
    }
    __syncwarp();  // row r's dS is written and read by the same four lanes
    for (int c = 0; c < SC_BK; ++c) {
      const float ds = Ss[r * (SC_BK + 1) + c];
      const float* kr = Ks + c * (D + 1) + c4;
#pragma unroll
      for (int jj = 0; jj < D / 4; ++jj)
        acc[jj] = fmaf(ds, kr[4 * jj], acc[jj]);
    }
  }

  if (row < p.sq) {
    float* dq = head_ptr_mut<float>(p.dq, p.st[DQ], ib, ih) +
                row * p.st[DQ][2];
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) dq[c4 + 4 * jj] = acc[jj] * p.scale;
  }
}

// K3, f32. Thread (r, c4) owns key r of the tile, the scores of query rows
// c4 + 4j of each query tile, and dK/dV columns c4 + 4jj.
template <int D>
__global__ void __launch_bounds__(SC_THREADS) dkv_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [SC_BK][D + 1]
  float* Vs = Ks + SC_BK * (D + 1);            // [SC_BK][D + 1]
  float* Qs = Vs + SC_BK * (D + 1);            // [SC_BQ][D + 1]
  float* Os = Qs + SC_BQ * (D + 1);            // dO, [SC_BQ][D + 1]
  float* Ps = Os + SC_BQ * (D + 1);            // [SC_BK][SC_BQ + 1]
  float* Ss = Ps + SC_BK * (SC_BQ + 1);        // dS, [SC_BK][SC_BQ + 1]
  float* Ls = Ss + SC_BK * (SC_BQ + 1);        // [SC_BQ]
  float* Ds = Ls + SC_BQ;                      // [SC_BQ]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int ikv = blockIdx.y, ib = blockIdx.z;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.x * SC_BK;
  const int key = k0 + r;
  load_tile_f32<D>(Ks, head_ptr<float>(p.k, p.st[K], ib, ikv), p.st[K][2],
                   k0, p.sk, SC_BK, tid);
  load_tile_f32<D>(Vs, head_ptr<float>(p.v, p.st[V], ib, ikv), p.st[V][2],
                   k0, p.sk, SC_BK, tid);

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) dk[jj] = dv[jj] = 0.f;

  const int nq = (p.sq + SC_BQ - 1) / SC_BQ;
  const int iq0 = p.causal ? k0 / SC_BQ : 0;
  const float* kr = Ks + r * (D + 1);
  const float* vr = Vs + r * (D + 1);
  for (int hg = 0; hg < group; ++hg) {
    const int ih = ikv * group + hg;
    const float* q = head_ptr<float>(p.q, p.st[Q], ib, ih);
    const float* dout = head_ptr<float>(p.dout, p.st[DO], ib, ih);
    const int64_t rowbase = (static_cast<int64_t>(ib) * p.h + ih) * p.sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * SC_BQ;
      __syncthreads();
      load_tile_f32<D>(Qs, q, p.st[Q][2], q0, p.sq, SC_BQ, tid);
      load_tile_f32<D>(Os, dout, p.st[DO][2], q0, p.sq, SC_BQ, tid);
      for (int i = tid; i < SC_BQ; i += SC_THREADS) {
        const bool in = q0 + i < p.sq;
        Ls[i] = in ? p.lse[rowbase + q0 + i] : 0.f;
        Ds[i] = in ? p.delta[rowbase + q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < SC_BQ / 4; ++j) {
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
        Ps[r * (SC_BQ + 1) + c] = pr;
        Ss[r * (SC_BQ + 1) + c] = pr * (dp - Ds[c]);
      }
      __syncwarp();  // key r's P and dS are written and read by its lanes
      for (int c = 0; c < SC_BQ; ++c) {
        const float pc = Ps[r * (SC_BQ + 1) + c];
        const float sc = Ss[r * (SC_BQ + 1) + c];
        const float* orow = Os + c * (D + 1) + c4;
        const float* qr = Qs + c * (D + 1) + c4;
#pragma unroll
        for (int jj = 0; jj < D / 4; ++jj) {
          dv[jj] = fmaf(pc, orow[4 * jj], dv[jj]);
          dk[jj] = fmaf(sc, qr[4 * jj], dk[jj]);
        }
      }
    }
  }

  if (key < p.sk) {
    float* dkp = head_ptr_mut<float>(p.dk, p.st[DK], ib, ikv) +
                 key * p.st[DK][2];
    float* dvp = head_ptr_mut<float>(p.dv, p.st[DV], ib, ikv) +
                 key * p.st[DV][2];
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) {
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

template <int D>
cudaError_t run_dq(const Params& p, int batch, int bf16_in,
                   cudaStream_t stream) {
  if (bf16_in) {
    const dim3 grid((p.sq + TC_BQ - 1) / TC_BQ, p.h, batch);
    const size_t smem = 2 * TC_BK * (D + 8) * sizeof(bf16);
    return launch(dq_bf16<D>, grid, TC_THREADS, smem, stream, p);
  }
  const dim3 grid((p.sq + SC_BQ - 1) / SC_BQ, p.h, batch);
  const size_t smem =
      ((2 * SC_BQ + 2 * SC_BK) * (D + 1) + SC_BQ * (SC_BK + 1)) *
      sizeof(float);
  return launch(dq_f32<D>, grid, SC_THREADS, smem, stream, p);
}

template <int D>
cudaError_t run_dkv(const Params& p, int batch, int bf16_in,
                    cudaStream_t stream) {
  if (bf16_in) {
    const dim3 grid((p.sk + TC_BK - 1) / TC_BK, p.hkv, batch);
    const size_t smem = (2 * TC_BK + 2 * TC_BQ) * (D + 8) * sizeof(bf16) +
                        2 * TC_BQ * sizeof(float);
    return launch(dkv_bf16<D>, grid, TC_THREADS, smem, stream, p);
  }
  const dim3 grid((p.sk + SC_BK - 1) / SC_BK, p.hkv, batch);
  const size_t smem = ((2 * SC_BK + 2 * SC_BQ) * (D + 1) +
                       2 * SC_BK * (SC_BQ + 1) + 2 * SC_BQ) *
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
