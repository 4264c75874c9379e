// Register-tiled f32 FFMA building blocks shared by the port's f32 kernels
// (csrc/flash_fwd.cu's flash_fwd_f32, csrc/flash_bwd.cu's dq_f32 and
// dkv_f32): true f32 on the CUDA cores, no TF32.
//
// Conventions of the kernels that use them: blocks of F32_THREADS threads;
// a tile of R rows of D floats lies in shared memory with row pitch D + 4
// floats (consecutive rows fall in distinct 16-byte bank groups), filled
// by cp.async 16-byte copies; a score tile is register-tiled, each thread
// holding SR x SC scores at rows a + GR i and columns b + GC j, read as
// float4s that the lanes owning the same row or column share (broadcast);
// a score operand of an output product goes through shared memory once,
// as [reduction index][output row] (pitch + 4), read in float4s.

#pragma once

#include "hopper.cuh"

namespace f32tile {

constexpr int F32_THREADS = 256;

// Issue the cp.async copies of ROWS rows of D floats, rows r0 .. of `src`
// (element row stride ss), into `dst` (row pitch D + 4 floats); rows at or
// past `limit` are zero-filled (nothing is read for them).
template <int D, int ROWS>
__device__ __forceinline__ void f32_rows_async(float* dst, const float* src,
                                               int64_t ss, int r0, int limit,
                                               int tid) {
  constexpr int V = D / 4;  // 16-byte vectors a row
  constexpr int N = ROWS * V;
  const uint32_t base = hopper::smem_u32(dst);
#pragma unroll
  for (int k = 0; k < (N + F32_THREADS - 1) / F32_THREADS; ++k) {
    const int i = tid + k * F32_THREADS;
    if (N % F32_THREADS == 0 || i < N) {
      const int r = i / V, c = i % V;
      const bool in = r0 + r < limit;
      const float* g = src + (in ? (r0 + r) * ss + 4 * c : 0);
      hopper::cp_async_16(base + (r * (D + 4) + 4 * c) * 4, g, in ? 16 : 0);
    }
  }
}

// The ring's step at streamed tile i of n (issue(j) issues tile j's
// copies into its stage): with ST >= 2 wait for tile i (issued ST - 1
// tiles ago), then, past a barrier that frees the stage tile i - 1 used
// and the scores it left in shared memory, issue tile i + ST - 1; with
// ST = 1 (no ring) wait for tile i - 1's readers, then load tile i and
// wait for it. Either way tile i is in and visible to every thread.
template <int ST, typename Issue>
__device__ __forceinline__ void f32_next_stage(int i, int n,
                                               const Issue& issue) {
  if constexpr (ST == 1) {
    __syncthreads();
    issue(i);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
  } else {
    hopper::cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < n) issue(i + ST - 1);
    hopper::cp_async_commit();
  }
}

// The score products of one tile: for each of NPR products, s[n][i][j] =
// A_n[a + GR i] . B_n[b + GC j] over D (rows of shared memory, pitch
// D + 4). NP partial sums an element (the four products of a float4 go to
// partials k % NP) keep at least 8 FMA chains a thread when the tile is
// small.
template <int D, int SR, int SC, int GR, int GC, int NPR>
__device__ __forceinline__ void f32_dots(float (&s)[NPR][SR][SC],
                                         const float* const (&A)[NPR],
                                         const float* const (&B)[NPR], int a,
                                         int b) {
  constexpr int CH = NPR * SR * SC;  // FMA chains a thread
  constexpr int NP = CH >= 8 ? 1 : 8 / CH;
  constexpr int P = D + 4;
  float ps[NPR][SR][SC][NP];
#pragma unroll
  for (int m = 0; m < NPR; ++m)
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j)
#pragma unroll
        for (int n = 0; n < NP; ++n) ps[m][i][j][n] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
#pragma unroll
    for (int m = 0; m < NPR; ++m) {
      float4 x[SR], y[SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
        x[i] = *reinterpret_cast<const float4*>(A[m] + (a + GR * i) * P + d);
#pragma unroll
      for (int j = 0; j < SC; ++j)
        y[j] = *reinterpret_cast<const float4*>(B[m] + (b + GC * j) * P + d);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          float(&q)[NP] = ps[m][i][j];
          q[0] = fmaf(x[i].x, y[j].x, q[0]);
          q[1 % NP] = fmaf(x[i].y, y[j].y, q[1 % NP]);
          q[2 % NP] = fmaf(x[i].z, y[j].z, q[2 % NP]);
          q[3 % NP] = fmaf(x[i].w, y[j].w, q[3 % NP]);
        }
    }
  }
#pragma unroll
  for (int m = 0; m < NPR; ++m)
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[m][i][j] = ps[m][i][j][0];
#pragma unroll
        for (int n = 1; n < NP; ++n) s[m][i][j] += ps[m][i][j][n];
      }
}

// The TR floats at X (a row of a score operand [reduction][XP], at a
// column that is a multiple of TR) into registers, 16 or 8 bytes a load.
template <int TR>
__device__ __forceinline__ void f32_xload(float (&x)[TR], const float* X) {
  if constexpr (TR % 4 == 0) {
#pragma unroll
    for (int n = 0; n < TR / 4; ++n) {
      const float4 t = *reinterpret_cast<const float4*>(X + 4 * n);
      x[4 * n] = t.x, x[4 * n + 1] = t.y;
      x[4 * n + 2] = t.z, x[4 * n + 3] = t.w;
    }
  } else if constexpr (TR == 2) {
    const float2 t = *reinterpret_cast<const float2*>(X);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = X[0];
  }
}

// The TR floats x into X (a row of a score operand [reduction][XP], at a
// column that is a multiple of TR), 16 or 8 bytes a store.
template <int TR>
__device__ __forceinline__ void f32_xstore(float* X, const float (&x)[TR]) {
  if constexpr (TR % 4 == 0) {
#pragma unroll
    for (int n = 0; n < TR / 4; ++n)
      *reinterpret_cast<float4*>(X + 4 * n) =
          make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);
  } else if constexpr (TR == 2) {
    *reinterpret_cast<float2*>(X) = make_float2(x[0], x[1]);
  } else {
    X[0] = x[0];
  }
}

// The output product of one tile: acc[i][4 n + e] += sum_r X[r][x0 + i]
// Y[r][4 (oc + OC n) + e] over the RED rows r of X ([RED][XP]) and Y
// (pitch D + 4): a thread of an output grid of OC column groups owns TR
// rows and D / (4 OC) float4 columns.
template <int D, int TR, int RED, int XP, int OC>
__device__ __forceinline__ void f32_outer(float (&acc)[TR][D / OC],
                                          const float* X, const float* Y,
                                          int x0, int oc) {
  constexpr int NG = D / (4 * OC);
#pragma unroll 4
  for (int r = 0; r < RED; ++r) {
    float x[TR];
    f32_xload<TR>(x, X + r * XP + x0);
    const float* yr = Y + r * (D + 4) + 4 * oc;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const float4 y = *reinterpret_cast<const float4*>(yr + 4 * OC * n);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        acc[i][4 * n] = fmaf(x[i], y.x, acc[i][4 * n]);
        acc[i][4 * n + 1] = fmaf(x[i], y.y, acc[i][4 * n + 1]);
        acc[i][4 * n + 2] = fmaf(x[i], y.z, acc[i][4 * n + 2]);
        acc[i][4 * n + 3] = fmaf(x[i], y.w, acc[i][4 * n + 3]);
      }
    }
  }
}

}  // namespace f32tile
