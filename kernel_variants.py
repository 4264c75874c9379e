#!/usr/bin/env python3
"""Build the design alternatives of K2 (``dq_wgmma`` at d 128 and
``dq_rows8`` at d 256) and K3 (``dkv_onepass`` at d 256) in
``service_account_auth_improvements_tpu_torch/csrc/flash_bwd.cu`` and
time them against the committed kernel on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 kernel_variants.py``. Each variant is the committed source with
the text edits listed in ``VARIANTS`` (an edit whose text is not found
exactly once fails the run). Every source is built with the flags of
``ops/_build.py`` into ``build/kernel_variants/<name>/``, one nvcc each,
all started together; ptxas's lines for the kernel each variant edits are
printed. Each build is held against the kernel's plain version
(``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``) at a ragged
shape and at the training shape of the kernel's head dim
(``KERNEL_HEADS``; chip_smoke.py's ``BWD_TOL``) and twice on one input
(bitwise), then each kernel's variants are timed at its training shape in
turns with the committed source (committed, variants, variants in
reverse, committed), queued behind a spin on the card as chip_smoke.py
times its kernels.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

OUT = cs.ROOT / "build" / "kernel_variants"
SOURCE = "flash_bwd"

# name -> (what it changes, [(text of the committed source, replacement)],
# the kernel it edits)
VARIANTS = {
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
        [("""  mbar_wait(q_full, 0);
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
         ("""    // S = Q K^T and dP = dO V^T: 64 rows x BK keys each
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

""", "    float ds[BK / 2];\n"),
         ("""        sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
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
  store_cols<D>(""")],
        "dq_rows8"),
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
}
# the heads (query, KV, head dim) each edited kernel is checked and timed
# at, at the training shape (b 8, s 2048): bench_800m's and phase 12's
# bench_800m_d256
KERNEL_HEADS = {"dq_wgmma": (12, 4, 128), "dq_rows8": (6, 2, 256),
                "dkv_onepass": (6, 2, 256)}


def variant_source(name: str, src: str) -> str:
    """The committed source with variant ``name``'s edits applied."""
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in the source exactly "
                             "once; update VARIANTS")
        src = src.replace(old, new)
    return src


def _compile(name: str) -> tuple[Path, str]:
    from service_account_auth_improvements_tpu_torch.ops import _build

    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    src = (d / f"{SOURCE}.cu").read_text()
    if name != "committed":
        (d / f"{SOURCE}.cu").write_text(variant_source(name, src))
    lib = d / f"lib{SOURCE}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(d / f"{SOURCE}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
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


def _use(lib: Path) -> None:
    """Route the port's K2 wrapper to this build's library."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    _build._libs[SOURCE] = ctypes.CDLL(str(lib))


def main() -> int:
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cs.phase_device()
    names = ["committed", *VARIANTS]
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_compile, names)))
    for name in names:
        what = VARIANTS[name][0] if name in VARIANTS else "as committed"
        cs._log(f"variant {name}: {what}")
        kernels = [VARIANTS[name][2]] if name in VARIANTS else KERNEL_HEADS
        for kernel in kernels:
            for line in _ptxas_lines(built[name][1], kernel):
                cs._log(f"  ptxas: {line}")

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    dtype = torch.bfloat16
    atol, rtol = cs.BWD_TOL[dtype]
    for kernel, (h, hkv, d) in KERNEL_HEADS.items():
        group = [n for n in VARIANTS if VARIANTS[n][2] == kernel]
        # K2 (dQ) or K3 (dK, dV): the wrapper, its plain version, the bound
        kind = "dkv" if kernel.startswith("dkv") else "dq"
        fn = getattr(fa, f"flash_bwd_{kind}")
        plain = getattr(fa, f"flash_bwd_{kind}_reference")
        for name in ["committed", *group]:
            _use(built[name][0])
            for shape in ((2, 1000, h, hkv, d), (b, s, h, hkv, d)):
                q, k, v, do, o, lse = cs._bwd_inputs(*shape, dtype, gen,
                                                     True)
                delta = fa.flash_bwd_delta(o, do)
                got, again, want = (
                    f(q, k, v, do, lse, delta, True)
                    for f in (fn, fn, plain))
                if kind == "dq":
                    got, again, want = (got,), (again,), (want,)
                err = max(cs._check(f"{name} {shape}", g, w, atol, rtol)
                          for g, w in zip(got, want))
                if not all(map(torch.equal, got, again)):
                    raise AssertionError(f"{name} {shape}: not "
                                         "deterministic")
                cs._log(f"variant {name} b{shape[0]} s{shape[1]} d{d}: "
                        f"{kind} max abs err {err:.3e} (atol {atol}, rtol "
                        f"{rtol}), twice bitwise equal")
                del q, k, v, do, o, lse, delta, got, again, want

        q, k, v, do, o, lse = cs._bwd_inputs(b, s, h, hkv, d, dtype, gen,
                                             True)
        delta = fa.flash_bwd_delta(o, do)
        bound_ms, bound_by = cs.kernel_bound(b, h, hkv, s, s, d, dtype, True,
                                             kind)
        flops = cs.kernel_flops(b, h, s, s, d, True, kind)
        for name in ["committed", *group, *reversed(group), "committed"]:
            _use(built[name][0])
            ms = cs._time_ms(lambda: fn(q, k, v, do, lse, delta, True),
                             queue_ahead=True)
            cs._log(f"time variant {name} ({kernel}) {kind} b{b} s{s} h{h} "
                    f"hkv{hkv} d{d} bf16 causal: {ms:.4f} ms "
                    f"({flops / ms / 1e9:.1f} TF/s, {bound_ms / ms:.3f} of "
                    f"bound {bound_ms:.4f} ms, {bound_by})")
        del q, k, v, do, o, lse, delta
    return 0


if __name__ == "__main__":
    sys.exit(main())
