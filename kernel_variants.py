#!/usr/bin/env python3
"""Build the design alternatives of K2 (``dq_wgmma`` in
``service_account_auth_improvements_tpu_torch/csrc/flash_bwd.cu``) and
time them against the committed kernel on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 kernel_variants.py``. Each variant is the committed source with
the text edits listed in ``VARIANTS`` (an edit whose text is not found
exactly once fails the run). Every source is built with the flags of
``ops/_build.py`` into ``build/kernel_variants/<name>/``, one nvcc each,
all started together; ptxas's lines for ``dq_wgmma`` are printed. Each
build is held against ``flash_bwd_dq_reference`` at a ragged shape and at
the training shape (chip_smoke.py's ``BWD_TOL``), then all are timed at
the training shape in turns (committed, variants, variants in reverse,
committed), queued behind a spin on the card as chip_smoke.py times its
kernels.
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

# name -> (what it changes, [(text of the committed source, replacement)])
VARIANTS = {
    "bk128": (
        "128-key K/V stages (m64n128 score products), 2 in the ring",
        [("constexpr int DQ_BK = 64;", "constexpr int DQ_BK = 128;")]),
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
          "cb * 64,")]),
}


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


def _ptxas_lines(log: str) -> list[str]:
    """ptxas's lines for dq_wgmma: registers, spills and C75xx notes."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "dq_wgmma" in line
            if keep:
                out.append(line.strip())
        elif "C75" in line and "dq_wgmma" in line:
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
        for line in _ptxas_lines(built[name][1]):
            cs._log(f"  ptxas: {line}")

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, h, hkv, d = cs.TRAIN_BATCH, cs.TRAIN_SEQ, 12, 4, 128
    dtype = torch.bfloat16
    atol, rtol = cs.BWD_TOL[dtype]
    for name in names:
        _use(built[name][0])
        for shape in ((2, 1000, h, hkv, d), (b, s, h, hkv, d)):
            q, k, v, do, o, lse = cs._bwd_inputs(*shape, dtype, gen, True)
            delta = fa.flash_bwd_delta(o, do)
            got = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
            want = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
            err = cs._check(f"{name} {shape}", got, want, atol, rtol)
            cs._log(f"variant {name} b{shape[0]} s{shape[1]}: dq max abs "
                    f"err {err:.3e} (atol {atol}, rtol {rtol})")
            del q, k, v, do, o, lse, delta, got, want

    q, k, v, do, o, lse = cs._bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
    delta = fa.flash_bwd_delta(o, do)
    bound_ms, bound_by = cs.kernel_bound(b, h, hkv, s, s, d, dtype, True,
                                         "dq")
    flops = cs.kernel_flops(b, h, s, s, d, True, "dq")
    for name in ["committed", *VARIANTS, *reversed(VARIANTS), "committed"]:
        _use(built[name][0])
        ms = cs._time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 True), queue_ahead=True)
        cs._log(f"time variant {name} dq b{b} s{s} h{h} hkv{hkv} d{d} bf16 "
                f"causal: {ms:.4f} ms ({flops / ms / 1e9:.1f} TF/s, "
                f"{bound_ms / ms:.3f} of bound {bound_ms:.4f} ms, "
                f"{bound_by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
