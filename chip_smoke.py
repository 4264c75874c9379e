#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, fine-tuning, side-model and
policy-training paths on one CUDA card and hold its kernels against their
plain versions.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built from ``csrc/`` at first use) and
no network. Phases, each of which raises on failure:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: every kernel source, one nvcc each, all started together, the
   per-dim ones also with -DFLASH_OTHER_DESIGNS=1 (the designs not
   shipped); ptxas's registers, spills and C75xx notes of the d 64, 192,
   256 and 320 to 512 kernels, of the f32 K1, K2 and K3 at every head dim
   and of the streamed kernels of csrc/flash_wide.cu (above d 512, bf16
   and f32) (the register-tiled ones must not spill, the pairs of blocks,
   K1's at d 384, K2's at d 512 and K3's at d 320 to 512, and the six
   streamed kernels must compile clean);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, in bf16 and f32, with stated tolerances, timed
   beside the plain version and a library call of the same function, with
   the achieved TF/s and the share of the bound: K1 (flash forward) at the
   serving and training shapes and ragged (s 1, 65, 127, 1000, 2047), GQA
   group 1 to 4, non-causal and d 64 shapes, K2 (dQ) and K3 (dK/dV) at the
   training shape and ragged, MHA, non-causal and d 64 shapes; K2 and K3
   launched twice on one input must each agree bit for bit; all three also
   at the fine-tuning shapes (b 4, s 2048, 32 / 8 heads, d 128 for
   Llama-3.1-8B and d 64 for Llama-3.2-1B; K1 also through the wrapper at
   b 1, s 1000), timed there too; and all three at phase 12's head dims
   256, 192, 512, 384 and 768 (b 8, s 2048, 6 / 2, 8 / 4, 3 / 1, 4 / 2 and
   2 / 1 heads) and at 320 and 448 (4 / 2 heads) and 576, 640 (4 / 2),
   704, 1024 (2 / 1) and 2048 (1 / 1) (no model), timed there beside SDPA
   (its backend named: its flash backend stops at d 256; MATH above), in
   f32 at b 2 s 1000 too (above d 512 timed beside SDPA's f32 calls), with
   K1 also at its per-length prefill, and above d 512 (the streamed
   kernels, bf16 and f32) each with its recompute factor, twice on one
   input bitwise, and through autograd over ``flash_attention`` at s 1,
   65, 129, 1000 and 2047 and non-causal s 512 (STREAMED_EDGES) in both
   dtypes; K1, K2 and K3 at
   d 64, 192 and 256 also at ragged lengths (s 1, 63 (K2, K3 at d 192),
   65, 127, 191, 2047; group 4 at s 300; non-causal s 512, at d 64 s
   256), the pairs of blocks at d 384 and 512 (K3's also at d 320 and
   448) at their edges
   (PAIR_EDGE_SETS: K3 at PAIR_EDGES, s 1, 65, 129, 300, 1000, 2047, GQA
   groups 1 to 3, non-causal s 256; K1 and K2 at ROWS_PAIR_EDGES, s 1,
   127, 129, 255, 300 at GQA groups 1 to 3, 1000, 2047, non-causal s 256;
   K1 there also twice on one input, bitwise); the design not shipped at
   d 64, 192, 256 and 320 to 512 (K1, K2 and K3 at d 64, K2 at d 192, K1,
   K2 and K3 at d 256: the 12-warp row split; K1 at d 192: the rows on 8
   warps; K3 at d 192: the one pass; K1 and K3 at d 384 and 512, K3 at
   d 320 and 448 and K2 at d 512: the D split; K2 at d 384: the pair of
   blocks)
   against the plain versions and timed in turns with the shipped one at
   DESIGN_SHAPES (d 64 at the fine-tuning shape; K1 also at d 256's
   prefill shape), K1 beside SDPA's forward with the blocks an SM holds,
   the K2 + K3 pair beside SDPA's backward, K1, K2 and K3 at d 384 and
   512 and K3 at d 320 and 448 with the clusters of two blocks a card
   holds; K1,
   K2 and K3 in f32 (the
   register-tiled
   flash_fwd_f32, dq_f32 and dkv_f32) against their plain versions at
   ragged lengths around their tiles (d 128 and 512) and at F32_SHAPES
   (K2 and K3 each launched twice, bitwise), timed there beside SDPA's
   f32 forward and backward, and the scalar f32 design (the other
   build) held against the plain versions and timed in turns with the
   shipped one at the first two of them; above d 512 the kernels that run
   on a cluster of ceil(d / 256) blocks up to d 2048 (f32 K1, K2 and K3,
   bf16 K3) at WIDE_EDGES at each streamed dim, twice bitwise, their
   column groups at d 2112, and both designs (the other build: the column
   groups) in turns at d 768 and 2048 (f32 at b 2 s 1000 beside SDPA's f32
   forward and backward) and at every streamed dim (bf16 K3 at b 8 s 2048
   beside SDPA's backward), with the clusters a card holds; the streamed
   kernels at d 1280, 1536 and 1728 too (clusters of 5, 6 and 7 blocks for
   K3), through autograd against the plain versions at CLUSTER_SIZE_EDGES;
4. serving: ``GenerationService`` at ``bench_800m`` with per-length
   prefill, behind ``make_server`` on 127.0.0.1, answering one-shot,
   repeated, sampled and streamed completions and /healthz and /metrics;
   the kernel launch counts of that run; ``llama.apply`` with flash
   attention against dense attention;
5. training: ``make_train_step`` at ``bench_800m`` (batch 8, seq 2048,
   remat "full", f32 master params) on one fixed batch: a finite loss
   that falls, exact launch counts per step, step time, tokens/s, MFU and
   peak memory; a profile of one step; the lm_head and optimizer times;
   flash against dense gradients at full width;
6. lifecycle, all at ``bench_800m``: ``train.loop.fit`` 4 steps straight
   against 2 steps into a checkpoint directory and a resumed fit to 4
   (every param and Adam moment bit-equal, exact launch counts per step),
   with periodic evaluation on held-out batches; the checkpoint served by
   ``GenerationService`` (params only, ``opt.pt`` hidden) and its
   completions against direct ``generate``; int8 weights (error bound on
   every leaf, logits against bf16, prefill and decode times); speculative
   decoding with a ``bench_400m`` draft and with the target as its own
   draft (f32: token-identical to plain greedy; bf16: over HTTP, with
   acceptance and latency); the ``train.loop`` CLI resuming from its
   ``--workdir`` and the serving CLI with ``--checkpoint-dir --int8
   --draft-preset`` as a subprocess;
7. mixture of experts at ``bench_moe`` (4 experts, switch top-1) and its
   Mixtral top-2 row: ``make_train_step`` at batch 8, seq 2048 with exact
   launch counts per step, a falling finite loss, the aux loss per step,
   step time, tokens/s, MFU, peak memory and a profile grouped into
   routing, dispatch and combine, expert products and the kernels; one
   step twice from one state, bitwise equal; flash against dense at full
   width (the share of routing choices that agree, and the gradients);
   ``GenerationService`` over HTTP with per-length and windowed prefill;
8. fine-tuning: Llama-3.1-8B (bf16) and Llama-3.2-1B (f32 master) from
   HF-layout state dicts drawn on the card, converted with
   ``models/convert_hf.py`` (config against the presets, round trip
   bitwise); LoRA through ``fit`` at the 8B, b 4 x 2048, 4 steps straight
   against 2 into a checkpoint and a resumed fit (adapters and moments
   bit-equal, base unchanged, first loss = the base's, exact launches per
   step, step time, peak memory, a profile, the step's parts); the
   fine-tuned 8B distilled into the 1B (``make_distill_step``, exact
   launches per step, teacher unchanged); the student checkpointed,
   restored and serving the 8B as its draft through ``spec_generate``;
9. side models: MNIST (784-256-10, b 1024, 20 SGD steps) and ResNet-50
   (b 256 x 224 x 224 x 3, bf16 NHWC, 10 momentum steps: falling loss,
   running stats moved, 25,557,032 params, step time, images/s, peak
   memory), and MNIST and ``resnet18-smoke`` on the card against the CPU;
10. parallel: a ``parallel.make_mesh`` mesh of one card over an NCCL
   process group (an all-reduce over it); at ``bench_800m`` (b 8 x 2048)
   three steps each of the plain step, the mesh step with flash attention
   (bit for bit the plain step's, K1 40 / K2 20 / K3 20 per step), with
   Ulysses (bit for bit the flash mesh step's, the same launches) and
   with ring attention (no K1; held to the dense step), with step times
   and peak memory; the ring's chunk arithmetic at full width (4 chunks
   of 512) against K1's output and LSE, bf16 and f32, timed;
11. parallel II: the GPipe schedule (``parallel.pipeline.pipeline_local``:
   every stage in this process, the hop a rotation) at ``bench_800m``, b 8
   x 2048, 4 stages of 5 layers, 8 microbatches: exact launches per step
   (K1 320 / K2 160 / K3 160), step time and peak memory beside the plain
   step, bf16 losses, and step 1's f32 gradients leaf by leaf against the
   plain stack's with a control schedule that loses a microbatch; the ep
   split at ``bench_moe``'s training shape (every ep rank's share of one
   MoE FFN for ep 2 and 4, summed) against the plain FFN; and on the
   world-1 NCCL mesh at full width, each bit (or token) for bit its plain
   path: the ``bench_moe`` train step, ``GenerationService(mesh=)`` at
   ``bench_800m`` (per-length and windowed prefill), a LoRA step over a
   ``bench_800m`` base and the ResNet-50 step;
12. wide head dims: ``bench_800m`` with its attention cut into 6 / 2 heads
   of 256, 8 / 4 of 192, 3 / 1 of 512, 4 / 2 of 384 and 2 / 1 of 768
   (``WIDE_HEADS``; h * d is still 1536), each trained by
   ``make_train_step`` at b 8 x 2048 for a few steps with exact launches
   per step (K1 40 / K2 20 / K3 20), a falling finite loss, step time,
   tokens/s, MFU and peak memory; the d 256, 512 and 768 models, in bf16,
   answer one per-length request over HTTP (K1 20, first tokens
   ``llama.apply``'s) and decode greedily through K1 in f32 token for
   token as the dense path does, d 768 (the streamed f32 K1) also in bf16
   with ``llama.apply``'s logits held to the dense path's; the d 512, 384
   and 768 models take one step with flash against one with dense
   attention (b 2, s 512), in f32 and bf16;
13. the placement policy and the GPU binding: a seeded journal of
   16,384 sched-journal/v1 placement rows over 16 pools of mixed sizes
   (``policy_journal``), written to JSONL and read back through the port's
   ``features``; the trainer's CLI (``controlplane.scheduler.policy.train``)
   at its defaults (300 steps, batch 64) and at batch 4096, with step ms,
   steps/s, launches per step and the idle share; that run on the card
   against the CPU's (``POLICY_TOL``), a resume at step 150 bit for bit,
   the checkpoint's keys, shapes and dtypes, ``choose_index`` over every
   example; then ``torch.distributed.run`` with the env
   ``controlplane/gpu.py``'s ``worker_env`` gives a one-card notebook,
   running the training CLI over an NCCL group of one on card 0.

The f32 backward's launches (K2 and K3 in f32) are counted on each path
that runs them: the flash against dense steps of phases 5, 7 and 12 and
the pipeline's f32 step 1 (phase 11); above d 512 (the streamed f32
kernels) apart, with phase 12's f32 greedy decode at d 768.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or without the
repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "service_account_auth_improvements_tpu_torch"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# kernel vs plain tolerances: |kernel - plain| <= ATOL + RTOL * |plain|.
# bf16: both sides round O to bf16 (one ulp is 2^-8 relative) from f32
# values that differ by the tile order of the online softmax and the bf16
# rounding of P; f32: only the summation order differs.
TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
LSE_ATOL = 1e-3
# K2/K3 vs plain: dS is rounded to bf16 on both sides from f32 values that
# differ in summation order (a product rounds to the neighbouring bf16
# value now and then), and the outputs round to bf16: a bf16 ulp of the
# largest gradients (|d| ~ 10, ulp 2^-5) plus the relative term. f32:
# summation order only.
BWD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# the streamed kernels' source (above d 512, bf16 and f32; one design, so
# one build) and its kernel templates, bf16's and f32's, each instantiated
# at its column group's width (ops/flash_attention.py's WIDE_COLUMNS)
WIDE_SOURCE = "flash_wide"
WIDE_KERNELS = {"flash_fwd": "flash_fwd_wide", "flash_bwd_dq": "dq_wide",
                "flash_bwd_dkv": "dkv_wide"}
WIDE_F32_KERNELS = {"flash_fwd": "flash_fwd_wide_f32",
                    "flash_bwd_dq": "dq_wide_f32",
                    "flash_bwd_dkv": "dkv_wide_f32"}
# the streamed kernels as independent column groups, bf16's K3 and f32's
# K1, K2 and K3 (the first streamed design: the -DFLASH_OTHER_DESIGNS=1
# build's at every dim, the port's above a cluster of CLUSTER_MAX blocks);
# WIDE_KERNELS' K3 and WIDE_F32_KERNELS run a row tile on a cluster of
# ops/flash_attention.py's wide_cluster and wide_f32_cluster blocks
WIDE_GROUPS = {"flash_bwd_dkv": "dkv_wide_groups"}
WIDE_F32_GROUPS = {"flash_fwd": "flash_fwd_wide_f32_groups",
                   "flash_bwd_dq": "dq_wide_f32_groups",
                   "flash_bwd_dkv": "dkv_wide_f32_groups"}
# each kernel of the main paths: its source under csrc/, and the TPU kernel
# it replaces, by function name and line in the JAX package's
# ops/flash_attention.py
KERNELS = {"flash_fwd": ("flash_fwd.cu", "_fwd_kernel", 113),
           "flash_bwd_dq": ("flash_bwd.cu", "_dq_kernel", 212),
           "flash_bwd_dkv": ("flash_bwd.cu", "_dkv_kernel", 261)}
# the profile's kernel groups: a __global__ kernel of csrc/ (matched as a
# substring of the profiler's kernel name) and its label
PROFILE_KERNELS = {"flash_fwd_wgmma": "K1 flash_fwd", "dq_wgmma": "K2 dq",
                   "dkv_wgmma": "K3 dkv",
                   "flash_fwd_rows8": "K1 flash_fwd (8 warps, d 256)",
                   "flash_fwd_twin": "K1 flash_fwd (twin 8-warp blocks, d 64)",
                   "dq_rows8": "K2 dq (8 warps, d 64, 192 and 256)",
                   "dkv_onepass": "K3 dkv (one pass, d 256)",
                   "dkv_pair": "K3 dkv (one pass on a cluster of two, d 320 "
                               "to 512)",
                   "flash_fwd_pair": "K1 flash_fwd (rows on a cluster of two, "
                                     "d 384 and 512)",
                   "dq_pair": "K2 dq (rows on a cluster of two, d 512)",
                   "dkv_keys8": "K3 dkv (keys on 8 warps, d 64)",
                   "flash_fwd_split": "K1 flash_fwd (D split)",
                   "dq_split": "K2 dq (D split)",
                   "dkv_split": "K3 dkv (D split)",
                   "flash_fwd_wide": "K1 flash_fwd (head dim streamed, "
                                     "d > 512)",
                   "dq_wide": "K2 dq (head dim streamed, d > 512)",
                   "dkv_wide": "K3 dkv (head dim streamed, d > 512; on a "
                               "cluster up to d 2048)"}
# K1's bf16 designs by the id flash_fwd_design returns (csrc/flash_fwd.cu's
# FwdDesign), K2's and K3's by the id flash_bwd_dq_design and
# flash_bwd_dkv_design return (csrc/flash_bwd.cu's BwdDesign)
FWD_DESIGNS = {0: "row split", 1: "D split", 2: "rows on 8 warps",
               5: "twin blocks of 8 warps", 7: "rows on a cluster of two",
               8: "head dim streamed, 256 columns a block"}
BWD_DESIGNS = {0: "row split", 1: "D split", 2: "rows on 8 warps",
               3: "one pass", 4: "keys on 8 warps",
               6: "a cluster of two, half the head dim a block",
               8: "head dim streamed, 256 columns a block"}
# the kernel template each design id runs, per kernel
DESIGN_KERNELS = {
    "flash_fwd": {0: "flash_fwd_wgmma", 1: "flash_fwd_split",
                  2: "flash_fwd_rows8", 5: "flash_fwd_twin",
                  7: "flash_fwd_pair", 8: "flash_fwd_wide"},
    "flash_bwd_dq": {0: "dq_wgmma", 1: "dq_split", 2: "dq_rows8",
                     6: "dq_pair", 8: "dq_wide"},
    "flash_bwd_dkv": {0: "dkv_wgmma", 1: "dkv_split", 3: "dkv_onepass",
                      4: "dkv_keys8", 6: "dkv_pair", 8: "dkv_wide"}}
# the other designs (all three at d 64, K1 and K3 at d 192 and 256, K2 at
# d 192 and 256, all three at d 384 and 512 and K3 at d 320 and 448 in
# bf16, and all three at d 128 in f32; phase 3 times them beside the
# shipped ones in turns):
# every kernel source built with -DFLASH_OTHER_DESIGNS=1 into here
OTHER_DESIGNS_DIR = ROOT / "build" / "chip_smoke_other_designs"
# the head dims at which some bf16 kernel ships one of two designs
# (DESIGN_SHAPES: where phase 3 times both)
DESIGN_DIMS = (64, 192, 256, 320, 384, 448, 512)
# K1's, K2's and K3's f32 designs by the id flash_fwd_f32_design and
# flash_bwd_f32_design return (csrc/flash_fwd.cu's and csrc/flash_bwd.cu's
# F32Design), and the head dim at which the other build runs the other one
F32_DESIGNS = {0: "scalar", 1: "register-tiled",
               2: "register-tiled on a cluster of ceil(d / 256) blocks"}
F32_CLUSTER_DESIGN = 2  # csrc/flash_wide.cu's kF32Cluster
F32_DESIGN_DIM = 128
# the bf16 streamed designs by the id flash_wide_design returns
# (csrc/flash_wide.cu's WideDesign)
WIDE_DESIGNS = {1: "column groups of 256", 2: "a cluster of ceil(d / 256) "
                                              "blocks"}
WIDE_CLUSTER_DESIGN = 2  # csrc/flash_wide.cu's kWideCluster
# the streamed head dims at which phase_f32_designs times the f32 K1, K2
# and K3 of both builds in turns (a cluster of 3 and of 8 blocks against
# the column groups), at b 2 s 1000, and phase_wide_designs the bf16 K3 at
# the training shape, each dim's heads (_kernel_heads)
F32_CLUSTER_DIMS = (768, 2048)
# a head dim past the largest cluster, where the port's f32 K1, K2 and K3
# and bf16 K3 are the column groups (phase 3 holds them there)
F32_PAST_CLUSTER = 2112
# the f32 kernels phase 2 reports ptxas's registers, spills and C75xx notes
# for, at every head dim (the scalar ones only in the other build); the
# register-tiled ones must not spill
F32_KERNELS = ("flash_fwd_f32", "dq_f32", "dkv_f32", "f32_reduce",
               "flash_fwd_f32_scalar", "dq_f32_scalar", "dkv_f32_scalar")
F32_NO_SPILL = ("flash_fwd_f32", "dq_f32", "dkv_f32", "f32_reduce")
# K1, K2 and K3 in f32 are timed (phase 3) at these shapes, label -> (b, s,
# heads, KV heads, head dim), causal, beside SDPA's f32 forward and
# backward: bench_800m's heads at the serving prompt's length (the f32
# parity steps and f32 prefill run there) and at the training shape, and
# phase 12's d 256 and d 512 heads; the first F32_IN_TURNS also in turns
# with the other build's scalar design
F32_SHAPES = {"b2 s1000 h12 hkv4 d128": (2, 1000, 12, 4, 128),
              "b8 s2048 h12 hkv4 d128": (8, 2048, 12, 4, 128),
              "b2 s1000 h6 hkv2 d256": (2, 1000, 6, 2, 256),
              "b2 s1000 h3 hkv1 d512": (2, 1000, 3, 1, 512)}
F32_IN_TURNS = 2

# serving path: bench_800m, batch 4, a 1000-token prompt, 64 new tokens
PRESET, BATCH, PROMPT, NEW = "bench_800m", 4, 1000, 64
# training path: bench_800m (bench.py's headline configuration), batch 8,
# seq 2048; TRAIN_STEPS counted steps on one fixed batch, the first of
# them a warm-up outside the step clock
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6
# one step with flash against one with dense attention at full width
# (b 2, s 512), compared on loss, grad norm (relative) and the largest
# per-leaf gradient difference over that leaf's largest gradient. f32:
# summation order through 20 layers (largest seen on the H100: loss 1e-6,
# leaf 7.1e-6); bf16: the two paths round P and O at different points and
# the residual stream carries it (seen: loss 7.3e-4, grad norm 2.9e-4,
# leaf 4.1e-2).
GRAD_TOL = {"f32": dict(loss=1e-4, gnorm=1e-4, leaf=1e-4),
            "bf16": dict(loss=1e-2, gnorm=1e-2, leaf=1e-1)}
# llama.apply logits (std ~0.8), flash attention against dense attention at
# full width. bf16: the two attention paths round P and O to bf16 at
# different points and 20 layers of bf16 residual stream carry the
# difference (largest seen on the H100: 0.13). f32: summation order only.
APPLY_ATOL = {"bf16": 0.25, "f32": 2e-3}

# lifecycle path, bench_800m at the training shape: run A trains
# LIFECYCLE_STEPS steps straight; run B trains RESUME_AT steps into a
# checkpoint directory and a fresh fit resumes it to LIFECYCLE_STEPS,
# evaluating EVAL_BATCHES held-out batches every RESUME_AT steps
LIFECYCLE_STEPS, RESUME_AT, EVAL_BATCHES = 4, 2, 2
# the speculative draft (the same vocabulary as PRESET) and its proposals
# per verify round
DRAFT, GAMMA = "bench_400m", 4
# int8 against bf16 prefill logits: the reference's weight-only budget
# (tests/test_quantize.py: max |Δ| / max(max |logit|, 1) < 0.05)
INT8_REL_TOL = 0.05
# checkpoint directories under the gitignored build/, deleted at the end
WORKDIR = ROOT / "build" / "chip_smoke_lifecycle"
CLI_WORKDIR = ROOT / "build" / "chip_smoke_cli"
DEV = "cuda"

# MoE path: bench.py's MoE row (bench_moe: 4 experts, switch top-1, the
# 400m attention geometry) trains TRAIN_STEPS steps at the training shape;
# its top-k routing row (moe_top_k=2, as bench.py builds bench_moe_top2)
# MOE_TOP2_STEPS. Both serve as the serving path does.
MOE_PRESET, MOE_TOP2_STEPS = "bench_moe", 3
# its query and KV heads: the kernel checks hold K1/K2/K3 against their
# plain versions at the shapes its training and prefill give them
MOE_HEADS, MOE_KV_HEADS = 8, 4
# flash against dense attention at full width (b 2, s 512, f32): routing
# is discontinuous, so a summation-order difference can move a near-tie
# token to another expert (and, under capacity, shift its group's later
# claims). At least MOE_ROUTING_AGREE of the top-k choices must agree.
# The gradients are held to the dense model's f32 tolerances when every
# choice agrees; a moved token changes two experts' gradients by its own
# contribution, so then the leaf bound is the bf16 one (GRAD_TOL).
MOE_ROUTING_AGREE = 0.999
# the profile's MoE routing group: the aten ops (by exact name) of the
# router softmax and its backward, the top-k sort, the capacity cumsum and
# the one-hots (one_hot fills by scatter_; the capacity one-hot is an eq)
MOE_ROUTING_OPS = frozenset({
    "aten::softmax", "aten::_softmax", "aten::_softmax_backward_data",
    "aten::sort", "aten::cumsum", "aten::one_hot", "aten::scatter_",
    "aten::eq"})


# fine-tuning path (phase 8): Llama-3.1-8B and Llama-3.2-1B as the public
# config.json files of meta-llama/Llama-3.1-8B and meta-llama/Llama-3.2-1B
# give them (the keys that shape the model). No weights are read: each
# state dict is drawn from a seed in HF's layout, in bf16 on the card.
HF_LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "vocab_size": 128256, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": False, "attention_bias": False,
    "mlp_bias": False, "torch_dtype": "bfloat16"}
HF_LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "hidden_size": 2048,
    "head_dim": 64, "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "vocab_size": 128256, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": True, "attention_bias": False,
    "mlp_bias": False, "torch_dtype": "bfloat16"}
# the fine-tuning shape, LoRA's fit run (straight, and RESUME_AT steps into
# FT_WORKDIR then resumed) and its adapter learning rate: adapters take a
# larger one than pretraining (Adam moves B by about lr per step, which
# moves a merged weight by ~0.09·lr: at 3e-4 less than half a bf16 ulp of
# the 0.02-scale base, so most of the update rounds away), and on an
# NVIDIA H100 80GB HBM3 at 700.00 W lr 1e-2 overshot after one step
# (losses 12.567, 12.022, 12.490, 12.640); the distillation steps,
# temperature and mixing
FT_BATCH, FT_SEQ, LORA_STEPS, LORA_LR = 4, 2048, 4, 2e-3
# the two models' head dims, for the kernel checks at their shapes
FT_HEAD_DIMS = (("8b", 128), ("1b", 64))
DISTILL_STEPS, DISTILL_T, DISTILL_ALPHA = 4, 2.0, 0.5
FT_WORKDIR = ROOT / "build" / "chip_smoke_finetune"
# the 8B's first LoRA step against next_token_loss on the base params (B
# = 0 merges to the base exactly, so equal bits are expected)
LORA_FIRST_LOSS_RTOL = 1e-5

# side models (phase 9): the default MNIST MLP at batch 1024 for 20 SGD
# steps; ResNet-50 at batch 256 x 224 x 224 x 3 (the per-GPU batch of
# NVIDIA DeepLearningExamples' ResNet-50 v1.5 recipe with AMP) for 10
# momentum steps on one batch; card against CPU at smoke size:
# resnet18-smoke (b 16, 32 x 32) and MNIST (b 256). bf16 on both sides,
# the convolutions' and matmuls' sums rounded at different points: MNIST
# logits within 3e-2, ResNet eval logits, train logits and running stats
# within 5e-2 (logits of ~3).
MNIST_BATCH, MNIST_STEPS = 1024, 20
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS, RESNET_LR = 256, 224, 10, 0.1
RESNET50_PARAMS = 25_557_032
SIDE_TOL = {"mnist": 3e-2, "resnet": 5e-2}

# the wide head dims (phase 12): PRESET with its attention cut into heads of
# 256 (6 / 2 heads), 192 (8 / 4), 512 (3 / 1), 384 (4 / 2) and 768 (2 / 1),
# built with dataclasses.replace (the JAX package has no preset at these
# dims). h * d stays 1536, so wq and wo keep their 1536 x 1536 and each
# kernel does PRESET's work at the training shape; d 256 and d 512 also
# keep wk/wv at 1536 x 512 (d 192, 384 and 768: 1536 x 768). d 384 and
# d 512 take the pairs of blocks and the split kernels (each block or
# consumer warpgroup owns part of the output's columns), d 768 the
# streamed kernels of csrc/flash_wide.cu (bf16 and f32). Each trains
# WIDE_STEPS steps at the training shape (the first a warm-up); the models
# of WIDE_SERVED then serve one per-length request, and those of
# WIDE_VS_DENSE take one step with flash against one with dense attention
# (b 2, s 512, GRAD_TOL). Phase 3 checks and times K1, K2 and K3 at every
# shape, and at KERNEL_ONLY_HEADS (no model, the training shape): the split
# kernels' other dims, 4 / 2 heads of 320 and of 448, and the streamed
# kernels' at 4 / 2 heads of 576 (the first past 512) and 640, 2 / 1 of
# 704 (11 chunks of 64, a prime) and 1024, and 1 / 1 of 2048 (d 576 and
# 704 end in a column group of 64).
WIDE_HEADS = {"bench_800m_d256": (6, 2, 256), "bench_800m_d192": (8, 4, 192),
              "bench_800m_d512": (3, 1, 512), "bench_800m_d384": (4, 2, 384),
              "bench_800m_d768": (2, 1, 768)}
WIDE_SERVED = (256, 512, 768)
WIDE_VS_DENSE = (512, 384, 768)
KERNEL_ONLY_HEADS = {"d320": (4, 2, 320), "d448": (4, 2, 448),
                     "d576": (4, 2, 576), "d640": (4, 2, 640),
                     "d704": (2, 1, 704), "d1024": (2, 1, 1024),
                     "d2048": (1, 1, 2048)}
# the per-dim libraries' bound: K1, K2 and K3 run csrc/flash_fwd.cu's and
# csrc/flash_bwd.cu's kernels up to this head dim, csrc/flash_wide.cu's
# streamed ones above it, in bf16 and f32 alike
# (ops/flash_attention.py's KERNEL_HEAD_DIMS)
PER_DIM_MAX = 512
# the streamed kernels' edges, (b, s, causal) at each of their dims'
# heads, through autograd over flash_attention, in bf16 and f32: one row,
# ragged ends one past a 64-key (bf16 K3, f32 K1) and a 128-row (bf16 K1,
# K2) block and past two of f32's 32-row and 32-key ones, the serving
# prompt length, s 2047, non-causal aligned
STREAMED_EDGES = ((2, 1, True), (2, 65, True), (2, 129, True),
                  (2, 1000, True), (1, 2047, True), (2, 512, False))
# the streamed head dims whose clusters of 5, 6 and 7 blocks (d 1280, the
# last block full; 1536; 1728, the last block 192 columns) are held at small
# shapes only: phase 3 through autograd against the plain versions, twice
# bitwise, in bf16 and at CLUSTER_SIZE_F32 in f32. (heads, KV heads) each,
# and the edges (b, s, causal): one row, one past a 128-row block, s 300,
# non-causal
CLUSTER_SIZE_HEADS = {1280: (2, 1), 1536: (2, 1), 1728: (2, 1)}
CLUSTER_SIZE_F32 = (1280, 1728)
CLUSTER_SIZE_EDGES = ((2, 1, True), (2, 129, True), (2, 300, True),
                      (2, 256, False))
WIDE_STEPS = TRAIN_STEPS
# the causal shape (b, s, heads, KV heads) each of DESIGN_DIMS is timed at
# in turns: Llama-3.2-1B's at the fine-tuning shape (phase 8's
# distillation student), phase 12's d 192, 256, 384 and 512 heads and
# KERNEL_ONLY_HEADS' d 320 and 448 ones at the training shape
DESIGN_SHAPES = {
    64: (FT_BATCH, FT_SEQ, HF_LLAMA32_1B["num_attention_heads"],
         HF_LLAMA32_1B["num_key_value_heads"]),
    **{d: (TRAIN_BATCH, TRAIN_SEQ, *WIDE_HEADS[f"bench_800m_d{d}"][:2])
       for d in (192, 256, 384, 512)},
    **{d: (TRAIN_BATCH, TRAIN_SEQ, *KERNEL_ONLY_HEADS[f"d{d}"][:2])
       for d in (320, 448)}}
# d 64's K1 and K2 blocks of 128 query rows (over 128- and 64-key tiles)
# and K3 blocks of 128 keys at their edges, (b, s, heads, KV heads,
# causal): one row, ragged ends inside and one past a block, s 2047 at
# Llama-3.2-1B's heads, GQA group 4, non-causal aligned; phase 3 holds the
# shipped K1, K2 and K3 there, phase_wide_designs the other build's
D64_EDGES = ((2, 1, 4, 4, True), (2, 65, 4, 4, True), (2, 127, 8, 2, True),
             (2, 191, 4, 2, True), (1, 2047, 32, 8, True),
             (2, 300, 8, 2, True), (2, 256, 4, 1, False))
# the edges (b, s, causal) phase_wide_designs holds the other build's K1
# at d 192 and 256 and K2 at d 192 at, at phase 12's heads (8 / 4 at d 192:
# GQA group 2): one row, ragged ends inside and past a 128-row block,
# s 2047, non-causal aligned
WIDE_EDGES = ((2, 1, True), (2, 65, True), (2, 191, True), (1, 2047, True),
              (2, 512, False))
# K3's pairs of blocks at d 320 to 512 (dkv_pair: 64 keys a pair, 64-query
# stages; DKV_PAIR_DIMS) at their edges, (b, s, heads, KV heads, causal):
# one row, ragged ends one past a 64-key block and past two, s 300 at GQA
# groups 1 and 2, s 1000 and 2047, non-causal aligned; groups 1 to 3.
# Phase 3 holds the shipped K3 there at each dim, phase_wide_designs the
# other build's
PAIR_EDGES = ((2, 1, 3, 1, True), (2, 65, 4, 2, True), (2, 129, 3, 1, True),
              (2, 300, 3, 3, True), (2, 300, 4, 2, True),
              (2, 1000, 3, 1, True), (1, 2047, 4, 2, True),
              (2, 256, 3, 1, False))
# K1's and K2's pairs of blocks (flash_fwd_pair, dq_pair), each 128 query
# rows a pair over 64- or 32-key tiles, at their edges, (b, s, heads, KV
# heads, causal): one row, one short of and one past a 128-row pair, one
# short of two, s 300 at GQA groups 1 to 3, s 1000 and 2047, non-causal
# aligned (b 8 s 2048 is phase 3's training-shape case at phase 12's
# heads)
ROWS_PAIR_EDGES = ((2, 1, 3, 1, True), (2, 127, 4, 2, True),
                   (2, 129, 3, 1, True), (2, 255, 4, 2, True),
                   (2, 300, 3, 3, True), (2, 300, 4, 2, True),
                   (2, 300, 3, 1, True), (2, 1000, 3, 1, True),
                   (1, 2047, 4, 2, True), (2, 256, 3, 1, False))
# the head dims at which each of K1, K2 and K3 has a pair of blocks in one
# of the two builds (K2's at d 384 in the other), and the edges each
# kernel is held at there: phase 3 holds the shipped kernels (K2 and K3
# side by side, at both kernels' edges), phase_wide_designs the other
# build's
PAIR_DIMS = (384, 512)
# the head dims at which K3 has a pair of blocks (dkv_pair; dkv_split in the
# other build): PAIR_DIMS, and d 320 and 448, where each block holds 64
# ceil(d / 128) columns and the second block's last 64 are TMA's zeros
DKV_PAIR_DIMS = (320, 384, 448, 512)
PAIR_EDGE_SETS = {"flash_fwd": ROWS_PAIR_EDGES,
                  "flash_bwd_dq": ROWS_PAIR_EDGES,
                  "flash_bwd_dkv": PAIR_EDGES}
# the kernels that must compile with no spill and no C75xx note (phase 2)
CLEAN_KERNELS = ("dkv_pair", "flash_fwd_pair", "dq_pair",
                 *WIDE_KERNELS.values())

# the placement policy (phase 13): POLICY_ROWS sched-journal/v1 placement
# rows over 16 pools (features.MAX_POOLS) of mixed sizes, each pool (hosts,
# chips per host) as a v5e node pool has them, from one host of 4 or 8
# chips to 16 hosts of 4; demands (chips, hosts) from one chip to 16
# hosts. Each row is decided by best fit over the reconciler's feasibility
# rule. The CLI trains POLICY_STEPS steps (its defaults: batch 64, hidden
# 32, lr 1e-2), then at batch 4096; a run stopped at POLICY_RESUME_AT
# resumes. Step times are CUDA events over POLICY_TIMED steps after
# POLICY_WARMUP, the idle share and launches from a profile of
# POLICY_PROFILED steps.
POLICY_ROWS = 16_384
POLICY_POOLS = ((1, 4),) * 3 + ((1, 8),) * 3 + ((4, 4),) * 4 + \
    ((8, 4),) * 3 + ((16, 4),) * 3
POLICY_DEMANDS = ((1, 1), (4, 1), (8, 1), (16, 4), (32, 8), (64, 16))
POLICY_STEPS, POLICY_BATCHES, POLICY_RESUME_AT = 300, (64, 4096), 150
POLICY_WARMUP, POLICY_TIMED, POLICY_PROFILED = 10, 100, 10
# the card against the port's CPU run after POLICY_STEPS steps, f32 on
# both (summation order only): every logged loss, every param but b3, and
# the probabilities the two param sets give every example's feasible
# pools. b3
# adds one constant to every pool's score, which the softmax ignores: its
# exact gradient is 0, each device computes rounding noise (~1e-9) in its
# place, and Adam (eps 1e-8) turns that noise into steps of up to ~lr; so
# b3 is held through what it could change, the probabilities. The
# other params: Adam normalizes small gradients, so summation order moves
# them more the longer the run; over 300 steps the reference differs from
# itself (jitted against op by op) by up to 1.7x atol 1e-5 + rtol 1e-4,
# and the port's CPU run from it by up to 2.5x (python
# tests/test_torch_policy.py prints both), so they are held at ten times
# that bound.
POLICY_TOL = {"loss": 1e-5, "atol": 1e-4, "rtol": 1e-3, "probs": 1e-4}
POLICY_DIR = ROOT / "build" / "chip_smoke_policy"


def _log(msg: str) -> None:
    print(msg, flush=True)


# the f32 K2 and K3 launches (and K1's) of each path that runs K2 and K3 in
# f32 (the flash against dense steps of phases 5, 7 and 12, phase 11's
# pipelined f32 step 1), as ``_f32_counted`` records them: {path: {kernel:
# launches}}; those of the paths above the per-dim bound (the streamed f32
# kernels: phase 12's d 768 flash against dense step, and its f32 greedy
# decode, K1 alone) apart
F32_PATHS: dict = {}
F32_WIDE_PATHS: dict = {}


def _f32_counted(path: str, fn, paths: dict = F32_PATHS):
    """``fn()``, with the K1, K2 and K3 launches it made added to
    ``paths[path]`` and printed."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    before = _counts(fa)
    out = fn()
    torch.cuda.synchronize()
    got = paths.setdefault(path, dict.fromkeys(before, 0))
    for name, n in _counts(fa).items():
        got[name] += n - before[name]
    _log(f"f32 launches on {path}: K1 {got['flash_fwd']}, K2 "
         f"{got['flash_bwd_dq']}, K3 {got['flash_bwd_dkv']}")
    return out


# cycles of a spin on the card (about 10 ms on an H100) queued ahead of a
# kernel's timed run: the host enqueues the run's launches meanwhile, so the
# events time the card and not the host (a K1 call's host path, measured
# below, is as long as the kernel itself at the serving shape). Paths whose
# host time is part of what a user waits for (prefill, decode, the step's
# parts) are timed without it.
QUEUE_AHEAD_CYCLES = 20_000_000


def _timed(name: str, fn, *args):
    """``fn(*args)``, with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    _log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def _time_ms(fn, iters: int = 20, warmup: int = 3,
             queue_ahead: bool = False) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside the script")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _log(f"device: {torch.cuda.get_device_name(0)} "
         f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
         f"cuda {torch.version.cuda}")
    _log(smi)


def phase_build() -> None:
    """Every kernel source, one nvcc each, all started together: as the
    port builds it, and the per-dim sources also with the other designs
    (bf16 at d 64, 192, 256 and 320 to 512, f32 at d 128; phase 3 times
    both). Raises if a register-tiled f32 kernel spills, a kernel of
    CLEAN_KERNELS or a streamed kernel spills or has a C75xx note (a
    wgmma serialised and the like), or the streamed kernels' column groups
    are not ops/flash_attention.py's WIDE_COLUMNS in both dtypes. The
    streamed source is built with the other designs too (bf16 K3 and f32
    K1, K2 and K3 as column groups at every dim); each streamed kernel's
    registers and spills, in either build, go to WIDE_PTXAS for the
    ``kernels`` line."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from service_account_auth_improvements_tpu_torch.ops import _build
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    t0 = time.perf_counter()
    sources = (*KERNEL_SOURCES, WIDE_SOURCE)
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        # map submits every build at once; the lists wait for them
        built = pool.map(_build.build, sources)
        other = pool.map(_build_other_designs, sources)
        *libs, wide = list(built)
        *others, wide_other = list(other)
    _log(f"build: {', '.join(sources)}, each also with the other designs "
         f"(bf16 at d {', '.join(map(str, DESIGN_DIMS))}, f32 at d "
         f"{F32_DESIGN_DIM}, and above d {PER_DIM_MAX} bf16 K3 and f32 K1, "
         f"K2 and K3), in {time.perf_counter() - t0:.1f} s")
    # bf16's K1, K2 and K3, then f32's
    columns = [ctypes.CDLL(str(wide)).flash_wide_columns(i)
               for i in range(2 * len(KERNELS))]
    if columns != [fa.WIDE_COLUMNS[name] for name in KERNELS] * 2:
        raise AssertionError(f"{WIDE_SOURCE}'s column groups {columns} are "
                             f"not WIDE_COLUMNS {fa.WIDE_COLUMNS} in both "
                             "dtypes")
    for lib in libs + others + [wide, wide_other]:
        log = lib.with_name(lib.name + ".log")
        if log.exists():
            _log(f"  {lib.relative_to(ROOT)}:")
            for line in log.read_text().splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill", "C75")):
                    _log(f"  ptxas: {line.strip()}")
    # the DESIGN_DIMS kernels of both designs and the f32 kernels at
    # every head dim, in one line each
    spilled = []
    for lib in libs + others:
        log = lib.with_name(lib.name + ".log")
        if not log.exists():
            continue
        for fn, n in ptxas_summary(log.read_text()).items():
            for d in fa.KERNEL_HEAD_DIMS:
                kernel = _template_name(fn, d)
                if not kernel or (d not in DESIGN_DIMS
                                  and kernel not in F32_KERNELS):
                    continue
                _log(f"ptxas {kernel}<{d}> ({lib.parent.name}): "
                     f"{n['registers']} registers, {n['spill_stores']} "
                     f"bytes of spill stores, C75xx: "
                     f"{', '.join(n['notes']) or 'none'}")
                if kernel in F32_NO_SPILL and n["spill_stores"]:
                    spilled.append(f"{kernel}<{d}>")
                if kernel in CLEAN_KERNELS and (n["spill_stores"]
                                                or n["notes"]):
                    spilled.append(f"{kernel}<{d}> ({', '.join(n['notes'])})")
    # the streamed kernels, one template each, at its group's width, bf16's
    # and f32's (both f32 designs of K2 and K3), in either build
    for which, lib in (("shipped", wide), ("other", wide_other)):
        report = ptxas_summary(lib.with_name(lib.name + ".log").read_text())
        for name, kernel in ((name, kernel) for kernels in (
                WIDE_KERNELS, WIDE_GROUPS, WIDE_F32_KERNELS,
                WIDE_F32_GROUPS) for name, kernel in kernels.items()):
            w = fa.WIDE_COLUMNS[name]
            (n,) = [n for fn, n in report.items()
                    if _template_name(fn, w) == kernel]
            WIDE_PTXAS[which, kernel] = n
            _log(f"ptxas {kernel}<{w}> ({lib.parent.name}): "
                 f"{n['registers']} registers, {n['spill_stores']} bytes of "
                 f"spill stores, C75xx: {', '.join(n['notes']) or 'none'}")
            if n["spill_stores"] or n["notes"]:
                spilled.append(f"{kernel}<{w}> ({', '.join(n['notes'])})")
    if spilled:
        raise AssertionError(f"kernels that must compile clean spill or "
                             f"serialise their wgmmas: {spilled}")


# the streamed kernels' ptxas numbers, {(build, kernel template): {
# "registers", "spill_stores", "notes"}} (phase 2; build "shipped" or
# "other")
WIDE_PTXAS: dict = {}


def ptxas_summary(text: str) -> dict:
    """Per entry function of an ``nvcc -Xptxas -v`` report: its registers,
    bytes of spill stores and the C75xx notes (wgmma serialised and the
    like) ptxas gave it, {mangled name: {"registers", "spill_stores",
    "notes"}}."""
    out, fn = {}, None
    for line in text.splitlines():
        note = re.search(r"\((C75\d\d)\).*function '(\w+)'", line)
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if note:
            out.setdefault(note.group(2), {"registers": None,
                                           "spill_stores": None,
                                           "notes": []})["notes"].append(
                note.group(1))
        elif entry:
            fn = entry.group(1)
            out.setdefault(fn, {"registers": None, "spill_stores": None,
                                "notes": []})
        elif fn and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[fn]["spill_stores"] = int(m.group(1))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def _template_name(mangled: str, d: int) -> str | None:
    """The name of the kernel template a mangled entry function
    instantiates at ``<d>``, or None: the shortest name right before
    ``ILi<d>E`` that its own length prefixes (the namespace's hash may end
    in digits that run into that length)."""
    end = mangled.find(f"ILi{d}E")
    for n in range(1, end):
        name, size = mangled[end - n:end], str(n)
        if (name[0].isalpha() or name[0] == "_") and mangled[
                :end - n].endswith(size):
            return name
    return None


def _build_other_designs(name: str) -> Path:
    """``csrc/<name>.cu`` built with ``-DFLASH_OTHER_DESIGNS=1`` (each
    kernel that ships one of two designs takes the one the port does not
    ship: bf16 at d 64 to 512, f32 at d 128 and f32 K2 and K3 above 512)
    into OTHER_DESIGNS_DIR,
    with ``ops/_build.py``'s flags; its ptxas report beside it."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    OTHER_DESIGNS_DIR.mkdir(parents=True, exist_ok=True)
    out = OTHER_DESIGNS_DIR / f"lib{name}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_OTHER_DESIGNS=1", "-o",
         str(out), str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu with "
                           f"-DFLASH_OTHER_DESIGNS=1:\n{proc.stdout}"
                           f"{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    return out


def _qkv(b, s, h, hkv, d, dtype, gen):
    """Model-layout [b, s, heads, d] inputs on the card, from a seed."""
    def mk(heads):
        return torch.randn((b, s, heads, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    return mk(h), mk(hkv), mk(hkv)


def _check(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} "
            f"rtol {rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def kernel_flops(b, h, sq, sk, d, causal, kernel="fwd") -> int:
    """The flops one flash kernel's function needs: the causal pairs this
    call really has, 2·d flops per pair for each of its products (K1's
    QKᵀ and PV, K2's QKᵀ, dO·Vᵀ and dS·K, K3's QKᵀ, dO·Vᵀ, Pᵀ·dO and
    dSᵀ·Q). A kernel that recomputes a product (K3 forms QKᵀ twice) is
    held to this count."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel]
    return 2 * products * b * h * d * pairs


def kernel_bound(b, h, hkv, sq, sk, d, dtype, causal,
                 kernel="fwd") -> tuple[float, str]:
    """Least time for one flash kernel: its flops (``kernel_flops``) over
    the peak for the dtype, or its bytes (each input read once, each
    output written once) over the HBM rate, whichever is larger; and which
    of the two it is."""
    flops = kernel_flops(b, h, sq, sk, d, causal, kernel)
    item = torch.tensor([], dtype=dtype).element_size()
    q_rows, kv_rows = b * h * sq * d, b * hkv * sk * d
    nbytes = {
        "fwd": (2 * q_rows + 2 * kv_rows) * item + 4 * b * h * sq,
        "dq": (3 * q_rows + 2 * kv_rows) * item + 8 * b * h * sq,
        "dkv": (2 * q_rows + 4 * kv_rows) * item + 8 * b * h * sq,
    }[kernel]
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> dict:
    """K1 against flash_fwd_reference on the card; returns the numbers
    of the main path's shape (bf16, causal, b 4, s 1000)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # name, b, s, h, hkv, d, dtype, causal, through the public wrapper
        ("train gqa s2048 bf16", TRAIN_BATCH, TRAIN_SEQ, 12, 4, 128,
         torch.bfloat16, True, False),
        # MOE_PRESET's training and per-length prefill shapes
        ("moe train gqa s2048 bf16", TRAIN_BATCH, TRAIN_SEQ, MOE_HEADS,
         MOE_KV_HEADS, 128, torch.bfloat16, True, False),
        ("moe prefill s1000 bf16 wrapper", BATCH, PROMPT, MOE_HEADS,
         MOE_KV_HEADS, 128, torch.bfloat16, True, True),
        ("gqa s1024 bf16", 4, 1024, 12, 4, 128, torch.bfloat16, True, False),
        ("gqa s1024 f32", 4, 1024, 12, 4, 128, torch.float32, True, False),
        ("gqa s1000 bf16 wrapper", 4, 1000, 12, 4, 128, torch.bfloat16,
         True, True),
        ("gqa s2047 bf16 wrapper", 1, 2047, 12, 4, 128, torch.bfloat16,
         True, True),
        ("gqa s1000 f32 wrapper", 2, 1000, 12, 4, 128, torch.float32, True,
         True),
        ("mha s512 bf16", 2, 512, 8, 8, 128, torch.bfloat16, True, False),
        ("non-causal s512 bf16", 2, 512, 12, 4, 128, torch.bfloat16, False,
         True),
        ("non-causal s512 f32", 2, 512, 12, 4, 128, torch.float32, False,
         False),
        ("gqa s384 d64 bf16", 2, 384, 8, 2, 64, torch.bfloat16, True, False),
        # d 64's 128-row blocks over 128-key tiles (flash_fwd_twin) at
        # their edges
        *((f"d64 s{s} h{h} hkv{hkv} causal {causal} bf16", b, s, h, hkv, 64,
           torch.bfloat16, causal, False)
          for b, s, h, hkv, causal in D64_EDGES),
        # the pairs of blocks of 128 query rows over 64-key tiles
        # (flash_fwd_pair) at their edges
        *((f"d{d} s{s} h{h} hkv{hkv} causal {causal} bf16", b, s, h, hkv,
           d, torch.bfloat16, causal, False)
          for d in PAIR_DIMS
          for b, s, h, hkv, causal in PAIR_EDGE_SETS["flash_fwd"]),
        ("g3 s1 bf16", 2, 1, 6, 2, 128, torch.bfloat16, True, False),
        ("g3 s65 bf16", 2, 65, 6, 2, 128, torch.bfloat16, True, False),
        ("g2 s127 bf16 wrapper", 2, 127, 8, 4, 128, torch.bfloat16, True,
         True),
        ("mha s129 d64 bf16", 2, 129, 8, 8, 64, torch.bfloat16, True, False),
        # the fine-tuning path's shapes (phase 8): Llama-3.1-8B (d 128)
        # and Llama-3.2-1B (d 64), 32 / 8 heads (GQA group 4), training
        # and a 1000-token prefill
        *((f"llama3 {name} train gqa4 s{FT_SEQ} d{d} bf16", FT_BATCH,
           FT_SEQ, 32, 8, d, torch.bfloat16, True, False)
          for name, d in FT_HEAD_DIMS),
        *((f"llama3 {name} prefill gqa4 s{PROMPT} d{d} bf16 wrapper", 1,
           PROMPT, 32, 8, d, torch.bfloat16, True, True)
          for name, d in FT_HEAD_DIMS),
        # the wide head dims (phase 12 and KERNEL_ONLY_HEADS): the training
        # shape and f32 at a ragged length (through the wrapper up to the
        # per-dim bound; above it O and LSE, twice bitwise); phase 12's
        # per-length prefill; the widest non-causal (the streamed kernels'
        # edges are phase_bwd_kernels' STREAMED_EDGES, through autograd)
        *((f"{name} train s{TRAIN_SEQ} bf16", TRAIN_BATCH, TRAIN_SEQ, h,
           hkv, d, torch.bfloat16, True, False)
          for name, (h, hkv, d) in _kernel_heads().items()),
        *((f"{name} prefill s{PROMPT} bf16 wrapper", BATCH, PROMPT, h, hkv,
           d, torch.bfloat16, True, True)
          for name, (h, hkv, d) in WIDE_HEADS.items()),
        *((f"{name} s{PROMPT} f32" + (" wrapper" if d <= PER_DIM_MAX
                                      else ""), 2, PROMPT, h, hkv, d,
           torch.float32, True, d <= PER_DIM_MAX)
          for name, (h, hkv, d) in _kernel_heads().items()),
        # the streamed f32 K1 (a cluster of ceil(d / 256) blocks up to d
        # 2048) at WIDE_EDGES at each streamed dim's heads, twice bitwise,
        # and the column groups past the largest cluster
        *((f"{name} s{s} causal {causal} f32", b, s, h, hkv, d,
           torch.float32, causal, False)
          for name, (h, hkv, d) in _kernel_heads().items()
          if d > PER_DIM_MAX for b, s, causal in WIDE_EDGES),
        (f"d{F32_PAST_CLUSTER} s65 f32 column groups", 2, 65, 1, 1,
         F32_PAST_CLUSTER, torch.float32, True, False),
        ("non-causal s512 d512 bf16", 2, 512, 3, 1, 512, torch.bfloat16,
         False, True),
        # K1's 128-row blocks at d 192 (64-key tiles) and d 256 (80-key
        # tiles, flash_fwd_rows8) at ragged ends, GQA group 4 and
        # non-causal
        *((f"d{d} s{s} bf16", 2 if s < 2047 else 1, s, h, hkv, d,
           torch.bfloat16, True, False)
          for h, hkv, d in ((6, 2, 256), (8, 4, 192))
          for s in (1, 65, 127, 191, 2047)),
        ("d256 gqa4 s300 bf16", 2, 300, 8, 2, 256, torch.bfloat16, True,
         False),
        *((f"d{d} non-causal s512 bf16", 2, 512, h, hkv, d, torch.bfloat16,
           False, False) for h, hkv, d in ((6, 2, 256), (8, 4, 192))),
        # the f32 kernel's tiles (flash_fwd_f32: 64 query rows and 64-key
        # tiles up to d 256, 32 and 32 from d 320) one row short of and one
        # past their ends, d 64, and F32_SHAPES
        ("gqa s384 d64 f32", 2, 384, 8, 2, 64, torch.float32, True, False),
        *((f"f32 d128 s{s}", 2, s, 6, 2, 128, torch.float32, True, False)
          for s in (63, 65, 127, 129)),
        *((f"f32 d512 s{s}", 2, s, 3, 1, 512, torch.float32, True, False)
          for s in (31, 33, 63, 65)),
        *((f"f32 {label}", b, s, h, hkv, d, torch.float32, True, False)
          for label, (b, s, h, hkv, d) in F32_SHAPES.items()),
    ]
    worst = 0.0
    # the largest error of the bf16 cases at each wide head dim, of the
    # f32 cases up to the per-dim bound, and of the f32 ones at each
    # streamed head dim
    worst_wide = {d: 0.0 for _, _, d in _kernel_heads().values()}
    worst_f32 = 0.0
    # (and of the column groups past the largest cluster, apart)
    worst_f32_wide = dict.fromkeys((*_streamed_dims(), F32_PAST_CLUSTER),
                                   0.0)
    worst_wide[F32_PAST_CLUSTER] = 0.0
    # and of the bf16 cases at the fine-tuning head dims
    worst_ft = {d: 0.0 for _, d in FT_HEAD_DIMS}
    for name, b, s, h, hkv, d, dtype, causal, wrapper in cases:
        q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want_o, want_lse = fa.flash_fwd_reference(qt, kt, vt, causal)
        atol, rtol = TOL[dtype]
        before = fa.launches
        if wrapper:
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = _check(name, got, want_o.transpose(1, 2), atol, rtol)
        else:
            got_o, got_lse = fa.flash_fwd(qt, kt, vt, causal)
            torch.cuda.synchronize()
            err = _check(name, got_o, want_o, atol, rtol)
            lerr = _check(name + " lse", got_lse, want_lse, LSE_ATOL, 0.0)
            _log(f"  lse max abs err {lerr:.3e}")
        if fa.launches != before + 1:
            raise AssertionError(f"{name}: the kernel did not launch")
        if not wrapper and (d > PER_DIM_MAX or (
                d in PAIR_DIMS and dtype == torch.bfloat16)):
            # a pair, or the streamed kernel's column groups, sum in a
            # fixed order: the same bits again
            again_o, again_lse = fa.flash_fwd(qt, kt, vt, causal)
            if not (torch.equal(got_o, again_o)
                    and torch.equal(got_lse, again_lse)):
                raise AssertionError(f"{name}: K1 is not deterministic")
            _log("  twice on one input, bitwise equal")
            del again_o, again_lse
        if dtype == torch.float32 and d in worst_f32_wide:
            worst_f32_wide[d] = max(worst_f32_wide[d], err)
        elif dtype == torch.float32:
            worst_f32 = max(worst_f32, err)
        if d not in worst_wide:
            worst = max(worst, err)
        elif dtype == torch.bfloat16:
            worst_wide[d] = max(worst_wide[d], err)
        if d in worst_ft and dtype == torch.bfloat16:
            worst_ft[d] = max(worst_ft[d], err)
        _log(f"kernel {name}: max abs err {err:.3e} "
             f"(atol {atol}, rtol {rtol})")

    # timing at the serving path's shape, at s 1024, and at the training
    # path's shape
    timed = {}
    for b, s in ((BATCH, PROMPT), (BATCH, 1024), (TRAIN_BATCH, TRAIN_SEQ)):
        h, hkv, d, dtype = 12, 4, 128, torch.bfloat16
        q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = _time_ms(lambda: fa.flash_fwd(qt, kt, vt, True),
                      queue_ahead=True)
        plain_ms = _time_ms(lambda: fa.flash_fwd_reference(qt, kt, vt, True),
                            queue_ahead=True)
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
            qt, kt, vt, is_causal=True, enable_gqa=True), queue_ahead=True)
        bound_ms, bound_by = kernel_bound(b, h, hkv, s, s, d, dtype, True)
        tflops = kernel_flops(b, h, s, s, d, True) / ms / 1e9
        _log(f"time b{b} s{s} h{h} hkv{hkv} d{d} bf16 causal: kernel "
             f"{ms:.4f} ms ({tflops:.1f} TF/s, {bound_ms / ms:.3f} of "
             f"bound), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
             f"bound {bound_ms:.4f} ms ({bound_by})")
        timed[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by, tflops=tflops,
                        bound_share=bound_ms / ms)
    # the host side of one K1 call (wrapper checks, output allocation, the
    # ctypes call, tensor maps, launch) at a size where the card is idle
    # most of the time: what a caller that does not queue ahead waits for
    q, k, v = _qkv(1, 128, 1, 1, 128, torch.bfloat16, gen)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    for _ in range(10):
        fa.flash_fwd(qt, kt, vt, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fa.flash_fwd(qt, kt, vt, True)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    _log(f"time K1 host path per call (b1 s128 h1 hkv1, host clock, 200 "
         f"calls): {host_us:.1f} us")
    # f32 (flash_fwd_f32) at F32_SHAPES
    f32 = {label: dict(_time_k1("f32", b, s, h, hkv, d, gen, torch.float32),
                       max_abs_err=worst_f32,
                       shape=f"b{b} s{s} h{h} hkv{hkv} d{d} f32 causal")
           for label, (b, s, h, hkv, d) in F32_SHAPES.items()}
    # the fine-tuning shapes: b 4, s 2048, 32 / 8 heads, d 128 and d 64,
    # each with the largest error of the bf16 cases at its head dim
    ft = {f"b{FT_BATCH} s{FT_SEQ} h32 hkv8 d{d} bf16 causal": dict(
        _time_k1(f"llama3 {name}", FT_BATCH, FT_SEQ, 32, 8, d, gen),
        max_abs_err=worst_ft[d])
        for name, d in FT_HEAD_DIMS}
    # the wide head dims at the training shape (flash_fwd_wgmma<192>,
    # flash_fwd_rows8<256>, flash_fwd_split<320> and <448>,
    # flash_fwd_pair<384> and <512>, flash_fwd_wide<256> above 512: the
    # build's ptxas lines above give their registers and spills), the
    # streamed kernel with its recompute factor
    wide = {name: dict(
        _time_k1(name, TRAIN_BATCH, TRAIN_SEQ, h, hkv, d, gen),
        max_abs_err=worst_wide[d],
        shape=f"b{TRAIN_BATCH} s{TRAIN_SEQ} h{h} hkv{hkv} d{d} bf16 causal",
        **streamed_numbers("flash_fwd", d))
        for name, (h, hkv, d) in _kernel_heads().items()}
    # the streamed f32 kernel at b 2 s 1000 at each of its head dims
    f32_wide = {name: dict(
        _time_k1(name, 2, PROMPT, h, hkv, d, gen, torch.float32),
        max_abs_err=worst_f32_wide[d],
        shape=f"b2 s{PROMPT} h{h} hkv{hkv} d{d} f32 causal",
        **streamed_numbers("flash_fwd", d, torch.float32))
        for name, (h, hkv, d) in _kernel_heads().items()
        if d > PER_DIM_MAX}
    return dict(max_abs_err=worst, **timed[TRAIN_SEQ], more_shapes=ft,
                wide=wide, f32=f32, f32_wide=f32_wide)


def _kernel_heads() -> dict:
    """Phase 3's wide head dims: phase 12's models and the kernel-only
    dims, name -> (heads, KV heads, head dim)."""
    return {**WIDE_HEADS, **KERNEL_ONLY_HEADS}


def _streamed_dims() -> list:
    """The head dims of ``_kernel_heads`` above the per-dim bound, where
    the streamed kernels run."""
    return [d for _, _, d in _kernel_heads().values() if d > PER_DIM_MAX]


def recompute(d: int, kernel: str, dtype=torch.bfloat16) -> float:
    """The work of a streamed kernel (``WIDE_KERNELS``, or in f32
    ``WIDE_F32_KERNELS`` and ``WIDE_F32_GROUPS``) at head dim ``d`` over
    its function's (``kernel_flops``): each of its column groups forms the
    scores over the whole head dim (K1 S, K2 S and dP, K3 S^T and dP^T)
    and multiplies against its group's W columns, a last narrower group
    too (its columns past d are zeros); 2·d flops a causal pair a product
    either way, as W flops for a group's product. A cluster (``wide_cluster``
    in bf16, ``wide_f32_cluster`` in f32) forms each score once, each block
    over its own columns, and multiplies only its own columns: 1.0."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    scores, outputs = {"flash_fwd": (1, 1), "flash_bwd_dq": (2, 1),
                       "flash_bwd_dkv": (2, 2)}[kernel]
    groups = len(fa.wide_groups(d, kernel))
    if _cluster(d, kernel, dtype) == groups:
        return (scores * d + outputs * d) / ((scores + outputs) * d)
    done = groups * (scores * d + outputs * fa.WIDE_COLUMNS[kernel])
    return done / ((scores + outputs) * d)


def streamed_numbers(kernel: str, d: int, dtype=torch.bfloat16) -> dict:
    """What phase 3 records beside a timing at head dim ``d`` where the
    streamed kernel runs (above the per-dim bound): the kernel of
    ``dtype``, as ``<template><<W>>``, its recompute factor and the blocks
    of its cluster (1: none; f32 K1, K2 and K3 and bf16 K3 on a cluster up
    to ``WIDE_CLUSTER_MAX`` groups, the column groups above); else
    nothing."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    if d <= PER_DIM_MAX:
        return {}
    cluster = _cluster(d, kernel, dtype)
    kernels, groups = ((WIDE_KERNELS, WIDE_GROUPS) if dtype == torch.bfloat16
                       else (WIDE_F32_KERNELS, WIDE_F32_GROUPS))
    template = (groups[kernel] if cluster == 1 and kernel in groups
                else kernels[kernel])
    return {"kernel": f"{template}<{fa.WIDE_COLUMNS[kernel]}>",
            "recompute": recompute(d, kernel, dtype), "cluster": cluster}


def _cluster(d: int, kernel: str, dtype) -> int:
    """The blocks of a cluster of the streamed ``kernel`` of ``dtype`` at
    head dim ``d`` (1: none), ops/flash_attention.py's ``wide_cluster`` or
    ``wide_f32_cluster``."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    return (fa.wide_cluster if dtype == torch.bfloat16
            else fa.wide_f32_cluster)(d, kernel)


def _sdpa_backend(q, k, v) -> str:
    """The backend SDPA takes for these [b, h, s, d] inputs (causal, GQA):
    the first of its priority order that accepts them (its flash backend
    stops at d 256)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in map(SDPBackend, torch._C._get_sdp_priority_order()):
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(
                    q[:1], k[:1], v[:1], is_causal=True, enable_gqa=True)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def _time_k1(label, b, s, h, hkv, d, gen, dtype=torch.bfloat16) -> dict:
    """K1 at one causal shape (bf16 unless ``dtype`` says f32), timed
    beside its plain version and SDPA's forward (naming the backend SDPA
    took), with its TF/s and share of the bound (f32: at the f32 rate)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = _time_ms(lambda: fa.flash_fwd(qt, kt, vt, True), queue_ahead=True)
    plain_ms = _time_ms(lambda: fa.flash_fwd_reference(qt, kt, vt, True),
                        iters=5, warmup=1, queue_ahead=True)
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
        qt, kt, vt, is_causal=True, enable_gqa=True), queue_ahead=True)
    backend = _sdpa_backend(qt, kt, vt)
    bound_ms, bound_by = kernel_bound(b, h, hkv, s, s, d, dtype, True)
    tflops = kernel_flops(b, h, s, s, d, True) / ms / 1e9
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    _log(f"time {label} b{b} s{s} h{h} hkv{hkv} d{d} {tag} causal: kernel "
         f"{ms:.4f} ms ({tflops:.1f} TF/s, {bound_ms / ms:.3f} of bound), "
         f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({backend}), bound "
         f"{bound_ms:.4f} ms ({bound_by}, at "
         f"{PEAK_FLOPS[dtype] / 1e12:.0f} TF/s)"
         f"{_streamed_note('flash_fwd', d, dtype)}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_backend=backend, bound_ms=bound_ms,
                bound_by=bound_by, tflops=tflops, bound_share=bound_ms / ms)


def _streamed_note(kernel: str, d: int, dtype=torch.bfloat16) -> str:
    """A timing line's note of the streamed kernel, its recompute factor
    and its cluster, where it runs."""
    n = streamed_numbers(kernel, d, dtype)
    cluster = (f", a cluster of {n['cluster']}" if n and n["cluster"] > 1
               else "")
    return (f"; {n['kernel']}, recompute {n['recompute']:.3f}x{cluster}"
            if n else "")


def _bwd_inputs(b, s, h, hkv, d, dtype, gen, causal):
    """[b, h, s, d] views of model-layout q/k/v/dO on the card and the
    forward's o and lse (K1)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = (t.transpose(1, 2) for t in _qkv(b, s, h, hkv, d, dtype, gen))
    do = _qkv(b, s, h, h, d, dtype, gen)[0].transpose(1, 2)
    o, lse = fa.flash_fwd(q, k, v, causal)
    return q, k, v, do, o, lse


def phase_bwd_kernels() -> dict:
    """K2 and K3 against flash_bwd_dq_reference/flash_bwd_dkv_reference
    on the card, directly and (ragged lengths) through autograd over the
    public ``flash_attention``; timed at the training shape beside their
    plain versions and SDPA's backward. Returns {"flash_bwd_dq": {...},
    "flash_bwd_dkv": {...}} with the numbers of the training shape."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # name, b, s, h, hkv, d, dtype, causal
        ("train gqa s2048 bf16", TRAIN_BATCH, TRAIN_SEQ, 12, 4, 128,
         torch.bfloat16, True),
        ("train gqa s2048 f32", TRAIN_BATCH, TRAIN_SEQ, 12, 4, 128,
         torch.float32, True),
        # MOE_PRESET's training shape
        ("moe train gqa s2048 bf16", TRAIN_BATCH, TRAIN_SEQ, MOE_HEADS,
         MOE_KV_HEADS, 128, torch.bfloat16, True),
        ("mha s512 bf16", 2, 512, 8, 8, 128, torch.bfloat16, True),
        ("non-causal s512 bf16", 2, 512, 12, 4, 128, torch.bfloat16, False),
        ("non-causal s512 f32", 2, 512, 12, 4, 128, torch.float32, False),
        ("gqa s384 d64 bf16", 2, 384, 8, 2, 64, torch.bfloat16, True),
        ("gqa s384 d64 f32", 2, 384, 8, 2, 64, torch.float32, True),
        # the fine-tuning path's training shapes (phase 8)
        *((f"llama3 {name} train gqa4 s{FT_SEQ} d{d} bf16", FT_BATCH,
           FT_SEQ, 32, 8, d, torch.bfloat16, True)
          for name, d in FT_HEAD_DIMS),
        # the wide head dims (phase 12 and KERNEL_ONLY_HEADS): the training
        # shape, f32 at a ragged length (above the per-dim bound the
        # streamed f32 kernels), and the widest non-causal
        *((f"{name} train s{TRAIN_SEQ} bf16", TRAIN_BATCH, TRAIN_SEQ, h,
           hkv, d, torch.bfloat16, True)
          for name, (h, hkv, d) in _kernel_heads().items()),
        *((f"{name} s{PROMPT} f32", 2, PROMPT, h, hkv, d, torch.float32,
           True)
          for name, (h, hkv, d) in _kernel_heads().items()),
        # the streamed f32 K2 and K3 (a cluster of ceil(d / 256) blocks up
        # to d 2048) at WIDE_EDGES at each streamed dim's heads, and the
        # column groups past the largest cluster
        *((f"{name} s{s} causal {causal} f32", b, s, h, hkv, d,
           torch.float32, causal)
          for name, (h, hkv, d) in _kernel_heads().items()
          if d > PER_DIM_MAX for b, s, causal in WIDE_EDGES),
        (f"d{F32_PAST_CLUSTER} s65 f32 column groups", 2, 65, 1, 1,
         F32_PAST_CLUSTER, torch.float32, True),
        # the streamed bf16 K3 (a cluster of ceil(d / 256) blocks up to d
        # 2048; K2 beside it) at WIDE_EDGES at each streamed dim's heads,
        # and the column groups past the largest cluster
        *((f"{name} s{s} causal {causal} bf16", b, s, h, hkv, d,
           torch.bfloat16, causal)
          for name, (h, hkv, d) in _kernel_heads().items()
          if d > PER_DIM_MAX for b, s, causal in WIDE_EDGES),
        (f"d{F32_PAST_CLUSTER} s65 bf16 column groups", 2, 65, 1, 1,
         F32_PAST_CLUSTER, torch.bfloat16, True),
        ("non-causal s512 d512 bf16", 2, 512, 3, 1, 512, torch.bfloat16,
         False),
        # d 256's 64-key K3 blocks and 128-row K2 blocks at ragged ends,
        # GQA group 4 and non-causal; at d 192 the row split's 128-key K3
        # blocks (32-row stages) and the 128-row K2 blocks (32-key stages)
        *((f"d256 s{s} bf16", 2 if s < 2047 else 1, s, 6, 2, 256,
           torch.bfloat16, True) for s in (65, 127, 191, 2047)),
        ("d256 gqa4 s300 bf16", 2, 300, 8, 2, 256, torch.bfloat16, True),
        ("d256 non-causal s512 bf16", 2, 512, 6, 2, 256, torch.bfloat16,
         False),
        *((f"d192 s{s} bf16", 2 if s < 2047 else 1, s, 8, 4, 192,
           torch.bfloat16, True) for s in (1, 63, 65, 127, 191, 2047)),
        # d 64's 128-row K2 blocks and 128-key K3 blocks at their edges
        *((f"d64 s{s} h{h} hkv{hkv} causal {causal} bf16", b, s, h, hkv, 64,
           torch.bfloat16, causal) for b, s, h, hkv, causal in D64_EDGES),
        ("d192 gqa4 s300 bf16", 2, 300, 8, 2, 192, torch.bfloat16, True),
        ("d192 non-causal s512 bf16", 2, 512, 8, 4, 192, torch.bfloat16,
         False),
        # K2's and K3's pairs of blocks at d 384 and 512 (dq_pair: 128
        # query rows a pair, 32-key stages; dkv_pair: 64 keys a pair) at
        # both kernels' edges, side by side, and K3's at d 320 and 448 at
        # its own
        *((f"d{d} s{s} h{h} hkv{hkv} causal {causal} bf16", b, s, h, hkv, d,
           torch.bfloat16, causal)
          for d in DKV_PAIR_DIMS
          for b, s, h, hkv, causal in dict.fromkeys(
              PAIR_EDGE_SETS["flash_bwd_dkv"]
              + (PAIR_EDGE_SETS["flash_bwd_dq"] if d in PAIR_DIMS
                 else ()))),
        # the f32 kernels' tiles (dq_f32: 64 rows at d 128, 32 at d 512;
        # dkv_f32: 64 keys and 32-row query tiles at d 128, 32 keys and
        # 8-row query tiles at d 512) one row short of and one past their
        # ends, and F32_SHAPES
        *((f"f32 d128 s{s}", 2, s, 6, 2, 128, torch.float32, True)
          for s in (31, 33, 63, 65, 127, 129)),
        *((f"f32 d512 s{s}", 2, s, 3, 1, 512, torch.float32, True)
          for s in (7, 9, 31, 33, 63, 65)),
        *((f"f32 {label}", b, s, h, hkv, d, torch.float32, True)
          for label, (b, s, h, hkv, d) in F32_SHAPES.items()),
    ]
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    worst_f32, worst_d64 = dict(worst), dict(worst)
    # the largest error of the bf16 cases at each wide head dim, and of the
    # f32 ones at each streamed head dim
    # (and of the column groups past the largest cluster, apart)
    worst_wide = {(kernel, d): 0.0 for kernel in worst
                  for d in (*(d for _, _, d in _kernel_heads().values()),
                            F32_PAST_CLUSTER)}
    worst_f32_wide = {(kernel, d): 0.0 for kernel in worst
                      for d in _streamed_dims()}
    for name, b, s, h, hkv, d, dtype, causal in cases:
        q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen,
                                          causal)
        delta = fa.flash_bwd_delta(o, do)
        atol, rtol = BWD_TOL[dtype]
        before = (fa.dq_launches, fa.dkv_launches)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if (fa.dq_launches, fa.dkv_launches) != (before[0] + 1,
                                                 before[1] + 1):
            raise AssertionError(f"{name}: K2/K3 did not launch")
        want_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        e = _check(f"{name} dq", dq, want_dq, atol, rtol)
        del want_dq
        want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                      delta, causal)
        ek = _check(f"{name} dk", dk, want_dk, atol, rtol)
        ev = _check(f"{name} dv", dv, want_dv, atol, rtol)
        if dtype == torch.float32 and d > PER_DIM_MAX:
            worst_f32_wide["flash_bwd_dq", d] = max(
                worst_f32_wide.get(("flash_bwd_dq", d), 0.0), e)
            worst_f32_wide["flash_bwd_dkv", d] = max(
                worst_f32_wide.get(("flash_bwd_dkv", d), 0.0), ek, ev)
        elif dtype == torch.float32:
            worst_f32["flash_bwd_dq"] = max(worst_f32["flash_bwd_dq"], e)
            worst_f32["flash_bwd_dkv"] = max(worst_f32["flash_bwd_dkv"], ek,
                                             ev)
        elif ("flash_bwd_dq", d) not in worst_wide:
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e)
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], ek, ev)
            if d == 64:
                worst_d64["flash_bwd_dq"] = max(worst_d64["flash_bwd_dq"], e)
                worst_d64["flash_bwd_dkv"] = max(worst_d64["flash_bwd_dkv"],
                                                 ek, ev)
        else:
            worst_wide["flash_bwd_dq", d] = max(worst_wide["flash_bwd_dq", d],
                                                e)
            worst_wide["flash_bwd_dkv", d] = max(
                worst_wide["flash_bwd_dkv", d], ek, ev)
        _log(f"kernel {name}: dq max abs err {e:.3e}, dk {ek:.3e}, dv "
             f"{ev:.3e} (atol {atol}, rtol {rtol})")
        # K2 and K3 sum in a fixed order with no atomics (f32: K3's split
        # parts too): a second launch on the same inputs gives the same bits
        dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq2):
            raise AssertionError(f"{name}: K2 is not deterministic")
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"{name}: K3 is not deterministic")
        _log(f"kernel {name}: K2 and K3 twice on one input, bitwise equal")
        del dq2, dk2, dv2
        del want_dk, want_dv, q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    # ragged lengths through the public wrapper: autograd over
    # flash_attention on model-layout tensors (K1, then K2 and K3 from
    # the FlashAttention Function), against flash_bwd_reference
    for b, s in ((2, 1000), (1, 2047)):
        h, hkv, d, dtype = 12, 4, 128, torch.bfloat16
        q, k, v = (t.requires_grad_(True)
                   for t in _qkv(b, s, h, hkv, d, dtype, gen))
        do = _qkv(b, s, h, h, d, dtype, gen)[0]
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        o = fa.flash_attention(q, k, v, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        if (fa.launches, fa.dq_launches, fa.dkv_launches) != tuple(
                n + 1 for n in before):
            raise AssertionError(f"ragged s{s}: K1/K2/K3 did not launch")
        qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
        ro, rlse = fa.flash_fwd_reference(qt, kt, vt, True)
        want = fa.flash_bwd_reference(qt, kt, vt, ro, rlse,
                                      do.transpose(1, 2), True)
        atol, rtol = BWD_TOL[dtype]
        errs = [_check(f"ragged s{s} d{n}", t.grad.transpose(1, 2), w,
                       atol, rtol)
                for t, w, n in zip((q, k, v), want, "qkv")]
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], *errs[1:])
        _log(f"kernel ragged s{s} bf16 through flash_attention autograd: "
             f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}")
        del q, k, v, do, o, want, ro, rlse

    # the streamed kernels (above the per-dim bound) at STREAMED_EDGES, at
    # each of their dims' heads, in bf16 and f32, and at CLUSTER_SIZE_EDGES
    # at CLUSTER_SIZE_HEADS, through autograd over flash_attention: O
    # against K1's plain version, the gradients against
    # flash_bwd_reference, and the whole of it again, bitwise
    streamed = [(label, h, hkv, d, (torch.bfloat16, torch.float32),
                 STREAMED_EDGES)
                for label, (h, hkv, d) in _kernel_heads().items()
                if d > PER_DIM_MAX]
    streamed += [(f"d{d}", h, hkv, d, (torch.bfloat16, torch.float32)
                  if d in CLUSTER_SIZE_F32 else (torch.bfloat16,),
                  CLUSTER_SIZE_EDGES)
                 for d, (h, hkv) in CLUSTER_SIZE_HEADS.items()]
    for label, h, hkv, d, dtypes, edges in streamed:
        for dtype, (b, s, causal) in itertools.product(dtypes, edges):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            name = f"{label} s{s} causal {causal} {tag} autograd"
            q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
            do = _qkv(b, s, h, h, d, dtype, gen)[0]
            runs = []
            for _ in range(2):
                ts = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
                before = _counts(fa)
                o = fa.flash_attention(*ts, causal=causal)
                o.backward(do)
                torch.cuda.synchronize()
                if _counts(fa) != {n: c + 1 for n, c in before.items()}:
                    raise AssertionError(f"{name}: K1/K2/K3 did not launch")
                runs.append((o.detach(), *(t.grad for t in ts)))
            if not all(map(torch.equal, *runs)):
                raise AssertionError(f"{name}: not the same bits again")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ro, rlse = fa.flash_fwd_reference(qt, kt, vt, causal)
            eo = _check(f"{name} O", runs[0][0].transpose(1, 2), ro,
                        *TOL[dtype])
            want = fa.flash_bwd_reference(qt, kt, vt, ro, rlse,
                                          do.transpose(1, 2), causal)
            errs = [_check(f"{name} d{n}", g.transpose(1, 2), w,
                           *BWD_TOL[dtype])
                    for g, w, n in zip(runs[0][1:], want, "qkv")]
            into = worst_wide if dtype == torch.bfloat16 else worst_f32_wide
            into["flash_bwd_dq", d] = max(into.get(("flash_bwd_dq", d), 0.0),
                                          errs[0])
            into["flash_bwd_dkv", d] = max(
                into.get(("flash_bwd_dkv", d), 0.0), *errs[1:])
            _log(f"kernel {name} (b{b} h{h} hkv{hkv}): O {eo:.3e}, dq "
                 f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; twice, "
                 "bitwise equal")
            del q, k, v, do, runs, ts, o, ro, rlse, want
        torch.cuda.empty_cache()

    # timing at the training shape: each kernel, its plain version, and
    # SDPA's backward (one call for dQ, dK and dV together: the backward
    # of one autograd graph, timed as a yardstick for both rows)
    b, s, h, hkv, d, dtype = TRAIN_BATCH, TRAIN_SEQ, 12, 4, 128, \
        torch.bfloat16
    q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
    delta = fa.flash_bwd_delta(o, do)
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, is_causal=True, enable_gqa=True)
    lib_ms = _time_ms(lambda: torch.autograd.grad(
        so, (sq, sk, sv), do, retain_graph=True), iters=10, queue_ahead=True)
    delta_ms = _time_ms(lambda: fa.flash_bwd_delta(o, do), iters=10,
                        queue_ahead=True)
    out = {}
    for name, kern, plain, kind in (
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
             lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               True), "dq"),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
             lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True), "dkv")):
        ms = _time_ms(kern, queue_ahead=True)
        plain_ms = _time_ms(plain, iters=5, warmup=1, queue_ahead=True)
        bound_ms, bound_by = kernel_bound(b, h, hkv, s, s, d, dtype, True,
                                          kind)
        tflops = kernel_flops(b, h, s, s, d, True, kind) / ms / 1e9
        _log(f"time {name} b{b} s{s} h{h} hkv{hkv} d{d} bf16 causal: "
             f"kernel {ms:.4f} ms ({tflops:.1f} TF/s, {bound_ms / ms:.3f} "
             f"of bound), plain {plain_ms:.4f} ms, sdpa backward "
             f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out[name] = dict(max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, tflops=tflops,
                         bound_share=bound_ms / ms)
    _log(f"time delta = rowsum(dO*O) (torch ops) b{b} s{s}: "
         f"{delta_ms:.4f} ms")
    del q, k, v, do, o, lse, delta, sq, sk, sv, so
    # the fine-tuning shapes: b 4, s 2048, 32 / 8 heads, d 128 and d 64
    for name in out:
        out[name]["more_shapes"] = {}
        out[name]["wide"] = {}
    for label, d in FT_HEAD_DIMS:
        for name, n in _time_k2_k3(f"llama3 {label}", FT_BATCH, FT_SEQ, 32,
                                   8, d, gen).items():
            if d == 64:  # d 64's own cases (its kernels line entries)
                n["max_abs_err"] = worst_d64[name]
            out[name]["more_shapes"][
                f"b{FT_BATCH} s{FT_SEQ} h32 hkv8 d{d} bf16 causal"] = n
    # the wide head dims at the training shape (dq_wgmma and dkv_wgmma at
    # <192> and <256>, dq_split and dkv_split at <320> to <512>)
    for label, (h, hkv, d) in _kernel_heads().items():
        for name, n in _time_k2_k3(label, TRAIN_BATCH, TRAIN_SEQ, h, hkv, d,
                                   gen).items():
            out[name]["wide"][label] = dict(
                n, max_abs_err=worst_wide[name, d],
                shape=f"b{TRAIN_BATCH} s{TRAIN_SEQ} h{h} hkv{hkv} d{d} bf16 "
                      "causal", **streamed_numbers(name, d))
    # f32 (dq_f32, dkv_f32) at F32_SHAPES
    for name in out:
        out[name]["f32"] = {}
        out[name]["f32_wide"] = {}
    for label, (b, s, h, hkv, d) in F32_SHAPES.items():
        for name, n in _time_k2_k3("f32", b, s, h, hkv, d, gen,
                                   torch.float32).items():
            out[name]["f32"][label] = dict(
                n, max_abs_err=worst_f32[name],
                shape=f"b{b} s{s} h{h} hkv{hkv} d{d} f32 causal")
    # the streamed f32 kernels at b 2 s 1000 at each of their head dims
    for label, (h, hkv, d) in _kernel_heads().items():
        if d <= PER_DIM_MAX:
            continue
        for name, n in _time_k2_k3(label, 2, PROMPT, h, hkv, d, gen,
                                   torch.float32).items():
            out[name]["f32_wide"][label] = dict(
                n, max_abs_err=worst_f32_wide[name, d],
                shape=f"b2 s{PROMPT} h{h} hkv{hkv} d{d} f32 causal",
                **streamed_numbers(name, d, torch.float32))
    return out


def _time_k2_k3(label, b, s, h, hkv, d, gen, dtype=torch.bfloat16) -> dict:
    """K2 and K3 at one causal shape (bf16 unless ``dtype`` says f32),
    each timed beside its plain version and SDPA's backward (one call for
    dQ, dK and dV together, naming the backend SDPA took), with TF/s, the
    share of the bound (f32: at the f32 rate) and the pair's sum
    (``pair_ms``, beside SDPA's backward): {kernel name: numbers}."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    delta = fa.flash_bwd_delta(o, do)
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, is_causal=True, enable_gqa=True)
    lib_ms = _time_ms(lambda: torch.autograd.grad(
        so, (sq, sk, sv), do, retain_graph=True), iters=10, queue_ahead=True)
    backend = _sdpa_backend(q, k, v)
    out = {}
    for name, kern, plain, kind in (
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
             lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               True), "dq"),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
             lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True), "dkv")):
        ms = _time_ms(kern, queue_ahead=True)
        plain_ms = _time_ms(plain, iters=3, warmup=1, queue_ahead=True)
        bound_ms, bound_by = kernel_bound(b, h, hkv, s, s, d, dtype, True,
                                          kind)
        tflops = kernel_flops(b, h, s, s, d, True, kind) / ms / 1e9
        _log(f"time {name} {label} b{b} s{s} h{h} hkv{hkv} d{d} {tag} "
             f"causal: kernel {ms:.4f} ms ({tflops:.1f} TF/s, "
             f"{bound_ms / ms:.3f} of bound), plain {plain_ms:.4f} ms, sdpa "
             f"backward {lib_ms:.4f} ms ({backend}), bound {bound_ms:.4f} ms "
             f"({bound_by}, at {PEAK_FLOPS[dtype] / 1e12:.0f} TF/s)"
             f"{_streamed_note(name, d, dtype)}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_backend=backend, bound_ms=bound_ms,
                         bound_by=bound_by, tflops=tflops,
                         bound_share=bound_ms / ms)
    # the pair computes what SDPA's one backward call does
    pair_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    for n in out.values():
        n["pair_ms"] = pair_ms
    _log(f"time K2 + K3 {label} b{b} s{s} h{h} hkv{hkv} d{d} {tag} causal: "
         f"{pair_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms ({backend}, "
         f"{pair_ms / lib_ms:.3f}x)")
    del q, k, v, do, o, lse, delta, sq, sk, sv, so
    torch.cuda.empty_cache()
    return out


def phase_wide_designs() -> dict:
    """At d 64, 192, 256 and 320 to 512 some kernels have two designs
    each. K1 at d
    64, 192 and 256: the row split (flash_fwd_wgmma: 12-warp blocks of
    128 rows, 64 a consumer, a producer warpgroup) and, at d 192 and 256,
    the rows on 8 warps (flash_fwd_rows8: the same rows without the
    producer, 80- or 96-key tiles, the two warpgroups taking turns at the
    tensor cores), at d 64 the twin blocks (flash_fwd_twin: those rows on
    two blocks a SM, 128-key tiles, each warpgroup's tile in series). K2
    and K3 at d 64, 192 and 256: the row split (dq_wgmma, dkv_wgmma:
    12-warp blocks with a producer warpgroup, K3 in two passes) and the
    8-warp designs (dq_rows8: the same rows without the producer;
    dkv_onepass: 64 keys a block, dV on one warpgroup and dK on the
    other, one pass; dkv_keys8 at d 64: 128 keys a block, 64 a warpgroup,
    each holding dK and dV of its keys, one pass); K1, K2 and K3 at d 384
    and 512 (K2's pair ships at d 512 only) and K3 at d 320 and 448: the D
    split (dkv_split: 64 keys a block, the output's columns split between
    the warpgroups, two passes; flash_fwd_split and dq_split: 64 rows a
    block) and a cluster of two (dkv_pair: dkv_onepass on each block of a
    pair; flash_fwd_pair and dq_pair: 128 rows a pair, as flash_fwd_wgmma
    and dq_rows8; each block holding half of the head dim, at d 320 and
    448 K3's 64 ceil(d / 128) columns a block, the second block's last 64
    TMA's zeros; the score products' partial sums exchanged between the
    pair's shared memories). The port ships, per
    kernel and head dim, the one its sources name (``flash_fwd_design``,
    ``flash_bwd_dq_design``, ``flash_bwd_dkv_design`` in each library);
    the other is built with -DFLASH_OTHER_DESIGNS=1 (phase 2). At each
    head dim's DESIGN_SHAPES (and for K1 at d 256 also at its per-length
    prefill, b 4 s 1000) the kernels have their other builds held against
    the plain versions (K2 and K3 also twice on one input, bitwise), then
    timed in turns with the shipped ones on the same inputs (shipped,
    other, other, shipped), K1 beside SDPA's forward with the blocks an SM
    holds of each, K2 + K3 as a pair beside SDPA's backward, each kernel
    that either build launches in clusters (K1, K2 and K3 at d 384 and
    512, K3 at d 320 and 448) with the clusters of two a card holds of
    each (-1: not a cluster kernel); the other K1 at d 192 and 256 and K2
    at d 192 (WIDE_EDGES), the other K1, K2 and K3 at d 64 (D64_EDGES) and
    at d 384 and 512 and K3 at d 320 and 448 (PAIR_EDGE_SETS) are also
    held against the plain versions
    at ragged lengths, GQA groups and non-causal. Returns {head
    dim: {kernel: numbers}}, K1's prefill numbers under ``"prefill"``."""
    from service_account_auth_improvements_tpu_torch.ops import (
        _build,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    libs = _design_libs()
    named = {d: {which: design_names(libs[which]["flash_fwd"],
                                     libs[which]["flash_bwd"], d)
                 for which in libs}
             for d in DESIGN_DIMS}
    kernels = {d: {which: design_kernels(libs[which]["flash_fwd"],
                                         libs[which]["flash_bwd"], d)
                   for which in libs}
               for d in DESIGN_DIMS}

    def k1(q, k, v):
        return {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                              lambda: fa.flash_fwd_reference(q, k, v, True),
                              [TOL[dtype], (LSE_ATOL, 0.0)])}

    def bwd(q, k, v, do, lse, delta, causal=True):
        return {
            "flash_bwd_dq": (
                lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),),
                lambda: (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                   causal),),
                [BWD_TOL[dtype]]),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal),
                [BWD_TOL[dtype]] * 2),
        }

    out = {}
    # the kernels whose two builds differ (and K2 beside K3) at each dim's
    # DESIGN_SHAPES
    for d in sorted(DESIGN_DIMS, reverse=True):
        b, s, h, hkv = DESIGN_SHAPES[d]
        q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
        delta = fa.flash_bwd_delta(o, do)
        calls = bwd(q, k, v, do, lse, delta)
        if len({n["flash_fwd"] for n in named[d].values()}) > 1:
            calls = {**k1(q, k, v), **calls}
        shape = f"b{b} s{s} h{h} hkv{hkv} d{d} bf16 causal"
        out[d] = _in_turns(libs, named[d], calls, shape)
        for name, n in out[d].items():
            n.update(shipped_kernel=kernels[d]["shipped"][name],
                     other_kernel=kernels[d]["other"][name])
        if "flash_fwd" in calls:
            # K1: beside SDPA's forward, with the blocks an SM holds
            n = out[d]["flash_fwd"]
            n["library_ms"] = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
                q, k, v, is_causal=True, enable_gqa=True), queue_ahead=True)
            for which in libs:
                n[f"{which}_blocks_per_sm"] = libs[which][
                    "flash_fwd"].flash_fwd_blocks_per_sm(d)
            _log(f"time d{d} designs K1 {shape}, in turns: shipped "
                 f"({n['shipped_kernel']}, {n['shipped_blocks_per_sm']} "
                 f"blocks a SM) {n['shipped_ms']:.4f} ms, other "
                 f"({n['other_kernel']}, {n['other_blocks_per_sm']}) "
                 f"{n['other_ms']:.4f} ms, sdpa forward "
                 f"{n['library_ms']:.4f} ms ({_sdpa_backend(q, k, v)})")
        # the clusters of two blocks a card holds of each build's kernel,
        # where either build launches it in clusters (-1: not in clusters)
        for name, fn in (("flash_fwd", "flash_fwd_clusters"),
                         ("flash_bwd_dq", "flash_bwd_dq_clusters"),
                         ("flash_bwd_dkv", "flash_bwd_dkv_clusters")):
            lib = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
            counts = {which: getattr(libs[which][lib], fn)(d)
                      for which in libs}
            if name not in out[d] or max(counts.values()) < 0:
                continue
            n = out[d][name]
            n.update({f"{which}_clusters": k for which, k in counts.items()})
            _log(f"{name} d{d}: clusters of two a card holds: shipped "
                 f"({n['shipped_kernel']}) {n['shipped_clusters']}, other "
                 f"({n['other_kernel']}) {n['other_clusters']}")
        # K2 + K3: what SDPA's one backward call computes
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=10,
            queue_ahead=True)
        pair = {which: sum(out[d][name][f"{which}_ms"]
                           for name in ("flash_bwd_dq", "flash_bwd_dkv"))
                for which in ("shipped", "other")}
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            out[d][name].update(shipped_pair_ms=pair["shipped"],
                                other_pair_ms=pair["other"],
                                library_ms=lib_ms)
        pair_kernels = {which: " + ".join(
            kernels[d][which][name]
            for name in ("flash_bwd_dq", "flash_bwd_dkv"))
            for which in ("shipped", "other")}
        _log(f"time d{d} designs K2 + K3 {shape}, in turns: shipped "
             f"({pair_kernels['shipped']}) {pair['shipped']:.4f} ms, other "
             f"({pair_kernels['other']}) {pair['other']:.4f} ms, sdpa "
             f"backward {lib_ms:.4f} ms ({_sdpa_backend(q, k, v)})")
        del q, k, v, do, o, lse, delta, sq, sk, sv, so, calls
        torch.cuda.empty_cache()
    # K1 at d 256's per-length prefill
    h, hkv, d = WIDE_HEADS["bench_800m_d256"]
    q, k, v = (t.transpose(1, 2)
               for t in _qkv(BATCH, PROMPT, h, hkv, d, dtype, gen))
    out[d]["flash_fwd"]["prefill"] = _in_turns(
        libs, named[d], k1(q, k, v),
        f"b{BATCH} s{PROMPT} h{h} hkv{hkv} d{d} bf16 causal")["flash_fwd"]
    del q, k, v
    torch.cuda.empty_cache()
    # K1's other design at d 192 and 256 at WIDE_EDGES, at d 64 at
    # D64_EDGES and at d 384 and 512 at its pair edges (phase 3 holds the
    # shipped one there)
    k1_edges = [(b, s, h, hkv, d, causal)
                for h, hkv, d in (WIDE_HEADS["bench_800m_d192"],
                                  WIDE_HEADS["bench_800m_d256"])
                for b, s, causal in WIDE_EDGES]
    k1_edges += [(b, s, h, hkv, 64, causal)
                 for b, s, h, hkv, causal in D64_EDGES]
    k1_edges += [(b, s, h, hkv, d, causal) for d in PAIR_DIMS
                 for b, s, h, hkv, causal in PAIR_EDGE_SETS["flash_fwd"]]
    try:
        _build._libs.update(libs["other"])
        for b, s, h, hkv, d, causal in k1_edges:
            q, k, v = (t.transpose(1, 2)
                       for t in _qkv(b, s, h, hkv, d, dtype, gen))
            (o, lse), (wo, wl) = (fa.flash_fwd(q, k, v, causal),
                                  fa.flash_fwd_reference(q, k, v, causal))
            torch.cuda.synchronize()
            name = (f"d{d} {kernels[d]['other']['flash_fwd']} (the design "
                    f"not shipped) b{b} s{s} h{h} hkv{hkv} causal {causal}")
            err = _check(name, o, wo, *TOL[dtype])
            lerr = _check(name + " lse", lse, wl, LSE_ATOL, 0.0)
            _log(f"kernel {name}: max abs err {err:.3e}, lse {lerr:.3e}")
            out[d]["flash_fwd"]["other_max_abs_err"] = max(
                out[d]["flash_fwd"]["other_max_abs_err"], err)
        # K2's and K3's other design at d 64 at D64_EDGES, K2's at d 192
        # at WIDE_EDGES, and each one's at its pair dims (K2 at d 384 and
        # 512, K3 at d 320 to 512) at its pair edges (phase 3 holds the
        # shipped ones there), each twice on one input
        h, hkv, _ = WIDE_HEADS["bench_800m_d192"]
        bwd_edges = [(b, s, h, hkv, 192, causal, ("flash_bwd_dq",))
                     for b, s, causal in WIDE_EDGES]
        bwd_edges += [(b, s, h, hkv, 64, causal,
                       ("flash_bwd_dq", "flash_bwd_dkv"))
                      for b, s, h, hkv, causal in D64_EDGES]
        bwd_edges += [(b, s, h, hkv, d, causal, (name,))
                      for name, dims in (("flash_bwd_dq", PAIR_DIMS),
                                         ("flash_bwd_dkv", DKV_PAIR_DIMS))
                      for d in dims
                      for b, s, h, hkv, causal in PAIR_EDGE_SETS[name]]
        for b, s, h, hkv, d, causal, names in bwd_edges:
            q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen,
                                              causal)
            delta = fa.flash_bwd_delta(o, do)
            calls = bwd(q, k, v, do, lse, delta, causal)
            for name in names:
                kern, plain, tols = calls[name]
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                label = (f"d{d} {kernels[d]['other'][name]} (the design not "
                         f"shipped) b{b} s{s} h{h} hkv{hkv} causal {causal}")
                err = max(_check(f"{label} {name}", g, w, *tol)
                          for g, w, tol in zip(got, want, tols))
                if not all(map(torch.equal, got, again)):
                    raise AssertionError(f"{label}: {name} is not "
                                         "deterministic")
                _log(f"kernel {label}: {name} max abs err {err:.3e}, twice "
                     "bitwise equal")
                out[d][name]["other_max_abs_err"] = max(
                    out[d][name]["other_max_abs_err"], err)
                del got, again, want
            del q, k, v, do, o, lse, delta, calls
    finally:
        _build._libs.update(libs["shipped"])
    out.update(_streamed_k3_designs(libs, bwd, gen))
    return out


def _streamed_k3_designs(libs, bwd, gen) -> dict:
    """The bf16 K3 above d 512 in both designs (``flash_wide_design``): a
    key tile on a cluster of ceil(d / 256) blocks (dkv_wide) and the column
    groups (dkv_wide_groups). At each streamed dim (the training shape,
    each dim's heads; the port runs the groups at d 576 and 640, where the
    cluster lost) the other build's held against the plain version (twice,
    bitwise), both timed in turns, beside SDPA's backward, with the
    clusters a card holds; the other build's also at WIDE_EDGES at d 768's
    heads, twice bitwise. ``bwd`` builds phase_wide_designs' K2 and K3
    calls. Returns {head dim: {"flash_bwd_dkv": numbers}}."""
    from service_account_auth_improvements_tpu_torch.ops import _build
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype, name = torch.bfloat16, "flash_bwd_dkv"
    heads = {d: (h, hkv) for h, hkv, d in _kernel_heads().values()}
    out = {}
    for d in sorted(_streamed_dims()):
        (h, hkv), b, s = heads[d], TRAIN_BATCH, TRAIN_SEQ
        q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
        delta = fa.flash_bwd_delta(o, do)
        calls = {name: bwd(q, k, v, do, lse, delta)[name]}
        wide = {which: wide_designs(libs[which][WIDE_SOURCE], d)[name]
                for which in libs}
        named = {which: {name: wide[which]["design"]} for which in libs}
        shape = f"b{b} s{s} h{h} hkv{hkv} d{d} bf16 causal"
        n = _in_turns(libs, named, calls, shape)[name]
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
        n.update(library_ms=_time_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=5,
            queue_ahead=True), library_backend=_sdpa_backend(q, k, v),
            **{f"{which}_{key}": wide[which][key] for which in libs
               for key in ("kernel", "clusters")})
        out[d] = {name: n}
        _log(f"time d{d} designs K3 {shape}, in turns: shipped "
             f"({n['shipped_kernel']}, clusters a card "
             f"{n['shipped_clusters']}) {n['shipped_ms']:.4f} ms, other "
             f"({n['other_kernel']}) {n['other_ms']:.4f} ms, sdpa backward "
             f"(dQ, dK and dV) {n['library_ms']:.4f} ms "
             f"({n['library_backend']})")
        del q, k, v, do, o, lse, delta, sq, sk, sv, so, calls
        torch.cuda.empty_cache()
    # the other build's K3 at WIDE_EDGES (phase 3 holds the shipped one)
    h, hkv, d = WIDE_HEADS["bench_800m_d768"]
    n = out[d][name]
    try:
        _build._libs.update(libs["other"])
        for b, s, causal in WIDE_EDGES:
            q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen,
                                              causal)
            delta = fa.flash_bwd_delta(o, do)
            kern, plain, tols = bwd(q, k, v, do, lse, delta, causal)[name]
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            label = (f"d{d} {n['other_kernel']} (the design not shipped) "
                     f"b{b} s{s} h{h} hkv{hkv} causal {causal}")
            err = max(_check(f"{label} {name}", g, w, *tol)
                      for g, w, tol in zip(got, want, tols))
            if not all(map(torch.equal, got, again)):
                raise AssertionError(f"{label}: {name} is not deterministic")
            _log(f"kernel {label}: {name} max abs err {err:.3e}, twice "
                 "bitwise equal")
            n["other_max_abs_err"] = max(n["other_max_abs_err"], err)
            del q, k, v, do, o, lse, delta, got, again, want
    finally:
        _build._libs.update(libs["shipped"])
    return out


def wide_designs(lib, d: int) -> dict:
    """The bf16 K1, K2 and K3 this flash_wide library runs at head dim
    ``d``: {kernel: {"design": its WIDE_DESIGNS name, "kernel":
    ``<template><<W>>``, "clusters": the clusters a card holds (-1: not a
    cluster kernel)}}, by ``flash_wide_design`` and
    ``flash_wide_clusters``."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    out = {}
    for i, name in enumerate(KERNELS):
        design = lib.flash_wide_design(i, d)
        kernels = (WIDE_KERNELS if design == WIDE_CLUSTER_DESIGN
                   or name not in WIDE_GROUPS else WIDE_GROUPS)
        out[name] = {"design": WIDE_DESIGNS[design],
                     "kernel": f"{kernels[name]}<{fa.WIDE_COLUMNS[name]}>",
                     "clusters": lib.flash_wide_clusters(i, d)}
    return out


def _design_libs() -> dict:
    """Both builds of every kernel source: {"shipped": the port's,
    "other": phase 2's -DFLASH_OTHER_DESIGNS=1 build}, {source: library}
    each."""
    import ctypes

    from service_account_auth_improvements_tpu_torch.ops import _build

    sources = (*KERNEL_SOURCES, WIDE_SOURCE)
    return {"shipped": {n: _build.load(n) for n in sources},
            "other": {n: ctypes.CDLL(str(OTHER_DESIGNS_DIR / f"lib{n}.so"))
                      for n in sources}}


def phase_f32_designs() -> dict:
    """K1, K2 and K3 in f32 have two designs at d 128: the register-tiled
    kernels (flash_fwd_f32, dq_f32, dkv_f32) and the scalar ones
    (flash_fwd_f32_scalar, dq_f32_scalar, dkv_f32_scalar: a thread forms
    whole length-D dots from shared memory, loads synchronous). The port
    ships the one ``flash_fwd_f32_design`` and ``flash_bwd_f32_design``
    name; the other build runs the other. At the first F32_IN_TURNS shapes
    of F32_SHAPES the other design is held against the plain versions (K2
    and K3 also launched twice on one input, bitwise), then both are timed
    in turns (shipped, other, other, shipped), K1 beside SDPA's f32
    forward and K2 + K3 as a pair beside SDPA's f32 backward. Above d 512
    K1, K2 and K3 have two designs too (``flash_wide_f32_design``): a row
    tile on a cluster of ceil(d / 256) blocks (flash_fwd_wide_f32,
    dq_wide_f32, dkv_wide_f32) and the column groups (WIDE_F32_GROUPS); at
    F32_CLUSTER_DIMS (b 2 s 1000, each dim's heads) the same, K1 beside
    SDPA's f32 forward and the pair beside its f32 backward, with the
    clusters a card holds. Returns
    {shape label: {kernel: numbers}}, the streamed dims' under
    ``"streamed"`` as {head dim: {kernel: numbers}}."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(6)
    libs = _design_libs()
    named = {which: f32_design_names(libs[which]["flash_fwd"],
                                     libs[which]["flash_bwd"],
                                     F32_DESIGN_DIM)
             for which in libs}
    bwd = ("flash_bwd_dq", "flash_bwd_dkv")
    out = {}
    for label, (b, s, h, hkv, d) in list(F32_SHAPES.items())[:F32_IN_TURNS]:
        q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
        delta = fa.flash_bwd_delta(o, do)
        calls = {
            "flash_fwd": (
                lambda: fa.flash_fwd(q, k, v, True),
                lambda: fa.flash_fwd_reference(q, k, v, True),
                [TOL[dtype], (LSE_ATOL, 0.0)]),
            "flash_bwd_dq": (
                lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, True),),
                lambda: (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                   True),),
                [BWD_TOL[dtype]]),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   True),
                [BWD_TOL[dtype]] * 2),
        }
        shape = f"b{b} s{s} h{h} hkv{hkv} d{d} f32 causal"
        out[label] = _in_turns(libs, named, calls, shape)
        backend = _sdpa_backend(q, k, v)
        fwd_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
            q, k, v, is_causal=True, enable_gqa=True), iters=5,
            queue_ahead=True)
        out[label]["flash_fwd"]["library_ms"] = fwd_ms
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=5,
            queue_ahead=True)
        pair = {which: sum(out[label][name][f"{which}_ms"] for name in bwd)
                for which in ("shipped", "other")}
        for name in bwd:
            out[label][name].update(shipped_pair_ms=pair["shipped"],
                                    other_pair_ms=pair["other"],
                                    library_ms=lib_ms)
        k1 = out[label]["flash_fwd"]
        _log(f"time f32 designs K1 {shape}, in turns: shipped "
             f"({named['shipped']['flash_fwd']}) {k1['shipped_ms']:.4f} ms, "
             f"other ({named['other']['flash_fwd']}) {k1['other_ms']:.4f} "
             f"ms, sdpa forward {fwd_ms:.4f} ms ({backend})")
        _log(f"time f32 designs K2 + K3 {shape}, in turns: shipped "
             f"({named['shipped']['flash_bwd_dq']}) {pair['shipped']:.4f} "
             f"ms, other ({named['other']['flash_bwd_dq']}) "
             f"{pair['other']:.4f} ms, sdpa backward {lib_ms:.4f} ms "
             f"({backend})")
        del q, k, v, do, o, lse, delta, sq, sk, sv, so, calls
        torch.cuda.empty_cache()
    # the streamed K1, K2 and K3: a cluster against the column groups
    out["streamed"] = {}
    heads = {d: (h, hkv) for h, hkv, d in _kernel_heads().values()}
    for d in F32_CLUSTER_DIMS:
        (h, hkv), b, s = heads[d], 2, PROMPT
        q, k, v, do, o, lse = _bwd_inputs(b, s, h, hkv, d, dtype, gen, True)
        delta = fa.flash_bwd_delta(o, do)
        calls = {
            "flash_fwd": (
                lambda: fa.flash_fwd(q, k, v, True),
                lambda: fa.flash_fwd_reference(q, k, v, True),
                [TOL[dtype], (LSE_ATOL, 0.0)]),
            "flash_bwd_dq": (
                lambda: (fa.flash_bwd_dq(q, k, v, do, lse, delta, True),),
                lambda: (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                   True),),
                [BWD_TOL[dtype]]),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   True),
                [BWD_TOL[dtype]] * 2),
        }
        shape = f"b{b} s{s} h{h} hkv{hkv} d{d} f32 causal"
        wide = {which: wide_f32_designs(libs[which][WIDE_SOURCE], d)
                for which in libs}
        named = {which: {name: n["design"] for name, n in wide[which].items()}
                 for which in libs}
        n_out = out["streamed"][d] = _in_turns(libs, named, calls, shape)
        fwd_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
            q, k, v, is_causal=True, enable_gqa=True), iters=5,
            queue_ahead=True)
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=5,
            queue_ahead=True)
        pair = {which: sum(n_out[name][f"{which}_ms"] for name in bwd)
                for which in ("shipped", "other")}
        backend = _sdpa_backend(q, k, v)
        for name in calls:
            n_out[name].update(library_backend=backend,
                               **{f"{which}_{key}": wide[which][name][key]
                                  for which in libs
                                  for key in ("kernel", "clusters")})
        n_out["flash_fwd"]["library_ms"] = fwd_ms
        for name in bwd:
            n_out[name].update(shipped_pair_ms=pair["shipped"],
                               other_pair_ms=pair["other"],
                               library_ms=lib_ms)
        k1 = n_out["flash_fwd"]
        _log(f"time f32 designs K1 {shape}, in turns: shipped "
             f"({k1['shipped_kernel']}, clusters a card "
             f"{k1['shipped_clusters']}) {k1['shipped_ms']:.4f} ms, other "
             f"({k1['other_kernel']}) {k1['other_ms']:.4f} ms, sdpa forward "
             f"{fwd_ms:.4f} ms ({backend})")
        _log(f"time f32 designs K2 + K3 {shape}, in turns: shipped "
             f"({wide['shipped']['flash_bwd_dq']['kernel']} + "
             f"{wide['shipped']['flash_bwd_dkv']['kernel']}, clusters a "
             f"card {wide['shipped']['flash_bwd_dq']['clusters']} and "
             f"{wide['shipped']['flash_bwd_dkv']['clusters']}) "
             f"{pair['shipped']:.4f} ms, other "
             f"({wide['other']['flash_bwd_dq']['kernel']} + "
             f"{wide['other']['flash_bwd_dkv']['kernel']}) "
             f"{pair['other']:.4f} ms, sdpa backward {lib_ms:.4f} ms "
             f"({backend})")
        del q, k, v, do, o, lse, delta, sq, sk, sv, so, calls
        torch.cuda.empty_cache()
    return out


def wide_f32_designs(lib, d: int) -> dict:
    """The f32 K1, K2 and K3 this flash_wide library runs at head dim
    ``d``: {kernel: {"design": its F32_DESIGNS name, "kernel":
    ``<template><<W>>``, "clusters": the clusters a card holds (-1: not a
    cluster kernel)}}, by ``flash_wide_f32_design`` and
    ``flash_wide_f32_clusters``."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    out = {}
    for i, name in enumerate(KERNELS):
        design = lib.flash_wide_f32_design(i, d)
        kernels = (WIDE_F32_KERNELS if design == F32_CLUSTER_DESIGN
                   else WIDE_F32_GROUPS)
        out[name] = {"design": F32_DESIGNS[design],
                     "kernel": f"{kernels[name]}<{fa.WIDE_COLUMNS[name]}>",
                     "clusters": lib.flash_wide_f32_clusters(i, d)}
    return out


def f32_design_names(fwd, bwd, d: int) -> dict:
    """The f32 design K1 of this flash_fwd library and K2 and K3 of this
    flash_bwd library run at head dim ``d``, by name (the F32Design ids of
    ``flash_fwd_f32_design`` and ``flash_bwd_f32_design``)."""
    name = F32_DESIGNS[bwd.flash_bwd_f32_design(d)]
    return {"flash_fwd": F32_DESIGNS[fwd.flash_fwd_f32_design(d)],
            "flash_bwd_dq": name, "flash_bwd_dkv": name}


def _in_turns(libs, named, calls, shape: str) -> dict:
    """Each kernel of ``calls`` ({name: (kernel call, plain call,
    [(atol, rtol)] per output)}, each call returning a tuple) through the
    other design's library against its plain version (K2 and K3 also
    twice, bitwise), then timed in turns through the shipped and the other
    library: {name: {"other_max_abs_err", "shipped_design", "shipped_ms",
    "other_design", "other_ms", "shape"}}."""
    from service_account_auth_improvements_tpu_torch.ops import _build

    out = {}
    try:
        _build._libs.update(libs["other"])
        for name, (kern, plain, tols) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max(_check(f"{shape} {named['other'][name]} {name}", g, w,
                             *tol) for g, w, tol in zip(got, want, tols))
            if name != "flash_fwd":
                again = kern()
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, again)):
                    raise AssertionError(f"{shape} {named['other'][name]} "
                                         f"{name} is not deterministic")
                del again
            _log(f"kernel {shape} {named['other'][name]} (the design not "
                 f"shipped) {name}: max abs err {err:.3e} (tolerances "
                 f"{tols})")
            out[name] = dict(other_max_abs_err=err, shape=shape)
            del got, want
        times = {name: {"shipped": [], "other": []} for name in calls}
        for which in ("shipped", "other", "other", "shipped"):
            _build._libs.update(libs[which])
            for name, (kern, _, _) in calls.items():
                times[name][which].append(_time_ms(kern, queue_ahead=True))
    finally:
        _build._libs.update(libs["shipped"])
    for name, t in times.items():
        shipped_ms, other_ms = (sum(t[w]) / len(t[w])
                                for w in ("shipped", "other"))
        out[name].update(shipped_design=named["shipped"][name],
                         shipped_ms=shipped_ms,
                         other_design=named["other"][name],
                         other_ms=other_ms)
        _log(f"time designs {name} {shape}, in turns: shipped "
             f"({named['shipped'][name]}) {shipped_ms:.4f} ms "
             f"{[round(x, 4) for x in t['shipped']]}, other "
             f"({named['other'][name]}) {other_ms:.4f} ms "
             f"{[round(x, 4) for x in t['other']]}")
    return out


def design_kernels(fwd, bwd, d: int) -> dict:
    """The kernel each of K1 (of this flash_fwd library), K2 and K3 (of
    this flash_bwd library) runs at head dim ``d``, as
    ``<template><<d>>``: DESIGN_KERNELS by the libraries' design ids."""
    ids = {"flash_fwd": fwd.flash_fwd_design(d),
           "flash_bwd_dq": bwd.flash_bwd_dq_design(d),
           "flash_bwd_dkv": bwd.flash_bwd_dkv_design(d)}
    return {name: f"{DESIGN_KERNELS[name][i]}<{d}>"
            for name, i in ids.items()}


def design_names(fwd, bwd, d: int) -> dict:
    """The design each kernel of these two libraries (flash_fwd,
    flash_bwd) runs at head dim ``d``, by name: K1's by the FwdDesign id of
    ``flash_fwd_design``, K2's and K3's by the BwdDesign id of
    ``flash_bwd_dq_design`` and ``flash_bwd_dkv_design``."""
    return {"flash_fwd": FWD_DESIGNS[fwd.flash_fwd_design(d)],
            "flash_bwd_dq": BWD_DESIGNS[bwd.flash_bwd_dq_design(d)],
            "flash_bwd_dkv": BWD_DESIGNS[bwd.flash_bwd_dkv_design(d)]}


def _http(base: str, path: str, body: dict | None = None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data)
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return r.read()


def _served(svc):
    """``svc`` behind ``make_server`` on 127.0.0.1: (base URL, stop)."""
    import threading

    from service_account_auth_improvements_tpu_torch.models import serving

    httpd = serving.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return "http://%s:%d" % httpd.server_address, stop


def _assert_completion(name, out, vocab):
    rows = out["completion_ids"]
    if len(rows) != BATCH or any(len(r) != NEW for r in rows):
        raise AssertionError(f"{name}: expected {BATCH} rows of {NEW} ids, "
                             f"got {[len(r) for r in rows]}")
    if not all(0 <= t < vocab for r in rows for t in r):
        raise AssertionError(f"{name}: ids outside the vocabulary")
    if out["usage"] != {"prompt_tokens": BATCH * PROMPT,
                        "completion_tokens": BATCH * NEW}:
        raise AssertionError(f"{name}: usage {out['usage']}")


def phase_serving() -> dict:
    """The port's main path: GenerationService at bench_800m (bf16
    weights from a seed, per-length prefill) behind make_server. Returns
    the kernel launch counts of exactly that run."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(llama.PRESETS[PRESET], param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    _log(f"serving: {PRESET} ({cfg.param_count() / 1e6:.1f}M params, "
         f"bf16) initialised in {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    prompts = prompts.tolist()
    svc = serving.GenerationService(cfg, params, prefill_window=0,
                                    device="cuda", name=PRESET)
    base, stop = _served(svc)
    greedy = {"prompt_ids": prompts, "max_new_tokens": NEW}
    sampled = dict(greedy, temperature=0.8, top_k=40, top_p=0.95, seed=1234)
    timings = {}
    fa.launches = 0  # the main path's run starts here
    try:
        for name, body in (("greedy", greedy), ("greedy again", greedy),
                           ("sampled", sampled)):
            t0 = time.perf_counter()
            out = json.loads(_http(base, "/v1/completions", body))
            timings[name] = time.perf_counter() - t0
            _assert_completion(name, out, cfg.vocab_size)
            _log(f"serving {name}: {timings[name] * 1e3:.1f} ms for "
                 f"{BATCH} x ({PROMPT} + {NEW}) tokens; row 0 starts "
                 f"{out['completion_ids'][0][:8]}")
            if name == "greedy":
                first = out
            elif name == "greedy again" and out != first:
                raise AssertionError("repeated greedy request differs")
        t0 = time.perf_counter()
        raw = _http(base, "/v1/completions", dict(greedy, stream=True))
        timings["stream"] = time.perf_counter() - t0
        events = [e[6:] for e in raw.decode().split("\n\n") if e]
        if events[-1] != "[DONE]" or any('"error"' in e for e in events):
            raise AssertionError(f"stream ended badly: {events[-2:]}")
        streamed = [[] for _ in range(BATCH)]
        for e in events[:-1]:
            for row, ids in zip(streamed, json.loads(e)["ids"]):
                row.extend(ids)
        if streamed != first["completion_ids"]:
            raise AssertionError("streamed greedy ids differ from one-shot")
        _log(f"serving stream: {len(events) - 1} events, "
             f"{timings['stream'] * 1e3:.1f} ms")
        if json.loads(_http(base, "/healthz")) != {"ok": True}:
            raise AssertionError("/healthz")
        metrics = _http(base, "/metrics").decode()
        for want in ('serving_requests_total{mode="oneshot",code="200"} 3.0',
                     'serving_requests_total{mode="stream",code="200"} 1.0',
                     f"serving_completion_tokens_total {4 * BATCH * NEW}.0"):
            if want not in metrics:
                raise AssertionError(f"/metrics lacks {want!r}")
    finally:
        launches = {"flash_fwd": fa.launches}  # read just after the run
        stop()
    prefills = 4  # one per-length prefill per completion request
    if launches["flash_fwd"] != cfg.n_layers * prefills:
        raise AssertionError(
            f"flash_fwd launched {launches['flash_fwd']} times; expected "
            f"{cfg.n_layers} layers x {prefills} prefills")
    _log(f"serving: flash_fwd launches {launches['flash_fwd']} = "
         f"{cfg.n_layers} layers x {prefills} prefills")

    # outside the counted run: the first greedy token against the model's
    # own forward, and flash attention against dense attention
    toks = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits = llama.apply(cfg, params, toks)
        want_first = logits[:, -1].argmax(-1).tolist()
        if want_first != [r[0] for r in first["completion_ids"]]:
            raise AssertionError("first greedy token differs from "
                                 "argmax of llama.apply")
        short = toks[:2, :256]
        flash = llama.apply(cfg, params, short)
        dense = llama.apply(dataclasses.replace(cfg, attn_impl="dense"),
                            params, short)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        flash32 = llama.apply(cfg32, params, short)
        dense32 = llama.apply(dataclasses.replace(cfg32, attn_impl="dense"),
                              params, short)
    for name, (f, d), atol in (("bf16", (flash, dense), APPLY_ATOL["bf16"]),
                               ("f32", (flash32, dense32),
                                APPLY_ATOL["f32"])):
        err = (f - d).abs()
        agree = (f.argmax(-1) == d.argmax(-1)).float().mean().item()
        _log(f"apply flash vs dense (b 2, s 256, {name}): max abs err "
             f"{err.max().item():.4e}, mean {err.mean().item():.4e}, logit "
             f"std {d.std().item():.4f}, argmax agreement {agree:.4f}")
        if not torch.isfinite(f).all() or err.max().item() > atol:
            raise AssertionError(f"{name} flash vs dense logits differ by "
                                 f"{err.max().item():.4e} > {atol}")

    # where a request's time goes: one per-length prefill (flash, and
    # dense for comparison) and one decode step, on the card's clock
    with torch.inference_mode():
        for impl in ("flash", "dense"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            ms = _time_ms(lambda: generate.prefill(
                c, params, toks, PROMPT + NEW, device="cuda"), iters=3,
                warmup=1)
            _log(f"time prefill {impl} b{BATCH} s{PROMPT}: {ms:.2f} ms")
        cache, _ = generate.prefill(cfg, params, toks, PROMPT + NEW,
                                    device="cuda")
        cos, sin = generate._rope(cfg, PROMPT + NEW, toks.device)
        token = toks[:, -1]
        ms = _time_ms(lambda: generate._decode_step(
            cfg, params, cache._replace(length=PROMPT), token, cos, sin),
            iters=10, warmup=2)
        _log(f"time decode step b{BATCH} cache {PROMPT + NEW}: {ms:.2f} ms")
        _profile_request(cfg, params, toks, generate)
    return launches


def _profile_request(cfg, params, toks, generate) -> None:
    """One greedy request's work (per-length prefill + NEW - 1 decode
    steps) under torch.profiler: the card's busy time by kernel, and its
    idle share of the wall time (the profiler's own overhead included).
    It records the card's kernels only: an eager MoE request runs about
    a million host ops, whose post-processing alone would take minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate.generate(cfg, params, toks, NEW,
                          device=toks.device.type)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        _log("profile: the profiler saw no device time (not measured)")
        return
    _log(f"profile greedy b{BATCH} {PROMPT}+{NEW}: wall {wall_ms:.1f} ms, "
         f"device busy {busy_ms:.1f} ms, idle share "
         f"{1 - busy_ms / wall_ms:.3f}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
             f"{e.key[:90]}")


def phase_training() -> dict:
    """The port's training path: ``make_train_step`` at ``bench_800m``,
    batch 8, seq 2048, f32 master params, bf16 compute, remat "full",
    ``loss_chunk`` 512, flash attention, on one fixed batch. Returns the
    kernel launch counts of exactly the counted run, and its numbers."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )
    from service_account_auth_improvements_tpu_torch.train.mfu import (
        chip_peak_flops,
        mfu,
    )

    cfg = llama.PRESETS[PRESET]
    if not (cfg.remat and cfg.remat_policy == "full" and cfg.loss_chunk
            and cfg.attn_impl == "flash" and cfg.param_dtype == "float32"):
        raise AssertionError(f"{PRESET} is not the training configuration")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    state = step_mod.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    step = step_mod.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2), device="cuda")
    mask = torch.ones_like(tokens)
    torch.cuda.synchronize()
    _log(f"training: {PRESET} ({cfg.param_count() / 1e6:.1f}M params, "
         f"f32 master, bf16 compute), batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    losses, norms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # counted run
    for i in range(TRAIN_STEPS):
        if i == 1:  # the first step is the warm-up
            start.record()
        state, m = step(state, tokens, mask)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    end.record()
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}  # read just after
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
    peak_mem = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 2 * L * TRAIN_STEPS,
            "flash_bwd_dq": L * TRAIN_STEPS,
            "flash_bwd_dkv": L * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want} (per step: K1 2x{L}, K2 and K3 {L})")
    _log(f"training: launches {launches} = per step K1 {2 * L} "
         f"(forward + recompute), K2 {L}, K3 {L}, over {TRAIN_STEPS} steps")
    _log(f"training: losses {[round(x, 4) for x in losses]}, grad norms "
         f"{[round(x, 4) for x in norms]}")
    if not all(map(torch.isfinite, map(torch.tensor, losses + norms))):
        raise AssertionError("non-finite loss or grad norm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on the repeated batch: "
                             f"{losses}")
    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ - 1)
    tok_s = tokens_per_step / (step_ms / 1e3)
    peak = chip_peak_flops()
    util = mfu(cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step,
                       step_ms / 1e3, 1, peak)
    _log(f"training: step {step_ms:.2f} ms (CUDA events, mean of "
         f"{TRAIN_STEPS - 1} steps after one warm-up), {tok_s:.1f} tokens/s, "
         f"mfu {util:.4f} (peak {peak / 1e12:.0f} TF/s bf16), peak memory "
         f"{peak_mem / 2**30:.2f} GiB")

    _profile_step(step, state, tokens, mask)
    parts = _time_step_parts(cfg, state, tokens, step_mod)
    for name, ms in parts.items():
        _log(f"training part {name}: {ms:.2f} ms ({ms / step_ms:.3f} of "
             f"the step)")
    del state, step, m
    torch.cuda.empty_cache()
    _grads_flash_vs_dense(cfg, step_mod)
    return dict(launches=launches, step_ms=step_ms, tokens_per_sec=tok_s,
                mfu=util, peak_mem=peak_mem)


def _profile_step(step, state, tokens, mask) -> None:
    """One train step under torch.profiler: the card's busy time by
    kernel and its idle share of the step's wall time (the profiler's
    own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        _log("profile: the profiler saw no device time (not measured)")
        return
    _log(f"profile train step: wall {wall_ms:.1f} ms, device busy "
         f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for key, label in PROFILE_KERNELS.items():
        ms = sum(e.self_device_time_total for e in kernels
                 if key in e.key) / 1e3
        _log(f"  {label}: {ms:.2f} ms of device time "
             f"({ms / busy_ms:.3f} of busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
             f"{e.key[:90]}")


def _time_step_parts(cfg, state, tokens, step_mod) -> dict:
    """The step's parts that are no kernel of the port, on the card's
    clock: the chunked lm_head loss (f32 logits from bf16 operands,
    forward, chunk recompute and backward) and the AdamW update (on zero
    gradients: the same work)."""
    from service_account_auth_improvements_tpu_torch.models import llama

    cdt = llama.dtype_of(cfg.dtype)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ - 1, cfg.dim), device="cuda",
                    dtype=cdt, requires_grad=True)
    head = state.params["lm_head"].detach().requires_grad_(True)
    targets = tokens[:, 1:]

    def lm_head_loss():
        nll = llama._chunked_nll(cfg, x, head.to(cdt), targets)
        torch.autograd.grad(nll.mean(), (x, head))

    zeros = step_mod._map(torch.zeros_like, state.params)
    opt = step_mod.make_optimizer()
    return {"lm_head loss fwd+bwd": _time_ms(lm_head_loss, iters=3,
                                             warmup=1),
            "adamw update": _time_ms(
                lambda: opt.apply(zeros, state.opt_state, state.params),
                iters=3, warmup=1)}


def _grads_flash_vs_dense(cfg, step_mod) -> None:
    """Outside the counted run: one step's loss and gradients with flash
    against dense attention at full width (all layers), b 2, s 512, in
    f32 and bf16 compute, from one init; the f32 launches counted under
    F32_PATHS, above the per-dim bound (the streamed f32 kernels) under
    F32_WIDE_PATHS."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama

    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    paths = F32_WIDE_PATHS if cfg.head_dim > PER_DIM_MAX else F32_PATHS
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        out = {}
        for impl in ("flash", "dense"):
            c = dataclasses.replace(cfg, dtype=dtype, attn_impl=impl)
            leaves = dict(step_mod._leaves(params))
            req = {k: v.detach().requires_grad_(True)
                   for k, v in leaves.items()}
            loss = llama.next_token_loss(c, step_mod._rebuild(params, req),
                                         tokens)
            if name == "f32" and impl == "flash":
                grads = _f32_counted(
                    f"flash vs dense grads d{cfg.head_dim}",
                    lambda: torch.autograd.grad(loss, list(req.values())),
                    paths)
            else:
                grads = torch.autograd.grad(loss, list(req.values()))
            out[impl] = (float(loss.detach()), dict(zip(req, grads)))
        (lf, gf), (ld, gd) = out["flash"], out["dense"]
        nf = float(step_mod.global_norm(gf))
        nd = float(step_mod.global_norm(gd))
        leaf = max(float((gf[k] - gd[k]).abs().max()
                         / gd[k].abs().max().clamp_min(1e-30)) for k in gd)
        tol = GRAD_TOL[name]
        _log(f"train grads flash vs dense (b 2, s 512, {name}): loss "
             f"{lf:.6f} vs {ld:.6f}, grad norm {nf:.6f} vs {nd:.6f}, largest "
             f"per-leaf grad difference {leaf:.3e} of the leaf's max "
             f"(tolerances {tol})")
        if not (abs(lf - ld) <= tol["loss"]
                and abs(nf - nd) <= tol["gnorm"] * nd
                and leaf <= tol["leaf"] and all(
                    torch.isfinite(g).all() for g in gf.values())):
            raise AssertionError(f"{name}: flash and dense train grads "
                                 "differ beyond the tolerances")
        del out, gf, gd
    del params
    torch.cuda.empty_cache()


def _counts(fa) -> dict:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches}


def _zero(fa) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


@contextlib.contextmanager
def _k1_by_head_dim(fa, by_dim: dict):
    """Inside: K1's launches (``fa.launches``, which its wrapper counts
    where it launches the kernel) also added up by head dim into
    ``by_dim`` ({d: launches}), for a path that runs K1 at two head
    dims: each forward's count, read around it."""
    forward = fa._forward

    def counted(q, k, v, causal):
        before = fa.launches
        out = forward(q, k, v, causal)
        d = q.shape[3]
        by_dim[d] = by_dim.get(d, 0) + fa.launches - before
        return out

    fa._forward = counted
    try:
        yield by_dim
    finally:
        fa._forward = forward


class _FitLog:
    """``fit``'s ``log``: echoes each line with the kernel launches since
    the line before it, so that each step and each eval is counted on its
    own (a step's line follows its step; an eval's line its eval)."""

    def __init__(self, fa):
        self.fa, self.lines = fa, []
        self.last = tuple(_counts(fa).values())

    def __call__(self, line: str) -> None:
        now = tuple(_counts(self.fa).values())
        delta = tuple(a - b for a, b in zip(now, self.last))
        self.last = now
        self.lines.append((line, delta))
        _log(f"  fit: {line} [since the line before: K1 {delta[0]}, K2 "
             f"{delta[1]}, K3 {delta[2]}]")


def _disk(path: Path) -> str:
    return f"{shutil.disk_usage(path).free / 1e9:.1f} GB free"


def phase_lifecycle() -> dict:
    """The notebook lifecycle at PRESET: train, checkpoint, resume,
    evaluate, serve the checkpoint (bf16, int8, speculative), and the two
    CLIs. Returns the kernel launches of each counted path."""
    try:
        WORKDIR.parent.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(WORKDIR, ignore_errors=True)
        launches, params = _timed("lifecycle train, resume, eval",
                                  _lifecycle_train)
        launches["serving checkpoint"] = _timed(
            "lifecycle serve checkpoint", _serve_checkpoint, params)
        _timed("lifecycle int8", _int8, params)
        launches["speculative"] = _timed("lifecycle speculative",
                                         _speculative, params)
        del params
        shutil.rmtree(WORKDIR, ignore_errors=True)
        torch.cuda.empty_cache()
        launches["train.loop CLI"] = _timed("lifecycle entry points",
                                            _entry_points)
        return launches
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
        shutil.rmtree(CLI_WORKDIR, ignore_errors=True)


def _lifecycle_train():
    """Run A (LIFECYCLE_STEPS straight) against run B (RESUME_AT steps into
    WORKDIR, then a fresh fit resuming to LIFECYCLE_STEPS) with evaluation
    every RESUME_AT steps: launches per step and per eval, bit-equal
    state, the eval records, checkpoint bytes and times. Returns the
    launches of the counted run and B's final params."""
    import numpy as np

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        evaluate,
        loop,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )

    cfg = llama.PRESETS[PRESET]
    L = cfg.n_layers
    rng = np.random.default_rng(5)
    corpus = rng.integers(0, cfg.vocab_size, TRAIN_BATCH * TRAIN_SEQ
                          * (LIFECYCLE_STEPS + 1), dtype=np.int32)
    held_out = [torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device=DEV) for _ in range(EVAL_BATCHES)]
    data_cfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    _log(f"lifecycle: {PRESET} b{TRAIN_BATCH} s{TRAIN_SEQ}; run A "
         f"{LIFECYCLE_STEPS} steps straight, run B {RESUME_AT} steps into "
         f"{WORKDIR.relative_to(ROOT)} and a resumed fit to "
         f"{LIFECYCLE_STEPS}, eval every {RESUME_AT} steps on "
         f"{EVAL_BATCHES} held-out batches; {_disk(WORKDIR.parent)}")

    def fit(steps, log, **kw):
        eval_data = held_out if kw.get("eval_every") else None
        return loop.fit(cfg, None, corpus, data_cfg,
                        loop.LoopConfig(steps=steps, log_every=1, **kw),
                        log=log, eval_data=eval_data, device=DEV)

    _zero(fa)  # the counted run starts here
    log = _FitLog(fa)
    t0 = time.perf_counter()
    state_a, _ = fit(LIFECYCLE_STEPS, log)
    b_kw = dict(workdir=str(WORKDIR), ckpt_every=RESUME_AT,
                eval_every=RESUME_AT)
    _, hist_b1 = fit(RESUME_AT, log, **b_kw)
    free_between = _disk(WORKDIR)
    state_b, hist_b2 = fit(LIFECYCLE_STEPS, log, **b_kw)
    torch.cuda.synchronize()
    launches = {"lifecycle training": _counts(fa)}  # read just after
    _log(f"lifecycle: runs A and B in {time.perf_counter() - t0:.1f} s")

    steps = evals = 0
    for line, delta in log.lines:
        if " eval loss=" in line:
            want, evals = (L * EVAL_BATCHES, 0, 0), evals + 1
        elif line.startswith("step "):
            want, steps = (2 * L, L, L), steps + 1
        else:  # resumed / saved
            want = (0, 0, 0)
        if delta != want:
            raise AssertionError(f"{line!r}: launches {delta}, expected "
                                 f"{want}")
    n_evals = LIFECYCLE_STEPS // RESUME_AT
    if (steps, evals) != (2 * LIFECYCLE_STEPS, n_evals):
        raise AssertionError(f"{steps} step and {evals} eval lines")
    if not any(line.startswith(f"resumed from step {RESUME_AT}")
               for line, _ in log.lines):
        raise AssertionError("run B did not log its resume")
    _log(f"lifecycle: launches exactly K1 {2 * L}, K2 {L}, K3 {L} in each "
         f"of {steps} steps (before and after the resume) and K1 "
         f"{L * EVAL_BATCHES}, K2 0, K3 0 in each of {evals} evals "
         f"({L} per eval batch)")

    if (state_b.step, state_b.opt_state.count) != (
            state_a.step, state_a.opt_state.count):
        raise AssertionError("run B ended at another step or count")
    worst, unequal = 0.0, []
    for what in ("params", "mu", "nu"):
        trees = [s.params if what == "params" else
                 getattr(s.opt_state, what) for s in (state_a, state_b)]
        for (name, a), (_, b) in zip(step._leaves(trees[0]),
                                     step._leaves(trees[1])):
            worst = max(worst, (a.float() - b.float()).abs().max().item())
            if not torch.equal(a, b):
                unequal.append(f"{what}/{name}")
    _log(f"lifecycle: resumed against uninterrupted after "
         f"{LIFECYCLE_STEPS} steps: largest difference {worst:.3e} over "
         f"params, mu and nu; "
         + ("bitwise equal" if not unequal else
            f"{len(unequal)} leaves differ: {unequal[:6]}"))
    if unequal:
        raise AssertionError("resumed training is not bit-equal to "
                             "uninterrupted training")

    records = [r for r in hist_b1 + hist_b2 if "eval_loss" in r]
    tokens = EVAL_BATCHES * TRAIN_BATCH * (TRAIN_SEQ - 1)
    if ([r["step"] for r in records] != list(
            range(RESUME_AT, LIFECYCLE_STEPS + 1, RESUME_AT))
            or any(r["eval_tokens"] != tokens for r in records)):
        raise AssertionError(f"eval records {records}")
    t0 = time.perf_counter()
    ev = evaluate.evaluate(cfg, state_a.params, held_out, device=DEV)
    eval_ms = (time.perf_counter() - t0) * 1e3 / EVAL_BATCHES
    _log(f"lifecycle: eval records {records}; evaluate of run A's final "
         f"params: loss {ev['loss']:.6f}, perplexity "
         f"{ev['perplexity']:.2f}, {ev['tokens']} tokens; "
         f"{eval_ms:.2f} ms per eval batch (host clock, one sync)")
    if round(ev["loss"], 4) != records[-1]["eval_loss"]:
        raise AssertionError("evaluate of A's params differs from B's "
                             "last eval record")

    step_dir = WORKDIR / str(checkpoint.latest_step(WORKDIR))
    sizes = {f.name: f.stat().st_size for f in step_dir.iterdir()}
    n_params = cfg.param_count()
    on_disk = sorted(p.name for p in WORKDIR.iterdir())
    _log(f"lifecycle: checkpoint {step_dir.name}: {sum(sizes.values())} "
         f"bytes on disk ({sizes}; {n_params} params x 12 bytes = "
         f"{n_params * 12}); steps on disk {on_disk}; {free_between} "
         f"after the first save, {_disk(WORKDIR)} now")
    params = state_b.params
    del state_a, state_b
    torch.cuda.empty_cache()
    return launches, params


def _serve_checkpoint(trained) -> dict:
    """restore_params of WORKDIR (opt.pt hidden first) behind make_server:
    the greedy and sampled requests of the serving phase, against direct
    ``generate`` from the same params. Returns the requests' launches."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        step,
    )

    cfg = dataclasses.replace(llama.PRESETS[PRESET], param_dtype="bfloat16")
    step_dir = WORKDIR / str(checkpoint.latest_step(WORKDIR))
    (step_dir / "opt.pt").rename(step_dir / "opt.pt.hidden")
    t0 = time.perf_counter()
    params = checkpoint.restore_params(WORKDIR, None, cfg, device=DEV)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        step._leaves(params), step._leaves(trained)))
    _log(f"serve checkpoint: restore_params of step {step_dir.name} in "
         f"{restore_s:.2f} s with opt.pt renamed away (never opened); "
         f"dtype {params['lm_head'].dtype}; equal to the trained params: "
         f"{same}")
    if not same:
        raise AssertionError("restore_params differs from the saved params")

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    greedy = {"prompt_ids": prompts.tolist(), "max_new_tokens": NEW}
    # top_k 40 runs as the service's pow-2 bucket, 64
    sampled = dict(greedy, temperature=0.8, top_k=40, top_p=0.95, seed=1234)
    svc = serving.GenerationService(cfg, params, prefill_window=0,
                                    device=DEV, name=PRESET)
    base, stop = _served(svc)
    got = {}
    _zero(fa)  # the counted run starts here
    try:
        for name, body in (("greedy", greedy), ("sampled", sampled)):
            t0 = time.perf_counter()
            got[name] = json.loads(_http(base, "/v1/completions", body))
            _assert_completion(name, got[name], cfg.vocab_size)
            _log(f"serve checkpoint {name}: "
                 f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    finally:
        launches = _counts(fa)  # read just after the run
        stop()
    if launches != {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise AssertionError(f"serve checkpoint launches {launches}, "
                             f"expected K1 {cfg.n_layers} per request")
    toks = prompts.to(DEV)
    for name, kw in (("greedy", {}), ("sampled", dict(
            generator=torch.Generator(device=DEV).manual_seed(1234),
            temperature=0.8, top_k=64, top_p=0.95))):
        want = generate.generate(cfg, params, toks, NEW, device=DEV, **kw)
        if want[:, PROMPT:].tolist() != got[name]["completion_ids"]:
            raise AssertionError(f"served {name} completions differ from "
                                 "direct generate")
    _log(f"serve checkpoint: launches {launches} (K1 {cfg.n_layers} per "
         f"request); greedy and sampled completions equal direct "
         f"generate.generate from the restored params")
    return launches


def _int8(params) -> None:
    """quantize_params of the restored params: bytes, the error bound on
    every quantized leaf, one greedy request, logits against bf16 weights,
    and prefill and decode times."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        quantize,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.train import step

    cfg = dataclasses.replace(llama.PRESETS[PRESET], param_dtype="bfloat16")
    bf16 = step._map(lambda t: t.to(torch.bfloat16), params)
    t0 = time.perf_counter()
    q = quantize.quantize_params(params)
    torch.cuda.synchronize()
    _log(f"int8: quantize_params in {time.perf_counter() - t0:.2f} s; "
         f"{quantize.quantized_bytes(q)} bytes against "
         f"{quantize.quantized_bytes(bf16)} in bf16 and "
         f"{quantize.quantized_bytes(params)} in f32")
    worst = 0.0
    leaves = [("lm_head", params["lm_head"], q["lm_head"])] + [
        (f"layers/{k}", params["layers"][k], q["layers"][k])
        for k in sorted(q["layers"]) if k in quantize._QUANT_KEYS]
    for name, w, qa in leaves:
        if not isinstance(qa, quantize.QuantizedTensor):
            raise AssertionError(f"{name} is not quantized")
        err = (w.float() - qa.to(torch.float32)).abs()
        scale = qa.scale.unsqueeze(-2)
        if not torch.all(err <= scale / 2 + 1e-7):
            raise AssertionError(f"{name}: |w - dequant(w)| > scale/2")
        worst = max(worst, (err / scale).max().item())
        del err
    _log(f"int8: |w - dequant(w)| <= scale/2 on all {len(leaves)} "
         f"quantized leaves (largest |w - dequant(w)| / scale "
         f"{worst:.4f}); tok_embed and norms kept in "
         f"{q['tok_embed'].dtype}")

    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    toks = prompts.to(DEV)
    svc = serving.GenerationService(cfg, q, prefill_window=0, device=DEV)
    t0 = time.perf_counter()
    out = svc.complete({"prompt_ids": prompts.tolist(),
                        "max_new_tokens": NEW})
    ms = (time.perf_counter() - t0) * 1e3
    _assert_completion("int8 greedy", out, cfg.vocab_size)
    with torch.inference_mode():
        want = generate.generate(cfg, bf16, toks, NEW, device=DEV)
        agree = (torch.tensor(out["completion_ids"], device=DEV)
                 == want[:, PROMPT:]).float().mean().item()
        _, lq = generate.prefill(cfg, q, toks, PROMPT + NEW, device=DEV)
        _, lb = generate.prefill(cfg, bf16, toks, PROMPT + NEW, device=DEV)
        rel = ((lq - lb).abs().max() / lb.abs().max().clamp_min(1.0)).item()
        top1 = (llama.apply(cfg, q, toks).argmax(-1)
                == llama.apply(cfg, bf16, toks).argmax(-1)).float().mean()
    _log(f"int8 greedy request: {ms:.1f} ms; completion tokens equal to "
         f"bf16 weights' {agree:.4f}; last prefill logits max |int8 - "
         f"bf16| {(lq - lb).abs().max().item():.4e} = {rel:.4f} of the "
         f"largest bf16 logit (tolerance {INT8_REL_TOL}); top-1 agreement "
         f"over all {BATCH * PROMPT} prompt positions "
         f"{top1.item():.4f}")
    if not torch.isfinite(lq).all() or rel >= INT8_REL_TOL:
        raise AssertionError(f"int8 logits {rel:.4f} of the largest bf16 "
                             f"logit off (tolerance {INT8_REL_TOL})")
    with torch.inference_mode():
        for name, p in (("bf16", bf16), ("int8", q)):
            prefill_ms = _time_ms(lambda: generate.prefill(
                cfg, p, toks, PROMPT + NEW, device=DEV), iters=3, warmup=1)
            cache, _ = generate.prefill(cfg, p, toks, PROMPT + NEW,
                                        device=DEV)
            cos, sin = generate._rope(cfg, PROMPT + NEW, toks.device)
            decode_ms = _time_ms(lambda: generate._decode_step(
                cfg, p, cache._replace(length=PROMPT), toks[:, -1], cos,
                sin), iters=10, warmup=2)
            _log(f"time {name} weights: prefill b{BATCH} s{PROMPT} "
                 f"{prefill_ms:.2f} ms, decode step b{BATCH} cache "
                 f"{PROMPT + NEW} {decode_ms:.2f} ms")
            del cache
    del bf16, q
    torch.cuda.empty_cache()


def _speculative(params) -> dict:
    """f32: greedy spec_generate with a DRAFT draft and with the target as
    its own draft against plain greedy generate; bf16: single-prompt
    greedy requests over HTTP, plain, DRAFT-drafted and self-drafted.
    Returns the launches of the bf16 requests."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
        speculative,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(llama.PRESETS[PRESET], param_dtype="bfloat16")
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(7))
    toks = prompt.to(DEV)

    # f32 compute (K1 runs its f32 kernel in the prefills)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    d32 = dataclasses.replace(llama.PRESETS[DRAFT], dtype="float32")
    dparams = llama.init(d32, torch.Generator(device=DEV).manual_seed(1),
                         device=DEV)
    want = generate.generate(cfg32, params, toks, NEW, device=DEV)
    for name, dcfg, dp in ((DRAFT, d32, dparams),
                           ("self-draft", cfg32, params)):
        t0 = time.perf_counter()
        got, stats = speculative.spec_generate(cfg32, params, dcfg, dp, toks,
                                               NEW, gamma=GAMMA, device=DEV)
        ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(got, want)
        _log(f"speculative f32 {name}: token-identical to plain greedy: "
             f"{same}; {stats}; {ms:.1f} ms")
        if not same:
            first = int((got != want).nonzero()[0, 1]) - PROMPT
            raise AssertionError(f"f32 speculative ({name}) differs from "
                                 f"plain greedy at new token {first}")
        if name == "self-draft" and stats["acceptance_rate"] != 1.0:
            raise AssertionError("self-draft did not accept every proposal")
    del dparams, want
    torch.cuda.empty_cache()

    # bf16, through the service over HTTP
    dcfg = dataclasses.replace(llama.PRESETS[DRAFT], param_dtype="bfloat16")
    dparams = llama.init(dcfg, torch.Generator(device=DEV).manual_seed(1),
                         device=DEV)
    body = {"prompt_ids": prompt.tolist(), "max_new_tokens": NEW}
    L = cfg.n_layers
    plain_ids = plain_ms = None
    total = dict.fromkeys(_counts(fa), 0)
    for name, draft, k1 in (
            ("plain", None, L),
            (f"{DRAFT} draft (random weights)", (dcfg, dparams),
             L + dcfg.n_layers),
            ("self-draft", (cfg, params), 2 * L)):
        svc = serving.GenerationService(cfg, params, prefill_window=0,
                                        draft=draft, gamma=GAMMA,
                                        device=DEV)
        base, stop = _served(svc)
        _zero(fa)  # this request's counted run
        try:
            t0 = time.perf_counter()
            out = json.loads(_http(base, "/v1/completions", body))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            counts = _counts(fa)  # read just after
            stop()
        total = {k: total[k] + counts[k] for k in total}
        ids = out["completion_ids"][0]
        if len(ids) != NEW or counts != {"flash_fwd": k1, "flash_bwd_dq": 0,
                                         "flash_bwd_dkv": 0}:
            raise AssertionError(f"{name}: {len(ids)} ids, launches "
                                 f"{counts}, expected K1 {k1}")
        stats = out.get("speculative")
        if draft is None:
            plain_ids, plain_ms = ids, ms
            _log(f"speculative bf16 plain greedy request: {ms:.1f} ms for "
                 f"1 x ({PROMPT} + {NEW}); K1 {k1}; target forwards per "
                 f"token 1.000 (prefill + {NEW - 1} decode steps)")
            continue
        if stats is None:
            raise AssertionError(f"{name}: no speculative stats")
        forwards = (1 + stats["proposed"] // GAMMA) / NEW
        agree = sum(a == b for a, b in zip(ids, plain_ids)) / NEW
        _log(f"speculative bf16 {name}: {ms:.1f} ms ({ms / plain_ms:.2f}x "
             f"plain); acceptance {stats['acceptance_rate']:.4f} "
             f"({stats['accepted']} of {stats['proposed']}); target "
             f"forwards per token {forwards:.3f} (prefill + verify "
             f"rounds); tokens equal to plain greedy {agree:.4f}; K1 {k1} "
             f"({L} target + {k1 - L} draft prefill)")
    del dparams
    torch.cuda.empty_cache()
    return total


def _entry_points() -> dict:
    """The entry points a user runs: ``train.loop``'s CLI twice on one
    ``--workdir`` (the second run resumes), then the serving CLI on that
    checkpoint with ``--int8`` and a draft as a subprocess, answering one
    single-prompt greedy request. Returns the CLI runs' launches."""
    import contextlib
    import io
    import socket

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import loop

    cfg = llama.PRESETS[PRESET]
    shutil.rmtree(CLI_WORKDIR, ignore_errors=True)
    argv = ["--preset", PRESET, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--log-every", "1", "--device", DEV,
            "--workdir", str(CLI_WORKDIR)]
    _zero(fa)  # the counted run starts here
    histories, outs = [], []
    for steps in (2, 3):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            histories.append(loop.main(argv + ["--steps", str(steps)]))
        outs.append(buf.getvalue())
        for line in outs[-1].splitlines():
            _log(f"  train.loop --steps {steps}: {line}")
    launches = _counts(fa)  # read just after
    L, n = cfg.n_layers, 3  # 3 steps over both calls
    if launches != {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n,
                    "flash_bwd_dkv": L * n}:
        raise AssertionError(f"train.loop CLI launches {launches}")
    if "resumed from step 2" not in outs[1]:
        raise AssertionError("the second train.loop run did not resume")
    if [len(h) for h in histories] != [2, 1] or not all(
            r["tokens_per_sec"] > 0 and 0 < r.get("mfu", 0) < 1
            for h in histories for r in h):
        raise AssertionError(f"train.loop histories lack tokens/s or mfu: "
                             f"{histories}")
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", f"{PKG}.models.serving", "--preset", PRESET,
           "--checkpoint-dir", str(CLI_WORKDIR), "--int8", "--draft-preset",
           DRAFT, "--prefill-window", "0", "--host", "127.0.0.1", "--port",
           str(port), "--device", DEV]
    log_path = CLI_WORKDIR / "serving.log"
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the serving CLI exited with "
                                     f"{proc.returncode}")
            try:
                _http(base, "/healthz")
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("the serving CLI did not come up")
                time.sleep(1)
        up_s = time.perf_counter() - t0
        prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                               generator=torch.Generator().manual_seed(7))
        t0 = time.perf_counter()
        out = json.loads(_http(base, "/v1/completions", {
            "prompt_ids": prompt.tolist(), "max_new_tokens": NEW}))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        for line in log_path.read_text().splitlines():
            _log(f"  serving CLI: {line}")
    if len(out["completion_ids"][0]) != NEW or "speculative" not in out:
        raise AssertionError(f"serving CLI reply {out}")
    _log(f"serving CLI (--checkpoint-dir --int8 --draft-preset {DRAFT} "
         f"--prefill-window 0): up in {up_s:.1f} s, one greedy request "
         f"{ms:.1f} ms, speculative {out['speculative']}; stopped")
    shutil.rmtree(CLI_WORKDIR, ignore_errors=True)
    return launches


def phase_moe() -> dict:
    """The mixture-of-experts path at MOE_PRESET: training (top-1 and
    top-2), one step twice from one state, flash against dense, serving.
    Returns the kernel launches of each counted path."""
    import dataclasses
    import gc

    from service_account_auth_improvements_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()  # the lifecycle's tensors are gone
    cfg = llama.PRESETS[MOE_PRESET]
    if not (cfg.moe_experts and cfg.moe_top_k == 1 and cfg.remat
            and cfg.remat_policy == "full" and cfg.loss_chunk
            and cfg.attn_impl == "flash" and cfg.param_dtype == "float32"):
        raise AssertionError(f"{MOE_PRESET} is not the MoE configuration")
    launches = {"moe_training": _timed("moe training", _moe_training, cfg)}
    top2 = dataclasses.replace(cfg, moe_top_k=2)
    launches["moe_training_top2"] = _timed(
        "moe training top-2", lambda: _moe_train(top2, MOE_TOP2_STEPS,
                                                 "top-2")[0])
    _timed("moe flash vs dense", _moe_flash_vs_dense, cfg)
    launches["moe_serving"] = _timed("moe serving", _moe_serving, cfg)
    return launches


def _moe_train(cfg, steps, name):
    """``steps`` train steps of ``cfg`` at batch TRAIN_BATCH x TRAIN_SEQ
    on one fixed batch, the first a warm-up outside the clock. Each
    step's aux loss is read from the step's own MoE layers (their aux,
    detached, recorded as they run: no forward of its own; the first L
    calls of a step are its forward, any after them the remat
    recompute). Checks the launches of every step, a falling finite loss
    and a finite aux.
    Returns (launches of the run, step ms, state, step, tokens, mask)."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )
    from service_account_auth_improvements_tpu_torch.train.mfu import (
        chip_peak_flops,
        mfu,
    )

    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    state = step_mod.init_train_state(
        cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    step = step_mod.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=torch.Generator(device=DEV)
                           .manual_seed(2), device=DEV)
    mask = torch.ones_like(tokens)
    g = min(cfg.moe_group_size, TRAIN_SEQ)
    torch.cuda.synchronize()
    _log(f"moe {name}: {MOE_PRESET} ({cfg.param_count() / 1e6:.1f}M params, "
         f"{cfg.active_matmul_param_count() / 1e6:.1f}M matmul-active, "
         f"{cfg.moe_experts} experts, top-{cfg.moe_top_k}), batch "
         f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_BATCH * TRAIN_SEQ // g} "
         f"routing groups of {g}, capacity {cfg.moe_cap(g)}")
    events, metrics, per_step, layer_aux, firsts = [], [], [], [], []
    host = []  # host seconds to issue each step (the step does not sync)
    moe_ffn = llama._moe_ffn

    def recording(*args, **kwargs):
        out, aux = moe_ffn(*args, **kwargs)
        layer_aux.append(aux.detach())
        return out, aux

    llama._moe_ffn = recording
    try:
        _zero(fa)  # the counted run starts here
        for _ in range(steps):
            firsts.append(len(layer_aux))
            before = tuple(_counts(fa).values())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            state, m = step(state, tokens, mask)
            host.append(time.perf_counter() - t0)
            end.record()
            per_step.append(tuple(a - b for a, b in
                                  zip(_counts(fa).values(), before)))
            events.append((start, end))
            metrics.append(m)
        torch.cuda.synchronize()
        launches = _counts(fa)  # read just after the run
    finally:
        llama._moe_ffn = moe_ffn
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    want = (2 * L, L, L)
    if any(d != want for d in per_step):
        raise AssertionError(f"moe {name} launches per step {per_step}, "
                             f"expected K1 {2 * L}, K2 {L}, K3 {L}")
    if launches != {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                    "flash_bwd_dkv": L * steps}:
        raise AssertionError(f"moe {name} launches {launches}")
    auxes = [float(torch.stack(layer_aux[i:i + L]).sum()) for i in firsts]
    step_ms = sum(s.elapsed_time(e) for s, e in events[1:]) / (steps - 1)
    host_ms = sum(host[1:]) / (steps - 1) * 1e3
    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ - 1)
    tok_s = tokens_per_step / (step_ms / 1e3)
    flops = cfg.flops_per_token(TRAIN_SEQ)
    util = mfu(flops * tokens_per_step, step_ms / 1e3, 1, chip_peak_flops())
    _log(f"moe {name}: launches {launches} = per step exactly K1 {2 * L} "
         f"(forward + recompute), K2 {L}, K3 {L} in each of {steps} steps")
    _log(f"moe {name}: losses {[round(x, 4) for x in losses]}, grad norms "
         f"{[round(x, 4) for x in norms]}, aux of each step per layer "
         f"{[round(x / L, 4) for x in auxes]} (the sum over {L} layers / "
         f"{L}; 1 = balanced)")
    if not all(map(torch.isfinite, map(torch.tensor,
                                       losses + norms + auxes))):
        raise AssertionError(f"moe {name}: non-finite loss, norm or aux")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe {name}: loss did not fall: {losses}")
    _log(f"moe {name}: step {step_ms:.2f} ms (CUDA events, mean of "
         f"{steps - 1} steps after one warm-up), {tok_s:.1f} tokens/s, mfu "
         f"{util:.4f} ({flops / 1e9:.4f} GFLOP/token, "
         f"{flops * tokens_per_step / 1e12:.2f} TFLOP/step), peak memory "
         f"{peak_mem / 2**30:.2f} GiB; the host issued a step in "
         f"{host_ms:.2f} ms (host clock, the same steps)")
    return launches, step_ms, state, step, tokens, mask


def _moe_training(cfg) -> dict:
    """MOE_PRESET's counted training run (TRAIN_STEPS steps), a grouped
    profile of one step, and one step twice from one copied state."""
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    launches, step_ms, state, step, tokens, mask = _moe_train(
        cfg, TRAIN_STEPS, "top-1")
    _profile_moe_step(cfg, step, state, tokens, mask, step_ms)
    copy = step_mod.TrainState(
        state.step, step_mod._map(torch.clone, state.params),
        step_mod.AdamState(state.opt_state.count,
                           step_mod._map(torch.clone, state.opt_state.mu),
                           step_mod._map(torch.clone, state.opt_state.nu)))
    a, _ = step(state, tokens, mask)
    b, _ = step(copy, tokens, mask)
    torch.cuda.synchronize()
    unequal = [f"{what}/{n}" for what, x, y in (
        ("params", a.params, b.params),
        ("mu", a.opt_state.mu, b.opt_state.mu),
        ("nu", a.opt_state.nu, b.opt_state.nu))
        for (n, p), (_, q) in zip(step_mod._leaves(x), step_mod._leaves(y))
        if not torch.equal(p, q)]
    _log("moe top-1: one step twice from one copied state: "
         + ("params, mu and nu bitwise equal" if not unequal else
            f"{len(unequal)} leaves differ: {unequal[:6]}"))
    if unequal:
        raise AssertionError("a MoE step is not deterministic (routing "
                             "recomputed under remat, or the products)")
    del state, copy, a, b, step
    torch.cuda.empty_cache()
    return launches


def _profile_moe_step(cfg, step, state, tokens, mask, step_ms) -> None:
    """One MoE train step under torch.profiler (with input shapes): the
    card's busy time grouped by the aten op that launched each kernel,
    into routing (MOE_ROUTING_OPS, and the one-hot products over every
    token of every group), dispatch and combine (products batched over
    the G routing groups), expert products (batched over the E experts),
    the port's kernels (by kernel name), and the rest; and the idle
    share of the step's wall time (the profiler's overhead included) and
    of ``step_ms``, the step's time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = min(cfg.moe_group_size, TRAIN_SEQ)
    G = TRAIN_BATCH * TRAIN_SEQ // g
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step(state, tokens, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        _log("profile: the profiler saw no device time (not measured)")
        return
    groups = dict.fromkeys(("routing: softmax, sort, cumsum, one-hots",
                            "dispatch + combine products",
                            "expert products", "K1/K2/K3"), 0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        ms = e.self_device_time_total / 1e3
        if e.device_type != DeviceType.CPU or not ms:
            continue
        batch = (e.input_shapes[0][0] if e.key == "aten::bmm"
                 and e.input_shapes and e.input_shapes[0] else None)
        if batch == cfg.moe_experts:
            groups["expert products"] += ms
        elif batch == G:
            groups["dispatch + combine products"] += ms
        elif batch == G * g or e.key in MOE_ROUTING_OPS:
            groups["routing: softmax, sort, cumsum, one-hots"] += ms
    groups["K1/K2/K3"] = sum(e.self_device_time_total for e in kernels
                             if any(k in e.key for k in PROFILE_KERNELS)
                             ) / 1e3
    groups["the rest (lm_head, attention projections, norms, AdamW, "
           "elementwise)"] = busy_ms - sum(groups.values())
    _log(f"profile moe train step: wall {wall_ms:.1f} ms, device busy "
         f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f} (the "
         f"profiler's input shapes included; against the unprofiled "
         f"{step_ms:.2f} ms step {1 - busy_ms / step_ms:.3f})")
    for label, ms in groups.items():
        _log(f"  {label}: {ms:.2f} ms ({ms / busy_ms:.3f} of busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
             f"{e.key[:90]}")


def _moe_flash_vs_dense(cfg) -> None:
    """Outside the counted runs: MOE_PRESET at full width (all layers), b
    2, s 512, f32, flash against dense attention from one init: the share
    of top-k routing choices that agree (each layer's choices recorded
    in a forward), then the loss and gradients of one step."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    params = llama.init(cfg, torch.Generator(device=DEV).manual_seed(3),
                        device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device=DEV,
                           generator=torch.Generator(device=DEV)
                           .manual_seed(4))
    moe_ffn = llama._moe_ffn
    out = {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, dtype="float32", attn_impl=impl)
        choices = []

        def recording(cfg_, h, lp, token_mask=None, **kw):
            probs = torch.softmax(h.float() @ lp["router"].float(), dim=-1)
            choices.append(torch.sort(probs, dim=-1, descending=True,
                                      stable=True).indices[..., :cfg_
                                                           .moe_top_k])
            return moe_ffn(cfg_, h, lp, token_mask, **kw)

        llama._moe_ffn = recording
        try:
            with torch.inference_mode():
                llama._backbone(c, params, tokens)
        finally:
            llama._moe_ffn = moe_ffn
        leaves = dict(step_mod._leaves(params))
        req = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss = llama.next_token_loss(c, step_mod._rebuild(params, req),
                                     tokens)
        grads = _f32_counted(
            "moe flash vs dense grads",
            lambda: torch.autograd.grad(loss, list(req.values()))) \
            if impl == "flash" else torch.autograd.grad(
                loss, list(req.values()))
        out[impl] = (torch.stack(choices), float(loss.detach()),
                     dict(zip(req, grads)))
    (rf, lf, gf), (rd, ld, gd) = out["flash"], out["dense"]
    agree = (rf == rd).float().mean().item()
    nf = float(step_mod.global_norm(gf))
    nd = float(step_mod.global_norm(gd))
    leaf = max(float((gf[k] - gd[k]).abs().max()
                     / gd[k].abs().max().clamp_min(1e-30)) for k in gd)
    tol = GRAD_TOL["f32" if agree == 1.0 else "bf16"]
    _log(f"moe flash vs dense ({MOE_PRESET}, b 2, s 512, f32): routing "
         f"choices agree {agree:.6f} of {rf.numel()} (required >= "
         f"{MOE_ROUTING_AGREE}); loss {lf:.6f} vs {ld:.6f}, grad norm "
         f"{nf:.6f} vs {nd:.6f}, largest per-leaf grad difference "
         f"{leaf:.3e} of the leaf's max (tolerances {tol})")
    if agree < MOE_ROUTING_AGREE:
        raise AssertionError(f"moe flash vs dense routing agreement "
                             f"{agree:.6f} < {MOE_ROUTING_AGREE}")
    if not (abs(lf - ld) <= tol["loss"] and abs(nf - nd) <= tol["gnorm"] * nd
            and leaf <= tol["leaf"]
            and all(torch.isfinite(g).all() for g in gf.values())):
        raise AssertionError("moe flash and dense train grads differ "
                             "beyond the tolerances")
    del out, gf, gd, params
    torch.cuda.empty_cache()


def _moe_serving(cfg) -> dict:
    """GenerationService at MOE_PRESET (bf16 weights from a seed) behind
    make_server: a greedy BATCH x (PROMPT + NEW) request with per-length
    prefill (K1 once per layer, counted) and one with the server's
    default windowed prefill (no K1); prefill and decode-step times and
    the idle share of one request. Returns the requests' launches."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = llama.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    body = {"prompt_ids": prompts.tolist(), "max_new_tokens": NEW}
    icfg = generate._inference_cfg(cfg)
    slots = BATCH * cfg.moe_experts * icfg.moe_cap(PROMPT)
    claims = BATCH * PROMPT * cfg.moe_top_k
    _log(f"moe serving: {MOE_PRESET} bf16, dropless routing: a per-length "
         f"prefill of {BATCH} x {PROMPT} routes {BATCH} groups of "
         f"{PROMPT} at capacity {icfg.moe_cap(PROMPT)}, so the expert "
         f"products run {slots} slots for {claims} claims "
         f"({slots / claims:.0f}x)")
    k1 = {}
    _zero(fa)  # the counted run starts here
    for name, kw in (("per-length prefill (--prefill-window 0)",
                      dict(prefill_window=0)),
                     (f"windowed prefill (default "
                      f"{serving.DEFAULT_PREFILL_WINDOW})", {})):
        svc = serving.GenerationService(cfg, params, device=DEV,
                                        name=MOE_PRESET, **kw)
        base, stop = _served(svc)
        before = fa.launches
        try:
            t0 = time.perf_counter()
            out = json.loads(_http(base, "/v1/completions", body))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            k1[name] = fa.launches - before
            stop()
        _assert_completion(f"moe {name}", out, cfg.vocab_size)
        _log(f"moe serving {name}: {ms:.1f} ms for {BATCH} x ({PROMPT} + "
             f"{NEW}) tokens; K1 {k1[name]}; row 0 starts "
             f"{out['completion_ids'][0][:8]}")
    launches = _counts(fa)  # read just after the run
    if list(k1.values()) != [cfg.n_layers, 0] or launches["flash_bwd_dq"] \
            or launches["flash_bwd_dkv"]:
        raise AssertionError(f"moe serving launches {k1} {launches}, "
                             f"expected K1 {cfg.n_layers} per per-length "
                             "prefill and none windowed")
    toks = prompts.to(DEV)
    with torch.inference_mode():
        for name, fn in (
                ("per-length", lambda: generate.prefill(
                    cfg, params, toks, PROMPT + NEW, device=DEV)),
                (f"windowed {serving.DEFAULT_PREFILL_WINDOW}",
                 lambda: generate.prefill_chunked(
                     cfg, params, toks, PROMPT + NEW,
                     window=serving.DEFAULT_PREFILL_WINDOW,
                     device=DEV))):
            ms = _time_ms(fn, iters=3, warmup=1)
            _log(f"time moe prefill {name} b{BATCH} s{PROMPT}: {ms:.2f} ms")
        cache, _ = generate.prefill(cfg, params, toks, PROMPT + NEW,
                                    device=DEV)
        cos, sin = generate._rope(cfg, PROMPT + NEW, toks.device)
        ms = _time_ms(lambda: generate._decode_step(
            icfg, params, cache._replace(length=PROMPT), toks[:, -1], cos,
            sin), iters=10, warmup=2)
        _log(f"time moe decode step b{BATCH} cache {PROMPT + NEW}: "
             f"{ms:.2f} ms")
        del cache
        _profile_request(cfg, params, toks, generate)
    del params
    torch.cuda.empty_cache()
    return launches


def _bits_checksum(tree) -> dict:
    """Per leaf: the sum of its bit patterns (int64) and of its values
    (f64), over one layer slice at a time (no copy of a whole 8B leaf)."""
    from service_account_auth_improvements_tpu_torch.utils.tree import leaves

    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}
    out = {}
    for name, t in leaves(tree):
        parts = t.unbind(0) if t.dim() > 2 else (t,)
        bits = sum(int(torch.sum(p.view(ints[t.dtype]), dtype=torch.int64))
                   for p in parts)
        vals = sum(float(torch.sum(p, dtype=torch.float64)) for p in parts)
        out[name] = (bits, vals)
    return out


def _draw_hf_state_dict(hf: dict, seed: int) -> dict:
    """An HF Llama state dict for the config ``hf`` (torch Linear [out,
    in] layout, ``model.`` keys) drawn from ``seed`` in bf16 on the card:
    matmul weights N(0, 0.02) (the residual-out projections
    0.02/sqrt(2·layers), as ``llama.init`` draws them), norms 1 + N(0,
    0.02); no ``lm_head.weight`` when the embeddings are tied."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    d, m, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    L, h, kv = (hf["num_hidden_layers"], hf["num_attention_heads"],
                hf["num_key_value_heads"])
    hd = hf.get("head_dim") or d // h
    out_std = 0.02 / (2 * L) ** 0.5

    def w(shape, std=0.02, mean=0.0):
        x = torch.randn(shape, generator=gen, device=DEV)
        return (x * std + mean).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": w((v, d)),
          "model.norm.weight": w((d,), mean=1.0)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w((d,), mean=1.0),
            p + "self_attn.q_proj.weight": w((h * hd, d)),
            p + "self_attn.k_proj.weight": w((kv * hd, d)),
            p + "self_attn.v_proj.weight": w((kv * hd, d)),
            p + "self_attn.o_proj.weight": w((d, h * hd), out_std),
            p + "post_attention_layernorm.weight": w((d,), mean=1.0),
            p + "mlp.gate_proj.weight": w((m, d)),
            p + "mlp.up_proj.weight": w((m, d)),
            p + "mlp.down_proj.weight": w((d, m), out_std),
        })
    if not hf["tie_word_embeddings"]:
        sd["lm_head.weight"] = w((v, d))
    return sd


def _hf_import(name, hf, preset, param_dtype, seed):
    """``config_from_hf`` against the port's preset (every field but
    max_seq_len), ``params_from_hf_state_dict`` of a drawn bf16 state
    dict on the card, and ``to_hf_state_dict`` → ``params_from_...``
    bitwise. Returns (cfg with flash attention and loss_chunk 512, the
    params in ``param_dtype``)."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        convert_hf,
        llama,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import leaves

    cfg = convert_hf.config_from_hf(hf)
    want = dataclasses.asdict(llama.PRESETS[preset])
    diff = {k: (v, want[k]) for k, v in dataclasses.asdict(cfg).items()
            if v != want[k]}
    _log(f"hf import {name}: config_from_hf against the {preset} preset "
         f"differs in {diff} (HF's context length, the preset's 8192)")
    if set(diff) != {"max_seq_len"}:
        raise AssertionError(f"{name}: config differs from {preset}: {diff}")
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype,
                              attn_impl="flash", loss_chunk=512)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = _draw_hf_state_dict(hf, seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = convert_hf.params_from_hf_state_dict(cfg, sd, device=DEV)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_sd = sum(t.numel() * t.element_size() for t in sd.values())
    last = cfg.n_layers - 1
    wq = sd[f"model.layers.{last}.self_attn.q_proj.weight"]
    if not torch.equal(params["layers"]["wq"][last], wq.T.to(params[
            "layers"]["wq"].dtype)):
        raise AssertionError(f"{name}: wq of the last layer is not "
                             "its q_proj.T")
    del sd, wq
    n = sum(t.numel() for _, t in leaves(params))
    if n != cfg.param_count():
        raise AssertionError(f"{name}: {n} params, config says "
                             f"{cfg.param_count()}")
    back = convert_hf.params_from_hf_state_dict(
        cfg, convert_hf.to_hf_state_dict(
            cfg, params, tie_word_embeddings=hf["tie_word_embeddings"]),
        device=DEV)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    unequal = [k for (k, a), (_, b) in zip(leaves(params), leaves(back))
               if a.dtype != b.dtype or not torch.equal(a, b)]
    del back
    torch.cuda.empty_cache()
    _log(f"hf import {name}: state dict drawn ({n_sd} bytes bf16) in "
         f"{t1 - t0:.2f} s, converted to {n} params in {param_dtype} on "
         f"the card in {t2 - t1:.2f} s; to_hf_state_dict -> "
         f"params_from_hf_state_dict in {t3 - t2:.2f} s: "
         + ("every leaf bitwise equal" if not unequal
            else f"leaves differ: {unequal}"))
    if unequal:
        raise AssertionError(f"{name}: the HF round trip is not the "
                             "identity")
    return cfg, params


def phase_finetune() -> dict:
    """Phase 8: Llama-3.1-8B and Llama-3.2-1B from HF-layout state dicts,
    LoRA through ``fit`` at the 8B (resume bitwise), distillation of the
    fine-tuned 8B into the 1B, and the distilled draft serving the 8B
    through ``spec_generate``. Returns the launches of each counted
    path."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' tensors are gone
    try:
        shutil.rmtree(FT_WORKDIR, ignore_errors=True)
        FT_WORKDIR.mkdir(parents=True)
        cfg8, base = _timed("finetune hf import 8B", _hf_import,
                            "Llama-3.1-8B", HF_LLAMA31_8B, "llama3_8b",
                            "bfloat16", 8)
        cfg1, student = _timed("finetune hf import 1B", _hf_import,
                               "Llama-3.2-1B", HF_LLAMA32_1B, "llama3_1b",
                               "float32", 1)
        corpus = np.random.default_rng(11).integers(
            0, cfg8.vocab_size, FT_BATCH * FT_SEQ, dtype=np.int32)
        # FT_BATCH sequences, each window of the corpus one of them
        corpus = np.tile(corpus, LORA_STEPS + 1)
        launches = {}
        launches["lora_8b"], lcfg, adapters = _timed(
            "finetune lora 8B", _lora_fit, cfg8, base, corpus)
        launches["distill_8b_1b"], teacher, dstate, step_ms = _timed(
            "finetune distill 8B -> 1B", _distill, cfg8, base, lcfg,
            adapters, cfg1, student, corpus)
        del base, adapters, student
        launches["speculative_8b_1b"] = _timed(
            "finetune speculative 8B + 1B draft", _serve_draft, cfg8,
            teacher, cfg1, dstate, corpus)
        _timed("finetune distill profile", _distill_profile, cfg1, cfg8,
               dstate, teacher, corpus, step_ms)
        del teacher, dstate
        return launches
    finally:
        shutil.rmtree(FT_WORKDIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _lora_fit(cfg, base, corpus):
    """LoRA (``LoraConfig()``: rank 8 on wq wk wv wo) through ``fit`` at
    FT_BATCH x FT_SEQ: LORA_STEPS straight against RESUME_AT into
    FT_WORKDIR and a resumed fit, with exact launches per step, bitwise
    equal adapters and moments, the base's checksums, the first loss
    against ``next_token_loss`` on the base; then step ms, tokens/s, peak
    memory, a profile and the step's parts. Returns (the counted run's
    launches, the LoRA config, the resumed run's adapters)."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        loop,
        lora,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
        TokenBatches,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import leaves

    L = cfg.n_layers
    lcfg = lora.LoraConfig()
    workdir = FT_WORKDIR / "lora"
    data_cfg = DataConfig(batch=FT_BATCH, seq=FT_SEQ)
    n_adapter = lora.lora_param_count(cfg, lcfg)
    _log(f"lora: Llama-3.1-8B bf16 base ({cfg.param_count() / 1e9:.3f}B "
         f"params), {lcfg} ({n_adapter} adapter params, f32), batch "
         f"{FT_BATCH} x {FT_SEQ}, AdamW lr {LORA_LR} without weight "
         f"decay; run A {LORA_STEPS} steps straight, run B {RESUME_AT} "
         f"into {workdir.relative_to(ROOT)} and a resumed fit to "
         f"{LORA_STEPS}; {_disk(FT_WORKDIR.parent)}")
    sums = _bits_checksum(base)

    def fit(steps, log, **kw):
        return loop.fit(cfg, None, corpus, data_cfg,
                        loop.LoopConfig(steps=steps, log_every=1, **kw),
                        optimizer=step.make_optimizer(
                            learning_rate=LORA_LR, weight_decay=0.0),
                        log=log, lora=lcfg, base_params=base, device=DEV)

    torch.cuda.reset_peak_memory_stats()
    _zero(fa)  # the counted run starts here
    log = _FitLog(fa)
    t0 = time.perf_counter()
    state_a, hist_a = fit(LORA_STEPS, log)
    peak_a = torch.cuda.max_memory_allocated()
    fit(RESUME_AT, log, workdir=str(workdir))
    state_b, hist_b = fit(LORA_STEPS, log, workdir=str(workdir))
    torch.cuda.synchronize()
    launches = _counts(fa)  # read just after
    _log(f"lora: runs A and B in {time.perf_counter() - t0:.1f} s")
    steps = 0
    for line, delta in log.lines:
        want = (2 * L, L, L) if line.startswith("step ") else (0, 0, 0)
        steps += line.startswith("step ")
        if delta != want:
            raise AssertionError(f"lora {line!r}: launches {delta}, "
                                 f"expected {want}")
    if steps != 2 * LORA_STEPS or not any(
            line.startswith(f"resumed from step {RESUME_AT}")
            for line, _ in log.lines):
        raise AssertionError(f"lora: {steps} step lines, or no resume")
    _log(f"lora: launches exactly K1 {2 * L}, K2 {L}, K3 {L} in each of "
         f"{steps} steps (before and after the resume)")
    unequal = [f"{what}/{n}" for what in ("params", "mu", "nu")
               for (n, a), (_, b) in zip(
                   leaves(state_a.params if what == "params"
                          else getattr(state_a.opt_state, what)),
                   leaves(state_b.params if what == "params"
                          else getattr(state_b.opt_state, what)))
               if not torch.equal(a, b)]
    if unequal or (state_a.step, state_a.opt_state.count) != (
            state_b.step, state_b.opt_state.count):
        raise AssertionError(f"lora: resumed adapters differ: {unequal}")
    step_dir = workdir / str(checkpoint.latest_step(workdir))
    sizes = {f.name: f.stat().st_size for f in step_dir.iterdir()}
    _log(f"lora: resumed against uninterrupted after {LORA_STEPS} steps: "
         f"every adapter leaf and Adam moment bitwise equal; checkpoint "
         f"{step_dir.name}: {sum(sizes.values())} bytes ({sizes}; "
         f"{n_adapter} adapter params x 12 bytes = {12 * n_adapter})")
    if _bits_checksum(base) != sums:
        raise AssertionError("lora: the base params changed")
    _log(f"lora: base checksums (bit-pattern and value sums of all "
         f"{len(sums)} leaves) equal before and after both runs")

    losses = [r["loss"] for r in hist_a]
    batch, mask = TokenBatches(corpus, data_cfg, device=DEV).masked_batch_at(0)
    with torch.no_grad():
        base_loss = float(llama.next_token_loss(cfg, base, batch, mask))
    rel = abs(losses[0] - base_loss) / abs(base_loss)
    _log(f"lora: losses {[round(x, 6) for x in losses]} (run B "
         f"{[round(r['loss'], 6) for r in hist_b]}); first step "
         f"{losses[0]!r} against next_token_loss on the base {base_loss!r}"
         f": relative difference {rel:.3e} ("
         + ("bitwise equal" if losses[0] == base_loss else "not bitwise")
         + f", tolerance {LORA_FIRST_LOSS_RTOL})")
    if rel > LORA_FIRST_LOSS_RTOL:
        raise AssertionError("lora: the zero-B merge is not the base")
    if not all(np.isfinite(losses)) or not max(losses[1:]) < losses[0]:
        raise AssertionError(f"lora: losses {losses} not finite and below "
                             "the first after it")

    # timing outside the counted run: one warm-up, then timed steps
    lstep = lora.make_lora_train_step(cfg, lcfg, step.make_optimizer(
        learning_rate=LORA_LR, weight_decay=0.0))
    state = state_a
    state, _ = lstep(state, base, batch, mask)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        state, _ = lstep(state, base, batch, mask)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 2
    tok_s = FT_BATCH * (FT_SEQ - 1) / (step_ms / 1e3)
    _log(f"lora: step {step_ms:.2f} ms (CUDA events, mean of 2 after a "
         f"warm-up), {tok_s:.1f} tokens/s, peak memory of run A "
         f"{peak_a / 2**30:.2f} GiB (base {_tree_bytes(base) / 2**30:.2f} "
         f"GiB)")
    _profile_step(lambda s, t, m: lstep(s, base, t, m), state, batch, mask)
    for part, ms in _time_lora_parts(cfg, lcfg, base, state,
                                     batch).items():
        _log(f"lora part {part}: {ms:.2f} ms ({ms / step_ms:.3f} of the "
             "step)")
    adapters = state_b.params
    del state, state_a, state_b
    torch.cuda.empty_cache()
    return launches, lcfg, adapters


def _tree_bytes(tree) -> int:
    from service_account_auth_improvements_tpu_torch.utils.tree import leaves

    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def _time_lora_parts(cfg, lcfg, base, state, batch) -> dict:
    """The LoRA step's parts that are no kernel of the port, on the
    card's clock: the chunked f32 lm_head loss at vocab 128256 (forward,
    chunk recompute and the backward to x only: the head is frozen), the
    merge of the four targets forward and backward, and AdamW over the
    adapters."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import lora, step
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        rebuild,
        tree_map,
    )

    cdt = llama.dtype_of(cfg.dtype)
    x = torch.randn((FT_BATCH, FT_SEQ - 1, cfg.dim), device=DEV,
                    dtype=cdt, requires_grad=True)
    head = base["lm_head"].to(cdt)

    def lm_head_loss():
        nll = llama._chunked_nll(cfg, x, head, batch[:, 1:])
        torch.autograd.grad(nll.mean(), (x,))

    flat = {n: t.detach().requires_grad_(True)
            for n, t in leaves(state.params)}
    grads_out = [torch.randn_like(base["layers"][t]) for t in lcfg.targets]

    def merge():
        merged = lora.merge_lora(base, rebuild(state.params, flat), lcfg)
        torch.autograd.grad([merged["layers"][t] for t in lcfg.targets],
                            list(flat.values()), grads_out)

    zeros = tree_map(torch.zeros_like, state.params)
    opt = step.make_optimizer(learning_rate=LORA_LR, weight_decay=0.0)
    parts = {"lm_head loss fwd+recompute+bwd to x (f32 products)":
             _time_ms(lm_head_loss, iters=3, warmup=1),
             f"merge_lora fwd+bwd ({len(lcfg.targets)} targets, "
             f"{cfg.n_layers} layers)":
             _time_ms(merge, iters=3, warmup=1),
             "adamw over the adapters": _time_ms(
                 lambda: opt.apply(zeros, state.opt_state, state.params),
                 iters=3, warmup=1)}
    del x, grads_out, flat
    return parts


def _distill(cfg8, base, lcfg, adapters, cfg1, student, corpus):
    """The fine-tuned 8B (``merge_lora``) as the teacher, the converted 1B
    in f32 master params as the student: DISTILL_STEPS of
    ``make_distill_step`` at FT_BATCH x FT_SEQ with exact launches per
    step, the teacher's checksums unchanged, step ms, peak memory.
    Returns (the counted run's launches, the teacher, the student's
    state, the step ms)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        distill,
        lora,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
        TokenBatches,
    )

    teacher = lora.merge_lora(base, adapters, lcfg)
    sums = _bits_checksum(teacher)
    state = step.TrainState(0, student, step.make_optimizer().init(student))
    dstep = distill.make_distill_step(cfg1, cfg8, temperature=DISTILL_T,
                                      alpha=DISTILL_ALPHA)
    batch, mask = TokenBatches(corpus, DataConfig(FT_BATCH, FT_SEQ),
                               device=DEV).masked_batch_at(0)
    Ls, Lt = cfg1.n_layers, cfg8.n_layers
    want = {"flash_fwd": 2 * Ls + Lt, "flash_bwd_dq": Ls,
            "flash_bwd_dkv": Ls}
    # K1's launches split by head dim: the student's 2 Ls, the teacher's Lt
    want_k1 = {cfg1.head_dim: 2 * Ls}
    want_k1[cfg8.head_dim] = want_k1.get(cfg8.head_dim, 0) + Lt
    _log(f"distill: teacher Llama-3.1-8B + merged adapters (bf16), "
         f"student Llama-3.2-1B ({cfg1.param_count() / 1e9:.3f}B params, "
         f"f32 master: {4 * _tree_bytes(student) / 2**30:.2f} GiB of "
         f"params, grads and moments), batch {FT_BATCH} x {FT_SEQ}, T "
         f"{DISTILL_T}, alpha {DISTILL_ALPHA}, {DISTILL_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    by_dim = {}
    with _k1_by_head_dim(fa, by_dim):
        _zero(fa)  # the counted run starts here
        for i in range(DISTILL_STEPS):
            before, before_k1 = _counts(fa), dict(by_dim)
            if i == 1:  # the first step is the warm-up
                start.record()
            state, m = dstep(state, teacher, batch, mask)
            metrics.append(m)
            delta = {k: _counts(fa)[k] - before[k] for k in want}
            delta_k1 = {d: by_dim[d] - before_k1.get(d, 0) for d in by_dim}
            if delta != want or delta_k1 != want_k1:
                raise AssertionError(
                    f"distill step {i + 1}: launches {delta}, K1 by head "
                    f"dim {delta_k1}, expected {want}, {want_k1}")
        end.record()
        torch.cuda.synchronize()
        launches = _counts(fa)  # read just after
    if sum(by_dim.values()) != launches["flash_fwd"]:
        raise AssertionError(f"distill: K1 by head dim {by_dim} does not "
                             f"sum to its {launches['flash_fwd']} launches")
    launches[f"flash_fwd d{cfg1.head_dim}"] = by_dim[cfg1.head_dim]
    step_ms = start.elapsed_time(end) / (DISTILL_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        _log(f"distill step {i + 1}: loss {m['loss']:.6f}, hard_loss "
             f"{m['hard_loss']:.6f}, kl {m['kl']:.6f}, grad_norm "
             f"{m['grad_norm']:.6f}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("distill: non-finite metrics")
    if _bits_checksum(teacher) != sums:
        raise AssertionError("distill: the teacher's params changed")
    _log(f"distill: launches exactly K1 {2 * Ls + Lt} (student {2 * Ls} "
         f"at d {cfg1.head_dim} with its recompute + teacher {Lt} at d "
         f"{cfg8.head_dim}, never recomputed), K2 {Ls}, "
         f"K3 {Ls} in each of {DISTILL_STEPS} steps; teacher checksums "
         f"equal before and after; step {step_ms:.2f} ms (CUDA events, "
         f"mean of {DISTILL_STEPS - 1} after a warm-up), "
         f"{FT_BATCH * (FT_SEQ - 1) / (step_ms / 1e3):.1f} tokens/s; peak "
         f"memory {peak / 2**30:.2f} GiB")
    return launches, teacher, state, step_ms


def _distill_profile(cfg_s, cfg_t, state, teacher, corpus,
                     step_ms) -> None:
    """After the draft is served (these updates move the student): a
    profile of one distill step, and the step's parts that are no kernel
    of the port on the card's clock: the chunked loss (both f32 lm_heads
    at vocab 128256, the log-softmaxes and the KL; forward, chunk
    recompute with the teacher's logits, backward to the student's hidden
    states and head) and AdamW over the student's f32 params."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import distill, step
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        tree_map,
    )

    batch = torch.tensor(corpus[:FT_BATCH * FT_SEQ].reshape(FT_BATCH, FT_SEQ),
                         dtype=torch.long, device=DEV)
    dstep = distill.make_distill_step(cfg_s, cfg_t, temperature=DISTILL_T,
                                      alpha=DISTILL_ALPHA)
    _profile_step(lambda s, t, m: dstep(s, teacher, t, m), state, batch,
                  torch.ones_like(batch))
    cdt = llama.dtype_of(cfg_s.dtype)
    x_s = torch.randn((FT_BATCH, FT_SEQ - 1, cfg_s.dim), device=DEV,
                      dtype=cdt, requires_grad=True)
    x_t = torch.randn((FT_BATCH, FT_SEQ - 1, cfg_t.dim), device=DEV,
                      dtype=cdt)
    head_s = state.params["lm_head"].detach().requires_grad_(True)
    head_t = teacher["lm_head"].to(cdt)

    def loss():
        ce, kl = llama.scan_seq_chunks(
            lambda a, bb, tc: distill._distill_chunk(
                cfg_s, a, bb, head_s.to(cdt), head_t, tc, DISTILL_T),
            cfg_s.loss_chunk, x_s, x_t, batch[:, 1:])
        torch.autograd.grad((ce + kl).mean(), (x_s, head_s))

    zeros = tree_map(torch.zeros_like, state.params)
    opt = step.make_optimizer()
    parts = {"distill loss fwd+recompute+bwd (two f32 lm_heads, KL)":
             _time_ms(loss, iters=3, warmup=1),
             "adamw over the student (f32)": _time_ms(
                 lambda: opt.apply(zeros, state.opt_state, state.params),
                 iters=3, warmup=1)}
    for part, ms in parts.items():
        _log(f"distill part {part}: {ms:.2f} ms ({ms / step_ms:.3f} of the "
             "step)")


def _serve_draft(cfg8, teacher, cfg1, state, corpus) -> dict:
    """The distilled student's state saved with ``checkpoint.save``, its
    params read back with ``restore_params`` and served as the draft of
    the 8B teacher through ``spec_generate``: one greedy 1 x (PROMPT +
    NEW) request against plain ``generate``. Returns the speculative
    request's launches."""
    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        speculative,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import checkpoint
    from service_account_auth_improvements_tpu_torch.utils.tree import leaves

    workdir = FT_WORKDIR / "draft"
    t0 = time.perf_counter()
    checkpoint.save(workdir, state)
    t1 = time.perf_counter()
    draft = checkpoint.restore_params(workdir, None, cfg1, device=DEV)
    t2 = time.perf_counter()
    if any(not torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves(state.params), leaves(draft))):
        raise AssertionError("draft: restored params differ from saved")
    size = sum(f.stat().st_size for f in (workdir / str(
        state.step)).iterdir())
    _log(f"draft: checkpoint of the distilled 1B's state ({size} bytes) "
         f"saved in {t1 - t0:.2f} s, restore_params in {t2 - t1:.2f} s, "
         "bitwise equal")
    prompt = torch.tensor(corpus[None, :PROMPT], dtype=torch.long,
                          device=DEV)
    generate.generate(cfg8, teacher, prompt[:, :16], 2, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = generate.generate(cfg8, teacher, prompt, NEW, device=DEV)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _zero(fa)  # the counted run starts here
    t0 = time.perf_counter()
    got, stats = speculative.spec_generate(cfg8, teacher, cfg1, draft,
                                           prompt, NEW, gamma=GAMMA,
                                           device=DEV)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _counts(fa)  # read just after
    want = {"flash_fwd": cfg8.n_layers + cfg1.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    if (tuple(got.shape) != (1, PROMPT + NEW)
            or not torch.equal(got[:, :PROMPT], prompt)
            or not bool(((got >= 0) & (got < cfg8.vocab_size)).all())
            or launches != want):
        raise AssertionError(f"draft: output {tuple(got.shape)} or "
                             f"launches {launches} (expected {want})")
    agree = float((got[0, PROMPT:] == plain[0, PROMPT:]).float().mean())
    _log(f"draft: spec_generate 8B target + distilled 1B draft, greedy 1 "
         f"x ({PROMPT} + {NEW}), gamma {GAMMA}: {ms:.1f} ms against "
         f"plain generate {plain_ms:.1f} ms ({ms / plain_ms:.2f}x); "
         f"acceptance {stats['acceptance_rate']:.4f} ({stats['accepted']}"
         f" of {stats['proposed']}); new tokens equal to plain greedy "
         f"{agree:.4f}; K1 {launches['flash_fwd']} ({cfg8.n_layers} "
         f"target + {cfg1.n_layers} draft prefill)")
    del draft
    torch.cuda.empty_cache()
    return launches


def phase_side_models() -> None:
    """Phase 9: MNIST (the default 784-256-10 MLP) and ResNet-50 training
    on the card, and MNIST and resnet18-smoke on the card against the
    CPU route."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    _timed("side models mnist", _mnist)
    _timed("side models resnet-50", _resnet50)
    _timed("side models card vs cpu", _side_card_vs_cpu)


def _mnist() -> None:
    from service_account_auth_improvements_tpu_torch.models import mnist

    cfg = mnist.MnistConfig()
    gen = torch.Generator(device=DEV).manual_seed(0)
    labels = torch.randint(0, cfg.num_classes, (MNIST_BATCH,),
                           generator=gen, device=DEV)
    # class-dependent means make the task learnable
    centers = torch.randn((cfg.num_classes, cfg.in_dim), generator=gen,
                          device=DEV) * 2.0
    x = centers[labels] + torch.randn((MNIST_BATCH, cfg.in_dim),
                                      generator=gen, device=DEV) * 0.5
    params = mnist.init(cfg, gen, device=DEV)
    step = mnist.make_sgd_step(cfg, lr=0.1)
    acc0 = float(mnist.accuracy(cfg, params, x, labels))
    losses = []
    for _ in range(MNIST_STEPS):
        params, loss = step(params, x, labels)
        losses.append(float(loss))
    acc = float(mnist.accuracy(cfg, params, x, labels))
    _log(f"mnist: {cfg} ({cfg.param_count()} params), batch "
         f"{MNIST_BATCH}, {MNIST_STEPS} SGD steps: loss {losses[0]:.4f} -> "
         f"{losses[-1]:.4f}, accuracy {acc0:.4f} -> {acc:.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"mnist: losses {losses}")


def _resnet50() -> None:
    from service_account_auth_improvements_tpu_torch.models import resnet
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        tree_map,
    )

    cfg = resnet.PRESETS["resnet50"]
    gen = torch.Generator(device=DEV).manual_seed(0)
    params, stats = resnet.init(cfg, gen, device=DEV)
    n = sum(t.numel() for _, t in leaves(params))
    if not n == cfg.param_count() == RESNET50_PARAMS:
        raise AssertionError(f"resnet50: {n} params in the tree, "
                             f"{cfg.param_count()} counted")
    x = torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                    generator=gen, device=DEV).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (RESNET_BATCH,),
                           generator=gen, device=DEV)
    stats0 = tree_map(torch.clone, stats)
    mom = tree_map(torch.zeros_like, params)
    step = resnet.make_train_step(cfg, lr=RESNET_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    for i in range(RESNET_STEPS):
        if i == 1:  # the first step is the warm-up
            start.record()
        params, stats, mom, loss = step(params, stats, mom, x, labels)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (RESNET_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    moved = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(stats), leaves(stats0)))
    _log(f"resnet50: {n} params (canonical {RESNET50_PARAMS}), batch "
         f"{RESNET_BATCH} x {RESNET_SIZE} x {RESNET_SIZE} x 3 bf16 NHWC "
         f"(channels_last), momentum SGD lr {RESNET_LR}, {RESNET_STEPS} "
         f"steps on one batch: losses {[round(v, 4) for v in losses]}; "
         f"{moved} of {len(list(leaves(stats)))} running-stat leaves "
         f"moved; step {step_ms:.2f} ms (CUDA events, mean of "
         f"{RESNET_STEPS - 1} after a warm-up), "
         f"{RESNET_BATCH / (step_ms / 1e3):.1f} images/s, peak memory "
         f"{peak / 2**30:.2f} GiB")
    # lr 0.1 with momentum on one repeated batch oscillates after its
    # first drop: every later step must be below the first
    if not (np.isfinite(losses).all() and max(losses[1:]) < losses[0]):
        raise AssertionError(f"resnet50: losses {losses}")
    if moved != len(list(leaves(stats))):
        raise AssertionError("resnet50: running stats did not all move")
    _profile_step(lambda p, xx, yy: step(p, stats, mom, xx, yy), params, x,
                  labels)


def _side_card_vs_cpu() -> None:
    """MNIST (b 256) and resnet18-smoke (b 16, 32 x 32: asymmetric SAME
    padding) on the card against the CPU route, one input each, bf16
    both sides, within SIDE_TOL."""
    from service_account_auth_improvements_tpu_torch.models import (
        mnist,
        resnet,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        tree_map,
    )

    rng = np.random.default_rng(0)
    cfg = mnist.MnistConfig()
    params = mnist.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor(rng.normal(size=(256, cfg.in_dim)), dtype=torch.float32)
    want = mnist.apply(cfg, params, x)
    got = mnist.apply(cfg, tree_map(lambda t: t.to(DEV), params),
                      x.to(DEV)).cpu()
    err = float((got - want).abs().max())
    _log(f"mnist card vs cpu (b 256, bf16): logits max abs err {err:.3e} "
         f"(max abs logit {float(want.abs().max()):.3f}, tolerance "
         f"{SIDE_TOL['mnist']})")
    if err > SIDE_TOL["mnist"]:
        raise AssertionError("mnist: card and CPU disagree")

    cfg = resnet.PRESETS["resnet18-smoke"]
    params, stats = resnet.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params["head"]["w"] = torch.randn(
        params["head"]["w"].shape,
        generator=torch.Generator().manual_seed(1)) * 0.3
    x = torch.tensor(rng.normal(size=(16, 32, 32, 3)), dtype=torch.float32)
    out = {}
    for dev in ("cpu", DEV):
        p, s = (tree_map(lambda t: t.to(dev), t) for t in (params, stats))
        ev, _ = resnet.apply(cfg, p, s, x.to(dev), train=False)
        tr, ns = resnet.apply(cfg, p, s, x.to(dev), train=True)
        out[dev] = (ev.cpu(), tr.cpu(), tree_map(lambda t: t.cpu(), ns))
    errs = [float((a - b).abs().max()) for a, b in zip(out[DEV][:2],
                                                       out["cpu"][:2])]
    errs.append(max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves(out[DEV][2]), leaves(out["cpu"][2]))))
    _log(f"resnet18-smoke card vs cpu (b 16, 32 x 32, bf16): eval logits "
         f"{errs[0]:.3e}, train logits {errs[1]:.3e}, running stats "
         f"{errs[2]:.3e} max abs err (max abs logit "
         f"{float(out['cpu'][0].abs().max()):.3f}, tolerance "
         f"{SIDE_TOL['resnet']})")
    if max(errs) > SIDE_TOL["resnet"]:
        raise AssertionError("resnet18-smoke: card and CPU disagree")


# parallel path (phase 10): the mesh step at PRESET, TRAIN_BATCH x
# TRAIN_SEQ, on a one-card mesh over NCCL (every axis 1): PARALLEL_STEPS
# steps each of the plain step, the mesh step with flash attention, with
# Ulysses (whose exchanges are the identity at sp 1: equal to flash, bit
# for bit) and with ring attention (held to the dense step). The mesh step
# at world 1 runs the plain step's arithmetic op for op: bitwise equal.
PARALLEL_STEPS = 3
# ring against dense attention. The PARALLEL_STEPS bf16 steps (the ring's
# time and launches) hold the losses and step 1's grad norm (the one norm
# taken from the same params) within the GRAD_TOL bf16 row; later steps
# start from params the two runs moved apart. What tells the two apart is
# step 1's gradients leaf by leaf from the same params in f32 compute,
# where only summation order separates them: within the GRAD_TOL f32
# "leaf" limit. A control ring whose mask lets each query see the next
# RING_CONTROL_PEEK keys must land above that limit, or the check could
# not see a faulty ring.
RING_CONTROL_PEEK = 1
# the ring's arithmetic at full width: TRAIN_SEQ as RING_CHUNKS chunks of
# sequence (ranks simulated in one process), against K1's output and LSE
# (TOL and LSE_ATOL)
RING_CHUNKS = 4


def phase_parallel() -> dict:
    """Phase 10: the parallel package on the card. The process group and
    a world-1 mesh over NCCL; the mesh train step (flash, Ulysses, ring)
    against the plain step; the ring's chunk arithmetic at full width.
    Returns each mesh run's launch counts."""
    import gc

    import torch.distributed as dist

    from service_account_auth_improvements_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
    )
    from service_account_auth_improvements_tpu_torch.parallel.mesh import (
        BACKENDS,
    )

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1),
                     device=DEV)
    probe = torch.ones(4, device=DEV)
    dist.all_reduce(probe)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    _log(f"parallel: process group {dist.get_backend()}, world size "
         f"{dist.get_world_size()}, mesh {sizes} on {mesh.device_type}; "
         f"an all-reduce over it: {probe.tolist()}")
    if (dist.get_backend() != BACKENDS[torch.device(DEV).type]
            or dist.get_world_size() != 1):
        raise AssertionError("the card's mesh must be NCCL at world 1")
    launches = _timed("parallel steps", _parallel_steps, mesh)
    _timed("parallel ring arithmetic", _ring_full_width)
    return launches


def _parallel_run(cfg, state0, mesh, tokens, mask, name):
    """PARALLEL_STEPS steps from a copy of ``state0``: (metrics per step,
    launches per step, the final state whole, step ms, peak GiB above
    what was allocated before the run)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    def copy(tree):
        return step_mod._map(lambda t: t.clone(), tree)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    opt = state0.opt_state
    state = step_mod.TrainState(0, copy(state0.params), step_mod.AdamState(
        0, copy(opt.mu), copy(opt.nu)))
    if mesh is not None:
        state = step_mod.shard_state(mesh, cfg, state)
    fn = step_mod.make_train_step(cfg, mesh=mesh)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics, per_step = [], []
    for i in range(PARALLEL_STEPS):
        if i == 1:  # the first step is the warm-up
            start.record()
        _zero(fa)  # each step's launches counted on their own
        state, m = fn(state, tokens, mask)
        per_step.append(tuple(_counts(fa).values()))
        metrics.append((m["loss"], m["grad_norm"]))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (PARALLEL_STEPS - 1)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    metrics = [(float(a), float(b)) for a, b in metrics]
    final = {part: step_mod._map(sharding.full_tensor, tree)
             for part, tree in (("params", state.params),
                                ("mu", state.opt_state.mu),
                                ("nu", state.opt_state.nu))}
    _log(f"parallel {name}: step {step_ms:.2f} ms (CUDA events, mean of "
         f"{PARALLEL_STEPS - 1} after one warm-up), peak {peak:.2f} GiB "
         "above what the run found allocated (its state included), "
         f"launches per step (K1, K2, K3) {per_step}, losses "
         f"{[round(x[0], 6) for x in metrics]}")
    if not all(np.isfinite(metrics).ravel()):
        raise AssertionError(f"parallel {name}: non-finite loss or norm")
    return metrics, per_step, final, step_ms, peak


def _largest_difference(a: dict, b: dict) -> float:
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
    )

    return max(float((x.float() - y.float()).abs().max())
               for part in a for (_, x), (_, y) in zip(leaves(a[part]),
                                                       leaves(b[part])))


def _parallel_steps(mesh) -> dict:
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    cfg = llama.PRESETS[PRESET]
    L = cfg.n_layers
    state0 = step_mod.init_train_state(
        cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=torch.Generator(device=DEV)
                           .manual_seed(2), device=DEV)
    mask = torch.ones_like(tokens)
    _log(f"parallel: {PRESET} at b {TRAIN_BATCH} x {TRAIN_SEQ}, f32 master, "
         f"bf16 compute, remat {cfg.remat_policy}, {PARALLEL_STEPS} steps "
         "per run from one init")
    plain = _parallel_run(cfg, state0, None, tokens, mask, "plain step")
    flash = _parallel_run(cfg, state0, mesh, tokens, mask, "mesh flash")
    if flash[0] != plain[0] or _largest_difference(flash[2], plain[2]):
        raise AssertionError(
            "the world-1 mesh step is not the plain step bit for bit: "
            f"largest difference {_largest_difference(flash[2], plain[2])}")
    _log(f"parallel mesh flash = plain step bit for bit (losses, grad "
         f"norms, params, mu, nu); step {flash[3]:.2f} ms against "
         f"{plain[3]:.2f} ms: the mesh's own cost at world 1 "
         f"{flash[3] - plain[3]:+.2f} ms per step")
    del plain
    uly = _parallel_run(dataclasses.replace(cfg, attn_impl="ulysses"),
                        state0, mesh, tokens, mask, "mesh ulysses")
    if uly[0] != flash[0] or _largest_difference(uly[2], flash[2]):
        raise AssertionError("Ulysses at sp 1 is not the flash mesh step "
                             "bit for bit")
    _log("parallel mesh ulysses = mesh flash bit for bit")
    for name, run in (("flash", flash), ("ulysses", uly)):
        if any(c != (2 * L, L, L) for c in run[1]):
            raise AssertionError(f"parallel {name}: launches per step "
                                 f"{run[1]}, expected K1 {2 * L}, K2 {L}, "
                                 f"K3 {L}")
    counts = {"parallel flash": flash[1], "parallel ulysses": uly[1]}
    del flash, uly
    torch.cuda.empty_cache()
    dense = _parallel_run(dataclasses.replace(cfg, attn_impl="dense"),
                          state0, None, tokens, mask, "plain dense step")
    ring = _parallel_run(dataclasses.replace(cfg, attn_impl="ring"),
                         state0, mesh, tokens, mask, "mesh ring")
    if any(c != (0, 0, 0) for c in ring[1]):
        raise AssertionError(f"parallel ring: launches per step {ring[1]}, "
                             "expected none")
    counts["parallel ring"] = ring[1]
    tol = GRAD_TOL["bf16"]
    loss_d = [abs(a[0] - b[0]) for a, b in zip(ring[0], dense[0])]
    norm_d = [abs(a[1] - b[1]) / b[1] for a, b in zip(ring[0], dense[0])]
    _log(f"parallel mesh ring vs plain dense, steps 1 to {PARALLEL_STEPS}: "
         f"loss differences {[f'{x:.3e}' for x in loss_d]} (tolerance "
         f"{tol['loss']}), grad norms {[f'{x:.3e}' for x in norm_d]} "
         f"relative (step 1, from the same params: {tol['gnorm']})")
    if max(loss_d) > tol["loss"] or norm_d[0] > tol["gnorm"]:
        raise AssertionError("ring and dense train steps disagree")
    del dense, ring
    torch.cuda.empty_cache()
    _timed("parallel ring grads", _ring_grads_vs_dense, cfg, mesh,
           state0.params, tokens, mask)
    del state0
    torch.cuda.empty_cache()
    return {path: dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                           map(sum, zip(*per_step))))
            for path, per_step in counts.items()}


def _ring_grads_vs_dense(cfg, mesh, params, tokens, mask) -> None:
    """Step 1's loss and gradients from ``params`` in f32 compute: the
    ring on the mesh's region (as the mesh step computes) against dense
    attention with no mesh, leaf by leaf; then a control ring whose mask
    lets each query see the next RING_CONTROL_PEEK keys, which the same
    limit must reject."""
    import contextlib
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        ring,
        use_mesh,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        value_and_grad,
    )

    def grads(impl, on_mesh):
        c = dataclasses.replace(cfg, dtype="float32", attn_impl=impl)
        with use_mesh(mesh) if on_mesh else contextlib.nullcontext():
            loss, g = value_and_grad(
                lambda p, t, m: llama.next_token_loss(c, p, t, m), params,
                tokens, mask)
        return float(loss), g

    def leaf_diff(got, want):
        return max(float((got[k] - want[k]).abs().max()
                         / want[k].abs().max().clamp_min(1e-30))
                   for k in want)

    tol = GRAD_TOL["f32"]
    l_dense, g_dense = grads("dense", False)
    g_dense = dict(leaves(g_dense))
    l_ring, g_ring = grads("ring", True)
    g_ring = dict(leaves(g_ring))
    n_ring = float(torch.sqrt(sum(g.double().square().sum()
                                  for g in g_ring.values())))
    n_dense = float(torch.sqrt(sum(g.double().square().sum()
                                   for g in g_dense.values())))
    sound = leaf_diff(g_ring, g_dense)
    finite = all(bool(torch.isfinite(g).all()) for g in g_ring.values())
    del g_ring
    real = ring._chunk_attention_with_lse

    def peeking(q, k, v, q_off, k_off, scale):
        return real(q, k, v, q_off + RING_CONTROL_PEEK, k_off, scale)

    ring._chunk_attention_with_lse = peeking
    try:
        l_ctrl, g_ctrl = grads("ring", True)
    finally:
        ring._chunk_attention_with_lse = real
    control = leaf_diff(dict(leaves(g_ctrl)), g_dense)
    del g_ctrl, g_dense
    torch.cuda.empty_cache()
    _log(f"parallel ring vs dense step 1 gradients ({PRESET}, b "
         f"{TRAIN_BATCH} x {TRAIN_SEQ}, f32 compute, same params): loss "
         f"{l_ring:.6f} vs {l_dense:.6f}, grad norm {n_ring:.6f} vs "
         f"{n_dense:.6f}, largest per-leaf grad difference {sound:.3e} of "
         f"the leaf's max (limit {tol['leaf']}); control (each query also sees "
         f"the next {RING_CONTROL_PEEK} key(s)): loss {l_ctrl:.6f}, per-leaf "
         f"difference {control:.3e}")
    if not (finite and abs(l_ring - l_dense) <= tol["loss"]
            and abs(n_ring - n_dense) <= tol["gnorm"] * n_dense
            and sound <= tol["leaf"]):
        raise AssertionError("ring and dense step 1 gradients differ "
                             "beyond the f32 tolerances")
    if control <= tol["leaf"]:
        raise AssertionError("the ring-vs-dense gradient limit does not "
                             "reject the control ring")


def _ring_by_chunks(q, k, v, n):
    """Ring attention over ``n`` sequence chunks with every rank simulated
    in one process: rank r folds chunks r, r-1, ... 0, n-1, ... with their
    global offsets, as the ring delivers them. Returns (out [b,s,h,d],
    lse [b,s,h] f32)."""
    from service_account_auth_improvements_tpu_torch.parallel import ring

    c = q.shape[1] // n
    scale = q.shape[-1] ** -0.5
    outs, lses = [], []
    for r in range(n):
        qr = q[:, r * c:(r + 1) * c]
        o = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qr.shape[:-1], ring.NEG_INF, dtype=torch.float32,
                         device=q.device)
        for step in range(n):
            j = (r - step) % n
            oj, lj = ring._chunk_attention_with_lse(
                qr, k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                r * c, j * c, scale)
            o, lse = ring._merge(o, lse, oj, lj)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _ring_full_width() -> None:
    """The ring's chunk arithmetic at the training shape (b 8, s 2048 as
    RING_CHUNKS chunks, 12 / 4 heads, d 128), bf16 and f32, against K1's
    output and LSE, timed beside K1."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device=DEV).manual_seed(9)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(TRAIN_BATCH, TRAIN_SEQ, 12, 4, 128, dtype, gen)
        got, got_lse = _ring_by_chunks(q, k, v, RING_CHUNKS)
        want, want_lse = fa.flash_fwd(*(t.transpose(1, 2)
                                        for t in (q, k, v)), True)
        atol, rtol = TOL[dtype]
        err = _check(f"ring {dtype}", got, want.transpose(1, 2), atol, rtol)
        lerr = _check(f"ring {dtype} lse", got_lse,
                      want_lse.transpose(1, 2), LSE_ATOL, 0.0)
        ring_ms = _time_ms(lambda: _ring_by_chunks(q, k, v, RING_CHUNKS),
                           iters=3, warmup=1)
        k1_ms = _time_ms(lambda: fa.flash_fwd(
            *(t.transpose(1, 2) for t in (q, k, v)), True), iters=10)
        _log(f"parallel ring arithmetic {str(dtype)[6:]} (b {TRAIN_BATCH}, "
             f"s {TRAIN_SEQ} as {RING_CHUNKS} chunks of "
             f"{TRAIN_SEQ // RING_CHUNKS}, 12 / 4 heads, d 128, causal): "
             f"out max abs err {err:.3e} (atol {atol} rtol {rtol}), lse "
             f"{lerr:.3e} (atol {LSE_ATOL}) against K1; {ring_ms:.2f} ms "
             f"for all {RING_CHUNKS} ranks' {RING_CHUNKS} chunk steps "
             f"against K1 {k1_ms:.4f} ms (CUDA events)")
        del q, k, v, got, want
    torch.cuda.empty_cache()


# phase 11, parallel II: the GPipe schedule at PRESET, TRAIN_BATCH x
# TRAIN_SEQ, as PIPE_STAGES stages of n_layers / PIPE_STAGES layers and
# PIPE_MICRO microbatches, every stage in this process through
# parallel.pipeline.pipeline_local (the package's ticks, the hop a
# rotation of the stages' activations). PIPE_STEPS bf16 steps of it and of
# the plain step from one init: exact launches per step (K1 2·M·L, K2 and
# K3 M·L), step ms, peak memory, and the losses within the GRAD_TOL bf16
# row. Step 1's loss and gradients from one set of params in f32 compute
# against the plain stack's: loss within PIPE_LOSS_TOL, each leaf within
# GRAD_TOL f32 "leaf" of its largest gradient; a control schedule that
# loses microbatch PIPE_CONTROL_DROP's input must land above that limit.
PIPE_STAGES, PIPE_MICRO, PIPE_STEPS, PIPE_CONTROL_DROP = 4, 8, 3, 3
PIPE_LOSS_TOL = 1e-4
# expert parallelism at MOE_PRESET's training shape (b TRAIN_BATCH x
# TRAIN_SEQ, one layer's MoE FFN, f32): every ep rank's share computed in
# this process (parallel.sharding.expert_share) and the partial outputs
# summed, for each of EP_SIZES, against the plain _moe_ffn: the expert
# choices equal, the output within EP_ATOL, the aux equal
EP_SIZES, EP_ATOL = (2, 4), 1e-5
# the world-1 NCCL mesh's paths at full width, each bit for bit its plain
# path: MOE_PRESET's train step (WORLD1_STEPS steps), GenerationService at
# PRESET (BATCH prompts of PROMPT tokens, WORLD1_NEW new, per-length and
# windowed prefill), a LoRA step over a PRESET base (WORLD1_STEPS steps,
# rank 8 on wq wk wv wo) and ResNet-50's momentum step (RESNET_BATCH,
# WORLD1_STEPS steps)
WORLD1_STEPS, WORLD1_NEW = 2, 16


def phase_parallel2() -> dict:
    """Phase 11: the pipeline's schedule and the expert split at full
    width in one process, and the world-1 NCCL mesh's MoE, serving, LoRA
    and ResNet-50 paths against their plain ones. Returns each path's
    launch counts."""
    import gc

    from service_account_auth_improvements_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
    )

    gc.collect()
    torch.cuda.empty_cache()
    counts = _timed("parallel II pipeline", _pipeline_full_width)
    _timed("parallel II expert split", _ep_full_width)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1),
                     device=DEV)
    counts.update(_timed("parallel II world-1 mesh paths", _world1_paths,
                         mesh))
    return counts


def _pipe_loss(cfg, params, tokens, mask, drop=None):
    """``next_token_loss`` with the layer stack run as PIPE_STAGES
    pipeline stages over PIPE_MICRO microbatches in this process
    (``pipeline_local``); ``drop`` zeroes that microbatch's input (a
    schedule that loses it: the control)."""
    import functools

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        pipeline,
    )

    cdt = llama.dtype_of(cfg.dtype)
    x = llama.embed(cfg, params, tokens)
    cos, sin = llama.rope_table(tokens.shape[1], cfg.head_dim,
                                cfg.rope_theta, scaling=cfg.rope_scaling(),
                                device=x.device)
    if drop is not None:
        mb = x.shape[0] // PIPE_MICRO
        x = torch.cat([x[:drop * mb], torch.zeros_like(x[:mb]),
                       x[(drop + 1) * mb:]])
    layer = llama._remat(cfg, functools.partial(llama._layer, cfg))
    y, _ = pipeline.pipeline_local(layer, params["layers"], x, (cos, sin),
                                   n_stages=PIPE_STAGES, n_micro=PIPE_MICRO)
    y = llama.rms_norm(y, params["final_norm"].to(cdt), cfg.norm_eps)
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        NO_REGION,
    )
    _, targets, m, count = llama.next_token_targets(cfg, NO_REGION, tokens,
                                                     mask)
    nll = llama._chunked_nll(cfg, y[:, :-1], params["lm_head"].to(cdt),
                             targets)
    return (nll * m).sum() / count.clamp_min(1.0)


def _pipe_run(cfg, state0, tokens, mask, piped: bool):
    """PIPE_STEPS steps from a copy of ``state0``, pipelined or plain:
    (losses, launches per step, step ms, peak GiB above what the run
    found allocated, the host's ms to issue a step: near the step's own
    when the host is what bounds it)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        value_and_grad,
    )

    def copy(tree):
        return step_mod._map(lambda t: t.clone(), tree)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    opt = state0.opt_state
    state = step_mod.TrainState(0, copy(state0.params), step_mod.AdamState(
        0, copy(opt.mu), copy(opt.nu)))
    optimizer = step_mod.make_optimizer()
    plain = step_mod.make_train_step(cfg, optimizer)

    def piped_step(state, tokens, mask):
        loss, grads = value_and_grad(
            lambda p: _pipe_loss(cfg, p, tokens, mask), state.params)
        gnorm = step_mod.global_norm(grads)
        params, opt_state = optimizer.apply(grads, state.opt_state,
                                            state.params, gnorm)
        return step_mod.TrainState(state.step + 1, params, opt_state), loss

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses, per_step = [], []
    for i in range(PIPE_STEPS):
        if i == 1:  # the first step is the warm-up
            start.record()
            t_host = time.perf_counter()
        _zero(fa)
        if piped:
            state, loss = piped_step(state, tokens, mask)
        else:
            state, m = plain(state, tokens, mask)
            loss = m["loss"]
        per_step.append(tuple(_counts(fa).values()))
        losses.append(loss)
    end.record()
    host_ms = (time.perf_counter() - t_host) * 1e3 / (PIPE_STEPS - 1)
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (PIPE_STEPS - 1)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    return [float(v) for v in losses], per_step, step_ms, peak, host_ms


def _pipeline_full_width() -> dict:
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        value_and_grad,
    )

    cfg = llama.PRESETS[PRESET]
    L, M, P = cfg.n_layers, PIPE_MICRO, PIPE_STAGES
    state0 = step_mod.init_train_state(
        cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=DEV)
    mask = torch.ones_like(tokens)
    plain = _pipe_run(cfg, state0, tokens, mask, piped=False)
    piped = _pipe_run(cfg, state0, tokens, mask, piped=True)
    _log(f"parallel II pipeline: {PRESET} at b {TRAIN_BATCH} x {TRAIN_SEQ} "
         f"as {P} stages of {L // P} layers, {M} microbatches of "
         f"{TRAIN_BATCH // M} (every stage in this process, bf16 compute, "
         f"f32 master): step {piped[2]:.2f} ms against the plain step's "
         f"{plain[2]:.2f} ms (CUDA events, mean of {PIPE_STEPS - 1} after a "
         f"warm-up), peak {piped[3]:.2f} GiB against {plain[3]:.2f} GiB "
         f"above the state, the host's issue {piped[4]:.2f} ms per step "
         f"against {plain[4]:.2f} ms (host clock, no sync inside); "
         f"launches per step (K1, K2, K3) {piped[1]}; "
         f"losses {[round(x, 6) for x in piped[0]]} against "
         f"{[round(x, 6) for x in plain[0]]}")
    want = (2 * M * L, M * L, M * L)
    if any(c != want for c in piped[1]):
        raise AssertionError(f"pipeline: launches per step {piped[1]}, "
                             f"expected {want}")
    tol = GRAD_TOL["bf16"]
    if (not np.isfinite(piped[0]).all()
            or max(abs(a - b) for a, b in zip(piped[0], plain[0]))
            > tol["loss"]):
        raise AssertionError("pipelined and plain bf16 steps disagree")
    counts = {"parallel II pipeline": dict(zip(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
        map(sum, zip(*piped[1]))))}
    del plain, piped
    torch.cuda.empty_cache()
    # step 1's gradients from the same params, f32 compute
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = state0.params

    def grads(fn):
        loss, g = value_and_grad(fn, params)
        return float(loss), dict(leaves(g))

    def leaf_diff(got, ref):
        return max(float((got[k] - ref[k]).abs().max()
                         / ref[k].abs().max().clamp_min(1e-30))
                   for k in ref)

    l_plain, g_plain = _f32_counted(
        "pipeline step 1 f32", lambda: grads(lambda p: llama.next_token_loss(
            c32, p, tokens, mask)))
    l_pipe, g_pipe = _f32_counted("pipeline step 1 f32", lambda: grads(
        lambda p: _pipe_loss(c32, p, tokens, mask)))
    sound = leaf_diff(g_pipe, g_plain)
    finite = all(bool(torch.isfinite(g).all()) for g in g_pipe.values())
    del g_pipe
    l_ctrl, g_ctrl = _f32_counted("pipeline step 1 f32", lambda: grads(
        lambda p: _pipe_loss(c32, p, tokens, mask, drop=PIPE_CONTROL_DROP)))
    control = leaf_diff(g_ctrl, g_plain)
    del g_ctrl, g_plain, state0, params
    torch.cuda.empty_cache()
    _log(f"parallel II pipeline vs plain step 1 ({PRESET}, b {TRAIN_BATCH} "
         f"x {TRAIN_SEQ}, f32 compute, same params): loss {l_pipe:.6f} vs "
         f"{l_plain:.6f} (limit {PIPE_LOSS_TOL}), largest per-leaf grad "
         f"difference {sound:.3e} of the leaf's max (limit "
         f"{GRAD_TOL['f32']['leaf']}); control (microbatch "
         f"{PIPE_CONTROL_DROP}'s input lost): loss {l_ctrl:.6f}, per-leaf "
         f"difference {control:.3e}")
    if not (finite and abs(l_pipe - l_plain) <= PIPE_LOSS_TOL
            and sound <= GRAD_TOL["f32"]["leaf"]):
        raise AssertionError("pipelined and plain step 1 gradients differ "
                             "beyond the f32 tolerances")
    if control <= GRAD_TOL["f32"]["leaf"]:
        raise AssertionError("the pipeline's gradient limit does not "
                             "reject the control schedule")
    return counts


def _ep_full_width() -> None:
    """One MoE layer's FFN at MOE_PRESET's training shape, f32: the sum of
    every ep rank's share against the plain FFN, for each of EP_SIZES,
    timed beside it."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )

    cfg = dataclasses.replace(llama.PRESETS[MOE_PRESET], dtype="float32")
    E, d, m = cfg.moe_experts, cfg.dim, cfg.mlp_dim
    gen = torch.Generator(device=DEV).manual_seed(11)

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=DEV) * std

    lp = {"router": normal(d, E), "moe_gate": normal(E, d, m),
          "moe_up": normal(E, d, m),
          "moe_down": normal(E, m, d, std=0.02 / (2 * cfg.n_layers) ** 0.5)}
    h = normal(TRAIN_BATCH, TRAIN_SEQ, d, std=1.0)
    with torch.no_grad():
        routes = []
        want, want_aux = llama._moe_ffn(cfg, h, lp, routes=routes)
        plain_ms = _time_ms(lambda: llama._moe_ffn(cfg, h, lp), iters=5,
                            warmup=1)
        for n in EP_SIZES:
            total = torch.zeros_like(want)
            shares = []
            for r in range(n):
                region = sharding.expert_share(n, r)
                e0, e1 = region.expert_range(E)
                share = {k: (v[e0:e1] if k.startswith("moe_") else v)
                         for k, v in lp.items()}
                got_routes = []
                out, aux = llama._moe_ffn(cfg, h, share, region=region,
                                          routes=got_routes)
                if not torch.equal(got_routes[0], routes[0]):
                    raise AssertionError(f"ep {n} rank {r}: routing differs")
                if float(aux) != float(want_aux):
                    raise AssertionError(f"ep {n} rank {r}: aux differs")
                total += out
                shares.append((region, share))
            err = _check(f"ep {n} combine", total, want, EP_ATOL, 0.0)
            region, share = shares[0]
            share_ms = _time_ms(lambda: llama._moe_ffn(cfg, h, share,
                                                       region=region),
                                iters=5, warmup=1)
            _log(f"parallel II ep {n} ({MOE_PRESET} MoE FFN, b "
                 f"{TRAIN_BATCH} x {TRAIN_SEQ}, {E} experts, {E // n} per "
                 f"rank, f32): routing equal on every rank, aux "
                 f"{float(want_aux):.6f} on every rank, summed output max "
                 f"abs err {err:.3e} (atol {EP_ATOL}); one rank's share "
                 f"{share_ms:.2f} ms against the whole FFN's "
                 f"{plain_ms:.2f} ms (CUDA events)")
    del h, want, lp
    torch.cuda.empty_cache()


def _world1_paths(mesh) -> dict:
    """The world-1 NCCL mesh's MoE train step, sharded serving, LoRA step
    and ResNet-50 step, each bit for bit (or token for token) its plain
    path's. Returns each mesh path's launch counts."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    counts = {}
    for name, fn in (("moe", _world1_moe), ("serving", _world1_serving),
                     ("lora", _world1_lora), ("resnet50", _world1_resnet)):
        got = fn(mesh, fa)
        if got is not None:
            counts[f"parallel II mesh {name}"] = got
        torch.cuda.empty_cache()
    return counts


def _same_trees(name, a, b) -> None:
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
    )

    for (n, x), (_, y) in zip(leaves(a), leaves(b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: {n} differs between the world-1 "
                                 "mesh and the plain path")


def _world1_moe(mesh, fa) -> dict:
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    cfg = llama.PRESETS[MOE_PRESET]
    gen = torch.Generator(device=DEV).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=DEV)
    mask = torch.ones_like(tokens)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        state = step_mod.init_train_state(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        if m is not None:
            state = step_mod.shard_state(m, cfg, state)
        fn = step_mod.make_train_step(cfg, mesh=m)
        _zero(fa)
        losses = []
        for _ in range(WORLD1_STEPS):
            state, met = fn(state, tokens, mask)
            losses.append(float(met["loss"]))
        runs[name] = (losses, _counts(fa), step_mod._map(
            sharding.full_tensor, state.params))
        del state
    if runs["plain"][0] != runs["mesh"][0]:
        raise AssertionError(f"moe mesh: losses {runs['mesh'][0]} against "
                             f"{runs['plain'][0]}")
    _same_trees("moe mesh params", runs["mesh"][2], runs["plain"][2])
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * WORLD1_STEPS,
            "flash_bwd_dq": L * WORLD1_STEPS,
            "flash_bwd_dkv": L * WORLD1_STEPS}
    if runs["mesh"][1] != want:
        raise AssertionError(f"moe mesh launches {runs['mesh'][1]}")
    _log(f"parallel II world-1 mesh {MOE_PRESET} train step = plain bit for "
         f"bit over {WORLD1_STEPS} steps (losses {runs['mesh'][0]}, every "
         f"param); launches {runs['mesh'][1]}")
    return runs["mesh"][1]


def _world1_serving(mesh, fa) -> dict:
    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )

    cfg = llama.PRESETS[PRESET]
    params = llama.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
    gen = np.random.default_rng(5)
    body = {"prompt_ids": gen.integers(0, cfg.vocab_size,
                                       (BATCH, PROMPT)).tolist(),
            "max_new_tokens": WORLD1_NEW}
    one = {"prompt_ids": body["prompt_ids"][0],
           "max_new_tokens": WORLD1_NEW, "stream": True}
    got, total = {}, None
    for window in (0, serving.DEFAULT_PREFILL_WINDOW):
        for name, m in (("plain", None), ("mesh", mesh)):
            p = (params if m is None else sharding.tree_distribute(
                params, m, llama.logical_axes(cfg)))
            svc = serving.GenerationService(cfg, p, max_new_cap=64,
                                            prefill_window=window,
                                            device=DEV, mesh=m)
            _zero(fa)
            ids = svc.complete(dict(body))["completion_ids"]
            stream = sum((c[0] for c in svc.stream_events(dict(one))), [])
            got[(window, name)] = (ids, stream, _counts(fa))
            if m is not None:
                svc.stop()
                if window == 0:
                    total = _counts(fa)
        if got[(window, "plain")][:2] != got[(window, "mesh")][:2]:
            raise AssertionError(f"serving mesh (window {window}): tokens "
                                 "differ from the plain service")
    if total["flash_fwd"] != 2 * cfg.n_layers:
        raise AssertionError(f"serving mesh launches {total}")
    _log(f"parallel II world-1 mesh GenerationService ({PRESET}, {BATCH} x "
         f"{PROMPT} one-shot and 1 x {PROMPT} streamed, {WORLD1_NEW} new "
         "tokens, greedy) = plain service token for token, per-length and "
         f"windowed prefill; per-length launches {total}, windowed "
         f"{got[(serving.DEFAULT_PREFILL_WINDOW, 'mesh')][2]}")
    return total


def _world1_lora(mesh, fa) -> dict:
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        lora,
        step as step_mod,
    )

    cfg = llama.PRESETS[PRESET]
    lcfg = lora.LoraConfig()
    base = llama.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                      device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=DEV)
    mask = torch.ones_like(tokens)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        state = lora.init_lora_state(
            cfg, lcfg, torch.Generator(device=DEV).manual_seed(1),
            device=DEV)
        b = base
        if m is not None:
            state = step_mod.shard_state(
                m, cfg, state, axes_tree=lora.lora_logical_axes(cfg, lcfg))
            b = sharding.tree_distribute(base, m, llama.logical_axes(cfg))
        fn = lora.make_lora_train_step(cfg, lcfg, mesh=m)
        _zero(fa)
        losses = []
        for _ in range(WORLD1_STEPS):
            state, met = fn(state, b, tokens, mask)
            losses.append(float(met["loss"]))
        runs[name] = (losses, _counts(fa), step_mod._map(
            sharding.full_tensor, state.params))
        del state, b
    if runs["plain"][0] != runs["mesh"][0]:
        raise AssertionError(f"lora mesh: losses {runs['mesh'][0]} against "
                             f"{runs['plain'][0]}")
    _same_trees("lora mesh adapters", runs["mesh"][2], runs["plain"][2])
    _log(f"parallel II world-1 mesh LoRA step ({PRESET} base, b "
         f"{TRAIN_BATCH} x {TRAIN_SEQ}, rank 8 on wq wk wv wo) = plain bit "
         f"for bit over {WORLD1_STEPS} steps (losses {runs['mesh'][0]}, "
         f"every adapter); launches {runs['mesh'][1]}")
    return runs["mesh"][1]


def _world1_resnet(mesh, fa) -> None:
    from service_account_auth_improvements_tpu_torch.models import resnet
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        tree_map,
    )

    cfg = resnet.PRESETS["resnet50"]
    gen = torch.Generator(device=DEV).manual_seed(0)
    params0, stats0 = resnet.init(cfg, gen, device=DEV)
    x = torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                    generator=gen, device=DEV).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (RESNET_BATCH,),
                           generator=gen, device=DEV)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        step = resnet.make_train_step(cfg, lr=RESNET_LR, mesh=m)
        params, stats = tree_map(torch.clone, params0), tree_map(
            torch.clone, stats0)
        mom = tree_map(torch.zeros_like, params)
        losses = []
        for _ in range(WORLD1_STEPS):
            params, stats, mom, loss = step(params, stats, mom, x, labels)
            losses.append(float(loss))
        runs[name] = (losses, params, stats, mom)
    for i, part in enumerate(("params", "stats", "momentum"), start=1):
        _same_trees(f"resnet50 mesh {part}", runs["mesh"][i],
                    runs["plain"][i])
    if runs["plain"][0] != runs["mesh"][0]:
        raise AssertionError("resnet50 mesh: losses differ")
    _log(f"parallel II world-1 mesh ResNet-50 step (b {RESNET_BATCH} x "
         f"{RESNET_SIZE}², bf16) = plain bit for bit over {WORLD1_STEPS} "
         f"steps (losses {runs['mesh'][0]}, params, running stats, "
         "momentum)")
    return None


# ------------------------------------------------------------ phase 12

def phase_wide_heads(window=None) -> dict:
    """PRESET at head dims 256, 192, 512, 384 and 768 (WIDE_HEADS):
    ``make_train_step`` at the training shape, WIDE_STEPS steps on one
    fixed batch, with exact launch counts per step (K1 2 L, K2 L, K3 L), a
    finite loss that falls, step time (and each step's, on the card's
    clock and the host's), tokens/s, MFU and peak memory; then the models
    of WIDE_SERVED serve, and those of WIDE_VS_DENSE take one step with
    flash against one with dense attention. Returns {head dim: {path:
    launch counts}} of exactly the counted runs. One more step of each
    runs under the profiler, uncounted. ``window(name)``, if given, is a
    context manager entered around the timed steps of WIDE_HEADS[name]
    (wide_steps.py profiles them so)."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )
    from service_account_auth_improvements_tpu_torch.train.mfu import (
        chip_peak_flops,
        mfu,
    )

    base = llama.PRESETS[PRESET]
    out = {}
    for name, (h, hkv, d) in WIDE_HEADS.items():
        cfg = dataclasses.replace(base, n_heads=h, n_kv_heads=hkv,
                                  head_dim=d)
        if h * d != base.n_heads * base.head_dim:
            raise AssertionError(f"{name}: h * d differs from {PRESET}'s")
        L = cfg.n_layers
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = step_mod.init_train_state(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        step = step_mod.make_train_step(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                               generator=torch.Generator(device=DEV)
                               .manual_seed(2), device=DEV)
        mask = torch.ones_like(tokens)
        layers = state.params["layers"]
        _log(f"wide heads: {name} ({cfg.param_count() / 1e6:.1f}M params, "
             f"{h} / {hkv} heads of {d}, wq {tuple(layers['wq'].shape[1:])}, "
             f"wk {tuple(layers['wk'].shape[1:])}), batch {TRAIN_BATCH} x "
             f"{TRAIN_SEQ}")
        losses, norms, host_ms = [], [], []
        # ends[i]: step i done on the card; the first step is the warm-up
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(WIDE_STEPS)]
        torch.cuda.synchronize()
        _zero(fa)  # the counted run
        timed = window(name) if window else contextlib.nullcontext()
        for i in range(WIDE_STEPS):
            if i == 1:
                timed.__enter__()
            t_host = time.perf_counter()
            state, m = step(state, tokens, mask)
            ends[i].record()
            host_ms.append((time.perf_counter() - t_host) * 1e3)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        timed.__exit__(None, None, None)
        launches = _counts(fa)  # read just after
        want = {"flash_fwd": 2 * L * WIDE_STEPS,
                "flash_bwd_dq": L * WIDE_STEPS,
                "flash_bwd_dkv": L * WIDE_STEPS}
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, expected "
                                 f"{want} (per step: K1 2x{L}, K2 and K3 "
                                 f"{L})")
        losses = [float(x) for x in losses]
        norms = [float(x) for x in norms]
        _log(f"wide heads {name}: launches {launches} = per step K1 "
             f"{2 * L}, K2 {L}, K3 {L}, over {WIDE_STEPS} steps; losses "
             f"{[round(x, 4) for x in losses]}, grad norms "
             f"{[round(x, 4) for x in norms]}")
        if not all(map(torch.isfinite, map(torch.tensor, losses + norms))):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: loss did not fall on the "
                                 f"repeated batch: {losses}")
        step_ms = ends[0].elapsed_time(ends[-1]) / (WIDE_STEPS - 1)
        each = [ends[i - 1].elapsed_time(ends[i])
                for i in range(1, WIDE_STEPS)]
        _log(f"wide heads {name}: each timed step "
             f"{[round(x, 2) for x in each]} ms on the card's clock (one "
             f"step's end to the next's; median "
             f"{sorted(each)[len(each) // 2]:.2f}), "
             f"{[round(x, 2) for x in host_ms[1:]]} ms of the host's to "
             f"issue each (warm-up: {host_ms[0]:.2f})")
        tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ - 1)
        tok_s = tokens_per_step / (step_ms / 1e3)
        peak = chip_peak_flops()
        util = mfu(cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step,
                   step_ms / 1e3, 1, peak)
        _log(f"wide heads {name}: step {step_ms:.2f} ms (CUDA events, mean "
             f"of {WIDE_STEPS - 1} steps after one warm-up), {tok_s:.1f} "
             f"tokens/s, mfu {util:.4f} (peak {peak / 1e12:.0f} TF/s bf16), "
             f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
             "GiB")
        _log(f"wide heads {name}: one step under the profiler:")
        _profile_step(step, state, tokens, mask)
        paths = {"training": launches}
        del step, m
        if d in WIDE_SERVED:
            paths.update(_wide_serving(cfg, state.params, fa))
        out[d] = paths
        del state
        torch.cuda.empty_cache()
        if d in WIDE_VS_DENSE:
            _log(f"wide heads {name}: one step flash against dense:")
            _grads_flash_vs_dense(cfg, step_mod)
    return out


def _wide_serving(cfg, params, fa) -> dict:
    """A trained wide-head model in bf16 behind ``GenerationService``
    (per-length prefill) answering one greedy request over HTTP: K1 once
    per layer, the first tokens ``llama.apply``'s argmax; then greedy f32
    decoding, flash (K1's f32 route) against dense, token for token, and
    above the per-dim bound (the streamed kernels) greedy bf16 decoding
    too: ``llama.apply``'s logits, flash against dense, within
    APPLY_ATOL's bf16 bound, and the greedy tokens' agreement reported.
    Returns the launch counts of each counted run; above the per-dim bound
    the f32 decode's go to F32_WIDE_PATHS instead (the streamed f32 K1's
    path)."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        step as step_mod,
    )

    L = cfg.n_layers
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    params16 = step_mod._map(lambda t: t.detach().to(torch.bfloat16), params)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    svc = serving.GenerationService(cfg16, params16, prefill_window=0,
                                    device=DEV, name="wide")
    url, stop = _served(svc)
    body = {"prompt_ids": prompts.tolist(), "max_new_tokens": NEW}
    _zero(fa)  # the counted request
    try:
        t0 = time.perf_counter()
        got = json.loads(_http(url, "/v1/completions", body))
        wall = time.perf_counter() - t0
    finally:
        served = _counts(fa)  # read just after
        stop()
    _assert_completion("wide greedy", got, cfg.vocab_size)
    if served != {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"wide serving launches {served}, expected K1 "
                             f"{L} (one per-length prefill)")
    toks = prompts.to(DEV)
    with torch.inference_mode():
        first = llama.apply(cfg16, params16, toks)[:, -1].argmax(-1)
        dense16 = generate.generate(
            dataclasses.replace(cfg16, attn_impl="dense"), params16, toks,
            NEW, device=DEV)[:, PROMPT:]
    if first.tolist() != [r[0] for r in got["completion_ids"]]:
        raise AssertionError("wide serving: first greedy token differs from "
                             "argmax of llama.apply")
    # bf16: flash and dense round P and O at different points, so a near
    # tie may decode apart; the agreement is reported, exactness is held
    # in f32 below
    agree = (torch.tensor(got["completion_ids"], device=DEV)
             == dense16).float().mean().item()
    _log(f"wide heads serving d{cfg.head_dim}: {wall * 1e3:.1f} ms for "
         f"{BATCH} x ({PROMPT} + {NEW}) tokens over HTTP, launches {served} "
         f"(K1 {L} per per-length prefill); first tokens = llama.apply's; "
         f"greedy tokens equal to the dense path's: {agree:.4f}")
    short = toks[:2, :256]
    paths = {"serving": served}
    if cfg.head_dim > PER_DIM_MAX:
        paths["greedy bf16"] = _wide_greedy_bf16(cfg16, params16, short, fa)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _zero(fa)  # the counted f32 decode
    with torch.inference_mode():
        flash = generate.generate(cfg32, params, short, 16, device=DEV)
        decoded = _counts(fa)
        dense = generate.generate(dataclasses.replace(cfg32,
                                                      attn_impl="dense"),
                                  params, short, 16, device=DEV)
    if decoded != {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"f32 greedy launches {decoded}, expected K1 "
                             f"{L}")
    if not torch.equal(flash, dense):
        raise AssertionError("wide f32 greedy tokens: flash differs from "
                             "dense")
    _log(f"wide heads greedy f32 (b 2, 256 + 16, d{cfg.head_dim}): flash "
         f"equals dense token for token, K1 {decoded['flash_fwd']}")
    if cfg.head_dim > PER_DIM_MAX:
        F32_WIDE_PATHS[f"greedy f32 d{cfg.head_dim}"] = {
            "flash_fwd": decoded["flash_fwd"]}
    else:
        paths["greedy f32"] = decoded
    return paths


def _wide_greedy_bf16(cfg16, params16, toks, fa) -> dict:
    """Above the per-dim bound: greedy bf16 decoding through K1 (once per
    layer, counted), ``llama.apply``'s logits with flash against dense
    attention
    within APPLY_ATOL["bf16"] (the two round P and O at different points,
    so a near tie may decode apart: the tokens' agreement is reported).
    Returns the counted launches."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
    )

    L = cfg16.n_layers
    dense_cfg = dataclasses.replace(cfg16, attn_impl="dense")
    _zero(fa)  # the counted bf16 decode
    with torch.inference_mode():
        flash = generate.generate(cfg16, params16, toks, 16, device=DEV)
        decoded = _counts(fa)
        dense = generate.generate(dense_cfg, params16, toks, 16, device=DEV)
        logits = llama.apply(cfg16, params16, toks).float()
        want = llama.apply(dense_cfg, params16, toks).float()
    if decoded != {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"bf16 greedy launches {decoded}, expected K1 "
                             f"{L}")
    err = float((logits - want).abs().max())
    if not (torch.isfinite(logits).all() and err <= APPLY_ATOL["bf16"]):
        raise AssertionError(f"wide bf16 logits: flash differs from dense "
                             f"by {err:.3e} (atol {APPLY_ATOL['bf16']})")
    agree = (flash == dense).float().mean().item()
    _log(f"wide heads greedy bf16 (b 2, 256 + 16, d{cfg16.head_dim}): K1 "
         f"{decoded['flash_fwd']}, llama.apply "
         f"logits flash against dense max abs err {err:.3e} (atol "
         f"{APPLY_ATOL['bf16']}), greedy tokens equal to the dense path's: "
         f"{agree:.4f}")
    return decoded


def policy_journal(n: int, seed: int) -> list[dict]:
    """``n`` sched-journal/v1 placement rows as the scheduler journals
    them: random occupancy of POLICY_POOLS, a demand from POLICY_DEMANDS,
    the feasible pools by the reconciler's rule (a multi-host demand takes
    an empty pool with enough hosts; a one-host demand, free chips in a
    pool whose hosts hold that many) and the best-fit choice among them
    (least leftover, then name). States with no feasible pool are not
    placements and are drawn again."""
    rng = np.random.default_rng(seed)
    shapes = {f"pool-{i:02d}": shape for i, shape in enumerate(POLICY_POOLS)}
    total = {p: hosts * chips for p, (hosts, chips) in shapes.items()}
    rows = []
    while len(rows) < n:
        used = {p: 0 if rng.random() < 0.3 else int(rng.integers(0, t + 1))
                for p, t in total.items()}
        chips, hosts = POLICY_DEMANDS[int(rng.integers(len(POLICY_DEMANDS)))]
        if hosts > 1:
            feasible = [p for p, (h, _) in shapes.items()
                        if h >= hosts and used[p] == 0]
        else:
            feasible = [p for p, (_, c) in shapes.items()
                        if c >= chips and total[p] - used[p] >= chips]
        if not feasible:
            continue
        pool = min(feasible, key=lambda p: (total[p] - used[p] - chips, p))
        rows.append({"kind": "placement",
                     "key": f"notebooks/u{len(rows) % 8}/nb-{len(rows)}",
                     "attrs": {
            "schema": "sched-journal/v1", "pool": pool, "chips": chips,
            "time_to_placement_s": float(rng.exponential(2.0)),
            "free_chips": {p: total[p] - used[p] for p in sorted(total)},
            "total_chips": dict(sorted(total.items())),
            "feasible": sorted(feasible), "demand_chips": chips,
            "demand_hosts": hosts,
            "slice_class": "multi-host" if hosts > 1 else "single-host",
            "queue_depth": int(rng.integers(0, 80)), "policy": "best_fit",
        }})
    return rows


def phase_policy() -> dict:
    """The placement-policy trainer on the card: a POLICY_ROWS journal
    written to JSONL and read back through the port's ``features``; the
    CLI (``policy.train.main``) at its defaults and at batch 4096, each
    with step ms, steps/s, launches per step and idle share; the card's
    run held to the CPU's (POLICY_TOL), a resume at POLICY_RESUME_AT bit
    for bit, the checkpoint's layout, and ``choose_index`` over every
    example; then the torchrun launch ``controlplane/gpu.py`` configures.
    Returns the step timings by batch."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        features,
        train as ptrain,
    )

    shutil.rmtree(POLICY_DIR, ignore_errors=True)
    POLICY_DIR.mkdir(parents=True)
    try:
        journal = POLICY_DIR / "journal.jsonl"
        t0 = time.perf_counter()
        with open(journal, "w") as f:
            for row in policy_journal(POLICY_ROWS, seed=0):
                f.write(json.dumps(row) + "\n")
        data = features.dataset(features.load_journal_jsonl(str(journal)))
        n = int(data["label"].shape[0])
        if n != POLICY_ROWS or data["dropped"]:
            raise AssertionError(f"policy journal: {n} examples, "
                                 f"{data['dropped']} dropped")
        _log(f"policy: {n} placement rows over {len(POLICY_POOLS)} pools "
             f"({journal.stat().st_size / 2**20:.1f} MiB of JSONL), "
             f"written and featurized in {time.perf_counter() - t0:.1f} s")
        timings = {}
        for batch in POLICY_BATCHES:
            workdir = POLICY_DIR / f"cli-b{batch}"
            args = ["--journal", str(journal), "--workdir", str(workdir)]
            if batch != 64:
                args += ["--batch-size", str(batch)]
            if DEV == "cpu":  # the rehearsal; the card is the default
                args += ["--device", "cpu"]
            t0 = time.perf_counter()
            ptrain.main(args)
            wall = time.perf_counter() - t0
            if ptrain.latest_step(str(workdir)) != POLICY_STEPS:
                raise AssertionError(f"policy CLI b{batch}: no checkpoint "
                                     f"at step {POLICY_STEPS}")
            timings[batch] = _policy_step_time(data, batch)
            t = timings[batch]
            _log(f"policy CLI batch {batch}: {POLICY_STEPS} steps in "
                 f"{wall:.2f} s (host clock, journal load included); step "
                 f"{t['step_ms']:.4f} ms (CUDA events, mean of "
                 f"{POLICY_TIMED} after {POLICY_WARMUP}), "
                 f"{1e3 / t['step_ms']:.1f} steps/s; per step "
                 f"{t['kernels']} kernels + {t['copies']} copies/fills, "
                 f"idle share {t['idle']} (profile of {POLICY_PROFILED} "
                 "steps)")
        _policy_checks(data, POLICY_DIR / "cli-b64" / ptrain.CKPT_FILE)
        _torchrun_binding()
    finally:
        shutil.rmtree(POLICY_DIR, ignore_errors=True)
    return timings


def _policy_step_time(data: dict, batch: int) -> dict:
    """The CLI loop's step (``make_policy_step`` on ``batch_at``'s rows),
    timed by CUDA events after a warm-up, then profiled: device kernels
    and copies per step, and the idle share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        model,
        train as ptrain,
    )
    from service_account_auth_improvements_tpu_torch.train.step import (
        make_optimizer,
    )

    opt = make_optimizer(learning_rate=1e-2, weight_decay=0.0)
    params = model.init_params(generator=torch.Generator().manual_seed(0),
                               device=DEV)
    state = ptrain.PolicyState(0, params, opt.init(params))
    step = ptrain.make_policy_step(opt)
    on_dev = ptrain.device_dataset(data, torch.device(DEV))

    def run(first, count):
        nonlocal state
        for i in range(first, first + count):
            state, _ = step(state, ptrain.batch_at(on_dev, 0, i, batch))

    run(0, POLICY_WARMUP)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(POLICY_WARMUP, POLICY_TIMED)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / POLICY_TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(POLICY_WARMUP + POLICY_TIMED, POLICY_PROFILED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    return {
        "step_ms": step_ms,
        "kernels": (sum(e.count for e in device)
                    - sum(e.count for e in copies)) / POLICY_PROFILED,
        "copies": sum(e.count for e in copies) / POLICY_PROFILED,
        "idle": (round(1 - busy_ms / wall_ms, 4) if busy_ms
                 else "not measured (the profiler saw no device time)"),
    }


def _policy_checks(data: dict, cli_ckpt: Path) -> None:
    """The CLI's batch-64 checkpoint against the same run with its loss
    read every step (bit for bit: the host syncs change nothing), that
    run against the port's CPU run (POLICY_TOL), a run stopped at
    POLICY_RESUME_AT and resumed (bit for bit), the checkpoint's keys,
    shapes and dtypes, and ``choose_index`` over every example."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        model,
        train as ptrain,
    )

    cli = ptrain.load_checkpoint(str(cli_ckpt))
    card, card_hist = ptrain.fit_policy(data, log_every=1, device=DEV)
    cpu, cpu_hist = ptrain.fit_policy(data, log_every=1, device="cpu")
    for k in model.PARAM_KEYS:
        if not np.array_equal(card.params[k].cpu().numpy(),
                              cli["params"][k]):
            raise AssertionError(f"policy: fit_policy's {k} differs from "
                                 "the CLI's checkpoint")
    loss_err = max(abs(a["loss"] - b["loss"])
                   for a, b in zip(card_hist, cpu_hist, strict=True))
    if loss_err > POLICY_TOL["loss"]:
        raise AssertionError(f"policy losses card vs CPU: {loss_err}")
    errs = {}
    for k in model.PARAM_KEYS:
        got, want = card.params[k].cpu(), cpu.params[k]
        errs[k] = float((got - want).abs().max())
        if k != "b3":
            torch.testing.assert_close(got, want, atol=POLICY_TOL["atol"],
                                       rtol=POLICY_TOL["rtol"])
    feats, glob, mask = (torch.as_tensor(data[k]) for k in (
        "pool_feats", "glob", "mask"))
    with torch.no_grad():
        probs = [torch.softmax(model.forward(
            {k: v.cpu() for k, v in p.items()}, feats, glob, mask), -1)
            [mask] for p in (card.params, cpu.params)]
    probs_err = float((probs[0] - probs[1]).abs().max())
    if probs_err > POLICY_TOL["probs"]:
        raise AssertionError(f"policy probabilities card vs CPU: "
                             f"{probs_err}")
    _log(f"policy card vs CPU after {POLICY_STEPS} steps: losses "
         f"{loss_err:.3e} (of {len(card_hist)}), params "
         f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (b3 held "
         f"through the probabilities), probabilities {probs_err:.3e}; "
         f"tolerances {POLICY_TOL}; final loss card "
         f"{card_hist[-1]['loss']:.6f}")
    resume_dir = str(POLICY_DIR / "resume")
    ptrain.fit_policy(data, steps=POLICY_RESUME_AT, workdir=resume_dir,
                      log_every=0, device=DEV)
    resumed, _ = ptrain.fit_policy(data, workdir=resume_dir, log_every=0,
                                   device=DEV)
    pairs = [("count", resumed.opt_state.count, card.opt_state.count)]
    for what in ("params", "mu", "nu"):
        a = (resumed.params if what == "params"
             else getattr(resumed.opt_state, what))
        b = card.params if what == "params" else getattr(card.opt_state,
                                                         what)
        pairs += [(f"{what}/{k}", a[k], b[k]) for k in model.PARAM_KEYS]
    for name, a, b in pairs:
        if not (a == b if isinstance(a, int) else torch.equal(a, b)):
            raise AssertionError(f"policy resume at {POLICY_RESUME_AT}: "
                                 f"{name} differs from the straight run")
    _log(f"policy: stopped at {POLICY_RESUME_AT} and resumed to "
         f"{POLICY_STEPS}, params, mu, nu and count bit-equal to the "
         "straight run on the card")
    _policy_checkpoint_layout(cli_ckpt)
    params = model.params_from_numpy(cli["params"], DEV)
    on_dev = [torch.as_tensor(data[k]).to(DEV) for k in (
        "pool_feats", "glob", "mask", "label")]
    idx, _, conf = model.choose_index(params, *on_dev[:3])
    chosen = on_dev[2].gather(-1, idx.clamp_min(0)[:, None])[:, 0]
    if not (bool((idx >= 0).all()) and bool(chosen.all())
            and bool(((conf > 0) & (conf <= 1)).all())):
        raise AssertionError("policy: choose_index named a masked pool")
    agree = float((idx == on_dev[3]).float().mean())
    _log(f"policy: choose_index over all {idx.numel()} examples on the "
         f"card named a feasible pool every time; it picks the logged "
         f"best-fit pool on {agree:.4f} of them")


def _policy_checkpoint_layout(path: Path) -> None:
    """``policy.npz``: 4 header fields, 6 params and 13 optimizer leaves
    (the int32 count, then mu and nu in sorted key order), as the
    reference writes it."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        model,
        train as ptrain,
    )

    h = model.DEFAULT_HIDDEN
    shapes = {"w1": (model.IN_FEATURES, h), "b1": (h,), "w2": (h, h),
              "b2": (h,), "w3": (h, 1), "b3": (1,)}
    want = {"schema": ("<U20", ()), "journal_schema": ("<U16", ()),
            "step": ("int64", ()), "hidden": ("int64", ()),
            **{f"param/{k}": ("float32", s) for k, s in shapes.items()},
            "opt/0": ("int32", ())}
    for i, k in enumerate(ptrain.LEAF_ORDER * 2, start=1):
        want[f"opt/{i}"] = ("float32", shapes[k])
    with np.load(path) as z:
        got = {k: (str(z[k].dtype), z[k].shape) for k in z.files}
    if got != want:
        raise AssertionError(f"policy.npz layout {got}, expected {want}")
    _log(f"policy.npz: {len(got)} arrays (4 header, 6 params, 13 optimizer "
         "leaves), keys, shapes and dtypes as the reference writes them")


def _torchrun_binding() -> None:
    """``torch.distributed.run`` with exactly the env ``gpu.worker_env``
    gives a one-card notebook (the downward API's node rank 0), running
    the training CLI: its process group is NCCL, world 1, on card 0 (gloo
    on the CPU when ``DEV`` is ``"cpu"``), rank 0 logs, the losses are
    finite."""
    from service_account_auth_improvements_tpu_torch.controlplane import (
        gpu,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        multihost,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    resolved = gpu.resolve({"type": "h100", "count": 1})
    pod_env = {e["name"]: e.get("value", "0")  # the pod index of pod 0
               for e in gpu.worker_env("nb", "nb-hl", "default", resolved,
                                       port=port)}
    env = {k: v for k, v in os.environ.items()
           if k not in multihost.TORCHRUN_ENV and not k.startswith("TPU_")}
    env.update(pod_env, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "1", "-m", f"{PKG}.train.loop", "--preset",
           "smoke", "--dp", "1", "--steps", "2", "--log-every", "1"]
    if DEV == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:  # torchrun and the rank it started, whatever happened
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun launch failed ({proc.returncode}): "
                             f"{err[-3000:]}")
    group = ("process group nccl: rank 0 of 1 on cuda:0" if DEV == "cuda"
             else "process group gloo: rank 0 of 1 on cpu")
    losses = [float(x) for x in re.findall(r"step \d+/2 loss=(\S+)", out)]
    if group not in out or len(losses) != 2 or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"torchrun launch: expected {group!r} and two "
                             f"finite losses, got:\n{out[-3000:]}")
    _log(f"torchrun binding: {' '.join(cmd[1:8])} ... with "
         f"{sorted(pod_env.items())}: {group}, losses {losses}, "
         f"{time.perf_counter() - t0:.1f} s")


def wide_kernel_entries(numbers: dict, wide: dict, designs: dict) -> list:
    """The wide head dims' ``kernels`` entries (phase 12), one per kernel
    and dim, from phase 3's numbers (``numbers[kernel]["wide"][label]``),
    phase 12's launches per path (``wide[d][path][kernel]``) and
    ``phase_wide_designs``' (``designs[d][kernel]``): wherever the two
    builds run different kernels (K1, K2 and K3 at d 192, 256, 384 and
    512) the other design's numbers beside the shipped one's, K2's and
    K3's with the pair's sum beside SDPA's backward; above the per-dim bound
    the streamed kernel (``source`` csrc/flash_wide.cu) and its recompute
    factor (bf16's: the f32 ones are ``wide_f32_kernel_entries``'), K3's
    with both its designs in turns at F32_CLUSTER_DIMS; the
    kernel-only dims (no model, so no launches on a main
    path) under the entries of their kind: d 320 and 448 under d 512's,
    K2's and K3's with the kernel each ran (``designs[d][kernel]``; K1
    has the same design in both builds there, so phase_wide_designs does
    not time it) and, K3's, both designs in turns, the streamed ones
    under d 768's."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    streamed = ("kernel", "recompute")
    under = {512: [label for label, (_, _, d) in KERNEL_ONLY_HEADS.items()
                   if d <= PER_DIM_MAX],
             768: [label for label, (_, _, d) in KERNEL_ONLY_HEADS.items()
                   if d > PER_DIM_MAX]}
    entries = []
    for label, (_, _, d) in WIDE_HEADS.items():
        for name, (src, _, line) in KERNELS.items():
            n = numbers[name]["wide"][label]
            these = (*keys, *streamed) if d > PER_DIM_MAX else keys
            by_path = {path: counts[name] for path, counts in wide[d].items()}
            entry = {
                "name": f"{name} d{d}",
                "route": "cuda",
                "source": f"{PKG}/csrc/"
                          + (f"{WIDE_SOURCE}.cu" if d > PER_DIM_MAX else src),
                "replaces": "service_account_auth_improvements_tpu/ops/"
                            f"flash_attention.py:{line}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                **{key: n[key] for key in these},
            }
            if "pair_ms" in n:
                entry["pair_ms"] = n["pair_ms"]
            both = designs.get(d, {}).get(name)
            if d > PER_DIM_MAX and name in WIDE_GROUPS:
                # the streamed K3's two designs at F32_CLUSTER_DIMS
                entry["designs_in_turns"] = {
                    f"d{dim}": designs[dim][name] for dim in F32_CLUSTER_DIMS}
            elif both and both["shipped_kernel"] != both["other_kernel"]:
                entry["designs_in_turns"] = both
            if d in under:
                entry["more_shapes"] = {
                    other: {key: numbers[name]["wide"][other][key]
                            for key in these}
                    for other in under[d]}
            # the kernel each split dim ran where phase_wide_designs timed
            # it (K2 and K3; K1 only where the builds differ), and both
            # designs in turns where they differ (K3's pair at d 320, 448)
            for other in under.get(d, []) if d <= PER_DIM_MAX else []:
                turns = designs[KERNEL_ONLY_HEADS[other][2]].get(name)
                if turns is None:
                    continue
                shape = entry["more_shapes"][other]
                shape["kernel"] = turns["shipped_kernel"]
                if turns["shipped_kernel"] != turns["other_kernel"]:
                    shape["designs_in_turns"] = turns
            entries.append(entry)
    return entries


def wide_f32_kernel_entries(numbers: dict, paths: dict, designs: dict,
                            ptxas: dict) -> list:
    """The streamed f32 kernels' ``kernels`` entries (flash_fwd_wide_f32,
    dq_wide_f32, dkv_wide_f32; ``source`` csrc/flash_wide.cu), one per
    kernel, from phase 3's numbers at b 2 s 1000 (``numbers[kernel]
    ["f32_wide"][label]``: bench_800m_d768's heads as the entry's, the
    kernel-only dims under ``more_shapes``), each with its kernel, recompute
    factor and cluster, its registers and spills (``ptxas[("shipped",
    template)]``, phase 2), and the launches of each path that runs it
    (``paths[path][kernel]``: phase 12's d 768 flash against dense f32
    step, K1 also its f32 greedy decode). Each carries its design and the
    clusters a card holds, and both designs in turns at F32_CLUSTER_DIMS
    (``designs["streamed"][d][kernel]``, ``phase_f32_designs``); K2's and
    K3's the pair's sum. Raises if a path launched none of a kernel."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share",
            "kernel", "recompute", "cluster")
    (label,) = [name for name, (_, _, d) in WIDE_HEADS.items()
                if d > PER_DIM_MAX]
    d = WIDE_HEADS[label][2]
    entries = []
    for name, (_, _, line) in KERNELS.items():
        by_path = {path: counts[name] for path, counts in paths.items()
                   if name in counts}
        if not by_path or not all(by_path.values()):
            raise AssertionError(f"{name} f32 streamed: a path launched no "
                                 f"kernel: {by_path}")
        n = numbers[name]["f32_wide"]
        these = keys if name == "flash_fwd" else (*keys, "pair_ms")
        built = ptxas["shipped", n[label]["kernel"].split("<")[0]]
        entry = {
            "name": f"{name} f32 d{d}",
            "route": "cuda",
            "source": f"{PKG}/csrc/{WIDE_SOURCE}.cu",
            "replaces": "service_account_auth_improvements_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: n[label][key] for key in these},
            "registers": built["registers"],
            "spill_stores": built["spill_stores"],
            "more_shapes": {other: {key: n[other][key] for key in these}
                            for other in n if other != label},
        }
        turns = designs["streamed"]
        entry.update(design=turns[d][name]["shipped_design"],
                     clusters_a_card=turns[d][name]["shipped_clusters"],
                     designs_in_turns={f"d{dim}": turns[dim][name]
                                       for dim in turns})
        entries.append(entry)
    return entries


def d64_kernel_entries(numbers: dict, paths: dict, designs: dict) -> list:
    """K1's, K2's and K3's ``kernels`` entries at d 64, naming the kernels
    that ship there (``designs[64][kernel]["shipped_kernel"]``), from
    phase 3's numbers at DESIGN_SHAPES[64] (``numbers[kernel]
    ["more_shapes"]``, with d 64's own largest error), the launches of the
    paths that run them at d 64 (``paths[path]``: phase 8's distillation
    student; K1's under ``"flash_fwd d64"``, the paths' K1 launches at
    d 64 alone) and ``phase_wide_designs``' (``designs[64][kernel]``: both
    designs in turns, K1 beside SDPA's forward, the pair beside SDPA's
    backward). Raises if a path launched none."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    b, s, h, hkv = DESIGN_SHAPES[64]
    shape = f"b{b} s{s} h{h} hkv{hkv} d64 bf16 causal"
    entries = []
    for name, (src, _, line) in KERNELS.items():
        counted = "flash_fwd d64" if name == "flash_fwd" else name
        by_path = {path: counts[counted] for path, counts in paths.items()}
        if not by_path or not all(by_path.values()):
            raise AssertionError(f"{name} d64: a path launched no kernel: "
                                 f"{by_path}")
        n = numbers[name]["more_shapes"][shape]
        these = keys if name == "flash_fwd" else (*keys, "pair_ms")
        entries.append({
            "name": f"{name} d64",
            "kernel": designs[64][name]["shipped_kernel"],
            "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": "service_account_auth_improvements_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "shape": shape,
            **{key: n[key] for key in these},
            "designs_in_turns": designs[64][name],
        })
    return entries


def f32_kernel_entries(numbers: dict, designs: dict, paths: dict) -> list:
    """K1's, K2's and K3's f32 ``kernels`` entries (flash_fwd_f32, dq_f32,
    dkv_f32), from phase 3's numbers at F32_SHAPES
    (``numbers[kernel]["f32"][label]``: the first shape's as the entry's,
    the others under ``more_shapes``), ``phase_f32_designs``'
    (``designs[label][kernel]``, the designs timed in turns) and the f32
    launches of each path (``paths[path][kernel]``). K2's and K3's carry
    the pair's sum. Raises if a path launched none of a kernel."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    first, *rest = F32_SHAPES
    entries = []
    for name, (src, _, line) in KERNELS.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        if not by_path or not all(by_path.values()):
            raise AssertionError(f"{name} f32: a path launched no kernel: "
                                 f"{by_path}")
        n = numbers[name]["f32"]
        these = keys if name == "flash_fwd" else (*keys, "pair_ms")
        entries.append({
            "name": f"{name} f32",
            "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": "service_account_auth_improvements_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: n[first][key] for key in these},
            "more_shapes": {label: {key: n[label][key] for key in these}
                            for label in rest},
            "designs_in_turns": {label: designs[label][name]
                                 for label in F32_SHAPES if label in designs},
        })
    return entries


def main() -> int:
    # full f32 products everywhere (no TF32), as the f32 checks assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    _timed("build", phase_build)
    numbers = {"flash_fwd": _timed("kernels K1", phase_kernels),
               **_timed("kernels K2 and K3", phase_bwd_kernels)}
    designs = _timed("kernels d 64 to 512 designs", phase_wide_designs)
    f32_designs = _timed("kernels f32 designs", phase_f32_designs)
    # the f32 backward's launches on the paths below
    F32_PATHS.clear()
    F32_WIDE_PATHS.clear()
    serving = _timed("serving", phase_serving)
    training = _timed("training", phase_training)
    lifecycle = phase_lifecycle()
    moe = phase_moe()
    finetune = phase_finetune()
    phase_side_models()
    parallel = phase_parallel()
    parallel.update(phase_parallel2())
    wide = _timed("wide heads", phase_wide_heads)
    _timed("policy", phase_policy)
    _log(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, _, line) in KERNELS.items():
        n = numbers[name]
        by_path = {"serving": serving.get(name, 0),
                   "training": training["launches"][name],
                   **{path: counts.get(name, 0)
                      for path, counts in {**lifecycle, **moe,
                                           **finetune,
                                           **parallel}.items()}}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": "service_account_auth_improvements_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "shape": f"b{TRAIN_BATCH} s{TRAIN_SEQ} h12 hkv4 d128 bf16 "
                     "causal",
            "max_abs_err": n["max_abs_err"],
            "ms": n["ms"],
            "plain_ms": n["plain_ms"],
            "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"],
            "library_ms": n["library_ms"],
            "tflops": n["tflops"],
            "bound_share": n["bound_share"],
            "more_shapes": n["more_shapes"],
        })
    kernels += d64_kernel_entries(
        numbers, {"distill_8b_1b": finetune["distill_8b_1b"]}, designs)
    kernels += wide_kernel_entries(numbers, wide, designs)
    kernels += f32_kernel_entries(numbers, f32_designs, F32_PATHS)
    kernels += wide_f32_kernel_entries(numbers, F32_WIDE_PATHS, f32_designs,
                                       WIDE_PTXAS)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
