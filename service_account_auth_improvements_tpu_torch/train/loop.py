"""The training loop: data → step → logs (port of ``train/loop.py``).

``fit`` runs ``make_train_step`` over deterministic ``TokenBatches`` on one
card and logs loss, tokens/s and MFU. Runnable as a module:
``python -m service_account_auth_improvements_tpu_torch.train.loop
--preset bench_800m --batch 8 --seq 2048 --steps 10`` (on the card; add
``--device cpu`` only with a small preset).

Not ported yet, and raising with their ROADMAP items when asked for:
checkpointing and resume (``workdir``, ``ckpt_every``) and periodic
evaluation (``eval_data``, ``eval_every``), queue 1 item 4; LoRA
fine-tuning (``lora``, ``base_params``), item 7; a mesh and the mesh-axis
flags, item 8.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.train.data import (
    DataConfig,
    TokenBatches,
)
from service_account_auth_improvements_tpu_torch.train.mfu import (
    chip_peak_flops,
    mfu,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    init_train_state,
    make_optimizer,
    make_train_step,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)

_CKPT_TODO = ("checkpointing, resume and evaluation are not ported yet "
              "(ROADMAP queue 1, item 4)")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    steps: int
    ckpt_every: int = 0          # 0 = only at the end
    log_every: int = 10
    workdir: str | None = None   # None = no checkpointing
    eval_every: int = 0          # 0 = no periodic eval (needs eval_data)


def fit(cfg: llama.LlamaConfig, mesh, tokens, data_cfg: DataConfig,
        loop: LoopConfig, optimizer=None, log=print, eval_data=None,
        lora=None, base_params=None, device=None):
    """Train for ``loop.steps`` optimizer steps from a fresh init (seed 0)
    on ``device`` (the card unless ``"cpu"``); returns (state, history).
    History records carry ``step``, ``loss``, ``tokens_per_sec`` and, on
    a card with a known peak, ``mfu``. The clock starts after the first
    step, which carries the kernel builds and library warm-up; a record
    logged before any later step has finished times that first step."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (mesh) is not ported yet (ROADMAP queue 1, "
            "item 8, \"parallel\")")
    if loop.workdir is not None or loop.ckpt_every:
        raise NotImplementedError(_CKPT_TODO)
    if eval_data is not None or loop.eval_every:
        raise NotImplementedError(_CKPT_TODO)
    if lora is not None or base_params is not None:
        raise NotImplementedError(
            "LoRA fine-tuning is not ported yet (ROADMAP queue 1, item 7)")
    dev = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    data = TokenBatches(tokens, data_cfg, device=dev)
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), optimizer,
        device=dev)
    packed = data_cfg.eos_id is not None
    step_fn = make_train_step(
        cfg, optimizer=optimizer, packed=packed,
        # segment-masked attention is a dense-impl feature; flash windows
        # train with the boundary loss mask only
        segment_eos_id=(data_cfg.eos_id
                        if packed and cfg.attn_impl == "dense" else None),
    )
    peak = chip_peak_flops(dev)
    history = []
    tokens_per_step = data_cfg.batch * (data_cfg.seq - 1)
    t0 = timed_from = None
    t_first = time.perf_counter()
    for i in range(loop.steps):
        batch, mask = data.masked_batch_at(i)
        state, metrics = step_fn(state, batch, mask)
        if t0 is None:
            # one sync after the first step: builds and warm-up stay out
            # of the throughput clock
            metrics["loss"].item()
            t0, timed_from = time.perf_counter(), i + 1
            t_first = t0 - t_first
        if loop.log_every and (i + 1) % loop.log_every == 0:
            loss = float(metrics["loss"])
            steps_timed = i + 1 - timed_from
            step_s = ((time.perf_counter() - t0) / steps_timed
                      if steps_timed else t_first)
            tok_s = tokens_per_step / step_s
            rec = {"step": i + 1, "loss": loss,
                   "tokens_per_sec": round(tok_s, 1)}
            util = mfu(cfg.flops_per_token(data_cfg.seq) * tokens_per_step,
                       step_s, 1, peak)
            if util:
                rec["mfu"] = round(util, 4)
            history.append(rec)
            log(f"step {i + 1}/{loop.steps} loss={loss:.4f} "
                f"({step_s:.2f}s/step, {tok_s:,.0f} tok/s"
                + (f", mfu={rec['mfu']:.3f}" if "mfu" in rec else "")
                + ")")
    return state, history


def main(argv=None) -> list:
    """The CLI; returns ``fit``'s history."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (small presets only)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    for axis in ("dp", "pp", "fsdp", "sp", "tp", "ep"):
        ap.add_argument(f"--{axis}", type=int, default=1)
    args = ap.parse_args(argv)

    if any(getattr(args, a) != 1 for a in ("dp", "pp", "fsdp", "sp", "tp",
                                           "ep")):
        raise NotImplementedError(
            "mesh axes are not ported yet (ROADMAP queue 1, item 8, "
            "\"parallel\")")
    cfg = llama.PRESETS[args.preset]
    # synthetic corpus sized for the run, as the reference's CLI makes it
    rng = np.random.default_rng(0)
    n = max(args.batch * args.seq * 4,
            args.batch * args.seq * (args.steps + 1) // 2)
    tokens = rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
    _, history = fit(cfg, None, tokens,
                     DataConfig(batch=args.batch, seq=args.seq),
                     LoopConfig(steps=args.steps, log_every=args.log_every,
                                workdir=args.workdir,
                                ckpt_every=args.ckpt_every),
                     device=args.device)
    return history


if __name__ == "__main__":
    main()
