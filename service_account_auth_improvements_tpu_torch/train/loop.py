"""The training loop: data → step → checkpoint/resume → logs (port of
``train/loop.py``).

``fit`` runs ``make_train_step`` over deterministic ``TokenBatches`` on one
card, restores the latest checkpoint of its ``workdir`` if there is one,
checkpoints every ``ckpt_every`` steps (and at the end), evaluates held-out
batches every ``eval_every`` steps, and logs loss, tokens/s and MFU. A
culled or preempted notebook resumes exactly where it left off, data order
included. Runnable as a module: ``python -m
service_account_auth_improvements_tpu_torch.train.loop --preset bench_800m
--batch 8 --seq 2048 --steps 10 --workdir <dir>`` (on the card; add
``--device cpu`` only with a small preset).

``fit(lora=LoraConfig(...), base_params=...)`` fine-tunes adapters over
frozen base weights (``train/lora.py``): the checkpointed and resumed state
is the adapter tree.

``fit(cfg, mesh, ...)`` trains sharded over a ``parallel.make_mesh`` mesh,
one process per rank: every rank runs ``fit`` with the same arguments,
rank 0 alone logs and writes checkpoints. The CLI's ``--dp/--pp/--fsdp/
--sp/--tp/--ep`` flags start the process group from the controller's env
(``parallel.multihost.maybe_initialize``) and build that mesh; launch one
process per rank with ``TPU_WORKER_ID`` and ``TPU_WORKER_HOSTNAMES`` set,
or under torchrun (``python -m torch.distributed.run --nnodes N
--nproc-per-node C -m service_account_auth_improvements_tpu_torch.train.loop
...``, with the ``PET_*`` env ``controlplane/gpu.py`` gives an H100 pod).
Unlike the reference's CLI, which always builds a mesh, it builds one
only when the flags' product or the env asks for more than one process,
so a one-card run keeps the plain path. ``fit(mesh=, lora=)`` fine-tunes
sharded adapters over the base laid out by the model's rules.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import (
    multihost,
    sharding,
)
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    MESH_AXES,
    MeshConfig,
    check_mesh,
    make_mesh,
)
from service_account_auth_improvements_tpu_torch.train import (
    checkpoint as ckpt,
    evaluate,
    lora as lora_mod,
)
from service_account_auth_improvements_tpu_torch.train.data import (
    DataConfig,
    RowShard,
    TokenBatches,
)
from service_account_auth_improvements_tpu_torch.train.mfu import (
    chip_peak_flops,
    mfu,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    _leaves,
    _map,
    init_train_state,
    make_optimizer,
    make_train_step,
    shard_state,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


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
    """Train until ``loop.steps`` optimizer steps on ``device`` (the card
    unless ``"cpu"``); returns (state, history).

    Resume: if ``loop.workdir`` holds a checkpoint, its state is restored
    into a fresh init's tensors and training continues from its step; the
    batches are pure in the step, so the run equals one that never
    stopped. Otherwise training starts from a fresh init (seed 0).

    ``eval_data``: held-out batches (tokens, or (tokens, mask) pairs);
    with ``loop.eval_every`` set, a perplexity eval runs on that cadence
    and lands in history as ``eval_loss``/``eval_perplexity`` records
    (without it, ``eval_data`` is ignored, as in the reference).

    ``lora`` (a ``train.lora.LoraConfig``) switches to adapter-only
    fine-tuning over frozen ``base_params`` (on ``device``): the state,
    its checkpoints and its resume are the adapter tree, so a culled
    notebook resumes a fine-tune from a few-MB checkpoint; evaluation runs
    on the merged params. The default optimizer then has no weight
    decay.

    History records carry ``step``, ``loss``, ``tokens_per_sec`` and, on
    a card with a known peak and outside LoRA mode (frozen-weight
    backprop skips the dW FLOPs the estimate counts), ``mfu``. The clock
    starts after the first
    step, which carries the kernel builds and library warm-up; a record
    logged before any later step has finished times that first step. Eval
    and checkpoint writes are kept out of the clock: tokens/s and MFU
    describe train steps.

    ``mesh`` (a ``parallel.make_mesh`` mesh, on ``device``'s type) trains
    sharded: every rank calls ``fit`` alike, draws the same init and lays
    it out by the rules, reads its rows of each batch, and rank 0 alone
    logs and writes checkpoints (a collective save). ``eval_data`` batches
    are global; each rank evaluates its rows. As in the reference,
    tokens/s counts the whole mesh's tokens and MFU divides by its
    chips."""
    if lora is not None and base_params is None:
        raise ValueError("lora fit requires base_params")
    dev = resolve_device(device)
    if mesh is not None:
        if check_mesh(mesh).device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                             f"{dev}")
        if torch.distributed.get_rank():
            log = _quiet
    if optimizer is None:
        optimizer = (make_optimizer(weight_decay=0.0) if lora is not None
                     else make_optimizer())
    data = TokenBatches(tokens, data_cfg, mesh=mesh, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if lora is not None:
        state = lora_mod.init_lora_state(cfg, lora, gen, optimizer,
                                         device=dev)
        if mesh is not None:
            state = shard_state(mesh, cfg, state, axes_tree=(
                lora_mod.lora_logical_axes(cfg, lora)))
            if not any(sharding.is_dtensor(t)
                       for _, t in _leaves(base_params)):
                base_params = sharding.tree_distribute(
                    base_params, mesh, llama.logical_axes(cfg))
    else:
        state = init_train_state(cfg, gen, optimizer, device=dev)
        if mesh is not None:
            state = shard_state(mesh, cfg, state)
    start = 0
    if loop.workdir is not None and ckpt.latest_step(loop.workdir) is not None:
        t = time.perf_counter()
        state = ckpt.restore(
            loop.workdir, mesh, cfg, state,
            axes_tree=(None if lora is None
                       else lora_mod.lora_logical_axes(cfg, lora)))
        start = state.step
        log(f"resumed from step {start} (restored in "
            f"{time.perf_counter() - t:.2f} s)")
    packed = data_cfg.eos_id is not None
    if lora is not None:
        # packed corpora train with the boundary loss mask only (the
        # adapter step has no segment-masked attention path)
        lora_step = lora_mod.make_lora_train_step(
            cfg, lora, optimizer=optimizer, mesh=mesh, packed=packed)

        def step_fn(state, batch, mask):
            return lora_step(state, base_params, batch, mask)
    else:
        step_fn = make_train_step(
            cfg, optimizer=optimizer, mesh=mesh, packed=packed,
            # segment-masked attention is a dense-impl feature; flash
            # windows train with the boundary loss mask only
            segment_eos_id=(data_cfg.eos_id
                            if packed and cfg.attn_impl == "dense"
                            else None),
        )
    eval_step = None
    if loop.eval_every and eval_data is not None:
        eval_step = evaluate.make_eval_step(cfg, mesh=mesh, packed=packed)
        # the eval set is iterated at every cadence: a generator would be
        # exhausted after the first eval
        eval_data = list(eval_data)
        if mesh is not None:
            eval_data = [_my_rows(b, mesh, dev) for b in eval_data]
    peak = chip_peak_flops(dev)
    history = []
    tokens_per_step = data_cfg.batch * (data_cfg.seq - 1)
    t0 = timed_from = None
    t_first = time.perf_counter()

    def save():
        t = time.perf_counter()
        ckpt.save(loop.workdir, state)
        log(f"saved checkpoint step {state.step} in "
            f"{time.perf_counter() - t:.2f} s")

    for i in range(start, loop.steps):
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
            util = (None if lora is not None else mfu(
                cfg.flops_per_token(data_cfg.seq) * tokens_per_step,
                step_s, 1 if mesh is None else mesh.size(), peak))
            if util:
                rec["mfu"] = round(util, 4)
            history.append(rec)
            log(f"step {i + 1}/{loop.steps} loss={loss:.4f} "
                f"({step_s:.2f}s/step, {tok_s:,.0f} tok/s"
                + (f", mfu={rec['mfu']:.3f}" if "mfu" in rec else "")
                + ")")
        do_eval = eval_step is not None and (i + 1) % loop.eval_every == 0
        do_save = (loop.workdir is not None and loop.ckpt_every
                   and (i + 1) % loop.ckpt_every == 0)
        if do_eval or do_save:
            # the step's queued work finishes before the pause is timed
            metrics["loss"].item()
            t_pause = time.perf_counter()
            if do_eval:
                eval_params = state.params
                if lora is not None:
                    # merged block by block (the eval step takes local
                    # blocks as they are)
                    eval_params = lora_mod.merge_lora(
                        _map(sharding.to_local, base_params),
                        _map(sharding.to_local, state.params), lora)
                ev = evaluate.evaluate(cfg, eval_params, eval_data,
                                       step=eval_step, device=dev)
                del eval_params
                history.append({"step": i + 1,
                                "eval_loss": round(ev["loss"], 4),
                                "eval_perplexity": ev["perplexity"],
                                "eval_tokens": ev["tokens"]})
                log(f"step {i + 1}/{loop.steps} eval "
                    f"loss={ev['loss']:.4f} ppl={ev['perplexity']:.1f}")
            if do_save:
                save()
            t0 += time.perf_counter() - t_pause
    if (loop.workdir is not None and state.step > start
            and ckpt.latest_step(loop.workdir) != state.step):
        save()
    return state, history


def _quiet(*_) -> None:
    """The log of every rank but 0."""


def _my_rows(batch, mesh, dev):
    """A global eval batch (tokens, or (tokens, mask)) → this rank's rows
    of it, as the global batch's ``DTensor``s."""
    tokens, mask = (batch if isinstance(batch, (tuple, list))
                    else (batch, None))
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    mask = (torch.ones_like(tokens, dtype=torch.int32) if mask is None
            else torch.as_tensor(mask, device=dev))
    rows = RowShard(mesh, tokens.shape[0])
    return rows.shard(tokens), rows.shard(mask)


def main(argv=None) -> list:
    """The CLI; returns ``fit``'s history. With mesh-axis flags whose
    product, or with a rendezvous env (``TPU_WORKER_*`` or torchrun's)
    that asks for more than one process, it starts the process group and
    trains on a mesh; otherwise on one device, with no mesh. Under
    torchrun the group starts at any world size, and rank 0 logs it."""
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

    mesh = config = None
    sizes = {a: getattr(args, a) for a in MESH_AXES}
    plan = multihost.rendezvous_plan()
    if np.prod(list(sizes.values())) > 1 or plan.num_processes > 1:
        config = MeshConfig(**sizes)
        config.resolve(plan.num_processes)  # before any process starts
    if multihost.maybe_initialize(args.device) == 0 and (
            torch.distributed.is_initialized()):
        print(multihost.describe_group(), flush=True)
    if config is not None:
        mesh = make_mesh(config, args.device)
    cfg = llama.PRESETS[args.preset]
    # synthetic corpus sized for the run, as the reference's CLI makes it
    rng = np.random.default_rng(0)
    n = max(args.batch * args.seq * 4,
            args.batch * args.seq * (args.steps + 1) // 2)
    tokens = rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
    _, history = fit(cfg, mesh, tokens,
                     DataConfig(batch=args.batch, seq=args.seq),
                     LoopConfig(steps=args.steps, log_every=args.log_every,
                                workdir=args.workdir,
                                ckpt_every=args.ckpt_every),
                     device=args.device)
    return history


if __name__ == "__main__":
    main()
