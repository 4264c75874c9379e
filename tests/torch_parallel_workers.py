"""Rank processes of the port's multi-rank CPU tests (gloo).

``launch`` runs a function of this module in n spawned processes joined
by a gloo process group over a ``file://`` store (so parallel test
workers never race for a port), each with a bounded time. The functions
read their inputs from, and write their results to, the test's
directory; the tests compare those with the JAX package. Nothing here
imports JAX: a rank process has the port and numpy only.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

PORT = "service_account_auth_improvements_tpu_torch"


def _entry(rank, fn_name, world, out, init, args):
    torch.set_num_threads(1)
    if init:
        dist.init_process_group(
            "gloo", init_method=f"file://{out}/store-{init}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
    try:
        globals()[fn_name](rank, world, pathlib.Path(out), *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn_name: str, world: int, out, *args, init: bool = True,
           env: dict | None = None, timeout: float = 240.0) -> None:
    """Run ``fn_name(rank, world, out, *args)`` on ``world`` spawned
    ranks; raises if one fails or the whole takes over ``timeout`` s."""
    import torch.multiprocessing as mp

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        ctx = mp.start_processes(
            _entry, args=(fn_name, world, str(out),
                          uuid.uuid4().hex if init else "", args),
            nprocs=world, join=False, start_method="spawn")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn_name} on {world} ranks took over "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _save(out: pathlib.Path, name: str, obj) -> None:
    torch.save(obj, out / f"{name}.pt")


def load(path):
    """A file the test or a rank wrote (numpy arrays and python objects
    besides tensors)."""
    return torch.load(path, weights_only=False)


def _mesh(**sizes):
    from service_account_auth_improvements_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
    )

    return make_mesh(MeshConfig(**{"fsdp": 1, **sizes}), device="cpu")


def _dims(t):
    """Per mesh dimension, the tensor dimension a DTensor is split on
    there, or None."""
    return [p.dim if p.is_shard() else None for p in t.placements]


def _gather_tree(tree):
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        tree_map,
    )

    return tree_map(lambda t: sharding.full_tensor(t).detach().clone(),
                    tree)


# -- attention -----------------------------------------------------------

def attention(rank, world, out, names):
    """Ring and/or Ulysses (``names``), causal and not, on local sequence
    chunks of the q/k/v in ``qkv.pt``: outputs and gradients of
    sum(o * cos(o)), each rank saving its chunks; the DTensor entries'
    outputs; the Ulysses head-count error."""
    from service_account_auth_improvements_tpu_torch.parallel import (
        ring,
        sharding,
        ulysses,
    )

    mesh = _mesh(sp=world)
    group = mesh.get_group("sp")
    q, k, v = load(out / "qkv.pt")
    res = {}
    bodies = {"ring": ring.ring_attention_local,
              "ulysses": ulysses.ulysses_attention_local}
    entries = {"ring": ring.ring_attention,
               "ulysses": ulysses.ulysses_attention}
    for name in names:
        fn = bodies[name]
        for causal in (True, False):
            leaves = [sharding.shard_local(t, mesh, sharding.placements(
                mesh, (None, "sp", None, None))).clone().requires_grad_()
                for t in (q, k, v)]
            o = fn(*leaves, group=group, causal=causal)
            loss = (o * torch.cos(o)).sum()
            grads = torch.autograd.grad(loss, leaves)
            res[(name, causal)] = (o.detach(), *grads)
    for name in names:
        fn = entries[name]
        places = sharding.placements(mesh, (None, "sp", None, None))
        d = [sharding.distribute(t, mesh, places) for t in (q, k, v)]
        res[(name, "dtensor")] = fn(*d, causal=True).full_tensor()
    try:
        ulysses.ulysses_attention_local(q[:, :, :3], k[:, :, :1],
                                        v[:, :, :1], group=group)
    except ValueError as e:
        res["ulysses_error"] = str(e)
    _save(out, f"attention-r{rank}", res)


# -- training ------------------------------------------------------------

def train(rank, world, out, tag, mesh_sizes, cfg_kw, grad_accum):
    """Three ``make_train_step`` steps on a mesh from the state and
    batches in ``train-init.pt``; rank 0 saves the whole params and
    moments after each step, and every rank its losses and norms."""
    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        params as tparams,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import step

    init = load(out / "train-init.pt")
    cfg = llama.LlamaConfig(**cfg_kw)
    mesh = _mesh(**mesh_sizes)
    state = tparams.train_state_from_numpy(
        cfg, init["params"], init["mu"], init["nu"], device="cpu")
    state = step.shard_state(mesh, cfg, state)
    fn = step.make_train_step(cfg, mesh=mesh, grad_accum=grad_accum)
    batch = sharding.placements(mesh, sharding.logical_to_mesh(
        ("batch", None)))
    res = {"steps": []}
    for toks, mask in init["batches"]:
        state, m = fn(state, sharding.distribute(toks, mesh, batch),
                      sharding.distribute(mask, mesh, batch))
        res["steps"].append({
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _gather_tree(state.params),
            "mu": _gather_tree(state.opt_state.mu),
            "nu": _gather_tree(state.opt_state.nu),
            "count": state.opt_state.count, "step": state.step})
        assert isinstance(state.params["lm_head"], torch.Tensor)
    res["placements"] = {
        name: _dims(t)
        for name, t in step._leaves(state.params)}
    if rank == 0:
        _save(out, f"train-{tag}", res)
    _save(out, f"train-{tag}-loss-r{rank}",
          [s["loss"] for s in res["steps"]])


# -- data, placements, checkpoint, bootstrap -----------------------------

def batches(rank, world, out):
    """The rows ``TokenBatches(mesh=...)`` gives this rank over three
    steps, with its mesh coordinate, on a dp 2 x fsdp 2 mesh (world 4),
    and the same on dp 1 x sp 2 x tp 2 (sp and tp ranks share rows); and
    what ``shard_constraint`` makes of a replicated [8, 2] DTensor."""
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
        use_mesh,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
        TokenBatches,
    )

    tokens = np.arange(4096, dtype=np.int32) % 997
    res = {}
    for tag, sizes in (("dp2fsdp2", dict(dp=2, fsdp=2)),
                       ("sp2tp2", dict(sp=2, tp=2))):
        mesh = _mesh(**sizes)
        data = TokenBatches(tokens, DataConfig(batch=8, seq=16, seed=3),
                            mesh=mesh, device="cpu")
        rows = []
        for i in range(3):
            t = data.batch_at(i)
            rows.append((t.to_local().numpy().copy(), tuple(t.shape),
                         _dims(t)))
        res[tag] = {"coord": mesh.get_coordinate(), "rows": rows}
        # a replicated DTensor constrained to the batch layout
        whole = sharding.distribute(torch.arange(16.).reshape(8, 2), mesh,
                                    sharding.placements(mesh, ()))
        with use_mesh(mesh):
            held = sharding.shard_constraint(whole, ("batch", None))
        res[tag]["constraint"] = (_dims(held), held.to_local().numpy())
    # what the model's region refuses on a live mesh
    refused = {}
    for tag, sizes, rules in (
            ("batch-over-dp-only", dict(dp=2, fsdp=2),
             {**sharding.DEFAULT_RULES, "batch": "dp"}),
            ("heads-unsharded", dict(fsdp=2, tp=2),
             {k: v for k, v in sharding.DEFAULT_RULES.items()
              if k != "heads"}),
            ("embed-over-tp", dict(fsdp=2, tp=2),
             {**sharding.DEFAULT_RULES, "embed": "tp"}),
            ("pp", dict(pp=2, fsdp=2), None), ("ep", dict(ep=2, fsdp=2), None)):
        try:
            sharding.LocalRegion(_mesh(**sizes), rules)
        except (ValueError, NotImplementedError) as e:
            refused[tag] = f"{type(e).__name__}: {e}"
    res["refused"] = refused
    res["pure-dp-rules"] = sharding.LocalRegion(
        _mesh(dp=2, fsdp=2), {**sharding.DEFAULT_RULES, "embed": None}
    ).n_batch
    _save(out, f"batches-r{rank}", res)


def fit_restore(rank, world, out, cfg_kw):
    """``fit`` on dp 2 x fsdp 2 for 3 steps into ``out/run`` with a
    checkpoint at step 2 and the end and an eval at step 3; then its last
    step restored onto an fsdp 2 x tp 2 mesh, state and params only, each
    rank saving what it holds, whole."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint as ckpt,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )
    from service_account_auth_improvements_tpu_torch.train.loop import (
        LoopConfig,
        fit,
    )

    cfg = llama.LlamaConfig(**cfg_kw)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 4096).astype(np.int32)
    lines = []
    state, history = fit(cfg, _mesh(dp=2, fsdp=2), tokens,
                         DataConfig(batch=4, seq=32),
                         LoopConfig(steps=3, ckpt_every=2, log_every=1,
                                    eval_every=3, workdir=str(out / "run")),
                         log=lines.append, device="cpu",
                         eval_data=[tokens[:128].reshape(4, 32)])
    fitted = {"params": _gather_tree(state.params),
              "mu": _gather_tree(state.opt_state.mu),
              "nu": _gather_tree(state.opt_state.nu)}
    mesh = _mesh(fsdp=2, tp=2)
    like = step.shard_state(mesh, cfg, step.init_train_state(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    got = ckpt.restore(out / "run", mesh, cfg, like)
    placed = {name: _dims(t)
              for name, t in step._leaves(got.params)}
    restored = {"params": _gather_tree(got.params),
                "mu": _gather_tree(got.opt_state.mu),
                "nu": _gather_tree(got.opt_state.nu),
                "step": got.step, "count": got.opt_state.count}
    params_only = _gather_tree(ckpt.restore_params(out / "run", mesh, cfg,
                                                   device="cpu"))
    _save(out, f"fit-r{rank}", {"lines": lines, "history": history,
                                "fitted": fitted, "restored": restored,
                                "placed": placed,
                                "params_only": params_only})


def rendezvous(rank, world, out, port):
    """``maybe_initialize`` from the controller's env (each rank sets its
    own ``TPU_WORKER_ID``), then one all-reduce over the group."""
    from service_account_auth_improvements_tpu_torch.parallel import (
        multihost,
    )

    os.environ["TPU_WORKER_ID"] = str(rank)
    multihost.COORD_PORT = port
    got = multihost.maybe_initialize(device="cpu")
    again = multihost.maybe_initialize(device="cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    _save(out, f"rendezvous-r{rank}", {
        "rank": got, "again": again, "world": dist.get_world_size(),
        "backend": dist.get_backend(), "sum": float(x),
        "plan": multihost.rendezvous_plan()})


def world_one(rank, world, out, cfg_kw):
    """A process with no process group: ``make_mesh`` starts a group of
    one by itself, and on that all-ones mesh three ``make_train_step``
    steps, an eval step and ``TokenBatches`` are the plain path's."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
        make_multislice_mesh,
    )
    from service_account_auth_improvements_tpu_torch.parallel.mesh import (
        single_device_mesh,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        evaluate,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
        TokenBatches,
    )

    assert not dist.is_initialized()
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1),
                     device="cpu")
    shapes = {"single": tuple(single_device_mesh("cpu").shape),
              "multislice": tuple(make_multislice_mesh(
                  1, MeshConfig(fsdp=1), device="cpu").shape)}
    cfg = llama.LlamaConfig(**cfg_kw)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, 2048).astype(np.int32)
    plain_data = TokenBatches(tokens, DataConfig(batch=4, seq=32),
                              device="cpu")
    mesh_data = TokenBatches(tokens, DataConfig(batch=4, seq=32),
                             mesh=mesh, device="cpu")
    runs = {}
    for name, m, data in (("plain", None, plain_data),
                          ("mesh", mesh, mesh_data)):
        state = step.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        if m is not None:
            state = step.shard_state(m, cfg, state)
        fn = step.make_train_step(cfg, mesh=m)
        losses = []
        for i in range(3):
            state, met = fn(state, *data.masked_batch_at(i))
            losses.append((met["loss"].item(), met["grad_norm"].item()))
        ev = evaluate.make_eval_step(cfg, mesh=m)(
            state.params, *data.masked_batch_at(5))
        runs[name] = {"losses": losses, "eval": [t.item() for t in ev],
                      "params": _gather_tree(state.params),
                      "mu": _gather_tree(state.opt_state.mu),
                      "nu": _gather_tree(state.opt_state.nu),
                      "batch": data.batch_at(1)}
    runs["mesh"]["batch"] = runs["mesh"]["batch"].to_local()
    runs["backend"], runs["world"] = dist.get_backend(), \
        dist.get_world_size()
    runs["shapes"] = shapes
    _save(out, "world-one", runs)
