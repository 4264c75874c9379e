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
    res["local_shapes"] = {
        name: tuple(sharding.to_local(t).shape)
        for name, t in step._leaves(state.params)}
    # a collective save of the last state (rank 0 writes)
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint as ckpt,
    )

    ckpt.save(out / f"ckpt-{tag}", state)
    # and restored onto this mesh, laid out by the rules again
    like = step.shard_state(mesh, cfg, step.init_train_state(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    back = ckpt.restore(out / f"ckpt-{tag}", mesh, cfg, like)
    res["restored"] = {"params": _gather_tree(back.params),
                       "mu": _gather_tree(back.opt_state.mu),
                       "nu": _gather_tree(back.opt_state.nu)}
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
            ("layers-unsharded", dict(pp=2, fsdp=2),
             {**sharding.DEFAULT_RULES, "layers": None}),
            ("experts-unsharded", dict(ep=2, fsdp=2),
             {**sharding.DEFAULT_RULES, "expert": None})):
        try:
            sharding.LocalRegion(_mesh(**sizes), rules)
        except ValueError as e:
            refused[tag] = f"{type(e).__name__}: {e}"
    res["refused"] = refused
    # pipeline and expert axes: the stage and the expert range
    pp = sharding.LocalRegion(_mesh(pp=2, fsdp=2))
    ep = sharding.LocalRegion(_mesh(ep=2, fsdp=2))
    res["pp-ep"] = (pp.stage, pp.sizes["pp"], ep.expert_range(4))
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


# -- model loss and gradients on a mesh ----------------------------------

def model_grads(rank, world, out, tag, mesh_sizes, cfg_kw):
    """``next_token_loss`` and its gradients on a mesh, from the params
    and batch in ``grads-init.pt``: the loss, the whole gradients (each
    block summed over the data axes as the train step sums it, then
    gathered), each leaf's local block shape, the MoE aux of ``apply``,
    the embedding, and the local gradient block of ``lm_head``. Rank 0
    saves everything; every rank its loss."""
    from torch.distributed.tensor import DTensor

    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        params as tparams,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
        use_mesh,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        tree_map,
        value_and_grad,
    )

    init = load(out / "grads-init.pt")
    cfg = llama.LlamaConfig(**cfg_kw)
    mesh = _mesh(**mesh_sizes)
    axes = llama.logical_axes(cfg)
    dparams = sharding.tree_distribute(
        tparams.from_numpy(init["params"], cfg, device="cpu"), mesh, axes)
    local = tree_map(sharding.to_local, dparams)
    rows = sharding.placements(mesh, sharding.logical_to_mesh(
        ("batch", None)))
    toks = sharding.shard_local(init["tokens"], mesh, rows)
    mask = sharding.shard_local(init["mask"], mesh, rows)
    with use_mesh(mesh):
        region = sharding.local_region()
        loss, grads = value_and_grad(
            lambda p: llama.next_token_loss(cfg, p, toks, mask), local)
        with torch.no_grad():
            _, aux = llama.apply(cfg, local, toks, return_aux=True,
                                 token_mask=mask)
            emb = llama.embed(cfg, local, toks, region)
    res = {"loss": float(loss), "aux": float(aux),
           "shapes": {n: tuple(t.shape) for n, t in leaves(local)},
           "lm_head_grad": grads["lm_head"].detach().clone(),
           "embed": emb}
    whole = {}
    flat_axes = dict(leaves(axes))
    for name, g in leaves(grads):
        region.reduce_grad(g, flat_axes[name])
    # the blocks of the leaves outside the layer stack, as this rank
    # holds them (replicated over pp: the same on every stage)
    outside = {n: grads[n].detach().clone()
               for n in ("tok_embed", "final_norm", "lm_head")}
    for name, g in leaves(grads):
        places = sharding.logical_sharding(mesh, flat_axes[name])
        whole[name] = DTensor.from_local(g, mesh, places, run_check=False
                                         ).full_tensor()
    res["grads"] = whole
    res["coord"] = mesh.get_coordinate()
    if rank == 0:
        _save(out, f"grads-{tag}", res)
    _save(out, f"grads-{tag}-r{rank}", {
        "loss": res["loss"], "coord": res["coord"],
        "lm_head_grad": res["lm_head_grad"], "embed": emb,
        "slab": local["layers"]["wq"].clone(), "outside": outside})


def moe_ep(rank, world, out, cfg_kw):
    """``_moe_ffn`` as ep rank ``rank`` of ``world`` (its experts' slice
    of the weights in ``moe-init.pt``, the router whole): the output, the
    aux, the expert choices, and the gradients of sum(out · cos(out)) +
    aux for the input, the router and the rank's experts."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )

    init = load(out / "moe-init.pt")
    cfg = llama.LlamaConfig(**cfg_kw)
    mesh = _mesh(ep=world)
    region = sharding.LocalRegion(mesh)
    e0, e1 = region.expert_range(cfg.moe_experts)
    lp = {n: (t[e0:e1] if n.startswith("moe_") else t).clone()
          .requires_grad_() for n, t in init["lp"].items()}
    h = init["h"].clone().requires_grad_()
    routes = []
    o, aux = llama._moe_ffn(cfg, h, lp, init["mask"], region=region,
                            routes=routes)
    loss = (o * torch.cos(o)).sum() + aux
    grads = torch.autograd.grad(loss, [h, *lp.values()])
    _save(out, f"moe-r{rank}", {
        "out": o.detach(), "aux": float(aux), "routes": routes[0],
        "experts": (e0, e1),
        "grads": dict(zip(["h", *lp], grads))})


# -- sharded serving ------------------------------------------------------

def serve(rank, world, out, cfg_kw, draft_kw, mesh_sizes, bodies):
    """``GenerationService(mesh=)`` on a mesh, from the params (and
    draft params) in ``serve-init.pt``: per-length and windowed prefill,
    then int8 weights with a draft model. Rank 0 takes the requests
    (``bodies``: one-shot, and streamed when ``stream`` is set) and saves
    what it returned; the other ranks follow it in lockstep."""
    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        params as tparams,
        quantize,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )

    init = load(out / "serve-init.pt")
    cfg = llama.LlamaConfig(**cfg_kw)
    dcfg = llama.LlamaConfig(**draft_kw)
    mesh = _mesh(**mesh_sizes)

    def lay(tree, c):
        return sharding.tree_distribute(
            tparams.from_numpy(tree, c, device="cpu"), mesh,
            llama.logical_axes(c))

    params, dparams = lay(init["params"], cfg), lay(init["draft"], dcfg)
    services = {
        "window0": serving.GenerationService(cfg, params, max_new_cap=32,
                                             prefill_window=0,
                                             device="cpu", mesh=mesh),
        "window4": serving.GenerationService(cfg, params, max_new_cap=32,
                                             prefill_window=4,
                                             device="cpu", mesh=mesh),
        "int8-draft": serving.GenerationService(
            cfg, quantize.quantize_params(params), max_new_cap=32,
            prefill_window=0, device="cpu", mesh=mesh,
            draft=(dcfg, quantize.quantize_params(dparams))),
    }
    res = {}
    for name, svc in services.items():
        if not svc.leader:
            svc.follow()
            continue
        got = []
        for body in bodies:
            if body.get("stream"):
                rows = None
                for chunk in svc.stream_events(dict(body)):
                    rows = ([list(c) for c in chunk] if rows is None
                            else [r + c for r, c in zip(rows, chunk)])
                got.append(rows)
            else:
                reply = svc.complete(dict(body))
                got.append((reply["completion_ids"],
                            reply.get("speculative")))
        svc.stop()
        res[name] = got
    if rank == 0:
        res["local_wq"] = tuple(services["window0"].params["layers"][
            "wq"].shape)
        _save(out, "serve", res)


# -- the side models' meshes ---------------------------------------------

def lora_mesh(rank, world, out, cfg_kw, lcfg_kw, mesh_sizes, lr):
    """Three ``make_lora_train_step(mesh=)`` steps from the base,
    adapters and batches in ``side-init.pt``: the adapters laid out by
    ``lora_logical_axes``, the base by the model's rules. Rank 0 saves
    each step's loss, norm and whole adapters and moments, and whether
    the base came back bit for bit."""
    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        params as tparams,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        lora,
        step,
    )

    init = load(out / "side-init.pt")
    cfg = llama.LlamaConfig(**cfg_kw)
    lcfg = lora.LoraConfig(**lcfg_kw)
    mesh = _mesh(**mesh_sizes)
    base = sharding.tree_distribute(
        tparams.from_numpy(init["base"], cfg, device="cpu"), mesh,
        llama.logical_axes(cfg))
    before = _gather_tree(base)
    opt = step.make_optimizer(learning_rate=lr, weight_decay=0.0)
    adapters = tparams.from_numpy(init["lora"], cfg, device="cpu")
    state = step.TrainState(0, adapters, opt.init(adapters))
    places = lora.lora_state_shardings(mesh, cfg, lcfg, state)
    state = step.shard_state(mesh, cfg, state,
                             axes_tree=lora.lora_logical_axes(cfg, lcfg))
    fn = lora.make_lora_train_step(cfg, lcfg, opt, mesh=mesh)
    res = {"steps": [], "places": {
        n: [p.dim if p.is_shard() else None for p in pl]
        for n, pl in step._leaves(places.params)}}
    batch = sharding.placements(mesh, sharding.logical_to_mesh(
        ("batch", None)))
    for toks, mask in init["batches"]:
        state, m = fn(state, base, sharding.distribute(toks, mesh, batch),
                      sharding.distribute(mask, mesh, batch))
        res["steps"].append({
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _gather_tree(state.params),
            "mu": _gather_tree(state.opt_state.mu),
            "nu": _gather_tree(state.opt_state.nu)})
    after = _gather_tree(base)
    res["base_same"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        step._leaves(before), step._leaves(after)))
    if rank == 0:
        _save(out, "lora", res)


def distill_mesh(rank, world, out, s_kw, t_kw, mesh_sizes):
    """Three ``make_distill_step(mesh=)`` steps from the student state,
    teacher and batches in ``side-init.pt`` (the student sharded, the
    teacher laid out by the rules); rank 0 saves each step's metrics and
    whole state."""
    from service_account_auth_improvements_tpu_torch.models import (
        llama,
        params as tparams,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        distill,
        step,
    )

    init = load(out / "side-init.pt")
    cfg_s, cfg_t = llama.LlamaConfig(**s_kw), llama.LlamaConfig(**t_kw)
    mesh = _mesh(**mesh_sizes)
    teacher = sharding.tree_distribute(
        tparams.from_numpy(init["teacher"], cfg_t, device="cpu"), mesh,
        llama.logical_axes(cfg_t))
    state = step.shard_state(mesh, cfg_s, tparams.train_state_from_numpy(
        cfg_s, init["params"], init["mu"], init["nu"], device="cpu"))
    fn = distill.make_distill_step(cfg_s, cfg_t, mesh=mesh,
                                   temperature=1.5, alpha=0.3)
    res = {"steps": []}
    batch = sharding.placements(mesh, sharding.logical_to_mesh(
        ("batch", None)))
    for toks, mask in init["batches"]:
        state, m = fn(state, teacher, sharding.distribute(toks, mesh, batch),
                      sharding.distribute(mask, mesh, batch))
        res["steps"].append({
            **{k: float(v) for k, v in m.items()},
            "params": _gather_tree(state.params),
            "mu": _gather_tree(state.opt_state.mu),
            "nu": _gather_tree(state.opt_state.nu)})
    if rank == 0:
        _save(out, "distill", res)


def fit_lora_mesh(rank, world, out, cfg_kw, lcfg_kw):
    """``fit(mesh=, lora=)`` on fsdp 2 x tp 2: 4 steps straight, and 2
    steps then 2 more resumed from the workdir's checkpoint, with an
    eval; every rank saves the adapters, moments and history."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.train import lora
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )
    from service_account_auth_improvements_tpu_torch.train.loop import (
        LoopConfig,
        fit,
    )

    cfg = llama.LlamaConfig(**cfg_kw)
    lcfg = lora.LoraConfig(**lcfg_kw)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 4096).astype(np.int32)
    base = llama.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    mesh = _mesh(fsdp=2, tp=2)
    eval_data = [tokens[:128].reshape(4, 32)]
    runs = {}
    for name, stops in (("straight", (4,)), ("resumed", (2, 4))):
        for steps in stops:
            state, history = fit(
                cfg, mesh, tokens, DataConfig(batch=4, seq=32),
                LoopConfig(steps=steps, log_every=1, eval_every=4,
                           workdir=str(out / name)),
                log=lambda *a: None, device="cpu", lora=lcfg,
                base_params=base, eval_data=eval_data)
        runs[name] = {"params": _gather_tree(state.params),
                      "mu": _gather_tree(state.opt_state.mu),
                      "nu": _gather_tree(state.opt_state.nu),
                      "history": history, "step": state.step}
    _save(out, f"fit-lora-r{rank}", runs)


class _F32:
    """A module whose ``bfloat16`` is ``float32`` (the vision tests'
    compute-dtype swap)."""

    def __init__(self, mod):
        self._mod, self.bfloat16 = mod, mod.float32

    def __getattr__(self, name):
        return getattr(self._mod, name)


def vision_mesh(rank, world, out, f32):
    """MNIST (3 SGD steps) and resnet18-smoke (3 momentum steps) on a dp
    mesh of ``world`` from ``vision-init.pt``, each rank on its rows of
    the global batch; every rank saves its results (``f32``: the models'
    bf16 compute swapped for f32)."""
    from service_account_auth_improvements_tpu_torch.models import (
        mnist,
        resnet,
    )

    if f32:
        mnist.torch = resnet.torch = _F32(torch)
    init = load(out / "vision-init.pt")
    mesh = _mesh(dp=world)
    res = {}
    x, labels = init["mnist_batch"]
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    step = mnist.make_sgd_step(mnist.MnistConfig(), lr=0.1, mesh=mesh)
    params = init["mnist"]
    losses = []
    for _ in range(3):
        params, loss = step(params, x[rows], labels[rows])
        losses.append(float(loss))
    res["mnist"] = {"params": params, "losses": losses}
    x, labels = init["resnet_batch"]
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    cfg = resnet.PRESETS["resnet18-smoke"]
    step = resnet.make_train_step(cfg, lr=0.1, mesh=mesh)
    params, stats = init["resnet"]
    mom = _zeros_like_tree(params)
    losses = []
    for _ in range(3):
        params, stats, mom, loss = step(params, stats, mom, x[rows],
                                        labels[rows])
        losses.append(float(loss))
    res["resnet"] = {"params": params, "stats": stats, "mom": mom,
                     "losses": losses}
    _save(out, f"vision-r{rank}", res)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def torchrun_rendezvous(out: pathlib.Path) -> None:
    """A process torchrun started: ``maybe_initialize`` from its env (a
    second call a no-op), then one all-reduce over the group."""
    from service_account_auth_improvements_tpu_torch.parallel import (
        multihost,
    )

    torch.set_num_threads(1)
    got = multihost.maybe_initialize(device="cpu")
    again = multihost.maybe_initialize(device="cpu")
    try:
        x = torch.tensor([float(got + 1)])
        dist.all_reduce(x)
        _save(out, f"torchrun-r{got}", {
            "rank": got, "again": again, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "sum": float(x),
            "local_rank": int(os.environ["LOCAL_RANK"]),
            "plan": multihost.rendezvous_plan(),
            "line": multihost.describe_group()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    # ``python -m tests.torch_parallel_workers <function> <dir>``: the
    # entry of a rank process a launcher (torchrun) starts
    import sys

    globals()[sys.argv[1]](pathlib.Path(sys.argv[2]))
