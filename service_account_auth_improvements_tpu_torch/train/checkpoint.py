"""TrainState checkpointing (port of ``train/checkpoint.py``).

The reference writes orbax checkpoints; the port keeps its own format, one
directory per step as orbax lays them out::

    <directory>/<step>/params.pt   the params, a nested dict of tensors
    <directory>/<step>/opt.pt      {"count": int, "mu": {...}, "nu": {...}}
    <directory>/<step>/meta.json   the step, and each leaf's dtype and shape

The tensors are ``torch.save``d from CPU copies, so a checkpoint loads
without a card, and read back with ``torch.load(weights_only=True,
mmap=True)``. A step is written into a temporary sibling directory,
flushed to disk and renamed into place, so ``latest_step`` sees only whole
checkpoints: a notebook culled or preempted mid-save resumes from the step
before. The newest ``max_to_keep`` steps are kept (orbax's default, 3).

This is the in-workload half of the lifecycle the control plane exists
for: cull or preempt the notebook, and the job resumes from the latest
step on the same volume.

A sharded state (``DTensor`` leaves, ``train.step.shard_state``) is saved
whole in the same layout: every rank joins each leaf's gather, and rank 0
alone copies it to the host and writes, so a checkpoint does not depend on the mesh that wrote it.
Restoring onto a mesh lays each leaf out by the rules, each rank copying
only its block out of the memory-mapped file; a checkpoint written on one
mesh restores onto another, and onto none.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil

import torch
import torch.distributed as dist

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import sharding
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    check_mesh,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    AdamState,
    TrainState,
    _leaves,
    _map,
    shard_state,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)

def _steps(directory: pathlib.Path) -> list[int]:
    """The whole checkpoints under ``directory``, oldest first: only
    integer-named directories (a temporary ``.<step>.tmp`` never
    counts)."""
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.is_dir() and p.name.isdigit())


def latest_step(directory) -> int | None:
    steps = _steps(pathlib.Path(directory))
    return steps[-1] if steps else None


def _write(path: pathlib.Path, obj) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(directory, state: TrainState, *, max_to_keep: int = 3) -> int:
    """Write ``state`` under ``directory/<step>``; returns the step. A step
    that is already on disk is left as it is (orbax skips it too). Keeps
    the newest ``max_to_keep`` checkpoints. A sharded state is a
    collective: every rank calls ``save``, and rank 0 writes."""
    directory = pathlib.Path(directory)
    step = int(state.step)
    final = directory / str(step)
    sharded = sharding.is_dtensor(next(_leaves(state.params))[1])
    if sharded:
        dist.barrier()  # every rank sees the same directory below
    if final.is_dir():
        return step
    writer = not sharded or dist.get_rank() == 0
    tmp = directory / f".{step}.tmp"
    if writer:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)  # left by a save that did not finish
        tmp.mkdir()
    opt = state.opt_state

    def cpu(tree):
        """Each leaf whole on the host, on the writer. The other ranks
        join each leaf's gather (a collective) and keep nothing, so only
        rank 0's host ever holds the state."""
        def one(t):
            whole = sharding.full_tensor(t).detach()
            return whole.to("cpu") if writer else None

        return _map(one, tree)

    meta = {"step": step, "leaves": {}}
    for prefix, tree in (("params", state.params), ("opt/mu", opt.mu),
                         ("opt/nu", opt.nu)):
        for name, t in _leaves(tree):
            meta["leaves"][f"{prefix}/{name}"] = {
                "dtype": str(t.dtype).removeprefix("torch."),
                "shape": list(t.shape)}
    # one file's CPU copy at a time: the host holds at most the moments
    params = cpu(state.params)
    if writer:
        _write(tmp / "params.pt", params)
    del params
    moments = {"count": int(opt.count), "mu": cpu(opt.mu),
               "nu": cpu(opt.nu)}
    if writer:
        _write(tmp / "opt.pt", moments)
        (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
        _fsync_dir(tmp)
        os.replace(tmp, final)
        _fsync_dir(directory)
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(directory / str(old))
    if sharded:
        dist.barrier()  # no rank reads the directory before it is whole
    return step


def _step_dir(directory, step: int | None) -> pathlib.Path:
    use = latest_step(directory) if step is None else step
    if use is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return pathlib.Path(directory) / str(use)


def _load(path: pathlib.Path):
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


def restore_params(directory, mesh, cfg: llama.LlamaConfig,
                   step: int | None = None, device=None, rules=None):
    """Restore ONLY the params (the serving path) onto ``device`` (the
    card unless ``"cpu"``), from the newest step unless ``step`` is given.
    ``opt.pt`` is never opened, so the Adam moments (twice the params'
    bytes) are never read or allocated, and the optimizer that wrote the
    state never has to be rebuilt. Each leaf keeps the dtype the
    checkpoint holds (f32 master weights stay f32; the model casts them
    to its compute dtype). A leaf the config does not know raises: the
    checkpoint was written for another preset. With a ``mesh`` (and
    ``rules``) the params are ``DTensor``s laid out by the rules on the
    mesh's device, each rank reading only its blocks."""
    dev = resolve_device(device)
    if mesh is not None and check_mesh(mesh).device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot restore onto "
                         f"{dev}")
    path = _step_dir(directory, step)
    params = _load(path / "params.pt")
    axes = llama.logical_axes(cfg)
    known = {name for name, _ in _leaves(axes)}
    for name, _ in _leaves(params):
        if name not in known:
            raise ValueError(
                f"checkpoint params leaf {name!r} ({path}) matches no "
                f"param of the given config — wrong --preset for this "
                f"checkpoint?")
    if mesh is not None:
        return sharding.tree_distribute(params, mesh, axes, rules)
    return _map(lambda t: t.to(dev), params)


def restore(directory, mesh, cfg: llama.LlamaConfig, state_like: TrainState,
            step: int | None = None, axes_tree=None,
            rules=None) -> TrainState:
    """Restore the full training state from the newest step (or ``step``)
    INTO ``state_like``: each of its tensors is overwritten in place with
    the checkpoint's values, cast to that tensor's dtype on its device (a
    bf16 ``mu`` restores as bf16), as orbax restores into its target. The
    structure and shapes must match; returns the restored ``TrainState``
    (its tensors are ``state_like``'s), which may hold any params tree
    (LoRA adapters too). With a ``mesh`` the restored leaves are laid out
    by the ``rules`` over the params' logical axes (``axes_tree``, the
    reference's override for such trees as ``lora_logical_axes``, else
    the config's): a ``state_like`` of whole tensors is laid out first, a
    sharded one keeps its layout, and each rank copies only its blocks."""
    if (mesh is not None and not sharding.is_dtensor(
            next(_leaves(state_like.params))[1])):
        state_like = shard_state(check_mesh(mesh), cfg, state_like, rules,
                                 axes_tree)
    path = _step_dir(directory, step)
    meta = json.loads((path / "meta.json").read_text())
    params = _load(path / "params.pt")
    opt = _load(path / "opt.pt")
    like_opt = state_like.opt_state

    @torch.no_grad()
    def fill(like, tree, prefix):
        got = dict(_leaves(tree))
        want = dict(_leaves(like))
        if got.keys() != want.keys():
            raise ValueError(
                f"checkpoint {path} {prefix} leaves {sorted(got)} do not "
                f"match the state's {sorted(want)}")
        for name, t in want.items():
            if list(t.shape) != meta["leaves"][f"{prefix}/{name}"]["shape"]:
                raise ValueError(f"checkpoint {path} {prefix}/{name} has "
                                 f"shape {got[name].shape}, the state "
                                 f"{tuple(t.shape)}")
            if sharding.is_dtensor(t):
                t.to_local().copy_(sharding.shard_local(
                    got[name], t.device_mesh, t.placements))
            else:
                t.copy_(got[name])
        return like

    return TrainState(
        meta["step"], fill(state_like.params, params, "params"),
        AdamState(opt["count"], fill(like_opt.mu, opt["mu"], "opt/mu"),
                  fill(like_opt.nu, opt["nu"], "opt/nu")))
