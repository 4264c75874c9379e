"""Policy training on the card (port of
``controlplane/scheduler/policy/train.py``).

Objective: outcome-weighted behaviour cloning. Each journal row is a
(state, decision, time-to-placement) tuple; the loss is the cross-entropy
against the logged decision over the MASKED scores, weighted by
``1/(1+ttp_s)`` and divided by ``max(sum of weights, 1e-6)``, all in f32.
The optimizer is the port's ``train/step.AdamW`` with the reference's
``make_optimizer(learning_rate, weight_decay=0.0)`` settings (global-norm
clip 1.0, b1 0.9, b2 0.95, eps 1e-8), which updates the parameters and
moments in place, as the reference's jitted step donates them.

The dataset goes to the device once; each step gathers its rows there.
The rows of step i are still ``np.random.default_rng((seed,
i)).integers(0, n, size=batch_size)``, so a fixed ``seed`` fixes the
batches and a resumed run is the run that never stopped. The loss is read
back to the host only every ``log_every`` steps.

Checkpoints are the reference's ``policy.npz``, written atomically
(tmp + ``os.replace``: the numpy ``PolicyChooser`` may read it
mid-train) with the same keys, shapes, dtypes and order: ``schema``,
``journal_schema``, ``step`` and ``hidden``, ``param/<key>``, and
``opt/<i>`` in the order of ``jax.tree_util.tree_leaves`` of the optax
state: ``opt/0`` the int32 update count, then ``mu`` and then ``nu``,
each in sorted key order (``b1, b2, b3, w1, w2, w3``). Either trainer
resumes the other's file, moments included.

The reference wraps its step in a jitwatch recompile seam
(``_maybe_jitwatch``); nothing here is traced or compiled, so it has no
counterpart.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, NamedTuple

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
    features,
    model,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    AdamState,
    AdamW,
    make_optimizer,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (
    value_and_grad,
)

CKPT_FILE = "policy.npz"
CKPT_SCHEMA = "sched-policy-ckpt/v1"
#: the parameter keys in the order optax flattens a dict (sorted): the
#: order of the moments among the ``opt/<i>`` leaves
LEAF_ORDER = tuple(sorted(model.PARAM_KEYS))
#: count, mu and nu: the optax state's leaves for these params
N_OPT_LEAVES = 1 + 2 * len(LEAF_ORDER)


class PolicyState(NamedTuple):
    step: int
    params: Any
    opt_state: AdamState


def policy_loss(params, pool_feats, glob, mask, label, weight):
    """Weighted cross-entropy of the logged choice under the masked
    scores (the reference's ``loss_fn``)."""
    scores = model.forward(params, pool_feats, glob, mask)
    logp = torch.log_softmax(scores, dim=-1)
    picked = logp.gather(-1, label[:, None])[:, 0]
    return -(weight * picked).sum() / weight.sum().clamp_min(1e-6)


def make_policy_step(optimizer: AdamW):
    """``step(state, batch) -> (state, metrics)``; ``batch`` is
    ``(pool_feats, glob, mask, label, weight)`` on the params' device
    (``label`` int64). The update writes the params and moments in place;
    the returned state holds the same tensors. ``metrics["loss"]`` stays
    on the device."""

    def step(state: PolicyState, batch):
        loss, grads = value_and_grad(policy_loss, state.params, *batch)
        params, opt_state = optimizer.apply(grads, state.opt_state,
                                            state.params)
        return PolicyState(state.step + 1, params, opt_state), {
            "loss": loss}

    return step


# ----------------------------------------------------------- checkpoint

def save_checkpoint(workdir: str, state: PolicyState, hidden: int) -> str:
    """Atomic ``policy.npz`` write; returns the path."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, CKPT_FILE)
    payload = {
        "schema": np.array(CKPT_SCHEMA),
        "journal_schema": np.array(features.JOURNAL_SCHEMA),
        "step": np.array(int(state.step), np.int64),
        "hidden": np.array(int(hidden), np.int64),
    }
    params = model.params_to_numpy(state.params)
    for key in model.PARAM_KEYS:
        payload[f"param/{key}"] = params[key]
    opt = state.opt_state
    leaves = [np.array(opt.count, np.int32)]
    for moments in (opt.mu, opt.nu):
        leaves += [moments[k].detach().cpu().numpy() for k in LEAF_ORDER]
    for i, leaf in enumerate(leaves):
        payload[f"opt/{i}"] = leaf
    fd, tmp = tempfile.mkstemp(dir=workdir, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> dict | None:
    """``{"params": {name: np.ndarray}, "opt_leaves", "step", "hidden"}``,
    or None when the file is absent, unreadable or of another schema."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if str(z["schema"]) != CKPT_SCHEMA:
                return None
            opt_keys = sorted(
                (k for k in z.files if k.startswith("opt/")),
                key=lambda k: int(k.split("/", 1)[1]),
            )
            return {
                "params": {k: z[f"param/{k}"] for k in model.PARAM_KEYS},
                "opt_leaves": [z[k] for k in opt_keys],
                "step": int(z["step"]),
                "hidden": int(z["hidden"]),
            }
    except (OSError, ValueError, KeyError):
        return None


def latest_step(workdir: str) -> int | None:
    loaded = load_checkpoint(os.path.join(workdir, CKPT_FILE))
    return loaded["step"] if loaded else None


def _opt_state(optimizer: AdamW, params: dict, leaves: list,
               dev) -> AdamState:
    """The optimizer state of ``params`` from a checkpoint's ``opt/<i>``
    leaves; fresh moments when their count is not this state's, as the
    reference's resume does when the leaf count of its treedef differs."""
    if len(leaves) != N_OPT_LEAVES:
        return optimizer.init(params)
    k = len(LEAF_ORDER)

    def moments(arrays):
        return {name: torch.tensor(a, device=dev)
                for name, a in zip(LEAF_ORDER, arrays)}
    return AdamState(int(leaves[0]), moments(leaves[1:1 + k]),
                     moments(leaves[1 + k:]))


def device_dataset(data: dict, dev) -> list:
    """A ``features.dataset`` dict on ``dev``, once: ``[pool_feats, glob,
    mask, label (int64), weight]``, the weight ``1/(1+ttp_s)`` in f32."""
    weight = (1.0 / (1.0 + data["ttp_s"])).astype(np.float32)
    return [torch.as_tensor(a).to(dev) for a in (
        data["pool_feats"], data["glob"], data["mask"],
        data["label"].astype(np.int64), weight)]


def batch_at(on_dev: list, seed: int, i: int, batch_size: int) -> list:
    """Step ``i``'s batch: the rows ``np.random.default_rng((seed,
    i))`` draws (deterministic, resume-stable), gathered on the device.
    On the card the indices go through pinned memory without waiting for
    it, so no step blocks the host on the card."""
    n = on_dev[0].shape[0]
    rows = torch.from_numpy(np.random.default_rng((seed, i)).integers(
        0, n, size=batch_size))
    if on_dev[0].is_cuda:
        rows = rows.pin_memory().to(on_dev[0].device, non_blocking=True)
    return [t[rows] for t in on_dev]


# ------------------------------------------------------------- training

def fit_policy(data: dict, *, seed: int = 0, steps: int = 300,
               batch_size: int = 64, hidden: int = model.DEFAULT_HIDDEN,
               learning_rate: float = 1e-2, workdir: str | None = None,
               ckpt_every: int = 0, log_every: int = 50,
               log=None, device=None) -> tuple:
    """Train on a ``features.dataset`` dict on ``device`` (the card unless
    ``"cpu"``); returns (state, history).

    Resume: with ``workdir`` holding a checkpoint, training continues
    from its step (its ``hidden`` overrides the argument) over the
    identical per-step batch schedule. A fresh run draws its params from
    a CPU ``torch.Generator`` seeded with ``seed``, so the card and the
    CPU start from the same params.
    """
    n = int(data["label"].shape[0])
    if n == 0:
        raise ValueError("empty training set: no usable placement rows "
                         "(journal too small, or schema drift: see "
                         "features.check_row)")
    dev = resolve_device(device)
    optimizer = make_optimizer(learning_rate=learning_rate,
                               weight_decay=0.0)
    start = 0
    resumed = (load_checkpoint(os.path.join(workdir, CKPT_FILE))
               if workdir else None)
    if resumed is not None:
        hidden = resumed["hidden"]
        start = resumed["step"]
        params = model.params_from_numpy(resumed["params"], dev)
        state = PolicyState(start, params, _opt_state(
            optimizer, params, resumed["opt_leaves"], dev))
        if log:
            log(f"resumed from step {start}")
    else:
        params = model.init_params(
            hidden, generator=torch.Generator().manual_seed(seed),
            device=dev)
        state = PolicyState(0, params, optimizer.init(params))
    step = make_policy_step(optimizer)
    on_dev = device_dataset(data, dev)
    history = []
    for i in range(start, steps):
        state, metrics = step(state, batch_at(on_dev, seed, i, batch_size))
        if log_every and (i + 1) % log_every == 0:
            loss = float(metrics["loss"])
            history.append({"step": i + 1, "loss": loss})
            if log:
                log(f"policy step {i + 1}/{steps} loss={loss:.4f}")
        if workdir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(workdir, state, hidden)
    if workdir and state.step > start:
        save_checkpoint(workdir, state, hidden)
    return state, history


def train_from_journal(journal_path: str, workdir: str, *,
                       seed: int = 0, steps: int = 300,
                       batch_size: int = 64, log=None,
                       device=None) -> dict:
    """Journal JSONL to a trained checkpoint; returns the run record
    (example and drop counts, final loss, checkpoint path)."""
    entries = features.load_journal_jsonl(journal_path)
    data = features.dataset(entries)
    state, history = fit_policy(
        data, seed=seed, steps=steps, batch_size=batch_size,
        workdir=workdir, log=log, device=device,
    )
    return {
        "examples": int(data["label"].shape[0]),
        "dropped_rows": int(data["dropped"]),
        "steps": int(state.step),
        "seed": seed,
        "final_loss": history[-1]["loss"] if history else None,
        "checkpoint": os.path.join(workdir, CKPT_FILE),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m service_account_auth_improvements_tpu_torch."
             "controlplane.scheduler.policy.train",
        description="train the placement policy from a decision-journal "
                    "JSONL dump, on the card",
    )
    ap.add_argument("--journal", required=True,
                    help="journal JSONL (sched-journal/v1 placement rows)")
    ap.add_argument("--workdir", required=True,
                    help="checkpoint directory (policy.npz lands here; an "
                         "existing checkpoint resumes)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    record = train_from_journal(
        args.journal, args.workdir, seed=args.seed, steps=args.steps,
        batch_size=args.batch_size, log=print, device=args.device,
    )
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
