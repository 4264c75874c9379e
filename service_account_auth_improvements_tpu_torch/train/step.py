"""Training step for the Llama workload (port of ``train/step.py``).

``make_train_step`` returns ``step(state, tokens, mask)``: next-token loss
→ gradients by autograd → clipped AdamW, written by hand to match the
reference's optax chain (``clip_by_global_norm`` then ``adamw``) rule for
rule; ``torch.optim.AdamW`` and ``clip_grad_norm_`` differ from it. The
reference donates the previous state so XLA reuses its buffers; here the
update writes the parameters and moments in place instead, and the
returned state holds the same tensors.

On a mesh (``make_train_step(mesh=...)``) the state's tensors are
``DTensor``s laid out by the logical rules (``shard_state``): each rank
updates its own blocks. The step runs the model on the local blocks of
the batch rows its (dp, fsdp) coordinate holds, then sums each
gradient over the data-parallel ranks that hold the same block, takes
the global norm over each element once, and applies AdamW to the blocks
(``sharded_update``, which the LoRA and distillation steps share). A
pipeline stage (pp) holds and updates its slab of the stacked layers, an
expert rank (ep) its range of experts; a weight replicated over pp or ep
comes out of the model with the same gradient on each of those ranks
(``parallel/pipeline.py``, ``llama._moe_ffn``), so it is not summed over
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import (
    sharding,
)
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    check_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
# the tree helpers under the names checkpoint.py and chip_smoke.py use
from service_account_auth_improvements_tpu_torch.utils.tree import (
    leaves as _leaves,
    rebuild as _rebuild,
    tree_map as _map,
    value_and_grad,
)

class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the moments, as
    dicts shaped like the params (``mu`` in ``mu_dtype``, ``nu`` in the
    param dtype, as optax keeps them)."""
    count: int
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: AdamState


def _linear(init: float, end: float, steps: int):
    """optax ``linear_schedule``: ``init`` → ``end`` over ``steps``
    counts, then held (constant ``init`` when ``steps <= 0``)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def make_lr_schedule(peak_lr: float = 3e-4, warmup_steps: int = 0,
                     decay_steps: int = 0, min_lr_ratio: float = 0.1):
    """Linear warmup → cosine decay → ``peak_lr * min_lr_ratio`` floor, as
    the reference builds it from optax's ``warmup_cosine_decay_schedule``;
    with no ``decay_steps`` warmup-then-constant, or the constant
    ``peak_lr`` (a float) when neither is given. A schedule maps the
    optimizer's pre-increment update count to a learning rate."""
    if not decay_steps:
        if warmup_steps:
            warm = _linear(0.0, peak_lr, warmup_steps)
            return lambda count: (warm(count) if count < warmup_steps
                                  else peak_lr)
        return peak_lr
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    init = 0.0 if warmup_steps else peak_lr
    warm = _linear(init, peak_lr, warmup_steps)
    end = peak_lr * min_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    span = decay_steps - warmup_steps

    def schedule(count):
        if count < warmup_steps:
            return warm(count)
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak_lr * ((1 - alpha) * cosine + alpha)
    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(...))``, written
    out. Per update, with g the gradients:

    1. the global norm of g (f32); when it is not below ``grad_clip``,
       each leaf becomes ``(g / norm) * grad_clip``;
    2. ``scale_by_adam``: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu,
       count += 1, u = mu/(1-b1^count) / (sqrt(nu/(1-b2^count)) + eps)
       (``eps_root`` 0; the corrections in f32, as optax computes them);
    3. ``add_decayed_weights`` on every leaf: u += weight_decay·p;
    4. ``scale_by_learning_rate``: u *= -lr, the schedule read at the
       pre-increment count (with warmup the first update has lr 0);
    5. ``apply_updates``: p = (p + u) cast back to p's dtype; mu is
       stored in ``mu_dtype`` (cast on write).

    ``apply`` does all of that in place, leaf by leaf."""
    learning_rate: float | Callable[[int], float] = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    mu_dtype: str | None = None

    def init(self, params) -> AdamState:
        mdt = (llama.dtype_of(self.mu_dtype) if self.mu_dtype else None)
        return AdamState(
            0,
            _map(lambda p: torch.zeros_like(p, dtype=mdt or p.dtype),
                 params),
            _map(torch.zeros_like, params),
        )

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    @torch.no_grad()
    def apply(self, grads, state: AdamState, params, norm=None):
        """One update of ``params`` and ``state`` in place; returns
        ``(params, new_state)``. ``norm`` is ``global_norm(grads)`` when
        the caller has it already."""
        if norm is None:
            norm = global_norm(grads)
        clip = norm >= self.grad_clip
        count = state.count + 1
        # optax: 1 - decay**count in f32 (a python float and an int32
        # array), cast to the moment's dtype in the division
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        lr = self.lr(state.count)
        for (name, p), (_, g), (_, mu), (_, nu) in zip(
                _leaves(params), _leaves(grads), _leaves(state.mu),
                _leaves(state.nu)):
            g = torch.where(clip, (g / norm.to(g.dtype)) * self.grad_clip,
                            g)
            m = g * (1 - self.b1) + mu * self.b1
            v = (g * g) * (1 - self.b2) + nu * self.b2
            u = (m / _as(bc1, m)) / (torch.sqrt(v / _as(bc2, v)) + self.eps)
            u = u + p * self.weight_decay
            u = u * _as(-lr, u)
            p.copy_((p + u).to(p.dtype))
            mu.copy_(m)
            nu.copy_(v)
        return params, AdamState(count, state.mu, state.nu)


def _as(x: float, like):
    """A python scalar in ``like``'s dtype, as optax casts its step size
    and bias corrections to the leaf dtype before multiplying. (A fill,
    not a host-to-device copy, so the update never waits on the card.)"""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (optax
    ``global_norm``; for f32 leaves the same sum)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float())
                          for _, t in _leaves(tree)))


def make_optimizer(learning_rate=3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   mu_dtype=None) -> AdamW:
    """AdamW with global-norm clipping, the reference's hyper-parameters.
    ``learning_rate`` may be a float or a schedule (``make_lr_schedule``).
    ``mu_dtype="bfloat16"`` stores the first moment in bf16."""
    return AdamW(learning_rate, weight_decay, b1, b2, 1e-8, grad_clip,
                 mu_dtype)


def init_train_state(cfg: llama.LlamaConfig, generator: torch.Generator,
                     optimizer: AdamW | None = None,
                     device=None) -> TrainState:
    """Master params from ``generator`` (``llama.init``) on ``device``
    (the card unless ``"cpu"``), zero moments, step 0."""
    optimizer = optimizer or make_optimizer()
    params = llama.init(cfg, generator, device=resolve_device(device))
    return TrainState(0, params, optimizer.init(params))


def state_shardings(mesh, cfg: llama.LlamaConfig, state: TrainState,
                    rules=None) -> TrainState:
    """Placements for a TrainState: params by their logical axes, each
    Adam moment as its param, the step and the count replicated."""
    return tree_state_shardings(mesh, llama.logical_axes(cfg), state, rules)


def tree_state_shardings(mesh, axes_tree, state: TrainState,
                         rules=None) -> TrainState:
    """``state_shardings`` for any params tree and its logical-axes tree
    (the generic core)."""
    p = sharding.tree_logical_sharding(mesh, axes_tree, rules)
    replicated = sharding.placements(mesh, ())
    return TrainState(replicated, p, AdamState(replicated, p, p))


def shard_state(mesh, cfg: llama.LlamaConfig, state: TrainState,
                rules=None, axes_tree=None) -> TrainState:
    """``state`` (whole tensors, the same on every rank) laid onto
    ``mesh`` by ``state_shardings``: its params and moments become
    ``DTensor``s holding this rank's blocks. ``axes_tree`` overrides the
    config's logical axes for another params tree (LoRA adapters)."""
    axes = axes_tree if axes_tree is not None else llama.logical_axes(cfg)

    def lay(tree):
        return sharding.tree_distribute(tree, mesh, axes, rules)

    opt = state.opt_state
    return TrainState(state.step, lay(state.params),
                      AdamState(opt.count, lay(opt.mu), lay(opt.nu)))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW | None = None,
                    mesh=None, rules=None, grad_accum: int = 1,
                    packed: bool = False,
                    segment_eos_id: int | None = None):
    """Return ``step(state, tokens, mask) -> (state, metrics)``; metrics
    are the loss and the pre-clip ``grad_norm`` as f32 scalar tensors (no
    host sync).

    ``grad_accum > 1`` splits the batch into that many STRIDED
    micro-batches (rows i, i+A, i+2A, … as the reference takes them),
    sums their gradients in f32 and divides once, casting to the param
    dtype after the division; the loss is the mean of the micro-batch
    losses. ``packed=True`` makes the mask a pure loss mask (the backbone
    sees every token as real). ``segment_eos_id`` derives segment ids
    from the tokens (count of EOS tokens strictly before a position) and
    blocks attention across documents — dense attention only.

    With a ``mesh`` (and logical ``rules``, ``DEFAULT_RULES`` when None)
    the state is sharded (``shard_state``) and ``tokens``/``mask`` are the
    global batch as a ``DTensor`` split over (dp, fsdp) (``TokenBatches``
    gives them so), or a plain tensor of this rank's rows. The metrics
    are global, the same on every rank. ``grad_accum`` takes strided
    micro-batches of the local rows, which are the global batch's strided
    micro-batches when the local row count divides by it."""
    optimizer = optimizer or make_optimizer()

    def loss_fn(params, tokens, mask):
        segment_ids = None
        if segment_eos_id is not None:
            prev_eos = torch.zeros_like(tokens, dtype=torch.int32)
            prev_eos[:, 1:] = (tokens[:, :-1] == segment_eos_id).int()
            segment_ids = torch.cumsum(prev_eos, dim=1)
        return llama.next_token_loss(
            cfg, params, tokens, mask,
            token_mask=None if packed else mask,
            segment_ids=segment_ids,
        )

    def loss_and_grads(params, tokens, mask):
        if grad_accum == 1:
            return value_and_grad(loss_fn, params, tokens, mask)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch={b} not divisible by grad_accum={grad_accum}"
            )
        acc = _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(grad_accum):
            l, g = value_and_grad(loss_fn, params, tokens[i::grad_accum],
                                  mask[i::grad_accum])
            loss = loss + l
            _map(lambda a, x: a.add_(x.float()), acc, g)
        loss = loss / grad_accum
        grads = _map(lambda a, p: (a / grad_accum).to(p.dtype), acc,
                     params)
        return loss, grads

    def step(state: TrainState, tokens, mask):
        loss, grads = loss_and_grads(state.params, tokens, mask)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.apply(grads, state.opt_state,
                                            state.params, gnorm)
        return (TrainState(state.step + 1, params, opt_state),
                {"loss": loss, "grad_norm": gnorm})

    if mesh is None:
        return step
    check_mesh(mesh)
    axes = llama.logical_axes(cfg)
    local = sharding.to_local

    def sharded_step(state: TrainState, tokens, mask):
        params = _map(local, state.params)
        with use_mesh(mesh, rules):
            region = sharding.local_region()
            loss, grads = loss_and_grads(params, local(tokens), local(mask))
        state, gnorm = sharded_update(region, axes, optimizer, state,
                                      params, grads)
        return state, {"loss": loss, "grad_norm": gnorm}

    return sharded_step


def sharded_update(region, axes_tree, optimizer: AdamW, state: TrainState,
                   params, grads):
    """The optimizer step of a sharded state from the gradients of its
    local blocks ``params`` (``grads``, the model's, in ``region``): each
    gradient summed over the data-parallel ranks its layout replicates
    it on, the global norm over every element once, AdamW on the blocks
    in place. Returns (the state, holding the same DTensors, and the
    norm)."""
    axes = dict(_leaves(axes_tree))
    local = sharding.to_local
    for name, g in _leaves(grads):
        region.reduce_grad(g, axes[name])
    gnorm = torch.sqrt(sum(region.sq_norm(g, axes[name])
                           for name, g in _leaves(grads)))
    opt = state.opt_state
    _, opt_state = optimizer.apply(
        grads, AdamState(opt.count, _map(local, opt.mu),
                         _map(local, opt.nu)), params, gnorm)
    # the blocks were updated in place: the DTensors hold the result
    return (TrainState(state.step + 1, state.params,
                       AdamState(opt_state.count, opt.mu, opt.nu)), gnorm)

