"""LoRA fine-tuning (port of ``train/lora.py``): low-rank adapters over
frozen base weights.

The adapter pair (A: [..., in, r], B: [..., r, out], B zero at init) is
merged into the base weight inside the step, ``W + (α/r)·A@B`` as one
batched matmul per target (leading layer and expert axes ride along), and
the unmodified training forward runs on the merged tree, as in the
reference. Only the adapters require grad: the base leaves enter the step
detached, so autograd computes no gradient for them (at Llama-3.1-8B an f32
gradient of the base would be 32 GB), and the merged copies of the targets
are the one extra weight set the step holds. The optimizer sees the
adapter tree alone, and a checkpoint is that tree
(``train/checkpoint.py`` takes any nested dict).

On a mesh the adapters are ``DTensor``s laid out by ``lora_logical_axes``
(A inherits the base's input axis, B its output axis) and the base
weights by the model's rules; the merge runs on the local blocks, whose
product is the base block's, and the factor replicated over tp takes
Megatron's ``f`` (its gradient from each tp rank's columns or rows
adds up), so the step is ``make_train_step``'s sharded update over the
adapter tree (``train.step.sharded_update``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import sharding
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    check_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    AdamW,
    TrainState,
    _map,
    global_norm,
    make_optimizer,
    sharded_update,
    tree_state_shardings,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (
    value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # layer-stack param names to adapt; any matmul weight under
    # params["layers"] works (attention, dense mlp, or moe_*: leading
    # layer/expert axes broadcast through the merge)
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _layer_shapes(cfg: llama.LlamaConfig) -> dict:
    """{name: shape} of the stacked ``layers`` leaves, from the config's
    logical axes and its sizes: nothing is allocated (the reference's
    ``jax.eval_shape`` of ``llama.init``)."""
    size = {"layers": cfg.n_layers, "embed": cfg.dim, "norm": cfg.dim,
            "heads": cfg.q_dim, "kv_heads": cfg.kv_dim, "mlp": cfg.mlp_dim,
            "expert": cfg.moe_experts}
    return {name: tuple(size[a] for a in axes)
            for name, axes in llama.logical_axes(cfg)["layers"].items()}


def _target_shapes(cfg: llama.LlamaConfig, lcfg: LoraConfig):
    """{target: base weight shape} without materializing params."""
    shapes = _layer_shapes(cfg)
    out = {}
    for t in lcfg.targets:
        if t not in shapes:
            raise ValueError(
                f"LoRA target {t!r} not in layer params {sorted(shapes)}")
        shape = shapes[t]
        if len(shape) < 3:
            # stacked per-layer matmul weights are >=3-D ([L, in, out]);
            # a 2-D target (a norm vector stack) would silently bind the
            # layer axis as the matmul input dim
            raise ValueError(
                f"LoRA target {t!r} is not a matmul weight (shape {shape})")
        out[t] = shape
    return out


def init_lora(cfg: llama.LlamaConfig, lcfg: LoraConfig,
              generator: torch.Generator, device=None) -> Any:
    """Adapter tree {target: {"a", "b"}} in f32 on ``device`` (the card
    unless ``"cpu"``); A ~ N(0, 1/√d_in) drawn from ``generator`` (the HF
    PEFT convention), B = 0 so the merged model starts exactly at the base
    model."""
    dev = resolve_device(device)
    tree = {}
    for t, shape in _target_shapes(cfg, lcfg).items():
        *lead, d_in, d_out = shape
        a = torch.randn((*lead, d_in, lcfg.rank), generator=generator,
                        dtype=torch.float32, device=generator.device)
        tree[t] = {
            "a": (d_in ** -0.5 * a).to(dev),
            "b": torch.zeros((*lead, lcfg.rank, d_out), dtype=torch.float32,
                             device=dev),
        }
    return tree


def lora_logical_axes(cfg: llama.LlamaConfig, lcfg: LoraConfig) -> Any:
    """Logical axes of the adapter tree, derived from each target's base
    axes: A inherits the input axis, B the output axis; the rank axis is
    unnamed."""
    base = llama.logical_axes(cfg)["layers"]
    return {
        t: {
            "a": (*base[t][:-1], None),
            "b": (*base[t][:-2], None, base[t][-1]),
        }
        for t in lcfg.targets
    }


# targets whose INPUT axis is tp-local (row parallel): their B is
# replicated over tp; the others' output axis is, and their A is
_ROW_PARALLEL = frozenset({"wo", "w_down", "moe_down"})


def merge_lora(params, lora, lcfg: LoraConfig):
    """Base params + scaled adapter products, in the base dtype: ``a @ b``
    and the scale in f32, then cast, then added in the base dtype, as the
    reference orders it. Untargeted leaves are the base's own tensors.
    In a mesh's region the leaves are local blocks, and the factor
    replicated over tp takes ``f`` (``region.tp_copy``)."""
    region = sharding.local_region()
    layers = dict(params["layers"])
    for t, ab in lora.items():
        a, b = ab["a"], ab["b"]
        if t in _ROW_PARALLEL:
            b = region.tp_copy(b)
        else:
            a = region.tp_copy(a)
        w = layers[t]
        layers[t] = w + (lcfg.scale * (a @ b)).to(w.dtype)
    return {**params, "layers": layers}


def init_lora_state(cfg: llama.LlamaConfig, lcfg: LoraConfig,
                    generator: torch.Generator,
                    optimizer: AdamW | None = None,
                    device=None) -> TrainState:
    """``TrainState`` whose ``params`` are the adapters only. Default
    optimizer: AdamW without weight decay (decaying B away from the
    just-learned direction is the usual LoRA convention)."""
    optimizer = optimizer or make_optimizer(weight_decay=0.0)
    lora = init_lora(cfg, lcfg, generator, device=device)
    return TrainState(0, lora, optimizer.init(lora))


def lora_state_shardings(mesh, cfg, lcfg: LoraConfig, state: TrainState,
                         rules=None) -> TrainState:
    """Placements for a LoRA ``TrainState`` (``lora_logical_axes``)."""
    return tree_state_shardings(mesh, lora_logical_axes(cfg, lcfg), state,
                                rules)


def make_lora_train_step(cfg: llama.LlamaConfig, lcfg: LoraConfig,
                         optimizer: AdamW | None = None, mesh=None,
                         rules=None, packed: bool = False):
    """Return ``step(state, base_params, tokens, mask) -> (state,
    metrics)``. Gradients flow through the merge into the adapters only;
    ``base_params`` comes back untouched. ``packed`` declares the mask a
    pure loss mask over a packed corpus (every token real), as in
    ``make_train_step``. Metrics are the loss and the adapters' pre-clip
    ``grad_norm``, f32 scalar tensors.

    With a ``mesh`` the state is the adapters laid out by
    ``lora_logical_axes`` (``train.step.shard_state(axes_tree=...)``),
    ``base_params`` the base laid out by the model's rules, and the
    batch as ``make_train_step`` takes it."""
    optimizer = optimizer or make_optimizer(weight_decay=0.0)

    def loss_fn(lora, base_params, tokens, mask):
        merged = merge_lora(base_params, lora, lcfg)
        return llama.next_token_loss(
            cfg, merged, tokens, mask,
            token_mask=None if packed else mask,
        )

    def step(state: TrainState, base_params, tokens, mask):
        base = _map(torch.Tensor.detach, base_params)
        loss, grads = value_and_grad(loss_fn, state.params, base, tokens,
                                     mask)
        gnorm = global_norm(grads)
        lora, opt_state = optimizer.apply(grads, state.opt_state,
                                          state.params, gnorm)
        return (TrainState(state.step + 1, lora, opt_state),
                {"loss": loss, "grad_norm": gnorm})

    if mesh is None:
        return step
    check_mesh(mesh)
    axes = lora_logical_axes(cfg, lcfg)
    local = sharding.to_local

    def sharded_step(state: TrainState, base_params, tokens, mask):
        lora = _map(local, state.params)
        base = _map(lambda t: local(t).detach(), base_params)
        with use_mesh(mesh, rules):
            region = sharding.local_region()
            loss, grads = value_and_grad(loss_fn, lora, base, local(tokens),
                                         local(mask))
        state, gnorm = sharded_update(region, axes, optimizer, state, lora,
                                      grads)
        return state, {"loss": loss, "grad_norm": gnorm}

    return sharded_step


def lora_param_count(cfg: llama.LlamaConfig, lcfg: LoraConfig) -> int:
    return sum(
        math.prod(s[:-2]) * (s[-2] + s[-1]) * lcfg.rank
        for s in _target_shapes(cfg, lcfg).values()
    )
