"""MNIST MLP (port of ``models/mnist.py``): the smallest end-to-end proof
that a notebook can train (BASELINE.json configurations #1 and #2).

Pure-functional, as the reference: a dict of params, ``apply``, a loss and
a plain-SGD step that returns new params. The matmuls run in bf16 (cuBLAS
on the card; the reference leaves them to XLA, no Pallas kernel). On a
mesh (``make_sgd_step(mesh=...)``) the step is data parallel over ``dp``
with the reference's global-batch semantics: each rank takes its rows,
its loss is its rows' mean over the dp size, and the gradients are summed
over dp, so loss and update are the global batch's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    data_parallel_group,
)
from service_account_auth_improvements_tpu_torch.parallel.sharding import (
    to_local,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (
    tree_map,
    value_and_grad,
)

@dataclasses.dataclass(frozen=True)
class MnistConfig:
    in_dim: int = 784
    hidden_dim: int = 256
    num_classes: int = 10
    num_layers: int = 2

    def param_count(self) -> int:
        dims = self._dims()
        return sum((a + 1) * b for a, b in zip(dims[:-1], dims[1:]))

    def _dims(self) -> list[int]:
        return ([self.in_dim]
                + [self.hidden_dim] * (self.num_layers - 1)
                + [self.num_classes])


def init(cfg: MnistConfig, generator: torch.Generator, device=None) -> dict:
    """f32 params on ``device`` (the card unless ``"cpu"``): He-normal
    weights drawn from ``generator``, zero biases."""
    dev = resolve_device(device)
    dims = cfg._dims()
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=generator.device)
        params[f"w{i}"] = (w * math.sqrt(2.0 / a)).to(dev)
        params[f"b{i}"] = torch.zeros((b,), dtype=torch.float32, device=dev)
    return params


def apply(cfg: MnistConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """(batch, 784) images → (batch, 10) f32 logits. Each matmul and bias
    add in bfloat16, the logits cast to float32 at the head."""
    h = x.to(torch.bfloat16)
    n = cfg.num_layers
    for i in range(n):
        w = params[f"w{i}"].to(torch.bfloat16)
        h = h @ w + params[f"b{i}"].to(torch.bfloat16)
        if i < n - 1:
            h = F.relu(h)
    return h.float()


def loss_fn(cfg: MnistConfig, params: dict, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(apply(cfg, params, x), dim=-1)
    return -torch.mean(logp.gather(1, labels.long()[:, None]))


def accuracy(cfg: MnistConfig, params: dict, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(apply(cfg, params, x), dim=-1)
    return torch.mean((pred == labels).float())


def make_sgd_step(cfg: MnistConfig, lr: float = 0.1, mesh=None):
    """``step(params, x, labels) -> (new_params, loss)``: one plain-SGD
    step, ``p - lr·g`` on every leaf (new tensors, as the reference's
    functional update). With a dp ``mesh`` the params are the same on
    every rank, ``x``/``labels`` the global batch as a ``DTensor`` split
    over dp or this rank's rows, and loss and update the global
    batch's."""
    group = None if mesh is None else data_parallel_group(mesh)
    n = cc.size(group)

    def step(params, x, labels):
        x, labels = to_local(x), to_local(labels)

        def objective(p):
            loss = loss_fn(cfg, p, x, labels)
            return loss if n == 1 else cc.sum_forward(loss / n, group)

        loss, grads = value_and_grad(objective, params)
        for g in grads.values():
            cc.all_reduce_(g, [group])
        with torch.no_grad():
            new_params = tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss

    return step
