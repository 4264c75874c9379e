"""ResNet-v1.5 family (port of ``models/resnet.py``): the vision workload
of BASELINE.json configuration #3 (ResNet-50).

Pure-functional, as the reference: ``init`` → (params, batch_stats);
``apply`` returns (logits, new_batch_stats). The param tree keeps the
reference's names and shapes, HWIO conv weights included, so the weight
bridge and checkpoints are the identity; each conv permutes its weight to
OIHW at use. Images come in NHWC, as the reference takes them, and the
activations are bf16 tensors in ``torch.channels_last`` memory (NHWC in
memory, NCHW as torch indexes them), the layout cuDNN's tensor-core
convolutions want. The convolutions are cuDNN's on the card (XLA's in the
reference, no Pallas kernel).

Two things are written out because torch's defaults differ from the
reference:

- SAME padding (``lax.conv_general_dilated(padding="SAME")`` and the SAME
  max-pool): ``total = max((⌈n/s⌉−1)·s + k − n, 0)``, ``total // 2``
  before and the rest after. At stride 2 that is asymmetric (the 7×7/2
  stem at 224 pads (2, 3), a 3×3/2 at 56 pads (0, 1)), where a symmetric
  ``padding=`` gives the same output shape over shifted windows.
- Batch norm: the biased batch variance in f32, running stats
  ``momentum·old + (1−momentum)·new``, and the normalisation in bf16
  with the reference's casts. ``nn.BatchNorm2d`` updates with the unbiased
  variance and the opposite momentum convention.

On a mesh (``make_train_step(mesh=...)``) the step is data parallel over
``dp`` with the reference's global-batch semantics: each rank takes its
rows, the batch norm is cross-replica (the per-channel sums for the mean
and then the variance are all-reduced over dp before the normalisation,
keeping the f32 statistics and the bf16 normalisation), so the running
statistics come out the same on every rank, and the loss is each rank's
rows' mean over the dp size with the gradients summed over dp.
"""

from __future__ import annotations

import dataclasses
import functools
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
    leaves,
    tree_map,
    value_and_grad,
)

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)     # resnet-50
    width: int = 64
    num_classes: int = 1000
    bottleneck: bool = True
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    def param_count(self) -> int:
        # the exact count of the param tree, built on the meta device
        params, _ = _build(self, lambda shape: torch.empty(
            shape, device="meta"), torch.device("meta"))
        return sum(t.numel() for _, t in leaves(params))


PRESETS = {
    "resnet18-smoke": ResNetConfig(stage_sizes=(1, 1), width=8,
                                   num_classes=10, bottleneck=False),
    "resnet50": ResNetConfig(),
}


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis of size ``n`` for a window
    ``k`` at stride ``s``: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """x [N, C, H, W] (channels_last) ⊛ w [kh, kw, cin, cout] (HWIO), SAME
    padding, in x's dtype."""
    kh, kw = w.shape[:2]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    w = w.permute(3, 2, 0, 1).to(dtype=x.dtype,
                                 memory_format=torch.channels_last)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (*pw, *ph))
    return F.conv2d(x, w, stride=stride)


def _max_pool_same(x, k: int = 3, s: int = 2):
    """``reduce_window(max, -inf, (1, k, k, 1), (1, s, s, 1), "SAME")``:
    the SAME padding is -inf."""
    ph = _same_pad(x.shape[2], k, s)
    pw = _same_pad(x.shape[3], k, s)
    x = F.pad(x, (*pw, *ph), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _channel(v):
    """A [C] vector broadcast over [N, C, H, W]."""
    return v[None, :, None, None]


def _bn_apply(x, scale, bias, mean, var, eps):
    inv = torch.rsqrt(var + eps) * scale
    return ((x - _channel(mean)) * _channel(inv.to(x.dtype))
            + _channel(bias.to(x.dtype)))


def _bn(x, params, stats, train, momentum, eps, group=None):
    """Batch norm over (N, H, W). train=True: batch statistics in f32
    (biased variance) and EMA-updated running stats; train=False: the
    running stats. The new stats carry no graph. With a dp ``group`` the
    statistics are the global batch's: per-channel sums all-reduced over
    it (a sum every rank uses, so its backward sums too)."""
    if train and cc.size(group) > 1:
        x32 = x.float()
        count = x32.numel() // x32.shape[1] * cc.size(group)
        mean = cc.all_sum(x32.sum(dim=(0, 2, 3)), group) / count
        dev = x32 - _channel(mean)
        var = cc.all_sum((dev * dev).sum(dim=(0, 2, 3)), group) / count
        new_stats = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * stats["var"] + (1 - momentum) * var.detach(),
        }
    elif train:
        x32 = x.float()
        mean = torch.mean(x32, dim=(0, 2, 3))
        var = torch.var(x32, dim=(0, 2, 3), unbiased=False)
        new_stats = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * stats["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    out = _bn_apply(x, params["scale"], params["bias"],
                    mean.to(x.dtype), var.to(x.dtype), eps)
    return out, new_stats


def _block_names(cfg: ResNetConfig):
    for stage, size in enumerate(cfg.stage_sizes):
        for block in range(size):
            yield f"s{stage}b{block}", stage, block


def _block_stride(stage: int, block: int) -> int:
    """Each stage after the first downsamples in its first block — the
    single definition used by init and apply."""
    return 2 if (stage > 0 and block == 0) else 1


def _build(cfg: ResNetConfig, conv_init, dev: torch.device):
    """(params, batch_stats) with each conv weight from
    ``conv_init((kh, kw, cin, cout))``, in the reference's draw order."""
    params: dict = {}
    stats: dict = {}

    def bn_init(c):
        return ({"scale": torch.ones((c,), dtype=torch.float32, device=dev),
                 "bias": torch.zeros((c,), dtype=torch.float32,
                                     device=dev)},
                {"mean": torch.zeros((c,), dtype=torch.float32, device=dev),
                 "var": torch.ones((c,), dtype=torch.float32, device=dev)})

    params["stem"] = {"conv": conv_init((7, 7, 3, cfg.width))}
    params["stem"]["bn"], stats["stem"] = bn_init(cfg.width)

    cin = cfg.width
    expansion = 4 if cfg.bottleneck else 1
    for name, stage, block in _block_names(cfg):
        cmid = cfg.width * (2 ** stage)
        cout = cmid * expansion
        stride = _block_stride(stage, block)
        bp: dict = {}
        bs: dict = {}
        if cfg.bottleneck:
            shapes = [(1, 1, cin, cmid), (3, 3, cmid, cmid),
                      (1, 1, cmid, cout)]
        else:
            shapes = [(3, 3, cin, cmid), (3, 3, cmid, cout)]
        for i, shape in enumerate(shapes):
            bp[f"conv{i}"] = conv_init(shape)
            bp[f"bn{i}"], bs[f"bn{i}"] = bn_init(shape[-1])
        if cin != cout or stride != 1:
            bp["proj"] = conv_init((1, 1, cin, cout))
            bp["proj_bn"], bs["proj_bn"] = bn_init(cout)
        params[name] = bp
        stats[name] = bs
        cin = cout

    params["head"] = {
        "w": torch.zeros((cin, cfg.num_classes), dtype=torch.float32,
                         device=dev),
        "b": torch.zeros((cfg.num_classes,), dtype=torch.float32,
                         device=dev),
    }
    return params, stats


def init(cfg: ResNetConfig, generator: torch.Generator, device=None):
    """(params, batch_stats) in f32 on ``device`` (the card unless
    ``"cpu"``): He-normal HWIO conv weights drawn from ``generator``, BN
    scale 1 and bias 0, running mean 0 and var 1, a zero head."""
    dev = resolve_device(device)

    def conv_init(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * math.sqrt(2.0 / fan_in)).to(dev)

    return _build(cfg, conv_init, dev)


def apply(cfg: ResNetConfig, params: dict, stats: dict, x: torch.Tensor,
          train: bool = True, group=None):
    """(batch, H, W, 3) NHWC images → ((batch, classes) f32 logits,
    new_batch_stats). ``group``: the dp group of a cross-replica batch
    norm (``x`` is then this rank's rows)."""
    bn = functools.partial(_bn, train=train, momentum=cfg.bn_momentum,
                           eps=cfg.bn_eps, group=group)
    new_stats: dict = {}
    # NHWC memory viewed as NCHW is channels_last
    h = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    h = _conv(h, params["stem"]["conv"], stride=2)
    h, new_stats["stem"] = bn(h, params["stem"]["bn"], stats["stem"])
    h = F.relu(h)
    h = _max_pool_same(h)

    n_convs = 3 if cfg.bottleneck else 2
    for name, stage, block in _block_names(cfg):
        bp, bs = params[name], stats[name]
        block_stride = _block_stride(stage, block)
        ns: dict = {}
        residual = h
        out = h
        for i in range(n_convs):
            # v1.5: the 3x3 conv carries the stride in bottleneck blocks
            stride = (block_stride if i == (1 if cfg.bottleneck else 0)
                      else 1)
            out = _conv(out, bp[f"conv{i}"], stride=stride)
            out, ns[f"bn{i}"] = bn(out, bp[f"bn{i}"], bs[f"bn{i}"])
            if i < n_convs - 1:
                out = F.relu(out)
        if "proj" in bp:
            residual = _conv(residual, bp["proj"], stride=block_stride)
            residual, ns["proj_bn"] = bn(residual, bp["proj_bn"],
                                         bs["proj_bn"])
        h = F.relu(out + residual)
        new_stats[name] = ns

    h = torch.mean(h.float(), dim=(2, 3))
    logits = h @ params["head"]["w"] + params["head"]["b"]
    return logits, new_stats


def loss_fn(cfg: ResNetConfig, params: dict, stats: dict, x: torch.Tensor,
            labels: torch.Tensor, group=None):
    """Mean cross-entropy of the batch; with a dp ``group``, of the
    global batch (each rank's share summed over it in the forward)."""
    logits, new_stats = apply(cfg, params, stats, x, train=True,
                              group=group)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(logp.gather(1, labels.long()[:, None]))
    n = cc.size(group)
    if n > 1:
        loss = cc.sum_forward(loss / n, group)
    return loss, new_stats


def make_train_step(cfg: ResNetConfig, lr: float = 0.1, mesh=None):
    """``step(params, stats, momentum, x, labels) -> (params, stats,
    momentum, loss)``: momentum SGD, ``m = 0.9·m + g`` then ``p = p −
    lr·m`` on every leaf (new tensors, as the reference's functional
    update). With a dp ``mesh`` params, stats and momentum are the same
    on every rank, ``x``/``labels`` the global batch as a ``DTensor``
    split over dp or this rank's rows; the batch norm is cross-replica
    and loss, update and running statistics are the global batch's."""
    group = None if mesh is None else data_parallel_group(mesh)

    def step(params, stats, momentum, x, labels):
        x, labels = to_local(x), to_local(labels)
        (loss, new_stats), grads = value_and_grad(
            lambda p: loss_fn(cfg, p, stats, x, labels, group), params,
            has_aux=True)
        for _, g in leaves(grads):
            cc.all_reduce_(g, [group])
        with torch.no_grad():
            new_momentum = tree_map(lambda m, g: 0.9 * m + g, momentum,
                                    grads)
            new_params = tree_map(lambda p, m: p - lr * m, params,
                                  new_momentum)
        return new_params, new_stats, new_momentum, loss

    return step
