"""Llama-3 family decoder-only transformer (port of ``models/llama.py``).

Parameters are a plain dict of tensors in the reference's layout: stacked
``layers`` leaves ``[L, ...]`` and weights ``[in, out]`` used as
``x @ W``, so a test can load parameters the JAX package initialised
(``models/params.py``) without transposes. The forward is functions on
tensors; the reference's ``lax.scan`` over layers is a Python loop.
``jax.checkpoint`` becomes ``torch.utils.checkpoint`` (non-reentrant):
per layer with ``remat_policy="full"``, selective (matmul outputs saved)
with ``"dots_saveable"``, and per loss chunk in ``scan_seq_chunks``; it
only acts while autograd records, so the serving path (under
``torch.inference_mode()``) runs plain.

On a mesh (``parallel.use_mesh``) the forward is the per-rank body of the
reference's partitioned program: the ambient ``parallel.sharding.
LocalRegion`` gathers each weight over its data axes where it is used
(inside the layer's remat, so the backward gathers again, as ZeRO-3
does), wraps the tensor-parallel products in Megatron's ``f``/``g``
where the reference's ``shard_constraint`` calls let XLA insert them,
splits the sequence over ``sp`` (rope at global positions) and runs ring
or Ulysses attention over it, keeps the vocabulary split over tp (a masked
embedding lookup summed over tp, vocab-parallel logits and loss), runs
each rank's range of experts over ``ep`` and the stacked layers as a GPipe
pipeline over ``pp`` (``parallel/pipeline.py``). The region is bound when
the forward starts, so a recompute on autograd's device thread uses the
same groups. Without a mesh the region is the identity and the arithmetic
is the plain path's, op for op.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from service_account_auth_improvements_tpu_torch.ops.attention import (
    multi_head_attention,
)
from service_account_auth_improvements_tpu_torch.ops.norms import rms_norm
from service_account_auth_improvements_tpu_torch.ops.rotary import (
    apply_rope,
    rope_table,
)
from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)
from service_account_auth_improvements_tpu_torch.parallel.pipeline import (
    pipeline_slab,
)
from service_account_auth_improvements_tpu_torch.parallel.sharding import (
    NO_REGION,
    local_region,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field for field the reference's ``LlamaConfig``, so presets and
    ``param_count``/``flops_per_token`` stay identical. ``scan_layers``
    and ``iota_embed`` change nothing here: the layers are a Python loop
    either way, and the reference's one-hot embedding is bit-identical
    to the gather (on a tp mesh the vocab-parallel lookup is its
    counterpart). ``pp_microbatches`` is the pipeline's microbatch count
    on a pp > 1 mesh (0: ``parallel.pipeline.default_microbatches``)."""
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14_336
    rope_theta: float = 500_000.0
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_seq: int = 8192
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master parameter dtype
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "dense"         # dense | flash | ring | ulysses
    iota_embed: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False
    moe_aux_weight: float = 0.01
    moe_group_size: int = 1024
    loss_chunk: int = 0
    remat_policy: str = "full"
    pp_microbatches: int = 0

    def rope_scaling(self) -> dict | None:
        """kwargs for ``rope_table(scaling=...)``; None when unscaled."""
        if not self.rope_scaling_factor:
            return None
        return {
            "factor": self.rope_scaling_factor,
            "low_freq_factor": self.rope_low_freq_factor,
            "high_freq_factor": self.rope_high_freq_factor,
            "original_max_seq": self.rope_original_max_seq,
        }

    def moe_cap(self, group: int) -> int:
        if self.moe_dropless:
            return group
        return max(1, int(self.moe_capacity_factor * self.moe_top_k
                          * group / self.moe_experts))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        if self.moe_experts:
            ffn = (self.dim * self.moe_experts
                   + 3 * self.moe_experts * self.dim * self.mlp_dim)
        else:
            ffn = 3 * self.dim * self.mlp_dim
        per_layer = (
            2 * self.dim
            + self.dim * self.q_dim
            + 2 * self.dim * self.kv_dim
            + self.q_dim * self.dim
            + ffn
        )
        return (self.vocab_size * self.dim + self.n_layers * per_layer
                + self.dim + self.dim * self.vocab_size)

    def matmul_param_count(self) -> int:
        """Params in matmuls: all but the token-embedding gather."""
        return self.param_count() - self.vocab_size * self.dim

    def active_matmul_param_count(self) -> int:
        total = self.matmul_param_count()
        if self.moe_experts:
            total -= (self.n_layers * 3
                      * (self.moe_experts - self.moe_top_k)
                      * self.dim * self.mlp_dim)
        return total

    def flops_per_token(self, seq_len: int | None = None) -> int:
        """Approx training FLOPs/token, as the reference counts them."""
        flops = 6 * self.active_matmul_param_count()
        if seq_len:
            flops += 6 * self.n_layers * self.n_heads * self.head_dim * seq_len
        if self.moe_experts:
            group = min(self.moe_group_size, seq_len or self.moe_group_size)
            flops += (3 * 2 * 2 * self.n_layers
                      * self.moe_experts * self.moe_cap(group) * self.dim)
        return flops


# The reference's presets, unchanged (its notes on each live there).
PRESETS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, mlp_dim=128, max_seq_len=128, rope_theta=10_000.0,
    ),
    "smoke": LlamaConfig(
        vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
        head_dim=16, mlp_dim=256, max_seq_len=256, rope_theta=10_000.0,
    ),
    "bench_400m": LlamaConfig(
        vocab_size=32_768, dim=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        head_dim=128, mlp_dim=4096, max_seq_len=2048, attn_impl="flash",
        loss_chunk=512,
    ),
    "bench_800m": LlamaConfig(
        vocab_size=32_768, dim=1536, n_layers=20, n_heads=12, n_kv_heads=4,
        head_dim=128, mlp_dim=6144, max_seq_len=2048, attn_impl="flash",
        loss_chunk=512,
    ),
    "bench_moe": LlamaConfig(
        vocab_size=32_768, dim=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        head_dim=128, mlp_dim=2048, max_seq_len=2048, attn_impl="flash",
        loss_chunk=512, moe_experts=4,
    ),
    "moe_smoke": LlamaConfig(
        vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
        head_dim=16, mlp_dim=256, max_seq_len=256, rope_theta=10_000.0,
        moe_experts=4,
    ),
    "moe2_smoke": LlamaConfig(
        vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
        head_dim=16, mlp_dim=256, max_seq_len=256, rope_theta=10_000.0,
        moe_experts=4, moe_top_k=2,
    ),
    "mixtral_8x7b": LlamaConfig(
        vocab_size=32_000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        head_dim=128, mlp_dim=14_336, max_seq_len=32_768,
        rope_theta=1_000_000.0, moe_experts=8, moe_top_k=2,
    ),
    "moe_8x1b": LlamaConfig(
        vocab_size=128_256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        head_dim=64, mlp_dim=8192, max_seq_len=8192, moe_experts=8,
    ),
    "llama3_1b": LlamaConfig(
        vocab_size=128_256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        head_dim=64, mlp_dim=8192, max_seq_len=8192,
        rope_scaling_factor=32.0, rope_original_max_seq=8192,
    ),
    "llama3_8b": LlamaConfig(
        rope_scaling_factor=8.0, rope_original_max_seq=8192,
    ),
    "llama3_70b": LlamaConfig(
        dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, head_dim=128,
        mlp_dim=28_672,
        rope_scaling_factor=8.0, rope_original_max_seq=8192,
    ),
}


def logical_axes(cfg: LlamaConfig) -> dict:
    """Nested dict (same structure as the params) of logical-axis tuples,
    as the reference names them: ``parallel.sharding`` resolves them
    against the rules to each leaf's placements on a mesh, the model's
    region gathers a weight by them, and ``train.checkpoint`` checks a
    checkpoint's leaves against them."""
    if cfg.moe_experts:
        ffn = {
            "router": ("layers", "embed", "expert"),
            "moe_gate": ("layers", "expert", "embed", "mlp"),
            "moe_up": ("layers", "expert", "embed", "mlp"),
            "moe_down": ("layers", "expert", "mlp", "embed"),
        }
    else:
        ffn = {
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        }
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "norm"),
            **ffn,
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (config dtypes are strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init(cfg: LlamaConfig, generator: torch.Generator, device=None):
    """Master params in ``param_dtype`` on ``device`` (the card unless
    ``"cpu"``), drawn from ``generator`` in the reference's order. The
    residual-out projections are scaled by 1/sqrt(2·n_layers). The draws
    differ from ``jax.random``'s; tests that need the reference's weights
    bridge them with ``models/params.py``. A mixture-of-experts config
    draws ``router`` and the stacked ``moe_*`` expert weights in the dense
    FFN's slot, as the reference does."""
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device=dev, dtype=pdt)

    L, E = cfg.n_layers, cfg.moe_experts
    std = 0.02
    out_std = 0.02 / (2 * L) ** 0.5
    params = {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), std),
        "layers": {
            "attn_norm": torch.ones((L, cfg.dim), dtype=pdt, device=dev),
            "wq": normal((L, cfg.dim, cfg.q_dim), std),
            "wk": normal((L, cfg.dim, cfg.kv_dim), std),
            "wv": normal((L, cfg.dim, cfg.kv_dim), std),
            "wo": normal((L, cfg.q_dim, cfg.dim), out_std),
            "mlp_norm": torch.ones((L, cfg.dim), dtype=pdt, device=dev),
        },
        "final_norm": torch.ones((cfg.dim,), dtype=pdt, device=dev),
    }
    if E:
        params["layers"].update({
            "router": normal((L, cfg.dim, E), std),
            "moe_gate": normal((L, E, cfg.dim, cfg.mlp_dim), std),
            "moe_up": normal((L, E, cfg.dim, cfg.mlp_dim), std),
            "moe_down": normal((L, E, cfg.mlp_dim, cfg.dim), out_std),
        })
    else:
        params["layers"].update({
            "w_gate": normal((L, cfg.dim, cfg.mlp_dim), std),
            "w_up": normal((L, cfg.dim, cfg.mlp_dim), std),
            "w_down": normal((L, cfg.mlp_dim, cfg.dim), out_std),
        })
    params["lm_head"] = normal((cfg.dim, cfg.vocab_size), std)
    return params


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``layers`` leaves (views)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def _vocab_split(region) -> bool:
    """Whether the vocabulary is split over more than one tp rank."""
    return cc.size(region.vocab) > 1


def embed(cfg: LlamaConfig, params, tokens, region=NO_REGION):
    """Token embedding in the compute dtype. Out-of-range ids clamp, as
    the reference's ``mode="clip"`` gather does (its ``iota_embed``
    one-hot path is bit-identical to this gather). With the vocabulary
    split over tp (Megatron's VocabParallelEmbedding, the reference's
    one-hot contraction over its vocab shards) each rank looks up the
    ids in its shard, zero for the others, and the rows are summed over
    tp: one rank holds each, so the sum is the row exactly."""
    ids = tokens.clamp(0, cfg.vocab_size - 1)
    table = region.param(params["tok_embed"], ("vocab", "embed"))
    if not _vocab_split(region):
        return table[ids].to(dtype_of(cfg.dtype))
    v = table.shape[0]
    local = ids - region.vocab_rank * v
    hit = (local >= 0) & (local < v)
    rows = torch.where(hit[..., None], table[local.clamp(0, v - 1)],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return cc.sum_forward(rows, region.vocab).to(dtype_of(cfg.dtype))


def _moe_ffn(cfg: LlamaConfig, h, lp, token_mask=None, region=NO_REGION,
             routes: list | None = None):
    """Top-k MoE FFN: h [b, s, d] → (out [b, s, d], aux f32 scalar). k=1
    is switch semantics (the gate is the raw router probability); k > 1
    is Mixtral semantics (gates renormalised over the selected experts).

    The reference's formulation, kept as it is: routing per group of
    ``moe_group_size`` tokens (the whole sequence when that does not
    divide it), f32 router logits and softmax, capacity slots claimed
    choice-major through a cumsum (every token's rank-0 choice before any
    rank-1 choice), one-hot dispatch and combine products and the expert
    products as one batched [G, E, C, d] × [E, d, m] contraction in the
    compute dtype. Claims past capacity and masked tokens (which neither
    take capacity nor enter the balance statistics) contribute exactly 0,
    falling through to the residual. ``aux`` is the load-balance loss:
    E · mean over groups of Σ_e density · mean router probability, where
    density counts routed claims before capacity over k.

    The one-hot products (not a gather and ``index_add_``) keep every
    expert in the autograd graph, so an expert no token reached still
    gets its (zero) gradient, and sum in a fixed order on the card, so a
    step and its remat recompute route and add up identically. The top
    k is a stable descending sort: ``jax.lax.top_k`` puts the lower
    expert first among equal probabilities and ``torch.topk`` does not.
    On a mesh the expert products are column/row parallel over tp (the
    reference's "mlp" constraint on ``act``). Over ep every rank sees the
    same tokens (the batch is not split over ep) and routes them over all
    E experts, then dispatches into and runs only its own range of them
    (``lp``'s expert leaves are that range): the combine's sum over
    experts becomes partial sums added over ep (Megatron's ``g``), and
    the routed input and the gates take ``f``, so every ep rank's
    gradient of them, and of the router, is the whole one. ``routes``,
    a list, receives the [G, g, K] expert choices."""
    b, s, d = h.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    g = min(cfg.moe_group_size, s)
    if s % g:
        g = s
    cap = cfg.moe_cap(g)
    cdt = h.dtype
    f32 = torch.float32
    G = b * (s // g)
    hg = h.reshape(G, g, d)
    if token_mask is None:
        tmask = torch.ones((G, g), dtype=f32, device=h.device)
    else:
        tmask = token_mask.to(f32).reshape(G, g)

    logits = hg.to(f32) @ lp["router"].to(f32)             # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :K]        # [G, g, K]
    if routes is not None:
        routes.append(idx)
    gate = probs.gather(-1, idx)
    if K > 1:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    gate = gate * tmask[..., None]
    onehot = (F.one_hot(idx, E).to(f32)
              * tmask[..., None, None])                   # [G, g, K, E]
    denom = tmask.sum(dim=1, keepdim=True).clamp_min(1.0)
    density = onehot.sum(dim=(1, 2)) / (denom * K)
    density_proxy = (probs * tmask[..., None]).sum(dim=1) / denom
    aux = E * (density * density_proxy).sum(-1).mean()

    # queue position of each (token, choice) in its expert, choice-major
    oh_cm = onehot.transpose(1, 2).reshape(G, K * g, E)
    pos_cm = torch.cumsum(oh_cm, dim=1) - oh_cm
    pos = pos_cm.reshape(G, K, g, E).transpose(1, 2)
    pos_tok = (pos * onehot).sum(-1)                      # [G, g, K]
    keep = (pos_tok < cap).to(f32) * tmask[..., None]
    sel = onehot * keep[..., None]
    # a claim at or past capacity has an all-zero row, as jax's one_hot
    # gives (F.one_hot raises on it instead)
    posoh = (pos_tok.long()[..., None]
             == torch.arange(cap, device=h.device)).to(f32)  # [G, g, K, C]
    disp = torch.einsum("gske,gskc->gsec", sel, posoh)   # [G, g, E, C]

    gate_sel = sel * gate[..., None]
    if region.sizes["ep"] > 1:
        e0, e1 = region.expert_range(E)
        disp, gate_sel = disp[:, :, e0:e1], region.ep_copy(gate_sel)[
            ..., e0:e1]
        hg = region.ep_copy(hg)
    xin = region.tp_copy(torch.einsum("gsec,gsd->gecd", disp.to(cdt), hg))
    act = (F.silu(torch.einsum("gecd,edm->gecm", xin,
                               lp["moe_gate"].to(cdt)))
           * torch.einsum("gecd,edm->gecm", xin, lp["moe_up"].to(cdt)))
    xout = region.tp_sum(torch.einsum("gecm,emd->gecd", act,
                                      lp["moe_down"].to(cdt)))
    combine = torch.einsum("gske,gskc->gsec", gate_sel, posoh).to(cdt)
    out = region.ep_sum(torch.einsum("gsec,gecd->gsd", combine, xout))
    return out.reshape(b, s, d), aux


def _layer(cfg: LlamaConfig, x, lp, cos, sin, token_mask=None,
           segment_ids=None, region=NO_REGION):
    """One decoder block. x: [b, s, dim] in compute dtype. Returns (x,
    aux): aux is the MoE load-balance term (None for dense layers, which
    have none). ``token_mask`` [b, s] keeps padding out of MoE routing.
    On a mesh ``lp`` holds the layer's local weight blocks, ``x`` this
    rank's rows and sequence chunk, and the heads are this rank's tp
    share."""
    b, s, _ = x.shape
    cdt = dtype_of(cfg.dtype)
    if region is not NO_REGION:
        axes = logical_axes(cfg)["layers"]
        lp = {n: region.param(t, axes[n][1:],
                              experts_local=n.startswith("moe_"))
              for n, t in lp.items()}

    h = rms_norm(x, lp["attn_norm"].to(cdt), cfg.norm_eps)
    hp = region.tp_copy(h)
    q = (hp @ lp["wq"].to(cdt)).reshape(b, s, -1, cfg.head_dim)
    k = (hp @ lp["wk"].to(cdt)).reshape(b, s, -1, cfg.head_dim)
    v = (hp @ lp["wv"].to(cdt)).reshape(b, s, -1, cfg.head_dim)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = region.attention(q, k, v, cfg.attn_impl, segment_ids)
    x = x + region.tp_sum(attn.reshape(b, s, -1) @ lp["wo"].to(cdt))

    h = rms_norm(x, lp["mlp_norm"].to(cdt), cfg.norm_eps)
    if cfg.moe_experts:
        if region.sizes["sp"] == 1:
            ff, aux = _moe_ffn(cfg, h, lp, token_mask, region=region)
            return x + ff, aux
        # routing groups and capacity span the whole sequence: every sp
        # rank routes all of it (gathered) and keeps its chunk of the
        # output; the aux is the whole sequence's on each (next_token_loss
        # counts it once)
        whole = cc.all_gather(h, 1, region.sp)
        mask = (None if token_mask is None
                else cc.all_gather(token_mask, 1, region.sp))
        ff, aux = _moe_ffn(cfg, whole, lp, mask, region=region)
        return x + region.seq_chunk(ff), aux
    hp = region.tp_copy(h)
    gate = F.silu(hp @ lp["w_gate"].to(cdt))
    up = hp @ lp["w_up"].to(cdt)
    return x + region.tp_sum((gate * up) @ lp["w_down"].to(cdt)), None


# the ops whose outputs ``dots_saveable`` keeps: every matrix product
# (``x @ W`` lowers to mm, the attention einsums to bmm). The flash
# kernels are launched through ctypes, so the policy cannot see them and
# they are recomputed, as JAX recomputes a pallas_call under this policy.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: LlamaConfig, fn):
    """``fn`` under the config's rematerialisation (the reference's
    ``jax.checkpoint`` of each layer): "full" saves only the layer's
    inputs and recomputes the rest in the backward pass, "dots_saveable"
    also saves the matmul outputs, "none" (or ``remat=False``) saves
    everything. Only while autograd records."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("full", "dots_saveable"):
        raise ValueError(
            f"remat_policy={cfg.remat_policy!r}: expected one of "
            "['dots_saveable', 'full'] or 'none'"
        )
    if not torch.is_grad_enabled():
        return fn
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "dots_saveable":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kwargs)


def _backbone(cfg: LlamaConfig, params, tokens, token_mask=None,
              return_layer_inputs: bool = False, segment_ids=None):
    """Embed + decoder stack + final norm: tokens [b, s] → (x [b, s, dim]
    in compute dtype, the summed MoE aux loss: None for a dense model,
    so its forward launches nothing for it) (the lm_head is the
    caller's: ``apply`` for full logits, ``next_token_loss`` in chunks).
    ``token_mask`` is the MoE validity mask (0 = padding), unused by
    dense layers. With ``return_layer_inputs`` also the per-layer input
    hidden states [L, b, s, dim], the KV-cache prefill source
    (models/generate.py): (x, aux, layer_inputs).

    On a mesh ``tokens`` are this rank's rows, whole; the backbone keeps
    its ``sp`` chunk of them and returns that chunk's hidden states."""
    cdt = dtype_of(cfg.dtype)
    s = tokens.shape[1]
    region = local_region()
    if region is not NO_REGION:
        _check_region(cfg, region, return_layer_inputs, segment_ids)
        tokens = region.seq_chunk(tokens)
        if token_mask is not None:
            token_mask = region.seq_chunk(token_mask)
    x = embed(cfg, params, tokens, region)
    cos, sin = rope_table(s, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling(), device=x.device)
    cos, sin = region.seq_chunk(cos, 0), region.seq_chunk(sin, 0)
    layer_fn = _remat(cfg, functools.partial(_layer, cfg, region=region))
    names = list(params["layers"])
    inputs, auxes = [], []
    if region.sizes["pp"] > 1:
        # the stage's slab of the stacked layers (rule "layers": "pp"):
        # the microbatched GPipe schedule; the token mask and segment ids
        # follow their microbatch, a None before a given one held by the
        # identity (all-ones) mask
        tail = [token_mask, segment_ids]
        while tail and tail[-1] is None:
            tail.pop()
        batched = tuple(torch.ones(x.shape[:2], dtype=torch.int32,
                                   device=x.device) if t is None else t
                        for t in tail)
        x, aux = pipeline_slab(layer_fn, params["layers"], x, (cos, sin),
                               batched, n_micro=cfg.pp_microbatches,
                               n_layers=cfg.n_layers, region=region)
        auxes.append(aux)
    else:
        # unbind, not per-layer indexing: the backward of unbind stacks
        # the layers' gradients once, where L index views would each
        # build a zero-filled gradient of the whole stacked leaf and sum
        # L of them
        per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
        for leaves in per_layer:
            if return_layer_inputs:
                inputs.append(x)
            x, aux = layer_fn(x, dict(zip(names, leaves)), cos, sin,
                              token_mask, segment_ids)
            auxes.append(aux)
    x = rms_norm(x, region.param(params["final_norm"], ("norm",)).to(cdt),
                 cfg.norm_eps)
    aux = torch.stack(auxes).sum() if cfg.moe_experts else None
    if return_layer_inputs:
        return x, aux, torch.stack(inputs)
    return x, aux


def _check_region(cfg: LlamaConfig, region, return_layer_inputs: bool,
                  segment_ids) -> None:
    """What the model does not run on this mesh raises, naming why."""
    sp = region.sizes["sp"]
    if return_layer_inputs and region.sizes["pp"] > 1:
        # the reference's error
        raise ValueError(
            "KV-cache prefill (return_layer_inputs) is not supported "
            "under pipeline parallelism; run generation on a pp=1 mesh")
    if return_layer_inputs and sp > 1:
        raise ValueError("KV-cache prefill needs the whole prompt on a "
                         "rank; serve on an sp=1 (tp/fsdp) mesh")
    if sp > 1 and segment_ids is not None:
        raise ValueError("segment_ids need the whole sequence on a rank; "
                         "train packed windows on an sp=1 mesh")


def lm_logits(cfg: LlamaConfig, params, x):
    """x [..., dim] compute dtype → f32 logits [..., vocab]. The operands
    are rounded to the compute dtype and multiplied in f32 — the
    reference's ``preferred_element_type=float32``; a bf16 matmul would
    round the logits to bf16 and flip greedy argmaxes. With the
    vocabulary split over tp each rank computes its shard's logits and
    they are gathered (decoding samples from all of them)."""
    region = local_region()
    head = region.param(params["lm_head"], ("embed", "vocab"))
    head = head.to(dtype_of(cfg.dtype)).float()
    return region.vocab_gather(region.vocab_copy(x).float() @ head)


def apply(cfg: LlamaConfig, params, tokens, return_aux: bool = False,
          token_mask=None, segment_ids=None):
    """Forward pass: tokens [b, s] int → logits [b, s, vocab] f32.
    With ``return_aux`` also returns the summed MoE load-balance loss (an
    f32 zero for a dense model). ``token_mask`` [b, s] (1 = real token) keeps padding out of MoE
    routing capacity and balance statistics. ``segment_ids`` [b, s]
    blocks attention across packed documents (dense attention only)."""
    x, aux = _backbone(cfg, params, tokens, token_mask,
                       segment_ids=segment_ids)
    logits = lm_logits(cfg, params, x)
    if return_aux:
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux
    return logits


class _VocabParallelNLL(torch.autograd.Function):
    """logz − target logit from each tp rank's vocab shard of the f32
    logits (Megatron's vocab-parallel cross-entropy): the row max and the
    sum of exps all-reduced over tp, the target's logit from the rank
    that holds it. The backward is softmax − one-hot on the rank's
    shard."""

    @staticmethod
    def forward(ctx, logits, targets, group, v0):
        v = logits.shape[-1]
        mx = logits.amax(-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        sum_exp = torch.exp(logits - mx[..., None]).sum(-1)
        dist.all_reduce(sum_exp, group=group)
        logz = torch.log(sum_exp) + mx
        local = targets - v0
        hit = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)
        target = torch.where(hit, logits.gather(-1, local[..., None])[
            ..., 0], torch.zeros((), dtype=logits.dtype,
                                 device=logits.device))
        dist.all_reduce(target, group=group)
        ctx.save_for_backward(logits, logz, local, hit)
        return logz - target

    @staticmethod
    def backward(ctx, g):
        logits, logz, local, hit = ctx.saved_tensors
        grad = torch.exp(logits - logz[..., None])
        grad.scatter_add_(-1, local[..., None],
                          -hit.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _nll(cfg: LlamaConfig, x, lm_head, targets, region=NO_REGION):
    """Per-position next-token NLL from hidden states: x [b, t, d] compute
    dtype, lm_head [d, vocab] compute dtype, targets [b, t] (already
    clipped) → nll [b, t] f32.

    The logits are the reference's: compute-dtype operands multiplied in
    f32 into f32 logits (``preferred_element_type=float32``). The target
    logit is read with a gather; the reference's one-hot contraction (a
    choice for its vocab-sharded logits) gives the same number exactly,
    and the gather never builds a [b, t, vocab] one-hot. With the
    vocabulary split over tp, ``lm_head`` is the rank's shard and the
    logits stay sharded (``_VocabParallelNLL``); ``x`` has taken
    ``region.vocab_copy``."""
    logits = x.float() @ lm_head.float()
    if _vocab_split(region):
        return _VocabParallelNLL.apply(logits, targets, region.vocab,
                                       region.vocab_rank * logits.shape[-1])
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return logz - target_logit


def scan_seq_chunks(fn, c: int, *arrays):
    """Run ``fn`` over ``c``-position sequence chunks of [b, t, ...]
    ``arrays``, each chunk under ``torch.utils.checkpoint`` while
    autograd records: per-chunk intermediates (the [b, c, vocab] logits
    blocks) are produced, reduced, and recomputed in the backward pass
    instead of being saved. The tail chunk is padded with each array's
    own prefix — the padded outputs are sliced off, and real data keeps
    the gather well-defined. ``fn`` maps chunk views to a [b, c] tensor
    or a tuple of them; returns the same with [b, t] leaves."""
    b, t = arrays[0].shape[:2]
    pad = (-t) % c
    if pad:
        arrays = tuple(torch.cat([a, a[:, :pad]], dim=1) for a in arrays)
    chunk = fn
    if torch.is_grad_enabled():
        chunk = functools.partial(checkpoint, fn, use_reentrant=False)
    outs = [chunk(*(a[:, i:i + c] for a in arrays))
            for i in range(0, t + pad, c)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, dim=1)[:, :t] for o in zip(*outs))
    return torch.cat(outs, dim=1)[:, :t]


def _chunked_nll(cfg: LlamaConfig, x, lm_head, targets, region=NO_REGION):
    """``_nll`` computed ``cfg.loss_chunk`` positions at a time — the
    [b, t, vocab] logits never exist (see ``scan_seq_chunks``). Same
    math to the ULP (each position's logsumexp is independent)."""
    c = min(cfg.loss_chunk, x.shape[1])
    return scan_seq_chunks(
        lambda xc, tc: _nll(cfg, xc, lm_head, tc, region), c, x, targets
    )


def next_token_targets(cfg: LlamaConfig, region, tokens, mask):
    """What the rank's hidden states predict: (trim, targets, m, count).
    ``trim``: drop the last hidden position (it has no target); targets
    clipped like the embedding; ``m`` the f32 target weights (None
    without a mask) and ``count`` their sum over the rank's rows (None
    without a mask). Over sp each chunk's last position predicts the
    next chunk's first token and the whole sequence's last has weight
    0, so nothing is trimmed."""
    targets = tokens[:, 1:].clamp(0, cfg.vocab_size - 1)
    m = None if mask is None else mask[:, 1:].to(torch.float32)
    if region.sizes["sp"] == 1:
        return True, targets, m, None if m is None else m.sum()
    if m is None:
        m = torch.ones(targets.shape, device=targets.device)
    m = torch.cat([m, torch.zeros_like(m[:, :1])], dim=1)
    count = m.sum()
    return (False, region.seq_chunk(torch.cat([targets, targets[:, :1]],
                                              dim=1)),
            region.seq_chunk(m), count)


_SAME_AS_MASK = object()


def next_token_loss(cfg: LlamaConfig, params, tokens, mask=None,
                    include_aux: bool = True,
                    token_mask=_SAME_AS_MASK, segment_ids=None):
    """Mean next-token cross-entropy (f32 scalar). tokens [b, s]; mask
    [b, s] optional (1 where the *target* position counts). With
    ``cfg.loss_chunk`` the vocab projection and log-softmax run in
    sequence chunks (``_chunked_nll``). For a MoE config ``include_aux``
    adds ``moe_aux_weight`` × the load-balance term;
    ``include_aux=False`` gives the pure cross-entropy (evaluation).

    ``token_mask`` is the validity mask the backbone feeds MoE routing;
    by default it follows ``mask`` (right padding); packed corpora pass
    ``None``. The backbone runs on the full sequence and the last hidden
    state is dropped after, as in the reference.

    On a mesh each rank computes its share of the global loss from its
    rows (and, over ``sp``, its sequence chunk, whose last position
    predicts the next chunk's first token): masked sums over the global
    token count, or its rows' mean over the number of row shards. The
    shares are summed across the data-parallel ranks in the forward only,
    so each rank differentiates its own share and the train step sums the
    gradients."""
    if token_mask is _SAME_AS_MASK:
        token_mask = mask
    region = local_region()
    x, aux = _backbone(cfg, params, tokens, token_mask=token_mask,
                       segment_ids=segment_ids)
    trim, targets, m, count = next_token_targets(cfg, region, tokens, mask)
    if trim:
        x = x[:, :-1]
    lm_head = region.param(params["lm_head"], ("embed", "vocab"))
    lm_head = lm_head.to(dtype_of(cfg.dtype))
    x = region.vocab_copy(x)
    if cfg.loss_chunk:
        nll = _chunked_nll(cfg, x, lm_head, targets, region)
    else:
        nll = _nll(cfg, x, lm_head, targets, region)
    if m is None:
        loss = nll.mean()
        if region.n_batch > 1:
            loss = loss / region.n_batch
    else:
        loss = (nll * m).sum() / region.batch_sum(count).clamp_min(1.0)
    if cfg.moe_experts and include_aux:
        # each (dp, fsdp) rank's aux is its rows' mean; every sp rank
        # routed the whole sequence, so holds the same one
        shares = region.n_batch * region.sizes["sp"]
        if shares > 1:
            aux = aux / shares
        loss = loss + cfg.moe_aux_weight * aux
    return region.data_sum(loss)
