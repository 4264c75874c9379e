"""Hugging Face Llama checkpoint ↔ the port's param tree (port of
``models/convert_hf.py``).

Any HF-layout Llama (Llama-2/3 family, ``LlamaForCausalLM``) loads into
``models/llama.py``'s tree: HF's LlamaModel uses the same rotate-half RoPE
as ``ops/rotary.py``, the same RMSNorm placement and the same SiLU
gate·up MLP, so the only changes are the layout ones (torch Linear [out,
in] → [in, out], layers stacked on a leading axis).

The functions take a plain ``{name: tensor}`` mapping, torch tensors or
numpy arrays, and a config dict or object; ``transformers`` is never
imported (``from_hf`` reads ``model.config`` and ``model.state_dict()``
of whatever it is given). Tensors are taken as they come and cast on the
target device, with no host hop: a bf16 checkpoint on the card converts
on the card.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


def config_from_hf(hf_cfg: Any) -> llama.LlamaConfig:
    """Map a ``transformers.LlamaConfig`` (or any object/dict with the
    same field names) to a :class:`llama.LlamaConfig`."""
    get = (hf_cfg.get if isinstance(hf_cfg, Mapping)
           else lambda k, d=None: getattr(hf_cfg, k, d))
    heads = get("num_attention_heads")
    hidden = get("hidden_size")
    scaling = get("rope_scaling") or {}
    rope_kw = {}
    if scaling:
        # HF aliases the type key; Llama-3.1+ checkpoints use "llama3"
        rope_type = scaling.get("rope_type") or scaling.get("type")
        if rope_type != "llama3":
            raise ValueError(
                f"unsupported rope_scaling type {rope_type!r}: only the "
                "Llama-3.1 'llama3' rule is implemented "
                "(ops/rotary.py); dropping it silently would corrupt "
                "long-context logits"
            )
        rope_kw = {
            "rope_scaling_factor": float(scaling["factor"]),
            "rope_low_freq_factor": float(
                scaling.get("low_freq_factor", 1.0)),
            "rope_high_freq_factor": float(
                scaling.get("high_freq_factor", 4.0)),
            "rope_original_max_seq": int(
                scaling.get("original_max_position_embeddings", 8192)),
        }
    return llama.LlamaConfig(
        vocab_size=get("vocab_size"),
        dim=hidden,
        n_layers=get("num_hidden_layers"),
        n_heads=heads,
        n_kv_heads=get("num_key_value_heads") or heads,
        head_dim=get("head_dim") or hidden // heads,
        mlp_dim=get("intermediate_size"),
        rope_theta=float(get("rope_theta") or 10_000.0),
        norm_eps=float(get("rms_norm_eps") or 1e-5),
        max_seq_len=get("max_position_embeddings") or 8192,
        **rope_kw,
    )


def _tensor(x) -> torch.Tensor:
    """A state-dict value as a tensor: torch tensors as they are, numpy
    arrays copied (dtypes torch lacks, such as bfloat16, through f32)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind != "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr.copy())


def params_from_hf_state_dict(cfg: llama.LlamaConfig,
                              sd: Mapping[str, Any], device=None) -> dict:
    """Build the port's param tree, in ``cfg.param_dtype`` on ``device``
    (the card unless ``"cpu"``), from an HF Llama state dict.

    Linear weights have torch's ``[out_features, in_features]`` layout and
    are transposed, because the model right-multiplies (``h @ w``); layer
    weights are stacked on a leading axis. The state dict's keys may carry
    the ``model.`` prefix or not. A missing ``lm_head.weight`` means tied
    embeddings: the head is a copy of the token embedding's transpose (a
    leaf of its own, as in the reference, so fine-tuning unties them)."""
    dev = resolve_device(device)
    pdt = llama.dtype_of(cfg.param_dtype)
    consumed = set()

    def a(name):
        consumed.add(name)
        return _tensor(sd[name]).to(device=dev, dtype=pdt)

    def linear(name):
        return a(name).T  # [out, in] -> [in, out]

    def stack(fmt, transform):
        return torch.stack([transform(fmt.format(i))
                            for i in range(cfg.n_layers)])

    def own(x):  # a contiguous copy: never the caller's storage
        return x.clone(memory_format=torch.contiguous_format)

    prefix = "model."
    if (f"{prefix}embed_tokens.weight" not in sd
            and "embed_tokens.weight" in sd):
        prefix = ""
    layer = prefix + "layers.{0}."
    params = {
        "tok_embed": own(a(f"{prefix}embed_tokens.weight")),
        "layers": {
            "attn_norm": stack(layer + "input_layernorm.weight", a),
            "wq": stack(layer + "self_attn.q_proj.weight", linear),
            "wk": stack(layer + "self_attn.k_proj.weight", linear),
            "wv": stack(layer + "self_attn.v_proj.weight", linear),
            "wo": stack(layer + "self_attn.o_proj.weight", linear),
            "mlp_norm": stack(layer + "post_attention_layernorm.weight", a),
            "w_gate": stack(layer + "mlp.gate_proj.weight", linear),
            "w_up": stack(layer + "mlp.up_proj.weight", linear),
            "w_down": stack(layer + "mlp.down_proj.weight", linear),
        },
        "final_norm": own(a(f"{prefix}norm.weight")),
    }
    head = "lm_head.weight"
    if head in sd:
        params["lm_head"] = own(linear(head))
    else:  # tied embeddings (Llama-3.2-1B/3B style)
        params["lm_head"] = own(params["tok_embed"].T)
    # every weight must have landed somewhere: a checkpoint with e.g.
    # attention biases (attention_bias=True variants) would otherwise
    # convert silently to wrong logits. Non-weight buffers are exempt.
    leftovers = {
        k for k in sd
        if k not in consumed and not k.endswith(".inv_freq")
    }
    if leftovers:
        raise ValueError(
            "unconverted weights in state dict (unsupported Llama "
            f"variant?): {sorted(leftovers)[:8]}"
        )
    return params


def from_hf(model, device=None) -> tuple[llama.LlamaConfig, dict]:
    """Convert an in-memory ``transformers.LlamaForCausalLM`` (anything
    with its ``config`` and ``state_dict()``) onto ``device``."""
    cfg = config_from_hf(model.config)
    return cfg, params_from_hf_state_dict(cfg, model.state_dict(),
                                          device=device)


def to_hf_state_dict(cfg: llama.LlamaConfig, params,
                     tie_word_embeddings: bool = False) -> dict:
    """Inverse of :func:`params_from_hf_state_dict`: the port's param tree
    → an HF Llama state dict (torch Linear ``[out, in]`` layout), to
    export a fine-tuned model back into the HF ecosystem. Each tensor is
    a contiguous copy on the params' device in the leaf's own dtype (the
    reference returns float32 numpy, which has no bfloat16; a bf16 tree
    exports the bf16 layout HF checkpoints ship). MoE trees have no HF
    Llama layout and are refused."""
    if cfg.moe_experts:
        raise ValueError(
            "HF LlamaForCausalLM has no MoE layout; export applies to "
            "dense configs only"
        )

    def t(x):  # [in, out] -> torch Linear [out, in]
        return x.T.contiguous()

    def plain(x):
        return x.clone()

    L = params["layers"]
    sd = {"model.embed_tokens.weight": plain(params["tok_embed"]),
          "model.norm.weight": plain(params["final_norm"])}
    per_layer = {
        "input_layernorm.weight": (L["attn_norm"], plain),
        "self_attn.q_proj.weight": (L["wq"], t),
        "self_attn.k_proj.weight": (L["wk"], t),
        "self_attn.v_proj.weight": (L["wv"], t),
        "self_attn.o_proj.weight": (L["wo"], t),
        "post_attention_layernorm.weight": (L["mlp_norm"], plain),
        "mlp.gate_proj.weight": (L["w_gate"], t),
        "mlp.up_proj.weight": (L["w_up"], t),
        "mlp.down_proj.weight": (L["w_down"], t),
    }
    for i in range(cfg.n_layers):
        for name, (stacked, transform) in per_layer.items():
            sd[f"model.layers.{i}.{name}"] = transform(stacked[i])
    if tie_word_embeddings:
        # lm_head and tok_embed are separate leaves in the tree, so
        # fine-tuning unties them: dropping a head that diverged from the
        # embedding would silently corrupt the exported model
        if not torch.allclose(params["lm_head"].float(),
                              params["tok_embed"].float().T,
                              rtol=1e-5, atol=1e-6):
            raise ValueError(
                "tie_word_embeddings=True but lm_head no longer equals "
                "tok_embed.T (fine-tuning untied them); export with "
                "tie_word_embeddings=False"
            )
    else:
        sd["lm_head.weight"] = t(params["lm_head"])
    return sd
