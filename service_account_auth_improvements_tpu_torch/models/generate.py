"""Autoregressive generation with a preallocated KV cache (port of
``models/generate.py``).

The cache is ``[L, b, max_len, kv_heads, head_dim]`` and, unlike the
reference's functional ``dynamic_update_slice``, is written IN PLACE (a
``KVCache`` returned by ``extend_cache`` shares its tensors with the one
passed in). Decode attention is a masked dense read over the whole cache,
as in the reference. The reference's ``lax.scan`` loops are Python loops
here and there is no ``jit``: every public function runs eagerly under
``torch.inference_mode()``.

Prefill reuses the model forward: ``llama._backbone(return_layer_inputs=
True)`` yields every layer's input, and each layer's K/V for the prompt
is recomputed from them. Per-length prefill (``prefill``) runs flash
attention when ``cfg.attn_impl == "flash"``: the Hopper kernel on the card.

Sampling draws from a ``torch.Generator`` (in place of ``jax.random``
keys): the same filters as the reference, other draws.

Under a tp/fsdp mesh (``parallel.use_mesh``, as ``models/serving.py``'s
``GenerationService(mesh=)`` enters it) every function here runs in the
mesh's region, each rank on the whole batch: the weights are gathered
over fsdp at use, each tp rank holds its kv heads of the cache and its
heads, mlp and vocabulary shards, the row-parallel products are summed
over tp and the logits gathered over it, so every rank samples the same
tokens from the same generator seed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.ops.attention import NEG_INF
from service_account_auth_improvements_tpu_torch.ops.norms import rms_norm
from service_account_auth_improvements_tpu_torch.ops.rotary import (
    apply_rope,
    rope_table,
)
from service_account_auth_improvements_tpu_torch.parallel.sharding import (
    NO_REGION,
    local_region,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


def _inference_cfg(cfg: llama.LlamaConfig) -> llama.LlamaConfig:
    """Inference routes MoE dropless: capacity is the whole routing
    group, so no token falls through to the residual. Training's capacity
    drops are not prefix-stable (a token kept at length s can be dropped
    at s + 1, as capacity grows with the group), so a KV cache could not
    reproduce them; dropless routing is causally consistent."""
    if not cfg.moe_experts:
        return cfg
    return dataclasses.replace(cfg, moe_dropless=True)


class KVCache(NamedTuple):
    k: torch.Tensor   # [L, b, max_len, kv_heads, head_dim]
    v: torch.Tensor   # [L, b, max_len, kv_heads, head_dim]
    length: int       # filled positions (same for the batch)


def _on_device(params, tokens, device):
    """``tokens`` as int64 on the params' device, after checking that
    device is the one asked for (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    pdev = params["tok_embed"].device
    if pdev.type != dev.type:
        raise ValueError(f"params are on {pdev}, but device {dev} was "
                         "asked for")
    return torch.as_tensor(tokens, dtype=torch.long, device=pdev)


def _kv_heads(cfg, region) -> int:
    """The kv heads a rank holds (its tp share)."""
    return cfg.n_kv_heads // region.sizes["tp"]


def _rope(cfg, length: int, device):
    return rope_table(length, cfg.head_dim, cfg.rope_theta,
                      scaling=cfg.rope_scaling(), device=device)


@torch.inference_mode()
def prefill(cfg: llama.LlamaConfig, params, tokens, max_len: int,
            device=None):
    """Run the prompt through the model once → (cache, last_logits f32).
    tokens [b, s] (no padding); the cache holds the prompt's K/V in
    [:s] of ``max_len`` positions."""
    cfg = _inference_cfg(cfg)
    tokens = _on_device(params, tokens, device)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cdt = llama.dtype_of(cfg.dtype)
    region = local_region()
    x, _, layer_inputs = llama._backbone(cfg, params, tokens,
                                         return_layer_inputs=True)
    # every layer's k/v from the saved layer inputs, one batched product
    axes = llama.logical_axes(cfg)["layers"]
    lp = {n: region.param(params["layers"][n], axes[n])
          for n in ("attn_norm", "wk", "wv")}
    h = rms_norm(layer_inputs, lp["attn_norm"].to(cdt)[:, None, None],
                 cfg.norm_eps)
    kvh = _kv_heads(cfg, region)
    shape = (cfg.n_layers, b, s, kvh, cfg.head_dim)
    k = torch.einsum("lbsd,ldk->lbsk", h, lp["wk"].to(cdt)).reshape(shape)
    v = torch.einsum("lbsd,ldk->lbsk", h, lp["wv"].to(cdt)).reshape(shape)
    cos, sin = _rope(cfg, s, x.device)
    k = apply_rope(k, cos, sin)  # broadcasts over the leading layer axis

    full = (cfg.n_layers, b, max_len, kvh, cfg.head_dim)
    ck = torch.zeros(full, dtype=cdt, device=x.device)
    cv = torch.zeros(full, dtype=cdt, device=x.device)
    ck[:, :, :s] = k
    cv[:, :, :s] = v
    return KVCache(ck, cv, s), llama.lm_logits(cfg, params, x[:, -1])


def _extend_layer(cfg, x, lp, ck, cv, pos0: int, cos_w, sin_w,
                  region=NO_REGION):
    """One layer over an m-token window at positions pos0..pos0+m-1;
    ck/cv [b, max_len, kvh, hd] are written in place. Causal within the
    window, full visibility of the cache. Returns x. In a mesh's region
    ``lp`` holds the layer's local blocks and the heads are the rank's
    tp share."""
    b, m, _ = x.shape
    cdt = llama.dtype_of(cfg.dtype)
    max_len = ck.shape[1]
    if region is not NO_REGION:
        axes = llama.logical_axes(cfg)["layers"]
        lp = {n: region.param(t, axes[n][1:],
                              experts_local=n.startswith("moe_"))
              for n, t in lp.items()}
    kvh = ck.shape[2]

    h = rms_norm(x, lp["attn_norm"].to(cdt), cfg.norm_eps)
    q = (h @ lp["wq"].to(cdt)).reshape(b, m, -1, cfg.head_dim)
    k = (h @ lp["wk"].to(cdt)).reshape(b, m, kvh, cfg.head_dim)
    v = (h @ lp["wv"].to(cdt)).reshape(b, m, kvh, cfg.head_dim)
    q = apply_rope(q, cos_w, sin_w)
    k = apply_rope(k, cos_w, sin_w)
    ck[:, pos0:pos0 + m] = k
    cv[:, pos0:pos0 + m] = v

    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, m, kvh, g, cfg.head_dim)
    # f32 scores from compute-dtype operands (preferred_element_type)
    scores = torch.einsum("bmkgd,bskd->bkgms", qg.float(), ck.float())
    scores = scores * (cfg.head_dim ** -0.5)     # [b, kvh, g, m, max_len]
    cols = torch.arange(max_len, device=x.device)
    rows = pos0 + torch.arange(m, device=x.device)
    mask = cols[None, :] <= rows[:, None]        # [m, max_len]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    attn = torch.einsum("bkgms,bskd->bmkgd", probs, cv)
    x = x + region.tp_sum(attn.reshape(b, m, -1) @ lp["wo"].to(cdt))

    h = rms_norm(x, lp["mlp_norm"].to(cdt), cfg.norm_eps)
    if cfg.moe_experts:
        ff, _ = llama._moe_ffn(cfg, h, lp, region=region)
        return x + ff
    gate = torch.nn.functional.silu(h @ lp["w_gate"].to(cdt))
    up = h @ lp["w_up"].to(cdt)
    return x + region.tp_sum((gate * up) @ lp["w_down"].to(cdt))


@torch.inference_mode()
def extend_cache(cfg, params, cache: KVCache, tokens, cos, sin):
    """Continue the sequence with an m-token window: tokens [b, m] at
    positions cache.length.. → (cache', logits [b, m, V] f32). The
    window's K/V are written into ``cache``'s tensors in place.
    ``cos``/``sin`` are the full-length rope tables."""
    cdt = llama.dtype_of(cfg.dtype)
    m = tokens.shape[1]
    pos0 = cache.length
    if pos0 + m > cache.k.shape[2]:
        raise ValueError(f"window of {m} at {pos0} overflows the cache "
                         f"({cache.k.shape[2]})")
    region = local_region()
    x = llama.embed(cfg, params, tokens, region)
    cos_w, sin_w = cos[pos0:pos0 + m], sin[pos0:pos0 + m]
    for i in range(cfg.n_layers):
        x = _extend_layer(cfg, x, llama.layer_params(params, i),
                          cache.k[i], cache.v[i], pos0, cos_w, sin_w,
                          region)
    x = rms_norm(x, region.param(params["final_norm"], ("norm",)).to(cdt),
                 cfg.norm_eps)
    return (KVCache(cache.k, cache.v, pos0 + m),
            llama.lm_logits(cfg, params, x))


def _decode_step(cfg, params, cache: KVCache, token, cos, sin):
    """token [b] at position cache.length → (cache', logits [b, V])."""
    cache, logits = extend_cache(cfg, params, cache, token[:, None],
                                 cos, sin)
    return cache, logits[:, 0]


def _filter(logits, temperature: float, top_k: int, top_p: float,
            use_top_p: bool):
    """Temperature, then top-k and top-p as THRESHOLDS (logits below the
    bound become -2e38; ties at the boundary are all kept)."""
    logits = logits / temperature
    if top_k:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    if use_top_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # exclusive prefix: rank 0 kept
        thresh = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        thresh = thresh.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    return logits


def _sample(logits, generator, temperature: float, top_k: int, top_p: float,
            *, greedy: bool, use_top_p: bool):
    """Greedy argmax, or a categorical draw (Gumbel-max, as
    ``jax.random.categorical``) from the filtered logits."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = _filter(logits, temperature, top_k, top_p, use_top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _decode_scan(cfg, params, cache, token, done, n: int, sample, eos_id,
                 use_eos, cos, sin):
    """``n`` decode steps, shared by the one-shot and chunked paths.
    Returns (cache, token, done, toks [b, n])."""
    toks = []
    for _ in range(n):
        cache, logits = _decode_step(cfg, params, cache, token, cos, sin)
        nxt = sample(logits)
        if use_eos:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        token = nxt
        toks.append(nxt)
    out = (torch.stack(toks, dim=1) if toks
           else token.new_zeros((token.shape[0], 0)))
    return cache, token, done, out


def _sampling_statics(temperature: float, top_k: int, top_p: float):
    temperature, top_p = float(temperature), float(top_p)
    greedy = temperature == 0.0
    if greedy:
        top_k, top_p = 0, 0.0
    return (1.0 if greedy else temperature, top_p, int(top_k), greedy,
            bool(top_p) and top_p < 1.0)


def _sampler(generator, temperature, top_k, top_p):
    t, p, k_, greedy, use_top_p = _sampling_statics(temperature, top_k,
                                                    top_p)

    def sample(logits):
        return _sample(logits, generator, t, k_, p, greedy=greedy,
                       use_top_p=use_top_p)
    return sample


def _generator(generator, dev):
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    return generator


@torch.inference_mode()
def generate(cfg: llama.LlamaConfig, params, prompt, max_new_tokens: int,
             generator=None, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, eos_id: int | None = None, device=None):
    """prompt [b, s] → [b, s + max_new_tokens]: prefill, then
    ``max_new_tokens - 1`` decode steps after the prefill's token.
    Greedy when temperature=0. With ``eos_id``, rows that emitted it are
    padded with it from then on."""
    cfg = _inference_cfg(cfg)
    prompt = _on_device(params, prompt, device)
    b, s = prompt.shape
    max_len = s + max_new_tokens
    cache, logits = prefill(cfg, params, prompt, max_len, device=device)
    cos, sin = _rope(cfg, max_len, prompt.device)
    sample = _sampler(_generator(generator, prompt.device), temperature,
                      top_k, top_p)
    first = sample(logits)
    use_eos = eos_id is not None
    done = (first == eos_id) if use_eos else torch.zeros(
        b, dtype=torch.bool, device=prompt.device)
    _, _, _, toks = _decode_scan(cfg, params, cache, first, done,
                                 max_new_tokens - 1, sample, eos_id,
                                 use_eos, cos, sin)
    return torch.cat([prompt, first[:, None], toks], dim=1)


@torch.inference_mode()
def prefill_chunked(cfg: llama.LlamaConfig, params, prompt, max_len: int,
                    window: int = 512, device=None):
    """``prefill`` in fixed-size windows → (cache, last_logits). The tail
    window is zero-padded and the cache length rolled back to the real
    tokens; the cache is ``max_len`` rounded up to whole windows, so the
    padded tail never overflows it."""
    cfg = _inference_cfg(cfg)
    prompt = _on_device(params, prompt, device)
    b, s = prompt.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cdt = llama.dtype_of(cfg.dtype)
    alloc = -(-max_len // window) * window
    full = (cfg.n_layers, b, alloc, _kv_heads(cfg, local_region()),
            cfg.head_dim)
    cache = KVCache(torch.zeros(full, dtype=cdt, device=prompt.device),
                    torch.zeros(full, dtype=cdt, device=prompt.device), 0)
    cos, sin = _rope(cfg, alloc, prompt.device)
    logits = None
    for start in range(0, s, window):
        chunk = prompt[:, start:start + window]
        n_real = chunk.shape[1]
        if n_real < window:
            chunk = torch.nn.functional.pad(chunk, (0, window - n_real))
        cache, win_logits = extend_cache(cfg, params, cache, chunk, cos, sin)
        # K/V beyond n_real are garbage: masked by the rolled-back length
        # and overwritten by the next window's writes
        cache = cache._replace(length=cache.length - window + n_real)
        logits = win_logits[:, n_real - 1]
    return cache, logits


class StreamState(NamedTuple):
    """Carry between ``stream_decode`` chunks. ``token`` is the newest
    sampled token (already emitted); ``done`` marks rows past their
    eos."""
    cache: KVCache
    token: torch.Tensor      # [b] int64
    done: torch.Tensor       # [b] bool
    generator: torch.Generator


@torch.inference_mode()
def start_stream(cfg: llama.LlamaConfig, params, prompt,
                 max_new_tokens: int, generator=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int | None = None,
                 prefill_window: int | None = None, device=None):
    """Begin chunked decoding: returns (StreamState, first_token [b]).
    ``prefill_window`` selects the fixed-window chunked prefill; without
    it the prompt goes through the per-length ``prefill``."""
    cfg = _inference_cfg(cfg)
    prompt = _on_device(params, prompt, device)
    b, s = prompt.shape
    if prefill_window:
        cache, logits = prefill_chunked(cfg, params, prompt,
                                        s + max_new_tokens,
                                        window=prefill_window, device=device)
    else:
        cache, logits = prefill(cfg, params, prompt, s + max_new_tokens,
                                device=device)
    generator = _generator(generator, prompt.device)
    first = _sampler(generator, temperature, top_k, top_p)(logits)
    done = (first == eos_id) if eos_id is not None else torch.zeros(
        b, dtype=torch.bool, device=prompt.device)
    return StreamState(cache, first, done, generator), first


@torch.inference_mode()
def stream_decode(cfg: llama.LlamaConfig, params, state: StreamState,
                  n: int, temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0, eos_id: int | None = None,
                  device=None):
    """Decode ``n`` more tokens: (StreamState, tokens [b, n]). Pass the
    same sampling args as ``start_stream``."""
    cfg = _inference_cfg(cfg)
    _on_device(params, state.token, device)
    max_len = state.cache.k.shape[2]
    if state.cache.length + n > max_len:
        raise ValueError(
            f"chunk of {n} exceeds the stream's token budget "
            f"(cache {max_len}, used {state.cache.length})"
        )
    cos, sin = _rope(cfg, max_len, state.token.device)
    sample = _sampler(state.generator, temperature, top_k, top_p)
    cache, token, done, toks = _decode_scan(
        cfg, params, state.cache, state.token, state.done, n, sample,
        eos_id, eos_id is not None, cos, sin)
    return StreamState(cache, token, done, state.generator), toks
