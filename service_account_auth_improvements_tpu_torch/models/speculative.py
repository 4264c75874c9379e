"""Speculative decoding: a small draft model proposes, the target verifies
(port of ``models/speculative.py``).

Each round the draft runs γ+1 single-token decode steps on its own KV
cache (the last one only writes the cache, so it holds K/V for every token
that may be accepted), the target scores the whole proposal window with
ONE ``generate.extend_cache`` forward, and acceptance and the correction
token are computed on the device; the host reads the round's emitted
tokens once. Both caches roll back by their ``length`` alone: stale
entries past it are masked by position and overwritten by later writes.

Sampling follows Leviathan et al. / Chen et al. rejection sampling, so the
output distribution is the target's; greedy speculative decoding is
token-identical to plain greedy decoding of the target. Draws come from an
explicit ``torch.Generator`` (other draws than ``jax.random``'s). Batch 1:
rows accepting different counts would need per-row cache lengths.
"""

from __future__ import annotations

import torch

from service_account_auth_improvements_tpu_torch.models import generate, llama


def _spec_round(cfg_t, cfg_d, params_t, params_d, cache_t, cache_d, token,
                temperature: float, generator, ropes, *, gamma: int,
                greedy: bool):
    """One propose-verify round from the last emitted ``token`` [1]. Returns
    (cache_t', cache_d', new tokens (a list of 1..γ+1 ids: the accepted
    prefix and one correction or bonus token), accepted count)."""
    cos_t, sin_t, cos_d, sin_d = ropes
    dev = token.device
    length = cache_t.length
    temp = 1.0 if greedy else temperature

    # draft: gamma proposals, then one cache-only step
    proposals, p_d = [], []
    tok = token
    for _ in range(gamma + 1):
        cache_d, logits = generate._decode_step(cfg_d, params_d, cache_d, tok,
                                                cos_d, sin_d)
        logits = logits[0] / temp
        if greedy:
            nxt = torch.argmax(logits)
        else:
            p = torch.softmax(logits, dim=-1)
            nxt = torch.multinomial(p, 1, generator=generator)[0]
            p_d.append(p)
        proposals.append(nxt)
        tok = nxt[None]
    q = torch.stack(proposals[:gamma])                       # [gamma]

    # target: score the window (token, q_0 .. q_{gamma-1}) in one forward
    window = torch.cat([token, q])[None]                     # [1, gamma+1]
    cache_t, logits_t = generate.extend_cache(cfg_t, params_t, cache_t,
                                              window, cos_t, sin_t)
    logits_t = logits_t[0] / temp                            # [gamma+1, V]

    # accept the longest prefix, then the correction (or bonus) token
    if greedy:
        best = torch.argmax(logits_t, dim=-1)                # [gamma+1]
        accept = q == best[:gamma]
    else:
        p_t = torch.softmax(logits_t, dim=-1)
        p_d = torch.stack(p_d[:gamma])                       # [gamma, V]
        idx = torch.arange(gamma, device=dev)
        u = torch.rand(gamma, generator=generator, device=dev)
        ratio = p_t[idx, q] / p_d[idx, q].clamp_min(1e-20)
        accept = u < ratio.clamp_max(1.0)
    n = torch.cumprod(accept.long(), dim=0).sum()            # 0..gamma
    if greedy:
        extra = best[n]
    else:
        resid = (p_t[:gamma] - p_d).clamp_min(0.0)
        mass = resid.sum(dim=-1, keepdim=True)
        # a degenerate residual (p_t <= p_d everywhere) falls back to p_t
        resid = torch.where(mass > 1e-9, resid / mass.clamp_min(1e-9),
                            p_t[:gamma])
        r = torch.multinomial(resid, 1, generator=generator)[:, 0]
        bonus = torch.multinomial(p_t[gamma], 1, generator=generator)[0]
        extra = torch.where(n < gamma, r[n.clamp_max(gamma - 1)], bonus)
    out = torch.where(torch.arange(gamma + 1, device=dev) < n,
                      torch.cat([q, q.new_zeros(1)]), extra)

    # the round's one host read: the accepted count and the tokens
    n_acc, *out = torch.cat([n[None], out]).tolist()
    # roll both caches back to the verified history: L + token + accepts
    new_len = length + 1 + n_acc
    return (cache_t._replace(length=new_len),
            cache_d._replace(length=new_len), out[:n_acc + 1], n_acc)


@torch.inference_mode()
def spec_generate(cfg_t: llama.LlamaConfig, params_t, cfg_d: llama.LlamaConfig,
                  params_d, prompt, max_new_tokens: int, gamma: int = 4,
                  generator=None, temperature: float = 0.0,
                  eos_id: int | None = None, alloc_tokens: int | None = None,
                  prefill_window: int | None = None, device=None):
    """Speculative generation on ``device`` (the card unless ``"cpu"``):
    prompt [1, s] → ([1, s + ≤max_new_tokens], stats). Greedy output is
    token-identical to ``generate.generate`` on the target alone;
    temperature > 0 samples the target's distribution by rejection
    sampling. ``stats`` reports the acceptance rate (target forwards per
    token ≈ 1 / (1 + rate·γ)).

    ``alloc_tokens`` (≥ max_new_tokens) sizes the KV caches without
    changing how many tokens are generated (a server passes its pow-2
    token bucket). ``prefill_window`` runs both prefills chunked
    (``generate.prefill_chunked``); without it they are the per-length
    ``generate.prefill``, which runs flash attention."""
    prompt = generate._on_device(params_t, prompt, device)
    generate._on_device(params_d, prompt, device)
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1")
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError("draft and target vocabularies must match")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    cfg_t = generate._inference_cfg(cfg_t)
    cfg_d = generate._inference_cfg(cfg_d)
    greedy = temperature == 0.0
    s = prompt.shape[1]
    # +gamma+1 slack: the final round's window may write past the budget
    max_len = s + max(alloc_tokens or 0, max_new_tokens) + gamma + 1
    if prefill_window:
        cache_t, logits = generate.prefill_chunked(
            cfg_t, params_t, prompt, max_len, window=prefill_window,
            device=device)
        cache_d, _ = generate.prefill_chunked(
            cfg_d, params_d, prompt, max_len, window=prefill_window,
            device=device)
    else:
        cache_t, logits = generate.prefill(cfg_t, params_t, prompt, max_len,
                                           device=device)
        cache_d, _ = generate.prefill(cfg_d, params_d, prompt, max_len,
                                      device=device)
    generator = generate._generator(generator, prompt.device)
    first = generate._sampler(generator, temperature, 0, 0.0)(logits)
    ropes = (*generate._rope(cfg_t, cache_t.k.shape[2], prompt.device),
             *generate._rope(cfg_d, cache_d.k.shape[2], prompt.device))

    emitted = first.tolist()
    proposed = accepted = 0
    while len(emitted) < max_new_tokens and (
            eos_id is None or emitted[-1] != eos_id):
        token = torch.tensor(emitted[-1:], device=prompt.device)
        cache_t, cache_d, new, n_acc = _spec_round(
            cfg_t, cfg_d, params_t, params_d, cache_t, cache_d, token,
            temperature, generator, ropes, gamma=gamma, greedy=greedy)
        proposed += gamma
        accepted += n_acc
        if eos_id is not None and eos_id in new:
            new = new[: new.index(eos_id) + 1]
        emitted.extend(new)

    emitted = emitted[:max_new_tokens]
    toks = torch.cat([prompt, torch.tensor([emitted], device=prompt.device)],
                     dim=1)
    stats = {
        "proposed": proposed,
        "accepted": accepted,
        "acceptance_rate": (round(accepted / proposed, 4) if proposed
                            else 0.0),
    }
    return toks, stats
