"""Multi-head attention front-end (port of ``ops/attention.py``).

``impl``:
  "dense"  plain PyTorch causal softmax attention (the reference).
  "flash"  the flash-attention forward (ops/flash_attention.py): the
           hand-written Hopper kernel on a CUDA tensor, its plain version
           on a CPU tensor.
  "ring"   ring attention over the ``sp`` ranks (parallel/ring.py): dense
           chunk arithmetic with f32 scores, no flash kernel.
  "ulysses" all-to-all sequence parallelism (parallel/ulysses.py) around
           the flash path on the local heads.

"ring" and "ulysses" take the sharded entries, which read DTensor inputs
or the ambient mesh and are a ring of one outside any mesh. (The model
computes on local blocks and calls the ``*_local`` bodies itself, through
``parallel.sharding.LocalRegion``.)

All impls take q/k/v shaped ``[batch, seq, heads, head_dim]``; kv may have
fewer heads (GQA by head-group reshape, never a KV repeat).
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def _dense_attention(q, k, v, scale: float, causal: bool = True,
                     segment_ids=None):
    """Causal softmax attention with GQA via head-group einsum.

    q: [b, sq, hq, d]; k/v: [b, sk, hkv, d]; hq = hkv * g. Scores are
    f32 (bf16 operands upcast: their products are exact in f32), the
    causal mask is END-aligned (``q_pos + (sk - sq) >= k_pos``), masked
    entries are ``-2e38``, and the f32 softmax is cast to ``v.dtype``
    before the PV product. ``segment_ids`` [b, s] blocks attention across
    packed-document boundaries (requires sq == sk).
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        mask = q_pos + (sk - sq) >= k_pos
        logits = logits.masked_fill(~mask, NEG_INF)
    if segment_ids is not None:
        if sq != sk:
            raise ValueError("segment_ids need sq == sk")
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~same[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def multi_head_attention(q, k, v, *, impl: str = "dense",
                         causal: bool = True, segment_ids=None):
    """Dispatch attention. Returns ``[b, sq, hq, d]`` in q.dtype.
    ``segment_ids`` is a dense-path feature: with any other impl it
    raises rather than silently attending across documents."""
    if segment_ids is not None and impl != "dense":
        raise ValueError(
            f"segment_ids requires attn_impl='dense' (got {impl!r}); "
            "packed windows under flash/ring/ulysses train with the "
            "boundary loss mask only"
        )
    if impl == "flash":
        from service_account_auth_improvements_tpu_torch.ops.flash_attention import (  # noqa: E501
            flash_attention,
        )

        return flash_attention(q, k, v, causal=causal)
    if impl == "ring":
        from service_account_auth_improvements_tpu_torch.parallel import (
            ring,
        )

        return ring.ring_attention(q, k, v, causal=causal)
    if impl == "ulysses":
        from service_account_auth_improvements_tpu_torch.parallel import (
            ulysses,
        )

        return ulysses.ulysses_attention(q, k, v, causal=causal)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _dense_attention(q, k, v, q.shape[-1] ** -0.5, causal=causal,
                            segment_ids=segment_ids)
