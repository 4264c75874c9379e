"""Ring attention: exact long-context attention over the ``sp`` mesh axis
(port of ``parallel/ring.py``).

Each rank holds a contiguous sequence chunk of q/k/v. The K/V chunks
rotate around the ring (``collectives.ring_shift``, point-to-point sends
to the next rank); at every step each rank attends its q chunk to the
visiting chunk and folds the result into a running log-sum-exp state:
exact, with O(seq / sp) memory per rank. Causality comes from the GLOBAL
position mask (a chunk entirely in the future contributes rows of (0,
-inf) and merges as a no-op), so every step runs the same arithmetic.

The chunk attention is dense arithmetic in the reference too (einsums,
no Pallas kernel): here torch einsums with f32 scores, so the ring
launches no flash kernel.
"""

from __future__ import annotations

import functools

import torch

from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)

NEG_INF = -2.0e38


def _chunk_attention_with_lse(q, k, v, q_off, k_off, scale):
    """Dense attention of a q chunk vs one kv chunk with GLOBAL causal mask.

    q [b,sq,h,d]; k/v [b,sk,hkv,d]; offsets are global sequence positions
    of element 0. Returns (out [b,sq,h,d] f32-normalized, lse [b,sq,h]
    f32); rows with no visible keys come back as (0, -inf) and merge as
    no-ops. The scores are f32 products of the operands (exact for bf16),
    and the probabilities are cast to v's dtype before the PV product, as
    the reference's einsums compute them."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
    k_pos = k_off + torch.arange(sk, device=q.device)[None, :]
    s = torch.where(q_pos >= k_pos, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # fully-masked rows: keep exp at 0, lse at -inf (no -inf - -inf NaN)
    m_safe = m.clamp_min(NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v).float()
    # l is [b,hkv,g,sq,1] → align to o [b,sq,hkv,g,d]
    l_t = l[..., 0].permute(0, 3, 1, 2)[..., None]
    o = o / l_t.clamp_min(1e-30)
    lse = torch.where(m[..., 0] <= NEG_INF / 2, NEG_INF,
                      m[..., 0] + torch.log(l[..., 0]))
    lse_t = lse.permute(0, 3, 1, 2).reshape(b, sq, hq)
    return o.reshape(b, sq, hq, d), lse_t


def _merge(o1, lse1, o2, lse2):
    """Fold two normalized partial attentions (log-sum-exp weighted)."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    w1 = torch.where(lse1 <= NEG_INF, 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(lse2 <= NEG_INF, 0.0, torch.exp(lse2 - m_safe))
    tot = (w1 + w2).clamp_min(1e-30)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / tot[..., None]
    lse = torch.where(m <= NEG_INF, NEG_INF, m_safe + torch.log(tot))
    return o, lse


def ring_attention_local(q, k, v, *, group=None, causal: bool = True):
    """Ring attention body on this rank's chunks (the reference's
    shard_map body): q/k/v [b, s_local, h(kv), d], a contiguous split of
    the global sequence over ``group`` (None: a ring of one). Returns the
    local output chunk in q.dtype. ``causal=False`` shifts the key
    offsets so every key is visible (the reference's ``q_off - 10**9``).
    The backward sends each K/V cotangent back around the ring."""
    n = cc.size(group)
    idx = 0 if group is None else torch.distributed.get_rank(group)
    b, sq, hq, d = q.shape
    scale = d ** -0.5
    s_local = k.shape[1]
    q_off = idx * sq
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                     device=q.device)
    kc, vc = k, v
    for step in range(n):
        j = (idx - step) % n
        k_off = j * s_local if causal else q_off - 10**9
        oj, lsej = _chunk_attention_with_lse(q, kc, vc, q_off, k_off, scale)
        o, lse = _merge(o, lse, oj, lsej)
        if step < n - 1:  # the reference's last rotation is never read
            kc, vc = cc.ring_shift(kc, group), cc.ring_shift(vc, group)
    return o.to(q.dtype)


def ring_attention(q, k, v, *, causal: bool = True, axis_name: str = "sp",
                   batch_axes=("dp", "fsdp"), head_axis: str = "tp",
                   kv_head_axis: str | None = None):
    """Sharded entry: ``ring_attention_local`` over the ``axis_name``
    ranks (``sharding.sp_attention``). q [b,s,hq,d], k/v [b,s,hkv,d] with
    seq sharded on ``axis_name``; batch on ``batch_axes``; heads on
    ``head_axis``."""
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        sp_attention,
    )

    return sp_attention(
        functools.partial(ring_attention_local, causal=causal), q, k, v,
        axis_name=axis_name, batch_axes=batch_axes, head_axis=head_axis,
        kv_head_axis=kv_head_axis)
