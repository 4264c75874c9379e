"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange
(port of ``parallel/ulysses.py``).

Each rank holds a contiguous sequence chunk of q/k/v. One all-to-all over
the ``sp`` ranks re-partitions them so that every rank holds the WHOLE
sequence for ``heads/sp`` of its local heads; attention then runs
unmodified (the flash kernels see an ordinary [b, s, h_local, d]
problem) and a fourth all-to-all restores the sequence split. Local head
counts must divide by ``sp`` (ring has no such constraint). Reference
point for the pattern: DeepSpeed-Ulysses (arXiv:2309.14509).
"""

from __future__ import annotations

import functools

from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)


def ulysses_attention_local(q, k, v, *, group=None, causal: bool = True,
                            inner_impl: str = "flash"):
    """All-to-all attention body on this rank's chunks: q [b, s_local,
    hq_local, d]; k/v [b, s_local, hkv_local, d] over ``group`` (None: one
    rank, where the exchanges are the identity). Returns the local output
    chunk [b, s_local, hq_local, d] in q.dtype."""
    from service_account_auth_improvements_tpu_torch.ops.attention import (
        multi_head_attention,
    )

    n = cc.size(group)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n or hkv % n:
        raise ValueError(
            f"ulysses needs local head counts divisible by sp={n}; got "
            f"q heads {hq}, kv heads {hkv} (lower tp or sp, or use ring)"
        )
    # seq-sharded → head-sharded: split heads, gather sequence
    q, k, v = (cc.all_to_all(t, 2, 1, group) for t in (q, k, v))
    out = multi_head_attention(q, k, v, impl=inner_impl, causal=causal)
    # head-sharded → seq-sharded: split sequence, gather heads
    return cc.all_to_all(out, 1, 2, group)


def ulysses_attention(q, k, v, *, causal: bool = True,
                      axis_name: str = "sp", inner_impl: str = "flash",
                      batch_axes=("dp", "fsdp"), head_axis: str = "tp",
                      kv_head_axis: str | None = None):
    """Sharded entry (the calling convention of ``ring_attention``): q
    [b,s,hq,d], k/v [b,s,hkv,d] with seq sharded on ``axis_name``, heads
    on ``head_axis``. ``inner_impl`` is the per-rank attention ("flash":
    the port's kernels on the card, their plain versions on the CPU)."""
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        sp_attention,
    )

    return sp_attention(
        functools.partial(ulysses_attention_local, causal=causal,
                          inner_impl=inner_impl), q, k, v,
        axis_name=axis_name, batch_axes=batch_axes, head_axis=head_axis,
        kv_head_axis=kv_head_axis)
