"""Differentiable collectives over one mesh dimension's process group.

JAX differentiates its collectives itself (the transpose of an all-gather
is a reduce-scatter, of a ``ppermute`` the reverse permutation, of an
all-to-all the inverse exchange); here each is a ``torch.autograd.Function``
with that backward written out. A group of ``None`` (a mesh dimension of
size 1) makes every one of them the identity, with no call at all, so a
one-card mesh runs the plain arithmetic. The group is bound when the
forward runs, so a backward (or a rematerialised forward) on autograd's
device thread uses the same group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x, dim: int, group):
    n = size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim: int, group):
    n = size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad_sum):
        ctx.dim, ctx.group, ctx.grad_sum = dim, group, grad_sum
        ctx.n = x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None, None


def all_gather(x, dim: int, group, grad_sum: bool = True):
    """Concatenate the ranks' ``x`` along ``dim`` in rank order. The
    backward reduce-scatters the cotangent (``grad_sum``: the ranks
    computed on different data, so their contributions add) or keeps this
    rank's slice of it (the ranks computed the same thing)."""
    if size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group, grad_sum)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x, group):
    """All-reduce (sum) in the forward, identity in the backward:
    Megatron's ``g``, after a row-parallel product, and the data-parallel
    sum of a loss whose every rank differentiates its own share."""
    if size(group) == 1:
        return x
    return _SumForward.apply(x, group)


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_backward(x, group):
    """Identity in the forward, all-reduce (sum) of the cotangent in the
    backward: Megatron's ``f``, before a column-parallel product, where
    each rank's partial gradient of a replicated activation adds up."""
    if size(group) == 1:
        return x
    return _SumBackward.apply(x, group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x, group):
    """All-reduce (sum) in the forward and in the backward: a sum every
    rank goes on to use (cross-replica batch-norm statistics), whose
    cotangent is each rank's share of the loss's, so the shares add."""
    if size(group) == 1:
        return x
    return _AllSum.apply(x, group)


def _shift(x, group, step: int):
    """Send ``x`` to the rank ``step`` ahead in the group, receive the
    one from ``step`` behind (``ppermute`` with ``i -> i + step``)."""
    n, r = size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        # the transpose of i -> i+1 is i -> i-1
        return _shift(g, ctx.group, -1), None


def ring_shift(x, group):
    """``x`` of the previous rank of the ring (rank i sends to i+1)."""
    if size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def _a2a(x, split_dim: int, concat_dim: int, group):
    n = size(group)
    src = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return _a2a(g, concat_dim, split_dim, group), None, None, None


def all_to_all(x, split_dim: int, concat_dim: int, group):
    """Tiled all-to-all (``jax.lax.all_to_all(tiled=True)``): ``x`` is cut
    into n blocks along ``split_dim``, block j goes to rank j, and the
    blocks received are joined along ``concat_dim`` in rank order. The
    backward is the inverse exchange."""
    if size(group) == 1:
        return x
    if x.shape[split_dim] % size(group):
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide over {size(group)} ranks")
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def shift(x, group, step: int = 1):
    """``_shift`` outside autograd (the pipeline's hop, whose backward
    ``parallel/pipeline.py`` schedules itself); the identity on a group
    of one."""
    if size(group) == 1:
        return x
    return _shift(x, group, step)


@torch.no_grad()
def all_reduce_(x, groups):
    """Sum ``x`` in place over each group of ``groups`` (None skipped);
    outside autograd."""
    for g in groups:
        if size(g) > 1:
            dist.all_reduce(x, group=g)
    return x
