"""GPipe pipeline parallelism over the ``pp`` mesh axis (port of
``parallel/pipeline.py``).

Each pipeline stage owns a contiguous slab of the stacked decoder layers
(the layer stack is sharded over ``pp`` on its leading axis, rule
``"layers": "pp"``). The batch is split into ``M`` microbatches; every
tick each stage applies its slab to its resident microbatch and hands the
activation to the next stage with one hop of a ring, so the schedule is
``M + P - 1`` ticks for ``P`` stages, and the bubble fraction is
``(P-1)/(M+P-1)``.

The reference writes the schedule as one ``lax.scan`` and lets AD turn
each ``ppermute`` into its inverse. Here the forward ticks and the
reverse ticks are both written out, in one ``torch.autograd.Function``
(``_GPipe``): autograd runs a collective's backward only on the ranks
whose graph needs it, and a stage in its bubble, or a stage whose input
needs no gradient, would skip a hop its neighbours wait on. The backward
of the pipeline is the forward's ticks in reverse: each stage receives
the gradient of its output over the reverse hop, backpropagates its
saved microbatch graph through its slab and sends the gradient of its
input back. Every rank runs every hop, forward and backward.

Bubble ticks compute nothing: a stage whose microbatch index ``t -
stage`` is out of range hands on what it received. The reference
computes them and masks their aux loss, which gives the same result. So
per step each stage runs its slab once per microbatch: with flash
attention that is ``M · L/P`` launches of K1 in the forward, as many in
the remat recompute, and ``M · L/P`` each of K2 and K3.

Stage 0 reads the microbatches; the last stage's outputs are broadcast
over pp, so every rank continues with the whole result (the reference's
slice of the last stage's buffer). The input's gradient is summed over pp
(only stage 0 produced it), so a weight used before the pipeline
(``tok_embed``) gets the same gradient on every stage, as one used after
it (``final_norm``, ``lm_head``) does.

The hop is a ring object: over the ``pp`` process group (``DistRing``,
one stage per rank) or a rotation of a list of stages in one process
(``LocalRing``, ``pipeline_local``), which runs the same ticks and is how
a single card checks a schedule of several stages.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)


def pipeline_stages(axis_name: str = "pp") -> int:
    """Size of the pipeline axis in the ambient mesh (1 = no pipeline)."""
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        local_region,
    )

    return local_region().sizes[axis_name]


def default_microbatches(b: int, n_stages: int) -> int:
    """The largest divisor of ``b`` that is at most ``2 · n_stages``
    (a bubble under a third when ``b`` allows; 1 always divides)."""
    return max(m for m in range(1, min(b, 2 * n_stages) + 1) if b % m == 0)


def check_shapes(n_layers: int, n_stages: int, b: int, n_micro: int) -> int:
    """The reference's errors, in its order; returns the microbatch count
    (``n_micro``, or the default for 0)."""
    if n_stages == 1:
        raise ValueError("pipeline_layers needs a mesh with pp > 1 in "
                         "scope; use the plain scan path otherwise")
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} not divisible by pp={n_stages}")
    n_micro = n_micro or default_microbatches(b, n_stages)
    if b % n_micro:
        raise ValueError(f"batch={b} not divisible by n_micro={n_micro}")
    return n_micro


class DistRing:
    """The hop over the ``pp`` group: this process runs one stage."""

    def __init__(self, group, n_stages: int, stage: int):
        self.group, self.n_stages = group, n_stages
        self.stages = [stage]

    def shift(self, ys):
        """Each stage's output → the next stage's input (i → i+1)."""
        return [cc.shift(ys[0], self.group, 1)]

    def shift_back(self, gs):
        """The transpose: each stage's input gradient → the previous
        stage's output gradient (i → i-1)."""
        return [cc.shift(gs[0], self.group, -1)]

    def from_last(self, y, like):
        """The last stage's ``y`` on every stage (``like`` elsewhere)."""
        out = (y if self.stages[0] == self.n_stages - 1
               else torch.empty_like(like)).contiguous()
        dist.broadcast(out, dist.get_global_rank(self.group,
                                                 self.n_stages - 1),
                       group=self.group)
        return out

    def total(self, xs):
        """The sum over the stages of one value per stage."""
        out = xs[0].clone()
        dist.all_reduce(out, group=self.group)
        return out


class LocalRing:
    """Every stage in this process; the hop rotates a list."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        self.stages = list(range(n_stages))

    def shift(self, ys):
        return ys[-1:] + ys[:-1]

    def shift_back(self, gs):
        return gs[1:] + gs[:1]

    def from_last(self, y, like):
        return y

    def total(self, xs):
        return sum(xs[1:], xs[0])


class _Plan(NamedTuple):
    """What the ticks need besides tensors: the ring, the microbatch
    count, ``apply(stage, h, m, slab)`` → (y, aux or None), one stage on
    microbatch ``m``, and ``names``, the order of each slab's leaves."""
    ring: object
    n_micro: int
    apply: Callable
    names: list


def _ticks(plan, x, slabs, record):
    """The forward ticks. ``slabs[i]`` is the i-th driven stage's slab
    (a dict). With ``record`` each valid (stage, microbatch) runs with
    autograd on a detached input and its graph is kept for ``_GPipe``'s
    backward. Returns (y, aux per driven stage, the graphs)."""
    ring, M = plan.ring, plan.n_micro
    P, T = ring.n_stages, plan.n_micro + ring.n_stages - 1
    micro = x.chunk(M)
    states = [torch.zeros_like(micro[0]) for _ in ring.stages]
    outs, graphs = [None] * M, {}
    aux = [torch.zeros((), dtype=torch.float32, device=x.device)
           for _ in ring.stages]
    for t in range(T):
        ys = []
        for i, s in enumerate(ring.stages):
            m = t - s
            h = micro[min(max(m, 0), M - 1)] if s == 0 else states[i]
            if not 0 <= m < M:
                ys.append(h)  # a bubble tick hands on what it got
                continue
            if record:
                with torch.enable_grad():
                    h_in = h.detach().requires_grad_()
                    y, a = plan.apply(s, h_in, m, slabs[i])
                graphs[(s, m)] = (h_in, y, a)
                y = y.detach()
            else:
                y, a = plan.apply(s, h, m, slabs[i])
            if a is not None:
                aux[i] = aux[i] + a.detach().float()
            if s == P - 1:
                outs[m] = y
            ys.append(y)
        if t < T - 1:
            states = ring.shift(ys)
    last = torch.cat(outs) if outs[0] is not None else None
    return ring.from_last(last, x), aux, graphs


class _GPipe(torch.autograd.Function):
    """(x, every driven stage's slab leaves) → (y, aux_total), with the
    reverse ticks as its backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        n = len(plan.names)
        slabs = []
        for i in range(len(plan.ring.stages)):
            part = leaves[i * n:(i + 1) * n]
            slabs.append({name: t.detach().requires_grad_(t.requires_grad)
                          for name, t in zip(plan.names, part)})
        y, aux, graphs = _ticks(plan, x, slabs, record=True)
        ctx.plan, ctx.slabs, ctx.graphs = plan, slabs, graphs
        ctx.x_like = (x.shape, x.dtype, x.device)
        return y, plan.ring.total(aux) / plan.n_micro

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, daux):
        plan, slabs, graphs = ctx.plan, ctx.slabs, ctx.graphs
        ring, M = plan.ring, plan.n_micro
        P, T = ring.n_stages, M + ring.n_stages - 1
        shape, dtype, dev = ctx.x_like
        mb = (shape[0] // M, *shape[1:])
        zeros = torch.zeros(mb, dtype=dtype, device=dev)
        dy_micro = dy.chunk(M) if dy is not None else [zeros] * M
        dx = [zeros] * M
        grads = [{n: None for n in plan.names} for _ in ring.stages]
        g_in = [zeros for _ in ring.stages]
        for t in reversed(range(T)):
            g_out = (ring.shift_back(g_in) if t < T - 1
                     else [zeros for _ in ring.stages])
            g_in = []
            for i, s in enumerate(ring.stages):
                m = t - s
                g = g_out[i]
                if 0 <= m < M:
                    if s == P - 1:
                        g = g + dy_micro[m]
                    h_in, y, a = graphs.pop((s, m))
                    outs, cots = [y], [g]
                    if a is not None and daux is not None:
                        outs.append(a)
                        cots.append((daux / M).to(a.dtype))
                    wrt = [n for n in plan.names
                           if slabs[i][n].requires_grad]
                    got = torch.autograd.grad(
                        outs, [h_in, *(slabs[i][n] for n in wrt)], cots,
                        allow_unused=True)
                    g = got[0] if got[0] is not None else zeros
                    for n, gw in zip(wrt, got[1:]):
                        if gw is not None:
                            grads[i][n] = (gw if grads[i][n] is None
                                           else grads[i][n] + gw)
                if s == 0:
                    if 0 <= m < M:
                        dx[m] = g
                    g = zeros  # stage 0 read the microbatch, not the hop
                g_in.append(g)
        # only stage 0 read x: its gradient, the same on every stage
        dx = ring.total([torch.cat(dx)] + [torch.zeros(shape, dtype=dtype,
                                                       device=dev)
                                           for _ in ring.stages[1:]])
        out = [None, dx]
        for i in range(len(ring.stages)):
            out.extend(grads[i][n] for n in plan.names)
        return tuple(out)


def _run(ring, layer_fn, slabs, x, consts, batched_consts, n_micro):
    """The pipeline over ``ring``'s stages, ``slabs[i]`` the i-th driven
    stage's layers (a dict of [L/P, ...] leaves)."""
    names = list(slabs[0])
    mb = x.shape[0] // n_micro
    bmicro = [c.split(mb) for c in batched_consts]

    def apply(stage, h, m, slab):
        per_layer = zip(*(slab[n].unbind(0) for n in names))
        auxes = []
        for leaves in per_layer:
            h, a = layer_fn(h, dict(zip(names, leaves)), *consts,
                            *(c[m] for c in bmicro))
            if a is not None:
                auxes.append(a.float())
        return h, (torch.stack(auxes).sum() if auxes else None)

    plan = _Plan(ring, n_micro, apply, names)
    if torch.is_grad_enabled():
        flat = [slab[n] for slab in slabs for n in names]
        return _GPipe.apply(plan, x, *flat)
    y, aux, _ = _ticks(plan, x, slabs, record=False)
    return y, ring.total(aux) / n_micro


def pipeline_slab(layer_fn, slab, x, consts=(), batched_consts=(), *,
                  n_micro: int = 0, n_layers: int, region):
    """``pipeline_layers`` from this rank's slab (``slab``: this stage's
    [L/P, ...] local blocks of an ``n_layers`` stack) in ``region``'s
    pp group: the model's entry (``llama._backbone``), whose weights are
    local blocks already. ``x`` is this rank's rows."""
    n_stages = region.sizes["pp"]
    n_micro = check_shapes(n_layers, n_stages, x.shape[0], n_micro)
    ring = DistRing(region.pp, n_stages, region.stage)
    return _run(ring, layer_fn, [slab], x, consts, batched_consts, n_micro)


def pipeline_layers(layer_fn, stacked_params, x, consts=(),
                    batched_consts=(), *, n_micro: int = 0,
                    axis_name: str = "pp"):
    """Run ``x`` through a pipelined stack of layers.

    Args:
      layer_fn: ``layer_fn(h, layer_params, *consts, *batched_consts)
        -> (h, aux)``, one decoder layer on a microbatch ``h [mb, s, d]``;
        ``aux`` a scalar (the MoE load-balance loss) or None. Wrap it in
        ``torch.utils.checkpoint`` first if remat is wanted.
      stacked_params: dict of leaves stacked on axis 0 with ``L =
        n_stages · layers_per_stage``: ``DTensor``s sharded over
        ``axis_name`` on that axis (rule ``"layers": "pp"``, the rank
        keeps its block), or whole tensors, the same on every rank (the
        rank takes its stage's slab).
      x: this rank's activations ``[b, s, d]``, the same on every stage.
      consts: per-call constants passed to every layer (rope tables).
      batched_consts: per-row constants with leading dim ``b`` (the
        token mask): each stage receives the rows of the microbatch it is
        processing, matching the activation that arrived over the hop.
      n_micro: microbatch count ``M`` (must divide ``b``); 0 picks the
        largest divisor of ``b`` that is at most ``2 · n_stages``.

    Returns ``(y [b, s, d], aux_total)``: the stack's output and the
    per-layer aux summed over layers and averaged over microbatches
    (``aux`` must be a batch-mean statistic, as the MoE loss is a mean
    over routing groups, which never span microbatches). Unlike the
    reference, which splits the global batch, ``b`` here is the rank's
    rows, so ``n_micro`` must divide those."""
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        local_region,
        to_local,
    )

    region = local_region()
    if axis_name != "pp":
        raise ValueError(f"the pipeline axis is 'pp', not {axis_name!r}")
    n_stages = region.sizes["pp"]
    leaves = dict(stacked_params)
    n_layers = next(iter(leaves.values())).shape[0]
    check_shapes(n_layers, n_stages, x.shape[0], n_micro)
    per = n_layers // n_stages
    slab = {}
    for n, t in leaves.items():
        local = to_local(t)
        slab[n] = (local if local.shape[0] == per
                   else local.narrow(0, region.stage * per, per))
    return pipeline_slab(layer_fn, slab, x, consts, batched_consts,
                         n_micro=n_micro, n_layers=n_layers, region=region)


def pipeline_local(layer_fn, stacked_params, x, consts=(),
                   batched_consts=(), *, n_stages: int, n_micro: int = 0):
    """``pipeline_layers`` with all ``n_stages`` stages in this process:
    the same ticks, the hop a rotation of the stages' activations (no
    process group). ``stacked_params`` are the whole stack's leaves; each
    stage takes its contiguous slab of them."""
    n_layers = next(iter(stacked_params.values())).shape[0]
    n_micro = check_shapes(n_layers, n_stages, x.shape[0], n_micro)
    per = n_layers // n_stages
    slabs = [{n: t.narrow(0, s * per, per)
              for n, t in stacked_params.items()}
             for s in range(n_stages)]
    return _run(LocalRing(n_stages), layer_fn, slabs, x, consts,
                batched_consts, n_micro)
