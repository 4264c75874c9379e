"""Logical-axis sharding rules → DTensor placements (port of
``parallel/sharding.py``).

Models annotate tensors with logical axis names ("batch", "embed",
"heads", …); a rule table maps each name to zero or more mesh axes, and
``logical_to_mesh`` resolves a tuple of names to the reference's spec
tuple. ``placements`` turns a spec into one ``Shard(dim)`` or
``Replicate()`` per mesh dimension, so a leaf laid out by the rules is a
``DTensor`` whose local block is exactly the block the reference's
``NamedSharding`` gives that device.

The model itself computes on local blocks, the body of the reference's
``shard_map``: ``LocalRegion`` is one rank's view of the mesh, and
``models/llama.py`` calls it where XLA's partitioner would insert a
collective (weights gathered over their data axes at use, Megatron's
``f``/``g`` around the tensor-parallel products, the sequence split over
``sp``). Without a mesh the region is the identity throughout.
"""

from __future__ import annotations

from service_account_auth_improvements_tpu_torch.parallel import (
    collectives as cc,
)
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    MESH_AXES,
    ambient_mesh,
    ambient_rules,
    check_mesh,
)

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate):
# the reference's table, unchanged.
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": "pp",
    "norm": None,
}

#: logical axes the model computes on per tensor-parallel shard; every
#: other sharded axis of a weight is gathered where the weight is used
TP_LOCAL = frozenset({"heads", "kv_heads", "mlp"})
#: axes whose ranks hold different data: gradients add across them
DATA_AXES = ("dp", "fsdp", "sp")


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_mesh(axes: tuple[str | None, ...],
                    rules: dict | None = None) -> tuple:
    """Resolve a tuple of logical axis names to a spec tuple: per tensor
    dimension None, a mesh axis, or a tuple of them. A mesh axis may
    appear only once per spec; later duplicates degrade to replication."""
    rules = rules if rules is not None else DEFAULT_RULES
    spec = []
    used: set[str] = set()
    for name in axes:
        if name is None:
            spec.append(None)
            continue
        flat = _axes(rules.get(name))
        fresh = tuple(a for a in flat if a not in used)
        used.update(fresh)
        if not fresh:
            spec.append(None)
        elif len(fresh) == 1:
            spec.append(fresh[0])
        else:
            spec.append(fresh)
    return tuple(spec)


def placements(mesh, spec) -> list:
    """One placement per mesh dimension for ``spec``: ``Shard(d)`` where
    tensor dimension d is split over that mesh axis, else ``Replicate()``.
    A dimension split over two axes is split over the first, then each
    part over the second (row-major, the reference's order for a tuple
    entry), so its axes must come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def logical_sharding(mesh, axes: tuple[str | None, ...],
                     rules: dict | None = None) -> list:
    """The placements of a tensor with logical ``axes`` on ``mesh``."""
    return placements(mesh, logical_to_mesh(axes, rules))


def is_axes(x) -> bool:
    """A logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn, axes_tree):
    if is_axes(axes_tree):
        return fn(axes_tree)
    return {k: _map_axes(fn, v) for k, v in axes_tree.items()}


def tree_logical_sharding(mesh, axes_tree, rules: dict | None = None):
    """Map a tree of logical-axes tuples to a tree of placements."""
    return _map_axes(lambda axes: logical_sharding(mesh, axes, rules),
                     axes_tree)


def shard_local(full, mesh, places):
    """This rank's block of the whole tensor ``full`` under ``places``:
    each ``Shard(d)`` splits dimension d evenly, in mesh-dimension order
    (DTensor's order). Uneven splits raise."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = full
    for m, p in enumerate(places):
        if isinstance(p, Shard):
            n = mesh.size(m)
            if local.shape[p.dim] % n:
                raise ValueError(
                    f"dimension {p.dim} of {tuple(full.shape)} does not "
                    f"divide over mesh axis {mesh.mesh_dim_names[m]} ({n})")
            local = local.chunk(n, dim=p.dim)[coord[m]]
    return local


def distribute(full, mesh, places):
    """``full`` (the same whole tensor on every rank, on any device) as a
    ``DTensor`` with ``places`` on ``mesh``'s device: each rank keeps its
    own block, with no communication."""
    from torch.distributed.tensor import DTensor

    local = shard_local(full, mesh, places).to(mesh.device_type)
    local = local.contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=full.shape, stride=full.stride())


def tree_distribute(tree, mesh, axes_tree, rules: dict | None = None):
    """A params tree of whole tensors laid onto ``mesh`` by the rules."""
    if isinstance(tree, dict):
        return {k: tree_distribute(v, mesh, axes_tree[k], rules)
                for k, v in tree.items()}
    return distribute(tree, mesh, logical_sharding(mesh, axes_tree, rules))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def to_local(x):
    """The local block of a ``DTensor``, a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full_tensor(x):
    """The whole tensor of a ``DTensor`` (a collective: every rank calls
    it), a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def shard_constraint(x, axes: tuple[str | None, ...],
                     rules: dict | None = None):
    """``with_sharding_constraint`` by logical axes. Without an ambient
    mesh, and on a plain tensor (a local block inside the model's region,
    whose layout the region keeps), the identity; a ``DTensor`` is
    redistributed to the rules' placements."""
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    rules = rules if rules is not None else ambient_rules()
    return x.redistribute(mesh, logical_sharding(mesh, axes, rules))


def _group(mesh, axis: str):
    """The process group of mesh axis ``axis``; None when it has one
    rank (the collectives' identity)."""
    if mesh is None or mesh.size(MESH_AXES.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def sp_attention(local_fn, q, k, v, *, axis_name: str = "sp",
                 batch_axes=("dp", "fsdp"), head_axis: str = "tp",
                 kv_head_axis: str | None = None):
    """The sharded entry of the sequence-parallel attention bodies (ring,
    Ulysses), the counterpart of ``sp_attention_shard_map``: q
    [b,s,hq,d], k/v [b,s,hkv,d] with seq on ``axis_name``, batch on
    ``batch_axes`` and heads on ``head_axis``. ``DTensor`` inputs are
    laid out so, the body runs on the local blocks over the
    ``axis_name`` group, and the output comes back as a ``DTensor`` like
    q. Plain tensors are local blocks already: the body runs on them over
    the ambient mesh's group (none without a mesh: a ring of one)."""
    from torch.distributed.tensor import DTensor

    if not is_dtensor(q):
        return local_fn(q, k, v, group=_group(ambient_mesh(), axis_name))
    mesh = q.device_mesh
    kv_head_axis = kv_head_axis or head_axis
    pq = placements(mesh, (tuple(batch_axes), axis_name, head_axis, None))
    pkv = placements(mesh, (tuple(batch_axes), axis_name, kv_head_axis,
                            None))
    out = local_fn(q.redistribute(mesh, pq).to_local(),
                   k.redistribute(mesh, pkv).to_local(),
                   v.redistribute(mesh, pkv).to_local(),
                   group=_group(mesh, axis_name))
    return DTensor.from_local(out, mesh, pq, run_check=False,
                              shape=q.shape, stride=q.stride())


class LocalRegion:
    """One rank's view of a mesh, as the model computes in it: batch rows
    split over (dp, fsdp), the sequence over sp, heads / kv heads / mlp
    and the vocabulary over tp, the stacked layers over pp (this rank's
    pipeline stage holds its slab) and the experts over ep (this rank
    runs its range of them); weights gathered at use over every other
    axis they are sharded on. Built from a mesh and the rules (which must
    keep that activation layout); with no mesh every method is the
    identity."""

    def __init__(self, mesh=None, rules: dict | None = None):
        if mesh is not None:
            check_mesh(mesh)
        self.rules = DEFAULT_RULES if rules is None else rules
        self.sizes = {a: (1 if mesh is None
                          else mesh.size(MESH_AXES.index(a)))
                      for a in MESH_AXES}
        self._check_rules()
        self.groups = {a: _group(mesh, a) for a in MESH_AXES}
        self.tp, self.sp = self.groups["tp"], self.groups["sp"]
        self.pp, self.ep = self.groups["pp"], self.groups["ep"]
        ranks = {a: (0 if mesh is None else mesh.get_local_rank(a))
                 for a in MESH_AXES}
        self.sp_rank = ranks["sp"]
        #: this rank's pipeline stage (its slab of the stacked layers)
        self.stage = ranks["pp"]
        self.ep_rank = ranks["ep"]
        self.n_batch = self.sizes["dp"] * self.sizes["fsdp"]
        # the vocabulary is split over tp when its rule says so: the
        # embedding and the logits then compute on the rank's shard
        vocab_tp = "tp" in _axes(self.rules.get("vocab"))
        self.vocab = self.tp if vocab_tp else None
        self.vocab_rank = ranks["tp"] if vocab_tp else 0

    def expert_range(self, n_experts: int) -> tuple[int, int]:
        """[first, last) of the experts this rank runs (all without ep)."""
        n = self.sizes["ep"]
        if n_experts % n:
            raise ValueError(f"{n_experts} experts do not divide over "
                             f"ep={n}")
        per = n_experts // n
        return self.ep_rank * per, (self.ep_rank + 1) * per

    def _check_rules(self) -> None:
        live = {a for a, n in self.sizes.items() if n > 1}
        want = {"batch": {"dp", "fsdp"} & live,
                "seq": {"sp"} & live,
                "layers": {"pp"} & live,
                "expert": {"ep"} & live,
                **{name: {"tp"} & live for name in TP_LOCAL}}
        for name in sorted(set(self.rules) | set(want)):
            rule = self.rules.get(name)
            got = set(_axes(rule)) & live
            ok = (got == want[name] if name in want
                  else got <= {"tp"} or got <= set(DATA_AXES)
                  if name == "vocab"
                  else got <= set(DATA_AXES))
            if not ok:
                raise ValueError(
                    f"rule {name!r}: {rule!r} on a mesh with live axes "
                    f"{sorted(live)}; the model computes with batch over "
                    "(dp, fsdp), seq over sp, heads/kv_heads/mlp over tp, "
                    "layers over pp and experts over ep, and may shard "
                    "its weights' other axes over dp, fsdp and sp (vocab "
                    "over tp or over those)")

    def spec(self, axes) -> tuple:
        return logical_to_mesh(axes, self.rules)

    def param(self, x, axes, experts_local: bool = False):
        """A weight's local block → the block the rank computes with: all
        of it but its shares of the tp-local axes (heads, kv heads, mlp,
        vocab), of the layer stack (pp) and, with ``experts_local``, of
        the experts (ep). The gathers over data axes reduce-scatter their
        gradient (the ranks saw different rows); a gather over tp or ep
        (an expert axis the rank routes over) keeps the rank's slice of
        it (the ranks computed the same). An int8 weight
        (``models/quantize.py``) gathers its values and its scale, whose
        contraction axis is dropped."""
        if hasattr(x, "scale") and hasattr(x, "values"):
            return type(x)(self.param(x.values, axes, experts_local),
                           self.param(x.scale, (*axes[:-2], axes[-1]),
                                      experts_local))
        for dim, entry in enumerate(self.spec(axes)):
            # the minor axis of a dim split over two was split last
            for a in reversed(_axes(entry)):
                if (self.sizes[a] == 1 or a == "pp"
                        or (a == "tp" and axes[dim] in TP_LOCAL | {"vocab"})
                        or (a == "ep" and experts_local)):
                    continue
                x = cc.all_gather(x, dim, self.groups[a],
                                  grad_sum=a in DATA_AXES)
        return x

    def vocab_copy(self, x):
        """Megatron ``f`` before the vocab-parallel logits."""
        return cc.sum_backward(x, self.vocab)

    def vocab_gather(self, logits):
        """The whole vocabulary's logits from each rank's shard (last
        dim); every rank goes on with the same, so the backward keeps the
        rank's slice."""
        return cc.all_gather(logits, logits.ndim - 1, self.vocab,
                             grad_sum=False)

    def ep_copy(self, x):
        """Megatron ``f`` over ep: an activation every ep rank routes,
        each rank's partial gradient (from its own experts) summed."""
        return cc.sum_backward(x, self.ep)

    def ep_sum(self, x):
        """Megatron ``g`` over ep: the partial combines of each rank's
        experts."""
        return cc.sum_forward(x, self.ep)

    def tp_copy(self, x):
        """Megatron ``f``: a replicated activation entering a
        column-parallel product."""
        return cc.sum_backward(x, self.tp)

    def tp_sum(self, x):
        """Megatron ``g``: the partial sums of a row-parallel product."""
        return cc.sum_forward(x, self.tp)

    def seq_chunk(self, x, dim: int = 1):
        """This rank's contiguous part of a whole sequence along ``dim``."""
        n = self.sizes["sp"]
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"sequence length {x.shape[dim]} does not "
                             f"divide over sp={n}")
        step = x.shape[dim] // n
        return x.narrow(dim, self.sp_rank * step, step)

    def attention(self, q, k, v, impl: str, segment_ids=None):
        """Attention of the local q/k/v blocks: ring and Ulysses over the
        sp group (a group of None is a ring of one); any other impl sees
        the whole sequence (gathered over sp) and keeps its own rows of
        the output. ``segment_ids`` under ring or Ulysses raises, as
        ``multi_head_attention`` says."""
        from service_account_auth_improvements_tpu_torch.ops.attention import (  # noqa: E501
            multi_head_attention,
        )
        from service_account_auth_improvements_tpu_torch.parallel import (
            ring,
            ulysses,
        )

        if segment_ids is None and impl == "ring":
            return ring.ring_attention_local(q, k, v, group=self.sp)
        if segment_ids is None and impl == "ulysses":
            return ulysses.ulysses_attention_local(q, k, v, group=self.sp)
        if self.sp is None:
            return multi_head_attention(q, k, v, impl=impl,
                                        segment_ids=segment_ids)
        whole = [cc.all_gather(t, 1, self.sp) for t in (q, k, v)]
        out = multi_head_attention(*whole, impl=impl,
                                   segment_ids=segment_ids)
        return self.seq_chunk(out)

    def data_sum(self, x):
        """Sum of every data-parallel rank's share of a loss; each rank
        differentiates its own share (the gradients are summed after)."""
        for a in DATA_AXES:
            x = cc.sum_forward(x, self.groups[a])
        return x

    def batch_sum(self, x):
        """Sum over the batch axes (dp, fsdp) outside autograd: a count of
        rows or tokens, which the sp ranks of one row share."""
        return cc.all_reduce_(x.detach().clone(), [self.groups["dp"],
                                                   self.groups["fsdp"]])

    def reduce_grad(self, g, axes):
        """A weight's gradient block summed over the data axes its layout
        replicates it on (the gathers reduce-scattered the others)."""
        spec_axes = {a for e in self.spec(axes) for a in _axes(e)}
        return cc.all_reduce_(g, [self.groups[a] for a in DATA_AXES
                                  if a not in spec_axes])

    def sq_norm(self, g, axes):
        """Σ g² of a whole gradient from its block: each element counted
        once (summed over the axes its layout splits it on)."""
        sq = (g.float() * g.float()).sum()
        spec_axes = [a for e in self.spec(axes) for a in _axes(e)]
        return cc.all_reduce_(sq, [self.groups[a] for a in spec_axes])


NO_REGION = LocalRegion()


def expert_share(n_ep: int, rank: int) -> LocalRegion:
    """A region computing as ep rank ``rank`` of ``n_ep`` with no process
    group: the model runs that rank's experts and its ep sums are the
    identity, so the caller adds the ranks' partial outputs. One process
    checks an ep split this way (``chip_smoke.py`` on one card)."""
    region = LocalRegion()
    region.sizes = {**region.sizes, "ep": n_ep}
    region.ep_rank = rank
    return region


def local_region() -> LocalRegion:
    """The region of the ambient mesh (``use_mesh``), ``NO_REGION``
    without one."""
    mesh = ambient_mesh()
    return NO_REGION if mesh is None else LocalRegion(mesh, ambient_rules())
