"""Device meshes for sharded training (port of ``parallel/mesh.py``).

The reference names a ``jax.sharding.Mesh`` over its devices; the port
names a ``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group, one process per card, with the same six dimensions in the
same order (``MESH_AXES``):

  dp    pure data parallel (gradient all-reduce)
  pp    pipeline parallel (GPipe, ``parallel/pipeline.py``)
  fsdp  data parallel with parameter and optimizer sharding (ZeRO-3)
  sp    sequence parallel (``parallel/ring.py``, ``parallel/ulysses.py``)
  tp    tensor (Megatron) parallel over heads, mlp and vocab
  ep    expert parallel (each rank runs its range of the experts)

Ranks fill the mesh in row-major order, so ``tp`` neighbours are adjacent
ranks (on one host, the NVLink peers) and ``dp`` is outermost.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os

import torch.distributed as dist

from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)

# Canonical axis order, outermost first (the reference's).
MESH_AXES: tuple[str, ...] = ("dp", "pp", "fsdp", "sp", "tp", "ep")

#: backend each device type's collectives run on; there is no other
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Per-axis sizes; ``-1`` on at most one axis means "absorb the rest"."""

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def sizes(self) -> dict[str, int]:
        return {
            "dp": self.dp,
            "pp": self.pp,
            "fsdp": self.fsdp,
            "sp": self.sp,
            "tp": self.tp,
            "ep": self.ep,
        }

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Fill the single ``-1`` axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} present"
            )
        return sizes


def _world(device) -> str:
    """The device type of ``device`` (the card unless ``"cpu"``), with the
    default process group up on its backend: a process that has none (a
    lone notebook kernel) gets a group of one over an in-memory store. A
    process that torchrun started as one of several (``WORLD_SIZE`` > 1)
    raises instead: alone, it would train by itself."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                "WORLD_SIZE > 1 but no process group is up: call "
                "parallel.multihost.maybe_initialize first")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(
            f"the process group runs {got!r}, but a {dev.type} mesh needs "
            f"{backend!r}: initialise it with that backend")
    return dev.type


def check_mesh(mesh):
    """``mesh`` itself, if it is a ``DeviceMesh`` named ``MESH_AXES`` (what
    ``make_mesh`` builds); anything else raises ``TypeError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if (not isinstance(mesh, DeviceMesh)
            or tuple(mesh.mesh_dim_names or ()) != MESH_AXES):
        raise TypeError(f"expected a DeviceMesh with dimensions {MESH_AXES} "
                        f"(parallel.make_mesh), got {mesh!r}")
    return mesh


def data_parallel_group(mesh):
    """The ``dp`` process group of a pure data-parallel ``mesh`` (the
    vision models' steps: the batch split over dp, the weights
    replicated); None for one dp rank. Another axis above 1 raises."""
    check_mesh(mesh)
    other = {a: mesh.size(i) for i, a in enumerate(MESH_AXES)
             if a != "dp" and mesh.size(i) > 1}
    if other:
        raise ValueError(f"a data-parallel step splits the batch over dp "
                         f"only; this mesh also has {other}")
    return None if mesh.size(0) == 1 else mesh.get_group("dp")


def make_mesh(config: MeshConfig | None = None, device=None):
    """A ``DeviceMesh`` named ``MESH_AXES`` over every rank of the default
    process group (created, at one rank, when there is none), on the card
    unless ``device="cpu"`` asks for the CPU (then over gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    dev_type = _world(device)
    sizes = config.resolve(dist.get_world_size())
    shape = tuple(sizes[a] for a in MESH_AXES)
    return init_device_mesh(dev_type, shape, mesh_dim_names=MESH_AXES)


def make_multislice_mesh(num_slices: int, config: MeshConfig | None = None,
                         device=None):
    """Mesh for a multi-slice job: ``dp`` spans the slices. Under the
    controller's slice-major ranks (``parallel/multihost.py``) ``dp =
    num_slices`` outermost puts one data-parallel replica per slice, so
    only the gradient all-reduce crosses slices. ``config`` sizes the
    intra-slice axes (its ``dp`` is overridden)."""
    config = dataclasses.replace(config or MeshConfig(), dp=num_slices)
    return make_mesh(config, device)


def single_device_mesh(device=None):
    """An all-ones mesh (the bench and single-card paths). The process
    group must have one rank: a sub-mesh of one rank of a larger world is
    not a mesh every rank agrees on."""
    return make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1),
                     device)


# (mesh, rules) in scope, the counterpart of ``jax.set_mesh`` /
# ``get_abstract_mesh``
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Enter ``mesh`` (and the logical-axis ``rules`` the model resolves
    against, ``DEFAULT_RULES`` when None) as the ambient mesh. Code that
    reads it (``ambient_mesh``, ``sharding.local_region``) runs the model
    as the per-rank body of that mesh."""
    token = _AMBIENT.set(None if mesh is None else (mesh, rules))
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh():
    """The mesh in scope, else None (the read side of ``use_mesh``)."""
    cur = _AMBIENT.get()
    return None if cur is None else cur[0]


def ambient_rules() -> dict | None:
    """The rules given to the ``use_mesh`` in scope (None: the defaults,
    or no mesh)."""
    cur = _AMBIENT.get()
    return None if cur is None else cur[1]
