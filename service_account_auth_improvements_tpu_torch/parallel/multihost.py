"""Multi-host bootstrap: the launcher's env -> ``torch.distributed``
(port of ``parallel/multihost.py``).

Two launchers, one process per card:

- The TPU control plane injects ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES``
  into every pod of a multi-host job and, for more than one slice,
  ``MEGASCALE_COORDINATOR_ADDRESS`` / ``MEGASCALE_NUM_SLICES`` /
  ``MEGASCALE_SLICE_ID``. ``rendezvous_plan`` folds them into one global
  namespace exactly as the reference does (its own copy: the port imports
  nothing of the JAX package); a hostname listed n times runs n
  processes, the n-th on card n.
- ``torch.distributed.run`` (torchrun), which ``controlplane/gpu.py``'s
  ``worker_env`` configures on H100 nodes, starts one process per card
  with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT`` set. When ``WORLD_SIZE`` is set it decides, and a
  ``TPU_*`` / ``MEGASCALE_*`` env that declares another world raises.

``maybe_initialize`` starts the default process group from either: NCCL
on the card, gloo only when the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    BACKENDS,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)

COORD_PORT = 8476


def worker_env() -> tuple[int, list[str]]:
    """Parse (worker_id, hostnames) from the injected env; ([0], single) when
    absent (single-host or CPU dev)."""
    wid = int(os.environ.get("TPU_WORKER_ID", "0"))
    hosts_raw = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    hosts = [h.strip() for h in hosts_raw.split(",") if h.strip()]
    return wid, hosts or ["localhost"]


@dataclasses.dataclass(frozen=True)
class RendezvousPlan:
    """Global process-group coordinates derived from the injected env."""

    coordinator: str      # host:port of the rank-0 store
    num_processes: int    # hosts_per_slice * num_slices
    process_id: int       # slice_id * hosts_per_slice + worker_id
    num_slices: int
    slice_id: int


TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def torchrun_env() -> dict[str, str] | None:
    """torchrun's per-process env, or None when ``WORLD_SIZE`` is unset.
    With ``WORLD_SIZE`` set, each of ``TORCHRUN_ENV`` must be."""
    if "WORLD_SIZE" not in os.environ:
        return None
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE is set but {missing} are not: launch "
                         "with torchrun (torch.distributed.run)")
    return {k: os.environ[k] for k in TORCHRUN_ENV}


def _tpu_world() -> int | None:
    """The world the TPU_* / MEGASCALE_* env declares, None without it."""
    if not ({"TPU_WORKER_HOSTNAMES", "MEGASCALE_NUM_SLICES"}
            & set(os.environ)):
        return None
    _, hosts = worker_env()
    return len(hosts) * int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))


def rendezvous_plan() -> RendezvousPlan:
    """The process-group coordinates of this process.

    Under torchrun (``WORLD_SIZE`` set) they are its env's: the store at
    ``MASTER_ADDR:MASTER_PORT``, ``RANK`` of ``WORLD_SIZE``, one slice.
    Otherwise, fold slice-local TPU_WORKER_* and MEGASCALE_* into one
    namespace.

    Ranks are slice-major (slice 0 holds ranks 0..H-1, slice 1 holds
    H..2H-1, ...) so a ``dp``-outermost mesh maps data-parallel replicas
    onto slices. The store runs on slice 0's rank-0 pod, the pod the
    controller names in MEGASCALE_COORDINATOR_ADDRESS (whose port is the
    inter-slice transport's; the store uses COORD_PORT)."""
    run = torchrun_env()
    if run is not None:
        world = int(run["WORLD_SIZE"])
        declared = _tpu_world()
        if declared is not None and declared != world:
            raise ValueError(
                f"torchrun's WORLD_SIZE={world} contradicts the TPU_* / "
                f"MEGASCALE_* env's world of {declared}")
        return RendezvousPlan(
            coordinator=f"{run['MASTER_ADDR']}:{run['MASTER_PORT']}",
            num_processes=world, process_id=int(run["RANK"]),
            num_slices=1, slice_id=0)
    wid, hosts = worker_env()
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    slice_id = int(os.environ.get("MEGASCALE_SLICE_ID", "0"))
    if num_slices > 1:
        coord_raw = os.environ.get("MEGASCALE_COORDINATOR_ADDRESS", "")
        coord_host = coord_raw.rsplit(":", 1)[0] if coord_raw else hosts[0]
    else:
        coord_host = hosts[0]
    return RendezvousPlan(
        coordinator=f"{coord_host}:{COORD_PORT}",
        num_processes=len(hosts) * num_slices,
        process_id=slice_id * len(hosts) + wid,
        num_slices=num_slices,
        slice_id=slice_id,
    )


def maybe_initialize(device=None) -> int:
    """Start the default process group when the env asks for one; returns
    this process's rank (0 alone).

    The TPU_* env asks for one when it declares more than one process;
    torchrun's always does, at any world size (a process it starts
    expects a group, as ``init_process_group("env://")`` gives it). On
    the card (unless ``device="cpu"``) the group runs NCCL, and the
    process first takes its card: ``LOCAL_RANK`` under torchrun, else the
    n-th worker listed under one hostname takes card n. Idempotent through
    ``dist.is_initialized()``. A real bootstrap failure (an unreachable
    store, a rank clash) propagates: going on alone would hang every other
    rank in its first collective."""
    plan = rendezvous_plan()
    run = torchrun_env()
    if run is None and plan.num_processes <= 1:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    if dev.type == "cuda":
        if run is not None:
            torch.cuda.set_device(int(run["LOCAL_RANK"]))
        else:
            wid, hosts = worker_env()
            torch.cuda.set_device(hosts[:wid].count(hosts[wid]))
    init = "env://" if run is not None else f"tcp://{plan.coordinator}"
    dist.init_process_group(
        BACKENDS[dev.type], init_method=init,
        world_size=plan.num_processes, rank=plan.process_id)
    return dist.get_rank()


def describe_group() -> str:
    """One line naming the default process group: backend, rank, world
    and this process's device (its card under NCCL)."""
    backend = dist.get_backend()
    where = (f"cuda:{torch.cuda.current_device()}" if backend == "nccl"
             else "cpu")
    return (f"process group {backend}: rank {dist.get_rank()} of "
            f"{dist.get_world_size()} on {where}")
