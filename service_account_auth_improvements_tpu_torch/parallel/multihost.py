"""Multi-host bootstrap: controller-injected env → ``torch.distributed``
(port of ``parallel/multihost.py``).

The control plane injects ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES``
into every pod of a multi-host job and, for more than one slice,
``MEGASCALE_COORDINATOR_ADDRESS`` / ``MEGASCALE_NUM_SLICES`` /
``MEGASCALE_SLICE_ID``. ``rendezvous_plan`` folds them into one global
namespace exactly as the reference does (its own copy: the port imports
nothing of the JAX package), and ``maybe_initialize`` starts the default
process group from it: one process per listed worker, NCCL on the card,
gloo only when the caller asks for the CPU. Several processes per host
(torchrun's ``LOCAL_RANK``) are the GPU env contract of ROADMAP queue 1,
item 10.
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


def rendezvous_plan() -> RendezvousPlan:
    """Fold slice-local TPU_WORKER_* and MEGASCALE_* into one namespace.

    Ranks are slice-major (slice 0 holds ranks 0..H-1, slice 1 holds
    H..2H-1, ...) so a ``dp``-outermost mesh maps data-parallel replicas
    onto slices. The store runs on slice 0's rank-0 pod, the pod the
    controller names in MEGASCALE_COORDINATOR_ADDRESS (whose port is the
    inter-slice transport's; the store uses COORD_PORT)."""
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
    """Start the default process group iff the env declares more than one
    process; returns this process's rank (0 alone).

    On the card (unless ``device="cpu"``) the group runs NCCL, and the
    process first takes its card: the n-th worker listed under one
    hostname takes card n. Idempotent through ``dist.is_initialized()``.
    A real bootstrap failure (an unreachable store, a rank clash)
    propagates: going on alone would hang every other rank in its first
    collective."""
    plan = rendezvous_plan()
    if plan.num_processes <= 1:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    if dev.type == "cuda":
        wid, hosts = worker_env()
        torch.cuda.set_device(hosts[:wid].count(hosts[wid]))
    dist.init_process_group(
        BACKENDS[dev.type], init_method=f"tcp://{plan.coordinator}",
        world_size=plan.num_processes, rank=plan.process_id)
    return dist.get_rank()
