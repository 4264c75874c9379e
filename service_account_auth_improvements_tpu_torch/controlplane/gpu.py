"""H100 accelerator binding: the counterpart of ``controlplane/tpu.py`` for
notebooks on NVIDIA H100 nodes.

A Notebook's ``gpu`` block ``{type: "h100", count: N, nodePool?}``
resolves (:func:`resolve`) to the cards per pod (its ``nvidia.com/gpu``
limit, :data:`RESOURCE_GPU`), the GKE node selector of H100 nodes, and
the number of hosts: up to 8 cards fit one a3-highgpu-8g host, and more
take whole hosts of 8, one pod per host. :func:`worker_env` gives each
pod the rendezvous that ``torch.distributed.run`` (torchrun) reads for
its arguments (``PET_NNODES``, ``PET_NODE_RANK``, ``PET_NPROC_PER_NODE``,
``PET_MASTER_ADDR``, ``PET_MASTER_PORT``); torchrun then starts one
process per card with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, which
``parallel/multihost.maybe_initialize`` reads.

There is no counterpart of ``tpu.megascale_env``: H100 nodes form no
slices, and hosts join one NCCL world over the data-center network
through the same rendezvous.
"""

from __future__ import annotations

import dataclasses

RESOURCE_GPU = "nvidia.com/gpu"
# GKE labels every GPU node with its accelerator type
SEL_ACCELERATOR = "cloud.google.com/gke-accelerator"
# and with its node pool: the key a node-pool pin (spec.gpu.nodePool, or
# the scheduler's placement) selects on
SEL_NODEPOOL = "cloud.google.com/gke-nodepool"
# the scheduler's placement decision, stamped on the Notebook at
# admission and folded into the selector like an explicit nodePool pin
ANNOTATION_NODEPOOL = "tpukf.dev/node-pool"

# the rendezvous port of the rank-0 pod (torchrun's default)
MASTER_PORT = 29500

# type -> GKE accelerator label value and cards per host (a3-highgpu-8g)
TYPES: dict[str, dict] = {
    "h100": {"selector": "nvidia-h100-80gb", "cards_per_host": 8},
}
SPEC_KEYS = frozenset({"type", "count", "nodePool"})


class GpuValidationError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ResolvedGpu:
    gpu_type: str
    total_cards: int
    num_hosts: int
    cards_per_host: int
    # optional explicit node-pool pin (spec.gpu.nodePool)
    node_pool: str | None = None

    @property
    def selector(self) -> dict[str, str]:
        sel = {SEL_ACCELERATOR: TYPES[self.gpu_type]["selector"]}
        if self.node_pool:
            sel[SEL_NODEPOOL] = self.node_pool
        return sel

    @property
    def multi_host(self) -> bool:
        return self.num_hosts > 1

    @property
    def gang_size(self) -> int:
        """Pods that must co-start: one per host."""
        return self.num_hosts


def resolve(spec: dict | None) -> ResolvedGpu | None:
    """Resolve a Notebook ``spec.gpu`` block; None when it is absent (a CPU
    notebook). ``count`` up to a host's cards takes one host; above that,
    it must be whole hosts."""
    if not spec:
        return None
    unknown = sorted(set(spec) - SPEC_KEYS)
    if unknown:
        raise GpuValidationError(
            f"unknown gpu spec keys {unknown}; know {sorted(SPEC_KEYS)}")
    gpu_type = str(spec.get("type", "h100")).lower()
    if gpu_type not in TYPES:
        raise GpuValidationError(
            f"unknown GPU type {gpu_type!r}; know {sorted(TYPES)}")
    per_host = TYPES[gpu_type]["cards_per_host"]
    count = spec.get("count")
    if count is None:
        raise GpuValidationError("gpu spec needs count")
    if isinstance(count, bool) or not isinstance(count, (int, str)):
        raise GpuValidationError(f"malformed gpu count {count!r}")
    try:
        count = int(count)
    except ValueError:
        raise GpuValidationError(f"malformed gpu count {count!r}")
    if count < 1:
        raise GpuValidationError(f"gpu count must be >= 1, got {count}")
    if count <= per_host:
        hosts, cards = 1, count
    elif count % per_host:
        raise GpuValidationError(
            f"{count} cards span hosts of {per_host} {gpu_type} cards: "
            f"ask for whole hosts (a multiple of {per_host})")
    else:
        hosts, cards = count // per_host, per_host
    return ResolvedGpu(
        gpu_type=gpu_type, total_cards=count, num_hosts=hosts,
        cards_per_host=cards,
        node_pool=(str(spec["nodePool"]) if spec.get("nodePool") else None),
    )


def _master_addr(name: str, service: str, namespace: str,
                 resolved: ResolvedGpu) -> str:
    """Where the rank-0 store listens: pod 0 through the headless service;
    on one host the rendezvous never leaves the pod, so ``localhost``."""
    if not resolved.multi_host:
        return "localhost"
    return f"{name}-0.{service}.{namespace}.svc"


def worker_env(name: str, service: str, namespace: str,
               resolved: ResolvedGpu, port: int = MASTER_PORT) -> list[dict]:
    """torchrun's rendezvous env for every pod of the notebook's
    StatefulSet ``name``: the node rank from the pod-index label through
    the downward API (the StatefulSet ordinal, as ``tpu.worker_env`` gives
    ``TPU_WORKER_ID``), the node count, the cards per node, and the
    rank-0 pod's address (:func:`_master_addr`) and ``port``."""
    return [
        {"name": "PET_NNODES", "value": str(resolved.num_hosts)},
        {"name": "PET_NODE_RANK", "valueFrom": {"fieldRef": {
            "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"
        }}},
        {"name": "PET_NPROC_PER_NODE",
         "value": str(resolved.cards_per_host)},
        {"name": "PET_MASTER_ADDR",
         "value": _master_addr(name, service, namespace, resolved)},
        {"name": "PET_MASTER_PORT", "value": str(port)},
    ]
