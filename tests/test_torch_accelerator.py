"""The H100 binding (``controlplane/gpu.py``) and torchrun's rendezvous in
``parallel/multihost.py``, on the CPU.

``gpu.resolve`` is held to its table of accepted and refused specs and
``gpu.worker_env`` to a pinned env. Then the env it gives drives
``torch.distributed.run`` for real: two gloo ranks form one world, and
the training CLI under torchrun logs the loss the ``TPU_*`` launch logs.
Every launch takes a free port, so parallel test workers never share one.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from service_account_auth_improvements_tpu_torch.controlplane import gpu  # noqa: E402
from service_account_auth_improvements_tpu_torch.parallel import (  # noqa: E402
    mesh as tmesh,
    multihost,
)
from tests import torch_parallel_workers as workers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "service_account_auth_improvements_tpu_torch"
LAUNCH_ENV = ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_SLICE_ID", "MEGASCALE_COORDINATOR_ADDRESS",
              *multihost.TORCHRUN_ENV)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("spec,want", [
    ({"type": "h100", "count": 1}, (1, 1, 1)),
    ({"type": "h100", "count": 3}, (3, 1, 3)),
    ({"type": "H100", "count": 8}, (8, 1, 8)),
    ({"count": "4"}, (4, 1, 4)),
    ({"type": "h100", "count": 16}, (16, 2, 8)),
    ({"type": "h100", "count": 64, "nodePool": "a3-pool"}, (64, 8, 8)),
])
def test_resolve_accepts(spec, want):
    r = gpu.resolve(spec)
    assert (r.total_cards, r.num_hosts, r.cards_per_host) == want
    assert r.gpu_type == "h100"
    assert r.gang_size == r.num_hosts and r.multi_host == (want[1] > 1)
    assert gpu.RESOURCE_GPU == "nvidia.com/gpu"
    sel = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    if "nodePool" in spec:
        sel["cloud.google.com/gke-nodepool"] = spec["nodePool"]
    assert r.selector == sel
    with pytest.raises(AttributeError):
        r.total_cards = 2  # frozen, as ResolvedTpu is


@pytest.mark.parametrize("spec,match", [
    ({"type": "h100"}, "needs count"),
    ({"type": "h100", "count": 0}, ">= 1"),
    ({"type": "h100", "count": -8}, ">= 1"),
    ({"type": "h100", "count": 12}, "whole hosts"),
    ({"type": "h100", "count": 9}, "whole hosts"),
    ({"type": "h100", "count": True}, "malformed"),
    ({"type": "h100", "count": 2.0}, "malformed"),
    ({"type": "h100", "count": "two"}, "malformed"),
    ({"type": "a100", "count": 1}, "unknown GPU type"),
    ({"type": "h100", "count": 8, "slices": 2}, "unknown gpu spec keys"),
])
def test_resolve_refuses(spec, match):
    with pytest.raises(gpu.GpuValidationError, match=match):
        gpu.resolve(spec)
    assert issubclass(gpu.GpuValidationError, ValueError)


def test_resolve_absent_block_is_a_cpu_notebook():
    assert gpu.resolve(None) is None and gpu.resolve({}) is None


def test_worker_env_is_torchruns_pet_env():
    pod_index = {"fieldRef": {
        "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"}}
    one = gpu.worker_env("nb", "nb-hl", "u1", gpu.resolve({"count": 1}))
    assert one == [
        {"name": "PET_NNODES", "value": "1"},
        {"name": "PET_NODE_RANK", "valueFrom": pod_index},
        {"name": "PET_NPROC_PER_NODE", "value": "1"},
        {"name": "PET_MASTER_ADDR", "value": "localhost"},
        {"name": "PET_MASTER_PORT", "value": "29500"},
    ]
    two_hosts = gpu.worker_env("nb", "nb-hl", "u1",
                               gpu.resolve({"count": 16}), port=1234)
    assert two_hosts == [
        {"name": "PET_NNODES", "value": "2"},
        {"name": "PET_NODE_RANK", "valueFrom": pod_index},
        {"name": "PET_NPROC_PER_NODE", "value": "8"},
        {"name": "PET_MASTER_ADDR", "value": "nb-0.nb-hl.u1.svc"},
        {"name": "PET_MASTER_PORT", "value": "1234"},
    ]
    assert gpu.MASTER_PORT == 29500  # torchrun's default


def _pod_env(resolved, node_rank: int) -> dict:
    """The env a pod gets from ``worker_env``, the downward API filled in
    (the pod index is the node rank), on a free port."""
    env = {}
    for e in gpu.worker_env("nb", "nb-hl", "u1", resolved,
                            port=_free_port()):
        env[e["name"]] = e.get("value", str(node_rank))
    return env


def _run(cmd, env, cwd, timeout=240):
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout,
                          env={**base, "PYTHONPATH": REPO,
                               "OMP_NUM_THREADS": "1", **env})


def test_torchrun_ranks_from_worker_env_form_one_world(tmp_path):
    """torchrun, configured only by ``worker_env``'s ``PET_*`` env (a
    two-card notebook), starts two ranks that form one gloo world of 2
    through ``maybe_initialize`` and all-reduce."""
    env = _pod_env(gpu.resolve({"count": 2}), node_rank=0)
    out = _run([sys.executable, "-m", "torch.distributed.run", "-m",
                "tests.torch_parallel_workers", "torchrun_rendezvous",
                str(tmp_path)], env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(2):
        res = workers.load(tmp_path / f"torchrun-r{rank}.pt")
        assert res["rank"] == res["again"] == res["local_rank"] == rank
        assert res["world"] == 2 and res["backend"] == "gloo"
        assert res["sum"] == 3.0
        assert res["plan"].num_processes == 2
        assert res["plan"].process_id == rank
        assert res["plan"].coordinator.endswith(
            ":" + env["PET_MASTER_PORT"])
        assert res["line"] == f"process group gloo: rank {rank} of 2 on cpu"


CLI_ARGS = ["--preset", "smoke", "--device", "cpu", "--dp", "2",
            "--steps", "2", "--batch", "4", "--seq", "32", "--log-every",
            "2"]


def _step2_loss(stdout: str) -> str:
    found = re.findall(r"step 2/2 loss=(\S+)", stdout)
    assert len(found) == 1, stdout
    return found[0]


def test_cli_under_torchrun_matches_the_tpu_env_launch(tmp_path):
    """The training CLI at ``--dp 2`` under torchrun (two processes on
    one node) logs, from rank 0 alone, the step-2 loss the same CLI logs
    as two processes with the ``TPU_*`` env
    (``test_torch_mesh.py::test_cli_trains_on_two_processes``'s launch)."""
    env = _pod_env(gpu.resolve({"count": 2}), node_rank=0)
    run = _run([sys.executable, "-m", "torch.distributed.run", "-m",
                f"{PKG}.train.loop", *CLI_ARGS], env, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "process group gloo: rank 0 of 2 on cpu" in run.stdout
    assert "rank 1" not in run.stdout
    cmd = [sys.executable, "-c",
           f"from {PKG}.parallel import multihost; "
           f"multihost.COORD_PORT = {_free_port()}; "
           f"from {PKG}.train import loop; loop.main({CLI_ARGS!r})"]
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    procs = [subprocess.Popen(
        cmd, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**base, "TPU_WORKER_ID": str(rank),
                        "TPU_WORKER_HOSTNAMES": "localhost,localhost",
                        "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert _step2_loss(run.stdout) == _step2_loss(outs[0][0])


def test_torchrun_env_decides_and_conflicts_raise(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE is set but"):
        multihost.rendezvous_plan()
    for k, v in {"RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
                 "MASTER_PORT": "1234"}.items():
        clean_env.setenv(k, v)
    plan = multihost.rendezvous_plan()
    assert (plan.coordinator, plan.num_processes, plan.process_id,
            plan.num_slices, plan.slice_id) == ("h0:1234", 2, 1, 1, 0)
    # a TPU_* env of the same world agrees; torchrun's rank decides
    clean_env.setenv("TPU_WORKER_ID", "0")
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    assert multihost.rendezvous_plan().process_id == 1
    # of another world, it raises, in the plan and before any group
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "a,b,c")
    for call in (multihost.rendezvous_plan,
                 lambda: multihost.maybe_initialize(device="cpu")):
        with pytest.raises(ValueError, match="contradicts"):
            call()
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    clean_env.setenv("MEGASCALE_NUM_SLICES", "2")
    with pytest.raises(ValueError, match="world of 4"):
        multihost.rendezvous_plan()
    assert not torch.distributed.is_initialized()


def test_lone_rank_of_a_torchrun_world_refuses_a_mesh(clean_env):
    """A process torchrun started as one of two, with no group up, must
    not make a mesh of one and train alone."""
    assert not torch.distributed.is_initialized()
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_initialize first"):
        tmesh.make_mesh(device="cpu")
    assert not torch.distributed.is_initialized()
