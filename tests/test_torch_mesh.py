"""Port parity: ``parallel/mesh.py``, ``sharding.py`` and ``multihost.py``
against the JAX package's, and the multi-process bootstrap on the CPU.

Mesh sizes, logical specs and rendezvous plans are compared value for
value with the reference on the same inputs. The rows a rank reads and
holds are held against where JAX's ``NamedSharding`` puts them on its 8
virtual CPU devices. The multi-rank checks run spawned gloo processes
(``tests/torch_parallel_workers.py``), and the CLI runs as two processes
with the controller's rendezvous env.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig as JMeshConfig,
    make_mesh as jmake_mesh,
    multihost as jmultihost,
    sharding as jsharding,
)
from service_account_auth_improvements_tpu.train import data as jdata  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import llama as tllama  # noqa: E402
from service_account_auth_improvements_tpu_torch.parallel import (  # noqa: E402
    mesh as tmesh,
    multihost as tmultihost,
    sharding as tsharding,
)
from service_account_auth_improvements_tpu_torch.utils.tree import leaves  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sizes,n", [
    (dict(), 8),
    (dict(dp=2, tp=2), 8),
    (dict(dp=2, fsdp=2, tp=2, sp=1), 8),
    (dict(fsdp=1, sp=-1, tp=2), 8),
    (dict(dp=-1, fsdp=-1), 8),          # two wild axes
    (dict(dp=3), 8),                    # not divisible
    (dict(dp=2, fsdp=2), 8),            # wants 4, 8 present
    (dict(pp=2, ep=2, fsdp=1), 4),
])
def test_mesh_config_resolve_matches_jax(sizes, n):
    def run(cls):
        try:
            return cls(**sizes).resolve(n)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(tmesh.MeshConfig) == run(JMeshConfig)
    assert tmesh.MESH_AXES == jax_axes()


def jax_axes():
    from service_account_auth_improvements_tpu.parallel import mesh

    return mesh.MESH_AXES


# the reference's rules, and rules whose axes collide (a mesh axis used
# twice in one spec degrades to replication)
RULES = {
    "default": None,
    "collide": {**jsharding.DEFAULT_RULES, "embed": "tp",
                "batch": ("dp", "fsdp", "tp"), "vocab": ("fsdp", "tp")},
}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("preset", ["smoke", "moe_smoke"])
def test_logical_to_mesh_matches_jax(preset, rules):
    r = RULES[rules]
    tcfg = tllama.PRESETS[preset]
    jcfg = jllama.PRESETS[preset]
    jaxes = dict(leaves(jllama.logical_axes(jcfg)))
    got_all = dict(leaves(tllama.logical_axes(tcfg)))
    assert got_all.keys() == jaxes.keys()
    for name, axes in got_all.items():
        assert axes == jaxes[name], name
        assert tsharding.logical_to_mesh(axes, r) == tuple(
            jsharding.logical_to_mesh(axes, r)), name
    for axes in (("batch", "batch"), ("batch", "seq", "heads", None),
                 ("embed", "vocab", "embed"), (None,), ()):
        assert tsharding.logical_to_mesh(axes, r) == tuple(
            jsharding.logical_to_mesh(axes, r)), axes
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


ENVS = {
    "single-host": {},
    "multi-host": {"TPU_WORKER_ID": "1",
                   "TPU_WORKER_HOSTNAMES": "a.svc, b.svc,c.svc"},
    "two-slices": {"TPU_WORKER_ID": "1",
                   "TPU_WORKER_HOSTNAMES": "ms-s1-0.ms-hl.u1.svc,"
                                           "ms-s1-1.ms-hl.u1.svc",
                   "MEGASCALE_NUM_SLICES": "2",
                   "MEGASCALE_SLICE_ID": "1",
                   "MEGASCALE_COORDINATOR_ADDRESS":
                       "ms-s0-0.ms-hl.u1.svc:8080"},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_rendezvous_plan_matches_jax(env, monkeypatch):
    for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
              "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert tmultihost.COORD_PORT == jmultihost.COORD_PORT
    assert tmultihost.worker_env() == jmultihost.worker_env()
    got = dataclasses.asdict(tmultihost.rendezvous_plan())
    assert got == dataclasses.asdict(jmultihost.rendezvous_plan())
    if env == "two-slices":  # slice-major ranks
        assert got["process_id"] == 3 and got["num_processes"] == 4
    if env == "single-host":
        assert tmultihost.maybe_initialize(device="cpu") == 0
        assert not torch.distributed.is_initialized()


def test_batch_rows_per_rank_match_jax(tmp_path):
    """On a dp 2 x fsdp 2 gloo mesh each rank holds the rows JAX's
    NamedSharding gives the device at the same mesh coordinate, and
    ``TokenBatches`` reads the rows JAX's ``TokenBatches`` reads for that
    row shard; on sp 2 x tp 2 every rank reads the whole batch. The
    model's region refuses rules that break its layout, and pp / ep."""
    workers.launch("batches", 4, tmp_path)
    tokens = np.arange(4096, dtype=np.int32) % 997
    cfg = jdata.DataConfig(batch=8, seq=16, seed=3)
    jmesh = jmake_mesh(JMeshConfig(dp=2, fsdp=2), jax.devices()[:4])
    index_map = NamedSharding(jmesh, P(("dp", "fsdp"), None)) \
        .devices_indices_map((8, 16))
    devices = np.asarray(jmesh.devices)
    # one JAX process reads the whole batch; with n processes the
    # reference's process p reads rows [p*B/n, (p+1)*B/n) of it
    everyone = jdata.TokenBatches(tokens, cfg, jmesh, process_index=0,
                                  process_count=1)
    whole = [np.asarray(everyone.batch_at(step)) for step in range(3)]
    for rank in range(4):
        res = workers.load(tmp_path / f"batches-r{rank}.pt")
        c = res["dp2fsdp2"]["coord"]
        # the device at this rank's (dp, fsdp) coordinate
        rows = index_map[devices[tuple(c)]][0]
        shard = c[0] * 2 + c[2]
        for step, (got, shape, places) in enumerate(
                res["dp2fsdp2"]["rows"]):
            assert shape == (8, 16)
            assert places == [0, None, 0, None, None, None]
            np.testing.assert_array_equal(got, whole[step][rows])
            np.testing.assert_array_equal(
                got, whole[step][shard * 2:(shard + 1) * 2])
        for step, (got, shape, places) in enumerate(res["sp2tp2"]["rows"]):
            assert places == [0, None, 0, None, None, None]  # sizes 1
            np.testing.assert_array_equal(got, whole[step])
        # shard_constraint lays a replicated tensor out by the rules
        dims, local = res["dp2fsdp2"]["constraint"]
        assert dims == [0, None, 0, None, None, None]
        np.testing.assert_array_equal(
            local, np.arange(16.).reshape(8, 2)[rows])
        dims, local = res["sp2tp2"]["constraint"]
        np.testing.assert_array_equal(local, np.arange(16.).reshape(8, 2))
        # the region keeps the activation layout it computes with: the
        # layers over pp and the experts over ep too
        refused = res["refused"]
        assert sorted(refused) == ["batch-over-dp-only", "embed-over-tp",
                                   "experts-unsharded", "heads-unsharded",
                                   "layers-unsharded"]
        for tag in refused:
            assert refused[tag].startswith("ValueError: rule"), refused
        # pp 2 x fsdp 2: ranks 0, 1 are stage 0; ep 2 x fsdp 2: ranks
        # 0, 2 run experts [0, 2)
        stage, n_stages, experts = res["pp-ep"]
        assert (stage, n_stages) == (rank // 2, 2)
        assert experts == ((0, 2) if rank % 2 == 0 else (2, 4))
        assert res["pure-dp-rules"] == 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_maybe_initialize_from_env(tmp_path):
    """Two processes with the controller's env form one gloo group:
    ranks from ``TPU_WORKER_ID``, the store on the first host, a second
    call a no-op."""
    port = _free_port()
    workers.launch("rendezvous", 2, tmp_path, port, init=False,
                   env={"TPU_WORKER_HOSTNAMES": "localhost,localhost"})
    for rank in range(2):
        res = workers.load(tmp_path / f"rendezvous-r{rank}.pt")
        assert res["rank"] == res["again"] == rank
        assert res["world"] == 2 and res["backend"] == "gloo"
        assert res["sum"] == 3.0
        assert res["plan"].coordinator == f"localhost:{port}"


def test_world_of_one_mesh_is_the_plain_path(tmp_path):
    """``make_mesh`` in a process with no group starts one (gloo on the
    CPU) and the all-ones mesh's step, eval and batches are the plain
    ones, bit for bit."""
    cfg = dataclasses.replace(tllama.PRESETS["smoke"], dtype="float32")
    workers.launch("world_one", 1, tmp_path, dataclasses.asdict(cfg),
                   init=False)
    res = workers.load(tmp_path / "world-one.pt")
    assert res["backend"] == "gloo" and res["world"] == 1
    assert res["shapes"] == {"single": (1,) * 6, "multislice": (1,) * 6}
    plain, mesh = res["plain"], res["mesh"]
    assert plain["losses"] == mesh["losses"]
    assert plain["eval"] == mesh["eval"]
    torch.testing.assert_close(plain["batch"], mesh["batch"], rtol=0,
                               atol=0)
    for what in ("params", "mu", "nu"):
        for (name, a), (_, b) in zip(leaves(plain[what]),
                                     leaves(mesh[what])):
            assert torch.equal(a, b), (what, name)


def test_mesh_refusals():
    """A mesh must be a ``make_mesh`` mesh; without one the region is the
    identity throughout."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsharding.LocalRegion(object())
    region = tsharding.NO_REGION
    assert region.sizes == {a: 1 for a in tmesh.MESH_AXES}
    x = torch.arange(6.).reshape(2, 3)
    for fn in (region.tp_copy, region.tp_sum, region.seq_chunk,
               region.data_sum):
        assert fn(x) is x
    assert region.param(x, ("embed", "vocab")) is x
    assert tsharding.shard_constraint(x, ("batch", None)) is x


def test_cli_trains_on_two_processes(tmp_path):
    """The training CLI (``train.loop.main``) with ``--dp 2``, as two
    processes with the rendezvous env (one per listed worker) trains on a dp 2 mesh over
    gloo; only rank 0 logs. Each rank points the store at a free port
    before it runs the CLI's ``main``, so no fixed port is shared."""
    args = ["--preset", "smoke", "--device", "cpu", "--dp", "2",
            "--steps", "2", "--batch", "4", "--seq", "32",
            "--log-every", "2"]
    pkg = "service_account_auth_improvements_tpu_torch"
    cmd = [sys.executable, "-c",
           f"from {pkg}.parallel import multihost; "
           f"multihost.COORD_PORT = {_free_port()}; "
           f"from {pkg}.train import loop; loop.main({args!r})"]
    procs = []
    for rank in range(2):
        env = {**os.environ, "TPU_WORKER_ID": str(rank),
               "TPU_WORKER_HOSTNAMES": "localhost,localhost",
               "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(cmd, cwd=tmp_path, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "step 2/2 loss=" in outs[0][0]
    assert outs[0][0].count("loss=") == 1
    assert "loss=" not in outs[1][0]
