"""Port parity: sharded serving. ``GenerationService(mesh=)`` on fsdp 2 x
tp 2 gloo CPU ranks (``tests/torch_parallel_workers.py``), f32, against
the JAX package's sharded service on its virtual devices and the port's
unsharded service: greedy one-shot and streamed completions token for
token, with the per-length and the windowed prefill; int8 weights with a
draft model (speculative decoding) against the port's unsharded int8
service. Rank 0 takes the requests and the other ranks decode them in
lockstep (``follow``). The serving CLI's ``--tp 2`` runs as two
processes behind one HTTP server.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from service_account_auth_improvements_tpu.models import (  # noqa: E402
    llama as jllama,
    serving as jserving,
)
from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig,
    make_mesh,
)
from service_account_auth_improvements_tpu.parallel.sharding import (  # noqa: E402
    tree_logical_sharding,
)
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
    quantize as tquantize,
    serving as tserving,
)
from tests import torch_parallel_workers as workers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                          iota_embed=True)
DRAFT = dataclasses.replace(CFG, n_layers=1, dim=32, n_heads=2,
                            n_kv_heads=2, head_dim=16, mlp_dim=64)
BODIES = [
    {"prompt_ids": [[5, 9, 2, 6, 7, 1], [3, 3, 8, 1, 4, 2]],
     "max_new_tokens": 8},
    {"prompt_ids": [[5, 9, 2, 6]], "max_new_tokens": 8},
    {"prompt_ids": [[11, 4, 7, 1, 9]], "max_new_tokens": 10,
     "stream": True},
]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tcfg(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def _stream(svc, body):
    rows = None
    for chunk in svc.stream_events(dict(body)):
        rows = ([list(c) for c in chunk] if rows is None
                else [r + c for r, c in zip(rows, chunk)])
    return rows


def test_sharded_service_matches_jax_and_unsharded(tmp_path):
    params = jllama.init(CFG, jax.random.key(0))
    dparams = jllama.init(DRAFT, jax.random.key(1))
    torch.save({"params": _np(params), "draft": _np(dparams)},
               tmp_path / "serve-init.pt")
    workers.launch("serve", 4, tmp_path,
                   dataclasses.asdict(_tcfg(CFG)),
                   dataclasses.asdict(_tcfg(DRAFT)), dict(fsdp=2, tp=2),
                   BODIES)
    got = workers.load(tmp_path / "serve.pt")
    # each rank holds its blocks: wq [L, dim/fsdp, q_dim/tp]
    assert got["local_wq"] == (CFG.n_layers, CFG.dim // 2, CFG.q_dim // 2)
    jmesh = make_mesh(MeshConfig(fsdp=2, tp=2), jax.devices()[:4])
    sharded = jax.device_put(params, tree_logical_sharding(
        jmesh, jllama.logical_axes(CFG)))
    tp = tparams.from_numpy(_np(params), _tcfg(CFG), device="cpu")
    for name, window in (("window0", 0), ("window4", 4)):
        jsvc = jserving.GenerationService(CFG, sharded, mesh=jmesh,
                                          prefill_window=window or None)
        plain = tserving.GenerationService(_tcfg(CFG), tp, max_new_cap=32,
                                           prefill_window=window,
                                           device="cpu")
        for body, mine in zip(BODIES, got[name]):
            if body.get("stream"):
                want = [sum((c[0] for c in jsvc.stream_events(
                    dict(body))), [])]
                assert mine == want == _stream(plain, body), name
            else:
                want = jsvc.complete(dict(body))["completion_ids"]
                assert mine[0] == want == plain.complete(
                    dict(body))["completion_ids"], name
    # int8 weights and a draft: the unsharded port service's tokens and
    # acceptance
    dtp = tparams.from_numpy(_np(dparams), _tcfg(DRAFT), device="cpu")
    plain = tserving.GenerationService(
        _tcfg(CFG), tquantize.quantize_params(tp), max_new_cap=32,
        prefill_window=0, device="cpu",
        draft=(_tcfg(DRAFT), tquantize.quantize_params(dtp)))
    for body, mine in zip(BODIES, got["int8-draft"]):
        if body.get("stream"):
            assert mine == _stream(plain, body)
        else:
            reply = plain.complete(dict(body))
            assert mine == (reply["completion_ids"],
                            reply.get("speculative"))
    assert got["int8-draft"][1][1] is not None  # one prompt: speculative


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serving_cli_on_two_processes(tmp_path):
    """``models.serving --tp 2`` as two processes with the rendezvous env:
    rank 0 answers over HTTP (the same completion twice), rank 1 decodes
    in lockstep and prints nothing, and both exit 0 when rank 0 is
    interrupted."""
    port, store = _free_port(), _free_port()
    pkg = "service_account_auth_improvements_tpu_torch"
    args = ["--preset", "tiny", "--device", "cpu", "--tp", "2",
            "--host", "127.0.0.1", "--port", str(port), "--max-new-cap",
            "16"]
    cmd = [sys.executable, "-c",
           f"from {pkg}.parallel import multihost; "
           f"multihost.COORD_PORT = {store}; "
           f"from {pkg}.models import serving; serving.main({args!r})"]
    procs = []
    for rank in range(2):
        env = {**os.environ, "TPU_WORKER_ID": str(rank),
               "TPU_WORKER_HOSTNAMES": "localhost,localhost",
               "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(cmd, cwd=tmp_path, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        body = json.dumps({"prompt_ids": [[5, 9, 2, 6]],
                           "max_new_tokens": 6}).encode()
        replies, deadline = [], time.monotonic() + 120
        while len(replies) < 2:
            assert all(p.poll() is None for p in procs), procs[0].stderr
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    replies.append(json.loads(r.read()))
            except OSError:
                assert time.monotonic() < deadline, "no server"
                time.sleep(0.5)
        procs[0].send_signal(signal.SIGINT)
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]
    ids = replies[0]["completion_ids"]
    assert len(ids) == 1 and len(ids[0]) == 6
    assert replies[1]["completion_ids"] == ids
    assert "mesh of 2" in outs[0][0] and outs[1][0] == ""
