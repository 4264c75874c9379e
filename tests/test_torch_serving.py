"""Port parity: the generation server against the JAX service.

Greedy completions of the port's GenerationService must equal the JAX
service's, ids for ids, for the same body (float32, tiny preset), both
with the per-length prefill (prefill_window None) and the chunked one,
with and without a speculative draft. ``main`` serves a training
checkpoint, int8 weights and a draft model.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.models import serving as jserving  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
    serving as tserving,
)

CFG = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
TCFG = tllama.LlamaConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(CFG, jax.random.key(0)))
    return tree, tparams.from_numpy(tree, TCFG, "cpu")


def port_service(weights, **kw):
    return tserving.GenerationService(TCFG, weights[1], max_new_cap=32,
                                      name="tiny", device="cpu", **kw)


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_completions_match_jax_service(weights, window):
    prompts = np.random.RandomState(0).randint(
        0, CFG.vocab_size, (2, 11)).tolist()
    body = {"prompt_ids": prompts, "max_new_tokens": 13}
    want = jserving.GenerationService(
        CFG, weights[0], max_new_cap=32, name="tiny",
        prefill_window=window).complete(dict(body))
    got = port_service(weights, prefill_window=window).complete(dict(body))
    assert got == want


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_moe_greedy_completions_match_jax_service(preset, window):
    cfg = dataclasses.replace(jllama.PRESETS[preset], dtype="float32")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(cfg, jax.random.key(0)))
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 11)).tolist()
    body = {"prompt_ids": prompts, "max_new_tokens": 9}
    want = jserving.GenerationService(
        cfg, tree, max_new_cap=32, name=preset,
        prefill_window=window).complete(dict(body))
    got = tserving.GenerationService(
        tcfg, tparams.from_numpy(tree, tcfg, "cpu"), max_new_cap=32,
        name=preset, prefill_window=window,
        device="cpu").complete(dict(body))
    assert got == want


def test_sampled_completion_reproducible_and_effective_top_k(weights):
    svc = port_service(weights)
    body = {"prompt_ids": [5, 9, 2], "max_new_tokens": 6,
            "temperature": 0.8, "top_k": 5, "top_p": 0.9, "seed": 7}
    a, b = svc.complete(dict(body)), svc.complete(dict(body))
    assert a == b and a["top_k"] == 8  # pow-2 bucketed
    assert all(0 <= t < CFG.vocab_size for t in a["completion_ids"][0])


def test_validation_and_busy(weights):
    svc = port_service(weights, max_streams=1)
    bad = [
        ({"prompt_ids": [[1, 2], [3]]}, "equal length"),
        ({"prompt_ids": []}, "non-empty"),
        ({"prompt_ids": [[1, 2]], "max_new_tokens": 0}, "max_new_tokens"),
        ({"prompt_ids": [[CFG.vocab_size]]}, "token ids"),
        ({"prompt_ids": [[1, 2]], "temperature": True}, "boolean"),
        ({"prompt_ids": [[1, 2]], "max_new_tokens": 2.5}, "integer"),
        ({"prompt_ids": [[1, 2]], "top_k": 512}, "top_k"),
        ({"prompt_ids": [[1, 2]], "seed": None}, "seed"),
        ({"prompt_ids": [[1] * 9] * 9}, "at most 8"),
        ({"prompt_ids": [[1] * (CFG.max_seq_len - 4)],
          "max_new_tokens": 8}, "max_seq_len"),
    ]
    for body, msg in bad:
        with pytest.raises(tserving.BadRequest, match=msg):
            svc.complete(body)
    body = {"prompt_ids": [[1, 2, 3]], "max_new_tokens": 4}
    first = svc.stream_events(dict(body))
    next(first)
    with pytest.raises(tserving.TooBusy):
        svc.stream_events(dict(body))
    first.close()  # slot released
    again = svc.stream_events(dict(body))
    assert next(again)
    again.close()


def _req(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_round_trip(weights):
    svc = port_service(weights, max_streams=1)
    httpd = tserving.make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % httpd.server_address
    try:
        assert _req(base, "/healthz") == (200, b'{"ok": true}')
        code, raw = _req(base, "/v1/models")
        assert code == 200
        assert json.loads(raw)["data"][0]["params"] == CFG.param_count()
        body = {"prompt_ids": [[3, 1, 4, 1, 5]], "max_new_tokens": 7}
        code, raw = _req(base, "/v1/completions", body)
        one_shot = json.loads(raw)
        assert code == 200 and len(one_shot["completion_ids"][0]) == 7
        code, raw = _req(base, "/v1/completions", dict(body, stream=True))
        events = [ln[6:] for ln in raw.decode().split("\n\n") if ln]
        assert code == 200 and events[-1] == "[DONE]"
        streamed = [t for e in events[:-1] for t in json.loads(e)["ids"][0]]
        assert streamed == one_shot["completion_ids"][0]
        code, raw = _req(base, "/v1/completions", {"prompt_ids": "x"})
        assert code == 400 and b"prompt_ids" in raw
        code, raw = _req(base, "/v1/completions", dict(body, stream="yes"))
        assert code == 400
        code, raw = _req(base, "/metrics")
        assert code == 200
        text = raw.decode()
        assert 'serving_requests_total{mode="oneshot",code="200"} 1.0' in text
        assert 'serving_requests_total{mode="stream",code="200"} 1.0' in text
        assert "serving_completion_tokens_total 14.0" in text
        assert _req(base, "/nope")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_main_refuses_unported_flags():
    # --tp/--fsdp serve on a mesh of as many processes
    # (tests/test_torch_sharded_serving.py runs it); alone, the mesh is
    # checked before any process group starts, and bad sizes are refused
    with pytest.raises(ValueError, match="wants 2 devices but 1 present"):
        tserving.main(["--preset", "tiny", "--device", "cpu", "--tp", "2"])
    assert not torch.distributed.is_initialized()
    for argv in (["--tp", "0"], ["--fsdp", "-1"]):
        with pytest.raises(SystemExit):
            tserving.main(["--preset", "tiny", "--device", "cpu", *argv])


def _draft_cfg(cfg):
    return dataclasses.replace(cfg, n_layers=1, dim=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, mlp_dim=64)


def test_speculative_service_matches_plain(weights):
    """With a draft wired in, single-prompt greedy completions equal the
    plain service's, ids for ids (the speculative guarantee), and the JAX
    speculative service's, acceptance stats included; batch > 1 and top-k
    requests take the plain path (no stats)."""
    dcfg = _draft_cfg(CFG)
    dtree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         jllama.init(dcfg, jax.random.key(9)))
    tdcfg = tllama.LlamaConfig(**dataclasses.asdict(dcfg))
    draft = (tdcfg, tparams.from_numpy(dtree, tdcfg, "cpu"))
    body = {"prompt_ids": [[3, 1, 4, 1]], "max_new_tokens": 8}
    plain = port_service(weights).complete(dict(body))
    for window in (None, 8):
        spec = port_service(weights, draft=draft, gamma=3,
                            prefill_window=window)
        got = spec.complete(dict(body))
        want = jserving.GenerationService(
            CFG, weights[0], max_new_cap=32, name="tiny",
            draft=(dcfg, dtree), gamma=3,
            prefill_window=window).complete(dict(body))
        assert got["completion_ids"] == plain["completion_ids"]
        assert got == want
        assert 0.0 <= got["speculative"]["acceptance_rate"] <= 1.0
    multi = spec.complete({"prompt_ids": [[1, 2], [3, 4]],
                           "max_new_tokens": 4})
    assert "speculative" not in multi
    top_k = spec.complete(dict(body, temperature=0.7, top_k=4))
    assert "speculative" not in top_k
    with pytest.raises(ValueError, match="vocab"):
        port_service(weights, draft=(dataclasses.replace(
            tdcfg, vocab_size=CFG.vocab_size + 1), draft[1]))


@pytest.fixture
def served(monkeypatch):
    """main()'s GenerationService, captured instead of served."""
    got = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def make_server(service, host, port):
        got["service"] = service
        return Server()

    monkeypatch.setattr(tserving, "make_server", make_server)
    return got


def test_main_serves_checkpoint_int8_and_draft(tmp_path, served):
    """--checkpoint-dir restores the params a training run saved (f32
    master weights, opt.pt unread), --int8 quantizes target and draft,
    --draft-preset turns single-prompt requests speculative."""
    from service_account_auth_improvements_tpu_torch.models import quantize
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        step,
    )

    cfg = tllama.PRESETS["tiny"]
    state = step.init_train_state(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
    checkpoint.save(tmp_path / "ck", state)
    (tmp_path / "ck" / "0" / "opt.pt").unlink()
    argv = ["--preset", "tiny", "--device", "cpu", "--checkpoint-dir",
            str(tmp_path / "ck"), "--prefill-window", "0"]
    assert tserving.main(argv) == 0
    svc = served["service"]
    assert svc.draft is None and svc.prefill_window is None
    assert torch.equal(svc.params["lm_head"], state.params["lm_head"])
    assert svc.params["lm_head"].dtype == torch.float32

    assert tserving.main(argv + ["--int8", "--draft-preset", "tiny",
                                 "--gamma", "3"]) == 0
    svc = served["service"]
    assert isinstance(svc.params["lm_head"], quantize.QuantizedTensor)
    want = quantize.quantize_array(state.params["lm_head"])
    assert torch.equal(svc.params["lm_head"].values, want.values)
    dcfg, dparams = svc.draft
    assert dcfg.param_dtype == "bfloat16" and svc.gamma == 3
    assert isinstance(dparams["layers"]["wq"], quantize.QuantizedTensor)
    out = svc.complete({"prompt_ids": [[5, 6, 7]], "max_new_tokens": 6})
    assert len(out["completion_ids"][0]) == 6
    assert out["speculative"]["proposed"] > 0
    with pytest.raises(SystemExit):
        tserving.main(argv + ["--gamma", "0"])
