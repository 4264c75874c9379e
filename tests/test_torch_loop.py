"""The port's training loop (train/loop.py) on the CPU: it trains, logs,
checkpoints, resumes bit for bit, evaluates on its cadence, fine-tunes
LoRA adapters over frozen base params (resumed bit for bit, evaluated on
the merged params), and refuses what is not ported yet with the ROADMAP
item to look at."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from service_account_auth_improvements_tpu_torch.models import llama  # noqa: E402
from service_account_auth_improvements_tpu_torch.train import loop  # noqa: E402
from service_account_auth_improvements_tpu_torch.train.data import (  # noqa: E402
    DataConfig,
)

CFG = llama.PRESETS["tiny"]
# a learnable corpus: one 16-token phrase over and over
TOKENS = np.tile(np.random.default_rng(0).integers(0, CFG.vocab_size, 16),
                 512).astype(np.int32)


def test_fit_descends_and_logs():
    logs = []
    state, history = loop.fit(
        CFG, None, TOKENS, DataConfig(batch=4, seq=64),
        loop.LoopConfig(steps=12, log_every=4),
        optimizer=loop.make_optimizer(learning_rate=3e-3),
        log=logs.append, device="cpu")
    assert state.step == 12 and state.opt_state.count == 12
    assert [r["step"] for r in history] == [4, 8, 12]
    assert history[-1]["loss"] < history[0]["loss"] - 0.5
    assert all(r["tokens_per_sec"] > 0 for r in history)
    assert all("mfu" not in r for r in history)  # no card: peak unknown
    assert len(logs) == 3 and logs[0].startswith("step 4/12 loss=")


def test_fit_packed_flash_config_runs():
    """Packed data with a flash config: the boundary loss mask only (no
    segment ids), kernels' plain versions on the CPU."""
    cfg = dataclasses.replace(CFG, head_dim=64, n_heads=2, n_kv_heads=1,
                              attn_impl="flash")
    flat = np.where(TOKENS % 5 == 0, 1, TOKENS).astype(np.int32)
    _, history = loop.fit(cfg, None, flat,
                          DataConfig(batch=2, seq=32, eos_id=1),
                          loop.LoopConfig(steps=2, log_every=1),
                          log=lambda *a: None, device="cpu")
    assert len(history) == 2 and all(np.isfinite(r["loss"])
                                     for r in history)


@pytest.mark.parametrize("kw,error,item", [
    # LoRA is ported: without base_params it is refused as the reference
    # refuses it
    (dict(lora=object()), ValueError, "lora fit requires base_params"),
    # a mesh trains LoRA too (tests/test_torch_side_meshes.py), when it
    # is a parallel.make_mesh mesh
    (dict(mesh=object(), lora=object(), base_params=object()),
     TypeError, "DeviceMesh"),
    # and what is not a parallel.make_mesh DeviceMesh is refused
    (dict(mesh=object()), TypeError, "DeviceMesh"),
])
def test_fit_refuses_what_is_not_ported(kw, error, item):
    kw = dict(kw)
    lcfg = loop.LoopConfig(steps=1, **kw.pop("loop_cfg", {}))
    mesh = kw.pop("mesh", None)
    with pytest.raises(error, match=item):
        loop.fit(CFG, mesh, TOKENS, DataConfig(batch=2, seq=16), lcfg,
                 device="cpu", **kw)


def test_main_cli(capsys):
    loop.main(["--preset", "tiny", "--steps", "2", "--batch", "2",
               "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1/2 loss=" in out and "step 2/2 loss=" in out
    # mesh flags need as many processes (tests/test_torch_mesh.py runs the
    # CLI on two); alone, the mesh is checked before any process group
    with pytest.raises(ValueError, match="wants 2 devices but 1 present"):
        loop.main(["--tp", "2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def _fit(steps, logs, **kw):
    eval_data = kw.pop("eval_data", None)
    return loop.fit(CFG, None, TOKENS, DataConfig(batch=4, seq=64),
                    loop.LoopConfig(steps=steps, log_every=1, **kw),
                    log=logs.append, eval_data=eval_data, device="cpu")


def _leaves(state):
    from service_account_auth_improvements_tpu_torch.train.step import (
        _leaves,
    )

    return [t for tree in (state.params, state.opt_state.mu,
                           state.opt_state.nu) for _, t in _leaves(tree)]


def test_fit_resumes_from_its_workdir_bitwise(tmp_path):
    """4 steps straight against 2 steps into a workdir and a fresh fit of
    4 on it: the second fit logs the resume, runs steps 3 and 4 only, and
    ends with the same bits in every param and moment."""
    straight, _ = _fit(4, [])
    logs = []
    half, _ = _fit(2, logs, workdir=str(tmp_path), ckpt_every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2"]
    resumed, history = _fit(4, logs, workdir=str(tmp_path), ckpt_every=2)
    assert any(line.startswith("resumed from step 2") for line in logs)
    assert [r["step"] for r in history] == [3, 4]
    assert (resumed.step, resumed.opt_state.count) == (4, 4)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(resumed),
                                                 _leaves(straight)))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "4"]
    # the end-of-run save of step 4 coincided with ckpt_every: one write
    assert sum("saved checkpoint step 4" in line for line in logs) == 1
    # nothing left to do: no step runs and nothing is written
    again, history = _fit(4, logs, workdir=str(tmp_path))
    assert history == [] and again.step == 4


def test_fit_periodic_eval_records():
    held_out = [TOKENS[:256].reshape(4, 64),
                (TOKENS[256:512].reshape(4, 64), np.ones((4, 64), np.int32))]
    logs = []
    _, history = _fit(4, logs, eval_every=2, eval_data=iter(held_out))
    evals = [r for r in history if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        assert set(r) == {"step", "eval_loss", "eval_perplexity",
                          "eval_tokens"}
        assert r["eval_tokens"] == 2 * 4 * 63
        assert r["eval_perplexity"] == pytest.approx(
            np.exp(r["eval_loss"]), rel=1e-3)
    assert evals[1]["eval_loss"] < evals[0]["eval_loss"]  # it learns
    assert sum(" eval loss=" in line for line in logs) == 2


def test_fit_accepts_eval_data_without_eval_every():
    """The reference accepts eval_data with eval_every 0 and ignores it."""
    _, history = _fit(2, [], eval_data=[TOKENS[:128].reshape(2, 64)])
    assert [r["step"] for r in history] == [1, 2]


@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_main_cli_trains_and_resumes_a_moe_preset(tmp_path, capsys, preset):
    """The training CLI takes a MoE preset as it takes a dense one: it
    trains, checkpoints the router and expert leaves and resumes from
    them."""
    from service_account_auth_improvements_tpu_torch.train import checkpoint

    argv = ["--preset", preset, "--batch", "2", "--seq", "32",
            "--log-every", "1", "--device", "cpu", "--workdir",
            str(tmp_path)]
    first = loop.main(argv + ["--steps", "2"])
    history = loop.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 3/3 loss=" in out
    assert [r["step"] for r in first + history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in first + history)
    params = checkpoint.restore_params(tmp_path, None,
                                       llama.PRESETS[preset], device="cpu")
    assert {"router", "moe_gate", "moe_up", "moe_down"} <= set(
        params["layers"])


def test_main_cli_resumes_from_workdir(tmp_path, capsys):
    argv = ["--preset", "tiny", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", "cpu", "--workdir",
            str(tmp_path)]
    loop.main(argv + ["--steps", "1"])
    history = loop.main(argv + ["--steps", "2", "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "step 2/2 loss=" in out
    assert [r["step"] for r in history] == [2]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1", "2"]


def _lora_fit(steps, logs, base, **kw):
    from service_account_auth_improvements_tpu_torch.train.lora import (
        LoraConfig,
    )

    eval_data = kw.pop("eval_data", None)
    return loop.fit(CFG, None, TOKENS, DataConfig(batch=4, seq=64),
                    loop.LoopConfig(steps=steps, log_every=1, **kw),
                    log=logs.append, eval_data=eval_data,
                    lora=LoraConfig(rank=4), base_params=base, device="cpu")


def _base():
    return llama.init(CFG, torch.Generator().manual_seed(5), device="cpu")


def test_lora_fit_resumes_from_its_adapter_checkpoint_bitwise(tmp_path):
    """4 adapter steps straight against 2 into a workdir and a fresh fit
    resuming to 4: the checkpoint holds the adapter tree only (no base
    leaf), the resumed state equals the straight one bit for bit, the
    base is untouched, and history carries no MFU."""
    base = _base()
    before = {n: t.clone() for n, t in _leaves_of(base)}
    straight, _ = _lora_fit(4, [], base)
    logs = []
    _lora_fit(2, logs, base, workdir=str(tmp_path), ckpt_every=2)
    saved = torch.load(tmp_path / "2" / "params.pt", weights_only=True)
    assert sorted(saved) == ["wk", "wo", "wq", "wv"]
    assert sorted(saved["wq"]) == ["a", "b"]
    resumed, history = _lora_fit(4, logs, base, workdir=str(tmp_path),
                                 ckpt_every=2)
    assert any(line.startswith("resumed from step 2") for line in logs)
    assert [r["step"] for r in history] == [3, 4]
    assert all("mfu" not in r and np.isfinite(r["loss"]) for r in history)
    assert (resumed.step, resumed.opt_state.count) == (4, 4)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(resumed),
                                                 _leaves(straight)))
    assert resumed.params["wq"]["b"].abs().max() > 0
    assert all(torch.equal(t, before[n]) for n, t in _leaves_of(base))


def test_lora_fit_evaluates_the_merged_params_without_weight_decay():
    """The eval records are ``evaluate`` on base + adapters (not on the
    adapters or the bare base), and the default optimizer has no weight
    decay: in the first step A's gradient is exactly 0 (B = 0), so A
    keeps its initial bits while B moves."""
    from service_account_auth_improvements_tpu_torch.train import (
        evaluate,
        lora,
    )

    base = _base()
    held_out = [TOKENS[:256].reshape(4, 64)]
    state, history = _lora_fit(2, [], base, eval_every=2,
                               eval_data=held_out)
    rec = [r for r in history if "eval_loss" in r]
    assert [r["step"] for r in rec] == [2]
    merged = lora.merge_lora(base, state.params, lora.LoraConfig(rank=4))
    want = evaluate.evaluate(CFG, merged, held_out, device="cpu")
    assert rec[0]["eval_loss"] == round(want["loss"], 4)
    bare = evaluate.evaluate(CFG, base, held_out, device="cpu")
    assert rec[0]["eval_loss"] != round(bare["loss"], 4)
    one, _ = _lora_fit(1, [], base)
    init = lora.init_lora_state(CFG, lora.LoraConfig(rank=4),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    for t in ("wq", "wk", "wv", "wo"):
        assert torch.equal(one.params[t]["a"], init.params[t]["a"])
        assert one.params[t]["b"].abs().max() > 0


def _leaves_of(tree):
    from service_account_auth_improvements_tpu_torch.train.step import (
        _leaves,
    )

    return list(_leaves(tree))
