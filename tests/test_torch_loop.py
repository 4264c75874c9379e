"""The port's training loop (train/loop.py) on the CPU: it trains, logs,
and refuses what is not ported yet with the ROADMAP item to look at."""

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


@pytest.mark.parametrize("kw,item", [
    (dict(loop_cfg=dict(workdir="/nonexistent")), "item 4"),
    (dict(loop_cfg=dict(ckpt_every=5)), "item 4"),
    (dict(loop_cfg=dict(eval_every=5)), "item 4"),
    (dict(eval_data=[]), "item 4"),
    (dict(lora=object()), "item 7"),
    (dict(mesh=object()), "item 8"),
])
def test_fit_refuses_what_is_not_ported(kw, item):
    kw = dict(kw)
    lcfg = loop.LoopConfig(steps=1, **kw.pop("loop_cfg", {}))
    mesh = kw.pop("mesh", None)
    with pytest.raises(NotImplementedError, match=item):
        loop.fit(CFG, mesh, TOKENS, DataConfig(batch=2, seq=16), lcfg,
                 device="cpu", **kw)


def test_main_cli(capsys):
    loop.main(["--preset", "tiny", "--steps", "2", "--batch", "2",
               "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1/2 loss=" in out and "step 2/2 loss=" in out
    with pytest.raises(NotImplementedError, match="item 8"):
        loop.main(["--tp", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 4"):
        loop.main(["--workdir", "/nonexistent", "--device", "cpu"])
