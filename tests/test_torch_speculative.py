"""Port parity: speculative decoding (models/speculative.py) against the
JAX ``spec_generate`` on bridged weights.

f32 compute, so greedy speculative decoding must be token-identical to
plain greedy decoding of the target (the speculative guarantee) and to
the reference's tokens. Sampled decoding draws from a torch.Generator,
not jax.random, so its tokens are checked for reproducibility and range,
not against JAX's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.models import speculative as jspec  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    generate as tgen,
    llama as tllama,
    params as tparams,
    speculative as tspec,
)

TGT = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
# a different (smaller) draft model with the same vocab
DRAFT = dataclasses.replace(
    jllama.PRESETS["tiny"], dtype="float32", n_layers=1, dim=32,
    n_heads=2, n_kv_heads=2, head_dim=16, mlp_dim=64)


def _port(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("t", TGT, 0), ("d", DRAFT, 99)):
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jllama.init(cfg, jax.random.key(seed)))
        out[name] = (cfg, tree, _port(cfg),
                     tparams.from_numpy(tree, _port(cfg), "cpu"))
    return out


def _prompt(seed, s=6):
    return np.random.default_rng(seed).integers(
        0, TGT.vocab_size, (1, s)).astype(np.int32)


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_equals_plain_greedy_and_jax(models, window):
    jt, jtp, tt, ttp = models["t"]
    jd, jdp, td, tdp = models["d"]
    prompt = _prompt(1)
    want = tgen.generate(tt, ttp, torch.tensor(prompt, dtype=torch.long),
                         12, device="cpu")
    got, stats = tspec.spec_generate(tt, ttp, td, tdp, prompt, 12, gamma=3,
                                     prefill_window=window, device="cpu")
    assert torch.equal(got, want)
    jgot, jstats = jspec.spec_generate(jt, jtp, jd, jdp, jnp.asarray(prompt),
                                       12, gamma=3, prefill_window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats == jstats  # greedy: the same proposals and acceptances
    assert 0.0 <= stats["acceptance_rate"] <= 1.0 and stats["proposed"] > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_target_greedy_equals_plain_greedy_and_jax(models, top_k):
    """A MoE target (dropless routing in the verify windows) with the
    dense draft: token-identical to plain greedy and to JAX, with the
    same proposals and acceptances."""
    cfg = dataclasses.replace(TGT, moe_experts=4, moe_top_k=top_k)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(cfg, jax.random.key(5)))
    tcfg = _port(cfg)
    tp = tparams.from_numpy(tree, tcfg, "cpu")
    jd, jdp, td, tdp = models["d"]
    prompt = _prompt(6)
    want = tgen.generate(tcfg, tp, torch.tensor(prompt, dtype=torch.long),
                         12, device="cpu")
    got, stats = tspec.spec_generate(tcfg, tp, td, tdp, prompt, 12, gamma=3,
                                     device="cpu")
    assert torch.equal(got, want)
    jgot, jstats = jspec.spec_generate(cfg, tree, jd, jdp,
                                       jnp.asarray(prompt), 12, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats == jstats


def test_self_draft_accepts_everything(models):
    _, _, tt, ttp = models["t"]
    prompt = _prompt(2, s=5)
    got, stats = tspec.spec_generate(tt, ttp, tt, ttp, prompt, 12, gamma=4,
                                     device="cpu")
    want = tgen.generate(tt, ttp, torch.tensor(prompt, dtype=torch.long),
                         12, device="cpu")
    assert torch.equal(got, want)
    assert stats["acceptance_rate"] == 1.0


def test_sampled_reproducible_per_seed_and_valid(models):
    _, _, tt, ttp = models["t"]
    _, _, td, tdp = models["d"]
    prompt = _prompt(3, s=5)

    def run(seed):
        return tspec.spec_generate(
            tt, ttp, td, tdp, prompt, 10, gamma=3, temperature=0.8,
            generator=torch.Generator().manual_seed(seed), device="cpu")

    (a, sa), (b, sb) = run(7), run(7)
    assert torch.equal(a, b) and sa == sb
    assert tuple(a.shape) == (1, 15)
    assert 0 <= int(a.min()) and int(a.max()) < TGT.vocab_size
    assert torch.equal(a[:, :5], torch.tensor(prompt, dtype=torch.long))
    assert any(not torch.equal(run(s)[0], a) for s in (8, 9, 10))


def test_eos_stops_early(models):
    _, _, tt, ttp = models["t"]
    _, _, td, tdp = models["d"]
    prompt = _prompt(4, s=5)
    free = tgen.generate(tt, ttp, torch.tensor(prompt, dtype=torch.long),
                         12, device="cpu")[0, 5:].tolist()
    eos = free[2]  # the third generated token
    got, _ = tspec.spec_generate(tt, ttp, td, tdp, prompt, 12, gamma=3,
                                 eos_id=eos, device="cpu")
    out = got[0, 5:].tolist()
    j = free.index(eos)
    assert out == free[: j + 1]


def test_stats_keys_match_jax_and_bad_input_raises(models):
    jt, jtp, tt, ttp = models["t"]
    prompt = _prompt(5, s=4)
    _, jstats = jspec.spec_generate(jt, jtp, jt, jtp, jnp.asarray(prompt), 3,
                                    gamma=2)
    _, stats = tspec.spec_generate(tt, ttp, tt, ttp, prompt, 3, gamma=2,
                                   device="cpu")
    assert sorted(stats) == sorted(jstats) == ["acceptance_rate", "accepted",
                                               "proposed"]
    with pytest.raises(ValueError, match="batch-1"):
        tspec.spec_generate(tt, ttp, tt, ttp, np.zeros((2, 3), np.int32), 3,
                            device="cpu")
    with pytest.raises(ValueError, match="vocabularies"):
        tspec.spec_generate(tt, ttp, dataclasses.replace(tt, vocab_size=9),
                            ttp, prompt, 3, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tspec.spec_generate(tt, ttp, tt, ttp, prompt, 3, gamma=0,
                            device="cpu")
