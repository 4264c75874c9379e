"""Port parity: KV-cache generation against the JAX generate module.

float32 compute throughout, so greedy decoding is required to be
TOKEN-IDENTICAL to the reference; caches and logits are held to f32
summation-order tolerances. Sampling draws differ by design (torch
generators vs jax.random keys), so the filters are compared, not draws.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import generate as jgen  # noqa: E402
from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.ops.rotary import (  # noqa: E402
    rope_table as jrope,
)
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    generate as tgen,
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from service_account_auth_improvements_tpu_torch.ops.rotary import (  # noqa: E402
    rope_table as trope,
)

TOL = dict(atol=5e-5, rtol=1e-5)


def setup(preset="tiny", impl="dense"):
    cfg = dataclasses.replace(jllama.PRESETS[preset], dtype="float32",
                              attn_impl=impl)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(cfg, jax.random.key(0)))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    return cfg, tree, tcfg, tparams.from_numpy(tree, tcfg, "cpu")


def prompt(cfg, b=2, s=11, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.long)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_cache_and_logits(impl):
    cfg, tree, tcfg, tparams_ = setup(impl=impl)
    toks = prompt(cfg)
    jc, jl = jgen.prefill(cfg, tree, toks, 20)
    tc, tl = tgen.prefill(tcfg, tparams_, _t(toks), 20, device="cpu")
    assert tc.length == int(jc.length) == 11
    assert tuple(tc.k.shape) == jc.k.shape
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("m", [1, 5])
def test_extend_cache(m):
    cfg, tree, tcfg, tparams_ = setup()
    toks = prompt(cfg)
    window = prompt(cfg, s=m, seed=1)
    jc, _ = jgen.prefill(cfg, tree, toks, 20)
    tc, _ = tgen.prefill(tcfg, tparams_, _t(toks), 20, device="cpu")
    jcos, jsin = jrope(20, cfg.head_dim, cfg.rope_theta)
    tcos, tsin = trope(20, cfg.head_dim, cfg.rope_theta)
    jc2, jl = jgen.extend_cache(cfg, tree, jc, jnp.asarray(window), jcos,
                                jsin)
    tc2, tl = tgen.extend_cache(tcfg, tparams_, tc, _t(window), tcos, tsin)
    assert tc2.length == int(jc2.length) == 11 + m
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc2.k.numpy(), np.asarray(jc2.k), **TOL)
    np.testing.assert_allclose(tc2.v.numpy(), np.asarray(jc2.v), **TOL)


@pytest.mark.parametrize("preset,impl", [("tiny", "dense"),
                                         ("tiny", "flash"),
                                         ("smoke", "flash"),
                                         ("moe_smoke", "dense"),
                                         ("moe2_smoke", "flash")])
def test_greedy_generate_token_identical(preset, impl):
    cfg, tree, tcfg, tparams_ = setup(preset, impl)
    toks = prompt(cfg, s=13)
    want = np.asarray(jgen.generate(cfg, tree, toks, 12))
    tfa.launches = 0
    got = tgen.generate(tcfg, tparams_, _t(toks), 12, device="cpu")
    assert tfa.launches == 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_chunked_equals_prefill_and_reference():
    cfg, tree, tcfg, tparams_ = setup()
    toks = prompt(cfg, s=21)
    pc, pl = tgen.prefill(tcfg, tparams_, _t(toks), 30, device="cpu")
    cc, cl = tgen.prefill_chunked(tcfg, tparams_, _t(toks), 30, window=8,
                                  device="cpu")
    jc, jl = jgen.prefill_chunked(cfg, tree, jnp.asarray(toks), 30,
                                  window=8)
    assert cc.length == pc.length == int(jc.length) == 21
    assert cc.k.shape[2] == 32  # max_len rounded up to whole windows
    np.testing.assert_allclose(cl.numpy(), pl.numpy(), **TOL)
    np.testing.assert_allclose(cc.k[:, :, :21].numpy(),
                               pc.k[:, :, :21].numpy(), **TOL)
    np.testing.assert_allclose(cl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_moe_windowed_prefill_matches_jax_and_naive_decode(preset):
    """Dropless MoE routing through the windowed prefill (groups of the
    window's length) and the per-length prefill (one group per prompt)
    gives the reference's logits; greedy cached decode equals re-running
    the whole sequence through ``llama.apply`` (dropless) every token."""
    cfg, tree, tcfg, tparams_ = setup(preset)
    toks = prompt(cfg, s=21)
    cc, cl = tgen.prefill_chunked(tcfg, tparams_, _t(toks), 30, window=8,
                                  device="cpu")
    jc, jl = jgen.prefill_chunked(cfg, tree, jnp.asarray(toks), 30,
                                  window=8)
    pc, pl = tgen.prefill(tcfg, tparams_, _t(toks), 30, device="cpu")
    np.testing.assert_allclose(cl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(cc.k[:, :, :21].numpy(),
                               np.asarray(jc.k)[:, :, :21], **TOL)
    got = tgen.generate(tcfg, tparams_, _t(toks), 9, device="cpu")
    naive = _t(toks)
    icfg = tgen._inference_cfg(tcfg)
    for _ in range(9):
        nxt = tllama.apply(icfg, tparams_, naive)[:, -1].argmax(-1)
        naive = torch.cat([naive, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), naive.numpy())


@pytest.mark.parametrize("window", [None, 8])
def test_stream_equals_one_shot(window):
    cfg, tree, tcfg, tparams_ = setup()
    toks = _t(prompt(cfg, s=9))
    want = tgen.generate(tcfg, tparams_, toks, 10, device="cpu")[:, 9:]
    state, first = tgen.start_stream(tcfg, tparams_, toks, 10,
                                     prefill_window=window, device="cpu")
    parts = [first[:, None]]
    for n in (4, 5):
        state, out = tgen.stream_decode(tcfg, tparams_, state, n,
                                        device="cpu")
        parts.append(out)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want.numpy())
    with pytest.raises(ValueError, match="token budget"):
        tgen.stream_decode(tcfg, tparams_, state, 64, device="cpu")


def test_eos_pads_after_first_hit():
    cfg, tree, tcfg, tparams_ = setup()
    toks = prompt(cfg, s=9)
    free = tgen.generate(tcfg, tparams_, _t(toks), 10, device="cpu")
    eos = int(free[0, 12])  # a token row 0 emits mid-completion
    want = np.asarray(jgen.generate(cfg, tree, toks, 10, eos_id=eos))
    got = tgen.generate(tcfg, tparams_, _t(toks), 10, eos_id=eos,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


class _Logits:
    """Stands in for a draw so the reference's filtered logits come out."""

    def __init__(self, logits):
        self.logits = logits

    def astype(self, _):
        return self.logits


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.5), (7, 0.8),
                                         (0, 0.999)])
def test_sample_filters_match_reference(monkeypatch, top_k, top_p):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    logits[1, 10] = logits[1, 11]  # a tie at a possible boundary
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg: _Logits(lg))
    t, p, k_, greedy, use_top_p = jgen._sampling_statics(0.7, top_k, top_p)
    want = jgen._sample(jnp.asarray(logits), None, t, k_, p,
                        greedy=greedy, use_top_p=use_top_p)
    t2, p2, k2, greedy2, use2 = tgen._sampling_statics(0.7, top_k, top_p)
    assert (k2, greedy2, use2) == (k_, greedy, use_top_p)
    assert t2 == pytest.approx(float(t)) and p2 == pytest.approx(float(p))
    got = tgen._filter(torch.tensor(logits), t2, k2, p2, use2)
    np.testing.assert_array_equal(got.numpy() <= -1e38,
                                  np.asarray(want) <= -1e38)
    keep = got.numpy() > -1e38
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               rtol=1e-6)


def test_sampling_is_reproducible_and_in_vocab():
    cfg, tree, tcfg, tparams_ = setup()
    toks = _t(prompt(cfg, s=9))

    def draw(seed):
        return tgen.generate(tcfg, tparams_, toks, 8, temperature=0.9,
                             top_k=20, top_p=0.9, device="cpu",
                             generator=torch.Generator().manual_seed(seed))

    a, b = draw(3), draw(3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
