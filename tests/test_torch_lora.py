"""Port parity: LoRA (train/lora.py) against the JAX ``train/lora.py``.

Adapters and base weights are the JAX package's, bridged as numpy. The
merge is held to JAX's per leaf: f32 bases within summation order of the
rank-r product (atol 1e-6), bf16 bases within one bf16 ulp of the base
value (the f32 products may round to neighbouring bf16 values). Three
``make_lora_train_step`` steps against the jitted JAX step in f32 compute
use ``tests/test_torch_train.py``'s tolerances: loss 2e-6, grad norm
1e-6 relative, adapters and moments atol 5e-6 + rtol 1e-5. The base
params come back bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.train import lora as jlora  # noqa: E402
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    lora as tlora,
    step as tstep,
)

TINY = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
MOE = dataclasses.replace(jllama.PRESETS["moe_smoke"], dtype="float32",
                          n_layers=2)


def _tcfg(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def _tlcfg(lcfg):
    return tlora.LoraConfig(**dataclasses.asdict(lcfg))


def _t(tree, dtype=torch.float32):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            dtype), tree)


def _np(t):
    return t.detach().float().numpy()


def _random_adapters(cfg, lcfg, seed=3):
    """JAX's adapter tree with B drawn too (B = 0 would hide the merge)."""
    lora = jlora.init_lora(cfg, lcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return {t: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(0, 0.05, ab["b"].shape), jnp.float32)}
        for t, ab in lora.items()}


@pytest.mark.parametrize("cfg,targets", [
    (TINY, ("wq", "wk", "wv", "wo")),
    (TINY, ("w_gate", "w_up", "w_down")),
    (MOE, ("wq", "moe_gate", "moe_up", "moe_down", "router")),
])
def test_adapter_shapes_axes_and_count_match_jax(cfg, targets):
    """The port's shape arithmetic gives JAX's ``eval_shape`` shapes for
    every layer leaf; the adapters (leading layer and expert axes too),
    their axes and the count are the reference's; A ~ N(0, 1/d_in), B =
    0, f32."""
    lcfg = jlora.LoraConfig(rank=4, targets=targets)
    tcfg, tl = _tcfg(cfg), _tlcfg(lcfg)
    real = tllama.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: tuple(t.shape) for n, t in real["layers"].items()} == \
        tlora._layer_shapes(tcfg)
    want = jlora.init_lora(cfg, lcfg, jax.random.key(1))
    got = tlora.init_lora(tcfg, tl, torch.Generator().manual_seed(1),
                          device="cpu")
    assert sorted(got) == sorted(want)
    for t in targets:
        for k in "ab":
            assert tuple(got[t][k].shape) == want[t][k].shape
            assert got[t][k].dtype == torch.float32
        assert not got[t]["b"].any()
        d_in = got[t]["a"].shape[-2]
        assert abs(float(got[t]["a"].std()) * d_in ** 0.5 - 1) < 0.2
    assert tlora.lora_logical_axes(tcfg, tl) == jlora.lora_logical_axes(
        cfg, lcfg)
    n = sum(x.numel() for ab in got.values() for x in ab.values())
    assert n == tlora.lora_param_count(tcfg, tl) == jlora.lora_param_count(
        cfg, lcfg)


def test_lora_param_count_at_llama3_8b_allocates_nothing():
    """Shape arithmetic only: the 8B preset's default adapters (rank 8 on
    wq wk wv wo: 6,815,744 params) are counted without an 8B init."""
    cfg = tllama.PRESETS["llama3_8b"]
    assert tlora.lora_param_count(cfg, tlora.LoraConfig()) == 6_815_744
    assert tlora.lora_param_count(cfg, tlora.LoraConfig()) == \
        jlora.lora_param_count(jllama.PRESETS["llama3_8b"],
                               jlora.LoraConfig())


def test_zero_b_merge_is_identity():
    """B = 0 at init: every merged leaf equals the base bit for bit, and
    untargeted leaves are the base's own tensors."""
    tcfg = _tcfg(TINY)
    tl = tlora.LoraConfig(rank=4)
    params = tllama.init(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    lora = tlora.init_lora(tcfg, tl, torch.Generator().manual_seed(1),
                           device="cpu")
    merged = tlora.merge_lora(params, lora, tl)
    for name in tl.targets:
        assert torch.equal(merged["layers"][name], params["layers"][name])
    assert merged["layers"]["attn_norm"] is params["layers"]["attn_norm"]
    assert merged["tok_embed"] is params["tok_embed"]
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, TINY.vocab_size, (2, 8)))
    assert torch.equal(tllama.apply(tcfg, params, toks),
                       tllama.apply(tcfg, merged, toks))


@pytest.mark.parametrize("cfg,targets,base_dtype", [
    (TINY, ("wq", "wk", "wv", "wo"), "float32"),
    (TINY, ("wq", "wk", "wv", "wo"), "bfloat16"),
    (MOE, ("wq", "moe_gate", "moe_down"), "float32"),
    (MOE, ("wq", "moe_gate", "moe_down"), "bfloat16"),
])
def test_merge_lora_matches_jax(cfg, targets, base_dtype):
    cfg = dataclasses.replace(cfg, param_dtype=base_dtype)
    lcfg = jlora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    base = jllama.init(cfg, jax.random.key(0))
    lora = _random_adapters(cfg, lcfg)
    want = jlora.merge_lora(base, lora, lcfg)
    tdt = tllama.dtype_of(base_dtype)
    got = tlora.merge_lora(_t(base, tdt), _t(lora), _tlcfg(lcfg))
    for name in want["layers"]:
        w = np.asarray(want["layers"][name], np.float32)
        g = got["layers"][name]
        assert g.dtype == tdt, name
        if base_dtype == "float32":
            np.testing.assert_allclose(_np(g), w, atol=1e-6, rtol=0,
                                       err_msg=name)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert (np.abs(_np(g) - w) <= ulp).all(), name
        if name not in targets:
            np.testing.assert_array_equal(_np(g), w)


def test_three_lora_steps_match_jax():
    """3 adapter steps against the jitted JAX step from the same base,
    adapters and zero moments (f32 compute). The first step moves B only
    (A's gradient is B·… = 0), the later ones both."""
    cfg = TINY
    lcfg = jlora.LoraConfig(rank=4)
    jopt = jstep.make_optimizer(learning_rate=1e-2, weight_decay=0.0)
    topt = tstep.make_optimizer(learning_rate=1e-2, weight_decay=0.0)
    base = jllama.init(cfg, jax.random.key(0))
    js = jlora.init_lora_state(cfg, lcfg, jax.random.key(1), jopt)
    tbase = _t(base)
    tbase_copy = {n: t.clone() for n, t in tstep._leaves(tbase)}
    tl = _tlcfg(lcfg)
    lora = _t(js.params)
    ts = tstep.TrainState(0, lora, topt.init(lora))
    jfn = jlora.make_lora_train_step(cfg, lcfg, jopt)
    tfn = tlora.make_lora_train_step(_tcfg(cfg), tl, topt)
    rng = np.random.default_rng(1)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
        mask = np.ones_like(toks)
        mask[1, 17:] = 0  # a padded row
        js, jm = jfn(js, base, jnp.asarray(toks), jnp.asarray(mask))
        ts, tm = tfn(ts, tbase, torch.tensor(toks, dtype=torch.long),
                     torch.tensor(mask))
        adam = js.opt_state[1][0]
        assert ts.step == int(js.step) == i + 1
        assert ts.opt_state.count == int(adam.count) == i + 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 2e-6, i
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for what, want, got in (("adapters", js.params, ts.params),
                                ("mu", adam.mu, ts.opt_state.mu),
                                ("nu", adam.nu, ts.opt_state.nu)):
            atol = 5e-6 * (1e-3 if what == "nu" else 1)
            # both flatten the nested dicts in sorted key order
            for (name, g), w in zip(tstep._leaves(got),
                                    jax.tree.leaves(want)):
                np.testing.assert_allclose(
                    _np(g), np.asarray(w), atol=atol, rtol=1e-5,
                    err_msg=f"{what} {name} step {i}")
    # only B moved in step 1, so after 3 steps both have
    assert ts.params["wq"]["b"].abs().max() > 0
    for name, t in tstep._leaves(tbase):
        assert torch.equal(t, tbase_copy[name]), name
        assert not t.requires_grad


def test_lora_step_gives_the_base_no_grad():
    """The frozen base never requires grad and never gets a .grad, even
    when the caller's base leaves require grad."""
    tcfg = _tcfg(TINY)
    tl = tlora.LoraConfig(rank=2)
    base = tllama.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for _, t in tstep._leaves(base):
        t.requires_grad_(True)
    state = tlora.init_lora_state(tcfg, tl, torch.Generator().manual_seed(1),
                                  device="cpu")
    toks = torch.randint(0, TINY.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    state, m = tlora.make_lora_train_step(tcfg, tl)(
        state, base, toks, torch.ones_like(toks))
    assert torch.isfinite(m["loss"]) and state.step == 1
    assert all(t.grad is None for _, t in tstep._leaves(base))
    assert sorted(state.opt_state.mu) == sorted(tl.targets)


def test_unknown_and_2d_targets_raise():
    tcfg = _tcfg(TINY)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="nope"):
        tlora.init_lora(tcfg, tlora.LoraConfig(targets=("nope",)), gen,
                        device="cpu")
    with pytest.raises(ValueError, match="not a matmul"):
        tlora.init_lora(tcfg, tlora.LoraConfig(targets=("attn_norm",)),
                        gen, device="cpu")
    # a mesh runs (tests/test_torch_side_meshes.py); it must be a
    # make_mesh mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlora.make_lora_train_step(tcfg, tlora.LoraConfig(), mesh=object())
