"""Port parity: LlamaConfig/PRESETS and the forward pass against the JAX
model. Weights go JAX ``llama.init`` → numpy → ``params.from_numpy``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)


def jax_params(cfg, seed=0):
    """The JAX model's init as a numpy tree (bf16 leaves via f32)."""
    tree = jllama.init(cfg, jax.random.key(seed))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def port_cfg(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def test_config_mirrors_reference_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(jllama.LlamaConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tllama.LlamaConfig)]
    assert tf == jf
    assert sorted(tllama.PRESETS) == sorted(jllama.PRESETS)
    for name, cfg in jllama.PRESETS.items():
        assert dataclasses.asdict(tllama.PRESETS[name]) == \
            dataclasses.asdict(cfg), name


@pytest.mark.parametrize("name", sorted(jllama.PRESETS))
def test_counts_match_reference(name):
    j, t = jllama.PRESETS[name], tllama.PRESETS[name]
    assert t.param_count() == j.param_count()
    assert t.matmul_param_count() == j.matmul_param_count()
    assert t.active_matmul_param_count() == j.active_matmul_param_count()
    assert t.rope_scaling() == j.rope_scaling()
    for seq in (None, 2048):
        assert t.flops_per_token(seq) == j.flops_per_token(seq)


def test_init_layout_matches_reference():
    cfg = jllama.PRESETS["tiny"]
    want = jax_params(cfg)
    got = tllama.init(port_cfg(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
    shapes = jax.tree.map(lambda a: a.shape, want)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    assert got["layers"]["wq"].dtype == torch.float32
    assert torch.all(got["layers"]["attn_norm"] == 1)
    # residual-out projections carry the 1/sqrt(2L) depth scaling
    ratio = (got["layers"]["wo"].std() / got["layers"]["wq"].std()).item()
    assert abs(ratio - 0.5) < 0.1


# logits tolerances (absolute): f32 is summation order only; bf16 is
# bf16 rounding through the residual stream on logits of std ~0.1 (the
# largest difference seen on these inputs is 6.6e-3)
TOL = {"float32": 2e-5, "bfloat16": 1.5e-2}


@pytest.mark.parametrize("preset", ["tiny", "smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_apply_logits_match_jax(preset, dtype, impl):
    cfg = dataclasses.replace(jllama.PRESETS[preset], dtype=dtype,
                              attn_impl=impl)
    tree = jax_params(cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tokens[0, 3] = cfg.vocab_size + 7  # out of range: clamps on both sides
    want = np.asarray(jllama.apply(cfg, jax.tree.map(np.asarray, tree),
                                   tokens))
    tfa.launches = 0
    got = tllama.apply(port_cfg(cfg), tparams.from_numpy(tree, cfg, "cpu"),
                       torch.tensor(tokens, dtype=torch.long))
    assert tfa.launches == 0
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0)


def test_backbone_returns_layer_inputs():
    cfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
    tree = jax_params(cfg)
    tokens = np.arange(10, dtype=np.int32)[None] % cfg.vocab_size
    _, _, want = jllama._backbone(cfg, tree, tokens,
                                  return_layer_inputs=True)
    _, got = tllama._backbone(port_cfg(cfg),
                                 tparams.from_numpy(tree, cfg, "cpu"),
                                 torch.tensor(tokens, dtype=torch.long),
                                 return_layer_inputs=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_moe_and_segment_flash_raise():
    moe = tllama.PRESETS["moe_smoke"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllama.init(moe, torch.Generator(), device="cpu")
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], attn_impl="flash")
    params = tllama.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="segment_ids requires"):
        tllama.apply(cfg, params, tokens,
                     segment_ids=torch.zeros(1, 8, dtype=torch.long))


def test_from_numpy_casts_to_param_dtype():
    cfg = dataclasses.replace(jllama.PRESETS["tiny"], param_dtype="bfloat16")
    tree = jax_params(cfg)
    got = tparams.from_numpy(tree, cfg, "cpu")
    assert got["lm_head"].dtype == torch.bfloat16
    # bf16 leaves crossed as f32 exactly, so the cast back is lossless
    np.testing.assert_array_equal(got["lm_head"].float().numpy(),
                                  tree["lm_head"])
