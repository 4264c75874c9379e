"""Port parity: HF Llama conversion (models/convert_hf.py) against the JAX
``models/convert_hf.py`` and against ``transformers`` itself.

The HF model is an in-process ``transformers.LlamaForCausalLM`` built
from a ``LlamaConfig`` with random weights (never a hub name), as
``tests/test_convert_hf.py`` builds it. Conversions are exact: every
converted leaf equals JAX's bit for bit, and the round trip is the
identity. Logits of the converted model (f32 compute, dense attention)
are held to ``transformers``' at the reference's tolerance, atol 2e-4 +
rtol 1e-3 (summation order through two layers); a bf16 model converts on
the tensors it has (no host hop) and its f32 copy gives the same logits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import (  # noqa: E402
    convert_hf as jconvert,
)
from service_account_auth_improvements_tpu.models import (  # noqa: E402
    llama as jllama,
)
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    convert_hf as tconvert,
    llama as tllama,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    step as tstep,
)

ROPE_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 64}


def _tiny_hf(tie=False, kv_heads=2, rope_scaling=None, dtype=None):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, rope_theta=10_000.0,
        rms_norm_eps=1e-5, max_position_embeddings=128,
        tie_word_embeddings=tie, attention_bias=False, mlp_bias=False,
        rope_scaling=rope_scaling,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    model.eval()
    return model.to(dtype) if dtype is not None else model


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _logits(cfg, params, toks):
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                              remat=False)
    return tllama.apply(cfg, params, torch.tensor(toks, dtype=torch.long))


@pytest.mark.parametrize("form", ["dict", "object", "llama3"])
def test_config_from_hf_matches_jax(form):
    model = _tiny_hf(rope_scaling=ROPE_LLAMA3 if form == "llama3"
                     else None)
    hf_cfg = model.config.to_dict() if form == "dict" else model.config
    got = tconvert.config_from_hf(hf_cfg)
    assert _fields(got) == _fields(jconvert.config_from_hf(hf_cfg))
    assert (got.n_heads, got.n_kv_heads, got.head_dim) == (4, 2, 16)
    assert got.rope_scaling_factor == (8.0 if form == "llama3" else 0.0)


def test_unsupported_rope_scaling_raises():
    cfg = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "rope_scaling": {"rope_type": "linear", "factor": 2.0}}
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        tconvert.config_from_hf(cfg)


@pytest.mark.parametrize("tie,prefix", [(False, True), (True, True),
                                        (False, False)])
def test_params_from_state_dict_match_jax(tie, prefix):
    """One numpy state dict through both converters: every leaf equal
    bit for bit; a tied checkpoint without ``lm_head.weight`` gives a head
    of its own equal to the embedding's transpose; keys without the
    ``model.`` prefix convert the same."""
    model = _tiny_hf(tie=tie)
    cfg = jconvert.config_from_hf(model.config)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not (tie and k == "lm_head.weight")}
    if not prefix:
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    want = jconvert.params_from_hf_state_dict(cfg, sd)
    got = tconvert.params_from_hf_state_dict(tconvert.config_from_hf(
        model.config), sd, device="cpu")
    flat_want = dict(zip(
        ["/".join(str(k.key) for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(want)[0]],
        jax.tree.leaves(want)))
    flat_got = dict(tstep._leaves(got))
    assert sorted(flat_got) == sorted(flat_want)
    for name, t in flat_got.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(flat_want[name]),
                                      err_msg=name)
    if tie:
        assert torch.equal(got["lm_head"], got["tok_embed"].T)
        assert got["lm_head"].data_ptr() != got["tok_embed"].data_ptr()


def test_head_dim_256_converts_like_jax_and_gives_its_first_loss():
    """An HF config whose ``head_dim`` (256) is wider than hidden / heads,
    as checkpoints may give it: both packages read the same config and
    convert the same leaves bit for bit (wq [64, 2·256], wk/wv [64, 256]),
    and the port's first loss through flash attention (the kernels' plain
    versions on the CPU, no launch) equals JAX's (its dense path on the
    CPU) within f32 summation order through two layers (2e-6, the train
    tests' loss tolerance)."""
    _wide_head_dim_converts_like_jax(256)


def test_head_dim_512_converts_like_jax_and_gives_its_first_loss():
    """The same at ``head_dim`` 512, the widest the port's kernels take
    (its split tiles: each consumer warpgroup owns part of the columns):
    wq [64, 2·512], wk/wv [64, 512], the loss within the same 2e-6."""
    _wide_head_dim_converts_like_jax(512)


def _wide_head_dim_converts_like_jax(head_dim):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=head_dim, rope_theta=10_000.0, rms_norm_eps=1e-5,
        max_position_embeddings=128, tie_word_embeddings=False,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    cfg = tconvert.config_from_hf(model.config.to_dict())
    jcfg = jconvert.config_from_hf(model.config.to_dict())
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (2, 1, head_dim)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jparams = jconvert.params_from_hf_state_dict(jcfg, sd)
    params = tconvert.params_from_hf_state_dict(cfg, sd, device="cpu")
    assert tuple(params["layers"]["wq"].shape) == (2, 64, 2 * head_dim)
    assert tuple(params["layers"]["wk"].shape) == (2, 64, head_dim)
    flat_want = dict(zip(
        ["/".join(str(k.key) for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jparams)[0]],
        jax.tree.leaves(jparams)))
    flat_got = dict(tstep._leaves(params))
    assert sorted(flat_got) == sorted(flat_want)
    for name, t in flat_got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(flat_want[name]),
                                      err_msg=name)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    got = tllama.next_token_loss(
        dataclasses.replace(cfg, attn_impl="flash", dtype="float32"), params,
        torch.tensor(toks, dtype=torch.long))
    want = jllama.next_token_loss(
        dataclasses.replace(jcfg, attn_impl="flash", dtype="float32"),
        jparams, jnp.asarray(toks, jnp.int32))
    assert abs(float(got) - float(want)) < 2e-6
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)


def test_leftover_weights_raise_and_inv_freq_is_exempt():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        attention_bias=True, mlp_bias=False, max_position_embeddings=128)
    torch.manual_seed(0)
    biased = transformers.LlamaForCausalLM(hf_cfg)
    cfg = tconvert.config_from_hf(biased.config)
    with pytest.raises(ValueError, match="unconverted weights"):
        tconvert.params_from_hf_state_dict(cfg, biased.state_dict(),
                                           device="cpu")
    model = _tiny_hf()
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    tconvert.params_from_hf_state_dict(cfg, sd, device="cpu")


def test_round_trip_is_the_identity_and_matches_jax_export():
    """params → HF state dict → params, bit for bit and in the param
    dtype (bf16 too); the exported dict equals JAX's export of the same
    tree and owns its storage (no views of the stacked leaves)."""
    model = _tiny_hf()
    cfg, params = tconvert.from_hf(model, device="cpu")
    sd = tconvert.to_hf_state_dict(cfg, params)
    jcfg, jparams = jconvert.from_hf(model)
    jsd = jconvert.to_hf_state_dict(jcfg, jparams)
    assert sorted(sd) == sorted(jsd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)
        assert v.is_contiguous()
        assert v.untyped_storage().nbytes() == v.numel() * v.element_size()
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, param_dtype=dtype)
        p = tconvert.params_from_hf_state_dict(c, model.state_dict(),
                                               device="cpu")
        back = tconvert.params_from_hf_state_dict(
            c, tconvert.to_hf_state_dict(c, p), device="cpu")
        for (n, a), (m, b) in zip(tstep._leaves(p), tstep._leaves(back)):
            assert n == m and a.dtype == b.dtype == tllama.dtype_of(dtype)
            assert torch.equal(a, b), n


def test_export_refuses_moe_and_a_stale_tied_head():
    cfg, params = tconvert.from_hf(_tiny_hf(tie=True), device="cpu")
    tconvert.to_hf_state_dict(cfg, params, tie_word_embeddings=True)
    with pytest.raises(ValueError, match="no MoE layout"):
        tconvert.to_hf_state_dict(
            dataclasses.replace(cfg, moe_experts=4), {})
    untied = dict(params, lm_head=params["lm_head"] * 1.5)
    with pytest.raises(ValueError, match="no longer equals"):
        tconvert.to_hf_state_dict(cfg, untied, tie_word_embeddings=True)


@pytest.mark.parametrize("kind", ["gqa", "mha", "tied", "llama3"])
def test_logit_parity_with_transformers(kind):
    model = _tiny_hf(kv_heads=4 if kind == "mha" else 2,
                     tie=kind == "tied",
                     rope_scaling=ROPE_LLAMA3 if kind == "llama3" else None)
    cfg, params = tconvert.from_hf(model, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17))
    with torch.no_grad():
        want = model(torch.tensor(toks)).logits.numpy()
    got = _logits(cfg, params, toks).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_bf16_model_converts_without_a_host_hop():
    """A bf16 model (whose tensors ``.numpy()`` refuses) converts from its
    own tensors: bf16 params equal its weights bit for bit, f32 params
    hold them exactly, and the logits match the model's f32 copy."""
    model = _tiny_hf(dtype=torch.bfloat16)
    cfg = tconvert.config_from_hf(model.config)
    p16 = tconvert.params_from_hf_state_dict(
        dataclasses.replace(cfg, param_dtype="bfloat16"),
        model.state_dict(), device="cpu")
    assert torch.equal(p16["layers"]["wq"][1],
                       model.model.layers[1].self_attn.q_proj.weight.T)
    cfg, params = tconvert.from_hf(model, device="cpu")
    assert params["lm_head"].dtype == torch.float32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17))
    with torch.no_grad():
        want = model.float()(torch.tensor(toks)).logits.numpy()
    np.testing.assert_allclose(_logits(cfg, params, toks).numpy(), want,
                               atol=2e-4, rtol=1e-3)


def test_converted_params_are_not_the_models_storage():
    """Training the converted tree in place leaves the HF model as it
    was."""
    model = _tiny_hf()
    before = model.model.embed_tokens.weight.detach().clone()
    _, params = tconvert.from_hf(model, device="cpu")
    params["tok_embed"].add_(1.0)
    params["final_norm"].add_(1.0)
    assert torch.equal(model.model.embed_tokens.weight, before)
