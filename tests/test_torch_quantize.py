"""Port parity: weight-only int8 (models/quantize.py) against the JAX
``quantize`` on the same numpy weights.

``torch.round`` and ``jnp.round`` both round half to even and both sides
divide in f32, so the int8 values must equal the reference's exactly and
the scales bit for bit. The dequantize is the same two f32 operations, so
``llama.apply`` on quantized params agrees with JAX's to f32 summation
order (held to 5e-5, test_torch_generate.py's tolerance) and greedy
generation is token-identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import generate as jgen  # noqa: E402
from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.models import quantize as jq  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    generate as tgen,
    llama as tllama,
    params as tparams,
    quantize as tq,
)

CFG = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                          param_dtype="float32", remat=False)
TCFG = tllama.LlamaConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(CFG, jax.random.key(0)))
    return tree, tparams.from_numpy(tree, TCFG, "cpu")


def _quantized_pair(weights):
    return jq.quantize_params(weights[0]), tq.quantize_params(weights[1])


@pytest.mark.parametrize("shape,seed", [((3, 16, 8), 0), ((64, 256), 1),
                                        ((2, 4, 128, 96), 2)])
def test_values_and_scales_equal_jax(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    # column 0 has absmax 127, so its scale is exactly 1 and 0.5, 1.5 and
    # -2.5 sit on rounding midpoints: half to even on both sides
    w[..., :4, 0] = np.array([0.5, 1.5, -2.5, 127.0], np.float32)
    want = jq.quantize_array(jnp.asarray(w))
    got = tq.quantize_array(torch.from_numpy(w))
    assert got.values.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    assert got.values[..., :4, 0].reshape(-1, 4).tolist()[0] == [0, 2, -2,
                                                                127]


def test_error_bound():
    """Symmetric absmax: |w - dequant(w)| <= scale/2 element-wise."""
    w = torch.randn((3, 16, 8), generator=torch.Generator().manual_seed(0))
    qa = tq.quantize_array(w)
    deq = qa.to(torch.float32)
    assert torch.all((w - deq).abs() <= qa.scale.unsqueeze(-2) / 2 + 1e-7)
    assert qa.values.dtype == torch.int8
    assert tuple(qa.scale.shape) == (3, 8)  # leading axes kept
    assert (qa.shape, qa.ndim, qa.device) == (w.shape, 3, w.device)


def test_quantized_bytes_equal_jax(weights):
    jqp, tqp = _quantized_pair(weights)
    assert tq.quantized_bytes(weights[1]) == jq.quantized_bytes(weights[0])
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tqp) < 0.5 * tq.quantized_bytes(weights[1])


def test_apply_with_quantized_params_matches_jax(weights):
    jqp, tqp = _quantized_pair(weights)
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size,
                                             (2, 16)).astype(np.int32)
    want = np.asarray(jllama.apply(CFG, jqp, jnp.asarray(toks)))
    got = tllama.apply(TCFG, tqp, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)
    # and the int8 shift from the f32 model stays in the reference's
    # weight-only budget (tests/test_quantize.py: 5% of the largest logit)
    full = tllama.apply(TCFG, weights[1], torch.tensor(toks,
                                                       dtype=torch.long))
    denom = max(full.abs().max().item(), 1.0)
    assert (got - full).abs().max().item() / denom < 0.05


def test_greedy_generate_with_int8_equals_jax(weights):
    jqp, tqp = _quantized_pair(weights)
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size,
                                               (2, 7)).astype(np.int32)
    want = np.asarray(jgen.generate(CFG, jqp, jnp.asarray(prompt), 9))
    got = tgen.generate(TCFG, tqp, torch.tensor(prompt, dtype=torch.long),
                        9, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_indexing_and_unbind_slice_scale_with_values():
    w = torch.randn((3, 16, 8), generator=torch.Generator().manual_seed(4))
    qa = tq.quantize_array(w)
    sliced = qa[1]
    assert tuple(sliced.values.shape) == (16, 8)
    assert tuple(sliced.scale.shape) == (8,)
    torch.testing.assert_close(sliced.to(torch.float32),
                               qa.to(torch.float32)[1], rtol=0, atol=0)
    layers = qa.unbind(0)
    assert len(layers) == 3
    for i, layer in enumerate(layers):
        assert torch.equal(layer.values, qa.values[i])
        assert torch.equal(layer.scale, qa.scale[i])
    with pytest.raises(ValueError, match="leading"):
        qa.unbind(1)


@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_quantized_moe_apply_matches_jax(preset):
    """The [L, E, in, out] expert leaves quantize per expert and output
    channel (values and scales equal the reference's), the router stays
    full precision, and ``llama.apply`` on the int8 tree agrees with
    JAX's at test_apply_with_quantized_params_matches_jax's tolerance."""
    cfg = dataclasses.replace(jllama.PRESETS[preset], dtype="float32",
                              param_dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(cfg, jax.random.key(0)))
    jqp = jq.quantize_params(tree)
    tqp = tq.quantize_params(tparams.from_numpy(tree, tcfg, "cpu"))
    assert isinstance(tqp["layers"]["router"], torch.Tensor)
    assert tqp["layers"]["router"].dtype == torch.float32
    for k in ("moe_gate", "moe_up", "moe_down"):
        got, want = tqp["layers"][k], jqp["layers"][k]
        assert isinstance(got, tq.QuantizedTensor), k
        assert tuple(got.scale.shape) == (cfg.n_layers, cfg.moe_experts,
                                          got.shape[-1])
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        assert got.scale.numpy().tobytes() == np.asarray(
            want.scale).tobytes()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    want = np.asarray(jllama.apply(cfg, jqp, jnp.asarray(toks)))
    got = tllama.apply(tcfg, tqp, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)


def test_embedding_norms_stay_full_precision(weights):
    tqp = tq.quantize_params(weights[1])
    for leaf in (tqp["tok_embed"], tqp["final_norm"],
                 tqp["layers"]["attn_norm"], tqp["layers"]["mlp_norm"]):
        assert isinstance(leaf, torch.Tensor)
        assert leaf.dtype == torch.float32
    assert tqp["tok_embed"] is weights[1]["tok_embed"]
    assert isinstance(tqp["lm_head"], tq.QuantizedTensor)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert isinstance(tqp["layers"][k], tq.QuantizedTensor), k
