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
    _, aux, got = tllama._backbone(port_cfg(cfg),
                                   tparams.from_numpy(tree, cfg, "cpu"),
                                   torch.tensor(tokens, dtype=torch.long),
                                   return_layer_inputs=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # a dense model has no load-balance term, and launches nothing for one
    assert aux is None
    _, aux = tllama.apply(port_cfg(cfg), tparams.from_numpy(tree, cfg, "cpu"),
                          torch.tensor(tokens, dtype=torch.long),
                          return_aux=True)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_moe_and_segment_flash_raise():
    """A MoE config's init gives the reference's leaf names and shapes,
    each matching its ``logical_axes`` entry; segment ids under flash
    attention raise."""
    for name in ("moe_smoke", "moe2_smoke"):
        moe = tllama.PRESETS[name]
        got = tllama.init(moe, torch.Generator().manual_seed(0),
                          device="cpu")
        want = jax.tree.map(lambda a: a.shape,
                            jllama.init(jllama.PRESETS[name],
                                        jax.random.key(0)))
        assert jax.tree.map(lambda t: tuple(t.shape), got) == want
        axes = tllama.logical_axes(moe)
        assert sorted(got["layers"]) == sorted(axes["layers"])
        assert {"router", "moe_gate", "moe_up", "moe_down"} <= set(
            got["layers"]) and "w_gate" not in got["layers"]
        for leaf, t in got["layers"].items():
            assert len(axes["layers"][leaf]) == t.ndim, leaf
        assert sum(t.numel() for t in jax.tree.leaves(got)) == \
            moe.param_count()
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


def _flat(tree):
    """{path: numpy} of a nested dict of tensors or arrays."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{name}/{k}": v for k, v in _flat(node).items()})
        else:
            out[name] = np.asarray(node.detach() if hasattr(node, "detach")
                                   else node, np.float32)
    return out


def _port_loss_and_grads(cfg, tree, tokens, mask=None, **kw):
    params = tparams.from_numpy(tree, cfg, "cpu")
    leaves = [p.requires_grad_(True) for p in _leaf_list(params)]
    loss = tllama.next_token_loss(port_cfg(cfg), params, tokens,
                                  mask=mask, **kw)
    loss.backward()
    assert all(p.grad is not None for p in leaves)
    return float(loss.detach()), _flat(_map_grad(params))


def _leaf_list(tree):
    for node in tree.values():
        if isinstance(node, dict):
            yield from _leaf_list(node)
        else:
            yield node


def _map_grad(tree):
    return {k: (_map_grad(v) if isinstance(v, dict) else v.grad)
            for k, v in tree.items()}


# f32 next-token loss and its gradients against jax.value_and_grad:
# summation order only (the largest leaf-gradient difference seen is ~1e-7
# on gradients of ~1e-2)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [0, 10])   # 23 targets: 23 % 10 != 0
def test_next_token_loss_and_grads_match_jax(masked, chunk):
    cfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                              loss_chunk=chunk)
    tree = jax_params(cfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tokens[1, 5] = cfg.vocab_size + 3   # out-of-range target: clipped
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32) if masked else None
    want, jgrads = jax.value_and_grad(
        lambda p: jllama.next_token_loss(cfg, p, tokens, mask))(
            jax.tree.map(np.asarray, tree))
    got, tgrads = _port_loss_and_grads(
        cfg, tree, torch.tensor(tokens, dtype=torch.long),
        None if mask is None else torch.tensor(mask))
    assert abs(got - float(want)) < 1e-5
    jflat = _flat(jgrads)
    assert sorted(jflat) == sorted(tgrads)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-6, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_moe_next_token_loss_and_grads_match_jax(preset, padded):
    """MoE configs: the loss with ``moe_aux_weight``·aux, its gradients,
    the pure cross-entropy and the aux of ``apply(return_aux=True)``
    against JAX, f32, with and without a right-padding mask (padding then
    routes nowhere). Tolerances as the dense test's."""
    cfg = dataclasses.replace(jllama.PRESETS[preset], dtype="float32")
    tree = jax_params(cfg)
    jtree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = None
    if padded:
        mask = np.ones((2, 24), np.float32)
        mask[0, 17:] = 0
        mask[1, 21:] = 0
    want, jgrads = jax.value_and_grad(
        lambda p: jllama.next_token_loss(cfg, p, tokens, mask))(jtree)
    ttok = torch.tensor(tokens, dtype=torch.long)
    tmask = None if mask is None else torch.tensor(mask)
    got, tgrads = _port_loss_and_grads(cfg, tree, ttok, tmask)
    assert abs(got - float(want)) < 1e-5
    jflat = _flat(jgrads)
    assert sorted(jflat) == sorted(tgrads)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-6, rtol=1e-4,
                                   err_msg=name)
    params = tparams.from_numpy(tree, cfg, "cpu")
    pure = tllama.next_token_loss(port_cfg(cfg), params, ttok, tmask,
                                  include_aux=False)
    jpure = jllama.next_token_loss(cfg, jtree, tokens, mask,
                                   include_aux=False)
    assert abs(float(pure) - float(jpure)) < 1e-5
    assert got > float(pure)  # the aux term is positive
    jlogits, jaux = jllama.apply(cfg, jtree, tokens, return_aux=True,
                                 token_mask=mask)
    tlogits, taux = tllama.apply(port_cfg(cfg), params, ttok,
                                 return_aux=True, token_mask=tmask)
    assert abs(float(taux) - float(jaux)) < 1e-6
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL["float32"], rtol=0)


def test_chunked_loss_equals_unchunked():
    """The chunked loss is the same per-position math (the tail chunk is
    padded with the sequence's own prefix and sliced off)."""
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], dtype="float32")
    params = tllama.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 30),
                           generator=torch.Generator().manual_seed(1))
    whole = tllama.next_token_loss(cfg, params, tokens)
    for c in (7, 29, 64):
        part = tllama.next_token_loss(
            dataclasses.replace(cfg, loss_chunk=c), params, tokens)
        torch.testing.assert_close(part, whole, atol=1e-6, rtol=0)


def test_bf16_loss_matches_jax():
    """bf16 compute: the logits are bf16 operands multiplied in f32 on
    both sides; the loss differs by bf16 rounding in the residual stream
    (largest seen 3e-4 on a loss of ~5.5)."""
    cfg = dataclasses.replace(jllama.PRESETS["smoke"], loss_chunk=16)
    tree = jax_params(cfg)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = float(jllama.next_token_loss(cfg, jax.tree.map(np.asarray, tree),
                                        tokens))
    got = tllama.next_token_loss(port_cfg(cfg),
                                 tparams.from_numpy(tree, cfg, "cpu"),
                                 torch.tensor(tokens, dtype=torch.long))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < 5e-3


@pytest.mark.parametrize("impl", ["dense", "flash", "moe"])
def test_remat_policies_give_the_same_grads(impl):
    """remat "full" (checkpoint per layer), "dots_saveable" (selective
    checkpointing that saves the matmul outputs) and "none" differ only
    in what is saved: loss and gradients agree (recompute is
    deterministic). head_dim 64 so that flash takes the kernels' plain
    versions on the CPU, with their launch counters still at 0. "moe" is
    flash with a top-2 MoE FFN: the recompute routes every token as the
    forward did."""
    base = dataclasses.replace(tllama.PRESETS["tiny"], dtype="float32",
                               head_dim=64, n_heads=2, n_kv_heads=1,
                               attn_impl="dense" if impl == "dense"
                               else "flash", loss_chunk=16)
    if impl == "moe":
        base = dataclasses.replace(base, moe_experts=4, moe_top_k=2,
                                   moe_capacity_factor=0.5)
    params = tllama.init(base, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.randint(0, base.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    results = {}
    for policy, remat in (("full", True), ("dots_saveable", True),
                          ("none", True), ("full", False)):
        cfg = dataclasses.replace(base, remat_policy=policy, remat=remat)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _flat_tensors(params).items()}
        loss = tllama.next_token_loss(cfg, _unflat(leaves), tokens)
        loss.backward()
        results[(policy, remat)] = (float(loss),
                                    {k: v.grad for k, v in leaves.items()})
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)
    ref_loss, ref_grads = results[("none", True)]
    for key, (loss, grads) in results.items():
        assert loss == ref_loss, key
        for name, g in grads.items():
            torch.testing.assert_close(g, ref_grads[name], atol=1e-7,
                                       rtol=1e-6, msg=f"{key} {name}")
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.next_token_loss(
            dataclasses.replace(base, remat_policy="bogus"), params, tokens)


def _flat_tensors(tree, prefix=""):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat_tensors(node, f"{prefix}{name}/"))
        else:
            out[prefix + name] = node
    return out


def _unflat(flat):
    tree = {}
    for path, t in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t
    return tree
