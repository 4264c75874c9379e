"""Port parity: the mixture-of-experts FFN (``llama._moe_ffn``) against the
JAX ``_moe_ffn`` on the same numpy inputs, at tests/test_moe.py's config.

f32 tolerances: out atol 1e-5 (largest seen 3e-8, summation order only),
aux atol 1e-6 (largest seen 1.2e-7); gradients of ``Σ out·w + aux`` atol
1e-5 + rtol 1e-4. Routing decisions (top-k, capacity claims) are exact on
both sides, so the tolerances hold only if every token picks the same
experts and slots as in the reference. bf16: the reference's rounding
points (the dispatch one-hot and the combine weights cast to bf16 before
their products, the expert products in bf16), out atol 1e-2 on outputs up
to ~0.22 (largest seen 2.9e-3, three bf16 ulps there; the two libraries
accumulate the bf16 products in different orders), aux 1e-6 (the router
is f32 on both sides).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
)

LEAVES = ("router", "moe_gate", "moe_up", "moe_down")
E, D, M = 4, 16, 32


def _cfgs(**kw):
    base = dict(
        vocab_size=64, dim=D, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=8, mlp_dim=M, max_seq_len=64, rope_theta=10_000.0,
        moe_experts=E, dtype="float32", param_dtype="float32",
    )
    base.update(kw)
    return jllama.LlamaConfig(**base), tllama.LlamaConfig(**base)


def _inputs(seed, b=2, s=16, masked=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, D)).astype(np.float32)
    lp = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.5,
          "moe_gate": rng.standard_normal((E, D, M)).astype(np.float32) * .1,
          "moe_up": rng.standard_normal((E, D, M)).astype(np.float32) * 0.1,
          "moe_down": rng.standard_normal((E, M, D)).astype(np.float32) * .1}
    mask = None
    if masked:  # right padding, a different length per row
        mask = np.ones((b, s), np.float32)
        mask[0, s - 5:] = 0
        mask[1, s - 2:] = 0
    return h, lp, mask


def _both(jcfg, tcfg, h, lp, mask, bf16=False):
    """``_moe_ffn`` of both packages on h (in bf16 if asked) and f32
    weights → (JAX out, JAX aux, port out, port aux) as numpy / floats."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jout, jaux = jllama._moe_ffn(
        jcfg, jnp.asarray(h, jdt), {k: jnp.asarray(v) for k, v in lp.items()},
        None if mask is None else jnp.asarray(mask))
    tout, taux = tllama._moe_ffn(
        tcfg, torch.tensor(h).to(tdt),
        {k: torch.tensor(v) for k, v in lp.items()},
        None if mask is None else torch.tensor(mask))
    return (np.asarray(jout, np.float32), float(jaux),
            tout.float().numpy(), float(taux))


# capacity factor 4.0: ample, nothing dropped; 0.5: contended; 0.0625:
# capacity 1. group 8 divides s 16 (two groups per row); 6 does not, so
# the whole row is one group
@pytest.mark.parametrize("group", [8, 6])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("factor", [4.0, 0.5, 0.0625])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_jax(k, factor, masked, group):
    jcfg, tcfg = _cfgs(moe_top_k=k, moe_capacity_factor=factor,
                       moe_group_size=group)
    h, lp, mask = _inputs(k * 10 + group, masked=masked)
    jout, jaux, tout, taux = _both(jcfg, tcfg, h, lp, mask)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    assert abs(taux - jaux) < 1e-6
    if masked:  # padding routes nowhere
        np.testing.assert_array_equal(tout[mask == 0], 0.0)


@pytest.mark.parametrize("k", [1, 2])
def test_tied_router_probabilities_pick_jax_experts(k):
    """A router that is zero in three columns: experts 1 to 3 tie for
    every token (and with an all-zero router all four do).
    ``jax.lax.top_k`` takes the lower index among equals; so must the
    port, or a top-2 token's second expert differs."""
    jcfg, tcfg = _cfgs(moe_top_k=k, moe_capacity_factor=4.0)
    h, lp, _ = _inputs(3, s=8)
    h = np.abs(h)  # expert 0's logit is positive: it ranks first
    one_column = np.zeros((D, E), np.float32)
    one_column[:, 0] = 1.0
    for router in (np.zeros((D, E), np.float32), one_column):
        lp = dict(lp, router=router)
        jout, _, tout, _ = _both(jcfg, tcfg, h, lp, None)
        np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
        # the tie resolved to the lowest indices: expert 0 first (it wins
        # or ties), then expert 1
        probs = torch.softmax(torch.tensor(h) @ torch.tensor(router), -1)
        want = np.zeros_like(tout)
        x = torch.tensor(h)
        for e in range(k):
            w = {n: torch.tensor(v[e]) for n, v in lp.items() if n != "router"}
            act = (torch.nn.functional.silu(x @ w["moe_gate"])
                   * (x @ w["moe_up"]))
            gate = probs[..., e]
            if k > 1:
                gate = gate / probs[..., :k].sum(-1)
            want += (gate[..., None] * (act @ w["moe_down"])).numpy()
        np.testing.assert_allclose(tout, want, atol=1e-5, rtol=0)


def test_claims_past_capacity_contribute_exactly_zero():
    """Capacity 1, every token routed to expert 0: only each group's first
    token reaches it; the rest are exactly 0, as in the reference."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=0.0625)
    assert tcfg.moe_cap(16) == 1
    h = np.ones((1, 16, D), np.float32)
    _, lp, _ = _inputs(4)
    lp["router"] = np.zeros((D, E), np.float32)
    lp["router"][:, 0] = 1.0
    jout, _, tout, _ = _both(jcfg, tcfg, h, lp, None)
    assert np.abs(tout[0, 0]).max() > 0
    np.testing.assert_array_equal(tout[0, 1:], 0.0)
    np.testing.assert_array_equal(jout[0, 1:], 0.0)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("factor", [4.0, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_grads_match_jax(k, factor, masked):
    """Gradients of Σ out·w + aux with respect to h and the four leaves
    against ``jax.grad`` (the router's through the gates and the aux
    term's density proxy; the density carries none)."""
    jcfg, tcfg = _cfgs(moe_top_k=k, moe_capacity_factor=factor)
    h, lp, mask = _inputs(20 + k, masked=masked)
    w = np.random.default_rng(9).standard_normal(h.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(h_, lp_):
        out, aux = jllama._moe_ffn(jcfg, h_, lp_, jmask)
        return jnp.sum(out * w) + aux

    jgh, jglp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), {n: jnp.asarray(v) for n, v in lp.items()})
    th = torch.tensor(h, requires_grad=True)
    tlp = {n: torch.tensor(v, requires_grad=True) for n, v in lp.items()}
    out, aux = tllama._moe_ffn(tcfg, th, tlp,
                               None if mask is None else torch.tensor(mask))
    (out * torch.tensor(w)).sum().add(aux).backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-4, err_msg="h")
    for name in LEAVES:
        np.testing.assert_allclose(tlp[name].grad.numpy(),
                                   np.asarray(jglp[name]), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_bf16_moe_ffn_matches_jax(k):
    jcfg, tcfg = _cfgs(moe_top_k=k, moe_capacity_factor=1.0,
                       dtype="bfloat16")
    h, lp, _ = _inputs(30 + k, s=32)
    jout, jaux, tout, taux = _both(jcfg, tcfg, h, lp, None, bf16=True)
    np.testing.assert_allclose(tout, jout, atol=1e-2, rtol=0)
    # the router runs in f32 from the same bf16 h on both sides
    assert abs(taux - jaux) < 1e-6
