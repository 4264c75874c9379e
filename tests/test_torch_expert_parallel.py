"""Port parity: expert parallelism (ep) in ``llama._moe_ffn`` on gloo CPU
ranks against the JAX package's ``_moe_ffn``, and the one-process expert
split (``parallel.sharding.expert_share``) against the plain FFN.

Every ep rank routes all tokens over all experts and runs its own range
of them; the partial combines are summed over ep and the routed input
and gates take Megatron's ``f``. Held at f32: the expert choices equal
the reference's ``top_k`` exactly, the output within 1e-5, the aux
within 1e-6, and the gradients of sum(out · cos(out)) + aux within atol
2e-5 + rtol 1e-4 (``tests/test_torch_moe.py``'s). Three sharded train
steps on fsdp 2 x ep 2 (top-1), tp 2 x ep 2 (top-2) and sp 2, each with
a checkpoint restored onto no mesh bit for bit, are
``tests/test_torch_parallel.py``'s ``*-moe*`` cases.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
)
from service_account_auth_improvements_tpu_torch.parallel import (  # noqa: E402
    sharding as tsharding,
)
from tests import torch_parallel_workers as workers  # noqa: E402

OUT_ATOL, AUX_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 2e-5, 1e-4


def _setup(k, seed=0, b=2, s=32):
    jcfg = dataclasses.replace(jllama.PRESETS["moe_smoke"], dtype="float32",
                               moe_top_k=k, moe_group_size=16)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.key(seed))
    lp = {n: np.asarray(params["layers"][n][0], np.float32)
          for n in ("router", "moe_gate", "moe_up", "moe_down")}
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, jcfg.dim)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, 20:] = 0
    return jcfg, tcfg, lp, h, mask


def _jax(jcfg, lp, h, mask):
    def f(h, lp):
        o, aux = jllama._moe_ffn(jcfg, h, lp, mask)
        return jnp.sum(o * jnp.cos(o)) + aux, (o, aux)

    (_, (o, aux)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(h, lp)
    g = min(jcfg.moe_group_size, h.shape[1])
    hg = jnp.asarray(h).reshape(-1, g, jcfg.dim)
    probs = jax.nn.softmax(hg @ lp["router"], axis=-1)
    idx = jax.lax.top_k(probs, jcfg.moe_top_k)[1]
    return (np.asarray(o), float(aux), np.asarray(idx),
            {"h": np.asarray(grads[0]),
             **{n: np.asarray(v) for n, v in grads[1].items()}})


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_over_ep_matches_jax(k, tmp_path):
    """ep 2 on two gloo ranks: each rank's output, aux, expert choices
    and gradients against the reference's unsharded ``_moe_ffn``; the
    router's and the input's gradients whole on every rank, each
    expert's on the rank that runs it."""
    jcfg, tcfg, lp, h, mask = _setup(k)
    torch.save({"lp": {n: torch.tensor(v) for n, v in lp.items()},
                "h": torch.tensor(h), "mask": torch.tensor(mask)},
               tmp_path / "moe-init.pt")
    workers.launch("moe_ep", 2, tmp_path, dataclasses.asdict(tcfg))
    o, aux, idx, grads = _jax(jcfg, lp, h, mask)
    for rank in range(2):
        got = workers.load(tmp_path / f"moe-r{rank}.pt")
        np.testing.assert_array_equal(got["routes"].numpy(), idx)
        np.testing.assert_allclose(got["out"].numpy(), o, atol=OUT_ATOL)
        assert abs(got["aux"] - aux) < AUX_ATOL
        e0, e1 = got["experts"]
        assert (e0, e1) == (2 * rank, 2 * rank + 2)
        for name, g in got["grads"].items():
            want = grads[name][e0:e1] if name.startswith("moe_") \
                else grads[name]
            np.testing.assert_allclose(g.numpy(), want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("n_ep", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_expert_shares_sum_to_the_plain_ffn(n_ep, k):
    """One process computing every ep rank's share (``expert_share``, as
    ``chip_smoke.py`` phase 11 does on one card): the shares' outputs
    sum to the plain FFN's, each share routes as the plain one does and
    reports its aux."""
    _, tcfg, lp, h, mask = _setup(k, seed=1)
    lp = {n: torch.tensor(v) for n, v in lp.items()}
    h, mask = torch.tensor(h), torch.tensor(mask)
    plain_routes = []
    want, want_aux = tllama._moe_ffn(tcfg, h, lp, mask, routes=plain_routes)
    total = torch.zeros_like(want)
    for r in range(n_ep):
        region = tsharding.expert_share(n_ep, r)
        e0, e1 = region.expert_range(tcfg.moe_experts)
        share = {n: (t[e0:e1] if n.startswith("moe_") else t)
                 for n, t in lp.items()}
        routes = []
        out, aux = tllama._moe_ffn(tcfg, h, share, mask, region=region,
                                   routes=routes)
        assert torch.equal(routes[0], plain_routes[0])
        assert float(aux) == float(want_aux)
        total = total + out
    torch.testing.assert_close(total, want, atol=OUT_ATOL, rtol=0)
    with pytest.raises(ValueError, match="do not divide"):
        tsharding.expert_share(3, 0).expert_range(4)
