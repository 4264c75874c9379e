"""Port parity: flash attention (plain versions on the CPU) against the
JAX Pallas kernels in interpret mode, forward and backward.

On a CPU tensor the port runs ``flash_fwd_reference`` and
``flash_bwd_dq_reference``/``flash_bwd_dkv_reference``, the plain versions
of its Hopper kernels K1, K2 and K3; the kernels themselves run only on
the card (chip_smoke.py and tests/test_torch_cuda.py). f32 unless a test
says otherwise: tolerances are the reference's own interpret-vs-dense
ones (tests/test_flash.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.ops import (  # noqa: E402
    flash_attention as jfa,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
    flash_attention as tfa,
)


def _qkv(b=2, sq=256, sk=256, h=4, hkv=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


# the wide head dims the kernels also take: d 192 and 256 on the unsplit
# tiles, 320 to 512 on the split ones (each consumer warpgroup owns part of
# the output's columns); the plain versions are the same at every d
WIDE_HEAD_DIMS = (192, 256, 320, 384, 448, 512)

# the reference's shapes (tests/test_flash.py)
CASES = {
    "gqa-causal": (dict(), True, 2e-5),
    "gqa-noncausal": (dict(), False, 2e-5),
    "mha": (dict(h=4, hkv=4), True, 2e-5),
    "multiblock-causal": (dict(b=1, sq=384, sk=384, h=2, hkv=1), True, 5e-5),
    "multiblock-noncausal": (dict(b=1, sq=384, sk=384, h=2, hkv=1), False,
                             5e-5),
    "asymmetric-512": (dict(b=1, sq=512, sk=512, h=2, hkv=2), True, 5e-5),
    "unaligned-127": (dict(sq=127, sk=127), True, 5e-4),
    # the wide head dims (d 192 to 512), at the tolerances of the d 64
    # cases of the same kind
    **{f"{name}-d{d}": (dict(shape, b=1, d=d), causal, atol)
       for d in WIDE_HEAD_DIMS
       for name, shape, causal, atol in (
           ("gqa-causal", dict(h=4, hkv=2), True, 2e-5),
           ("unaligned-127", dict(sq=127, sk=127, h=2, hkv=1), True, 5e-4),
           ("noncausal-256", dict(h=2, hkv=1), False, 2e-5))},
}


@pytest.fixture
def counter():
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    yield
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0), \
        "no kernel may launch for CPU tensors"


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax_interpret(name, counter):
    shape, causal, atol = CASES[name]
    q, k, v = _qkv(**shape)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True)
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_lse_matches_jax_kernel(causal, counter):
    q, k, v = _qkv(b=1, sq=256, sk=256, h=4, hkv=2)
    qt, kt, vt = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    jo, jlse = jfa._flash_fwd(jnp.asarray(qt), jnp.asarray(kt),
                              jnp.asarray(vt), causal=causal, interpret=True)
    o, lse = tfa.flash_fwd_reference(torch.tensor(qt), torch.tensor(kt),
                                     torch.tensor(vt), causal)
    assert lse.shape == (1, 4, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)


def test_reference_bf16_casts_p_to_v_dtype(counter):
    """bf16 in, bf16 out, f32 lse; matches the JAX kernel within bf16
    rounding of P and O (a few ulps of |o| <= ~3)."""
    q, k, v = _qkv(b=1, sq=128, sk=128, h=2, hkv=1)
    qt, kt, vt = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (qt, kt, vt)),
                              causal=True, interpret=True)
    o, lse = tfa.flash_fwd_reference(
        *(torch.tensor(a).bfloat16() for a in (qt, kt, vt)), True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-4)


def test_dispatch_rules(monkeypatch, counter):
    """The reference's ``_use_pallas`` rules: shapes the kernel covers go
    through ``flash_fwd`` (here its plain version), the rest to dense."""
    calls = []
    real = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        lambda *a: calls.append(1) or real(*a))

    def routed(shape, causal, dtype=torch.float32):
        calls.clear()
        q, k, v = (torch.tensor(a).to(dtype) for a in _qkv(**shape))
        got = tfa.flash_attention(q, k, v, causal=causal)
        want = tattn._dense_attention(q, k, v, q.shape[-1] ** -0.5,
                                      causal=causal)
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), atol=3e-2)
        return bool(calls)

    assert routed(dict(sq=100, sk=100), True)          # causal: any length
    assert not routed(dict(sq=100, sk=100), False)     # unaligned non-causal
    assert not routed(dict(sq=128, sk=256), True)      # causal sq != sk
    assert routed(dict(sq=128, sk=256), False)         # aligned non-causal
    assert not routed(dict(sq=128, sk=128, d=48), True)  # d % 64 != 0
    assert not routed(dict(sq=128, sk=128), True, torch.float16)
    assert routed(dict(sq=128, sk=128), True, torch.bfloat16)


def test_flash_fwd_raises_like_the_forced_path(counter):
    q, k, v = (torch.tensor(np.swapaxes(a, 1, 2))
               for a in _qkv(sq=128, sk=256))
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_fwd(q, k, v, True)
    q2, k2, v2 = (torch.tensor(np.swapaxes(a, 1, 2))
                  for a in _qkv(sq=100, sk=100))
    with pytest.raises(ValueError, match="block-aligned"):
        tfa.flash_fwd(q2, k2, v2, False)


def test_grads_flow_on_cpu_without_launches(counter):
    """With autograd recording, ``flash_attention`` goes through the
    ``FlashAttention`` Function: the forward equals the no-grad path, the
    gradients of every input exist and are finite, and on CPU tensors
    only the plain versions run (the fixture checks all three counters;
    q/k/v as the model hands them over, [b, s, h, d])."""
    q, k, v = (torch.tensor(a) for a in _qkv(sq=128, sk=128))
    with torch.inference_mode():
        want = tfa.flash_attention(q, k, v, causal=True)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tfa.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is not None
    np.testing.assert_array_equal(o.detach().numpy(), want.numpy())
    o.sum().backward()  # a zero-stride dO, as the gradient of a sum
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape
        assert torch.isfinite(t.grad).all()


def _jax_grads(q, k, v, causal, dtype=jnp.float32):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        o = o.astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o))
    args = tuple(jnp.asarray(a, dtype) for a in (q, k, v))
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, causal, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=causal).float()
    (o * torch.cos(o)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


# the reference's gradient cases (tests/test_flash.py): grads of
# sum(o * cos o); 5e-4 for one block, 1e-3 multi-block, as there
GRAD_CASES = {
    "gqa-causal": (dict(b=1, sq=128, sk=128, h=2, hkv=1), True, False, 5e-4),
    "gqa-noncausal": (dict(sq=256, sk=256), False, False, 5e-4),
    "mha-causal": (dict(b=1, sq=256, sk=256, h=4, hkv=4), True, False, 5e-4),
    "multiblock-causal": (dict(b=1, sq=384, sk=384, h=2, hkv=1), True, True,
                          1e-3),
    "multiblock-noncausal": (dict(b=1, sq=384, sk=384, h=2, hkv=1), False,
                             True, 1e-3),
    "unaligned-127": (dict(sq=127, sk=127), True, False, 5e-4),
    # d 192 to 512 at the tolerances of the d 64 cases of the same kind
    **{f"{name}-d{d}": (dict(shape, d=d), causal, multiblock, atol)
       for d in WIDE_HEAD_DIMS
       for name, shape, causal, multiblock, atol in (
           ("gqa-causal", dict(b=1, sq=128, sk=128, h=2, hkv=1), True,
            False, 5e-4),
           ("unaligned-127", dict(b=1, sq=127, sk=127, h=2, hkv=1), True,
            False, 5e-4),
           ("multiblock-causal", dict(b=1, sq=384, sk=384, h=2, hkv=1),
            True, True, 1e-3))},
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_grads_match_jax_interpret(name, counter, monkeypatch):
    """Grads through the port's Function (plain K1/K2/K3 on the CPU)
    against ``jax.grad`` of the Pallas kernels in interpret mode. The
    multi-block cases force the reference's blocks to 128 (its own
    test's monkeypatch), so its kernels carry state across grid steps;
    the ragged case is padded to 128 by the reference and masked in the
    port."""
    shape, causal, multiblock, atol = GRAD_CASES[name]
    if multiblock:
        monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v = _qkv(**shape)
    want = _jax_grads(q, k, v, causal)
    got = _port_grads(q, k, v, causal)
    for w, g, n in zip(want, got, "qkv"):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"d{n}")


def test_flash_grads_bf16_match_jax_interpret(counter):
    """bf16 q/k/v: both sides round P, dS and the outputs to bf16 at the
    same points; the tolerance is a few bf16 ulps of the gradients
    (|d·| up to ~8, one ulp 2^-5 there) for tile-order differences."""
    q, k, v = _qkv(b=1, sq=128, sk=128, h=2, hkv=1)
    want = _jax_grads(q, k, v, True, jnp.bfloat16)
    got = _port_grads(q, k, v, True, torch.bfloat16)
    for w, g, n in zip(want, got, "qkv"):
        np.testing.assert_allclose(g, w, atol=6e-2, rtol=2e-2,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_reference_matches_jax_flash_bwd(causal, counter, monkeypatch):
    """``flash_bwd_reference`` (the step-by-step recompute the kernels
    implement) against ``_flash_bwd(..., interpret=True)`` on the same
    o/lse/dO, multi-block (blocks forced to 128) with GQA."""
    monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v = (np.swapaxes(a, 1, 2)
               for a in _qkv(b=1, sq=256, sk=256, h=4, hkv=2))
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, interpret=True)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v)), jo, jlse,
                          jnp.asarray(do), causal=causal, interpret=True)
    to, tlse = tfa.flash_fwd_reference(
        *(torch.tensor(a) for a in (q, k, v)), causal)
    got = tfa.flash_bwd_reference(*(torch.tensor(a) for a in (q, k, v)),
                                  to, tlse, torch.tensor(do), causal)
    for w, g, n in zip(want, got, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=f"d{n}")
    # the wrapper takes the plain route on CPU tensors
    again = tfa.flash_bwd(*(torch.tensor(a) for a in (q, k, v)), to, tlse,
                          torch.tensor(do), causal)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_bwd_reference_matches_jax_flash_bwd_wide_head(d, causal, counter,
                                                       monkeypatch):
    """The same at head dims 192 to 512, GQA group 2, two blocks of 128
    per axis, at the d 64 case's tolerance (2e-5)."""
    monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v = (np.swapaxes(a, 1, 2)
               for a in _qkv(b=1, sq=256, sk=256, h=2, hkv=1, d=d))
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, interpret=True)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v)), jo, jlse,
                          jnp.asarray(do), causal=causal, interpret=True)
    to, tlse = tfa.flash_fwd_reference(
        *(torch.tensor(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    got = tfa.flash_bwd(*(torch.tensor(a) for a in (q, k, v)), to, tlse,
                        torch.tensor(do), causal)
    for w, g, n in zip(want, got, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=f"d{n}")


def test_bwd_reference_rounds_like_the_kernels(counter):
    """bf16: K2 forms dS from the f32 P, K3 from P rounded to dO's dtype
    (the reference keeps both); both outputs come back in the inputs'
    dtypes and agree with the JAX kernels within bf16 rounding."""
    q, k, v = (np.swapaxes(a, 1, 2)
               for a in _qkv(b=1, sq=128, sk=128, h=2, hkv=1))
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal=True, interpret=True)
    want = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, causal=True,
                          interpret=True)
    tq, tk, tv, tdo = (torch.tensor(a).bfloat16() for a in (q, k, v, do))
    to, tlse = tfa.flash_fwd_reference(tq, tk, tv, True)
    got = tfa.flash_bwd_reference(tq, tk, tv, to, tlse, tdo, True)
    for w, g, n in zip(want, got, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=6e-2,
                                   rtol=2e-2, err_msg=f"d{n}")
