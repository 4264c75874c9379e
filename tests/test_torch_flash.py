"""Port parity: the flash-attention forward (plain version on the CPU)
against the JAX Pallas kernel in interpret mode.

On a CPU tensor the port runs ``flash_fwd_reference``, the plain version
of its Hopper kernel; the kernel itself runs only on the card
(chip_smoke.py and tests/test_torch_cuda.py). f32 unless a test says
otherwise: tolerances are the reference's own interpret-vs-dense ones
(tests/test_flash.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
}


@pytest.fixture
def counter():
    tfa.launches = 0
    yield
    assert tfa.launches == 0, "no kernel may launch for CPU tensors"


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


def test_grad_required_raises_not_implemented(counter):
    q, k, v = (torch.tensor(a) for a in _qkv(sq=128, sk=128))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K2/K3"):
        tfa.flash_attention(q, k, v, causal=True)
    with torch.inference_mode():
        assert tfa.flash_attention(q.detach(), k, v).shape == q.shape
