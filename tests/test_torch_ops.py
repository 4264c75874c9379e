"""Port parity: norms, rotary and dense attention against the JAX ops.

Same numpy inputs through both; f32 tolerances are tight (summation
order and transcendental ULPs only), bf16 tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.ops import attention as jattn  # noqa: E402
from service_account_auth_improvements_tpu.ops import norms as jnorms  # noqa: E402
from service_account_auth_improvements_tpu.ops import rotary as jrot  # noqa: E402
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
    norms as tnorms,
    rotary as trot,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.tensor(x).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (2, 5, 64)), _rand(rng, (64,))
    want = jnorms.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = tnorms.rms_norm(_t(x, getattr(torch, dtype)),
                          _t(w, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the cast before the weight multiply is the same rounding on
    # both sides; one bf16 ulp of slack for the f32 statistics' order
    tol = F32_TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("scaling", [None, {
    "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_seq": 64}])
def test_rope_table(scaling):
    jc, js = jrot.rope_table(256, 64, 10_000.0, scaling=scaling)
    tc, ts = trot.rope_table(256, 64, 10_000.0, scaling=scaling)
    # angles up to 255 rad: f32 cos/sin implementations differ by ulps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)


def test_llama3_scale_freqs_bands():
    freqs = 1.0 / (500_000.0 ** (np.arange(0, 64, 2) / 64)).astype(
        np.float32)
    kw = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_seq=8192)
    want = jrot.llama3_scale_freqs(jnp.asarray(freqs), **kw)
    got = trot.llama3_scale_freqs(torch.tensor(freqs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 12, 3, 32))
    jc, js = jrot.rope_table(12, 32, 10_000.0)
    tc, ts = trot.rope_table(12, 32, 10_000.0)
    want = jrot.apply_rope(jnp.asarray(x, dtype), jc, js)
    got = trot.apply_rope(_t(x, getattr(torch, dtype)), tc, ts)
    assert got.dtype == getattr(torch, dtype)
    # bf16: one rounding of an f32 result (<= 1 ulp, 2^-8 relative)
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# b, sq, sk, hq, hkv, d, causal
ATTN_CASES = [
    (2, 16, 16, 4, 2, 8, True),    # GQA causal
    (2, 16, 16, 4, 2, 8, False),   # GQA non-causal
    (1, 12, 12, 4, 4, 8, True),    # MHA
    (2, 5, 13, 6, 3, 8, True),     # end-aligned sk > sq
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_dense_attention_f32(case):
    b, sq, sk, hq, hkv, d, causal = case
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, (b, sq, hq, d)), _rand(rng, (b, sk, hkv, d)),
               _rand(rng, (b, sk, hkv, d)))
    want = jattn._dense_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), d ** -0.5, causal=causal)
    got = tattn._dense_attention(_t(q), _t(k), _t(v), d ** -0.5,
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_dense_attention_bf16():
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, (2, 16, 4, 8)), _rand(rng, (2, 16, 2, 8)),
               _rand(rng, (2, 16, 2, 8)))
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jattn._dense_attention(*args, 8 ** -0.5)
    got = tattn._dense_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                                 8 ** -0.5)
    assert got.dtype == torch.bfloat16
    # bf16 probabilities and PV product: a few bf16 ulps of |v| ~ 3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=4e-2)


def test_dense_attention_segment_ids():
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, (2, 10, 4, 8)), _rand(rng, (2, 10, 2, 8)),
               _rand(rng, (2, 10, 2, 8)))
    seg = np.array([[0] * 4 + [1] * 6, [0] * 7 + [1] * 3], np.int32)
    want = jattn._dense_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 8 ** -0.5,
                                  segment_ids=jnp.asarray(seg))
    got = tattn._dense_attention(_t(q), _t(k), _t(v), 8 ** -0.5,
                                 segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_multi_head_attention_dispatch():
    q = torch.zeros(1, 4, 2, 8)
    seg = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment_ids requires"):
        tattn.multi_head_attention(q, q, q, impl="flash", segment_ids=seg)
    # outside a mesh ring and Ulysses are a sequence split of one: ring's
    # single chunk is dense arithmetic, Ulysses' exchanges the identity
    rng = np.random.default_rng(5)
    qr, kr, vr = (_t(_rand(rng, (1, 6, 4, 8))), _t(_rand(rng, (1, 6, 2, 8))),
                  _t(_rand(rng, (1, 6, 2, 8))))
    dense = tattn.multi_head_attention(qr, kr, vr, impl="dense")
    for impl in ("ring", "ulysses"):
        for causal in (True, False):
            got = tattn.multi_head_attention(qr, kr, vr, impl=impl,
                                             causal=causal)
            want = tattn.multi_head_attention(qr, kr, vr, impl="dense",
                                              causal=causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **F32_TOL)
    with pytest.raises(ValueError, match="segment_ids requires"):
        tattn.multi_head_attention(qr, kr, vr, impl="ring", segment_ids=seg)
    assert dense.shape == qr.shape
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.multi_head_attention(q, q, q, impl="nope")
    out = tattn.multi_head_attention(q, q, q, impl="dense", segment_ids=seg)
    assert out.shape == q.shape
