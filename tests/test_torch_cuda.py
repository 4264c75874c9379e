"""The port's kernels on the card: each against its plain version.

These need a CUDA card and nvcc (the kernels have no CPU mode) and skip
without them. The file imports no JAX, so it runs on a machine without it;
there, skip the suite's conftest (which configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py

chip_smoke.py holds the same kernels at the serving path's full shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b, s, h, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.tensor(rng.standard_normal((b, heads, s, d)),
                     dtype=torch.float32).to("cuda", dtype)
        for heads in (h, hkv, hkv))


# bf16: O is rounded to bf16 on both sides (one ulp is 2^-8 relative);
# f32: summation order only
TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,hkv,d,causal", [
    (300, 4, 2, 128, True),    # ragged causal tail, GQA
    (256, 4, 4, 64, True),     # MHA, d 64
    (256, 4, 1, 128, False),   # non-causal, aligned
])
def test_flash_fwd_kernel_matches_plain(cuda, dtype, s, h, hkv, d, causal):
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(2, s, h, hkv, d, dtype)
    before = fa.launches
    o, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, causal)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_greedy_generate_flash_equals_dense_on_cuda(cuda):
    """A small model with head_dim 128 in f32: per-length prefill through
    the kernel decodes the same greedy ids as dense attention."""
    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=128, dtype="float32", attn_impl="flash")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 77),
                           generator=torch.Generator().manual_seed(1))
    before = fa.launches
    got = generate.generate(cfg, params, prompt, 12)
    assert fa.launches == before + cfg.n_layers
    want = generate.generate(dataclasses.replace(cfg, attn_impl="dense"),
                             params, prompt, 12)
    assert torch.equal(got, want)
