"""The port on the card: each kernel against its plain version, and the
card-only routes (train steps, fit's resume, checkpoints, int8, the MoE
FFN, LoRA, distillation, HF conversion, MNIST and ResNet) against the CPU
route.

These need a CUDA card and nvcc (the kernels have no CPU mode) and skip
without them. The file imports no JAX, so it runs on a machine without it;
there, skip the suite's conftest (which configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py

chip_smoke.py holds the same kernels at the main paths' full shapes.
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

# (b, s, h, hkv, d, causal) for K1, K2 and K3: ragged lengths (the kernels
# mask the tail themselves), GQA groups 1 to 4, d 64 to 512, non-causal
# aligned inputs, and the training paths' shapes
SHAPES = [
    (2, 300, 4, 2, 128, True),     # ragged causal tail, group 2
    (2, 256, 4, 4, 64, True),      # MHA, d 64
    (2, 256, 4, 1, 128, False),    # non-causal, aligned, group 4
    (2, 1, 6, 2, 128, True),       # one row, group 3
    (2, 65, 6, 2, 128, True),
    (2, 127, 8, 2, 128, True),     # group 4
    (2, 129, 8, 8, 64, True),      # MHA, d 64, one row past a tile
    (1, 1000, 12, 4, 128, True),   # the serving prompt length
    (1, 2047, 12, 4, 128, True),
    (8, 2048, 12, 4, 128, True),   # the training shape
    # the wide head dims: ragged, GQA group 3, one row, non-causal, and
    # bench_800m's training shape with h * d kept at 1536 (6 / 2 heads of
    # 256, 8 / 4 of 192)
    (2, 300, 4, 2, 192, True),
    (2, 300, 4, 2, 256, True),
    (2, 129, 6, 2, 192, True),
    (2, 129, 6, 2, 256, True),
    (2, 1, 6, 2, 256, True),
    (2, 256, 4, 1, 256, False),
    (8, 2048, 8, 4, 192, True),
    (8, 2048, 6, 2, 256, True),
    # d 256's K3 blocks of 64 keys and K2 blocks of 128 rows (dkv_onepass,
    # dq_rows8): ragged ends inside and one past a block, GQA group 4,
    # non-causal
    (2, 65, 6, 2, 256, True),
    (2, 127, 6, 2, 256, True),
    (2, 191, 6, 2, 256, True),
    (1, 2047, 6, 2, 256, True),
    (2, 300, 8, 2, 256, True),
    (2, 512, 6, 2, 256, False),
    # K1's blocks of 128 rows over 64-key tiles at d 192 (and 80-key ones
    # at d 256, flash_fwd_rows8): at bench_800m_d192's 8 / 4 heads one
    # row, ragged ends inside and one past a tile, s 2047, non-causal; at
    # d 256 GQA group 4 at the serving prompt length
    (2, 1, 8, 4, 192, True),
    (2, 65, 8, 4, 192, True),
    (2, 127, 8, 4, 192, True),
    (2, 191, 8, 4, 192, True),
    (1, 2047, 8, 4, 192, True),
    (2, 512, 8, 4, 192, False),
    (1, 1000, 8, 2, 256, True),
    # the split kernels' head dims (each consumer warpgroup owns part of
    # the output's columns): ragged (s 1000, 2047, 300, 129), one row, GQA
    # groups 1 to 3, non-causal, and bench_800m's training shape cut into
    # 3 / 1 heads of 512 and 4 / 2 of 384
    (2, 300, 4, 2, 320, True),
    (1, 1000, 4, 2, 320, True),
    (2, 129, 6, 2, 384, True),
    (2, 256, 2, 2, 384, False),
    (1, 2047, 4, 2, 448, True),
    (2, 256, 4, 2, 448, False),
    (2, 300, 3, 1, 512, True),
    (1, 1000, 3, 1, 512, True),
    (1, 2047, 3, 1, 512, True),
    (2, 1, 3, 1, 512, True),
    (2, 256, 4, 1, 512, False),
    (8, 2048, 4, 2, 384, True),
    (8, 2048, 3, 1, 512, True),
    # K3's pairs of blocks at d 384 and 512 (dkv_pair: 64 keys a pair,
    # 64-query stages): one row short of, one past and one short of two
    # 64-key blocks, at phase 12's heads
    (2, 63, 4, 2, 384, True),
    (2, 65, 4, 2, 384, True),
    (2, 127, 4, 2, 384, True),
    (2, 63, 3, 1, 512, True),
    (2, 65, 3, 1, 512, True),
    (2, 127, 3, 1, 512, True),
    # K3's pairs of blocks at d 320 and 448 (dkv_pair, each block 64
    # ceil(d / 128) columns, the second block's last 64 TMA's zeros): one
    # row, one short of, one past and past two 64-key blocks, s 300 at GQA
    # groups 1 to 3, s 2047, non-causal aligned, and KERNEL_ONLY_HEADS' 4 /
    # 2 heads at the training shape (d 320's s 2047 and d 448's s 300 at
    # group 2 and non-causal s 256 are above)
    *((b, s, h, hkv, d, causal) for d in (320, 448)
      for b, s, h, hkv, causal in (
          (2, 1, 3, 1, True), (2, 63, 4, 2, True), (2, 65, 4, 2, True),
          (2, 129, 3, 1, True), (2, 300, 3, 3, True),
          (8, 2048, 4, 2, True))),
    (1, 2047, 4, 2, 320, True),
    (2, 256, 3, 1, 320, False),
    (2, 300, 4, 2, 448, True),
    # K1's pairs of blocks at d 384 (flash_fwd_pair) and K2's at d 512
    # (dq_pair), 128 query rows a pair: one past a pair and one short of
    # two, at phase 12's heads (s 127 is above)
    (2, 129, 4, 2, 384, True),
    (2, 255, 4, 2, 384, True),
    (2, 129, 3, 1, 512, True),
    (2, 255, 3, 1, 512, True),
    # the f32 kernels' tiles one row short of and one past their ends:
    # dq_f32's 64-row blocks and 64-key tiles and dkv_f32's 64-key blocks
    # and 32-row query tiles at d 128 (65 and 127 are above), dq_f32's
    # 32-row blocks and 8-key tiles and dkv_f32's 32-key blocks and 8-row
    # query tiles at d 512. flash_fwd_f32's 64-row blocks and 64-key tiles
    # at d 128 (s 63, 65, 127, 129) and its 32-row blocks and 32-key tiles
    # at d 512 (s 31, 33, 63, 65) are these rows too; its 64-row blocks and
    # tiles at d 192 and 256 one row short of a block (one past: s 65
    # above)
    (2, 31, 6, 2, 128, True),
    (2, 33, 6, 2, 128, True),
    (2, 63, 6, 2, 128, True),
    (2, 129, 6, 2, 128, True),
    (2, 7, 3, 1, 512, True),
    (2, 9, 3, 1, 512, True),
    (2, 31, 3, 1, 512, True),
    (2, 33, 3, 1, 512, True),
    (2, 63, 3, 1, 512, True),
    (2, 65, 3, 1, 512, True),
    (2, 63, 8, 4, 192, True),
    (2, 63, 6, 2, 256, True),
    # d 64's K2 blocks of 128 query rows over 64-key stages and K3 blocks
    # of 128 keys over 64-query stages (dq_rows8, dkv_keys8): one row,
    # ragged ends inside and one past a block, GQA group 4, non-causal
    # aligned, and Llama-3.2-1B's heads at s 2047 and at the fine-tuning
    # shape
    (2, 1, 4, 4, 64, True),
    (2, 65, 4, 4, 64, True),
    (2, 127, 8, 2, 64, True),
    (2, 191, 4, 2, 64, True),
    (2, 300, 8, 2, 64, True),
    (2, 256, 4, 1, 64, False),
    (1, 2047, 32, 8, 64, True),
    (4, 2048, 32, 8, 64, True),
    # d 64's K1 blocks of 128 query rows over 128-key tiles, two blocks a
    # SM (flash_fwd_twin), at Llama-3.2-1B's heads: one row, a ragged end
    # inside a warpgroup's rows, one short of and one past a block
    (2, 1, 32, 8, 64, True),
    (2, 63, 32, 8, 64, True),
    (2, 127, 32, 8, 64, True),
    (2, 129, 32, 8, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv,d,causal", SHAPES)
def test_flash_fwd_kernel_matches_plain(cuda, dtype, b, s, h, hkv, d,
                                        causal):
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(b, s, h, hkv, d, dtype)
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


# K2/K3 vs plain. bf16: dS is rounded to bf16 on both sides from f32 values
# that differ in summation order, and the outputs round to bf16 (one ulp is
# 2^-8 relative); f32: summation order only.
BWD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hkv,d,causal", SHAPES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, b, s, h, hkv, d,
                                       causal):
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(b, s, h, hkv, d, dtype)
    do = _qkv(b, s, h, h, d, dtype, seed=1)[0]
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.flash_bwd_delta(o, do)
    before = (fa.dq_launches, fa.dkv_launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  causal)
    atol, rtol = BWD_TOL[dtype]
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 300, 4, 2, 128),
                                         (8, 2048, 12, 4, 128),
                                         (2, 65, 4, 4, 64),
                                         (2, 300, 8, 2, 64),
                                         (4, 2048, 32, 8, 64),
                                         (2, 129, 32, 8, 64),
                                         (2, 63, 8, 4, 192),
                                         (2, 65, 8, 4, 192),
                                         (1, 2047, 8, 4, 192),
                                         (2, 300, 4, 2, 256),
                                         (2, 300, 8, 2, 256),
                                         (8, 2048, 6, 2, 256),
                                         (2, 300, 3, 1, 512),
                                         (8, 2048, 3, 1, 512),
                                         (8, 2048, 4, 2, 384),
                                         (2, 255, 3, 1, 512),
                                         (2, 255, 4, 2, 384),
                                         (2, 127, 4, 2, 384),
                                         (2, 129, 3, 1, 512),
                                         (2, 65, 4, 2, 320),
                                         (2, 300, 3, 3, 320),
                                         (8, 2048, 4, 2, 320),
                                         (2, 129, 3, 1, 448),
                                         (1, 2047, 4, 2, 448),
                                         (8, 2048, 4, 2, 448)])
def test_flash_bwd_kernel_is_deterministic(cuda, dtype, kernel, b, s, h, hkv,
                                           d):
    """K2 sums over the key tiles and K3 over the group's heads and the
    query tiles inside one block, in a fixed order, with no atomics: two
    launches give the same bits (at d 64 the shipped dq_rows8 and
    dkv_keys8, whose warpgroups share the streamed stages; at d 192
    dq_rows8 on 64-key stages; at d 256
    dq_rows8 and dkv_onepass, whose warpgroups exchange P^T through shared
    memory; at d 320 to 512 dkv_pair, whose two blocks each add the
    other's partial scores to their own, the same two f32 values on both
    (at d 320 and 448 the second block's padding adds exact zeros),
    and so do K1's flash_fwd_pair and K2's dq_pair there, through the one
    exchange of csrc/hopper.cuh (the rows at s 127 and 129: one short of
    and one past a pair's 128 query rows, K2 at d 384 and K1 at d 512);
    in
    f32 dkv_f32's key tiles split over several blocks at the small shapes,
    their parts summed in split order by a second pass). K1 too: each
    block owns its query rows (at d 64 flash_fwd_twin, two blocks a SM;
    in f32 flash_fwd_f32 reduces each row's max and sum over a
    half-warp by shuffles, in a fixed order)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(b, s, h, hkv, d, dtype)
    do = _qkv(b, s, h, h, d, dtype, seed=1)[0]
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_bwd_delta(o, do)
    if kernel == "flash_fwd":
        first, second = (fa.flash_fwd(q, k, v, True) for _ in range(2))
    else:
        fn = getattr(fa, kernel)
        first = fn(q, k, v, do, lse, delta, True)
        second = fn(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    if kernel == "flash_bwd_dq":
        first, second = (first,), (second,)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 384, 448, 512])
def test_k3_pair_reads_and_stores_no_column_past_d(cuda, d):
    """K3's pair of blocks (dkv_pair) on rows padded past d with NaN, in
    every input and output: the second block's tensor maps end at d (at d
    320 and 448 its box reaches 64 columns past, where TMA brings zeros,
    not the padding), and it stores no column past d. dK and dV match the
    plain version; the padding is still NaN."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(2, 129, 4, 2, d, torch.bfloat16)
    do = _qkv(2, 129, 4, 4, d, torch.bfloat16, seed=1)[0]
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_bwd_delta(o, do)

    def padded(t):
        buf = torch.full((*t.shape[:3], d + 64), float("nan"),
                         dtype=t.dtype, device=t.device)
        buf[..., :d] = t
        return buf

    ins = [padded(t)[..., :d] for t in (q, k, v, do)]
    outs = [padded(torch.zeros_like(t)) for t in (k, v)]
    assert ins[0].stride(2) == d + 64
    fa._launch_bwd("flash_bwd_dkv", *ins, lse, delta, None,
                   outs[0][..., :d], outs[1][..., :d], True)
    torch.cuda.synchronize()
    want = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)
    atol, rtol = BWD_TOL[torch.bfloat16]
    for got, w in zip(outs, want):
        assert torch.isnan(got[..., d:]).all()
        torch.testing.assert_close(got[..., :d].float(), w.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_kernels_refuse_a_strided_head_dim(cuda, kernel):
    """A CUDA input whose head dim is not contiguous (the kernels' TMA
    maps and vector loads need it) raises; nothing falls back and nothing
    launches."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    q, k, v = _qkv(2, 128, 4, 2, 128, torch.bfloat16)
    strided = _qkv(2, 128, 4, 2, 256, torch.bfloat16)[0][..., ::2]
    assert strided.shape == q.shape and strided.stride(3) == 2
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    with pytest.raises(ValueError, match="contiguous head dim"):
        if kernel == "flash_fwd":
            fa.flash_fwd(strided, k, v, True)
        else:
            o, lse = fa.flash_fwd(q, k, v, True)
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            delta = fa.flash_bwd_delta(o, q)
            getattr(fa, kernel)(strided, k, v, q, lse, delta, True)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,remat_policy", [
    ("float32", "full"), ("bfloat16", "full"),
    ("float32", "dots_saveable"), ("float32", "none")])
def test_train_steps_flash_equal_dense_on_cuda(cuda, dtype, remat_policy):
    """A small model with head_dim 128: three train steps with flash
    attention (K1 forward, K1 again in the recompute, K2, K3) against
    dense attention from the same init. f32: summation order only; bf16:
    the two paths round P and O at different points, so loss and grad
    norm agree to bf16 noise. Under "dots_saveable" the kernel is
    invisible to the policy and recomputed, as under "full"; "none"
    launches K1 once per layer."""
    from service_account_auth_improvements_tpu_torch.models import llama

    _flash_steps_equal_dense(dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=128, dtype=dtype, attn_impl="flash", loss_chunk=48,
        remat_policy=remat_policy), remat_policy)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_kernels_refuse_a_head_dim_above_256(cuda, kernel):
    """Every multiple of 64 has a kernel in both dtypes, so the one
    refusal left is a head dim that is no multiple of 64: d 600 in f32 and
    in bf16 raises at each kernel's entry, and nothing launches or falls
    back; f32 at d 576 (once refused, naming the per-dim bound of 512)
    runs the streamed f32 kernel, through the public wrapper for K1, once.
    (The name dates from when the bound was 256 in both dtypes.)"""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    def call(q, k, v):
        if kernel == "flash_fwd":
            return fa.flash_fwd(q, k, v, True)
        lse = torch.zeros(q.shape[:3], device="cuda")
        return getattr(fa, kernel)(q, k, v, q, lse, lse, True)

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(1, 128, 2, 1, 600, dtype)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        with pytest.raises(ValueError, match="supports head_dim"):
            call(q, k, v)
        assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    q, k, v = _qkv(1, 128, 2, 1, 576, torch.float32)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    if kernel == "flash_fwd":
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
        want = fa.flash_fwd_reference(q, k, v, True)[0].transpose(1, 2)
        torch.testing.assert_close(out, want, atol=TOL[torch.float32][0],
                                   rtol=TOL[torch.float32][1])
    else:
        call(q, k, v)
    torch.cuda.synchronize()
    after = (fa.launches, fa.dq_launches, fa.dkv_launches)
    which = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").index(kernel)
    assert after == tuple(n + (i == which) for i, n in enumerate(before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [192, 256, 384, 512])
def test_train_steps_flash_equal_dense_wide_head_on_cuda(cuda, head_dim,
                                                         dtype):
    """The same three steps at head dims 192 to 512 (remat "full"):
    K1 twice, K2 and K3 once per layer, flash against dense within the
    d 128 tolerances."""
    from service_account_auth_improvements_tpu_torch.models import llama

    _flash_steps_equal_dense(dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=head_dim, dtype=dtype, attn_impl="flash", loss_chunk=48,
        remat_policy="full"), "full")


@pytest.mark.cuda
def test_greedy_generate_wide_head_flash_equals_dense_on_cuda(cuda):
    """Per-length prefill through K1 at head_dim 256 (f32) decodes the
    same greedy ids as dense attention."""
    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=256, dtype="float32", attn_impl="flash")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 77),
                           generator=torch.Generator().manual_seed(1))
    before = fa.launches
    got = generate.generate(cfg, params, prompt, 12)
    assert fa.launches == before + cfg.n_layers
    want = generate.generate(dataclasses.replace(cfg, attn_impl="dense"),
                             params, prompt, 12)
    assert torch.equal(got, want)


# (b, s, h, hkv, d, causal, dtype) above 512, where K1, K2 and K3 are the
# streamed kernels of csrc/flash_wide.cu (256 output columns a block; bf16:
# the head dim in 64-column chunks, f32: in 32-column ones): one row, ragged
# ends inside and one past their 128-row (bf16 K1, K2) and 64-key (bf16
# K3) blocks, and past f32's 64-row (K1, K2), 64-key (K1) and 32-key (K2,
# K3) ones, the serving prompt length, s 2047, non-causal aligned, GQA
# groups 1 to 2; d 576, 704 and 832 end in a group of 64 columns, d 704
# and 832 are 11 and 13 bf16 chunks; bench_800m_d768's training shape
# (bf16) and its f32 greedy prompt (b 2, s 256). f32's K2 and K3 run a row
# tile on a cluster of ceil(d / 256) blocks up to d 2048 (3 at d 576 to
# 768, 4 at d 832, the last block 64 columns wide, and 1024, 8 at d 2048),
# the column groups past it (d 2112): the rows after the first f32 ones
# hold the clusters at each size and the groups past them. The f32 K1
# runs on a cluster of the same size too (64 query rows, 32-key tiles),
# and so does the bf16 K3 (64 keys, 32-query stages) where its last block
# holds at least 192 columns (d 704, 768, 1024, 2048; the column groups at
# d 576, 640, 832 and past d 2048): the last rows hold both at ragged ends
# one short of and one past those tiles, and bf16's K3 as column groups at
# d 576 and 2112. Clusters of 5, 6 and 7 blocks: d 1280 (the last block
# full) and 1728 (the last block 192 columns) in both dtypes, 1536 in bf16
WIDE_SHAPES = [
    (2, 1, 2, 1, 576, True, "bfloat16"),
    (2, 65, 4, 2, 576, True, "bfloat16"),
    (2, 300, 4, 2, 640, True, "bfloat16"),
    (2, 256, 2, 1, 704, False, "bfloat16"),
    (2, 129, 2, 1, 768, True, "bfloat16"),
    (1, 1000, 2, 1, 768, True, "bfloat16"),
    (1, 2047, 2, 1, 768, True, "bfloat16"),
    (2, 512, 2, 1, 768, False, "bfloat16"),
    (2, 127, 2, 1, 832, True, "bfloat16"),
    (2, 65, 2, 1, 1024, True, "bfloat16"),
    (1, 300, 1, 1, 2048, True, "bfloat16"),
    (8, 2048, 2, 1, 768, True, "bfloat16"),
    (2, 1, 2, 1, 576, True, "float32"),
    (2, 33, 4, 2, 576, True, "float32"),
    (2, 65, 2, 1, 640, True, "float32"),
    (2, 256, 2, 1, 704, False, "float32"),
    (2, 256, 2, 1, 768, True, "float32"),
    (1, 1000, 2, 1, 768, True, "float32"),
    (1, 2047, 2, 1, 768, True, "float32"),
    (2, 129, 2, 1, 832, True, "float32"),
    (2, 97, 2, 1, 1024, True, "float32"),
    (1, 300, 1, 1, 2048, True, "float32"),
    (2, 191, 4, 2, 576, True, "float32"),
    (2, 300, 2, 1, 640, True, "float32"),
    (2, 512, 2, 1, 768, False, "float32"),
    (2, 65, 2, 1, 832, True, "float32"),
    (1, 1000, 2, 1, 832, True, "float32"),
    (2, 300, 2, 1, 1024, True, "float32"),
    (1, 1000, 1, 1, 2048, True, "float32"),
    (2, 65, 1, 1, 2112, True, "float32"),
    (2, 95, 4, 2, 576, True, "bfloat16"),
    (2, 97, 2, 1, 704, True, "bfloat16"),
    (2, 33, 2, 1, 768, True, "bfloat16"),
    (1, 191, 1, 1, 2048, True, "bfloat16"),
    (2, 65, 1, 1, 2112, True, "bfloat16"),
    (2, 63, 4, 2, 576, True, "float32"),
    (2, 31, 2, 1, 768, True, "float32"),
    (2, 97, 1, 1, 2048, True, "float32"),
    (2, 129, 2, 1, 1280, True, "bfloat16"),
    (2, 300, 2, 1, 1280, True, "float32"),
    (2, 256, 2, 1, 1536, False, "bfloat16"),
    (2, 300, 2, 1, 1728, True, "bfloat16"),
    (2, 65, 2, 1, 1728, True, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,causal,dtype", WIDE_SHAPES)
def test_streamed_kernels_match_plain(cuda, b, s, h, hkv, d, causal, dtype):
    """K1 (O and LSE), K2 and K3 above 512 against their plain versions,
    at the d <= 512 kernels' tolerances of the dtype (f32: summation order
    only), each launched once and counted."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = getattr(torch, dtype)
    q, k, v = _qkv(b, s, h, hkv, d, dtype)
    do = _qkv(b, s, h, h, d, dtype, seed=1)[0]
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.flash_bwd_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), want_o.float(),
                               atol=TOL[dtype][0], rtol=TOL[dtype][1])
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    atol, rtol = BWD_TOL[dtype]
    want = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        torch.testing.assert_close(got.float(), w.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("b,s,h,hkv,d,dtype", [
    (2, 300, 4, 2, 576, "bfloat16"), (2, 127, 2, 1, 832, "bfloat16"),
    (8, 2048, 2, 1, 768, "bfloat16"), (2, 300, 4, 2, 576, "float32"),
    (2, 127, 2, 1, 832, "float32"), (2, 1000, 2, 1, 768, "float32"),
    (2, 1000, 2, 1, 1024, "float32"), (1, 1000, 1, 1, 2048, "float32"),
    (2, 65, 1, 1, 2112, "float32"), (1, 1000, 1, 1, 2048, "bfloat16"),
    (2, 65, 1, 1, 2112, "bfloat16"), (2, 300, 2, 1, 1280, "bfloat16"),
    (2, 300, 2, 1, 1280, "float32"), (2, 300, 2, 1, 1728, "bfloat16"),
    (2, 300, 2, 1, 1728, "float32")])
def test_streamed_kernels_are_deterministic(cuda, kernel, b, s, h, hkv, d,
                                            dtype):
    """Each output element of the streamed kernels belongs to one block
    and every sum runs in a fixed order (the column groups form the same
    scores in the same chunk order; f32's K1, K2 and K3 and bf16's K3 on a
    cluster add the blocks' partial scores in rank order, each sum formed
    once): two launches give the same bits, in bf16 and in f32."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = getattr(torch, dtype)
    q, k, v = _qkv(b, s, h, hkv, d, dtype)
    do = _qkv(b, s, h, h, d, dtype, seed=1)[0]
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_bwd_delta(o, do)
    if kernel == "flash_fwd":
        first, second = (fa.flash_fwd(q, k, v, True) for _ in range(2))
    else:
        fn = getattr(fa, kernel)
        first, second = (fn(q, k, v, do, lse, delta, True)
                         for _ in range(2))
        if kernel == "flash_bwd_dq":
            first, second = (first,), (second,)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("head_dim", [576, 768])
def test_train_steps_flash_equal_dense_above_512_on_cuda(cuda, head_dim,
                                                         dtype):
    """Three steps at 2 / 1 heads of 576 and of 768 (bench_800m_d768's
    heads; remat "full"), in bf16 and f32: K1 twice, K2 and K3 once per
    layer on the streamed kernels, flash against dense within the
    tolerances of the d <= 512 steps."""
    from service_account_auth_improvements_tpu_torch.models import llama

    _flash_steps_equal_dense(dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=head_dim, dtype=dtype, attn_impl="flash",
        loss_chunk=48, remat_policy="full"), "full")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,remat_policy", [
    ("float32", "full"), ("bfloat16", "full"),
    ("float32", "dots_saveable"), ("float32", "none")])
def test_moe_train_steps_flash_equal_dense_on_cuda(cuda, dtype,
                                                   remat_policy):
    """The same three steps with a 4-expert top-2 FFN at capacity factor
    1.25 (claims overflow): the routing recomputed under remat is the
    forward's, and flash against dense within the same tolerances."""
    _flash_steps_equal_dense(dataclasses.replace(
        _small_flash_cfg(dtype), remat_policy=remat_policy, moe_experts=4,
        moe_top_k=2), remat_policy)


def _flash_steps_equal_dense(cfg, remat_policy):
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import step

    dtype = cfg.dtype
    tokens = torch.randint(0, cfg.vocab_size, (2, 100),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")
    mask = torch.ones_like(tokens)
    metrics = {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        state = step.init_train_state(
            c, torch.Generator(device="cuda").manual_seed(0))
        fn = step.make_train_step(c)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        losses = []
        for _ in range(3):
            state, m = fn(state, tokens, mask)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        after = (fa.launches, fa.dq_launches, fa.dkv_launches)
        per_step = [(a - b) // 3 for a, b in zip(after, before)]
        if impl == "flash":
            # forward (+ recompute unless "none") per layer, K2, K3
            k1 = c.n_layers * (1 if remat_policy == "none" else 2)
            assert per_step == [k1, c.n_layers, c.n_layers]
        else:
            assert per_step == [0, 0, 0]
        metrics[impl] = losses
    tol = 1e-4 if dtype == "float32" else 3e-2
    for (lf, gf), (ld, gd) in zip(metrics["flash"], metrics["dense"]):
        assert abs(lf - ld) <= tol * max(1.0, abs(ld))
        assert abs(gf - gd) <= tol * max(1.0, abs(gd))
    assert metrics["flash"][-1][0] < metrics["flash"][0][0]


def _small_flash_cfg(dtype="bfloat16"):
    from service_account_auth_improvements_tpu_torch.models import llama

    return dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=2, n_kv_heads=1,
        head_dim=128, dtype=dtype, attn_impl="flash", loss_chunk=48)


@pytest.mark.cuda
def test_fit_resume_equals_uninterrupted_on_cuda(cuda, tmp_path):
    """A small flash config on the card: 4 steps straight against 2 into
    a workdir and a resumed fit of 4. K2 and K3 are deterministic and the
    batches pure in the step, so every param and moment is bit-equal."""
    from service_account_auth_improvements_tpu_torch.train import (
        loop,
        step,
    )
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )

    cfg = _small_flash_cfg()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 2 * 100 * 8).astype(np.int32)
    data = DataConfig(batch=2, seq=100)

    def fit(steps, workdir=None):
        logs = []
        state, _ = loop.fit(cfg, None, tokens, data,
                            loop.LoopConfig(steps=steps, log_every=1,
                                            workdir=workdir),
                            log=logs.append)
        return state, logs

    straight, _ = fit(4)
    fit(2, str(tmp_path))
    resumed, logs = fit(4, str(tmp_path))
    assert any(line.startswith("resumed from step 2") for line in logs)
    for tree in ("params", "mu", "nu"):
        a = (straight.params if tree == "params"
             else getattr(straight.opt_state, tree))
        b = (resumed.params if tree == "params"
             else getattr(resumed.opt_state, tree))
        for (name, x), (_, y) in zip(step._leaves(a), step._leaves(b)):
            assert torch.equal(x, y), (tree, name)


@pytest.mark.cuda
def test_checkpoint_from_cuda_loads_to_cpu_and_cuda(cuda, tmp_path):
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        step,
    )

    cfg = _small_flash_cfg()
    opt = step.make_optimizer(mu_dtype="bfloat16")
    state = step.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), opt)
    checkpoint.save(tmp_path, state._replace(step=3))
    for dev in ("cpu", "cuda"):
        params = checkpoint.restore_params(tmp_path, None, cfg, device=dev)
        for (name, a), (_, b) in zip(step._leaves(params),
                                     step._leaves(state.params)):
            assert a.device.type == dev and torch.equal(a.cpu(), b.cpu())
        like = step.init_train_state(cfg, torch.Generator().manual_seed(1),
                                     opt, device=dev)
        got = checkpoint.restore(tmp_path, None, cfg, like)
        assert got.step == 3
        assert got.opt_state.mu["lm_head"].dtype == torch.bfloat16
        assert got.opt_state.mu["lm_head"].device.type == dev


@pytest.mark.cuda
def test_quantized_tensor_dequantizes_on_cuda_within_bound(cuda):
    from service_account_auth_improvements_tpu_torch.models import quantize

    w = torch.randn((3, 256, 384), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    qa = quantize.quantize_array(w)
    assert qa.device.type == "cuda" and qa.values.dtype == torch.int8
    err = (w - qa.to(torch.float32)).abs()
    assert torch.all(err <= qa.scale.unsqueeze(-2) / 2 + 1e-7)
    cpu = quantize.quantize_array(w.cpu())
    assert torch.equal(cpu.values, qa.values.cpu())
    assert torch.equal(cpu.scale, qa.scale.cpu())


@pytest.mark.cuda
def test_greedy_speculative_equals_plain_greedy_on_cuda(cuda):
    """f32, a flash target (K1 in both prefills) and a smaller draft:
    speculative greedy ids equal plain greedy ids; self-draft accepts
    every proposal."""
    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        speculative,
    )

    cfg = _small_flash_cfg("float32")
    dcfg = dataclasses.replace(cfg, n_layers=2)
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    dparams = llama.init(dcfg,
                         torch.Generator(device="cuda").manual_seed(1))
    prompt = torch.randint(0, cfg.vocab_size, (1, 70), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    want = generate.generate(cfg, params, prompt, 24)
    got, stats = speculative.spec_generate(cfg, params, dcfg, dparams,
                                           prompt, 24, gamma=3)
    assert torch.equal(got, want) and stats["proposed"] > 0
    got, stats = speculative.spec_generate(cfg, params, cfg, params,
                                           prompt, 24, gamma=4)
    assert torch.equal(got, want) and stats["acceptance_rate"] == 1.0


def _moe_inputs(dtype, device, b=2, s=256, d=256, e=4, m=512, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape, std=1.0):
        return torch.tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32).to(device, dtype)
    h = mk(b, s, d)
    lp = {"router": mk(d, e, std=0.1), "moe_gate": mk(e, d, m, std=0.05),
          "moe_up": mk(e, d, m, std=0.05), "moe_down": mk(e, m, d, std=0.05)}
    return h, lp


def _moe_cfg(**kw):
    from service_account_auth_improvements_tpu_torch.models import llama

    return dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, mlp_dim=512, moe_experts=4,
        moe_group_size=128, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,factor", [(1, 4.0), (2, 4.0), (1, 1.25),
                                          (2, 1.25)])
def test_moe_ffn_on_cuda_matches_cpu(cuda, top_k, factor):
    """f32: the card's routing equals the CPU's, and out is within 1e-5
    and aux within 1e-6, with ample capacity (factor 4) and with
    overflow (factor 1.25). The seeded input has no router near-tie (each
    of its top-k choices beats the next by more than 1e-6, asserted), so
    another summation order cannot swap a choice or a capacity claim."""
    from service_account_auth_improvements_tpu_torch.models import llama

    cfg = _moe_cfg(moe_top_k=top_k, moe_capacity_factor=factor,
                   dtype="float32")
    h, lp = _moe_inputs(torch.float32, "cuda")
    got, aux = llama._moe_ffn(cfg, h, lp)
    hc = h.cpu()
    lpc = {k: v.cpu() for k, v in lp.items()}
    want, want_aux = llama._moe_ffn(cfg, hc, lpc)

    def route(x, r):
        probs = torch.softmax(x.float() @ r.float(), -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gaps = top.values[..., :top_k] - top.values[..., 1:top_k + 1]
        return top.indices[..., :top_k].cpu(), gaps.min(-1).values.cpu()

    idx, margin = route(h, lp["router"])
    want_idx, want_margin = route(hc, lpc["router"])
    assert bool((want_margin > 1e-6).all() and (margin > 1e-6).all())
    assert torch.equal(idx, want_idx)
    assert abs(float(aux) - float(want_aux)) < 1e-6
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_bf16_is_deterministic_on_cuda(cuda, top_k):
    """bf16 forward and backward twice on one input: the same bits (the
    one-hot products have no atomics), which a bitwise resume needs."""
    from service_account_auth_improvements_tpu_torch.models import llama

    cfg = _moe_cfg(moe_top_k=top_k, dtype="bfloat16")
    h, lp = _moe_inputs(torch.bfloat16, "cuda")
    lp = {k: v.float() for k, v in lp.items()}
    w = torch.randn(h.shape, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator(device="cuda").manual_seed(3))
    runs = []
    for _ in range(2):
        hh = h.detach().clone().requires_grad_(True)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in lp.items()}
        out, aux = llama._moe_ffn(cfg, hh, leaves)
        (out.float() * w.float()).sum().add(aux).backward()
        runs.append([out, aux, hh.grad] + [leaves[k].grad
                                           for k in sorted(leaves)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["moe_smoke", "moe2_smoke"])
def test_moe_greedy_cached_decode_equals_naive_on_cuda(cuda, preset):
    """f32 at the CI presets on the card: the KV-cached greedy decode
    (dropless routing per window) gives the ids of re-running the whole
    sequence through ``llama.apply`` every token."""
    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
    )

    cfg = dataclasses.replace(llama.PRESETS[preset], dtype="float32")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 7), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    got = generate.generate(cfg, params, prompt, 12)
    icfg = generate._inference_cfg(cfg)
    naive = prompt
    with torch.inference_mode():
        for _ in range(12):
            nxt = llama.apply(icfg, params, naive)[:, -1].argmax(-1)
            naive = torch.cat([naive, nxt[:, None]], dim=1)
    assert torch.equal(got, naive)


# fine-tuning and side models: the card's route against the CPU route on
# one input. f32 compute differs by summation order only (TF32 off): 1e-4
# relative on losses, and after the steps each leaf within 1e-4 of its
# largest element but for at most one element in a hundred. Adam divides
# by sqrt(nu) + eps, so a gradient element within rounding noise of zero
# (a cancellation, |g| near eps) has an ill-conditioned update that can
# land anywhere within ±lr: every element is held within a fifth of the
# steps' summed learning rates (seen on an NVIDIA H100 80GB HBM3 at
# 700.00 W: 0.11% of a LoRA B leaf outside 1e-4, and the student's
# largest difference 1.5e-5, 0.05 lr, after one step at lr 3e-4). bf16
# (the vision models compute in bf16): cuDNN and the CPU round their
# convolution and matmul sums to bf16 at different points, and batch
# norm's batch statistics carry it: stated per test.
def _lora_cfg(head_dim):
    from service_account_auth_improvements_tpu_torch.models import llama

    return dataclasses.replace(
        llama.PRESETS["smoke"], dim=256, n_heads=4, n_kv_heads=1,
        head_dim=head_dim, dtype="float32", attn_impl="flash",
        loss_chunk=48)


def _to(tree, device):
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        tree_map,
    )

    # a copy: a step updates its state in place
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _close_leaves(a, b, rel, loose, what):
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
    )

    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        err = (x - y).abs()
        bound = rel * max(float(y.abs().max()), 1e-30)
        assert float((err > bound).float().mean()) <= 1e-2, (what, name)
        assert float(err.max()) <= loose, (what, name)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
def test_lora_steps_on_cuda_match_cpu(cuda, head_dim):
    """Two LoRA steps (GQA group 4, flash) on the card against the CPU
    route from the same base and adapters: K1 2·L, K2 L, K3 L per step,
    the base untouched, losses and adapters within the f32 tolerances."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import lora
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
    )

    cfg = _lora_cfg(head_dim)
    lcfg = lora.LoraConfig()
    base = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        b = _to(base, dev)
        copy = {n: t.clone() for n, t in leaves(b)}
        state = lora.init_lora_state(cfg, lcfg,
                                     torch.Generator().manual_seed(2),
                                     device="cpu")
        state = state._replace(params=_to(state.params, dev),
                               opt_state=state.opt_state._replace(
                                   mu=_to(state.opt_state.mu, dev),
                                   nu=_to(state.opt_state.nu, dev)))
        step = lora.make_lora_train_step(cfg, lcfg)
        toks = tokens.to(dev)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        losses = []
        for _ in range(2):
            state, m = step(state, b, toks, torch.ones_like(toks))
            losses.append(float(m["loss"]))
        after = (fa.launches, fa.dq_launches, fa.dkv_launches)
        if dev == "cuda":
            L = cfg.n_layers
            assert [(x - y) // 2 for x, y in zip(after, before)] == [
                2 * L, L, L]
        assert all(torch.equal(t, copy[n]) for n, t in leaves(b))
        out[dev] = (losses, state.params)
    for lc, lg in zip(out["cpu"][0], out["cuda"][0]):
        assert abs(lc - lg) <= 1e-4 * abs(lc)
    _close_leaves(out["cuda"][1], out["cpu"][1], 1e-4, 0.2 * 2 * 3e-4,
                  "adapters")


@pytest.mark.cuda
def test_distill_on_cuda_matches_cpu(cuda):
    """``distill_loss`` and one ``make_distill_step`` step with a d 128
    teacher and a d 64 student (flash, f32) on the card against the CPU:
    the teacher runs once (K1 = 2·L_s + L_t, K2 = K3 = L_s), metrics
    within 1e-4 relative."""
    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        distill,
        step,
    )

    cfg_t, cfg_s = _lora_cfg(128), dataclasses.replace(_lora_cfg(64),
                                                       n_layers=2)
    teacher = llama.init(cfg_t, torch.Generator().manual_seed(0),
                         device="cpu")
    student = step.init_train_state(cfg_s, torch.Generator().manual_seed(1),
                                    device="cpu")
    tokens = torch.randint(0, cfg_s.vocab_size, (2, 100),
                           generator=torch.Generator().manual_seed(2))
    mask = torch.ones_like(tokens)
    mask[1, 80:] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        t, m = _to(teacher, dev), mask.to(dev)
        s = step.TrainState(0, _to(student.params, dev),
                            step.AdamState(0, _to(student.opt_state.mu, dev),
                                           _to(student.opt_state.nu, dev)))
        with torch.no_grad():
            _, metrics = distill.distill_loss(cfg_s, cfg_t, s.params, t,
                                              tokens.to(dev), m)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        s, sm = distill.make_distill_step(cfg_s, cfg_t)(s, t, tokens.to(dev),
                                                        m)
        after = (fa.launches, fa.dq_launches, fa.dkv_launches)
        if dev == "cuda":
            assert [x - y for x, y in zip(after, before)] == [
                2 * cfg_s.n_layers + cfg_t.n_layers, cfg_s.n_layers,
                cfg_s.n_layers]
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: float(v) for k, v in sm.items()}, s.params)
    for i in (0, 1):
        for k, v in out["cpu"][i].items():
            assert abs(out["cuda"][i][k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    _close_leaves(out["cuda"][2], out["cpu"][2], 1e-4, 0.2 * 3e-4,
                  "student")


def _hf_state_dict(n_layers, dim, heads, kv_heads, head_dim, mlp, vocab,
                   tied, dtype, device, seed=0):
    """An HF Llama state dict drawn from a seed (torch Linear [out, in])."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02
                ).to(dtype)

    sd = {"model.embed_tokens.weight": w(vocab, dim),
          "model.norm.weight": w(dim)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w(dim),
            p + "self_attn.q_proj.weight": w(heads * head_dim, dim),
            p + "self_attn.k_proj.weight": w(kv_heads * head_dim, dim),
            p + "self_attn.v_proj.weight": w(kv_heads * head_dim, dim),
            p + "self_attn.o_proj.weight": w(dim, heads * head_dim),
            p + "post_attention_layernorm.weight": w(dim),
            p + "mlp.gate_proj.weight": w(mlp, dim),
            p + "mlp.up_proj.weight": w(mlp, dim),
            p + "mlp.down_proj.weight": w(dim, mlp),
        })
    if not tied:
        sd["lm_head.weight"] = w(vocab, dim)
    return sd


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_hf_conversion_on_cuda_equals_cpu(cuda, tied, param_dtype):
    """A bf16 HF state dict on the card converts on the card: every leaf
    equals the CPU conversion of the same tensors bit for bit, the round
    trip is the identity, and the converted model's f32 logits match the
    CPU's."""
    from service_account_auth_improvements_tpu_torch.models import (
        convert_hf,
        llama,
    )
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
    )

    hf = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 1, "head_dim": 64, "rope_theta": 500000.0,
          "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
          "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                           "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                           "original_max_position_embeddings": 8192}}
    cfg = dataclasses.replace(convert_hf.config_from_hf(hf),
                              param_dtype=param_dtype, dtype="float32",
                              attn_impl="flash")
    sd = _hf_state_dict(2, 256, 4, 1, 64, 512, 512, tied, torch.bfloat16,
                        "cuda")
    got = convert_hf.params_from_hf_state_dict(cfg, sd)
    want = convert_hf.params_from_hf_state_dict(
        cfg, {k: v.cpu() for k, v in sd.items()}, device="cpu")
    for (n, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.device.type == "cuda" and a.dtype == llama.dtype_of(
            param_dtype)
        assert torch.equal(a.cpu(), b), n
    back = convert_hf.params_from_hf_state_dict(
        cfg, convert_hf.to_hf_state_dict(cfg, got, tie_word_embeddings=tied))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(got),
                                                          leaves(back)))
    toks = torch.randint(0, 512, (2, 128),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lg = llama.apply(cfg, got, toks.cuda()).cpu()
        lc = llama.apply(cfg, want, toks)
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_mnist_on_cuda_matches_cpu(cuda):
    """The bf16 MLP on the card (cuBLAS) against the CPU: logits within
    one bf16 rounding of the hidden layer (atol 3e-2 on logits of ~10),
    three SGD steps' losses within 1e-2, the loss falling."""
    from service_account_auth_improvements_tpu_torch.models import mnist

    cfg = mnist.MnistConfig()
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 512)
    x = (rng.normal(size=(10, 784)) * 2.0)[labels] + rng.normal(
        size=(512, 784)) * 0.5
    x, labels = torch.tensor(x, dtype=torch.float32), torch.tensor(labels)
    params = mnist.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        xd, ld = x.to(dev), labels.to(dev)
        logits = mnist.apply(cfg, p, xd).cpu()
        step = mnist.make_sgd_step(cfg, lr=0.1)
        losses = []
        for _ in range(3):
            p, loss = step(p, xd, ld)
            losses.append(float(loss))
        out[dev] = logits, losses
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=3e-2,
                               rtol=0)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert abs(a - b) <= 1e-2
    assert out["cuda"][1][-1] < out["cuda"][1][0]


@pytest.mark.cuda
def test_resnet18_smoke_bf16_on_cuda_matches_cpu(cuda):
    """resnet18-smoke in bf16 (cuDNN convolutions in channels_last, the
    hand-written batch norm) on the card against the CPU, on a 32×32
    batch (asymmetric SAME padding): eval logits within atol 5e-2 of
    logits of ~3, train-mode logits and running stats within 5e-2,
    three momentum steps' losses within 5e-2 and falling."""
    from service_account_auth_improvements_tpu_torch.models import resnet
    from service_account_auth_improvements_tpu_torch.utils.tree import (
        leaves,
        tree_map,
    )

    cfg = resnet.PRESETS["resnet18-smoke"]
    params, stats = resnet.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params["head"]["w"] = torch.randn(
        params["head"]["w"].shape,
        generator=torch.Generator().manual_seed(1)) * 0.3
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(16, 32, 32, 3)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 10, 16))
    out = {}
    for dev in ("cpu", "cuda"):
        p, s = _to(params, dev), _to(stats, dev)
        xd, ld = x.to(dev), labels.to(dev)
        eval_logits, _ = resnet.apply(cfg, p, s, xd, train=False)
        train_logits, new_stats = resnet.apply(cfg, p, s, xd, train=True)
        m = tree_map(torch.zeros_like, p)
        step = resnet.make_train_step(cfg, lr=0.1)
        losses = []
        for _ in range(3):
            p, s, m, loss = step(p, s, m, xd, ld)
            losses.append(float(loss))
        out[dev] = (eval_logits.cpu(), train_logits.cpu(),
                    _to(new_stats, "cpu"), losses)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=5e-2,
                               rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=5e-2,
                               rtol=0)
    for (n, a), (_, b) in zip(leaves(out["cuda"][2]), leaves(out["cpu"][2])):
        torch.testing.assert_close(a, b, atol=5e-2, rtol=0, msg=n)
    for a, b in zip(out["cuda"][3], out["cpu"][3]):
        assert abs(a - b) <= 5e-2
    assert out["cuda"][3][-1] < out["cuda"][3][0]


def _ring_by_chunks(q, k, v, n):
    """Ring attention over ``n`` ranks simulated in one process: rank r's
    q chunk folds the kv chunks r, r-1, ... in the ring's order with
    their global offsets. → (out [b,s,h,d], lse [b,s,h] f32)."""
    from service_account_auth_improvements_tpu_torch.parallel import ring

    c = q.shape[1] // n
    outs, lses = [], []
    for r in range(n):
        qr = q[:, r * c:(r + 1) * c]
        o = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qr.shape[:-1], ring.NEG_INF, device=q.device)
        for step in range(n):
            j = (r - step) % n
            oj, lj = ring._chunk_attention_with_lse(
                qr, k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                r * c, j * c, q.shape[-1] ** -0.5)
            o, lse = ring._merge(o, lse, oj, lj)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_chunks_compose_to_full_attention_on_cuda(cuda, dtype):
    """The ring's per-rank arithmetic on the card: 4 chunks of 128 (b 2,
    4 / 2 heads, d 128, causal) composed with their global offsets equal
    K1's output and LSE and dense attention, within TOL (LSE 1e-3)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        attention,
        flash_attention as fa,
    )

    q, k, v = (t.transpose(1, 2) for t in _qkv(2, 512, 4, 2, 128, dtype))
    got, got_lse = _ring_by_chunks(q, k, v, 4)
    want, want_lse = fa.flash_fwd(*(t.transpose(1, 2) for t in (q, k, v)),
                                  True)
    dense = attention._dense_attention(q, k, v, 128 ** -0.5)
    atol, rtol = TOL[dtype]
    for ref in (want.transpose(1, 2), dense):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(got_lse, want_lse.transpose(1, 2),
                               atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_world_one_nccl_mesh_step_equals_plain_on_cuda(cuda):
    """``make_mesh`` with no process group starts one of one rank over
    NCCL; on that mesh three train steps (flash, and Ulysses at sp 1,
    whose exchanges are the identity) equal the plain step bit for bit,
    with the plain step's kernel launches."""
    import torch.distributed as dist

    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )
    from service_account_auth_improvements_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
        sharding,
    )
    from service_account_auth_improvements_tpu_torch.train import step

    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1))
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    cfg = _small_flash_cfg("bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")
    mask = torch.ones_like(tokens)
    runs = {}
    for name, c, m in (("plain", cfg, None), ("mesh", cfg, mesh),
                       ("ulysses", dataclasses.replace(
                           cfg, attn_impl="ulysses"), mesh)):
        state = step.init_train_state(
            c, torch.Generator(device="cuda").manual_seed(0))
        if m is not None:
            state = step.shard_state(m, c, state)
        fn = step.make_train_step(c, mesh=m)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        metrics = []
        for _ in range(3):
            state, met = fn(state, tokens, mask)
            metrics.append((met["loss"].item(), met["grad_norm"].item()))
        after = (fa.launches, fa.dq_launches, fa.dkv_launches)
        leaves = [sharding.full_tensor(t) for tree in (
            state.params, state.opt_state.mu, state.opt_state.nu)
            for _, t in step._leaves(tree)]
        runs[name] = (metrics, [a - b for a, b in zip(after, before)],
                      leaves)
    L = cfg.n_layers
    assert runs["plain"][1] == [3 * 2 * L, 3 * L, 3 * L]
    for name in ("mesh", "ulysses"):
        assert runs[name][0] == runs["plain"][0], name
        assert runs[name][1] == runs["plain"][1], name
        assert all(torch.equal(a, b) for a, b in zip(runs[name][2],
                                                     runs["plain"][2]))


def _chip_smoke():
    """chip_smoke.py (JAX-free), for phase 13's journal and tolerances."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_policy_trains_on_cuda_like_the_cpu(cuda):
    """The placement policy's 300 default steps on the card against the
    CPU, at phase 13's tolerances: every loss, every param but b3, and
    the probabilities of every feasible pool (what b3 is held through)."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        features,
        model,
        train as ptrain,
    )

    cs = _chip_smoke()
    tol = cs.POLICY_TOL
    data = features.dataset(cs.policy_journal(2048, 0))
    card, card_hist = ptrain.fit_policy(data, log_every=1, device="cuda")
    cpu, cpu_hist = ptrain.fit_policy(data, log_every=1, device="cpu")
    assert len(card_hist) == len(cpu_hist) == cs.POLICY_STEPS
    for a, b in zip(card_hist, cpu_hist):
        assert abs(a["loss"] - b["loss"]) <= tol["loss"], a["step"]
    for k in model.PARAM_KEYS:
        assert card.params[k].is_cuda
        if k != "b3":
            torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                       atol=tol["atol"], rtol=tol["rtol"])
    feats, glob, mask = (torch.as_tensor(data[k]) for k in (
        "pool_feats", "glob", "mask"))
    with torch.no_grad():
        probs = [torch.softmax(model.forward(
            {k: v.cpu() for k, v in p.items()}, feats, glob, mask), -1)
            [mask] for p in (card.params, cpu.params)]
    torch.testing.assert_close(probs[0], probs[1], atol=tol["probs"],
                               rtol=0)


@pytest.mark.cuda
def test_policy_resume_is_bit_equal_on_cuda(cuda, tmp_path):
    """Stopped at 30 and resumed to 60 on the card: params, moments and
    count bit-equal to the straight run; the checkpoint loads on the
    card and the CPU alike."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        features,
        model,
        train as ptrain,
    )

    data = features.dataset(_chip_smoke().policy_journal(1024, 1))
    kw = dict(seed=2, batch_size=256, log_every=0, device="cuda")
    wd = str(tmp_path / "resume")
    ptrain.fit_policy(data, steps=30, workdir=wd, **kw)
    resumed, _ = ptrain.fit_policy(data, steps=60, workdir=wd, **kw)
    straight, _ = ptrain.fit_policy(data, steps=60, **kw)
    assert resumed.opt_state.count == straight.opt_state.count == 60
    for tree in ("params", "mu", "nu"):
        a = (resumed.params if tree == "params"
             else getattr(resumed.opt_state, tree))
        b = (straight.params if tree == "params"
             else getattr(straight.opt_state, tree))
        for k in model.PARAM_KEYS:
            assert torch.equal(a[k], b[k]), (tree, k)
    loaded = ptrain.load_checkpoint(str(tmp_path / "resume"
                                        / ptrain.CKPT_FILE))
    for dev in ("cuda", "cpu"):
        params = model.params_from_numpy(loaded["params"], dev)
        for k in model.PARAM_KEYS:
            assert torch.equal(params[k].cpu(), straight.params[k].cpu())
