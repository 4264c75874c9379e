"""Port parity: the train step against the jitted JAX ``make_train_step``
(mesh None), started from one JAX ``init_train_state``.

Each variant runs K = 3 steps on both sides from the same params and zero
moments (bridged with ``models/params.py``) and compares, after every
step, the loss, the pre-clip ``grad_norm``, the params and the Adam
moments. f32 compute. Tolerances: f32 state is summation order only
(largest params difference seen 1.8e-6 on params of ~0.1 after 3 steps);
bf16 params and moments round to bf16 in both, and a gradient that
rounds one bf16 ulp apart moves nu (~g^2) by two: they may differ by two
bf16 ulps (2^-6 relative); the reference's grad norm is itself a bf16 sum.
Adam divides by sqrt(nu) + eps, so a gradient element within rounding
noise of zero has an ill-conditioned update: a few params in a thousand
may move up to a tenth of a step's lr apart in f32 (seen: 1 of 16384,
by 1.1e-5), or a few bf16 ulps (seen: 1 of 16384, by 4.9e-4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.train import data as jdata  # noqa: E402
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    step as tstep,
)
from service_account_auth_improvements_tpu_torch.train.mfu import (  # noqa: E402
    chip_peak_flops,
    mfu,
)

TINY = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
EOS = 3

# name: (config, make_train_step kwargs, make_optimizer kwargs, packed data)
VARIANTS = {
    "constant-lr": (TINY, {}, {}, False),
    "warmup-cosine": (dataclasses.replace(TINY, loss_chunk=20), {},
                      {"schedule": (1e-3, 2, 10)}, False),
    "grad-accum-2": (TINY, {"grad_accum": 2}, {}, False),
    "bf16-state": (dataclasses.replace(TINY, param_dtype="bfloat16"), {},
                   {"mu_dtype": "bfloat16"}, False),
    "packed": (TINY, {"packed": True}, {}, True),
    "segment-eos": (TINY, {"packed": True, "segment_eos_id": EOS}, {},
                    True),
    # head_dim 64: JAX takes dense attention on the CPU, the port its
    # flash Function with the kernels' plain versions
    "flash-hd64-dots": (dataclasses.replace(
        TINY, head_dim=64, n_heads=2, n_kv_heads=1, attn_impl="flash",
        remat_policy="dots_saveable"), {}, {}, False),
    # the wide head dims K1, K2 and K3 also take (flash on the port's
    # side, dense on JAX's, as above): 2 / 1 heads of 192 and 256, and the
    # split kernels' dims as chip_smoke.py cuts bench_800m, 3 / 1 heads of
    # 512 and 4 / 2 of 384
    **{f"flash-hd{d}": (dataclasses.replace(
        TINY, head_dim=d, n_heads=h, n_kv_heads=hkv, attn_impl="flash"), {},
        {}, False)
       for d, h, hkv in ((192, 2, 1), (256, 2, 1), (384, 4, 2),
                         (512, 3, 1))},
    # switch top-1 and Mixtral top-2 FFNs: the loss carries the aux term;
    # capacity int(1.25·k·40/4) per 40-token row, so claims overflow
    "moe": (dataclasses.replace(TINY, moe_experts=4), {}, {}, False),
    "moe_top2": (dataclasses.replace(TINY, moe_experts=4, moe_top_k=2),
                 {}, {}, False),
}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return [np.asarray(t.detach().float().numpy())
            for _, t in tstep._leaves(tree)]


def _optimizers(okw):
    okw = dict(okw)
    sched = okw.pop("schedule", None)
    if sched:
        return (jstep.make_optimizer(jstep.make_lr_schedule(*sched), **okw),
                tstep.make_optimizer(tstep.make_lr_schedule(*sched), **okw))
    return jstep.make_optimizer(**okw), tstep.make_optimizer(**okw)


def _batch(cfg, rng, packed):
    toks = rng.integers(4, cfg.vocab_size, (4, 40)).astype(np.int32)
    if not packed:
        return toks, np.ones_like(toks)
    toks[:, [7, 19, 30]] = EOS  # documents end mid-window
    return toks, jdata.boundary_mask(toks, EOS).astype(np.int32)


def _assert_close(got, want, atol, rtol, loose, what):
    """Every element within ``loose``, and all but one in a thousand
    within ``atol + rtol·|want|``."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert bad.mean() <= 1e-3, (
        f"{what}: {int(bad.sum())} of {bad.size} elements outside atol "
        f"{atol} rtol {rtol}")
    np.testing.assert_allclose(got, want, atol=loose, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_three_steps_match_jax(name):
    cfg, kw, okw, packed = VARIANTS[name]
    bf16 = cfg.param_dtype == "bfloat16"
    jopt, topt = _optimizers(okw)
    js = jstep.init_train_state(cfg, jax.random.key(0), optimizer=jopt)
    adam = js.opt_state[1][0]
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    ts = tparams.train_state_from_numpy(
        tcfg, _np(js.params), _np(adam.mu), _np(adam.nu), device="cpu",
        mu_dtype=okw.get("mu_dtype"))
    jfn = jstep.make_train_step(cfg, jopt, **kw)
    tfn = tstep.make_train_step(tcfg, topt, **kw)
    rng = np.random.default_rng(1)
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    for i in range(3):
        toks, mask = _batch(cfg, rng, packed)
        js, jm = jfn(js, jnp.asarray(toks), jnp.asarray(mask))
        ts, tm = tfn(ts, torch.tensor(toks, dtype=torch.long),
                     torch.tensor(mask))
        adam = js.opt_state[1][0]
        assert ts.step == int(js.step) == i + 1
        assert ts.opt_state.count == int(adam.count) == i + 1
        assert tm["loss"].dtype == torch.float32
        assert abs(float(tm["loss"]) - float(jm["loss"])) < (
            2e-4 if bf16 else 2e-6), i
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1.6e-2 if bf16 else 1e-6)
        atol, rtol = (1e-4, 2 ** -6) if bf16 else (5e-6, 1e-5)
        for what, want, got in (
                ("params", js.params, ts.params),
                ("mu", adam.mu, ts.opt_state.mu),
                ("nu", adam.nu, ts.opt_state.nu)):
            jl = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
            tl = _leaves(got)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                # nu is ~g^2: its scale sets the absolute tolerance
                tol = atol * (1e-3 if what == "nu" else 1)
                loose = ((1e-3 if bf16 else 3e-5) if what == "params"
                         else tol)
                _assert_close(b, a, tol, rtol, loose,
                              f"{name} {what} step {i}")
    assert ts.params["lm_head"].dtype == (torch.bfloat16 if bf16
                                          else torch.float32)
    if okw.get("mu_dtype"):
        assert ts.opt_state.mu["lm_head"].dtype == torch.bfloat16
        assert ts.opt_state.nu["lm_head"].dtype == torch.bfloat16
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0)


def test_lr_schedule_values():
    """The reference's schedule shapes (tests/test_train.py), evaluated
    at the same counts on both sides."""
    sched = tstep.make_lr_schedule(peak_lr=1e-3, warmup_steps=10,
                                   decay_steps=100)
    assert sched(0) == 0.0
    assert abs(sched(10) - 1e-3) < 1e-9
    assert abs(sched(100) - 1e-4) < 1e-9
    assert sched(55) < 1e-3
    assert tstep.make_lr_schedule(peak_lr=3e-4) == 3e-4
    wc = tstep.make_lr_schedule(peak_lr=1e-3, warmup_steps=10)
    assert wc(0) == 0.0
    assert abs(wc(10) - 1e-3) < 1e-9 and abs(wc(500) - 1e-3) < 1e-9
    for args in ((1e-3, 10, 100), (1e-3, 10, 0), (2e-4, 0, 50)):
        j, t = jstep.make_lr_schedule(*args), tstep.make_lr_schedule(*args)
        for count in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 250):
            np.testing.assert_allclose(t(count), float(j(count)),
                                       rtol=1e-6, atol=1e-12)


def test_clip_and_first_warmup_update():
    """optax semantics the hand-written AdamW keeps: a gradient whose
    norm is below the limit passes unscaled, one above is scaled by
    limit/norm; with warmup the first update has lr 0, so only the
    moments move; weight decay reaches every leaf."""
    opt = tstep.make_optimizer(tstep.make_lr_schedule(1e-2, 2, 0),
                               grad_clip=1.0)
    params = {"a": torch.ones(4), "n": {"b": torch.full((2,), 2.0)}}
    state = opt.init(params)
    small = {"a": torch.full((4,), 0.1), "n": {"b": torch.zeros(2)}}
    params, state = opt.apply(small, state, params)
    assert torch.equal(params["a"], torch.ones(4))   # lr(0) == 0
    torch.testing.assert_close(state.mu["a"], torch.full((4,), 0.01))
    big = {"a": torch.full((4,), 3.0), "n": {"b": torch.zeros(2)}}
    _, state = opt.apply(big, state, params)         # norm 6: scaled 1/6
    torch.testing.assert_close(state.mu["a"],
                               torch.full((4,), 0.9 * 0.01 + 0.1 * 0.5))
    # lr(1) = 5e-3: b's gradient is 0, so it moves by weight decay only
    torch.testing.assert_close(params["n"]["b"],
                               torch.full((2,), 2.0 - 5e-3 * 0.1 * 2.0))


def test_grad_accum_rejects_bad_batch_and_mesh_raises():
    cfg = tllama.PRESETS["tiny"]
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    step = tstep.make_train_step(cfg, grad_accum=3)
    toks = torch.zeros((8, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        step(state, toks, torch.ones_like(toks))
    # a mesh is ported (tests/test_torch_parallel.py); what is not a
    # parallel.make_mesh DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(cfg, mesh=object())


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", 0.0),
    ("Tesla T4", 0.0),
])
def test_chip_peak_flops_by_device_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert chip_peak_flops() == peak
    assert chip_peak_flops(0) == peak
    assert chip_peak_flops("cpu") == 0.0
    assert mfu(peak * 0.5, 1.0, 1) == (0.5 if peak else 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_peak_flops() == 0.0
