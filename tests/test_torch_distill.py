"""Port parity: distillation (train/distill.py) against the JAX
``train/distill.py``, on JAX-initialised teacher and student params
bridged as numpy, f32 compute.

Tolerances: ``distill_loss`` and its metrics within 2e-6 (summation order
through the backbones and the vocab reductions); three
``make_distill_step`` steps within ``tests/test_torch_train.py``'s (loss
2e-6, grad norm 1e-6 relative, params and moments atol 5e-6 + rtol
1e-5). The teacher comes back bit for bit and never requires grad.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.train import distill as jdistill  # noqa: E402
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    distill as tdistill,
    step as tstep,
)

TEACHER = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
STUDENT = dataclasses.replace(TEACHER, n_layers=1, dim=32, n_heads=2,
                              n_kv_heads=1, mlp_dim=64)
MOE_STUDENT = dataclasses.replace(
    jllama.PRESETS["moe_smoke"], dtype="float32", vocab_size=256, dim=64,
    n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, mlp_dim=128)


def _tcfg(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def _t(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()), tree)


def _batch(seed=2, b=2, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TEACHER.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones_like(toks)
    mask[:, 20:] = 0
    return toks, mask


@pytest.mark.parametrize("student,loss_chunk", [
    (STUDENT, 0), (STUDENT, 7), (MOE_STUDENT, 0), (MOE_STUDENT, 5)])
def test_distill_loss_matches_jax(student, loss_chunk):
    """Loss, hard loss and KL against JAX's, unchunked and chunked (a
    ragged tail chunk); an MoE student carries its aux term."""
    cfg_s = dataclasses.replace(student, loss_chunk=loss_chunk)
    teacher = jllama.init(TEACHER, jax.random.key(0))
    params = jllama.init(cfg_s, jax.random.key(1))
    toks, mask = _batch()
    jloss, jm = jdistill.distill_loss(cfg_s, TEACHER, params, teacher,
                                      jnp.asarray(toks), jnp.asarray(mask),
                                      temperature=1.5, alpha=0.3)
    tloss, tm = tdistill.distill_loss(
        _tcfg(cfg_s), _tcfg(TEACHER), _t(params), _t(teacher),
        torch.tensor(toks, dtype=torch.long), torch.tensor(mask),
        temperature=1.5, alpha=0.3)
    for k in ("loss", "hard_loss", "kl"):
        assert tm[k].dtype == torch.float32
        assert abs(float(tm[k]) - float(jm[k])) < 2e-6, k
    assert float(tloss) == float(tm["loss"])
    mixed = 0.3 * 1.5 ** 2 * float(tm["kl"]) + 0.7 * float(tm["hard_loss"])
    if cfg_s.moe_experts:
        assert float(tloss) > mixed + 1e-6  # the aux term is there
    else:
        assert abs(float(tloss) - mixed) < 1e-6


def test_identical_models_have_zero_kl_and_the_plain_loss():
    """Teacher = student: KL 0 (to rounding) and the hard term equals
    ``next_token_loss`` under the same mask."""
    cfg = _tcfg(TEACHER)
    params = tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks, mask = _batch()
    toks, mask = torch.tensor(toks, dtype=torch.long), torch.tensor(mask)
    _, m = tdistill.distill_loss(cfg, cfg, params, params, toks, mask)
    assert abs(float(m["kl"])) < 1e-6
    want = tllama.next_token_loss(cfg, params, toks, mask)
    np.testing.assert_allclose(float(m["hard_loss"]), float(want),
                               rtol=1e-6)


def test_three_distill_steps_match_jax():
    """3 steps against the jitted JAX step from the same student state
    (zero moments, default optimizer: weight decay 0.1, clip 1.0)."""
    jopt = jstep.make_optimizer(learning_rate=1e-2)
    topt = tstep.make_optimizer(learning_rate=1e-2)
    teacher = jllama.init(TEACHER, jax.random.key(0))
    js = jstep.init_train_state(STUDENT, jax.random.key(1), optimizer=jopt)
    tteacher = _t(teacher)
    copy = {n: t.clone() for n, t in tstep._leaves(tteacher)}
    params = _t(js.params)
    ts = tstep.TrainState(0, params, topt.init(params))
    jfn = jdistill.make_distill_step(STUDENT, TEACHER, jopt, alpha=0.7)
    tfn = tdistill.make_distill_step(_tcfg(STUDENT), _tcfg(TEACHER), topt,
                                     alpha=0.7)
    tfa.launches = 0
    for i in range(3):
        toks, mask = _batch(seed=10 + i, b=4)
        js, jm = jfn(js, teacher, jnp.asarray(toks), jnp.asarray(mask))
        ts, tm = tfn(ts, tteacher, torch.tensor(toks, dtype=torch.long),
                     torch.tensor(mask))
        adam = js.opt_state[1][0]
        assert ts.step == int(js.step) == i + 1
        for k in ("loss", "hard_loss", "kl"):
            assert abs(float(tm[k]) - float(jm[k])) < 2e-6, (k, i)
            assert not tm[k].requires_grad
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for what, want, got in (("params", js.params, ts.params),
                                ("mu", adam.mu, ts.opt_state.mu),
                                ("nu", adam.nu, ts.opt_state.nu)):
            atol = 5e-6 * (1e-3 if what == "nu" else 1)
            jl = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
            tl = [t.float().numpy() for _, t in tstep._leaves(got)]
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                np.testing.assert_allclose(b, a, atol=atol, rtol=1e-5,
                                           err_msg=f"{what} step {i}")
    for name, t in tstep._leaves(tteacher):
        assert torch.equal(t, copy[name]), name
        assert not t.requires_grad and t.grad is None
    assert tfa.launches == 0  # dense attention here


def test_teacher_runs_once_per_step_without_a_graph(monkeypatch):
    """With flash attention (the kernels' plain versions on the CPU,
    counted here as the kernels count their launches on the card) the
    teacher's layers run once per step (never recomputed by the
    backward), the student's twice under remat: K1 = 2·L_s + L_t, K2 =
    K3 = L_s."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for kind, name in (("fwd", "flash_fwd_reference"),
                       ("dq", "flash_bwd_dq_reference"),
                       ("dkv", "flash_bwd_dkv_reference")):
        def counted(*a, _fn=getattr(tfa, name), _kind=kind):
            calls[_kind] += 1
            return _fn(*a)
        monkeypatch.setattr(tfa, name, counted)
    t_cfg = dataclasses.replace(_tcfg(TEACHER), head_dim=64, n_heads=2,
                                n_kv_heads=1, attn_impl="flash")
    s_cfg = dataclasses.replace(_tcfg(STUDENT), head_dim=64, n_heads=2,
                                n_kv_heads=1, attn_impl="flash",
                                loss_chunk=8)
    gen = torch.Generator().manual_seed(0)
    teacher = tllama.init(t_cfg, gen, device="cpu")
    state = tstep.init_train_state(s_cfg, gen, device="cpu")
    step = tdistill.make_distill_step(s_cfg, t_cfg)
    toks, mask = _batch()
    state, m = step(state, teacher, torch.tensor(toks, dtype=torch.long),
                    torch.tensor(mask))
    assert torch.isfinite(m["loss"])
    L_s, L_t = s_cfg.n_layers, t_cfg.n_layers
    assert calls == {"fwd": 2 * L_s + L_t, "dq": L_s, "dkv": L_s}


def test_vocab_mismatch_raises_in_both_functions():
    bad = dataclasses.replace(_tcfg(STUDENT),
                              vocab_size=2 * STUDENT.vocab_size)
    with pytest.raises(ValueError, match="vocab"):
        tdistill.make_distill_step(bad, _tcfg(TEACHER))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="vocab"):
        tdistill.distill_loss(bad, _tcfg(TEACHER), {}, {}, toks,
                              torch.ones_like(toks))
    # a mesh runs (tests/test_torch_side_meshes.py); it must be a
    # make_mesh mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdistill.make_distill_step(_tcfg(STUDENT), _tcfg(TEACHER),
                                   mesh=object())
