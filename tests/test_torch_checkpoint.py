"""The port's checkpoints (train/checkpoint.py) on the CPU, and a resume
held against the jitted JAX train step.

Round trips are bitwise. The JAX bridge: 3 jitted JAX steps from one JAX
init, the state bridged with ``params.train_state_from_numpy``, saved by
the port and restored; 2 more port steps then equal 2 more JAX steps
within test_torch_train.py's f32 tolerances (loss 2e-6; params atol 5e-6 +
rtol 1e-5, a thousandth of the elements up to 3e-5; moments atol 5e-6 /
5e-9 for nu, rtol 1e-5): summation order only.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    checkpoint as ckpt,
    step as tstep,
)
from tests.test_torch_train import _assert_close  # noqa: E402

CFG = tllama.PRESETS["tiny"]


def _batch(seed, cfg=CFG):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 24))
    return torch.tensor(toks, dtype=torch.long), torch.ones(4, 24,
                                                            dtype=torch.int)


def _state(cfg=CFG, optimizer=None, seed=0):
    return tstep.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                  optimizer, device="cpu")


def _trained(steps, cfg=CFG, optimizer=None):
    state = _state(cfg, optimizer)
    fn = tstep.make_train_step(cfg, optimizer)
    for i in range(steps):
        state, _ = fn(state, *_batch(i, cfg))
    return state, fn


def _flat(state):
    return ([("params/" + n, t) for n, t in tstep._leaves(state.params)]
            + [("mu/" + n, t) for n, t in tstep._leaves(state.opt_state.mu)]
            + [("nu/" + n, t) for n, t in tstep._leaves(state.opt_state.nu)])


def _assert_equal(got, want):
    assert (got.step, got.opt_state.count) == (want.step,
                                               want.opt_state.count)
    for (name, a), (_, b) in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("param_dtype,mu_dtype", [
    ("float32", None), ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_save_restore_round_trip_is_bitwise(tmp_path, param_dtype,
                                            mu_dtype):
    cfg = dataclasses.replace(CFG, param_dtype=param_dtype)
    opt = tstep.make_optimizer(mu_dtype=mu_dtype)
    state, _ = _trained(2, cfg, opt)
    assert ckpt.save(tmp_path / "ck", state) == 2
    assert ckpt.latest_step(tmp_path / "ck") == 2
    step_dir = tmp_path / "ck" / "2"
    assert sorted(os.listdir(step_dir)) == ["meta.json", "opt.pt",
                                            "params.pt"]
    meta = json.loads((step_dir / "meta.json").read_text())
    assert meta["step"] == 2
    assert meta["leaves"]["opt/mu/lm_head"] == {
        "dtype": mu_dtype or param_dtype,
        "shape": [cfg.dim, cfg.vocab_size]}
    like = _state(cfg, opt, seed=5)
    got = ckpt.restore(tmp_path / "ck", None, cfg, like)
    _assert_equal(got, state)
    assert got.params["lm_head"] is like.params["lm_head"]  # in place


def test_restore_casts_to_the_target_dtypes(tmp_path):
    """The target state gives the dtypes, as orbax's target does: an f32
    mu restores as bf16 into a bf16 target."""
    state, _ = _trained(1)
    ckpt.save(tmp_path, state)
    like = _state(optimizer=tstep.make_optimizer(mu_dtype="bfloat16"))
    got = ckpt.restore(tmp_path, None, CFG, like)
    assert got.opt_state.mu["lm_head"].dtype == torch.bfloat16
    assert torch.equal(got.opt_state.mu["lm_head"],
                       state.opt_state.mu["lm_head"].bfloat16())
    assert torch.equal(got.params["lm_head"], state.params["lm_head"])


def test_resumed_equals_uninterrupted_bitwise(tmp_path):
    """4 steps straight against 2 steps, save, restore into a fresh
    init, 2 more: every param and moment bit-identical on the CPU."""
    straight, fn = _trained(4)
    half, _ = _trained(2)
    ckpt.save(tmp_path, half)
    resumed = ckpt.restore(tmp_path, None, CFG, _state(seed=7))
    assert resumed.step == 2
    for i in (2, 3):
        resumed, _ = fn(resumed, *_batch(i))
    _assert_equal(resumed, straight)


def _jnp(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_resume_from_bridged_jax_state_matches_jax(tmp_path):
    _resume_from_bridged(
        dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32"),
        tmp_path)


@pytest.mark.parametrize("top_k", [1, 2])
def test_resume_from_bridged_jax_moe_state_matches_jax(tmp_path, top_k):
    """The same bridge with a MoE FFN: the router and the stacked expert
    leaves (and their moments) go through the checkpoint, whose names are
    checked against ``logical_axes``."""
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                               moe_experts=4, moe_top_k=top_k)
    _resume_from_bridged(jcfg, tmp_path)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = ckpt.restore_params(tmp_path, None, tcfg, device="cpu")
    assert tuple(params["layers"]["moe_down"].shape) == (
        jcfg.n_layers, 4, jcfg.mlp_dim, jcfg.dim)


def _resume_from_bridged(jcfg, tmp_path):
    """3 jitted JAX steps, the state bridged, saved and restored by the
    port, then 2 more steps on both sides: equal within the f32
    tolerances."""
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    jfn = jstep.make_train_step(jcfg, jstep.make_optimizer())
    tfn = tstep.make_train_step(tcfg, tstep.make_optimizer())
    js = jstep.init_train_state(jcfg, jax.random.key(0),
                                optimizer=jstep.make_optimizer())
    batches = [_batch(10 + i, tcfg) for i in range(5)]
    for toks, mask in batches[:3]:
        js, _ = jfn(js, jnp.asarray(toks.numpy()), jnp.asarray(mask.numpy()))
    adam = js.opt_state[1][0]
    bridged = tparams.train_state_from_numpy(
        tcfg, _jnp(js.params), _jnp(adam.mu), _jnp(adam.nu),
        count=int(adam.count), step=int(js.step), device="cpu")
    assert ckpt.save(tmp_path, bridged) == 3
    ts = ckpt.restore(tmp_path, None, tcfg, _state(tcfg, seed=3))
    _assert_equal(ts, bridged)
    for toks, mask in batches[3:]:
        js, jm = jfn(js, jnp.asarray(toks.numpy()), jnp.asarray(mask.numpy()))
        ts, tm = tfn(ts, toks, mask)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 2e-6
    adam = js.opt_state[1][0]
    assert (ts.step, ts.opt_state.count) == (int(js.step), int(adam.count))
    for what, want, got in (("params", js.params, ts.params),
                            ("mu", adam.mu, ts.opt_state.mu),
                            ("nu", adam.nu, ts.opt_state.nu)):
        jl = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
        tl = [t.numpy() for _, t in tstep._leaves(got)]
        tol = 5e-6 * (1e-3 if what == "nu" else 1)
        loose = 3e-5 if what == "params" else tol
        for a, b in zip(jl, tl):
            _assert_close(b, a, tol, 1e-5, loose, what)


def test_restore_params_reads_params_only(tmp_path, monkeypatch):
    """The serving path: only params.pt is read (opt.pt can be gone), and
    each leaf keeps the checkpoint's dtype."""
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16")
    state, _ = _trained(1, cfg)
    ckpt.save(tmp_path, state)
    os.rename(tmp_path / "1" / "opt.pt", tmp_path / "opt.pt.away")
    opened = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda f, *a, **kw: (
        opened.append(os.path.basename(f)), real_load(f, *a, **kw))[1])
    params = ckpt.restore_params(tmp_path, None, cfg, device="cpu")
    assert opened == ["params.pt"]
    for (name, a), (_, b) in zip(tstep._leaves(params),
                                 tstep._leaves(state.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
    assert sorted(params) == sorted(state.params)


def test_restore_params_rejects_a_wrong_preset(tmp_path):
    state, _ = _trained(1)
    ckpt.save(tmp_path, state)
    wrong = dataclasses.replace(CFG, moe_experts=4)
    with pytest.raises(ValueError, match="matches no param"):
        ckpt.restore_params(tmp_path, None, wrong, device="cpu")
    # and a shape the state does not have fails the full restore
    smoke = tllama.PRESETS["smoke"]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, None, smoke, _state(smoke))


def test_max_to_keep_gc(tmp_path):
    state = _state()
    for i in range(1, 5):
        ckpt.save(tmp_path, state._replace(step=i), max_to_keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.isdigit())
    assert kept == ["3", "4"], kept


def test_half_written_save_is_ignored(tmp_path):
    """A save cut off before its rename leaves only a temporary sibling:
    latest_step and restore see the last whole step, and the next save of
    that step replaces the leftover."""
    state, _ = _trained(1)
    ckpt.save(tmp_path, state)
    partial = tmp_path / ".2.tmp"
    partial.mkdir()
    (partial / "params.pt").write_bytes(b"truncated")
    (tmp_path / "notes").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    got = ckpt.restore(tmp_path, None, CFG, _state(seed=4))
    _assert_equal(got, state)
    ckpt.save(tmp_path, state._replace(step=2))
    assert not partial.exists()
    assert ckpt.latest_step(tmp_path) == 2
    # a step already on disk is left as it is
    before = (tmp_path / "2" / "params.pt").stat().st_mtime_ns
    ckpt.save(tmp_path, state._replace(step=2))
    assert (tmp_path / "2" / "params.pt").stat().st_mtime_ns == before


def test_missing_checkpoint_and_mesh_raise(tmp_path):
    assert ckpt.latest_step(tmp_path / "nothing") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(tmp_path, None, CFG, device="cpu")
    # restoring onto a mesh is ported (tests/test_torch_parallel.py); what
    # is not a parallel.make_mesh DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        ckpt.restore(tmp_path, object(), CFG, _state())
    with pytest.raises(TypeError, match="DeviceMesh"):
        ckpt.restore_params(tmp_path, object(), CFG, device="cpu")
