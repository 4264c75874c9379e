"""Port parity: the side models' meshes, on gloo CPU ranks
(``tests/torch_parallel_workers.py``) against the JAX package's mesh
steps on its virtual devices and against the port's unsharded steps.

- LoRA on fsdp 2 x tp 2: three ``make_lora_train_step(mesh=)`` steps
  against JAX's ``make_lora_train_step(mesh=)`` and the port's unsharded
  step, f32, at ``tests/test_torch_lora.py``'s tolerances (loss 2e-6,
  grad norm 1e-6 relative, adapters and moments atol 5e-6 + rtol 1e-5);
  the base comes back bit for bit. ``fit(mesh=, lora=)`` resumed from
  its checkpoint equals the straight run bit for bit.
- Distillation on fsdp 2: three ``make_distill_step(mesh=)`` steps
  against JAX's on its fsdp 2 mesh and the port's unsharded step, at
  ``tests/test_torch_distill.py``'s tolerances (the train tests').
- MNIST and resnet18-smoke data parallel over dp 2 (ResNet's batch norm
  cross-replica) against JAX's mesh steps and the port's unsharded step
  on the global batch: in f32 compute at ``tests/test_torch_vision.py``'s
  f32 tolerances (loss 1e-5, each leaf within 2e-5 of its largest
  element, running stats atol 1e-5 + rtol 1e-5), and as shipped in bf16
  at its bf16 ones (MNIST loss and params 2e-2; ResNet loss 5e-3, stats
  2e-2); every rank's running statistics are the same.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.models import mnist as jmnist  # noqa: E402
from service_account_auth_improvements_tpu.models import resnet as jresnet  # noqa: E402
from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig,
    make_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu.train import distill as jdistill  # noqa: E402
from service_account_auth_improvements_tpu.train import lora as jlora  # noqa: E402
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    mnist as tmnist,
    params as tparams,
    resnet as tresnet,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    distill as tdistill,
    lora as tlora,
    step as tstep,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (  # noqa: E402
    leaves,
)
from tests import test_torch_vision as tvision  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402
from tests.jaxdrift import requires_jax_shard_map  # noqa: E402

TINY = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32")
STUDENT = dataclasses.replace(TINY, n_layers=1, dim=32, n_heads=2,
                              n_kv_heads=2, mlp_dim=64)


def _tcfg(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batches(vocab, n=3, b=4, s=24, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (b, s)).astype(np.int64)
        mask = np.ones_like(toks, dtype=np.int32)
        mask[1, 17:] = 0  # a padded row
        out.append((toks, mask))
    return out


def _close(got, want, what, atol=5e-6):
    """Adapters/params and moments at the train tests' tolerances."""
    for part in ("params", "mu", "nu"):
        g = dict(leaves(got[part]))
        w = dict(leaves(want[part]))
        assert sorted(g) == sorted(w)
        tol = atol * (1e-3 if part == "nu" else 1)
        for name in g:
            np.testing.assert_allclose(
                np.asarray(g[name], np.float32),
                np.asarray(w[name], np.float32), atol=tol, rtol=1e-5,
                err_msg=f"{what} {part}/{name}")


def _jmesh(**kw):
    n = int(np.prod(list(kw.values())))
    mesh = make_mesh(MeshConfig(dp=1, **kw), jax.devices()[:n])
    return mesh, NamedSharding(mesh, P(("dp", "fsdp"), None))


def _jax_adam(js):
    adam = js.opt_state[1][0]
    return {"params": _np(js.params), "mu": _np(adam.mu),
            "nu": _np(adam.nu)}


def _port(ts):
    return {"params": ts.params, "mu": ts.opt_state.mu,
            "nu": ts.opt_state.nu}


@requires_jax_shard_map
def test_lora_steps_on_fsdp2_tp2_match_jax(tmp_path):
    """Adapters on wq/wo (A over fsdp and B over tp for wq, the reverse
    for wo) and the dense mlp, three steps."""
    cfg = TINY
    lcfg = jlora.LoraConfig(rank=4, targets=("wq", "wo", "w_gate",
                                             "w_down"))
    lr = 1e-2
    base = jllama.init(cfg, jax.random.key(0))
    js = jlora.init_lora_state(cfg, lcfg, jax.random.key(1),
                               jstep.make_optimizer(learning_rate=lr,
                                                    weight_decay=0.0))
    # B drawn too, so A moves from the first step
    rng = np.random.default_rng(3)
    lora = {t: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(0, 0.05, ab["b"].shape), jnp.float32)}
        for t, ab in js.params.items()}
    js = js._replace(params=lora)
    batches = _batches(cfg.vocab_size)
    torch.save({"base": _np(base), "lora": _np(lora),
                "batches": [(torch.tensor(t), torch.tensor(m))
                            for t, m in batches]},
               tmp_path / "side-init.pt")
    tl = tlora.LoraConfig(**dataclasses.asdict(lcfg))
    workers.launch("lora_mesh", 4, tmp_path,
                   dataclasses.asdict(_tcfg(cfg)), dataclasses.asdict(tl),
                   dict(fsdp=2, tp=2), lr)
    got = workers.load(tmp_path / "lora.pt")
    assert got["base_same"]
    # A inherits the input axis (embed: fsdp, dim 1), B the output one
    assert got["places"]["wq/a"][2] == 1 and got["places"]["wq/b"][4] == 2
    assert got["places"]["wo/a"][4] == 1 and got["places"]["wo/b"][2] == 2
    jmesh, sh = _jmesh(fsdp=2, tp=2)
    jopt = jstep.make_optimizer(learning_rate=lr, weight_decay=0.0)
    jfn = jlora.make_lora_train_step(cfg, lcfg, jopt, mesh=jmesh)
    topt = tstep.make_optimizer(learning_rate=lr, weight_decay=0.0)
    tlo = tparams.from_numpy(_np(lora), _tcfg(cfg), device="cpu")
    ts = tstep.TrainState(0, tlo, topt.init(tlo))
    tbase = tparams.from_numpy(_np(base), _tcfg(cfg), device="cpu")
    tfn = tlora.make_lora_train_step(_tcfg(cfg), tl, topt)
    for i, (toks, mask) in enumerate(batches):
        with use_mesh(jmesh):
            js, jm = jfn(js, base, jax.device_put(toks.astype(np.int32),
                                                  sh),
                         jax.device_put(mask, sh))
        ts, tm = tfn(ts, tbase, torch.tensor(toks), torch.tensor(mask))
        step = got["steps"][i]
        for ref in (jm, tm):
            assert abs(step["loss"] - float(ref["loss"])) < 2e-6, i
            np.testing.assert_allclose(step["grad_norm"],
                                       float(ref["grad_norm"]), rtol=1e-6)
        _close(step, _jax_adam(js), f"lora vs JAX step {i}")
        _close(step, _port(ts), f"lora vs unsharded step {i}")


@requires_jax_shard_map
def test_distill_steps_on_fsdp2_match_jax(tmp_path):
    cfg_s = STUDENT
    teacher = jllama.init(TINY, jax.random.key(0))
    js = jstep.init_train_state(cfg_s, jax.random.key(1))
    init = _jax_adam(js)
    batches = _batches(TINY.vocab_size, b=4)
    torch.save({"teacher": _np(teacher), **init,
                "batches": [(torch.tensor(t), torch.tensor(m))
                            for t, m in batches]},
               tmp_path / "side-init.pt")
    workers.launch("distill_mesh", 2, tmp_path,
                   dataclasses.asdict(_tcfg(cfg_s)),
                   dataclasses.asdict(_tcfg(TINY)), dict(fsdp=2))
    got = workers.load(tmp_path / "distill.pt")
    jmesh, sh = _jmesh(fsdp=2)
    js = jax.device_put(js, jstep.state_shardings(jmesh, cfg_s, js))
    jfn = jdistill.make_distill_step(cfg_s, TINY, mesh=jmesh,
                                     temperature=1.5, alpha=0.3)
    ts = tparams.train_state_from_numpy(_tcfg(cfg_s), init["params"],
                                        init["mu"], init["nu"],
                                        device="cpu")
    tteacher = tparams.from_numpy(_np(teacher), _tcfg(TINY), device="cpu")
    tfn = tdistill.make_distill_step(_tcfg(cfg_s), _tcfg(TINY),
                                     temperature=1.5, alpha=0.3)
    for i, (toks, mask) in enumerate(batches):
        with use_mesh(jmesh):
            js, jm = jfn(js, teacher, jax.device_put(toks.astype(np.int32),
                                                     sh),
                         jax.device_put(mask, sh))
        ts, tm = tfn(ts, tteacher, torch.tensor(toks), torch.tensor(mask))
        step = got["steps"][i]
        for ref in (jm, tm):
            for k in ("loss", "hard_loss", "kl"):
                assert abs(step[k] - float(ref[k])) < 2e-6, (i, k)
            np.testing.assert_allclose(step["grad_norm"],
                                       float(ref["grad_norm"]), rtol=1e-6)
        _close(step, _jax_adam(js), f"distill vs JAX step {i}")
        _close(step, _port(ts), f"distill vs unsharded step {i}")


def test_fit_lora_on_a_mesh_resumes_bitwise(tmp_path):
    """``fit(mesh=fsdp 2 x tp 2, lora=)``: 2 steps, then 2 more resumed
    from the checkpoint, equal 4 straight steps bit for bit on every
    rank, with the same eval record; the straight run's losses equal
    the unsharded ``fit``'s within the train tolerance."""
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )
    from service_account_auth_improvements_tpu_torch.train.loop import (
        LoopConfig,
        fit,
    )

    cfg = _tcfg(TINY)
    lcfg = tlora.LoraConfig(rank=4)
    workers.launch("fit_lora_mesh", 4, tmp_path, dataclasses.asdict(cfg),
                   dataclasses.asdict(lcfg))
    ranks = [workers.load(tmp_path / f"fit-lora-r{r}.pt") for r in range(4)]
    for r in ranks:
        a, b = r["straight"], r["resumed"]
        assert a["step"] == b["step"] == 4
        for part in ("params", "mu", "nu"):
            for (n, x), (_, y) in zip(leaves(a[part]), leaves(b[part])):
                assert torch.equal(x, y), (part, n)
                assert torch.equal(x, dict(leaves(ranks[0]["straight"][
                    part]))[n])
        assert a["history"][-1] == b["history"][-1]  # the eval record
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 4096).astype(np.int32)
    base = tllama.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    _, history = fit(cfg, None, tokens, DataConfig(batch=4, seq=32),
                     LoopConfig(steps=4, log_every=1, eval_every=4),
                     log=lambda *a: None, device="cpu", lora=lcfg,
                     base_params=base,
                     eval_data=[tokens[:128].reshape(4, 32)])
    sharded = ranks[0]["straight"]["history"]
    assert [h["step"] for h in history] == [h["step"] for h in sharded]
    for h, s in zip(history, sharded):
        for key in ("loss", "eval_loss"):
            if key in h:
                assert abs(h[key] - s[key]) < 2e-6, (key, h, s)


def _vision_refs(x_m, y_m, x_r, y_r, mnist0, resnet0, dp_mesh):
    """The references: JAX's dp mesh steps and the port's unsharded
    steps on the global batch (three each)."""
    jm_fn = jmnist.make_sgd_step(jmnist.MnistConfig(), lr=0.1,
                                 mesh=dp_mesh)
    tm_fn = tmnist.make_sgd_step(tmnist.MnistConfig(), lr=0.1)
    jp, tp = mnist0, tvision._t(mnist0)
    ref = {"mnist": {"jax": [], "port": []}, "resnet": {"jax": [],
                                                        "port": []}}
    for _ in range(3):
        with use_mesh(dp_mesh):
            jp, jl = jm_fn(jp, jnp.asarray(x_m), jnp.asarray(y_m))
        tp, tl = tm_fn(tp, torch.tensor(x_m), torch.tensor(y_m))
        ref["mnist"]["jax"].append((jp, float(jl)))
        ref["mnist"]["port"].append((tp, float(tl)))
    cfg, params, stats = resnet0
    jr_fn = jresnet.make_train_step(cfg, lr=0.1, mesh=dp_mesh)
    tr_fn = tresnet.make_train_step(tresnet.PRESETS[tvision.SMOKE], lr=0.1)
    jst = (params, stats, jax.tree.map(jnp.zeros_like, params))
    tst = (tvision._t(params), tvision._t(stats),
           tvision._t(jax.tree.map(jnp.zeros_like, params)))
    for _ in range(3):
        with use_mesh(dp_mesh):
            *jst, jl = jr_fn(*jst, jnp.asarray(x_r), jnp.asarray(y_r))
        *tst, tl = tr_fn(*tst, torch.tensor(x_r), torch.tensor(y_r))
        ref["resnet"]["jax"].append((*jst, float(jl)))
        ref["resnet"]["port"].append((*tst, float(tl)))
    return ref


@requires_jax_shard_map
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vision_steps_on_dp2_match_jax(dtype, tmp_path, request):
    """MNIST and resnet18-smoke (cross-replica batch norm) on dp 2: three
    steps' losses, params, momentum and running statistics against JAX's
    dp 2 mesh steps and the port's unsharded steps on the global batch."""
    f32 = dtype == "f32"
    if f32:
        request.getfixturevalue("f32_compute")
    x_m, y_m = tvision._mnist_data(n=32)
    mnist0 = jmnist.init(jmnist.MnistConfig(), jax.random.key(0))
    resnet0 = tvision._resnet()
    x_r, y_r = tvision._images(8, 32)
    torch.save({"mnist_batch": (torch.tensor(x_m), torch.tensor(y_m)),
                "resnet_batch": (torch.tensor(x_r), torch.tensor(y_r)),
                "mnist": tvision._t(mnist0),
                "resnet": (tvision._t(resnet0[1]), tvision._t(resnet0[2]))},
               tmp_path / "vision-init.pt")
    workers.launch("vision_mesh", 2, tmp_path, f32)
    ranks = [workers.load(tmp_path / f"vision-r{r}.pt") for r in range(2)]
    dp_mesh = make_mesh(MeshConfig(dp=2, fsdp=1), jax.devices()[:2])
    ref = _vision_refs(x_m, y_m, x_r, y_r, mnist0, resnet0, dp_mesh)
    mnist_tol = 1e-5 if f32 else 2e-2
    resnet_tol = 1e-5 if f32 else 5e-3
    for r in ranks:
        m = r["mnist"]
        for i, loss in enumerate(m["losses"]):
            for who in ("jax", "port"):
                assert abs(loss - ref["mnist"][who][i][1]) < mnist_tol, \
                    (who, i)
        for who in ("jax", "port"):
            if f32:
                tvision._assert_leaves(m["params"], ref["mnist"][who][-1][0]
                                       if who == "jax" else
                                       _np_tree(ref["mnist"][who][-1][0]),
                                       2e-5, f"mnist params vs {who}")
        res = r["resnet"]
        for i, loss in enumerate(res["losses"]):
            for who in ("jax", "port"):
                assert abs(loss - ref["resnet"][who][i][3]) < resnet_tol, \
                    (who, i)
        for who in ("jax", "port"):
            params, stats, mom, _ = ref["resnet"][who][-1]
            if who == "port":
                params, stats, mom = (_np_tree(t) for t in (params, stats,
                                                            mom))
            for name, g, w in tvision._pairs(res["stats"], stats):
                np.testing.assert_allclose(
                    g, w, atol=1e-5 if f32 else 2e-2, rtol=1e-5 if f32
                    else 0, err_msg=f"stats {name} vs {who}")
            if f32:
                tvision._assert_leaves(res["mom"], mom, 2e-5,
                                       f"resnet momentum vs {who}")
                tvision._assert_leaves(res["params"], params, 2e-5,
                                       f"resnet params vs {who}")
    # the running statistics are the same on every rank
    for (_, a), (_, b) in zip(leaves(ranks[0]["resnet"]["stats"]),
                              leaves(ranks[1]["resnet"]["stats"])):
        assert torch.equal(a, b)


def _np_tree(tree):
    """A port tree as nested numpy (the shape ``_pairs`` walks)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


@pytest.fixture
def f32_compute(monkeypatch):
    for jmod, tmod in ((jmnist, tmnist), (jresnet, tresnet)):
        monkeypatch.setattr(jmod, "jnp", tvision._F32(jnp, jnp.float32))
        monkeypatch.setattr(tmod, "torch", tvision._F32(torch,
                                                        torch.float32))
