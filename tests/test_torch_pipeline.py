"""Port parity: the GPipe pipeline (``parallel/pipeline.py``) on gloo CPU
ranks against the JAX package's pipelined loss on its virtual devices.

The port's ranks (``tests/torch_parallel_workers.py``) run the tiny
preset at 4 layers in f32 with per-layer remat; the reference runs the
same params and batch through ``jax.value_and_grad`` of its pipelined
``next_token_loss`` on a mesh of the same shape (remat off: the same
arithmetic). Tolerances, tighter than ``tests/test_pipeline.py``'s own
2e-4/2e-3 against the scan: loss 1e-5, gradients atol 2e-5 + rtol 1e-4.
Three pipelined train steps are held at the train tests' tolerances
(``tests/test_torch_parallel.py``), each from a shared state; the
single-process schedule (``pipeline_local``, what
``chip_smoke.py`` drives on one card) is held here against the plain
stack.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig,
    make_mesh,
    pipeline_layers as jpipeline_layers,
    use_mesh,
)
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    checkpoint as tckpt,
    step as tstep,
)
from service_account_auth_improvements_tpu_torch.parallel import (  # noqa: E402
    pipeline as tpipe,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (  # noqa: E402
    leaves,
    value_and_grad,
)
from tests import test_torch_parallel as tpar  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402
from tests.jaxdrift import requires_jax_shard_map  # noqa: E402

CFG = dataclasses.replace(jllama.PRESETS["tiny"], n_layers=4,
                          dtype="float32", remat=False)
MOE = dataclasses.replace(jllama.PRESETS["moe_smoke"], dtype="float32",
                          remat=False)
LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-5, 1e-4


def _tcfg(cfg, **kw):
    # the port keeps per-layer remat on: the pipeline's stage graphs run
    # under torch.utils.checkpoint as in training
    return tllama.LlamaConfig(**{**dataclasses.asdict(cfg), "remat": True,
                                 **kw})


def _inputs(cfg, seed, b=8, s=32, pad_from=None):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
    mask = np.ones_like(tokens, dtype=np.int32)
    if pad_from is not None:
        mask[:, pad_from:] = 0
    return tokens, mask


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _run_port(tmp_path, tag, sizes, cfg, params, tokens, mask):
    torch.save({"params": _np(params), "tokens": torch.tensor(tokens),
                "mask": torch.tensor(mask)}, tmp_path / "grads-init.pt")
    world = int(np.prod(list(sizes.values())))
    workers.launch("model_grads", world, tmp_path, tag, sizes,
                   dataclasses.asdict(_tcfg(cfg)))
    return (workers.load(tmp_path / f"grads-{tag}.pt"),
            [workers.load(tmp_path / f"grads-{tag}-r{r}.pt")
             for r in range(world)])


def _jax_loss_grads(cfg, mesh_kw, params, tokens, mask):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = make_mesh(MeshConfig(fsdp=1, **mesh_kw), jax.devices()[:n])
    sh = NamedSharding(mesh, P(("dp", "fsdp"), None))
    toks = jax.device_put(jnp.asarray(tokens, jnp.int32), sh)
    m = jax.device_put(jnp.asarray(mask), sh)
    with use_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jllama.next_token_loss(cfg, p, toks, m)))(params)
    return float(loss), _np(grads)


def _assert_grads(got, want, what):
    want = dict(leaves(want))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{what} {name}")


# name: (port and JAX mesh, n_micro)
CASES = {
    "pp2-m2": (dict(pp=2), 2),
    "pp2-m4": (dict(pp=2), 4),
    "pp2-m8": (dict(pp=2), 8),
    "pp4": (dict(pp=4), 0),
    "pp2-tp2": (dict(pp=2, tp=2), 2),
}


@requires_jax_shard_map
@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_loss_and_grads_match_jax(name, tmp_path):
    """Loss and every gradient of the pipelined loss against the
    reference's on the same mesh; every rank reports the same loss, each
    stage holds only its slab of the stacked layers, and the leaves
    outside the stack (replicated over pp) get the same gradient on every
    stage."""
    sizes, n_micro = CASES[name]
    cfg = dataclasses.replace(CFG, pp_microbatches=n_micro,
                              iota_embed="tp" in sizes)
    params = jllama.init(cfg, jax.random.key(0))
    tokens, mask = _inputs(cfg, 1)
    got, ranks = _run_port(tmp_path, name, sizes, cfg, params, tokens, mask)
    want_loss, want_grads = _jax_loss_grads(cfg, sizes, params, tokens,
                                            mask)
    assert abs(got["loss"] - want_loss) < LOSS_TOL, (got["loss"], want_loss)
    assert all(r["loss"] == got["loss"] for r in ranks)
    _assert_grads(got["grads"], want_grads, name)
    n_stages = sizes["pp"]
    per = cfg.n_layers // n_stages
    wq = np.asarray(params["layers"]["wq"])
    for r in ranks:
        stage = r["coord"][1]
        slab = r["slab"].numpy()
        assert slab.shape[0] == per
        if "tp" not in sizes:
            np.testing.assert_array_equal(
                slab, wq[stage * per:(stage + 1) * per])
        # the stage-0 rank with the same coordinates on the other axes
        peer = next(p for p in ranks if p["coord"][1] == 0 and
                    p["coord"][2:] == r["coord"][2:])
        for name, g in r["outside"].items():
            assert torch.equal(g, peer["outside"][name]), (name, stage)


@requires_jax_shard_map
def test_pipeline_moe_aux_counted_once_and_token_mask(tmp_path):
    """Switch MoE under pp 2 with a padded tail: the aux of ``apply``
    equals the reference's at pp 1 (bubble ticks add none), and the
    masked loss and its gradients the reference's pipelined ones (the
    mask follows its microbatch through the stages)."""
    cfg = dataclasses.replace(MOE, pp_microbatches=4)
    params = jllama.init(cfg, jax.random.key(0))
    tokens, mask = _inputs(cfg, 3, pad_from=24)
    got, _ = _run_port(tmp_path, "moe", dict(pp=2), cfg, params, tokens,
                       mask)
    _, ref_aux = jax.jit(lambda p: jllama.apply(
        cfg, p, jnp.asarray(tokens, jnp.int32), return_aux=True,
        token_mask=jnp.asarray(mask)))(params)
    assert abs(got["aux"] - float(ref_aux)) < 1e-6, (got["aux"], ref_aux)
    want_loss, want_grads = _jax_loss_grads(cfg, dict(pp=2), params,
                                            tokens, mask)
    assert abs(got["loss"] - want_loss) < LOSS_TOL
    _assert_grads(got["grads"], want_grads, "moe pp2")


def _plain_and_local(cfg, n_stages, n_micro):
    """Loss and grads of the port's plain stack, of the same stack
    through ``pipeline_local`` (every stage in this process), and of a
    wrong schedule that zeroes microbatch 1's input (the control)."""
    tcfg = _tcfg(cfg)
    params = tparams.from_numpy(_np(jllama.init(cfg, jax.random.key(0))),
                                tcfg, device="cpu")
    tokens, mask = _inputs(cfg, 5)
    toks = torch.tensor(tokens)

    def piped(p, drop=None):
        x = tllama.embed(tcfg, p, toks)
        cos, sin = tllama.rope_table(toks.shape[1], tcfg.head_dim,
                                     tcfg.rope_theta)
        layer = tllama._remat(tcfg, lambda h, lp, c, s: tllama._layer(
            tcfg, h, lp, c, s))
        if drop is not None:
            mb = x.shape[0] // n_micro
            x = torch.cat([x[:drop * mb], torch.zeros_like(x[:mb]),
                           x[(drop + 1) * mb:]])
        y, _ = tpipe.pipeline_local(layer, p["layers"], x, (cos, sin),
                                    n_stages=n_stages, n_micro=n_micro)
        y = tllama.rms_norm(y, p["final_norm"], tcfg.norm_eps)
        logits = tllama.lm_logits(tcfg, p, y[:, :-1])
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab_size), toks[:, 1:].reshape(-1))

    def plain(p):
        x, _ = tllama._backbone(tcfg, p, toks)
        logits = tllama.lm_logits(tcfg, p, x[:, :-1])
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab_size), toks[:, 1:].reshape(-1))

    return (value_and_grad(plain, params), value_and_grad(piped, params),
            value_and_grad(lambda p: piped(p, drop=1), params))


def test_local_schedule_matches_plain_stack():
    """All 4 stages in one process over 8 microbatches, as
    ``chip_smoke.py`` phase 11 runs them (the hop a rotation of the
    stages' activations): loss and gradients equal the plain stack's
    within the tolerances above, and a schedule that loses one
    microbatch's input does not (the control phase 11 also runs)."""
    (l0, g0), (l1, g1), (_, bad) = _plain_and_local(CFG, 4, 8)
    assert abs(float(l0) - float(l1)) < LOSS_TOL
    for (name, a), (_, b) in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(b, a, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   msg=name)
    worst = max(float((b - a).abs().max())
                for (_, a), (_, b) in zip(leaves(g0), leaves(bad)))
    assert worst > 1e-3


def test_pipeline_rejects_bad_shapes():
    """The reference's errors, word for word: no pp mesh, layers not
    divisible by the stages, a batch not divisible by the microbatches."""
    x = torch.zeros((4, 8, CFG.dim))
    layers = {"w": torch.zeros((3, 2))}
    errors = []
    with pytest.raises(ValueError, match="pp > 1") as e:
        tpipe.pipeline_layers(lambda h, lp: (h, None), layers, x)
    errors.append(str(e.value))
    with pytest.raises(ValueError, match="not divisible by pp") as e:
        tpipe.pipeline_local(lambda h, lp: (h, None), layers, x,
                             n_stages=2)
    errors.append(str(e.value))
    with pytest.raises(ValueError, match="not divisible by n_micro") as e:
        tpipe.pipeline_local(lambda h, lp: (h, None),
                             {"w": torch.zeros((4, 2))}, x, n_stages=2,
                             n_micro=3)
    errors.append(str(e.value))
    with pytest.raises(ValueError) as e:
        jpipeline_layers(lambda h, lp: (h, 0.0),
                         {"w": jnp.zeros((3, 2))}, jnp.zeros((4, 8, 2)))
    assert errors[0] == str(e.value)
    assert errors[1:] == ["n_layers=3 not divisible by pp=2",
                          "batch=4 not divisible by n_micro=3"]
    assert tpipe.default_microbatches(8, 2) == 4
    assert tpipe.default_microbatches(6, 4) == 6
    assert tpipe.default_microbatches(7, 2) == 1


def _jax_state_from(js, state):
    """The reference's ``TrainState`` holding the port's (gathered)
    params and Adam moments after a step."""
    adam = js.opt_state[1][0]._replace(
        count=jnp.asarray(state["count"], jnp.int32),
        mu=jax.tree.map(jnp.asarray, _np(state["mu"])),
        nu=jax.tree.map(jnp.asarray, _np(state["nu"])))
    opt = (js.opt_state[0], (adam, *js.opt_state[1][1:]))
    return js._replace(step=jnp.asarray(state["step"], jnp.int32),
                       params=jax.tree.map(jnp.asarray,
                                           _np(state["params"])),
                       opt_state=opt)


@requires_jax_shard_map
def test_pipeline_train_steps_match_jax(tmp_path):
    """Three ``make_train_step`` steps of the smoke preset (f32) on pp 2
    against the reference's jitted step on its pp 2 mesh and against the
    port's unsharded step: params and moments at the train tests'
    tolerances (atol 5e-6 + rtol 1e-5, one element in a thousand a param
    up to one lr), the loss at 2e-6 against the port's unsharded step and
    at the pipeline's 1e-5 against the reference's. Each of the
    reference's steps starts from the port's state after the step
    before, and the loss is held looser there because the reference's
    own losses for one state differ by more than 2e-6 between its
    programs: from the port's state after step 2, its pp 2 train step
    reports 6.2769074, its loss alone on one device 6.2769084, on dp 2 x
    fsdp 2 or fsdp 2 x tp 2 6.2769098 (the port's), and its own pp 2
    trajectory, left to run, follows its unsharded one away from its
    dp/fsdp/tp ones (the Adam outlier ``tests/test_torch_parallel.py``
    describes). The last state, saved on pp 2, restores onto no mesh and
    onto pp 2 bit for bit."""
    cfg = tpar.SMOKE
    js, params, mu, nu = tpar._jax_state(cfg)
    batches = tpar._batches(cfg)
    torch.save({"params": params, "mu": mu, "nu": nu,
                "batches": [(torch.tensor(t), torch.tensor(m))
                            for t, m in batches]},
               tmp_path / "train-init.pt")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    workers.launch("train", 2, tmp_path, "pp2", dict(pp=2),
                   dataclasses.asdict(tcfg), 1)
    got = workers.load(tmp_path / "train-pp2.pt")
    assert got["local_shapes"]["layers/wq"][0] == cfg.n_layers // 2
    jmesh = make_mesh(MeshConfig(dp=1, fsdp=1, pp=2), jax.devices()[:2])
    jfn = jstep.make_train_step(cfg, mesh=jmesh)
    batch_sh = NamedSharding(jmesh, P(("dp", "fsdp"), None))
    ts = tparams.train_state_from_numpy(tcfg, params, mu, nu, device="cpu")
    tfn = tstep.make_train_step(tcfg)
    for i, (toks, mask) in enumerate(batches):
        start = js if i == 0 else _jax_state_from(js, got["steps"][i - 1])
        start = jax.device_put(start,
                               jstep.state_shardings(jmesh, cfg, start))
        with use_mesh(jmesh):
            jnext, jm = jfn(start, jax.device_put(toks.astype(np.int32),
                                                  batch_sh),
                            jax.device_put(mask, batch_sh))
        ts, tm = tfn(ts, torch.tensor(toks), torch.tensor(mask))
        step = got["steps"][i]
        for ref_loss, ref_norm, tol in (
                (float(jm["loss"]), float(jm["grad_norm"]), LOSS_TOL),
                (float(tm["loss"]), float(tm["grad_norm"]), 2e-6)):
            assert abs(step["loss"] - ref_loss) < tol, (i, step["loss"],
                                                        ref_loss)
            np.testing.assert_allclose(step["grad_norm"], ref_norm,
                                       rtol=1e-6)
        adam = jnext.opt_state[1][0]
        tpar._assert_state(step, {"params": _np(jnext.params),
                                  "mu": _np(adam.mu), "nu": _np(adam.nu)},
                           f"pp2 vs JAX, step {i}")
        tpar._assert_state(step, {"params": ts.params,
                                  "mu": ts.opt_state.mu,
                                  "nu": ts.opt_state.nu},
                           f"pp2 vs unsharded, step {i}")
    like = tstep.init_train_state(tcfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    back = tckpt.restore(tmp_path / "ckpt-pp2", None, tcfg, like)
    for part, tree in (("params", back.params), ("mu", back.opt_state.mu),
                       ("nu", back.opt_state.nu)):
        for (n, a), (_, b), (_, c) in zip(
                leaves(tree), leaves(got["steps"][-1][part]),
                leaves(got["restored"][part])):
            assert torch.equal(a, b) and torch.equal(a, c), (part, n)
