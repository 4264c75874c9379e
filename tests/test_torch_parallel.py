"""Port parity: ring and Ulysses attention, sharded training, sharded
evaluation and checkpoints across meshes, on gloo CPU ranks against the
JAX package on its 8 virtual CPU devices.

The port's side runs in spawned rank processes
(``tests/torch_parallel_workers.py``), f32 throughout (gloo's bf16
coverage is uneven). Tolerances are the reference tests' own: attention
outputs atol 2e-5 (``tests/test_ring.py``), gradients atol 5e-4; train
steps as ``tests/test_torch_train.py`` holds the unsharded step (loss
2e-6, params and moments atol 5e-6 + rtol 1e-5, the nu tolerance scaled
by 1e-3), with one element in a thousand allowed further: a param as far
as one step's learning rate (3e-4). That is the reference's own sharding
noise: JAX's step on fsdp 2 x tp 2 puts one ``tok_embed`` element of the
smoke preset 1.2e-4 from JAX's unsharded step after the second step, an
Adam update whose gradient is within rounding noise of zero (its
direction, and so an update of up to lr, follows the summation order).
A checkpoint restored onto another mesh, or onto none, is bitwise.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.ops.attention import (  # noqa: E402
    _dense_attention as jdense,
)
from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig,
    make_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu.parallel.ring import (  # noqa: E402
    ring_attention as jring,
)
from service_account_auth_improvements_tpu.parallel.ulysses import (  # noqa: E402
    ulysses_attention as julysses,
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
from service_account_auth_improvements_tpu_torch.utils.tree import leaves  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402
from tests.jaxdrift import requires_jax_shard_map  # noqa: E402

SMOKE = dataclasses.replace(jllama.PRESETS["smoke"], dtype="float32")
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-4


def _qkv(b, s, h, hkv, d=16):
    ks = jax.random.split(jax.random.key(3), 3)
    return tuple(jax.random.normal(k, shape, jnp.float32) for k, shape in
                 zip(ks, ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))))


def _objective(o):
    return jnp.sum(o * jnp.cos(o))


# name: (port ranks = sp, JAX mesh, shapes b, s, h, hkv) — the reference
# tests' setups: ring at sp 4 on (sp 4, tp 2), Ulysses at sp 2
ATTENTION = {
    "ring": (4, dict(dp=1, fsdp=1, sp=4, tp=2), 8, (2, 64, 4, 2), jring),
    "ulysses": (2, dict(dp=1, fsdp=1, sp=2, tp=1), 2, (2, 64, 4, 2),
                julysses),
}


@requires_jax_shard_map
@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_sp_attention_matches_dense_and_jax(name, tmp_path):
    """Forward and gradients of ring / Ulysses on local sequence chunks,
    causal and not, against dense attention and the reference's sharded
    entry; the DTensor entry against the local body; Ulysses' head-count
    error word for word."""
    sp, mesh_kw, n_dev, shape, jfn = ATTENTION[name]
    q, k, v = _qkv(*shape)
    torch.save(tuple(torch.tensor(np.asarray(a)) for a in (q, k, v)),
               tmp_path / "qkv.pt")
    workers.launch("attention", sp, tmp_path, [name])
    ranks = [workers.load(tmp_path / f"attention-r{r}.pt")
             for r in range(sp)]
    jmesh = make_mesh(MeshConfig(**mesh_kw), jax.devices()[:n_dev])
    scale = 16 ** -0.5  # head dim 16
    for causal in (True, False):
        # the port's chunks, joined along the sequence in rank order
        got = [torch.cat([r[(name, causal)][i] for r in ranks], dim=1)
               .numpy() for i in range(4)]
        dense = jdense(q, k, v, scale, causal=causal)
        dgrads = jax.grad(lambda *a: _objective(jdense(
            *a, scale, causal=causal)), argnums=(0, 1, 2))(q, k, v)
        with use_mesh(jmesh):
            want = jax.jit(functools.partial(jfn, causal=causal))(q, k, v)
            jgrads = jax.jit(jax.grad(
                lambda *a: _objective(jfn(*a, causal=causal)),
                argnums=(0, 1, 2)))(q, k, v)
        for ref in (dense, want):
            np.testing.assert_allclose(got[0], np.asarray(ref),
                                       atol=OUT_ATOL)
        for i, wrt in enumerate("qkv"):
            for ref in (dgrads, jgrads):
                np.testing.assert_allclose(
                    got[1 + i], np.asarray(ref[i]), atol=GRAD_ATOL,
                    err_msg=f"{name} causal={causal} d{wrt}")
    local = torch.cat([r[(name, True)][0] for r in ranks], dim=1)
    for r in ranks:
        torch.testing.assert_close(r[(name, "dtensor")], local, rtol=0,
                                   atol=0)
    if name == "ulysses":  # 3 q heads, 1 kv head: not divisible by sp
        with use_mesh(jmesh), pytest.raises(ValueError) as err:
            jax.jit(julysses)(q[:, :, :3], k[:, :, :1], v[:, :, :1])
        assert ranks[0]["ulysses_error"] == str(err.value)


def _jax_state(cfg):
    js = jstep.init_train_state(cfg, jax.random.key(0))
    adam = js.opt_state[1][0]
    as_np = functools.partial(jax.tree.map,
                              lambda a: np.asarray(a, np.float32))
    return js, as_np(js.params), as_np(adam.mu), as_np(adam.nu)


def _batches(cfg, n=3, b=8, s=32):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
        out.append((toks, np.ones_like(toks, dtype=np.int32)))
    return out


def _assert_close(got, want, atol, rtol, loose, what):
    """Every element within ``loose``, and all but one in a thousand
    within ``atol + rtol·|want|`` (as tests/test_torch_train.py)."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert bad.mean() <= 1e-3, (
        f"{what}: {int(bad.sum())} of {bad.size} elements outside atol "
        f"{atol} rtol {rtol}")
    np.testing.assert_allclose(got, want, atol=loose, rtol=rtol,
                               err_msg=what)


LR = 3e-4  # make_optimizer's default


def _assert_state(got: dict, want: dict, what: str) -> None:
    """Params and moments: the unsharded train test's tolerances, a
    param outlier (one in a thousand) up to one step's lr."""
    for part in ("params", "mu", "nu"):
        g = dict(leaves(got[part]))
        w = dict(leaves(want[part]))
        assert g.keys() == w.keys()
        for name in g:
            tol = 5e-6 * (1e-3 if part == "nu" else 1)
            loose = LR if part == "params" else tol
            _assert_close(np.asarray(g[name], np.float32),
                          np.asarray(w[name], np.float32), tol, 1e-5,
                          loose, f"{what} {part}/{name}")


# name: (port mesh, JAX MeshConfig, devices, config changes, grad_accum)
SHAPES = {
    "dp2-fsdp2": (dict(dp=2, fsdp=2), dict(dp=2, fsdp=2), 4, {}, 1),
    "dp2-fsdp2-accum2": (dict(dp=2, fsdp=2), dict(dp=2, fsdp=2), 4, {}, 2),
    "fsdp2-tp2": (dict(fsdp=2, tp=2), dict(dp=1, fsdp=2, tp=2), 4, {}, 1),
    # the switch MoE FFN: experts column/row parallel over tp, the aux
    # loss a mean over every rank's routing groups
    "fsdp2-tp2-moe": (dict(fsdp=2, tp=2), dict(dp=1, fsdp=2, tp=2), 4,
                      {"moe_experts": 4}, 1),
    "sp2-tp2-ring": (dict(sp=2, tp=2), dict(dp=1, fsdp=1, sp=2, tp=2), 4,
                     {"attn_impl": "ring"}, 1),
    "sp2-ulysses": (dict(sp=2), dict(dp=1, fsdp=1, sp=2), 2,
                    {"attn_impl": "ulysses"}, 1),
    # expert parallelism: each ep rank runs its two of the four experts
    "fsdp2-ep2-moe": (dict(fsdp=2, ep=2), dict(dp=1, fsdp=2, ep=2), 4,
                      {"moe_experts": 4}, 1),
    "tp2-ep2-moe-top2": (dict(tp=2, ep=2), dict(dp=1, fsdp=1, tp=2, ep=2),
                         4, {"moe_experts": 4, "moe_top_k": 2}, 1),
    # MoE routing groups over a sequence split over sp
    "sp2-moe": (dict(sp=2), dict(dp=1, fsdp=1, sp=2), 2,
                {"moe_experts": 4}, 1),
}


@requires_jax_shard_map
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sharded_train_steps_match_jax(name, tmp_path):
    """Three ``make_train_step`` steps of the smoke preset (f32) on a
    gloo mesh against the reference's jitted step on the same mesh shape
    and against the port's unsharded step, after every step: loss, grad
    norm, params and both Adam moments."""
    sizes, jmesh_kw, n_dev, change, accum = SHAPES[name]
    cfg = dataclasses.replace(SMOKE, **change)
    js, params, mu, nu = _jax_state(cfg)
    batches = _batches(cfg)
    torch.save({"params": params, "mu": mu, "nu": nu,
                "batches": [(torch.tensor(t), torch.tensor(m))
                            for t, m in batches]},
               tmp_path / "train-init.pt")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    world = int(np.prod(list(sizes.values())))
    workers.launch("train", world, tmp_path, name, sizes,
                   dataclasses.asdict(tcfg), accum)
    got = workers.load(tmp_path / f"train-{name}.pt")
    for r in range(world):  # every rank reports the same global loss
        assert workers.load(tmp_path / f"train-{name}-loss-r{r}.pt") == \
            [s["loss"] for s in got["steps"]]
    # the reference, partitioned over the same mesh shape
    jmesh = make_mesh(MeshConfig(**jmesh_kw), jax.devices()[:n_dev])
    js = jax.device_put(js, jstep.state_shardings(jmesh, cfg, js))
    jfn = jstep.make_train_step(cfg, mesh=jmesh, grad_accum=accum)
    batch_sh = NamedSharding(jmesh, P(("dp", "fsdp"), None))
    # the port's unsharded step
    ts = tparams.train_state_from_numpy(tcfg, params, mu, nu, device="cpu")
    tfn = tstep.make_train_step(tcfg, grad_accum=accum)
    for i, (toks, mask) in enumerate(batches):
        with use_mesh(jmesh):
            js, jm = jfn(js, jax.device_put(toks.astype(np.int32), batch_sh),
                         jax.device_put(mask, batch_sh))
        ts, tm = tfn(ts, torch.tensor(toks), torch.tensor(mask))
        step = got["steps"][i]
        assert step["step"] == step["count"] == i + 1
        for ref_loss, ref_norm in ((float(jm["loss"]), float(
                jm["grad_norm"])), (float(tm["loss"]), float(
                tm["grad_norm"]))):
            assert abs(step["loss"] - ref_loss) < 2e-6, (name, i)
            np.testing.assert_allclose(step["grad_norm"], ref_norm,
                                       rtol=1e-6)
        adam = js.opt_state[1][0]
        jax_state = {part: jax.tree.map(
            lambda a: np.asarray(a, np.float32), tree)
            for part, tree in (("params", js.params), ("mu", adam.mu),
                               ("nu", adam.nu))}
        _assert_state(step, jax_state, f"{name} vs JAX, step {i}")
        _assert_state(step, {"params": ts.params, "mu": ts.opt_state.mu,
                             "nu": ts.opt_state.nu},
                      f"{name} vs unsharded, step {i}")
    # the state's layout is the rules': e.g. wq [L, embed, heads] splits
    # dim 0 over pp, 1 over fsdp and 2 over tp
    wq = got["placements"]["layers/wq"]
    assert wq == [None, 0, 1, None, 2, None]
    if "moe_experts" in change:  # the experts split over ep
        assert got["placements"]["layers/moe_gate"][5] == 1
        assert got["local_shapes"]["layers/moe_gate"][1] == \
            4 // sizes.get("ep", 1)
    assert got["local_shapes"]["layers/wq"][0] == \
        cfg.n_layers // sizes.get("pp", 1)
    # the last state, saved collectively on this mesh, restores onto no
    # mesh and onto this mesh bit for bit
    like = tstep.init_train_state(tcfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    back = tckpt.restore(tmp_path / f"ckpt-{name}", None, tcfg, like)
    last = got["steps"][-1]
    assert back.step == 3 and back.opt_state.count == 3
    for part, tree in (("params", back.params), ("mu", back.opt_state.mu),
                       ("nu", back.opt_state.nu)):
        for (n, a), (_, b), (_, c) in zip(leaves(tree), leaves(last[part]),
                                          leaves(got["restored"][part])):
            assert torch.equal(a, b) and torch.equal(a, c), (name, part, n)


def test_fit_checkpoint_restores_across_meshes(tmp_path):
    """``fit`` on dp 2 x fsdp 2 (world 4) with periodic eval writes a
    checkpoint that restores bitwise onto fsdp 2 x tp 2, params only
    too, and onto no mesh; rank 0 alone logs; the run's losses and eval
    equal an unsharded ``fit``'s within the train tolerances."""
    cfg = tllama.LlamaConfig(**dataclasses.asdict(SMOKE))
    workers.launch("fit_restore", 4, tmp_path, dataclasses.asdict(cfg))
    ranks = [workers.load(tmp_path / f"fit-r{r}.pt") for r in range(4)]
    assert tckpt.latest_step(tmp_path / "run") == 3
    assert any("saved checkpoint step 2" in line
               for line in ranks[0]["lines"])
    assert all(not r["lines"] for r in ranks[1:])
    def same(h):  # tokens/s is each rank's own clock
        return [{k: v for k, v in rec.items() if k != "tokens_per_sec"}
                for rec in h]

    assert all(same(r["history"]) == same(ranks[0]["history"])
               for r in ranks)
    on_disk = {"params": torch.load(tmp_path / "run" / "3" / "params.pt")}
    opt = torch.load(tmp_path / "run" / "3" / "opt.pt")
    on_disk.update(mu=opt["mu"], nu=opt["nu"])
    plain_like = tstep.init_train_state(cfg, torch.Generator().manual_seed(7),
                                        device="cpu")
    plain = tckpt.restore(tmp_path / "run", None, cfg, plain_like)
    assert plain.step == 3 and plain.opt_state.count == 3
    for r in ranks:
        assert r["restored"]["step"] == 3 and r["restored"]["count"] == 3
        assert r["placed"]["layers/wq"] == [None, 0, 1, None, 2, None]
        for part in ("params", "mu", "nu"):
            for (name, a), (_, b), (_, c), (_, d) in zip(
                    leaves(on_disk[part]), leaves(r["fitted"][part]),
                    leaves(r["restored"][part]),
                    leaves(getattr(plain, "params") if part == "params"
                           else getattr(plain.opt_state, part))):
                for other in (b, c, d):
                    assert torch.equal(a, other), (part, name)
        for (name, a), (_, b) in zip(leaves(on_disk["params"]),
                                     leaves(r["params_only"])):
            assert torch.equal(a, b), name
    # the same run without a mesh
    from service_account_auth_improvements_tpu_torch.train.data import (
        DataConfig,
    )
    from service_account_auth_improvements_tpu_torch.train.loop import (
        LoopConfig,
        fit,
    )

    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 4096).astype(np.int32)
    eval_data = [tokens[:128].reshape(4, 32)]
    state, history = fit(cfg, None, tokens, DataConfig(batch=4, seq=32),
                         LoopConfig(steps=3, log_every=1, eval_every=3),
                         log=lambda *a: None, eval_data=eval_data,
                         device="cpu")
    sharded = ranks[0]["history"]
    assert [h["step"] for h in history] == [h["step"] for h in sharded]
    for h, s in zip(history, sharded):
        for key in ("loss", "eval_loss"):
            if key in h:
                assert abs(h[key] - s[key]) < 2e-6, (key, h, s)
        if "eval_tokens" in h:
            assert h["eval_tokens"] == s["eval_tokens"]
    _assert_state(ranks[0]["fitted"], {
        "params": state.params, "mu": state.opt_state.mu,
        "nu": state.opt_state.nu}, "fit dp2 x fsdp2 vs unsharded")
    assert any("eval_loss" in h for h in sharded)


@requires_jax_shard_map
def test_vocab_parallel_embedding_and_loss_match_jax(tmp_path):
    """On tp 2 the vocabulary stays split: the masked embedding lookup
    summed over tp is the reference's gather bit for bit, the chunked
    f32 loss (vocab-parallel logsumexp and target logit) and every
    gradient match the reference's on its tp 2 mesh (loss 1e-5, grads
    atol 2e-5 + rtol 1e-4, f32), and each tp rank's ``lm_head``
    gradient is its own vocab shard of the whole one."""
    cfg = dataclasses.replace(SMOKE, loss_chunk=8, iota_embed=True)
    params = jllama.init(cfg, jax.random.key(0))
    (toks, mask), = _batches(cfg, n=1, b=4, s=32)
    mask[:, 24:] = 0
    as_np = functools.partial(jax.tree.map,
                              lambda a: np.asarray(a, np.float32))
    torch.save({"params": as_np(params), "tokens": torch.tensor(toks),
                "mask": torch.tensor(mask)}, tmp_path / "grads-init.pt")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    workers.launch("model_grads", 2, tmp_path, "tp2", dict(tp=2),
                   dataclasses.asdict(tcfg))
    got = workers.load(tmp_path / "grads-tp2.pt")
    jmesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=2), jax.devices()[:2])
    with use_mesh(jmesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jllama.next_token_loss(cfg, p, toks.astype(np.int32),
                                             mask)))(params)
    assert abs(got["loss"] - float(loss)) < 1e-5
    want = dict(leaves(as_np(grads)))
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=2e-5,
                                   rtol=1e-4, err_msg=name)
    table = np.asarray(params["tok_embed"], np.float32)
    half = cfg.vocab_size // 2
    for r in range(2):
        rank = workers.load(tmp_path / f"grads-tp2-r{r}.pt")
        np.testing.assert_array_equal(rank["embed"].numpy(), table[toks])
        head = rank["lm_head_grad"]
        assert tuple(head.shape) == (cfg.dim, half)
        torch.testing.assert_close(
            head, got["grads"]["lm_head"][:, r * half:(r + 1) * half],
            rtol=0, atol=0)
