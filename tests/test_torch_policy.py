"""Port parity: ``controlplane/scheduler/policy/{features,model,train}.py``
against the JAX package's, on the CPU.

The featurizer's arrays are bit-equal to the reference's; the scorer,
``choose_index``, the loss and its gradients agree with the reference's
numpy and ``jax.numpy`` forward and ``jax.value_and_grad``; both trainers,
resumed from one JAX-written step-0 ``policy.npz`` (the bridge for JAX's
init, which torch cannot draw), follow one trajectory; and the checkpoint
round-trips both ways, into JAX's trainer and the numpy
``PolicyChooser``.

The trainers run on ``chip_smoke.policy_journal``'s rows (16 pools of
mixed sizes, demands of one chip to 16 hosts), whose encoded features
span every input direction but one. ``tests/test_schedpolicy.py``'s
``_synth_journal`` (4 equal pools, one demand) encodes to two distinct
pool vectors, so most of w1 gets no gradient but rounding noise there,
which Adam (eps 1e-8) turns into steps of ~lr in either stack: its rows
are used for the featurizer and the scorer, where no training is
involved. Everywhere, b3 is held through the policy's probabilities and
not by value: it adds one constant to every pool's score, which the
softmax ignores, so its exact gradient is 0 and each stack moves it by
its own rounding noise.

Run as a script (``python tests/test_torch_policy.py``) it prints how far
300 steps of the reference differ from themselves (jitted against op by
op) and from the port's CPU run, in units of atol 1e-5 + rtol 1e-4; the
card's check in ``chip_smoke.py`` is set from that.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.controlplane.scheduler.policy import (  # noqa: E402,E501
    features as jfeatures,
    model as jmodel,
    train as jtrain,
)
from service_account_auth_improvements_tpu.controlplane.scheduler.policy.serve import (  # noqa: E402,E501
    PolicyChooser,
)
from service_account_auth_improvements_tpu.train.step import (  # noqa: E402
    make_optimizer as jmake_optimizer,
)
from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E402,E501
    features as tfeatures,
    model as tmodel,
    train as ttrain,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (  # noqa: E402
    value_and_grad,
)
from tests.test_schedpolicy import (  # noqa: E402
    _demand,
    _pools,
    _row,
    _synth_journal,
)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the train tests' f32 tolerances (tests/test_torch_train.py): losses, and
# params and both moments
LOSS_TOL = 2e-6
ATOL, RTOL = 5e-6, 1e-5
# the policy two param sets give every example (its probabilities over the
# feasible pools; what b3 is held through), for params within ATOL/RTOL
PROBS_ATOL = 1e-5
ARRAYS = ("pool_feats", "glob", "mask", "label", "ttp_s")


@pytest.fixture(autouse=True)
def one_thread():
    """The scorer's tensors are tiny: with the suite's workers sharing the
    cores, more intra-op threads only contend, and the loops slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_dataset(got: dict, want: dict) -> None:
    assert got["dropped"] == want["dropped"]
    for k in ARRAYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("journal,seed", [
    ("synth", 0), ("synth", 1), ("synth", 2), ("chip", 0), ("chip", 5)])
def test_dataset_is_bit_equal_to_the_reference(journal, seed):
    entries = (_synth_journal(160, seed) if journal == "synth"
               else chip_smoke.policy_journal(300, seed))
    _same_dataset(tfeatures.dataset(entries), jfeatures.dataset(entries))
    for e in entries:
        assert tfeatures.check_row(e["attrs"]) == jfeatures.check_row(
            e["attrs"]) == []


def test_dropped_rows_and_empty_journal_match_the_reference():
    pools, demand = _pools(), _demand()
    used = {"p0": 16, "p1": 0, "p2": 0, "p3": 16}
    good = _row(pools, used, demand, "p1")
    wide = {f"w{i}": pools["p0"] for i in range(tfeatures.MAX_POOLS + 1)}
    wrong_schema = _row(pools, used, demand, "p1")
    wrong_schema["attrs"]["schema"] = "sched-journal/v0"
    missing = _row(pools, used, demand, "p1")
    del missing["attrs"]["queue_depth"]
    rider = _row(pools, used, demand, "p1", park_reason=3)
    mistyped = _row(pools, used, demand, "p1")
    mistyped["attrs"]["feasible"] = "p1"
    not_placement = {**good, "kind": "park"}
    rows = [good, _row(pools, used, demand, "p0"),        # outside mask
            _row(pools, used, demand, "nope"),             # unknown pool
            _row(wide, {}, demand, "w0"),                  # too wide
            wrong_schema, missing, rider, mistyped, not_placement,
            _row(pools, {}, demand, "p2", ttp=None)]       # ttp -> 0.0
    for e in rows:
        assert tfeatures.check_row(e["attrs"]) == jfeatures.check_row(
            e["attrs"])
        got, want = tfeatures.example_from(e), jfeatures.example_from(e)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.label, got.ttp_s, got.pools) == (
                want.label, want.ttp_s, want.pools)
    d = tfeatures.dataset(rows)
    _same_dataset(d, jfeatures.dataset(rows))
    assert d["label"].shape[0] == 2 and d["dropped"] == 7
    _same_dataset(tfeatures.dataset([]), jfeatures.dataset([]))
    for name in ("JOURNAL_SCHEMA", "PLACEMENT_FIELDS", "RIDER_FIELDS",
                 "MAX_POOLS", "POOL_FEATURES", "GLOBAL_FEATURES"):
        assert getattr(tfeatures, name) == getattr(jfeatures, name), name


def test_journal_jsonl_loads_as_the_reference(tmp_path):
    entries = _synth_journal(20, 4)
    path = tmp_path / "j.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in entries) + "\n\n")
    got = tfeatures.load_journal_jsonl(str(path))
    assert got == jfeatures.load_journal_jsonl(str(path)) == entries
    assert tfeatures.placement_rows(got) == jfeatures.placement_rows(got)


def _ref_params(seed=0, hidden=tmodel.DEFAULT_HIDDEN) -> dict:
    return {k: np.asarray(v) for k, v in jmodel.init_params(
        jax.random.key(seed), hidden=hidden).items()}


def _states(n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, tfeatures.MAX_POOLS,
                             tfeatures.POOL_FEATURES)).astype(np.float32)
    glob = rng.normal(size=(n, tfeatures.GLOBAL_FEATURES)).astype(
        np.float32)
    mask = rng.random((n, tfeatures.MAX_POOLS)) < 0.4
    mask[:3] = False  # all-masked rows
    mask[3, 7] = True
    mask[3, :7] = mask[3, 8:] = False  # exactly one feasible pool
    return feats, glob, mask


def test_forward_and_choose_index_match_the_reference():
    for seed, hidden in ((0, 32), (1, 8)):
        np_params = _ref_params(seed, hidden)
        params = tmodel.params_from_numpy(np_params, "cpu")
        feats, glob, mask = _states(40, seed)
        got = tmodel.forward(params, torch.tensor(feats), torch.tensor(glob),
                             torch.tensor(mask)).numpy()
        np.testing.assert_allclose(
            got, jmodel.forward(np_params, feats, glob, mask, xp=np),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got, np.asarray(jmodel.forward(
                {k: jnp.asarray(v) for k, v in np_params.items()},
                jnp.asarray(feats), jnp.asarray(glob), jnp.asarray(mask),
                xp=jnp)), rtol=0, atol=1e-6)
        idx, scores, conf = tmodel.choose_index(
            params, torch.tensor(feats), torch.tensor(glob),
            torch.tensor(mask))
        for i in range(len(feats)):
            want_idx, want_scores, want_conf = jmodel.choose_index(
                np_params, feats[i], glob[i], mask[i])
            assert int(idx[i]) == want_idx
            np.testing.assert_allclose(scores[i].numpy(), want_scores,
                                       rtol=0, atol=1e-6)
            assert abs(float(conf[i]) - want_conf) <= 1e-6
            if not mask[i].any():
                assert int(idx[i]) == -1 and float(conf[i]) == 0.0
            else:
                assert mask[i, int(idx[i])]
        assert float(conf[3]) == pytest.approx(1.0, abs=1e-6)
    for name in ("IN_FEATURES", "DEFAULT_HIDDEN", "NEG_INF", "PARAM_KEYS"):
        assert getattr(tmodel, name) == getattr(jmodel, name), name


def _ref_loss(params, pool_feats, glob, mask, label, weight):
    """The reference's loss (``policy/train.py`` ``make_policy_step``'s
    ``loss_fn``, lines 75-81), which it keeps inside the step."""
    scores = jmodel.forward(params, pool_feats, glob, mask, xp=jnp)
    logp = jax.nn.log_softmax(scores, axis=-1)
    picked = jnp.take_along_axis(
        logp, label[:, None].astype(jnp.int32), axis=-1)[:, 0]
    return -(weight * picked).sum() / jnp.maximum(weight.sum(), 1e-6)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_loss_and_grads_match_jax(zero_weights):
    data = tfeatures.dataset(chip_smoke.policy_journal(64, 2))
    weight = (1.0 / (1.0 + data["ttp_s"])).astype(np.float32)
    if zero_weights:  # the max(sum, 1e-6) floor
        weight[:] = 0.0
    batch = [data["pool_feats"], data["glob"], data["mask"], data["label"],
             weight]
    np_params = _ref_params(3)
    want_loss, want_grads = jax.value_and_grad(_ref_loss)(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        *map(jnp.asarray, batch))
    tbatch = [torch.as_tensor(a) for a in batch]
    tbatch[3] = tbatch[3].long()
    loss, grads = value_and_grad(
        ttrain.policy_loss, tmodel.params_from_numpy(np_params, "cpu"),
        *tbatch)
    assert abs(float(loss) - float(want_loss)) <= 1e-6
    for k in tmodel.PARAM_KEYS:
        np.testing.assert_allclose(grads[k].numpy(), want_grads[k],
                                   rtol=0, atol=1e-6, err_msg=k)


def _step0_checkpoint(workdir, seed=0, hidden=tmodel.DEFAULT_HIDDEN):
    """JAX's init, saved by JAX's trainer as a step-0 ``policy.npz``: the
    bridge both trainers resume from."""
    params = jmodel.init_params(jax.random.key(seed), hidden=hidden)
    opt = jmake_optimizer(learning_rate=1e-2, weight_decay=0.0)
    jtrain.save_checkpoint(str(workdir), jtrain.PolicyState(
        jnp.zeros((), jnp.int32), params, opt.init(params)), hidden)


def _jax_moments(state) -> tuple:
    """(count, mu, nu) of JAX's optimizer state, by leaf order."""
    leaves = jax.tree_util.tree_leaves(state.opt_state)
    assert len(leaves) == ttrain.N_OPT_LEAVES
    k = len(ttrain.LEAF_ORDER)
    mu = dict(zip(ttrain.LEAF_ORDER, map(np.asarray, leaves[1:1 + k])))
    nu = dict(zip(ttrain.LEAF_ORDER, map(np.asarray, leaves[1 + k:])))
    return int(leaves[0]), mu, nu


def _probs(params: dict, data: dict) -> np.ndarray:
    """The probabilities ``params`` give the feasible pools of every
    example."""
    with torch.no_grad():
        scores = tmodel.forward(
            {k: torch.tensor(np.asarray(v)) for k, v in params.items()},
            *(torch.as_tensor(data[k]) for k in ("pool_feats", "glob",
                                                  "mask")))
        probs = torch.softmax(scores, -1)
    return probs[torch.as_tensor(data["mask"])].numpy()


def _assert_same_run(jstate, tstate, data) -> None:
    """JAX's state against the port's: count, both moments and every
    param but b3 at the train tests' tolerances, and b3 through the
    masked log-probabilities."""
    count, mu, nu = _jax_moments(jstate)
    assert count == tstate.opt_state.count == int(jstate.step) == (
        tstate.step)
    for k in tmodel.PARAM_KEYS:
        for what, want, got in (("mu", mu, tstate.opt_state.mu),
                                ("nu", nu, tstate.opt_state.nu)):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what}/{k}")
        if k != "b3":
            np.testing.assert_allclose(
                tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(
        _probs(tstate.params, data), _probs(jstate.params, data), rtol=0,
        atol=PROBS_ATOL)


@pytest.fixture(scope="module")
def chip_data():
    return tfeatures.dataset(chip_smoke.policy_journal(512, 0))


def test_fit_matches_jax_over_60_steps(tmp_path, chip_data):
    """60 steps of each trainer from one bridged step-0 state: every loss
    within 2e-6; params, mu and nu at the train tests' tolerances."""
    for who in ("jax", "port"):
        _step0_checkpoint(tmp_path / who)
    kw = dict(seed=0, steps=60, batch_size=64, log_every=1)
    jstate, jhist = jtrain.fit_policy(chip_data, workdir=str(
        tmp_path / "jax"), **kw)
    tstate, thist = ttrain.fit_policy(chip_data, workdir=str(
        tmp_path / "port"), device="cpu", **kw)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(thist, jhist)) <= LOSS_TOL
    _assert_same_run(jstate, tstate, chip_data)


def test_port_checkpoint_is_the_reference_layout_and_serves(tmp_path,
                                                            chip_data):
    """A port-written ``policy.npz`` has JAX's keys, shapes, dtypes and
    13-leaf order; JAX's ``load_checkpoint`` reads it; the numpy
    ``PolicyChooser`` picks what the port's ``choose_index`` picks."""
    for who in ("jax", "port"):
        _step0_checkpoint(tmp_path / who)
    kw = dict(seed=1, steps=30, batch_size=32, log_every=0)
    jtrain.fit_policy(chip_data, workdir=str(tmp_path / "jax"), **kw)
    tstate, _ = ttrain.fit_policy(chip_data, workdir=str(tmp_path / "port"),
                                  device="cpu", **kw)
    path = str(tmp_path / "port" / ttrain.CKPT_FILE)
    with np.load(tmp_path / "jax" / jtrain.CKPT_FILE) as j, \
            np.load(path) as t:
        assert sorted(t.files) == sorted(j.files)
        assert len([k for k in t.files if k.startswith("opt/")]) == 13
        for k in j.files:
            assert (t[k].dtype, t[k].shape) == (j[k].dtype, j[k].shape), k
            if t[k].dtype.kind in "iuU":
                assert t[k] == j[k], k
        # the leaf order: opt/1-6 are mu, opt/7-12 nu, each b1 b2 b3 w1
        # w2 w3, as the values show
        for i, k in enumerate(ttrain.LEAF_ORDER * 2, start=1):
            moments = tstate.opt_state.mu if i <= 6 else tstate.opt_state.nu
            assert np.array_equal(t[f"opt/{i}"], moments[k].numpy()), i
    loaded = jtrain.load_checkpoint(path)
    assert loaded["step"] == 30 and loaded["hidden"] == 32
    for k in tmodel.PARAM_KEYS:
        assert np.array_equal(loaded["params"][k], tstate.params[k].numpy())
    chooser = PolicyChooser(path, min_confidence=0.0)
    pools = _pools(6)
    demand = _demand()
    rng = np.random.default_rng(0)
    decided = 0
    for _ in range(40):
        used = {p: int(rng.choice([0, 4, 8, 16])) for p in pools}
        feas = [p for p in sorted(pools)
                if pools[p].total_chips - used[p] >= demand.total_chips]
        depth = int(rng.integers(0, 9))
        choice = chooser.choose(pools, used, demand, feas,
                                queue_depth=depth)
        if not feas:
            assert choice is None
            continue
        free = {p: pools[p].total_chips - used[p] for p in pools}
        total = {p: pools[p].total_chips for p in pools}
        feats, glob, mask, order = tfeatures.encode_state(
            free, total, feas, demand.total_chips, demand.num_hosts, depth)
        idx, _, _ = tmodel.choose_index(
            tstate.params, torch.tensor(feats), torch.tensor(glob),
            torch.tensor(mask))
        assert choice.pool == order[int(idx)]
        decided += 1
    assert decided > 10


def test_port_checkpoint_resumes_in_jax_with_its_moments(tmp_path,
                                                          chip_data):
    """The port trains 30 steps from the bridge; JAX's ``fit_policy``
    resumes that file to 60 steps, and equals the port's own resume to
    60: the moments came through, not a fresh start."""
    _step0_checkpoint(tmp_path / "port")
    kw = dict(seed=2, batch_size=64, log_every=1)
    ttrain.fit_policy(chip_data, steps=30, workdir=str(tmp_path / "port"),
                      device="cpu", **kw)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jstate, jhist = jtrain.fit_policy(chip_data, steps=60, workdir=str(
        tmp_path / "jax"), **kw)
    tstate, thist = ttrain.fit_policy(chip_data, steps=60, workdir=str(
        tmp_path / "port"), device="cpu", **kw)
    assert len(jhist) == len(thist) == 30
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(thist, jhist)) <= LOSS_TOL
    _assert_same_run(jstate, tstate, chip_data)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, chip_data):
    """The reverse: JAX trains 30 steps from the bridge; the port resumes
    its file to 60 and equals JAX's own resume."""
    _step0_checkpoint(tmp_path / "jax")
    kw = dict(seed=3, batch_size=64, log_every=1)
    jtrain.fit_policy(chip_data, steps=30, workdir=str(tmp_path / "jax"),
                      **kw)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    logs = []
    tstate, thist = ttrain.fit_policy(chip_data, steps=60, workdir=str(
        tmp_path / "port"), device="cpu", log=logs.append, **kw)
    jstate, jhist = jtrain.fit_policy(chip_data, steps=60, workdir=str(
        tmp_path / "jax"), **kw)
    assert logs[0] == "resumed from step 30"
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(thist, jhist)) <= LOSS_TOL
    _assert_same_run(jstate, tstate, chip_data)


def _bits(state) -> list:
    opt = state.opt_state
    return [state.step, opt.count] + [
        t for tree in (state.params, opt.mu, opt.nu)
        for t in (tree[k] for k in tmodel.PARAM_KEYS)]


def _bit_equal(a, b) -> bool:
    return all((x == y) if isinstance(x, int) else torch.equal(x, y)
               for x, y in zip(_bits(a), _bits(b), strict=True))


def test_resume_is_the_uninterrupted_run_bit_for_bit(tmp_path, chip_data):
    kw = dict(seed=0, batch_size=32, log_every=5, device="cpu")
    wd = str(tmp_path / "resume")
    _, first = ttrain.fit_policy(chip_data, steps=25, workdir=wd, **kw)
    assert ttrain.latest_step(wd) == 25
    resumed, rest = ttrain.fit_policy(chip_data, steps=50, workdir=wd, **kw)
    straight, hist = ttrain.fit_policy(chip_data, steps=50, **kw)
    assert _bit_equal(resumed, straight)
    assert first + rest == hist
    # the saved file is the state, and a run with nothing left to do
    # leaves it untouched
    path = os.path.join(wd, ttrain.CKPT_FILE)
    loaded = ttrain.load_checkpoint(path)
    for k in tmodel.PARAM_KEYS:
        assert np.array_equal(loaded["params"][k],
                              straight.params[k].numpy())
    before = os.stat(path).st_mtime_ns
    again, _ = ttrain.fit_policy(chip_data, steps=50, workdir=wd, **kw)
    assert os.stat(path).st_mtime_ns == before and again.step == 50


def test_checkpoint_hidden_overrides_the_argument(tmp_path, chip_data):
    """As the reference: a resumed run takes the checkpoint's width."""
    _step0_checkpoint(tmp_path, seed=5, hidden=8)
    state, _ = ttrain.fit_policy(chip_data, steps=3, batch_size=8,
                                 hidden=32, workdir=str(tmp_path),
                                 log_every=0, device="cpu")
    assert state.params["w2"].shape == (8, 8)
    assert ttrain.load_checkpoint(str(tmp_path / ttrain.CKPT_FILE))[
        "hidden"] == 8


def test_fixed_seed_repeats_and_another_seed_diverges(chip_data):
    kw = dict(steps=40, batch_size=16, log_every=10, device="cpu")
    s1, h1 = ttrain.fit_policy(chip_data, seed=3, **kw)
    s2, h2 = ttrain.fit_policy(chip_data, seed=3, **kw)
    assert _bit_equal(s1, s2) and h1 == h2
    s3, _ = ttrain.fit_policy(chip_data, seed=4, **kw)
    assert not any(torch.equal(s1.params[k], s3.params[k])
                   for k in ("w1", "w2", "w3"))


def test_cli_writes_the_checkpoint_and_refuses(tmp_path, monkeypatch,
                                               capsys):
    path = tmp_path / "j.jsonl"
    path.write_text("".join(json.dumps(e) + "\n"
                            for e in chip_smoke.policy_journal(40, 1)))
    args = ["--journal", str(path), "--workdir", str(tmp_path / "wd"),
            "--steps", "20"]
    assert ttrain.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    record = json.loads(out[out.index("{"):])
    assert (record["examples"], record["dropped_rows"], record["steps"]) == (
        40, 0, 20)
    assert record["checkpoint"] == str(tmp_path / "wd" / ttrain.CKPT_FILE)
    assert ttrain.latest_step(str(tmp_path / "wd")) == 20
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty training set"):
        ttrain.train_from_journal(str(empty), str(tmp_path / "wd2"),
                                  device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ttrain.main(args),
                 lambda: tmodel.init_params(generator=torch.Generator()),
                 lambda: tmodel.params_from_numpy(_ref_params())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _spread(steps: int = 300, rows: int = 4096, batch: int = 64) -> dict:
    """For ``python tests/test_torch_policy.py``: 300 steps of the JAX
    trainer jitted, op by op (``jax.disable_jit``) and of the port on the
    CPU, from one bridged state on ``chip_smoke.policy_journal``; for each
    of the latter two, its largest loss difference from the jitted run
    and, per param, the largest ``|difference| / (1e-5 + 1e-4 |jitted|)``."""
    import tempfile

    data = tfeatures.dataset(chip_smoke.policy_journal(rows, 0))
    kw = dict(seed=0, steps=steps, batch_size=batch, log_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        for who in ("jit", "eager", "port"):
            _step0_checkpoint(Path(tmp) / who)
        jit, jit_hist = jtrain.fit_policy(data, workdir=f"{tmp}/jit", **kw)
        with jax.disable_jit():
            eager, eager_hist = jtrain.fit_policy(
                data, workdir=f"{tmp}/eager", **kw)
        port, port_hist = ttrain.fit_policy(data, workdir=f"{tmp}/port",
                                            device="cpu", **kw)
    out = {}
    for name, params, hist in (
            ("reference op by op", eager.params, eager_hist),
            ("port on the CPU", {k: v.numpy()
                                 for k, v in port.params.items()},
             port_hist)):
        row = {"loss": max(abs(a["loss"] - b["loss"])
                           for a, b in zip(hist, jit_hist))}
        for k in tmodel.PARAM_KEYS:
            want = np.asarray(jit.params[k])
            row[k] = float((np.abs(np.asarray(params[k]) - want)
                            / (1e-5 + 1e-4 * np.abs(want))).max())
        out[name] = row
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name, row in _spread().items():
        print(f"{name} against the jitted reference, 300 steps: "
              + ", ".join(f"{k} {v:.4g}" for k, v in row.items()))
