"""Port parity: the side models (models/mnist.py, models/resnet.py) against
the JAX ``models/mnist.py`` and ``models/resnet.py``, on JAX-initialised
params bridged as numpy.

Both models compute in bf16 by design. To hold the math itself (SAME
padding, the -inf max-pool padding, batch norm's biased variance and
momentum, the gradients) to the reference tightly, the f32 tests run both
sides with their bf16 compute dtype swapped for f32 (a module proxy on
each side): atol 1e-5 + rtol 1e-5 on logits and stats, and each gradient
and momentum leaf within 2e-5 of its largest element (summation order).
32×32 inputs pad every stride-2 conv and the pool asymmetrically, 33×33
symmetrically.
As shipped, in bf16: MNIST agrees bit for bit with JAX's forward (seen 0)
and within 2e-2 after three SGD steps; ResNet in eval mode within 1e-5
(seen 2.4e-7), in train mode within 1e-2 on logits (seen 3.0e-3: the two
stacks round the batch-norm arithmetic at different points) and 2e-2 on
the running stats (seen 4.6e-3), and its loss over three momentum steps
within 5e-3 (seen 1.1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import mnist as jmnist  # noqa: E402
from service_account_auth_improvements_tpu.models import resnet as jresnet  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    mnist as tmnist,
    resnet as tresnet,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (  # noqa: E402
    leaves,
)

SMOKE = "resnet18-smoke"


class _F32:
    """A module whose ``bfloat16`` is ``float32``: the model's compute
    dtype swapped, everything else the module's own."""

    def __init__(self, mod, f32):
        self._mod, self.bfloat16 = mod, f32

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def f32_compute(monkeypatch):
    for jmod, tmod in ((jmnist, tmnist), (jresnet, tresnet)):
        monkeypatch.setattr(jmod, "jnp", _F32(jnp, jnp.float32))
        monkeypatch.setattr(tmod, "torch", _F32(torch, torch.float32))


def _t(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()), tree)


def _pairs(got, want):
    """(path, port leaf as numpy, JAX leaf as numpy) of two trees."""
    for name, t in leaves(got):
        w = want
        for part in name.split("/"):
            w = w[part]
        yield name, t.detach().float().numpy(), np.asarray(w, np.float32)


def _assert_leaves(got, want, rel, what):
    for name, g, w in _pairs(got, want):
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= bound, f"{what} {name}"


def _resnet(seed=0):
    """resnet18-smoke params with a random head (the reference's zero
    head would make every logit 0 and every other gradient 0)."""
    cfg = jresnet.PRESETS[SMOKE]
    params, stats = jresnet.init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params["head"]["w"] = jnp.asarray(
        rng.normal(0, 0.3, params["head"]["w"].shape), jnp.float32)
    return cfg, params, stats


def _images(n, hw, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, n))


def _mnist_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    centers = rng.normal(size=(10, 784)) * 2.0
    x = centers[labels] + rng.normal(size=(n, 784)) * 0.5
    return x.astype(np.float32), labels


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mnist_apply_loss_and_sgd_steps_match_jax(dtype, request):
    if dtype == "f32":
        request.getfixturevalue("f32_compute")
    cfg = jmnist.MnistConfig()
    params = jmnist.init(cfg, jax.random.key(0))
    x, labels = _mnist_data()
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    tx, tl = torch.tensor(x), torch.tensor(labels)
    tp = _t(params)
    logits = tmnist.apply(cfg, tp, tx)
    assert logits.dtype == torch.float32 and logits.shape == (64, 10)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jmnist.apply(cfg, params, jx)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tmnist.loss_fn(cfg, tp, tx, tl)),
                               float(jmnist.loss_fn(cfg, params, jx, jl)),
                               rtol=1e-6)
    assert float(tmnist.accuracy(cfg, tp, tx, tl)) == float(
        jmnist.accuracy(cfg, params, jx, jl))
    jstep = jmnist.make_sgd_step(cfg, lr=0.1)
    tstep = tmnist.make_sgd_step(cfg, lr=0.1)
    for i in range(3):
        params, jloss = jstep(params, jx, jl)
        tp, tloss = tstep(tp, tx, tl)
        assert abs(float(tloss) - float(jloss)) < (
            2e-2 if dtype == "bf16" else 1e-5), i
    _assert_leaves(tp, params, 2e-2 if dtype == "bf16" else 2e-5,
                   f"mnist {dtype} params")
    assert all(not t.requires_grad for _, t in leaves(tp))


def test_mnist_param_count_and_mesh():
    cfg = tmnist.MnistConfig()
    params = tmnist.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert sum(t.numel() for t in params.values()) == cfg.param_count() \
        == jmnist.MnistConfig().param_count() == 203_530
    # a dp mesh runs (tests/test_torch_side_meshes.py); it must be a
    # make_mesh mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmnist.make_sgd_step(cfg, mesh=object())


@pytest.mark.parametrize("n,k,s", [
    (224, 7, 2), (33, 7, 2), (56, 3, 2), (33, 3, 2), (28, 3, 1),
    (33, 1, 2), (17, 3, 2)])
def test_same_padding_and_max_pool_match_lax(n, k, s):
    """``_conv`` and ``_max_pool_same`` against ``lax`` SAME in f32: the
    asymmetric (total // 2, rest) padding at stride 2, -inf in the
    pool."""
    rng = np.random.default_rng(n * k + s)
    x = rng.normal(size=(2, n, n, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tx = torch.tensor(x).permute(0, 3, 1, 2)
    got = tresnet._conv(tx, torch.tensor(w), stride=s).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    if k == 3:
        pool = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, k, k, 1), (1, s, s, 1), "SAME")
        got = tresnet._max_pool_same(tx, k, s).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pool))
    assert tresnet._same_pad(224, 7, 2) == (2, 3)
    assert tresnet._same_pad(56, 3, 2) == (0, 1)
    assert tresnet._same_pad(112, 3, 2) == (0, 1)


@pytest.mark.parametrize("hw", [32, 33])
@pytest.mark.parametrize("train", [True, False])
def test_resnet_forward_and_stats_match_jax_in_f32(f32_compute, hw, train):
    """resnet18-smoke forward and new stats, f32 compute. SAME padding
    of an odd kernel at stride 2 is asymmetric on even sizes only: 32×32
    pads every stride-2 conv and the pool (0, 1) or (2, 3), 33×33 pads
    them all symmetrically (a symmetric ``padding=`` fails the first, a
    fixed (lo, lo + 1) split the second)."""
    cfg, params, stats = _resnet()
    x, _ = _images(4, hw)
    jl, js = jresnet.apply(cfg, params, stats, jnp.asarray(x), train=train)
    tl, ts = tresnet.apply(tresnet.PRESETS[SMOKE], _t(params), _t(stats),
                           torch.tensor(x), train=train)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    for name, g, w in _pairs(ts, js):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
        if not train:
            assert np.array_equal(g, w)


def test_resnet_momentum_steps_match_jax_in_f32(f32_compute):
    """3 momentum-SGD steps (m = 0.9·m + g, p -= lr·m) on a 32×32 batch
    (asymmetric padding everywhere): loss, params, momentum and running
    stats, f32 compute."""
    cfg, params, stats = _resnet()
    x, labels = _images(8, 32)
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    tx, tl = torch.tensor(x), torch.tensor(labels)
    mom = jax.tree.map(jnp.zeros_like, params)
    tp, ts, tm = _t(params), _t(stats), _t(mom)
    jstep = jresnet.make_train_step(cfg, lr=0.1)
    tstep = tresnet.make_train_step(tresnet.PRESETS[SMOKE], lr=0.1)
    for i in range(3):
        params, stats, mom, jloss = jstep(params, stats, mom, jx, jl)
        tp, ts, tm, tloss = tstep(tp, ts, tm, tx, tl)
        assert abs(float(tloss) - float(jloss)) < 1e-5, i
        _assert_leaves(tm, mom, 2e-5, f"momentum step {i}")
        _assert_leaves(tp, params, 2e-5, f"params step {i}")
        for name, g, w in _pairs(ts, stats):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"stats {name} step {i}")
    assert all(not t.requires_grad
               for tree in (tp, ts, tm) for _, t in leaves(tree))


def test_resnet_bf16_as_shipped_matches_jax():
    """The bf16 model against JAX's: eval mode (running stats) to
    rounding, train mode within the bf16 tolerances, three momentum
    steps' losses close and falling."""
    cfg, params, stats = _resnet()
    tcfg = tresnet.PRESETS[SMOKE]
    x, labels = _images(8, 33)
    jl, _ = jresnet.apply(cfg, params, stats, jnp.asarray(x), train=False)
    tl, _ = tresnet.apply(tcfg, _t(params), _t(stats), torch.tensor(x),
                          train=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    jl, js = jresnet.apply(cfg, params, stats, jnp.asarray(x), train=True)
    tl, ts = tresnet.apply(tcfg, _t(params), _t(stats), torch.tensor(x),
                           train=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2)
    for name, g, w in _pairs(ts, js):
        np.testing.assert_allclose(g, w, atol=2e-2, err_msg=name)
    mom = jax.tree.map(jnp.zeros_like, params)
    tp, tst, tm = _t(params), _t(stats), _t(mom)
    jstep = jresnet.make_train_step(cfg, lr=0.1)
    tstep = tresnet.make_train_step(tcfg, lr=0.1)
    losses = []
    for i in range(3):
        params, stats, mom, jloss = jstep(params, stats, mom,
                                          jnp.asarray(x), jnp.asarray(labels))
        tp, tst, tm, tloss = tstep(tp, tst, tm, torch.tensor(x),
                                   torch.tensor(labels))
        assert abs(float(tloss) - float(jloss)) < 5e-3, i
        losses.append(float(tloss))
    assert losses[-1] < losses[0]


def test_resnet50_param_count():
    """The canonical ResNet-50 v1.5 count, from the port's tree (built on
    the meta device) and from JAX's."""
    assert tresnet.PRESETS["resnet50"].param_count() == 25_557_032
    assert jresnet.PRESETS["resnet50"].param_count() == 25_557_032
    cfg = tresnet.PRESETS[SMOKE]
    params, stats = tresnet.init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    jparams, jstats = jresnet.init(jresnet.PRESETS[SMOKE], jax.random.key(0))
    assert {n: tuple(t.shape) for n, t in leaves(params)} == {
        n: w.shape for n, _, w in _pairs(params, jparams)}
    assert sum(t.numel() for _, t in leaves(params)) == cfg.param_count()
    assert [n for n, _ in leaves(stats)] == [n for n, _, _ in
                                             _pairs(stats, jstats)]
    assert not params["head"]["w"].any()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tresnet.make_train_step(cfg, mesh=object())
