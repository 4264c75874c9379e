"""Port parity: held-out evaluation (train/evaluate.py) against the JAX
``evaluate`` on the same numpy batches and bridged weights.

f32 compute, so the token-weighted loss agrees to summation order (held
to 1e-5, the reference's own tolerance in tests/test_evaluate.py) and the
token count exactly.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.train import evaluate as jev  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    evaluate as tev,
    make_eval_step,
)

CFG = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                          param_dtype="float32", remat=False)
TCFG = tllama.LlamaConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(CFG, jax.random.key(0)))
    return tree, tparams.from_numpy(tree, TCFG, "cpu")


def _batches(n, b=4, s=32, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
            for _ in range(n)]


def _both(weights, batches, packed=False):
    want = jev.evaluate(CFG, weights[0], [
        tuple(map(jnp.asarray, b)) if isinstance(b, tuple)
        else jnp.asarray(b) for b in batches], packed=packed)
    got = tev.evaluate(TCFG, weights[1], batches, packed=packed,
                       device="cpu")
    return got, want


def _assert_match(got, want):
    assert abs(got["loss"] - want["loss"]) < 1e-5
    assert got["tokens"] == want["tokens"]
    assert abs(got["perplexity"] - want["perplexity"]) < (
        1e-4 * want["perplexity"])


def test_evaluate_matches_jax(weights):
    got, want = _both(weights, _batches(3))
    _assert_match(got, want)
    assert got["tokens"] == 3 * 4 * 31
    assert got["perplexity"] == math.exp(got["loss"])


def test_mask_weighting_matches_jax(weights):
    t = _batches(2)
    m = np.ones_like(t[0])
    m[:, 16:] = 0
    full, _ = _both(weights, t)
    got, want = _both(weights, [(t[0], m), t[1]])
    _assert_match(got, want)
    assert got["tokens"] == full["tokens"] - 4 * 16
    assert got["loss"] != full["loss"]


def test_bare_batches_equal_all_ones_masks(weights):
    t = _batches(2)
    bare = tev.evaluate(TCFG, weights[1], t, device="cpu")
    pairs = tev.evaluate(TCFG, weights[1],
                         [(x, np.ones_like(x)) for x in t], device="cpu")
    assert bare == pairs


def test_packed_matches_jax(weights):
    t = _batches(1)[0]
    m = np.ones_like(t)
    m[:, [5, 20]] = 0  # document starts: their targets masked out
    got, want = _both(weights, [(t, m)], packed=True)
    _assert_match(got, want)
    # the prebuilt step the training loop passes gives the same numbers
    step = make_eval_step(TCFG, packed=True)
    again = tev.evaluate(TCFG, weights[1], [(t, m)], step=step,
                         device="cpu")
    assert again == got


def test_evaluate_excludes_moe_aux():
    """A MoE model's eval loss is the pure cross-entropy, JAX's to 1e-5;
    the training loss (with the aux term) is larger."""
    cfg = dataclasses.replace(jllama.PRESETS["moe_smoke"], dtype="float32",
                              param_dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jllama.init(cfg, jax.random.key(0)))
    params = tparams.from_numpy(tree, tcfg, "cpu")
    t = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                          (4, 32)).astype(np.int32)
    want = jev.evaluate(cfg, tree, [jnp.asarray(t)])
    got = tev.evaluate(tcfg, params, [t], device="cpu")
    _assert_match(got, want)
    tt = torch.tensor(t, dtype=torch.long)
    pure = float(tllama.next_token_loss(tcfg, params, tt,
                                        include_aux=False))
    assert abs(got["loss"] - pure) < 1e-5
    assert float(tllama.next_token_loss(tcfg, params, tt)) > pure


def test_empty_batches_raise(weights):
    gen = iter(_batches(1))
    list(gen)  # exhausted
    with pytest.raises(ValueError, match="no tokens"):
        tev.evaluate(TCFG, weights[1], gen, device="cpu")
    with pytest.raises(ValueError, match="no tokens"):
        tev.evaluate(TCFG, weights[1], [], device="cpu")


def test_mesh_raises():
    # evaluation on a mesh is ported (tests/test_torch_parallel.py); what
    # is not a parallel.make_mesh DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_eval_step(TCFG, mesh=object())
