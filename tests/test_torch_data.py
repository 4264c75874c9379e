"""Port parity: the input pipeline (train/data.py). Batch order is numpy's
``default_rng((seed, epoch))`` permutation on both sides, so the port's
batches must equal the reference's bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from service_account_auth_improvements_tpu.parallel import (  # noqa: E402
    MeshConfig,
    make_mesh,
)
from service_account_auth_improvements_tpu.train import data as jdata  # noqa: E402
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    data as tdata,
)

TOKENS = np.random.default_rng(0).integers(0, 500, size=5000,
                                           dtype=np.int32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(dp=1, fsdp=1), jax.devices()[:1])


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 7),
                                          (False, 0)])
def test_batches_bit_identical_across_epochs(mesh, shuffle, seed):
    cfg = jdata.DataConfig(batch=4, seq=64, shuffle=shuffle, seed=seed)
    want = jdata.TokenBatches(TOKENS, cfg, mesh)
    got = tdata.TokenBatches(TOKENS, tdata.DataConfig(
        batch=4, seq=64, shuffle=shuffle, seed=seed), device="cpu")
    assert got.steps_per_epoch == want.steps_per_epoch == 19
    for step in (0, 1, 5, 18, 19, 20, 38, 57, 100):  # epochs 0 to 5
        a = np.asarray(want.batch_at(step))
        b = got.batch_at(step)
        assert b.dtype == torch.long and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), a)


def test_masked_batches_and_iteration_match(mesh):
    docs = [np.arange(1, n + 1) for n in (5, 40, 17, 90, 3, 61) * 8]
    flat = jdata.pack_documents(docs, eos_id=0)
    np.testing.assert_array_equal(tdata.pack_documents(docs, eos_id=0),
                                  flat)
    jcfg = jdata.DataConfig(batch=2, seq=32, eos_id=0, seed=3)
    tcfg = tdata.DataConfig(batch=2, seq=32, eos_id=0, seed=3)
    want = jdata.TokenBatches(flat, jcfg, mesh)
    got = tdata.TokenBatches(flat, tcfg, device="cpu")
    for step in range(4):
        jt, jm = want.masked_batch_at(step)
        tt, tm = got.masked_batch_at(step)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(
            tm.numpy(), tdata.boundary_mask(tt.numpy(), 0))
    for (jt, jm), (tt, tm), _ in zip(want, got, range(3)):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_boundary_mask_and_errors():
    toks = np.array([[5, 0, 7, 8, 0, 9]])
    np.testing.assert_array_equal(tdata.boundary_mask(toks, 0),
                                  jdata.boundary_mask(toks, 0))
    with pytest.raises(ValueError, match="one global batch"):
        tdata.TokenBatches(TOKENS[:100], tdata.DataConfig(batch=4, seq=64),
                           device="cpu")
    # a mesh is a parallel.make_mesh DeviceMesh (tests/test_torch_mesh.py
    # and test_torch_parallel.py shard batches over real ones)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdata.TokenBatches(TOKENS, tdata.DataConfig(batch=4, seq=64),
                           mesh=object(), device="cpu")
