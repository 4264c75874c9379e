"""The placement scorer on tensors (port of
``controlplane/scheduler/policy/model.py``).

Every pool is scored by the same small MLP over ``concat(pool_block,
global_block)``: 6 -> hidden -> hidden -> 1 with tanh between, so the
scorer is permutation-equivariant over pools and pool-count-agnostic up
to ``features.MAX_POOLS``. Infeasible pools are set to :data:`NEG_INF`
inside :func:`forward`, so its argmax can never name a pool the
feasibility mask rejects.

The parameters are a flat dict of f32 tensors keyed by
:data:`PARAM_KEYS`, the keys of the ``policy.npz`` checkpoint;
``params_from_numpy`` and ``params_to_numpy`` bridge it to the numpy
dict the reference's numpy ``forward`` (its serving side) reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy.features import (  # noqa: E501
    GLOBAL_FEATURES,
    POOL_FEATURES,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)

#: per-pool scorer input width
IN_FEATURES = POOL_FEATURES + GLOBAL_FEATURES
DEFAULT_HIDDEN = 32
#: masked logit for infeasible pools: large enough that no finite learned
#: score outranks it, small enough to stay softmax-safe in f32
NEG_INF = -1e9

#: parameter leaf names (a flat dict, as the checkpoint keys them)
PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def init_params(hidden: int = DEFAULT_HIDDEN, *,
                generator: torch.Generator, device=None) -> dict:
    """Weights drawn from a standard normal by ``generator`` (on its own
    device) and scaled by 1/sqrt(fan-in), biases zero, all f32, then
    placed on ``device`` (the card unless ``"cpu"``). The draws are not
    JAX's: a test that needs the reference's init bridges it through a
    checkpoint or ``params_from_numpy``."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)

    w1 = normal(IN_FEATURES, hidden) * (1.0 / math.sqrt(IN_FEATURES))
    w2 = normal(hidden, hidden) * (1.0 / math.sqrt(hidden))
    w3 = normal(hidden, 1) * (1.0 / math.sqrt(hidden))
    params = {"w1": w1, "b1": torch.zeros(hidden), "w2": w2,
              "b2": torch.zeros(hidden), "w3": w3, "b3": torch.zeros(1)}
    return {k: params[k].to(dev) for k in PARAM_KEYS}


def forward(params: dict, pool_feats, glob, mask):
    """Masked per-pool scores.

    ``pool_feats``: (..., P, POOL_FEATURES); ``glob``: (...,
    GLOBAL_FEATURES); ``mask``: (..., P) bool. Returns (..., P) scores
    with every infeasible slot at :data:`NEG_INF`, applied here, inside
    the model."""
    glob_b = glob[..., None, :].expand(
        *pool_feats.shape[:-1], GLOBAL_FEATURES)
    x = torch.cat([pool_feats, glob_b], dim=-1)
    h = torch.tanh(x @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    scores = (h @ params["w3"] + params["b3"])[..., 0]
    return torch.where(mask, scores, NEG_INF)


def choose_index(params: dict, pool_feats, glob, mask) -> tuple:
    """The serving decision over a batch of states: ``(index, scores,
    confidence)``, tensors of shape (...), (..., P) and (...). ``index``
    is the argmax (the first of equal maxima, as numpy's) and
    ``confidence`` the softmax mass on it over the FEASIBLE slots; a state
    with no feasible slot gets index -1 and confidence 0, as the
    reference's single-state numpy ``choose_index`` returns."""
    scores = forward(params, pool_feats, glob, mask)
    # infeasible slots sit at NEG_INF, whose exp underflows to exactly 0
    # in f32 beside any feasible score: the softmax over all P slots is
    # the softmax over the feasible ones
    probs = torch.softmax(scores, dim=-1)
    any_feasible = mask.any(dim=-1)
    index = torch.where(any_feasible, scores.argmax(dim=-1), -1)
    confidence = torch.where(any_feasible, probs.amax(dim=-1), 0.0)
    return index, scores, confidence


def params_from_numpy(d: dict, device=None) -> dict:
    """A numpy parameter dict (a checkpoint's, or the reference's) as f32
    tensors on ``device`` (the card unless ``"cpu"``), copied: training
    updates them in place."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(d[k], np.float32), device=dev)
            for k in PARAM_KEYS}


def params_to_numpy(params: dict) -> dict:
    """The tensors of ``params`` as numpy f32 arrays, keyed by
    :data:`PARAM_KEYS`."""
    return {k: params[k].detach().cpu().numpy() for k in PARAM_KEYS}
