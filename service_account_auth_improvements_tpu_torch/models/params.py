"""Weight bridge: the JAX package's parameter pytree, as numpy arrays, to
the port's tensors with identical names and shapes."""

from __future__ import annotations

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.models.llama import (
    LlamaConfig,
    dtype_of,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


def from_numpy(tree, cfg: LlamaConfig, device=None, dtype=None):
    """Nested dict of numpy arrays → the same dict of tensors on
    ``device`` (the card unless ``"cpu"``) in ``dtype`` (default
    ``cfg.param_dtype``). numpy has no bf16, so callers hand bf16 leaves
    over as ``np.asarray(x, np.float32)`` and the cast happens here."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.param_dtype) if dtype is None else dtype

    def conv(node):
        if isinstance(node, dict):
            return {name: conv(child) for name, child in node.items()}
        return torch.from_numpy(np.asarray(node, np.float32).copy()).to(
            device=dev, dtype=dt)

    return conv(tree)


def train_state_from_numpy(cfg: LlamaConfig, params, mu, nu, count: int = 0,
                           step: int = 0, device=None, mu_dtype=None):
    """A JAX ``TrainState``'s contents, as numpy trees, to the port's
    ``train.step.TrainState``: ``params`` and ``nu`` in
    ``cfg.param_dtype``, ``mu`` in ``mu_dtype`` (default the param
    dtype, as optax keeps it), the Adam update ``count`` and ``step``."""
    from service_account_auth_improvements_tpu_torch.train.step import (
        AdamState,
        TrainState,
    )

    mdt = dtype_of(mu_dtype) if mu_dtype else None
    return TrainState(step, from_numpy(params, cfg, device),
                      AdamState(count, from_numpy(mu, cfg, device, mdt),
                                from_numpy(nu, cfg, device)))
