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
