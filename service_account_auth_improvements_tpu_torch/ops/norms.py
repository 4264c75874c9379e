"""Normalization ops (port of ``ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm with f32 statistics. The cast back to ``x.dtype`` comes
    BEFORE the multiply by ``weight``, as in the reference — bf16 parity
    depends on that order."""
    dtype = x.dtype
    x32 = x.float()
    scale = 1.0 / torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                             + eps)
    return (x32 * scale).to(dtype) * weight
