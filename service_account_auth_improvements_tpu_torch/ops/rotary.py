"""Rotary position embeddings (RoPE), Llama-3 flavour (port of
``ops/rotary.py``)."""

from __future__ import annotations

import math

import torch


def llama3_scale_freqs(freqs, *, factor: float, low_freq_factor: float,
                       high_freq_factor: float, original_max_seq: int):
    """Llama-3.1 frequency rescaling (``rope_type="llama3"``): short
    wavelengths keep their frequency, long ones are slowed by ``factor``,
    and the band in between interpolates smoothly."""
    wavelen = 2.0 * math.pi / freqs
    low_wavelen = original_max_seq / low_freq_factor
    high_wavelen = original_max_seq / high_freq_factor
    smooth = (original_max_seq / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    return torch.where(
        wavelen < high_wavelen,
        freqs,
        torch.where(
            wavelen > low_wavelen,
            freqs / factor,
            (1.0 - smooth) * freqs / factor + smooth * freqs,
        ),
    )


def rope_table(seq_len: int, head_dim: int, theta: float = 500_000.0,
               scaling: dict | None = None, device=None):
    """(cos, sin) tables, each ``[seq_len, head_dim // 2]`` f32.
    ``scaling``: optional Llama-3.1 context-extension parameters (see
    :func:`llama3_scale_freqs`)."""
    freqs = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    if scaling:
        freqs = llama3_scale_freqs(freqs, **scaling)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate ``x`` ``[b, seq, heads, head_dim]`` by position tables:
    rotate-half (contiguous split) convention, computed in f32, cast back
    to ``x.dtype``."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)
