"""Weight-only int8 quantization for inference (port of
``models/quantize.py``).

Matmul weights are stored as int8 with a per-output-channel f32 scale
(symmetric absmax), halving (against bf16) or quartering (against f32) the
model's resident bytes. The accuracy cost is the usual weight-only budget:
|w − dequant(w)| ≤ scale/2 per element.

No model-code changes: ``QuantizedTensor.to(dtype)`` returns the
dequantized tensor, and every weight use in ``models/llama.py`` and
``models/generate.py`` already goes through ``.to(compute_dtype)``; layer
slicing (``leaf[i]``, ``leaf.unbind(0)``) slices values and scale
together. The dequantize is plain torch ops, as the reference's is XLA
outside any kernel; here it is not fused into the matmul, so the
dequantized weight is materialised per use (a fused W8A16 GEMM is an open
lever, ROADMAP). Norm weights and the token embedding (a gather, not a
matmul) stay in full precision.

Quantized trees are for INFERENCE: they drop into ``llama.apply`` and
``generate.generate`` as they are. Quantize after training, before
serving.

A tree of ``DTensor``s (params laid out on a mesh) quantizes each weight
whole, so the scales are the unsharded weight's, and keeps each rank's
blocks: the values laid out as the weight, the scale as the weight
without its contraction axis (``models/serving.py`` on a tp/fsdp mesh).
"""

from __future__ import annotations

import torch


class QuantizedTensor:
    """int8 ``values`` in the native weight layout ``[..., in, out]`` and
    an f32 ``scale`` ``[..., out]`` (the contraction axis dropped, every
    leading stacked-layer axis kept, so slicing a layer slices both)."""

    def __init__(self, values: torch.Tensor, scale: torch.Tensor):
        self.values = values
        self.scale = scale

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """The dequantized weight in ``dtype``: the model's universal
        weight access, as ``.astype`` is the reference's."""
        return self.values.to(dtype) * self.scale.unsqueeze(-2).to(dtype)

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.values[idx], self.scale[idx])

    def unbind(self, dim: int = 0) -> tuple:
        if dim != 0:
            raise ValueError("only the leading (layer) axis unbinds")
        return tuple(QuantizedTensor(v, s) for v, s in
                     zip(self.values.unbind(0), self.scale.unbind(0)))

    def __repr__(self) -> str:
        return (f"QuantizedTensor(int8 {tuple(self.values.shape)}, scale "
                f"{tuple(self.scale.shape)})")


def quantize_array(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric absmax int8 quantization, per channel over the
    contraction axis (``dim=-2`` of the ``[..., in, out]`` layout), on
    ``w``'s device. ``torch.round`` rounds half to even, as ``jnp.round``
    does, so values and scales equal the reference's bit for bit."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=-2)
    # divided by a tensor, not a Python number: on CUDA, torch multiplies
    # by the reciprocal of a scalar divisor, which can miss the correctly
    # rounded quotient (the reference's scale) by an ulp
    scale = absmax.clamp_min(1e-12) / torch.tensor(127.0, device=w.device)
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return QuantizedTensor(q.to(torch.int8), scale)


# matmul weights (native layout [..., in, out]); norms and tok_embed (a
# gather) stay full precision, as does a mixture-of-experts router (tiny,
# and an int8 perturbation of its hard top-k would flip near-tie tokens to
# another expert)
_QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "moe_gate", "moe_up", "moe_down",
})


def _quantize_leaf(w) -> QuantizedTensor:
    """``quantize_array`` of a weight, or of a ``DTensor``'s whole weight
    with the result laid out as the ``DTensor`` (values as the weight,
    the scale without the contraction axis: a split of it becomes
    replication, a split of the output axis moves down one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return quantize_array(w)
    from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: E501
        distribute,
    )

    q = quantize_array(w.full_tensor())
    nd = w.ndim
    scale_places = [
        p if not isinstance(p, Shard) or p.dim < nd - 2
        else Replicate() if p.dim == nd - 2 else Shard(p.dim - 1)
        for p in w.placements]
    return QuantizedTensor(distribute(q.values, w.device_mesh, w.placements),
                           distribute(q.scale, w.device_mesh, scale_places))


def quantize_params(params) -> dict:
    """Quantize every matmul weight of a Llama param tree to int8; the
    result drops into ``llama.apply`` and ``generate.generate``."""
    return {
        "tok_embed": params["tok_embed"],
        "final_norm": params["final_norm"],
        "lm_head": _quantize_leaf(params["lm_head"]),
        "layers": {
            k: (_quantize_leaf(v) if k in _QUANT_KEYS else v)
            for k, v in params["layers"].items()
        },
    }


def quantized_bytes(params) -> int:
    """Resident bytes of a (possibly quantized) param tree."""
    total = 0
    for leaf in params.values():
        if isinstance(leaf, dict):
            total += quantized_bytes(leaf)
        elif isinstance(leaf, QuantizedTensor):
            total += quantized_bytes({"values": leaf.values,
                                      "scale": leaf.scale})
        else:
            total += leaf.numel() * leaf.element_size()
    return total
