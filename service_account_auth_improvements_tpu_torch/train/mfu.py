"""Model FLOPs Utilization accounting (port of ``train/mfu.py``).

Peak numbers are NVIDIA's published dense bf16 tensor-core rates per card
(the H100 data sheet): H100 SXM 989 TF/s, H100 PCIe 756 TF/s. A card is
recognised by its CUDA device name.
"""

from __future__ import annotations

import torch

# (name fragments that must all occur, peak) in match order: the PCIe part
# first, since every H100 name contains "h100"
_PEAK_BF16 = (
    (("h100", "pcie"), 756e12),
    (("h100",), 989e12),
)


def chip_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of the card (the current one by default, or
    the given index or ``torch.device``), recognised by its device name;
    0 if unknown, and 0 for the CPU or without a card."""
    if not torch.cuda.is_available():
        return 0.0
    if device is not None and not isinstance(device, int) and (
            torch.device(device).type != "cuda"):
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    for parts, peak in _PEAK_BF16:
        if all(p in name for p in parts):
            return peak
    return 0.0


def mfu(model_flops_per_step: float, step_time_s: float, n_chips: int,
        peak_per_chip: float | None = None) -> float:
    """Achieved model FLOPs / peak FLOPs over the step. 0 if peak unknown."""
    peak = peak_per_chip if peak_per_chip is not None else chip_peak_flops()
    if not peak or step_time_s <= 0:
        return 0.0
    return model_flops_per_step / (step_time_s * n_chips * peak)
