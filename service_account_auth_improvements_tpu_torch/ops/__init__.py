"""Numeric ops: attention (dense / flash), norms, rotary.

Plain PyTorch versions always exist; the flash-attention forward launches
its hand-written Hopper kernel on CUDA tensors (``flash_attention.py``).
"""

from service_account_auth_improvements_tpu_torch.ops.attention import (  # noqa: F401
    multi_head_attention,
)
from service_account_auth_improvements_tpu_torch.ops.rotary import (  # noqa: F401
    rope_table,
    apply_rope,
)
from service_account_auth_improvements_tpu_torch.ops.norms import rms_norm  # noqa: F401
