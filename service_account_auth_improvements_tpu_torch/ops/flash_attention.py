"""Flash-attention forward: the hand-written Hopper kernel and its plain
version (port of K1, ``_fwd_kernel``/``_flash_fwd`` in
``service_account_auth_improvements_tpu/ops/flash_attention.py``).

Routes: on a CUDA tensor ``flash_fwd`` launches the sm_90a kernel in
``csrc/flash_fwd.cu`` (built at first use by ``ops/_build.py``); on a CPU
tensor it runs ``flash_fwd_reference``, the plain PyTorch version of the
same arithmetic. There is no other route: a CUDA tensor the kernel cannot
take raises, it never falls back. ``launches`` counts kernel launches.

The public ``flash_attention`` keeps the reference's dispatch rules
(``_use_pallas``): non-bf16/f32 dtypes, ``d % 64 != 0``, causal
``sq != sk`` and non-causal unaligned shapes go to the dense path. The
reference zero-pads ragged causal inputs to 128 and slices the output
back; here the kernel (and its plain version) mask the ragged tail
themselves, which is the same computation on the real rows without the
copies. The reference's ``SATPU_FLASH_*`` block overrides are a TPU sweep
knob and are not ported: the Hopper kernel picks its own tiles.

Only the forward exists in the port so far: with autograd recording and
inputs that require grad, ``flash_fwd`` raises (the backward kernels K2/K3
are ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from service_account_auth_improvements_tpu_torch.ops import _build
from service_account_auth_improvements_tpu_torch.ops.attention import (
    NEG_INF,
    _dense_attention,
)

# alignment unit of the reference's contract: non-causal inputs must be a
# multiple of this (causal ones are masked to their length)
BLOCK_Q = 128
BLOCK_K = 128
KERNEL_HEAD_DIMS = (64, 128, 192, 256)

#: kernel launches since the last reset (tests and chip_smoke.py read it)
launches = 0


def _use_kernel(q, k, causal: bool) -> bool:
    """The reference's ``_use_pallas`` shape rules, [b, s, h, d] inputs.
    Its backend test becomes the tensor's device inside ``flash_fwd``."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        return False
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    if d % 64 != 0:
        return False
    if causal and sq != sk:
        # the kernel's causal mask is start-aligned (row >= col); dense
        # handles the end-aligned sq != sk case
        return False
    if (sq % BLOCK_Q or sk % BLOCK_K) and not causal:
        return False
    return True


def flash_fwd_reference(q, k, v, causal: bool):
    """Plain PyTorch version of the kernel: q [b,h,sq,d], k/v
    [b,hkv,sk,d] → (o [b,h,sq,d] in q.dtype, lse [b,h,sq] f32).

    The same arithmetic in one tile: f32 scores from input-dtype
    operands, a start-aligned causal mask of ``-2e38``, unnormalised
    probabilities cast to the V dtype before the PV product, division by
    the row sum at the end, and ``lse = m + log l``."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * d ** -0.5
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 - the kernel's name
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                       v.float())
    o = (acc / l).to(q.dtype).reshape(b, h, sq, d)
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return o, lse


def flash_fwd(q, k, v, causal: bool):
    """q [b,h,sq,d], k/v [b,hkv,sk,d] (any strides, head dim contiguous)
    → (o [b,h,sq,d], lse [b,h,sq] f32). The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            "flash_fwd requires sq == sk for causal (got "
            f"sq={q.shape[2]}, sk={k.shape[2]}); use the dense path"
        )
    if not causal and (q.shape[2] % BLOCK_Q or k.shape[2] % BLOCK_K):
        raise ValueError(
            "non-causal flash_fwd needs block-aligned sequences "
            f"(got sq={q.shape[2]}, sk={k.shape[2]})"
        )
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward in the port yet (kernels "
            "K2/K3, ROADMAP queue 2); run under torch.inference_mode() "
            "or use attn_impl='dense'"
        )
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_fwd: unsupported device {q.device}")


def _library():
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p] * 5 + [i] * 7 + [i64] * 12
                       + [i, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool):
    global launches
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    ts = (q, k, v)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_fwd: q, k and v must be on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype for t in ts):
        raise ValueError("flash_fwd kernel takes bf16 or f32 q/k/v of "
                         f"one dtype (got {[t.dtype for t in ts]})")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS} (got {d})")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % hkv):
        raise ValueError(f"flash_fwd: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    # the bf16 kernel moves K/V rows in 16-byte vectors: every row must
    # start on a 16-byte boundary
    align = 8 if q.dtype == torch.bfloat16 else 1
    for t in ts:
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) or (
                t.data_ptr() % 16):
            raise ValueError("flash_fwd kernel needs a contiguous head dim "
                             "and 16-byte aligned rows")
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _library()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, hkv,
                 sq, sk, d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3], int(causal), d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True):
    """Public wrapper: q [b,sq,h,d], k/v [b,sk,hkv,d] → [b,sq,h,d].

    Shapes the kernel contract covers go through ``flash_fwd`` (kernel
    on CUDA, plain version on CPU) on [b,h,s,d] views of the inputs, and
    the output comes back as a view of a [b,s,h,d] tensor; the rest go
    to the dense path, as in the reference."""
    if not _use_kernel(q, k, causal):
        return _dense_attention(q, k, v, q.shape[-1] ** -0.5, causal=causal)
    o, _ = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal)
    return o.transpose(1, 2)
