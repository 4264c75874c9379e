"""Flash attention: the hand-written Hopper kernels and their plain
versions (port of K1 ``_fwd_kernel``/``_flash_fwd``, K2 ``_dq_kernel`` and
K3 ``_dkv_kernel``/``_flash_bwd``, and the ``_flash`` custom VJP in
``service_account_auth_improvements_tpu/ops/flash_attention.py``).

Routes: on a CUDA tensor ``flash_fwd`` launches the sm_90a kernel in
``csrc/flash_fwd.cu`` and ``flash_bwd_dq``/``flash_bwd_dkv`` launch those
in ``csrc/flash_bwd.cu``, or, above ``KERNEL_HEAD_DIMS``, those of
``csrc/flash_wide.cu`` (each library built at first use by
``ops/_build.py``); on a CPU tensor they run ``flash_fwd_reference`` and
``flash_bwd_dq_reference``/``flash_bwd_dkv_reference``, the plain PyTorch
versions of the same arithmetic. There is no other route: a CUDA tensor a
kernel cannot take raises, it never falls back. ``launches``,
``dq_launches`` and ``dkv_launches`` count the launches of K1, K2 and K3.

Inside each library the entry point picks the kernel by dtype and head
dim, never by catching an error: in bf16 up to d 192, K1 is
``flash_fwd_wgmma``, K2 is ``dq_wgmma`` and K3 is ``dkv_wgmma`` (TMA loads
into an mbarrier ring, a producer warp, consumer warpgroups on wgmma, with
the pieces in ``csrc/hopper.cuh``); at d 256 they are ``flash_fwd_rows8``,
``dq_rows8`` and ``dkv_onepass`` (8-warp blocks, no producer warpgroup);
from d 320 to 512 K1 and K2 are ``flash_fwd_split`` and ``dq_split``,
which split the output's D columns between the two consumer warpgroups
and exchange the halves of each score tile through shared memory (but
``flash_fwd_pair`` at d 384 and 512 and ``dq_pair`` at d 512), and K3 is
``dkv_pair``: ``dkv_onepass`` on each block of a cluster of two, each
holding 64 ceil(d / 128) columns (at d 320 and 448 the second block's
last 64 are TMA's zeros, not stored), the partial scores summed through
distributed shared memory; each is built for every head dim in
``KERNEL_HEAD_DIMS`` with tiles chosen per dim. float32 runs
``flash_fwd_f32`` and the register-tiled FFMA kernels ``dq_f32`` and
``dkv_f32`` (true f32 FMA, no TF32; when a launch has fewer than two
blocks a SM, K2 splits its blocks' key ranges and K3 its key tiles' query
ranges over up to four blocks, whose parts a second pass, ``f32_reduce``,
sums from a workspace this module allocates). Every kernel there holds its
rows at the whole head dim (or half of it in each block of a pair), so
512 is the bound of those libraries. Above it the reference's rules (its
Pallas kernels set no upper bound) admit every multiple of 64, and so does
the port, in both dtypes: ``csrc/flash_wide.cu`` streams the head dim and
gives each block ``WIDE_COLUMNS`` output columns, so what a block holds
does not grow with d; bf16 runs ``flash_fwd_wide`` and ``dq_wide``
(wgmma over 64-column chunks) and, up to ``WIDE_CLUSTER_MAX`` groups,
``dkv_wide`` (where its last column group is at least three quarters
full), float32 (register-tiled FFMA over 32-column chunks, true f32)
``flash_fwd_wide_f32``, ``dq_wide_f32`` and ``dkv_wide_f32``: a row tile on
a cluster of ``wide_cluster(d, name)`` (bf16) or ``wide_f32_cluster(d,
name)`` (f32) blocks, one a column group, whose partial scores are summed
through distributed shared memory, so each score is formed once; above it
those kernels' column groups run as independent blocks
(``dkv_wide_groups``; ``flash_fwd_wide_f32_groups``,
``dq_wide_f32_groups``, ``dkv_wide_f32_groups``), each forming the scores
over the whole head dim, as ``flash_fwd_wide`` and ``dq_wide`` do at
every d. None splits a row tile over a workspace. A CUDA tensor whose head dim is no multiple of 64 raises;
there is no other refusal by head dim, and the design is chosen by the
head dim alone, never by catching an error. All count under the same
counters.

Gradients: when autograd records and an input requires grad,
``flash_fwd`` goes through ``FlashAttention``, a ``torch.autograd.Function``
whose forward runs K1 and saves q, k, v, o and lse, and whose backward
computes delta = rowsum(dO * O) in f32 and runs K2 and K3 (``flash_bwd``).

The public ``flash_attention`` keeps the reference's dispatch rules
(``_use_pallas``): non-bf16/f32 dtypes, ``d % 64 != 0``, causal
``sq != sk`` and non-causal unaligned shapes go to the dense path. The
reference zero-pads ragged causal inputs to 128 and slices the output
back; here the kernels (and their plain versions) mask the ragged tail
themselves, which is the same computation on the real rows without the
copies. The reference's ``SATPU_FLASH_*`` block overrides are a TPU sweep
knob and are not ported: the Hopper kernels pick their own tiles.
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
#: head dims K1, K2 and K3 are built for one by one, in bf16 and f32:
#: every multiple of 64 up to 512, the bound of the per-dim libraries. In
#: both dtypes every multiple of 64 above it takes the streamed kernels
#: (``WIDE_FUNCTIONS``)
KERNEL_HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512)
#: the C functions of ``csrc/flash_wide.cu`` that run K1, K2 and K3 in bf16
#: and f32 above ``KERNEL_HEAD_DIMS`` (each picks its kernel by dtype)
WIDE_FUNCTIONS = {"flash_fwd": "flash_wide_fwd",
                  "flash_bwd_dq": "flash_wide_dq",
                  "flash_bwd_dkv": "flash_wide_dkv"}
#: the output columns one block of each of those kernels owns, in both
#: dtypes (its C constants FWD_W, DQ_W and DKV_W, and FWD_W_F32, DQ_W_F32
#: and DKV_W_F32, which ``flash_wide_columns`` reports): ``wide_groups``
#: lists the blocks' column groups at a head dim. The f32 K1, K2 and K3 and
#: the bf16 K3 run a row tile's groups as one cluster, each block streaming
#: only its own columns of the head dim (``wide_f32_cluster``,
#: ``wide_cluster``); the bf16 K1's and K2's blocks each form the scores
#: over the whole head dim
WIDE_COLUMNS = {"flash_fwd": 256, "flash_bwd_dq": 256, "flash_bwd_dkv": 256}
#: the most blocks a cluster of a streamed kernel has (the portable cluster
#: size, the C constant CLUSTER_MAX): up to 8 groups (d 2048) those kernels
#: run on a cluster, above it as independent groups
WIDE_CLUSTER_MAX = 8
#: the bf16 streamed kernels that run on a cluster (C ``wide_design``)
WIDE_CLUSTER_KERNELS = ("flash_bwd_dkv",)

#: kernel launches since the last reset (tests and chip_smoke.py read
#: them): K1 (forward), K2 (dQ) and K3 (dK/dV)
launches = 0
dq_launches = 0
dkv_launches = 0


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
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def _forward(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_fwd: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K1, backward K2 and
    K3 from the saved q, k, v, o and lse. Returns (o, lse); lse carries no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def _library(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FWD_ARGS = [_P] * 5 + [_I] * 7 + [_I64] * 12 + [_I, ctypes.c_float, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P, _P]


def _check_layout(name, ts, dtype):
    """The kernels' input contract: one device, one dtype (bf16 or f32), a
    contiguous head dim and 16-byte aligned rows: the kernels move rows in
    16-byte vectors, by cp.async or by TMA, whose tensor maps need a
    16-byte aligned base and strides that are multiples of 16 bytes."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs must be on one device")
    if dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != dtype for t in ts):
        raise ValueError(f"{name} kernel takes bf16 or f32 inputs of one "
                         f"dtype (got {[t.dtype for t in ts]})")
    for t in ts:
        if not _aligned(t):
            raise ValueError(f"{name} kernel needs a contiguous head dim "
                             "and 16-byte aligned rows")


def kernel_route(name, d, dtype) -> tuple[str, str]:
    """The library (a ``csrc/`` source) and C function that run kernel
    ``name`` ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv") on CUDA
    tensors of head dim ``d`` in ``dtype`` (bf16 or f32): the per-dim
    kernels at ``KERNEL_HEAD_DIMS``, the streamed ones at every multiple of
    64 above them; raises for any other head dim."""
    if d in KERNEL_HEAD_DIMS:
        return ("flash_fwd" if name == "flash_fwd" else "flash_bwd"), name
    if d % 64 == 0 and d > KERNEL_HEAD_DIMS[-1]:
        return "flash_wide", WIDE_FUNCTIONS[name]
    raise ValueError(f"{name} kernel supports head_dim in {KERNEL_HEAD_DIMS} "
                     f"and every multiple of 64 above it (got {d} in "
                     f"{dtype})")


def wide_groups(d, name) -> list[tuple[int, int]]:
    """The column groups of kernel ``name``'s streamed blocks at head dim
    ``d``, (first column, width) each: ``WIDE_COLUMNS[name]`` columns each
    but the last, which ends at d."""
    w = WIDE_COLUMNS[name]
    return [(c, min(w, d - c)) for c in range(0, d, w)]


def wide_f32_cluster(d, name) -> int:
    """The blocks of one cluster of kernel ``name``'s f32 streamed kernel at
    head dim ``d`` (its ``flash_wide_f32_design`` is then kF32Cluster): the
    column groups of a row tile (``wide_groups``) while they are at most
    ``WIDE_CLUSTER_MAX``; 1 (no cluster, each group its own block) above
    it."""
    n = len(wide_groups(d, name))
    return n if n <= WIDE_CLUSTER_MAX else 1


def wide_cluster(d, name) -> int:
    """The blocks of one cluster of kernel ``name``'s bf16 streamed kernel
    at head dim ``d`` (its ``flash_wide_design`` is then kWideCluster): the
    column groups of a row tile for ``WIDE_CLUSTER_KERNELS`` while they are
    at most ``WIDE_CLUSTER_MAX`` and the last holds at least three quarters
    of ``WIDE_COLUMNS``; 1 (no cluster) otherwise."""
    groups = wide_groups(d, name)
    full = groups[-1][1] >= 3 * WIDE_COLUMNS[name] // 4
    return (len(groups) if name in WIDE_CLUSTER_KERNELS and full
            and len(groups) <= WIDE_CLUSTER_MAX else 1)


def _aligned(t) -> bool:
    align = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and not any(s % align for s in t.stride()[:3]))


def _launch(q, k, v, causal: bool):
    global launches
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    _check_layout("flash_fwd", (q, k, v), q.dtype)
    lib, fn_name = kernel_route("flash_fwd", d, q.dtype)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % hkv):
        raise ValueError(f"flash_fwd: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _library(lib, fn_name, _FWD_ARGS)
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


# ---------------------------------------------------------------- backward

def _scores(q, k, lse, causal: bool):
    """The backward's recompute, shared by both plain versions: q
    [b,h,sq,d] grouped as [b,hkv,g,sq,d], S = scale·QKᵀ in f32 from
    input-dtype operands with the start-aligned causal mask of -2e38, and
    P = exp(S - lse) in f32."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * d ** -0.5
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    return qg, torch.exp(s - lse.reshape(b, hkv, h // hkv, sq, 1))


def flash_bwd_delta(o, do):
    """delta = rowsum(dO * O) in f32, [b,h,sq] contiguous: the reference
    computes it in jnp, outside its kernels (``_flash_bwd``)."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool):
    """Plain PyTorch version of K2: dq [b,h,sq,d] in q.dtype.

    P stays f32; dS = P·(dO·Vᵀ - delta) is rounded to K's dtype before
    dS·K, and dq = scale·(dS·K) is rounded to q's dtype at the end."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    _, p = _scores(q, k, lse, causal)
    dog = do.reshape(b, hkv, h // hkv, sq, d).float()
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    ds = (p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1))).to(k.dtype)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.float(), k.float())
    return (dq * d ** -0.5).to(q.dtype).reshape(b, h, sq, d)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool):
    """Plain PyTorch version of K3: (dk, dv) [b,hkv,sk,d] in k's and v's
    dtypes, summed over the group's query heads and all query rows.

    P is rounded to dO's dtype first and that P serves both dV = Pᵀ·dO
    and (upcast again) dS = P·(dO·Vᵀ - delta), rounded to q's dtype
    before dK = scale·dSᵀ·Q."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    qg, p = _scores(q, k, lse, causal)
    p = p.to(do.dtype).float()
    dog = do.reshape(b, hkv, h // hkv, sq, d).float()
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    ds = (p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1))).to(q.dtype)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.float(), qg.float())
    return (dk * d ** -0.5).to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool):
    """Plain PyTorch version of the whole backward (``_flash_bwd``):
    delta, then K2's and K3's recompute arithmetic step by step (not
    autograd over ``flash_fwd_reference``) → (dq, dk, dv)."""
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """K2 on CUDA tensors (``dq_launches`` counts it), its plain version
    on CPU tensors → dq in q's layout and dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    global dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, dq, None, None,
                causal)
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """K3 on CUDA tensors (``dkv_launches`` counts it), its plain version
    on CPU tensors → (dk, dv) in k's and v's layouts and dtypes."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, None, dk, dv,
                causal)
    dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool):
    """The backward of ``flash_fwd`` → (dq, dk, dv): delta in f32, then K2
    and K3 on CUDA tensors (their plain versions on CPU tensors). dO as
    autograd hands it over may have zero strides (the gradient of a sum)
    or a strided head dim; such a dO is copied to a contiguous tensor
    first."""
    if do.device.type == "cuda" and (
            0 in do.stride() or not _aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _launch_bwd(fn_name, q, k, v, do, lse, delta, dq, dk, dv,
                causal: bool):
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    outs = [t for t in (dq, dk, dv) if t is not None]
    _check_layout(fn_name, (q, k, v, do, *outs), q.dtype)
    lib, c_name = kernel_route(fn_name, d, q.dtype)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % hkv or do.shape != q.shape):
        raise ValueError(f"{fn_name}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"do {tuple(do.shape)}")
    for t in (lse, delta):
        if (t.dtype != torch.float32 or t.shape != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{fn_name}: lse and delta must be f32 "
                             f"[b, h, sq] contiguous on the card")
    strides = (ctypes.c_int64 * 21)(*(
        s for t in (q, k, v, do, dq, dk, dv)
        for s in (t.stride()[:3] if t is not None else (0, 0, 0))))
    ptr = [t.data_ptr() if t is not None else None
           for t in (q, k, v, do, lse, delta, dq, dk, dv)]
    bf16 = int(q.dtype == torch.bfloat16)
    fn = _library(lib, c_name, _BWD_ARGS)
    with torch.cuda.device(q.device):
        # K2 or K3 in f32 with split tiles: the parts' workspace, as the
        # library that launches them counts it (the caching allocator
        # reuses it only in this stream's order)
        nbytes = 0 if bf16 else _library(
            lib, f"{lib}_workspace", [_I] * 8, _I64)(
                int(fn_name == "flash_bwd_dkv"), bf16, b, h, hkv, sq, sk, d)
        ws = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
              if nbytes > 0 else None)
        err = fn(*ptr, strides, bf16, b, h, hkv, sq, sk, d, int(causal),
                 d ** -0.5, ws.data_ptr() if ws is not None else None,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")


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
