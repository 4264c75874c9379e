#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and hold its
kernels against their plain versions.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built from ``csrc/`` at first use) and
no network. Phases, each of which raises on failure:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: every kernel of the path, timed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in bf16 and f32, with stated tolerances,
   timed beside the plain version and a library call of the same function;
4. serving: ``GenerationService`` at ``bench_800m`` with per-length
   prefill, behind ``make_server`` on 127.0.0.1, answering one-shot,
   repeated, sampled and streamed completions and /healthz and /metrics;
   the kernel launch counts of that run; ``llama.apply`` with flash
   attention against dense attention.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or without the
repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PKG = "service_account_auth_improvements_tpu_torch"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# kernel vs plain tolerances: |kernel - plain| <= ATOL + RTOL * |plain|.
# bf16: both sides round O to bf16 (one ulp is 2^-8 relative) from f32
# values that differ by the tile order of the online softmax and the bf16
# rounding of P; f32: only the summation order differs.
TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
LSE_ATOL = 1e-3

# serving path: bench_800m, batch 4, a 1000-token prompt, 64 new tokens
PRESET, BATCH, PROMPT, NEW = "bench_800m", 4, 1000, 64
# llama.apply logits (std ~0.8), flash attention against dense attention at
# full width. bf16: the two attention paths round P and O to bf16 at
# different points and 20 layers of bf16 residual stream carry the
# difference (largest seen on the H100: 0.13). f32: summation order only.
APPLY_ATOL = {"bf16": 0.25, "f32": 2e-3}


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside the script")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _log(f"device: {torch.cuda.get_device_name(0)} "
         f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
         f"cuda {torch.version.cuda}")
    _log(smi)


def phase_build() -> None:
    from service_account_auth_improvements_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build("flash_fwd")
    _log(f"build: flash_fwd in {time.perf_counter() - t0:.1f} s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                _log(f"  ptxas: {line.strip()}")


def _qkv(b, s, h, hkv, d, dtype, gen):
    """Model-layout [b, s, heads, d] inputs on the card, from a seed."""
    def mk(heads):
        return torch.randn((b, s, heads, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    return mk(h), mk(hkv), mk(hkv)


def _check(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} "
            f"rtol {rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def kernel_bound(b, h, hkv, sq, sk, d, dtype, causal) -> tuple[float, str]:
    """Least time for one flash forward: its flops (the causal pairs this
    call really has) over the peak for the dtype, or its bytes (q, k, v
    read once; o, lse written once) over the HBM rate, whichever is
    larger; and which of the two it is."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    flops = 4 * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * d + 2 * b * hkv * sk * d) * item \
        + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> dict:
    """K1 against flash_fwd_reference on the card; returns the numbers
    of the main path's shape (bf16, causal, b 4, s 1000)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # name, b, s, h, hkv, d, dtype, causal, through the public wrapper
        ("gqa s1024 bf16", 4, 1024, 12, 4, 128, torch.bfloat16, True, False),
        ("gqa s1024 f32", 4, 1024, 12, 4, 128, torch.float32, True, False),
        ("gqa s1000 bf16 wrapper", 4, 1000, 12, 4, 128, torch.bfloat16,
         True, True),
        ("gqa s2047 bf16 wrapper", 1, 2047, 12, 4, 128, torch.bfloat16,
         True, True),
        ("gqa s1000 f32 wrapper", 2, 1000, 12, 4, 128, torch.float32, True,
         True),
        ("mha s512 bf16", 2, 512, 8, 8, 128, torch.bfloat16, True, False),
        ("non-causal s512 bf16", 2, 512, 12, 4, 128, torch.bfloat16, False,
         True),
        ("non-causal s512 f32", 2, 512, 12, 4, 128, torch.float32, False,
         False),
        ("gqa s384 d64 bf16", 2, 384, 8, 2, 64, torch.bfloat16, True, False),
    ]
    worst = 0.0
    for name, b, s, h, hkv, d, dtype, causal, wrapper in cases:
        q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want_o, want_lse = fa.flash_fwd_reference(qt, kt, vt, causal)
        atol, rtol = TOL[dtype]
        before = fa.launches
        if wrapper:
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = _check(name, got, want_o.transpose(1, 2), atol, rtol)
        else:
            got_o, got_lse = fa.flash_fwd(qt, kt, vt, causal)
            torch.cuda.synchronize()
            err = _check(name, got_o, want_o, atol, rtol)
            lerr = _check(name + " lse", got_lse, want_lse, LSE_ATOL, 0.0)
            _log(f"  lse max abs err {lerr:.3e}")
        if fa.launches != before + 1:
            raise AssertionError(f"{name}: the kernel did not launch")
        worst = max(worst, err)
        _log(f"kernel {name}: max abs err {err:.3e} "
             f"(atol {atol}, rtol {rtol})")

    # timing at the serving path's shape, and at s 1024
    timed = {}
    for s in (PROMPT, 1024):
        b, h, hkv, d, dtype = BATCH, 12, 4, 128, torch.bfloat16
        q, k, v = _qkv(b, s, h, hkv, d, dtype, gen)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = _time_ms(lambda: fa.flash_fwd(qt, kt, vt, True))
        plain_ms = _time_ms(lambda: fa.flash_fwd_reference(qt, kt, vt, True))
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E501
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = kernel_bound(b, h, hkv, s, s, d, dtype, True)
        _log(f"time b{b} s{s} h{h} hkv{hkv} d{d} bf16 causal: kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
             f"bound {bound_ms:.4f} ms ({bound_by})")
        timed[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
    q, k, v = _qkv(2, PROMPT, 12, 4, 128, torch.float32, gen)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = _time_ms(lambda: fa.flash_fwd(qt, kt, vt, True), iters=5)
    _log(f"time b2 s{PROMPT} h12 hkv4 d128 f32 causal: kernel {ms:.4f} ms")
    return dict(max_abs_err=worst, **timed[PROMPT])


def _http(base: str, path: str, body: dict | None = None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data)
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return r.read()


def _assert_completion(name, out, vocab):
    rows = out["completion_ids"]
    if len(rows) != BATCH or any(len(r) != NEW for r in rows):
        raise AssertionError(f"{name}: expected {BATCH} rows of {NEW} ids, "
                             f"got {[len(r) for r in rows]}")
    if not all(0 <= t < vocab for r in rows for t in r):
        raise AssertionError(f"{name}: ids outside the vocabulary")
    if out["usage"] != {"prompt_tokens": BATCH * PROMPT,
                        "completion_tokens": BATCH * NEW}:
        raise AssertionError(f"{name}: usage {out['usage']}")


def phase_serving() -> dict:
    """The port's main path: GenerationService at bench_800m (bf16
    weights from a seed, per-length prefill) behind make_server. Returns
    the kernel launch counts of exactly that run."""
    import dataclasses
    import threading

    from service_account_auth_improvements_tpu_torch.models import (
        generate,
        llama,
        serving,
    )
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    cfg = dataclasses.replace(llama.PRESETS[PRESET], param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    _log(f"serving: {PRESET} ({cfg.param_count() / 1e6:.1f}M params, "
         f"bf16) initialised in {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    prompts = prompts.tolist()
    svc = serving.GenerationService(cfg, params, prefill_window=0,
                                    device="cuda", name=PRESET)
    httpd = serving.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % httpd.server_address
    greedy = {"prompt_ids": prompts, "max_new_tokens": NEW}
    sampled = dict(greedy, temperature=0.8, top_k=40, top_p=0.95, seed=1234)
    timings = {}
    fa.launches = 0  # the main path's run starts here
    try:
        for name, body in (("greedy", greedy), ("greedy again", greedy),
                           ("sampled", sampled)):
            t0 = time.perf_counter()
            out = json.loads(_http(base, "/v1/completions", body))
            timings[name] = time.perf_counter() - t0
            _assert_completion(name, out, cfg.vocab_size)
            _log(f"serving {name}: {timings[name] * 1e3:.1f} ms for "
                 f"{BATCH} x ({PROMPT} + {NEW}) tokens; row 0 starts "
                 f"{out['completion_ids'][0][:8]}")
            if name == "greedy":
                first = out
            elif name == "greedy again" and out != first:
                raise AssertionError("repeated greedy request differs")
        t0 = time.perf_counter()
        raw = _http(base, "/v1/completions", dict(greedy, stream=True))
        timings["stream"] = time.perf_counter() - t0
        events = [e[6:] for e in raw.decode().split("\n\n") if e]
        if events[-1] != "[DONE]" or any('"error"' in e for e in events):
            raise AssertionError(f"stream ended badly: {events[-2:]}")
        streamed = [[] for _ in range(BATCH)]
        for e in events[:-1]:
            for row, ids in zip(streamed, json.loads(e)["ids"]):
                row.extend(ids)
        if streamed != first["completion_ids"]:
            raise AssertionError("streamed greedy ids differ from one-shot")
        _log(f"serving stream: {len(events) - 1} events, "
             f"{timings['stream'] * 1e3:.1f} ms")
        if json.loads(_http(base, "/healthz")) != {"ok": True}:
            raise AssertionError("/healthz")
        metrics = _http(base, "/metrics").decode()
        for want in ('serving_requests_total{mode="oneshot",code="200"} 3.0',
                     'serving_requests_total{mode="stream",code="200"} 1.0',
                     f"serving_completion_tokens_total {4 * BATCH * NEW}.0"):
            if want not in metrics:
                raise AssertionError(f"/metrics lacks {want!r}")
    finally:
        launches = {"flash_fwd": fa.launches}  # read just after the run
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    prefills = 4  # one per-length prefill per completion request
    if launches["flash_fwd"] != cfg.n_layers * prefills:
        raise AssertionError(
            f"flash_fwd launched {launches['flash_fwd']} times; expected "
            f"{cfg.n_layers} layers x {prefills} prefills")
    _log(f"serving: flash_fwd launches {launches['flash_fwd']} = "
         f"{cfg.n_layers} layers x {prefills} prefills")

    # outside the counted run: the first greedy token against the model's
    # own forward, and flash attention against dense attention
    toks = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits = llama.apply(cfg, params, toks)
        want_first = logits[:, -1].argmax(-1).tolist()
        if want_first != [r[0] for r in first["completion_ids"]]:
            raise AssertionError("first greedy token differs from "
                                 "argmax of llama.apply")
        short = toks[:2, :256]
        flash = llama.apply(cfg, params, short)
        dense = llama.apply(dataclasses.replace(cfg, attn_impl="dense"),
                            params, short)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        flash32 = llama.apply(cfg32, params, short)
        dense32 = llama.apply(dataclasses.replace(cfg32, attn_impl="dense"),
                              params, short)
    for name, (f, d), atol in (("bf16", (flash, dense), APPLY_ATOL["bf16"]),
                               ("f32", (flash32, dense32),
                                APPLY_ATOL["f32"])):
        err = (f - d).abs()
        agree = (f.argmax(-1) == d.argmax(-1)).float().mean().item()
        _log(f"apply flash vs dense (b 2, s 256, {name}): max abs err "
             f"{err.max().item():.4e}, mean {err.mean().item():.4e}, logit "
             f"std {d.std().item():.4f}, argmax agreement {agree:.4f}")
        if not torch.isfinite(f).all() or err.max().item() > atol:
            raise AssertionError(f"{name} flash vs dense logits differ by "
                                 f"{err.max().item():.4e} > {atol}")

    # where a request's time goes: one per-length prefill (flash, and
    # dense for comparison) and one decode step, on the card's clock
    with torch.inference_mode():
        for impl in ("flash", "dense"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            ms = _time_ms(lambda: generate.prefill(
                c, params, toks, PROMPT + NEW, device="cuda"), iters=3,
                warmup=1)
            _log(f"time prefill {impl} b{BATCH} s{PROMPT}: {ms:.2f} ms")
        cache, _ = generate.prefill(cfg, params, toks, PROMPT + NEW,
                                    device="cuda")
        cos, sin = generate._rope(cfg, PROMPT + NEW, toks.device)
        token = toks[:, -1]
        ms = _time_ms(lambda: generate._decode_step(
            cfg, params, cache._replace(length=PROMPT), token, cos, sin),
            iters=10, warmup=2)
        _log(f"time decode step b{BATCH} cache {PROMPT + NEW}: {ms:.2f} ms")
        _profile_request(cfg, params, toks, generate)
    return launches


def _profile_request(cfg, params, toks, generate) -> None:
    """One greedy request's work (per-length prefill + NEW - 1 decode
    steps) under torch.profiler: the card's busy time by kernel, and its
    idle share of the wall time (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        generate.generate(cfg, params, toks, NEW, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        _log("profile: the profiler saw no device time (not measured)")
        return
    _log(f"profile greedy b{BATCH} {PROMPT}+{NEW}: wall {wall_ms:.1f} ms, "
         f"device busy {busy_ms:.1f} ms, idle share "
         f"{1 - busy_ms / wall_ms:.3f}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        _log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
             f"{e.key[:90]}")


def main() -> int:
    # full f32 products everywhere (no TF32), as the f32 checks assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    k1 = phase_kernels()
    launches = phase_serving()
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_fwd.cu",
        "replaces": "service_account_auth_improvements_tpu/ops/"
                    "flash_attention.py:113",
        "launches": launches["flash_fwd"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
