#!/usr/bin/env python3
"""Phase 12 of chip_smoke.py (``phase_wide_heads``) alone, on one CUDA
card, for the configurations of ``chip_smoke.WIDE_HEADS`` named on the
command line, in the order named (all of them, in their order, without
names): each one's training steps with each timed step's ms on the card's
clock and on the host's, then its serving and flash-against-dense steps
where phase 12 runs them.

Run from the repository root on a machine with a card and ``nvcc``::

    python3 wide_steps.py [--other-k1] [--other-wide] [--profile NAME]
                          [--steps N] [--watch] [NAME ...]

``--other-k1`` runs K1 from the ``-DFLASH_OTHER_DESIGNS=1`` build of
``csrc/flash_fwd.cu`` (at d 384 ``flash_fwd_split`` in place of
``flash_fwd_pair``), K2 and K3 from the shipped build. ``--other-wide``
runs the head dims above 512 from that build of ``csrc/flash_wide.cu``
(the column groups in place of the clusters: at d 768 bf16's
``dkv_wide_groups`` for ``dkv_wide``, f32's ``*_wide_f32_groups``). ``--profile NAME``
runs NAME's timed steps under ``torch.profiler`` and prints the card's
busy time by kernel and the host's calls that took the most time.
``--steps N`` takes N training steps a configuration (chip_smoke's
WIDE_STEPS without it; the first is the warm-up). ``--watch`` logs, in
every timed window, each point where the host's main thread stayed
longer than WATCH_S (its Python stack, from a thread that samples it
every WATCH_EVERY_S; a gap in that thread's own samples means the GIL
was held) and each garbage collection that took longer than WATCH_GC_S.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import sys
import threading
import time
import traceback

import torch

import chip_smoke as cs

WATCH_S = 0.2  # a stay of the main thread at one point worth logging
WATCH_EVERY_S = 0.01  # how often the watcher samples the main thread
WATCH_GC_S = 0.01  # a garbage collection worth logging


@contextlib.contextmanager
def _profiled():
    """The timed steps under torch.profiler: the card's time by kernel
    and the host's by call, summed over the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    cs._log(f"profile of the timed steps: card busy "
            f"{sum(e.self_device_time_total for e in device) / 1e3:.2f} ms")
    for e in device[:15]:
        cs._log(f"  card {e.self_device_time_total / 1e3:9.2f} ms "
                f"{e.count:6d}x {e.key[:90]}")
    for e in host[:15]:
        cs._log(f"  host {e.self_cpu_time_total / 1e3:9.2f} ms "
                f"{e.count:6d}x {e.key[:90]}")


def _where(frame) -> str:
    """The innermost frames of ``frame``'s stack, innermost last."""
    if frame is None:
        return "(no frame)"
    return " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                       for f in reversed(traceback.extract_stack(frame,
                                                                 limit=6)))


@contextlib.contextmanager
def _watched(name: str):
    """Log where the main thread stays longer than WATCH_S, gaps in the
    watcher's own samples (the GIL held that long) and garbage
    collections longer than WATCH_GC_S, while the block runs."""
    main = threading.main_thread().ident
    stop = threading.Event()
    gc_start = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            took = time.perf_counter() - gc_start.pop("t")
            if took > WATCH_GC_S:
                cs._log(f"watch {name}: garbage collection of generation "
                        f"{info['generation']} took {took:.3f} s")

    def run():
        key, since, logged = None, time.perf_counter(), False
        tick, before = since, None
        while not stop.wait(WATCH_EVERY_S):
            now = time.perf_counter()
            frame = sys._current_frames().get(main)
            here = _where(frame)
            if now - tick > WATCH_S:
                cs._log(f"watch {name}: no sample for {now - tick:.3f} s "
                        f"(the GIL held): before at {before}; after at "
                        f"{here}")
            at = (id(frame), frame.f_lasti) if frame is not None else None
            if at != key:
                if logged:
                    cs._log(f"watch {name}:   ... there {now - since:.3f} s")
                key, since, logged = at, now, False
            elif not logged and now - since > WATCH_S:
                cs._log(f"watch {name}: main thread seen at one place for "
                        f"over {WATCH_S} s: {here}")
                logged = True
            tick, before = now, here

    thread = threading.Thread(target=run, daemon=True)
    gc.callbacks.append(on_gc)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
        gc.callbacks.remove(on_gc)


def parse_args(argv=None) -> argparse.Namespace:
    """The command line: names of ``chip_smoke.WIDE_HEADS`` (all of
    them, in their order, if none), ``--other-k1``, ``--other-wide``,
    ``--profile NAME``, ``--steps N``, ``--watch``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("names", nargs="*", metavar="NAME")
    parser.add_argument("--other-k1", action="store_true")
    parser.add_argument("--other-wide", action="store_true")
    parser.add_argument("--profile", choices=list(cs.WIDE_HEADS))
    parser.add_argument("--steps", type=int, default=cs.WIDE_STEPS)
    parser.add_argument("--watch", action="store_true")
    args = parser.parse_args(argv)
    if args.steps < 2:
        parser.error("--steps: at least 2 (a warm-up and a timed step)")
    if unknown := set(args.names) - set(cs.WIDE_HEADS):
        parser.error(f"not in WIDE_HEADS: {sorted(unknown)}")
    args.names = args.names or list(cs.WIDE_HEADS)
    return args


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("wide_steps.py: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    from service_account_auth_improvements_tpu_torch.ops import _build

    for name in cs.KERNEL_SOURCES:
        _build.load(name)
    if args.other_k1:
        path = cs._build_other_designs("flash_fwd")
        _build._libs["flash_fwd"] = ctypes.CDLL(str(path))
        cs._log(f"K1 from the other build: {path.name}")
    if args.other_wide:
        path = cs._build_other_designs(cs.WIDE_SOURCE)
        _build._libs[cs.WIDE_SOURCE] = ctypes.CDLL(str(path))
        cs._log(f"the streamed kernels from the other build: {path.name}")
    cs.WIDE_HEADS = {n: cs.WIDE_HEADS[n] for n in args.names}
    cs.WIDE_STEPS = args.steps

    @contextlib.contextmanager
    def window(name):
        with contextlib.ExitStack() as stack:
            if args.watch:
                stack.enter_context(_watched(name))
            if name == args.profile:
                stack.enter_context(_profiled())
            yield

    cs._timed("wide heads", cs.phase_wide_heads, window)
    return 0


if __name__ == "__main__":
    sys.exit(main())
