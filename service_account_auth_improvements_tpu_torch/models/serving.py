"""Minimal generation server: the KV-cache decode path over HTTP (port of
``models/serving.py``).

Serves ``POST /v1/completions`` (ids in → ids out, OpenAI-shaped body,
one-shot or SSE), ``/healthz``, ``/v1/models`` and ``/metrics`` from a
stdlib ThreadingHTTPServer, with the reference's validation, bounds and
power-of-two buckets (max_new_tokens and top_k run at the next power of
two; completions are truncated to the requested n). Generation is
serialized under a lock (one card); open streams are bounded by a
semaphore (429 past it).

Prompts go through the fixed-window chunked prefill by default
(``DEFAULT_PREFILL_WINDOW``); ``prefill_window=0``/None selects the
per-length prefill, the path that runs flash attention — the Hopper
kernel — under ``attn_impl="flash"`` presets.

The server completes the train → checkpoint → serve lifecycle: ``main``
loads a training checkpoint's params (``--checkpoint-dir``), optionally
as int8 weights (``--int8``, models/quantize.py), and with a draft model
(``--draft-preset``) decodes single-prompt requests speculatively
(models/speculative.py).

``--tp``/``--fsdp`` serve a model sharded over a mesh, one process per
card as the training CLI runs (``parallel/multihost.py``): the params
are restored straight onto the mesh (or drawn whole and laid out by the
rules), and every rank decodes in the mesh's region
(``models/generate.py``). Rank 0 alone runs the HTTP server; it
broadcasts each validated request (ids, sampling parameters, seed) to
the other ranks, which decode it in lockstep (``GenerationService.
follow``) and draw the same tokens from the same generator seed. On a
mesh the service runs one request at a time, each whole: the followers
take requests in order, so a stream holds the mesh until it ends, and a
stream whose client leaves is still decoded to its end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch
import torch.distributed as dist

from service_account_auth_improvements_tpu_torch.models import (
    generate,
    llama,
    quantize,
    speculative,
)
from service_account_auth_improvements_tpu_torch.parallel import (
    multihost,
    sharding,
)
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    MeshConfig,
    check_mesh,
    make_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.train import checkpoint
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
from service_account_auth_improvements_tpu_torch.utils.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
)


class BadRequest(ValueError):
    pass


class TooBusy(RuntimeError):
    """Concurrent-stream cap reached → HTTP 429."""


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


#: prompt-length bucket for the default chunked prefill
DEFAULT_PREFILL_WINDOW = 512


def _scalar(body: dict, name: str, cast, default, lo=None, hi=None):
    """Coerce and range-check an optional scalar field; malformed or
    out-of-range input is the CLIENT's error (400). JSON null stands for
    "absent" only when the default is None; booleans are never numbers;
    a fractional float is not an int."""
    v = body.get(name, default)
    if v is None:
        if default is None:
            return None
        raise BadRequest(f"{name} must be a {cast.__name__}, not null")
    if isinstance(v, bool):
        raise BadRequest(f"{name} must be a {cast.__name__}, not a "
                         f"boolean")
    if not isinstance(v, (int, float)):
        raise BadRequest(f"{name} must be a {cast.__name__}")
    if cast is int and isinstance(v, float) and not v.is_integer():
        raise BadRequest(f"{name} must be an integer")
    try:
        v = cast(v)
    except (TypeError, ValueError, OverflowError):
        raise BadRequest(f"{name} must be a {cast.__name__}")
    if not math.isfinite(v):
        raise BadRequest(f"{name} must be finite")
    if (lo is not None and v < lo) or (hi is not None and v > hi):
        raise BadRequest(f"{name} must be in [{lo}, {hi}]")
    return v


def _serving_mesh(mesh):
    """``mesh``, if the decode can run on it: tp and fsdp (and dp, whose
    ranks decode alike); a pipeline or a split sequence raises."""
    check_mesh(mesh)
    for axis in ("pp", "sp"):
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            raise ValueError(f"serving runs on a tp/fsdp mesh; {axis} > 1 "
                             "splits the layers or the prompt")
    return mesh


def _local_tree(tree):
    """A params tree with each ``DTensor`` (and each int8 weight's values
    and scale) replaced by this rank's block."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, quantize.QuantizedTensor):
        return quantize.QuantizedTensor(sharding.to_local(tree.values),
                                        sharding.to_local(tree.scale))
    return sharding.to_local(tree)


class GenerationService:
    """Validates requests and runs the decode; thread-safe."""

    STREAM_CHUNK = 16

    def __init__(self, cfg: llama.LlamaConfig, params,
                 max_new_cap: int = 512, max_batch: int = 8,
                 max_streams: int = 4, name: str = "llama",
                 prefill_window: int | None = DEFAULT_PREFILL_WINDOW,
                 draft: tuple | None = None, gamma: int = 4, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        # a sharded model (tp/fsdp over a parallel.make_mesh mesh): its
        # params are DTensors laid out by the rules (or their local
        # blocks), and the decodes run in the mesh's region
        self.mesh = None if mesh is None else _serving_mesh(mesh)
        self.params = _local_tree(params)
        if draft is not None:
            draft = (draft[0], _local_tree(draft[1]))
        # (draft_cfg, draft_params): single-prompt requests without top-k
        # or top-p decode speculatively — the same output distribution,
        # fewer target forwards (models/speculative.py)
        if draft is not None and draft[0].vocab_size != cfg.vocab_size:
            raise ValueError("draft vocab must match the target's")
        self.draft = draft
        self.gamma = gamma
        self.prefill_window = prefill_window or None
        self.max_new_cap = max_new_cap
        self.max_batch = max_batch
        self.name = name
        self._lock = threading.Lock()
        # each open stream pins a KV cache between chunks (the lock wraps
        # only the decodes): bound them
        self._streams = threading.Semaphore(max_streams)
        self.registry = Registry()
        self.m_requests = Counter(
            "serving_requests_total", "completion requests by outcome",
            labels=("mode", "code"), registry=self.registry)
        self.m_tokens = Counter(
            "serving_completion_tokens_total", "tokens generated",
            registry=self.registry)
        self.m_latency = Histogram(
            "serving_request_seconds", "one-shot completion latency",
            buckets=Histogram.DEFAULT_BUCKETS, registry=self.registry)
        self.m_streams = Gauge(
            "serving_streams_active", "open SSE streams",
            registry=self.registry)
        # on a mesh, rank 0 runs each request whole under this lock and
        # announces it to the followers first
        self._request = threading.Lock()

    def _mesh_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh)

    @property
    def leader(self) -> bool:
        """Whether this process takes the requests (rank 0 of a mesh, or
        the only one)."""
        return self.mesh is None or dist.get_rank() == 0

    def _announce(self, message) -> bool:
        """On a mesh's rank 0: take the request lock and broadcast
        ``message`` to the followers (True); otherwise nothing (False)."""
        if self.mesh is None:
            return False
        self._request.acquire()
        dist.broadcast_object_list([message], src=0)
        return True

    def follow(self) -> None:
        """On every rank of a mesh but 0: decode each request rank 0
        announces, in its order, until it calls ``stop``. A request that
        fails fails on rank 0 as well, which reports it."""
        if self.mesh is None or self.leader:
            raise RuntimeError("follow() runs on the ranks after 0 of a "
                               "mesh")
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0)
            if msg[0] is None:
                return
            kind, body = msg[0]
            try:
                if kind == "complete":
                    self._complete(body)
                else:
                    toks, _, n, n_run, sampling, gen = self._parse(body)
                    for _ in self._stream_chunks(toks, n, n_run, sampling,
                                                 gen):
                        pass
            except Exception:  # noqa: BLE001 - rank 0 answers it
                # the follower keeps serving; the failure is rank 0's to
                # report (the request fails there too), the trace here
                traceback.print_exc()

    def stop(self) -> None:
        """On a mesh's rank 0: release the followers."""
        if self._announce(None):
            self._request.release()

    def info(self) -> dict:
        return {
            "id": self.name,
            "vocab_size": self.cfg.vocab_size,
            "max_seq_len": self.cfg.max_seq_len,
            "params": self.cfg.param_count(),
            "max_new_tokens_cap": self.max_new_cap,
            "max_batch": self.max_batch,
        }

    def _parse(self, body: dict):
        """Validate a completions request → (toks, s, n, n_run, sampling
        kwargs, generator). Raises BadRequest."""
        prompts = body.get("prompt_ids")
        if isinstance(prompts, list) and prompts and isinstance(
                prompts[0], int):
            prompts = [prompts]
        if (not isinstance(prompts, list) or not prompts
                or not all(isinstance(p, list) and p for p in prompts)):
            raise BadRequest("prompt_ids must be a non-empty id list "
                             "or list of id lists")
        if len(prompts) > self.max_batch:
            raise BadRequest(f"at most {self.max_batch} prompts "
                             f"per request")
        s = len(prompts[0])
        if any(len(p) != s for p in prompts):
            raise BadRequest("all prompts must have equal length "
                             "(bucket or pad upstream)")
        flat = [t for p in prompts for t in p]
        if not all(isinstance(t, int) and 0 <= t < self.cfg.vocab_size
                   for t in flat):
            raise BadRequest(f"token ids must be ints in "
                             f"[0, {self.cfg.vocab_size})")
        n = _scalar(body, "max_new_tokens", int, 16,
                    lo=1, hi=self.max_new_cap)
        if s + n > self.cfg.max_seq_len:
            raise BadRequest(f"prompt+completion exceeds max_seq_len "
                             f"{self.cfg.max_seq_len}")
        temperature = _scalar(body, "temperature", float, 0.0,
                              lo=0.0, hi=100.0)
        top_k = _scalar(body, "top_k", int, 0,
                        lo=0, hi=min(1024, self.cfg.vocab_size))
        if top_k:
            top_k = min(_next_pow2(top_k), self.cfg.vocab_size)
        top_p = _scalar(body, "top_p", float, 0.0, lo=0.0, hi=1.0)
        eos_id = _scalar(body, "eos_id", int, None,
                         lo=0, hi=self.cfg.vocab_size - 1)
        seed = _scalar(body, "seed", int, 0, lo=0, hi=2**32 - 1)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        # run the next power of two and truncate; near the context limit,
        # clamp to the remaining window
        n_run = min(_next_pow2(n), self.cfg.max_seq_len - s)
        sampling = {"temperature": temperature, "top_k": top_k,
                    "top_p": top_p, "eos_id": eos_id}
        toks = torch.tensor(prompts, dtype=torch.long, device=self.device)
        return toks, s, n, n_run, sampling, generator

    def complete(self, body: dict) -> dict:
        if self.mesh is not None:
            self._parse(body)  # a bad request fails here, on rank 0 alone
        held = self._announce(("complete", body))
        try:
            return self._complete(body)
        finally:
            if held:
                self._request.release()

    def _complete(self, body: dict) -> dict:
        toks, s, n, n_run, sampling, generator = self._parse(body)
        t0 = time.perf_counter()
        spec_stats = None
        if (self.draft is not None and toks.shape[0] == 1
                and not sampling["top_k"] and not sampling["top_p"]):
            dcfg, dparams = self.draft
            # the requested n bounds the decode; the caches get the pow-2
            # bucket, as the other paths do
            with self._lock, self._mesh_ctx():
                out, spec_stats = speculative.spec_generate(
                    self.cfg, self.params, dcfg, dparams, toks, n,
                    gamma=self.gamma, generator=generator,
                    temperature=sampling["temperature"],
                    eos_id=sampling["eos_id"], alloc_tokens=n_run,
                    prefill_window=self.prefill_window, device=self.device)
            # spec_generate stops at (and includes) the first eos
            completion = out[:, s:s + n].tolist()
        else:
            # the chunked decode path the SSE streams use: chunks truncate
            # at eos and stop early once every row is done
            completion = [[] for _ in range(toks.shape[0])]
            for chunk in self._stream_chunks(toks, n, n_run, sampling,
                                             generator):
                for row, ids in zip(completion, chunk):
                    row.extend(ids)
        n_tokens = sum(len(r) for r in completion)
        self.m_latency.observe(time.perf_counter() - t0)
        self.m_tokens.inc(n_tokens)
        return {
            "model": self.name,
            "completion_ids": completion,
            # the EFFECTIVE top_k: pow-2 bucketed, 0 for greedy requests
            "top_k": (0 if sampling["temperature"] == 0.0
                      else sampling["top_k"]),
            "usage": {
                "prompt_tokens": toks.shape[0] * s,
                "completion_tokens": n_tokens,
            },
            **({"speculative": spec_stats} if spec_stats else {}),
        }

    def stream_events(self, body: dict):
        """Validate eagerly, then return an iterator of per-chunk token
        lists (``[rows][tokens]``) for SSE. Raises TooBusy (429) at the
        concurrent-stream cap."""
        toks, s, n, n_run, sampling, generator = self._parse(body)
        gen = self._stream_iter(toks, n, n_run, sampling, generator, body)
        # prime to the sentinel: TooBusy raises HERE, before any header
        # goes out, and the started generator's close() always runs its
        # finally (releasing the stream slot)
        next(gen)
        return gen

    def _stream_iter(self, toks, n, n_run, sampling, generator, body):
        if not self._streams.acquire(blocking=False):
            raise TooBusy("too many concurrent streams; retry")
        self.m_streams.inc()
        held = False
        chunks = self._stream_chunks(toks, n, n_run, sampling, generator)
        try:
            held = self._announce(("stream", body))
            yield None  # primed sentinel (consumed by stream_events)
            for chunk in chunks:
                self.m_tokens.inc(sum(len(r) for r in chunk))
                yield chunk
        finally:
            if held:
                # the followers decode the whole request: so does rank 0
                for _ in chunks:
                    pass
                self._request.release()
            self._streams.release()
            self.m_streams.inc(-1)

    def _stream_chunks(self, toks, n, n_run, sampling, generator):
        # the lock wraps each DECODE, never a client write
        eos_id = sampling["eos_id"]
        with self._lock, self._mesh_ctx():
            state, first = generate.start_stream(
                self.cfg, self.params, toks, n_run, generator=generator,
                prefill_window=self.prefill_window, device=self.device,
                **sampling
            )
            first = first.tolist()  # one bulk transfer, not per token
        yield [[t] for t in first]
        row_done = ([t == eos_id for t in first] if eos_id is not None
                    else [False] * len(first))
        remaining, produced = n - 1, 0
        # the done check is a device->host sync: skipped when no eos is set
        while remaining > 0 and not (
                eos_id is not None and bool(state.done.all())):
            # bucket the tail chunk by remaining's power of two
            c = min(self.STREAM_CHUNK, n_run - produced,
                    _next_pow2(remaining))
            with self._lock, self._mesh_ctx():
                state, out = generate.stream_decode(
                    self.cfg, self.params, state, c, device=self.device,
                    **sampling
                )
                out = out.tolist()
            produced += c
            emit = min(c, remaining)
            chunk = []
            for i, row in enumerate(out):
                ids = [] if row_done[i] else row[:emit]
                if eos_id is not None and eos_id in ids:
                    ids = ids[: ids.index(eos_id) + 1]
                    row_done[i] = True
                chunk.append(ids)
            yield chunk
            remaining -= emit


def make_server(service: GenerationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (but do not serve) an HTTP server for ``service``; callers
    run ``serve_forever()`` and MUST ``shutdown()``/``server_close()``."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/v1/models":
                self._reply(200, {"data": [service.info()]})
            elif self.path == "/metrics":
                data = service.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._reply(404, {"error": "not found"})
                return
            mode = "oneshot"  # until the stream flag parses
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    raise BadRequest("invalid Content-Length")
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise BadRequest("body must be a JSON object")
                stream = body.get("stream", False)
                if not isinstance(stream, bool):
                    raise BadRequest("stream must be a boolean")
                mode = "stream" if stream else "oneshot"
                if stream:
                    self._stream(service.stream_events(body))
                else:
                    self._reply(200, service.complete(body))
                # counted after the reply went out: a failed write must
                # not record a phantom 200 next to the 500
                service.m_requests.labels(mode, 200).inc()
            except BadRequest as e:
                service.m_requests.labels(mode, 400).inc()
                self._reply(400, {"error": str(e)})
            except TooBusy as e:
                service.m_requests.labels(mode, 429).inc()
                self._reply(429, {"error": str(e)})
            except json.JSONDecodeError:
                service.m_requests.labels(mode, 400).inc()
                self._reply(400, {"error": "invalid JSON"})
            except Exception as e:  # surface, don't kill the thread
                service.m_requests.labels(mode, 500).inc()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, events):
            """SSE: one `data:` event per decode chunk, then [DONE].
            Once the 200 is out, errors can only be signalled in-band."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for chunk in events:
                    self.wfile.write(
                        b"data: " + json.dumps({"ids": chunk}).encode()
                        + b"\n\n"
                    )
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except BrokenPipeError:
                pass  # client went away mid-stream
            except Exception as e:
                try:
                    self.wfile.write(
                        b"data: " + json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode() + b"\n\n"
                    )
                except OSError:
                    pass
            finally:
                events.close()  # deterministic stream-slot release

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="llama3_1b")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="default cuda; the CPU only when asked for")
    ap.add_argument("--checkpoint-dir",
                    help="checkpoint directory from train/checkpoint.py "
                         "(its newest step); random init when omitted "
                         "(demo mode)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 (models/quantize.py)")
    ap.add_argument("--max-new-cap", type=int, default=512)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways: shard the model over a tp "
                         "mesh, one process per card (the controller's "
                         "rendezvous env, parallel/multihost.py)")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="fsdp ways composed with --tp")
    ap.add_argument("--draft-preset",
                    help="enable speculative decoding with this draft "
                         "model (same vocab) for single-prompt requests")
    ap.add_argument("--draft-checkpoint-dir",
                    help="checkpoint for the draft model (random init "
                         "without it — demo only: a random draft accepts "
                         "~nothing and SLOWS serving down)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens proposed per verify round")
    ap.add_argument("--prefill-window", type=int,
                    default=DEFAULT_PREFILL_WINDOW,
                    help="prompt-length bucket (fixed-window chunked "
                         "prefill); 0 selects the per-length prefill, "
                         "which runs flash attention")
    args = ap.parse_args(argv)
    if args.tp < 1 or args.fsdp < 1:
        ap.error("--tp and --fsdp must be >= 1")
    if args.gamma < 1:
        ap.error("--gamma must be >= 1")
    if args.prefill_window < 0:
        ap.error("--prefill-window must be >= 0 (0 disables)")
    device = resolve_device(args.device)
    mesh = None
    plan = multihost.rendezvous_plan()
    if args.tp * args.fsdp > 1 or plan.num_processes > 1:
        config = MeshConfig(dp=1, fsdp=args.fsdp, tp=args.tp)
        config.resolve(plan.num_processes)  # before any process starts
        multihost.maybe_initialize(args.device)
        mesh = make_mesh(config, args.device)
        device = resolve_device(args.device)

    import dataclasses

    def load(preset, checkpoint_dir, seed):
        cfg = dataclasses.replace(llama.PRESETS[preset],
                                  param_dtype="bfloat16")
        if checkpoint_dir:
            # params only, straight onto the mesh when there is one: the
            # optimizer moments are never read
            params = checkpoint.restore_params(checkpoint_dir, mesh, cfg,
                                               device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = llama.init(cfg, gen, device=device)
            if mesh is not None:
                params = sharding.tree_distribute(params, mesh,
                                                  llama.logical_axes(cfg))
        if args.int8:
            params = quantize.quantize_params(params)
        return cfg, params

    cfg, params = load(args.preset, args.checkpoint_dir, 0)
    draft = None
    if args.draft_preset:
        if not args.draft_checkpoint_dir:
            print("WARNING: random-init draft (no --draft-checkpoint-dir) "
                  "— demo only, acceptance will be ~0")
        draft = load(args.draft_preset, args.draft_checkpoint_dir, 1)
    service = GenerationService(cfg, params, max_new_cap=args.max_new_cap,
                                name=args.preset,
                                prefill_window=args.prefill_window,
                                draft=draft, gamma=args.gamma,
                                device=device, mesh=mesh)
    if not service.leader:
        service.follow()
        return 0
    httpd = make_server(service, args.host, args.port)
    print(f"serving {args.preset} on {httpd.server_address} ({device}"
          + ("" if mesh is None else f", mesh of {mesh.size()}") + ")",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
