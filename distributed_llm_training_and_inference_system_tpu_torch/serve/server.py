"""OpenAI-compatible inference server on the standard library.

Counterpart of the JAX package's ``serve/server.py``: ``POST
/v1/completions`` (plain JSON, or server-sent events with ``"stream":
true``), ``GET /health``, ``GET /v1/stats`` (``engine.stats()``) and ``GET
/v1/models``, over ``http.server.ThreadingHTTPServer`` with one engine
thread. Handler threads only enqueue requests and wait; the engine thread
runs ``engine.step()``, which holds the engine lock only around
bookkeeping, never across device work. CORS follows
``ServeConfig.cors_origins`` ("" off, "*" any origin, or a comma-separated
list of origins) with the JAX server's headers, ``OPTIONS`` preflights
included. Every finished request goes to ``observer("inference_request",
payload)`` with the JAX server's payload keys. ``/metrics`` renders the
registry or fails with its error; a server given no registry answers 404
there.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..metrics.observability import CONTENT_TYPE as METRICS_CONTENT_TYPE
from .engine import InferenceEngine
from .scheduler import Request, RequestState, SamplingParams
from .tokenizer import IncrementalDecoder, load_tokenizer

logger = logging.getLogger("llmctl.serve.server")

REQUEST_TIMEOUT_S = 600.0


class BadRequest(ValueError):
    """Completion-body validation failure -> HTTP 400."""


def parse_completion_body(body: dict, tokenizer, vocab_size: int
                          ) -> tuple[list, SamplingParams, bool]:
    """Validate an OpenAI-style /v1/completions body into
    (prompt_tokens, sampling, stream). Raises BadRequest with a
    client-facing message. (The JAX package's function, copied.)"""
    prompt = body.get("prompt", "")
    if isinstance(prompt, list):           # OpenAI also accepts token ids
        if any(isinstance(t, bool) or not isinstance(t, int)
               for t in prompt):
            raise BadRequest("prompt token ids must be integers")
        prompt_tokens = list(prompt)
        bad = [t for t in prompt_tokens if not 0 <= t < vocab_size]
        if bad:
            raise BadRequest(f"prompt token id {bad[0]} outside "
                             f"[0, {vocab_size})")
    else:
        prompt_tokens = tokenizer.encode(str(prompt))
    if not prompt_tokens:
        raise BadRequest("empty prompt")

    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, int)):
        raise BadRequest(f"seed must be an integer, got {seed!r}")
    try:
        sampling = SamplingParams(
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            max_tokens=int(body.get("max_tokens", 64)),
            seed=seed,
        )
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid sampling parameter: {e}") from None
    if sampling.max_tokens < 1:
        raise BadRequest(
            f"max_tokens must be >= 1, got {sampling.max_tokens}")
    return prompt_tokens, sampling, bool(body.get("stream", False))


def cors_headers(origins: str, origin: str, request_headers: str) -> dict:
    """CORS headers for a request from ``origin`` asking for
    ``request_headers`` (its Access-Control-Request-Headers), or only the
    Vary header when the origin is not allowed; {} with CORS off. The JAX
    server's ``_cors_headers``: credentials are asserted only for an
    explicit list (reflecting any origin with credentials would grant more
    than "*"), and Vary goes on every response, denials included, so a
    shared cache keys on the origin."""
    if not origins:
        return {}
    explicit = origins != "*"
    vary = {"Vary": "Origin, Access-Control-Request-Headers"}
    if explicit and origin not in {
            o.strip() for o in origins.split(",") if o.strip()}:
        return vary
    headers = {
        "Access-Control-Allow-Origin": (origin if explicit else "*") or "*",
        "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
        "Access-Control-Allow-Headers": request_headers or "*",
        **vary,
    }
    if explicit:
        headers["Access-Control-Allow-Credentials"] = "true"
    return headers


def _percentile(xs: list, q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(int(q * len(s)), len(s) - 1)]


class InferenceServer:
    """One engine behind a threaded HTTP front. ``start()`` binds
    ``serve_cfg.host:serve_cfg.port`` (port 0 picks a free port) and returns
    the bound port; ``stop()`` shuts down the HTTP loop and the engine
    thread."""

    def __init__(self, model_cfg, serve_cfg, params=None, device=None,
                 seed: int = 0, observer=None, metrics=None):
        """``observer(event, payload)`` receives an "inference_request"
        event for each finished request; ``metrics`` is what ``GET
        /metrics`` renders (anything with a ``render() -> bytes``, such as
        ``metrics.observability.PrometheusExporter``)."""
        self.model_cfg = model_cfg
        self.serve_cfg = serve_cfg
        self.tokenizer = load_tokenizer(serve_cfg.artifact or None,
                                        model_cfg.vocab_size)
        self.engine = InferenceEngine(
            model_cfg, serve_cfg, params=params, seed=seed, device=device,
            eos_token_id=getattr(self.tokenizer, "eos_token_id", None))
        self.observer = observer or (lambda event, payload: None)
        self.metrics = metrics
        self._lock = self.engine.lock
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._waiters: dict[str, threading.Event] = {}
        self._streams: dict[str, queue.Queue] = {}
        self._recent_latencies: list[float] = []
        self._recent_ttfts: list[float] = []
        self._engine_error: Optional[str] = None
        self._engine_error_count = 0
        self.engine.on_finish = self._notify_finished
        self.engine.on_token = self._notify_tokens

    # -- engine thread -------------------------------------------------------

    def _notify_finished(self, req) -> None:
        """Engine-thread callback: wake the handler waiting on ``req``."""
        event = self._waiters.pop(req.request_id, None)
        if event is not None:
            event.set()
        # the stream's reader pops it: batches queued before the end
        # marker are still read
        stream = self._streams.get(req.request_id)
        if stream is not None:
            stream.put(None)                        # end of stream

    def _notify_tokens(self, req, tokens: list) -> None:
        stream = self._streams.get(req.request_id)
        if stream is not None:
            stream.put(list(tokens))

    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                busy = (self.engine.scheduler.queue_depth > 0
                        or self.engine.scheduler.active_count > 0)
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self.engine.step()
                self._engine_error = None
            except Exception as e:   # keep serving: fail the in-flight
                # requests (their waiters fire), report on /health, probe
                logger.exception("engine step failed")
                self._engine_error = f"{type(e).__name__}: {e}"
                self._engine_error_count += 1
                self.engine.fail_all(self._engine_error)
                if self.engine.recover():
                    self._engine_error = None

    # -- request handling ----------------------------------------------------

    def submit(self, body: dict) -> tuple[int, Request | dict]:
        """Validate and enqueue one completion body. Returns (status,
        request) on acceptance, else (status, error body)."""
        try:
            prompt_tokens, sampling, stream = parse_completion_body(
                body, self.tokenizer, self.model_cfg.vocab_size)
        except BadRequest as e:
            return 400, {"error": str(e)}
        req = Request(request_id=f"cmpl-{uuid.uuid4().hex[:24]}",
                      prompt_tokens=prompt_tokens, sampling=sampling)
        req.stream_requested = stream
        self._waiters[req.request_id] = threading.Event()
        if stream:
            self._streams[req.request_id] = queue.Queue()
        with self._lock:
            accepted = self.engine.scheduler.add_request(req)
        if not accepted:
            self._waiters.pop(req.request_id, None)
            self._streams.pop(req.request_id, None)
            if req.error:
                return 400, {"error": req.error}
            return 503, {"error": "server overloaded"}
        self._wake.set()
        return 200, req

    def wait(self, req: Request) -> tuple[int, dict]:
        """Block until ``req`` leaves its slot; the completion body."""
        event = self._waiters.get(req.request_id)
        if event is not None and not event.wait(REQUEST_TIMEOUT_S):
            self._waiters.pop(req.request_id, None)
            with self._lock:
                self.engine.scheduler.cancel(req.request_id)
            return 504, {"error": "timeout"}
        if req.state is RequestState.FAILED:
            return 500, {"error": req.error or "failed"}
        self._record_request_metrics(req)
        n_gen = len(req.generated_tokens)
        return 200, {
            "id": req.request_id,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_cfg.name,
            "choices": [{
                "index": 0,
                "text": self.tokenizer.decode(req.generated_tokens),
                "token_ids": list(req.generated_tokens),
                "finish_reason": req.finish_reason,
            }],
            "usage": {
                "prompt_tokens": req.num_prompt_tokens,
                "completion_tokens": n_gen,
                "total_tokens": req.num_prompt_tokens + n_gen,
            },
            "metrics": {"ttft_ms": req.ttft_ms,
                        "latency_ms": (req.finish_time - req.arrival_time)
                        * 1000.0},
        }

    def stream_chunks(self, req: Request):
        """Yield SSE ``data:`` chunks for ``req`` as its tokens arrive,
        then the final chunk and ``[DONE]``."""
        q = self._streams.get(req.request_id)

        def chunk(text, finish_reason=None, token_ids=()):
            return ("data: " + json.dumps({
                "id": req.request_id, "object": "text_completion",
                "model": self.model_cfg.name,
                "choices": [{"index": 0, "text": text,
                             "token_ids": list(token_ids),
                             "finish_reason": finish_reason}],
            }) + "\n\n").encode()

        decoder = IncrementalDecoder(self.tokenizer)
        deadline = time.monotonic() + REQUEST_TIMEOUT_S
        while q is not None:
            try:
                batch = q.get(timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                with self._lock:
                    self.engine.scheduler.cancel(req.request_id)
                break
            if batch is None:
                break
            yield chunk(decoder.feed(batch), token_ids=batch)
        self._streams.pop(req.request_id, None)
        self._waiters.pop(req.request_id, None)
        self._record_request_metrics(req)
        yield chunk(decoder.finish(), req.finish_reason or "error")
        yield b"data: [DONE]\n\n"

    def cancel(self, req: Request) -> None:
        self._streams.pop(req.request_id, None)
        self._waiters.pop(req.request_id, None)
        if self.serve_cfg.stream_abort_on_disconnect:
            with self._lock:
                self.engine.scheduler.cancel(req.request_id)

    def _record_request_metrics(self, req: Request) -> None:
        """/health percentiles and the observer's event for a finished
        request (the blocking and streaming paths share it)."""
        if req.finish_time is None:
            return
        latency_ms = (req.finish_time - req.arrival_time) * 1000.0
        with self._lock:
            self._recent_latencies = (
                self._recent_latencies + [latency_ms])[-1000:]
            if req.ttft_ms is not None:
                self._recent_ttfts = (
                    self._recent_ttfts + [req.ttft_ms])[-1000:]
            st = self.engine.stats()
        self.observer("inference_request", {
            "latency_ms": latency_ms, "ttft_ms": req.ttft_ms,
            "prompt_tokens": req.num_prompt_tokens,
            "tokens": len(req.generated_tokens),
            "queue_depth": st["queue_depth"],
            "preemptions": st["preemptions"],
            "swap_ins": st["swap_ins"],
            "swapped_host_bytes": st["swapped_host_bytes"],
        })

    def health(self) -> tuple[int, dict]:
        with self._lock:
            stats = self.engine.stats()
            lat, ttft = list(self._recent_latencies), list(self._recent_ttfts)
        healthy = self._engine_error is None
        return (200 if healthy else 503), {
            "status": "healthy" if healthy else "degraded",
            "model": self.model_cfg.name,
            "engine": stats,
            "p50_latency_ms": _percentile(lat, 0.50),
            "ttft_ms": {"p50": _percentile(ttft, 0.50),
                        "p99": _percentile(ttft, 0.99)},
            "last_engine_error": self._engine_error,
            "engine_error_count": self._engine_error_count,
        }

    def stats(self) -> tuple[int, dict]:
        with self._lock:
            return 200, self.engine.stats()

    def models(self) -> tuple[int, dict]:
        return 200, {"object": "list",
                     "data": [{"id": self.model_cfg.name, "object": "model",
                               "owned_by": "llmctl",
                               "max_model_len": self.serve_cfg.max_seq_len}]}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Start the engine thread and the HTTP loop; the bound port."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._engine_loop,
                                        daemon=True, name="llmctl-engine")
        self._thread.start()
        self._http = ThreadingHTTPServer(
            (self.serve_cfg.host, self.serve_cfg.port), _make_handler(self))
        self._http.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True, name="llmctl-http")
        self._http_thread.start()
        port = self._http.server_address[1]
        logger.info("serving %s on %s:%d", self.model_cfg.name,
                    self.serve_cfg.host, port)
        return port

    def stop(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http_thread.join(timeout=10.0)
            self._http = self._http_thread = None
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):     # route to logging
            logger.debug("%s - " + fmt, self.address_string(), *args)

        def _cors(self) -> None:
            for k, v in cors_headers(
                    server.serve_cfg.cors_origins,
                    self.headers.get("Origin", ""),
                    self.headers.get("Access-Control-Request-Headers",
                                     "")).items():
                self.send_header(k, v)

        def _json(self, status: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self._cors()
            self.end_headers()
            self.wfile.write(data)

        def do_OPTIONS(self):           # CORS preflight
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self._cors()
            self.end_headers()

        def _metrics(self) -> None:
            if server.metrics is None:
                self._json(404, {"error": "this server exports no metrics "
                                          "(serve start --prometheus-port)"})
                return
            data = server.metrics.render()
            self.send_response(200)
            self.send_header("Content-Type", METRICS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(data)))
            self._cors()
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            routes = {"/health": server.health, "/v1/stats": server.stats,
                      "/v1/models": server.models}
            if self.path == "/metrics":
                self._metrics()
            elif self.path in routes:
                self._json(*routes[self.path]())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return
            status, req = server.submit(body)
            if status != 200:
                self._json(status, req)
                return
            if not req.stream_requested:
                self._json(*server.wait(req))
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self._cors()
            self.end_headers()
            self.close_connection = True
            try:
                for data in server.stream_chunks(req):
                    self.wfile.write(data)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                server.cancel(req)     # client went away mid-stream

    return Handler


def create_server(model_cfg, serve_cfg, fleet_cfg=None, params=None,
                  device=None, observer=None, metrics=None):
    """The serve command's one entry point: one replica -> the
    ``InferenceServer``; ``fleet_cfg.replicas > 1`` -> the fleet front
    (serve/fleet/http.py: router + supervisor over in-process engine
    replicas or fleet worker processes). Both expose the same /v1
    surface, and neither is started."""
    if fleet_cfg is not None and fleet_cfg.replicas > 1:
        from .fleet.http import FleetServer
        return FleetServer(model_cfg, serve_cfg, fleet_cfg, params=params,
                           observer=observer, device=device,
                           metrics=metrics)
    return InferenceServer(model_cfg, serve_cfg, params=params,
                           device=device, observer=observer, metrics=metrics)
