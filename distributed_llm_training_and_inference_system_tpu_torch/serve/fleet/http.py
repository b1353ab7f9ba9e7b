"""HTTP front for the serve fleet.

The port's copy of the JAX package's ``serve/fleet/http.py``, served on
``http.server.ThreadingHTTPServer`` (JAX's is aiohttp), SSE included:
the same OpenAI surface as the single-engine server (``POST
/v1/completions``, ``GET /v1/models``, ``/health``, ``/metrics``,
``/v1/stats``; serve/server.py), sharing its body validator, plus the
fleet's routes:

- ``GET  /fleet/status``  — per-replica health + router ledger
- ``POST /fleet/drain``   — ``{"replica": N}``: graceful drain
- ``POST /fleet/undrain`` — return a drained replica to rotation
- ``POST /fleet/migrate`` — ``{"request_id": ..., "replica": N}``
- ``POST /fleet/role``    — ``{"replica": N, "role": ...}``
- ``POST /fleet/courier/chunk`` — one KV-courier frame into this
  process's receiver (the ack lists the sequence numbers still missing)
- ``POST /fleet/courier/fetch`` — the owner side of a prefix fetch from
  an in-process replica

When every replica saturates, completions answer 429 with a Retry-After
header. ``stream: true`` is served through the fleet stream hub: every
token batch carries its last token's sequence number in the SSE ``id:``
field, and a dropped connection does not abort the request: ``GET
/v1/streams/{request_id}`` with ``Last-Event-ID`` (or
``?last_event_id=``) replays only the unacked tail, then follows live.
The frames are the JAX front's, byte for byte.

With a shared state store (the HA front tier) a refresher thread folds
sibling fronts' journal records between supervisor polls, and ``/health``
answers 503 ``starting`` until the front attached to the store and read
one supervisor snapshot.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Optional
from urllib.parse import parse_qs

from ...analysis.annotations import aiohttp_handler
from ...config.schema import FleetConfig, ModelConfig, ServeConfig
from ..scheduler import RequestState
from ..server import REQUEST_TIMEOUT_S, BadRequest, parse_completion_body
from ..tokenizer import IncrementalDecoder, load_tokenizer
from . import ServeFleet
from .faults import FaultPlan
from .router import FleetSaturated
from .transport import CourierChunk
from .worker import Reply, serve, stop_server, wait_for_sigterm

logger = logging.getLogger("llmctl.serve.fleet.http")


class _Refresher:
    """Folds the shared journal every ``interval_s`` on a thread of its
    own, so live SSE delivery of streams a sibling front feeds does not
    wait a supervisor poll."""

    def __init__(self, store, interval_s: float = 0.02):
        self._stop = threading.Event()
        self._store = store
        self._interval = interval_s
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llmctl-fleet-refresh")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._store.sync()
            except Exception:
                logger.exception("store refresh failed")

    def cancel(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class _Runner:
    """What :meth:`FleetServer.start_async` returns: ``cleanup()`` stops
    the HTTP server (the fleet is shut down by its owner)."""

    def __init__(self, server: "FleetServer"):
        self._server = server

    async def cleanup(self) -> None:
        self._server.stop_http()


def _retry_after(e: FleetSaturated) -> dict:
    return {"Retry-After": str(max(int(e.retry_after_s + 0.5), 1))}


class FleetServer:
    """A ``ServeFleet`` behind the HTTP front. ``device`` is the card by
    default; a front whose replicas are all remote builds no engine and
    never touches the device. ``metrics`` is what ``/metrics`` renders
    (anything with ``render() -> bytes``); without it the route answers
    404, as the single-engine server's does."""

    def __init__(self, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 fleet_cfg: FleetConfig, params=None, observer=None,
                 fault_plan: Optional[FaultPlan] = None,
                 front_id: Optional[str] = None, device=None,
                 metrics=None):
        self.serve_cfg = serve_cfg
        self.observer = observer or (lambda event, payload: None)
        self.metrics = metrics
        self.tokenizer = load_tokenizer(serve_cfg.artifact or None,
                                        model_cfg.vocab_size)
        self.fleet = ServeFleet(
            model_cfg, serve_cfg, fleet_cfg, params=params,
            observer=self.observer, fault_plan=fault_plan,
            eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
            front_id=front_id, device=device)
        self.model_cfg = self.fleet.model_cfg    # artifact-effective config
        self._ready = False
        self._refresher: Optional[_Refresher] = None
        self._httpd = None
        self.bound_port: Optional[int] = None

    # -- completions ---------------------------------------------------------

    @aiohttp_handler
    def completions(self, handler, body: dict):
        try:
            prompt_tokens, sampling, stream = parse_completion_body(
                body, self.tokenizer, self.model_cfg.vocab_size)
        except BadRequest as e:
            return Reply({"error": str(e)}, 400)
        priority = str(body.get("priority", "standard"))
        if stream:
            return self._stream_completion(handler, prompt_tokens,
                                           sampling, priority)
        event = threading.Event()
        try:
            req = self.fleet.submit(prompt_tokens, sampling,
                                    on_complete=lambda _r: event.set(),
                                    priority=priority)
        except FleetSaturated as e:
            return Reply({"error": str(e)}, 429, _retry_after(e))
        except ValueError as e:      # per-replica validation (too long)
            return Reply({"error": str(e)}, 400)
        if not event.wait(REQUEST_TIMEOUT_S):
            self.fleet.router.cancel(req.request_id)
            return Reply({"error": "timeout"}, 504)
        if req.state is RequestState.FAILED:
            return Reply({"error": req.error or "failed"}, 500)
        latency_ms = (req.finish_time - req.arrival_time) * 1000.0
        n_gen = len(req.generated_tokens)
        meta = getattr(req, "fleet_meta", {}) or {}
        self.observer("inference_request", {
            "latency_ms": latency_ms, "ttft_ms": req.ttft_ms,
            "prompt_tokens": req.num_prompt_tokens, "tokens": n_gen,
            "replica": meta.get("replica"),
            "requeues": meta.get("requeues", 0),
        })
        return {
            "id": req.request_id,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_cfg.name,
            "choices": [{
                "index": 0,
                "text": self.tokenizer.decode(req.generated_tokens),
                "token_ids": req.generated_tokens,
                "finish_reason": req.finish_reason,
            }],
            "usage": {
                "prompt_tokens": req.num_prompt_tokens,
                "completion_tokens": n_gen,
                "total_tokens": req.num_prompt_tokens + n_gen,
            },
            "metrics": {"ttft_ms": req.ttft_ms, "latency_ms": latency_ms,
                        "replica": meta.get("replica"),
                        "requeues": meta.get("requeues", 0)},
        }

    # -- SSE streaming -------------------------------------------------------

    @aiohttp_handler
    def _stream_completion(self, handler, prompt_tokens, sampling,
                           priority: str = "standard"):
        try:
            req = self.fleet.submit_streaming(prompt_tokens, sampling,
                                              priority=priority)
        except FleetSaturated as e:
            return Reply({"error": str(e)}, 429, _retry_after(e))
        except ValueError as e:
            return Reply({"error": str(e)}, 400)
        return self._serve_stream(handler, req.request_id, from_seq=0,
                                  resume=False)

    @aiohttp_handler
    def stream_resume(self, handler, rid: str, query: str):
        """``GET /v1/streams/{request_id}``: reconnect a dropped stream
        from ``Last-Event-ID`` (header or ``?last_event_id=``); 404 once
        the log left the replay window or never existed."""
        raw = handler.headers.get("Last-Event-ID")
        if raw is None:
            raw = (parse_qs(query).get("last_event_id") or [None])[0]
        try:
            from_seq = int(raw) + 1 if raw is not None else 0
        except ValueError:
            return Reply({"error": f"Last-Event-ID must be an integer seq, "
                                   f"got {raw!r}"}, 400)
        if not self.fleet.streams.has(rid):
            return Reply({"error": f"unknown or expired stream {rid!r}"},
                         404)
        return self._serve_stream(handler, rid, from_seq=max(from_seq, 0),
                                  resume=True)

    def _sse_event(self, rid: str, seq_last: int, token_ids: list,
                   text: str = "", finish_reason=None) -> bytes:
        """One SSE frame; ``id:`` carries the seq of the batch's last
        token, what a reconnect echoes as ``Last-Event-ID``."""
        payload = {
            "id": rid, "object": "text_completion",
            "model": self.model_cfg.name, "seq": seq_last,
            "choices": [{"index": 0,
                         "text": text,
                         "token_ids": token_ids,
                         "finish_reason": finish_reason}],
        }
        return (f"id: {seq_last}\n"
                f"data: {json.dumps(payload)}\n\n").encode()

    @aiohttp_handler
    def _serve_stream(self, handler, rid: str, from_seq: int,
                      resume: bool):
        """Serve one SSE connection off the stream hub: the atomic
        (replay tail, live subscription) snapshot, then hub events in
        order until the finish event. A dropped connection only
        unsubscribes: the request keeps decoding and a reconnect resumes
        where the client left off."""
        q: queue.Queue = queue.Queue()
        sub = self.fleet.streams.subscribe(rid, from_seq, q.put,
                                           resume=resume)
        if sub is None:       # raced the replay TTL
            return Reply({"error": f"unknown or expired stream {rid!r}"},
                         404)
        seq_next = sub["start"]
        # incremental text decode against the accumulated token list,
        # seeded with the prefix the client already holds
        prefix = (self.fleet.streams.tokens_of(rid) or [])[:sub["start"]]
        decoder = IncrementalDecoder(self.tokenizer, prefix)
        wfile = handler.wfile

        def write(data: bytes) -> None:
            wfile.write(data)
            wfile.flush()

        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.end_headers()
            handler.close_connection = True
            if not resume:
                # announce the request id at once (no `id:` line): a
                # client whose front dies before the first token resumes
                # the same request elsewhere instead of resubmitting it
                announce = {
                    "id": rid, "object": "text_completion",
                    "model": self.model_cfg.name, "seq": -1,
                    "choices": [{"index": 0, "text": "",
                                 "token_ids": [],
                                 "finish_reason": None}],
                }
                write(f"data: {json.dumps(announce)}\n\n".encode())
            if sub["tokens"]:
                seq_next = sub["start"] + len(sub["tokens"])
                write(self._sse_event(rid, seq_next - 1, sub["tokens"],
                                      text=decoder.feed(sub["tokens"])))
            finished = sub["finished"]
            finish_reason = sub["finish_reason"]
            while not finished:
                try:
                    ev = q.get(timeout=REQUEST_TIMEOUT_S)
                except queue.Empty:
                    # stalled for the whole timeout: free the slot as the
                    # non-streaming path does
                    self.fleet.router.cancel(rid)
                    break
                if ev[0] == "tokens":
                    _kind, start, toks = ev
                    seq_next = start + len(toks)
                    write(self._sse_event(rid, seq_next - 1, list(toks),
                                          text=decoder.feed(toks)))
                    # backpressure ack: the event reached the socket
                    self.fleet.streams.ack(rid, sub["sub"])
                elif ev[0] == "drop":
                    # the hub dropped this subscriber for backpressure:
                    # end abruptly (no finish frame, no [DONE]) so the
                    # client reconnects with Last-Event-ID
                    logger.warning(
                        "stream %s: subscriber dropped for backpressure "
                        "at seq %d (reconnectable)", rid, seq_next - 1)
                    return None
                else:
                    _kind, finish_reason, _error = ev
                    finished = True
            write(self._sse_event(
                rid, max(seq_next - 1, 0), [], text=decoder.finish(),
                finish_reason=finish_reason or "error"))
            write(b"data: [DONE]\n\n")
        except (BrokenPipeError, ConnectionResetError):
            # client went away: the request keeps running and its log
            # stays replayable (the single-engine server aborts instead)
            logger.info("stream %s: client disconnected at seq %d "
                        "(reconnectable)", rid, seq_next - 1)
        finally:
            self.fleet.streams.unsubscribe(rid, sub["sub"])
        return None

    # -- the other routes ----------------------------------------------------

    def models(self) -> dict:
        return {"object": "list",
                "data": [{"id": self.model_cfg.name, "object": "model",
                          "owned_by": "llmctl",
                          "max_model_len": self.serve_cfg.max_seq_len}]}

    def health(self) -> Reply:
        if not self._ready:
            # not yet attached to the state store, or no snapshot read
            return Reply({"status": "starting",
                          "front": self.fleet.front_id}, 503)
        snap = self.fleet.status()
        healthy = [r for r in snap["replicas"] if r["state"] == "healthy"]
        # up while any replica takes traffic
        return Reply({"status": "healthy" if healthy else "degraded",
                      "model": self.model_cfg.name,
                      "replicas_healthy": len(healthy),
                      "replicas_total": len(snap["replicas"]),
                      "router": snap["router"]},
                     200 if healthy else 503)

    @aiohttp_handler
    async def handle_health(self, request=None) -> Reply:
        """``/health`` for a caller in an event loop (the JAX front's
        handler signature)."""
        return self.health()

    @aiohttp_handler
    def _drain_action(self, body: dict, drain: bool):
        try:
            replica = int(body["replica"])
        except (KeyError, TypeError, ValueError):
            return Reply({"error": "body must be {\"replica\": <id>}"}, 400)
        ok = (self.fleet.drain(replica) if drain
              else self.fleet.undrain(replica))
        if not ok:
            return Reply({"error": f"no replica {replica}"}, 404)
        return {"ok": True, "replica": replica,
                "action": "drain" if drain else "undrain"}

    def fleet_migrate(self, body: dict):
        try:
            request_id = str(body["request_id"])
            replica = int(body["replica"])
        except (KeyError, TypeError, ValueError):
            return Reply({"error": "body must be {\"request_id\": <id>, "
                                   "\"replica\": <id>}"}, 400)
        if all(r.replica_id != replica for r in self.fleet.replicas):
            return Reply({"error": f"no replica {replica}"}, 404)
        if not self.fleet.migrate(request_id, replica):
            return Reply({"error": f"request {request_id!r} is not resident "
                                   "on a healthy replica other than the "
                                   "destination"}, 404)
        return {"ok": True, "request_id": request_id, "replica": replica,
                "action": "migrate"}

    def fleet_role(self, body: dict):
        try:
            replica = int(body["replica"])
            role = str(body["role"]).lower()
        except (KeyError, TypeError, ValueError):
            return Reply({"error": "body must be {\"replica\": <id>, "
                                   "\"role\": \"prefill|decode|mixed\"}"},
                         400)
        if role not in ("prefill", "decode", "mixed"):
            return Reply({"error": f"unknown role {role!r} "
                                   "(prefill|decode|mixed)"}, 400)
        if not self.fleet.set_role(replica, role):
            return Reply({"error": f"no replica {replica}"}, 404)
        return {"ok": True, "replica": replica, "role": role,
                "action": "role"}

    def courier_chunk(self, body: dict):
        """One courier frame in; the reassembly ack out (always 200:
        a corrupt CRC is data for the sender's retry loop)."""
        try:
            chunk = CourierChunk.from_wire(body)
        except Exception:
            return Reply({"error": "body must be a courier chunk frame "
                                   "{ticket, seq, total, crc32, "
                                   "data(b64)}"}, 400)
        return self.fleet.courier_receiver.add_chunk(chunk)

    def metrics_body(self, handler) -> None:
        if self.metrics is None:
            handler.send_json(Reply({"error": "this front exports no "
                                              "metrics (serve start "
                                              "--prometheus-port)"}, 404))
            return
        from ...metrics.observability import CONTENT_TYPE
        data = self.metrics.render()
        handler.send_response(200)
        handler.send_header("Content-Type", CONTENT_TYPE)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    # the routes: each runs on a ThreadingHTTPServer request thread (the
    # JAX front's aiohttp handlers, under the same marker)

    @aiohttp_handler
    def handle_models(self, _handler, _query):
        return self.models()

    @aiohttp_handler
    def handle_health_get(self, _handler, _query):
        return self.health()

    @aiohttp_handler
    def handle_stats(self, _handler, _query):
        return self.fleet.status()

    @aiohttp_handler
    def handle_fleet_status(self, _handler, _query):
        return self.fleet.status()

    @aiohttp_handler
    def handle_fleet_drain(self, _handler, body: dict):
        return self._drain_action(body, drain=True)

    @aiohttp_handler
    def handle_fleet_undrain(self, _handler, body: dict):
        return self._drain_action(body, drain=False)

    @aiohttp_handler
    def handle_fleet_migrate(self, _handler, body: dict):
        return self.fleet_migrate(body)

    @aiohttp_handler
    def handle_fleet_role(self, _handler, body: dict):
        return self.fleet_role(body)

    @aiohttp_handler
    def handle_courier_chunk(self, _handler, body: dict):
        return self.courier_chunk(body)

    @aiohttp_handler
    def handle_courier_fetch(self, _handler, body: dict):
        return self.fleet.serve_prefix_fetch(body)

    @aiohttp_handler
    def handle_metrics(self, handler, _query) -> None:
        self.metrics_body(handler)

    def routes(self) -> dict:
        """(method, path) -> route: the JAX front's ``_build_app``."""
        return {
            ("POST", "/v1/completions"): self.completions,
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/v1/stats"): self.handle_stats,
            ("GET", "/health"): self.handle_health_get,
            ("GET", "/metrics"): self.handle_metrics,
            ("GET", "/fleet/status"): self.handle_fleet_status,
            ("POST", "/fleet/drain"): self.handle_fleet_drain,
            ("POST", "/fleet/undrain"): self.handle_fleet_undrain,
            ("POST", "/fleet/migrate"): self.handle_fleet_migrate,
            ("POST", "/fleet/role"): self.handle_fleet_role,
            ("POST", "/fleet/courier/chunk"): self.handle_courier_chunk,
            ("POST", "/fleet/courier/fetch"): self.handle_courier_fetch,
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Start the fleet and the HTTP server; attach to the state store,
        fold its journal once and read one snapshot before ``/health``
        answers 200. The bound port."""
        self.fleet.start()
        self._httpd = serve(self.serve_cfg.host, self.serve_cfg.port,
                            self.routes(),
                            {("GET", "/v1/streams/"): self.stream_resume})
        self.bound_port = self._httpd.server_address[1]
        store = self.fleet.store
        store.attach(info={"port": self.bound_port})
        if store.shared:
            store.sync()
            self._refresher = _Refresher(store)
        self.fleet.status()
        self._ready = True
        logger.info("fleet serving %s on %s:%d (%d replicas, front %s)",
                    self.model_cfg.name, self.serve_cfg.host,
                    self.bound_port, len(self.fleet.replicas),
                    self.fleet.front_id)
        return self.bound_port

    async def start_async(self) -> _Runner:
        """:meth:`start` for a caller in an event loop; ``cleanup()`` of
        what it returns stops the HTTP server."""
        self.start()
        return _Runner(self)

    def stop_http(self) -> None:
        if self._refresher is not None:
            self._refresher.cancel()
            self._refresher = None
        stop_server(self._httpd)
        self._httpd = None

    def stop(self) -> None:
        """Stop the HTTP server, the refresher and the fleet."""
        self.stop_http()
        self.fleet.shutdown()

    def run_forever(self, stop: Optional[threading.Event] = None) -> None:
        """Serve until SIGTERM/SIGINT (or ``stop``)."""
        self.start()
        try:
            wait_for_sigterm(stop)
        finally:
            self.stop()
