"""`llmctl-torch fleet worker`: one fleet replica as its own OS process.

The port's copy of the JAX package's ``serve/fleet/worker.py``, served on
``http.server.ThreadingHTTPServer`` (the JAX worker's front is aiohttp).
The other half of serve/fleet/remote.py: a worker runs one engine
replica (any role) plus the host-local :class:`CourierReceiver`, behind
the JAX worker's routes:

- ``POST /fleet/courier/chunk``  — inbound KV chunks (push courier;
  reassembled, CRC-verified, attached by ticket)
- ``POST /worker/submit``        — a request in its wire form; a courier
  ticket riding along is attached locally before admission
- ``GET  /worker/probe``         — health, load and counters
- ``POST /worker/outbox/take``   — finished results, crash/drain orphans,
  completed migrations and handoffs, stream batches, back to the parent
  (payload-carrying entries name a ticket parked here, never bytes)
- ``POST /worker/ship``          — push a parked payload to another
  worker's courier endpoint (worker to worker; the control plane never
  relays KV bytes)
- ``POST /worker/prefix`` and ``/fleet/courier/fetch`` — the owner side
  of a prefix fetch
- ``POST /worker/drain|undrain|role|migrate|cancel``, ``GET
  /worker/status`` and ``/health``

With store endpoints the worker demotes its evicted and drain-flushed
prefix pages to the store service and restores store-held pages from it;
``fleet worker --weights-from-store`` boots its weights from there.

The worker supervises its own engine: a crashed engine thread is rebuilt
locally under doubling backoff while its orphans flow to the outbox. The
parent only declares the worker dead when the process stops answering.

:meth:`FleetWorker.run_forever` prints one ready line on stdout and
nothing else there; at SIGTERM it stops and writes the process's kernel
launch counts and its engines' pass counters to stderr as one
``LLMCTL_WORKER_LAUNCHES {json}`` line (:func:`launch_report`).
"""

from __future__ import annotations

import json
import logging
import signal
import sys
import threading
import time
import urllib.request
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ...analysis.annotations import (aiohttp_handler, engine_thread_only,
                                     supervisor_thread)
from ...config.schema import FleetConfig, ModelConfig, ServeConfig
from ..scheduler import Request, RequestState, SamplingParams
from . import replica as replica_mod
from .faults import FaultInjector, FaultPlan
from .remote import request_from_wire, request_to_wire
from .replica import EngineReplica
from .store_service import StoreClient
from .transport import (KV_STORE_OWNER, CourierChunk, CourierReceiver,
                        HTTPCourierTransport, TransportError,
                        TransportStats)

logger = logging.getLogger("llmctl.serve.fleet.worker")

READY_PREFIX = "LLMCTL_WORKER_READY"
LAUNCHES_PREFIX = "LLMCTL_WORKER_LAUNCHES"
PARAMS_PREFIX = "LLMCTL_WORKER_PARAMS"


# -- the stdlib JSON front (the worker's and the fleet front's) ---------------

class Reply:
    """One JSON answer: status, the object, extra headers. A route returns
    a Reply, or a plain dict for a 200. ``body`` is the encoded JSON."""

    __slots__ = ("status", "data", "headers")

    def __init__(self, data: dict, status: int = 200,
                 headers: Optional[dict] = None):
        self.status = status
        self.data = data
        self.headers = headers or {}

    @property
    def body(self) -> bytes:
        return json.dumps(self.data).encode()


class JSONHandler(BaseHTTPRequestHandler):
    """Dispatch on ``(method, path)`` to ``routes`` (set by :func:`serve`):
    POST routes take the parsed JSON body, GET routes the query string.
    A route that writes its own response (SSE) returns None."""

    protocol_version = "HTTP/1.1"
    routes: dict = {}
    prefixes: dict = {}         # (method, path prefix) -> route(handler, rest)

    def log_message(self, fmt, *args):
        logger.debug("%s - " + fmt, self.address_string(), *args)

    def send_json(self, reply) -> None:
        if not isinstance(reply, Reply):
            reply = Reply(reply)
        data = reply.body
        self.send_response(reply.status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in reply.headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _route(self, method: str):
        path, _, query = self.path.partition("?")
        fn = self.routes.get((method, path))
        if fn is None:
            for (m, prefix), pfn in self.prefixes.items():
                if m == method and path.startswith(prefix):
                    return (lambda pfn=pfn, rest=path[len(prefix):]:
                            pfn(self, rest, query))
            return None
        if method == "GET":
            return lambda: fn(self, query)
        n = int(self.headers.get("Content-Length", 0) or 0)
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return lambda: Reply({"error": "invalid JSON"}, 400)
        if not isinstance(body, dict):
            return lambda: Reply({"error": "body must be a JSON object"},
                                 400)
        return lambda: fn(self, body)

    def _dispatch(self, method: str) -> None:
        call = self._route(method)
        if call is None:
            self.send_json(Reply({"error": f"no route {self.path}"}, 404))
            return
        try:
            out = call()
        except (BrokenPipeError, ConnectionResetError):
            return
        except Exception as e:
            logger.exception("%s %s failed", method, self.path)
            out = Reply({"error": f"{type(e).__name__}: {e}"}, 500)
        if out is not None:
            self.send_json(out)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def serve(host: str, port: int, routes: dict,
          prefixes: Optional[dict] = None) -> ThreadingHTTPServer:
    """A started ThreadingHTTPServer on ``host:port`` (0 = a free port)
    answering ``routes``; its thread is a daemon."""
    handler = type("Handler", (JSONHandler,),
                   {"routes": dict(routes), "prefixes": dict(prefixes or {})})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="llmctl-fleet-http").start()
    return httpd


def stop_server(httpd: Optional[ThreadingHTTPServer]) -> None:
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()


def wait_for_sigterm(stop: Optional[threading.Event] = None) -> None:
    """Block until SIGTERM or SIGINT (or ``stop`` is set)."""
    stop = stop or threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while not stop.wait(0.5):
            pass
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


# -- launch accounting ---------------------------------------------------------

def _kernel_wrappers() -> dict:
    """Every hand-written kernel's launch-counting wrapper, by name."""
    from ...ops import (adamw_cuda, attention_cuda, int4_matmul, int8_matmul,
                        paged_attention_cuda, rmsnorm)
    return {"paged_attention": paged_attention_cuda.paged_attention_kernel,
            "paged_attention_int8":
            paged_attention_cuda.paged_attention_int8_kernel,
            "paged_attention_int4":
            paged_attention_cuda.paged_attention_int4_kernel,
            "int8_matmul": int8_matmul.int8_matmul_kernel,
            "int8_matmul_ksplit": int8_matmul.int8_matmul_ksplit_kernel,
            "int4_matmul": int4_matmul.int4_matmul_kernel,
            "rmsnorm": rmsnorm.rmsnorm_kernel,
            "flash_fwd": attention_cuda.flash_fwd,
            "adamw": adamw_cuda.adamw_kernel}


def launch_report(engines) -> dict:
    """This process's kernel launches, and the passes of ``engines`` (every
    engine the worker ran, a rebuilt one too) that launch the paged kernel
    once a layer: dispatched decode steps, suffix prefills, prefill
    chunks."""
    return {"launches": {n: int(w.launches)
                         for n, w in _kernel_wrappers().items()},
            "layers": engines[0].cfg.num_layers if engines else 0,
            "dispatched_steps": sum(int(e.total_dispatched_steps)
                                    for e in engines),
            "extend_prefills": sum(int(e.total_extend_prefills)
                                   for e in engines),
            "prefill_chunks": sum(int(e.total_prefill_chunks)
                                  for e in engines),
            "prefill_tokens": sum(int(e.total_prefill_tokens)
                                  for e in engines)}


def params_checksum(model) -> float:
    """Sum of every parameter's elements in fp64, summed in the order of
    ``named_parameters`` (a worker's weights against the loader's)."""
    import torch
    with torch.no_grad():
        return float(sum(float(p.detach().sum(dtype=torch.float64))
                         for _n, p in model.named_parameters()))


class FleetWorker:
    """One engine replica + courier receiver + outbox, ready to be served
    by :meth:`serve_http` or driven directly in tests. ``device`` is the
    card by default; tests pass ``"cpu"``."""

    def __init__(self, replica_id: int, model_cfg: ModelConfig,
                 serve_cfg: ServeConfig,
                 fleet_cfg: Optional[FleetConfig] = None,
                 role: str = replica_mod.ROLE_MIXED, params=None,
                 seed: int = 0, fault_plan: Optional[FaultPlan] = None,
                 warmup: bool = True, device=None):
        self.fleet_cfg = fleet_cfg or FleetConfig()
        self.injector = FaultInjector(fault_plan) if fault_plan else None
        self.receiver = CourierReceiver(
            ttl_ms=self.fleet_cfg.courier_ticket_ttl_ms)
        self.courier_stats = TransportStats()
        # before the replica: its warmup generate fires _on_finish
        self._outbox: deque = deque()
        self._lock = threading.Lock()
        self.replica = EngineReplica(
            replica_id, model_cfg, serve_cfg, params=params, seed=seed,
            injector=self.injector, on_finish=self._on_finish,
            fleet_cfg=self.fleet_cfg, role=role, device=device)
        self.params = self.replica.engine.params
        self.replica.courier_receiver = self.receiver
        # disaggregation: a prefill-role worker cannot see the fleet, so
        # the handoff destination is always "the parent decides": the
        # extracted payload parks here under a ticket and the parent
        # places and ships it
        self.replica.handoff_dest = lambda req, rid: -1
        self.replica.on_handoff = self._on_handoff
        # fleet-global prefix cache: this worker fetches missing prefix
        # pages itself (the owner hint and endpoint ride the submit wire);
        # set once the server knows its bound address
        self.self_endpoint: Optional[str] = None
        self.replica.prefix_fetcher = self._fetch_prefix
        # the store service (serve/fleet/store_service.py): with store
        # endpoints this worker demotes its evicted and drain-flushed
        # prefix pages to the shared store, and serves KV_STORE_OWNER
        # hints from it, so a returning conversation landing here restores
        # pages that another replica or worker demoted
        self.store_client = None
        if self.fleet_cfg.kv_store_endpoint_list():
            self.store_client = StoreClient(self.fleet_cfg,
                                            injector=self.injector)
            self.replica.set_kv_store(self.store_client)
        # streaming: a request's token batches ship to the parent as
        # cursor-tagged outbox entries; the deque keeps a request's
        # stream entries ahead of its own terminal entry
        self.replica.on_token = self._on_token
        if warmup:
            eng = self.replica.engine
            eng.generate([[1, 2, 3]], SamplingParams(
                temperature=0.0, max_tokens=4))
            eng.total_prefill_tokens = 0
            if hasattr(eng, "total_unexpected_prefills"):
                eng.total_unexpected_prefills = 0
            # the warmup's passes launched the paged kernel too: the
            # launch report counts the serving passes only
            for w in _kernel_wrappers().values():
                w.launches = 0
            eng.total_dispatched_steps = 0
            eng.total_extend_prefills = 0
            eng.total_prefill_chunks = 0
        with self._lock:
            self._outbox.clear()    # drop warmup completions
        # every engine this worker ran, a rebuilt one too (launch_report)
        self.engines = [self.replica.engine]
        self._restarts = 0
        self._next_restart = 0.0
        self._backoff_s = self.fleet_cfg.restart_backoff_s
        self._stop = threading.Event()
        self._janitor: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- engine-side hooks ---------------------------------------------------

    @engine_thread_only
    def _on_finish(self, replica_id: int, req: Request) -> None:
        entry = {
            "kind": "finished",
            "request_id": req.request_id,
            "generated_tokens": [int(t) for t in req.generated_tokens],
            "finish_reason": req.finish_reason,
            "state": ("failed" if req.state is RequestState.FAILED
                      else "completed"),
            "error": req.error,
            "ttft_ms": req.ttft_ms,
        }
        with self._lock:
            self._outbox.append(entry)

    @engine_thread_only
    def _on_token(self, replica_id: int, req: Request,
                  tokens: list) -> None:
        """Publish one token batch with its sequence cursor: ``start`` is
        the request's own committed count, so after a local rebuild and
        re-prefill the cursors stay aligned with the fleet-wide numbering.
        ``seed`` rides along so the parent can requeue a SIGKILLed stream
        from its last delivered token."""
        entry = {"kind": "stream", "request_id": req.request_id,
                 "start": len(req.generated_tokens) - len(tokens),
                 "tokens": [int(t) for t in tokens],
                 "seed": req.assigned_seed}
        with self._lock:
            self._outbox.append(entry)

    @engine_thread_only
    def _on_handoff(self, replica_id: int, req: Request,
                    dest) -> None:
        """Prefill-complete extraction (engine thread): park the payload
        under a ticket and publish a handoff entry; no sockets here."""
        ticket = f"courier-{uuid.uuid4().hex[:16]}"
        payload, req.swapped_kv = req.swapped_kv, None
        self.receiver.put_payload(ticket, payload)
        with self._lock:
            self._outbox.append({"kind": "handoff", "ticket": ticket,
                                 "partial": False, "dest": None,
                                 "request": request_to_wire(req)})

    # -- local supervision ---------------------------------------------------

    @supervisor_thread
    def _flush_orphans(self) -> None:
        for req in self.replica.take_orphans():
            payload = req.swapped_kv
            ticket = None
            partial = False
            if isinstance(payload, dict) \
                    and "courier_ticket" not in payload:
                ticket = f"courier-{uuid.uuid4().hex[:16]}"
                partial = bool(payload.get("partial"))
                self.receiver.put_payload(ticket, payload)
                req.swapped_kv = None
            with self._lock:
                self._outbox.append({"kind": "orphan", "ticket": ticket,
                                     "partial": partial,
                                     "request": request_to_wire(req)})

    @supervisor_thread
    def _flush_migrated(self) -> None:
        for req, t in self.replica.take_migrated():
            payload, req.swapped_kv = req.swapped_kv, None
            ticket = None
            partial = False
            if isinstance(payload, dict):
                ticket = f"courier-{uuid.uuid4().hex[:16]}"
                partial = bool(payload.get("partial"))
                self.receiver.put_payload(ticket, payload)
            with self._lock:
                self._outbox.append({"kind": "migrated", "ticket": ticket,
                                     "partial": partial, "dest": t.dest,
                                     "reason": t.reason,
                                     "request": request_to_wire(req)})

    @supervisor_thread
    def supervise_once(self, now: Optional[float] = None) -> None:
        """One local-janitor pass: collect orphans and migrations into the
        outbox and rebuild a crashed engine under doubling backoff."""
        now = time.monotonic() if now is None else now
        r = self.replica
        self._flush_migrated()
        state = r.state
        if state in (replica_mod.CRASHED, replica_mod.STOPPED):
            self._flush_orphans()
            if self._next_restart == 0.0:
                self._next_restart = now + self._backoff_s
                self._backoff_s = min(
                    max(self._backoff_s, 1e-3) * 2,
                    self.fleet_cfg.restart_backoff_max_s)
            elif now >= self._next_restart:
                try:
                    r.stop()
                    r.restart(params=self.params)
                    self.engines.append(r.engine)
                    self._restarts += 1
                    self._next_restart = 0.0
                    logger.info("worker replica %d engine rebuilt "
                                "(restart #%d)", r.replica_id,
                                self._restarts)
                except Exception:
                    logger.exception("worker engine rebuild failed")
                    self._next_restart = now + self._backoff_s
        else:
            self._flush_orphans()       # drain victims etc.

    @supervisor_thread
    def _janitor_loop(self) -> None:
        interval = min(self.fleet_cfg.probe_interval_s, 0.05)
        while not self._stop.wait(interval):
            try:
                self.supervise_once()
            except Exception:
                logger.exception("worker janitor pass failed")

    def start(self) -> None:
        self.replica.start()
        if self._janitor is None or not self._janitor.is_alive():
            self._stop.clear()
            self._janitor = threading.Thread(
                target=self._janitor_loop, daemon=True,
                name=f"llmctl-fleet-worker-{self.replica.replica_id}")
            self._janitor.start()

    def shutdown(self) -> None:
        stop_server(self._httpd)
        self._httpd = None
        self._stop.set()
        if self._janitor is not None:
            self._janitor.join(timeout=5.0)
            self._janitor = None
        self.replica.stop()
        try:
            self.replica.engine.release()
        except Exception:
            pass

    # -- RPC bodies (also driven directly by tests) --------------------------

    @aiohttp_handler
    def submit_wire(self, body: dict) -> dict:
        req = request_from_wire(body, receiver=self.receiver)
        ok = self.replica.submit(req)
        out = {"ok": bool(ok)}
        if not ok and req.error:
            out["reject_error"] = req.error
        return out

    @aiohttp_handler
    def probe_dict(self) -> dict:
        r = self.replica
        try:
            base = r.probe()
        except RuntimeError as e:
            # the engine crashed; the process is fine and the janitor is
            # rebuilding it
            base = {"replica": r.replica_id, "state": replica_mod.CRASHED,
                    "role": r.role, "queue_depth": 0, "active": 0,
                    "outstanding_tokens": 0, "error": str(e)}
        hits, queries, cached = r.prefix_cache_stats()
        eng = r.engine
        base.update({
            "resident_requests": r.resident_requests()
            if base["state"] == replica_mod.HEALTHY else [],
            "queued_interactive_wait_ms":
            r.queued_priority_wait_ms("interactive")
            if base["state"] == replica_mod.HEALTHY else 0.0,
            "migrations_in_flight": r.migrations_in_flight(),
            "migrations": r.migrations_out,
            "migrated_tokens": r.migrated_tokens,
            "reprefill_avoided_tokens": r.reprefill_avoided_tokens,
            "migrations_by_reason": dict(r.migrations_by_reason),
            "handoffs": r.handoffs_out,
            "handoff_tokens": r.handoff_tokens,
            "handoffs_local": r.handoffs_local,
            "prefix_hits": hits, "prefix_queries": queries,
            "requeue_cached_tokens": cached,
            "prefix_pages": [h.hex() for h in r.prefix_inventory()],
            "prefix_fetch": r.prefix_fetch_stats(),
            "spec": r.spec_stats(),
            "engine_restarts": self._restarts,
            "total_prefill_tokens": getattr(eng, "total_prefill_tokens",
                                            0),
            "total_unexpected_prefills": getattr(
                eng, "total_unexpected_prefills", 0),
            "outbox_depth": len(self._outbox),
        })
        return base

    @aiohttp_handler
    def take_outbox(self) -> dict:
        with self._lock:
            entries = list(self._outbox)
            self._outbox.clear()
        return {"entries": entries, "probe": self.probe_dict()}

    @aiohttp_handler
    def ship(self, body: dict) -> dict:
        """Push a parked payload to another worker's courier endpoint.
        Pops the ticket: an aborted push means the payload is gone and the
        parent falls back to re-prefill (the courier contract)."""
        ticket = str(body.get("ticket", ""))
        dest_endpoint = str(body.get("dest_endpoint", "")).rstrip("/")
        if not ticket or not dest_endpoint:
            return {"ok": False,
                    "error": "body must be {ticket, dest_endpoint}"}
        payload = self.receiver.take_payload(ticket)
        if payload is None:
            return {"ok": False,
                    "error": f"unknown or expired ticket {ticket!r}"}
        transport = HTTPCourierTransport(
            self.fleet_cfg, injector=self.injector,
            stats=self.courier_stats, endpoint=dest_endpoint)
        try:
            transport.transfer(payload,
                               src=self.replica.replica_id,
                               dest=body.get("dest"), ticket=ticket)
        except TransportError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "ticket": ticket}

    @aiohttp_handler
    def status_dict(self) -> dict:
        out = self.probe_dict()
        out["courier"] = {**self.courier_stats.snapshot(),
                          **self.receiver.stats()}
        sc = self.store_client
        if sc is not None:
            # local counters only: status answers while the store is down
            out["kv_store"] = {"endpoint": sc.endpoint,
                               "endpoints": sc.endpoints,
                               "remote_hits": sc.total_remote_hits,
                               "remote_misses": sc.total_remote_misses,
                               "retries": sc.total_retries,
                               "failovers": sc.total_failovers,
                               "hedges": sc.total_hedges}
        return out

    # -- fleet-global prefix cache -------------------------------------------

    @engine_thread_only
    def _fetch_prefix(self, fetcher_id: int, owner,
                      owner_endpoint: Optional[str],
                      hashes: list) -> Optional[dict]:
        """Fetch half: ask the owner's front (a worker or the parent's
        fleet server; both serve /fleet/courier/fetch) to extract and push
        the pages to this worker's own courier endpoint, then claim them
        by ticket. A store-held hint (``KV_STORE_OWNER``) is pulled from
        the store service: its frames replay through this worker's own
        receiver. None = miss."""
        ep = (owner_endpoint or "").rstrip("/")
        if owner == KV_STORE_OWNER:
            client = self.store_client
            if client is None or (ep and ep not in client.endpoints):
                if not ep:
                    return None
                client = StoreClient(self.fleet_cfg, endpoint=ep,
                                     injector=self.injector)
                if self.store_client is None:
                    self.store_client = client
            return client.fetch(hashes, self.receiver)
        me = self.self_endpoint
        if not ep or not me:
            return None
        ticket = f"courier-{uuid.uuid4().hex[:16]}"
        body = {"replica": owner,
                "hashes": [h.hex() if isinstance(h, bytes) else str(h)
                           for h in hashes],
                "ticket": ticket, "dest": self.replica.replica_id,
                "dest_endpoint": me}
        wire = urllib.request.Request(
            f"{ep}/fleet/courier/fetch",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(
                wire,
                timeout=self.fleet_cfg.prefix_fetch_timeout_s) as resp:
            out = json.loads(resp.read().decode())
        if not out.get("ok"):
            return None
        return self.receiver.take_payload(ticket)

    @aiohttp_handler
    def prefix_fetch(self, body: dict) -> dict:
        """Owner side of ``POST /fleet/courier/fetch`` (alias
        ``/worker/prefix``): extract the requested prefix pages on the
        engine thread and push them, chunked, to the fetcher's courier
        endpoint. A miss is an ok=False answer, not an error."""
        try:
            hashes = [bytes.fromhex(h) for h in body.get("hashes", [])]
        except (TypeError, ValueError):
            return {"ok": False, "error": "malformed hashes"}
        ticket = str(body.get("ticket") or "")
        dest_ep = str(body.get("dest_endpoint") or "").rstrip("/")
        if not hashes or not ticket or not dest_ep:
            return {"ok": False, "error":
                    "body must be {hashes, ticket, dest_endpoint}"}
        payload = self.replica.request_prefix_extract(
            hashes, timeout_s=self.fleet_cfg.prefix_fetch_timeout_s)
        if not payload:
            return {"ok": False, "error": "prefix pages not cached"}
        transport = HTTPCourierTransport(
            self.fleet_cfg, injector=self.injector,
            stats=self.courier_stats, endpoint=dest_ep)
        try:
            transport.transfer(payload,
                               src=self.replica.replica_id,
                               dest=body.get("dest"), ticket=ticket)
        except TransportError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "ticket": ticket,
                "covered": int(payload["pages"]["num_pages"])}

    # -- HTTP front ----------------------------------------------------------

    def routes(self) -> dict:
        """(method, path) -> route, the JAX worker's ``build_app``."""
        w = self

        def courier_chunk(_h, body):
            try:
                chunk = CourierChunk.from_wire(body)
            except Exception:
                return Reply(
                    {"error": "body must be a courier chunk frame "
                              "{ticket, seq, total, crc32, data(b64)}"}, 400)
            return w.receiver.add_chunk(chunk)

        def submit(_h, body):
            try:
                return w.submit_wire(body)
            except (KeyError, TypeError, ValueError) as e:
                return Reply({"ok": False,
                              "error": f"malformed request: {e}"}, 400)

        def role(_h, body):
            r = str(body.get("role", "")).lower()
            if r not in (replica_mod.ROLE_PREFILL, replica_mod.ROLE_DECODE,
                         replica_mod.ROLE_MIXED):
                return Reply({"ok": False, "error": f"unknown role {r!r}"},
                             400)
            w.replica.set_role(r)
            return {"ok": True, "role": r}

        def drain(_h, _body):
            w.replica.request_drain()
            return {"ok": True}

        def undrain(_h, _body):
            w.replica.undrain()
            return {"ok": True}

        def migrate(_h, body):
            ok = w.replica.request_migrate(
                str(body.get("request_id", "")), dest=body.get("dest"),
                reason=str(body.get("reason", "operator")))
            return {"ok": bool(ok)}

        def cancel(_h, body):
            return {"ok": bool(w.replica.cancel(
                str(body.get("request_id", ""))))}

        def health(_h, _query):
            state = w.replica.state
            ok = state == replica_mod.HEALTHY
            return Reply({"status": "healthy" if ok else state},
                         200 if ok else 503)

        # the chunked pushes of ship and prefix block (retries, backoff)
        # on their own handler thread; probes keep answering meanwhile
        return {
            ("POST", "/fleet/courier/chunk"): courier_chunk,
            ("POST", "/worker/submit"): submit,
            ("GET", "/worker/probe"): lambda _h, _q: w.probe_dict(),
            ("POST", "/worker/outbox/take"): lambda _h, _b: w.take_outbox(),
            ("POST", "/worker/ship"): lambda _h, b: w.ship(b),
            ("POST", "/worker/prefix"): lambda _h, b: w.prefix_fetch(b),
            ("POST", "/fleet/courier/fetch"):
            lambda _h, b: w.prefix_fetch(b),
            ("POST", "/worker/drain"): drain,
            ("POST", "/worker/undrain"): undrain,
            ("POST", "/worker/role"): role,
            ("POST", "/worker/migrate"): migrate,
            ("POST", "/worker/cancel"): cancel,
            ("GET", "/worker/status"): lambda _h, _q: w.status_dict(),
            ("GET", "/health"): health,
        }

    def serve_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind the HTTP front, start the replica and the janitor; the
        bound port."""
        self._httpd = serve(host, port, self.routes())
        bound = self._httpd.server_address[1]
        # our own courier endpoint: prefix fetches ask owners to push here
        self.self_endpoint = f"http://{host}:{bound}"
        self.start()
        return bound

    def run_forever(self, host: str = "127.0.0.1", port: int = 0,
                    stop: Optional[threading.Event] = None,
                    report: Optional[Callable[[str], None]] = None) -> None:
        """Serve until SIGTERM/SIGINT. Prints exactly one machine-readable
        ready line to stdout (``LLMCTL_WORKER_READY port=N``) so a spawning
        parent can discover an ephemeral port; everything else goes to
        stderr, the launch report last."""
        bound = self.serve_http(host, port)
        print(f"{READY_PREFIX} port={bound}", flush=True)
        logger.info("fleet worker replica %d (%s) serving on %s:%d",
                    self.replica.replica_id, self.replica.role, host, bound)
        try:
            wait_for_sigterm(stop)
        finally:
            self.shutdown()
            line = (f"{LAUNCHES_PREFIX} "
                    f"{json.dumps(launch_report(self.engines))}")
            (report or (lambda s: print(s, file=sys.stderr,
                                        flush=True)))(line)
