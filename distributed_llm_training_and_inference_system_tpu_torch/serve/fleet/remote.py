"""Remote fleet replicas: the parent-side client of `llmctl-torch fleet
worker`.

The port's copy of the JAX package's ``serve/fleet/remote.py`` (which
imports no JAX): the wire forms of a request, of its sampling parameters
and of a worker's view folded back (``request_to_wire`` gives the JAX
package's JSON for the same request), and :class:`RemoteReplica`, the
router's and supervisor's duck-typed replica over urllib, with the JAX
client's per-call timeout, doubling-backoff reconnect gate and teardown.

Failure semantics mirror the threaded fleet:

- a worker whose process answers is healthy, even while its engine
  thread is mid-restart (the worker supervises its own engine; crash
  orphans flow back through the outbox);
- a worker that stops answering accumulates probe misses and is torn
  down by the supervisor like an engine-thread crash: every request
  known in flight there is reset and requeued (payload stubs pointing at
  the dead worker are stripped, and the survivor re-prefills), and
  reconnect attempts back off exponentially;
- results, orphans, migrations and handoffs come back through a polled
  outbox: the worker never needs to reach the parent.

KV payload bytes never cross this module: they move worker to worker
over the courier (``/worker/ship`` + ``/fleet/courier/chunk``), and the
requests here carry only ticket stubs.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Optional

from ..scheduler import Request, RequestState, SamplingParams
from . import replica as replica_mod
from .migration import MigrationTicket
from .replica import reset_for_requeue
from .transport import ticket_stub

logger = logging.getLogger("llmctl.serve.fleet.remote")


class RemoteUnavailable(RuntimeError):
    """A control RPC to the worker failed (refused / timeout / reset /
    black-holed). The caller treats it like a probe miss."""


# -- request wire format ------------------------------------------------------
#
# Everything a sequence needs to continue BIT-IDENTICALLY on another
# replica: prompt + generated tokens (the resume context), sampling
# params, and the assigned_seed fixed at first prefill (the per-position
# PRNG stream). KV bytes travel separately over the courier; the wire
# carries only the ticket.


def sampling_to_wire(s: SamplingParams) -> dict:
    return {"temperature": s.temperature, "top_k": s.top_k,
            "top_p": s.top_p, "max_tokens": s.max_tokens,
            "stop_token_ids": list(s.stop_token_ids), "seed": s.seed}


def sampling_from_wire(d: dict) -> SamplingParams:
    return SamplingParams(
        temperature=float(d.get("temperature", 1.0)),
        top_k=int(d.get("top_k", 0)), top_p=float(d.get("top_p", 1.0)),
        max_tokens=int(d.get("max_tokens", 64)),
        stop_token_ids=tuple(d.get("stop_token_ids", ())),
        seed=d.get("seed"))


def request_to_wire(req: Request) -> dict:
    kv = req.swapped_kv
    ticket = kv.get("courier_ticket") if isinstance(kv, dict) else None
    return {
        "request_id": req.request_id,
        "prompt_tokens": [int(t) for t in req.prompt_tokens],
        "generated_tokens": [int(t) for t in req.generated_tokens],
        "assigned_seed": req.assigned_seed,
        "fleet_requeued": bool(req.fleet_requeued),
        "handoffs": int(getattr(req, "handoffs", 0)),
        # fleet SSE streaming: a streaming request's worker publishes
        # cursor-tagged token batches through its outbox
        "stream": bool(getattr(req, "stream_requested", False)),
        # SLO priority class: the worker's scheduler is class-blind, but
        # the wire carries it so migrated/requeued requests keep their
        # class and the worker's probe can report per-class residents
        "priority": str(getattr(req, "priority", "standard")),
        "sampling": sampling_to_wire(req.sampling),
        "ticket": ticket,
        "partial": bool(kv.get("partial")) if isinstance(kv, dict)
        else False,
        # fleet-global prefix cache: the router's placement-time hint
        # rides the wire so the WORKER can fetch the shared pages
        # itself (it cannot see the fleet)
        "prefix_owner": getattr(req, "prefix_owner", None),
        "prefix_owner_endpoint": getattr(req, "prefix_owner_endpoint",
                                         None),
        # courier-aware speculation: the sequence's SpecState dict (tiny,
        # plain scalars) so a remote worker arms the tuned window
        "spec_state": getattr(req, "spec_state", None),
        # pipelined multi-replica prefill: the stage manifest travels so
        # a worker-hosted engine bounds the chunked prefill and releases
        # page-only stage requests the same way an in-proc one does
        # (stage DUTY still needs the in-proc import seam — see
        # serve/fleet/pipeline.py stage_candidates)
        "pipeline_stage": getattr(req, "pipeline_stage", None),
    }


def request_from_wire(d: dict, receiver=None) -> Request:
    """Rebuild a Request on the worker. When a courier ticket rode along
    and ``receiver`` is given, the payload is attached immediately (the
    destination-terminated restore); a missing/expired ticket leaves
    ``swapped_kv`` None and the engine re-prefills."""
    req = Request(request_id=str(d["request_id"]),
                  prompt_tokens=[int(t) for t in d["prompt_tokens"]],
                  sampling=sampling_from_wire(d.get("sampling", {})))
    req.generated_tokens = [int(t) for t in d.get("generated_tokens", [])]
    req.assigned_seed = d.get("assigned_seed")
    req.fleet_requeued = bool(d.get("fleet_requeued"))
    req.handoffs = int(d.get("handoffs", 0))
    req.stream_requested = bool(d.get("stream"))
    req.priority = str(d.get("priority", "standard"))
    req.prefix_owner = d.get("prefix_owner")
    req.prefix_owner_endpoint = d.get("prefix_owner_endpoint")
    spec = d.get("spec_state")
    if isinstance(spec, dict):
        req.spec_state = spec
    stage = d.get("pipeline_stage")
    if isinstance(stage, dict):
        req.pipeline_stage = stage
    ticket = d.get("ticket")
    if ticket and receiver is not None:
        payload = receiver.take_payload(ticket)
        if payload is None:
            logger.warning("worker: courier ticket %s missing/expired "
                           "for %s; re-prefill", ticket, req.request_id)
        req.swapped_kv = payload
    return req


def apply_wire(req: Request, d: dict) -> None:
    """Fold a worker's view of a request back onto the parent's object
    (the SAME object the router's waiters hold)."""
    req.generated_tokens = [int(t) for t in d.get("generated_tokens", [])]
    if d.get("assigned_seed") is not None:
        req.assigned_seed = d["assigned_seed"]
    req.handoffs = int(d.get("handoffs", req.handoffs))
    if isinstance(d.get("spec_state"), dict):
        # the worker's copy is fresher: it observed the dispatches this
        # parent never saw — the next placement resumes from it
        req.spec_state = d["spec_state"]


class RemoteReplica:
    """One `llmctl fleet worker` process, fronted for the router and
    supervisor with the same duck-typed surface as
    :class:`~.replica.EngineReplica`."""

    remote = True

    def __init__(self, replica_id: int, endpoint: str, fleet_cfg=None,
                 injector=None,
                 on_finish: Optional[Callable[[int, Request], None]] = None,
                 role: str = replica_mod.ROLE_MIXED,
                 poll_interval_s: float = 0.02):
        self.replica_id = replica_id
        self.endpoint = endpoint.rstrip("/")
        self.cfg = fleet_cfg
        self.injector = injector
        self.on_finish = on_finish
        # fleet SSE streaming: fired with (replica_id, request_id,
        # start_seq, tokens) for each cursor-tagged batch the worker
        # published through its outbox. Set by ServeFleet to feed the
        # stream hub (which dedupes by seq, so late or re-delivered
        # batches after a SIGKILL/requeue are harmless).
        self.on_tokens: Optional[Callable] = None
        # HA front tier: fired with (replica_id, entry) for a finished
        # outbox entry whose request THIS front never submitted — in a
        # multi-front deployment the worker's outbox drains to whichever
        # front polls first, and the collector must finish the shared
        # stream log + ledger on behalf of the front that owns the
        # waiter (serve/fleet/state.py). None = drop, the single-front
        # behavior.
        self.on_foreign: Optional[Callable] = None
        self.role = role
        self.poll_interval_s = poll_interval_s
        self.timeout_s = float(getattr(fleet_cfg, "remote_timeout_s", 5.0))
        self._backoff_base_s = float(getattr(
            fleet_cfg, "remote_reconnect_backoff_s", 0.05))
        self._backoff_max_s = 2.0
        self.state = replica_mod.HEALTHY    # probes correct this
        self.last_error: Optional[str] = None
        self.restarts = 0                   # parent-side reconnects
        self._lock = threading.RLock()
        self._inflight: dict[str, Request] = {}
        self._orphans: list[Request] = []
        self._migrated: list[tuple[Request, MigrationTicket]] = []
        # telemetry mirrored from the worker (supervisor snapshot reads
        # these attributes exactly as it does off EngineReplica)
        self._cache: dict = {}
        self.migrations_out = 0
        self.migrated_tokens = 0
        self.reprefill_avoided_tokens = 0
        self.migrations_by_reason: dict[str, int] = {}
        self.migration_pauses_ms: list = []
        self.migration_log: list = []
        self.handoffs_out = 0
        self.handoff_tokens = 0
        self.handoffs_local = 0
        self.handoff_stalls_ms: list = []
        # fleet-global prefix cache: the worker's advertised page-hash
        # inventory (bytes) and fetch-side counters, refreshed per probe
        self._prefix_inv: tuple = ()
        # parent-side load adjustment: the probe cache is only as fresh
        # as the last poll, so submissions between probes would all pile
        # onto the same least-loaded replica. Work submitted since the
        # last probe is added to the routing signal until the next probe
        # reflects it worker-side.
        self._pending_outstanding = 0
        self._pending_depth = 0
        # reconnect gate
        self._fail_streak = 0
        self._retry_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- RPC plumbing --------------------------------------------------------

    def _rpc(self, path: str, body: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> dict:
        """One control RPC with a per-call timeout. Failures arm a
        doubling-backoff gate: until it expires, further RPCs fail fast
        (RemoteUnavailable) instead of hammering a dead endpoint — the
        reconnect schedule the probe loop then rides."""
        now = time.monotonic()
        with self._lock:
            if now < self._retry_at:
                raise RemoteUnavailable(
                    f"replica {self.replica_id} backing off "
                    f"({self._fail_streak} consecutive failures)")
        try:
            if self.injector is not None:
                self.injector.on_rpc(self.replica_id)
            if body is None:
                wire = urllib.request.Request(
                    f"{self.endpoint}{path}", method="GET")
            else:
                wire = urllib.request.Request(
                    f"{self.endpoint}{path}",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
            with urllib.request.urlopen(
                    wire, timeout=timeout_s or self.timeout_s) as resp:
                out = json.loads(resp.read().decode())
        except Exception as e:
            with self._lock:
                backoff = min(
                    self._backoff_base_s * (2 ** self._fail_streak),
                    self._backoff_max_s)
                self._fail_streak += 1
                self._retry_at = time.monotonic() + backoff
                self.last_error = f"{type(e).__name__}: {e}"
            raise RemoteUnavailable(
                f"replica {self.replica_id} rpc {path} failed: {e}") \
                from e
        with self._lock:
            self._fail_streak = 0
            self._retry_at = 0.0
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Sync the provisioned role to the worker and start the outbox
        poller (the thread that pulls finished results, orphans, and
        migrations back — the remote analogue of the engine thread's
        on_finish callbacks)."""
        try:
            self._rpc("/worker/role", {"role": self.role})
        except RemoteUnavailable as e:
            logger.warning("replica %d: role sync deferred (%s)",
                           self.replica_id, e)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name=f"llmctl-fleet-remote-{self.replica_id}")
            self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_outbox()
            except RemoteUnavailable:
                pass            # gate armed; probes own the verdict
            except Exception:
                logger.exception("replica %d outbox poll failed",
                                 self.replica_id)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout)
        self._thread = None

    def restart(self, params=None) -> None:
        """Reconnect attempt (the supervisor's restart path — ``params``
        is accepted for signature parity and ignored; the worker owns its
        own engine rebuilds). Raises when the endpoint is still dark so
        the supervisor re-arms its exponential backoff."""
        with self._lock:
            self._fail_streak = 0
            self._retry_at = 0.0
        self._rpc("/worker/probe")          # raises if still dark
        with self._lock:
            self.state = replica_mod.HEALTHY
            self.last_error = None
        self.restarts += 1
        self.start()

    def teardown(self) -> list[Request]:
        """Declared dead by probes (SIGKILL, black-holed endpoint):
        every request known in flight there is reset for requeue. Ticket
        stubs pointing at the dead worker are stripped by
        ``reset_for_requeue`` — the payload bytes died with the process,
        so survivors re-prefill from tokens (degraded, never wrong)."""
        self.stop()
        with self._lock:
            victims = list(self._inflight.values())
            victims += self._orphans
            victims += [req for req, _t in self._migrated]
            self._inflight.clear()
            self._orphans = []
            self._migrated = []
            self.state = replica_mod.CRASHED
        for r in victims:
            reset_for_requeue(r)
        logger.warning("remote replica %d torn down: %d in-flight "
                       "requests requeued", self.replica_id, len(victims))
        return victims

    # -- router surface ------------------------------------------------------

    def accepting(self) -> bool:
        with self._lock:
            return self.state == replica_mod.HEALTHY

    def submit(self, req: Request) -> bool:
        if not self.accepting():
            return False
        kv = req.swapped_kv
        if isinstance(kv, dict) and "courier_ticket" not in kv:
            # raw payload bytes cannot be teleported over a control RPC;
            # the router ships BEFORE submit, so reaching here means the
            # courier was bypassed — degrade to re-prefill loudly
            logger.warning("replica %d: raw KV payload on %s at remote "
                           "submit; dropping for re-prefill",
                           self.replica_id, req.request_id)
            req.swapped_kv = None
        try:
            out = self._rpc("/worker/submit", request_to_wire(req))
        except RemoteUnavailable:
            return False
        if not out.get("ok"):
            if out.get("reject_error"):
                # per-replica validation (prompt too long): surface the
                # error exactly like the in-proc submit path does
                req.error = str(out["reject_error"])
            return False
        with self._lock:
            self._inflight[req.request_id] = req
            self._pending_outstanding += (len(req.context_tokens)
                                          + max(req.remaining_tokens, 0))
            self._pending_depth += 1
        return True

    def cancel(self, request_id: str) -> bool:
        try:
            out = self._rpc("/worker/cancel", {"request_id": request_id})
        except RemoteUnavailable:
            return False
        if out.get("ok"):
            with self._lock:
                self._inflight.pop(request_id, None)
            return True
        return False

    def queue_depth(self) -> int:
        with self._lock:
            return (int(self._cache.get("queue_depth", 0))
                    + self._pending_depth)

    def active_count(self) -> int:
        return int(self._cache.get("active", 0))

    def outstanding_tokens(self) -> int:
        with self._lock:
            return (int(self._cache.get("outstanding_tokens", 0))
                    + self._pending_outstanding)

    def resident_requests(self) -> list[tuple[str, int, str]]:
        # older workers probe 2-tuples (no priority); default the class
        out = []
        for row in self._cache.get("resident_requests", []):
            rid, rem = row[0], row[1]
            pri = row[2] if len(row) > 2 else "standard"
            out.append((str(rid), int(rem), str(pri)))
        return out

    def queued_priority_wait_ms(self, priority: str) -> float:
        """Probe-stale mirror of the worker's worst queueing age for
        ``priority`` (only 'interactive' travels the probe wire today —
        the autoscaler's TTFT-preemption signal)."""
        if priority != "interactive":
            return 0.0
        return float(self._cache.get("queued_interactive_wait_ms", 0.0))

    def prefix_cache_stats(self) -> tuple[int, int, int]:
        return (int(self._cache.get("prefix_hits", 0)),
                int(self._cache.get("prefix_queries", 0)),
                int(self._cache.get("requeue_cached_tokens", 0)))

    def prefix_inventory(self) -> list:
        """The worker's advertised prefix-page hashes, as of the last
        probe — the router's fetch-hint input. Probe-stale by design: a
        page evicted since the advertise makes the fetch a counted miss,
        never wrong tokens."""
        with self._lock:
            return list(self._prefix_inv)

    def prefix_fetch_stats(self) -> dict:
        with self._lock:
            pf = self._cache.get("prefix_fetch") or {}
        return {"fetches": int(pf.get("fetches", 0)),
                "pages": int(pf.get("pages", 0)),
                "bytes": int(pf.get("bytes", 0)),
                "misses": int(pf.get("misses", 0)),
                "aborts": int(pf.get("aborts", 0)),
                "fetch_ms": list(pf.get("fetch_ms", [])),
                "fetch_count": int(pf.get("fetch_count", 0))}

    def spec_stats(self) -> dict:
        """The worker's speculative-decode counters, as of the last
        probe (probe-stale like every other mirrored counter)."""
        with self._lock:
            sp = self._cache.get("spec") or {}
        return {"dispatches": int(sp.get("dispatches", 0)),
                "drafts": int(sp.get("drafts", 0)),
                "accepted": int(sp.get("accepted", 0)),
                "resumes": int(sp.get("resumes", 0))}

    def pool_room_for(self, req: Request) -> bool:
        """The ``handoff_dest`` advisory's pool check for a remote decode
        replica: the probe carries the worker's pool facts (free pages net
        of reserves, page size, decode lookahead) and this consults them. Probe-stale room
        still races — the destination's own admission is the binding
        check, and a loser falls back to local decode, counted in
        ``handoffs_local`` — but a full remote pool no longer attracts
        every handoff. Optimistic (True) before the first probe."""
        with self._lock:
            ps = int(self._cache.get("pool_page_size", 0) or 0)
            free = int(self._cache.get("pool_free_pages", 0) or 0)
            look = int(self._cache.get("pool_lookahead", 0) or 0)
        if ps <= 0:
            return True
        need = -(-(len(req.context_tokens) + look) // ps)
        return need <= free

    def pool_free_ratio(self):
        """Probe-stale mirror of the worker's free-pool fraction; None
        before the first probe or when the worker has no pool facts —
        an unprobed remote must not vote pool pressure."""
        with self._lock:
            total = int(self._cache.get("pool_total_pages", 0) or 0)
            free = int(self._cache.get("pool_free_pages", 0) or 0)
        if total <= 0:
            return None
        return max(free, 0) / float(total)

    def migrations_in_flight(self) -> int:
        return int(self._cache.get("migrations_in_flight", 0))

    # -- supervisor surface --------------------------------------------------

    def probe(self) -> dict:
        """Health probe over HTTP. Raises RemoteUnavailable on transport
        failure (the supervisor counts the miss); a reachable worker is
        healthy even while its engine self-restarts — its orphans flow
        back through the outbox."""
        out = self._rpc("/worker/probe")
        self._absorb_probe(out)
        return out

    def _absorb_probe(self, out: dict) -> None:
        with self._lock:
            self._cache.update(out)
            # the worker's own view now includes everything we submitted
            # before this probe left; drop the parent-side adjustment
            self._pending_outstanding = 0
            self._pending_depth = 0
            worker_state = out.get("state")
            if worker_state == replica_mod.DRAINED:
                self.state = replica_mod.DRAINED
            elif worker_state == replica_mod.DRAINING:
                self.state = replica_mod.DRAINING
            else:
                # crashed/restarting engines are the WORKER's problem;
                # the process answering is what the parent cares about
                self.state = replica_mod.HEALTHY
            if out.get("role"):
                self.role = out["role"]
            self.migrations_out = int(out.get("migrations", 0))
            self.migrated_tokens = int(out.get("migrated_tokens", 0))
            self.reprefill_avoided_tokens = int(
                out.get("reprefill_avoided_tokens", 0))
            self.handoffs_out = int(out.get("handoffs", 0))
            self.handoff_tokens = int(out.get("handoff_tokens", 0))
            self.handoffs_local = int(out.get("handoffs_local", 0))
            if out.get("migrations_by_reason"):
                self.migrations_by_reason = dict(
                    out["migrations_by_reason"])
            if "prefix_pages" in out:
                try:
                    self._prefix_inv = tuple(
                        bytes.fromhex(h) for h in out["prefix_pages"])
                except (TypeError, ValueError):
                    self._prefix_inv = ()

    def poll_outbox(self) -> int:
        """Pull finished results / orphans / migrations from the worker
        and apply them. Returns how many entries were absorbed."""
        out = self._rpc("/worker/outbox/take", {})
        if out.get("probe"):
            self._absorb_probe(out["probe"])
        entries = out.get("entries", [])
        for e in entries:
            kind = e.get("kind")
            if kind == "finished":
                self._apply_finished(e)
            elif kind == "orphan":
                req = self._resolve(e)
                with self._lock:
                    self._orphans.append(req)
            elif kind in ("migrated", "handoff"):
                req = self._resolve(e)
                reason = "handoff" if kind == "handoff" \
                    else e.get("reason", "drain")
                with self._lock:
                    self._migrated.append((req, MigrationTicket(
                        request_id=req.request_id, dest=e.get("dest"),
                        reason=reason)))
            elif kind == "stream":
                self._apply_stream(e)
            else:
                logger.warning("replica %d: unknown outbox entry %r",
                               self.replica_id, kind)
        return len(entries)

    def _apply_stream(self, e: dict) -> None:
        """One cursor-tagged token batch from the worker's outbox. The
        committed tokens fold onto the parent-side Request object (with
        the worker's assigned_seed), so a later SIGKILL teardown requeues
        from the last STREAMED token instead of position zero — the
        survivor re-prefills the streamed context and continues the same
        PRNG stream, resuming delivery with no client-visible gap. Then
        the batch is forwarded to the hub, which dedupes by seq (a stale
        poll or post-requeue regeneration re-sends nothing)."""
        rid = str(e.get("request_id", ""))
        try:
            start = int(e.get("start", 0))
            toks = [int(t) for t in e.get("tokens", [])]
        except (TypeError, ValueError):
            logger.warning("replica %d: malformed stream entry for %s",
                           self.replica_id, rid)
            return
        if not rid or not toks:
            return
        with self._lock:
            req = self._inflight.get(rid)
            if req is not None:
                if req.assigned_seed is None \
                        and e.get("seed") is not None:
                    req.assigned_seed = int(e["seed"])
                gen = req.generated_tokens
                if start <= len(gen) < start + len(toks):
                    gen.extend(toks[len(gen) - start:])
                if req.first_token_time is None:
                    req.first_token_time = time.monotonic()
        cb = self.on_tokens
        if cb is not None:
            cb(self.replica_id, rid, start, toks)

    def _resolve(self, e: dict) -> Request:
        d = e["request"]
        rid = str(d["request_id"])
        with self._lock:
            req = self._inflight.pop(rid, None)
        if req is None:
            # unknown to this parent (e.g. it restarted): rebuild; the
            # router will skip it if its ledger has no entry
            req = request_from_wire(d)
        else:
            apply_wire(req, d)
        ticket = e.get("ticket")
        if ticket:
            req.swapped_kv = ticket_stub(ticket, self.replica_id,
                                         partial=e.get("partial", False))
        else:
            req.swapped_kv = None
        return req

    def _apply_finished(self, e: dict) -> None:
        rid = str(e["request_id"])
        with self._lock:
            req = self._inflight.pop(rid, None)
        if req is None:
            # another front submitted it (multi-front outbox split):
            # hand the terminal facts to the fleet's foreign-finish
            # path so the shared stream log and ledger still close
            if self.on_foreign is not None:
                self.on_foreign(self.replica_id, e)
            return
        req.generated_tokens = [int(t) for t in
                                e.get("generated_tokens", [])]
        now = time.monotonic()
        if e.get("ttft_ms") is not None and req.first_token_time is None:
            req.first_token_time = req.arrival_time + e["ttft_ms"] / 1e3
        req.finish_time = now
        req.finish_reason = e.get("finish_reason")
        if e.get("state") == "failed":
            req.state = RequestState.FAILED
            req.error = e.get("error") or "failed on remote worker"
        else:
            req.state = RequestState.FINISHED
        if self.on_finish is not None:
            self.on_finish(self.replica_id, req)

    def complete_foreign(self, rid: str, rec: dict) -> bool:
        """Complete a locally-held request from a FOLDED terminal ledger
        record (serve/fleet/state.py): this front submitted the request,
        but its finished outbox entry drained to a sibling front, which
        journaled the terminal facts. Applies them to the local Request
        object and fires ``on_finish`` so waiters (HTTP responses, SSE
        finish frames) resolve. False = not held here."""
        with self._lock:
            req = self._inflight.pop(rid, None)
        if req is None:
            return False
        toks = rec.get("tokens")
        if toks is not None:
            req.generated_tokens = [int(t) for t in toks]
        now = time.monotonic()
        if req.first_token_time is None:
            req.first_token_time = now
        req.finish_time = now
        req.finish_reason = rec.get("finish_reason")
        if rec.get("outcome") == "failed":
            req.state = RequestState.FAILED
            req.error = rec.get("error") or "failed on remote worker"
        else:
            req.state = RequestState.FINISHED
        if self.on_finish is not None:
            self.on_finish(self.replica_id, req)
        return True

    def take_orphans(self) -> list[Request]:
        with self._lock:
            out, self._orphans = self._orphans, []
        return out

    def take_migrated(self) -> list[tuple[Request, MigrationTicket]]:
        with self._lock:
            out, self._migrated = self._migrated, []
        return out

    def request_drain(self) -> None:
        with self._lock:
            self.state = replica_mod.DRAINING
        try:
            self._rpc("/worker/drain", {})
        except RemoteUnavailable as e:
            logger.warning("replica %d drain rpc failed: %s",
                           self.replica_id, e)

    def undrain(self) -> None:
        try:
            self._rpc("/worker/undrain", {})
        except RemoteUnavailable as e:
            logger.warning("replica %d undrain rpc failed: %s",
                           self.replica_id, e)
            return
        with self._lock:
            self.state = replica_mod.HEALTHY

    def set_role(self, role: str) -> None:
        try:
            self._rpc("/worker/role", {"role": role})
        except RemoteUnavailable as e:
            logger.warning("replica %d role rpc failed: %s",
                           self.replica_id, e)
            return
        self.role = role

    def request_migrate(self, request_id: str, dest: Optional[int] = None,
                        reason: str = "operator") -> bool:
        try:
            out = self._rpc("/worker/migrate",
                            {"request_id": request_id, "dest": dest,
                             "reason": reason})
        except RemoteUnavailable:
            return False
        return bool(out.get("ok"))
