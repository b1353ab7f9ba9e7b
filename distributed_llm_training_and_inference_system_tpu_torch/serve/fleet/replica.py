"""One fleet replica: an InferenceEngine on its own engine thread.

The port's copy of the JAX package's ``serve/fleet/replica.py``. Replicas
in one process share one card: each steps its engine on its own thread,
all on the current (default) stream. Payloads that leave an engine are
host numpy arrays made by ``kv_cache.payload_numpy``, which waits for the
card first; a restart releases the crashed engine's weights reference and
KV pool before the new engine allocates its own.

Mirrors the single-server engine loop (serve/server.py ``_engine_loop``)
with two fleet-specific differences:

- **Crash = requeue, not fail.** The single server answers an engine-thread
  exception with ``fail_all`` (waiters get HTTP 500). In a fleet the whole
  point is that another replica can finish the work: the dying thread rips
  every queued + resident request out of the scheduler (no page bookkeeping
  — the engine is discarded and rebuilt on restart), resets them for
  re-prefill, and stashes them as *orphans* for the supervisor to reroute.

- **Drain runs ON the engine thread.** Engine device state (KV page arrays,
  pipelined dispatch records) is touched outside ``engine.lock`` by the
  stepping thread, so a foreign thread can never safely evict slots. A
  drain request just sets a flag; the engine thread performs the eviction
  itself at the next step boundary — after catching up the pipelined
  dispatch — using the engine's own preemption path, so KV pages are
  released (not leaked) and resident requests resume elsewhere from
  prompt+generated exactly like a preemption resume (token-identical:
  same assigned_seed, PRNG folded by position).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

from ...config.schema import FleetConfig, ModelConfig, ServeConfig
from ..engine import InferenceEngine
from ..kv_cache import payload_numpy
from ..scheduler import Request, RequestState
from . import migration
from .faults import FaultInjector
from .migration import MigrationTicket

logger = logging.getLogger("llmctl.serve.fleet.replica")

# replica lifecycle states
from ...analysis.annotations import (engine_thread_only, thread_seam)
STARTING = "starting"
HEALTHY = "healthy"
DRAINING = "draining"     # drain requested; engine thread not yet at boundary
DRAINED = "drained"       # out of rotation, engine alive and empty
CRASHED = "crashed"       # engine thread died; orphans await requeue
STOPPED = "stopped"

# disaggregated prefill/decode roles (DistServe/Splitwise — PAPERS.md).
# A prefill-role replica admits new prompts, prefills them, and hands
# each sequence WITH its KV to a decode-capable replica at the
# prefill-complete boundary (the degenerate one-phase migration); a
# decode-role replica only ever restores handed-off payloads and
# decodes. Mixed = classic fleet replica (both phases).
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"


def reset_for_requeue(req: Request, keep_kv: bool = False) -> None:
    """Make a request admissible on another replica. Generated tokens and
    ``assigned_seed`` are KEPT: the new replica re-prefills prompt+generated
    (the engine's preemption-resume path) and continues the same per-position
    PRNG stream, so greedy and seeded-sampled output is token-identical to
    an undisturbed run. Replica-local state (the slot) is dropped.

    ``prefix_hashes`` are NOT replica-local — they digest token content,
    and a survivor holding the prompt's pages in its prefix cache serves
    them without recompute — so they are preserved whenever they still
    describe the full resume context (no tokens generated yet: the common
    crash-orphan case). Once decode produced tokens the context outgrew
    the hashed chain and the survivor rehashes at admission (keeping the
    short chain would make the publish loop index past its end).

    ``keep_kv=True`` preserves ``swapped_kv``: the payload is host memory,
    independent of the source engine — the KV-migration handoff
    (serve/fleet/migration.py). Default drops it (crash paths, where a
    partially-built payload must not travel)."""
    req.state = RequestState.QUEUED
    req.slot = None
    req.error = None
    req.finish_time = None
    req.finish_reason = None
    req.cancel_requested = False
    req.fleet_requeued = True
    # placement-time fetch hints are stale the moment the request leaves
    # its replica; the router re-attaches fresh ones (or none) at the
    # next placement
    req.prefix_owner = None
    req.prefix_owner_endpoint = None
    if req.generated_tokens:
        req.prefix_hashes = None
    if not keep_kv:
        req.swapped_kv = None


class EngineReplica:
    """An engine + its stepping thread + fleet bookkeeping."""

    def __init__(self, replica_id: int, model_cfg: ModelConfig,
                 serve_cfg: ServeConfig, params=None, seed: int = 0,
                 injector: Optional[FaultInjector] = None,
                 on_finish: Optional[Callable[[int, Request], None]] = None,
                 eos_token_id: Optional[int] = None,
                 fleet_cfg: Optional[FleetConfig] = None,
                 role: str = ROLE_MIXED, device=None):
        self.replica_id = replica_id
        self.device = device
        self.serve_cfg = serve_cfg
        self.seed = seed
        self.injector = injector
        self.eos_token_id = eos_token_id
        self.role = role
        self._migrate_on_drain = bool(fleet_cfg.migrate_on_drain) \
            if fleet_cfg is not None else False
        # fleet-global prefix cache: the fetch half (this replica is the
        # cache-cold destination). `prefix_fetcher` is injected by
        # ServeFleet (KVCourier.fetch_prefix) or FleetWorker (its
        # socket fetcher); the engine's prefix_fetch_hook calls through
        # _fetch_prefix, which owns the counters below.
        self.prefix_fetcher: Optional[Callable] = None
        self._prefix_fetch = bool(getattr(fleet_cfg, "prefix_fetch",
                                          False)) \
            if fleet_cfg is not None else False
        self._prefix_fetch_min_pages = int(getattr(
            fleet_cfg, "prefix_fetch_min_pages", 1) or 1)
        self._prefix_fetch_timeout_s = float(getattr(
            fleet_cfg, "prefix_fetch_timeout_s", 5.0) or 5.0)
        self._prefix_inventory_max = int(getattr(
            fleet_cfg, "prefix_inventory_max", 512) or 0) \
            if fleet_cfg is not None else 0
        self.prefix_fetches = 0          # fetches that imported pages
        self.prefix_fetch_pages = 0      # pages received over the wire
        self.prefix_fetch_bytes = 0
        self.prefix_fetch_misses = 0     # owner had nothing / no payload
        self.prefix_fetch_aborts = 0     # transfer/RPC failed
        self.prefix_fetch_ms: deque = deque(maxlen=64)
        # owner half: extract jobs other replicas queued for our prefix
        # pages; serviced ON the engine thread between steps (the pages are
        # read at a loop boundary, between the thread's dispatches). Import
        # jobs (pipelined-prefill pre-ship deliveries) share the queue.
        self._prefix_jobs: list[dict] = []
        # pipelined prefill (serve/fleet/pipeline.py): the coordinator's
        # chunk-progress sink, fired from the engine thread after every
        # chunk of a stage request (enqueue-only on the far side)
        self.on_pipeline_chunk: Optional[Callable] = None
        # single-request migrations (rebalance / operator): ticket state
        # advances ONLY on the engine thread at step boundaries; the dict
        # itself is shared with the supervisor thread (_state_lock)
        self._migrations: dict[str, MigrationTicket] = {}
        self._migrated: list[tuple[Request, MigrationTicket]] = []
        self.migrations_out = 0
        self.migrated_tokens = 0            # KV entries moved (source side)
        self.reprefill_avoided_tokens = 0   # drain path: context NOT recomputed
        self.migrations_by_reason: dict[str, int] = {}
        self.migration_pauses_ms: deque = deque(maxlen=64)
        self.migration_log: deque = deque(maxlen=64)   # per-move detail
        # prefill->decode handoff plane (disaggregated serving):
        # `handoff_dest` is the router's pre-extraction advisory (which
        # decode replica has pool room — None means decode locally);
        # `on_handoff` places the extracted sequence, synchronously on
        # THIS engine thread, so a handoff never waits for a supervisor
        # poll (that latency would land in every stream's ITL)
        self.handoff_dest: Optional[Callable] = None
        self.on_handoff: Optional[Callable] = None
        self.handoffs_out = 0
        self.handoff_tokens = 0          # KV entries shipped at handoff
        self.handoffs_local = 0          # fallbacks: decoded at the source
        self.handoff_stalls_ms: deque = deque(maxlen=64)
        self.handoff_log: deque = deque(maxlen=64)
        # tiered fleet KV store (serve/fleet/kv_store.py): when set (via
        # `set_kv_store`), hashed prefix pages this engine evicts are
        # DEMOTED to the host-tier store instead of destroyed
        # (asynchronously — the store's encoder worker pays the
        # deflate, not this engine thread), and drain/retire flushes
        # the whole inventory there synchronously — scale-down stops
        # being cache-destructive. Duck-typed FleetKVStore surface:
        # demote_async(hashes, payload) / demote(hashes, payload).
        self.kv_store = None
        self.store_flush_pages = 0      # pages flushed at drain/retire
        # fired with (replica_id, request) whenever a request leaves its
        # slot terminally on this replica (finished/cancelled) — the
        # router's completion hook. NOT fired on crash/drain extraction.
        self.on_finish = on_finish
        # fleet SSE streaming: fired with (replica_id, request, tokens)
        # for each freshly-accepted token batch of a STREAMING request
        # (engine on_token, forwarded only when req.stream_requested).
        # Set by ServeFleet to feed the FleetStreamHub; fires on the
        # engine thread, sometimes under engine.lock — the hub never
        # calls back into an engine, so no inversion is possible.
        self.on_token: Optional[Callable] = None
        # host-local CourierReceiver (set by ServeFleet / FleetWorker):
        # payload-carrying requests arrive holding a ticket STUB; submit
        # attaches the completed payload from this receiver — the
        # destination-terminated half of the courier. None = direct
        # payloads only (offline/unit use).
        self.courier_receiver = None
        self._state_lock = threading.Lock()
        self.state = STARTING
        self.last_error: Optional[str] = None
        self.restarts = 0          # maintained by the supervisor
        self._drain_requested = threading.Event()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._orphans: list[Request] = []
        self.engine = InferenceEngine(model_cfg, serve_cfg, params=params,
                                      seed=seed, eos_token_id=eos_token_id,
                                      device=device)
        # the engine may refine model_cfg from an artifact; later restarts
        # and sibling replicas must build from the EFFECTIVE config
        self.model_cfg = self.engine.cfg
        self._wire_engine()
        self.state = HEALTHY

    def _wire_engine(self) -> None:
        """Attach the fleet hooks + role expectations to self.engine (also
        re-run after restart() builds a fresh one)."""
        self.engine.on_finish = self._engine_finished
        self.engine.on_token = self._engine_tokens
        self.engine.on_prefill_complete = self._on_prefill_complete
        self.engine.expect_pure_decode = (self.role == ROLE_DECODE)
        self.engine.prefix_fetch_hook = (self._fetch_prefix
                                         if self._prefix_fetch else None)
        self.engine.pipeline_chunk_hook = self._pipeline_chunk
        kv = getattr(self.engine, "kv", None)
        if kv is not None:
            kv.demote_hook = (self._demote_pages
                              if self.kv_store is not None else None)

    @thread_seam
    def set_kv_store(self, store) -> None:
        """Attach (or detach) the tiered-store demotion sink. Applied to
        the current engine and re-applied by ``_wire_engine`` after every
        restart, so a rebuilt engine keeps demoting."""
        self.kv_store = store
        kv = getattr(self.engine, "kv", None)
        if kv is not None:
            kv.demote_hook = (self._demote_pages
                              if store is not None else None)

    @engine_thread_only
    def _pipeline_chunk(self, req: Request, done: int,
                        finished: bool) -> None:
        """Engine pipeline_chunk_hook: a pipelined-prefill stage request
        advanced one chunk (its full pages are registered). Forward to
        the coordinator with our id; the far side only enqueues."""
        cb = self.on_pipeline_chunk
        if cb is not None and getattr(req, "pipeline_stage", None):
            try:
                cb(self.replica_id, req, done, finished)
            except Exception:
                logger.exception(
                    "replica %d pipeline chunk callback failed",
                    self.replica_id)

    @engine_thread_only
    def _demote_pages(self, hashes: list, content: dict) -> None:
        """PagedKVCache.demote_hook: the hashed pages an allocation just
        evicted (batched — one gather per allocation) — hand their
        content to the fleet store's background encoder (the engine
        thread never pays the deflate). Failures are the store's to
        swallow, and cost only a future recompute."""
        store = self.kv_store
        if store is not None:
            store.demote_async(hashes, content)

    @engine_thread_only
    def _flush_inventory_to_store(self) -> None:
        """Demote EVERY cached prefix page to the fleet store — the
        drain/retire seam that makes scale-down preserve the cluster
        cache. One batched device extract, split per page by the store.
        Guarded: a broken engine (teardown after a crash declaration)
        just skips the flush."""
        store = self.kv_store
        eng = self.engine
        kv = getattr(eng, "kv", None)
        if store is None or kv is None:
            return
        try:
            with eng.lock:
                pairs = kv.prefix_cache_pairs()
                if not pairs:
                    return
                hashes = [h for h, _p in pairs]
                payload = kv.extract_pages([p for _h, p in pairs])
            # synchronous on purpose: a retiring replica must have its
            # inventory durably down a tier before it leaves rotation
            flushed = store.demote(hashes, payload)
            with self._state_lock:
                self.store_flush_pages += int(flushed or 0)
            logger.info("replica %d flushed %d/%d cached prefix pages "
                        "to the fleet KV store", self.replica_id,
                        int(flushed or 0), len(pairs))
        except Exception:
            logger.exception(
                "replica %d inventory flush to the KV store failed",
                self.replica_id)

    @thread_seam
    def set_role(self, role: str) -> None:
        """Re-role this replica (balancer / operator). Takes effect for
        requests admitted from now on; residents finish where they are."""
        with self._state_lock:
            self.role = role
        self.engine.expect_pure_decode = (role == ROLE_DECODE)
        logger.info("replica %d role -> %s", self.replica_id, role)

    # -- engine thread -------------------------------------------------------

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"llmctl-fleet-replica-{self.replica_id}")
            self._thread.start()

    @engine_thread_only
    def _loop(self) -> None:
        logger.info("replica %d engine thread started", self.replica_id)
        eng = self.engine
        while not self._stop.is_set():
            if self._drain_requested.is_set():
                self._drain_on_thread()
                self._drain_requested.clear()
                continue
            if self._migrations:
                try:
                    self._service_migrations()
                except Exception as e:   # broken engine mid-copy
                    self._crash(e)
                    return
            if self._prefix_jobs:
                # owner half of the fleet prefix fetch: extraction runs
                # here, between steps, where no dispatch of this thread
                # is half-issued; per-job failures answer a miss
                # instead of crashing the replica
                self._service_prefix_extracts()
            with eng.lock:
                busy = (eng.scheduler.queue_depth > 0
                        or eng.scheduler.active_count > 0)
            if not busy:
                self._wake.wait(timeout=0.02)
                self._wake.clear()
                continue
            try:
                if self.injector is not None:
                    active = None
                    if self.injector.wants_request_ids:
                        # request-keyed crash plans (the bench's pipeline
                        # chaos arm) need to see WHICH requests this step
                        # serves, not just that a step happened
                        with eng.lock:
                            active = [r.request_id
                                      for r in eng.scheduler.slots
                                      if r is not None]
                            active += [r.request_id
                                       for r in eng.scheduler.waiting]
                    self.injector.before_step(self.replica_id,
                                              active=active)
                    d = self.injector.step_delay_s(self.replica_id)
                    if d > 0:
                        time.sleep(d)
                eng.step()
            except Exception as e:
                self._crash(e)
                return                      # thread dies, like a process
        logger.info("replica %d engine thread stopped", self.replica_id)

    @engine_thread_only
    def _crash(self, exc: Exception) -> None:
        """Engine-thread death: stash every in-flight request as an orphan
        for the supervisor to reroute. No KV bookkeeping — this engine is
        discarded; restart() builds a fresh one."""
        logger.warning("replica %d crashed: %s", self.replica_id, exc)
        with self._state_lock:
            self.state = CRASHED
            self.last_error = f"{type(exc).__name__}: {exc}"
            # in-flight migration tickets die with the engine — but a
            # ticket caught BETWEEN its two phases already copied the
            # victim's full (immutable) pages to host memory, and host
            # memory doesn't die with the engine thread. Those pre-copies
            # are salvaged as PARTIAL payloads: the destination writes
            # the covered pages back and re-prefills only the uncovered
            # tail (engine._prefill partial-restore path), crediting
            # reprefill_tokens_avoided. Tickets still in phase 1 have
            # copied nothing and fall back to plain requeue.
            # COMPLETED migrations (_migrated) survive as before: those
            # payloads are whole and their requests already left.
            partials = self._salvage_precopies()
            self._migrations.clear()
        orphans = self._rip_out()
        for r in orphans:
            p = partials.get(r.request_id)
            if p is not None:
                r.swapped_kv = p
        with self._state_lock:
            self._orphans.extend(orphans)
        self._fail_prefix_jobs()

    def _salvage_precopies(self) -> dict[str, dict]:
        """Partial ``swapped_kv`` payloads from migration tickets whose
        phase-1 pre-copy completed before the engine died. Caller holds
        ``_state_lock``; the engine object (and its page-size constant)
        outlives its thread."""
        kv = getattr(self.engine, "kv", None)
        if kv is None:
            return {}
        out = {}
        for rid, t in self._migrations.items():
            if t.pre and t.pre.get("pages") is not None:
                out[rid] = {
                    "pages": t.pre["pages"],
                    "positions": t.pre["full_pages"] * kv.page_size,
                    "partial": True,
                }
        return out

    def _rip_out(self) -> list[Request]:
        """Remove every queued + resident request from a dead (or stopping)
        engine without touching its KV pool, reset each for requeue."""
        eng = self.engine
        with eng.lock:
            victims = list(eng.scheduler.waiting)
            eng.scheduler.waiting.clear()
            for i, r in enumerate(eng.scheduler.slots):
                if r is not None:
                    victims.append(r)
                    eng.scheduler.slots[i] = None
            eng._partial_prefills.clear()
            eng._pending = None
        for r in victims:
            reset_for_requeue(r)
        return victims

    @engine_thread_only
    def _drain_on_thread(self) -> None:
        """Graceful eviction, executed BY the engine thread between steps:
        catch up the pipelined dispatch, preempt every resident request
        through the engine's own path (KV pages released, prefix pages
        published), then empty the queue.

        With ``migrate_on_drain`` the resident sequences leave WITH their
        paged KV (two-phase: pre-copy full pages, run one more decode
        dispatch while the bulk is already copied, stop-and-copy only the
        tail) — the survivor restores the pages and resumes with zero
        re-prefill. Otherwise orphans resume elsewhere from
        prompt+generated, PR-2 style."""
        eng = self.engine
        try:
            eng._drain_pending()
            tickets: list[tuple[Request, dict]] = []
            if self._migrate_on_drain:
                with eng.lock:
                    for slot, r in enumerate(eng.scheduler.slots):
                        if r is not None and r.state is RequestState.RUNNING:
                            tickets.append(
                                (r, migration.precopy_slot(eng, slot)))
                interleave = not (eng._spec_on and eng.kv.quantized)
                if tickets and any(eng.active) and interleave:
                    # phase 1 done: let decode advance one dispatch while
                    # the full pages are already on host — the stop phase
                    # then covers only the tail written since. Decode-only
                    # (not eng.step()): a drain must not START a queued
                    # request's prefill just to evict it again.
                    #
                    # SKIPPED under speculation + quantized KV: committed
                    # quantized K/V bytes depend on dispatch grouping
                    # (the dequant multiply fuses into different program
                    # contexts for the verify window vs the decode scan),
                    # so a decode-only dispatch where the undisturbed
                    # engine would have speculated forks the byte stream
                    # — the destination could then diverge token-wise.
                    # Going straight to stop-and-copy keeps the dispatch
                    # schedule identical; the pause only grows by the
                    # tail the skipped dispatch would have absorbed.
                    with eng.lock:
                        eng._ensure_decode_capacity()
                    if any(eng.active):
                        sampled = eng._decode_device()
                        with eng.lock:
                            eng._apply_decode(sampled)
                            eng.scheduler.step_finished(eng.eos_token_id)
            victims: list[Request] = []
            with eng.lock:
                # phase 2: stop-and-copy sequences still resident (ones
                # that finished during the interleaved dispatch are done —
                # the best outcome a migration can have)
                for r, pre in tickets:
                    slot = eng._req_slot.get(r.request_id)
                    if slot is None or eng.scheduler.slots[slot] is not r \
                            or r.state is not RequestState.RUNNING:
                        continue
                    payload, detail = migration.stop_and_copy(eng, slot, pre)
                    eng._preempt(slot)   # pages freed, -> waiting head
                    # AFTER _preempt: in preemption=swap mode it stashes
                    # its own full-chain extraction, which the two-phase
                    # payload supersedes
                    r.swapped_kv = payload
                    self._note_migration(r, payload, detail, reason="drain")
                # chunked prefills: drop progress, release the slot's pages
                # manually (there is no preemption path for PREFILLING)
                for rid in list(eng._partial_prefills):
                    del eng._partial_prefills[rid]
                for slot, r in enumerate(eng.scheduler.slots):
                    if r is None:
                        continue
                    if r.state is RequestState.RUNNING:
                        eng._preempt(slot)   # -> waiting head, pages freed
                    else:                    # PREFILLING (chunked)
                        eng._reserved_pages -= eng._reserved_by.pop(
                            r.request_id, 0)
                        pins = eng._prefix_pins.pop(r.request_id, None)
                        if r.request_id in eng._req_slot:
                            eng._req_slot.pop(r.request_id)
                            eng.kv.release(slot)
                        if pins:
                            eng.kv.unpin_pages(pins)
                        eng.active[slot] = False
                        eng.positions[slot] = 0
                        eng.stop_positions[slot] = 0
                        eng.scheduler.slots[slot] = None
                        r.slot = None
                        eng.scheduler.waiting.appendleft(r)
                victims = list(eng.scheduler.waiting)
                eng.scheduler.waiting.clear()
            for r in victims:
                # migrated victims carry their two-phase payload; under
                # migrate_on_drain, queued swap-preempted victims keep
                # theirs too (host arrays restore anywhere)
                reset_for_requeue(r, keep_kv=self._migrate_on_drain)
            # tiered KV store: a drain is the scale-down path — flush
            # the whole prefix inventory down a tier so the cluster
            # cache survives this replica leaving rotation (the
            # preemptions above just published the residents' pages, so
            # the flush covers them too)
            self._flush_inventory_to_store()
            with self._state_lock:
                self._orphans.extend(victims)
                self.state = DRAINED
            logger.info("replica %d drained (%d requests requeued)",
                        self.replica_id, len(victims))
        except Exception as e:           # drain hit a broken engine
            self._crash(e)

    @engine_thread_only
    def _engine_finished(self, req: Request) -> None:
        if self.on_finish is not None:
            self.on_finish(self.replica_id, req)

    @engine_thread_only
    def _engine_tokens(self, req: Request, tokens: list) -> None:
        """Engine on_token hook: forward a streaming request's fresh
        batch to the fleet stream plane. Non-streaming requests (and
        warmup generates) skip the callback entirely."""
        cb = self.on_token
        if cb is not None and getattr(req, "stream_requested", False):
            cb(self.replica_id, req, tokens)

    # -- prefill->decode handoff (engine-thread half) ------------------------

    @engine_thread_only
    def _on_prefill_complete(self, req: Request) -> None:
        """Engine prefill-complete hook (engine thread, no locks held):
        on a prefill-role replica the freshly-prefilled sequence leaves
        WITH its KV instead of occupying a decode slot — the one-phase
        handoff (serve/fleet/migration.py ``handoff_slot``), placed
        synchronously so the stream's first decode token is delayed only
        by the copy itself, never by a supervisor poll. When no decode
        replica has pool room the sequence stays and decodes here (local
        fallback: correct, just not disaggregated)."""
        if self.role != ROLE_PREFILL or self.on_handoff is None:
            return
        if self._thread is None or not self._thread.is_alive():
            return        # offline use (warmup/compile): no fleet to hand to
        dest = (self.handoff_dest(req, self.replica_id)
                if self.handoff_dest is not None else None)
        if dest is None:
            self.handoffs_local += 1
            logger.info("replica %d: no decode pool room for %s, "
                        "decoding locally", self.replica_id, req.request_id)
            return
        eng = self.engine
        t0 = time.perf_counter()
        with eng.lock:
            slot = eng._req_slot.get(req.request_id)
            if slot is None or eng.scheduler.slots[slot] is not req \
                    or req.state is not RequestState.RUNNING:
                return
            payload, detail = migration.handoff_slot(eng, slot)
            eng._preempt(slot)   # pages freed, prefix pages published
            # _preempt parked it at the waiting head; a handed-off
            # sequence leaves this engine entirely
            if eng.scheduler.waiting and eng.scheduler.waiting[0] is req:
                eng.scheduler.waiting.popleft()
            else:
                eng.scheduler.waiting.remove(req)
        reset_for_requeue(req, keep_kv=True)
        req.swapped_kv = payload
        req.handoff_time = time.monotonic()
        req.handoffs += 1
        self.on_handoff(self.replica_id, req, dest)
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._note_handoff(req, payload, detail, stall_ms, dest)

    @engine_thread_only
    def _note_handoff(self, req: Request, payload: dict, detail: dict,
                      stall_ms: float, dest: Optional[int]) -> None:
        self.handoffs_out += 1
        self.handoff_tokens += int(payload["positions"])
        self.handoff_stalls_ms.append(float(stall_ms))
        self.handoff_log.append({**detail, "request_id": req.request_id,
                                 "dest": dest, "stall_ms": stall_ms,
                                 "payload_bytes":
                                     migration.payload_nbytes(payload)})
        logger.info(
            "replica %d handed off %s -> replica %s: %d prefill tokens in "
            "%d pages, stall %.2f ms", self.replica_id, req.request_id,
            dest, payload["positions"], detail["total_pages"], stall_ms)

    # -- KV migration (engine-thread half) -----------------------------------

    @engine_thread_only
    def _note_migration(self, req: Request, payload: dict, detail: dict,
                        reason: str) -> None:
        self.migrations_out += 1
        self.migrated_tokens += int(payload["positions"])
        self.migrations_by_reason[reason] = (
            self.migrations_by_reason.get(reason, 0) + 1)
        if reason == "drain":
            # the counterfactual was re-prefilling prompt+generated on the
            # survivor; a rebalance move avoids nothing (it would simply
            # have stayed put), so only drain credits avoided tokens
            self.reprefill_avoided_tokens += len(req.context_tokens)
        self.migration_pauses_ms.append(float(detail["pause_ms"]))
        self.migration_log.append({**detail, "request_id": req.request_id,
                                   "reason": reason,
                                   "payload_bytes":
                                       migration.payload_nbytes(payload)})
        logger.info(
            "replica %d migrated %s out (%s): %d tokens, %d pages "
            "pre-copied + %d stop-copied, pause %.2f ms",
            self.replica_id, req.request_id, reason, payload["positions"],
            detail["precopy_pages"], detail["stop_pages"],
            detail["pause_ms"])

    @engine_thread_only
    def _service_migrations(self) -> None:
        """Advance in-flight single-request migrations (rebalance /
        operator) at a step boundary, ON the engine thread. One phase per
        boundary visit: phase 1 pre-copies the victim's full (immutable)
        pages and returns — the loop keeps decoding — and the NEXT visit
        stop-and-copies only the pages written since, evicts through the
        engine's own preemption path, and stashes (request, ticket) for
        the supervisor's courier."""
        with self._state_lock:
            tickets = list(self._migrations.items())
        eng = self.engine
        eng._drain_pending()
        for rid, t in tickets:
            handoff: Optional[Request] = None
            with eng.lock:
                slot = eng._req_slot.get(rid)
                req = (eng.scheduler.slots[slot]
                       if slot is not None else None)
                valid = (req is not None and req.request_id == rid
                         and req.state is RequestState.RUNNING)
                if valid and t.phase == "precopy":
                    t.pre = migration.precopy_slot(eng, slot)
                    t.phase = "stop"
                elif valid:
                    payload, t.detail = migration.stop_and_copy(
                        eng, slot, t.pre)
                    eng._preempt(slot)
                    # _preempt parked it at the waiting head; a migrating
                    # request leaves this engine entirely
                    if eng.scheduler.waiting and \
                            eng.scheduler.waiting[0] is req:
                        eng.scheduler.waiting.popleft()
                    else:
                        eng.scheduler.waiting.remove(req)
                    handoff = req
            if not valid:
                # finished / preempted / requeued since the request was
                # ticketed: nothing to move (and the pre-copy, if any, is
                # stale) — drop the ticket, the request is wherever the
                # normal paths put it
                with self._state_lock:
                    self._migrations.pop(rid, None)
                continue
            if handoff is not None:
                reset_for_requeue(handoff, keep_kv=True)
                handoff.swapped_kv = payload
                self._note_migration(handoff, payload, t.detail, t.reason)
                with self._state_lock:
                    self._migrations.pop(rid, None)
                    self._migrated.append((handoff, t))

    # -- fleet-facing API ----------------------------------------------------

    @thread_seam
    def accepting(self) -> bool:
        with self._state_lock:
            return self.state == HEALTHY

    @thread_seam
    def submit(self, req: Request) -> bool:
        if not self.accepting():
            return False
        from .transport import is_ticket_stub
        if is_ticket_stub(req.swapped_kv):
            # attach the courier-delivered payload by ticket, locally —
            # no sender round-trip. A missing/expired ticket degrades to
            # re-prefill (correct tokens, extra compute), never blocks.
            ticket = req.swapped_kv["courier_ticket"]
            recv = self.courier_receiver
            payload = recv.take_payload(ticket) if recv is not None \
                else None
            if payload is None:
                logger.warning(
                    "replica %d: courier ticket %s missing/expired for "
                    "%s; falling back to re-prefill", self.replica_id,
                    ticket, req.request_id)
            req.swapped_kv = payload
        with self.engine.lock:
            ok = self.engine.scheduler.add_request(req)
        if ok:
            self._wake.set()
        return ok

    @thread_seam
    def cancel(self, request_id: str) -> bool:
        with self.engine.lock:
            return self.engine.scheduler.cancel(request_id)

    @thread_seam
    def queue_depth(self) -> int:
        return self.engine.scheduler.queue_depth

    @thread_seam
    def active_count(self) -> int:
        return self.engine.scheduler.active_count

    @thread_seam
    def outstanding_tokens(self) -> int:
        """Routing load signal: tokens of work still owed — un-prefilled
        context plus undecoded budget for queued requests, remaining decode
        budget for resident ones. Read lock-free (a stale-by-one-step value
        routes marginally unevenly, never incorrectly)."""
        total = 0
        for r in list(self.engine.scheduler.waiting):
            total += len(r.context_tokens) + r.remaining_tokens
        for r in list(self.engine.scheduler.slots):
            if r is not None:
                total += max(r.remaining_tokens, 0)
        return total

    @thread_seam
    def pool_room_for(self, req: Request) -> bool:
        """Advisory handoff-destination check: could this replica restore
        ``req``'s context pages plus one dispatch of decode growth right
        now? Lock-free read of the pool counters — the binding check is
        the destination's own admission reserve; a stale answer costs
        one local-decode fallback or one head-of-line wait, never
        correctness."""
        eng = self.engine
        kv = getattr(eng, "kv", None)
        if kv is None:
            return False
        need = kv.pages_needed(len(req.context_tokens)
                               + eng._decode_lookahead)
        return need <= kv.free_pages - eng._reserved_pages

    @thread_seam
    def probe(self) -> dict:
        """Health snapshot for the supervisor. Raises if the engine thread
        is dead — a crashed replica must not look merely idle. Carries
        the KV-pool room facts (free pages net of admission reserves,
        page size, decode lookahead) so a REMOTE parent's
        ``handoff_dest`` advisory can consult real room instead of
        assuming it (the PR-6 known gap)."""
        with self._state_lock:
            state = self.state
        if state == CRASHED:
            raise RuntimeError(self.last_error or "replica crashed")
        eng = self.engine
        kv = getattr(eng, "kv", None)
        return {
            "replica": self.replica_id,
            "state": state,
            "role": self.role,
            "queue_depth": self.queue_depth(),
            "active": self.active_count(),
            "outstanding_tokens": self.outstanding_tokens(),
            "restarts": self.restarts,
            "pool_free_pages": (int(kv.free_pages - eng._reserved_pages)
                                if kv is not None else 0),
            "pool_total_pages": (int(kv.num_pages)
                                 if kv is not None else 0),
            "pool_page_size": int(kv.page_size) if kv is not None else 0,
            "pool_lookahead": (int(eng._decode_lookahead)
                               if kv is not None else 0),
        }

    @thread_seam
    def pool_free_ratio(self):
        """Free fraction of the KV pool (net of admission reserves), or
        ``None`` when there is no pool to measure. Lock-free advisory
        read — the autoscaler's pool-pressure vote, where a stale value
        costs one poll of hysteresis, never correctness."""
        eng = self.engine
        kv = getattr(eng, "kv", None)
        if kv is None or int(kv.num_pages) <= 0:
            return None
        free = max(int(kv.free_pages - eng._reserved_pages), 0)
        return free / float(kv.num_pages)

    @thread_seam
    def request_drain(self) -> None:
        with self._state_lock:
            if self.state not in (HEALTHY, DRAINING):
                return
            self.state = DRAINING
        self._drain_requested.set()
        self._wake.set()

    @thread_seam
    def undrain(self) -> None:
        with self._state_lock:
            if self.state == DRAINED:
                self.state = HEALTHY

    @thread_seam
    def take_orphans(self) -> list[Request]:
        """Hand the stashed crash/drain victims to the caller. The
        supervisor collects on every poll (remote workers surface
        orphans while healthy), so the swap must exclude a concurrent
        crash/drain extend — hence the lock."""
        with self._state_lock:
            out, self._orphans = self._orphans, []
        return out

    @thread_seam
    def request_migrate(self, request_id: str, dest: Optional[int] = None,
                        reason: str = "operator") -> bool:
        """Ask the engine thread to migrate one RESIDENT request out with
        its KV (two-phase; see migration.py). Returns False when this
        replica can't (not healthy, already migrating it, or the request
        isn't resident here) — the caller treats that as 'nothing moved'."""
        with self._state_lock:
            if self.state != HEALTHY or request_id in self._migrations:
                return False
        with self.engine.lock:
            if request_id not in self.engine._req_slot:
                return False
        with self._state_lock:
            self._migrations[request_id] = MigrationTicket(
                request_id=request_id, dest=dest, reason=reason)
        self._wake.set()
        return True

    @thread_seam
    def migrations_in_flight(self) -> int:
        with self._state_lock:
            return len(self._migrations)

    @thread_seam
    def take_migrated(self) -> list[tuple[Request, MigrationTicket]]:
        """Hand completed migrations (request + ticket with dest hint) to
        the supervisor for placement. Survives a crash: payloads are host
        memory and these requests already left the engine."""
        with self._state_lock:
            out, self._migrated = self._migrated, []
        return out

    @thread_seam
    def resident_requests(self) -> list[tuple[str, int, str]]:
        """(request_id, remaining_tokens, priority) of RUNNING requests —
        the rebalancer's and the preemption pass's victim-selection
        input."""
        out = []
        with self.engine.lock:
            for r in self.engine.scheduler.slots:
                if r is not None and r.state is RequestState.RUNNING:
                    out.append((r.request_id, r.remaining_tokens,
                                getattr(r, "priority", "standard")))
        return out

    @thread_seam
    def queued_priority_wait_ms(self, priority: str) -> float:
        """Longest current queue wait (ms) among QUEUED requests of the
        given class — the preemption pass's TTFT-risk signal. Lock-free
        read, same contract as ``outstanding_tokens``."""
        now = time.monotonic()
        worst = 0.0
        for r in list(self.engine.scheduler.waiting):
            if getattr(r, "priority", "standard") == priority:
                worst = max(worst, (now - r.arrival_time) * 1e3)
        return worst

    @thread_seam
    def prefix_cache_stats(self) -> tuple[int, int, int]:
        """(prefix_hits, prefix_queries, requeue_cached_tokens) from the
        engine — per-replica cache observability (hit-rate gauge)."""
        kv = getattr(self.engine, "kv", None)
        if kv is None:                     # engine released
            return 0, 0, 0
        return (kv.prefix_hits, kv.prefix_queries,
                getattr(self.engine, "total_requeue_cached_tokens", 0))

    @thread_seam
    def spec_stats(self) -> dict:
        """Per-replica speculative-decode counters (running totals) for
        the supervisor snapshot / `llmctl_fleet_spec_*` Prometheus
        export. ``resumes`` counts slots armed from a MIGRATED SpecState
        — the courier-aware-speculation payoff signal."""
        eng = self.engine
        return {
            "dispatches": int(getattr(eng, "total_spec_dispatches", 0)),
            "drafts": int(getattr(eng, "total_spec_drafts", 0)),
            "accepted": int(getattr(eng, "total_spec_accepted", 0)),
            "resumes": int(getattr(eng, "total_spec_resumes", 0)),
        }

    # -- fleet-global prefix cache -------------------------------------------

    @thread_seam
    def prefix_inventory(self) -> list:
        """The prefix-page hashes this replica's cache currently holds —
        the router's hint input (bounded; advisory, so staleness only
        costs a missed fetch or a counted miss)."""
        if self._prefix_inventory_max <= 0:
            return []
        kv = getattr(self.engine, "kv", None)
        if kv is None:
            return []
        with self.engine.lock:
            return kv.prefix_inventory(self._prefix_inventory_max)

    @thread_seam
    def prefix_fetch_stats(self) -> dict:
        """Fetch-side counters for the supervisor snapshot / Prometheus
        (`llmctl_fleet_prefix_fetch_*`). fetch_ms is the bounded recent
        window of ALL attempts (hits, misses, aborts); fetch_count the
        cumulative attempt total the histogram pump deltas on."""
        with self._state_lock:
            return {
                "fetches": self.prefix_fetches,
                "pages": self.prefix_fetch_pages,
                "bytes": self.prefix_fetch_bytes,
                "misses": self.prefix_fetch_misses,
                "aborts": self.prefix_fetch_aborts,
                "fetch_ms": list(self.prefix_fetch_ms),
                "fetch_count": (self.prefix_fetches
                                + self.prefix_fetch_misses
                                + self.prefix_fetch_aborts),
            }

    @engine_thread_only
    def _fetch_prefix(self, req: Request, hashes: list) -> Optional[dict]:
        """Engine prefix_fetch_hook: fetch ``hashes``' pages from the
        request's hinted owner through the injected fetcher (courier /
        worker sockets). Returns {"hashes": [bytes], "pages": payload}
        or None; every failure mode is counted and degrades to plain
        prefill on the caller side."""
        fetcher = self.prefix_fetcher
        if (fetcher is None or not self._prefix_fetch
                or len(hashes) < self._prefix_fetch_min_pages):
            return None
        owner = getattr(req, "prefix_owner", None)
        if owner is None or owner == self.replica_id:
            return None
        t0 = time.perf_counter()
        payload, aborted = None, False
        try:
            payload = fetcher(self.replica_id, owner,
                              getattr(req, "prefix_owner_endpoint", None),
                              list(hashes))
        except Exception as e:      # TransferAborted + wire surprises
            aborted = True
            logger.warning(
                "replica %d: prefix fetch from replica %s aborted for "
                "%s (%s); falling back to plain prefill",
                self.replica_id, owner, req.request_id, e)
        out = None
        if payload is not None and not aborted:
            hx = payload.get("hashes") or []
            pages = payload.get("pages")
            try:
                hb = [bytes.fromhex(h) if isinstance(h, str) else h
                      for h in hx]
            except (ValueError, TypeError):
                hb, pages = [], None
            if hb and isinstance(pages, dict):
                out = {"hashes": hb, "pages": pages}
        ms = (time.perf_counter() - t0) * 1e3
        with self._state_lock:
            self.prefix_fetch_ms.append(float(ms))
            if aborted:
                self.prefix_fetch_aborts += 1
            elif out is None:
                self.prefix_fetch_misses += 1
            else:
                self.prefix_fetches += 1
                self.prefix_fetch_pages += int(
                    out["pages"].get("num_pages", 0))
                self.prefix_fetch_bytes += migration.payload_nbytes(
                    out["pages"])
        return out

    @thread_seam
    def request_prefix_extract(self, hashes: list,
                               timeout_s: Optional[float] = None
                               ) -> Optional[dict]:
        """Owner half of the fleet prefix fetch: extract the cached pages
        for (a prefix of) ``hashes`` as a courier-encodable payload
        {"prefix": True, "hashes": [hex], "pages": {...}}. The extraction
        itself runs ON the engine thread at the next loop boundary,
        between its dispatches, and this caller waits (bounded). None = nothing cached, replica
        down, or timeout: the fetcher counts a miss and re-prefills."""
        if not hashes:
            return None
        with self._state_lock:
            if self.state in (CRASHED, STOPPED):
                return None
        if self._thread is None or not self._thread.is_alive():
            # offline/unit use: no engine thread is dispatching, so the
            # buffers are stable and direct extraction is safe
            return self._extract_prefix_payload(hashes)
        job = {"hashes": list(hashes), "event": threading.Event(),
               "result": None}
        with self._state_lock:
            self._prefix_jobs.append(job)
        self._wake.set()
        if not job["event"].wait(
                timeout=timeout_s or self._prefix_fetch_timeout_s):
            return None
        return job["result"]

    @thread_seam
    def request_prefix_import(self, hashes: list, pages: dict,
                              timeout_s: Optional[float] = None
                              ) -> Optional[int]:
        """Receiver half of the pipelined-prefill pre-ship: insert the
        couriered ``pages`` for ``hashes`` into this replica's prefix
        cache ahead of the stage that will pin them. Runs ON the engine
        thread at the next loop boundary (same queue as extracts — the
        pool is only safe to mutate between dispatches); this caller
        waits (bounded). Returns the number of pages claimed or already
        present, None on failure/timeout — the pre-shipper stops and the
        stage's own prefix fetch covers the gap."""
        if not hashes or not pages:
            return None
        with self._state_lock:
            if self.state in (CRASHED, STOPPED):
                return None
        if self._thread is None or not self._thread.is_alive():
            return self._import_prefix_payload(hashes, pages)
        job = {"hashes": list(hashes), "pages": pages,
               "event": threading.Event(), "result": None}
        with self._state_lock:
            self._prefix_jobs.append(job)
        self._wake.set()
        if not job["event"].wait(
                timeout=timeout_s or self._prefix_fetch_timeout_s):
            return None
        return job["result"]

    @engine_thread_only
    def _service_prefix_extracts(self) -> None:
        """Answer queued prefix-extract (and pipeline pre-ship import)
        jobs (engine thread, between steps). Per-job failures — a
        deleted-buffer race with an in-flight dispatch, a released
        engine — answer None (the fetcher re-prefills / the pre-shipper
        stops) instead of killing the replica."""
        with self._state_lock:
            jobs, self._prefix_jobs = self._prefix_jobs, []
        for job in jobs:
            try:
                if "pages" in job:
                    job["result"] = self._import_prefix_payload(
                        job["hashes"], job["pages"])
                else:
                    job["result"] = self._extract_prefix_payload(
                        job["hashes"])
            except Exception:
                logger.exception(
                    "replica %d prefix extract failed", self.replica_id)
                job["result"] = None
            job["event"].set()

    @engine_thread_only
    def _import_prefix_payload(self, hashes: list,
                               pages: dict) -> Optional[int]:
        """Insert pre-shipped pages under the engine lock. First-writer-
        wins and partial import on a dry pool both count as delivery (the
        content is there either way); an exception is a real failure."""
        eng = self.engine
        kv = getattr(eng, "kv", None)
        if kv is None:
            return None
        try:
            with eng.lock:
                kv.insert_prefix_pages(hashes, pages)
            return len(hashes)
        except Exception as e:
            logger.warning("replica %d pipeline page import failed (%s)",
                           self.replica_id, e)
            return None

    @engine_thread_only
    def _extract_prefix_payload(self, hashes: list) -> Optional[dict]:
        eng = self.engine
        kv = getattr(eng, "kv", None)
        if kv is None:
            return None
        try:
            with eng.lock:
                pages = kv.lookup_prefix(hashes)
                if not pages:
                    return None
                payload = {
                    "prefix": True,
                    # hex: the manifest crosses JSON on the HTTP courier
                    "hashes": [h.hex() for h in hashes[:len(pages)]],
                    "pages": payload_numpy(kv.extract_pages(pages)),
                }
            return payload
        except Exception as e:
            # a released engine and friends: a miss, never an error — the
            # fetcher falls back to prefill
            logger.warning("replica %d prefix extract degraded to miss "
                           "(%s)", self.replica_id, e)
            return None

    @thread_seam
    def _fail_prefix_jobs(self) -> None:
        """Release extract waiters when this replica stops/crashes (their
        fetchers then count a miss instead of blocking to timeout)."""
        with self._state_lock:
            jobs, self._prefix_jobs = self._prefix_jobs, []
        for job in jobs:
            job["event"].set()

    @thread_seam
    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout)
        self._thread = None
        with self._state_lock:
            if self.state != CRASHED:
                self.state = STOPPED
        self._fail_prefix_jobs()

    @thread_seam
    def teardown(self) -> list[Request]:
        """Stop the thread and extract whatever was still in flight (used
        when a replica is declared dead by probes: the engine may be fine,
        but the fleet has already decided to rebuild it)."""
        self.stop()
        with self._state_lock:
            partials = self._salvage_precopies()
            self._migrations.clear()
        # retire seam for the tiered KV store: the engine thread is
        # joined, so direct extraction is safe — salvage the prefix
        # cache down a tier before the buffers are released. A truly
        # broken engine makes the flush a guarded no-op.
        self._flush_inventory_to_store()
        orphans = self.take_orphans() + self._rip_out()
        for r in orphans:
            p = partials.get(r.request_id)
            if p is not None:
                r.swapped_kv = p
        try:
            self.engine.release()
        except Exception:
            logger.exception("replica %d engine release failed",
                             self.replica_id)
        return orphans

    @thread_seam
    def restart(self, params=None) -> None:
        """Build a fresh engine (fresh KV pool) and resume stepping. Caller (supervisor) owns backoff/limits. The old
        engine's KV pool is released first, so the card never holds two
        pools for one replica."""
        old = self.engine
        if getattr(old, "kv", None) is not None:
            old.release()
        self.engine = None
        self.engine = InferenceEngine(
            self.model_cfg, self.serve_cfg, params=params, seed=self.seed,
            eos_token_id=self.eos_token_id, device=self.device)
        self._wire_engine()
        with self._state_lock:
            self.state = HEALTHY
            self.last_error = None
        self.restarts += 1
        self._drain_requested.clear()
        self.start()
