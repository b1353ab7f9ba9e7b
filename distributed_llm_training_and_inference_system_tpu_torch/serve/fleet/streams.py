"""Fleet stream hub: per-request monotonically-sequenced token logs.

The fleet already guarantees that a request's TOKEN SEQUENCE survives
every disruption bit-identically — crash requeue, drain migration,
rebalance, prefill->decode handoff, courier chaos, SIGKILL'd remote
workers (PR 2-7 invariants, asserted by the dryrun regimes). What it
could not do until now is *stream* those tokens: an SSE response pins an
HTTP connection to one live producer, and the producer keeps changing.

:class:`FleetStreamHub` turns the invariant into a delivery contract.
Every streaming request gets a **log**: the tokens emitted so far, where
a token's **sequence number is simply its index** (seq k = the k-th
generated token — well-defined precisely because re-placement resumes
token-identically). Producers publish batches tagged with their start
seq; the hub

- **dedupes by seq**: a re-placed producer that regenerates (or a late
  outbox poll that re-delivers) tokens the log already holds is
  absorbed silently — counted, never re-delivered;
- **orders**: a batch arriving ahead of a gap is buffered until the gap
  fills (remote cursor entries can race a requeue);
- **heals**: an in-proc publisher hands the request's own
  ``generated_tokens`` as the authority, so a crash that ate a callback
  between record and publish cannot leave a hole;
- **replays**: subscribers attach at any ``from_seq`` (SSE
  ``Last-Event-ID`` + 1) and receive exactly the unacked tail, then
  live batches in order, then one finish event.

Threading: publishers are engine threads (possibly holding their
engine's lock) and remote poll threads; subscribers' callbacks are
invoked UNDER the hub lock so per-subscriber delivery is totally
ordered — callbacks must be non-blocking and must never call back into
the hub or any engine (``loop.call_soon_threadsafe`` and
``queue.put_nowait`` are the intended shapes). The hub itself never
calls into an engine, so hub-lock < engine-lock can never invert.

HA front tier (serve/fleet/state.py): the hub's ``_logs`` dict is a
WORKING VIEW over a replicable :class:`FleetStateStore`. With the
default in-memory store nothing changes (writes are no-ops — the view
is the only copy, byte-for-byte the single-front behavior). With a
shared store, every local mutation (open / fresh append / finish /
discard) writes one journal record, and :meth:`apply_record` folds
OTHER fronts' records through the exact same dedupe-by-seq publish
path — so N fronts converge on one log per request, any front can
serve ``Last-Event-ID`` replay for a stream it never terminated, and a
front's death loses nothing that reached the journal (the terminal
``finish_from_request`` sync heals whatever didn't).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

from .state import FleetStateStore, StoreFenced

logger = logging.getLogger("llmctl.serve.fleet.streams")

# subscriber event shapes (delivered in order, finish always last):
#   ("tokens", start_seq, [tok, ...])
#   ("finish", finish_reason, error)
#   ("drop", None, None)   — backpressure disconnect: the subscriber
#                            exceeded max_buffered_batches without
#                            acking; it must close its connection and
#                            reconnect with Last-Event-ID (the log is
#                            intact — only THIS subscription died)


class _Subscriber:
    __slots__ = ("cb", "next_seq", "buffered")

    def __init__(self, cb: Callable, next_seq: int):
        self.cb = cb
        self.next_seq = next_seq
        # delivered-but-unacked batches: incremented per cb delivery,
        # decremented by FleetStreamHub.ack once the consumer actually
        # wrote the event to its client. The gap between the two IS the
        # per-subscriber buffer a slow client grows.
        self.buffered = 0


class _StreamLog:
    __slots__ = ("rid", "tokens", "finished", "finish_reason", "error",
                 "replica", "subs", "pending", "created", "finished_at",
                 "origin")

    def __init__(self, now: float, rid: str = "", origin: str = "local"):
        self.rid = rid
        self.tokens: list[int] = []
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.replica: Optional[int] = None     # last publisher
        self.subs: dict[int, _Subscriber] = {}
        # out-of-order batches keyed by their start seq, held until the
        # log reaches them (bounded: see _PENDING_MAX)
        self.pending: dict[int, list[int]] = {}
        self.created = now
        self.finished_at: Optional[float] = None
        # "local" = opened by this front's own submit path; "remote" =
        # learned from the shared store (another front terminated the
        # original connection) — a resume served off a remote-origin
        # log IS a front failover the client survived
        self.origin = origin


# out-of-order buffer bound per log: batches further ahead than this are
# dropped (the finish-time sync heals any resulting hole from the
# authoritative token list, so this only bounds memory, never loses data)
_PENDING_MAX = 64


class FleetStreamHub:
    """All live + recently-finished stream logs, with the counters the
    supervisor snapshot / Prometheus pump read."""

    def __init__(self, ttl_ms: float = 60_000.0,
                 max_buffered_batches: int = 0,
                 store: Optional[FleetStateStore] = None):
        self._lock = threading.RLock()
        self._logs: dict[str, _StreamLog] = {}
        self._sub_seq = 0
        self._ttl_s = max(float(ttl_ms), 0.0) / 1e3
        # per-subscriber backpressure cap
        # (FleetConfig.stream_max_buffered_batches; 0 = unbounded)
        self._max_buffered = max(int(max_buffered_batches), 0)
        # replicable log-of-record (serve/fleet/state.py): the in-memory
        # default makes every record() a no-op and never folds, so a
        # single-front hub is bit-identical to the pre-store one
        self.store = store or FleetStateStore()
        self.store.on("stream", self.apply_record)
        # re-entrancy guard: records folded from the store must not be
        # re-recorded (each fact lives once per originating front)
        self._folding = 0
        # counters (running totals — the Prometheus pump deltas them)
        self.total_opened = 0
        self.total_finished = 0
        self.total_tokens = 0            # tokens accepted into logs
        self.total_duplicates = 0        # publish overlap suppressed by seq
        self.total_replayed = 0          # tokens re-sent to reconnects
        self.total_reconnects = 0
        self.total_gaps_healed = 0       # tokens recovered from the request
        self.total_out_of_order = 0      # batches buffered ahead of a gap
        self.total_identity_mismatches = 0
        self.total_backpressure_drops = 0   # slow subscribers disconnected
        # unfinished logs evicted because the router no longer knew their
        # request (the PR-8 leak: opened, died outside the finish wiring)
        self.total_orphan_logs_gc = 0
        # resumes served for streams ANOTHER front terminated (the log
        # arrived via the shared store) — the client-visible half of a
        # front failover, fed to llmctl_fleet_front_reconnects
        self.total_front_resumes = 0
        self.replay_sizes: deque = deque(maxlen=64)   # per-reconnect burst
        self._dups_by_replica: dict[int, int] = {}

    def _rec(self, rec: dict, force: bool = False) -> None:
        """Journal one local mutation (no-op on the in-memory store; a
        fenced front logs and carries on locally — it is about to be
        torn down, and the fence exists precisely so these writes don't
        reach the shared log). ``force`` records even mid-fold: a
        LOCALLY-produced pending batch draining because a fold filled
        its gap is still this front's fact to journal."""
        if self._folding and not force:
            return
        try:
            self.store.record({"ns": "stream", **rec})
        except StoreFenced:
            logger.warning("stream store write refused: front %s is "
                           "fenced", self.store.front_id)

    # -- log lifecycle -------------------------------------------------------

    def open(self, request_id: str) -> bool:
        """Create the log for a streaming request BEFORE placement, so no
        publisher can race the first token past an absent log."""
        with self._lock:
            if request_id in self._logs:
                return False
            self._logs[request_id] = _StreamLog(time.monotonic(),
                                                rid=request_id)
            self.total_opened += 1
            self._rec({"op": "open", "rid": request_id})
            return True

    def has(self, request_id: str) -> bool:
        with self._lock:
            if request_id in self._logs:
                return True
        if not self.store.shared:
            return False
        # another front may have opened it: fold the journal tail first
        self.store.sync()
        with self._lock:
            return request_id in self._logs

    def discard(self, request_id: str) -> None:
        """Drop a log outright (submit failed after open): waiters get a
        finish event so nothing blocks on a stream that never started."""
        with self._lock:
            log = self._logs.pop(request_id, None)
            if log is not None and not log.finished:
                self._finish_locked(log, "error", "stream discarded")
                self._rec({"op": "discard", "rid": request_id})

    # -- publishing ----------------------------------------------------------

    def publish(self, request_id: str, start_seq: int, tokens: list,
                replica: Optional[int] = None) -> int:
        """One producer batch: ``tokens`` are seqs [start_seq,
        start_seq+len). Returns how many were NEW (appended). Overlap
        with the log is suppressed (dedupe-by-seq); a batch past the
        log's frontier is buffered until the gap fills."""
        if not tokens:
            return 0
        with self._lock:
            log = self._logs.get(request_id)
            if log is not None:
                if log.finished:
                    return 0
                return self._publish_locked(log, int(start_seq),
                                            [int(t) for t in tokens],
                                            replica)
        if not self.store.shared:
            return 0
        # a producer this front adopted (worker outbox split across
        # fronts) can outrun the journal fold that opens the log:
        # catch up once and retry
        self.store.sync()
        with self._lock:
            log = self._logs.get(request_id)
            if log is None or log.finished:
                return 0
            return self._publish_locked(log, int(start_seq),
                                        [int(t) for t in tokens], replica)

    def publish_from_request(self, req, tokens: list,
                             replica: Optional[int] = None) -> int:
        """In-proc publisher (engine ``on_token``): the request object IS
        the authority, so a hole below this batch — callbacks eaten by a
        crash between record and publish — is healed from
        ``req.generated_tokens`` before the batch lands. Runs on the
        engine thread that owns the token list, so the read is safe."""
        if not tokens:
            return 0
        gen = list(req.generated_tokens)
        start = len(gen) - len(tokens)
        with self._lock:
            log = self._logs.get(req.request_id)
            if log is None or log.finished:
                return 0
            behind = len(log.tokens)
            if start > behind:
                healed = self._publish_locked(log, behind,
                                              gen[behind:start], replica)
                self.total_gaps_healed += healed
                if healed:
                    logger.warning(
                        "stream %s: healed %d-token gap from the request "
                        "(missed publish callbacks)", req.request_id,
                        healed)
            return self._publish_locked(log, start,
                                        [int(t) for t in tokens], replica)

    def sync(self, request_id: str, full_tokens: list,
             replica: Optional[int] = None) -> int:
        """Reconcile the log against the request's full token list (the
        terminal-state authority): appends any missing tail. Returns the
        number of tokens appended."""
        with self._lock:
            log = self._logs.get(request_id)
            if log is None or log.finished:
                return 0
            behind = len(log.tokens)
            if len(full_tokens) <= behind:
                return 0
            appended = self._publish_locked(
                log, behind, [int(t) for t in full_tokens[behind:]],
                replica)
            self.total_gaps_healed += appended
            return appended

    def _publish_locked(self, log: _StreamLog, start: int, tokens: list,
                        replica: Optional[int],
                        record: Optional[bool] = None) -> int:
        # whether a fresh extension here is OURS to journal: local
        # publishes record, folded ones don't — and a buffered batch
        # keeps the provenance it arrived with, so a local batch whose
        # gap a FOLD fills still reaches the journal
        rec_this = (not self._folding) if record is None else record
        if replica is not None:
            log.replica = replica
        if start > len(log.tokens):
            # ahead of a gap (remote cursor raced a requeue): hold it
            self.total_out_of_order += 1
            if len(log.pending) < _PENDING_MAX:
                log.pending[start] = (tokens, rec_this)
            return 0
        skip = len(log.tokens) - start
        overlap = min(skip, len(tokens))
        if overlap:
            self.total_duplicates += overlap
            if replica is not None:
                self._dups_by_replica[replica] = (
                    self._dups_by_replica.get(replica, 0) + overlap)
            # the fleet invariant says overlapping seqs carry identical
            # tokens; a mismatch means a producer broke token identity —
            # surfaced as a counter (and log), never re-delivered
            for i in range(overlap):
                if log.tokens[start + i] != tokens[i]:
                    self.total_identity_mismatches += 1
                    logger.error(
                        "stream token identity violation at seq %d: log "
                        "has %d, replica %s republished %d",
                        start + i, log.tokens[start + i], replica,
                        tokens[i])
        fresh = tokens[skip:] if skip < len(tokens) else []
        appended = 0
        if fresh:
            seq0 = len(log.tokens)
            log.tokens.extend(fresh)
            self.total_tokens += len(fresh)
            appended = len(fresh)
            # only the FRESH extension reaches the journal: the log of
            # record holds each seq exactly once per originating front,
            # and folds dedupe whatever interleaving remains
            if rec_this:
                self._rec({"op": "append", "rid": log.rid, "s": seq0,
                           "t": fresh, "r": replica}, force=True)
            self._deliver_locked(log, seq0, fresh)
        # drain any buffered batch the frontier has reached
        while log.pending:
            nxt = min(log.pending)
            if nxt > len(log.tokens):
                break
            toks, was_local = log.pending.pop(nxt)
            appended += self._publish_locked(log, nxt, toks, replica,
                                             record=was_local)
        return appended

    def _deliver_locked(self, log: _StreamLog, start: int,
                        tokens: list) -> None:
        end = start + len(tokens)
        dropped: list = []
        for sub_id, sub in log.subs.items():
            if sub.next_seq >= end:
                continue
            if self._max_buffered and sub.buffered >= self._max_buffered:
                # backpressure: this subscriber's consumer stopped
                # draining (slow SSE client). Disconnect IT — the log
                # keeps growing and a Last-Event-ID reconnect replays
                # exactly the unacked tail — rather than buffering the
                # fleet's memory behind one stalled socket.
                dropped.append(sub_id)
                continue
            lo = max(sub.next_seq - start, 0)
            sub.buffered += 1
            sub.cb(("tokens", start + lo, tokens[lo:]))
            sub.next_seq = end
        for sub_id in dropped:
            sub = log.subs.pop(sub_id)
            self.total_backpressure_drops += 1
            logger.warning(
                "stream subscriber %s dropped: %d delivered batches "
                "never consumed (stream_max_buffered_batches=%d); "
                "client can replay via Last-Event-ID", sub_id,
                sub.buffered, self._max_buffered)
            sub.cb(("drop", None, None))

    def ack(self, request_id: str, sub_id, batches: int = 1) -> None:
        """Consumer-side acknowledgement: the subscriber wrote
        ``batches`` delivered events to its client, so that much of its
        buffer drained. The SSE writer calls this after every write;
        without acks a subscriber hits the backpressure cap and is
        disconnected."""
        if sub_id is None:
            return
        with self._lock:
            log = self._logs.get(request_id)
            sub = log.subs.get(sub_id) if log is not None else None
            if sub is not None:
                sub.buffered = max(sub.buffered - batches, 0)

    # -- finishing -----------------------------------------------------------

    def finish(self, request_id: str, finish_reason: Optional[str] = None,
               error: Optional[str] = None) -> None:
        with self._lock:
            log = self._logs.get(request_id)
            if log is None or log.finished:
                return
            self._finish_locked(log, finish_reason, error)

    def finish_from_request(self, req,
                            replica: Optional[int] = None) -> None:
        """Terminal-state hook (router completion path): sync the log to
        the request's final token list, then finish. Covers both normal
        completion and router-side failures (requeue budget, parked
        overflow) — the one place every streaming request ends."""
        self.sync(req.request_id, req.generated_tokens, replica)
        err = req.error if getattr(req, "error", None) else None
        self.finish(req.request_id, req.finish_reason, err)

    def _finish_locked(self, log: _StreamLog, finish_reason, error) -> None:
        log.finished = True
        log.finish_reason = finish_reason
        log.error = error
        log.finished_at = time.monotonic()
        log.pending.clear()
        self.total_finished += 1
        self._rec({"op": "finish", "rid": log.rid,
                   "reason": finish_reason, "error": error})
        for sub in log.subs.values():
            sub.cb(("finish", finish_reason, error))
        log.subs.clear()

    # -- subscribing ---------------------------------------------------------

    def subscribe(self, request_id: str, from_seq: int, cb: Callable,
                  resume: bool = False) -> Optional[dict]:
        """Attach a subscriber at ``from_seq`` (SSE reconnect: last acked
        seq + 1). Returns None for an unknown stream, else::

            {"sub": id-or-None, "start": seq, "tokens": [replay tail],
             "finished": bool, "finish_reason": ..., "error": ...}

        The snapshot and the registration are atomic: every token is in
        the snapshot or will arrive exactly once via ``cb``, in order.
        ``from_seq`` past the frontier clamps to it (a future
        ``Last-Event-ID`` must not wedge the reconnect); ``resume=True``
        counts the reconnect and the replayed tail."""
        if self.store.shared:
            # the stream may have been terminated by another front, and
            # even a locally-known log may be behind the journal
            self.store.sync()
        with self._lock:
            log = self._logs.get(request_id)
            if log is None:
                return None
            from_seq = max(0, min(int(from_seq), len(log.tokens)))
            snapshot = list(log.tokens[from_seq:])
            sub_id = None
            if not log.finished:
                self._sub_seq += 1
                sub_id = self._sub_seq
                log.subs[sub_id] = _Subscriber(cb, len(log.tokens))
            if resume:
                self.total_reconnects += 1
                self.total_replayed += len(snapshot)
                self.replay_sizes.append(len(snapshot))
                if log.origin == "remote":
                    # this front is serving a stream some OTHER front
                    # terminated: the failover the HA tier exists for
                    self.total_front_resumes += 1
            return {"sub": sub_id, "start": from_seq, "tokens": snapshot,
                    "finished": log.finished,
                    "finish_reason": log.finish_reason, "error": log.error}

    def unsubscribe(self, request_id: str, sub_id) -> None:
        if sub_id is None:
            return
        with self._lock:
            log = self._logs.get(request_id)
            if log is not None:
                log.subs.pop(sub_id, None)

    # -- shared-store folding ------------------------------------------------

    def apply_record(self, rec: dict) -> None:
        """Fold one journal record from another front. Applied through
        the exact locked paths a local mutation takes (dedupe-by-seq,
        idempotent finish), with re-recording suppressed — at-least-once
        journal delivery is therefore safe."""
        op = rec.get("op")
        rid = str(rec.get("rid", ""))
        if not rid:
            return
        with self._lock:
            self._folding += 1
            try:
                log = self._logs.get(rid)
                if op == "open":
                    if log is None:
                        self._logs[rid] = _StreamLog(
                            time.monotonic(), rid=rid, origin="remote")
                        self.total_opened += 1
                elif op == "append":
                    if log is None:
                        # appends can reach us before (or without) the
                        # open — e.g. this front attached mid-run
                        log = _StreamLog(time.monotonic(), rid=rid,
                                         origin="remote")
                        self._logs[rid] = log
                        self.total_opened += 1
                    if not log.finished:
                        self._publish_locked(
                            log, int(rec.get("s", 0)),
                            [int(t) for t in rec.get("t", [])],
                            rec.get("r"))
                elif op == "finish":
                    if log is not None and not log.finished:
                        self._finish_locked(log, rec.get("reason"),
                                            rec.get("error"))
                elif op == "discard":
                    log = self._logs.pop(rid, None)
                    if log is not None and not log.finished:
                        self._finish_locked(log, "error",
                                            "stream discarded")
            finally:
                self._folding -= 1

    # -- housekeeping / introspection ----------------------------------------

    def gc(self, now: Optional[float] = None,
           known: Optional[Callable[[str], bool]] = None) -> int:
        """Evict finished logs past the replay TTL (the reconnect window).

        ``known`` (the router's ledger membership, when given) closes
        the unfinished-log leak: a log opened by ``submit_streaming``
        whose request died OUTSIDE the hub's finish wiring (router-side
        failure before placement, a front that crashed between open and
        submit) was retained forever. An unfinished log older than the
        TTL whose request id the router no longer knows is collected —
        its subscribers get a finish event — and counted in
        ``orphan_logs_gc``. The TTL doubles as the grace window, so a
        just-opened log can never race its own router registration."""
        if self._ttl_s <= 0:
            return 0
        now = time.monotonic() if now is None else now
        evicted = 0
        with self._lock:
            for rid in list(self._logs):
                log = self._logs[rid]
                if log.finished and log.finished_at is not None \
                        and now - log.finished_at > self._ttl_s:
                    del self._logs[rid]
                    evicted += 1
                elif not log.finished and known is not None \
                        and now - log.created > self._ttl_s \
                        and not known(rid):
                    self._finish_locked(log, "error",
                                        "orphaned stream log collected")
                    del self._logs[rid]
                    self.total_orphan_logs_gc += 1
                    evicted += 1
                    logger.warning(
                        "stream %s: unfinished log collected (router no "
                        "longer knows the request)", rid)
        return evicted

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for lg in self._logs.values() if not lg.finished)

    def tokens_of(self, request_id: str) -> Optional[list]:
        """The log's current token list (loadgen identity assertions)."""
        if self.store.shared:
            self.store.sync()
        with self._lock:
            log = self._logs.get(request_id)
            return None if log is None else list(log.tokens)

    def replica_stats(self) -> dict:
        """Per-replica stream columns for the supervisor snapshot:
        ``active`` = live streams last fed by that replica; ``replayed``
        = duplicate tokens that replica republished after a re-placement
        (suppressed by seq — the migration-resume replay)."""
        with self._lock:
            out: dict[int, dict] = {}
            for lg in self._logs.values():
                if not lg.finished and lg.replica is not None:
                    slot = out.setdefault(lg.replica,
                                          {"active": 0, "replayed": 0})
                    slot["active"] += 1
            for rid, n in self._dups_by_replica.items():
                out.setdefault(rid, {"active": 0, "replayed": 0})
                out[rid]["replayed"] = n
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": sum(1 for lg in self._logs.values()
                              if not lg.finished),
                "opened": self.total_opened,
                "finished": self.total_finished,
                "tokens": self.total_tokens,
                "duplicates": self.total_duplicates,
                "replayed": self.total_replayed,
                "reconnects": self.total_reconnects,
                "gaps_healed": self.total_gaps_healed,
                "out_of_order": self.total_out_of_order,
                "identity_mismatches": self.total_identity_mismatches,
                "backpressure_drops": self.total_backpressure_drops,
                "orphan_logs_gc": self.total_orphan_logs_gc,
                "front_resumes": self.total_front_resumes,
                # bounded recent replay bursts + the cumulative count the
                # Prometheus pump deltas on (same contract as migration
                # pauses)
                "replay_sizes": list(self.replay_sizes),
                "replay_count": self.total_reconnects,
            }
