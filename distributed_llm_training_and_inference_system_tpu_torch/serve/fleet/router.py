"""Fleet router: request-level placement across engine replicas.

Two-signal routing, Llumnix-style (PAPERS.md):

- **Prefix affinity.** The first ``affinity_prefix_tokens`` of the prompt
  are digested (sha1 — Python's ``hash`` is per-process salted and would
  break cross-run determinism) and looked up on a consistent-hash ring
  with ``affinity_vnodes`` points per replica. Prompts sharing a prefix
  land on the same replica, so its prefix cache (serve/kv_cache.py) serves
  the shared pages instead of every replica re-prefilling them. Consistent
  hashing keeps the mapping stable when a replica leaves: only its own
  arc reassigns, the other replicas' hot prefixes stay put.

- **Least outstanding tokens.** When affinity is off, the owner is down or
  draining, or the owner's queue runs ``affinity_max_imbalance`` deeper
  than the least-loaded replica's (a hot prefix must not melt one replica
  while others idle), the request goes to the replica owing the fewest
  tokens of work (queued context + undecoded budget) — a closer proxy for
  time-to-service than request counts, since requests differ by orders of
  magnitude in prompt and generation length.

Admission is fleet-scoped: beyond ``max_pending`` queued-but-not-resident
requests the router rejects with :class:`FleetSaturated` (HTTP 429 +
Retry-After upstream) instead of growing unbounded tail latency.

Every accepted request is accounted terminally: completed, failed (requeue
budget exhausted / parked overflow), or still in flight — ``stats()``
exposes the ledger and tests assert nothing is silently dropped.

HA front tier (serve/fleet/state.py): the ledger (``_meta``), the
terminal counters, and the parked queue are a working view over a
replicable :class:`FleetStateStore`. The in-memory default changes
nothing; with a shared store every mutation journals one record and
:meth:`apply_record` folds other fronts' records in, so N stateless
fronts agree on which requests are in flight, share one requeue budget
per request, balance one fleet-wide ledger, and — via the
deterministic adopter — recover a dead front's parked requests
(re-prefilled from their journaled wire form: the payload bytes are
advisory, the tokens are the truth).
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
import uuid
from bisect import bisect_right
from typing import Callable, Iterable, Optional, Sequence

from ...config.schema import FleetConfig
from ..scheduler import Request, RequestState, SamplingParams
from .replica import reset_for_requeue
from .state import FleetStateStore, StoreFenced
from .transport import KV_STORE_OWNER

logger = logging.getLogger("llmctl.serve.fleet.router")


class FleetSaturated(RuntimeError):
    """Every replica is saturated (or none is healthy): the client should
    back off ``retry_after_s`` seconds (HTTP 429 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


# SLO priority classes (Llumnix-style isolation, PAPERS.md). Admission
# sheds best-effort first: it only gets half the queue, while standard
# loses just the interactive headroom reservation and interactive keeps
# the full bound. Retry-After is class-aware — shed best-effort clients
# back off hard, shed interactive clients retry soon (their 429 means a
# genuine full-fleet outage, usually brief once the autoscaler reacts).
PRIORITIES = ("interactive", "standard", "best-effort")
_BEST_EFFORT_ADMIT_FRACTION = 0.5
_RETRY_AFTER_SCALE = {"interactive": 0.5, "standard": 1.0,
                      "best-effort": 4.0}


def normalize_priority(priority) -> str:
    """Clamp arbitrary client input onto the known classes (unknown or
    missing = standard — a typo must not silently outrank paying
    interactive traffic)."""
    p = str(priority or "standard").strip().lower().replace("_", "-")
    return p if p in PRIORITIES else "standard"


def _hash_point(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def prefix_digest(prompt_tokens: Sequence[int], k: int) -> int:
    """Stable digest of the first ``k`` prompt tokens — the affinity key."""
    head = ",".join(str(int(t)) for t in prompt_tokens[:k])
    return _hash_point(head.encode())


def _role(replica) -> str:
    """Replica role for routing; anything not declaring one is mixed."""
    return getattr(replica, "role", "mixed")


def _needs_prefill(req: Request) -> bool:
    """Whether placing this request requires prefill compute on the
    destination. Payload-carrying requests (migrations, handoffs, drain
    victims) restore their pages — any replica can take them, decode-role
    included — EXCEPT partial payloads (crash-salvaged pre-copies), whose
    uncovered tail still needs a prefill-capable replica."""
    return req.swapped_kv is None or bool(req.swapped_kv.get("partial"))


class FleetRouter:
    def __init__(self, replicas: Iterable, cfg: Optional[FleetConfig] = None,
                 observer: Optional[Callable[[str, dict], None]] = None,
                 courier=None, page_size: int = 0,
                 store: Optional[FleetStateStore] = None,
                 kv_store=None):
        self.cfg = cfg or FleetConfig()
        self.replicas = list(replicas)
        self.by_id = {r.replica_id: r for r in self.replicas}
        self.observer = observer or (lambda event, payload: None)
        # KV courier (serve/fleet/transport.py): every payload-carrying
        # placement ships the pages through it src->dest before submit.
        # None = legacy direct hand-off (fake-replica unit tests).
        self.courier = courier
        # fleet-global prefix cache: with page_size > 0 (and
        # cfg.prefix_fetch), every needs-prefill placement gets a
        # `prefix_owner` hint — the replica (other than the destination)
        # whose advertised prefix-page inventory covers the longest
        # chain prefix of the prompt. 0 disables hints entirely (plain
        # engines, fake-replica unit tests).
        self.page_size = int(page_size)
        # tiered fleet KV store (serve/fleet/kv_store.py): its holdings
        # join the inventory map under KV_STORE_OWNER so the hint path
        # can fall back to store-served fetches when no live replica
        # covers the prompt. None = no store tier.
        self.kv_store = kv_store
        # pipelined multi-replica prefill (serve/fleet/pipeline.py):
        # bound by ServeFleet post-construction. When set, qualifying
        # long needs-prefill prompts hand their placement to the
        # coordinator's stage pipeline instead of the loop below.
        self.pipeline = None
        try:
            self._endpoints = self.cfg.endpoint_map()
        except Exception:
            self._endpoints = {}
        # networked store service: its endpoint joins the map under the
        # KV_STORE_OWNER sentinel (whether configured as "store=URL" in
        # fleet_endpoints, as kv_store_endpoint, or as the replicated
        # kv_store_endpoints member list — the FIRST member is
        # advertised; a worker whose own member list contains it fetches
        # through its own failover-capable client), so store hints are
        # honorable by REMOTE destinations too — the worker fetches
        # straight from the service, closing the item-2 skip gap.
        if hasattr(self.cfg, "kv_store_endpoint_list"):
            _store_eps = self.cfg.kv_store_endpoint_list()
        else:
            _ep = str(getattr(self.cfg, "kv_store_endpoint", "")
                      or "").rstrip("/")
            _store_eps = [_ep] if _ep else []
        if _store_eps:
            self._endpoints.setdefault(KV_STORE_OWNER, _store_eps[0])
        # inventory TTL cache (PR-7 named gap): > 0 bounds how often the
        # hint path re-reads every replica's prefix-page inventory.
        # Invalidated wholesale on replica teardown/drain/undrain/
        # restart (supervisor calls invalidate_inventories) — a dead
        # owner's pages must leave the hint path immediately, while
        # within-TTL staleness only costs a counted fetch miss.
        self._inv_ttl_s = float(getattr(self.cfg,
                                        "prefix_inventory_ttl_ms", 0.0)
                                or 0.0) / 1e3
        self._inv_cache: Optional[tuple[float, dict]] = None
        self.inventory_cache_hits = 0
        self.inventory_cache_misses = 0
        # store hints silently skipped because the destination was a
        # remote worker (it cannot reach this process's store tier) —
        # the measurable face of the ROADMAP item-2 gap
        self.total_store_hint_remote_skips = 0
        # _lock guards router bookkeeping ONLY. It is never held across a
        # replica.submit() call: submit takes the engine lock, and the
        # engine thread calls back into on_request_exit under that same
        # lock — holding _lock across both directions would be an ABBA
        # deadlock between the HTTP thread and the engine thread.
        self._lock = threading.Lock()
        self._ring: list[tuple[int, int]] = []      # (point, replica_id)
        self._rebuild_ring()
        self._waiters: dict[str, Callable[[Request], None]] = {}
        self._meta: dict[str, dict] = {}            # rid -> ledger entry
        self._parked: list[Request] = []            # requeues awaiting a
        #                                             healthy replica
        # replicable ledger (serve/fleet/state.py): the in-memory default
        # journals nothing, so a single-front router is bit-identical to
        # the pre-store one. Shared stores fold sibling fronts' records
        # into _meta/counters and surface their parked requests here.
        self.store = store or FleetStateStore()
        self.store.on("ledger", self.apply_record)
        self._folding = 0
        self._parked_remote: dict[str, tuple[str, dict]] = {}
        # fired on a folded terminal record so the owning front can
        # complete its local Request object (waiters, SSE finish) for a
        # request whose finished outbox entry another front collected
        self.on_store_pop: Optional[Callable[[str, dict], None]] = None
        self.total_parked_adopted = 0
        self.total_submitted = 0
        self.total_completed = 0
        self.total_failed = 0
        self.total_rejected = 0
        # per-class admission ledger (SLO priority tiers): who got in and
        # who was shed. Keys are the PRIORITIES constants.
        self.submitted_by_class: dict[str, int] = {p: 0
                                                   for p in PRIORITIES}
        self.rejected_by_class: dict[str, int] = {p: 0
                                                  for p in PRIORITIES}
        self.total_requeues = 0
        self.total_affinity_hits = 0
        self.total_migrations = 0       # migrated sequences placed
        self.total_handoffs = 0         # prefill->decode handoffs placed
        self.completed_per_replica: dict[int, int] = {
            r.replica_id: 0 for r in self.replicas}
        self.routed_per_replica: dict[int, int] = {
            r.replica_id: 0 for r in self.replicas}
        self.requeues_per_replica: dict[int, int] = {
            r.replica_id: 0 for r in self.replicas}

    def _rebuild_ring(self) -> None:
        ring: list[tuple[int, int]] = []
        for r in self.replicas:
            for v in range(self.cfg.affinity_vnodes):
                ring.append((
                    _hash_point(f"replica-{r.replica_id}:{v}".encode()),
                    r.replica_id))
        ring.sort()
        self._ring = ring

    # -- elastic membership (serve/fleet/autoscaler.py) ----------------------

    def add_replica(self, replica, endpoint: Optional[str] = None) -> None:
        """Join a freshly spawned replica to the placement plane:
        membership list, consistent-hash ring (only this replica's arc
        reassigns — hot prefixes elsewhere stay put), per-replica
        counters, and the courier endpoint map for a remote worker."""
        with self._lock:
            if any(r.replica_id == replica.replica_id
                   for r in self.replicas):
                return
            self.replicas = self.replicas + [replica]
            self.by_id = {r.replica_id: r for r in self.replicas}
            self._rebuild_ring()
            self.completed_per_replica.setdefault(replica.replica_id, 0)
            self.routed_per_replica.setdefault(replica.replica_id, 0)
            self.requeues_per_replica.setdefault(replica.replica_id, 0)
            if endpoint:
                self._endpoints[replica.replica_id] = endpoint
        self.invalidate_inventories()

    def remove_replica(self, replica_id: int) -> None:
        """Retire a replica from the placement plane (drained + flushed
        upstream by the autoscaler). Its ring arc reassigns to the
        survivors; its historical counters stay in the stats — a retire
        must not erase completed-work accounting."""
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.replica_id != replica_id]
            self.by_id = {r.replica_id: r for r in self.replicas}
            self._rebuild_ring()
            self._endpoints.pop(replica_id, None)
        self.invalidate_inventories()

    # -- placement -----------------------------------------------------------

    def _ring_owner(self, digest: int,
                    accepting_ids: set) -> Optional[int]:
        """First accepting replica at/after the digest's ring point
        (wrapping) — consistent hashing's 'walk to the next node'."""
        if not self._ring or not accepting_ids:
            return None
        i = bisect_right(self._ring, (digest, -1))
        for k in range(len(self._ring)):
            point, rid = self._ring[(i + k) % len(self._ring)]
            if rid in accepting_ids:
                return rid
        return None

    def _candidates(self, prompt_tokens: Sequence[int],
                    exclude: frozenset = frozenset(),
                    needs_prefill: bool = True,
                    priority: str = "standard") -> tuple[list, bool]:
        """(replicas to try in order, affinity_applied): affinity owner
        first when within the imbalance bound, then by least outstanding
        tokens. ``affinity_applied`` is True only when the ring owner was
        actually promoted — the affinity-hit stat must not count plain
        least-loaded placements that happened to coincide.

        Role awareness (disaggregated serving): ``needs_prefill`` requests
        never see decode-role replicas (they couldn't compute the prompt),
        and prefix affinity is therefore automatically restricted to the
        prefill-capable subset. Payload-carrying requests can land
        anywhere — ordered decode-first (that's what decode replicas are
        FOR; a prefill replica is the last resort) and skipping affinity
        (their pages travel with them, there is no cache to chase)."""
        accepting = [r for r in self.replicas
                     if r.replica_id not in exclude and r.accepting()]
        if needs_prefill:
            accepting = [r for r in accepting if _role(r) != "decode"]
        if not accepting:
            return [], False
        load = {r.replica_id: r.outstanding_tokens() for r in accepting}
        depth = {r.replica_id: r.queue_depth() for r in accepting}
        if priority == "interactive":
            # TTFT-first ordering: the requests QUEUED ahead are what an
            # interactive arrival actually waits behind — shallowest
            # queue first, outstanding tokens as the tiebreak
            ordered = sorted(accepting,
                             key=lambda r: (depth[r.replica_id],
                                            load[r.replica_id],
                                            r.replica_id))
        else:
            ordered = sorted(accepting,
                             key=lambda r: (load[r.replica_id],
                                            r.replica_id))
        if not needs_prefill:
            # stable sort: decode < mixed < prefill, least-loaded within
            ordered.sort(key=lambda r: {"decode": 0, "mixed": 1}.get(
                _role(r), 2))
            return ordered, False
        if self.cfg.affinity_prefix_tokens > 0 and len(accepting) > 1:
            owner = self._ring_owner(
                prefix_digest(prompt_tokens,
                              self.cfg.affinity_prefix_tokens),
                {r.replica_id for r in accepting})
            if owner is not None and depth[owner] <= (
                    min(depth.values()) + self.cfg.affinity_max_imbalance):
                ordered.sort(key=lambda r: r.replica_id != owner)
                return ordered, True
        return ordered, False

    def pending_total(self) -> int:
        """Queued-but-not-resident requests fleet-wide (admission bound)."""
        return (sum(r.queue_depth() for r in self.replicas)
                + len(self._parked))

    # -- fleet-global prefix-cache hints -------------------------------------

    def _hints_enabled(self, req: Request) -> bool:
        """Needs-prefill placements get owner hints. PARTIAL payloads
        (crash-salvaged pre-copies) count: their uncovered tail is a
        prefill like any other, and the engine routes it through the
        prefix-fetch path (``_maybe_fetch_salvage_tail``) when hinted."""
        if self.page_size <= 0 or not self.cfg.prefix_fetch:
            return False
        kv = req.swapped_kv
        return kv is None or bool(kv.get("partial"))

    def _inventories(self) -> dict:
        """Per-replica prefix-page hash sets for the hint path. Crashed/
        stopped replicas are skipped (their cache died or is dark);
        DRAINED ones are not — a drained replica's engine is alive and
        serving its pages is exactly the flash-crowd-spill case this
        plane exists for. With ``prefix_inventory_ttl_ms`` > 0 the map
        is cached for that long (counted hits/misses) instead of being
        re-read from every replica on every placement."""
        if self._inv_ttl_s > 0:
            now = time.monotonic()
            with self._lock:
                if self._inv_cache is not None \
                        and now < self._inv_cache[0]:
                    self.inventory_cache_hits += 1
                    return self._inv_cache[1]
        from .replica import CRASHED, STOPPED
        out = {}
        for r in self.replicas:
            inv = getattr(r, "prefix_inventory", None)
            if inv is None or getattr(r, "state", None) in (CRASHED,
                                                            STOPPED):
                continue
            try:
                hashes = inv()
            except Exception:
                hashes = ()
            if hashes:
                out[r.replica_id] = set(hashes)
        if self.kv_store is not None:
            held = self.kv_store.inventory(
                getattr(self.cfg, "prefix_inventory_max", 0))
            if held:
                out[KV_STORE_OWNER] = set(held)
        if self._inv_ttl_s > 0:
            with self._lock:
                self.inventory_cache_misses += 1
                self._inv_cache = (time.monotonic() + self._inv_ttl_s,
                                   out)
        return out

    def invalidate_inventories(self) -> None:
        """Drop the TTL inventory cache (replica teardown / drain /
        undrain / restart: that replica's advertised pages just changed
        wholesale, and a fetch hint naming a dead owner would burn a
        timeout per placement until the TTL expired)."""
        with self._lock:
            self._inv_cache = None

    def _attach_prefix_hint(self, req: Request, dest_id: int,
                            invs: dict) -> None:
        """Stamp ``req.prefix_owner`` (+ courier endpoint) with the
        replica whose inventory covers the destination's prompt better
        than the destination itself does — the destination then FETCHES
        those pages instead of re-prefilling. Advisory only: a stale
        hint costs one counted miss, never wrong tokens.

        Tier preference: a LIVE replica owner wins (its pages are hot
        HBM and its extract path is cheapest); the host-tier KV store
        (``KV_STORE_OWNER``) is the fall-back, chosen only when its
        holdings cover strictly more of the prompt than both the
        destination and every live inventory — the
        returning-conversation case where HBM residency has expired.
        Store hints are only stamped for in-proc destinations (a remote
        worker cannot reach this process's store)."""
        req.prefix_owner = None
        req.prefix_owner_endpoint = None
        if not invs:
            return
        if req.prefix_hashes is None:
            from ..kv_cache import prefix_page_hashes
            req.prefix_hashes = prefix_page_hashes(
                req.context_tokens, self.page_size)
        hashes = req.prefix_hashes
        usable = min(len(hashes),
                     max((len(req.context_tokens) - 1) // self.page_size,
                         0))
        if usable == 0:
            return

        def coverage(inv) -> int:
            c = 0
            while c < usable and hashes[c] in inv:
                c += 1
            return c

        best, best_cov = None, coverage(invs.get(dest_id, ()))
        for rid, inv in invs.items():
            if rid == dest_id or rid == KV_STORE_OWNER:
                continue
            c = coverage(inv)
            if c > best_cov or (c == best_cov and best is not None
                                and rid < best):
                best, best_cov = rid, c
        # store fall-back: strictly-better coverage only. A remote
        # destination can only honor the hint when the store is the
        # NETWORKED service (its endpoint rides the fleet map under
        # the KV_STORE_OWNER sentinel) — an in-proc store is this
        # process's heap and unreachable from a worker.
        if KV_STORE_OWNER in invs:
            c = coverage(invs[KV_STORE_OWNER])
            if c > best_cov:
                if getattr(self.by_id.get(dest_id), "remote", False) \
                        and not self._endpoints.get(KV_STORE_OWNER):
                    # the store would have won but a remote worker
                    # cannot reach this process-local store tier —
                    # counted (the pre-service ROADMAP item-2 gap),
                    # hint falls back to the best live owner
                    with self._lock:
                        self.total_store_hint_remote_skips += 1
                else:
                    best, best_cov = KV_STORE_OWNER, c
        if best is not None:
            req.prefix_owner = best
            req.prefix_owner_endpoint = self._endpoints.get(best)

    # -- shared-ledger plumbing ----------------------------------------------

    def _rec(self, rec: dict) -> None:
        """Journal one ledger mutation (no-op on the in-memory store; a
        fenced front keeps operating locally — it is being superseded
        and its replacement folds from the journal, not from it)."""
        if self._folding or not self.store.shared:
            return
        try:
            self.store.record({"ns": "ledger", **rec})
        except StoreFenced:
            logger.warning("ledger store write refused: front %s is "
                           "fenced", self.store.front_id)

    @staticmethod
    def _wire(req: Request) -> dict:
        """Serializable resume form for the shared ledger (prompt +
        progress + sampling; KV payloads stay host-local — an adopted
        request re-prefills, degraded never wrong)."""
        from .remote import request_to_wire
        wire = request_to_wire(req)
        wire.pop("ticket", None)      # the ticket dies with its host
        return wire

    def knows(self, request_id: str) -> bool:
        """Ledger membership — fleet-wide when the store is shared. The
        stream hub's unfinished-log GC keys off this."""
        with self._lock:
            return request_id in self._meta

    def apply_record(self, rec: dict) -> None:
        """Fold one sibling front's ledger record. Upsert semantics
        throughout (requeues fold by max, pops are idempotent), so
        interleaved or replayed records cannot corrupt the view."""
        op = rec.get("op")
        rid = str(rec.get("rid", ""))
        hook = None
        with self._lock:
            self._folding += 1
            try:
                if op == "put":
                    self._meta.setdefault(rid, {
                        "requeues": 0, "replica": None,
                        "owner": rec.get("f"),
                        "wire": rec.get("wire")})
                elif op == "meta":
                    meta = self._meta.get(rid)
                    if meta is not None:
                        if rec.get("replica") is not None:
                            meta["replica"] = rec["replica"]
                        if rec.get("requeues") is not None:
                            meta["requeues"] = max(
                                meta.get("requeues", 0),
                                int(rec["requeues"]))
                elif op == "pop":
                    meta = self._meta.pop(rid, None)
                    self._parked_remote.pop(rid, None)
                    outcome = rec.get("outcome")
                    if meta is not None:
                        if outcome == "completed":
                            self.total_completed += 1
                            r = rec.get("replica")
                            if r is not None:
                                self.completed_per_replica[r] = (
                                    self.completed_per_replica.get(r, 0)
                                    + 1)
                        elif outcome == "failed":
                            self.total_failed += 1
                        elif outcome == "rejected":
                            self.total_rejected += 1
                    if outcome in ("completed", "failed"):
                        hook = self.on_store_pop
                elif op == "count":
                    key = rec.get("key")
                    n = int(rec.get("n", 1))
                    if key == "completed":
                        # journal compaction rewrites a terminal
                        # put..pop group into one aggregated count
                        # record (state.py) — same net counter effect a
                        # fresh front would get from folding the pair
                        self.total_completed += n
                        r = rec.get("replica")
                        if r is not None:
                            self.completed_per_replica[r] = (
                                self.completed_per_replica.get(r, 0) + n)
                    elif key == "failed":
                        self.total_failed += n
                    elif key == "submitted":
                        self.total_submitted += n
                        r = rec.get("replica")
                        if r is not None:
                            self.routed_per_replica[r] = (
                                self.routed_per_replica.get(r, 0) + n)
                    elif key == "requeues":
                        self.total_requeues += n
                        r = rec.get("replica")
                        if r is not None:
                            self.requeues_per_replica[r] = (
                                self.requeues_per_replica.get(r, 0) + n)
                    elif key == "rejected":
                        self.total_rejected += n
                    elif key == "migrations":
                        self.total_migrations += n
                    elif key == "handoffs":
                        self.total_handoffs += n
                elif op == "park":
                    if rid in self._meta:
                        self._parked_remote[rid] = (rec.get("f", ""),
                                                    rec.get("wire") or {})
                elif op == "unpark":
                    self._parked_remote.pop(rid, None)
            finally:
                self._folding -= 1
        if hook is not None:
            # outside the lock: the hook walks replicas and fires the
            # waiter for a request another front saw finish
            hook(rid, rec)

    # -- submission ----------------------------------------------------------

    def admit_bound(self, priority: str) -> int:
        """Class-aware admission bound on pending requests. Interactive
        keeps the full ``max_pending``; standard gives up the
        ``priority_headroom_requests`` reservation; best-effort is
        additionally capped at half the queue so it sheds FIRST as the
        fleet approaches saturation."""
        bound = self.cfg.max_pending
        headroom = int(getattr(self.cfg, "priority_headroom_requests", 0))
        if priority == "interactive":
            return bound
        bound = max(bound - headroom, 1)
        if priority == "best-effort":
            bound = min(bound, max(
                int(self.cfg.max_pending
                    * _BEST_EFFORT_ADMIT_FRACTION), 1))
        return bound

    def submit(self, prompt_tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               on_complete: Optional[Callable[[Request], None]] = None,
               stream: bool = False,
               priority: str = "standard") -> Request:
        """Admit one request into the fleet. Returns the (QUEUED) Request;
        raises FleetSaturated on backpressure. ``on_complete`` fires (from
        an engine thread) when the request reaches a terminal state, however
        many replicas it crossed on the way. ``stream`` marks the request
        for token streaming: every replica it crosses publishes its token
        batches to the fleet stream hub (serve/fleet/streams.py).
        ``priority`` is the SLO class (interactive|standard|best-effort):
        best-effort is shed first at saturation, with a class-aware
        Retry-After."""
        priority = normalize_priority(priority)
        req = Request(
            request_id=request_id or f"fleet-{uuid.uuid4().hex[:24]}",
            prompt_tokens=list(prompt_tokens),
            sampling=sampling or SamplingParams(),
            stream_requested=bool(stream),
            priority=priority)
        if self.pending_total() >= self.admit_bound(priority):
            with self._lock:
                self.total_rejected += 1
                self.rejected_by_class[priority] = (
                    self.rejected_by_class.get(priority, 0) + 1)
                self._rec({"op": "count", "key": "rejected"})
            raise FleetSaturated(
                f"fleet saturated for class {priority}: "
                f"{self.pending_total()} pending >= admission bound "
                f"{self.admit_bound(priority)} "
                f"(max_pending {self.cfg.max_pending})",
                self.cfg.retry_after_s
                * _RETRY_AFTER_SCALE.get(priority, 1.0))
        cands, affinity_first = self._candidates(req.prompt_tokens,
                                                 priority=priority)
        with self._lock:
            self._meta[req.request_id] = {"requeues": 0, "replica": None}
            if on_complete is not None:
                self._waiters[req.request_id] = on_complete
            # the journaled wire form lets a surviving front adopt this
            # request if both its placement AND this front die
            self._rec({"op": "put", "rid": req.request_id,
                       "wire": (self._wire(req)
                                if self.store.shared else None)})
        # pipelined multi-replica prefill: a qualifying long prompt
        # hands its placement to the coordinator — its pipeline thread
        # either lands the request on the final stage replica or
        # collapses back through place_pipeline_final/pipeline_abandon.
        # Counted as submitted HERE (the launch is the admission); the
        # exit path settles completed/failed as for any request.
        if self.pipeline is not None and self.pipeline.try_launch(req):
            with self._lock:
                self.total_submitted += 1
                self.submitted_by_class[priority] = (
                    self.submitted_by_class.get(priority, 0) + 1)
                self._rec({"op": "count", "key": "submitted"})
            return req
        invs = self._inventories() if self._hints_enabled(req) else {}
        for i, r in enumerate(cands):
            if invs:
                self._attach_prefix_hint(req, r.replica_id, invs)
            if r.submit(req):
                with self._lock:
                    self.total_submitted += 1
                    self.submitted_by_class[priority] = (
                        self.submitted_by_class.get(priority, 0) + 1)
                    self.routed_per_replica[r.replica_id] = (
                        self.routed_per_replica.get(r.replica_id, 0) + 1)
                    self._meta[req.request_id]["replica"] = r.replica_id
                    if affinity_first and i == 0:
                        self.total_affinity_hits += 1
                    self._rec({"op": "count", "key": "submitted",
                               "replica": r.replica_id})
                    self._rec({"op": "meta", "rid": req.request_id,
                               "replica": r.replica_id})
                return req
        # nobody accepted: either zero healthy replicas or every queue full
        with self._lock:
            self._meta.pop(req.request_id, None)
            self._waiters.pop(req.request_id, None)
            self.total_rejected += 1
            self.rejected_by_class[priority] = (
                self.rejected_by_class.get(priority, 0) + 1)
            self._rec({"op": "pop", "rid": req.request_id,
                       "outcome": "rejected"})
        if req.error:      # per-replica validation rejected it (too long)
            raise ValueError(req.error)
        raise FleetSaturated(
            "fleet saturated: no replica accepted the request",
            self.cfg.retry_after_s
            * _RETRY_AFTER_SCALE.get(priority, 1.0))

    # -- completion / requeue ------------------------------------------------

    def on_request_exit(self, replica_id: int, req: Request) -> None:
        """Per-replica engine ``on_finish`` hook (fires on the engine
        thread, possibly under that engine's lock — must not call back
        into any engine)."""
        if getattr(req, "pipeline_stage", None) is not None:
            # pipelined-prefill stage requests live OUTSIDE the ledger
            # (the original request holds the meta entry); route the
            # exit to the coordinator's event pump instead
            if self.pipeline is not None:
                self.pipeline.stage_exited(replica_id, req)
            return
        with self._lock:
            meta = self._meta.pop(req.request_id, None)
            waiter = self._waiters.pop(req.request_id, None)
            if meta is not None:
                if req.state is RequestState.FAILED:
                    self.total_failed += 1
                else:
                    self.total_completed += 1
                    self.completed_per_replica[replica_id] = (
                        self.completed_per_replica.get(replica_id, 0) + 1)
                final_meta = {**meta, "replica": replica_id}
                failed = req.state is RequestState.FAILED
                self._rec({
                    "op": "pop", "rid": req.request_id,
                    "outcome": "failed" if failed else "completed",
                    "replica": replica_id,
                    # the terminal token list rides the record so any
                    # front can final-sync the stream log and complete
                    # its local waiter for a request it submitted but
                    # whose finish another front collected
                    "tokens": ([int(t) for t in req.generated_tokens]
                               if self.store.shared else None),
                    "finish_reason": req.finish_reason,
                    "error": req.error if failed else None})
        if meta is not None:
            req.fleet_meta = final_meta      # per-replica loadgen breakdown
        if waiter is not None:
            waiter(req)

    def foreign_exit(self, rid: str, entry: dict,
                     replica_id: int) -> None:
        """Terminal accounting for a request THIS front never submitted
        (multi-front outbox split: the worker's finished entry drained
        here, the waiter lives on a sibling front). Pops the folded
        ledger entry, settles the counters, and journals a pop record
        carrying the terminal tokens so the owning front can complete
        its local Request object."""
        failed = entry.get("state") == "failed"
        with self._lock:
            meta = self._meta.pop(rid, None)
            if meta is None:
                return        # already settled (duplicate / raced fold)
            if failed:
                self.total_failed += 1
            else:
                self.total_completed += 1
                self.completed_per_replica[replica_id] = (
                    self.completed_per_replica.get(replica_id, 0) + 1)
            self._rec({
                "op": "pop", "rid": rid,
                "outcome": "failed" if failed else "completed",
                "replica": replica_id,
                "tokens": [int(t) for t in
                           entry.get("generated_tokens", [])],
                "finish_reason": entry.get("finish_reason"),
                "error": entry.get("error") if failed else None})

    def _fail(self, req: Request, error: str) -> None:
        req.state = RequestState.FAILED
        req.error = error
        req.finish_time = time.monotonic()
        req.finish_reason = "error"
        with self._lock:
            self.total_failed += 1
            meta = self._meta.pop(req.request_id, None)
            waiter = self._waiters.pop(req.request_id, None)
            self._rec({"op": "pop", "rid": req.request_id,
                       "outcome": "failed",
                       "tokens": ([int(t) for t in req.generated_tokens]
                                  if self.store.shared else None),
                       "finish_reason": "error", "error": error})
        if meta is not None:
            req.fleet_meta = meta
        if waiter is not None:
            waiter(req)

    def requeue(self, reqs: Sequence[Request], from_replica: int) -> int:
        """Re-place requests extracted from a crashed/drained replica.
        Requests over their requeue budget fail loudly; ones that no healthy
        replica can take are parked until ``flush_parked``. Returns how many
        were placed immediately."""
        placed = 0
        for req in reqs:
            if getattr(req, "pipeline_stage", None) is not None:
                # pipelined-prefill stages are never re-placed: their
                # product is cache pages on the replica that just died.
                # Notify the coordinator so the pipeline collapses to a
                # single-replica prefill instead of waiting to timeout.
                if self.pipeline is not None:
                    self.pipeline.stage_orphaned(req)
                continue
            with self._lock:
                meta = self._meta.get(req.request_id)
                if meta is None:      # completed/cancelled concurrently
                    continue
                meta["requeues"] += 1
                n = meta["requeues"]
                self.total_requeues += 1
                self.requeues_per_replica[from_replica] = (
                    self.requeues_per_replica.get(from_replica, 0) + 1)
                self._rec({"op": "count", "key": "requeues",
                           "replica": from_replica})
                self._rec({"op": "meta", "rid": req.request_id,
                           "requeues": n})
            if n > self.cfg.max_requeues:
                self._fail(req, f"requeued {n} times (max_requeues="
                                f"{self.cfg.max_requeues})")
                continue
            # keep_kv: payload presence was decided replica-side — drain
            # victims under migrate_on_drain travel WITH their KV pages
            # (and crash-salvaged partial pre-copies ride here too);
            # crash paths already stripped theirs in _rip_out
            reset_for_requeue(req, keep_kv=True)
            if self._place(req, exclude=frozenset({from_replica}),
                           src=from_replica):
                placed += 1
            elif self._place(req, src=from_replica):
                placed += 1           # lone-replica fleet: same one is fine
            else:
                with self._lock:
                    overflow = (len(self._parked)
                                >= self.cfg.max_pending)
                    if not overflow:
                        self._parked.append(req)
                        self._rec({"op": "park", "rid": req.request_id,
                                   "wire": (self._wire(req)
                                            if self.store.shared
                                            else None)})
                if overflow:
                    self._fail(req, "no healthy replica and the requeue "
                                    "buffer is full")
        self.observer("fleet_requeue", {"from_replica": from_replica,
                                        "count": len(reqs)})
        return placed

    def replica_of(self, request_id: str) -> Optional[int]:
        """Last known placement of an in-flight request (None when unknown
        or already terminal) — the operator-migrate source lookup."""
        with self._lock:
            meta = self._meta.get(request_id)
            return meta.get("replica") if meta else None

    def place_migrated(self, req: Request, from_replica: int,
                       dest: Optional[int] = None,
                       kind: str = "migration") -> bool:
        """Place a sequence that left ``from_replica`` WITH its KV payload
        (serve/fleet/migration.py). The rebalancer's destination hint is
        tried first; otherwise normal candidate order (excluding the
        source). Does NOT charge the requeue budget — migrations are
        voluntary moves, not failures. Unplaceable sequences park like
        requeues; the payload rides along and restores wherever they land
        (or the destination falls back to re-prefill if its pool is full).
        """
        with self._lock:
            known = req.request_id in self._meta
        if not known:            # completed/cancelled concurrently
            return False
        placed = False
        if dest is not None:
            r = self.by_id.get(dest)
            if r is not None and r.accepting() \
                    and self._ship(req, from_replica, dest) \
                    and r.submit(req):
                placed = True
                with self._lock:
                    self.routed_per_replica[dest] = (
                        self.routed_per_replica.get(dest, 0) + 1)
                    meta = self._meta.get(req.request_id)
                    if meta is not None:
                        meta["replica"] = dest
                    self._rec({"op": "meta", "rid": req.request_id,
                               "replica": dest})
        if not placed:
            placed = (self._place(req, exclude=frozenset({from_replica}),
                                  src=from_replica)
                      or self._place(req, src=from_replica))
        if placed:
            with self._lock:
                if kind == "handoff":
                    self.total_handoffs += 1
                else:
                    self.total_migrations += 1
                self._rec({"op": "count",
                           "key": ("handoffs" if kind == "handoff"
                                   else "migrations")})
        else:
            with self._lock:
                overflow = len(self._parked) >= self.cfg.max_pending
                if not overflow:
                    self._parked.append(req)
                    self._rec({"op": "park", "rid": req.request_id,
                               "wire": (self._wire(req)
                                        if self.store.shared
                                        else None)})
            if overflow:
                self._fail(req, f"no healthy replica for a {kind} "
                                "sequence and the requeue buffer is full")
        self.observer(f"fleet_{kind}", {
            "from_replica": from_replica, "dest": dest,
            "request_id": req.request_id, "placed": placed})
        return placed

    # -- disaggregated prefill/decode handoff --------------------------------

    def handoff_dest(self, req: Request,
                     from_replica: int) -> Optional[int]:
        """Pre-extraction advisory for a prefill-role replica: the
        decode-capable replica this freshly-prefilled sequence should land
        on — pure decode role first, least outstanding tokens within a
        class — or None when no decode pool has room (the source then
        decodes locally: the DistServe fallback that keeps handoff an
        optimization, never a liveness dependency)."""
        cands = [r for r in self.replicas
                 if r.replica_id != from_replica and r.accepting()
                 and _role(r) in ("decode", "mixed")]
        cands.sort(key=lambda r: ({"decode": 0}.get(_role(r), 1),
                                  r.outstanding_tokens(), r.replica_id))
        for r in cands:
            room = getattr(r, "pool_room_for", None)
            if room is None or room(req):
                return r.replica_id
        return None

    def place_handoff(self, req: Request, from_replica: int,
                      dest: Optional[int] = None) -> bool:
        """Place a post-prefill handoff (called synchronously from the
        source replica's engine thread). Same machinery as
        ``place_migrated`` — dest hint first, then decode-first candidate
        order, park on total outage — but counted in the handoff ledger.
        The final fallback includes the SOURCE replica itself: the
        payload restores anywhere with zero prefill, landing back home is
        merely un-disaggregated, not wrong."""
        return self.place_migrated(req, from_replica, dest=dest,
                                   kind="handoff")

    # -- pipelined multi-replica prefill -------------------------------------

    def place_pipeline_final(self, req: Request,
                             dest: Optional[int] = None) -> bool:
        """Place the ORIGINAL request of a pipelined prefill (called from
        the coordinator's pipeline thread). With ``dest`` (the planned
        final stage replica) the submit is direct and PRESERVES the
        coordinator's prefix hint — the predecessor stage owns the
        shipped chain, which the destination's inventory may not
        advertise yet. ``dest=None`` is the collapse path: ordinary
        candidate order with placement-time hints, which usually
        recovers whatever chunks completed before the failure."""
        with self._lock:
            known = req.request_id in self._meta
        if not known:            # cancelled/failed concurrently
            return False
        if dest is not None:
            r = self.by_id.get(dest)
            if r is not None and r.accepting() and r.submit(req):
                with self._lock:
                    self.routed_per_replica[dest] = (
                        self.routed_per_replica.get(dest, 0) + 1)
                    meta = self._meta.get(req.request_id)
                    if meta is not None:
                        meta["replica"] = dest
                    self._rec({"op": "meta", "rid": req.request_id,
                               "replica": dest})
                return True
            # planned destination refused (drained/full since planning):
            # fall through to the ordinary path — still correct, the
            # hint re-attachment finds the pages wherever they are
        return self._place(req)

    def pipeline_abandon(self, req: Request, error: str) -> None:
        """Terminal failure for a pipelined request that neither the
        pipeline nor the collapse placement could land: settles the
        ledger (submitted=1/failed=1) and fires the waiter."""
        self._fail(req, error)

    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked)

    def _ship(self, req: Request, src: Optional[int],
              dest: int) -> bool:
        """Move the request's KV payload src->dest over the courier
        transport before submission. True = ready to submit (payload
        delivered, or nothing to ship). False = the transfer aborted:
        the payload is gone and the request now needs prefill — the
        caller must recompute its candidate set (a decode-role replica
        chosen for a payload can no longer take it)."""
        if self.courier is None:
            return True
        return self.courier.ship(req, src, dest)

    def _place(self, req: Request, exclude: frozenset = frozenset(),
               src: Optional[int] = None) -> bool:
        while True:
            cands, _ = self._candidates(
                req.prompt_tokens, exclude=exclude,
                needs_prefill=_needs_prefill(req),
                priority=getattr(req, "priority", "standard"))
            invs = self._inventories() if self._hints_enabled(req) else {}
            for r in cands:
                if invs:
                    self._attach_prefix_hint(req, r.replica_id, invs)
                if not self._ship(req, src, r.replica_id):
                    # courier abort dropped the payload; the candidate
                    # order (decode-first, affinity-skipped) is stale —
                    # re-plan as a needs-prefill placement. Terminates:
                    # with no payload left, _ship can never fail again.
                    break
                if r.submit(req):
                    with self._lock:
                        self.routed_per_replica[r.replica_id] = (
                            self.routed_per_replica.get(r.replica_id, 0)
                            + 1)
                        meta = self._meta.get(req.request_id)
                        if meta is not None:
                            meta["replica"] = r.replica_id
                        self._rec({"op": "meta", "rid": req.request_id,
                                   "replica": r.replica_id})
                    return True
            else:
                return False

    def flush_parked(self) -> int:
        """Retry parked requeues (called by the supervisor after a replica
        returns to rotation). Returns how many found a home. With a
        shared store, the deterministic adopter additionally rehydrates
        requests a DEAD front parked — from their journaled wire form,
        so they re-prefill on a survivor instead of being stranded in a
        heap that no longer exists."""
        with self._lock:
            parked, self._parked = self._parked, []
        placed = 0
        still_parked = []
        for req in parked:
            with self._lock:
                meta = self._meta.get(req.request_id)
                # a parked payload still sits on its LAST placement's
                # host; that replica is the courier source when the
                # request finally finds a home
                src = meta.get("replica") if meta else None
            if self._place(req, src=src):
                placed += 1
                self._rec({"op": "unpark", "rid": req.request_id})
            else:
                still_parked.append(req)
        if still_parked:
            with self._lock:
                self._parked = still_parked + self._parked
        placed += self._adopt_parked()
        return placed

    def _adopt_parked(self) -> int:
        """Adopt dead fronts' parked requests (shared store only, one
        deterministic adopter at a time). The adopter fences the dead
        owner BEFORE claiming, so a zombie cannot re-place the same
        request — and even if two fronts raced here, seq-dedupe plus
        the idempotent pop fold make a double placement a waste of
        FLOPs, never a correctness break."""
        if not self.store.shared or not self._parked_remote \
                or not self.store.is_adopter():
            return 0
        placed = 0
        with self._lock:
            candidates = list(self._parked_remote.items())
        for rid, (owner, wire) in candidates:
            if not owner or self.store.front_alive(owner):
                continue
            if not wire:
                continue
            self.store.fence(owner)
            with self._lock:
                if rid not in self._meta:      # finished concurrently
                    self._parked_remote.pop(rid, None)
                    continue
                self._parked_remote.pop(rid, None)
                self._rec({"op": "unpark", "rid": rid})
            from .remote import request_from_wire
            try:
                req = request_from_wire(wire)
            except (KeyError, TypeError, ValueError):
                logger.warning("adoption: malformed parked wire for %s",
                               rid)
                continue
            reset_for_requeue(req)
            if self._place(req):
                placed += 1
                self.total_parked_adopted += 1
                logger.warning("adopted parked request %s from dead "
                               "front %s", rid, owner)
            else:
                with self._lock:
                    self._parked.append(req)
                    self._rec({"op": "park", "rid": rid,
                               "wire": self._wire(req)})
        return placed

    def cancel(self, request_id: str) -> bool:
        """Client-timeout path: cancel wherever the request currently is
        (its meta records the last placement; a requeue between the read
        and the call falls through to the all-replicas sweep)."""
        with self._lock:
            meta = self._meta.get(request_id)
            last = meta.get("replica") if meta else None
        ordered = ([self.by_id[last]] if last in self.by_id else []) + [
            r for r in self.replicas if r.replica_id != last]
        for r in ordered:
            if getattr(r, "cancel", None) is not None \
                    and r.cancel(request_id):
                return True
        with self._lock:     # parked: cancel locally
            for i, req in enumerate(self._parked):
                if req.request_id == request_id:
                    self._parked.pop(i)
                    self._meta.pop(request_id, None)
                    self._waiters.pop(request_id, None)
                    self._rec({"op": "pop", "rid": request_id,
                               "outcome": "cancelled"})
                    return True
        return False

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            in_flight = len(self._meta)
            return {
                "submitted": self.total_submitted,
                "completed": self.total_completed,
                "failed": self.total_failed,
                "rejected": self.total_rejected,
                "requeues": self.total_requeues,
                "affinity_hits": self.total_affinity_hits,
                "migrations": self.total_migrations,
                "handoffs": self.total_handoffs,
                "parked": len(self._parked),
                "parked_remote": len(self._parked_remote),
                "parked_adopted": self.total_parked_adopted,
                "in_flight": in_flight,
                # SLO priority tiers: per-class admission ledger (dict
                # copies — callers mutate snapshots freely)
                "submitted_by_class": dict(self.submitted_by_class),
                "rejected_by_class": dict(self.rejected_by_class),
                "inventory_cache_hits": self.inventory_cache_hits,
                "inventory_cache_misses": self.inventory_cache_misses,
                "store_hint_remote_skips":
                    self.total_store_hint_remote_skips,
                "completed_per_replica": dict(self.completed_per_replica),
                "routed_per_replica": dict(self.routed_per_replica),
                "requeues_per_replica": dict(self.requeues_per_replica),
            }
