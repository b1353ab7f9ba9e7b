"""Replica supervisor: health probes, restart-with-backoff, drain.

The supervisor is the fleet's failure detector and janitor. Each poll it:

1. collects orphans — requests a crashed or drained replica extracted —
   and hands them to the router for re-placement on surviving replicas;
2. probes healthy replicas (queue depth + liveness; the fault injector can
   make a probe time out to model a hung/partitioned replica). After
   ``probe_failures`` consecutive misses the replica is torn down exactly
   like a crash: thread stopped, in-flight work requeued, engine rebuilt;
3. restarts dead replicas under exponential backoff (base doubles per
   consecutive restart, capped), then flushes any parked requeues at them.

Everything runs on one supervisor thread (or, in tests and the dryrun
regime, via explicit ``poll_once`` calls — no background thread, fully
deterministic scheduling), so per-replica state needs no locking beyond
what the replicas themselves provide.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ...config.schema import FleetConfig
from . import replica as replica_mod
from .faults import FaultInjector
from .replica import (ROLE_DECODE, ROLE_MIXED, ROLE_PREFILL, EngineReplica)
from .router import FleetRouter
from ...analysis.annotations import (supervisor_thread, thread_seam)

logger = logging.getLogger("llmctl.serve.fleet.supervisor")


class ReplicaSupervisor:
    def __init__(self, replicas: list[EngineReplica], router: FleetRouter,
                 cfg: Optional[FleetConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 params=None,
                 observer: Optional[Callable[[str, dict], None]] = None,
                 streams=None, store=None, kv_store=None, pipeline=None,
                 autoscaler=None, weights=None):
        self.cfg = cfg or FleetConfig()
        self.replicas = replicas
        self.router = router
        self.injector = injector
        # tiered fleet KV store (serve/fleet/kv_store.py) OR its
        # networked stand-in (store_service.StoreClient — same duck):
        # snapshot section + `fleet status` line. None = no store tier.
        self.kv_store = kv_store
        # weight courier (serve/fleet/weights.py): checkpoint-shipping
        # counters land as the snapshot's "weights" section (feeds
        # llmctl_fleet_weights_*). None = no store service.
        self.weights = weights
        # pipelined multi-replica prefill (serve/fleet/pipeline.py):
        # snapshot section + `fleet status` line. None = bare-router
        # unit tests.
        self.pipeline = pipeline
        # elastic autoscaler (serve/fleet/autoscaler.py): scale up/down
        # + SLO preemption decisions ride this poll loop — one decision
        # point per poll, after the rebalancer. None = fixed fleet.
        self.autoscaler = autoscaler
        # fleet stream hub (serve/fleet/streams.py): snapshot columns +
        # replay-window GC ride the supervisor poll. None = no streaming
        # plane (unit tests on bare routers).
        self.streams = streams
        # replicable front state (serve/fleet/state.py): shared stores
        # get a heartbeat + journal fold each poll, and the snapshot
        # grows a "fronts" section. None/in-memory = single front.
        self.store = store
        self.params = params          # shared weights for engine rebuilds
        self.observer = observer or (lambda event, payload: None)
        self._misses: dict[int, int] = {r.replica_id: 0 for r in replicas}
        self._next_restart: dict[int, float] = {}
        self._backoff: dict[int, float] = {}
        self.total_restarts = 0
        # migration-driven rebalancer state: consecutive polls over the
        # imbalance bound (hysteresis — one bursty poll must not move KV)
        self._imbalance_streak = 0
        self.total_rebalance_migrations = 0
        # role balancer state (disaggregated prefill/decode): one re-role
        # in flight at a time — (replica_id, new_role) while the donor
        # drains (with migration) before switching class
        self._rerole: Optional[tuple[int, str]] = None
        self._role_streak = 0
        self._role_want: Optional[str] = None
        self.total_reroles = 0
        self.total_role_promotions = 0
        # crash-promotion bookkeeping for auto-demotion: replica_id ->
        # the role it was provisioned with before health promoted it to
        # mixed, plus the per-replica healthy-again streak (demotion
        # fires after `role_restore_hysteresis` consecutive polls with
        # the crashed class back in rotation — one flapping restart must
        # not bounce roles)
        self._promoted: dict[int, str] = {}
        self._restore_streak: dict[int, int] = {}
        self.total_role_demotions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one supervision pass ------------------------------------------------

    @supervisor_thread
    def poll_once(self, now: Optional[float] = None) -> dict:
        """One probe/requeue/restart pass; returns the fleet snapshot it
        acted on. Deterministic: tests drive this directly."""
        now = time.monotonic() if now is None else now
        recovered = False
        if self.store is not None and self.store.shared:
            # fold sibling fronts' journal records into the local hub +
            # ledger views, and stamp our own liveness (the HA tier's
            # failure detector reads these heartbeats)
            self.store.sync()
            self.store.heartbeat(info={
                "active_streams": (self.streams.active_count()
                                   if self.streams is not None else 0)})
        # courier first: completed migrations carry live KV payloads and
        # their requests are homeless until placed — before any probe or
        # restart work, whatever the source replica's state is now
        self._collect_migrated()
        for r in self.replicas:
            state = r.state
            # orphans are collected unconditionally: a REMOTE worker
            # self-heals engine crashes and surfaces the victims through
            # its outbox while the parent still sees it healthy; in-proc
            # replicas only ever stash orphans in crash/drain states, so
            # the extra calls are free no-ops there
            self._requeue_orphans(r)
            if state in (replica_mod.CRASHED, replica_mod.STOPPED):
                recovered |= self._maybe_restart(r, now)
            elif state == replica_mod.HEALTHY:
                self._probe(r)
        self._ensure_role_coverage()
        self._maybe_role_restore()
        self._maybe_role_balance()
        self._maybe_rebalance()
        if self.autoscaler is not None:
            self.autoscaler.poll(now=time.monotonic())
        if self.streams is not None:
            # expire finished replay windows AND unfinished logs whose
            # request the router no longer knows (the PR-8 leak: opened
            # by submit_streaming, died outside the finish wiring)
            self.streams.gc(known=self.router.knows)
        if recovered or self.router.parked_count():
            self.router.flush_parked()
        snap = self.snapshot()
        self.observer("fleet", snap)
        return snap

    @supervisor_thread
    def _collect_migrated(self) -> None:
        for r in self.replicas:
            for req, ticket in r.take_migrated():
                # remote prefill workers surface their prefill->decode
                # handoffs here (they can't see the fleet to place them
                # synchronously); keep them in the handoff ledger
                kind = ("handoff" if ticket.reason == "handoff"
                        else "migration")
                self.router.place_migrated(req, from_replica=r.replica_id,
                                           dest=ticket.dest, kind=kind)

    @supervisor_thread
    def _maybe_rebalance(self) -> None:
        """Migration-driven load rebalancing: when the outstanding-token
        spread between the hottest and coldest healthy replica exceeds
        the configured fraction of the hottest's load for
        ``rebalance_poll_hysteresis`` consecutive polls, the hottest
        replica's longest-remaining resident sequences migrate hot ->
        cold (bounded by ``max_concurrent_migrations``). Placement bias
        on NEW requests can't fix a skew of long-running residents —
        moving the sequences themselves can."""
        cfg = self.cfg
        if cfg.rebalance_imbalance_ratio <= 0:
            return
        healthy = [r for r in self.replicas
                   if r.state == replica_mod.HEALTHY]
        if len(healthy) < 2:
            self._imbalance_streak = 0
            return
        load = {r.replica_id: r.outstanding_tokens() for r in healthy}
        hot = max(healthy, key=lambda r: (load[r.replica_id], -r.replica_id))
        cold = min(healthy, key=lambda r: (load[r.replica_id], r.replica_id))
        spread = load[hot.replica_id] - load[cold.replica_id]
        if load[hot.replica_id] <= 0 or \
                spread <= cfg.rebalance_imbalance_ratio \
                * load[hot.replica_id]:
            self._imbalance_streak = 0
            return
        self._imbalance_streak += 1
        if self._imbalance_streak < cfg.rebalance_poll_hysteresis:
            return
        budget = cfg.max_concurrent_migrations - sum(
            r.migrations_in_flight() for r in self.replicas)
        if budget <= 0:
            return
        residents = sorted(hot.resident_requests(),
                           key=lambda x: x[1], reverse=True)
        moved = 0
        for rid, *_rest in residents[:budget]:
            if hot.request_migrate(rid, dest=cold.replica_id,
                                   reason="rebalance"):
                moved += 1
        if moved:
            self.total_rebalance_migrations += moved
            # re-arm: let the moves land before measuring the spread again
            self._imbalance_streak = 0
            logger.info(
                "rebalancer: migrating %d sequence(s) replica %d -> %d "
                "(outstanding %d vs %d)", moved, hot.replica_id,
                cold.replica_id, load[hot.replica_id],
                load[cold.replica_id])

    # -- disaggregated prefill/decode roles ----------------------------------

    @staticmethod
    def _role(r) -> str:
        return getattr(r, "role", ROLE_MIXED)

    @supervisor_thread
    def _ensure_role_coverage(self) -> None:
        """Role-aware health: if every prefill-capable replica is down,
        new requests have nowhere to go (and payload-less orphans park
        forever); if every decode-capable one is down, handoffs all fall
        back to local decode. Either way the fix is the same — promote a
        healthy survivor of the other class to MIXED so the fleet
        degrades to classic (un-disaggregated) serving instead of
        deadlocking. Promotions reverse automatically: once the crashed
        class is healthy again for ``role_restore_hysteresis`` polls,
        ``_maybe_role_restore`` demotes the survivor back to its
        provisioned role (0 disables — operator re-splits manually)."""
        roles = {r.replica_id: self._role(r) for r in self.replicas}
        if all(v == ROLE_MIXED for v in roles.values()):
            return
        healthy = [r for r in self.replicas
                   if r.state == replica_mod.HEALTHY
                   and hasattr(r, "set_role")]

        def promote(donors: list, lost: str) -> None:
            if not donors:
                return
            r = min(donors, key=lambda x: (x.outstanding_tokens(),
                                           x.replica_id))
            logger.warning(
                "no healthy %s-capable replica left: promoting replica "
                "%d (%s) to mixed", lost, r.replica_id, self._role(r))
            # remember the provisioned role so _maybe_role_restore can
            # demote once the crashed class returns to rotation
            self._promoted.setdefault(r.replica_id, self._role(r))
            self._restore_streak.pop(r.replica_id, None)
            r.set_role(ROLE_MIXED)
            self.total_role_promotions += 1
            self.router.flush_parked()

        def provisioned(kind: str) -> bool:
            # the capability exists SOMEWHERE in the fleet (any state):
            # losing it to crashes warrants promotion. A fleet the
            # operator built without it (e.g. prefill-only, where local
            # decode IS the design) must not self-promote.
            return any(v in (kind, ROLE_MIXED) for v in roles.values())

        if provisioned(ROLE_PREFILL) and not any(
                roles[r.replica_id] in (ROLE_PREFILL, ROLE_MIXED)
                for r in healthy):
            promote([r for r in healthy
                     if roles[r.replica_id] == ROLE_DECODE], ROLE_PREFILL)
        healthy = [r for r in self.replicas
                   if r.state == replica_mod.HEALTHY
                   and hasattr(r, "set_role")]
        if provisioned(ROLE_DECODE) and not any(
                self._role(r) in (ROLE_DECODE, ROLE_MIXED)
                for r in healthy):
            promote([r for r in healthy
                     if self._role(r) == ROLE_PREFILL], ROLE_DECODE)

    @supervisor_thread
    def _maybe_role_restore(self) -> None:
        """Auto-demotion (PR-4 known gap): a replica that role-aware
        health promoted to MIXED returns to its provisioned role once the
        class it was covering for is healthy again — held for
        ``role_restore_hysteresis`` consecutive polls so one flapping
        restart cannot bounce roles. A promoted replica the operator (or
        balancer) has since re-roled away from mixed is no longer ours to
        demote; its record is dropped."""
        if not self._promoted or self.cfg.role_restore_hysteresis <= 0:
            return
        for rid, provisioned in list(self._promoted.items()):
            r = next((x for x in self.replicas if x.replica_id == rid),
                     None)
            if r is None or self._role(r) != ROLE_MIXED \
                    or not hasattr(r, "set_role"):
                self._promoted.pop(rid, None)
                self._restore_streak.pop(rid, None)
                continue
            # the capability this promotion was covering is the OPPOSITE
            # of the provisioned role (a decode replica went mixed
            # because prefill died, and vice versa)
            lost = (ROLE_DECODE if provisioned == ROLE_PREFILL
                    else ROLE_PREFILL)
            covered = any(
                x.replica_id != rid and x.state == replica_mod.HEALTHY
                and self._role(x) in (lost, ROLE_MIXED)
                for x in self.replicas)
            if not covered:
                self._restore_streak.pop(rid, None)
                continue
            streak = self._restore_streak.get(rid, 0) + 1
            self._restore_streak[rid] = streak
            if streak < self.cfg.role_restore_hysteresis:
                continue
            logger.info(
                "%s class healthy again: demoting replica %d back to "
                "provisioned role %s", lost, rid, provisioned)
            r.set_role(provisioned)
            self.total_role_demotions += 1
            self._promoted.pop(rid, None)
            self._restore_streak.pop(rid, None)
            self.router.flush_parked()

    @supervisor_thread
    def _maybe_role_balance(self) -> None:
        """Re-role replicas from observed phase pressure. Prefill pressure
        is the queue of un-prefilled prompts on prefill-role replicas;
        decode-slot pressure is observed through the handoff backlog
        (handoffs only queue on a decode replica when every slot is
        busy). When one class's per-replica queue depth exceeds
        ``role_balance_ratio`` x the other's (+1, so idle fleets don't
        flap) for ``role_balance_poll_hysteresis`` consecutive polls, the
        least-loaded replica of the over-provisioned class drains (with
        migration — its residents move out losslessly) and joins the
        starved class. Floors keep every class minimally staffed; one
        re-role in flight at a time."""
        cfg = self.cfg
        if cfg.role_balance_ratio <= 0:
            return
        if self._rerole is not None:
            rid, new_role = self._rerole
            r = next((x for x in self.replicas if x.replica_id == rid),
                     None)
            if r is None or r.state in (replica_mod.CRASHED,
                                        replica_mod.STOPPED):
                self._rerole = None     # died mid-drain: abandon the move
            elif r.state == replica_mod.DRAINED:
                r.set_role(new_role)
                r.undrain()
                self.router.flush_parked()
                self.total_reroles += 1
                self._rerole = None
                logger.info("role balancer: replica %d re-roled to %s",
                            rid, new_role)
            return                      # one move at a time
        healthy = [r for r in self.replicas
                   if r.state == replica_mod.HEALTHY
                   and hasattr(r, "set_role")]
        pre = [r for r in healthy if self._role(r) == ROLE_PREFILL]
        dec = [r for r in healthy if self._role(r) == ROLE_DECODE]
        if not pre or not dec:
            self._role_streak = 0
            return
        p = sum(r.queue_depth() for r in pre) / len(pre)
        d = sum(r.queue_depth() for r in dec) / len(dec)
        if p > cfg.role_balance_ratio * (d + 1.0) \
                and len(dec) > cfg.role_min_decode:
            want, donors = ROLE_PREFILL, dec
        elif d > cfg.role_balance_ratio * (p + 1.0) \
                and len(pre) > cfg.role_min_prefill:
            want, donors = ROLE_DECODE, pre
        else:
            self._role_streak = 0
            self._role_want = None
            return
        if self._role_want != want:     # direction flip restarts the count
            self._role_streak = 0
            self._role_want = want
        self._role_streak += 1
        if self._role_streak < cfg.role_balance_poll_hysteresis:
            return
        donor = min(donors, key=lambda r: (r.outstanding_tokens(),
                                           r.replica_id))
        self._rerole = (donor.replica_id, want)
        self._role_streak = 0
        logger.info(
            "role balancer: draining replica %d (%s) to re-role as %s "
            "(prefill q %.1f vs decode q %.1f per replica)",
            donor.replica_id, self._role(donor), want, p, d)
        donor.request_drain()

    @supervisor_thread
    def _requeue_orphans(self, r: EngineReplica) -> None:
        orphans = r.take_orphans()
        if orphans:
            logger.info("requeuing %d orphans from replica %d",
                        len(orphans), r.replica_id)
            self.router.requeue(orphans, from_replica=r.replica_id)

    @supervisor_thread
    def _probe(self, r: EngineReplica) -> None:
        try:
            if self.injector is not None:
                self.injector.on_probe(r.replica_id)
            r.probe()
        except Exception as e:
            self._misses[r.replica_id] = self._misses.get(
                r.replica_id, 0) + 1
            logger.warning("probe miss %d/%d on replica %d: %s",
                           self._misses[r.replica_id],
                           self.cfg.probe_failures, r.replica_id, e)
            if self._misses[r.replica_id] >= self.cfg.probe_failures:
                # declared dead: tear down like a crash — requests move,
                # the engine rebuilds under backoff
                logger.warning("replica %d declared dead after %d probe "
                               "misses", r.replica_id,
                               self._misses[r.replica_id])
                orphans = r.teardown()
                # its prefix cache died with it: cached inventories must
                # not keep hinting fetches at a dead owner
                self.router.invalidate_inventories()
                if orphans:
                    self.router.requeue(orphans,
                                        from_replica=r.replica_id)
                self._schedule_restart(r, time.monotonic())
            return
        self._misses[r.replica_id] = 0

    @supervisor_thread
    def _schedule_restart(self, r: EngineReplica, now: float) -> None:
        if r.replica_id not in self._next_restart:
            backoff = self._backoff.get(r.replica_id,
                                        self.cfg.restart_backoff_s)
            self._next_restart[r.replica_id] = now + backoff
            # exponential: the NEXT consecutive failure waits twice as long
            self._backoff[r.replica_id] = min(
                max(backoff, 1e-3) * 2, self.cfg.restart_backoff_max_s)

    @supervisor_thread
    def _maybe_restart(self, r: EngineReplica, now: float) -> bool:
        if self.cfg.max_restarts and r.restarts >= self.cfg.max_restarts:
            return False               # permanently failed; stays dead
        self._schedule_restart(r, now)
        if now < self._next_restart[r.replica_id]:
            return False
        try:
            r.stop()                    # idempotent; joins a dead thread
            r.restart(params=self.params)
            self.router.invalidate_inventories()   # fresh (empty) cache
            self.total_restarts += 1
            self._misses[r.replica_id] = 0
            del self._next_restart[r.replica_id]
            logger.info("replica %d restarted (restart #%d, next backoff "
                        "%.2fs)", r.replica_id, r.restarts,
                        self._backoff[r.replica_id])
            return True
        except Exception:
            logger.exception("replica %d restart failed", r.replica_id)
            # keep CRASHED; back off again before the next attempt
            del self._next_restart[r.replica_id]
            self._schedule_restart(r, time.monotonic())
            return False

    @thread_seam
    def forget(self, replica_id: int) -> None:
        """Drop all per-replica bookkeeping for a retired member (the
        autoscaler's release path) — a later replica reusing the id
        must not inherit probe misses or restart backoff."""
        self._misses.pop(replica_id, None)
        self._next_restart.pop(replica_id, None)
        self._backoff.pop(replica_id, None)
        self._promoted.pop(replica_id, None)
        self._restore_streak.pop(replica_id, None)
        if self._rerole is not None and self._rerole[0] == replica_id:
            self._rerole = None

    @thread_seam
    def current_backoff_s(self, replica_id: int) -> float:
        """The delay the NEXT restart of this replica will wait (test +
        status surface for the exponential schedule)."""
        return self._backoff.get(replica_id, self.cfg.restart_backoff_s)

    # -- operator actions ----------------------------------------------------

    @thread_seam
    def drain(self, replica_id: int) -> bool:
        r = next((x for x in self.replicas if x.replica_id == replica_id),
                 None)
        if r is None:
            return False
        r.request_drain()
        # drain changes which replica should attract placements AND whose
        # inventory the spill-off hints should consult — re-read fresh
        self.router.invalidate_inventories()
        return True

    @thread_seam
    def undrain(self, replica_id: int) -> bool:
        r = next((x for x in self.replicas if x.replica_id == replica_id),
                 None)
        if r is None:
            return False
        r.undrain()
        self.router.invalidate_inventories()
        self.router.flush_parked()
        return True

    @thread_seam
    def set_role(self, replica_id: int, role: str) -> bool:
        """Operator action (`llmctl fleet role` / POST /fleet/role):
        manually re-role one replica. Immediate — the operator drains
        first if they want the switch loss-free for residents (the
        balancer's automated path does exactly that)."""
        if role not in (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED):
            return False
        r = next((x for x in self.replicas if x.replica_id == replica_id),
                 None)
        if r is None or not hasattr(r, "set_role"):
            return False
        r.set_role(role)
        self.total_reroles += 1
        self.router.flush_parked()
        return True

    @thread_seam
    def migrate(self, request_id: str, dest_replica: int) -> bool:
        """Operator action (`llmctl fleet migrate`): move one in-flight
        request to ``dest_replica`` with its KV. Returns False when the
        destination doesn't exist, the request isn't resident anywhere,
        or it already lives on the destination."""
        if all(r.replica_id != dest_replica for r in self.replicas):
            return False
        src_id = self.router.replica_of(request_id)
        if src_id is None or src_id == dest_replica:
            return False
        src = next((r for r in self.replicas if r.replica_id == src_id),
                   None)
        if src is None:
            return False
        return src.request_migrate(request_id, dest=dest_replica,
                                   reason="operator")

    # -- background loop -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.probe_interval_s):
                try:
                    self.poll_once()
                except Exception:
                    logger.exception("supervisor poll failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="llmctl-fleet-supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- introspection -------------------------------------------------------

    @supervisor_thread
    def snapshot(self) -> dict:
        """Fleet-wide status: per-replica health + router ledger. Feeds
        /fleet/status, `llmctl fleet status`, and the Prometheus pump."""
        reps = []
        requeue_cached = 0
        pauses: list[float] = []
        stalls: list[float] = []
        by_reason: dict[str, int] = {}
        # fleet-global prefix cache: fetch-side aggregates (counters are
        # running totals; fetch_ms a bounded recent window + cumulative
        # count — the usual Prometheus delta contract)
        fetch_agg = {"fetches": 0, "pages": 0, "bytes": 0, "misses": 0,
                     "aborts": 0, "fetch_ms": [], "fetch_count": 0}
        # courier-aware speculation: per-replica acceptance counters,
        # fleet-aggregated (running totals — the llmctl_fleet_spec_*
        # Prometheus pump deltas them). `resumes` counts sequences that
        # arrived WITH a migrated SpecState and kept their tuned window.
        spec_agg = {"dispatches": 0, "drafts": 0, "accepted": 0,
                    "resumes": 0}
        try:
            endpoints = self.cfg.endpoint_map()
        except Exception:
            endpoints = {}
        stream_by_replica = (self.streams.replica_stats()
                             if self.streams is not None else {})
        for r in self.replicas:
            hits, queries, cached = r.prefix_cache_stats()
            requeue_cached += cached
            pauses.extend(r.migration_pauses_ms)
            stalls.extend(getattr(r, "handoff_stalls_ms", ()))
            for reason, n in r.migrations_by_reason.items():
                by_reason[reason] = by_reason.get(reason, 0) + n
            pf = (r.prefix_fetch_stats()
                  if hasattr(r, "prefix_fetch_stats") else {})
            for key in ("fetches", "pages", "bytes", "misses", "aborts",
                        "fetch_count"):
                fetch_agg[key] += int(pf.get(key, 0))
            fetch_agg["fetch_ms"].extend(pf.get("fetch_ms", ()))
            sp = r.spec_stats() if hasattr(r, "spec_stats") else {}
            for key in spec_agg:
                spec_agg[key] += int(sp.get(key, 0))
            reps.append({
                "replica": r.replica_id,
                "state": r.state,
                "role": self._role(r),
                # courier endpoint this replica receives payloads at
                # ("local" = this process's receiver via the fleet front)
                "endpoint": endpoints.get(r.replica_id, "local"),
                "remote": bool(getattr(r, "remote", False)),
                # crash-promoted to mixed; auto-demotes back to this
                # provisioned role once the lost class is healthy again
                "promoted_from": self._promoted.get(r.replica_id),
                "queue_depth": r.queue_depth(),
                "active": r.active_count(),
                "outstanding_tokens": r.outstanding_tokens(),
                "restarts": r.restarts,
                "probe_misses": self._misses.get(r.replica_id, 0),
                "last_error": r.last_error,
                "migrations": r.migrations_out,
                "handoffs": getattr(r, "handoffs_out", 0),
                "prefix_hits": hits,
                "prefix_queries": queries,
                "prefix_hit_rate": round(hits / max(queries, 1), 4),
                # fleet-global prefix cache: pages this replica pulled
                # from siblings instead of re-prefilling, and the
                # attempts that came back empty
                "prefix_fetch_pages": int(pf.get("pages", 0)),
                "prefix_fetch_misses": int(pf.get("misses", 0)),
                # fleet SSE streaming: live streams this replica is
                # currently producing, and duplicate tokens it
                # republished after a re-placement (suppressed by seq —
                # the migration-resume replay, client-invisible)
                "active_streams": int(stream_by_replica.get(
                    r.replica_id, {}).get("active", 0)),
                "stream_replayed_tokens": int(stream_by_replica.get(
                    r.replica_id, {}).get("replayed", 0)),
                # speculative decode per replica: the acceptance rate is
                # the `fleet status` column; resumes are migrated-state
                # arms (courier-aware speculation)
                "spec_dispatches": int(sp.get("dispatches", 0)),
                "spec_drafts": int(sp.get("drafts", 0)),
                "spec_accepted": int(sp.get("accepted", 0)),
                "spec_resumes": int(sp.get("resumes", 0)),
                "spec_acceptance": round(
                    int(sp.get("accepted", 0))
                    / max(int(sp.get("drafts", 0)), 1), 4),
            })
        migration = {
            "migrations": sum(r.migrations_out for r in self.replicas),
            # rebalancer-initiated moves specifically (graftlint
            # counter-wiring found this counted-but-never-snapshotted
            # since PR 3 — the by_reason dict only aggregates moves that
            # COMPLETED, while this counts moves the rebalancer ordered)
            "rebalance_migrations": self.total_rebalance_migrations,
            "migrated_tokens": sum(r.migrated_tokens
                                   for r in self.replicas),
            # drain migrations skip re-prefill of prompt+generated; warm-
            # prefix requeues skip the cached prompt pages — both are
            # prefill FLOPs the fleet did NOT spend
            "reprefill_tokens_avoided": requeue_cached + sum(
                r.reprefill_avoided_tokens for r in self.replicas),
            "in_flight": sum(r.migrations_in_flight()
                             for r in self.replicas),
            "by_reason": by_reason,
            # recent stop-and-copy pauses (bounded per replica) plus the
            # cumulative count, so the Prometheus pump can histogram only
            # the NEW ones (delta on pause_count)
            "pauses_ms": pauses,
            "pause_count": sum(r.migrations_out for r in self.replicas),
        }
        # disaggregated prefill/decode plane: handoff counters arrive as
        # running totals (the Prometheus pump deltas them), the stall
        # list as a bounded recent window + cumulative count (same
        # contract as migration pauses)
        handoff = {
            "handoffs": sum(getattr(r, "handoffs_out", 0)
                            for r in self.replicas),
            "handoff_tokens": sum(getattr(r, "handoff_tokens", 0)
                                  for r in self.replicas),
            "local_fallbacks": sum(getattr(r, "handoffs_local", 0)
                                   for r in self.replicas),
            "stalls_ms": stalls,
            "stall_count": sum(getattr(r, "handoffs_out", 0)
                               for r in self.replicas),
            "reroles": self.total_reroles,
            "promotions": self.total_role_promotions,
            "demotions": self.total_role_demotions,
        }
        # courier transport plane (serve/fleet/transport.py): running
        # totals + a bounded recent transfer_ms window, same Prometheus
        # delta contract as the migration pauses above
        courier = getattr(self.router, "courier", None)
        # HA front tier: the shared store's front registry (per-front
        # heartbeat/port/alive) + tier counters. A single-front fleet
        # reports itself alone; in-memory stores report nothing.
        fronts: dict = {}
        if self.store is not None and self.store.shared:
            fronts = {
                "fronts": self.store.fronts_view(),
                "front_id": self.store.front_id,
                "failovers": int(self.store.counters_view().get(
                    "failovers", 0)),
                "reconnects": (self.streams.total_front_resumes
                               if self.streams is not None else 0),
            }
        return {"replicas": reps, "router": self.router.stats(),
                "restarts": self.total_restarts, "migration": migration,
                "handoff": handoff, "front_tier": fronts,
                # fleet SSE streaming: hub counters (running totals +
                # the bounded replay-size window — the usual Prometheus
                # delta contract; feeds llmctl_fleet_stream_*)
                "streams": (self.streams.stats()
                            if self.streams is not None else {}),
                # fleet-global prefix cache: fetched-instead-of-
                # recomputed pages/bytes, misses, aborts + the fetch
                # latency window (feeds llmctl_fleet_prefix_fetch_*)
                "prefix_fetch": fetch_agg,
                # courier-aware speculation: fleet-wide acceptance
                # counters (feeds llmctl_fleet_spec_*) + the aggregate
                # acceptance rate the operator eyeballs
                "spec": {**spec_agg, "acceptance": round(
                    spec_agg["accepted"] / max(spec_agg["drafts"], 1),
                    4)},
                # per-replica courier endpoint map (string keys: JSON)
                "endpoints": {str(k): v for k, v in endpoints.items()},
                # tiered fleet KV store: demotion/hit/miss counters +
                # tier occupancy (running totals, the Prometheus pump
                # deltas the mapped ones; feeds llmctl_fleet_kvstore_*)
                "kv_store": (self.kv_store.snapshot()
                             if self.kv_store is not None else {}),
                # courier weight distribution: chunks/resumes/bytes
                # moved through the store service (feeds
                # llmctl_fleet_weights_*)
                "weights": (self.weights.snapshot()
                            if self.weights is not None else {}),
                "pipeline": (self.pipeline.snapshot()
                             if self.pipeline is not None else {}),
                # elastic autoscaler: scale/preempt counters + the
                # event timeline (feeds llmctl_fleet_autoscale_* and
                # the bench scenario report)
                "autoscale": (self.autoscaler.snapshot()
                              if self.autoscaler is not None else {}),
                "courier": courier.snapshot() if courier else {}}
