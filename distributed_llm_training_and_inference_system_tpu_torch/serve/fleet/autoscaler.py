"""Elastic fleet autoscaler: queue-driven scale up/down + SLO preemption.

The port's copy of the JAX package's ``serve/fleet/autoscaler.py``. All
of it runs from the supervisor poll (``ReplicaSupervisor.poll_once``
calls :meth:`FleetAutoscaler.poll` after the rebalancer):

- **elastic scaling**: when the admission queue per healthy replica stays
  above ``autoscale_up_queue_per_replica`` (or the KV pool's free-page
  ratio below ``autoscale_up_free_page_ratio``) for
  ``autoscale_hysteresis_polls`` polls, one replica is added: an
  in-process ``EngineReplica`` sharing the loaded weights (adopted from the
  warm-spare pool when one is ready), or a ``llmctl-torch fleet worker``
  process found through its ``LLMCTL_WORKER_READY port=N`` line when a
  :class:`ProcessWorkerSpawner` is installed. When the queue fades below
  ``autoscale_down_queue_per_replica`` with an idle replica on hand, the
  least valuable idle replica retires by drain with migration, and its
  prefix inventory flushes to the fleet KV store. Cooldown polls after
  every action and a floor (``autoscale_min_replicas`` and the provisioned
  roles) keep it from flapping.
- **SLO preemption**: when ``interactive_ttft_target_ms`` is set and an
  interactive request has queued past it, one best-effort resident of that
  replica migrates (KV and all) to the least loaded sibling.
- **degrade contract**: a spawn that never reports ready is counted
  (``total_spawn_failures``) and rolled back; a retire whose victim crashes
  or stalls mid-drain is counted (``total_retire_rollbacks``) and handed
  back to the crash and undrain paths.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from collections import deque
from typing import Optional

from ...analysis.annotations import supervisor_thread, thread_seam
from ...config.schema import FleetConfig
from . import replica as replica_mod
from .replica import ROLE_DECODE, ROLE_MIXED, ROLE_PREFILL

logger = logging.getLogger("llmctl.serve.fleet.autoscaler")

# priority class whose residents are preemptible, and the class whose
# queueing latency triggers the preemption (see router.PRIORITIES)
PREEMPTIBLE_CLASS = "best-effort"
PROTECTED_CLASS = "interactive"


def synthesize_worker_argv(model_cfg, serve_cfg, fleet_cfg,
                           weights_name: str = "",
                           spool_dir: str = "", device: str = "cuda") -> list:
    """Worker command line made from the serving process's own config:
    ``serve start --fleet-autoscale-spawn worker`` builds its
    :class:`ProcessWorkerSpawner` from it. It runs the port's CLI module
    with the worker's ``--device`` on its command line, and mirrors the
    options of ``llmctl-torch fleet worker``; ``--replica-id`` and
    ``--port`` are appended per spawn. With a store service
    (``kv_store_endpoint(s)``) the worker boots its weights over the wire
    (``--weights-from-store``)."""
    import sys
    pkg = __name__.split(".")[0]
    argv = [sys.executable, "-m", f"{pkg}.cli", "--device", str(device),
            "fleet", "worker",
            "--model", str(serve_cfg.model),
            "--max-batch-size", str(serve_cfg.max_batch_size),
            "--max-seq-len", str(serve_cfg.max_seq_len),
            "--kv-block-size", str(serve_cfg.kv_block_size),
            "--dtype", str(serve_cfg.dtype),
            "--kv-quantization", str(serve_cfg.kv_quantization),
            "--courier-codec", str(fleet_cfg.courier_codec),
            "--courier-chunk-bytes", str(fleet_cfg.courier_chunk_bytes)]
    if serve_cfg.artifact:
        argv += ["--artifact", str(serve_cfg.artifact)]
    if getattr(serve_cfg, "prefill_chunk", 0):
        argv += ["--prefill-chunk", str(serve_cfg.prefill_chunk)]
    if getattr(serve_cfg, "speculative", "off") != "off":
        argv += ["--speculative", str(serve_cfg.speculative),
                 "--spec-tokens", str(serve_cfg.speculative_tokens)]
    lister = getattr(fleet_cfg, "kv_store_endpoint_list", None)
    store_eps = (list(lister()) if callable(lister) else
                 ([str(fleet_cfg.kv_store_endpoint)]
                  if getattr(fleet_cfg, "kv_store_endpoint", "") else []))
    if store_eps:
        # the whole member list travels: a spawned worker must survive
        # the same store death the parent does
        if len(store_eps) > 1:
            argv += ["--store-endpoints", ",".join(store_eps)]
        else:
            argv += ["--store-endpoint", store_eps[0]]
        argv += ["--weights-from-store"]
        if weights_name:
            argv += ["--weights-name", str(weights_name)]
        if spool_dir:
            argv += ["--weights-spool", str(spool_dir)]
    return argv


class ProcessWorkerSpawner:
    """Spawns ``llmctl fleet worker`` OS processes for scale-up.

    ``argv_base`` is the full worker command line MINUS ``--replica-id``
    and ``--port`` (both appended per spawn; ``--port 0`` asks the
    worker to bind an ephemeral port and print it). The spawner scans
    the child's stdout for the ready line and returns the live
    endpoint, or ``None`` when the worker dies or stays silent past
    ``spawn_timeout_s`` — the autoscaler counts that as a spawn
    failure and rolls back.
    """

    READY_RE = re.compile(r"LLMCTL_WORKER_READY port=(\d+)")

    def __init__(self, argv_base: list, host: str = "127.0.0.1",
                 spawn_timeout_s: float = 30.0, store_endpoints=()):
        self.argv_base = list(argv_base)
        self.host = host
        self.spawn_timeout_s = float(spawn_timeout_s)
        # store tier the spawned worker will bootstrap from: spawn()
        # gates on its readiness (/health leaving 503 "starting")
        # instead of letting the worker burn its spawn timeout against
        # a store still scanning its disk tier
        self.store_endpoints = list(store_endpoints or ())
        self._procs: dict[int, object] = {}

    def spawn(self, replica_id: int) -> Optional[str]:
        import subprocess
        if self.store_endpoints:
            from .store_tier import wait_store_ready
            if not wait_store_ready(self.store_endpoints,
                                    timeout_s=self.spawn_timeout_s):
                logger.warning(
                    "worker %d not spawned: store tier %s never became "
                    "ready", replica_id, ",".join(self.store_endpoints))
                return None
        argv = self.argv_base + ["--replica-id", str(replica_id),
                                 "--port", "0"]
        try:
            proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            logger.warning("worker spawn failed to exec: %s", e)
            return None
        ready = threading.Event()
        box: dict[str, int] = {}

        def _scan():
            # runs past the ready line too: a child blocking on a full
            # stdout pipe would look exactly like a hang
            for line in proc.stdout:
                m = self.READY_RE.search(line)
                if m and not ready.is_set():
                    box["port"] = int(m.group(1))
                    ready.set()

        t = threading.Thread(target=_scan, daemon=True,
                             name=f"llmctl-spawn-scan-{replica_id}")
        t.start()
        if not ready.wait(self.spawn_timeout_s):
            logger.warning("worker %d never printed its ready line within "
                           "%.1fs; killing it", replica_id,
                           self.spawn_timeout_s)
            try:
                proc.terminate()
                proc.wait(timeout=5.0)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
            return None
        self._procs[replica_id] = proc
        return f"http://{self.host}:{box['port']}"

    def retire(self, replica_id: int) -> None:
        proc = self._procs.pop(replica_id, None)
        if proc is None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=5.0)
        except Exception:
            try:
                proc.kill()
            except Exception:
                pass

    def shutdown(self) -> None:
        for rid in list(self._procs):
            self.retire(rid)


class FleetAutoscaler:
    """Scale/preemption decisions from one supervisor-poll vantage.

    Holds the elastic state machine (streaks, cooldown, the single
    in-flight retirement) plus the counters the snapshot/metrics
    surface reports. The fleet facade owns the mechanics (spawn, wire,
    release); this class owns only *when* and *which*.
    """

    def __init__(self, fleet, cfg: Optional[FleetConfig] = None,
                 spawner: Optional[ProcessWorkerSpawner] = None):
        self.fleet = fleet
        self.cfg = cfg or fleet.fleet_cfg
        self.spawner = spawner
        # the provisioned fleet is the operator's contract: the default
        # ceiling is 2x it, and retirement never eats into the last
        # healthy replica of a provisioned role class
        self._provisioned = int(self.cfg.replicas)
        self._provisioned_roles = list(self.cfg.role_list())
        self._spawned: set[int] = set()     # replica ids we added
        # spawn ids are monotone — never reused after a retire — so a
        # new replica can't collide with a dead sibling's lingering
        # ledger/store state, and ids line up with the fleet's
        # pre-warmed spare pool
        self._next_spawn_id = max(
            (r.replica_id for r in fleet.replicas), default=-1) + 1
        self._up_streak = 0
        self._down_streak = 0
        # born in cooldown: observe steady state for one cooldown window
        # before the first capacity decision — a just-started fleet is
        # idle by construction and would otherwise shed a provisioned
        # replica before the first request lands
        self._cooldown = int(self.cfg.autoscale_cooldown_polls)
        # one retirement in flight at a time: (replica draining) ->
        # DRAINED -> released, or crash/timeout -> rollback
        self._retiring: Optional[int] = None
        self._retire_deadline = 0.0
        self.total_scale_ups = 0
        self.total_scale_downs = 0
        self.total_spawn_failures = 0
        self.total_retire_rollbacks = 0
        self.total_preemptions = 0
        # scaling-event timeline for the bench scenario report: bounded,
        # relative-time stamped records of every action taken
        self.events: deque = deque(maxlen=256)
        self._t0 = time.monotonic()

    # -- bounds --------------------------------------------------------------

    @thread_seam
    def ceiling(self) -> int:
        return int(self.cfg.autoscale_max_replicas) or \
            2 * max(self._provisioned, 1)

    @thread_seam
    def floor(self) -> int:
        return max(int(self.cfg.autoscale_min_replicas), 1)

    def _event(self, kind: str, replica: Optional[int] = None,
               **extra) -> None:
        rec = {"t": round(time.monotonic() - self._t0, 3), "kind": kind}
        if replica is not None:
            rec["replica"] = replica
        rec.update(extra)
        self.events.append(rec)

    # -- the per-poll decision -----------------------------------------------

    @supervisor_thread
    def poll(self, now: Optional[float] = None) -> None:
        """One autoscale pass; called by ``ReplicaSupervisor.poll_once``
        after the rebalancer (so scale decisions see post-rebalance
        load). Preemption runs every poll — an SLO breach must not wait
        out a cooldown; capacity changes are gated behind hysteresis
        and cooldown."""
        now = time.monotonic() if now is None else now
        self._preempt_pass()
        if self._retiring is not None:
            self._advance_retire(now)
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        replicas = self.fleet.replicas
        healthy = [r for r in replicas
                   if r.state == replica_mod.HEALTHY]
        if not healthy:
            self._up_streak = self._down_streak = 0
            return
        pending = self.fleet.router.pending_total()
        per = pending / float(len(healthy))
        queue_pressure = per > self.cfg.autoscale_up_queue_per_replica
        pool_pressure, min_free = self._pool_pressure(healthy)
        if (queue_pressure or pool_pressure) \
                and len(replicas) < self.ceiling():
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= self.cfg.autoscale_hysteresis_polls:
                self._scale_up(
                    reason="queue" if queue_pressure else "pool",
                    free_page_ratio=min_free)
            return
        idle = [r for r in healthy
                if r.queue_depth() == 0 and r.active_count() == 0]
        if per < self.cfg.autoscale_down_queue_per_replica and idle \
                and not pool_pressure \
                and len(healthy) > self.floor():
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= self.cfg.autoscale_hysteresis_polls:
                self._begin_retire(idle, now)
            return
        self._up_streak = 0
        self._down_streak = 0

    @supervisor_thread
    def _pool_pressure(self, healthy: list) -> tuple:
        """KV-pool pressure vote: the MIN free-page ratio across healthy
        replicas against ``autoscale_up_free_page_ratio``. Queue depth
        alone misses page starvation — long residents can pin the pool
        while admission queues stay shallow (every new prompt waits on
        pages, not slots), so pool pressure feeds scale-up alongside
        queue pressure and vetoes scale-down. Replicas without a pool
        surface (stale remote mirrors, test fakes) simply don't vote;
        0 disables the signal. Returns ``(pressured, min_ratio)``."""
        thresh = float(getattr(self.cfg, "autoscale_up_free_page_ratio",
                               0.0) or 0.0)
        if thresh <= 0.0:
            return False, None
        ratios = []
        for r in healthy:
            fn = getattr(r, "pool_free_ratio", None)
            if fn is None:
                continue
            try:
                v = fn()
            except Exception:
                continue
            if v is not None:
                ratios.append(float(v))
        if not ratios:
            return False, None
        lo = min(ratios)
        return lo < thresh, round(lo, 4)

    # -- scale-up ------------------------------------------------------------

    @supervisor_thread
    def _scale_up(self, reason: str = "queue",
                  free_page_ratio=None) -> None:
        self._up_streak = 0
        rid = max(self._next_spawn_id,
                  max((r.replica_id for r in self.fleet.replicas),
                      default=-1) + 1)
        self._next_spawn_id = rid + 1
        endpoint = None
        r = None
        try:
            if self.spawner is not None:
                endpoint = self.spawner.spawn(rid)
                if endpoint is None:
                    raise RuntimeError(
                        f"worker {rid} never reported ready")
                r = self.fleet.spawn_remote_replica(rid, endpoint)
            else:
                r = self.fleet.spawn_engine_replica(rid)
            r.start()
            self.fleet.adopt_replica(r, endpoint=endpoint)
        except Exception as e:
            # degrade contract: a failed spawn is COUNTED and fully
            # rolled back — the fleet never routed to it, so no request
            # is affected
            self.total_spawn_failures += 1
            self._cooldown = int(self.cfg.autoscale_cooldown_polls)
            self._event("spawn_failure", rid, error=str(e)[:200])
            logger.warning("autoscaler: spawn of replica %d failed "
                           "(rolled back): %s", rid, e)
            if self.spawner is not None:
                try:
                    self.spawner.retire(rid)
                except Exception:
                    pass
            if r is not None:
                try:
                    r.stop()
                    engine = getattr(r, "engine", None)
                    if engine is not None:
                        engine.release()
                except Exception:
                    pass
            return
        self._spawned.add(rid)
        self.total_scale_ups += 1
        self._cooldown = int(self.cfg.autoscale_cooldown_polls)
        extra = {"kindof": "remote" if endpoint else "engine",
                 "reason": reason}
        if free_page_ratio is not None:
            extra["free_page_ratio"] = free_page_ratio
        self._event("scale_up", rid, **extra)
        logger.info("autoscaler: scaled UP — replica %d joined (%s, "
                    "%s pressure), fleet now %d", rid,
                    endpoint or "in-proc", reason,
                    len(self.fleet.replicas))

    # -- scale-down ----------------------------------------------------------

    @supervisor_thread
    def _retire_candidate(self, idle: list):
        """Pick the least-valuable idle replica whose departure keeps
        every PROVISIONED role class covered by another healthy
        replica. Autoscaler-spawned replicas retire first (highest id
        first — LIFO keeps the provisioned fleet stable), then
        provisioned ones down to the floor."""
        healthy = [r for r in self.fleet.replicas
                   if r.state == replica_mod.HEALTHY]

        def covered(kind: str, without: int) -> bool:
            return any(r.replica_id != without
                       and getattr(r, "role", ROLE_MIXED)
                       in (kind, ROLE_MIXED) for r in healthy)

        needed = [k for k in (ROLE_PREFILL, ROLE_DECODE)
                  if any(v in (k, ROLE_MIXED)
                         for v in self._provisioned_roles)]
        ranked = sorted(idle, key=lambda r: (
            r.replica_id not in self._spawned, -r.replica_id))
        for r in ranked:
            if all(covered(k, r.replica_id) for k in needed):
                return r
        return None

    @supervisor_thread
    def _begin_retire(self, idle: list, now: float) -> None:
        self._down_streak = 0
        victim = self._retire_candidate(idle)
        if victim is None:
            return
        self._retiring = victim.replica_id
        self._retire_deadline = now + \
            float(self.cfg.autoscale_spawn_timeout_s)
        # drain-with-migration: residents (none, it's idle — but a
        # request may land between our check and the drain flag) move
        # out losslessly, and the prefix inventory flushes to the fleet
        # KV store, so the retiring replica's cache survives it
        victim.request_drain()
        self.fleet.router.invalidate_inventories()
        self._event("retire_begin", victim.replica_id)
        logger.info("autoscaler: scaling DOWN — draining replica %d for "
                    "retirement", victim.replica_id)

    @supervisor_thread
    def _advance_retire(self, now: float) -> None:
        rid = self._retiring
        r = next((x for x in self.fleet.replicas
                  if x.replica_id == rid), None)
        if r is None:                      # already gone (operator?)
            self._retiring = None
            return
        if r.state == replica_mod.DRAINED:
            # the store-flush credit: pages this replica pushed into the
            # fleet KV store at drain — the proof scale-down preserved
            # its cache instead of forcing re-prefills
            flushed = int(getattr(r, "store_flush_pages", 0))
            self.fleet.release_replica(rid)
            if self.spawner is not None and rid in self._spawned:
                try:
                    self.spawner.retire(rid)
                except Exception:
                    pass
            self._spawned.discard(rid)
            self.total_scale_downs += 1
            self._cooldown = int(self.cfg.autoscale_cooldown_polls)
            self._retiring = None
            self._event("scale_down", rid, flushed_pages=flushed)
            logger.info("autoscaler: replica %d retired, fleet now %d",
                        rid, len(self.fleet.replicas))
        elif r.state in (replica_mod.CRASHED, replica_mod.STOPPED):
            # botched retire: the victim died mid-drain. COUNT it and
            # abandon — the supervisor's crash path already requeued its
            # orphans and will restart it; nothing is lost
            self.total_retire_rollbacks += 1
            self._retiring = None
            self._event("retire_rollback", rid, reason=r.state)
            logger.warning("autoscaler: retire of replica %d rolled back "
                           "(%s mid-drain)", rid, r.state)
        elif now > self._retire_deadline:
            # drain stalled (migrations can't land anywhere?) — put the
            # replica back in rotation rather than serve short-handed
            r.undrain()
            self.fleet.router.invalidate_inventories()
            self.fleet.router.flush_parked()
            self.total_retire_rollbacks += 1
            self._retiring = None
            self._event("retire_rollback", rid, reason="drain timeout")
            logger.warning("autoscaler: retire of replica %d rolled back "
                           "(drain timed out); undrained", rid)

    # -- SLO preemption ------------------------------------------------------

    @supervisor_thread
    def _preempt_pass(self) -> None:
        """TTFT guard: for each replica where an interactive request has
        queued past ``interactive_ttft_target_ms``, migrate one resident
        best-effort sequence (KV and all) to the least-loaded sibling —
        the freed slot admits the interactive request next step. Rides
        the existing migration budget so preemptions and rebalances
        can't jointly oversubscribe the courier."""
        target = float(self.cfg.interactive_ttft_target_ms)
        if target <= 0:
            return
        replicas = self.fleet.replicas
        healthy = [r for r in replicas
                   if r.state == replica_mod.HEALTHY]
        if len(healthy) < 2:
            return
        budget = self.cfg.max_concurrent_migrations - sum(
            r.migrations_in_flight() for r in replicas)
        for r in healthy:
            if budget <= 0:
                return
            waitfn = getattr(r, "queued_priority_wait_ms", None)
            if waitfn is None:
                continue
            try:
                wait = waitfn(PROTECTED_CLASS)
            except Exception:
                continue
            if wait <= target:
                continue
            victims = [(vid, rem) for vid, rem, pri
                       in r.resident_requests()
                       if pri == PREEMPTIBLE_CLASS]
            if not victims:
                continue
            dests = sorted(
                (d for d in healthy
                 if d.replica_id != r.replica_id and d.accepting()),
                key=lambda d: (d.outstanding_tokens(), d.replica_id))
            if not dests:
                continue
            # evict the longest-remaining victim: it frees its slot for
            # the longest and is the one most worth finishing elsewhere
            vid = max(victims, key=lambda v: v[1])[0]
            if r.request_migrate(vid, dest=dests[0].replica_id,
                                 reason="preempt"):
                self.total_preemptions += 1
                budget -= 1
                self._event("preempt", r.replica_id, request=vid,
                            dest=dests[0].replica_id,
                            interactive_wait_ms=round(wait, 1))
                logger.info(
                    "autoscaler: preempting best-effort %s off replica "
                    "%d -> %d (interactive queued %.0fms > %.0fms "
                    "target)", vid, r.replica_id, dests[0].replica_id,
                    wait, target)

    # -- introspection -------------------------------------------------------

    @thread_seam
    def reset_counters(self) -> None:
        self.total_scale_ups = 0
        self.total_scale_downs = 0
        self.total_spawn_failures = 0
        self.total_retire_rollbacks = 0
        self.total_preemptions = 0
        self.events.clear()
        self._t0 = time.monotonic()
        # same born-in-cooldown rule as construction: a counter reset
        # marks the start of a measured window — settle first
        self._cooldown = int(self.cfg.autoscale_cooldown_polls)

    @thread_seam
    def snapshot(self) -> dict:
        """Autoscale section of the fleet snapshot — feeds
        /fleet/status, `llmctl fleet status`, the Prometheus pump
        (llmctl_fleet_autoscale_*), and the bench scenario timeline."""
        return {
            "enabled": True,
            "replicas": len(self.fleet.replicas),
            "floor": self.floor(),
            "ceiling": self.ceiling(),
            "cooldown_polls_left": self._cooldown,
            "retiring": self._retiring,
            "spawned": sorted(self._spawned),
            "scale_ups": self.total_scale_ups,
            "scale_downs": self.total_scale_downs,
            "spawn_failures": self.total_spawn_failures,
            "retire_rollbacks": self.total_retire_rollbacks,
            "preemptions": self.total_preemptions,
            "events": list(self.events),
        }
