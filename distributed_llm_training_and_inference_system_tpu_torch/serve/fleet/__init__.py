"""Serve fleet control plane: N engine replicas behind a router.

The port's copy of the JAX package's ``serve/fleet/``, in one process:

- :class:`~.router.FleetRouter` — prefix-affinity consistent hashing +
  least-outstanding-tokens placement, fleet admission (429 + Retry-After)
- :class:`~.replica.EngineReplica` — a threaded engine whose crash and
  drain paths extract in-flight requests instead of failing them
- :class:`~.supervisor.ReplicaSupervisor` — health probes, requeue,
  restart with exponential backoff
- :class:`~.faults.FaultInjector` — deterministic crash / probe-timeout /
  straggler / chunk-chaos injection, drawn as the JAX package draws it
- :class:`~.transport.KVCourier` — every migration, handoff and salvaged
  partial payload crosses the chunked, checksummed, retrying courier
- :class:`~.streams.FleetStreamHub` — exactly-once token streams
- :class:`~.pipeline.PipelineCoordinator` — pipelined prefill over
  replicas (off by default, ``pipeline_prefill_min_tokens = 0``)
- :class:`~.remote.RemoteReplica` — a `llmctl-torch fleet worker`
  process (serve/fleet/worker.py) behind the same duck-typed surface
- :class:`~.state.SharedFileStateStore` and :class:`~.front.FleetFrontTier`
  — the HA front tier: stateless fronts (serve/fleet/http.py) over one
  journal
- :class:`~.kv_store.FleetKVStore` — the tiered host KV store that evicted
  and retired prefix pages demote to; :class:`~.store_service.StoreClient`
  stands in for it when the store runs as `llmctl-torch fleet store`
  processes (``kv_store_endpoint(s)``), which also carry checkpoints for
  :class:`~.weights.WeightCourier`
- :class:`~.autoscaler.FleetAutoscaler` — scale up and down from queue and
  pool pressure, and TTFT-guard preemption, from the supervisor poll
- :class:`ServeFleet` — the facade wiring them together

In-process replicas are threads, each stepping its own ``InferenceEngine``
on one card; their weights are loaded once, by the first in-process
replica, and shared. A remote replica (``FleetConfig.remote_replicas`` +
its ``fleet_endpoints`` entry) is a worker process holding its own weights;
KV payloads reach it over the HTTP courier.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Callable, Optional, Sequence

from ...config.schema import FleetConfig, ModelConfig, ServeConfig
from ..scheduler import Request, SamplingParams
from .autoscaler import (FleetAutoscaler, ProcessWorkerSpawner,
                         synthesize_worker_argv)
from .faults import (DestUnreachable, FaultInjector, FaultPlan,
                     InjectedCrash, ProbeTimeout, RpcBlackhole)
from .front import FleetFrontTier
from .kv_store import FleetKVStore
from .migration import MigrationTicket
from .pipeline import PipelineCoordinator, plan_stages
from .remote import RemoteReplica, RemoteUnavailable
from .replica import (ROLE_DECODE, ROLE_MIXED, ROLE_PREFILL, EngineReplica,
                      reset_for_requeue)
from .router import (FleetRouter, FleetSaturated, normalize_priority,
                     prefix_digest)
from .state import (FleetStateStore, InMemoryStateStore,
                    SharedFileStateStore, StoreFenced, build_state_store)
from .store_service import StoreClient, StoreService
from .streams import FleetStreamHub
from .supervisor import ReplicaSupervisor
from .transport import (KV_STORE_OWNER, CourierReceiver,
                        HTTPCourierTransport, InProcTransport, KVCourier,
                        TransferAborted, TransportError, build_transport,
                        is_ticket_stub, ticket_stub)
from .weights import WeightCourier, WeightShipError

__all__ = [
    "CourierReceiver",
    "DestUnreachable",
    "EngineReplica",
    "FaultInjector",
    "FaultPlan",
    "FleetAutoscaler",
    "FleetFrontTier",
    "FleetKVStore",
    "FleetRouter",
    "FleetSaturated",
    "FleetStateStore",
    "KV_STORE_OWNER",
    "FleetStreamHub",
    "HTTPCourierTransport",
    "InMemoryStateStore",
    "InProcTransport",
    "InjectedCrash",
    "KVCourier",
    "MigrationTicket",
    "PipelineCoordinator",
    "ProbeTimeout",
    "ProcessWorkerSpawner",
    "RemoteReplica",
    "RemoteUnavailable",
    "RpcBlackhole",
    "ROLE_DECODE",
    "ROLE_MIXED",
    "ROLE_PREFILL",
    "ReplicaSupervisor",
    "ServeFleet",
    "SharedFileStateStore",
    "StoreClient",
    "StoreFenced",
    "StoreService",
    "TransferAborted",
    "TransportError",
    "WeightCourier",
    "WeightShipError",
    "build_state_store",
    "build_transport",
    "is_ticket_stub",
    "normalize_priority",
    "plan_stages",
    "prefix_digest",
    "reset_for_requeue",
    "synthesize_worker_argv",
    "ticket_stub",
]

logger = logging.getLogger("llmctl.serve.fleet")

class ServeFleet:
    """N replicas + router + supervisor, ready to serve.

    In-process replicas load or initialise the weights once (the first
    of them) and share them read-only: one copy on the card under N KV
    pools. A quantized serve config quantizes once; the others take that
    quantized model as it is. Remote replicas hold their own weights in
    their own processes; a fleet whose replicas are all remote builds no
    engine and never touches the device.

    ``supervise=True`` runs the supervisor on its own thread;
    ``supervise=False`` leaves probing, requeue and restart to explicit
    ``supervisor.poll_once()`` calls (deterministic tests). ``device``
    is the card by default; tests pass ``"cpu"``."""

    def __init__(self, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 fleet_cfg: Optional[FleetConfig] = None, params=None,
                 fault_plan: Optional[FaultPlan] = None,
                 observer: Optional[Callable[[str, dict], None]] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 supervise: bool = True,
                 front_id: Optional[str] = None, device=None):
        self.fleet_cfg = fleet_cfg or FleetConfig()
        self.fleet_cfg.validate()    # incl. endpoint-map/remote mismatch
        if getattr(serve_cfg, "tensor_parallel", 1) > 1:
            raise NotImplementedError(
                "fleet replicas with tensor_parallel > 1 are not ported to "
                "the PyTorch package yet (ROADMAP queue 1 item 7b)")
        self.serve_cfg = serve_cfg
        self.injector = FaultInjector(fault_plan) if fault_plan else None
        roles = self.fleet_cfg.role_list()
        remote_ids = self.fleet_cfg.remote_replica_ids()
        endpoints = self.fleet_cfg.endpoint_map()
        # every migration / handoff / salvaged-partial payload crosses
        # the chunked, checksummed courier: in-process destinations attach
        # by ticket in this process's receiver, remote ones are pushed over
        # HTTP per the fleet_endpoints map
        self.courier = KVCourier(self.fleet_cfg, injector=self.injector)
        # the tiered KV store: evicted and drain-flushed prefix pages
        # demote here as compressed courier frames, the router's hint path
        # falls back to it, and fetches replay the frames through the
        # courier's receiver. With kv_store_endpoint(s) the store lives in
        # `fleet store` processes and a StoreClient stands in for it, so
        # every front and worker resolve one store.
        store_eps = self.fleet_cfg.kv_store_endpoint_list()
        if store_eps:
            self.kv_store = StoreClient(self.fleet_cfg,
                                        injector=self.injector)
        elif self.fleet_cfg.kv_store:
            self.kv_store = FleetKVStore(self.fleet_cfg)
        else:
            self.kv_store = None
        self.courier.kv_store = self.kv_store
        # checkpoints ride the same store service: ship_weights() lets a
        # bare `fleet worker --weights-from-store` boot over the wire
        self.weight_courier = (
            WeightCourier(self.fleet_cfg, injector=self.injector)
            if store_eps else None)
        # the stream logs and the router ledger live behind this store:
        # in memory by default; `state_store = "file"` shares them between
        # the HA fronts
        self.store = build_state_store(self.fleet_cfg, front_id=front_id)
        self.front_id = self.store.front_id
        # the per-request token logs: every replica a streaming request
        # crosses publishes here with monotonic sequence numbers, and the
        # hub dedupes by sequence, so requeues and migrations are
        # invisible to a stream's reader
        self.streams = FleetStreamHub(
            ttl_ms=self.fleet_cfg.stream_log_ttl_ms,
            max_buffered_batches=self.fleet_cfg
            .stream_max_buffered_batches,
            store=self.store)
        self.courier_receiver = self.courier.receiver
        self.replicas: list = []
        loaded = False
        for i in range(self.fleet_cfg.replicas):
            if i in remote_ids:
                self.replicas.append(RemoteReplica(
                    i, endpoints[i], fleet_cfg=self.fleet_cfg,
                    injector=self.injector,
                    on_finish=self._on_request_exit, role=roles[i]))
                continue
            r = EngineReplica(
                i, model_cfg, serve_cfg, params=params,
                # distinct base seeds so unseeded sampled requests do not
                # mirror each other across replicas
                seed=seed + 1000 * i, injector=self.injector,
                on_finish=self._on_request_exit,
                eos_token_id=eos_token_id,
                fleet_cfg=self.fleet_cfg, role=roles[i], device=device)
            if not loaded:
                # the first in-process replica owns the load (and the
                # quantization): the others take the model it serves
                params = r.engine.params
                model_cfg = r.model_cfg
                loaded = True
            self.replicas.append(r)
        self.model_cfg = model_cfg
        # what the autoscaler needs to build replicas after construction
        self._params = params
        self._seed = seed
        self._eos_token_id = eos_token_id
        self._device = device
        # the page size the engines hash prefixes with; 0 turns the
        # fleet prefix cache off
        page_size = (serve_cfg.kv_block_size
                     if (serve_cfg.prefix_caching
                         and self.fleet_cfg.prefix_fetch) else 0)
        self.router = FleetRouter(self.replicas, self.fleet_cfg,
                                  observer=observer, courier=self.courier,
                                  page_size=page_size, store=self.store,
                                  kv_store=self.kv_store)
        # HA front tier: a terminal record folded from a sibling front
        # completes the local Request object (waiters, SSE finish)
        self.router.on_store_pop = self._complete_from_store
        # the coordinator exists even when gated off (min_tokens=0) so the
        # snapshot and metrics keep one shape
        self.pipeline = PipelineCoordinator(self.fleet_cfg, page_size)
        self.pipeline.bind(self.router, self.replicas, self.courier)
        self.router.pipeline = self.pipeline
        for r in self.replicas:
            self._wire_replica(r)
        # the autoscaler, polled by the supervisor. With
        # autoscale_spawn = "worker" it scales up with `fleet worker`
        # processes whose command line is made from this fleet's config.
        spawner = None
        if self.fleet_cfg.autoscale \
                and self.fleet_cfg.autoscale_spawn == "worker":
            # the worker CLI's --device: "cuda" or "cpu" (a torch.device's
            # type; "cuda:0" is not a choice there)
            dev = str(getattr(device, "type", device) or "cuda").split(":")[0]
            spawner = ProcessWorkerSpawner(
                synthesize_worker_argv(
                    self.model_cfg, self.serve_cfg, self.fleet_cfg,
                    weights_name=self.serve_cfg.model, device=dev),
                spawn_timeout_s=self.fleet_cfg.autoscale_spawn_timeout_s,
                store_endpoints=store_eps)
        self.autoscaler = (FleetAutoscaler(self, self.fleet_cfg,
                                           spawner=spawner)
                           if self.fleet_cfg.autoscale else None)
        self.supervisor = ReplicaSupervisor(
            self.replicas, self.router, self.fleet_cfg,
            injector=self.injector, params=params, observer=observer,
            streams=self.streams, store=self.store,
            kv_store=self.kv_store, pipeline=self.pipeline,
            autoscaler=self.autoscaler, weights=self.weight_courier)
        self._supervise = supervise
        # the warm-spare pool: a background thread builds up to two
        # standby replicas (ids just above the provisioned ones) so that a
        # scale-up adopts one at once instead of building it mid-burst
        self._spares: list = []
        self._spares_pending: set = set()
        self._spares_cv = threading.Condition()
        self._spares_closed = False
        if self.autoscaler is not None and self.autoscaler.spawner is None:
            n = len(self.replicas)
            spare_ids = [n + k for k in range(max(
                min(self.autoscaler.ceiling(), n + 2) - n, 0))]
            if spare_ids:
                self._spares_pending.update(spare_ids)
                threading.Thread(target=self._warm_spares,
                                 args=(spare_ids,), daemon=True,
                                 name="fleet-spare-warmer").start()

    def _wire_replica(self, r) -> None:
        """Attach one replica's fleet-facing callbacks."""
        if getattr(r, "remote", False):
            # multi-front: finished entries for requests another front
            # submitted still close the shared log and ledger; a remote
            # worker publishes its token batches, handoffs and prefix
            # fetches through its outbox and the submit wire
            r.on_foreign = self._on_foreign_finished
            r.on_tokens = self._on_remote_stream_tokens
            return
        r.courier_receiver = self.courier_receiver
        # streaming: the engine's on_token feeds the hub directly
        r.on_token = self._on_stream_tokens
        # disaggregation: a prefill-role replica asks the router for a
        # decode destination before it extracts, then places the handed-
        # off sequence from its engine thread
        r.handoff_dest = self.router.handoff_dest
        r.on_handoff = self._place_handoff
        # prefix fetch: each replica serves its cached pages to the fleet
        # and fetches missing ones through the courier
        self.courier.prefix_providers[r.replica_id] = \
            r.request_prefix_extract
        r.prefix_fetcher = self.courier.fetch_prefix
        # pipelined prefill: stage chunk progress feeds the coordinator
        r.on_pipeline_chunk = self.pipeline.on_stage_chunk
        # the tiered KV store: evicted and retired prefix pages demote
        # down a tier instead of being destroyed
        if self.kv_store is not None:
            r.set_kv_store(self.kv_store)

    # -- elastic membership (the autoscaler's mechanics) ---------------------

    def _build_engine_replica(self, replica_id: int) -> EngineReplica:
        """One in-process replica on the loaded weights, warmed as the JAX
        package warms it (greedy prompts of 8, 16, ... 256 tokens, whose
        pages stay in its prefix cache), with its pass counters reset."""
        r = EngineReplica(
            replica_id, self.model_cfg, self.serve_cfg, params=self._params,
            seed=self._seed + 1000 * replica_id, injector=self.injector,
            on_finish=self._on_request_exit,
            eos_token_id=self._eos_token_id, fleet_cfg=self.fleet_cfg,
            role=ROLE_MIXED, device=self._device)
        n = 8
        while n <= min(256, self.serve_cfg.max_seq_len - 4):
            r.engine.generate([list(range(1, n + 1))],
                              SamplingParams(temperature=0.0, max_tokens=2))
            n <<= 1
        r.engine.total_prefill_tokens = 0
        r.engine.total_decode_steps = 0
        r.engine.total_padded_slot_steps = 0
        r.engine.total_short_dispatches = 0
        return r

    def _warm_spares(self, ids: list) -> None:
        """The background warmer: stock the standby pool once."""
        for rid in ids:
            if self._spares_closed:
                return
            try:
                r = self._build_engine_replica(rid)
            except Exception:
                logger.exception("spare replica %d warm-up failed", rid)
                with self._spares_cv:
                    self._spares_pending.discard(rid)
                    self._spares_cv.notify_all()
                continue
            with self._spares_cv:
                self._spares_pending.discard(rid)
                if self._spares_closed:
                    released = r
                else:
                    self._spares.append(r)
                    released = None
                self._spares_cv.notify_all()
            if released is not None:
                try:
                    released.engine.release()
                except Exception:
                    pass

    def wait_warm_spares(self, timeout_s: float = 300.0) -> bool:
        """Block until the standby pool has finished warming (or the
        timeout passes); True when no warm-up is still in flight."""
        deadline = time.monotonic() + timeout_s
        with self._spares_cv:
            while self._spares_pending and time.monotonic() < deadline:
                self._spares_cv.wait(timeout=1.0)
            return not self._spares_pending

    def spawn_engine_replica(self, replica_id: int) -> EngineReplica:
        """One in-process replica for a scale-up: from the warm-spare pool
        when stocked, else built now. If the warmer is building exactly
        this id, wait for it rather than build a duplicate."""
        deadline = time.monotonic() + 300.0
        with self._spares_cv:
            while replica_id in self._spares_pending \
                    and time.monotonic() < deadline:
                self._spares_cv.wait(timeout=1.0)
            for s in self._spares:
                if s.replica_id == replica_id:
                    self._spares.remove(s)
                    return s
        return self._build_engine_replica(replica_id)

    def spawn_remote_replica(self, replica_id: int,
                             endpoint: str) -> RemoteReplica:
        """The front (neither started nor wired) of a freshly spawned
        `fleet worker` at its discovered endpoint."""
        return RemoteReplica(
            replica_id, endpoint, fleet_cfg=self.fleet_cfg,
            injector=self.injector, on_finish=self._on_request_exit,
            role=ROLE_MIXED)

    def adopt_replica(self, replica, endpoint: Optional[str] = None
                      ) -> None:
        """Join a started replica to the live fleet: its wiring, the
        router's ring and endpoint map, the pipeline's candidates.
        ``self.replicas`` is the list the supervisor iterates, and
        membership changes only on the supervisor thread."""
        self._wire_replica(replica)
        self.replicas.append(replica)
        if endpoint is not None:
            self.fleet_cfg.fleet_endpoints[replica.replica_id] = endpoint
        self.router.add_replica(replica, endpoint=endpoint)
        self.pipeline.bind(self.router, self.replicas, self.courier)

    def release_replica(self, replica_id: int) -> None:
        """Remove a drained replica from the live fleet and free its
        engine (the drain already migrated its residents and flushed its
        prefix inventory to the KV store)."""
        r = next((x for x in self.replicas if x.replica_id == replica_id),
                 None)
        if r is None:
            return
        self.replicas.remove(r)
        self.router.remove_replica(replica_id)
        self.pipeline.bind(self.router, self.replicas, self.courier)
        self.courier.prefix_providers.pop(replica_id, None)
        self.fleet_cfg.fleet_endpoints.pop(replica_id, None)
        self.supervisor.forget(replica_id)
        try:
            r.stop()
        except Exception:
            pass
        engine = getattr(r, "engine", None)
        if engine is not None:
            try:
                engine.release()
            except Exception:
                pass

    def ship_weights(self, name: str = "") -> dict:
        """Register this fleet's loaded weights in the store service (by
        default under the model's name) so `fleet worker
        --weights-from-store` boots over the wire. Idempotent and
        upload-resumable; raises :class:`WeightShipError` naming the
        endpoint when the service is unreachable."""
        if self.weight_courier is None:
            raise RuntimeError(
                "ship_weights needs kv_store_endpoint: no store service is "
                "configured for this fleet")
        if self._params is None:
            raise RuntimeError(
                "ship_weights: this front holds no loaded params (all "
                "replicas remote); ship from the process that loaded them, "
                "or with `fleet ship-weights`")
        return self.weight_courier.ship(name or self.serve_cfg.model,
                                        self._params)

    def _on_request_exit(self, replica_id: int, req: Request) -> None:
        self.router.on_request_exit(replica_id, req)

    def _on_stream_tokens(self, replica_id: int, req: Request,
                          tokens: list) -> None:
        self.streams.publish_from_request(req, tokens, replica=replica_id)

    def _on_remote_stream_tokens(self, replica_id: int, request_id: str,
                                 start: int, tokens: list) -> None:
        self.streams.publish(request_id, start, tokens,
                             replica=replica_id)

    # -- HA front tier seams -------------------------------------------------

    def _on_foreign_finished(self, replica_id: int, entry: dict) -> None:
        """A worker's finished entry for a request another front submitted
        (the outbox drains to whichever front polls first): final-sync
        and finish the shared stream log, then close the shared ledger.
        The journaled pop record carries the terminal tokens, so the
        owning front folds it and completes its local waiter."""
        rid = str(entry.get("request_id", ""))
        if not rid:
            return
        tokens = [int(t) for t in entry.get("generated_tokens", [])]
        if self.streams.has(rid):
            self.streams.sync(rid, tokens, replica=replica_id)
            self.streams.finish(rid, entry.get("finish_reason"),
                                entry.get("error"))
        self.router.foreign_exit(rid, entry, replica_id)

    def _complete_from_store(self, rid: str, rec: dict) -> None:
        """Folded terminal ledger record: if this front still holds the
        Request object (it submitted it; the finish drained elsewhere),
        complete it so HTTP waiters and SSE finish frames resolve."""
        for r in self.replicas:
            fn = getattr(r, "complete_foreign", None)
            if fn is not None and fn(rid, rec):
                return

    def _place_handoff(self, replica_id: int, req: Request,
                       dest: Optional[int]) -> None:
        self.router.place_handoff(req, from_replica=replica_id, dest=dest)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for r in self.replicas:
            r.start()
        if self._supervise:
            self.supervisor.start()

    def shutdown(self) -> None:
        """Stop the supervisor, spawned workers and every engine thread,
        and release the engines' weights references and KV pools (the
        unadopted spares' too)."""
        self.supervisor.stop()
        if self.autoscaler is not None \
                and self.autoscaler.spawner is not None:
            self.autoscaler.spawner.shutdown()
        with self._spares_cv:
            self._spares_closed = True
            spares, self._spares = self._spares, []
            self._spares_pending.clear()
            self._spares_cv.notify_all()
        for s in spares:
            try:
                s.engine.release()
            except Exception:
                pass
        for r in self.replicas:
            r.stop()
            engine = getattr(r, "engine", None)   # remote: no engine here
            if engine is not None:
                try:
                    engine.release()
                except Exception:
                    pass

    # -- serving -------------------------------------------------------------

    def submit(self, prompt_tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               on_complete: Optional[Callable[[Request], None]] = None,
               priority: str = "standard") -> Request:
        return self.router.submit(prompt_tokens, sampling,
                                  request_id=request_id,
                                  on_complete=on_complete,
                                  priority=priority)

    def submit_streaming(self, prompt_tokens: Sequence[int],
                         sampling: Optional[SamplingParams] = None,
                         request_id: Optional[str] = None,
                         on_complete: Optional[Callable[[Request], None]]
                         = None, priority: str = "standard") -> Request:
        """Admit one streaming request: its token batches flow through the
        stream hub (``self.streams``) with monotonic sequence numbers
        across every re-placement. The log opens before placement, so no
        producer can race the first token past it; a rejected submission
        tears it down. The hub finishes the log on the request's terminal
        state before the caller's ``on_complete`` fires."""
        rid = request_id or f"fleet-{uuid.uuid4().hex[:24]}"
        self.streams.open(rid)

        def _complete(req: Request) -> None:
            meta = getattr(req, "fleet_meta", {}) or {}
            self.streams.finish_from_request(req,
                                             replica=meta.get("replica"))
            if on_complete is not None:
                on_complete(req)

        try:
            return self.router.submit(prompt_tokens, sampling,
                                      request_id=rid,
                                      on_complete=_complete, stream=True,
                                      priority=priority)
        except Exception:
            self.streams.discard(rid)
            raise

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None,
                 timeout_s: float = 300.0) -> list[Request]:
        """Submit every prompt and wait for terminal states. Without a
        supervisor thread the wait polls the supervisor, so crash and
        drain recovery still happen, deterministically, on this
        thread."""
        events: list[threading.Event] = []
        reqs: list[Request] = []
        for p in prompts:
            ev = threading.Event()
            reqs.append(self.submit(p, sampling,
                                    on_complete=lambda _r, ev=ev: ev.set()))
            events.append(ev)
        deadline = time.monotonic() + timeout_s
        for ev in events:
            while not ev.wait(timeout=0.02):
                if not self._supervise:
                    self.supervisor.poll_once()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet generate: {sum(not e.is_set() for e in events)}"
                        f" of {len(events)} requests still pending")
        return reqs

    # -- operator surface ----------------------------------------------------

    def drain(self, replica_id: int) -> bool:
        return self.supervisor.drain(replica_id)

    def undrain(self, replica_id: int) -> bool:
        return self.supervisor.undrain(replica_id)

    def migrate(self, request_id: str, dest_replica: int) -> bool:
        """Move one in-flight request to ``dest_replica`` with its KV
        pages (no re-prefill)."""
        return self.supervisor.migrate(request_id, dest_replica)

    def set_role(self, replica_id: int, role: str) -> bool:
        """Re-role one replica (prefill|decode|mixed)."""
        return self.supervisor.set_role(replica_id, role)

    def status(self) -> dict:
        return self.supervisor.snapshot()

    def serve_prefix_fetch(self, body: dict) -> dict:
        """Owner side of ``POST /fleet/courier/fetch`` when the owning
        replica runs in this process: extract the cached prefix pages (on
        that replica's engine thread) and push them, chunked, to the
        remote fetcher's courier endpoint."""
        try:
            owner = int(body.get("replica", -1))
            hashes = [bytes.fromhex(h) for h in body.get("hashes", [])]
        except (TypeError, ValueError):
            return {"ok": False, "error": "malformed replica/hashes"}
        ticket = str(body.get("ticket") or "")
        dest_ep = str(body.get("dest_endpoint") or "").rstrip("/")
        if not hashes or not ticket or not dest_ep:
            return {"ok": False, "error":
                    "body must be {replica, hashes, ticket, dest_endpoint}"}
        provider = self.courier.prefix_providers.get(owner)
        if provider is None:
            return {"ok": False,
                    "error": f"no in-proc replica {owner} here"}
        payload = provider(hashes, self.fleet_cfg.prefix_fetch_timeout_s)
        if not payload:
            return {"ok": False, "error": "prefix pages not cached"}
        transport = HTTPCourierTransport(
            self.fleet_cfg, injector=self.injector,
            stats=self.courier.stats, endpoint=dest_ep)
        try:
            transport.transfer(payload, src=owner,
                               dest=body.get("dest"), ticket=ticket)
        except TransportError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "ticket": ticket,
                "covered": int(payload["pages"]["num_pages"])}
