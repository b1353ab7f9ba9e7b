"""Pipelined multi-replica prefill: one long prompt, many prefill stages.

A 100k-token prompt used to prefill on ONE replica, stalling that
replica's co-resident decodes for the whole duration — the prefill/
decode interference DistServe warns about, recreated at the pool level.
Mooncake's chunked pipeline parallelism (PAPERS.md) is the fix this
module implements over seams that already exist:

- the router plans an ordered stage list over prefill-capable replicas
  and splits the prompt at page-aligned boundaries (:func:`plan_stages`);
- stage k is a synthetic ``Request`` (``req.pipeline_stage`` manifest)
  submitted straight to its replica, where the ordinary chunked-prefill
  engine path computes token-chunk k against the shipped-in KV of
  chunks < k (imported through the same ``insert_prefix_pages`` plane a
  prefix fetch uses) and publishes each finished full page immediately;
- while the stage's later chunks compute, the coordinator pre-ships the
  published pages to the next stage's replica over the standard CRC'd
  courier — transfer hides behind compute instead of serializing
  (counted: ``preship_hidden_ms`` vs ``preship_ms``);
- the final stage is the ORIGINAL request, placed on the last replica
  with a prefix hint at its predecessor: it pins the shipped chain,
  computes only the last chunk, and samples its first token with the
  same position-folded key a single-replica prefill would have used —
  token-identical, greedy and seeded. Decode handoff, streaming, and
  the router ledger all see a perfectly ordinary request.

Degrade contract, same as every fleet plane: ANY stage failure (replica
crash, chunk chaos on the courier, pool-full, timeout) collapses the
pipeline to a counted single-replica prefill. Stages only ever produce
prefix-cache pages, so a lost stage costs recompute, never wrong
tokens — and chunks that DID finish before the collapse are usually
recovered through the ordinary placement-time prefix hint.

Stage requests bypass the router ledger entirely (submitted directly to
replicas); the ledger sees only the original request, so
``completed + failed + rejected == submitted`` holds with pipelining on.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Optional

from ...analysis.annotations import engine_thread_only, thread_seam
from ...config.schema import FleetConfig
from ..scheduler import Request, RequestState, SamplingParams

logger = logging.getLogger("llmctl.serve.fleet.pipeline")


def plan_stages(n_tokens: int, page_size: int, n_replicas: int,
                min_tokens: int, max_stages: int) -> Optional[list[int]]:
    """Page-aligned cumulative stage boundaries for one prompt, or None
    when pipelining shouldn't engage.

    Returns ``[b_1, ..., b_{S-1}, n_tokens]``: stage k computes tokens
    ``[b_{k-1}, b_k)``. Every non-final boundary is a page multiple (only
    FULL pages are shareable between replicas) and leaves at least one
    token for the final stage (the last context token must be
    re-processed to produce the first output logits — the same ``usable``
    bound the prefix-fetch path enforces). Engages only when the prompt
    clears ``min_tokens``, at least two stages fit, and every stage gets
    at least one full page of work."""
    if min_tokens <= 0 or page_size <= 0 or n_tokens < min_tokens:
        return None
    S = min(int(max_stages), int(n_replicas))
    if S < 2:
        return None
    full = (n_tokens - 1) // page_size     # stageable full pages
    if full < S:
        return None                        # < 1 page of work per stage
    per = full // S
    bounds = [per * (k + 1) * page_size for k in range(S - 1)]
    bounds.append(n_tokens)                # final: remaining pages + tail
    return bounds


class _Pipe:
    """One in-flight pipeline: the original request, its plan, and the
    event queue the engine-side hooks feed (chunk progress, stage exits,
    orphan notices — all enqueue-only, drained by the pipeline thread)."""

    def __init__(self, req: Request, bounds: list[int], reps: list,
                 hashes: list):
        self.req = req
        self.bounds = bounds
        self.reps = reps
        self.hashes = hashes          # full-page chain of the whole prompt
        self.events: queue.Queue = queue.Queue()
        self.stage_rids: dict[int, str] = {}   # stage k -> request_id


class PipelineCoordinator:
    """Plans and drives pipelined prefills; owns the pipeline counters.

    Constructed by ``ServeFleet`` before the router (the router's submit
    path delegates to :meth:`try_launch`), then bound to the live
    router/replica/courier objects once they exist. Each launched
    pipeline runs on its own daemon thread: stages are sequential (chunk
    k's attention needs chunks < k), the pre-ship of published pages to
    the next replica is what overlaps with compute."""

    def __init__(self, cfg: FleetConfig, page_size: int):
        self.cfg = cfg
        self.page_size = page_size
        self.router = None            # bound by ServeFleet post-construction
        self.replicas: list = []
        self.courier = None
        self._lock = threading.Lock()
        self._pipes: dict[str, _Pipe] = {}
        # running totals (metrics/names.py COUNTER_FLOW)
        self.total_pipelines = 0
        self.total_pipelines_completed = 0
        self.total_pipeline_collapses = 0
        self.total_pipeline_stages = 0
        self.total_preshipped_pages = 0
        # pre-ship import half timed out on the destination's engine
        # thread (the bench-host gap PR 14 found): the pages shipped but
        # never attached, so the next stage falls back to its own fetch.
        # Counted apart from generic fetch misses — a busy destination
        # engine is a different disease than a cold cache.
        self.total_pipeline_preship_timeouts = 0
        self.total_preship_ms = 0.0
        self.total_preship_hidden_ms = 0.0
        self._stage_ms: deque = deque(maxlen=256)
        self._stage_count = 0

    # -- wiring --------------------------------------------------------------

    def bind(self, router, replicas, courier) -> None:
        self.router = router
        self.replicas = list(replicas)
        self.courier = courier

    @property
    def enabled(self) -> bool:
        return (self.cfg.pipeline_prefill_min_tokens > 0
                and self.page_size > 0 and self.router is not None)

    # -- launch (router submit path) -----------------------------------------

    def stage_candidates(self) -> list:
        """Prefill-capable, accepting, IN-PROCESS replicas, least loaded
        first. Remote workers are excluded from stage duty: the pre-ship
        import half runs through this process's replica objects (the
        documented gap — a remote stage would need the import verb on
        the worker surface)."""
        from .replica import ROLE_DECODE
        out = []
        for r in self.replicas:
            if getattr(r, "remote", False):
                continue
            try:
                if not r.accepting():
                    continue
            except Exception:
                continue
            if getattr(r, "role", None) == ROLE_DECODE:
                continue
            out.append(r)
        out.sort(key=lambda r: (r.outstanding_tokens(), r.replica_id))
        return out

    def try_launch(self, req: Request) -> bool:
        """Plan and launch a pipeline for ``req`` if it qualifies. True
        means the coordinator now owns the request's placement: its
        pipeline thread will either place it on the final stage replica
        or collapse to an ordinary placement — the router's submit path
        must not also place it."""
        if not self.enabled or req.swapped_kv is not None:
            return False
        n = len(req.prompt_tokens)
        cands = self.stage_candidates()
        bounds = plan_stages(n, self.page_size, len(cands),
                             self.cfg.pipeline_prefill_min_tokens,
                             self.cfg.pipeline_prefill_max_stages)
        if bounds is None:
            return False
        from ..kv_cache import prefix_page_hashes
        hashes = prefix_page_hashes(req.prompt_tokens, self.page_size)
        pipe = _Pipe(req, bounds, cands[:len(bounds)], hashes)
        with self._lock:
            self.total_pipelines += 1
            self.total_pipeline_stages += len(bounds)
            self._pipes[req.request_id] = pipe
        threading.Thread(target=self._run, args=(pipe,), daemon=True,
                         name=f"pipeline-{req.request_id[:16]}").start()
        logger.info(
            "pipelined prefill %s: %d tokens over %d stage(s) on "
            "replicas %s", req.request_id, n, len(bounds),
            [r.replica_id for r in pipe.reps])
        return True

    # -- engine-side notifications (enqueue only) ----------------------------

    @engine_thread_only
    def on_stage_chunk(self, replica_id: int, req: Request, done: int,
                       finished: bool) -> None:
        """Replica ``on_pipeline_chunk`` hook: a stage request advanced
        one chunk (its full pages are published). Engine thread, no
        locks may be taken beyond the coordinator's own."""
        stage = getattr(req, "pipeline_stage", None)
        if not stage:
            return
        with self._lock:
            pipe = self._pipes.get(stage.get("origin"))
        if pipe is not None:
            pipe.events.put(("chunk", int(stage.get("stage", -1)),
                             int(done), bool(finished)))

    @engine_thread_only
    def stage_exited(self, replica_id: int, req: Request) -> None:
        """Router ``on_request_exit`` delegation for stage requests: the
        stage reached a terminal state (finished, failed, cancelled)."""
        stage = getattr(req, "pipeline_stage", None)
        if not stage:
            return
        with self._lock:
            pipe = self._pipes.get(stage.get("origin"))
        if pipe is not None:
            pipe.events.put(("exit", int(stage.get("stage", -1)),
                             req.finish_reason or "",
                             req.state is not RequestState.FINISHED))

    @thread_seam
    def stage_orphaned(self, req: Request) -> None:
        """A stage request came back as a crash/drain orphan (router
        requeue path): stages are never re-placed — the pipeline
        collapses instead."""
        stage = getattr(req, "pipeline_stage", None)
        if not stage:
            return
        with self._lock:
            pipe = self._pipes.get(stage.get("origin"))
        if pipe is not None:
            pipe.events.put(("exit", int(stage.get("stage", -1)),
                             "orphaned", True))

    # -- pipeline thread -----------------------------------------------------

    def _run(self, pipe: _Pipe) -> None:
        req = pipe.req
        try:
            ok = True
            for k in range(len(pipe.bounds) - 1):
                if not self._run_stage(pipe, k):
                    ok = False
                    break
            if ok:
                ok = self._place_final(pipe)
                if ok:
                    with self._lock:
                        self.total_pipelines_completed += 1
        except Exception:
            logger.exception("pipelined prefill %s failed; collapsing",
                             req.request_id)
            ok = False
        finally:
            # stop routing events to a finished pipeline BEFORE the
            # collapse placement, so a late stage exit can't race it
            with self._lock:
                self._pipes.pop(req.request_id, None)
        if not ok:
            self._collapse(pipe)

    def _stage_request(self, pipe: _Pipe, k: int) -> Request:
        req = pipe.req
        b = pipe.bounds[k]
        sreq = Request(
            request_id=f"{req.request_id}::stage{k}",
            prompt_tokens=list(req.prompt_tokens[:b]),
            # max_tokens=1 keeps the admission tail reservation minimal;
            # a stage never decodes
            sampling=SamplingParams(temperature=0.0, max_tokens=1),
            pipeline_stage={"origin": req.request_id, "stage": k,
                            "stages": len(pipe.bounds), "bound": b})
        sreq.prefix_hashes = pipe.hashes[:b // self.page_size]
        if k > 0:
            # anything the pre-ship didn't deliver in time is pulled by
            # the stage's own prefill-time prefix fetch from its
            # predecessor — the ordinary fetch plane, chaos and all
            sreq.prefix_owner = pipe.reps[k - 1].replica_id
        pipe.stage_rids[k] = sreq.request_id
        return sreq

    def _run_stage(self, pipe: _Pipe, k: int) -> bool:
        rep, nxt = pipe.reps[k], pipe.reps[k + 1]
        bound_pages = pipe.bounds[k] // self.page_size
        sreq = self._stage_request(pipe, k)
        t0 = time.perf_counter()
        if not rep.submit(sreq):
            logger.warning("pipelined prefill %s: stage %d rejected by "
                           "replica %d", pipe.req.request_id, k,
                           rep.replica_id)
            return False
        deadline = time.monotonic() + (
            self.cfg.pipeline_prefill_stage_timeout_ms / 1e3)
        # pages known present on `rep` before it computes anything: what
        # the previous stage's pre-ship + completion left there
        avail = pipe.bounds[k - 1] // self.page_size if k > 0 else 0
        sent = 0
        finished = False
        preship_dead = False
        while True:
            if sent < avail and not preship_dead:
                got = self._preship(rep, nxt, pipe.hashes[sent:avail],
                                    hidden=not finished)
                if got <= 0:
                    # pre-ship broke (chaos, dry pool, owner eviction):
                    # stop shipping — the next stage's own fetch covers
                    # the gap, degrade never wrong
                    preship_dead = True
                else:
                    sent += got
                continue
            if finished:
                with self._lock:
                    self._stage_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                    self._stage_count += 1
                return True
            wait = deadline - time.monotonic()
            if wait <= 0:
                logger.warning(
                    "pipelined prefill %s: stage %d timed out after "
                    "%.0f ms", pipe.req.request_id, k,
                    self.cfg.pipeline_prefill_stage_timeout_ms)
                return False
            try:
                ev = pipe.events.get(timeout=min(wait, 0.05))
            except queue.Empty:
                continue
            kind, stage_k = ev[0], ev[1]
            if stage_k != k:
                continue               # stale event from a prior stage
            if kind == "chunk":
                done, fin = ev[2], ev[3]
                avail = max(avail, min(done // self.page_size,
                                       bound_pages))
                finished = finished or fin
            elif kind == "exit":
                reason, failed = ev[2], ev[3]
                if failed or reason != "pipeline_stage":
                    logger.warning(
                        "pipelined prefill %s: stage %d exited (%s)",
                        pipe.req.request_id, k, reason or "failed")
                    return False
                finished = True
                avail = bound_pages

    def _preship(self, src, dest, hashes: list, hidden: bool) -> int:
        """Ship published pages ``hashes`` src -> dest over the courier
        (extract on the source's engine thread, CRC'd chunk transfer,
        import on the destination's engine thread). Returns the number
        of chain pages now confirmed at the destination, or <= 0 on any
        failure. ``hidden`` marks transfers that overlapped stage
        compute — the overlap-ratio numerator."""
        if not hashes:
            return 0
        t0 = time.perf_counter()
        delivered = 0
        import_timed_out = False
        try:
            if self.courier is not None:
                payload = self.courier.fetch_prefix(
                    dest.replica_id, src.replica_id, None, list(hashes))
            else:
                payload = src.request_prefix_extract(list(hashes))
            if payload:
                hx = payload.get("hashes") or []
                pages = payload.get("pages")
                hb = [bytes.fromhex(h) if isinstance(h, str) else h
                      for h in hx]
                # chain consistency: accept only a PREFIX of what was
                # asked (same rule as the engine's fetch import)
                j = 0
                while j < min(len(hb), len(hashes)) \
                        and hb[j] == hashes[j]:
                    j += 1
                if j > 0 and isinstance(pages, dict):
                    if j < len(hb):
                        from ..kv_cache import slice_page_payload
                        pages = slice_page_payload(pages, j)
                    if dest.request_prefix_import(hb[:j],
                                                  pages) is not None:
                        delivered = j
                    else:
                        import_timed_out = True
        except Exception as e:     # TransferAborted + wire surprises
            logger.warning(
                "pipeline pre-ship %d -> %d aborted (%s); next stage "
                "falls back to its own fetch", src.replica_id,
                dest.replica_id, e)
            delivered = 0
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.total_preship_ms += ms
            if hidden:
                self.total_preship_hidden_ms += ms
            if delivered > 0:
                self.total_preshipped_pages += delivered
            if import_timed_out:
                self.total_pipeline_preship_timeouts += 1
        return delivered

    def _place_final(self, pipe: _Pipe) -> bool:
        """The final stage IS the original request: place it on the last
        planned replica with a prefix hint at its predecessor — it pins
        the shipped chain, computes only the last chunk, and samples
        token-identically (the first-token key folds by the FULL context
        length, placement-independent)."""
        req = pipe.req
        req.prefix_hashes = list(pipe.hashes)
        req.prefix_owner = pipe.reps[-2].replica_id
        req.prefix_owner_endpoint = None
        return self.router.place_pipeline_final(
            req, dest=pipe.reps[-1].replica_id)

    def _collapse(self, pipe: _Pipe) -> None:
        """Degrade to single-replica prefill: cancel whatever stages are
        still running and hand the ORIGINAL request to the ordinary
        placement path. Completed chunks usually survive as prefix-cache
        pages and are recovered through the placement-time hint; a total
        placement outage fails the request through the ledger so the
        fleet arithmetic stays balanced."""
        req = pipe.req
        with self._lock:
            self.total_pipeline_collapses += 1
        for k, rid in pipe.stage_rids.items():
            try:
                pipe.reps[k].cancel(rid)
            except Exception:
                pass
        req.prefix_owner = None
        req.prefix_owner_endpoint = None
        logger.warning("pipelined prefill %s collapsed to single-replica "
                       "prefill", req.request_id)
        if not self.router.place_pipeline_final(req, dest=None):
            self.router.pipeline_abandon(
                req, "pipelined prefill collapsed and no replica "
                     "accepted the fallback placement")

    # -- introspection -------------------------------------------------------

    def reset_counters(self) -> None:
        """Zero the running totals (bench A/B laps: the warm lap compiles
        every stage bucket, then the measured lap starts from a clean
        ledger). In-flight pipelines are untouched."""
        with self._lock:
            self.total_pipelines = 0
            self.total_pipelines_completed = 0
            self.total_pipeline_collapses = 0
            self.total_pipeline_stages = 0
            self.total_preshipped_pages = 0
            self.total_pipeline_preship_timeouts = 0
            self.total_preship_ms = 0.0
            self.total_preship_hidden_ms = 0.0
            self._stage_ms.clear()
            self._stage_count = 0

    def snapshot(self) -> dict:
        """Counter snapshot for the supervisor / Prometheus pump (running
        totals plus the bounded recent stage-latency window)."""
        with self._lock:
            return {
                "pipelines": self.total_pipelines,
                "completed": self.total_pipelines_completed,
                "collapses": self.total_pipeline_collapses,
                "stages": self.total_pipeline_stages,
                "preshipped_pages": self.total_preshipped_pages,
                "preship_timeouts":
                    self.total_pipeline_preship_timeouts,
                "preship_ms": round(self.total_preship_ms, 3),
                "preship_hidden_ms": round(self.total_preship_hidden_ms,
                                           3),
                "overlap_ratio": (
                    round(self.total_preship_hidden_ms
                          / self.total_preship_ms, 4)
                    if self.total_preship_ms > 0 else None),
                "in_flight": len(self._pipes),
                "stage_ms": list(self._stage_ms),
                "stage_count": self._stage_count,
            }
