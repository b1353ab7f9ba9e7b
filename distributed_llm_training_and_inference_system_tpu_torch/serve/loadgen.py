"""Load generation for one inference engine or a fleet (the JAX package's
``serve/loadgen.py``).

Drives ``InferenceEngine.step()`` directly (no HTTP), so the numbers are the
engine's, not a web stack's:

- ``run_poisson``: open loop. Arrivals follow a seeded Poisson process of
  rate ``offered_rps`` whatever the engine's progress; the engine steps
  until every admitted request has finished, so late arrivals' tails count.
- ``run_closed_loop``: ``concurrency`` requests in flight, a new one the
  moment one finishes (the saturation probe).

Prompts and arrival gaps come from ``numpy.random.default_rng(seed)`` in
the JAX module's order of draws, so both packages offer the same requests.
Every request is greedy. ``LoadResult.summary()`` reports p50/p99 TTFT
(arrival to first token), p50/p99 TPOT ((finish - first token) / (n - 1)),
goodput (completed tokens over the wall), preemptions and the queue's
high-water mark; ``device_times=True`` adds the TTFT a co-located client
would see (queue wait + the bucket's on-device prefill,
``engine.measure_device_times``).

A ``ServeFleet`` target (``serve/fleet/``) is driven through its router:
the replica threads step, the generator submits on schedule, polls the
supervisor when no supervisor thread runs, and the result carries the
per-replica breakdown, requeues, migrations, handoffs, the courier and
prefix-fetch ledgers, the streaming client's exactly-once readout
(``stream=True``) and the pipelined-prefill readout (``long_prompts``).

``FrontStreamClient`` and ``run_stream_fronts`` drive an HA front tier
over HTTP: SSE streams that reconnect to the next front with
``Last-Event-ID`` when theirs dies, counting gaps and duplicates.
``run_returning`` is the fleet KV store's returning-conversation scenario
(warm turn, pool churn, return turn restored from the store), and
``run_scenario`` one cell of the autoscaler's scenario matrix (diurnal,
flash-crowd, phase-shift, returning-churn, long-context) with per-SLO-class
attainment and the scaling events.
"""

from __future__ import annotations

import threading as _threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .scheduler import Request, RequestState, SamplingParams

@dataclass
class LoadResult:
    offered_rps: float
    completed: int = 0
    failed: int = 0
    duration_s: float = 0.0
    ttft_ms: list = field(default_factory=list)
    # queue wait + the on-device prefill of the request's bucket
    ttft_device_ms: list = field(default_factory=list)
    tpot_ms: list = field(default_factory=list)
    preemptions: int = 0
    queue_peak: int = 0
    goodput_tokens_per_s: float = 0.0
    decode_ms_per_token_device: Optional[float] = None
    # fleet targets only: 429-rejected submissions, cross-replica requeues
    # and the per-replica breakdown {rid: {requests, p50/p99_ttft_ms,
    # requeues}}
    rejected: int = 0
    requeues: int = 0
    per_replica: dict = field(default_factory=dict)
    # Retry-After resubmissions (``rejected`` then counts final ones)
    retries: int = 0
    # sequences moved with their pages, and prefill tokens the fleet did
    # not compute again
    migrations: int = 0
    migrated_tokens: int = 0
    reprefill_tokens_avoided: int = 0
    # disaggregated prefill/decode: handoffs, local-decode fallbacks and
    # the per-phase breakdown
    handoffs: int = 0
    handoffs_local: int = 0
    phases: dict = field(default_factory=dict)
    # the KV courier: transfers, chunks, retries, aborts, wire bytes and
    # transfer-time percentiles
    courier: dict = field(default_factory=dict)
    # the fleet prefix cache: pages fetched from sibling replicas
    prefix_fetch: dict = field(default_factory=dict)
    # streaming client mode: streamed-token identity against the final
    # completion, gaps and duplicates (0 both), delivery-gap percentiles
    stream: dict = field(default_factory=dict)
    # the returning-conversation scenario (run_returning): warm-turn and
    # return-turn TTFT, the prefill tokens the return turns spent, their
    # tokens; and the fleet KV store's counters
    returning: dict = field(default_factory=dict)
    kv_store: dict = field(default_factory=dict)
    # pipelined prefill: stage counts, overlap, the long/short split and
    # every request's tokens in submission order
    pipeline: dict = field(default_factory=dict)
    # the scenario matrix (run_scenario): per-SLO-class attainment, the
    # autoscaler's events, plan-order tokens
    scenario: dict = field(default_factory=dict)

    def percentile(self, xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")

    def summary(self) -> dict:
        return {
            # None for closed-loop runs (offered load is "as fast as the
            # engine finishes"); inf would serialise as non-standard JSON
            "offered_rps": (round(self.offered_rps, 3)
                            if np.isfinite(self.offered_rps) else None),
            "completed": self.completed,
            "failed": self.failed,
            "duration_s": round(self.duration_s, 2),
            "p50_ttft_ms": round(self.percentile(self.ttft_ms, 50), 1),
            "p99_ttft_ms": round(self.percentile(self.ttft_ms, 99), 1),
            "p50_tpot_ms": round(self.percentile(self.tpot_ms, 50), 2),
            "p99_tpot_ms": round(self.percentile(self.tpot_ms, 99), 2),
            "goodput_tok_s": round(self.goodput_tokens_per_s, 1),
            "preemptions": self.preemptions,
            "queue_peak": self.queue_peak,
            **({"p50_ttft_device_ms":
                round(self.percentile(self.ttft_device_ms, 50), 1),
                "p99_ttft_device_ms":
                round(self.percentile(self.ttft_device_ms, 99), 1),
                "decode_ms_per_token_device":
                round(self.decode_ms_per_token_device, 3)}
               if self.ttft_device_ms else {}),
            **({"rejected": self.rejected, "requeues": self.requeues,
                "retries": self.retries,
                "migrations": self.migrations,
                "migrated_tokens": self.migrated_tokens,
                "reprefill_tokens_avoided": self.reprefill_tokens_avoided,
                "per_replica": self.per_replica}
               if self.per_replica else {}),
            **({"handoffs": self.handoffs,
                "handoffs_local": self.handoffs_local,
                "phases": self.phases}
               if self.phases else {}),
            **({"courier": self.courier} if self.courier else {}),
            **({"prefix_fetch": self.prefix_fetch}
               if self.prefix_fetch else {}),
            **({"stream": self.stream} if self.stream else {}),
            **({"returning": self.returning} if self.returning else {}),
            **({"kv_store": self.kv_store} if self.kv_store else {}),
            **({"pipeline": self.pipeline} if self.pipeline else {}),
            **({"scenario": self.scenario} if self.scenario else {}),
        }


def _finalize(res: LoadResult, reqs: list, engine, t0: float) -> LoadResult:
    res.duration_s = time.monotonic() - t0
    done_tokens = 0
    for r in reqs:
        if r.state is RequestState.FINISHED:
            res.completed += 1
            done_tokens += len(r.generated_tokens)
            if r.ttft_ms is not None:
                res.ttft_ms.append(r.ttft_ms)
            if len(r.generated_tokens) > 1 and r.finish_time is not None \
                    and r.first_token_time is not None:
                res.tpot_ms.append(
                    (r.finish_time - r.first_token_time) * 1000.0
                    / (len(r.generated_tokens) - 1))
        elif r.state in (RequestState.FAILED, RequestState.CANCELLED):
            res.failed += 1
    res.preemptions = engine.total_preemptions
    res.goodput_tokens_per_s = done_tokens / max(res.duration_s, 1e-9)
    return res


def attach_device_times(res: LoadResult, reqs: list, engine) -> LoadResult:
    """Fill ``res.ttft_device_ms`` from a calibration after the run: per
    request, (prefill dispatch - arrival, a host wait) + the on-device
    prefill time of its bucket. Requests without a dense bucket (suffix
    or chunked prefills) are skipped."""
    cal = engine.measure_device_times()
    for r in reqs:
        if (r.state is RequestState.FINISHED
                and r.prefill_dispatch_time is not None
                and r.prefill_bucket in cal["prefill_ms"]):
            queue_ms = (r.prefill_dispatch_time - r.arrival_time) * 1e3
            res.ttft_device_ms.append(
                queue_ms + cal["prefill_ms"][r.prefill_bucket])
    res.decode_ms_per_token_device = cal["decode_ms_per_token"]
    return res


def _is_fleet(target) -> bool:
    """Fleet targets (serve/fleet ServeFleet) quack with a .router; plain
    engines are stepped inline by the generator."""
    return hasattr(target, "router")


class _StreamClient:
    """One streamed request's client-side consumer: subscribes to the
    fleet stream hub, asserts the per-subscriber ordering contract
    (contiguous seqs — any gap or duplicate is counted and would fail
    the run's identity check), and records per-batch delivery times for
    the jitter percentiles. Callbacks arrive on producer threads under
    the hub lock, so this only appends."""

    def __init__(self):
        self.tokens: list[int] = []
        self.next_seq = 0
        self.gaps = 0
        self.dups = 0
        self.batch_times: list[float] = []   # one stamp per batch burst
        self.finished = False
        # set right after subscribe: consumes are instantaneous here, so
        # every delivered batch acks immediately (the backpressure cap
        # is for stalled SSE sockets, not in-process consumers). Safe
        # under the hub lock — it is re-entrant.
        self.acker = None

    def __call__(self, ev):
        if ev[0] == "tokens":
            _kind, start, toks = ev
            if start > self.next_seq:
                self.gaps += 1
            elif start < self.next_seq:
                self.dups += 1
            self.tokens.extend(toks)
            self.next_seq = start + len(toks)
            self.batch_times.append(time.monotonic())
            if self.acker is not None:
                self.acker()
        else:
            self.finished = True

    def delivery_gaps_ms(self) -> list:
        """Inter-batch delivery gaps — the client-observed inter-token
        stall profile (a migration/crash resume shows up as one long
        gap; steady decode as the dispatch cadence)."""
        return [(b - a) * 1e3 for a, b in
                zip(self.batch_times, self.batch_times[1:])]


def _finalize_fleet(res: LoadResult, reqs: list, fleet,
                    t0: float,
                    stream_clients: Optional[dict] = None,
                    long_prompt_len: int = 0) -> LoadResult:
    """Fleet-side accounting: aggregate latencies like _finalize, then the
    per-replica breakdown (requests, p50/p99 TTFT, requeues) from each
    request's routing metadata + the router ledger."""
    res.duration_s = time.monotonic() - t0
    done_tokens = 0
    by_replica: dict[int, dict] = {}
    for r in reqs:
        if r.state is RequestState.FINISHED:
            res.completed += 1
            done_tokens += len(r.generated_tokens)
            if r.ttft_ms is not None:
                res.ttft_ms.append(r.ttft_ms)
            if len(r.generated_tokens) > 1 and r.finish_time is not None \
                    and r.first_token_time is not None:
                res.tpot_ms.append(
                    (r.finish_time - r.first_token_time) * 1000.0
                    / (len(r.generated_tokens) - 1))
            meta = getattr(r, "fleet_meta", None) or {}
            rid = meta.get("replica")
            if rid is not None:
                slot = by_replica.setdefault(
                    rid, {"requests": 0, "ttfts": []})
                slot["requests"] += 1
                if r.ttft_ms is not None:
                    slot["ttfts"].append(r.ttft_ms)
        elif r.state in (RequestState.FAILED, RequestState.CANCELLED):
            res.failed += 1
    stats = fleet.router.stats()
    res.requeues = stats["requeues"]
    snap = fleet.supervisor.snapshot()
    mig = snap.get("migration", {})
    res.migrations = mig.get("migrations", 0)
    res.migrated_tokens = mig.get("migrated_tokens", 0)
    res.reprefill_tokens_avoided = mig.get("reprefill_tokens_avoided", 0)
    res.preemptions = sum(rep.engine.total_preemptions
                          for rep in fleet.replicas)
    res.goodput_tokens_per_s = done_tokens / max(res.duration_s, 1e-9)
    def pct(xs, q):
        # None, not NaN: summaries are JSON-serialized and NaN is not a
        # standard JSON token (same rule as offered_rps above)
        return round(res.percentile(xs, q), 1) if xs else None

    # disaggregated fleets (any non-mixed role): per-phase breakdown.
    # TTFT is the prefill phase's latency (queue + prefill + the handoff
    # crossing); ITL/TPOT is the decode phase's. The handoff stalls come
    # from the supervisor snapshot (bounded recent window).
    roles = {rep.replica_id: getattr(rep, "role", "mixed")
             for rep in fleet.replicas}
    ho = snap.get("handoff", {})
    if ho.get("handoffs", 0) or set(roles.values()) - {"mixed"}:
        res.handoffs = ho.get("handoffs", 0)
        res.handoffs_local = ho.get("local_fallbacks", 0)
        stalls = ho.get("stalls_ms", [])

        def pct2(xs, q):
            return round(res.percentile(xs, q), 2) if xs else None

        res.phases = {
            "prefill": {
                "p50_ttft_ms": pct(res.ttft_ms, 50),
                "p99_ttft_ms": pct(res.ttft_ms, 99),
                "replicas": sorted(rid for rid, ro in roles.items()
                                   if ro in ("prefill", "mixed")),
            },
            "decode": {
                "p50_itl_ms": pct2(res.tpot_ms, 50),
                "p99_itl_ms": pct2(res.tpot_ms, 99),
                "replicas": sorted(rid for rid, ro in roles.items()
                                   if ro in ("decode", "mixed")),
            },
            "handoff": {
                "count": res.handoffs,
                "local_fallbacks": res.handoffs_local,
                "p50_stall_ms": pct2(stalls, 50),
                "p99_stall_ms": pct2(stalls, 99),
                # the transport's share of the crossing: how much of the
                # handoff stall was the courier link itself
                "p50_transfer_ms": pct2(
                    snap.get("courier", {}).get("transfer_ms", []), 50),
                "p99_transfer_ms": pct2(
                    snap.get("courier", {}).get("transfer_ms", []), 99),
            },
        }

    # courier transport plane: any payload that crossed replicas rode it
    cour = snap.get("courier", {})
    if cour.get("transfers", 0) or cour.get("aborts", 0):
        def pct3(xs, q):
            return round(res.percentile(xs, q), 2) if xs else None
        xfer = cour.get("transfer_ms", [])
        res.courier = {
            "transfers": cour.get("transfers", 0),
            "chunks": cour.get("chunks", 0),
            "retries": cour.get("retries", 0),
            "corruptions": cour.get("corruptions", 0),
            "resumes": cour.get("resumes", 0),
            "aborts": cour.get("aborts", 0),
            # wire codec ledger: bytes that actually traveled vs the raw
            # payload bytes they covered (the A/B signal for
            # --serve-courier-codec)
            "bytes_wire": cour.get("bytes_wire", 0),
            "bytes_raw": cour.get("bytes_raw", 0),
            "compression_ratio": cour.get("compression_ratio", 1.0),
            "p50_transfer_ms": pct3(xfer, 50),
            "p99_transfer_ms": pct3(xfer, 99),
        }

    # fleet-global prefix cache: fetched-instead-of-recomputed pages —
    # nonzero whenever admission spilled off a warm owner and the fetch
    # plane recovered the pages
    pf = snap.get("prefix_fetch", {})
    if pf.get("pages", 0) or pf.get("misses", 0) or pf.get("aborts", 0):
        def pct4(xs, q):
            return round(res.percentile(xs, q), 2) if xs else None
        window = pf.get("fetch_ms", [])
        res.prefix_fetch = {
            "fetches": pf.get("fetches", 0),
            "pages": pf.get("pages", 0),
            "bytes": pf.get("bytes", 0),
            "misses": pf.get("misses", 0),
            "aborts": pf.get("aborts", 0),
            "p50_fetch_ms": pct4(window, 50),
            "p99_fetch_ms": pct4(window, 99),
        }
    # the fleet KV store: demotion, hit and miss counters and the tiers'
    # occupancy, when eviction or a drain pushed pages down a tier
    ks = snap.get("kv_store", {})
    if ks.get("demotions") or ks.get("hits") or ks.get("misses"):
        res.kv_store = {k: ks.get(k, 0) for k in (
            "hits", "misses", "demotions", "evictions", "spills",
            "corrupt", "bytes_served", "bytes_stored",
            "dram_entries", "disk_entries")}

    # pipelined multi-replica prefill: the coordinator's counters plus
    # the interference split — long-prompt TTFT (the pipelining payoff)
    # vs the co-resident SHORT requests' TPOT (the protection readout).
    # token_lists rides along (submission order) for on/off identity.
    pl = snap.get("pipeline", {})
    if pl.get("pipelines", 0) or long_prompt_len > 0:
        def pct6(xs, q):
            return round(res.percentile(xs, q), 2) if xs else None
        long_ttft, short_ttft, short_tpot = [], [], []
        for r in reqs:
            if r.state is not RequestState.FINISHED:
                continue
            is_long = (long_prompt_len > 0
                       and len(r.prompt_tokens) >= long_prompt_len)
            if r.ttft_ms is not None:
                (long_ttft if is_long else short_ttft).append(r.ttft_ms)
            if not is_long and len(r.generated_tokens) > 1 \
                    and r.finish_time is not None \
                    and r.first_token_time is not None:
                short_tpot.append(
                    (r.finish_time - r.first_token_time) * 1000.0
                    / (len(r.generated_tokens) - 1))
        pipes = pl.get("pipelines", 0)
        res.pipeline = {
            "pipelines": pipes,
            "completed": pl.get("completed", 0),
            "stages": pl.get("stages", 0),
            "mean_stages": (round(pl.get("stages", 0) / pipes, 2)
                            if pipes else None),
            "collapses": pl.get("collapses", 0),
            "preshipped_pages": pl.get("preshipped_pages", 0),
            "preship_ms": pl.get("preship_ms", 0),
            "preship_hidden_ms": pl.get("preship_hidden_ms", 0),
            "overlap_ratio": pl.get("overlap_ratio"),
            "long_prompts": len(long_ttft),
            "p50_long_ttft_ms": pct6(long_ttft, 50),
            "p99_long_ttft_ms": pct6(long_ttft, 99),
            "p50_short_ttft_ms": pct6(short_ttft, 50),
            "p99_short_ttft_ms": pct6(short_ttft, 99),
            "p50_short_tpot_ms": pct6(short_tpot, 50),
            "p99_short_tpot_ms": pct6(short_tpot, 99),
            "token_lists": [[int(t) for t in r.generated_tokens]
                            for r in reqs],
        }

    # streaming client mode: per-token delivery jitter + the
    # exactly-once ledger. ``identity_ok`` is the headline assertion:
    # every request's STREAMED token sequence equals its final
    # completion, with zero client-observed seq gaps or duplicates —
    # across whatever crashes/migrations the run injected.
    if stream_clients is not None:
        by_rid = {r.request_id: r for r in reqs}
        identity_ok = True
        streamed_tokens = 0
        gaps = dups = 0
        all_gaps_ms: list = []
        for rid, sc in stream_clients.items():
            req = by_rid.get(rid)
            if req is not None and req.state is RequestState.FINISHED \
                    and sc.tokens != req.generated_tokens:
                identity_ok = False
            streamed_tokens += len(sc.tokens)
            gaps += sc.gaps
            dups += sc.dups
            all_gaps_ms.extend(sc.delivery_gaps_ms())
        hub = fleet.streams.stats()

        def pct5(xs, q):
            return round(res.percentile(xs, q), 2) if xs else None

        res.stream = {
            "streams": len(stream_clients),
            "tokens": streamed_tokens,
            "identity_ok": identity_ok,
            "gaps": gaps,
            "duplicates": dups,
            # producer-side re-sends the hub absorbed (never delivered)
            "suppressed_duplicates": hub.get("duplicates", 0),
            "replayed": hub.get("replayed", 0),
            "p50_gap_ms": pct5(all_gaps_ms, 50),
            "p99_gap_ms": pct5(all_gaps_ms, 99),
            "max_gap_ms": (round(max(all_gaps_ms), 2)
                           if all_gaps_ms else None),
        }

    for rid, slot in sorted(by_replica.items()):
        res.per_replica[rid] = {
            "requests": slot["requests"],
            "p50_ttft_ms": pct(slot["ttfts"], 50),
            "p99_ttft_ms": pct(slot["ttfts"], 99),
            "requeues": stats["requeues_per_replica"].get(rid, 0),
        }
    # replicas that served nothing still appear (an operator reading the
    # breakdown must see the idle replica, not infer it from absence)
    for rep in fleet.replicas:
        res.per_replica.setdefault(rep.replica_id, {
            "requests": 0, "p50_ttft_ms": None, "p99_ttft_ms": None,
            "requeues": stats["requeues_per_replica"].get(
                rep.replica_id, 0)})
    return res


def _submit_fleet(fleet, prompt, max_tokens, reqs, events, res,
                  retryq: Optional[list] = None, max_retries: int = 0,
                  tries: int = 0,
                  stream_clients: Optional[dict] = None,
                  priority: str = "standard"):
    """One fleet submission; 429-style rejections are counted, not raised.

    With ``max_retries > 0`` a saturated submission honors the server's
    Retry-After hint: it re-enters ``retryq`` as (due_time, prompt, tries)
    and is resubmitted by the drive loop once due — the client half of the
    backpressure contract. Budget exhausted -> counted rejected+failed,
    exactly like max_retries=0.

    ``stream_clients`` (a dict, streaming mode): submit through the
    stream hub and attach a :class:`_StreamClient` subscriber — tokens
    are then consumed as a live stream, not just read off the finished
    request."""
    import threading

    from .fleet.router import FleetSaturated
    ev = threading.Event()
    try:
        if stream_clients is not None:
            req = fleet.submit_streaming(
                prompt,
                SamplingParams(temperature=0.0, max_tokens=max_tokens),
                on_complete=lambda _r, ev=ev: ev.set(),
                priority=priority)
            sc = _StreamClient()
            sub = fleet.streams.subscribe(req.request_id, 0, sc)
            if sub is not None:
                sc.acker = (lambda rid=req.request_id,
                            sid=sub["sub"]:
                            fleet.streams.ack(rid, sid))
                if sub["tokens"]:
                    sc(("tokens", sub["start"], sub["tokens"]))
                if sub["finished"]:
                    sc(("finish", sub["finish_reason"], sub["error"]))
            stream_clients[req.request_id] = sc
            reqs.append(req)
        else:
            reqs.append(fleet.submit(
                prompt,
                SamplingParams(temperature=0.0, max_tokens=max_tokens),
                on_complete=lambda _r, ev=ev: ev.set(),
                priority=priority))
        events.append(ev)
    except FleetSaturated as e:
        if retryq is not None and tries < max_retries:
            res.retries += 1
            retryq.append((time.monotonic() + e.retry_after_s, prompt,
                           tries + 1, priority))
        else:
            res.rejected += 1
            res.failed += 1


def _drain_retryq(fleet, retryq, max_tokens, reqs, events, res,
                  max_retries, stream_clients=None) -> None:
    """Resubmit every due Retry-After entry (oldest first)."""
    now = time.monotonic()
    due = [x for x in retryq if x[0] <= now]
    for x in sorted(due, key=lambda x: x[0]):
        retryq.remove(x)
        _submit_fleet(fleet, x[1], max_tokens, reqs, events, res,
                      retryq=retryq, max_retries=max_retries, tries=x[2],
                      stream_clients=stream_clients,
                      priority=x[3] if len(x) > 3 else "standard")


def _hot_prefix(rng, hi, prompt_len, hot_prefix_len: int) -> list:
    """The shared head of every flash-crowd prompt (drawn once a run),
    clamped to leave at least one distinct tail token."""
    k = min(max(hot_prefix_len, 0), max(prompt_len - 1, 0))
    return [int(t) for t in rng.integers(1, hi, size=k)] if k else []


def _run_poisson_fleet(fleet, *, offered_rps, num_requests, prompt_len,
                       max_tokens, seed, vocab_hi, prompt_pool,
                       max_retries=0, hot_prefix_len=0,
                       stream=False, long_prompts=0,
                       long_prompt_len=0) -> LoadResult:
    """Open-loop arrivals against a fleet router: replica threads do the
    stepping; the generator only submits on schedule and waits. The
    supervisor is polled inline when no background supervisor runs, so
    injected faults recover deterministically inside the measured window.

    ``long_prompts > 0`` is the long-context scenario: that many
    ``long_prompt_len``-token summarization prompts join the SAME
    Poisson arrival stream, evenly interleaved with the short chat
    traffic. Their prompts are drawn up front from the run seed, so two
    runs differing only in fleet config (pipelining on vs off) offer a
    token-identical workload — LoadResult.pipeline carries the A/B."""
    rng = np.random.default_rng(seed)
    hi = vocab_hi or fleet.model_cfg.vocab_size
    total = num_requests + max(long_prompts, 0)
    gaps = rng.exponential(1.0 / offered_rps, size=total)
    arrivals = np.cumsum(gaps)
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    pool = [hot + rng.integers(1, hi,
                               size=prompt_len - len(hot)).tolist()
            for _ in range(max(prompt_pool, 1))]
    # long prompts drawn up front (deterministic across fleet-config
    # A/Bs) and spread evenly through the arrival order
    long_pool = [rng.integers(1, hi, size=long_prompt_len).tolist()
                 for _ in range(max(long_prompts, 0))]
    long_at = {(k * total) // max(long_prompts, 1) + 1: k
               for k in range(max(long_prompts, 0))} \
        if long_prompts > 0 else {}
    reqs: list[Request] = []
    events: list = []
    retryq: list = []
    stream_clients: Optional[dict] = {} if stream else None
    res = LoadResult(offered_rps=offered_rps)
    supervised = fleet.supervisor._thread is not None
    t0 = time.monotonic()
    i = 0
    while i < total or retryq \
            or not all(e.is_set() for e in events):
        now = time.monotonic() - t0
        while i < total and arrivals[i] <= now:
            if i in long_at:
                prompt = long_pool[long_at[i]]
            elif prompt_pool:
                prompt = pool[int(rng.integers(len(pool)))]
            else:
                prompt = hot + rng.integers(
                    1, hi, size=prompt_len - len(hot)).tolist()
            _submit_fleet(fleet, prompt, max_tokens, reqs, events, res,
                          retryq=retryq, max_retries=max_retries,
                          stream_clients=stream_clients)
            i += 1
        _drain_retryq(fleet, retryq, max_tokens, reqs, events, res,
                      max_retries, stream_clients=stream_clients)
        res.queue_peak = max(res.queue_peak, fleet.router.pending_total())
        if not supervised:
            fleet.supervisor.poll_once()
        time.sleep(0.005)
    return _finalize_fleet(res, reqs, fleet, t0,
                           stream_clients=stream_clients,
                           long_prompt_len=long_prompt_len
                           if long_prompts > 0 else 0)


def _run_closed_loop_fleet(fleet, *, concurrency, num_requests, prompt_len,
                           max_tokens, seed, vocab_hi,
                           max_retries=0, hot_prefix_len=0,
                           stream=False) -> LoadResult:
    rng = np.random.default_rng(seed)
    hi = vocab_hi or fleet.model_cfg.vocab_size
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    reqs: list[Request] = []
    events: list = []
    retryq: list = []
    stream_clients: Optional[dict] = {} if stream else None
    res = LoadResult(offered_rps=float("inf"))
    supervised = fleet.supervisor._thread is not None
    submitted = 0
    t0 = time.monotonic()
    while submitted < num_requests or retryq \
            or not all(e.is_set() for e in events):
        in_flight = sum(1 for e in events if not e.is_set())
        while submitted < num_requests and in_flight < concurrency:
            _submit_fleet(fleet,
                          hot + rng.integers(
                              1, hi,
                              size=prompt_len - len(hot)).tolist(),
                          max_tokens, reqs, events, res,
                          retryq=retryq, max_retries=max_retries,
                          stream_clients=stream_clients)
            submitted += 1
            in_flight += 1
        _drain_retryq(fleet, retryq, max_tokens, reqs, events, res,
                      max_retries, stream_clients=stream_clients)
        res.queue_peak = max(res.queue_peak, fleet.router.pending_total())
        if not supervised:
            fleet.supervisor.poll_once()
        time.sleep(0.005)
    return _finalize_fleet(res, reqs, fleet, t0,
                           stream_clients=stream_clients)


def run_poisson(engine, *, offered_rps: float, num_requests: int,
                prompt_len: int, max_tokens: int, seed: int = 0,
                vocab_hi: Optional[int] = None, prompt_pool: int = 0,
                max_retries: int = 0, hot_prefix_len: int = 0,
                stream: bool = False, device_times: bool = False,
                long_prompts: int = 0, long_prompt_len: int = 0
                ) -> LoadResult:
    """Open-loop run; steps until everything admitted drains.
    ``prompt_pool > 0`` draws prompts from that many distinct prompts;
    ``hot_prefix_len > 0`` gives every prompt the same seeded head. A
    fleet target goes through ``_run_poisson_fleet``, where
    ``max_retries`` honours Retry-After, ``stream`` consumes every
    request as a token stream and ``long_prompts`` mixes long prompts
    into the traffic; a plain engine ignores those three."""
    if _is_fleet(engine):
        return _run_poisson_fleet(
            engine, offered_rps=offered_rps, num_requests=num_requests,
            prompt_len=prompt_len, max_tokens=max_tokens, seed=seed,
            vocab_hi=vocab_hi, prompt_pool=prompt_pool,
            max_retries=max_retries, hot_prefix_len=hot_prefix_len,
            stream=stream, long_prompts=long_prompts,
            long_prompt_len=long_prompt_len)
    rng = np.random.default_rng(seed)
    hi = vocab_hi or engine.cfg.vocab_size
    gaps = rng.exponential(1.0 / offered_rps, size=num_requests)
    arrivals = np.cumsum(gaps)
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    pool = [hot + rng.integers(1, hi, size=prompt_len - len(hot)).tolist()
            for _ in range(max(prompt_pool, 1))]

    reqs: list[Request] = []
    res = LoadResult(offered_rps=offered_rps)
    t0 = time.monotonic()
    i = 0
    while i < num_requests or engine.scheduler.active_count > 0 \
            or engine.scheduler.queue_depth > 0 or engine._partial_prefills:
        now = time.monotonic() - t0
        while i < num_requests and arrivals[i] <= now:
            prompt = (pool[int(rng.integers(len(pool)))] if prompt_pool
                      else hot + rng.integers(
                          1, hi, size=prompt_len - len(hot)).tolist())
            r = Request(request_id=f"load-{i}", prompt_tokens=prompt,
                        sampling=SamplingParams(temperature=0.0,
                                                max_tokens=max_tokens))
            if engine.scheduler.add_request(r):
                reqs.append(r)
            else:
                res.failed += 1
            i += 1
        res.queue_peak = max(res.queue_peak, engine.scheduler.queue_depth)
        if engine.step() == 0 and i < num_requests:
            # idle before the next arrival: sleep to it, not spin
            wait = arrivals[i] - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    res = _finalize(res, reqs, engine, t0)
    if device_times:
        attach_device_times(res, reqs, engine)
    return res


def run_closed_loop(engine, *, concurrency: int, num_requests: int,
                    prompt_len: int, max_tokens: int, seed: int = 0,
                    vocab_hi: Optional[int] = None,
                    max_retries: int = 0, hot_prefix_len: int = 0,
                    stream: bool = False,
                    device_times: bool = False) -> LoadResult:
    """Closed-loop run: ``concurrency`` requests in flight, a new one
    arriving the moment one finishes. A fleet target routes through the
    router as in ``run_poisson``."""
    if _is_fleet(engine):
        return _run_closed_loop_fleet(
            engine, concurrency=concurrency, num_requests=num_requests,
            prompt_len=prompt_len, max_tokens=max_tokens, seed=seed,
            vocab_hi=vocab_hi, max_retries=max_retries,
            hot_prefix_len=hot_prefix_len, stream=stream)
    rng = np.random.default_rng(seed)
    hi = vocab_hi or engine.cfg.vocab_size
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    reqs: list[Request] = []
    res = LoadResult(offered_rps=float("inf"))
    submitted = 0
    t0 = time.monotonic()

    def submit():
        nonlocal submitted
        r = Request(request_id=f"load-{submitted}",
                    prompt_tokens=hot + rng.integers(
                        1, hi, size=prompt_len - len(hot)).tolist(),
                    sampling=SamplingParams(temperature=0.0,
                                            max_tokens=max_tokens))
        submitted += 1
        if engine.scheduler.add_request(r):
            reqs.append(r)
        else:
            res.failed += 1

    def in_flight() -> int:
        return sum(1 for r in reqs if r.state in (
            RequestState.QUEUED, RequestState.PREFILLING,
            RequestState.RUNNING))

    while submitted < num_requests or in_flight() > 0:
        while submitted < num_requests and in_flight() < concurrency:
            submit()
        res.queue_peak = max(res.queue_peak, engine.scheduler.queue_depth)
        engine.step()
    res = _finalize(res, reqs, engine, t0)
    if device_times:
        attach_device_times(res, reqs, engine)
    return res


def run_returning(fleet, *, conversations: int, history_len: int,
                  tail_len: int = 4, max_tokens: int = 16,
                  filler_requests: int = 8, filler_len: int = 64,
                  think_time_s: float = 0.0, seed: int = 0,
                  vocab_hi: int = 0) -> LoadResult:
    """Returning-conversation scenario (the tiered fleet KV store's
    headline): ``conversations`` multi-turn chats each
    prefill a ``history_len``-token shared history (warm turn), then go
    quiet for a think-time gap LONGER than their pages' HBM residency —
    modeled by ``filler_requests`` distinct prompts churning the pool so
    LRU eviction demotes the histories down a tier — and finally RETURN
    with the same history and a fresh tail. With the store on, the
    return turn fetches its history's pages back (store hits) and
    prefills only the tail; with it off, the whole history re-prefills.

    ``LoadResult.returning`` carries the warm-vs-return TTFT split, the
    prefill tokens the return turns actually spent, and the returning
    token lists (a store-on/store-off A/B must be token-identical —
    degrade never changes output). Closed-loop per turn; fleet targets
    only."""
    rng = np.random.default_rng(seed)
    hi = vocab_hi or fleet.model_cfg.vocab_size
    histories = [
        [int(t) for t in rng.integers(1, hi, size=history_len)]
        for _ in range(conversations)]
    reqs: list[Request] = []
    res = LoadResult(offered_rps=float("inf"))
    supervised = fleet.supervisor._thread is not None
    t0 = time.monotonic()

    def turn(prompts) -> list[Request]:
        events: list = []
        batch: list[Request] = []
        for p in prompts:
            _submit_fleet(fleet, p, max_tokens, batch, events, res)
        while not all(e.is_set() for e in events):
            res.queue_peak = max(res.queue_peak,
                                 fleet.router.pending_total())
            if not supervised:
                fleet.supervisor.poll_once()
            time.sleep(0.005)
        reqs.extend(batch)
        return batch

    def engines():
        return [rep.engine for rep in fleet.replicas
                if getattr(rep, "engine", None) is not None]

    def prefill_total() -> int:
        return sum(e.total_prefill_tokens for e in engines())

    warm = turn([h + [int(t) for t in rng.integers(1, hi, size=tail_len)]
                 for h in histories])
    # the think-time gap: other tenants' traffic outlives this
    # conversation's HBM residency
    deadline = time.monotonic() + max(think_time_s, 0.0)
    while time.monotonic() < deadline:
        if not supervised:
            fleet.supervisor.poll_once()
        time.sleep(0.005)
    if filler_requests > 0:
        turn([[int(t) for t in rng.integers(1, hi, size=filler_len)]
              for _ in range(filler_requests)])
    # eviction demotions encode on the store's background worker; the
    # think-time gap is exactly when that drains in production — make
    # it deterministic here
    store = getattr(fleet, "kv_store", None)
    if store is not None:
        store.flush_pending()
    fetched0 = sum(getattr(e, "total_prefix_fetched_tokens", 0)
                   for e in engines())
    spent0 = prefill_total()
    # returns are SEQUENTIAL: real conversations come back after
    # independent think times, not as a thundering herd — and per-
    # request TTFT is the honest store-hit-vs-recompute readout only
    # without co-batching artifacts
    ret = []
    for h in histories:
        ret.extend(turn([h + [int(t) for t in
                              rng.integers(1, hi, size=tail_len)]]))
    ret_spent = prefill_total() - spent0
    ret_fetched = sum(getattr(e, "total_prefix_fetched_tokens", 0)
                      for e in engines()) - fetched0

    def pct(xs, q):
        return (round(float(np.percentile(np.asarray(xs), q)), 2)
                if xs else None)

    warm_ttft = [r.ttft_ms for r in warm if r.ttft_ms is not None]
    ret_ttft = [r.ttft_ms for r in ret if r.ttft_ms is not None]
    out = _finalize_fleet(res, reqs, fleet, t0)
    out.returning = {
        "conversations": conversations,
        "history_len": history_len,
        "warm_p50_ttft_ms": pct(warm_ttft, 50),
        "warm_p99_ttft_ms": pct(warm_ttft, 99),
        "return_p50_ttft_ms": pct(ret_ttft, 50),
        "return_p99_ttft_ms": pct(ret_ttft, 99),
        "return_prefill_tokens": int(ret_spent),
        "return_fetched_tokens": int(ret_fetched),
        "token_lists": [list(r.generated_tokens) for r in ret],
    }
    return out


class FrontStreamClient:
    """HTTP SSE client over an HA front tier's front list, hardened for
    front death (serve/fleet/front.py).

    One ``stream()`` call drives one request end to end: POST
    ``/v1/completions`` (``stream: true``) to a front, consume SSE
    frames, and on ANY connection failure — refused, reset mid-read,
    timeout, a 404 from a front that hasn't folded the journal yet —
    retry with **doubling backoff across the configured front list
    (round-robin)** instead of failing the request: reconnect at
    ``GET /v1/streams/{rid}`` with the last delivered seq as
    ``Last-Event-ID`` so only the unacked tail replays. Client-side
    dedupe-by-seq mirrors the hub's, so ``gaps``/``dups`` count real
    contract violations (both must be 0 across a front SIGKILL).

    ``reconnects_per_front`` is the failover ledger LoadResult.stream
    surfaces: which surviving front picked each dropped client up. Each
    stream's result also carries its TTFT and TPOT on the client's clock
    (``ttft_ms``, ``tpot_ms``; the JAX client records no times).
    """

    def __init__(self, fronts, max_attempts: int = 16,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 read_timeout_s: float = 60.0):
        self.fronts = [str(f).rstrip("/") for f in fronts]
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.read_timeout_s = float(read_timeout_s)
        self._lock = _threading.Lock()
        self.reconnects_per_front = {f: 0 for f in self.fronts}
        self.total_reconnects = 0
        self.total_retries = 0          # failed attempts retried

    def _count_reconnect(self, front: str) -> None:
        with self._lock:
            self.reconnects_per_front[front] = (
                self.reconnects_per_front.get(front, 0) + 1)
            self.total_reconnects += 1

    def stream(self, prompt_tokens, max_tokens: int,
               temperature: float = 0.0, seed=None,
               start_front: int = 0) -> dict:
        import json as _json
        import urllib.request

        rid = None
        last_seq = -1
        tokens: list[int] = []
        gaps = dups = 0
        finish_reason = None
        done = False
        error = None
        fi = int(start_front)
        backoff = self.backoff_s
        attempts_left = self.max_attempts
        # the client's clock: the first and the latest fresh token
        t0 = time.monotonic()
        t_first = t_last = None
        while not done and attempts_left > 0:
            front = self.fronts[fi % len(self.fronts)]
            resumed = rid is not None
            try:
                if not resumed:
                    body = {"prompt": [int(t) for t in prompt_tokens],
                            "max_tokens": int(max_tokens),
                            "temperature": float(temperature),
                            "stream": True}
                    if seed is not None:
                        body["seed"] = int(seed)
                    wire = urllib.request.Request(
                        f"{front}/v1/completions",
                        data=_json.dumps(body).encode(),
                        headers={"Content-Type": "application/json"},
                        method="POST")
                else:
                    wire = urllib.request.Request(
                        f"{front}/v1/streams/{rid}"
                        f"?last_event_id={last_seq}", method="GET")
                with urllib.request.urlopen(
                        wire, timeout=self.read_timeout_s) as resp:
                    if resumed:
                        self._count_reconnect(front)
                    backoff = self.backoff_s
                    for raw in resp:
                        line = raw.decode("utf-8", "replace").strip()
                        if not line.startswith("data:"):
                            continue
                        payload = line[len("data:"):].strip()
                        if payload == "[DONE]":
                            done = True
                            break
                        ev = _json.loads(payload)
                        rid = ev.get("id", rid)
                        choice = (ev.get("choices") or [{}])[0]
                        toks = [int(t) for t in
                                (choice.get("token_ids") or [])]
                        if toks:
                            seq_last = int(ev.get("seq",
                                                  last_seq + len(toks)))
                            start = seq_last - len(toks) + 1
                            if start > last_seq + 1:
                                gaps += 1
                            elif start <= last_seq:
                                dups += 1
                            fresh = toks[max(last_seq + 1 - start, 0):]
                            tokens.extend(fresh)
                            if fresh:
                                t_last = time.monotonic()
                                t_first = t_first or t_last
                            last_seq = max(last_seq, seq_last)
                        if choice.get("finish_reason"):
                            finish_reason = choice["finish_reason"]
            except Exception as e:          # refused/reset/timeout/404
                error = e
            if done:
                break
            # connection ended without [DONE] (killed front, dropped
            # socket, backpressure drop) or failed outright: rotate to
            # the next front under doubling backoff and resume
            attempts_left -= 1
            with self._lock:
                self.total_retries += 1
            if attempts_left <= 0:
                break
            time.sleep(backoff)
            backoff = min(backoff * 2, self.backoff_max_s)
            fi += 1
        return {"ok": done, "rid": rid, "tokens": tokens, "gaps": gaps,
                "dups": dups, "finish_reason": finish_reason,
                "error": None if done else repr(error),
                # time to the first token and between the later ones, on
                # the client's clock (reconnects included)
                "ttft_ms": None if t_first is None
                else (t_first - t0) * 1e3,
                "tpot_ms": None if t_first is None or len(tokens) < 2
                else (t_last - t_first) * 1e3 / (len(tokens) - 1)}


def run_stream_fronts(fronts, *, num_requests: int, prompt_len: int,
                      max_tokens: int, seed: int = 0,
                      vocab_hi: int = 1000, concurrency: int = 4,
                      temperature: float = 0.0,
                      client: Optional[FrontStreamClient] = None,
                      prompts=None, pin_front: Optional[int] = None
                      ) -> LoadResult:
    """Closed-loop HTTP streaming load against an HA front tier.

    Unlike the in-process stream mode (``run_poisson(stream=True)``),
    every request here crosses real sockets to a front process and is
    consumed as SSE — so killing a front mid-run exercises the full
    failover path: reconnect to a survivor, Last-Event-ID replay,
    shared-log delivery. ``LoadResult.stream`` reports the client-side
    ledger: gaps/dups (must be 0), per-front reconnect counts, and the
    per-request token lists (``token_lists``, submission order) for
    token-identity assertions against an undisturbed engine.
    ``pin_front`` starts every request on one front (the
    kill-the-connection-holder scenario); default spreads round-robin.
    """
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(1, vocab_hi, size=prompt_len).tolist()
                   for _ in range(num_requests)]
    client = client or FrontStreamClient(fronts)
    results: list = [None] * len(prompts)
    sem = _threading.Semaphore(max(int(concurrency), 1))
    t0 = time.monotonic()

    def drive(i: int) -> None:
        with sem:
            results[i] = client.stream(
                prompts[i], max_tokens, temperature=temperature,
                start_front=(pin_front if pin_front is not None else i))

    threads = [_threading.Thread(target=drive, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = LoadResult(offered_rps=float("inf"))
    res.duration_s = time.monotonic() - t0
    done_tokens = 0
    gaps = dups = 0
    for r in results:
        if r and r["ok"]:
            res.completed += 1
            done_tokens += len(r["tokens"])
        else:
            res.failed += 1
        if r:
            gaps += r["gaps"]
            dups += r["dups"]
    res.goodput_tokens_per_s = done_tokens / max(res.duration_s, 1e-9)
    res.stream = {
        "streams": len(prompts),
        "tokens": done_tokens,
        "gaps": gaps,
        "duplicates": dups,
        "reconnects": client.total_reconnects,
        "retries": client.total_retries,
        "reconnects_per_front": dict(client.reconnects_per_front),
        "token_lists": [r["tokens"] if r else None for r in results],
        "ttft_ms": [r["ttft_ms"] if r else None for r in results],
        "tpot_ms": [r["tpot_ms"] if r else None for r in results],
    }
    return res


#: The scenario matrix ``bench e2e --serve-scenario`` sweeps. Each shapes
#: the OFFERED load (arrival rate and/or request geometry) over the run
#: window; the fleet's reaction — scale-ups, drain-retires, preemptions —
#: is the thing under test, so every plan is drawn up front from the run
#: seed and is byte-identical across an autoscale-on/off A/B.
SCENARIOS = ("diurnal", "flash-crowd", "phase-shift",
             "returning-churn", "long-context")

#: SLO class mix for scenario traffic (seeded per-request draw).
CLASS_MIX = (("interactive", 0.30), ("standard", 0.45),
             ("best-effort", 0.25))

#: Default attainment targets. best-effort has NO latency target — its
#: contract is "eventually, correctly" (it absorbs shedding and
#: preemption so the paying classes hold theirs).
DEFAULT_TTFT_TARGETS_MS = {"interactive": 2000.0, "standard": 6000.0,
                           "best-effort": float("inf")}
DEFAULT_TPOT_TARGETS_MS = {"interactive": 400.0, "standard": 800.0,
                           "best-effort": float("inf")}


def _scenario_plan(scenario: str, rng, *, duration_s: float,
                   base_rps: float, peak_rps: float, prompt_len: int,
                   max_tokens: int, hi: int, long_prompt_len: int,
                   class_mix) -> list:
    """Draw the full offered-load plan up front: a list of
    ``{"t", "cls", "prompt", "max_tokens"}`` entries, arrival times from
    an inhomogeneous Poisson process (rate follows the scenario's
    curve), class and prompt from the same seeded stream. Deterministic
    given (scenario, seed): the A/B invariant."""
    def rate(t: float) -> float:
        f = t / max(duration_s, 1e-9)
        if scenario == "diurnal":
            # one full day-cycle: trough at the edges, peak mid-window
            return base_rps + (peak_rps - base_rps) * 0.5 * (
                1.0 - float(np.cos(2.0 * np.pi * f)))
        if scenario == "flash-crowd":
            return peak_rps if 0.35 <= f < 0.60 else base_rps
        if scenario == "phase-shift":
            # steady arrivals near the burst peak: the stress is the
            # composition flip (prefill-heavy -> decode-heavy) under
            # a rate that overloads the fleet in aggregate but leaves
            # room for the interactive class alone — at trough rate
            # the flip is invisible
            return max(base_rps, 0.9 * peak_rps)
        return base_rps

    cum = []
    acc = 0.0
    for cls, w in class_mix:
        acc += w
        cum.append((acc, cls))
    total_w = acc

    # flash crowds hit ONE piece of content: burst prompts share a hot
    # head so admission affinity + the prefix planes see the real shape
    hot = [int(t) for t in rng.integers(1, hi, size=max(prompt_len // 2,
                                                        1))]
    plan = []
    t = 0.0
    while len(plan) < 4096:
        t += float(rng.exponential(1.0 / max(rate(t), 1e-6)))
        if t >= duration_s:
            break
        u = float(rng.random()) * total_w
        cls = next(c for edge, c in cum if u <= edge)
        f = t / max(duration_s, 1e-9)
        p_len, m_tok, head = prompt_len, max_tokens, []
        if scenario == "flash-crowd" and 0.35 <= f < 0.60:
            head = hot
        elif scenario == "phase-shift":
            # prefill-heavy half (long prompts, terse outputs) then a
            # decode-heavy half (short prompts, full generations —
            # the batch classes' 3x multiplier below is what makes it
            # decode-bound)
            if f < 0.5:
                p_len, m_tok = prompt_len * 3, max(max_tokens // 4, 4)
            else:
                p_len, m_tok = max(prompt_len // 2, 8), max_tokens
        elif scenario == "long-context" and len(plan) % 6 == 5:
            p_len = max(long_prompt_len, prompt_len)
        # SLO classes differ in shape, not just contract: interactive
        # turns are chat-sized while standard/best-effort carry the
        # long batch generations — exactly the traffic a class-blind
        # FCFS queue makes interactive wait behind under overload
        if cls != "interactive":
            m_tok *= 2
        elif scenario == "phase-shift" and f >= 0.5:
            # interactive chat turns stay short even in the
            # decode-heavy phase — the batch classes are what flip
            # the workload
            m_tok = max(m_tok // 2, 8)
        tail = rng.integers(1, hi, size=max(p_len - len(head), 1))
        plan.append({"t": t, "cls": cls,
                     "prompt": head + [int(x) for x in tail],
                     "max_tokens": int(m_tok)})
    return plan


def _scenario_scaling(fleet, timeline, replicas_peak: int) -> dict:
    """The scaling half of the scenario readout: autoscaler counters +
    the event log (relative timestamps — reset at run start) + the
    sampled replica-count timeline."""
    au = fleet.supervisor.snapshot().get("autoscale", {})
    return {
        "enabled": bool(au.get("enabled")),
        "replicas_start": timeline[0][1] if timeline else
        len(fleet.replicas),
        "replicas_peak": replicas_peak,
        "replicas_final": len(fleet.replicas),
        "replica_timeline": timeline,
        "scale_ups": au.get("scale_ups", 0),
        "scale_downs": au.get("scale_downs", 0),
        "spawn_failures": au.get("spawn_failures", 0),
        "retire_rollbacks": au.get("retire_rollbacks", 0),
        "preemptions": au.get("preemptions", 0),
        "events": au.get("events", []),
    }


def run_scenario(fleet, *, scenario: str, duration_s: float = 8.0,
                 base_rps: float = 4.0, peak_rps: float = 16.0,
                 prompt_len: int = 24, max_tokens: int = 12,
                 long_prompt_len: int = 192, seed: int = 0,
                 vocab_hi: int = 0, max_retries: int = 0,
                 ttft_targets_ms: Optional[dict] = None,
                 tpot_targets_ms: Optional[dict] = None,
                 class_mix=CLASS_MIX) -> LoadResult:
    """One cell of the scenario matrix (fleet targets only).

    Offered load follows the scenario's curve with a seeded SLO-class
    mix; the result's ``scenario`` block reports, per class: admission
    ledger (submitted/shed/retried), TTFT/TPOT percentiles, attainment
    against the class targets, and ``slo_goodput_tok_s`` — tokens from
    requests that MET their targets, the honest "goodput under SLO"
    figure — plus the autoscaler's scaling events on the run timeline
    and plan-order ``token_lists`` for the on/off identity assertion.

    ``returning-churn`` delegates the drive loop to :func:`run_returning`
    (the store churn scenario) and attaches the scaling readout."""
    from .fleet.router import FleetSaturated

    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {SCENARIOS}")
    ttft_targets = dict(DEFAULT_TTFT_TARGETS_MS)
    ttft_targets.update(ttft_targets_ms or {})
    tpot_targets = dict(DEFAULT_TPOT_TARGETS_MS)
    tpot_targets.update(tpot_targets_ms or {})
    autoscaler = getattr(fleet, "autoscaler", None)
    if autoscaler is not None:
        # zero the event clock so event timestamps line up with t0
        autoscaler.reset_counters()

    if scenario == "returning-churn":
        n0 = len(fleet.replicas)
        out = run_returning(
            fleet, conversations=max(int(base_rps), 2),
            history_len=max(prompt_len * 4, 32), tail_len=4,
            max_tokens=max_tokens,
            filler_requests=max(int(peak_rps), 4),
            filler_len=prompt_len * 2, seed=seed, vocab_hi=vocab_hi)
        ret = out.returning
        out.scenario = {
            "scenario": scenario,
            "duration_s": round(out.duration_s, 2),
            "classes": {"standard": {
                "submitted": out.completed + out.failed,
                "completed": out.completed, "rejected": out.rejected,
                "p50_ttft_ms": ret.get("return_p50_ttft_ms"),
                "p99_ttft_ms": ret.get("return_p99_ttft_ms"),
            }},
            "scaling": _scenario_scaling(
                fleet, [(0.0, n0)], max(n0, len(fleet.replicas))),
            "token_lists": ret.get("token_lists", []),
        }
        return out

    rng = np.random.default_rng(seed)
    hi = vocab_hi or fleet.model_cfg.vocab_size
    plan = _scenario_plan(
        scenario, rng, duration_s=duration_s, base_rps=base_rps,
        peak_rps=peak_rps, prompt_len=prompt_len, max_tokens=max_tokens,
        hi=hi, long_prompt_len=long_prompt_len, class_mix=class_mix)
    reqs: list[Request] = []
    events: list = []
    retryq: list = []                    # (due_time, plan_idx, tries)
    idx_of: dict[str, int] = {}          # request_id -> plan index
    ledger = {cls: {"submitted": 0, "rejected": 0, "retries": 0}
              for cls, _w in class_mix}
    res = LoadResult(offered_rps=base_rps)
    supervised = fleet.supervisor._thread is not None
    n = len(fleet.replicas)
    timeline = [(0.0, n)]
    replicas_peak = n
    t0 = time.monotonic()

    def _try_submit(i: int, tries: int) -> None:
        entry = plan[i]
        led = ledger[entry["cls"]]
        ev = _threading.Event()
        try:
            req = fleet.submit(
                entry["prompt"],
                SamplingParams(temperature=0.0,
                               max_tokens=entry["max_tokens"]),
                on_complete=lambda _r, ev=ev: ev.set(),
                priority=entry["cls"])
        except FleetSaturated as e:
            if tries < max_retries:
                led["retries"] += 1
                res.retries += 1
                retryq.append((time.monotonic() + e.retry_after_s, i,
                               tries + 1))
            else:
                led["rejected"] += 1
                res.rejected += 1
                res.failed += 1
            return
        led["submitted"] += 1
        idx_of[req.request_id] = i
        reqs.append(req)
        events.append(ev)

    i = 0
    while i < len(plan) or retryq or not all(e.is_set() for e in events):
        now = time.monotonic() - t0
        while i < len(plan) and plan[i]["t"] <= now:
            _try_submit(i, 0)
            i += 1
        nowm = time.monotonic()
        for x in sorted([x for x in retryq if x[0] <= nowm]):
            retryq.remove(x)
            _try_submit(x[1], x[2])
        res.queue_peak = max(res.queue_peak, fleet.router.pending_total())
        n = len(fleet.replicas)
        if n != timeline[-1][1]:
            timeline.append((round(time.monotonic() - t0, 2), n))
        replicas_peak = max(replicas_peak, n)
        if not supervised:
            fleet.supervisor.poll_once()
        time.sleep(0.005)

    res = _finalize_fleet(res, reqs, fleet, t0)

    # per-class attainment: did each finished request hold its class's
    # TTFT/TPOT targets? slo_goodput counts only the tokens of requests
    # that met BOTH — the figure the A/B headline compares.
    by_cls: dict[str, dict] = {}
    token_lists: list = [None] * len(plan)
    for r in reqs:
        cls = getattr(r, "priority", "standard")
        slot = by_cls.setdefault(cls, {
            "completed": 0, "failed": 0, "tokens": 0, "slo_tokens": 0,
            "ttft": [], "tpot": [], "met": 0})
        if r.state is not RequestState.FINISHED:
            slot["failed"] += 1
            continue
        slot["completed"] += 1
        ntok = len(r.generated_tokens)
        slot["tokens"] += ntok
        idx = idx_of.get(r.request_id)
        if idx is not None:
            token_lists[idx] = [int(t) for t in r.generated_tokens]
        tpot = None
        if ntok > 1 and r.finish_time is not None \
                and r.first_token_time is not None:
            tpot = (r.finish_time - r.first_token_time) * 1000.0 \
                / (ntok - 1)
            slot["tpot"].append(tpot)
        if r.ttft_ms is not None:
            slot["ttft"].append(r.ttft_ms)
        met = (r.ttft_ms is not None
               and r.ttft_ms <= ttft_targets.get(cls, float("inf"))
               and (tpot is None
                    or tpot <= tpot_targets.get(cls, float("inf"))))
        if met:
            slot["met"] += 1
            slot["slo_tokens"] += ntok

    def pct(xs, q):
        return round(res.percentile(xs, q), 2) if xs else None

    dur = max(res.duration_s, 1e-9)
    classes = {}
    for cls, _w in class_mix:
        led = ledger[cls]
        slot = by_cls.get(cls, {})
        if not (led["submitted"] or led["rejected"]):
            continue
        tt = ttft_targets.get(cls, float("inf"))
        tp = tpot_targets.get(cls, float("inf"))
        done = slot.get("completed", 0)
        classes[cls] = {
            "submitted": led["submitted"],
            "rejected": led["rejected"],
            "retries": led["retries"],
            "completed": done,
            "failed": slot.get("failed", 0),
            "p50_ttft_ms": pct(slot.get("ttft", []), 50),
            "p99_ttft_ms": pct(slot.get("ttft", []), 99),
            "p50_tpot_ms": pct(slot.get("tpot", []), 50),
            "p99_tpot_ms": pct(slot.get("tpot", []), 99),
            "ttft_target_ms": tt if np.isfinite(tt) else None,
            "tpot_target_ms": tp if np.isfinite(tp) else None,
            "attainment": (round(slot.get("met", 0) / done, 3)
                           if done else None),
            "goodput_tok_s": round(slot.get("tokens", 0) / dur, 1),
            "slo_goodput_tok_s": round(slot.get("slo_tokens", 0) / dur,
                                       1),
        }

    res.scenario = {
        "scenario": scenario,
        "duration_s": round(res.duration_s, 2),
        "offered": {"base_rps": base_rps, "peak_rps": peak_rps,
                    "planned_requests": len(plan)},
        "classes": classes,
        "scaling": _scenario_scaling(fleet, timeline, replicas_peak),
        "token_lists": token_lists,
    }
    return res
