"""The Prometheus metric-name registry (a copy of the JAX package's
``metrics/names.py``, entry for entry; tests/test_torch_metrics.py holds
the two equal).

- :data:`METRICS` declares every exported metric (kind, help, labels,
  histogram buckets). The port's ``PrometheusExporter`` constructs its
  registry from it.
- :data:`COUNTER_FLOW` declares how each ``total_*`` running counter
  flows from its owning class into snapshot/stats keys and (optionally)
  a registered Prometheus name. Its owners' paths are the JAX package's,
  and the port has every one of them under the same path
  (serve/engine.py and serve/fleet/: the supervisor, streams, fronts, KV
  store, store service and client, weight courier, pipeline and
  autoscaler).

The text exposition appends ``_total`` to counters at scrape time (a
declared ``_total`` is stripped first); :func:`scraped_name` gives the
wire name tests and dashboards see.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

GAUGE = "gauge"
COUNTER = "counter"
HISTOGRAM = "histogram"


class MetricSpec(NamedTuple):
    kind: str
    help: str
    labels: tuple = ()
    buckets: Optional[tuple] = None


_LAT_BUCKETS = (.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000)
_XFER_BUCKETS = (.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000, 5000)

METRICS: dict[str, MetricSpec] = {
    # -- training / system -------------------------------------------------
    "llmctl_train_loss": MetricSpec(GAUGE, "Training loss"),
    "llmctl_train_mfu": MetricSpec(GAUGE, "Model FLOPs utilisation"),
    "llmctl_train_tokens_per_sec": MetricSpec(GAUGE, "Global tokens/s"),
    "llmctl_train_tokens_per_sec_per_chip": MetricSpec(
        GAUGE, "Tokens/s per chip"),
    "llmctl_train_grad_norm": MetricSpec(GAUGE, "Gradient global norm"),
    "llmctl_train_lr": MetricSpec(GAUGE, "Learning rate"),
    "llmctl_train_step": MetricSpec(GAUGE, "Current optimizer step"),
    "llmctl_eval_loss": MetricSpec(GAUGE, "Eval loss"),
    "llmctl_hbm_used_gb": MetricSpec(GAUGE, "HBM in use", ("device",)),
    "llmctl_cpu_percent": MetricSpec(GAUGE, "Host CPU percent"),
    "llmctl_mem_percent": MetricSpec(GAUGE, "Host memory percent"),
    # -- single-server inference ------------------------------------------
    "llmctl_inference_requests_total": MetricSpec(
        COUNTER, "Completed inference requests"),
    "llmctl_inference_latency_seconds": MetricSpec(
        HISTOGRAM, "Request latency",
        buckets=(.01, .025, .05, .1, .2, .5, 1, 2, 5, 10)),
    "llmctl_inference_ttft_seconds": MetricSpec(
        HISTOGRAM, "Time to first token",
        buckets=(.01, .025, .05, .1, .15, .2, .3, .5, 1, 2)),
    "llmctl_inference_queue_depth": MetricSpec(GAUGE, "Queued requests"),
    "llmctl_decode_tokens_per_sec": MetricSpec(
        GAUGE, "Decode throughput"),
    "llmctl_inference_preemptions": MetricSpec(COUNTER, "KV preemptions"),
    "llmctl_inference_swap_ins": MetricSpec(COUNTER, "Swap-in restores"),
    "llmctl_inference_swapped_host_bytes": MetricSpec(
        GAUGE, "Host bytes held by swapped-out KV"),
    # -- fleet control plane ----------------------------------------------
    "llmctl_fleet_replica_queue_depth": MetricSpec(
        GAUGE, "Queued requests per replica", ("replica",)),
    "llmctl_fleet_replica_outstanding_tokens": MetricSpec(
        GAUGE, "Tokens of work owed per replica (routing load signal)",
        ("replica",)),
    "llmctl_fleet_replica_active": MetricSpec(
        GAUGE, "Resident (decoding) requests per replica", ("replica",)),
    "llmctl_fleet_replica_healthy": MetricSpec(
        GAUGE, "1 while the replica accepts traffic", ("replica",)),
    "llmctl_fleet_replica_restarts": MetricSpec(
        COUNTER, "Supervisor restarts per replica", ("replica",)),
    "llmctl_fleet_requeues": MetricSpec(
        COUNTER, "Requests rerouted off a crashed or drained replica"),
    "llmctl_fleet_rejected": MetricSpec(
        COUNTER, "Requests refused with 429 + Retry-After"),
    # -- KV migration plane -----------------------------------------------
    "llmctl_fleet_migrations": MetricSpec(
        COUNTER, "Sequences moved between replicas with their KV pages"),
    "llmctl_fleet_migrated_tokens": MetricSpec(
        COUNTER, "KV entries (tokens) moved by cross-replica migration"),
    "llmctl_fleet_reprefill_tokens_avoided": MetricSpec(
        COUNTER, "Prefill tokens NOT recomputed thanks to KV migration "
                 "and warm-prefix orphan requeue"),
    "llmctl_fleet_migration_pause_ms": MetricSpec(
        HISTOGRAM, "Stop-and-copy pause per migration (ms; the "
                   "two-phase copy's stop phase only)",
        buckets=_LAT_BUCKETS),
    "llmctl_fleet_replica_prefix_hit_rate": MetricSpec(
        GAUGE, "Prefix-cache page hit rate per replica (affinity-ring "
               "payoff)", ("replica",)),
    # -- disaggregated prefill/decode plane -------------------------------
    "llmctl_fleet_handoffs": MetricSpec(
        COUNTER, "Prefill->decode KV handoffs (disaggregated serving)"),
    "llmctl_fleet_handoff_stall_ms": MetricSpec(
        HISTOGRAM, "Per-handoff stall (one-phase KV extract + "
                   "placement, ms)", buckets=_LAT_BUCKETS),
    "llmctl_fleet_replica_role": MetricSpec(
        GAUGE, "Replica role (0=mixed, 1=prefill, 2=decode)",
        ("replica",)),
    # -- courier transport plane ------------------------------------------
    "llmctl_fleet_courier_chunks": MetricSpec(
        COUNTER, "Courier chunk send attempts (incl. retransmissions)"),
    "llmctl_fleet_courier_retries": MetricSpec(
        COUNTER, "Courier chunk retransmissions (lost, late, or "
                 "corrupt)"),
    "llmctl_fleet_courier_corruptions": MetricSpec(
        COUNTER, "Courier chunks rejected by CRC32 at the receiver"),
    "llmctl_fleet_courier_resumes": MetricSpec(
        COUNTER, "Courier resend rounds (only missing chunks resent)"),
    "llmctl_fleet_courier_aborts": MetricSpec(
        COUNTER, "Courier transfers that exhausted their retry budget "
                 "(payload dropped; destination re-prefilled)"),
    "llmctl_fleet_courier_wire_bytes": MetricSpec(
        COUNTER, "Courier bytes actually sent on the wire (post-codec, "
                 "retransmits included)"),
    "llmctl_fleet_courier_raw_bytes": MetricSpec(
        COUNTER, "Raw payload bytes the sent courier chunks covered "
                 "(pre-codec; raw/wire = effective compression ratio)"),
    "llmctl_fleet_courier_expired": MetricSpec(
        COUNTER, "Courier tickets evicted by TTL before being claimed "
                 "(abandoned reassembly buffers and unattached "
                 "payloads)"),
    "llmctl_fleet_courier_transfer_ms": MetricSpec(
        HISTOGRAM, "End-to-end courier transfer time per payload (ms)",
        buckets=_XFER_BUCKETS),
    # -- fleet-global prefix cache ----------------------------------------
    "llmctl_fleet_prefix_fetch_pages": MetricSpec(
        COUNTER, "Prefix pages fetched from another replica's cache "
                 "instead of re-prefilled"),
    "llmctl_fleet_prefix_fetch_bytes": MetricSpec(
        COUNTER, "Host bytes of fetched prefix pages moved over the "
                 "courier"),
    "llmctl_fleet_prefix_fetch_misses": MetricSpec(
        COUNTER, "Prefix fetches that found nothing at the owner "
                 "(evicted since advertised / stale hint) — degraded "
                 "to plain prefill"),
    "llmctl_fleet_prefix_fetch_aborts": MetricSpec(
        COUNTER, "Prefix fetches whose courier transfer failed — "
                 "degraded to plain prefill"),
    "llmctl_fleet_prefix_fetch_ms": MetricSpec(
        HISTOGRAM, "End-to-end prefix fetch time per attempt (ms; hint "
                   "-> pages imported or degraded)",
        buckets=_XFER_BUCKETS),
    "llmctl_fleet_prefix_inventory_cache_hits": MetricSpec(
        COUNTER, "Placements whose prefix-owner hints used the "
                 "TTL-cached inventory map"),
    "llmctl_fleet_prefix_inventory_cache_misses": MetricSpec(
        COUNTER, "Placements that re-read every replica's prefix "
                 "inventory (cache cold, expired, or invalidated)"),
    # -- tiered fleet KV store --------------------------------------------
    "llmctl_fleet_kvstore_hits": MetricSpec(
        COUNTER, "Prefix pages served from the host-tier KV store "
                 "(compressed frames replayed instead of re-prefilling "
                 "— the returning-conversation payoff)"),
    "llmctl_fleet_kvstore_misses": MetricSpec(
        COUNTER, "Store fetches that served nothing (entry evicted, "
                 "expired, or corrupt) — degraded to plain prefill"),
    "llmctl_fleet_kvstore_demotions": MetricSpec(
        COUNTER, "Prefix pages demoted into the store (HBM eviction "
                 "and drain/retire inventory flushes; encoded once)"),
    "llmctl_fleet_kvstore_evictions": MetricSpec(
        COUNTER, "Store entries dropped (capacity pressure past the "
                 "disk tier, TTL expiry, or failed verification)"),
    "llmctl_fleet_kvstore_bytes": MetricSpec(
        COUNTER, "Compressed wire bytes replayed out of the store on "
                 "fetch hits"),
    # -- networked KV fabric (standalone `llmctl fleet store`) -------------
    "llmctl_fleet_kvstore_remote_hits": MetricSpec(
        COUNTER, "Prefix pages replayed from the standalone store "
                 "SERVICE into this process (client-side count; the "
                 "service's own hits ride llmctl_fleet_kvstore_hits)"),
    "llmctl_fleet_kvstore_remote_misses": MetricSpec(
        COUNTER, "Store-service fetches that served zero pages here "
                 "(service unreachable, nothing held, or replay failed "
                 "verification) — degraded to plain prefill"),
    # -- replicated store tier (N members, one KV_STORE_OWNER) -------------
    "llmctl_fleet_kvstore_retry": MetricSpec(
        COUNTER, "Store-service RPC retries on transient errors "
                 "(connection refused/reset) before anything was "
                 "counted a miss — bounded, doubling backoff"),
    "llmctl_fleet_kvstore_failovers": MetricSpec(
        COUNTER, "Store RPCs answered by a member other than the "
                 "first one tried (health-gated endpoint rotation "
                 "after a member died or partitioned)"),
    "llmctl_fleet_kvstore_hedges": MetricSpec(
        COUNTER, "Hedged store fetches fired: a second member raced "
                 "because the first was slow past the hedge window"),
    "llmctl_fleet_kvstore_fenced_rejects": MetricSpec(
        COUNTER, "Writes refused by this store member with a FATAL "
                 "ack because it is fenced or a stale incarnation "
                 "(the zombie rule — never silently admitted)"),
    "llmctl_fleet_kvstore_sync_pulls": MetricSpec(
        COUNTER, "Entries (KV frames + weight chunks) this store "
                 "member pulled from peers during anti-entropy "
                 "reconciliation (un-counted in hit/serve ledgers)"),
    "llmctl_fleet_weights_chunks": MetricSpec(
        COUNTER, "Checkpoint chunks moved through the store service by "
                 "this process's weight courier (ships + fetches; "
                 "resumed chunks are NOT re-moved)"),
    "llmctl_fleet_weights_resumes": MetricSpec(
        COUNTER, "Weight ships/fetches that resumed a partial transfer "
                 "instead of restarting (upload: seqs the service "
                 "already held; download: verified spool records)"),
    "llmctl_fleet_weights_bytes": MetricSpec(
        COUNTER, "Wire bytes of checkpoint chunks moved through the "
                 "store service by this process"),
    # -- pipelined multi-replica prefill -----------------------------------
    "llmctl_fleet_pipeline_prefills": MetricSpec(
        COUNTER, "Long prompts split across the prefill pool as a "
                 "chunk pipeline (Mooncake-style chunked pipeline "
                 "parallelism)"),
    "llmctl_fleet_pipeline_stages": MetricSpec(
        COUNTER, "Prefill stages planned across all pipelined prompts "
                 "(stages / prefills = mean pipeline depth)"),
    "llmctl_fleet_pipeline_collapses": MetricSpec(
        COUNTER, "Pipelines degraded to single-replica prefill (stage "
                 "crash, courier chaos, pool-full, timeout) — counted, "
                 "never wrong tokens"),
    "llmctl_fleet_pipeline_preshipped_pages": MetricSpec(
        COUNTER, "KV pages shipped to the next stage's replica ahead "
                 "of its prefill (transfer hidden behind compute)"),
    "llmctl_fleet_pipeline_stage_ms": MetricSpec(
        HISTOGRAM, "Wall time per completed pipeline stage (submit -> "
                   "pages published, ms)",
        buckets=_XFER_BUCKETS),
    "llmctl_fleet_pipeline_preship_timeouts": MetricSpec(
        COUNTER, "Pre-ship deliveries the next stage's replica never "
                 "imported within the extract window (the transfer "
                 "falls back to the collapse path — counted, never "
                 "wrong tokens)"),
    "llmctl_fleet_store_hint_remote_skips": MetricSpec(
        COUNTER, "Placements where the KV store tier covered the "
                 "prompt best but the destination was a remote worker "
                 "that cannot reach it — the hint fell back to a live "
                 "owner (ROADMAP item-2 gap, now measurable)"),
    # -- fleet SSE streaming plane ----------------------------------------
    "llmctl_fleet_stream_active": MetricSpec(
        GAUGE, "Live SSE streams fleet-wide"),
    "llmctl_fleet_stream_tokens": MetricSpec(
        COUNTER, "Tokens accepted into fleet stream logs (seq-deduped)"),
    "llmctl_fleet_stream_duplicates": MetricSpec(
        COUNTER, "Producer token re-sends suppressed by sequence number "
                 "(re-placement resume replay; never client-visible)"),
    "llmctl_fleet_stream_replayed_tokens": MetricSpec(
        COUNTER, "Tokens replayed to reconnecting SSE clients "
                 "(Last-Event-ID tail)"),
    "llmctl_fleet_stream_reconnects": MetricSpec(
        COUNTER, "SSE reconnects served from the stream log"),
    "llmctl_fleet_stream_gaps_healed": MetricSpec(
        COUNTER, "Stream-log tokens recovered from the request's own "
                 "token list (publish callbacks lost to a crash "
                 "window)"),
    "llmctl_fleet_stream_backpressure_drops": MetricSpec(
        COUNTER, "SSE subscribers disconnected for exceeding the "
                 "per-subscriber buffered-batch cap "
                 "(stream_max_buffered_batches); the client replays "
                 "via Last-Event-ID"),
    "llmctl_fleet_stream_replay_tokens": MetricSpec(
        HISTOGRAM, "Tokens replayed per SSE reconnect (Last-Event-ID "
                   "tail size)",
        buckets=(1, 2, 5, 10, 25, 50, 100, 250, 1000)),
    "llmctl_fleet_stream_orphan_gcs": MetricSpec(
        COUNTER, "Unfinished stream logs collected because the router "
                 "no longer knew their request (opened, then died "
                 "outside the finish wiring)"),
    # -- HA front tier ----------------------------------------------------
    "llmctl_fleet_front_failovers": MetricSpec(
        COUNTER, "Front processes that died and were fenced by the "
                 "front tier (clients fail over to survivors)"),
    "llmctl_fleet_front_reconnects": MetricSpec(
        COUNTER, "SSE resumes served for streams ANOTHER front "
                 "terminated (the log arrived via the shared state "
                 "store) — each is a client surviving a front death"),
    "llmctl_fleet_front_up": MetricSpec(
        GAUGE, "1 while the front's store heartbeat is fresh and it is "
               "not fenced", ("front",)),
    "llmctl_fleet_front_active_streams": MetricSpec(
        GAUGE, "Live SSE subscriptions per front (store heartbeat "
               "info)", ("front",)),
    # -- speculative decode plane -----------------------------------------
    "llmctl_fleet_spec_dispatches": MetricSpec(
        COUNTER, "Fused speculative verify+decode dispatches "
                 "fleet-wide"),
    "llmctl_fleet_spec_drafts": MetricSpec(
        COUNTER, "Draft tokens proposed within adaptive windows "
                 "fleet-wide"),
    "llmctl_fleet_spec_accepted": MetricSpec(
        COUNTER, "Draft tokens verified/accepted by the device "
                 "fleet-wide"),
    "llmctl_fleet_spec_resumes": MetricSpec(
        COUNTER, "Slots armed from a MIGRATED SpecState (tuned window "
                 "kept across migration / prefill->decode handoff)"),
    # -- elastic autoscaler + SLO priority tiers ---------------------------
    "llmctl_fleet_autoscale_scale_ups": MetricSpec(
        COUNTER, "Replicas the autoscaler added (in-proc engine or "
                 "spawned `llmctl fleet worker` process) under "
                 "sustained queue pressure"),
    "llmctl_fleet_autoscale_scale_downs": MetricSpec(
        COUNTER, "Replicas the autoscaler retired through drain-with-"
                 "migration + store flush (scale-down costs zero "
                 "re-prefill tokens)"),
    "llmctl_fleet_autoscale_spawn_failures": MetricSpec(
        COUNTER, "Scale-up attempts whose worker never reported ready "
                 "(or whose adoption failed) — counted and fully "
                 "rolled back"),
    "llmctl_fleet_autoscale_retire_rollbacks": MetricSpec(
        COUNTER, "Retirements abandoned mid-drain (victim crashed or "
                 "the drain timed out) — the replica returns to "
                 "rotation or the crash path; no request is lost"),
    "llmctl_fleet_autoscale_preemptions": MetricSpec(
        COUNTER, "Best-effort residents migrated off a replica to "
                 "protect a queued interactive request's TTFT target "
                 "(KV moves with them — preempted, never dropped)"),
    "llmctl_fleet_replicas": MetricSpec(
        GAUGE, "Live fleet size under elastic scaling (provisioned + "
               "autoscaler-added - retired)"),
}


def scraped_name(name: str) -> str:
    """The sample base name Prometheus scrapes expose: counters gain a
    ``_total`` suffix (prometheus_client strips any declared one first,
    so registry names may or may not carry it)."""
    spec = METRICS[name]
    if spec.kind == COUNTER:
        base = name[:-len("_total")] if name.endswith("_total") else name
        return base + "_total"
    return name


def fleet_metric_names() -> list[str]:
    return [n for n in METRICS if n.startswith("llmctl_fleet_")]


class CounterFlow(NamedTuple):
    """One running counter's declared wiring: the attribute on its
    owning class, the key it must appear under in that class's
    snapshot/stats source, and the registered Prometheus name it
    ultimately feeds (None = deliberately process-local: exposed via
    /v1/stats, bench ledgers, and dryrun assertions but not scraped)."""
    owner: str           # class name ("InferenceEngine", ...)
    attr: str            # "total_*" attribute
    snapshot_key: str    # string key in the owner's snapshot function
    metric: Optional[str]


# Snapshot functions per owner (the counter-wiring pass scans these):
#   InferenceEngine.stats            (serve/engine.py)
#   ReplicaSupervisor.snapshot       (serve/fleet/supervisor.py)
#   FleetStreamHub.stats             (serve/fleet/streams.py)
#   FleetFrontTier.snapshot          (serve/fleet/front.py)
COUNTER_SNAPSHOT_FN = {
    "InferenceEngine": ("serve/engine.py", "stats"),
    "ReplicaSupervisor": ("serve/fleet/supervisor.py", "snapshot"),
    "FleetStreamHub": ("serve/fleet/streams.py", "stats"),
    "FleetFrontTier": ("serve/fleet/front.py", "snapshot"),
    "FleetKVStore": ("serve/fleet/kv_store.py", "snapshot"),
    "StoreClient": ("serve/fleet/store_service.py", "snapshot"),
    "StoreService": ("serve/fleet/store_service.py", "status_dict"),
    "WeightCourier": ("serve/fleet/weights.py", "snapshot"),
    "PipelineCoordinator": ("serve/fleet/pipeline.py", "snapshot"),
    "FleetAutoscaler": ("serve/fleet/autoscaler.py", "snapshot"),
}

COUNTER_FLOW: tuple[CounterFlow, ...] = (
    # engine counters -> InferenceEngine.stats() keys
    CounterFlow("InferenceEngine", "total_preemptions", "preemptions",
                "llmctl_inference_preemptions"),
    CounterFlow("InferenceEngine", "total_swap_ins", "swap_ins",
                "llmctl_inference_swap_ins"),
    CounterFlow("InferenceEngine", "total_decode_steps", "decode_steps",
                None),
    CounterFlow("InferenceEngine", "total_short_dispatches",
                "short_dispatches", None),
    CounterFlow("InferenceEngine", "total_prefill_tokens",
                "prefill_tokens", None),
    CounterFlow("InferenceEngine", "total_prefix_cached_tokens",
                "prefix_cached_tokens", None),
    # feeds reprefill_tokens_avoided through the supervisor snapshot's
    # migration section (replica.prefix_cache_stats -> requeue_cached)
    CounterFlow("InferenceEngine", "total_requeue_cached_tokens",
                "requeue_cached_tokens",
                "llmctl_fleet_reprefill_tokens_avoided"),
    CounterFlow("InferenceEngine", "total_prefix_fetched_tokens",
                "prefix_fetched_tokens", None),
    CounterFlow("InferenceEngine", "total_salvage_tail_fetched_tokens",
                "salvage_tail_fetched_tokens", None),
    CounterFlow("InferenceEngine", "total_unexpected_prefills",
                "unexpected_prefills", None),
    CounterFlow("InferenceEngine", "total_partial_restores",
                "partial_restores", None),
    CounterFlow("InferenceEngine", "total_padded_slot_steps",
                "padded_slot_steps", None),
    CounterFlow("InferenceEngine", "total_spec_dispatches",
                "spec_dispatches", "llmctl_fleet_spec_dispatches"),
    CounterFlow("InferenceEngine", "total_spec_drafts", "spec_drafts",
                "llmctl_fleet_spec_drafts"),
    CounterFlow("InferenceEngine", "total_spec_accepted",
                "spec_accepted", "llmctl_fleet_spec_accepted"),
    CounterFlow("InferenceEngine", "total_spec_resumes", "spec_resumes",
                "llmctl_fleet_spec_resumes"),
    # stream-hub counters -> FleetStreamHub.stats() keys (the supervisor
    # snapshot embeds them wholesale; the Prometheus pump deltas the
    # mapped ones)
    CounterFlow("FleetStreamHub", "total_opened", "opened", None),
    CounterFlow("FleetStreamHub", "total_finished", "finished", None),
    CounterFlow("FleetStreamHub", "total_tokens", "tokens",
                "llmctl_fleet_stream_tokens"),
    CounterFlow("FleetStreamHub", "total_duplicates", "duplicates",
                "llmctl_fleet_stream_duplicates"),
    CounterFlow("FleetStreamHub", "total_replayed", "replayed",
                "llmctl_fleet_stream_replayed_tokens"),
    CounterFlow("FleetStreamHub", "total_reconnects", "reconnects",
                "llmctl_fleet_stream_reconnects"),
    CounterFlow("FleetStreamHub", "total_gaps_healed", "gaps_healed",
                "llmctl_fleet_stream_gaps_healed"),
    CounterFlow("FleetStreamHub", "total_out_of_order", "out_of_order",
                None),
    CounterFlow("FleetStreamHub", "total_identity_mismatches",
                "identity_mismatches", None),
    CounterFlow("FleetStreamHub", "total_backpressure_drops",
                "backpressure_drops",
                "llmctl_fleet_stream_backpressure_drops"),
    CounterFlow("FleetStreamHub", "total_orphan_logs_gc",
                "orphan_logs_gc", "llmctl_fleet_stream_orphan_gcs"),
    CounterFlow("FleetStreamHub", "total_front_resumes",
                "front_resumes", "llmctl_fleet_front_reconnects"),
    # tiered-KV-store counters -> FleetKVStore.snapshot() keys (the
    # supervisor snapshot embeds the section wholesale; the Prometheus
    # pump deltas the mapped ones)
    CounterFlow("FleetKVStore", "total_hits", "hits",
                "llmctl_fleet_kvstore_hits"),
    CounterFlow("FleetKVStore", "total_misses", "misses",
                "llmctl_fleet_kvstore_misses"),
    CounterFlow("FleetKVStore", "total_demotions", "demotions",
                "llmctl_fleet_kvstore_demotions"),
    CounterFlow("FleetKVStore", "total_duplicates", "duplicates", None),
    CounterFlow("FleetKVStore", "total_evictions", "evictions",
                "llmctl_fleet_kvstore_evictions"),
    CounterFlow("FleetKVStore", "total_expired", "expired", None),
    CounterFlow("FleetKVStore", "total_spills", "spills", None),
    CounterFlow("FleetKVStore", "total_corrupt", "corrupt", None),
    CounterFlow("FleetKVStore", "total_bytes_served", "bytes_served",
                "llmctl_fleet_kvstore_bytes"),
    CounterFlow("FleetKVStore", "total_bytes_stored", "bytes_stored",
                None),
    # networked-store client counters -> StoreClient.snapshot() keys
    # (the duck stand-in for FleetKVStore when kv_store_endpoint is
    # set; the service's own counters merge into the same section
    # under the in-proc keys above)
    CounterFlow("StoreClient", "total_remote_hits", "remote_hits",
                "llmctl_fleet_kvstore_remote_hits"),
    CounterFlow("StoreClient", "total_remote_misses", "remote_misses",
                "llmctl_fleet_kvstore_remote_misses"),
    CounterFlow("StoreClient", "total_retries", "retries",
                "llmctl_fleet_kvstore_retry"),
    CounterFlow("StoreClient", "total_failovers", "failovers",
                "llmctl_fleet_kvstore_failovers"),
    CounterFlow("StoreClient", "total_hedges", "hedges",
                "llmctl_fleet_kvstore_hedges"),
    # replicated-tier service counters -> StoreService.status_dict()
    # kv_store-section keys (scraped off each member's /store/status)
    CounterFlow("StoreService", "total_fenced_rejects", "fenced_rejects",
                "llmctl_fleet_kvstore_fenced_rejects"),
    CounterFlow("StoreService", "total_sync_pulls", "sync_pulls",
                "llmctl_fleet_kvstore_sync_pulls"),
    CounterFlow("StoreService", "total_sync_rounds", "sync_rounds",
                None),
    # weight-courier counters -> WeightCourier.snapshot() keys (the
    # supervisor snapshot embeds the "weights" section wholesale)
    CounterFlow("WeightCourier", "total_chunks", "chunks",
                "llmctl_fleet_weights_chunks"),
    CounterFlow("WeightCourier", "total_resumes", "resumes",
                "llmctl_fleet_weights_resumes"),
    CounterFlow("WeightCourier", "total_failovers", "failovers", None),
    CounterFlow("WeightCourier", "total_bytes", "bytes",
                "llmctl_fleet_weights_bytes"),
    # pipelined-prefill counters -> PipelineCoordinator.snapshot() keys
    # (the supervisor snapshot embeds the section wholesale; the
    # Prometheus pump deltas the mapped ones)
    CounterFlow("PipelineCoordinator", "total_pipelines", "pipelines",
                "llmctl_fleet_pipeline_prefills"),
    CounterFlow("PipelineCoordinator", "total_pipelines_completed",
                "completed", None),
    CounterFlow("PipelineCoordinator", "total_pipeline_collapses",
                "collapses", "llmctl_fleet_pipeline_collapses"),
    CounterFlow("PipelineCoordinator", "total_pipeline_stages", "stages",
                "llmctl_fleet_pipeline_stages"),
    CounterFlow("PipelineCoordinator", "total_preshipped_pages",
                "preshipped_pages",
                "llmctl_fleet_pipeline_preshipped_pages"),
    CounterFlow("PipelineCoordinator", "total_preship_ms", "preship_ms",
                None),
    CounterFlow("PipelineCoordinator", "total_preship_hidden_ms",
                "preship_hidden_ms", None),
    CounterFlow("PipelineCoordinator", "total_pipeline_preship_timeouts",
                "preship_timeouts",
                "llmctl_fleet_pipeline_preship_timeouts"),
    # elastic autoscaler counters -> FleetAutoscaler.snapshot() keys
    # (the supervisor snapshot embeds the "autoscale" section wholesale)
    CounterFlow("FleetAutoscaler", "total_scale_ups", "scale_ups",
                "llmctl_fleet_autoscale_scale_ups"),
    CounterFlow("FleetAutoscaler", "total_scale_downs", "scale_downs",
                "llmctl_fleet_autoscale_scale_downs"),
    CounterFlow("FleetAutoscaler", "total_spawn_failures",
                "spawn_failures", "llmctl_fleet_autoscale_spawn_failures"),
    CounterFlow("FleetAutoscaler", "total_retire_rollbacks",
                "retire_rollbacks",
                "llmctl_fleet_autoscale_retire_rollbacks"),
    CounterFlow("FleetAutoscaler", "total_preemptions", "preemptions",
                "llmctl_fleet_autoscale_preemptions"),
    # front-tier counters -> FleetFrontTier.snapshot() keys
    CounterFlow("FleetFrontTier", "total_front_failovers", "failovers",
                "llmctl_fleet_front_failovers"),
    CounterFlow("FleetFrontTier", "total_front_respawns", "respawns",
                None),
    # supervisor counters -> ReplicaSupervisor.snapshot() keys
    # (per-replica restarts ride llmctl_fleet_replica_restarts; the
    # fleet-wide totals below are status-surface only)
    CounterFlow("ReplicaSupervisor", "total_restarts", "restarts", None),
    CounterFlow("ReplicaSupervisor", "total_rebalance_migrations",
                "rebalance_migrations", None),
    CounterFlow("ReplicaSupervisor", "total_reroles", "reroles", None),
    CounterFlow("ReplicaSupervisor", "total_role_promotions",
                "promotions", None),
    CounterFlow("ReplicaSupervisor", "total_role_demotions", "demotions",
                None),
)


# Counters of the port's engine features that the JAX engine lacks (swap
# preemption, chunked prefill, the decode dispatch and extend-prefill
# tallies): /v1/stats only. Kept apart so COUNTER_FLOW stays JAX's, entry
# for entry; the counter-wiring pass reads both.
PORT_COUNTER_FLOW: tuple[CounterFlow, ...] = (
    CounterFlow("InferenceEngine", "total_swap_outs", "swap_outs", None),
    CounterFlow("InferenceEngine", "total_swap_out_bytes", "swap_out_bytes",
                None),
    CounterFlow("InferenceEngine", "total_swap_fallbacks", "swap_fallbacks",
                None),
    CounterFlow("InferenceEngine", "total_chunked_prefills",
                "chunked_prefills", None),
    CounterFlow("InferenceEngine", "total_prefill_chunks", "prefill_chunks",
                None),
    CounterFlow("InferenceEngine", "total_dispatched_steps",
                "dispatched_steps", None),
    CounterFlow("InferenceEngine", "total_extend_prefills",
                "extend_prefills", None),
    CounterFlow("InferenceEngine", "total_paged_passes", "paged_passes",
                None),
)
