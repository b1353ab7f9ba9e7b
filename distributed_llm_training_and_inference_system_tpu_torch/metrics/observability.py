"""Observability: metrics collection and Prometheus/OTLP export (the JAX
package's ``metrics/observability.py``), on the standard library.

- ``MetricsCollector`` samples the host from ``/proc`` (CPU, memory,
  network and disk counters) and each visible card's memory from
  ``torch.cuda.mem_get_info`` (device-wide bytes in use and the card's
  total), on a background thread with a bounded history.
- ``Registry`` holds gauges, counters and histograms with labels and
  renders the Prometheus text format as prometheus_client 0.25's
  ``generate_latest`` prints it: a counter declared ``x`` (or
  ``x_total``) as ``x_total`` plus an ``x_created`` gauge, a histogram as
  cumulative ``_bucket{le=...}`` samples, ``_count`` and ``_sum`` plus
  ``_created``, label pairs sorted by name, values as Go prints floats.
  The ``process_*``/``python_*`` series of prometheus_client are not
  emitted.
- ``PrometheusExporter`` builds one metric per ``names.METRICS`` entry and
  serves the registry on its own port (``serve()``; port 0 binds a free
  one). A failure to bind raises. ``export_fleet`` takes the fleet
  supervisor's snapshot, as the JAX exporter does.
- ``OTLPExporter`` imports ``opentelemetry`` when built, as the JAX
  package does; without it, it raises naming the missing package.
- ``ObservabilityManager`` composes them; unlike the JAX manager it lets
  an exporter that fails to start raise. ``prometheus_port=0`` serves on
  a free port (the JAX manager takes 0 as off); ``None`` is off.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import torch

from .names import COUNTER, GAUGE, HISTOGRAM, METRICS

logger = logging.getLogger("llmctl.metrics")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- host and card readings ----------------------------------------------------

def _cpu_times() -> tuple[float, float]:
    """(idle, total) jiffies of all CPUs from /proc/stat."""
    with open("/proc/stat") as f:
        fields = [float(x) for x in f.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0.0)  # + iowait
    return idle, sum(fields[:8])


class CpuPercent:
    """psutil's ``cpu_percent(interval=None)``: the busy share of all CPUs
    since the previous call (0.0 on the first)."""

    def __init__(self):
        self._last: Optional[tuple[float, float]] = None

    def __call__(self) -> float:
        now = _cpu_times()
        last, self._last = self._last, now
        if last is None or now[1] <= last[1]:
            return 0.0
        return 100.0 * (1.0 - (now[0] - last[0]) / (now[1] - last[1]))


def memory_info() -> dict:
    """Host memory from /proc/meminfo in bytes: total, available, used
    (total - available) and percent."""
    vals = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            vals[key] = float(rest.split()[0]) * 1024.0
    total = vals["MemTotal"]
    avail = vals.get("MemAvailable", vals.get("MemFree", 0.0))
    return {"total": total, "available": avail, "used": total - avail,
            "percent": round(100.0 * (total - avail) / total, 1)}


def _net_bytes() -> tuple[float, float]:
    """(sent, received) bytes over every interface from /proc/net/dev."""
    sent = recv = 0.0
    with open("/proc/net/dev") as f:
        for line in f.readlines()[2:]:
            cols = line.split(":", 1)[1].split()
            recv += float(cols[0])
            sent += float(cols[8])
    return sent, recv


def _disk_bytes() -> Optional[tuple[float, float]]:
    """(read, written) bytes of the whole disks (those in /sys/block) from
    /proc/diskstats; None where the kernel exposes neither."""
    try:
        with open("/proc/diskstats") as f:
            lines = f.readlines()
        disks = set(os.listdir("/sys/block"))
    except OSError:
        return None
    read = written = 0.0
    for line in lines:
        cols = line.split()
        if len(cols) > 9 and cols[2] in disks:
            read += float(cols[5]) * 512.0
            written += float(cols[9]) * 512.0
    return read, written


def card_memory() -> dict[int, tuple[float, float]]:
    """{card index: (bytes in use, total bytes)} of every visible card,
    device-wide as nvidia-smi counts them; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[i] = (float(total - free), float(total))
    return out


@dataclass
class SystemSample:
    timestamp: float
    cpu_percent: float
    mem_percent: float
    mem_used_gb: float
    net_sent_mbps: float
    net_recv_mbps: float
    disk_read_mbps: float
    disk_write_mbps: float
    hbm_used_gb: dict[int, float] = field(default_factory=dict)
    hbm_limit_gb: dict[int, float] = field(default_factory=dict)


class MetricsCollector:
    """Background sampler: host stats from /proc and each card's memory,
    at ``interval`` seconds, with a bounded history."""

    def __init__(self, interval: float = 1.0, history: int = 1000):
        self.interval = interval
        self.history: collections.deque[SystemSample] = collections.deque(
            maxlen=history)
        self.training: collections.deque[dict] = collections.deque(maxlen=history)
        self.inference: collections.deque[dict] = collections.deque(maxlen=history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cpu = CpuPercent()
        self._last_net = None
        self._last_disk = None

    def sample_once(self) -> SystemSample:
        now = time.time()
        net = _net_bytes()
        disk = _disk_bytes()
        net_sent = net_recv = disk_r = disk_w = 0.0
        if self._last_net is not None:
            t0, n0 = self._last_net
            dt = max(now - t0, 1e-3)
            net_sent = (net[0] - n0[0]) / dt / 1e6 * 8
            net_recv = (net[1] - n0[1]) / dt / 1e6 * 8
        if disk is not None and self._last_disk is not None:
            t0, d0 = self._last_disk
            dt = max(now - t0, 1e-3)
            disk_r = (disk[0] - d0[0]) / dt / 1e6
            disk_w = (disk[1] - d0[1]) / dt / 1e6
        self._last_net = (now, net)
        if disk is not None:
            self._last_disk = (now, disk)
        cards = card_memory()
        mem = memory_info()
        sample = SystemSample(
            timestamp=now, cpu_percent=self._cpu(),
            mem_percent=mem["percent"], mem_used_gb=mem["used"] / 1e9,
            net_sent_mbps=net_sent, net_recv_mbps=net_recv,
            disk_read_mbps=disk_r, disk_write_mbps=disk_w,
            hbm_used_gb={i: u / 1e9 for i, (u, _) in cards.items()},
            hbm_limit_gb={i: t / 1e9 for i, (_, t) in cards.items()})
        self.history.append(sample)
        return sample

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.sample_once()
                except Exception:  # keep the sampler alive, say why
                    logger.exception("metrics sample failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="llmctl-metrics")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def record_training(self, payload: dict) -> None:
        self.training.append({"timestamp": time.time(), **payload})

    def record_inference(self, payload: dict) -> None:
        self.inference.append({"timestamp": time.time(), **payload})

    def summary(self) -> dict:
        out: dict[str, Any] = {}
        if self.history:
            s = self.history[-1]
            out["system"] = {
                "cpu_percent": s.cpu_percent, "mem_percent": s.mem_percent,
                "hbm_used_gb": s.hbm_used_gb, "hbm_limit_gb": s.hbm_limit_gb,
            }
        if self.training:
            out["training"] = dict(self.training[-1])
        if self.inference:
            recent = list(self.inference)[-100:]
            lat = sorted(r.get("latency_ms", 0.0) for r in recent)
            out["inference"] = {
                "requests": len(recent),
                "p50_latency_ms": lat[len(lat) // 2] if lat else 0.0,
                "p99_latency_ms": lat[int(len(lat) * 0.99)] if lat else 0.0,
            }
        return out


# -- the registry and its text format ----------------------------------------

def go_float(d: float) -> str:
    """A float as prometheus_client's ``floatToGoString`` prints it."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:            # Go switches to exponents sooner
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _sample(name: str, labels: dict, value: float) -> str:
    if labels:
        pairs = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{pairs}}} {go_float(value)}\n"
    return f"{name} {go_float(value)}\n"


class _Child:
    """One label combination of a metric: its value (gauge, counter) or
    bucket counts and sum (histogram), and its creation time."""

    def __init__(self, metric: "Metric"):
        self._metric = metric
        self.created = time.time()
        self.value = 0.0
        self.buckets = [0.0] * len(metric.buckets)
        self.sum = 0.0

    def set(self, value: float) -> None:
        if self._metric.kind != GAUGE:
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        with self._metric.lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == HISTOGRAM:
            raise TypeError(f"{self._metric.name} is a histogram")
        if self._metric.kind == COUNTER and amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        with self._metric.lock:
            self.value += float(amount)

    def observe(self, amount: float) -> None:
        if self._metric.kind != HISTOGRAM:
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        amount = float(amount)
        with self._metric.lock:
            self.sum += amount
            for i, bound in enumerate(self._metric.buckets):
                if amount <= bound:
                    self.buckets[i] += 1.0
                    break


class Metric:
    """A gauge, counter or histogram with named labels. A metric without
    labels has its one child from construction; ``labels(**values)`` makes
    or finds a labelled child."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: tuple = (), buckets: Optional[tuple] = None,
                 lock: Optional[threading.Lock] = None):
        if kind not in (GAUGE, COUNTER, HISTOGRAM):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.lock = lock or threading.Lock()
        self.buckets: tuple = ()
        if kind == HISTOGRAM:
            if not buckets:
                raise ValueError(f"histogram {name} needs its buckets")
            bounds = [float(b) for b in buckets]
            if bounds != sorted(bounds):
                raise ValueError("Buckets not in sorted order")
            if bounds[-1] != math.inf:
                bounds.append(math.inf)
            self.buckets = tuple(bounds)
        self._children: dict[tuple, _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)

    def labels(self, **values) -> _Child:
        if sorted(values) != sorted(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {sorted(values)}")
        key = tuple(str(values[k]) for k in self.labelnames)
        with self.lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
        return child

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}: "
                             "call labels() first")
        return self._children[()]

    def set(self, value: float) -> None:
        self._only().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render(self) -> str:
        with self.lock:
            children = [(dict(zip(self.labelnames, key)), child)
                        for key, child in self._children.items()]
            if self.kind == COUNTER:
                base = self.name.removesuffix("_total")
                lines = [f"# HELP {base}_total {_escape_help(self.help)}\n",
                         f"# TYPE {base}_total counter\n"]
                lines += [_sample(base + "_total", lb, c.value)
                          for lb, c in children]
            else:
                base = self.name
                lines = [f"# HELP {base} {_escape_help(self.help)}\n",
                         f"# TYPE {base} {self.kind}\n"]
                for lb, c in children:
                    if self.kind == GAUGE:
                        lines.append(_sample(base, lb, c.value))
                        continue
                    acc = 0.0
                    for bound, n in zip(self.buckets, c.buckets):
                        acc += n
                        lines.append(_sample(base + "_bucket",
                                             {**lb, "le": go_float(bound)},
                                             acc))
                    lines.append(_sample(base + "_count", lb, acc))
                    lines.append(_sample(base + "_sum", lb, c.sum))
            if self.kind != GAUGE and children:
                lines += [f"# HELP {base}_created {_escape_help(self.help)}\n",
                          f"# TYPE {base}_created gauge\n"]
                lines += [_sample(base + "_created", lb, c.created)
                          for lb, c in children]
        return "".join(lines)


class Registry:
    """An ordered set of metrics, rendered in registration order."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"Duplicated timeseries in Registry: "
                                 f"{metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def render(self) -> bytes:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.render() for m in metrics).encode("utf-8")


def serve_registry(registry: Registry, port: int, host: str = ""
                   ) -> ThreadingHTTPServer:
    """An HTTP server answering ``GET /metrics`` (and ``/``) with the
    registry's text, on a daemon thread; port 0 binds a free port
    (``server.server_address[1]``). Binding errors raise."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("%s - " + fmt, self.address_string(), *args)

        def do_GET(self):
            if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = registry.render()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="llmctl-prometheus").start()
    return server


# -- exporters ------------------------------------------------------------------

class PrometheusExporter:
    """The ``llmctl_*`` gauges, counters and histograms of ``names.METRICS``
    in a registry of the exporter's own, scraped on ``port``."""

    def __init__(self, port: int = 9100):
        self.port = port
        self.registry = Registry()
        for name, spec in METRICS.items():
            self.registry.register(Metric(name, spec.kind, spec.help,
                                          spec.labels, spec.buckets))
        mk = self.registry.__getitem__
        self.train_loss = mk("llmctl_train_loss")
        self.train_mfu = mk("llmctl_train_mfu")
        self.tokens_per_sec = mk("llmctl_train_tokens_per_sec")
        self.tokens_per_sec_chip = mk("llmctl_train_tokens_per_sec_per_chip")
        self.grad_norm = mk("llmctl_train_grad_norm")
        self.lr = mk("llmctl_train_lr")
        self.steps = mk("llmctl_train_step")
        self.eval_loss = mk("llmctl_eval_loss")
        self.hbm_used = mk("llmctl_hbm_used_gb")
        self.cpu = mk("llmctl_cpu_percent")
        self.mem = mk("llmctl_mem_percent")
        self.infer_requests = mk("llmctl_inference_requests_total")
        self.infer_latency = mk("llmctl_inference_latency_seconds")
        self.infer_ttft = mk("llmctl_inference_ttft_seconds")
        self.infer_queue = mk("llmctl_inference_queue_depth")
        self.decode_tokens_per_sec = mk("llmctl_decode_tokens_per_sec")
        # the engine reports running totals: export_inference incs the
        # delta over the largest total seen (the server's handler threads
        # report concurrently, so a smaller total may arrive late)
        self.infer_preemptions = mk("llmctl_inference_preemptions")
        self.infer_swap_ins = mk("llmctl_inference_swap_ins")
        self.infer_swapped_bytes = mk("llmctl_inference_swapped_host_bytes")
        # serve-fleet control plane (serve/fleet/): per-replica health the
        # operator alarms on. Queue depth + outstanding tokens are the
        # routing signals themselves; restarts/requeues/rejections are the
        # failure-path counters the fault-injection tests exercise.
        self.fleet_queue_depth = mk("llmctl_fleet_replica_queue_depth")
        self.fleet_outstanding = mk(
            "llmctl_fleet_replica_outstanding_tokens")
        self.fleet_active = mk("llmctl_fleet_replica_active")
        self.fleet_healthy = mk("llmctl_fleet_replica_healthy")
        self.fleet_restarts = mk("llmctl_fleet_replica_restarts")
        self.fleet_requeues = mk("llmctl_fleet_requeues")
        self.fleet_rejected = mk("llmctl_fleet_rejected")
        # KV migration plane (serve/fleet/migration.py): how much work
        # moved between replicas and what it saved vs re-prefill
        self.fleet_migrations = mk("llmctl_fleet_migrations")
        self.fleet_migrated_tokens = mk("llmctl_fleet_migrated_tokens")
        self.fleet_reprefill_avoided = mk(
            "llmctl_fleet_reprefill_tokens_avoided")
        self.fleet_migration_pause = mk("llmctl_fleet_migration_pause_ms")
        self.fleet_prefix_hit_rate = mk(
            "llmctl_fleet_replica_prefix_hit_rate")
        # disaggregated prefill/decode plane (serve/fleet/ roles)
        self.fleet_handoffs = mk("llmctl_fleet_handoffs")
        self.fleet_handoff_stall = mk("llmctl_fleet_handoff_stall_ms")
        self.fleet_replica_role = mk("llmctl_fleet_replica_role")
        # courier transport plane (serve/fleet/transport.py)
        self.fleet_courier_chunks = mk("llmctl_fleet_courier_chunks")
        self.fleet_courier_retries = mk("llmctl_fleet_courier_retries")
        self.fleet_courier_corruptions = mk(
            "llmctl_fleet_courier_corruptions")
        self.fleet_courier_resumes = mk("llmctl_fleet_courier_resumes")
        self.fleet_courier_aborts = mk("llmctl_fleet_courier_aborts")
        self.fleet_courier_wire_bytes = mk(
            "llmctl_fleet_courier_wire_bytes")
        self.fleet_courier_raw_bytes = mk(
            "llmctl_fleet_courier_raw_bytes")
        self.fleet_courier_expired = mk("llmctl_fleet_courier_expired")
        self.fleet_courier_transfer = mk(
            "llmctl_fleet_courier_transfer_ms")
        # fleet-global prefix cache (serve/fleet/ prefix fetch)
        self.fleet_prefix_fetch_pages = mk(
            "llmctl_fleet_prefix_fetch_pages")
        self.fleet_prefix_fetch_bytes = mk(
            "llmctl_fleet_prefix_fetch_bytes")
        self.fleet_prefix_fetch_misses = mk(
            "llmctl_fleet_prefix_fetch_misses")
        self.fleet_prefix_fetch_aborts = mk(
            "llmctl_fleet_prefix_fetch_aborts")
        self.fleet_prefix_fetch = mk("llmctl_fleet_prefix_fetch_ms")
        # inventory TTL cache (FleetConfig.prefix_inventory_ttl_ms)
        self.fleet_inventory_cache_hits = mk(
            "llmctl_fleet_prefix_inventory_cache_hits")
        self.fleet_inventory_cache_misses = mk(
            "llmctl_fleet_prefix_inventory_cache_misses")
        # tiered fleet KV store (serve/fleet/kv_store.py)
        self.fleet_kvstore_hits = mk("llmctl_fleet_kvstore_hits")
        self.fleet_kvstore_misses = mk("llmctl_fleet_kvstore_misses")
        self.fleet_kvstore_demotions = mk(
            "llmctl_fleet_kvstore_demotions")
        self.fleet_kvstore_evictions = mk(
            "llmctl_fleet_kvstore_evictions")
        self.fleet_kvstore_bytes = mk("llmctl_fleet_kvstore_bytes")
        # networked KV fabric: the standalone-store client's own view
        # (serve/fleet/store_service.py) + courier weight distribution
        # (serve/fleet/weights.py)
        self.fleet_kvstore_remote_hits = mk(
            "llmctl_fleet_kvstore_remote_hits")
        self.fleet_kvstore_remote_misses = mk(
            "llmctl_fleet_kvstore_remote_misses")
        # replicated store tier (serve/fleet/store_tier.py): client
        # failover + member fencing/anti-entropy
        self.fleet_kvstore_retry = mk("llmctl_fleet_kvstore_retry")
        self.fleet_kvstore_failovers = mk(
            "llmctl_fleet_kvstore_failovers")
        self.fleet_kvstore_hedges = mk("llmctl_fleet_kvstore_hedges")
        self.fleet_kvstore_fenced_rejects = mk(
            "llmctl_fleet_kvstore_fenced_rejects")
        self.fleet_kvstore_sync_pulls = mk(
            "llmctl_fleet_kvstore_sync_pulls")
        self.fleet_weights_chunks = mk("llmctl_fleet_weights_chunks")
        self.fleet_weights_resumes = mk("llmctl_fleet_weights_resumes")
        self.fleet_weights_bytes = mk("llmctl_fleet_weights_bytes")
        # pipelined multi-replica prefill (serve/fleet/pipeline.py)
        self.fleet_pipeline_prefills = mk(
            "llmctl_fleet_pipeline_prefills")
        self.fleet_pipeline_stages = mk("llmctl_fleet_pipeline_stages")
        self.fleet_pipeline_collapses = mk(
            "llmctl_fleet_pipeline_collapses")
        self.fleet_pipeline_preshipped_pages = mk(
            "llmctl_fleet_pipeline_preshipped_pages")
        self.fleet_pipeline_stage = mk("llmctl_fleet_pipeline_stage_ms")
        self.fleet_pipeline_preship_timeouts = mk(
            "llmctl_fleet_pipeline_preship_timeouts")
        self.fleet_store_hint_remote_skips = mk(
            "llmctl_fleet_store_hint_remote_skips")
        # fleet SSE streaming (serve/fleet/streams.py): the exactly-once
        # delivery ledger
        self.fleet_stream_active = mk("llmctl_fleet_stream_active")
        self.fleet_stream_tokens = mk("llmctl_fleet_stream_tokens")
        self.fleet_stream_duplicates = mk(
            "llmctl_fleet_stream_duplicates")
        self.fleet_stream_replayed = mk(
            "llmctl_fleet_stream_replayed_tokens")
        self.fleet_stream_reconnects = mk(
            "llmctl_fleet_stream_reconnects")
        self.fleet_stream_gaps_healed = mk(
            "llmctl_fleet_stream_gaps_healed")
        self.fleet_stream_backpressure_drops = mk(
            "llmctl_fleet_stream_backpressure_drops")
        self.fleet_stream_replay = mk("llmctl_fleet_stream_replay_tokens")
        self.fleet_stream_orphan_gcs = mk(
            "llmctl_fleet_stream_orphan_gcs")
        # HA front tier (serve/fleet/front.py + state.py)
        self.fleet_front_failovers = mk("llmctl_fleet_front_failovers")
        self.fleet_front_reconnects = mk(
            "llmctl_fleet_front_reconnects")
        self.fleet_front_up = mk("llmctl_fleet_front_up")
        self.fleet_front_active_streams = mk(
            "llmctl_fleet_front_active_streams")
        # speculative decode plane (serve/speculative.py SpecState)
        self.fleet_spec_dispatches = mk("llmctl_fleet_spec_dispatches")
        self.fleet_spec_drafts = mk("llmctl_fleet_spec_drafts")
        self.fleet_spec_accepted = mk("llmctl_fleet_spec_accepted")
        self.fleet_spec_resumes = mk("llmctl_fleet_spec_resumes")
        # elastic autoscaler + SLO tiers (serve/fleet/autoscaler.py)
        self.fleet_autoscale_scale_ups = mk(
            "llmctl_fleet_autoscale_scale_ups")
        self.fleet_autoscale_scale_downs = mk(
            "llmctl_fleet_autoscale_scale_downs")
        self.fleet_autoscale_spawn_failures = mk(
            "llmctl_fleet_autoscale_spawn_failures")
        self.fleet_autoscale_retire_rollbacks = mk(
            "llmctl_fleet_autoscale_retire_rollbacks")
        self.fleet_autoscale_preemptions = mk(
            "llmctl_fleet_autoscale_preemptions")
        self.fleet_replicas = mk("llmctl_fleet_replicas")
        self._last_totals: dict[str, float] = {}
        self._totals_lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None

    def render(self) -> bytes:
        return self.registry.render()

    def serve(self) -> int:
        """Start the scrape endpoint (once); the bound port."""
        if self._server is None:
            self._server = serve_registry(self.registry, self.port)
            self.port = self._server.server_address[1]
        return self.port

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def export_system(self, sample: SystemSample) -> None:
        self.cpu.set(sample.cpu_percent)
        self.mem.set(sample.mem_percent)
        for dev, used in sample.hbm_used_gb.items():
            self.hbm_used.labels(device=str(dev)).set(used)

    def export_training(self, m: dict) -> None:
        # a CPU run reports mfu None (MFU is a card's figure): not set
        for key, gauge in (("loss", self.train_loss), ("mfu", self.train_mfu),
                           ("tokens_per_sec", self.tokens_per_sec),
                           ("tokens_per_sec_per_chip",
                            self.tokens_per_sec_chip),
                           ("grad_norm", self.grad_norm), ("lr", self.lr),
                           ("step", self.steps)):
            if m.get(key) is not None:
                gauge.set(m[key])

    def export_inference(self, m: dict) -> None:
        self.infer_requests.inc()
        if "latency_ms" in m:
            self.infer_latency.observe(m["latency_ms"] / 1e3)
        if "ttft_ms" in m and m["ttft_ms"] is not None:
            self.infer_ttft.observe(m["ttft_ms"] / 1e3)
        if "queue_depth" in m:
            self.infer_queue.set(m["queue_depth"])
        if "decode_tokens_per_sec" in m:
            self.decode_tokens_per_sec.set(m["decode_tokens_per_sec"])
        for key, counter in (("preemptions", self.infer_preemptions),
                             ("swap_ins", self.infer_swap_ins)):
            if key in m:
                with self._totals_lock:
                    last = self._last_totals.get(key, 0)
                    if m[key] > last:
                        counter.inc(m[key] - last)
                        self._last_totals[key] = m[key]
        if "swapped_host_bytes" in m:
            self.infer_swapped_bytes.set(m["swapped_host_bytes"])

    def export_fleet(self, snap: dict) -> None:
        """Export a supervisor snapshot (serve/fleet/supervisor.py
        ``snapshot()``): per-replica gauges and the fleet's counters, each
        counter inc'ed by its running total's growth since the last
        snapshot; the histograms take the newest entries of their bounded
        windows. Sections the port's fleet never fills (the KV store,
        the weight courier, the fronts) stay at zero."""
        with self._totals_lock:
            self._export_fleet(snap)

    def _export_fleet(self, snap: dict) -> None:
        """Export a supervisor snapshot (serve/fleet/supervisor.py
        ``snapshot()``): per-replica gauges + fleet counters. Counters
        arrive as running totals, so the delta since the last snapshot is
        inc'ed (same convention as preemptions/swap_ins above)."""
        for rep in snap.get("replicas", []):
            rid = str(rep["replica"])
            self.fleet_queue_depth.labels(replica=rid).set(
                rep.get("queue_depth", 0))
            self.fleet_outstanding.labels(replica=rid).set(
                rep.get("outstanding_tokens", 0))
            self.fleet_active.labels(replica=rid).set(rep.get("active", 0))
            self.fleet_healthy.labels(replica=rid).set(
                1.0 if rep.get("state") == "healthy" else 0.0)
            key = f"fleet_restarts_{rid}"
            delta = rep.get("restarts", 0) - self._last_totals.get(key, 0)
            if delta > 0:
                self.fleet_restarts.labels(replica=rid).inc(delta)
            self._last_totals[key] = rep.get("restarts", 0)
            if "prefix_hit_rate" in rep:
                self.fleet_prefix_hit_rate.labels(replica=rid).set(
                    rep["prefix_hit_rate"])
            if "role" in rep:
                self.fleet_replica_role.labels(replica=rid).set(
                    {"mixed": 0, "prefill": 1, "decode": 2}.get(
                        rep["role"], 0))
        router = snap.get("router", {})
        for key, counter in (
                ("requeues", self.fleet_requeues),
                ("rejected", self.fleet_rejected),
                ("inventory_cache_hits", self.fleet_inventory_cache_hits),
                ("inventory_cache_misses",
                 self.fleet_inventory_cache_misses),
                ("store_hint_remote_skips",
                 self.fleet_store_hint_remote_skips)):
            total = router.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_{key}"] = total
        mig = snap.get("migration", {})
        for key, counter in (
                ("migrations", self.fleet_migrations),
                ("migrated_tokens", self.fleet_migrated_tokens),
                ("reprefill_tokens_avoided", self.fleet_reprefill_avoided)):
            total = mig.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_mig_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_mig_{key}"] = total
        # pauses arrive as a bounded recent list + a cumulative count:
        # observe only the count delta's worth of newest entries, so a
        # repeated snapshot can't double-fill the histogram
        count = mig.get("pause_count", 0)
        new = int(count - self._last_totals.get("fleet_mig_pauses", 0))
        pauses = mig.get("pauses_ms", [])
        if new > 0:
            for p in pauses[-min(new, len(pauses)):]:
                self.fleet_migration_pause.observe(p)
        self._last_totals["fleet_mig_pauses"] = count
        # disaggregation plane: handoff counter + stall histogram follow
        # the same delta-on-running-totals contract as migration above
        ho = snap.get("handoff", {})
        total = ho.get("handoffs", 0)
        delta = total - self._last_totals.get("fleet_handoffs", 0)
        if delta > 0:
            self.fleet_handoffs.inc(delta)
        self._last_totals["fleet_handoffs"] = total
        count = ho.get("stall_count", 0)
        new = int(count - self._last_totals.get("fleet_handoff_stalls", 0))
        stalls = ho.get("stalls_ms", [])
        if new > 0:
            for s in stalls[-min(new, len(stalls)):]:
                self.fleet_handoff_stall.observe(s)
        self._last_totals["fleet_handoff_stalls"] = count
        # courier transport plane: counters on running totals, the
        # transfer histogram on the bounded recent window (same delta
        # contract as migration pauses / handoff stalls above)
        cour = snap.get("courier", {})
        for key, counter in (
                ("chunks", self.fleet_courier_chunks),
                ("retries", self.fleet_courier_retries),
                ("corruptions", self.fleet_courier_corruptions),
                ("resumes", self.fleet_courier_resumes),
                ("aborts", self.fleet_courier_aborts),
                ("bytes_wire", self.fleet_courier_wire_bytes),
                ("bytes_raw", self.fleet_courier_raw_bytes),
                ("expired", self.fleet_courier_expired)):
            total = cour.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_cour_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_cour_{key}"] = total
        count = cour.get("transfer_count", 0)
        new = int(count - self._last_totals.get("fleet_cour_transfers", 0))
        xfers = cour.get("transfer_ms", [])
        if new > 0:
            for t in xfers[-min(new, len(xfers)):]:
                self.fleet_courier_transfer.observe(t)
        self._last_totals["fleet_cour_transfers"] = count
        # fleet-global prefix-fetch plane: same delta-on-running-totals
        # contract; the latency histogram fills from the bounded recent
        # window gated by the cumulative attempt count
        pf = snap.get("prefix_fetch", {})
        for key, counter in (
                ("pages", self.fleet_prefix_fetch_pages),
                ("bytes", self.fleet_prefix_fetch_bytes),
                ("misses", self.fleet_prefix_fetch_misses),
                ("aborts", self.fleet_prefix_fetch_aborts)):
            total = pf.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_pf_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_pf_{key}"] = total
        count = pf.get("fetch_count", 0)
        new = int(count - self._last_totals.get("fleet_pf_fetches", 0))
        window = pf.get("fetch_ms", [])
        if new > 0:
            for t in window[-min(new, len(window)):]:
                self.fleet_prefix_fetch.observe(t)
        self._last_totals["fleet_pf_fetches"] = count
        # tiered fleet KV store: demotion/hit/miss/eviction counters and
        # the compressed bytes replayed on hits, delta'd from the
        # snapshot's running totals like every other fleet counter
        ks = snap.get("kv_store", {})
        for key, counter in (
                ("hits", self.fleet_kvstore_hits),
                ("misses", self.fleet_kvstore_misses),
                ("demotions", self.fleet_kvstore_demotions),
                ("evictions", self.fleet_kvstore_evictions),
                ("bytes_served", self.fleet_kvstore_bytes),
                # networked backend only: the client-side replay/miss
                # counts (the in-proc store never sets these keys)
                ("remote_hits", self.fleet_kvstore_remote_hits),
                ("remote_misses", self.fleet_kvstore_remote_misses),
                # replicated tier: client failover counters plus the
                # member-side fencing/anti-entropy counts (the latter
                # appear when this process scrapes a member's status)
                ("retries", self.fleet_kvstore_retry),
                ("failovers", self.fleet_kvstore_failovers),
                ("hedges", self.fleet_kvstore_hedges),
                ("fenced_rejects", self.fleet_kvstore_fenced_rejects),
                ("sync_pulls", self.fleet_kvstore_sync_pulls)):
            total = ks.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_ks_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_ks_{key}"] = total
        # courier weight distribution: chunks/resumes/bytes this
        # process moved through the store service (supervisor snapshot
        # "weights" section; running totals like every fleet counter)
        wt = snap.get("weights", {})
        for key, counter in (
                ("chunks", self.fleet_weights_chunks),
                ("resumes", self.fleet_weights_resumes),
                ("bytes", self.fleet_weights_bytes)):
            total = wt.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_wt_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_wt_{key}"] = total
        # pipelined multi-replica prefill: counters on running totals,
        # the stage-latency histogram on the bounded recent window gated
        # by the cumulative stage count (same contract as courier
        # transfers above)
        pl = snap.get("pipeline", {})
        for key, counter in (
                ("pipelines", self.fleet_pipeline_prefills),
                ("stages", self.fleet_pipeline_stages),
                ("collapses", self.fleet_pipeline_collapses),
                ("preshipped_pages",
                 self.fleet_pipeline_preshipped_pages),
                ("preship_timeouts",
                 self.fleet_pipeline_preship_timeouts)):
            total = pl.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_pl_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_pl_{key}"] = total
        count = pl.get("stage_count", 0)
        new = int(count - self._last_totals.get("fleet_pl_stages_obs", 0))
        window = pl.get("stage_ms", [])
        if new > 0:
            for t in window[-min(new, len(window)):]:
                self.fleet_pipeline_stage.observe(t)
        self._last_totals["fleet_pl_stages_obs"] = count
        # speculative-decode plane: per-replica counters arrive fleet-
        # aggregated as running totals (supervisor snapshot "spec"
        # section); the pump deltas them like every other fleet counter
        sp = snap.get("spec", {})
        for key, counter in (
                ("dispatches", self.fleet_spec_dispatches),
                ("drafts", self.fleet_spec_drafts),
                ("accepted", self.fleet_spec_accepted),
                ("resumes", self.fleet_spec_resumes)):
            total = sp.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_sp_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_sp_{key}"] = total
        # fleet SSE streaming plane: counters on running totals; the
        # replay-size histogram fills from the bounded recent window
        # gated by the cumulative reconnect count (same delta contract)
        st = snap.get("streams", {})
        if st:
            self.fleet_stream_active.set(st.get("active", 0))
        for key, counter in (
                ("tokens", self.fleet_stream_tokens),
                ("duplicates", self.fleet_stream_duplicates),
                ("replayed", self.fleet_stream_replayed),
                ("reconnects", self.fleet_stream_reconnects),
                ("gaps_healed", self.fleet_stream_gaps_healed),
                ("backpressure_drops",
                 self.fleet_stream_backpressure_drops),
                ("orphan_logs_gc", self.fleet_stream_orphan_gcs),
                ("front_resumes", self.fleet_front_reconnects)):
            total = st.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_st_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_st_{key}"] = total
        count = st.get("replay_count", 0)
        new = int(count - self._last_totals.get("fleet_st_replays", 0))
        sizes = st.get("replay_sizes", [])
        if new > 0:
            for s in sizes[-min(new, len(sizes)):]:
                self.fleet_stream_replay.observe(s)
        self._last_totals["fleet_st_replays"] = count
        # HA front tier: per-front liveness/load gauges from the shared
        # store's registry + the tier failover counter (running total,
        # delta'd like every other fleet counter)
        ft = snap.get("front_tier", {})
        for fid, entry in (ft.get("fronts") or {}).items():
            self.fleet_front_up.labels(front=fid).set(
                1.0 if entry.get("alive") else 0.0)
            self.fleet_front_active_streams.labels(front=fid).set(
                entry.get("active_streams", 0))
        total = ft.get("failovers", 0)
        delta = total - self._last_totals.get("fleet_front_failovers", 0)
        if delta > 0:
            self.fleet_front_failovers.inc(delta)
        self._last_totals["fleet_front_failovers"] = total
        # elastic autoscaler: scale/preempt counters (running totals,
        # delta'd) + the live fleet-size gauge
        au = snap.get("autoscale", {})
        if au:
            self.fleet_replicas.set(au.get("replicas", 0))
        for key, counter in (
                ("scale_ups", self.fleet_autoscale_scale_ups),
                ("scale_downs", self.fleet_autoscale_scale_downs),
                ("spawn_failures", self.fleet_autoscale_spawn_failures),
                ("retire_rollbacks",
                 self.fleet_autoscale_retire_rollbacks),
                ("preemptions", self.fleet_autoscale_preemptions)):
            total = au.get(key, 0)
            delta = total - self._last_totals.get(f"fleet_au_{key}", 0)
            if delta > 0:
                counter.inc(delta)
            self._last_totals[f"fleet_au_{key}"] = total


class OTLPExporter:
    """OpenTelemetry spans for train/inference events; needs the
    ``opentelemetry`` SDK and its OTLP HTTP exporter installed."""

    def __init__(self, endpoint: str, service: str = "llmctl"):
        try:
            from opentelemetry import trace
            from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
                OTLPSpanExporter)
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor
        except ImportError as e:
            raise RuntimeError(
                f"--otlp-endpoint needs the opentelemetry SDK and its OTLP "
                f"HTTP exporter: {e.name or 'opentelemetry'} is not "
                f"installed") from e
        resource = Resource.create({"service.name": service})
        provider = TracerProvider(resource=resource)
        provider.add_span_processor(BatchSpanProcessor(
            OTLPSpanExporter(endpoint=f"{endpoint}/v1/traces")))
        trace.set_tracer_provider(provider)
        self.tracer = trace.get_tracer("llmctl")

    def record_training_step(self, m: dict) -> None:
        with self.tracer.start_as_current_span("training_step") as span:
            for k, v in m.items():
                if isinstance(v, (int, float)):
                    span.set_attribute(f"train.{k}", v)

    def record_inference_request(self, m: dict) -> None:
        with self.tracer.start_as_current_span("inference_request") as span:
            for k, v in m.items():
                if isinstance(v, (int, float)):
                    span.set_attribute(f"inference.{k}", v)


class ObservabilityManager:
    """The collector and the exporters, with the pump that exports the
    latest system sample every 5 s. An exporter that cannot start
    raises."""

    def __init__(self, prometheus_port: Optional[int] = None,
                 otlp_endpoint: Optional[str] = None,
                 collect_interval: float = 1.0):
        self.collector = MetricsCollector(interval=collect_interval)
        self.prometheus: Optional[PrometheusExporter] = None
        self.otlp: Optional[OTLPExporter] = None
        self._export_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False
        self.add_exporters(prometheus_port, otlp_endpoint)

    def add_exporters(self, prometheus_port: Optional[int] = None,
                      otlp_endpoint: Optional[str] = None) -> None:
        """Start each exporter asked for that this manager lacks (it keeps
        one of each: a second port or endpoint is not opened)."""
        if otlp_endpoint and self.otlp is None:
            self.otlp = OTLPExporter(otlp_endpoint)
        if prometheus_port is not None and self.prometheus is None:
            exporter = PrometheusExporter(prometheus_port)
            exporter.serve()
            self.prometheus = exporter
            if self._started:
                self._start_pump()

    def start(self) -> None:
        self.collector.start()
        self._started = True
        self._start_pump()

    def _start_pump(self) -> None:
        if self.prometheus and self._export_thread is None:
            def pump():
                while not self._stop.wait(5.0):
                    if self.collector.history:
                        self.prometheus.export_system(self.collector.history[-1])
            self._export_thread = threading.Thread(target=pump, daemon=True,
                                                   name="llmctl-export")
            self._export_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.collector.stop()
        if self._export_thread is not None:
            self._export_thread.join(timeout=10)
            self._export_thread = None
        if self.prometheus is not None:
            self.prometheus.close()

    def record_training_step(self, m: dict) -> None:
        self.collector.record_training(m)
        if self.prometheus:
            self.prometheus.export_training(m)
        if self.otlp:
            self.otlp.record_training_step(m)

    def record_eval(self, m: dict) -> None:
        self.collector.record_training({"eval": True, **m})
        if self.prometheus and "loss" in m:
            self.prometheus.eval_loss.set(m["loss"])

    def record_inference(self, m: dict) -> None:
        self.collector.record_inference(m)
        if self.prometheus:
            self.prometheus.export_inference(m)
        if self.otlp:
            self.otlp.record_inference_request(m)

    def record_fleet(self, snap: dict) -> None:
        """Per-replica fleet snapshot (supervisor poll cadence)."""
        if self.prometheus:
            self.prometheus.export_fleet(snap)


# -- the process's manager ------------------------------------------------------

_manager: Optional[ObservabilityManager] = None
_manager_lock = threading.Lock()


def setup_observability(prometheus_port: Optional[int] = None,
                        otlp_endpoint: Optional[str] = None
                        ) -> ObservabilityManager:
    """The process's manager, made and started on the first call; a later
    call adds the exporters it asks for that the manager lacks (a trainer
    that ran first, with none, does not leave a server without its
    scrape endpoint). ``LLMCTL_METRICS_PORT`` and ``LLMCTL_OTLP_ENDPOINT``
    stand in for arguments left None."""
    global _manager
    if prometheus_port is None:
        port = os.environ.get("LLMCTL_METRICS_PORT")
        prometheus_port = int(port) if port else None
    if otlp_endpoint is None:
        otlp_endpoint = os.environ.get("LLMCTL_OTLP_ENDPOINT")
    with _manager_lock:
        if _manager is None:
            mgr = ObservabilityManager(prometheus_port, otlp_endpoint)
            mgr.start()
            _manager = mgr
        else:
            _manager.add_exporters(prometheus_port, otlp_endpoint)
        return _manager


def get_observability() -> Optional[ObservabilityManager]:
    return _manager


def reset_observability() -> None:
    """Stop the process's manager (threads and scrape endpoint) and forget
    it, so the next ``setup_observability`` makes a new one."""
    global _manager
    with _manager_lock:
        mgr, _manager = _manager, None
    if mgr is not None:
        mgr.stop()


def engine_observer() -> Callable[[str, dict], None]:
    """The hook ``runtime/engine.py`` feeds: train steps and evals go to
    the process's manager."""
    mgr = setup_observability()

    def observe(event: str, payload: dict) -> None:
        if event == "train_step":
            mgr.record_training_step(payload)
        elif event == "eval":
            mgr.record_eval(payload)
    return observe
