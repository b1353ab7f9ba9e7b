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
  one). A failure to bind raises. ``export_fleet`` raises: the fleet is
  ROADMAP queue 1 item 9.
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
        raise NotImplementedError(
            "fleet metrics are not ported to the PyTorch package yet "
            "(ROADMAP queue 1 item 9)")


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
        """Per-replica fleet snapshot: not ported yet (item 9)."""
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
