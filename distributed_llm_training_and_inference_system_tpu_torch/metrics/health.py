"""Health monitoring: system / training / inference (the JAX package's
``metrics/health.py``).

The system monitor reads the host from ``/proc`` and ``/`` (CPU, memory,
disk) and, on the card, its memory occupancy from
``torch.cuda.mem_get_info`` (device-wide, as nvidia-smi counts it). The
training and inference monitors give the JAX package's statuses and
messages for the same inputs. ``HealthManager`` takes a ``device``: the
card by default (raising without one), or ``"cpu"`` for a host-only
check.
"""

from __future__ import annotations

import logging
import math
import shutil
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import torch

from ..device import resolve_device
from .observability import CpuPercent, memory_info

logger = logging.getLogger("llmctl.health")


class HealthStatus(str, Enum):
    HEALTHY = "healthy"
    WARNING = "warning"
    CRITICAL = "critical"
    UNKNOWN = "unknown"

    @property
    def rank(self) -> int:
        return {"healthy": 0, "unknown": 1, "warning": 2, "critical": 3}[self.value]


@dataclass
class HealthCheck:
    name: str
    status: HealthStatus
    message: str = ""
    value: Optional[float] = None
    timestamp: float = field(default_factory=time.time)


def disk_percent(path: str = "/") -> float:
    """psutil's ``disk_usage(path).percent``: used over what a user may
    fill (used + available), to one decimal."""
    du = shutil.disk_usage(path)
    room = du.used + du.free
    return round(100.0 * du.used / room, 1) if room else 0.0


class SystemHealthMonitor:
    """CPU/mem/disk thresholds and, on the card, memory occupancy."""

    def __init__(self, cpu_warn=85.0, cpu_crit=95.0, mem_warn=85.0,
                 mem_crit=95.0, disk_warn=85.0, disk_crit=95.0,
                 hbm_warn=0.90, hbm_crit=0.98, device=None):
        self.t = dict(cpu=(cpu_warn, cpu_crit), mem=(mem_warn, mem_crit),
                      disk=(disk_warn, disk_crit), hbm=(hbm_warn, hbm_crit))
        self.device = resolve_device(device)
        self._cpu = CpuPercent()

    def _level(self, value: float, kind: str) -> HealthStatus:
        warn, crit = self.t[kind]
        if value >= crit:
            return HealthStatus.CRITICAL
        if value >= warn:
            return HealthStatus.WARNING
        return HealthStatus.HEALTHY

    def checks(self) -> list[HealthCheck]:
        out = []
        cpu = self._cpu()
        out.append(HealthCheck("cpu", self._level(cpu, "cpu"),
                               f"cpu {cpu:.0f}%", cpu))
        mem = memory_info()["percent"]
        out.append(HealthCheck("memory", self._level(mem, "mem"),
                               f"mem {mem:.0f}%", mem))
        disk = disk_percent("/")
        out.append(HealthCheck("disk", self._level(disk, "disk"),
                               f"disk {disk:.0f}%", disk))
        if self.device.type != "cuda":
            out.append(HealthCheck("device0", HealthStatus.HEALTHY,
                                   "cpu responsive"))
            return out
        for i in range(torch.cuda.device_count()):
            free, limit = torch.cuda.mem_get_info(i)
            frac = (limit - free) / limit
            out.append(HealthCheck(
                f"hbm_device{i}", self._level(frac, "hbm"),
                f"HBM {frac*100:.0f}% of {limit/1e9:.0f}GB", frac))
        return out


class TrainingHealthMonitor:
    """Staleness / NaN / grad-norm band."""

    def __init__(self, stale_seconds=300.0, grad_lo=1e-3, grad_hi=100.0):
        self.stale_seconds = stale_seconds
        self.grad_lo, self.grad_hi = grad_lo, grad_hi

    def checks(self, last_step: Optional[dict]) -> list[HealthCheck]:
        if not last_step:
            return [HealthCheck("training", HealthStatus.UNKNOWN,
                                "no training metrics yet")]
        out = []
        age = time.time() - last_step.get("timestamp", 0)
        if age > self.stale_seconds:
            out.append(HealthCheck("progress", HealthStatus.CRITICAL,
                                   f"no step for {age:.0f}s", age))
        else:
            out.append(HealthCheck("progress", HealthStatus.HEALTHY,
                                   f"last step {age:.0f}s ago", age))
        loss = last_step.get("loss")
        if loss is not None:
            if math.isnan(loss) or math.isinf(loss):
                out.append(HealthCheck("loss", HealthStatus.CRITICAL,
                                       f"loss is {loss}"))
            else:
                out.append(HealthCheck("loss", HealthStatus.HEALTHY,
                                       f"loss {loss:.4f}", loss))
        g = last_step.get("grad_norm")
        if g is not None:
            if g > self.grad_hi or math.isnan(g):
                st = HealthStatus.CRITICAL
            elif g < self.grad_lo:
                st = HealthStatus.WARNING
            else:
                st = HealthStatus.HEALTHY
            out.append(HealthCheck("grad_norm", st, f"grad norm {g:.4g}", g))
        return out


class InferenceHealthMonitor:
    """Error rate / latency / queue depth."""

    def __init__(self, err_warn=0.05, latency_warn_ms=10_000.0,
                 queue_warn=100):
        self.err_warn = err_warn
        self.latency_warn_ms = latency_warn_ms
        self.queue_warn = queue_warn

    def checks(self, recent: list[dict]) -> list[HealthCheck]:
        if not recent:
            return [HealthCheck("inference", HealthStatus.UNKNOWN,
                                "no inference traffic")]
        out = []
        errs = sum(1 for r in recent if r.get("error"))
        rate = errs / len(recent)
        out.append(HealthCheck(
            "error_rate",
            HealthStatus.WARNING if rate > self.err_warn else HealthStatus.HEALTHY,
            f"{rate*100:.1f}% errors over {len(recent)} reqs", rate))
        lats = sorted(r.get("latency_ms", 0.0) for r in recent)
        p99 = lats[int(len(lats) * 0.99)] if lats else 0.0
        out.append(HealthCheck(
            "latency_p99",
            HealthStatus.WARNING if p99 > self.latency_warn_ms else HealthStatus.HEALTHY,
            f"p99 {p99:.0f}ms", p99))
        q = recent[-1].get("queue_depth", 0)
        out.append(HealthCheck(
            "queue_depth",
            HealthStatus.WARNING if q > self.queue_warn else HealthStatus.HEALTHY,
            f"queue {q}", float(q)))
        return out


@dataclass
class HealthReport:
    status: HealthStatus
    checks: list[HealthCheck]
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "status": self.status.value,
            "timestamp": self.timestamp,
            "checks": [{"name": c.name, "status": c.status.value,
                        "message": c.message, "value": c.value}
                       for c in self.checks],
        }


class HealthManager:
    """Periodic monitor loop, alert callbacks and history."""

    def __init__(self, interval: float = 30.0,
                 collector: Optional[object] = None, device=None):
        self.interval = interval
        self.collector = collector  # MetricsCollector, if observability is up
        self.system = SystemHealthMonitor(device=device)
        self.training = TrainingHealthMonitor()
        self.inference = InferenceHealthMonitor()
        self.history: list[HealthReport] = []
        self.alert_callbacks: list[Callable[[HealthReport], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_alert_callback(self, cb: Callable[[HealthReport], None]) -> None:
        self.alert_callbacks.append(cb)

    def run_checks(self) -> HealthReport:
        checks = self.system.checks()
        training_last = None
        inference_recent: list[dict] = []
        if self.collector is not None:
            if getattr(self.collector, "training", None):
                training_last = dict(self.collector.training[-1])
            inference_recent = list(getattr(self.collector, "inference", []))[-100:]
        checks += self.training.checks(training_last)
        checks += self.inference.checks(inference_recent)
        worst = max((c.status for c in checks), key=lambda s: s.rank,
                    default=HealthStatus.UNKNOWN)
        report = HealthReport(worst, checks)
        self.history.append(report)
        if len(self.history) > 1000:
            self.history = self.history[-1000:]
        if worst in (HealthStatus.WARNING, HealthStatus.CRITICAL):
            for cb in self.alert_callbacks:
                try:
                    cb(report)
                except Exception:   # one bad callback must not stop alerts
                    logger.exception("health alert callback failed")
        return report

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.run_checks()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="llmctl-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


def setup_health_monitoring(interval: float = 30.0,
                            device=None) -> HealthManager:
    """A started manager over the process's collector (when observability
    is up) that prints warning and critical checks."""
    from .observability import get_observability
    obs = get_observability()
    mgr = HealthManager(interval=interval,
                        collector=obs.collector if obs else None,
                        device=device)

    def console_alert(report: HealthReport) -> None:
        bad = [c for c in report.checks
               if c.status in (HealthStatus.WARNING, HealthStatus.CRITICAL)]
        for c in bad:
            print(f"[health:{c.status.value}] {c.name}: {c.message}")

    mgr.add_alert_callback(console_alert)
    mgr.start()
    return mgr
