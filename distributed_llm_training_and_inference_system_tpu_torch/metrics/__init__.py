"""Metrics layer: observability (wired into the trainer and the server)
and health."""

from .health import (  # noqa: F401
    HealthCheck, HealthManager, HealthReport, HealthStatus,
    InferenceHealthMonitor, SystemHealthMonitor, TrainingHealthMonitor,
    setup_health_monitoring)
from .observability import (  # noqa: F401
    MetricsCollector, ObservabilityManager, PrometheusExporter, Registry,
    engine_observer, get_observability, reset_observability,
    setup_observability)
