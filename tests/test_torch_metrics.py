"""The port's metrics, Prometheus exposition and health monitors against
the JAX package's (CPU).

- ``METRICS`` and ``COUNTER_FLOW`` equal JAX's entry for entry.
- One sequence of events (a system sample with fixed numbers, 3 train
  steps, 1 eval, 6 inference requests with running preemption and swap-in
  totals, one without a TTFT) goes through JAX's ``ObservabilityManager``
  (in a subprocess: prometheus_client's process-wide registry takes each
  metric name once) and the port's, scraped from its own endpoint: every
  ``llmctl_*`` sample is equal (name, labels, value; ``_created`` by name
  and labels only), and so are the ``# HELP`` and ``# TYPE`` lines.
- The hand-written renderer prints what prometheus_client prints for
  gauges, counters and histograms with and without labels.
- The health monitors give JAX's statuses and messages on the same inputs.
- The port's server answers 5 requests and its ``/metrics`` counts them.
"""

import json
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from distributed_llm_training_and_inference_system_tpu.metrics import (
    health as jhealth, names as jnames)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.metrics import (
    health as thealth, names as tnames, observability as tobs)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceServer)

ROOT = Path(__file__).resolve().parents[1]

SYSTEM = dict(timestamp=1.0, cpu_percent=12.5, mem_percent=40.25,
              mem_used_gb=3.5, net_sent_mbps=0.0, net_recv_mbps=0.0,
              disk_read_mbps=0.0, disk_write_mbps=0.0,
              hbm_used_gb={0: 3.25, 1: 0.5}, hbm_limit_gb={0: 80.0, 1: 80.0})
TRAIN = [dict(step=s, loss=5.5 - 0.25 * s, grad_norm=1.5 / s, lr=1e-4 * s,
              tokens_per_sec=1000.0 * s, tokens_per_sec_per_chip=1000.0 * s,
              mfu=0.125 * s) for s in (1, 2, 3)]
EVAL = dict(loss=4.75, perplexity=115.58, tokens=4096.0)
INFER = [dict(latency_ms=30.0 + 17.0 * i, ttft_ms=(None if i == 3 else
                                                    4.0 + 9.5 * i),
              prompt_tokens=10 + i, tokens=8, queue_depth=i % 3,
              preemptions=[0, 1, 1, 3, 3, 4][i], swap_ins=[0, 0, 2, 2, 5, 5][i],
              swapped_host_bytes=1024 * i) for i in range(6)]

JAX_SCRIPT = """
import json, sys
from prometheus_client import generate_latest
from distributed_llm_training_and_inference_system_tpu.metrics import (
    observability as o)
ev = json.loads(sys.stdin.read())
mgr = o.ObservabilityManager()
mgr.prometheus = o.PrometheusExporter(0)
sysd = ev["system"]
sysd["hbm_used_gb"] = {int(k): v for k, v in sysd["hbm_used_gb"].items()}
sysd["hbm_limit_gb"] = {int(k): v for k, v in sysd["hbm_limit_gb"].items()}
mgr.prometheus.export_system(o.SystemSample(**sysd))
for m in ev["train"]:
    mgr.record_training_step(m)
mgr.record_eval(ev["eval"])
for m in ev["infer"]:
    mgr.record_inference(m)
sys.stdout.write(generate_latest().decode())
"""

_SAMPLE = re.compile(r"^(\w+)(\{[^}]*\})? (\S+)$")


def _parse(text: str):
    """({(name, labels): value or None for _created}, [# lines]) of the
    llmctl_* part of an exposition."""
    samples, meta = {}, []
    for line in text.splitlines():
        if line.startswith("#"):
            if line.split()[2].startswith("llmctl_"):
                meta.append(line)
            continue
        m = _SAMPLE.match(line)
        assert m, line
        name, labels, value = m.groups()
        if not name.startswith("llmctl_"):
            continue
        key = (name, labels or "")
        assert key not in samples, key
        samples[key] = None if name.endswith("_created") else float(value)
    return samples, sorted(meta)


def _events() -> dict:
    return {"system": SYSTEM, "train": TRAIN, "eval": EVAL, "infer": INFER}


def test_metric_names_equal_jax():
    assert list(tnames.METRICS) == list(jnames.METRICS)
    for name, spec in jnames.METRICS.items():
        assert tuple(tnames.METRICS[name]) == tuple(spec), name
    assert [tuple(f) for f in tnames.COUNTER_FLOW] == \
        [tuple(f) for f in jnames.COUNTER_FLOW]
    assert tnames.COUNTER_SNAPSHOT_FN == jnames.COUNTER_SNAPSHOT_FN
    for name in jnames.METRICS:
        assert tnames.scraped_name(name) == jnames.scraped_name(name)
    assert tnames.fleet_metric_names() == jnames.fleet_metric_names()


@pytest.fixture
def manager():
    tobs.reset_observability()
    mgr = tobs.setup_observability(prometheus_port=0)
    yield mgr
    tobs.reset_observability()


def test_exposition_equals_jax_sample_for_sample(manager):
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT], cwd=ROOT,
                         input=json.dumps(_events()), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    want, want_meta = _parse(res.stdout)

    ev = _events()
    manager.prometheus.export_system(tobs.SystemSample(**ev["system"]))
    for m in ev["train"]:
        manager.record_training_step(m)
    manager.record_eval(ev["eval"])
    for m in ev["infer"]:
        manager.record_inference(m)
    url = f"http://127.0.0.1:{manager.prometheus.port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        got, got_meta = _parse(r.read().decode())
    assert got_meta == want_meta
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == value, key
    # the events reached the series they name
    assert got[("llmctl_inference_requests_total", "")] == 6.0
    assert got[("llmctl_inference_ttft_seconds_count", "")] == 5.0
    assert got[("llmctl_inference_preemptions_total", "")] == 4.0
    assert got[("llmctl_train_step", "")] == 3.0
    assert got[("llmctl_hbm_used_gb", '{device="1"}')] == 0.5


def test_renderer_prints_what_prometheus_client_prints():
    from prometheus_client import (CollectorRegistry, Counter, Gauge,
                                   Histogram, generate_latest)
    ref, reg = CollectorRegistry(), tobs.Registry()
    classes = {"gauge": Gauge, "counter": Counter, "histogram": Histogram}

    def both(kind, name, help, labels=(), buckets=None):
        kw = {"labelnames": list(labels), "registry": ref}
        if buckets:
            kw["buckets"] = buckets
        return (classes[kind](name, help, **kw),
                reg.register(tobs.Metric(name, kind, help, labels, buckets)))

    rng = np.random.default_rng(0)
    a, b = both("gauge", "llmctl_g", "help with \\ and\nnewline")
    for x in (a, b):
        x.set(1e-7)
    a, b = both("gauge", "llmctl_gl", "G", ("device",))
    for x in (a, b):
        x.labels(device="0").set(123456789012.0)
        x.labels(device='q"\\').set(float("inf"))
    a, b = both("counter", "llmctl_c_total", "C")
    for x in (a, b):
        x.inc(2)
    a, b = both("counter", "llmctl_cl", "CL", ("replica",))
    for x in (a, b):
        x.labels(replica="1").inc(3.5)
    both("gauge", "llmctl_unset", "labelled, no child", ("replica",))
    a, b = both("histogram", "llmctl_h", "H", (), (.01, .5, 1, 2.5, 10))
    values = rng.exponential(2.0, 40).tolist()
    for x in (a, b):
        for v in values:
            x.observe(v)
    a, b = both("histogram", "llmctl_hl", "HL", ("replica",), (.5, 1))
    for x in (a, b):
        x.labels(replica="b").observe(0.75)
        x.labels(replica="a").observe(3)

    def strip(text):
        return re.sub(r"(_created\S*) \S+", r"\1 T", text)

    assert strip(reg.render().decode()) == strip(generate_latest(ref).decode())


def test_exporter_refuses_what_it_cannot_do():
    exp = tobs.PrometheusExporter(0)
    # the fleet's snapshot is exported now (its series are held to JAX's
    # in tests/test_torch_fleet_router.py); an empty one sets no child
    exp.export_fleet({"replicas": []})
    assert 'replica="' not in exp.render().decode()
    # a port that cannot be bound raises (no quiet disable)
    exp.serve()
    try:
        with pytest.raises(OSError):
            tobs.PrometheusExporter(exp.port).serve()
    finally:
        exp.close()
    with pytest.raises(ValueError, match="Duplicated"):
        exp.registry.register(tobs.Metric("llmctl_train_loss", "gauge", "x"))


def test_otlp_without_the_sdk_names_the_missing_package():
    pytest.importorskip("opentelemetry")
    try:
        import opentelemetry.sdk  # noqa: F401
        pytest.skip("the opentelemetry SDK is installed here")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="is not installed"):
        tobs.OTLPExporter("http://127.0.0.1:4318")
    tobs.reset_observability()
    try:
        with pytest.raises(RuntimeError, match="opentelemetry"):
            tobs.setup_observability(otlp_endpoint="http://127.0.0.1:4318")
        assert tobs.get_observability() is None
    finally:
        tobs.reset_observability()


def test_a_later_setup_adds_the_exporter_it_asks_for():
    """A trainer's engine_observer() makes the process's manager without an
    exporter; a server set up after it in the same process still gets its
    scrape endpoint, and the pump exports system samples there."""
    tobs.reset_observability()
    try:
        observe = tobs.engine_observer()
        mgr = tobs.get_observability()
        assert mgr is not None and mgr.prometheus is None
        observe("train_step", TRAIN[0])
        again = tobs.setup_observability(prometheus_port=0)
        assert again is mgr and mgr.prometheus is not None
        assert mgr._export_thread is not None and mgr._export_thread.is_alive()
        observe("train_step", TRAIN[1])
        url = f"http://127.0.0.1:{mgr.prometheus.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            got, _ = _parse(r.read().decode())
        assert got[("llmctl_train_step", "")] == 2.0
        port = mgr.prometheus.port          # one exporter: kept as it is
        assert tobs.setup_observability(prometheus_port=0).prometheus.port \
            == port
    finally:
        tobs.reset_observability()
    assert mgr._export_thread is None


def test_concurrent_running_totals_count_once():
    """The server's handler threads report the engine's running totals
    out of order; the counter ends at the largest total, each increment
    counted once (32 threads, a 10 us switch interval)."""
    import threading
    exp = tobs.PrometheusExporter(0)
    total, lock = [0], threading.Lock()

    def worker():
        for _ in range(200):
            with lock:
                total[0] += 1
                seen = total[0]
            exp.export_inference({"preemptions": seen, "swap_ins": seen // 2,
                                  "latency_ms": 1.0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got, _ = _parse(exp.render().decode())
    assert got[("llmctl_inference_preemptions_total", "")] == 32 * 200
    assert got[("llmctl_inference_swap_ins_total", "")] == 32 * 200 // 2
    assert got[("llmctl_inference_requests_total", "")] == 32 * 200
    assert got[("llmctl_inference_latency_seconds_count", "")] == 32 * 200


def test_collector_reads_the_host():
    col = tobs.MetricsCollector()
    first = col.sample_once()
    time.sleep(0.05)
    s = col.sample_once()
    assert first.cpu_percent == 0.0 and 0.0 <= s.cpu_percent <= 100.0
    assert 0.0 < s.mem_percent < 100.0 and s.mem_used_gb > 0.0
    assert s.hbm_used_gb == {}          # no card here
    assert col.summary()["system"]["mem_percent"] == s.mem_percent


# -- health ---------------------------------------------------------------

def _checks(checks):
    return [(c.name, c.status.value, c.message) for c in checks]


@pytest.mark.parametrize("kind,values", [
    ("cpu", [0.0, 50.0, 84.9, 85.0, 94.99, 95.0, 100.0]),
    ("mem", [10.0, 85.0, 96.0]),
    ("disk", [84.0, 85.0, 95.0]),
    ("hbm", [0.5, 0.9, 0.97, 0.98, 1.0]),
])
def test_system_levels_equal_jax(kind, values):
    j = jhealth.SystemHealthMonitor()
    t = thealth.SystemHealthMonitor(device="cpu")
    assert t.t == j.t
    for v in values:
        assert t._level(v, kind).value == j._level(v, kind).value


@pytest.mark.parametrize("case", [
    None, {},
    {"loss": 2.5, "grad_norm": 1.0, "age": 10.2},
    {"loss": 2.5, "grad_norm": 1.0, "age": 400.2},              # stale
    {"loss": float("nan"), "grad_norm": 1.0, "age": 1.2},
    {"loss": float("inf"), "age": 1.2},
    {"loss": 2.5, "grad_norm": 5e-4, "age": 1.2},                # low
    {"loss": 2.5, "grad_norm": 250.0, "age": 1.2},               # high
    {"loss": 2.5, "grad_norm": float("nan"), "age": 1.2},
], ids=["none", "empty", "ok", "stale", "nan_loss", "inf_loss", "grad_low",
        "grad_high", "grad_nan"])
def test_training_monitor_equals_jax(case):
    if case and "age" in case:
        case = {**{k: v for k, v in case.items() if k != "age"},
                "timestamp": time.time() - case["age"]}
    j = jhealth.TrainingHealthMonitor().checks(case)
    t = thealth.TrainingHealthMonitor().checks(case)
    assert _checks(t) == _checks(j)
    for a, b in zip(t, j):
        if b.value is not None and not np.isnan(b.value):
            assert a.value == pytest.approx(b.value, rel=1e-3)


def _requests(n, errors=0, latency=50.0, slow=0, queue=0):
    out = [{"latency_ms": latency + i, "queue_depth": queue}
           for i in range(n)]
    for i in range(errors):
        out[i]["error"] = "boom"
    for i in range(slow):
        out[-1 - i]["latency_ms"] = 20_000.0
    return out


@pytest.mark.parametrize("recent", [
    [], _requests(10), _requests(100, errors=6), _requests(100, errors=5),
    _requests(100, slow=1), _requests(100, slow=2), _requests(3, queue=101),
], ids=["none", "ok", "error_rate", "error_edge", "latency_edge",
        "latency", "queue"])
def test_inference_monitor_equals_jax(recent):
    j = jhealth.InferenceHealthMonitor().checks(recent)
    t = thealth.InferenceHealthMonitor().checks(recent)
    assert _checks(t) == _checks(j)
    assert [c.value for c in t] == [c.value for c in j]


def test_health_report_and_manager_on_the_cpu():
    col = tobs.MetricsCollector()
    col.record_training({"loss": 2.0, "grad_norm": 1.0})
    col.record_inference({"latency_ms": 5.0, "error": "x"})
    mgr = thealth.HealthManager(collector=col, device="cpu")
    alerts = []
    mgr.add_alert_callback(alerts.append)
    rep = mgr.run_checks()
    d = rep.to_dict()
    jrep = jhealth.HealthReport(jhealth.HealthStatus.HEALTHY, []).to_dict()
    assert set(d) == set(jrep)
    assert {c["name"] for c in d["checks"]} >= {
        "cpu", "memory", "disk", "device0", "progress", "loss", "grad_norm",
        "error_rate", "latency_p99", "queue_depth"}
    assert d["status"] == "warning" and alerts == [rep]   # 100% errors


def test_health_needs_a_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        thealth.HealthManager()


# -- the server's /metrics ----------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read().decode()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_metrics_count_its_requests(manager):
    cfg = get_model_config("gpt-test")
    scfg = ServeConfig(model="gpt-test", host="127.0.0.1", port=0,
                       max_batch_size=4, max_seq_len=128, prefill_chunk=32,
                       kv_block_size=8, dtype="float32")

    def observer(event, payload):
        if event == "inference_request":
            manager.record_inference(payload)

    srv = InferenceServer(cfg, scfg, device="cpu", observer=observer,
                          metrics=manager.prometheus)
    port = srv.start()
    try:
        rng = np.random.default_rng(5)
        for i in range(4):
            out = _post(port, {"prompt": rng.integers(1, 250, 5 + i).tolist(),
                               "max_tokens": 4, "temperature": 0.0})
            assert len(out["choices"][0]["token_ids"]) == 4
        req = urllib.request.Request(           # the streaming path too
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 4,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert b"[DONE]" in r.read()
        status, text = _get(f"http://127.0.0.1:{port}/metrics")
        _, scraped = _get(f"http://127.0.0.1:{manager.prometheus.port}/")
    finally:
        srv.stop()
    assert status == 200
    for body in (text, scraped):
        samples, _ = _parse(body)
        assert samples[("llmctl_inference_requests_total", "")] == 5.0
        assert samples[("llmctl_inference_ttft_seconds_count", "")] == 5.0
        assert samples[("llmctl_inference_latency_seconds_count", "")] == 5.0


def test_server_without_a_registry_says_so():
    cfg = get_model_config("gpt-test")
    scfg = ServeConfig(model="gpt-test", host="127.0.0.1", port=0,
                       max_batch_size=2, max_seq_len=64, prefill_chunk=32,
                       kv_block_size=8, dtype="float32")
    srv = InferenceServer(cfg, scfg, device="cpu")
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{port}/metrics")
        assert e.value.code == 404
        assert b"prometheus-port" in e.value.read()
    finally:
        srv.stop()
