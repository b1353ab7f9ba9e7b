"""The port's fleet control plane without engines, and what the fleet
reports, against the JAX package's.

- The JAX package's tests/test_fleet_router.py (routing policy,
  consistent hashing, admission with Retry-After, the requeue budget,
  migration placement, the rebalancer, loadgen's Retry-After honouring,
  the fault plan, FleetConfig) and the engine-free role classes of
  tests/test_fleet_disagg.py (role routing, the role balancer, role
  configs), run as they are on the port's modules: their source with the
  package's name swapped for the port's, the fake replicas included.
- ``FleetConfig`` equals JAX's field for field (names, defaults,
  validation, the derived maps).
- ``export_fleet`` of the same supervisor snapshots gives JAX's fleet
  series, names, labels and values, sample for sample (JAX's exporter in
  a subprocess: prometheus_client's registry is process-wide).
- Loadgen's fleet ``run_poisson`` and ``run_closed_loop`` offer JAX's
  requests and report JAX's keys, per-replica breakdown and counts.
- The options of steps 9c and 9d build their fleet: remote replicas, the
  HTTP courier and the fronts' file store; the autoscaler, the in-process
  KV store and the store service's client.
- The kernels' launch counters lose no increment under threads.
"""

import dataclasses
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from distributed_llm_training_and_inference_system_tpu.config import (
    schema as jschema)
from distributed_llm_training_and_inference_system_tpu.serve import (
    loadgen as jload)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    schema as tschema)
from distributed_llm_training_and_inference_system_tpu_torch.metrics import (
    observability as tobs)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    adamw_cuda, build, paged_attention_cuda as pac)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    loadgen as tload)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    ServeFleet, state as tstate)

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, SERVE, _one_thread, fleets, make_fleet, params)

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = "distributed_llm_training_and_inference_system_tpu"

# -- the reference's control-plane arms, on the port -------------------------

def _on_the_port(name: str) -> dict:
    """The namespace of the JAX package's test file ``name`` run with the
    package's name swapped for the port's."""
    path = ROOT / "tests" / name
    src = path.read_text().replace(f"{JAX_PKG}.", f"{JAX_PKG}_torch.")
    assert not re.search(r"^\s*(import|from) jax", src, re.M)
    ns: dict = {"__name__": f"{path.stem}_on_the_port"}
    exec(compile(src, str(path), "exec"), ns)
    return ns


# every class of test_fleet_router.py; the engine-free role classes of
# test_fleet_disagg.py
_router = _on_the_port("test_fleet_router.py")
for _name, _obj in list(_router.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj
_disagg = _on_the_port("test_fleet_disagg.py")
TestRoleRouting = _disagg["TestRoleRouting"]
TestRoleBalancer = _disagg["TestRoleBalancer"]
TestFleetConfigRoles = _disagg["TestFleetConfigRoles"]


# -- FleetConfig ---------------------------------------------------------------

def test_fleet_config_equals_jax_field_for_field():
    jf = {f.name: f for f in dataclasses.fields(jschema.FleetConfig)}
    tf = {f.name: f for f in dataclasses.fields(tschema.FleetConfig)}
    assert list(tf) == list(jf)
    for name, f in jf.items():
        assert tf[name].type == f.type, name
        assert tf[name].default == f.default, name
    assert dataclasses.asdict(tschema.FleetConfig()) == dataclasses.asdict(
        jschema.FleetConfig())
    d = {"replicas": 3, "roles": "prefill,decode,mixed",
         "remote_replicas": "2", "kv_store_endpoints":
         "http://a:1,http://b:2",
         "fleet_endpoints": {"2": "http://h:9", "store": "http://s:1"}}
    a, b = jschema.FleetConfig.from_dict(d), tschema.FleetConfig.from_dict(d)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for fn in ("role_list", "remote_replica_ids", "endpoint_map",
               "kv_store_endpoint_list"):
        assert getattr(a, fn)() == getattr(b, fn)(), fn
    for bad in ({"replicas": 0}, {"roles": "prefill,bogus"},
                {"courier_codec": "lz4"}, {"state_store": "file"},
                {"pipeline_prefill_max_stages": 1}):
        errs = []
        for mod in (jschema, tschema):
            try:
                mod.FleetConfig.from_dict(dict(bad))
                errs.append(None)
            except mod.ConfigError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], bad
    assert tschema.parse_fleet_endpoints("0=http://x:1,store=http://y:2") \
        == jschema.parse_fleet_endpoints("0=http://x:1,store=http://y:2")


# -- the options of steps 9c and 9d are served -------------------------------

_EP = {0: "http://127.0.0.1:1", 1: "http://127.0.0.1:2"}


@pytest.mark.parametrize("over, step", [
    ({"remote_replicas": "1", "fleet_endpoints": {1: _EP[1]}}, "9c"),
    ({"fleet_endpoints": {0: _EP[0]}}, "9c"),
    ({"courier_transport": "http", "courier_endpoint": _EP[0]}, "9c"),
    ({"fronts": 2, "state_store": "file", "state_store_dir": "/nonexistent",
      "remote_replicas": "0,1", "fleet_endpoints": dict(_EP)}, "9c"),
    ({"state_store": "file", "state_store_dir": "/nonexistent"}, "9c"),
    ({"autoscale": True, "autoscale_max_replicas": 3}, "9d"),
    ({"kv_store": True}, "9d"),
    ({"kv_store_endpoint": _EP[0]}, "9d"),
], ids=["remote", "endpoints", "http-courier", "fronts", "file-store",
        "autoscale", "kv-store", "store-service"])
def test_options_of_later_steps_raise_naming_the_step(over, step, tmp_path):
    """The options of step 9c build their fleet (remote replicas behind
    RemoteReplica, the HTTP courier, the fronts' file store), and so do
    those of 9d (the autoscaler with its warm spare, the in-process KV
    store wired into the router, courier and replicas, the store service's
    client with the weight courier)."""
    from distributed_llm_training_and_inference_system_tpu_torch.config import (  # noqa: E501
        ServeConfig, get_model_config)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        FleetAutoscaler, FleetKVStore, RemoteReplica, SharedFileStateStore,
        StoreClient, WeightCourier)
    if over.get("state_store_dir"):
        over = dict(over, state_store_dir=str(tmp_path))
    fc = tschema.FleetConfig(replicas=2, **over)
    fleet = ServeFleet(get_model_config("gpt-test"), ServeConfig(**SERVE),
                       fc, device="cpu", supervise=False)
    try:
        store = fleet.kv_store
        assert fleet.router.kv_store is store is fleet.courier.kv_store
        local = [r for r in fleet.replicas if not getattr(r, "remote", False)]
        assert all(r.kv_store is store for r in local)
        if over.get("kv_store"):
            assert isinstance(store, FleetKVStore)
        if over.get("kv_store_endpoint"):
            assert isinstance(store, StoreClient)
            assert store.endpoints == [_EP[0]]
            assert isinstance(fleet.weight_courier, WeightCourier)
        else:
            assert fleet.weight_courier is None
        if over.get("autoscale"):
            assert isinstance(fleet.autoscaler, FleetAutoscaler)
            assert fleet.supervisor.autoscaler is fleet.autoscaler
            assert fleet.wait_warm_spares(60.0)
            assert [s.replica_id for s in fleet._spares] == [2]
        else:
            assert fleet.autoscaler is None
        remote = fc.remote_replica_ids()
        for r in fleet.replicas:
            assert isinstance(r, RemoteReplica) == (r.replica_id in remote)
            if r.replica_id in remote:
                assert r.endpoint == fc.endpoint_map()[r.replica_id]
                assert not hasattr(r, "engine")
        assert isinstance(fleet.store, SharedFileStateStore) == (
            fc.state_store == "file")
        assert fleet.courier.force_http == (fc.courier_transport == "http")
    finally:
        fleet.shutdown()


def test_the_file_state_store_and_shared_ledger_raise_naming_9c(tmp_path):
    """The file store is built, and the shared ledger's wire form is
    JAX's request wire without its host-local ticket."""
    cfg = tschema.FleetConfig(state_store="file",
                              state_store_dir=str(tmp_path))
    store = tstate.build_state_store(cfg, front_id="A")
    assert isinstance(store, tstate.SharedFileStateStore)
    assert store.shared and store.front_id == "A"
    assert store.expiry_s == max(3 * cfg.probe_interval_s, 0.25)
    from distributed_llm_training_and_inference_system_tpu_torch.serve import (  # noqa: E501
        scheduler)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        remote, router)
    req = scheduler.Request(request_id="r", prompt_tokens=[1, 2],
                            sampling=scheduler.SamplingParams())
    req.swapped_kv = {"courier_ticket": "t", "at": 0, "partial": False}
    wire = router.FleetRouter._wire(req)
    assert "ticket" not in wire
    assert wire == {k: v for k, v in remote.request_to_wire(req).items()
                    if k != "ticket"}


# -- fleet metrics -------------------------------------------------------------

JAX_FLEET_SCRIPT = """
import json, sys
from prometheus_client import generate_latest
from distributed_llm_training_and_inference_system_tpu.metrics import (
    observability as o)
mgr = o.ObservabilityManager()
mgr.prometheus = o.PrometheusExporter(0)
for snap in json.loads(sys.stdin.read()):
    mgr.record_fleet(snap)
sys.stdout.write(generate_latest().decode())
"""

_SAMPLE = re.compile(r"^(\w+)(\{[^}]*\})? (\S+)$")


def _fleet_samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if line.startswith("#") or not m or "_fleet_" not in m.group(1):
            continue
        name, labels, value = m.groups()
        out[(name, labels or "")] = (None if name.endswith("_created")
                                     else float(value))
    return out


def test_fleet_series_equal_jax(params, fleets):
    """Supervisor snapshots of a port fleet before and after a crash
    requeue and a restart, exported by both packages' exporters."""
    fleet = make_fleet(fleets, "torch", params,
                       plan=dict(crash_replica=0, crash_after_steps=2))
    sp = PKGS["torch"].Sampling(temperature=0.0, max_tokens=16)
    prompts = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5], [9, 8, 7, 6]]
    snaps = [json.loads(json.dumps(fleet.status()))]
    fleet.generate(prompts, sp, timeout_s=120)
    snaps.append(json.loads(json.dumps(fleet.status())))
    fleet.generate(prompts[:1], sp, timeout_s=120)
    snaps.append(json.loads(json.dumps(fleet.status())))
    assert snaps[-1]["router"]["requeues"] >= 1
    res = subprocess.run([sys.executable, "-c", JAX_FLEET_SCRIPT],
                         cwd=ROOT, input=json.dumps(snaps),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    want = _fleet_samples(res.stdout)
    exp = tobs.PrometheusExporter(0)
    mgr = tobs.ObservabilityManager()
    mgr.prometheus = exp
    for snap in snaps:
        mgr.record_fleet(snap)
    got = _fleet_samples(exp.render().decode())
    assert got == want
    assert got[("llmctl_fleet_requeues_total", "")] >= 1
    assert ("llmctl_fleet_replica_queue_depth", '{replica="0"}') in got


# -- loadgen's fleet targets ---------------------------------------------------

@pytest.mark.parametrize("mode", ["poisson", "closed"])
def test_loadgen_fleet_breakdown_equals_jax(params, fleets, mode):
    out = {}
    for pkg, lg in (("jax", jload), ("torch", tload)):
        fleet = make_fleet(fleets, pkg, params,
                           plan=dict(crash_replica=0, crash_after_steps=2))
        offered = []
        submit = fleet.submit

        def record(prompt, *a, submit=submit, offered=offered, **k):
            offered.append(list(prompt))
            return submit(prompt, *a, **k)
        fleet.submit = record
        if mode == "poisson":
            res = lg.run_poisson(fleet, offered_rps=30.0, num_requests=10,
                                 prompt_len=8, max_tokens=24, seed=0)
        else:
            res = lg.run_closed_loop(fleet, concurrency=3, num_requests=6,
                                     prompt_len=6, max_tokens=6, seed=1)
        s = res.summary()
        out[pkg] = (sorted(offered), sorted(s),
                    sorted(s["per_replica"]),
                    {k: sorted(v) for k, v in s["per_replica"].items()},
                    res.completed, res.failed,
                    sum(v["requests"] for v in res.per_replica.values()),
                    sum(v["requeues"] for v in res.per_replica.values())
                    == res.requeues)
    assert out["torch"] == out["jax"]
    assert out["torch"][4] == (10 if mode == "poisson" else 6)


# -- launch counters under threads ---------------------------------------------

def test_launch_counters_lose_nothing_under_threads():
    """8 threads count launches through the wrappers' own counting call,
    with the interpreter switching threads every microsecond: every
    increment lands, and callers still read and reset the plain ints."""
    kernels = (pac.paged_attention_kernel, pac.paged_attention_int8_kernel,
               adamw_cuda.adamw_kernel)
    saved = [(k.launches, getattr(k, "leaves", None)) for k in kernels]
    for k in kernels:
        k.launches = 0
    adamw_cuda.adamw_kernel.leaves = 0
    n = 2000

    def work():
        for _ in range(n):
            build.count_launch(pac.paged_attention_kernel)
            build.count_launch(pac.paged_attention_int8_kernel, 2)
            build.count_launch(adamw_cuda.adamw_kernel, leaves=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        got = (pac.paged_attention_kernel.launches,
               pac.paged_attention_int8_kernel.launches,
               adamw_cuda.adamw_kernel.launches,
               adamw_cuda.adamw_kernel.leaves)
        for k, (launches, leaves) in zip(kernels, saved):
            k.launches = launches
            if leaves is not None:
                k.leaves = leaves
    assert got == (8 * n, 16 * n, 8 * n, 24 * n)
