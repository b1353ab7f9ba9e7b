"""The replicated store tier on the port (serve/fleet/store_tier.py and the
tier half of serve/fleet/store_service.py), held to the JAX package's.

- The JAX package's ``tests/test_store_tier.py`` on the port's modules,
  its in-process ``FakeWire`` routing to the port's ``StoreService``. Left
  out, by name: ``test_health_gate_starting_until_warm``, which serves the
  JAX service on aiohttp; its port counterpart below serves the port's on
  ``http.server``.
- Across the packages, through the reference's ``FakeWire`` (a JSON round
  trip a call): its conformance, failover, fencing and weight-tier classes
  with the JAX package's clients over the port's ``StoreService``
  (``...JaxClients``) and the port's clients over the JAX package's
  (``...JaxService``).
- The JAX regime ``serve.fleet2+ha-store`` with two spawned ``fleet
  store`` members (``--device cpu``, one membership directory): a ship
  converges both; a weight download partitioned from its member
  mid-way resumes from the spool on the survivor, by the port's and by the
  JAX package's ``WeightCourier``, with the combined per-seq ledger
  balanced; a worker boots from the tier, a retired replica's pages land
  on both members (write-ack 2), the member first in the list is
  SIGKILLed and the returning conversation restores from the survivor
  with 0 misses, tail-only; a fenced member's upload draws a FATAL ack and
  its ``/health`` answers 503. Counters and tokens equal the JAX fleet's
  over two JAX members, and the JAX engine's tokens.
"""

import json
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, PORT_CLI, SERVE, Proc, _one_thread, fleets, get_json,
    ledger_balanced, make_fleet, on_the_port, params, procs, reference,
    remote_fleet_cfg, wait_until)

_ref = on_the_port("test_store_tier.py",
                   leave_out=("test_health_gate_starting_until_warm",))
for _name, _obj in list(_ref.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj
model_cfg = _ref["model_cfg"]
wire = _ref["wire"]
backend = _ref["backend"]

_CROSS = ("TestConformance", "TestClientFailover", "TestFencing",
          "TestWeightsTier")


def _bound(cls, ns):
    """``cls`` with the ``wire`` and ``backend`` fixtures of namespace
    ``ns`` (whose ``StoreService`` the caller has replaced)."""
    wire_fn = ns["wire"]._get_wrapped_function()
    backend_fn = ns["backend"]._get_wrapped_function()

    class Bound(cls):
        @pytest.fixture()
        def wire(self, monkeypatch):
            return wire_fn(monkeypatch)

        # the services of the other package: the in-process store of the
        # clients' own package is the reference's own case
        @pytest.fixture(params=["service", "tier"])
        def backend(self, request, wire):
            return backend_fn(request, wire)
    return Bound


def _cross_namespaces():
    from distributed_llm_training_and_inference_system_tpu.serve.fleet.store_service import (  # noqa: E501
        StoreService as JaxService)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_service import (  # noqa: E501
        StoreService as PortService)
    left = ("test_health_gate_starting_until_warm",)
    jax_clients = on_the_port("test_store_tier.py", leave_out=left,
                              swap=False)
    jax_clients["StoreService"] = PortService
    port_clients = on_the_port("test_store_tier.py", leave_out=left)
    port_clients["StoreService"] = JaxService
    return {"JaxClients": jax_clients, "JaxService": port_clients}


for _suffix, _ns in _cross_namespaces().items():
    for _name in _CROSS:
        globals()[_name + _suffix] = _bound(_ns[_name], _ns)


@pytest.mark.socket
def test_health_gate_starting_until_warm(tmp_path, model_cfg):
    """A member restarted over its spill directory answers 503
    ``{"status": "starting"}`` on the stdlib front until its disk scan
    completes, then serves the spilled pages over the wire."""
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_service import (  # noqa: E501
        StoreClient, StoreService)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_tier import (  # noqa: E501
        wait_store_ready)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.transport import (  # noqa: E501
        CourierReceiver)
    cfg, hashes, payload = _ref["_spilled_store_dir"](tmp_path, model_cfg)
    svc = StoreService(cfg, warm=False)
    assert not svc.ready
    svc.warm = lambda: None          # hold the gate shut while we look
    port = svc.serve_http("127.0.0.1", 0)
    ep = f"http://127.0.0.1:{port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{ep}/health", timeout=5.0)
        assert exc.value.code == 503
        assert json.loads(exc.value.read().decode()) == \
            {"status": "starting"}
        assert not wait_store_ready([ep], timeout_s=0.2)
        del svc.warm
        svc.warm()                      # the disk scan completes
        assert wait_store_ready([ep], timeout_s=5.0)
        sc = StoreClient(_ref["store_cfg"](kv_store_endpoints=ep))
        out = sc.fetch(hashes, CourierReceiver())
        np.testing.assert_allclose(out["pages"]["k"],
                                   payload["k"][:, :len(hashes)])
    finally:
        svc.stop()


# -- the JAX regime serve.fleet2+ha-store -------------------------------------

HA_A = [7, 3, 9, 1, 4, 8, 2, 6] * 4
HA_B = [5, 2, 8, 3, 1, 9, 6, 4] * 4
HA_PROMPTS = [HA_A + [70, 71, 72], HA_B + [80, 81, 82]]
HA_GREEDY = dict(temperature=0.0, max_tokens=16)
HA_SERVE = dict(max_seq_len=128)
HA_FLEET = dict(kv_store_write_ack=2, kv_store_retry_max=2,
                kv_store_retry_backoff_ms=5.0, affinity_prefix_tokens=0,
                probe_interval_s=0.05, restart_backoff_s=0.05,
                probe_failures=2, remote_timeout_s=5.0,
                courier_chunk_bytes=1024, prefix_inventory_ttl_ms=60_000.0)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def weight_failover(pkg: str, eps: list, spool) -> dict:
    """Act (a): a payload shipped to both members; a download partitioned
    from member 0 after two batches raises; the next, member 0 dark and
    the same spool, resumes on member 1. The combined serve ledger."""
    from distributed_llm_training_and_inference_system_tpu.serve.fleet import (  # noqa: E501
        faults as jfaults, weights as jweights)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        faults as tfaults, weights as tweights)
    wmod, fmod = ((jweights, jfaults) if pkg == "jax"
                  else (tweights, tfaults))
    name = f"hafo-{pkg}"
    rng = np.random.default_rng(7)
    tree = {"wte": {"embedding": rng.standard_normal(16384).astype(
        np.float32)}, "head": {"w": rng.standard_normal(4096).astype(
            np.float32)}}
    cfg = PKGS[pkg].schema.FleetConfig(
        replicas=1, courier_chunk_bytes=1024, kv_store_retry_max=1,
        kv_store_retry_backoff_ms=1.0)
    total = wmod.WeightCourier(cfg, endpoint=",".join(eps),
                               write_ack=0).ship(name, tree)["total"]

    def partitioned(after):
        return fmod.FaultInjector(fmod.FaultPlan(
            store_partition_member=0, store_partition_after_calls=after,
            store_partition_count=-1))
    first = wmod.WeightCourier(cfg, endpoint=eps[0], spool_dir=str(spool),
                               injector=partitioned(3))
    with pytest.raises(wmod.WeightShipError):
        first.fetch(name)
    second = wmod.WeightCourier(cfg, endpoint=",".join(eps),
                                spool_dir=str(spool),
                                injector=partitioned(0))
    got = second.fetch(name)
    for top, leaf in (("wte", "embedding"), ("head", "w")):
        np.testing.assert_array_equal(got[top][leaf], tree[top][leaf])
    served = [get_json(f"{ep}/store/weights/status?name={name}")["served"]
              for ep in eps]
    combined = {}
    for one in served:
        for q, n in one.items():
            combined[int(q)] = combined.get(int(q), 0) + n
    return {"spooled_first": first.total_chunks >= 16,
            "resumed": second.total_resumes >= 1,
            "balanced": (sorted(combined) == list(range(total))
                         and set(combined.values()) == {1}),
            "both_served": all(served)}


def ha_store_regime(fleet, pkg, restorer, eps, kill_first, fence) -> dict:
    """Acts (b) and (c) on one fleet whose store client spans ``eps``."""
    S = PKGS[pkg].Sampling

    def drain_to(rid):
        assert fleet.drain(rid)
        wait_until(lambda: fleet.replicas[rid].state == "drained",
                   f"drain of replica {rid}", fleet)

    fleet.replicas[0].engine.kv.flush_prefix_cache()
    drain_to(1)
    fleet.generate([HA_A + [50, 51, 52], HA_B + [60, 61, 62]],
                   S(**HA_GREEDY), timeout_s=120)
    fleet.undrain(1)
    drain_to(0)
    snap = fleet.kv_store.snapshot()
    members = [get_json(f"{ep}/store/status")["kv_store"]["demotions"]
               for ep in eps]
    fleet.replicas[0].engine.kv.flush_prefix_cache()
    fleet.router.invalidate_inventories()
    r0 = restorer()
    kill_first()
    [ret] = fleet.generate([HA_PROMPTS[0]], S(**HA_GREEDY), timeout_s=120)
    r1 = restorer()
    fence()
    ack = _call(f"{eps[1]}/store/demote", {"hash": "00" * 16})
    fenced = get_json(f"{eps[1]}/store/status")["kv_store"]
    st = fleet.router.stats()
    return {"tokens": ret.generated_tokens,
            "flushed_8": snap["demotions"] >= 8,
            "both_hold_8": all(d >= 8 for d in members),
            "hits_4": r1[0] - r0[0] >= 4, "misses": r1[1] - r0[1],
            "retried_or_failed_over": r1[3] - r0[3] >= 1,
            "tail_prefill": r1[2] - r0[2],
            "fatal_ack": (ack[0], ack[1]["ok"], ack[1].get("fatal")),
            "fenced_rejects": fenced["fenced_rejects"],
            "health": _call(f"{eps[1]}/health"),
            "failed": st["failed"], "balanced": ledger_balanced(st)}


@pytest.mark.socket
def test_the_ha_store_regime_matches_the_jax_fleet(params, fleets, procs,
                                                   tmp_path):
    import jax

    from distributed_llm_training_and_inference_system_tpu.serve.fleet.weights import (  # noqa: E501
        WeightCourier as JaxCourier)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_tier import (  # noqa: E501
        StoreMembership, wait_store_ready)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.worker import (  # noqa: E501
        PARAMS_PREFIX, params_checksum)
    want = reference("jax", params, HA_PROMPTS[:1], HA_GREEDY, **HA_SERVE)
    out = {}
    # the JAX package: two members of its own service in this process
    jns = on_the_port("test_store_service.py", swap=False)
    jdir = str(tmp_path / "jax-members")
    jmembers = []
    try:
        for mid in ("s0", "s1"):
            h = jns["Harness"]()
            h.svc.membership = StoreMembership(jdir, mid)
            h.svc.member_id = mid
            h.svc.membership.attach({"endpoint": h.endpoint})
            jmembers.append(h)
        jeps = [h.endpoint for h in jmembers]
        jf = make_fleet(fleets, "jax", params, warm=True, serve_kw=HA_SERVE,
                        kv_store_endpoints=",".join(jeps), **HA_FLEET)

        def jax_restorer():
            c = jf.kv_store
            return (c.total_remote_hits, c.total_remote_misses,
                    jf.replicas[1].engine.total_prefill_tokens,
                    c.total_retries + c.total_failovers)
        out["jax"] = ha_store_regime(
            jf, "jax", jax_restorer, jeps, jmembers[0].kill,
            lambda: StoreMembership(jdir, "ctl").fence("s1"))
    finally:
        for h in jmembers:
            h.kill()
    # the port: two spawned members over one membership directory
    mdir = str(tmp_path / "members")
    deadline = time.monotonic() + 60
    members = []
    for mid in ("s0", "s1"):
        p = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu", "fleet",
                  "store", "--port", "0", "--courier-chunk-bytes", "1024",
                  "--member-id", mid, "--membership-dir", mdir,
                  "--sync-interval-ms", "200"],
                 tmp_path / f"store-{mid}.log", "LLMCTL_STORE_READY")
        procs.append(p)
        members.append(p)
    for p in members:
        p.wait_ready(deadline)
    eps = [p.endpoint for p in members]
    assert wait_store_ready(eps, timeout_s=30.0)
    shipped = JaxCourier(endpoint=",".join(eps), write_ack=0).ship(
        "gpt-test", jax.tree_util.tree_map(np.asarray, params["jax"]))
    assert shipped["members"] == 2
    for ep in eps:
        assert get_json(f"{ep}/store/weights/status?name=gpt-test")[
            "complete"]
    failover = {pkg: weight_failover(pkg, eps, tmp_path / f"spool-{pkg}")
                for pkg in ("torch", "jax")}
    assert failover["torch"] == failover["jax"] == {
        "spooled_first": True, "resumed": True, "balanced": True,
        "both_served": True}
    worker = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu",
                   "fleet", "worker", "--model", "gpt-test",
                   "--replica-id", "1", "--port", "0", "--seed", "1000",
                   "--max-batch-size", "2", "--max-seq-len", "128",
                   "--prefill-chunk", "32", "--kv-block-size", "8",
                   "--dtype", "float32", "--courier-chunk-bytes", "1024",
                   "--restart-backoff", "0.05", "--store-endpoints",
                   ",".join(eps), "--weights-from-store",
                   "--weights-name", "gpt-test"],
                  tmp_path / "worker.log", "LLMCTL_WORKER_READY")
    procs.append(worker)
    worker.wait_ready(deadline)
    assert float(worker.stderr_line(PARAMS_PREFIX).split("checksum=")[1]) \
        == params_checksum(params["torch"])
    tf = PKGS["torch"].fleet.ServeFleet(
        PKGS["torch"].cfg, PKGS["torch"].schema.ServeConfig(
            **dict(SERVE, **HA_SERVE)),
        remote_fleet_cfg({1: worker.endpoint}, replicas=2,
                         remote_replicas="1",
                         kv_store_endpoints=",".join(eps), **HA_FLEET),
        params=params["torch"], supervise=False, seed=0, device="cpu")
    fleets.append(tf)
    rep0 = tf.replicas[0].engine
    rep0.generate([[1, 2, 3]], PKGS["torch"].Sampling(temperature=0.0,
                                                      max_tokens=4))
    rep0.total_prefill_tokens = 0
    tf.start()

    def port_restorer():
        st = get_json(f"{worker.endpoint}/worker/status")
        ks = st["kv_store"]
        return (ks["remote_hits"], ks["remote_misses"],
                st["total_prefill_tokens"], ks["retries"] + ks["failovers"])
    out["torch"] = ha_store_regime(
        tf, "torch", port_restorer, eps, members[0].kill,
        lambda: StoreMembership(mdir, "ctl").fence("s1"))
    got = out["torch"]
    assert got == out["jax"]
    assert got["tokens"] == want[0]
    assert got["flushed_8"] and got["both_hold_8"] and got["hits_4"]
    assert got["misses"] == 0 and got["retried_or_failed_over"]
    assert got["tail_prefill"] == len(HA_PROMPTS[0]) - len(HA_A)
    assert got["fatal_ack"] == (200, False, True)
    assert got["fenced_rejects"] == 1
    assert got["health"] == (503, {"status": "fenced"})
    assert got["failed"] == 0 and got["balanced"]
