"""The port's autoscaler (serve/fleet/autoscaler.py) and the fleet's
membership methods, held to the JAX package's.

- The JAX package's ``tests/test_autoscaler.py`` on the port's modules.
  Left out, by name, ``test_synthesized_worker_argv_bootstraps_from_store``,
  which expects the JAX CLI module's command line; its port counterpart
  below checks the port's module, the worker's ``--device``, and that
  ``llmctl-torch fleet worker`` parses the line.
- The JAX regime ``serve.fleet2+autoscale`` on both packages' fleets,
  driven by explicit ``supervisor.poll_once()`` calls: a burst scales 2 to
  3 by adopting the warm spare, the fade retires it with its pages flushed
  to the KV store and a returning conversation prefills only its tail,
  and the TTFT guard migrates a best-effort resident for a queued
  interactive request. Tokens, counters and the event kinds are equal.
"""

import threading
import time

from distributed_llm_training_and_inference_system_tpu_torch.cli.commands import (  # noqa: E501
    fleet as tfleet_cli)
from distributed_llm_training_and_inference_system_tpu_torch.config.schema import (  # noqa: E501
    FleetConfig)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    autoscaler as tasc)
from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, PORT_CLI, _one_thread, fleets, ledger_balanced, make_fleet,
    on_the_port, params, reference, wait_until)

_ref = on_the_port("test_autoscaler.py", leave_out=(
    "test_synthesized_worker_argv_bootstraps_from_store",))
for _name, _obj in list(_ref.items()):
    if _name.startswith("test_") and callable(_obj):
        globals()[_name] = _obj


def test_synthesized_worker_argv_bootstraps_from_store():
    from types import SimpleNamespace

    serve = SimpleNamespace(model="gpt-test", max_batch_size=4,
                            max_seq_len=128, kv_block_size=16,
                            dtype="float32", kv_quantization="none",
                            artifact="", prefill_chunk=0,
                            speculative="off", speculative_tokens=4)
    cfg = FleetConfig(kv_store_endpoint="http://127.0.0.1:9400",
                      prefix_fetch=True)
    argv = tasc.synthesize_worker_argv(None, serve, cfg,
                                       weights_name="gpt-test",
                                       spool_dir="/tmp/spool", device="cpu")
    assert argv[1:7] == ["-m", PORT_CLI, "--device", "cpu", "fleet",
                         "worker"]
    s = " ".join(argv)
    assert "--model gpt-test" in s
    assert "--store-endpoint http://127.0.0.1:9400" in s
    assert "--weights-from-store" in s
    assert "--weights-name gpt-test" in s
    assert "--weights-spool /tmp/spool" in s
    assert "--artifact" not in s
    plain = tasc.synthesize_worker_argv(None, serve, FleetConfig())
    assert "--weights-from-store" not in " ".join(plain)
    assert "--device cuda" in " ".join(plain)
    assert "--replica-id" not in s and "--port" not in s
    # the worker's own parser reads the line, the spawner's additions too
    args = tfleet_cli.build_parser("fleet").parse_args(
        argv[6:] + ["--replica-id", "3", "--port", "0"])
    assert (args.sub, args.model_name, args.store_endpoint,
            args.weights_from_store, args.weights_spool, args.replica_id) \
        == ("worker", "gpt-test", "http://127.0.0.1:9400", True,
            "/tmp/spool", 3)


def test_a_worker_spawning_fleet_names_its_device(params, fleets):
    """``autoscale_spawn="worker"`` gives the fleet a ProcessWorkerSpawner
    whose command line runs the port's CLI on the fleet's device, and no
    warm spare (scale-ups are processes)."""
    fleet = make_fleet(fleets, "torch", params, autoscale=True,
                       autoscale_spawn="worker", autoscale_max_replicas=3)
    spawner = fleet.autoscaler.spawner
    assert isinstance(spawner, tasc.ProcessWorkerSpawner)
    assert spawner.argv_base[1:7] == ["-m", PORT_CLI, "--device", "cpu",
                                      "fleet", "worker"]
    assert fleet.wait_warm_spares(1.0) and fleet._spares == []


# -- the JAX regime serve.fleet2+autoscale --------------------------------------

AS_HOT = [9, 2, 7, 4, 1, 8, 3, 6] * 3      # 24 tokens = 3 pages
AS_PROMPTS = [AS_HOT + [100 + i] for i in range(6)]
AS_WARM = AS_HOT + [200]
AS_RET = AS_HOT + [77, 78]
AS_BE_PROMPTS = [[11, 12, 13, 14, 15], [21, 22, 23, 24, 25]]
AS_IA = [31, 32, 33, 34]
GREEDY = dict(temperature=0.0, max_tokens=16)
BE = dict(temperature=0.0, max_tokens=110)
REGIME_SERVE = dict(max_batch_size=1, max_seq_len=128)


def _drain(fleet, rid):
    assert fleet.drain(rid)
    wait_until(lambda: fleet.replicas[rid].state == "drained",
               f"drain of replica {rid}", fleet)


def autoscale_regime(fleet, pkg) -> dict:
    S = PKGS[pkg].Sampling
    for rep in fleet.replicas:
        rep.engine.kv.flush_prefix_cache()
    scaler = fleet.autoscaler
    # (a) a burst: 6 requests into 2 single-slot replicas
    evs, reqs = [], []
    for i, p in enumerate(AS_PROMPTS):
        ev = threading.Event()
        reqs.append(fleet.submit(
            p, S(**GREEDY),
            priority=("interactive", "standard", "best-effort")[i % 3],
            on_complete=lambda _r, ev=ev: ev.set()))
        evs.append(ev)
    wait_until(lambda: all(e.is_set() for e in evs)
               and scaler.total_scale_ups >= 1, "autoscale burst", fleet)
    burst = {"replicas": len(fleet.replicas),
             "tokens": [r.generated_tokens for r in reqs]}
    # (b) the fade: one hot turn pinned on the spawned replica, the store
    # wiped of what the operator's drains flushed, then the floor lowered
    _drain(fleet, 0)
    _drain(fleet, 1)
    warm = fleet.generate([AS_WARM], S(**GREEDY), timeout_s=120)
    fleet.undrain(0)
    fleet.undrain(1)
    fleet.kv_store.clear()
    fleet.fleet_cfg.autoscale_min_replicas = 2
    wait_until(lambda: scaler.total_scale_downs >= 1, "scale-down", fleet)
    down = [e for e in scaler.events if e["kind"] == "scale_down"]
    for rep in fleet.replicas:
        rep.engine.kv.flush_prefix_cache()
    fleet.router.invalidate_inventories()
    pre = sum(r.engine.total_prefill_tokens for r in fleet.replicas)
    hits0 = fleet.kv_store.snapshot()["hits"]
    ret = fleet.generate([AS_RET], S(**GREEDY), timeout_s=120)
    fade = {"ids": sorted(r.replica_id for r in fleet.replicas),
            "flushed_some": down[0]["flushed_pages"] >= 3,
            "warm": warm[0].generated_tokens,
            "ret": ret[0].generated_tokens,
            "restored_pages": fleet.kv_store.snapshot()["hits"] - hits0 >= 3,
            "tail_prefill": sum(r.engine.total_prefill_tokens
                                for r in fleet.replicas) - pre}
    # (c) the TTFT guard: both slots held by best-effort runs
    order, be_evs, be_reqs = [], [], []
    for i, p in enumerate(AS_BE_PROMPTS):
        ev = threading.Event()
        be_reqs.append(fleet.submit(
            p, S(**BE), priority="best-effort",
            on_complete=lambda _r, ev=ev, i=i: (order.append(f"be{i}"),
                                                ev.set())))
        be_evs.append(ev)
    deadline = time.monotonic() + 120
    while sum(r.active_count() for r in fleet.replicas) < 2:
        time.sleep(0.002)
        assert time.monotonic() < deadline, "best-effort never resident"
    ia_ev = threading.Event()
    ia = fleet.submit(AS_IA, S(**GREEDY), priority="interactive",
                      on_complete=lambda _r: (order.append("ia"),
                                              ia_ev.set()))
    wait_until(lambda: scaler.total_preemptions >= 1, "TTFT guard", fleet)
    wait_until(lambda: ia_ev.is_set() and all(e.is_set() for e in be_evs),
               "preempt act", fleet)
    pev = [e for e in scaler.events if e["kind"] == "preempt"]
    victim = next(f"be{i}" for i, r in enumerate(be_reqs)
                  if r.request_id == pev[0]["request"])
    guard = {"ia_first": order.index("ia") < order.index(victim),
             "ia": ia.generated_tokens,
             "be": [r.generated_tokens for r in be_reqs]}
    snap = scaler.snapshot()
    st = fleet.router.stats()
    return {"burst": burst, "fade": fade, "guard": guard,
            "events": [(e["kind"], e.get("replica")) for e in scaler.events
                       if e["kind"] != "preempt"] + [("preempt", None)],
            "counters": {k: snap[k] for k in (
                "replicas", "scale_ups", "scale_downs", "spawn_failures",
                "retire_rollbacks", "spawned")},
            "preempted": snap["preemptions"] >= 1,
            "failed": st["failed"], "balanced": ledger_balanced(st)}


def test_the_autoscale_regime_matches_the_jax_fleet(params, fleets):
    ref = reference("jax", params, AS_PROMPTS, GREEDY, **REGIME_SERVE)
    warm_ref = reference("jax", params, [AS_WARM, AS_RET], GREEDY,
                         **REGIME_SERVE)
    be_ref = reference("jax", params, AS_BE_PROMPTS, BE, **REGIME_SERVE)
    ia_ref = reference("jax", params, [AS_IA], GREEDY, **REGIME_SERVE)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(
            fleets, pkg, params, warm=True, serve_kw=REGIME_SERVE,
            kv_store=True, kv_store_dram_mb=16.0, autoscale=True,
            autoscale_min_replicas=3, autoscale_max_replicas=3,
            autoscale_up_queue_per_replica=1.0,
            autoscale_down_queue_per_replica=0.5,
            autoscale_hysteresis_polls=1, autoscale_cooldown_polls=0,
            interactive_ttft_target_ms=25.0)
        out[pkg] = autoscale_regime(fleet, pkg)
    got = out["torch"]
    assert got == out["jax"]
    assert got["burst"] == {"replicas": 3, "tokens": ref}
    assert got["fade"] == {"ids": [0, 1], "flushed_some": True,
                           "warm": warm_ref[0], "ret": warm_ref[1],
                           "restored_pages": True,
                           "tail_prefill": len(AS_RET) - len(AS_HOT)}
    assert got["guard"] == {"ia_first": True, "ia": ia_ref[0],
                            "be": be_ref}
    assert got["events"] == [("scale_up", 2), ("retire_begin", 2),
                             ("scale_down", 2), ("preempt", None)]
    assert got["counters"]["scale_ups"] == got["counters"]["scale_downs"] \
        == 1
    assert got["failed"] == 0 and got["balanced"]
