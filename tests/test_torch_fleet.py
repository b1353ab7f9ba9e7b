"""The port's ServeFleet against the JAX package's, engine-backed (the
JAX package's tests/test_fleet.py arms): both fleets on the same params
(gpt-test, fp32, CPU), the same requests and FaultPlan, give the same
tokens, which are also one undisturbed engine's.

- greedy routing under prefix affinity;
- a crash mid-decode, injected by step count: requeued, nothing dropped,
  the ledger balanced; the supervisor restarts the replica, releasing the
  crashed engine's pool, and it serves again;
- a drain without migration: the streams re-prefill elsewhere;
- a drain with migration, greedy and seeded: 0 re-prefill tokens;
- int8 KV pages migrating;
- the supervisor's probe-timeout teardown, restart and backoff.

Faults fire by step or probe count; every wait is bounded; every fleet
is shut down by the ``fleets`` fixture.
"""

import pytest

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, PROMPTS, _one_thread, await_all, fleets, ledger_balanced,
    make_fleet, params, prefill_tokens, reference, submit, wait_until)

GREEDY = dict(temperature=0.0, max_tokens=24)
SEEDED = dict(temperature=0.9, top_k=16, max_tokens=48, seed=1234)


def fleet_sampling(pkg, **kw):
    return PKGS[pkg].Sampling(**dict(GREEDY, **kw))


def test_greedy_routing_matches_the_jax_fleet(params, fleets):
    want = reference("jax", params, PROMPTS, dict(GREEDY, max_tokens=8))
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, affinity_prefix_tokens=8)
        got = [r.generated_tokens for r in fleet.generate(
            PROMPTS, fleet_sampling(pkg, max_tokens=8), timeout_s=120)]
        st = fleet.router.stats()
        assert got == want, pkg
        assert st["completed"] == len(PROMPTS) and ledger_balanced(st)


def test_crash_mid_decode_requeues_and_the_replica_restarts(params,
                                                            fleets):
    want = reference("jax", params, PROMPTS, GREEDY)
    again = reference("jax", params, PROMPTS[:1], GREEDY)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params,
                           plan=dict(crash_replica=0, crash_after_steps=2))
        crashed = fleet.replicas[0].engine
        reqs = fleet.generate(PROMPTS, fleet_sampling(pkg), timeout_s=120)
        st = fleet.router.stats()
        wait_until(lambda: fleet.replicas[0].state == "healthy",
                   "restart", fleet)
        after = fleet.generate(PROMPTS[:1], fleet_sampling(pkg),
                               timeout_s=120)
        out[pkg] = ([r.generated_tokens for r in reqs], st["requeues"] >= 1,
                    st["completed"], ledger_balanced(st),
                    fleet.replicas[0].restarts,
                    [r.generated_tokens for r in after])
        if pkg == "torch":
            # the crashed engine gave up its pool and weights reference
            assert crashed.kv is None and crashed.params is None
            assert fleet.replicas[0].engine is not crashed
    assert out["torch"] == out["jax"] == (want, True, len(PROMPTS), True, 1,
                                          again)


def _drain_mid_decode(fleet, pkg, prompts, sampling, n_tokens=2):
    reqs, events = submit(fleet, pkg, prompts, sampling)
    wait_until(lambda: all(len(r.generated_tokens) >= n_tokens
                           or e.is_set() for r, e in zip(reqs, events)),
               "decode")
    src = next(r.replica_id for r in fleet.replicas
               if r.resident_requests())
    pre = prefill_tokens(fleet)
    assert fleet.drain(src)
    await_all(fleet, events)
    return reqs, prefill_tokens(fleet) - pre


def test_drain_without_migration_requeues_token_identical(params, fleets):
    sp = dict(GREEDY, max_tokens=64)
    want = reference("jax", params, PROMPTS[:4], sp)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, migrate_on_drain=False,
                           warm=True)
        reqs, reprefilled = _drain_mid_decode(fleet, pkg, PROMPTS[:4], sp)
        st = fleet.router.stats()
        out[pkg] = ([r.generated_tokens for r in reqs], reprefilled > 0,
                    st["completed"], fleet.status()["migration"][
                        "migrations"])
    assert out["torch"] == out["jax"] == (want, True, 4, 0)


@pytest.mark.parametrize("sampling", [dict(GREEDY, max_tokens=64), SEEDED],
                         ids=["greedy", "seeded"])
def test_drain_migration_spends_no_reprefill(params, fleets, sampling):
    want = reference("jax", params, PROMPTS[:4], sampling)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True)
        reqs, reprefilled = _drain_mid_decode(fleet, pkg, PROMPTS[:4],
                                              sampling)
        mig = fleet.status()["migration"]
        out[pkg] = ([r.generated_tokens for r in reqs], reprefilled,
                    mig["migrations"] >= 1, mig["migrated_tokens"] > 0,
                    mig["reprefill_tokens_avoided"] > 0,
                    mig["by_reason"].get("drain", 0) >= 1,
                    ledger_balanced(fleet.router.stats()))
    assert out["torch"] == out["jax"] == (want, 0, True, True, True, True,
                                          True)


def test_int8_kv_pages_migrate(params, fleets):
    sp = dict(GREEDY, max_tokens=64)
    want = reference("jax", params, PROMPTS[:1], sp,
                     kv_quantization="int8")
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True,
                           serve_kw={"kv_quantization": "int8"})
        reqs, reprefilled = _drain_mid_decode(fleet, pkg, PROMPTS[:1], sp,
                                              n_tokens=4)
        logs = [d for r in fleet.replicas for d in r.migration_log]
        out[pkg] = ([r.generated_tokens for r in reqs], reprefilled,
                    len(logs), logs[0]["precopy_pages"] >= 1)
    assert out["torch"] == out["jax"] == (want, 0, 1, True)


def test_probe_timeout_teardown_restart_and_backoff(params, fleets):
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params,
                           plan=dict(probe_timeout_replica=1,
                                     probe_timeout_count=2),
                           probe_failures=2, restart_backoff_max_s=1.0)
        sup = fleet.supervisor
        b0 = sup.current_backoff_s(1)
        sup.poll_once()                         # miss 1
        sup.poll_once()                         # miss 2: teardown
        down = fleet.replicas[1].state
        old = fleet.replicas[1].engine
        wait_until(lambda: fleet.replicas[1].state == "healthy",
                   "restart after the backoff", fleet)
        snap = fleet.status()
        out[pkg] = (down in ("stopped", "crashed"),
                    fleet.replicas[1].restarts,
                    sup.current_backoff_s(1) == min(b0 * 2, 1.0),
                    snap["restarts"],
                    sorted(r["replica"] for r in snap["replicas"]))
        if pkg == "torch":
            assert old.kv is None and fleet.replicas[1].engine is not old
    assert out["torch"] == out["jax"] == (True, 1, True, 1, [0, 1])
