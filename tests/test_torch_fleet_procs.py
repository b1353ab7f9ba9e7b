"""The multi-process arms of the JAX package's ``serve.fleet2+remote``
regime on the port: two spawned `llmctl-torch fleet worker` processes
(gpt-test, fp32, CPU) serving JAX's params from JAX's export artifact,
fronted by the port's ``RemoteReplica`` inside a ``ServeFleet``, with
the regime's chunk chaos (drop 0.2, corrupt 0.15, duplicate 0.1) seeded
at each worker's sender.

(a) a drain mid-decode moves the residents worker to worker over the
    HTTP courier: total prefill tokens equal the prompt tokens (zero
    re-prefill) and the tokens are the JAX engine's;
(b) the same under seeded sampling;
(c) SIGKILL a worker mid-decode: its requests re-prefill on the survivor,
    the ledger balances, the tokens are the JAX engine's;
(d) a prefill/decode pair: one handoff per prompt and zero prefill on
    the decode worker.

Every process is stopped in the fixture's teardown; every wait is
bounded.
"""

import time

import pytest

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    CHAOS, PKGS, SERVE, WAIT_S, get_json, jax_artifact, params, procs,
    reference, remote_fleet_cfg, spawn_worker)

pytestmark = pytest.mark.socket

PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2], [6, 1, 8, 0],
           [35, 8, 9, 7, 9, 3]]
DIS_PROMPTS = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5], [9, 8, 7, 6]]
GREEDY = dict(temperature=0.0, max_tokens=60)
SEEDED = dict(temperature=0.8, seed=123, max_tokens=40)


def _fleet(endpoints, **kw):
    tp = PKGS["torch"]
    return tp.fleet.ServeFleet(
        tp.cfg, tp.schema.ServeConfig(**SERVE),
        remote_fleet_cfg(endpoints, **kw), supervise=False, device="cpu")


def _run_batch(fleet, prompts, sampling, deadline, hook=None,
               hook_ep=None):
    Sampling = PKGS["torch"].Sampling
    events, reqs = [], []
    import threading
    for p in prompts:
        ev = threading.Event()
        reqs.append(fleet.submit(p, Sampling(**sampling),
                                 on_complete=lambda _r, ev=ev: ev.set()))
        events.append(ev)
    if hook is not None:
        while True:
            s = get_json(f"{hook_ep}/worker/status")
            if s.get("active", 0) >= 1 and s["total_prefill_tokens"] > 0:
                hook()
                break
            assert time.monotonic() < deadline, "mid-decode hook never fired"
            time.sleep(0.005)
    while not all(e.is_set() for e in events):
        fleet.supervisor.poll_once()
        time.sleep(0.01)
        assert time.monotonic() < deadline, "remote batch hung"
    return [list(r.generated_tokens) for r in reqs]


def test_two_workers_drain_seeded_kill(params, procs, tmp_path):
    """Arms (a), (b) and (c) on one pair of workers, as the regime runs
    them."""
    deadline = time.monotonic() + WAIT_S
    art = jax_artifact(params, tmp_path)
    slow = {"slow_ms": 8.0}
    wa = spawn_worker(tmp_path, art, 0, plan=dict(
        CHAOS, seed=5, slow_replica=0, **slow))
    wb = spawn_worker(tmp_path, art, 1, plan=dict(
        CHAOS, seed=6, slow_replica=1, **slow))
    procs += [wa, wb]
    wa.wait_ready(deadline)
    wb.wait_ready(deadline)
    ref = reference("jax", params, PROMPTS, GREEDY)
    sref = reference("jax", params, PROMPTS, SEEDED)
    n_prompt = sum(len(p) for p in PROMPTS)
    fleet = _fleet({0: wa.endpoint, 1: wb.endpoint})
    fleet.start()
    try:
        # (a) greedy drain with migration under chunk chaos
        toks = _run_batch(fleet, PROMPTS, GREEDY, deadline,
                          hook=lambda: fleet.drain(0), hook_ep=wa.endpoint)
        assert toks == ref, "remote drain diverged from the JAX engine"
        sa = get_json(f"{wa.endpoint}/worker/status")
        sb = get_json(f"{wb.endpoint}/worker/status")
        assert sa["total_prefill_tokens"] + sb["total_prefill_tokens"] \
            == n_prompt, "the drain re-prefilled"
        assert fleet.router.stats()["requeues"] >= 1
        assert sa["courier"]["transfers"] >= 1, "no worker-to-worker ship"
        assert sa["courier"]["aborts"] == 0, sa["courier"]
        assert sa["courier"]["retries"] + sb["courier"]["retries"] > 0, \
            "the chunk chaos never fired"
        # (b) seeded sampling across a drain of the other worker
        fleet.undrain(0)
        toks = _run_batch(fleet, PROMPTS, SEEDED, deadline,
                          hook=lambda: fleet.drain(1), hook_ep=wb.endpoint)
        assert toks == sref, "remote seeded drain diverged"
        # (c) SIGKILL worker 1 mid-decode
        fleet.undrain(1)
        toks = _run_batch(fleet, PROMPTS, GREEDY, deadline, hook=wb.kill,
                          hook_ep=wb.endpoint)
        assert toks == ref, "the run across a SIGKILL diverged"
        st = fleet.router.stats()
        assert st["failed"] == 0 and st["in_flight"] == 0
        assert st["completed"] == st["submitted"] - st["rejected"], st
        assert fleet.replicas[1].state == "crashed"
    finally:
        fleet.shutdown()
    # the survivor stops cleanly and reports its launches; the killed
    # worker reports nothing
    assert wa.stop() == 0
    assert wa.stderr_line("LLMCTL_WORKER_LAUNCHES") is not None
    assert wb.stderr_line("LLMCTL_WORKER_LAUNCHES") is None


def test_prefill_decode_pair(params, procs, tmp_path):
    """Arm (d): every prompt prefills on worker 0 and crosses the HTTP
    courier to worker 1, which dispatches no prefill."""
    deadline = time.monotonic() + WAIT_S
    art = jax_artifact(params, tmp_path)
    wa = spawn_worker(tmp_path, art, 0, plan=dict(CHAOS, seed=11))
    wb = spawn_worker(tmp_path, art, 1, role="decode",
                      plan=dict(CHAOS, seed=12))
    procs += [wa, wb]
    wa.wait_ready(deadline)
    wb.wait_ready(deadline)
    sampling = dict(temperature=0.0, max_tokens=20)
    ref = reference("jax", params, DIS_PROMPTS, sampling)
    fleet = _fleet({0: wa.endpoint, 1: wb.endpoint}, roles="prefill,decode")
    fleet.start()
    try:
        toks = _run_batch(fleet, DIS_PROMPTS, sampling, deadline)
        assert toks == ref, "remote disaggregation diverged"
        sa = get_json(f"{wa.endpoint}/worker/status")
        sb = get_json(f"{wb.endpoint}/worker/status")
        st = fleet.router.stats()
        assert sa["handoffs"] == len(DIS_PROMPTS) == st["handoffs"]
        assert sb["total_prefill_tokens"] == 0
        assert sb["total_unexpected_prefills"] == 0
        assert sa["total_prefill_tokens"] == sum(len(p)
                                                 for p in DIS_PROMPTS)
        assert st["completed"] == len(DIS_PROMPTS) and st["failed"] == 0
    finally:
        fleet.shutdown()
