"""The fleet over the wire, in process: the JAX package's tests of the
remote replica, the worker-to-worker courier, the shared file state
store and the HA front (``tests/test_fleet_remote.py`` and
``tests/test_fleet_front.py``) run on the port's modules, and the wire
held to JAX's across the two packages.

- ``tests/test_fleet_front.py``, all of it, and ``TestEndpointConfig``,
  ``TestRemoteReplica`` (against the file's stdlib ``FakeWorkerServer``)
  and ``TestWorkerToWorkerShip`` of ``tests/test_fleet_remote.py``: their
  source with the package's name swapped for the port's. Left out, by
  name: ``TestWorkerToWorkerShip.test_spawned_worker_round_trip``, which
  imports jax and spawns a JAX worker; the port's spawned workers are
  tests/test_torch_fleet_procs.py, tests/test_torch_fleet_procs_quant.py
  and tests/test_torch_fleet_ha.py.
- ``request_to_wire`` gives JAX's JSON for the same requests (greedy,
  seeded, speculative state, partial progress with a ticket), and
  ``request_from_wire`` reads JAX's back.
- JAX's ``RemoteReplica`` (urllib only) drives a port ``FleetWorker``
  served on a thread: submit, probe, outbox, finished and orphan entries,
  tokens equal to the JAX engine's.
- The SSE bytes of a greedy stream and of a ``Last-Event-ID`` resume from
  the port's ``FleetServer`` equal those from JAX's ``FleetServer`` over
  the same params (with the random request id replaced in both).
"""

import asyncio
import json
import threading
import time
import urllib.request


from distributed_llm_training_and_inference_system_tpu.serve import (
    scheduler as jsched)
from distributed_llm_training_and_inference_system_tpu.serve.fleet import (
    remote as jremote)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    scheduler as tsched)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    remote as tremote, worker as tworker)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.http import (  # noqa: E501
    FleetServer as TorchFleetServer)
from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, SERVE, WAIT_S, _one_thread, on_the_port, params, reference)

# -- the reference's tests on the port ---------------------------------------

_front = on_the_port("test_fleet_front.py")
for _name, _obj in list(_front.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj
_remote = on_the_port("test_fleet_remote.py",
                      leave_out=("test_spawned_worker_round_trip",))
TestEndpointConfig = _remote["TestEndpointConfig"]
TestRemoteReplica = _remote["TestRemoteReplica"]
TestWorkerToWorkerShip = _remote["TestWorkerToWorkerShip"]
model_cfg = _front["model_cfg"]
fake_worker = _remote["fake_worker"]


# -- the wire form across packages -------------------------------------------

def _requests(mod):
    S, R = mod.SamplingParams, mod.Request
    greedy = R(request_id="g", prompt_tokens=[5, 17, 99],
               sampling=S(temperature=0.0, max_tokens=8))
    seeded = R(request_id="s", prompt_tokens=[1, 2, 3, 4],
               sampling=S(temperature=0.8, top_k=40, top_p=0.9, seed=123,
                          max_tokens=16, stop_token_ids=(2, 7)))
    spec = R(request_id="sp", prompt_tokens=[9, 8, 7],
             sampling=S(temperature=0.0, max_tokens=12))
    spec.spec_state = {"window": 4, "accepted": 7, "drafted": 12,
                       "dispatches": 3}
    spec.priority = "interactive"
    part = R(request_id="p", prompt_tokens=[3, 1, 4, 1, 5],
             sampling=S(temperature=0.7, seed=5, max_tokens=20))
    part.generated_tokens = [11, 12, 13]
    part.assigned_seed = 987654321
    part.fleet_requeued = True
    part.handoffs = 1
    part.stream_requested = True
    part.swapped_kv = {"courier_ticket": "courier-abc", "at": 1,
                       "partial": True}
    part.prefix_owner = 0
    part.prefix_owner_endpoint = "http://127.0.0.1:9"
    part.pipeline_stage = {"stage": 1, "of": 2, "end": 32}
    return [greedy, seeded, spec, part]


def test_request_wire_equals_jax():
    for j, t in zip(_requests(jsched), _requests(tsched)):
        jw, tw = jremote.request_to_wire(j), tremote.request_to_wire(t)
        assert json.dumps(tw) == json.dumps(jw), j.request_id
        back = tremote.request_from_wire(json.loads(json.dumps(jw)))
        assert tremote.request_to_wire(back) == {**tw, "ticket": None,
                                                 "partial": False}
        assert json.dumps(tremote.sampling_to_wire(t.sampling)) == \
            json.dumps(jremote.sampling_to_wire(j.sampling))
    d = {"generated_tokens": [1, 2], "assigned_seed": 4, "handoffs": 2,
         "spec_state": {"window": 2}}
    j, t = _requests(jsched)[0], _requests(tsched)[0]
    jremote.apply_wire(j, d)
    tremote.apply_wire(t, d)
    assert json.dumps(tremote.request_to_wire(t)) == json.dumps(
        jremote.request_to_wire(j))


# -- JAX's client against the port's worker ------------------------------------

def _port_worker(params, plan=None):
    tp = PKGS["torch"]
    w = tworker.FleetWorker(
        1, tp.cfg, tp.schema.ServeConfig(**SERVE),
        fleet_cfg=tp.schema.FleetConfig(replicas=1,
                                        restart_backoff_s=0.05),
        params=params["torch"], seed=1000,
        fault_plan=tp.fleet.FaultPlan(**plan) if plan else None,
        device="cpu")
    w.serve_http("127.0.0.1", 0)
    return w


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_jax_remote_replica_drives_a_port_worker(params):
    from distributed_llm_training_and_inference_system_tpu.config.schema \
        import FleetConfig as JaxFleetConfig
    w = _port_worker(params)
    done = []
    rr = jremote.RemoteReplica(
        1, w.self_endpoint, fleet_cfg=JaxFleetConfig(replicas=2),
        on_finish=lambda rid, r: done.append(r))
    try:
        rr.start()
        prompts = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5]]
        sp = dict(temperature=0.0, max_tokens=8)
        reqs = [jsched.Request(request_id=f"j{i}", prompt_tokens=list(p),
                               sampling=jsched.SamplingParams(**sp))
                for i, p in enumerate(prompts)]
        assert all(rr.submit(r) for r in reqs)
        probe = rr.probe()
        assert probe["state"] == "healthy" and probe["replica"] == 1
        _wait(lambda: len(done) == len(reqs), "remote requests")
        assert [r.generated_tokens for r in reqs] == reference(
            "jax", params, prompts, sp)
        assert all(r.state is jsched.RequestState.FINISHED for r in reqs)
        # the probe's counters, as JAX's client mirrors them
        after = rr.probe()
        assert after["total_prefill_tokens"] == sum(map(len, prompts))
        assert rr.outstanding_tokens() == 0 and rr.active_count() == 0
    finally:
        rr.stop()
        w.shutdown()


def test_a_crashed_port_worker_engine_returns_orphans_to_jax(params):
    """The worker's engine crashes mid-decode (a seeded fault); its
    in-flight request comes back through the outbox as an orphan entry in
    JAX's form, and the worker rebuilds its engine."""
    from distributed_llm_training_and_inference_system_tpu.config.schema \
        import FleetConfig as JaxFleetConfig
    w = _port_worker(params, plan=dict(crash_replica=1,
                                       crash_after_steps=3))
    rr = jremote.RemoteReplica(1, w.self_endpoint,
                               fleet_cfg=JaxFleetConfig(replicas=2))
    try:
        rr.start()
        req = jsched.Request(request_id="o1", prompt_tokens=[9, 8, 7, 6],
                             sampling=jsched.SamplingParams(
                                 temperature=0.0, max_tokens=40))
        assert rr.submit(req)
        orphans = []
        _wait(lambda: orphans.extend(rr.take_orphans()) or orphans,
              "no orphan came back")
        [o] = orphans
        assert o is req and o.request_id == "o1"
        assert o.prompt_tokens == [9, 8, 7, 6]
        _wait(lambda: w._restarts == 1, "the worker never rebuilt")
        assert rr.probe()["engine_restarts"] == 1
    finally:
        rr.stop()
        w.shutdown()


# -- SSE bytes against JAX's front -------------------------------------------

def _gate_first_publish(fleet):
    """Hold each request's token publishes until its SSE subscriber is
    attached, so both fronts frame the same batches."""
    hub = fleet.streams
    orig = hub.publish_from_request

    def gated(req, tokens, replica=None):
        deadline = time.monotonic() + WAIT_S
        while True:
            with hub._lock:
                log = hub._logs.get(req.request_id)
                if log is None or log.subs or log.finished:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        return orig(req, tokens, replica=replica)
    hub.publish_from_request = gated


def _sse(url, body=None, headers=None) -> bytes:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})},
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return resp.read()


def _stream_bytes(base, prompt, max_tokens) -> tuple[bytes, bytes]:
    """(the POST stream's bytes, a resume's from Last-Event-ID 2), with
    the request id replaced by RID."""
    first = _sse(f"{base}/v1/completions",
                 {"prompt": prompt, "max_tokens": max_tokens,
                  "temperature": 0.0, "stream": True})
    rid = json.loads(first.split(b"\n")[0][len(b"data: "):])["id"]
    again = _sse(f"{base}/v1/streams/{rid}", headers={"Last-Event-ID": "2"})
    return (first.replace(rid.encode(), b"RID"),
            again.replace(rid.encode(), b"RID"))


def test_sse_bytes_equal_jax_fleet_server(params):
    from distributed_llm_training_and_inference_system_tpu.serve.fleet.http \
        import FleetServer as JaxFleetServer
    prompt, n = [5, 17, 99, 3, 42, 7, 23], 9
    got = {}
    for pkg in ("jax", "torch"):
        p = PKGS[pkg]
        scfg = p.schema.ServeConfig(**dict(SERVE, host="127.0.0.1", port=0))
        fcfg = p.schema.FleetConfig(replicas=2, affinity_prefix_tokens=0,
                                    probe_interval_s=0.05)
        if pkg == "torch":
            srv = TorchFleetServer(p.cfg, scfg, fcfg, params=params[pkg],
                                   device="cpu")
            _gate_first_publish(srv.fleet)
            port = srv.start()
            try:
                got[pkg] = _stream_bytes(f"http://127.0.0.1:{port}",
                                         prompt, n)
            finally:
                srv.stop()
            continue
        srv = JaxFleetServer(p.cfg, scfg, fcfg, params=params[pkg])
        _gate_first_publish(srv.fleet)
        loop = asyncio.new_event_loop()
        runner = loop.run_until_complete(srv.start_async())
        t = threading.Thread(target=loop.run_forever, daemon=True)
        t.start()
        try:
            got[pkg] = _stream_bytes(f"http://127.0.0.1:{srv.bound_port}",
                                     prompt, n)
        finally:
            async def _close():
                if srv._refresher is not None:
                    srv._refresher.cancel()
                await runner.cleanup()
            asyncio.run_coroutine_threadsafe(_close(), loop).result(30)
            loop.call_soon_threadsafe(loop.stop)
            t.join(10)
            srv.fleet.shutdown()
    assert got["torch"] == got["jax"]
    first, resumed = got["torch"]
    ids = [int(x.split(b": ")[1]) for x in first.split(b"\n")
           if x.startswith(b"id: ")]
    assert ids == sorted(ids) and ids[-1] == n - 1
    assert resumed.startswith(b"id: ") and b'"seq": ' in resumed
    assert first.endswith(b"data: [DONE]\n\n")
    assert resumed.endswith(b"data: [DONE]\n\n")
