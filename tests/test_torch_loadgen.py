"""The port's load generator against the JAX package's on one engine each
(gpt-test, fp32, CPU).

- The same seed offers the same requests: the same prompts, in the same
  arrival order, open and closed loop, with a prompt pool and a hot
  prefix (the prompts are drawn after the arrival gaps from one numpy
  generator, so equal prompts also mean the gaps were drawn alike).
- Every request's greedy tokens equal the JAX engine's for that request.
- ``summary()`` has JAX's keys (with ``device_times`` too); completed,
  failed and token counts agree with the requests.
- A fleet target runs through its router with the per-replica breakdown;
  the HA fronts' stream client runs; the store tier's returning
  conversations (``run_returning``) and a cell of the autoscaler's
  scenario matrix (``run_scenario``) run on both packages' fleets with
  equal tokens and readouts.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, loadgen as jload)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg, schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams, loadgen as tload)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


def _engines(params):
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**SERVE),
                   params=params, seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**SERVE),
                         params=params_from_jax(
                             jax.tree_util.tree_map(np.asarray, params),
                             torch_cfg("gpt-test"), device="cpu"),
                         seed=0, device="cpu")
    return je, te


def _recording(engine):
    """The requests an engine's scheduler is offered, in order."""
    seen = []
    add = engine.scheduler.add_request

    def record(r):
        seen.append(r)
        return add(r)
    engine.scheduler.add_request = record
    return seen


def _offered(seen):
    return [(r.request_id, list(r.prompt_tokens), r.sampling.max_tokens)
            for r in seen]


RUNS = [
    ("poisson", dict(offered_rps=500.0, num_requests=6, prompt_len=12,
                     max_tokens=5, seed=3)),
    ("poisson", dict(offered_rps=500.0, num_requests=5, prompt_len=16,
                     max_tokens=4, seed=4, prompt_pool=2)),
    ("poisson", dict(offered_rps=500.0, num_requests=5, prompt_len=20,
                     max_tokens=4, seed=5, hot_prefix_len=8)),
    ("closed", dict(concurrency=2, num_requests=5, prompt_len=10,
                    max_tokens=6, seed=6)),
    ("closed", dict(concurrency=3, num_requests=4, prompt_len=24,
                    max_tokens=3, seed=7, hot_prefix_len=16)),
]


@pytest.mark.parametrize("kind,kw", RUNS, ids=[
    "poisson", "poisson-pool", "poisson-hot", "closed", "closed-hot"])
def test_same_requests_same_tokens_same_summary(params, kind, kw):
    je, te = _engines(params)
    jseen, tseen = _recording(je), _recording(te)
    run = {"poisson": (jload.run_poisson, tload.run_poisson),
           "closed": (jload.run_closed_loop, tload.run_closed_loop)}[kind]
    jres, tres = run[0](je, **kw), run[1](te, **kw)
    assert _offered(tseen) == _offered(jseen)
    jtok = {r.request_id: r.generated_tokens for r in jseen}
    ttok = {r.request_id: r.generated_tokens for r in tseen}
    assert ttok == jtok
    js, ts = jres.summary(), tres.summary()
    assert list(ts) == list(js)
    for key in ("offered_rps", "completed", "failed", "preemptions"):
        assert ts[key] == js[key], key
    n = kw["num_requests"]
    assert ts["completed"] + ts["failed"] == n and ts["completed"] == n
    assert len(tres.ttft_ms) == n
    assert len(tres.tpot_ms) == sum(len(t) > 1 for t in ttok.values())
    assert ts["goodput_tok_s"] > 0
    assert tres.goodput_tokens_per_s * tres.duration_s == pytest.approx(
        sum(len(t) for t in ttok.values()))


def test_device_times_add_jax_keys(params):
    je, te = _engines(params)
    kw = dict(concurrency=2, num_requests=3, prompt_len=12, max_tokens=4,
              seed=1, device_times=True)
    js = jload.run_closed_loop(je, **kw).summary()
    res = tload.run_closed_loop(te, **kw)
    ts = res.summary()
    assert list(ts) == list(js)
    assert len(res.ttft_device_ms) == 3
    assert res.decode_ms_per_token_device > 0
    # the calibration wrote nothing but scratch page 0: a request served
    # after it gets the tokens of an engine that never calibrated
    _, fresh = _engines(params)
    prompt = [[9, 8, 7, 6, 5, 4, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    assert [r.generated_tokens for r in te.generate(prompt, sp)] == \
        [r.generated_tokens for r in fresh.generate(prompt, sp)]


def test_fleet_targets_and_scenarios_name_the_fleet_item(params):
    """A fleet target runs through its router (both replicas appear in
    the per-replica breakdown, every request completes as on one engine);
    the HA fronts' stream client is served (an unreachable front list
    reports a failed stream); the scenarios of the store tier and the
    autoscaler run on a KV-store fleet of each package: the returning
    turns' tokens, the prefill and fetched tokens they spent, and a
    flash-crowd cell's plan-order tokens equal JAX's."""
    from distributed_llm_training_and_inference_system_tpu.serve.fleet import (  # noqa: E501
        ServeFleet as JaxFleet)
    from distributed_llm_training_and_inference_system_tpu_torch.config.schema import (  # noqa: E501
        FleetConfig)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        ServeFleet)
    _, te = _engines(params)
    fleet = ServeFleet(torch_cfg("gpt-test"), ServeConfig(**SERVE),
                       FleetConfig(replicas=2, affinity_prefix_tokens=0),
                       params=te.params, supervise=False, device="cpu")
    fleet.start()
    try:
        res = tload.run_closed_loop(fleet, concurrency=2, num_requests=3,
                                    prompt_len=6, max_tokens=3, seed=5)
    finally:
        fleet.shutdown()
    alone = tload.run_closed_loop(te, concurrency=2, num_requests=3,
                                  prompt_len=6, max_tokens=3, seed=5)
    assert res.completed == alone.completed == 3
    assert sorted(res.per_replica) == [0, 1]
    assert sum(v["requests"] for v in res.per_replica.values()) == 3
    assert set(res.summary()["per_replica"][0]) == {
        "requests", "p50_ttft_ms", "p99_ttft_ms", "requeues"}
    out = {}
    for pkg, mod, make, schema, p in (
            ("jax", jload, JaxFleet, jax_schema, params),
            ("torch", tload, ServeFleet, torch_schema, te.params)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        f = make((jax_cfg if pkg == "jax" else torch_cfg)("gpt-test"),
                 schema.ServeConfig(**SERVE),
                 schema.FleetConfig(replicas=2, affinity_prefix_tokens=0,
                                    kv_store=True, kv_store_dram_mb=16.0),
                 params=p, supervise=False, seed=0, **kw)
        f.start()
        try:
            ret = mod.run_returning(f, conversations=2, history_len=24,
                                    tail_len=4, max_tokens=4,
                                    filler_requests=2, filler_len=12,
                                    seed=3)
            cell = mod.run_scenario(f, scenario="flash-crowd",
                                    duration_s=0.4, base_rps=10.0,
                                    peak_rps=20.0, prompt_len=8,
                                    max_tokens=3, seed=4)
        finally:
            f.shutdown()
        r = ret.returning
        out[pkg] = (sorted(ret.summary()), r["token_lists"],
                    r["return_prefill_tokens"], r["return_fetched_tokens"],
                    sorted(cell.summary()["scenario"]),
                    cell.scenario["token_lists"],
                    cell.scenario["offered"]["planned_requests"],
                    sorted(cell.scenario["classes"]))
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == 2 and out["torch"][6] > 0
    assert all(t is not None for t in out["torch"][5])
    dead = tload.run_stream_fronts(
        ["http://127.0.0.1:9"], num_requests=1, prompt_len=3, max_tokens=2,
        client=tload.FrontStreamClient(["http://127.0.0.1:9"],
                                       max_attempts=2, backoff_s=0.001))
    assert dead.failed == 1 and dead.stream["gaps"] == 0
