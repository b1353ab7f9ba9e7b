"""What the fleet tests of the port share (tests/test_torch_fleet*.py):
both packages' ``ServeFleet`` built alike on one params tree (gpt-test,
fp32, CPU), driven to the end with every wait bounded, and shut down by
the ``fleets`` fixture of each test file."""

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu.serve import (
    fleet as jax_fleet)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg, schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    fleet as torch_fleet)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

PROMPTS = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5], [9, 8, 7, 6],
           [11, 12, 13], [21, 22, 23, 24, 25, 26], [31, 32, 33]]
WAIT_S = 120.0            # the bound on every wait of a fleet test
SERVE = dict(model="gpt-test", max_batch_size=2, max_seq_len=256,
             prefill_chunk=32, kv_block_size=8, dtype="float32",
             decode_steps_per_dispatch=2)

PKGS = {
    "jax": SimpleNamespace(
        fleet=jax_fleet, schema=jax_schema, Sampling=JaxSampling,
        Engine=JaxEngine, cfg=jax_cfg("gpt-test"), kw={}),
    "torch": SimpleNamespace(
        fleet=torch_fleet, schema=torch_schema, Sampling=SamplingParams,
        Engine=InferenceEngine, cfg=torch_cfg("gpt-test"),
        kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """{package: params}: one JAX tree and the port's model made from it."""
    tree = jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))
    return {"jax": tree,
            "torch": params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            tree),
                                     torch_cfg("gpt-test"), device="cpu")}


@pytest.fixture()
def fleets():
    """Every fleet a test builds; all shut down when it ends, so no engine
    thread outlives its test."""
    made = []
    yield made
    for f in made:
        f.shutdown()


def make_fleet(made, pkg, params, *, plan=None, serve_kw=None,
               warm=False, **fleet_kw):
    p = PKGS[pkg]
    fc = dict(replicas=2, affinity_prefix_tokens=0, restart_backoff_s=0.05,
              probe_interval_s=0.05)
    fc.update(fleet_kw)
    fleet = p.fleet.ServeFleet(
        p.cfg, p.schema.ServeConfig(**dict(SERVE, **(serve_kw or {}))),
        p.schema.FleetConfig(**fc), params=params[pkg],
        fault_plan=p.fleet.FaultPlan(**plan) if plan else None,
        supervise=False, seed=0, **p.kw)
    made.append(fleet)
    if warm:
        for r in fleet.replicas:
            r.engine.generate([[1, 2, 3]], p.Sampling(temperature=0.0,
                                                      max_tokens=4))
            r.engine.total_prefill_tokens = 0
            r.engine.total_unexpected_prefills = 0
    fleet.start()
    return fleet


def reference(pkg, params, prompts, sampling: dict, **serve_kw):
    """Tokens of one undisturbed engine."""
    p = PKGS[pkg]
    eng = p.Engine(p.cfg, p.schema.ServeConfig(**dict(SERVE, **serve_kw)),
                   params=params[pkg], seed=0, **p.kw)
    try:
        return [list(r.generated_tokens)
                for r in eng.generate(prompts, p.Sampling(**sampling))]
    finally:
        eng.release()


def submit(fleet, pkg, prompts, sampling: dict, stream=False):
    events, reqs = [], []
    for pr in prompts:
        ev = threading.Event()
        fn = fleet.submit_streaming if stream else fleet.submit
        reqs.append(fn(pr, PKGS[pkg].Sampling(**sampling),
                       on_complete=lambda _r, ev=ev: ev.set()))
        events.append(ev)
    return reqs, events


def wait_until(cond, what: str, fleet=None):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if fleet is not None:
            fleet.supervisor.poll_once()
        time.sleep(0.002)
        assert time.monotonic() < deadline, f"{what}: not within {WAIT_S} s"


def await_all(fleet, events):
    wait_until(lambda: all(e.is_set() for e in events), "fleet requests",
               fleet)


def ledger_balanced(st) -> bool:
    return (st["completed"] + st["failed"] + st["rejected"]
            == st["submitted"] and st["in_flight"] == 0)


def prefill_tokens(fleet) -> int:
    return sum(r.engine.total_prefill_tokens for r in fleet.replicas)
