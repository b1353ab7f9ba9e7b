"""Quantized KV pages across the HTTP courier between two spawned port
workers (gpt-test, fp32 weights, CPU, JAX's params from JAX's export
artifact): a drain mid-decode under the seeded chunk chaos with the
``delta-zlib`` codec moves int8 and int4 pages worker to worker with zero
re-prefill, and the tokens equal the JAX engine's over the same page kind.
Prompts stay within the dense prefill and decode windows within a page
(T <= PS), where JAX's int4 scatter keeps both nibbles (ROADMAP queue 3
item 5)."""

import time

import pytest

from test_torch_fleet_procs import PROMPTS, _fleet, _run_batch
from torch_fleet_harness import (  # noqa: F401  (fixtures)
    CHAOS, WAIT_S, get_json, jax_artifact, params, procs, reference,
    spawn_worker)

pytestmark = pytest.mark.socket


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_pages_drain_under_delta_zlib(params, procs, tmp_path,
                                                kind):
    deadline = time.monotonic() + WAIT_S
    art = jax_artifact(params, tmp_path)
    extra = ["--kv-quantization", kind, "--courier-codec", "delta-zlib"]
    ws = [spawn_worker(tmp_path, art, i, extra=extra, plan=dict(
        CHAOS, seed=21 + i, slow_replica=i, slow_ms=8.0)) for i in (0, 1)]
    procs += ws
    for w in ws:
        w.wait_ready(deadline)
    sampling = dict(temperature=0.0, max_tokens=40)
    ref = reference("jax", params, PROMPTS, sampling, kv_quantization=kind)
    fleet = _fleet({0: ws[0].endpoint, 1: ws[1].endpoint},
                   courier_codec="delta-zlib")
    fleet.start()
    try:
        toks = _run_batch(fleet, PROMPTS, sampling, deadline,
                          hook=lambda: fleet.drain(0),
                          hook_ep=ws[0].endpoint)
        assert toks == ref, f"{kind} drain diverged from the JAX engine"
        sa, sb = (get_json(f"{w.endpoint}/worker/status") for w in ws)
        assert sa["total_prefill_tokens"] + sb["total_prefill_tokens"] \
            == sum(len(p) for p in PROMPTS), "the drain re-prefilled"
        c = sa["courier"]
        assert c["transfers"] >= 1 and c["aborts"] == 0, c
        # the pages crossed under delta-zlib (under codec none every
        # frame's wire bytes equal its raw bytes)
        assert c["bytes_wire"] != c["bytes_raw"], c
        st = fleet.router.stats()
        assert st["failed"] == 0 and st["completed"] == len(PROMPTS)
    finally:
        fleet.shutdown()
