"""The HA front arm of the JAX package's ``serve.fleet2+ha-front``
regime on the port: two spawned port workers (JAX's params from JAX's
export artifact), two spawned `llmctl-torch fleet front` processes over a
shared file state store, SSE clients (``FrontStreamClient``) pinned to
front 0, and front 0 SIGKILLed once every stream is live. Every client
reconnects to front 1 with ``Last-Event-ID`` and ends token-identical to
the JAX engine with zero gaps and zero duplicates; the survivor's folded
ledger balances, the dead front is fenced and one failover is counted.
"""

import sys
import threading
import time

import pytest

from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.front import (  # noqa: E501
    FleetFrontTier)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.state import (  # noqa: E501
    SharedFileStateStore)
from distributed_llm_training_and_inference_system_tpu_torch.serve.loadgen import (  # noqa: E501
    FrontStreamClient, run_stream_fronts)
from torch_fleet_harness import (  # noqa: F401  (fixtures)
    CHAOS, PORT_CLI, WAIT_S, get_json, jax_artifact, params, procs,
    reference, spawn_worker)

pytestmark = [pytest.mark.socket, pytest.mark.sse]

PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2], [6, 1, 8, 0],
           [35, 8, 9, 7, 9, 3]]
MAX_TOKENS = 48


def test_front_sigkill_mid_stream(params, procs, tmp_path):
    deadline = time.monotonic() + WAIT_S
    art = jax_artifact(params, tmp_path)
    ws = [spawn_worker(tmp_path, art, i, plan=dict(
        CHAOS, seed=31 + i, slow_replica=i, slow_ms=12.0)) for i in (0, 1)]
    procs += ws
    for w in ws:
        w.wait_ready(deadline)
    ref = reference("jax", params, PROMPTS, dict(temperature=0.0,
                                                 max_tokens=MAX_TOKENS))
    store_dir = tmp_path / "store"

    def front_cmd(index, front_id):
        return [sys.executable, "-m", PORT_CLI, "--device", "cpu", "fleet",
                "front", "--model", "gpt-test", "--front-id", front_id,
                "--host", "127.0.0.1", "--port", "0", "--replicas", "2",
                "--remote-replicas", "0,1",
                "--fleet-endpoint", f"0={ws[0].endpoint}",
                "--fleet-endpoint", f"1={ws[1].endpoint}",
                "--state-store-dir", str(store_dir),
                "--max-batch-size", "2", "--max-seq-len", "256",
                "--kv-block-size", "8", "--probe-interval", "0.05"]

    tier = FleetFrontTier(SharedFileStateStore(store_dir, front_id="tier"),
                          front_cmd, fronts=2, respawn=False,
                          ready_timeout_s=WAIT_S)
    try:
        fronts = [f"http://127.0.0.1:{p}" for p in tier.start()]
        for ep in fronts:
            assert get_json(f"{ep}/health")["status"] == "healthy"
        client = FrontStreamClient(fronts, max_attempts=40, backoff_s=0.05,
                                   read_timeout_s=60.0)
        held: dict = {}

        def load():
            held["res"] = run_stream_fronts(
                fronts, num_requests=len(PROMPTS), prompt_len=8,
                max_tokens=MAX_TOKENS, prompts=PROMPTS,
                concurrency=len(PROMPTS), client=client, pin_front=0)

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        # every stream live with tokens flowing, read through the
        # survivor's folded view of the shared store
        while True:
            try:
                st = get_json(f"{fronts[1]}/fleet/status").get("streams",
                                                                {})
                if st.get("active", 0) >= len(PROMPTS) \
                        and st.get("tokens", 0) >= 2 * len(PROMPTS):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the streams never went live"
            time.sleep(0.02)
        tier.kill(0)
        tier.poll()
        assert tier.total_front_failovers == 1
        loader.join(timeout=max(deadline - time.monotonic(), 1))
        assert not loader.is_alive(), "the stream clients hung"
        res = held["res"]
        assert res.failed == 0 and res.completed == len(PROMPTS)
        assert res.stream["gaps"] == 0 and res.stream["duplicates"] == 0
        assert res.stream["token_lists"] == ref
        assert res.stream["reconnects_per_front"][fronts[1]] >= 1
        snap = get_json(f"{fronts[1]}/fleet/status")
        rt = snap["router"]
        assert rt["failed"] == 0 and rt["in_flight"] == 0
        assert rt["completed"] == rt["submitted"] >= len(PROMPTS), rt
        assert snap["streams"]["identity_mismatches"] == 0
        assert snap["streams"]["front_resumes"] >= 1
        ft = snap["front_tier"]
        assert [f for f, e in ft["fronts"].items() if e.get("fenced")]
        assert ft["failovers"] >= 1
    finally:
        tier.stop()
