"""``llmctl-torch fleet`` and the fleet options of ``serve start`` against
the JAX package's ``llmctl`` (CPU, gpt-test).

- Option parity: ``fleet`` and each of its subcommands have the JAX click
  command's options (names, defaults, choices), through
  tests/test_torch_cli.py's harness.
- ``serve start --replicas 2`` (the parsed line's ``build_server``)
  answers ``/v1/completions`` and ``/fleet/status``; ``fleet status
  --json`` prints the snapshot with JAX's keys, ``fleet status`` a table,
  and ``drain``, ``undrain``, ``role`` and ``migrate`` reach the front.
- ``fleet store``, ``fleet ship-weights``, the worker's store options and
  ``serve start``'s KV store and autoscaler options run: a spawned store
  answers ``/health`` and stops at SIGTERM, a checkpoint ships to an
  in-process store and a worker's parts boot it back, and ``serve start``
  builds a fleet with its store client or its autoscaler.
"""

import contextlib
import importlib
import io
import json
import urllib.request

import pytest

from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.cli.commands \
    import serve as tserve
from distributed_llm_training_and_inference_system_tpu_torch.metrics import (
    observability as tobs)
from test_torch_cli import (_argparse_options, _click_options, _compare,
                            _subparser)
from torch_fleet_harness import PKGS, SERVE, params  # noqa: F401

JAX_FLEET = "distributed_llm_training_and_inference_system_tpu.cli.commands.fleet"
SUBS = ["status", "drain", "undrain", "role", "migrate", "worker", "front",
        "store", "ship-weights"]


@pytest.fixture(autouse=True)
def _fresh_observability():
    tobs.reset_observability()
    yield
    tobs.reset_observability()


def test_fleet_options_equal_jax():
    app = importlib.import_module(JAX_FLEET).app
    assert sorted(app.commands) == sorted(SUBS)
    parser = tmain.command_module("fleet").build_parser("x")
    for sub in SUBS:
        _compare("fleet", sub, _click_options(app.commands[sub].params),
                 _argparse_options(_subparser(parser, sub)))


def _run(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(argv)
    return rc, buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _jax_status_keys(params) -> dict:
    p = PKGS["jax"]
    fleet = p.fleet.ServeFleet(p.cfg, p.schema.ServeConfig(**SERVE),
                               p.schema.FleetConfig(replicas=2),
                               params=params["jax"], supervise=False)
    try:
        return fleet.status()
    finally:
        fleet.shutdown()


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_serve_start_replicas_and_the_fleet_verbs(params):
    argv = ["--device", "cpu", "serve", "start", "--model", "gpt-test",
            "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "256",
            "--kv-block-size", "8", "--max-batch-size", "2",
            "--kv-hbm-gb", "0.01", "--replicas", "2",
            "--fleet-affinity-tokens", "0"]
    srv = tserve.build_server(tmain.parse(argv))
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        out = _post(f"{base}/v1/completions",
                    {"prompt": [5, 17, 99], "max_tokens": 4,
                     "temperature": 0.0})
        assert len(out["choices"][0]["token_ids"]) == 4
        assert out["metrics"]["replica"] in (0, 1)
        with urllib.request.urlopen(f"{base}/fleet/status") as r:
            assert r.status == 200 and len(json.loads(r.read())[
                "replicas"]) == 2
        rc, text = _run(["fleet", "status", "--url", base, "--json"])
        assert rc == 0
        snap = json.loads(text)
        assert _keys(snap) == _keys(_jax_status_keys(params))
        assert snap["router"]["completed"] == 1
        rc, table = _run(["fleet", "status", "--url", base])
        assert rc == 0 and "Fleet replicas" in table
        assert "router: 1/1 completed" in table
        assert _run(["fleet", "drain", "1", "--url", base]) == (
            0, "replica 1: drain requested\n")
        assert _run(["fleet", "undrain", "1", "--url", base]) == (
            0, "replica 1: back in rotation\n")
        assert _run(["fleet", "role", "0", "decode", "--url", base]) == (
            0, "replica 0: role set to decode\n")
        # migrating a request that is not resident answers 404
        assert tmain.main(["fleet", "migrate", "nope", "1", "--url",
                           base]) == 1
    finally:
        srv.stop()


STORE_CASES = {
    "store": ["fleet", "store", "--port", "0", "--dram-mb", "8"],
    "ship-weights": ["fleet", "ship-weights", "--model", "gpt-test",
                     "--param-seed", "0", "--name", "gpt-test"],
    "worker-store": ["fleet", "worker", "--model", "gpt-test",
                     "--store-endpoint"],
    "worker-stores": ["fleet", "worker", "--model", "gpt-test",
                      "--store-endpoints"],
    "worker-weights": ["fleet", "worker", "--model", "gpt-test",
                       "--weights-from-store", "--weights-name", "gpt-test",
                       "--store-endpoint"],
    "serve-autoscale": ["serve", "start", "--model", "gpt-test",
                        "--replicas", "2", "--fleet-autoscale",
                        "--fleet-autoscale-max-replicas", "2",
                        "--port", "0", "--kv-hbm-gb", "0.01"],
    "serve-store-endpoint": ["serve", "start", "--model", "gpt-test",
                             "--replicas", "2", "--port", "0",
                             "--kv-hbm-gb", "0.01",
                             "--fleet-kv-store-endpoint"],
}


@pytest.fixture()
def store_endpoint():
    """The port's StoreService on a stdlib HTTP thread."""
    from distributed_llm_training_and_inference_system_tpu_torch.config.schema import (  # noqa: E501
        FleetConfig)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_service import (  # noqa: E501
        StoreService)
    svc = StoreService(FleetConfig(kv_store=True, courier_chunk_bytes=4096))
    port = svc.serve_http("127.0.0.1", 0)
    yield svc, f"http://127.0.0.1:{port}"
    svc.stop()


def _spawned_store_answers_health() -> None:
    """``python -m ...cli --device cpu fleet store`` prints its ready line,
    answers ``/health`` and exits 0 at SIGTERM."""
    import sys
    import tempfile
    import time

    from torch_fleet_harness import PORT_CLI, Proc
    with tempfile.TemporaryDirectory() as tmp:
        p = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu"]
                 + STORE_CASES["store"], f"{tmp}/store.log",
                 "LLMCTL_STORE_READY")
        try:
            p.wait_ready(time.monotonic() + 60)
            with urllib.request.urlopen(f"{p.endpoint}/health",
                                        timeout=10) as r:
                assert r.status == 200
                assert json.loads(r.read())["status"] == "healthy"
        finally:
            assert p.stop() == 0


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_the_store_tier_exits_2_naming_9d(case, store_endpoint, capsys):
    """Each surface of the store tier (once refused, exiting 2) runs."""
    from distributed_llm_training_and_inference_system_tpu_torch.cli.commands import (  # noqa: E501
        fleet as tfleet)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        FleetAutoscaler, StoreClient)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.worker import (  # noqa: E501
        params_checksum)
    svc, ep = store_endpoint
    argv = ["--device", "cpu"] + STORE_CASES[case]
    if case == "store":
        _spawned_store_answers_health()
        return
    if case == "ship-weights":
        assert tmain.main(argv[:4] + ["--store-endpoint", ep]
                          + argv[4:]) == 0
        assert "weights 'gpt-test' registered on 1 member(s)" \
            in capsys.readouterr().out
        assert svc.weights.status("gpt-test")["complete"]
        return
    if case.startswith("worker"):
        if case == "worker-weights":
            assert tmain.main(["--device", "cpu", "fleet", "ship-weights",
                               "--store-endpoint", ep, "--model",
                               "gpt-test", "--param-seed", "0"]) == 0
        args = tmain.parse(argv + [ep])
        _m, _s, fleet_cfg, params = tfleet.worker_parts(
            args, torch_device("cpu"))
        assert fleet_cfg.kv_store_endpoint_list() == [ep]
        assert fleet_cfg.prefix_fetch
        if case == "worker-weights":
            want = tfleet.seeded_params(_m, 0, torch_device("cpu"),
                                        "float32")
            assert params_checksum(params) == params_checksum(want)
        else:
            assert params is None
        return
    if case == "serve-store-endpoint":
        argv = argv + [ep]
    srv = tserve.build_server(tmain.parse(argv))
    try:
        if case == "serve-autoscale":
            assert isinstance(srv.fleet.autoscaler, FleetAutoscaler)
            assert srv.fleet.autoscaler.ceiling() == 2
        else:
            assert isinstance(srv.fleet.kv_store, StoreClient)
            assert srv.fleet.kv_store.endpoints == [ep]
            assert srv.fleet.status()["kv_store"]["reachable"]
    finally:
        srv.fleet.shutdown()


def torch_device(name: str):
    import torch
    return torch.device(name)
