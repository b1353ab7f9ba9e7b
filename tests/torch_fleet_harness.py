"""What the fleet tests of the port share (tests/test_torch_fleet*.py):
both packages' ``ServeFleet`` built alike on one params tree (gpt-test,
fp32, CPU), driven to the end with every wait bounded, and shut down by
the ``fleets`` fixture of each test file."""

import threading
import time
from types import SimpleNamespace
from typing import Optional

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


def on_the_port(name: str, leave_out=(), swap: bool = True) -> dict:
    """The namespace of the JAX package's test file ``name`` run with the
    package's name swapped for the port's, without the test functions
    named in ``leave_out`` (their source lines are cut before the swap).
    ``swap=False`` keeps the JAX package's names: the namespace of the file
    as it is, for a test that then hands its JAX clients a port service."""
    import ast
    import re
    from pathlib import Path
    path = Path(__file__).resolve().parent / name
    lines = path.read_text().splitlines(keepends=True)
    cut = set()
    for node in ast.walk(ast.parse("".join(lines))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in leave_out:
            first = min([node.lineno] + [d.lineno
                                         for d in node.decorator_list])
            cut.update(range(first - 1, node.end_lineno))
    missing = set(leave_out) - {n.name for n in ast.walk(ast.parse(
        "".join(lines))) if isinstance(n, ast.FunctionDef)}
    assert not missing, f"{name} has no {sorted(missing)}"
    jax_pkg = "distributed_llm_training_and_inference_system_tpu"
    src = "".join(line for i, line in enumerate(lines) if i not in cut)
    if swap:
        src = src.replace(f"{jax_pkg}.", f"{jax_pkg}_torch.")
        assert not re.search(r"^\s*(import|from) jax", src, re.M)
    ns: dict = {"__name__": f"{path.stem}_on_the_port" if swap
                else f"{path.stem}_as_it_is"}
    exec(compile(src, str(path), "exec"), ns)
    return ns


# -- spawned port workers and fronts ------------------------------------------

PORT_CLI = "distributed_llm_training_and_inference_system_tpu_torch.cli"
WORKER_SERVE = ["--max-batch-size", "2", "--max-seq-len", "256",
                "--prefill-chunk", "32", "--kv-block-size", "8",
                "--dtype", "float32"]
# the JAX regime's chunk chaos at each worker's sender
CHAOS = {"chunk_drop_rate": 0.2, "chunk_corrupt_rate": 0.15,
         "chunk_duplicate_rate": 0.1}
# small chunks and a patient courier, so chaos lands and is absorbed
COURIER = ["--courier-chunk-bytes", "1024", "--courier-retries", "12",
           "--courier-deadline-ms", "50", "--courier-backoff-ms", "0.2",
           "--courier-backoff-max-ms", "2"]


def jax_artifact(params, tmp_path) -> str:
    """JAX's params exported by the JAX package's io/export.py."""
    from distributed_llm_training_and_inference_system_tpu.io import (
        export as jexp)
    path = tmp_path / "gpt-test.safetensors"
    jexp.export_params(jax.tree_util.tree_map(np.asarray, params["jax"]),
                       path)
    return str(path)


class Proc:
    """One spawned CLI process: its Popen, bound port, stderr file."""

    def __init__(self, argv, log_path, prefix: str):
        import os
        import subprocess
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=self._log, env=env,
            text=True, start_new_session=True)
        self.prefix = prefix
        self.port = None
        self.ready_line = None

    def wait_ready(self, deadline: float) -> int:
        import select
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, (
                f"process died during startup (rc={self.proc.returncode}):"
                f" {open(self.log_path).read()[-2000:]}")
            rd, _, _ = select.select([self.proc.stdout], [], [], 0.5)
            if rd:
                line = self.proc.stdout.readline()
                if line.startswith(self.prefix):
                    self.ready_line = line.strip()
                    self.port = int(line.split("port=")[1].split()[0])
                    return self.port
        raise AssertionError(f"{self.prefix} never printed")

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> int:
        """SIGTERM (then SIGKILL past a bound); the exit code."""
        import subprocess
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def stderr_line(self, prefix: str):
        for line in open(self.log_path):
            if line.startswith(prefix):
                return line[len(prefix):].strip()
        return None


def spawn_worker(tmp_path, artifact: str, rid: int, role: str = "mixed",
                 plan: Optional[dict] = None, extra=()) -> Proc:
    import json
    import sys
    argv = [sys.executable, "-m", PORT_CLI, "--device", "cpu", "fleet",
            "worker", "--model", "gpt-test", "--artifact", artifact,
            "--replica-id", str(rid), "--role", role, "--host", "127.0.0.1",
            "--port", "0", "--seed", str(1000 * rid),
            "--restart-backoff", "0.05", *WORKER_SERVE, *COURIER, *extra]
    if plan:
        argv += ["--fault-plan", json.dumps(plan)]
    return Proc(argv, tmp_path / f"worker{rid}-{time.monotonic_ns()}.log",
                "LLMCTL_WORKER_READY")


@pytest.fixture()
def procs():
    """Every process a test spawns; all stopped when it ends."""
    made = []
    yield made
    for p in made:
        try:
            p.stop()
        except Exception:
            p.proc.kill()


def remote_fleet_cfg(endpoints: dict, **kw):
    fc = dict(replicas=len(endpoints),
              remote_replicas=",".join(str(i) for i in sorted(endpoints)),
              fleet_endpoints=dict(endpoints), affinity_prefix_tokens=0,
              probe_interval_s=0.05, restart_backoff_s=0.05,
              probe_failures=2, migrate_on_drain=True, remote_timeout_s=5.0,
              courier_chunk_bytes=1024, courier_max_retries=12,
              courier_retry_backoff_ms=0.2,
              courier_retry_backoff_max_ms=2.0,
              courier_chunk_deadline_ms=50.0)
    fc.update(kw)
    return torch_schema.FleetConfig(**fc)


def get_json(url: str) -> dict:
    import json
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read().decode())
