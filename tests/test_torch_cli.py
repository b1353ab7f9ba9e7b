"""The port's command line, ``llmctl-torch``, against the JAX package's
``llmctl`` (CPU, gpt-test, ``--device cpu``).

- Option parity: each ported command's argparse options (names, defaults,
  choices) equal the JAX click command's params, read by introspection,
  apart from the exceptions listed in ``EXCEPTIONS`` with what each waits
  for.
- ``init scaffold`` writes JAX's files byte for byte, apart from the
  program's name and the ``[hardware]`` section (the port's H100).
- Train, then evaluate and export: the JAX CLI trains 2 steps; from that
  checkpoint the JAX CLI and the port's ``train launch`` each go on to
  step 4, and the final losses agree within the trajectory tolerance of
  tests/test_torch_train.py (rtol 1e-5); the port writes its checkpoint
  and manifest and ``train status`` reads them. On the JAX checkpoint
  ``eval run --suite all`` gives JAX's results within 1e-5 relative, and
  ``export convert`` writes JAX's safetensors, npz and gguf bytes.
  ``export synth`` writes JAX's bytes, and the port serves the artifact.
- Launcher: ``LocalLauncher`` runs the port's train_entry in a child and
  adds no ``XLA_FLAGS``; ``run_with_restarts`` relaunches a failing child
  and counts it; multi-host and the cluster launchers raise (item 7).
- Serving and health: ``build_server`` answers ``/v1/completions``,
  ``/health``, ``/v1/stats`` and ``/metrics``; ``--replicas 2`` and the
  ``--fleet-*`` options build the fleet front, the KV store's included;
  ``health check --json`` gives JAX's keys;
  ``hw probe --emit`` writes a TOML that ``load_config_file`` reads.
- Entry points raise without a card unless given ``--device cpu``; the
  unported commands exit 2 naming their ROADMAP item, and ``fleet
  store`` (once among them) answers ``/health``; ``python -m
  ...cli --help`` runs with jax, the JAX package, click, rich, psutil,
  prometheus_client, aiohttp, opentelemetry and ml_dtypes blocked.
"""

import argparse
import contextlib
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tomllib
import urllib.request
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

from distributed_llm_training_and_inference_system_tpu.cli.main import (
    main as jax_cli)
from distributed_llm_training_and_inference_system_tpu.metrics import (
    health as jhealth)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.cli.commands \
    import serve as tserve
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config, loader as tloader)
from distributed_llm_training_and_inference_system_tpu_torch.config.schema \
    import HardwareConfig
from distributed_llm_training_and_inference_system_tpu_torch.metrics import (
    observability as tobs)
from distributed_llm_training_and_inference_system_tpu_torch.runtime import (
    launcher as tlaunch)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.utils.tomlio \
    import load_config_file

ROOT = Path(__file__).resolve().parents[1]
JAX_CMDS = "distributed_llm_training_and_inference_system_tpu.cli.commands"
PORT_CLI = "distributed_llm_training_and_inference_system_tpu_torch.cli"
BLOCKED = ["jax", "jaxlib", "distributed_llm_training_and_inference_system_tpu",
           "click", "rich", "psutil", "prometheus_client", "aiohttp",
           "opentelemetry", "ml_dtypes"]
TRAJECTORY_RTOL = 1e-5          # tests/test_torch_train.py's step rtol

# (command, subcommand, option) -> why the port differs
EXCEPTIONS = {
    (None, None, "--platform"): "JAX platform choice; the port has --device",
    (None, None, "--fake-devices"): "XLA host devices; multi-GPU is item 7",
    (None, None, "--device"): "the port's own: cuda (default) or cpu",
    ("init", "scaffold", "--hardware"):
        "default h100 (the JAX default v5e-8 is a TPU preset: item 7)",
}
PORTED = {"init": ("init", ["scaffold"]), "hw": ("hw", ["probe", "benchmark"]),
          "train": ("train", ["launch", "status"]),
          "eval": ("eval_cmd", ["run"]),
          "export": ("export", ["convert", "import-hf", "synth"]),
          "serve": ("serve", ["start"]), "health": ("health", ["check",
                                                               "drift"])}


def _click_options(params) -> dict:
    out = {}
    for p in params:
        if not p.opts or not p.opts[0].startswith("--"):
            continue
        if p.name == "version":
            continue
        names = frozenset(p.opts + p.secondary_opts)
        default = p.default
        if type(default).__name__ == "Sentinel":       # click's UNSET
            default = False if p.is_flag else None
        if p.multiple:
            default = list(default or [])
        out[names] = (default, tuple(getattr(p.type, "choices", None) or ())
                      or None)
    return out


def _argparse_options(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._VersionAction,
                          argparse._SubParsersAction)) \
                or not a.option_strings:
            continue
        default = list(a.default or []) if isinstance(
            a, argparse._AppendAction) else a.default
        out[frozenset(a.option_strings)] = (
            default, tuple(a.choices) if a.choices else None)
    return out


def _subparser(parser, name):
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            return a.choices[name]
    raise KeyError(name)


def _compare(cmd, sub, want: dict, got: dict):
    def excused(names):
        return any((cmd, sub, n) in EXCEPTIONS
                   or ("fleet" in n and (cmd, sub, "--fleet-*") in EXCEPTIONS)
                   for n in names)
    for names, spec in want.items():
        if excused(names):
            continue
        assert names in got, f"{cmd} {sub}: {sorted(names)} missing"
        assert got[names] == spec, f"{cmd} {sub} {sorted(names)}"
    extra = [n for n in got if n not in want and not excused(n)]
    assert not extra, f"{cmd} {sub}: port-only {extra}"


def test_global_options_equal_jax():
    _compare(None, None, _click_options(jax_cli.params),
             _argparse_options(tmain.root_parser()))


@pytest.mark.parametrize("cmd", sorted(PORTED))
def test_command_options_equal_jax(cmd):
    module, subs = PORTED[cmd]
    app = importlib.import_module(f"{JAX_CMDS}.{module}").app
    parser = tmain.command_module(cmd).build_parser("x")
    for sub in subs:
        want = _click_options(app.commands[sub].params)
        got = _argparse_options(_subparser(parser, sub))
        _compare(cmd, sub, want, got)
    # the excepted defaults really are the port's own
    sc = _argparse_options(_subparser(tmain.command_module("init")
                                      .build_parser("x"), "scaffold"))
    assert sc[frozenset({"--hardware"})][0] == "h100"


def _run(argv) -> tuple[int, str]:
    """The port's main() in this process: (exit code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(argv)
    return rc, buf.getvalue()


def _jax(argv) -> str:
    r = CliRunner().invoke(jax_cli, argv, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


@pytest.fixture(autouse=True)
def _fresh_observability():
    tobs.reset_observability()
    yield
    tobs.reset_observability()


def _strip_hardware(text: str) -> tuple[str, str]:
    head, sep, tail = text.partition("\n[hardware]\n")
    assert sep
    return head, tail


def test_init_scaffold_writes_jax_files(tmp_path):
    _jax(["init", "scaffold", "--model", "gpt-125m", "--hardware", "h100",
          "--out", str(tmp_path / "j")])
    rc, out = _run(["init", "scaffold", "--model", "gpt-125m",
                    "--out", str(tmp_path / "t")])
    assert rc == 0 and "Scaffolded gpt-125m" in out
    jfiles = sorted(p.relative_to(tmp_path / "j")
                    for p in (tmp_path / "j").rglob("*"))
    assert sorted(p.relative_to(tmp_path / "t")
                  for p in (tmp_path / "t").rglob("*")) == jfiles
    for rel in jfiles:
        j, t = tmp_path / "j" / rel, tmp_path / "t" / rel
        if j.is_dir():
            continue
        jt, tt = j.read_text(), t.read_text()
        if rel.suffix == ".toml" and "[hardware]" in jt:
            (jt, jhw), (tt, thw) = _strip_hardware(jt), _strip_hardware(tt)
            assert tomllib.loads(thw) == {"preset": "h100",
                                          **vars(HardwareConfig())}
        assert tt.replace("llmctl-torch", "llmctl") == jt, rel
    assert os.access(tmp_path / "t" / "train.sh", os.X_OK)
    cfg = tloader.load_run_config(
        tmp_path / "t" / "configs/presets/gpt-125m-h100.toml")
    assert cfg.hardware == HardwareConfig() and cfg.model.name == "gpt-125m"
    assert _run(["init", "scaffold", "--hardware", "v5e-8", "--out",
                 str(tmp_path / "x")])[0] == 2


# -- train, then evaluate and export ---------------------------------------

SETS = ["--set", "data.max_length=32", "--set", "parallel.global_batch_size=4",
        "--set", "training.log_interval=1",
        "--set", "checkpoint.async_save=false", "--set", "optimizer.lr=0.01"]
TASKS = [
    {"type": "multiple_choice", "context": [1, 2, 3],
     "choices": [[4], [5, 6], [7, 8, 9]], "answer": 1},
    {"type": "multiple_choice", "context": [40, 41, 42, 43, 44],
     "choices": [[3, 3], [200]], "answer": 0},
    {"type": "greedy_match", "context": [9, 9, 9, 9], "target": [1, 2]},
    {"type": "greedy_match", "context": [100, 7, 50], "target": [5, 5, 5]},
]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI's 2-step checkpoint, and its continuation to step 4 on
    a copy. The JAX trainer's process-wide observability manager (no
    exporter) is stopped and forgotten afterwards."""
    from distributed_llm_training_and_inference_system_tpu.metrics import (
        observability as jobs)
    d = tmp_path_factory.mktemp("jaxrun")
    try:
        _jax(["train", "launch", "--in-process", "--model", "gpt-test",
              "--max-steps", "2", "--set", f"checkpoint.path={d / 'a'}"]
             + SETS)
        shutil.copytree(d / "a", d / "b")
        _jax(["train", "launch", "--in-process", "--model", "gpt-test",
              "--max-steps", "4", "--set", f"checkpoint.path={d / 'b'}"]
             + SETS)
    finally:
        if jobs._manager is not None:
            jobs._manager.stop()
            jobs._manager = None
    return d


def _loose_equal(got, want, rtol=1e-5, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _loose_equal(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _loose_equal(a, b, rtol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol), path
    else:
        assert got == want, path


def test_train_launch_status_and_trajectory(jax_run, tmp_path):
    shutil.copytree(jax_run / "a", tmp_path / "c")
    rc, _ = _run(["--device", "cpu", "train", "launch", "--in-process",
                  "--model", "gpt-test", "--max-steps", "4",
                  "--set", f"checkpoint.path={tmp_path / 'c'}"] + SETS)
    assert rc == 0
    step4 = tmp_path / "c" / "step_4"
    assert (step4 / "state.pt").exists() and (step4 / "COMMIT").exists()
    manifest = json.loads((tmp_path / "c" / "run_manifest.json").read_text())
    want = json.loads((jax_run / "b" / "run_manifest.json").read_text())
    assert manifest["start_step"] == 2 and manifest["end_step"] == 4
    assert manifest["final_metrics"]["loss"] == pytest.approx(
        want["final_metrics"]["loss"], rel=TRAJECTORY_RTOL)
    cfg = tmp_path / "run.toml"
    cfg.write_text(f'[checkpoint]\npath = "{tmp_path / "c"}"\n'
                   f"[training]\nmax_steps = 4\n")
    rc, out = _run(["train", "status", "--config", str(cfg)])
    assert rc == 0 and "checkpoints at steps: [2, 4] (latest 4 of max 4)" \
        in out


def test_eval_run_all_equals_jax(jax_run, tmp_path):
    tasks = tmp_path / "tasks.jsonl"
    tasks.write_text("\n".join(json.dumps(t) for t in TASKS))
    common = ["eval", "run", "--ckpt", str(jax_run / "a"), "--model",
              "gpt-test", "--suite", "all", "--tasks", str(tasks),
              "--batches", "2", "--batch-size", "2", "--seq-len", "64"]
    _jax(common + ["--out", str(tmp_path / "j.json")])
    rc, out = _run(["--device", "cpu"] + common
                   + ["--out", str(tmp_path / "t.json")])
    assert rc == 0 and "loaded checkpoint step 2" in out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    _loose_equal(got, want)
    assert got["tasks"][0]["multiple_choice"]["examples"] == 2


@pytest.mark.parametrize("fmt", ["safetensors", "npz", "gguf"])
def test_export_convert_writes_jax_bytes(jax_run, tmp_path, fmt):
    ext = {"safetensors": "safetensors", "npz": "npz", "gguf": "gguf"}[fmt]
    args = ["export", "convert", "--ckpt", str(jax_run / "a"),
            "--format", fmt]
    _jax(args + ["--out", str(tmp_path / f"j.{ext}")])
    rc, out = _run(["--device", "cpu"] + args
                   + ["--out", str(tmp_path / f"t.{ext}")])
    assert rc == 0 and f"exported {fmt} artifact" in out
    assert (tmp_path / f"t.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()


def test_export_convert_of_a_port_checkpoint_serves(jax_run, tmp_path):
    """The port's own checkpoint (step 4 above) through convert and into
    the engine: the artifact's weights are the checkpoint's."""
    shutil.copytree(jax_run / "a", tmp_path / "c")
    assert _run(["--device", "cpu", "train", "launch", "--in-process",
                 "--model", "gpt-test", "--max-steps", "3",
                 "--set", f"checkpoint.path={tmp_path / 'c'}"] + SETS)[0] == 0
    art = tmp_path / "c3.safetensors"
    assert _run(["--device", "cpu", "export", "convert", "--ckpt",
                 str(tmp_path / "c"), "--out", str(art)])[0] == 0
    cfg = get_model_config("gpt-test")
    serve = dict(model="gpt-test", max_batch_size=2, max_seq_len=64,
                 prefill_chunk=32, kv_block_size=8, dtype="float32")
    a = InferenceEngine(cfg, ServeConfig(**serve, artifact=str(art)),
                        device="cpu")
    b = InferenceEngine(cfg, ServeConfig(**serve, artifact=str(tmp_path
                                                                / "c")),
                        device="cpu")
    for (n, p), (_, q) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_export_synth_writes_jax_bytes_and_serves(tmp_path, quant):
    args = ["export", "synth", "--model", "gpt-test", "--quant", quant,
            "--seed", "3"]
    _jax(args + ["--out", str(tmp_path / "j.safetensors")])
    rc, out = _run(args + ["--out", str(tmp_path / "t.safetensors")])
    assert rc == 0 and "synthesized gpt-test artifact" in out
    assert (tmp_path / "t.safetensors").read_bytes() == \
        (tmp_path / "j.safetensors").read_bytes()
    cfg = get_model_config("gpt-test")
    eng = InferenceEngine(cfg, ServeConfig(
        model="gpt-test", max_batch_size=2, max_seq_len=64, prefill_chunk=32,
        kv_block_size=8, dtype="float32",
        artifact=str(tmp_path / "t.safetensors")), device="cpu")
    assert (eng.quantization or "none") == quant
    [req] = eng.generate([[3, 1, 4, 1, 5]],
                         SamplingParams(temperature=0.0, max_tokens=5))
    assert len(req.generated_tokens) == 5


def test_export_synth_int4_refuses_what_jax_refuses(tmp_path, capsys):
    """gpt-test's 64-wide inputs are not a multiple of int4's group of
    128: both commands refuse with the same message."""
    args = ["export", "synth", "--model", "gpt-test", "--quant", "int4",
            "--out", str(tmp_path / "x.safetensors")]
    r = CliRunner().invoke(jax_cli, args)
    assert r.exit_code == 1
    assert tmain.main(args) == 1
    assert capsys.readouterr().err.strip() == r.output.strip()


# -- launcher ---------------------------------------------------------------

def test_local_launcher_runs_the_port_entry(tmp_path, capsys):
    cfg = tlaunch.LaunchConfig(
        seed=7, extra_args=[
            "--device", "cpu", "--model", "gpt-test", "--max-steps", "2",
            "--set", f"checkpoint.path={tmp_path / 'ck'}"] + SETS)
    env = tlaunch._train_env(cfg)
    assert env.get("XLA_FLAGS") == os.environ.get("XLA_FLAGS")
    assert env["LLMCTL_TRAINING__SEED"] == "7"
    cmd = tlaunch._train_cmd(cfg)
    assert cmd[1:3] == ["-m", tlaunch.ENTRY] and "--device" in cmd
    orch = tlaunch.ProcessOrchestrator(cfg)
    assert orch.run_with_restarts(max_restarts=1, backoff_seconds=0) == 0
    assert orch.restarts == 0 and orch.status()["returncode"] == 0
    assert (tmp_path / "ck" / "step_2" / "COMMIT").exists()
    manifest = json.loads((tmp_path / "ck" / "run_manifest.json").read_text())
    assert manifest["seed"] == 7
    assert "finished" in capsys.readouterr().out
    det = tlaunch._train_env(tlaunch.LaunchConfig(deterministic=True))
    assert det["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert det["LLMCTL_TRAINING__DETERMINISTIC"] == "true"


def test_run_with_restarts_relaunches_a_failing_child():
    cfg = tlaunch.LaunchConfig(extra_args=[
        "--device", "cpu", "--model", "gpt-test",
        "--set", "training.attn_impl=bogus"])
    orch = tlaunch.ProcessOrchestrator(cfg)
    rc = orch.run_with_restarts(max_restarts=2, backoff_seconds=0,
                                stream_output=False)
    assert rc != 0 and orch.restarts == 2


@pytest.mark.parametrize("kw", [dict(num_hosts=2), dict(launcher="slurm"),
                                dict(launcher="mpi"), dict(launcher="k8s"),
                                dict(launcher="gke")])
def test_multi_host_launchers_raise_item_7(kw):
    with pytest.raises(NotImplementedError, match="item 7"):
        tlaunch.ProcessOrchestrator(tlaunch.LaunchConfig(**kw))


@pytest.mark.parametrize("argv", [
    ["--nodes", "2", "train", "launch"],
    ["--launcher", "slurm", "train", "launch"],
    ["--chips-per-node", "4", "train", "launch"],
    ["train", "launch", "--nodes", "2"],
])
def test_multi_host_options_exit_naming_item_7(argv, capsys):
    assert tmain.main(argv) == 2
    assert "item 7" in capsys.readouterr().err


# -- serving and health -------------------------------------------------------

SERVE_ARGS = ["--device", "cpu", "serve", "start", "--model", "gpt-test",
              "--host", "127.0.0.1", "--port", "0", "--prometheus-port", "0",
              "--max-seq-len", "128", "--kv-block-size", "8",
              "--kv-hbm-gb", "0.01", "--max-batch-size", "2"]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def test_build_server_answers_every_route():
    args = tmain.parse(SERVE_ARGS)
    srv = tserve.build_server(args)
    assert srv.serve_cfg.dtype == "float32"       # the CPU default
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for i in range(3):
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps({
                    "prompt": [5, 6, 7 + i], "max_tokens": 3,
                    "temperature": 0.0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.loads(r.read())
            assert len(body["choices"][0]["token_ids"]) == 3
        status, health = _get(base + "/health")
        assert status == 200 and json.loads(health)["status"] == "healthy"
        status, stats = _get(base + "/v1/stats")
        assert status == 200 and json.loads(stats)["device"] == "cpu"
        status, metrics = _get(base + "/metrics")
        assert status == 200
        assert b"llmctl_inference_requests_total 3.0" in metrics
        _, scraped = _get(f"http://127.0.0.1:{srv.metrics.port}/metrics")
        assert b"llmctl_inference_requests_total 3.0" in scraped
    finally:
        srv.stop()


@pytest.mark.parametrize("extra,item", [
    (["--replicas", "2"], "served"),
    (["--replicas", "2", "--fleet-kv-store"], "served"),
    (["--replicas", "2", "--fleet-max-pending", "64"], "served"),
    (["--replicas", "2", "--tensor-parallel", "2"], "item 7"),
], ids=["extra0-item 9", "extra1-item 9", "extra2-item 9", "extra3-item 7"])
def test_serve_refuses_what_waits_for_a_roadmap_item(extra, item):
    """``--replicas > 1`` and the fleet options build the fleet front, the
    fleet KV store's included; replicas with tensor parallelism wait for
    item 7 (one tensor-parallel engine serves:
    tests/test_torch_tp_serve.py)."""
    if item != "served":
        with pytest.raises(NotImplementedError, match=item):
            tserve.build_server(tmain.parse(SERVE_ARGS + extra))
        return
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.http import (  # noqa: E501
        FleetServer)
    srv = tserve.build_server(tmain.parse(SERVE_ARGS + extra))
    try:
        assert isinstance(srv, FleetServer)
        assert len(srv.fleet.replicas) == 2
        assert srv.fleet.fleet_cfg.max_pending == (
            64 if "--fleet-max-pending" in extra else 512)
        assert (srv.fleet.kv_store is not None) == (
            "--fleet-kv-store" in extra)
    finally:
        srv.fleet.shutdown()


def test_health_check_json_has_jax_keys():
    rc, out = _run(["--device", "cpu", "health", "check", "--json"])
    assert rc == 0
    report = json.loads(out)
    want = jhealth.HealthReport(jhealth.HealthStatus.HEALTHY, [
        jhealth.HealthCheck("x", jhealth.HealthStatus.HEALTHY)]).to_dict()
    assert set(report) == set(want)
    assert all(set(c) == set(want["checks"][0]) for c in report["checks"])
    assert {"cpu", "memory", "disk"} <= {c["name"] for c in report["checks"]}


def test_health_drift(tmp_path):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"cpu_percent": 10.0, "mem": 1.0}))
    cur = tmp_path / "cur.json"
    cur.write_text(json.dumps({"cpu_percent": 10.5, "mem": 2.0}))
    rc, out = _run(["health", "drift", "--baseline", str(base), "--current",
                    str(cur)])
    assert rc == 1 and "drift detected in: mem" in out
    rc, _ = _run(["health", "drift", "--baseline", str(base), "--current",
                  str(cur), "--tolerance", "200"])
    assert rc == 0


def test_hw_probe_emit_and_benchmark(tmp_path):
    path = tmp_path / "hw" / "local.toml"
    rc, out = _run(["--device", "cpu", "hw", "probe", "--emit", str(path)])
    assert rc == 0 and "Hardware Profile" in out
    profile = load_config_file(path)
    assert profile["chips"]["platform"] == "cpu"
    assert HardwareConfig.from_dict(profile["hardware"]).platform == "cpu"
    assert profile["cpu"]["cores_logical"] == os.cpu_count()
    rc, out = _run(["--device", "cpu", "hw", "benchmark", "--matmul-size",
                    "64", "--mem-size-mb", "1"])
    assert rc == 0 and "host clock" in out and "TFLOP/s" in out


@pytest.mark.parametrize("argv", [
    ["serve", "start", "--model", "gpt-test"],
    ["hw", "probe"],
    ["health", "check"],
    ["eval", "run", "--model", "gpt-test"],
    ["train", "launch", "--in-process", "--model", "gpt-test"],
])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with contextlib.redirect_stdout(io.StringIO()):
            tmain.main(argv)


# `fleet store`, `admin lint`, `plan`, `bench comms` and `tune comms` were
# refused until their slices were ported: each now runs from the command
# line

def test_fleet_store_serves_health_and_stops_at_sigterm(tmp_path):
    # `python -m ...cli --device cpu fleet store` answers /health and
    # stops at SIGTERM with exit code 0
    import sys
    import time

    from torch_fleet_harness import Proc
    p = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu", "fleet",
              "store", "--port", "0"], tmp_path / "store.log",
             "LLMCTL_STORE_READY")
    try:
        p.wait_ready(time.monotonic() + 60)
        status, body = _get(f"{p.endpoint}/health")
        assert status == 200 and json.loads(body)["epoch"] == 0
    finally:
        assert p.stop() == 0


def test_admin_lint_exits_0_on_the_clean_tree(capsys):
    assert tmain.main(["admin", "lint"]) == 0
    assert "0 unsuppressed" in capsys.readouterr().out


def test_plan_compute_prints_the_plans(capsys):
    assert tmain.main(["--device", "cpu", "plan", "compute", "--model",
                       "gpt-test", "--hardware", "cpu-8"]) == 0
    assert "Parallelism plans: gpt-test on cpu-fakex8" in \
        capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["bench", "tune"])
def test_comms_commands_on_one_rank_ask_for_ranks(cmd, capsys):
    # on one CPU rank they ask for the ranks a collective needs
    # (tests/test_torch_comms_bench.py runs them on two)
    assert tmain.main(["--device", "cpu", cmd, "comms"]) == 1
    assert "need >=2 ranks" in capsys.readouterr().err


def _blocked(argv: list[str]) -> subprocess.CompletedProcess:
    code = ("import runpy, sys\n"
            f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
            f"sys.argv = ['llmctl-torch'] + {argv!r}\n"
            f"runpy.run_module({PORT_CLI!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_real_entry_point_runs_with_the_missing_packages_blocked():
    res = _blocked(["--help"])
    assert res.returncode == 0, res.stderr
    for cmd in tmain.COMMANDS:
        assert f"  {cmd} " in res.stdout
    res = _blocked(["--device", "cpu", "health", "check", "--json"])
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["checks"]
    res = _blocked(["--version"])
    assert res.returncode == 0 and "llmctl-torch" in res.stdout


TOML_CASES = [
    {"a": 1, "b": 2.5, "c": "x\"y", "d": True, "e": [1, 2], "f": {"g": "h"}},
    {"model": {"name": "gpt-test", "rope": {"base": 10000.0}},
     "runs": [{"x": 1}, {"x": 2, "y": {"z": [0.5]}}], "top": "t"},
    {"key with space": {"inline": {"p": 1, "q": "r"}}, "empty": []},
]


@pytest.mark.parametrize("data", TOML_CASES, ids=["scalars", "nested",
                                                  "quoted"])
def test_dump_toml_writes_jax_text(tmp_path, data):
    from distributed_llm_training_and_inference_system_tpu.utils import (
        tomlio as jtoml)
    from distributed_llm_training_and_inference_system_tpu_torch.utils import (
        tomlio as ttoml)
    text = ttoml.dump_toml(data, tmp_path / "x" / "t.toml")
    assert text == jtoml.dump_toml(data)
    assert ttoml.load_config_file(tmp_path / "x" / "t.toml") == \
        ttoml.loads_toml(text) == jtoml.loads_toml(text)
    (tmp_path / "t.json").write_text(json.dumps(data))
    assert ttoml.load_config_file(tmp_path / "t.json") == data
    with pytest.raises(ValueError, match="Unsupported"):
        ttoml.load_config_file(tmp_path / "t.yaml")


def test_time_fn_on_the_cpu():
    from distributed_llm_training_and_inference_system_tpu_torch.utils.timing \
        import time_fn
    calls = []
    s = time_fn(lambda x: calls.append(x), 7, warmup=2, iters=9, windows=3,
                device="cpu")
    assert len(calls) == 2 + 9 and 0.0 <= s < 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            time_fn(lambda: None)
