"""The port's operator commands (``bench``, ``trace``, ``replay``, ``tune``,
``admin``; ``plugins/autotuning.py``) against the JAX package's ``llmctl``,
on the CPU at gpt-test size (``--device cpu``).

- Option parity: each command's argparse options equal the JAX click
  command's (names, defaults, choices), through tests/test_torch_cli.py's
  harness; ``--chip-lock`` defaults under the temporary directory.
- ``replay run`` gives MATCH on a port training run, exits 1 on a
  manifest whose loss was altered, and replays part of a run.
- ``admin inspect`` prints JAX's lines (paths, shapes, dtypes, bytes) for a
  JAX checkpoint, ``admin index`` JAX's JSON and lines, ``admin gc`` JAX's
  lines; ``inspect`` also reads a port checkpoint.
- ``tune kernels`` writes a cache that JAX's ``AutoTuner.load_results``
  reads as a cache hit, and the port reads JAX's; a matmul trial's product
  runs under its settings and restores the process-wide ones, also when
  it raises; flash is not a valid trial on the CPU.
- ``bench kernels``, ``e2e`` (train, serve, serve-load), ``kv-decode`` and
  ``dataloader`` print JAX's JSON keys; ``battery`` runs, resumes, parks
  and dry-runs as JAX's.
- ``training.profile=True`` writes a Chrome trace on the CPU; ``trace
  capture`` writes one and ``trace summarize`` lists it.
- ``bench kv-decode``'s courier wire-codec section gives JAX's bytes.
- ``bench comms`` and ``tune comms|sp|full`` exit 2 naming their ROADMAP
  item, ``admin lint`` exits 0 on the port's tree; the fleet options of ``bench e2e`` run a
  two-replica fleet, the returning-conversation A/B and a scenario cell
  included.
"""

import contextlib
import importlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from distributed_llm_training_and_inference_system_tpu.cli.main import (
    main as jax_cli)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.metrics import (
    observability as tobs)
from distributed_llm_training_and_inference_system_tpu_torch.plugins import (
    autotuning as tat)
from test_torch_cli import (SETS, _argparse_options, _click_options,
                            _compare, _subparser)

JAX_CMDS = "distributed_llm_training_and_inference_system_tpu.cli.commands"
TOOLS = {"bench": ["kernels", "e2e", "kv-decode", "comms", "dataloader",
                   "battery"],
         "trace": ["capture", "summarize"], "replay": ["run"],
         "tune": ["kernels", "comms", "sp", "full"],
         "admin": ["lint", "gc", "inspect", "index"]}
# (command, subcommand, option) -> why the port's default differs
DEFAULTS_DIFFER = {("bench", "battery", "--chip-lock"):
                   "under the temporary directory ($TMPDIR), not /tmp"}


def _run(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(argv)
    return rc, buf.getvalue()


def _jax(argv, code: int = 0) -> str:
    r = CliRunner().invoke(jax_cli, argv, catch_exceptions=False)
    assert r.exit_code == code, r.output
    return r.output


def _json(text: str):
    return json.loads(text[text.index("{"):])


@pytest.fixture(autouse=True)
def _fresh_observability():
    tobs.reset_observability()
    yield
    tobs.reset_observability()


@pytest.mark.parametrize("cmd", sorted(TOOLS))
def test_tool_options_equal_jax(cmd):
    app = importlib.import_module(f"{JAX_CMDS}.{cmd}").app
    parser = tmain.command_module(cmd).build_parser("x")
    assert sorted(app.commands) == sorted(TOOLS[cmd])
    for sub in TOOLS[cmd]:
        want = _click_options(app.commands[sub].params)
        got = _argparse_options(_subparser(parser, sub))
        for (c, s, opt) in DEFAULTS_DIFFER:
            if (c, s) == (cmd, sub):
                key = next(k for k in want if opt in k)
                want[key] = got[key]
        _compare(cmd, sub, want, got)


def test_chip_lock_defaults_under_the_temporary_directory():
    import tempfile
    parser = tmain.command_module("bench").build_parser("x")
    got = _argparse_options(_subparser(parser, "battery"))
    default = got[frozenset({"--chip-lock"})][0]
    assert default == str(Path(tempfile.gettempdir()) / "llmctl_chip.lock")


# -- replay and trace ---------------------------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A 3-step gpt-test run of the port's `train launch`."""
    d = tmp_path_factory.mktemp("portrun") / "ck"
    tobs.reset_observability()
    rc, _ = _run(["--device", "cpu", "train", "launch", "--in-process",
                  "--model", "gpt-test", "--max-steps", "3",
                  "--set", f"checkpoint.path={d}",
                  "--set", "checkpoint.interval_steps=1"] + SETS)
    tobs.reset_observability()
    assert rc == 0
    return d


def test_replay_matches_a_port_run(port_run):
    rc, out = _run(["--device", "cpu", "replay", "run", str(port_run)])
    assert rc == 0 and "-> MATCH" in out, out
    assert "rel diff 0.00e+00" in out, out           # bitwise on the CPU


def test_replay_exits_1_on_an_altered_loss(port_run, tmp_path):
    m = json.loads((port_run / "run_manifest.json").read_text())
    m["final_metrics"]["loss"] *= 1.001
    bad = tmp_path / "run_manifest.json"
    bad.write_text(json.dumps(m))
    rc, out = _run(["--device", "cpu", "replay", "run", str(bad)])
    assert rc == 1 and "MISMATCH" in out
    rc, out = _run(["--device", "cpu", "replay", "run", str(bad),
                    "--steps", "1"])
    assert rc == 0 and "partial replay done" in out
    rc, _ = _run(["replay", "run", str(tmp_path / "none.json")])
    assert rc == 1


def test_engine_profile_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import get_model_config, loader
    from distributed_llm_training_and_inference_system_tpu_torch.runtime \
        .engine import TrainingEngine
    cfg = loader.load_run_config(None, cli_overrides={
        "data": {"max_length": 32},
        "parallel": {"micro_batch_size": 2, "global_batch_size": 2},
        "training": {"profile": True, "profile_dir": str(tmp_path / "tr"),
                     "max_steps": 2},
        "checkpoint": {"path": str(tmp_path / "ck")}})
    cfg.model = get_model_config("gpt-test")
    eng = TrainingEngine(cfg, device="cpu")
    try:
        eng.train(resume=False)
    finally:
        eng.close()
    files = list((tmp_path / "tr").iterdir())
    assert files == [eng.profile_trace]
    assert files[0].name.endswith(".json")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_trace_capture_and_summarize(tmp_path):
    out = tmp_path / "traces"
    cfg = tmp_path / "run.toml"
    cfg.write_text(f'[checkpoint]\npath = "{tmp_path / "ck"}"\n')
    rc, text = _run(["--device", "cpu", "trace", "capture", "--config",
                     str(cfg), "--model", "gpt-test", "--steps", "2",
                     "--out", str(out)])
    assert rc == 0 and f"captured 2 steps" in text and "Perfetto" in text
    assert (tmp_path / "ck" / "run_manifest.json").is_file()
    # a replay of the profiled run re-profiles nothing into its directory
    [trace] = list(out.iterdir())
    rc, text = _run(["--device", "cpu", "replay", "run",
                     str(tmp_path / "ck")])
    assert rc == 0 and "-> MATCH" in text, text
    assert list(out.iterdir()) == [trace]
    rc, text = _run(["trace", "summarize", str(out)])
    assert rc == 0 and "1 files" in text and "Chrome traces present" in text
    (tmp_path / "empty").mkdir()
    rc, _ = _run(["trace", "summarize", str(tmp_path / "empty")])
    assert rc == 1


# -- admin ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX CLI's gpt-test checkpoints at steps 1 and 2."""
    from distributed_llm_training_and_inference_system_tpu.metrics import (
        observability as jobs)
    d = tmp_path_factory.mktemp("jaxck") / "ck"
    try:
        _jax(["train", "launch", "--in-process", "--model", "gpt-test",
              "--max-steps", "2", "--set", f"checkpoint.path={d}",
              "--set", "checkpoint.interval_steps=1"] + SETS)
    finally:
        if jobs._manager is not None:
            jobs._manager.stop()
            jobs._manager = None
    return d


@pytest.mark.parametrize("extra", [[], ["--limit", "5"], ["--step", "1"]])
def test_admin_inspect_prints_jax_lines(jax_ckpt, extra):
    want = _jax(["admin", "inspect", "--ckpt", str(jax_ckpt)] + extra)
    rc, got = _run(["admin", "inspect", "--ckpt", str(jax_ckpt)] + extra)
    assert rc == 0
    assert got == want


def test_admin_inspect_reads_a_port_checkpoint(port_run):
    rc, out = _run(["admin", "inspect", "--ckpt", str(port_run),
                    "--limit", "1000"])
    assert rc == 0
    assert "  opt_state.count  ()  int32  0.00 MB\n" in out
    assert "  opt_state.mu.blocks.0.down  (128, 64)  float32  0.03 MB\n" \
        in out
    assert "  step  ()  int64  0.00 MB\n" in out
    assert "step 3:" in out and "extra keys: ['config', 'step', " \
        "'train_data']" in out


def test_admin_gc_prints_jax_lines(jax_ckpt, tmp_path):
    for name in ("j", "t"):
        shutil.copytree(jax_ckpt, tmp_path / name)
    for argv in (["--keep-latest", "5"], ["--keep-latest", "1", "--dry-run"],
                 ["--keep-latest", "1"]):
        want = _jax(["admin", "gc", "--ckpt", str(tmp_path / "j")] + argv)
        rc, got = _run(["admin", "gc", "--ckpt", str(tmp_path / "t")] + argv)
        assert rc == 0 and got == want.replace(str(tmp_path / "j"),
                                               str(tmp_path / "t"))
    assert sorted(p.name for p in (tmp_path / "t").iterdir()
                  if p.name.startswith("step_")) == ["step_2"]


def test_admin_index_writes_jax_json(tmp_path):
    from distributed_llm_training_and_inference_system_tpu_torch.io.data \
        import write_token_shard
    rng = np.random.default_rng(0)
    d = tmp_path / "data"
    for i, dt in enumerate((np.uint16, np.uint32)):
        write_token_shard(d / f"s{i}.bin", [rng.integers(1, 100, size=n)
                                            for n in (5, 9, 3)], dtype=dt)
    want = _jax(["admin", "index", "--data", str(d), "--out",
                 str(tmp_path / "j.json")])
    rc, got = _run(["admin", "index", "--data", str(d), "--out",
                    str(tmp_path / "t.json")])
    assert rc == 0 and got == want.replace("j.json", "t.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


# -- tune -----------------------------------------------------------------------

TUNE = ["--matmul-size", "32", "48", "16", "--seq-len", "16", "--head-dim",
        "8", "--heads", "2", "--batch", "2", "--trials", "2"]


def test_tune_kernels_cache_is_read_by_jax(tmp_path):
    from distributed_llm_training_and_inference_system_tpu.plugins import (
        autotuning as jat)
    rc, out = _run(["--device", "cpu", "tune", "kernels", *TUNE,
                    "--output-dir", str(tmp_path)])
    assert rc == 0 and "results cached to" in out
    cache = json.loads((tmp_path / "tuning_cache.json").read_text())
    assert sorted(cache) == ["attention_16_8_2_2_cpu", "matmul_32x48x16_cpu"]
    # 9 valid matmul combinations; attention: xla at two dtypes (flash
    # needs a card)
    assert cache["matmul_32x48x16_cpu"]["num_evaluated"] == 9
    assert {r["params"]["impl"] for r in cache["attention_16_8_2_2_cpu"][
        "all_results"]} == {"xla"}
    tuner = jat.AutoTuner()
    tuner.load_results(tmp_path / "tuning_cache.json")
    got = tuner.grid_search(None, cache_key="matmul_32x48x16_cpu")
    assert got.to_dict() == cache["matmul_32x48x16_cpu"]
    assert json.loads(json.dumps(tuner.cache, sort_keys=True)) == cache


def test_tune_kernels_reads_a_jax_cache(tmp_path, monkeypatch):
    _jax(["tune", "kernels", *TUNE, "--output-dir", str(tmp_path)])
    jcache = json.loads((tmp_path / "tuning_cache.json").read_text())
    tuner = tat.AutoTuner(device="cpu")
    tuner.load_results(tmp_path / "tuning_cache.json")

    def no_trial(*a, **k):
        raise AssertionError("a cache hit runs no trial")
    monkeypatch.setattr(tat.MatMulTuner, "benchmark", no_trial)
    monkeypatch.setattr(tat.AttentionTuner, "benchmark", no_trial)
    assert tuner.tune_matmul(32, 48, 16).to_dict() == \
        jcache["matmul_32x48x16_cpu"]
    assert tuner.tune_attention(16, 8, 2, 2).to_dict() == \
        jcache["attention_16_8_2_2_cpu"]
    tuner.save_results(tmp_path / "again.json")
    assert json.loads((tmp_path / "again.json").read_text()) == jcache


@pytest.mark.parametrize("prec,accum", [("default", "float32"),
                                        ("high", "bfloat16"),
                                        ("highest", "float32")])
def test_matmul_trial_restores_the_global_settings(prec, accum):
    cuda = torch.backends.cuda.matmul
    before = (torch.get_float32_matmul_precision(),
              cuda.allow_bf16_reduced_precision_reduction)
    tuner = tat.MatMulTuner(8, 8, 8, device="cpu")
    params = {"dtype": "float32", "precision": prec, "accum_dtype": accum}
    fn, (a, b) = tuner.build(params)
    got = fn(a, b)
    assert got.dtype == getattr(torch, accum)
    torch.testing.assert_close(got, (a @ b).to(got.dtype))
    seen = []

    class Failing(torch.Tensor):
        def __matmul__(self, other):
            seen.append((torch.get_float32_matmul_precision(),
                         cuda.allow_bf16_reduced_precision_reduction))
            raise RuntimeError("trial failed")
    with pytest.raises(RuntimeError, match="trial failed"):
        fn(a.as_subclass(Failing), b)
    want_mode = {"default": "highest", "high": "high",
                 "highest": "highest"}[prec]
    assert seen == [(want_mode, accum == "bfloat16")]
    assert (torch.get_float32_matmul_precision(),
            cuda.allow_bf16_reduced_precision_reduction) == before


def test_tune_kernels_fails_when_a_flash_trial_fails(tmp_path, monkeypatch):
    """A flash kernel that does not build or launch fails the command: the
    plain attention is never cached as the best in its place."""
    monkeypatch.setattr(tat.AttentionTuner, "validate",
                        lambda self, p: p["block_q"] == p["block_k"] == 128)
    real_build = tat.AttentionTuner.build

    def build(self, params):
        if params["impl"] != "flash":
            return real_build(self, params)

        def launch(*a):
            raise RuntimeError("flash_fwd kernel launch failed: CUDA error 1")
        return launch, ()
    monkeypatch.setattr(tat.AttentionTuner, "build", build)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _run(["--device", "cpu", "tune", "kernels", *TUNE,
              "--output-dir", str(tmp_path)])
    assert not (tmp_path / "tuning_cache.json").exists()


def test_attention_tuner_validates_flash_on_a_card_at_its_head_dims():
    t = tat.AttentionTuner(16, 8, 2, 2, device="cpu")
    flash = {"impl": "flash", "block_q": 128, "block_k": 128,
             "dtype": "bfloat16"}
    assert not t.validate(flash)                 # no card
    t.device = torch.device("cuda")              # validate reads no tensor
    assert not t.validate(flash)                 # head dim 8: not built
    for d in (64, 128):
        t.head_dim = d
        assert t.validate(flash)
        assert not t.validate({**flash, "block_k": 256})


def test_attention_tuner_space_and_collective_refusal():
    t = tat.AttentionTuner(16, 8, 2, 2, device="cpu")
    space = t.parameter_space()
    valid = [dict(zip(space, c)) for c in
             __import__("itertools").product(*space.values())
             if t.validate(dict(zip(space, c)))]
    assert valid == [{"impl": "xla", "block_q": 128, "block_k": 128,
                      "dtype": d} for d in ("bfloat16", "float32")]
    # the collective tuner, once item 7's, runs over a mesh: one rank here
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.parallel \
        .mesh import build_mesh
    mesh = build_mesh(ParallelConfig(), torch.device("cpu"))
    res = tat.AutoTuner(tat.TuningConfig(max_iterations=6, num_trials=1),
                        device="cpu").tune_collective(mesh, "dp", 0.01)
    assert res.num_evaluated == 6 and set(res.best_params) == {
        "pattern", "n_chunks", "dtype"}
    fn, args = t.build(valid[1])
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        attention as fa)
    ref = fa.flash_attention(*args, causal=True)
    torch.testing.assert_close(fn(*args), ref, rtol=1e-5, atol=1e-5)


# -- bench ----------------------------------------------------------------------

def _keys(tree, depth=3):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_bench_kernels_keys_as_jax():
    argv = ["bench", "kernels", "--seq-len", "32", "--hidden", "32",
            "--heads", "2", "--batch", "2"]
    want = _json(_jax(argv))
    rc, got = _run(["--device", "cpu"] + argv)
    assert rc == 0 and _keys(_json(got)) == _keys(want)
    assert set(want) == {"matmul", "attention_xla", "rmsnorm", "rope"}


def test_bench_kv_decode_keys_as_jax():
    argv = ["bench", "kv-decode", "--slots", "2", "--kv-heads", "2",
            "--q-heads", "4", "--head-dim", "16", "--page-size", "8",
            "--context", "40", "--layers", "2", "--steps", "2"]
    for mode in ("paged", "scatter"):
        want = _json(_jax(argv + ["--write-mode", mode]))
        rc, got = _run(["--device", "cpu"] + argv + ["--write-mode", mode])
        got = _json(got)
        assert rc == 0 and set(got) == set(want)
        for kind in ("bf16", "int8", "int4"):
            assert _keys(got[kind]) == _keys(want[kind])
            # the ledgers are arithmetic on the shape: JAX's numbers
            assert got[kind]["capacity"] == want[kind]["capacity"]
            assert got[kind]["hbm_ledger_per_step_mb"] == \
                want[kind]["hbm_ledger_per_step_mb"]
        for k in ("int4_vs_int8_slots_per_hbm_byte",
                  "int4_vs_bf16_slots_per_hbm_byte", "write_mode",
                  "backend"):
            assert got[k] == want[k], k
        # the courier's wire-codec section: JAX's bytes and ratios
        assert _keys(got["courier_codec_ab"], 4) == _keys(
            want["courier_codec_ab"], 4)
        for kind, arms in want["courier_codec_ab"].items():
            for codec, arm in arms.items():
                for k in ("bytes_raw", "bytes_wire", "compression_ratio"):
                    assert got["courier_codec_ab"][kind][codec][k] == \
                        arm[k], (kind, codec, k)
        assert got["delta_zlib_vs_none_int8_wire"] == \
            want["delta_zlib_vs_none_int8_wire"]


def test_kv_decode_step_runs_each_page_kind_against_fp32_pages():
    from distributed_llm_training_and_inference_system_tpu_torch.cli.\
        commands import bench
    inp = bench.kv_decode_inputs(2, 2, 16, 4, 8, 40, torch.device("cpu"))
    ref = bench.kv_decode_step(bench.kv_decode_pages("bf16", inp["kf"]),
                               inp, "paged")
    for kind, tol in (("int8", 0.05), ("int4", 0.5)):
        for mode in ("paged", "scatter"):
            out = bench.kv_decode_step(bench.kv_decode_pages(kind, inp["kf"]),
                                       inp, mode)
            assert out.shape == ref.shape and torch.isfinite(out).all()
            assert (out - ref).abs().max() < tol, (kind, mode)


@pytest.mark.parametrize("extra", [[], ["--prefetch", "2", "--step-ms", "1"]],
                         ids=["sync", "prefetch"])
def test_bench_dataloader_keys_as_jax(tmp_path, extra):
    from distributed_llm_training_and_inference_system_tpu_torch.io.data \
        import write_token_shard
    rng = np.random.default_rng(0)
    write_token_shard(tmp_path / "s.bin", [rng.integers(1, 100, size=n)
                                           for n in (50, 90, 30, 70)])
    for path in ("synthetic", f"file://{tmp_path}"):
        argv = ["bench", "dataloader", "--path", path, "--batch", "2",
                "--seq-len", "32", "--batches", "4"] + extra
        want = _json(_jax(argv))
        rc, got = _run(argv)
        assert rc == 0 and set(_json(got)) == set(want), path


def test_bench_e2e_train_and_serve_keys_as_jax():
    argv = ["bench", "e2e", "--model", "gpt-test", "--mode", "both",
            "--steps", "1", "--batch", "2", "--seq-len", "16",
            "--requests", "2", "--prompt-len", "8", "--gen-len", "3"]
    want = _json(_jax(argv))
    rc, got = _run(["--device", "cpu"] + argv)
    got = _json(got)
    assert rc == 0 and _keys(got) == _keys(want)
    assert got["train"]["tokens_per_sec"] > 0


def test_bench_e2e_serve_load_keys_as_jax():
    argv = ["bench", "e2e", "--model", "gpt-test", "--mode", "serve-load",
            "--requests", "3", "--prompt-len", "40", "--gen-len", "3",
            "--rps", "50", "--concurrency", "2", "--serve-hot-prefix", "32"]
    want = _json(_jax(argv))["serve_load"]
    rc, got = _run(["--device", "cpu"] + argv)
    got = _json(got)["serve_load"]
    assert rc == 0 and set(got) == set(want)
    for loop in ("open_loop", "closed_loop"):
        g, w = got[loop][0], want[loop][0]
        assert set(g) == set(w), loop
        # the port's engine counters add dispatched steps, suffix prefills
        # and chunks (the paged kernel's launches a layer)
        assert set(w["engine"]) <= set(g["engine"])
        assert g["completed"] == w["completed"] == 3
        # the hot prefix's two full pages are shared as in JAX's engine
        assert g["engine"]["prefix_cached_tokens"] == \
            w["engine"]["prefix_cached_tokens"] > 0


# the bench e2e line the served fleet options are added to
_FLEET_E2E = ["bench", "e2e", "--model", "gpt-test", "--mode", "serve-load",
              "--requests", "3", "--prompt-len", "6", "--gen-len", "3",
              "--rps", "50", "--concurrency", "2", "--no-device-times",
              "--serve-long-prompt-len", "40"]
_TWO = ["--serve-replicas", "2"]
_WAITS = [
    (["bench", "comms"], "need >=2 ranks"),
    (["tune", "comms"], "need >=2 ranks"),
    (["tune", "sp"], "refusing to calibrate SP schemes on the CPU"),
    (["tune", "full", "--max-iterations", "2", "--trials", "1"],
     "collective: skipped (single device)"),
    (["admin", "lint"], "lint"),
    (["bench", "e2e", "--serve-replicas", "2"], "served"),
    (["bench", "e2e", "--serve-disagg"] + _TWO, "served"),
    (["bench", "e2e", "--serve-courier-chaos", "0.1"] + _TWO, "served"),
    (["bench", "e2e", "--serve-courier-codec", "zlib"] + _TWO, "served"),
    (["bench", "e2e", "--serve-courier-zlib-level", "1"] + _TWO, "served"),
    (["bench", "e2e", "--serve-returning", "2",
      "--serve-returning-history", "48", "--slots", "2"] + _TWO, "served"),
    (["bench", "e2e", "--serve-long-prompts", "1"] + _TWO, "served"),
    (["bench", "e2e", "--serve-scenario", "diurnal",
      "--serve-scenario-duration", "0.5", "--serve-scenario-base-rps", "4",
      "--serve-scenario-peak-rps", "8", "--serve-ttft-target-ms", "500"]
     + _TWO, "served"),
    (["bench", "e2e", "--serve-stream"] + _TWO, "served"),
    (["bench", "e2e", "--serve-max-retries", "2"] + _TWO, "served"),
]


@pytest.mark.parametrize(
    "argv,item", _WAITS,
    ids=[f"argv{i}-item {7 if i < 4 else 9}" for i in range(len(_WAITS))])
def test_what_waits_for_an_item_exits_2(argv, item, capsys, tmp_path):
    """What waits for a ROADMAP item exits 2 naming it; the fleet options
    of ``bench e2e`` are served: the sweep runs a two-replica fleet (and,
    with ``--serve-long-prompts``, the pipelined prefill A/B; with
    ``--serve-returning``, the store-on/off A/B; with ``--serve-scenario``,
    the autoscale-on/off cell), the arms' tokens equal. ``bench comms`` and
    ``tune comms|sp|full``, once item 7's, are ported: on one CPU rank the
    collective commands ask for two ranks (tests/test_torch_comms_bench.py
    runs them on two), ``tune sp`` refuses the CPU, ``tune full`` tunes
    the matmul and attention and skips the collective."""
    if argv[0] in ("bench", "tune") and argv[1] != "e2e":
        if argv[1] == "full":
            argv = argv + ["--output-dir", str(tmp_path)]
            assert tmain.main(["--device", "cpu"] + argv) == 0
            assert item in capsys.readouterr().out
            assert (tmp_path / "full_tuning_results.json").is_file()
            return
        assert tmain.main(["--device", "cpu"] + argv) == 1
        assert item in capsys.readouterr().err
        return
    if item == "lint":
        # graftlint is ported: the port's own tree is clean
        assert tmain.main(["--device", "cpu"] + argv) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[-1].startswith("graftlint: ")
        assert " 0 unsuppressed across 5 pass(es)" in out
        return
    if item != "served":
        assert tmain.main(["--device", "cpu"] + argv) == 2
        err = capsys.readouterr().err
        assert f"ROADMAP queue 1 {item}" in err
        return
    rc, out = _run(["--device", "cpu"] + _FLEET_E2E + argv[2:])
    assert rc == 0
    load = _json(out)["serve_load"]
    for point in load["open_loop"] + load["closed_loop"]:
        assert point["completed"] == 3
        assert sorted(point["per_replica"]) == ["0", "1"]
    if "--serve-long-prompts" in argv:
        assert load["pipeline"]["token_identical"]
        assert load["pipeline"]["chaos_token_identical"]
    if "--serve-returning" in argv:
        ab = load["returning"]
        assert ab["token_identical"]
        on, off = (ab[a]["returning"] for a in ("store_on", "store_off"))
        assert on["conversations"] == off["conversations"] == 2
        assert on["return_prefill_tokens"] < off["return_prefill_tokens"]
        assert ab["store_on"]["kv_store"]["hits"] > 0
    if "--serve-scenario" in argv:
        cell = load["scenario_matrix"]["diurnal"]
        assert cell["token_identical"] and cell["common_completed"] > 0
        assert cell["autoscale_on"]["scenario"]["scaling"]["enabled"]


def _spec(tmp_path, items) -> Path:
    spec = tmp_path / "battery.json"
    spec.write_text(json.dumps({"item": items, "env": {"LLMCTL_X": "7"}}))
    return spec


def test_bench_battery_runs_resumes_and_dry_runs(tmp_path, capsys):
    import sys
    ok = [sys.executable, "-c",
          "import os; print('value', os.environ['LLMCTL_X'])"]
    spec = _spec(tmp_path, [{"name": "ok", "cmd": ok, "timeout": 60},
                            {"name": "bad", "cmd": [sys.executable, "-c",
                                                    "raise SystemExit(4)"]}])
    common = ["bench", "battery", "--spec", str(spec), "--out",
              str(tmp_path / "out"), "--no-guard", "--chip-lock",
              str(tmp_path / "lock")]
    rc, out = _run(common)
    assert rc == 1
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary == {"ran": 1, "skipped": 0, "failed": 1, "parked": False,
                       "manifest": str(tmp_path / "out" /
                                       "battery_manifest.json")}
    log = (tmp_path / "out" / "ok.log").read_text()
    assert "value 7" in log and log.endswith("rc=0\n")
    rc, out = _run(common + ["--dry-run"])
    assert rc == 0 and "skip  ok" in out and "run   bad" in out
    assert "env: LLMCTL_X=7" in out
    rc, out = _run(common)                          # resume skips "ok"
    assert rc == 1 and "ok: already done (rc=0), skipping" in out
    # the JAX command reads the same manifest and skips the same item
    jout = _jax(common[:-3] + ["--chip-lock", str(tmp_path / "lock"),
                               "--dry-run", "--no-guard"])
    assert "skip  ok" in jout and "run   bad" in jout


def test_bench_battery_parks_without_a_card(tmp_path, monkeypatch):
    from distributed_llm_training_and_inference_system_tpu_torch.cli.\
        commands import bench
    monkeypatch.setattr(bench, "probe_card", lambda: False)
    spec = _spec(tmp_path, [{"name": "a", "cmd": "true"}])
    rc, out = _run(["bench", "battery", "--spec", str(spec), "--out",
                    str(tmp_path / "o"), "--no-wait-for-chip",
                    "--chip-lock", ""])
    assert rc == 2 and json.loads(out.strip().splitlines()[-1])["parked"]
    assert not (tmp_path / "lock").exists()
