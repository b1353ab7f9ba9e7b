"""The port's planner (``parallel/planner.py``) and ``plan`` against the
JAX package's.

The JAX planner tests (``tests/test_parallel.py``: plan search, the
single-chip rejection, long-context sp, the sp-scheme choice and its
calibration, the plan TOML, the compute-efficiency calibration, the
serving planner and its calibration) run on both packages with the same
inputs: every plan's ``to_dict``, every estimate, calibration, sweep row
and the ``plan compute --out`` TOML must equal JAX's (exact: the same
float arithmetic in the same order). The hardware presets equal JAX's
field for field; ``h100-1`` and ``h100-8`` are the card's.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.config.presets import (
    HARDWARE_PRESETS as JAX_HW)
from distributed_llm_training_and_inference_system_tpu.config.schema import (
    HardwareConfig as JaxHW, ParallelConfig as JaxPar)
from distributed_llm_training_and_inference_system_tpu.parallel import (
    planner as jp)
from distributed_llm_training_and_inference_system_tpu.utils.tomlio import (
    dump_toml as jax_dump_toml, load_config_file as jax_load)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    HARDWARE_PRESETS, ParallelConfig, get_hardware_preset,
    get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.parallel import (
    planner as tp)


@pytest.fixture(autouse=True)
def _no_calibration(tmp_path, monkeypatch):
    """Every test starts uncalibrated (no file in the working tree is
    read)."""
    for var, name in (("LLMCTL_CALIBRATION", "cal.json"),
                      ("LLMCTL_SP_CALIBRATION", "sp.json"),
                      ("LLMCTL_SERVE_CALIBRATION", "serve.json")):
        monkeypatch.setenv(var, str(tmp_path / name))


def both(model: str, hw: str):
    """(JAX's model and hardware, the port's): a card's preset goes to
    JAX as a profile of the same fields."""
    port_hw = get_hardware_preset(hw)
    jax_hw = JAX_HW.get(hw) or JaxHW(**dataclasses.asdict(port_hw))
    return (jax_cfg(model), jax_hw), (get_model_config(model), port_hw)


def dicts(plans) -> list:
    return [p.to_dict() for p in plans]


def test_hardware_presets_equal_jax_and_add_the_card():
    for name, hw in JAX_HW.items():
        assert dataclasses.asdict(HARDWARE_PRESETS[name]) == \
            dataclasses.asdict(hw), name
    assert set(HARDWARE_PRESETS) - set(JAX_HW) == {"h100-1", "h100-8"}
    for name, n in (("h100-1", 1), ("h100-8", 8)):
        hw = HARDWARE_PRESETS[name]
        assert (hw.chip_type, hw.num_chips, hw.hbm_gb_per_chip,
                hw.peak_bf16_tflops) == ("h100", n, 80.0, 989.0)


@pytest.mark.parametrize("model,hw,chips,seq,batch,kw", [
    ("gpt-7b", "v5e-256", 256, 2048, 512, {}),
    ("gpt-7b", "v5e-1", 1, 2048, 8, {}),
    ("gpt-7b", "v5e-256", 256, 32768, 64,
     dict(long_context=True, max_candidates=20)),
    ("gpt-moe-8x1b", "v5e-64", 64, 4096, 128, {}),
    ("llama-8b-gqa", "h100-8", 8, 4096, 64, dict(long_context=True)),
], ids=["7b-v5e256", "7b-single-chip", "7b-long-context", "moe-v5e64",
        "llama-h100-8"])
def test_search_equals_jax(model, hw, chips, seq, batch, kw):
    (jm, jh), (tm, th) = both(model, hw)
    want = jp.MeshPlanner(jm, jh).search(chips, seq, batch, **kw)
    got = tp.MeshPlanner(tm, th).search(chips, seq, batch, **kw)
    assert dicts(got) == dicts(want)
    assert got


def test_planner_7b_v5e256():
    model, hw = get_model_config("gpt-7b"), get_hardware_preset("v5e-256")
    best = tp.MeshPlanner(model, hw).search(256, seq_len=2048,
                                            global_batch=512)[0]
    assert best.estimate.fits, best.estimate.reject_reason
    assert best.parallel.total_devices == 256
    assert 0.2 < best.estimate.mfu < 1.0
    assert best.estimate.total_gb < hw.hbm_gb_per_chip


def test_planner_7b_single_chip_rejects():
    plans = tp.MeshPlanner(get_model_config("gpt-7b"),
                           get_hardware_preset("v5e-1")).search(
        1, seq_len=2048, global_batch=8)
    assert plans and not plans[0].estimate.fits
    assert "exceeds HBM" in plans[0].estimate.reject_reason


def test_planner_long_context_uses_sp():
    hw = get_hardware_preset("v5e-256")
    plans = tp.MeshPlanner(get_model_config("gpt-7b"), hw).search(
        256, seq_len=32768, global_batch=64, long_context=True,
        max_candidates=20)
    assert plans and plans[0].estimate.fits
    assert any(p.parallel.sequence_parallel > 1 for p in plans)
    assert plans[0].estimate.activations_gb < hw.hbm_gb_per_chip


@pytest.mark.parametrize("par", [
    dict(data_parallel=8, micro_batch_size=4, global_batch_size=32),
    dict(fsdp=4, tensor_parallel=2, zero_stage=1, micro_batch_size=2,
         global_batch_size=16, activation_checkpoint="full"),
    dict(pipeline_parallel=2, num_microbatches=4, data_parallel=2,
         tensor_parallel=2, activation_checkpoint="none"),
    dict(sequence_parallel=4, tensor_parallel=2,
         activation_checkpoint="selective_attn"),
])
def test_manual_plan_equals_jax(par):
    (jm, jh), (tm, th) = both("gpt-1b", "v5e-8")
    want = jp.manual_plan(jm, jh, JaxPar(**par), 4096, 32)
    got = tp.manual_plan(tm, th, ParallelConfig(**par), 4096, 32)
    assert got.to_dict() == want.to_dict()


def test_sp_scheme_chooser():
    (jm, jh), (tm, th) = both("gpt-7b", "v5e-256")
    for sp in (8, 3):
        want = jp.choose_sp_scheme(jm, sp, 32768, hw=jh, calibration={})
        got = tp.choose_sp_scheme(tm, sp, 32768, hw=th, calibration={})
        assert got == want
    scheme, costs = tp.choose_sp_scheme(tm, 8, 32768, hw=th,
                                        calibration={})
    assert costs["ulysses_feasible"] and scheme == "ulysses"
    scheme, costs = tp.choose_sp_scheme(tm, 3, 32768, hw=th,
                                        calibration={})
    assert not costs["ulysses_feasible"] and scheme == "ring"
    assert costs["ulysses_ms"] == float("inf")


def test_sp_calibration_flips_choice():
    """Measured per-scheme efficiencies (tune sp) override the analytic
    default and can flip the choice; a calibration from other silicon is
    ignored. The calibration dict is JAX's."""
    model, hw = get_model_config("gpt-7b"), get_hardware_preset("v5e-256")
    peak = hw.peak_bf16_tflops * 1e12
    rows = []
    for s in (8192, 16384):
        ring_ideal = 4.0 * (s / 8) * s * 16 * 128 / peak * 1e3
        uly_ideal = 2.0 * float(s) * s * (16 / 8) * 128 / peak * 1e3
        rows.append({"S": s,
                     "ring_compute_ms_per_device": ring_ideal / 0.9,
                     "ulysses_compute_ms_per_device": uly_ideal / 0.05})
    calib = tp.calibrate_sp_schemes(rows, hw)
    assert calib == jp.calibrate_sp_schemes(rows, JAX_HW["v5e-256"])
    assert 0.85 <= calib["ring_efficiency"] <= 1.0
    assert calib["ulysses_efficiency"] < 0.1
    tp.save_sp_calibration(calib)
    assert tp.load_sp_calibration()["chip_type"] == hw.chip_type
    scheme, costs = tp.choose_sp_scheme(model, 8, 32768, hw=hw)
    assert costs["calibrated"] and scheme == "ring"
    assert (scheme, costs) == jp.choose_sp_scheme(
        jax_cfg("gpt-7b"), 8, 32768, hw=JAX_HW["v5e-256"])
    tp.save_sp_calibration({**calib, "chip_type": "v9z"})
    scheme, costs = tp.choose_sp_scheme(model, 8, 32768, hw=hw)
    assert not costs["calibrated"] and scheme == "ulysses"
    with pytest.raises(ValueError, match="faster than"):
        tp.calibrate_sp_schemes([{**rows[0], "ring_compute_ms_per_device":
                                  1e-6}], hw)


def test_plan_toml_roundtrip(tmp_path):
    """``plan compute --out`` writes JAX's TOML for the same plan."""
    (jm, jh), _ = both("gpt-1b", "v5e-8")
    want = tmp_path / "jax.toml"
    jax_dump_toml(jp.MeshPlanner(jm, jh).best(8, 2048, 64).to_dict(), want)
    got = tmp_path / "port.toml"
    assert tmain.main(["--device", "cpu", "plan", "compute", "--model",
                       "gpt-1b", "--hardware", "v5e-8", "--global-batch",
                       "64", "--out", str(got)]) == 0
    assert got.read_text() == want.read_text()
    back = jax_load(got)
    assert back["parallelism"]["tensor_parallel"] == \
        jax_load(want)["parallelism"]["tensor_parallel"]


def test_plan_compute_tables_and_manual_mode(capsys, tmp_path):
    """The search's table and breakdown, the manual mode's one plan (its
    TOML JAX's manual plan's), the sp scheme line, the hints."""
    argv = ["--device", "cpu", "plan", "compute", "--model", "gpt-7b",
            "--hardware", "v5e-1", "-tp", "1", "--fsdp", "1", "--out",
            str(tmp_path / "m.toml")]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "Parallelism plans: gpt-7b on v5ex1 (seq 2048, batch 32)" in out
    assert "Best plan: per-chip memory & time breakdown" in out
    assert "EXCEEDED" in out and "Plan exceeds limits" in out
    (jm, jh), _ = both("gpt-7b", "v5e-1")
    par = JaxPar(strategy="manual", micro_batch_size=1, global_batch_size=32,
                 gradient_accumulation_steps=32)
    want = tmp_path / "j.toml"
    jax_dump_toml(jp.manual_plan(jm, jh, par, 2048, 32).to_dict(), want)
    assert (tmp_path / "m.toml").read_text() == want.read_text()
    assert tmain.main(["--device", "cpu", "plan", "compute", "--model",
                       "gpt-7b", "--hardware", "v5e-256", "--seq-len",
                       "32768", "--global-batch", "64", "--long-context",
                       "-sp", "8", "-tp", "2"]) == 0
    assert "sp scheme: ulysses" in capsys.readouterr().out


def test_planner_calibration_roundtrip():
    model, hw = get_model_config("gpt-1b"), get_hardware_preset("v5e-8")
    default = tp.MeshPlanner(model, hw)
    assert default.COMPUTE_EFFICIENCY == \
        tp.MeshPlanner.DEFAULT_COMPUTE_EFFICIENCY == \
        jp.MeshPlanner.DEFAULT_COMPUTE_EFFICIENCY
    tp.save_calibration({"compute_efficiency": 0.458,
                         "chip_type": hw.chip_type})
    assert tp.load_calibration()["compute_efficiency"] == 0.458
    calibrated = tp.MeshPlanner(model, hw)
    assert calibrated.COMPUTE_EFFICIENCY == 0.458
    par = ParallelConfig(micro_batch_size=4, global_batch_size=32,
                         data_parallel=8)
    assert (calibrated.estimate(par, 2048, 32).step_time_s
            > default.estimate(par, 2048, 32).step_time_s)
    # JAX's planner reads the same file the same way
    jcal = jp.MeshPlanner(jax_cfg("gpt-1b"), JAX_HW["v5e-8"])
    assert dataclasses.asdict(calibrated.estimate(par, 2048, 32)) == \
        dataclasses.asdict(jcal.estimate(JaxPar(
            micro_batch_size=4, global_batch_size=32, data_parallel=8),
            2048, 32))
    # an H100 calibration does not price a TPU, and the reverse
    tp.save_calibration({"compute_efficiency": 0.3, "chip_type": "h100"})
    assert tp.MeshPlanner(model, hw).COMPUTE_EFFICIENCY == 0.6
    assert tp.MeshPlanner(model, get_hardware_preset(
        "h100-8")).COMPUTE_EFFICIENCY == 0.3


def test_zero_stage_semantics_validated():
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ConfigError
    with pytest.raises(ConfigError, match="fsdp"):
        ParallelConfig(zero_stage=3).validate()
    ParallelConfig(zero_stage=3, fsdp=2).validate()
    ParallelConfig(zero_stage=1).validate()


@pytest.mark.parametrize("model,hw", [("gpt-1b", "v5e-8"),
                                      ("gpt-7b", "v5e-1"),
                                      ("llama-8b-gqa", "h100-1")])
def test_serve_planner_equals_jax(model, hw):
    (jm, jh), (tm, th) = both(model, hw)
    jsp, tsp = jp.ServePlanner(jm, jh), tp.ServePlanner(tm, th)
    for tpar in (1, 2):
        kw = dict(context_len=8192, tensor_parallel=tpar,
                  batches=(4, 256))
        assert tsp.sweep(**kw) == jsp.sweep(**kw)
        for q, kq in (("none", "none"), ("int8", "int8"), ("int4", "int4")):
            assert tsp.estimate(batch=8, quant=q, kv_quant=kq,
                                tensor_parallel=tpar).to_dict() == \
                jsp.estimate(batch=8, quant=q, kv_quant=kq,
                             tensor_parallel=tpar).to_dict()


def test_serve_planner_prices_quant_and_capacity():
    cfg = get_model_config("gpt-1b")
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import HardwareConfig
    p = tp.ServePlanner(cfg, HardwareConfig())
    fp = p.estimate(batch=8, quant="none")
    q8 = p.estimate(batch=8, quant="int8")
    q4 = p.estimate(batch=8, quant="int4")
    assert fp.weight_gb > q8.weight_gb > q4.weight_gb
    assert fp.kv_pool_gb < q8.kv_pool_gb < q4.kv_pool_gb
    assert fp.decode_tok_s < q8.decode_tok_s < q4.decode_tok_s
    kv8 = p.estimate(batch=8, kv_quant="int8")
    assert kv8.kv_pages > fp.kv_pages * 1.8
    rows = p.sweep(context_len=8192 * 16, batches=(256,))
    assert any(not r["fits"] and "KV pool" in r["reject_reason"]
               for r in rows)
    assert 1.0 < fp.prefill_ms < 200.0


def test_serve_planner_calibration_plumbing():
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import HardwareConfig
    cfg, hw = get_model_config("gpt-1b"), HardwareConfig()
    assert tp.load_serve_calibration() is None
    assert tp.ServePlanner(cfg, hw).decode_efficiency == 0.6
    tp.save_serve_calibration({"chip_type": hw.chip_type,
                               "decode_efficiency": 0.42,
                               "mfu_prefill": 0.33})
    p = tp.ServePlanner(cfg, hw)
    assert p.decode_efficiency == 0.42 and p.mfu_prefill == 0.33
    assert p.estimate(batch=8).decode_tok_s < tp.ServePlanner(
        cfg, hw, decode_efficiency=0.6).estimate(batch=8).decode_tok_s
    tp.save_serve_calibration({"chip_type": "v9999",
                               "decode_efficiency": 0.01})
    assert tp.ServePlanner(cfg, hw).decode_efficiency == 0.6
    assert tp.ServePlanner(cfg, hw,
                           decode_efficiency=0.9).decode_efficiency == 0.9


class _Engine:
    """An engine's calibration surface with set times (JAX's and the
    port's calibrations read the same numbers)."""

    def __init__(self, serve_cfg, tp_, prefill_ms, decode_ms):
        self.serve_cfg = SimpleNamespace(
            max_seq_len=1024, quantization=serve_cfg[0],
            kv_quantization=serve_cfg[1], tensor_parallel=tp_)
        self.times = (prefill_ms, decode_ms)

    def _bucket(self, n):
        return 512

    def measure_device_times(self, buckets=()):
        return {"prefill_ms": {b: self.times[0] for b in buckets},
                "decode_ms_per_token": self.times[1], "iters": 8}


@pytest.mark.parametrize("quant,tp_", [(("none", "none"), 1),
                                       (("int8", "int8"), 2),
                                       (("int4", "none"), 2)])
def test_calibrate_serve_planner_equals_jax(quant, tp_):
    (jm, jh), (tm, th) = both("llama-8b-gqa", "h100-1")
    eng = _Engine(quant, tp_, 61.3, 9.7)
    assert tp.calibrate_serve_planner(tm, th, eng) == \
        jp.calibrate_serve_planner(jm, jh, eng)


def test_plan_serve_sweep_and_calibrate(capsys, monkeypatch, tmp_path):
    """``plan serve``'s sweep and single-config JSON are the planner's;
    ``--calibrate`` measures a gpt-test engine on the CPU against a CPU
    profile and saves it, and refuses a card's profile on the CPU."""
    assert tmain.main(["--device", "cpu", "plan", "serve", "--model",
                       "gpt-1b", "--hardware", "h100-1",
                       "--candidates", "3"]) == 0
    rows = json.loads(capsys.readouterr().out)
    (jm, jh), _ = both("gpt-1b", "h100-1")
    assert rows == jp.ServePlanner(jm, jh).sweep()[:3]
    assert tmain.main(["--device", "cpu", "plan", "serve", "--model",
                       "gpt-1b", "--hardware", "h100-1", "--quant",
                       "int8"]) == 0
    assert json.loads(capsys.readouterr().out) == jp.ServePlanner(
        jm, jh).estimate(quant="int8").to_dict()
    assert tmain.main(["--device", "cpu", "plan", "serve", "--model",
                       "gpt-test", "--hardware", "h100-1",
                       "--calibrate"]) == 1
    assert "refusing" in capsys.readouterr().err
    assert tmain.main(["--device", "cpu", "plan", "serve", "--model",
                       "gpt-test", "--hardware", "cpu-8",
                       "--calibrate"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["chip_type"] == "cpu-fake" and out["prefill_bucket"] == 128
    assert tp.load_serve_calibration()["decode_ms_per_token"] == \
        out["decode_ms_per_token"] > 0


def test_plan_verify_measures_and_does_not_save_a_cpu_run(capsys):
    assert tmain.main(["--device", "cpu", "plan", "verify", "--model",
                       "gpt-test", "--batch", "2", "--seq-len", "64",
                       "--steps", "2"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out[:out.rindex("}") + 1])
    assert result["backend"] == "cpu" and result["measured_step_ms"] > 0
    assert abs(result["recalibrated_error"]) < 1e-3
    assert "not saving calibration" in out
    assert tp.load_calibration() is None
