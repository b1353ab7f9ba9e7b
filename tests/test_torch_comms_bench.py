"""Collective benchmarks and tuning in the port against the JAX package's.

``comms/bench.py`` ``bench_all`` and ``plugins/autotuning.py``
``CollectiveTuner`` run on two gloo ranks of the port
(``tests/torch_dist_ranks.py`` ``comms_bench_rank``, one spawn) and on two
fake CPU devices of JAX: each row has JAX's keys (the port's add the
backend and whether the traffic was host-staged), the same patterns in
the same order, devices, sizes and dtypes; the tuning result has JAX's
keys and space, and the ranks agree on it. ``bench comms`` and ``tune
comms`` run their ranks as children of the command line; ``tune sp``'s
rows, calibrated and saved, flip the planner's ring-or-Ulysses choice as
JAX's ``test_sp_calibration_flips_choice`` does. Times are not compared.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_ranks as R
from distributed_llm_training_and_inference_system_tpu.comms import (
    bench as jbench)
from distributed_llm_training_and_inference_system_tpu.plugins import (
    autotuning as jtune)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.cli.commands \
    import tune as ttune
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_hardware_preset, get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.parallel import (
    planner as tp)

SIZE_MB = 0.05


@pytest.fixture(scope="module")
def ranks():
    return R.spawn(R.comms_bench_rank, 2, SIZE_MB)


@pytest.fixture(scope="module")
def jax_side():
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    rows = jbench.bench_all(mesh, "x", SIZE_MB)
    tuner = jtune.AutoTuner(jtune.TuningConfig(max_iterations=4,
                                               num_trials=2, num_warmup=1))
    res = tuner.tune_collective(mesh, "x", SIZE_MB)
    return rows, res.to_dict(), sorted(tuner.cache)


def test_bench_all_rows_have_jax_structure(ranks, jax_side):
    want = jax_side[0]
    for rows, _, _ in ranks:
        assert [r["pattern"] for r in rows] == [r["pattern"] for r in want]
        for got, ref in zip(rows, want):
            assert set(got) - set(ref) == {"backend", "host_staged"}
            assert set(ref) <= set(got)
            for key in ("devices", "size_mb", "dtype"):
                assert got[key] == ref[key], key
            assert got["backend"] == "gloo" and got["host_staged"] is True
            assert got["time_ms"] > 0 and got["bus_bandwidth_gbps"] > 0
    # every rank reports the slowest rank's time: the rows agree
    assert ranks[0][0] == ranks[1][0]


def test_collective_tuner_has_jax_structure_and_ranks_agree(ranks,
                                                            jax_side):
    want, want_keys = jax_side[1], jax_side[2]
    for _, got, keys in ranks:
        assert set(got) == set(want)
        assert set(got["best_params"]) == set(want["best_params"])
        assert got["num_evaluated"] == want["num_evaluated"] == 4
        assert [set(r) for r in got["all_results"]] == \
            [set(r) for r in want["all_results"]]
        assert [r["params"] for r in got["all_results"]] == \
            [r["params"] for r in want["all_results"]]
        # JAX's key, the port's axis name in it
        assert keys == [k.replace("collective_x", "collective_dp")
                        for k in want_keys]
    assert ranks[0][1] == ranks[1][1]


def _json_after(out: str, head: str):
    return json.loads(out[out.index(head):])


def test_bench_comms_runs_its_ranks(capsys, monkeypatch):
    # one intra-op thread a rank (the children inherit the environment):
    # parallel test workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert tmain.main(["--device", "cpu", "bench", "comms", "--devices", "2",
                       "--size-mb", str(SIZE_MB), "--pattern",
                       "allreduce"]) == 0
    [row] = _json_after(capsys.readouterr().out, "[\n")
    assert row["pattern"] == "allreduce" and row["devices"] == 2
    assert row["backend"] == "gloo" and row["host_staged"] is True
    assert tmain.main(["--device", "cpu", "bench", "comms"]) == 1
    assert "need >=2 ranks" in capsys.readouterr().err


def test_tune_sp_calibration_flips_choice(monkeypatch, tmp_path, capsys):
    """``tune sp``'s rows (here from set times: the ring step near its
    FLOPs ideal at the H100's peak, Ulysses 20x off it), calibrated and
    saved, make the planner pick ring where the analytic model picks
    Ulysses; ``tune sp`` refuses the CPU."""
    monkeypatch.setenv("LLMCTL_SP_CALIBRATION", str(tmp_path / "sp.json"))
    hw = get_hardware_preset("h100-1")
    peak = hw.peak_bf16_tflops * 1e12
    sp, heads, head_dim = 8, 16, 128

    def timer(causal, q, k):
        b, s, n, d = q.shape
        if causal:                  # ulysses: full S, heads/sp
            return 2.0 * b * s * s * n * d / peak * 1e3 / 0.05
        return 4.0 * b * s * s * n * d / peak * 1e3 / 0.9
    rows = ttune.sp_rows([8192, 16384], sp, heads, head_dim, "cpu", timer)
    args = SimpleNamespace(heads=heads, head_dim=head_dim, sp=sp,
                           save_calib=True)
    model = get_model_config("gpt-7b")
    assert tp.choose_sp_scheme(model, 8, 32768, hw=hw)[0] == "ulysses"
    calib = ttune.sp_calibrate(rows, hw, args)
    assert 0.85 <= calib["ring_efficiency"] <= 1.0
    assert calib["ulysses_efficiency"] < 0.1
    assert tp.load_sp_calibration() == calib
    scheme, costs = tp.choose_sp_scheme(model, 8, 32768, hw=hw)
    assert costs["calibrated"] and scheme == "ring"
    capsys.readouterr()
    assert tmain.main(["--device", "cpu", "tune", "sp"]) == 1
    assert "refusing" in capsys.readouterr().err
