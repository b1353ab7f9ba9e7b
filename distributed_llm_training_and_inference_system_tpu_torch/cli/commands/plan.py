"""`llmctl-torch plan` — parallelism planning (the JAX package's ``plan``).

The options, the plan TOML (``--out``) and the tables are the JAX
command's; the tables print as plain text (no rich). The cost model is
``parallel/planner.py``:

- ``compute``: search (or, with any degree given, evaluate) a plan for
  ``--model`` on ``--hardware`` (a preset: JAX's TPU presets, ``h100-1``,
  ``h100-8``; or a profile file);
- ``verify``: train steps on the global ``--device`` against the planner's
  prediction for the same single-device config; on a card the measured
  compute efficiency is saved as the calibration later plans use (a CPU
  measurement is never saved);
- ``serve``: price serving configurations (``ServePlanner``), or with
  ``--calibrate`` measure a live engine's device times
  (``calibrate_serve_planner``) and save them; with
  ``--tensor-parallel N`` the engine runs on N ranks of this command line
  (``runtime.launcher.launch_ranks``) and its times are one rank's. A
  calibration is refused where the engine's device is not the profile's
  kind.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog,
                                 description="Parallelism planning.")
    sub = ap.add_subparsers(dest="sub", metavar="{compute,verify,serve}")
    co = sub.add_parser("compute", help="Search (or evaluate) a parallelism "
                                        "plan for MODEL on HARDWARE.")
    co.add_argument("--model", required=True,
                    help="Model template name or config file (JSON/TOML).")
    co.add_argument("--hardware", required=True,
                    help="Hardware preset name (e.g. h100-8, v5e-8) or "
                         "profile file.")
    co.add_argument("--seq-len", default=2048, type=int)
    co.add_argument("--global-batch", default=32, type=int)
    co.add_argument("--long-context", action="store_true", default=False,
                    help="Search sequence-parallel (ring attention) axes "
                         "too.")
    co.add_argument("--tensor-parallel", "-tp", default=None, type=int,
                    help="Manual mode: fix TP degree.")
    co.add_argument("--pipeline-parallel", "-pp", default=None, type=int)
    co.add_argument("--sequence-parallel", "-sp", default=None, type=int)
    co.add_argument("--expert-parallel", "-ep", default=None, type=int)
    co.add_argument("--fsdp", default=None, type=int)
    co.add_argument("--zero-stage", default=None, type=int)
    co.add_argument("--micro-batch", default=None, type=int)
    co.add_argument("--candidates", default=3, type=int,
                    help="How many top plans to display.")
    co.add_argument("--out", dest="out_path", default=None,
                    help="Save plan TOML.")
    ve = sub.add_parser("verify", help="Measure a real train step against "
                                       "the planner's prediction.")
    ve.add_argument("--model", default="gpt-750m",
                    help="Model template or config file to measure.")
    ve.add_argument("--hardware", default=None,
                    help="Hardware preset for prediction (default: h100-1).")
    ve.add_argument("--batch", default=4, type=int)
    ve.add_argument("--seq-len", default=2048, type=int)
    ve.add_argument("--steps", default=10, type=int)
    ve.add_argument("--save", dest="save_calib", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="Persist the measured compute efficiency so future "
                         "planner predictions use it.")
    ve.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="Adam mu/nu dtype for the measured step.")
    se = sub.add_parser("serve", help="Price SERVING configs.")
    se.add_argument("--model", required=True,
                    help="Model template name or config file (JSON/TOML).")
    se.add_argument("--hardware", required=True,
                    help="Hardware preset name (e.g. h100-1) or profile "
                         "file.")
    se.add_argument("--context-len", default=1024, type=int,
                    help="Resident context length priced for KV capacity.")
    se.add_argument("--prompt-len", default=512, type=int)
    se.add_argument("--page-size", default=64, type=int)
    se.add_argument("--batch", default=None, type=int,
                    help="Single-config mode: fix the decode batch size.")
    se.add_argument("--quant", default=None, choices=["none", "int8", "int4"],
                    help="Single-config mode: fix weight quantization.")
    se.add_argument("--kv-quant", default=None,
                    choices=["none", "int8", "int4"])
    se.add_argument("--tensor-parallel", "-tp", default=1, type=int)
    se.add_argument("--candidates", default=6, type=int)
    se.add_argument("--calibrate", action="store_true", default=False,
                    help="Measure (decode_efficiency, mfu_prefill) on the "
                         "live device via a small engine's device-time "
                         "probes and persist to "
                         "tuning_results/serve_calibration.json.")
    se.add_argument("--artifact", default="",
                    help="Calibrate: load weights from a checkpoint dir or "
                         "export file instead of random init.")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch plan").print_help()
        return 0
    return {"compute": compute, "verify": verify, "serve": serve}[
        args.sub](args)


def _load_model(spec: str):
    from ...config.presets import get_model_config
    from ...config.schema import ModelConfig
    from ...utils.tomlio import load_config_file
    if Path(spec).exists():
        return ModelConfig.from_dict(load_config_file(spec))
    return get_model_config(spec)


def _load_hw(spec: str):
    from ...config.presets import HARDWARE_PRESETS, get_hardware_preset
    from ...config.schema import HardwareConfig
    from ...utils.tomlio import load_config_file
    if spec in HARDWARE_PRESETS:
        return get_hardware_preset(spec)
    raw = load_config_file(spec)
    return HardwareConfig.from_dict(raw.get("hardware", raw))


def table(title: str, head: tuple, rows: list, right=()) -> str:
    """A plain-text table: the title, the columns, one line a row
    (columns in ``right`` right-aligned)."""
    cells = [list(head)] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(head))]

    def line(r):
        return "  ".join(c.rjust(w) if i in right else c.ljust(w)
                         for i, (c, w) in enumerate(zip(r, widths))).rstrip()
    rule = "-" * len(line(cells[0]))
    return "\n".join([title, line(cells[0]), rule]
                     + [line(r) for r in cells[1:]])


def compute(args) -> int:
    """Search (or evaluate) a parallelism plan for MODEL on HARDWARE."""
    from ...config.schema import ParallelConfig
    from ...parallel.planner import MeshPlanner, choose_sp_scheme, \
        manual_plan
    from ...utils.tomlio import dump_toml

    model_cfg = _load_model(args.model)
    hw = _load_hw(args.hardware)
    manual = any(v is not None for v in (
        args.tensor_parallel, args.pipeline_parallel, args.sequence_parallel,
        args.expert_parallel, args.fsdp, args.zero_stage, args.micro_batch))
    if manual:
        tp = args.tensor_parallel or 1
        pp = args.pipeline_parallel or 1
        sp = args.sequence_parallel or 1
        ep = args.expert_parallel or 1
        fs = args.fsdp or 1
        dp = max(hw.num_chips // (tp * pp * sp * ep * fs), 1)
        mb = args.micro_batch or 1
        shards = dp * fs
        par = ParallelConfig(
            strategy="manual", data_parallel=dp, fsdp=fs,
            tensor_parallel=tp, pipeline_parallel=pp, sequence_parallel=sp,
            expert_parallel=ep, zero_stage=args.zero_stage or 0,
            micro_batch_size=mb, global_batch_size=args.global_batch,
            gradient_accumulation_steps=max(
                args.global_batch // max(shards * mb, 1), 1))
        plans = [manual_plan(model_cfg, hw, par, args.seq_len,
                             args.global_batch)]
    else:
        plans = MeshPlanner(model_cfg, hw).search(
            hw.num_chips, args.seq_len, args.global_batch,
            max_candidates=args.candidates, long_context=args.long_context)
    if not plans:
        raise CommandError("no feasible plan found — reduce model/batch or "
                           "add chips")

    cols = ("dp", "fsdp", "tp", "pp", "sp", "ep", "zero", "mb",
            "mem GB/chip", "step ms", "tok/s/chip", "MFU", "fits")
    rows = []
    for p in plans:
        e, c = p.estimate, p.parallel
        rows.append((c.data_parallel, c.fsdp, c.tensor_parallel,
                     c.pipeline_parallel, c.sequence_parallel,
                     c.expert_parallel, c.zero_stage, c.micro_batch_size,
                     f"{e.total_gb:.1f}", f"{e.step_time_s * 1e3:.0f}",
                     f"{e.tokens_per_sec_per_chip:.0f}",
                     f"{e.mfu * 100:.0f}%", "Y" if e.fits else "N"))
    print(table(f"Parallelism plans: {model_cfg.name} on "
                f"{hw.chip_type}x{hw.num_chips} "
                f"(seq {args.seq_len}, batch {args.global_batch})", cols,
                rows, right=range(len(cols))))

    best = plans[0]
    e = best.estimate
    print(table("Best plan: per-chip memory & time breakdown",
                ("Resource", "Value", "Limit"), [
                    ("params", f"{e.params_gb:.2f} GB", ""),
                    ("grads", f"{e.grads_gb:.2f} GB", ""),
                    ("optimizer", f"{e.optimizer_gb:.2f} GB", ""),
                    ("activations", f"{e.activations_gb:.2f} GB", ""),
                    ("total", f"{e.total_gb:.2f} GB",
                     f"{hw.hbm_gb_per_chip:.0f} GB "
                     + ("OK" if e.fits else "EXCEEDED")),
                    ("compute", f"{e.compute_time_s * 1e3:.1f} ms", ""),
                    ("dp comm", f"{e.dp_comm_time_s * 1e3:.1f} ms", ""),
                    ("tp comm", f"{e.tp_comm_time_s * 1e3:.1f} ms", ""),
                    ("pp bubble", f"{e.pp_bubble_frac * 100:.0f}%", "")],
                right=(1, 2)))

    if best.parallel.sequence_parallel > 1:
        scheme, costs = choose_sp_scheme(
            model_cfg, best.parallel.sequence_parallel, args.seq_len,
            best.parallel.micro_batch_size, hw=hw)
        src = "measured (tune sp)" if costs["calibrated"] else "analytic"
        uly = ("infeasible (heads % sp != 0)"
               if not costs["ulysses_feasible"]
               else f"{costs['ulysses_ms']:.0f} ms")
        print(f"sp scheme: {scheme} — ring {costs['ring_ms']:.0f} ms vs "
              f"ulysses {uly} per step attention ({src})")

    if not e.fits:
        print("Plan exceeds limits. Consider:")
        for hint in ("raise --tensor-parallel or --fsdp to shard more",
                     "set --zero-stage 1 (sharded optimizer state)",
                     "use activation_checkpoint=full",
                     "reduce --global-batch or --seq-len"):
            print(f"  - {hint}")
        if e.reject_reason:
            print(f"  reason: {e.reject_reason}")

    if args.out_path:
        dump_toml(best.to_dict(), args.out_path)
        print(f"Plan saved to {args.out_path}")
    return 0


def verify(args) -> int:
    """Measure train steps on the device and compare them with the
    planner's prediction for the same single-device config; on a card,
    persist the measured compute efficiency as calibration."""
    import time

    import torch

    from ...config.schema import OptimizerConfig, ParallelConfig
    from ...device import resolve_device
    from ...exec.train_step import TrainState, make_train_step
    from ...models import gpt
    from ...parallel.planner import (MeshPlanner, manual_plan,
                                     save_calibration)

    device = resolve_device(args.root.device)
    on_card = device.type == "cuda"
    model_cfg = _load_model(args.model)
    hw = _load_hw(args.hardware or "h100-1")

    par = ParallelConfig(activation_checkpoint="selective",
                         micro_batch_size=args.batch,
                         global_batch_size=args.batch)
    step_fn, opt_init, _ = make_train_step(
        model_cfg, OptimizerConfig(lr=1e-4, moment_dtype=args.moment_dtype,
                                   nu_dtype=args.moment_dtype), par,
        attn_impl="flash" if on_card else "xla")
    gen = torch.Generator(device=device).manual_seed(0)
    state = TrainState.create(gpt.init(model_cfg, gen, device=device),
                              opt_init)
    tokens = torch.randint(1, model_cfg.vocab_size,
                           (args.batch, args.seq_len), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    batch = {"tokens": tokens}
    state, m = step_fn(state, batch)
    float(m["loss"])                      # waits for the device
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step_fn(state, batch)
    float(m["loss"])
    measured_s = (time.perf_counter() - t0) / args.steps

    tok_s = args.batch * args.seq_len / measured_s
    fpt = gpt.flops_per_token(model_cfg, args.seq_len)
    measured_eff = tok_s * fpt / (hw.peak_bf16_tflops * 1e12)
    plan = manual_plan(model_cfg, hw, par, args.seq_len, args.batch)
    predicted_s = plan.estimate.step_time_s
    err = (predicted_s - measured_s) / measured_s
    plan2 = MeshPlanner(model_cfg, hw, compute_efficiency=measured_eff
                        ).estimate(par, args.seq_len, args.batch)
    err2 = (plan2.step_time_s - measured_s) / measured_s
    backend = "gpu" if on_card else "cpu"
    result = {
        "model": model_cfg.name, "batch": args.batch,
        "seq_len": args.seq_len,
        "measured_step_ms": round(measured_s * 1e3, 2),
        "predicted_step_ms": round(predicted_s * 1e3, 2),
        "prediction_error": round(err, 4),
        "measured_compute_efficiency": round(measured_eff, 4),
        "recalibrated_step_ms": round(plan2.step_time_s * 1e3, 2),
        "recalibrated_error": round(err2, 4),
        "backend": backend,
    }
    print(json.dumps(result, indent=2))
    if args.save_calib and not on_card:
        # a CPU-measured "efficiency" against a card's peak would poison
        # every future prediction
        print(f"not saving calibration: measurement ran on {backend}, "
              f"peaks are for {hw.chip_type}")
    elif args.save_calib:
        path = save_calibration({
            "compute_efficiency": round(measured_eff, 4),
            "chip_type": hw.chip_type, "source": result})
        print(f"calibration saved to {path} — future `llmctl-torch plan` "
              "predictions for this chip type use the measured efficiency")
    return 0


def serve(args) -> int:
    """Price serving configs: weight/KV memory budget, max residency, and
    analytic TTFT + decode throughput per (quant, kv-quant, batch)."""
    from ...parallel.planner import (ServePlanner, calibrate_serve_planner,
                                     save_serve_calibration)

    model_cfg = _load_model(args.model)
    hw_cfg = _load_hw(args.hardware)
    if args.calibrate:
        from ...config.schema import ServeConfig
        from ...device import resolve_device
        from ...serve import InferenceEngine
        device = resolve_device(args.root.device)
        if (device.type == "cuda") != (hw_cfg.platform == "gpu"):
            # times measured on one kind of device, stamped with another's
            # chip type, would poison every future serve prediction
            raise CommandError(
                f"refusing to calibrate a {hw_cfg.chip_type} profile "
                f"({hw_cfg.platform}) on the {device.type} device — run on "
                "that hardware, or pass a --hardware profile of it")
        tp = args.tensor_parallel
        if tp > 1:
            # a tensor-parallel engine: this command line on tp ranks,
            # rank 0 measuring, the others following its descriptors
            from ...parallel.mesh import init_distributed, rank_device
            from ...runtime.launcher import launch_ranks, this_rank
            if this_rank() is None:
                return launch_ranks(args.argv, tp)
            device = rank_device(device, tp)
            init_distributed(device)
        eng = InferenceEngine(model_cfg, ServeConfig(
            model=model_cfg.name, max_batch_size=4,
            max_seq_len=min(1024, model_cfg.max_position_embeddings),
            artifact=args.artifact, quantization=args.quant or "none",
            kv_quantization=args.kv_quant or "none",
            dtype="bfloat16" if device.type == "cuda" else "float32",
            tensor_parallel=tp), device=device)
        if eng.is_follower:
            eng.follow()
            return 0
        cal = calibrate_serve_planner(model_cfg, hw_cfg, eng)
        eng.stop_followers()
        path = save_serve_calibration(cal)
        print(json.dumps({"saved": path, **cal}, indent=2))
        return 0

    planner = ServePlanner(model_cfg, hw_cfg)
    if args.batch is not None or args.quant is not None \
            or args.kv_quant is not None:
        est = planner.estimate(
            batch=args.batch or 8, context_len=args.context_len,
            prompt_len=args.prompt_len, page_size=args.page_size,
            quant=args.quant or "none", kv_quant=args.kv_quant or "none",
            tensor_parallel=args.tensor_parallel)
        print(json.dumps(est.to_dict(), indent=2))
        return 0
    rows = planner.sweep(context_len=args.context_len,
                         prompt_len=args.prompt_len,
                         page_size=args.page_size,
                         tensor_parallel=args.tensor_parallel)
    print(json.dumps(rows[:args.candidates], indent=2))
    return 0
