"""`llmctl-torch tune` — autotuning (the JAX package's ``tune``).

- ``kernels`` grid-searches the matmul and attention spaces of
  ``plugins/autotuning.py`` on the global ``--device`` and writes
  ``<output-dir>/tuning_cache.json`` in the JAX command's JSON.
- ``comms`` tunes collective dispatch (``CollectiveTuner``) over
  ``--devices`` ranks, children of this command line
  (``runtime.launcher.launch_ranks``; ranks that share a card move their
  collectives over gloo, through host memory: the report says so).
- ``sp`` measures ring against Ulysses attention per device on the card,
  through the flash kernels, at the two schemes' shapes (a ring step: the
  local S/sp queries against one S/sp key chunk, unmasked, times sp;
  Ulysses: the whole sequence, causal, over heads/sp) and saves the
  per-scheme efficiencies ``parallel.planner.choose_sp_scheme`` reads. It
  refuses the CPU: efficiencies are taken against the card's peak.
- ``full`` runs the matmul, attention and (on two cards or more)
  collective tuners and writes a summary.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Autotuning.")
    sub = ap.add_subparsers(dest="sub", metavar="{kernels,comms,sp,full}")
    ke = sub.add_parser("kernels", help="Tune matmul + attention kernels.")
    ke.add_argument("--matmul-size", nargs=3, type=int,
                    default=(1024, 1024, 1024), metavar=("M", "K", "N"),
                    help="M K N.")
    ke.add_argument("--seq-len", default=512, type=int)
    ke.add_argument("--head-dim", default=64, type=int)
    ke.add_argument("--heads", default=8, type=int)
    ke.add_argument("--batch", default=8, type=int)
    ke.add_argument("--max-iterations", default=32, type=int)
    ke.add_argument("--timeout", default=120.0, type=float)
    ke.add_argument("--trials", default=5, type=int)
    ke.add_argument("--output-dir", default="tuning_results")
    co = sub.add_parser("comms", help="Tune collective dispatch over the "
                                      "live mesh.")
    co.add_argument("--size-mb", default=8.0, type=float)
    co.add_argument("--devices", dest="n_devices", default=None, type=int)
    co.add_argument("--max-iterations", default=32, type=int)
    co.add_argument("--timeout", default=120.0, type=float)
    co.add_argument("--trials", default=5, type=int)
    co.add_argument("--output-dir", default="tuning_results")
    sp = sub.add_parser("sp", help="Measure ring-vs-Ulysses per-device "
                                   "attention cost and save the planner's "
                                   "calibration.")
    sp.add_argument("--seq-lens", default="8192,16384")
    sp.add_argument("--sp", default=8, type=int)
    sp.add_argument("--heads", default=16, type=int)
    sp.add_argument("--head-dim", default=128, type=int)
    sp.add_argument("--repeats", default=8, type=int)
    sp.add_argument("--save", dest="save_calib",
                    action=argparse.BooleanOptionalAction, default=True)
    fu = sub.add_parser("full", help="Tune everything and write a "
                                     "summary.")
    fu.add_argument("--output-dir", default="tuning_results")
    fu.add_argument("--max-iterations", default=32, type=int)
    fu.add_argument("--timeout", default=300.0, type=float)
    fu.add_argument("--trials", default=5, type=int)
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch tune").print_help()
        return 0
    return {"kernels": kernels, "comms": comms, "sp": sp,
            "full": full}[args.sub](args)


def _report(name, res) -> None:
    print(f"{name}: best={res.best_params} "
          f"latency={res.best_latency_ms:.3f} ms "
          f"(+{res.improvement_pct:.1f}% vs first config, "
          f"{res.num_evaluated} evaluated)")


def _tuner(args, timeout: float):
    from ...plugins.autotuning import AutoTuner, TuningConfig
    return AutoTuner(TuningConfig(max_iterations=args.max_iterations,
                                  timeout_seconds=timeout,
                                  num_trials=args.trials),
                     device=args.root.device)


def _where(mesh) -> str:
    return (f"backend {mesh.backend}"
            + (", host-staged" if mesh.backend == "gloo" else ""))


def comms(args) -> int:
    """Tune collective dispatch over the live mesh (measured)."""
    from ...runtime.launcher import launch_ranks, this_rank
    from .bench import comm_ranks, rank_mesh

    n = comm_ranks(args)
    if this_rank() is None:
        return launch_ranks(args.argv, n)
    mesh = rank_mesh(args, n)
    tuner = _tuner(args, args.timeout)
    res = tuner.tune_collective(mesh, "dp", args.size_mb)
    if mesh.rank == 0:
        _report(f"collective ({n} ranks, {_where(mesh)})", res)
        out = Path(args.output_dir) / "tuning_cache.json"
        tuner.save_results(out)
        print(f"results cached to {out}")
    return 0


def sp_timer(device, repeats: int):
    """(causal, q, k) -> ms of one flash-attention call on ``device``:
    ``repeats`` kernels a call, each output the next query, so they run
    serialised on the device and the figure is the kernels' time."""
    import torch

    from ...ops.attention import flash_attention
    from ...utils.timing import time_fn

    def timed(causal, q, k):
        def chained(q_, k_):
            for _ in range(repeats):
                q_ = flash_attention(q_, k_, k_, causal=causal)
            return q_
        with torch.inference_mode():
            return time_fn(chained, q, k, warmup=1, iters=4, windows=2,
                           device=device) / repeats * 1e3
    return timed


def sp_rows(seq_lens: list, sp: int, heads: int, head_dim: int, device,
            timer) -> list:
    """The probe's rows: per sequence length, the per-device attention ms
    of a ring step (the local S/sp queries against one S/sp key chunk,
    unmasked) times sp, and of Ulysses (the whole sequence over heads/sp,
    causal), bf16."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)
    rows = []
    for s in seq_lens:
        ring_step = timer(False, rand(1, s // sp, heads, head_dim),
                          rand(1, s // sp, heads, head_dim))
        uly = timer(True, rand(1, s, heads // sp, head_dim),
                    rand(1, s, heads // sp, head_dim))
        rows.append({"S": s,
                     "ring_compute_ms_per_device": round(ring_step * sp, 3),
                     "ulysses_compute_ms_per_device": round(uly, 3)})
        print(json.dumps(rows[-1]))
    return rows


def sp_calibrate(rows: list, hw, args) -> dict:
    """The per-scheme efficiencies of ``rows``, saved (``--save``) where
    ``parallel.planner.choose_sp_scheme`` reads them, with the choice they
    make for gpt-7b."""
    from ...config.presets import get_model_config
    from ...parallel.planner import (calibrate_sp_schemes, choose_sp_scheme,
                                     save_sp_calibration)
    calib = calibrate_sp_schemes(rows, hw, num_heads=args.heads,
                                 head_dim=args.head_dim, sp=args.sp)
    print(json.dumps(calib))
    if args.save_calib:
        path = save_sp_calibration(calib)
        print(f"sp calibration saved to {path}")
        m = get_model_config("gpt-7b")
        for s in (8192, 16384, 32768):
            scheme, costs = choose_sp_scheme(m, args.sp, s, hw=hw,
                                             calibration=calib)
            print(f"gpt-7b S={s} sp={args.sp}: {scheme} "
                  f"(ring {costs['ring_ms']:.0f} ms vs ulysses "
                  f"{costs['ulysses_ms']:.0f} ms)")
    return calib


def sp(args) -> int:
    """Measure ring-vs-Ulysses per-device attention cost on the card and
    save the per-scheme efficiencies the planner's choice uses."""
    import torch

    from ...config.presets import get_hardware_preset
    from ...device import resolve_device

    device = resolve_device(args.root.device)
    if device.type != "cuda":
        raise CommandError(
            "refusing to calibrate SP schemes on the CPU — efficiencies are "
            "measured against the card's peak and a CPU run would poison "
            "every future scheme choice")
    seq_lens = [int(x) for x in args.seq_lens.split(",")]
    if args.sp < 2 or args.heads % args.sp or any(
            s % args.sp for s in seq_lens):
        raise CommandError(
            f"probe needs sp >= 2, heads ({args.heads}) % sp == 0 and every "
            f"seq len % sp == 0 — got sp={args.sp}, seq_lens={args.seq_lens}")
    # the peak of the ATTACHED card: efficiencies divided by another's
    # would poison every future choice
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        raise CommandError(f"no hardware preset for card {name!r} — add its "
                           "peak to config/presets.py HARDWARE_PRESETS "
                           "before calibrating")
    rows = sp_rows(seq_lens, args.sp, args.heads, args.head_dim, device,
                   sp_timer(device, args.repeats))
    sp_calibrate(rows, get_hardware_preset("h100-1"), args)
    return 0


def full(args) -> int:
    """Tune everything and write a summary: the matmul and attention
    tuners, then the collective tuner over every card when there are two
    or more (this process rank 0, its children through ``LocalLauncher``
    the others, each running only the collective part)."""
    import torch

    from ...device import resolve_device
    from ...runtime.launcher import lead_ranks, this_rank
    from .bench import rank_mesh

    device = resolve_device(args.root.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    tuner = _tuner(args, args.timeout / 3)
    if this_rank() is not None:
        tuner.tune_collective(rank_mesh(args, cards), "dp", 8.0)
        return 0
    summary = {}
    r = tuner.tune_matmul(1024, 1024, 1024)
    _report("matmul", r)
    summary["matmul"] = r.to_dict()
    r = tuner.tune_attention(512, 64, 8, 8)
    _report("attention", r)
    summary["attention"] = r.to_dict()
    if cards >= 2:
        ranks = lead_ranks(args.argv, cards)
        try:
            mesh = rank_mesh(args, cards)
            r = tuner.tune_collective(mesh, "dp", 8.0)
        finally:
            failed = ranks.wait()
        if failed:
            raise CommandError(f"a collective tuning rank exited {failed}")
        _report(f"collective ({cards} ranks, {_where(mesh)})", r)
        summary["collective"] = r.to_dict()
    else:
        print("collective: skipped (single device)")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "full_tuning_results.json").write_text(
        json.dumps(summary, indent=2))
    tuner.save_results(out_dir / "tuning_cache.json")
    print(f"summary written to {out_dir}/full_tuning_results.json")
    return 0


def kernels(args) -> int:
    """Tune matmul + attention; write the cache."""
    tuner = _tuner(args, args.timeout)
    m, k, n = args.matmul_size
    _report("matmul", tuner.tune_matmul(m, k, n))
    _report("attention", tuner.tune_attention(args.seq_len, args.head_dim,
                                              args.heads, args.batch))
    out = Path(args.output_dir) / "tuning_cache.json"
    tuner.save_results(out)
    print(f"results cached to {out}")
    return 0
