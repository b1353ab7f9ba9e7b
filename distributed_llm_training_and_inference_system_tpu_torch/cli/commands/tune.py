"""`llmctl-torch tune` — autotuning (the JAX package's ``tune kernels``).

``kernels`` grid-searches the matmul and attention spaces of
``plugins/autotuning.py`` on the global ``--device`` and writes
``<output-dir>/tuning_cache.json`` in the JAX command's JSON. ``comms``,
``sp`` and ``full`` tune collectives and sequence-parallel schemes over a
mesh of cards with the planner: they exit 2 naming ROADMAP queue 1 item 7b.
"""

from __future__ import annotations

import argparse
from pathlib import Path

MULTI_GPU = "ROADMAP queue 1 item 7b"


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
                                      f"mesh (not ported: {MULTI_GPU}).")
    co.add_argument("--size-mb", default=8.0, type=float)
    co.add_argument("--devices", dest="n_devices", default=None, type=int)
    co.add_argument("--max-iterations", default=32, type=int)
    co.add_argument("--timeout", default=120.0, type=float)
    co.add_argument("--trials", default=5, type=int)
    co.add_argument("--output-dir", default="tuning_results")
    sp = sub.add_parser("sp", help="Calibrate ring against Ulysses "
                                   f"attention (not ported: {MULTI_GPU}).")
    sp.add_argument("--seq-lens", default="8192,16384")
    sp.add_argument("--sp", default=8, type=int)
    sp.add_argument("--heads", default=16, type=int)
    sp.add_argument("--head-dim", default=128, type=int)
    sp.add_argument("--repeats", default=8, type=int)
    sp.add_argument("--save", dest="save_calib",
                    action=argparse.BooleanOptionalAction, default=True)
    fu = sub.add_parser("full", help="Tune everything and write a summary "
                                     f"(not ported: {MULTI_GPU}).")
    fu.add_argument("--output-dir", default="tuning_results")
    fu.add_argument("--max-iterations", default=32, type=int)
    fu.add_argument("--timeout", default=300.0, type=float)
    fu.add_argument("--trials", default=5, type=int)
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch tune").print_help()
        return 0
    if args.sub != "kernels":
        raise NotImplementedError(
            f"tune {args.sub} tunes over a mesh of cards with the planner; "
            f"multi-GPU is not ported to the PyTorch package yet "
            f"({MULTI_GPU})")
    return kernels(args)


def _report(name, res) -> None:
    print(f"{name}: best={res.best_params} "
          f"latency={res.best_latency_ms:.3f} ms "
          f"(+{res.improvement_pct:.1f}% vs first config, "
          f"{res.num_evaluated} evaluated)")


def kernels(args) -> int:
    """Tune matmul + attention; write the cache."""
    from ...plugins.autotuning import AutoTuner, TuningConfig

    tuner = AutoTuner(TuningConfig(max_iterations=args.max_iterations,
                                   timeout_seconds=args.timeout,
                                   num_trials=args.trials),
                      device=args.root.device)
    m, k, n = args.matmul_size
    _report("matmul", tuner.tune_matmul(m, k, n))
    _report("attention", tuner.tune_attention(args.seq_len, args.head_dim,
                                              args.heads, args.batch))
    out = Path(args.output_dir) / "tuning_cache.json"
    tuner.save_results(out)
    print(f"results cached to {out}")
    return 0
