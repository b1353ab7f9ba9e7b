"""`llmctl-torch trace` — profiler trace capture and inspection (the JAX
package's ``trace capture`` / ``trace summarize``).

``capture`` runs real training steps with ``training.profile`` on, so the
``TrainingEngine`` records them with ``torch.profiler`` (CPU and CUDA
activity) and writes a Chrome trace into ``--out``; ``summarize``
inventories a capture directory. The global ``--device`` goes to the
trainer.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Profiler traces.")
    sub = ap.add_subparsers(dest="sub", metavar="{capture,summarize}")
    ca = sub.add_parser("capture", help="Capture a profiler trace of real "
                                        "training steps.")
    ca.add_argument("--config", dest="config_file", default=None)
    ca.add_argument("--model", dest="model_name", default=None,
                    help="Model template (when no --config).")
    ca.add_argument("--steps", default=5, type=int)
    ca.add_argument("--out", dest="out_dir", default="traces")
    su = sub.add_parser("summarize", help="Inventory a captured trace "
                                          "directory.")
    su.add_argument("trace_dir")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch trace").print_help()
        return 0
    if args.sub == "capture":
        return capture(args.config_file, args.model_name, args.steps,
                       args.out_dir, args.root.device)
    return summarize(args.trace_dir)


def capture(config_file, model_name, steps: int, out_dir: str,
            device: str) -> int:
    """Capture a profiler trace of real training steps."""
    from ...config.loader import load_run_config
    from ...config.presets import get_model_config
    from ...metrics.observability import engine_observer
    from ...runtime.engine import TrainingEngine

    if config_file and not Path(config_file).is_file():
        raise CommandError(f"no config file {config_file}")
    overrides = {"training": {"max_steps": steps, "profile": True,
                              "profile_dir": out_dir,
                              "log_interval": max(steps // 2, 1)},
                 "checkpoint": {"interval_steps": 10_000_000}}
    cfg = load_run_config(config_file, cli_overrides=overrides)
    if model_name:
        cfg.model = get_model_config(model_name)
    engine = TrainingEngine(cfg, device=device, observer=engine_observer())
    try:
        final = engine.train(resume=False)
    finally:
        engine.close()
    print(f"captured {steps} steps (final loss "
          f"{final.get('loss', float('nan')):.4f}) into {out_dir}")
    print(f"open with: Perfetto (ui.perfetto.dev) or chrome://tracing "
          f"(load {engine.profile_trace.name})")
    return 0


def summarize(trace_dir: str) -> int:
    """Inventory a captured trace directory."""
    root = Path(trace_dir)
    if not root.is_dir():
        raise CommandError(f"no trace directory {trace_dir}")
    files = sorted(root.rglob("*"), key=lambda p: str(p))
    n_files = 0
    total = 0
    for f in files:
        if f.is_file():
            n_files += 1
            size = f.stat().st_size
            total += size
            print(f"  {f.relative_to(root)}  ({size / 1e3:.1f} kB)")
    if n_files == 0:
        raise CommandError(f"no trace files under {trace_dir}")
    print(f"{n_files} files, {total / 1e6:.2f} MB total")
    chrome = [f for f in files if f.name.endswith((".json", ".json.gz"))]
    if chrome:
        print("Chrome traces present: load in Perfetto or chrome://tracing "
              "for op- and kernel-level timing")
    return 0
