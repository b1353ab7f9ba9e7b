"""`llmctl-torch init` — scaffold a training project (the JAX package's
``init scaffold``).

Writes the JAX command's files for the same ``--model``, with the command
name ``llmctl-torch``; the run config's ``[hardware]`` section is the
port's ``HardwareConfig`` (one H100 SXM) under ``--hardware h100``. A TPU
preset name raises: TPU and multi-card hardware wait for ROADMAP queue 1
item 7b.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from ...config.presets import MODEL_TEMPLATES, get_model_config
from ...config.schema import HardwareConfig
from ...utils.tomlio import dump_toml
from ..main import PROG, CommandError

# the card the port's configs describe
HARDWARE = {"h100": HardwareConfig()}
# the JAX package's TPU presets
TPU_PRESETS = ("v5e-1", "v5e-4", "v5e-8", "v5e-64", "v5e-256", "v4-8",
               "v5p-8", "cpu-8")


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Project scaffolding.")
    sub = ap.add_subparsers(dest="sub", metavar="{scaffold}")
    sc = sub.add_parser("scaffold", help="Create project structure: configs, "
                                         "data dir, launch script.")
    sc.add_argument("--model", dest="model_name", default="gpt-7b",
                    choices=sorted(MODEL_TEMPLATES),
                    help="Model template to scaffold for.")
    sc.add_argument("--out", dest="out_dir", default=".",
                    help="Project directory to create files in.")
    sc.add_argument("--hardware", default="h100",
                    help=f"Hardware preset name ({', '.join(HARDWARE)}).")
    sc.add_argument("--force", action="store_true", default=False,
                    help="Overwrite existing files.")
    return ap


def run(args) -> int:
    if args.sub is None:      # `init` alone scaffolds with the defaults
        args = build_parser(f"{PROG} init").parse_args(["scaffold"])
    return scaffold(args.model_name, args.out_dir, args.hardware, args.force)


def hardware_section(name: str) -> dict:
    if name in TPU_PRESETS:
        raise NotImplementedError(
            f"hardware preset {name!r} is a TPU; the PyTorch package "
            "scaffolds for one H100 (TPU and multi-card presets: ROADMAP "
            "queue 1 item 7b)")
    if name not in HARDWARE:
        raise CommandError(f"unknown hardware preset {name!r}; available: "
                           f"{sorted(HARDWARE)}")
    return {"preset": name, **dataclasses.asdict(HARDWARE[name])}


def scaffold(model_name: str, out_dir: str, hardware: str,
             force: bool) -> int:
    """Create project structure: configs, data dir, launch script."""
    hw = hardware_section(hardware)
    root = Path(out_dir)
    cfg = get_model_config(model_name)

    for d in ("configs/models", "configs/presets", "configs/hw", "data",
              "checkpoints", "logs", "traces"):
        (root / d).mkdir(parents=True, exist_ok=True)

    def write(path: Path, text: str):
        if path.exists() and not force:
            print(f"  skip (exists): {path}")
            return
        path.write_text(text)
        print(f"  wrote: {path}")

    write(root / f"configs/models/{model_name}.json",
          json.dumps(cfg.to_dict(), indent=2) + "\n")

    # every key is consumed by config.schema.RunConfig
    run_cfg = {
        "model": cfg.to_dict(),
        "data": {
            "train": "data/train",
            "val": "data/val",
            "max_length": min(2048, cfg.max_position_embeddings),
            "pack_sequences": True,
        },
        "optimizer": {
            "lr": 3e-4, "weight_decay": 0.1, "warmup_steps": 2000,
            "grad_clip_norm": 1.0,
        },
        "parallel": {
            "strategy": "auto",
            "tensor_parallel": 1,
            "pipeline_parallel": 1,
            "sequence_parallel": 1,
            "zero_stage": 1,
            "activation_checkpoint": "selective",
            "micro_batch_size": 1,
            "global_batch_size": 32,
        },
        "training": {
            "max_steps": 10000, "eval_interval": 500, "save_interval": 1000,
            "log_interval": 10, "seed": 42, "mixed_precision": "bf16",
        },
        "checkpoint": {
            "path": "checkpoints", "interval_steps": 1000,
            "sharded": True, "async_save": True, "keep_latest": 5,
        },
        "hardware": hw,
    }
    write(root / f"configs/presets/{model_name}-{hardware}.toml",
          dump_toml(run_cfg))

    write(root / "configs/data.toml", dump_toml({
        "source": {"kind": "local", "path": "data/train",
                   "format": "token-shards"},
        "tokenization": {"tokenizer": "byte", "append_eos": True},
    }))

    write(root / "train.sh", (
        "#!/usr/bin/env bash\n"
        "set -euo pipefail\n"
        f"{PROG} train launch \\\n"
        f"  --config configs/presets/{model_name}-{hardware}.toml \\\n"
        f"  \"$@\"\n"))
    (root / "train.sh").chmod(0o755)

    write(root / "README.md", (
        f"# {model_name} training project\n\n"
        f"Generated by `{PROG} init scaffold`.\n\n"
        "## Quickstart\n\n"
        "```bash\n"
        f"{PROG} hw probe --emit configs/hw/local.toml\n"
        f"{PROG} plan compute --model configs/models/{model_name}.json "
        "--hardware configs/hw/local.toml --out configs/plan.toml\n"
        "./train.sh\n"
        "```\n"))

    params_b = cfg.param_count / 1e9
    print(f"Scaffolded {model_name} ({params_b:.2f}B params) in "
          f"{root.resolve()}")
    return 0
