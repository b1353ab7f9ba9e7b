"""Training entry point (the JAX package's ``runtime/train_entry.py``):

    python -m distributed_llm_training_and_inference_system_tpu_torch.\\
runtime.train_entry --model gpt-1b --max-steps 8

Config precedence is file < env (LLMCTL_*) < CLI flags. Trains on the card
(``--device cpu`` runs the plain path on the CPU), with train steps and
evals fed to ``metrics.observability.engine_observer()`` (a scrape endpoint
when ``LLMCTL_METRICS_PORT`` is set). Launched as one rank of a mesh
(``runtime/launcher.py`` sets ``RANK``/``WORLD_SIZE``...), it trains that
rank's shards. On a card each process ends by printing its training
kernels' launches and its peak ``torch.cuda.max_memory_allocated`` to
stderr (``LLMCTL_TRAIN_LAUNCHES {json}``). Multi-host training waits for
ROADMAP queue 1 item 7b, step 6.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_overrides(pairs: list[str]) -> dict:
    """--set section.field=value overrides."""
    from ..config.loader import _coerce
    out: dict = {}
    for p in pairs:
        key, _, val = p.partition("=")
        section, _, field_ = key.partition(".")
        out.setdefault(section, {})[field_] = _coerce(val)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser("llmctl-train-entry")
    ap.add_argument("--config", default=None, help="run config TOML/JSON")
    ap.add_argument("--model", default=None, help="model template name")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=V",
                    help="config override, repeatable")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("LLMCTL_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..config.loader import load_run_config
    from ..config.presets import get_model_config
    from ..metrics.observability import engine_observer
    from .engine import TrainingEngine
    overrides = parse_overrides(args.set)
    if args.max_steps is not None:
        overrides.setdefault("training", {})["max_steps"] = args.max_steps
    cfg = load_run_config(args.config, cli_overrides=overrides)
    if args.model:
        cfg.model = get_model_config(args.model)
    engine = TrainingEngine(cfg, device=args.device,
                            observer=engine_observer())
    try:
        final = engine.train(resume=not args.no_resume)
        if engine.device.type == "cuda":
            import torch
            # one write of the whole line: the ranks share the stream
            sys.stderr.write("LLMCTL_TRAIN_LAUNCHES " + json.dumps(dict(
                kernel_launches(), rank=engine.rank,
                max_memory_allocated=torch.cuda.max_memory_allocated(
                    engine.device))) + "\n")
            sys.stderr.flush()
    finally:
        engine.close()
    if engine.rank == 0:
        logging.getLogger("llmctl.train").info("finished: %s", final)
    return 0


def kernel_launches() -> dict:
    """This process's launches of the training kernels (the flash forward
    and backward pair, AdamW and the leaves it updated)."""
    from ..ops import adamw_cuda, attention_cuda
    return {"flash_fwd": attention_cuda.flash_fwd.launches,
            "flash_bwd_dq": attention_cuda.flash_bwd_dq.launches,
            "flash_bwd_dkv": attention_cuda.flash_bwd_dkv.launches,
            "adamw": adamw_cuda.adamw_kernel.launches,
            "adamw_leaves": adamw_cuda.adamw_kernel.leaves}


if __name__ == "__main__":
    sys.exit(main())
