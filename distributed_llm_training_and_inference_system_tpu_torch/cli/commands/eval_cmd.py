"""`llmctl-torch eval` — model evaluation (the JAX package's ``eval run``).

Loads a checkpoint (the port's or the JAX package's) onto the global
``--device`` and reports perplexity over a dataset (``exec.train_step.
make_eval_step`` over ``io.data.make_dataset``, plain attention as the JAX
command's), JSONL task files (``evals.tasks``) and the pattern-recall
selftest (a machinery probe, not a quality metric).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Evaluation suites.")
    sub = ap.add_subparsers(dest="sub", metavar="{run}")
    r = sub.add_parser("run", help="Evaluate a checkpoint.")
    r.add_argument("--ckpt", dest="ckpt_dir", default=None,
                   help="Checkpoint directory (omit for random init smoke "
                        "eval).")
    r.add_argument("--model", dest="model_name", default="gpt-test")
    r.add_argument("--data", dest="data_path", default="synthetic",
                   help="Eval dataset path (token shards) or 'synthetic'.")
    r.add_argument("--suite", default="perplexity",
                   choices=["perplexity", "tasks", "selftest", "all"])
    r.add_argument("--tasks", dest="task_files", action="append", default=[],
                   help="Task JSONL file(s) for --suite tasks (repeatable; "
                        "schema: evals/tasks.py).")
    r.add_argument("--batches", default=16, type=int)
    r.add_argument("--batch-size", default=8, type=int)
    r.add_argument("--seq-len", default=512, type=int)
    r.add_argument("--out", dest="out_path", default=None,
                   help="Write results JSON.")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch eval").print_help()
        return 0
    evaluate(args)
    return 0


def load_model(ckpt_dir, cfg, device):
    """(GPT on ``device``, effective config, step) of the latest checkpoint
    under ``ckpt_dir``, or random init from seed 0 (step None) when there
    is no directory."""
    from ...io.checkpoint import CheckpointManager, apply_ckpt_model_overrides
    from ...models import gpt
    from ...weights import checkpoint_tree, params_from_jax

    if ckpt_dir and Path(ckpt_dir).exists():
        step = CheckpointManager(ckpt_dir).latest_step()
        if step is None:
            raise CommandError(f"no checkpoints under {ckpt_dir}")
        tree, extra = checkpoint_tree(ckpt_dir, step)
        cfg = apply_ckpt_model_overrides(cfg, extra)
        return params_from_jax(tree, cfg, device=device), cfg, step
    gen = torch.Generator(device=device).manual_seed(0)
    return gpt.init(cfg, gen, device=device), cfg, None


def evaluate(args) -> dict:
    """The JAX command's results dict (and its printed lines)."""
    from ...config.presets import get_model_config
    from ...device import resolve_device
    from ...exec.train_step import make_eval_step
    from ...io.data import make_dataset
    from ...models import gpt

    device = resolve_device(args.root.device)
    cfg = get_model_config(args.model_name)
    seq_len = min(args.seq_len, cfg.max_position_embeddings)
    params, cfg, step = load_model(args.ckpt_dir, cfg, device)
    if step is None:
        print("no checkpoint given: evaluating random init (smoke mode)")
    else:
        print(f"loaded checkpoint step {step}")

    results: dict = {"model": args.model_name, "suite": args.suite}
    suite = args.suite

    if suite in ("perplexity", "all"):
        data = make_dataset(args.data_path, args.batch_size, seq_len,
                            cfg.vocab_size, seed=0)
        eval_step = make_eval_step(cfg)
        losses, counts = [], []
        for _ in range(args.batches):
            batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in next(data).items()}
            batch["tokens"] = batch["tokens"].long()
            out = eval_step(params, batch)
            losses.append(float(out["loss"]))
            counts.append(float(out["tokens"]))
        total = float(np.sum(counts))
        loss = float(np.sum([l * c for l, c in zip(losses, counts)])) \
            / max(total, 1)
        ppl = float(np.exp(min(loss, 30.0)))
        results["perplexity"] = {"loss": loss, "perplexity": ppl,
                                 "tokens": total}
        print(f"perplexity: loss={loss:.4f} ppl={ppl:.2f} "
              f"({total:.0f} tokens)")

    if suite in ("tasks", "all") and (args.task_files or suite == "tasks"):
        if not args.task_files:
            raise CommandError(
                "--suite tasks needs at least one --tasks file.jsonl "
                "(schema: evals/tasks.py docstring)")
        from ...evals import run_tasks
        from ...serve.tokenizer import load_tokenizer
        tok = load_tokenizer(args.ckpt_dir, cfg.vocab_size)
        results["tasks"] = [
            run_tasks(params, cfg, f, tokenizer=tok,
                      batch_size=args.batch_size)
            for f in args.task_files]
        for t in results["tasks"]:
            mc = t.get("multiple_choice", {})
            gm = t.get("greedy_match", {})
            print(
                f"{t['file']}: "
                + (f"mc acc={mc['acc']:.3f} acc_norm={mc['acc_norm']:.3f} "
                   f"(n={mc['examples']}) " if mc else "")
                + (f"greedy exact={gm['exact_match']:.3f} "
                   f"prefix={gm['prefix_match']:.3f} (n={gm['examples']})"
                   if gm else ""))

    if suite in ("selftest", "all"):
        # greedy next-token recall on repeated patterns: proves the
        # forward/argmax machinery runs, NOT a model-quality metric
        rng = np.random.default_rng(0)
        correct = total_probes = 0
        for _ in range(min(args.batches, 8)):
            pattern = rng.integers(1, cfg.vocab_size,
                                   size=4).astype(np.int32)
            prompt = np.tile(pattern, 8)[:-1]
            with torch.no_grad():
                logits = gpt.forward(
                    params, torch.from_numpy(prompt[None].astype(np.int64))
                    .to(device), cfg)
            pred = int(torch.argmax(logits[0, -1]))
            correct += int(pred == int(pattern[-1]))
            total_probes += 1
        results["selftest"] = {"pattern_recall_acc": correct / total_probes,
                               "probes": total_probes}
        print(f"pattern-recall selftest: {correct}/{total_probes}")

    if args.out_path:
        Path(args.out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out_path).write_text(json.dumps(results, indent=2))
        print(f"results written to {args.out_path}")
    return results
