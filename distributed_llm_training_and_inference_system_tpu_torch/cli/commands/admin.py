"""`llmctl-torch admin` — checkpoint GC, tensor inspection, dataset
indexing and static checks (the JAX package's ``admin gc`` / ``inspect``
/ ``index`` / ``lint``).

``inspect`` reads the port's checkpoints (``state.pt``) and the JAX
package's (``host_*.npz`` through ``io/checkpoint.read_jax_checkpoint``),
and lists a JAX checkpoint's leaves by the JAX command's flattened paths,
shapes, dtypes and bytes. ``index`` writes the JAX command's JSON.
``lint`` runs graftlint (``analysis/``) over the port's own tree: the AST
checks of the thread-context, lock-discipline, counter-wiring,
config-wiring and np-jnp-parity contracts, with the JAX command's flags,
text lines and JSON report; it exits 1 on an unsuppressed finding.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..main import CommandError

def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog,
                                 description="Maintenance utilities.")
    sub = ap.add_subparsers(dest="sub", metavar="{gc,inspect,index,lint}")
    li = sub.add_parser("lint", help="Run graftlint: the AST invariant "
                                     "checker for the serve fleet's "
                                     "concurrency, wiring, and parity "
                                     "contracts.")
    li.add_argument("--format", dest="fmt", default="text",
                    choices=["text", "json"],
                    help="Diagnostic output format.")
    li.add_argument("--rules", default="",
                    help="Comma-separated pass ids to run (default: all of "
                         "thread-context, lock-discipline, counter-wiring, "
                         "config-wiring, np-jnp-parity).")
    li.add_argument("--baseline", dest="baseline_path", default=None,
                    help="Baseline file of grandfathered findings "
                         "[default: analysis/baseline.json].")
    li.add_argument("--write-baseline", action="store_true", default=False,
                    help="Grandfather every currently-unsuppressed finding "
                         "into the baseline file and exit 0.")
    li.add_argument("--all", dest="show_all", action="store_true",
                    default=False,
                    help="List suppressed/baselined findings too (text "
                         "format; json always carries everything).")
    gc = sub.add_parser("gc", help="Garbage-collect old checkpoints, "
                                   "keeping the newest N.")
    gc.add_argument("--ckpt", dest="ckpt_dir", required=True)
    gc.add_argument("--keep-latest", default=5, type=int)
    gc.add_argument("--dry-run", action="store_true", default=False)
    ins = sub.add_parser("inspect", help="List tensors in a checkpoint: "
                                         "path, shape, dtype, bytes.")
    ins.add_argument("--ckpt", dest="ckpt_dir", required=True)
    ins.add_argument("--step", default=None, type=int)
    ins.add_argument("--limit", default=40, type=int,
                     help="Max tensors to list.")
    ix = sub.add_parser("index", help="Index tokenized dataset shards: "
                                      "docs, tokens, bytes per shard.")
    ix.add_argument("--data", dest="data_dir", required=True)
    ix.add_argument("--out", dest="out_path", default=None)
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch admin").print_help()
        return 0
    if args.sub == "lint":
        return lint(args.fmt, args.rules, args.baseline_path,
                    args.write_baseline, args.show_all)
    if args.sub == "gc":
        return gc(args.ckpt_dir, args.keep_latest, args.dry_run)
    if args.sub == "inspect":
        return inspect(args.ckpt_dir, args.step, args.limit)
    return index(args.data_dir, args.out_path)


def lint(fmt: str, rules: str, baseline_path, write_baseline: bool,
         show_all: bool) -> int:
    """graftlint over the port's tree; 1 on unsuppressed findings. Suppress
    one with ``# graftlint: ignore[rule-id]`` on the offending line, or
    grandfather a deliberate one in the baseline with a note."""
    from ...analysis import run_lint, write_baseline as _wb

    rule_list = [r.strip() for r in rules.split(",") if r.strip()] or None
    try:
        result = run_lint(rules=rule_list, baseline_path=baseline_path)
    except ValueError as e:
        raise CommandError(str(e))
    if write_baseline:
        path = _wb(result.findings, path=baseline_path)
        print(f"baseline updated: {path} "
              f"({len(result.unsuppressed)} finding(s) grandfathered)")
        return 0
    if fmt == "json":
        print(json.dumps(result.to_dict(), indent=2))
    else:
        shown = result.findings if show_all else result.unsuppressed
        for f in sorted(shown, key=lambda x: (x.rule, x.file, x.line)):
            tag = ("suppressed" if f.suppressed
                   else "baselined" if f.baselined else "FAIL")
            print(f"[{f.rule}] {f.file}:{f.line} {tag}: {f.message}")
        print(f"graftlint: {len(result.findings)} finding(s), "
              f"{len(result.unsuppressed)} unsuppressed across "
              f"{len(result.rules_run)} pass(es)")
    return 0 if result.ok else 1


def _ckpt_dir(path: str) -> Path:
    p = Path(path)
    if not p.is_dir():
        raise CommandError(f"no checkpoint directory {path}")
    return p


def gc(ckpt_dir: str, keep_latest: int, dry_run: bool) -> int:
    """Garbage-collect old checkpoints, keeping the newest N."""
    from ...io.checkpoint import CheckpointManager

    ckpt = CheckpointManager(_ckpt_dir(ckpt_dir), keep_latest=keep_latest)
    steps = ckpt.all_steps()
    doomed = steps[:-keep_latest] if len(steps) > keep_latest else []
    if not doomed:
        print(f"nothing to collect ({len(steps)} checkpoints <= "
              f"keep_latest {keep_latest})")
        return 0
    if dry_run:
        print(f"would remove steps: {doomed}")
        return 0
    ckpt._gc()
    print(f"removed steps: {doomed}; kept {ckpt.all_steps()}")
    return 0


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted path, leaf) pairs of a nested dict/list, keys sorted at
    every level as JAX's tree flattening orders a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += flatten_with_paths(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def _leaf_info(leaf) -> tuple[tuple, str, int, int]:
    """(shape, dtype name, bytes, values) of a tensor or a Python
    number (a number is a 0-d int64/float64 leaf, as numpy holds it)."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(leaf)
    return (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."),
            leaf.numel() * leaf.element_size(), leaf.numel())


def inspect(ckpt_dir: str, step, limit: int) -> int:
    """List tensors in a checkpoint: path, shape, dtype, bytes."""
    from ...io.checkpoint import CheckpointManager

    ckpt = CheckpointManager(_ckpt_dir(ckpt_dir))
    if ckpt.latest_step() is None:
        raise CommandError(f"no checkpoints under {ckpt_dir}")
    state, extra = ckpt.restore(step=step)
    flat = flatten_with_paths(state)
    total_bytes = 0
    total_params = 0
    for i, (path, leaf) in enumerate(flat):
        shape, dtype, nbytes, size = _leaf_info(leaf)
        total_bytes += nbytes
        total_params += size
        if i < limit:
            print(f"  {path}  {shape}  {dtype}  {nbytes / 1e6:.2f} MB")
    if len(flat) > limit:
        print(f"  ... {len(flat) - limit} more tensors")
    print(f"step {step or ckpt.latest_step()}: {len(flat)} tensors, "
          f"{total_params / 1e6:.1f}M values, {total_bytes / 1e9:.2f} GB")
    if extra:
        print(f"extra keys: {sorted(extra)}")
    return 0


def index(data_dir: str, out_path) -> int:
    """Index tokenized dataset shards: docs, tokens, bytes per shard."""
    from ...io.data import _discover_shards

    if not Path(data_dir).is_dir():
        raise CommandError(f"no data directory {data_dir}")
    shards = _discover_shards(data_dir)
    if not shards:
        raise CommandError(f"no token shards under {data_dir}")
    rows = []
    for s in shards:
        rows.append({
            "path": str(s.path),
            "num_documents": int(len(s.doc_bounds) - 1),
            "num_tokens": int(s.num_tokens),
            "dtype": str(s.dtype),
            "bytes": Path(s.path).stat().st_size,
        })
        print(f"  {Path(s.path).name}: {rows[-1]['num_documents']} docs, "
              f"{rows[-1]['num_tokens']} tokens")
    summary = {
        "shards": rows,
        "total_documents": sum(r["num_documents"] for r in rows),
        "total_tokens": sum(r["num_tokens"] for r in rows),
    }
    print(f"total: {summary['total_documents']} docs, "
          f"{summary['total_tokens']} tokens in {len(rows)} shards")
    if out_path:
        Path(out_path).write_text(json.dumps(summary, indent=2))
        print(f"index written to {out_path}")
    return 0
