"""`llmctl-torch replay` — deterministic re-execution of a recorded run
(the JAX package's ``replay run``).

The run manifest (``run_manifest.json``, written by ``TrainingEngine`` at
the end of every run) pins the config and the seeds; ``run`` re-executes
the training from scratch into a temporary checkpoint directory, with
the profiler off (a profiled run's trace directory is left as it was),
and holds
the final loss to the recorded one within ``--tolerance`` (relative),
exiting 1 on a mismatch. ``--steps N`` below the recorded end replays only
N steps and compares nothing. The global ``--device`` goes to the trainer.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
from pathlib import Path

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Deterministic "
                                                        "replay.")
    sub = ap.add_subparsers(dest="sub", metavar="{run}")
    ru = sub.add_parser("run", help="Re-run the training recorded in "
                                    "MANIFEST and verify the loss.")
    ru.add_argument("manifest", help="a run_manifest.json or the "
                                     "checkpoint dir containing one")
    ru.add_argument("--tolerance", default=1e-4, type=float,
                    help="Allowed relative loss deviation (bitwise runs "
                         "give 0).")
    ru.add_argument("--steps", default=None, type=int,
                    help="Replay only the first N steps (faster spot "
                         "check; skips the final-loss comparison).")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch replay").print_help()
        return 0
    return replay(args.manifest, args.tolerance, args.steps,
                  args.root.device)


def replay(manifest: str, tolerance: float, steps, device: str) -> int:
    """Re-run the recorded training and verify the final loss; returns 0
    on a match (or a partial replay), 1 on a mismatch."""
    from ...config.schema import RunConfig
    from ...runtime.engine import TrainingEngine

    mpath = Path(manifest)
    if mpath.is_dir():
        mpath = mpath / "run_manifest.json"
    if not mpath.exists():
        raise CommandError(f"no run manifest at {mpath}")
    m = json.loads(mpath.read_text())

    cfg = RunConfig.from_dict(m["config"])
    max_steps = steps if steps is not None else m["end_step"]
    partial = steps is not None and steps < m["end_step"]
    with tempfile.TemporaryDirectory(prefix="llmctl-replay-") as tmp:
        cfg.checkpoint.path = tmp      # never clobber the original run
        cfg.training.profile = False   # nor write into its trace directory
        cfg.training.max_steps = max_steps
        print(f"replaying run {m['run_id']}: {max_steps} steps, "
              f"seed {m['seed']}")
        engine = TrainingEngine(cfg, device=device)
        try:
            final = engine.train(resume=False)
        finally:
            engine.close()

    if partial:
        print(f"partial replay done: loss {final['loss']:.6f} at step "
              f"{max_steps} (no recorded value to compare)")
        return 0
    recorded = m["final_metrics"].get("loss")
    if recorded is None:
        raise CommandError("manifest has no recorded final loss")
    got = final["loss"]
    rel = (abs(got - recorded) / abs(recorded)) if recorded else abs(got)
    ok = math.isfinite(got) and rel <= tolerance
    print(f"recorded loss {recorded:.6f} | replayed {got:.6f} | "
          f"rel diff {rel:.2e} -> {'MATCH' if ok else 'MISMATCH'}")
    return 0 if ok else 1
