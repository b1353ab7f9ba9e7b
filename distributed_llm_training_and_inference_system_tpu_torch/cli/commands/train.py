"""`llmctl-torch train` — launch training (the JAX package's ``train
launch`` / ``train status``).

``launch`` runs ``runtime/train_entry.py`` in this process (``--in-process``,
or a local one-host run without ``--dry-run``/``--restart-on-failure``, as
the JAX command does), else through ``runtime/launcher.py``'s local
launcher in a child process; ``--restart-on-failure N`` supervises the
child and relaunches it up to N times, each resuming from the latest
committed checkpoint. The global ``--device`` goes to the trainer. A
parallel config (``--set parallel.tensor_parallel=2`` and the like) always
goes through the launcher, which spawns one rank per device of the mesh
(gloo on the CPU with ``--device cpu``). Multi-host launchers and
``--nodes > 1`` raise (ROADMAP queue 1 item 7b).
"""

from __future__ import annotations

import argparse

from ...runtime.launcher import LaunchConfig, ProcessOrchestrator
from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Training workflows.")
    sub = ap.add_subparsers(dest="sub", metavar="{launch,status}")
    la = sub.add_parser("launch", help="Launch a training run.")
    la.add_argument("--config", dest="config_file", default=None,
                    help="Run config TOML/JSON (from `init scaffold`).")
    la.add_argument("--model", default=None,
                    help="Model template name (overrides config).")
    la.add_argument("--max-steps", default=None, type=int)
    la.add_argument("--launcher", default=None,
                    choices=["local", "slurm", "mpi", "k8s", "gke"],
                    help="Launcher (default: the global --launcher).")
    la.add_argument("--nodes", default=None, type=int,
                    help="Number of hosts.")
    la.add_argument("--in-process", action="store_true", default=False,
                    help="Run the engine in THIS process.")
    la.add_argument("--no-resume", action="store_true", default=False,
                    help="Ignore existing checkpoints.")
    la.add_argument("--restart-on-failure", default=0, type=int,
                    help="Supervise the job and relaunch up to N times on "
                         "non-zero exit, resuming from the latest "
                         "committed checkpoint.")
    la.add_argument("--dry-run", action="store_true", default=False,
                    help="Print the launch plan without starting.")
    la.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SEC.KEY=V", help="Config override, repeatable.")
    st = sub.add_parser("status", help="Show checkpoint/run status for a "
                                       "training config.")
    st.add_argument("--config", dest="config_file", required=True)
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch train").print_help()
        return 0
    if args.sub == "status":
        return status(args.config_file)
    return launch(args)


def entry_args(args, device: str) -> list[str]:
    """train_entry's command line for a launch, but its ``--config``."""
    out = []
    if args.model:
        out += ["--model", args.model]
    if args.max_steps is not None:
        out += ["--max-steps", str(args.max_steps)]
    if args.no_resume:
        out += ["--no-resume"]
    for ov in args.overrides:
        out += ["--set", ov]
    if device == "cpu":
        out += ["--device", "cpu"]
    return out


def _ranks(args) -> int:
    """The ranks the run's parallel config spans (config < env < --set)."""
    from ...config.loader import load_run_config
    from ...runtime.train_entry import parse_overrides
    cfg = load_run_config(args.config_file,
                          cli_overrides=parse_overrides(args.overrides))
    cfg.parallel.require_supported(cfg.model)
    return cfg.parallel.total_devices


def launch(args) -> int:
    """Launch a training run (local process); returns its exit code."""
    root = args.root
    launcher = args.launcher or root.launcher
    nodes = args.nodes or root.nodes
    if nodes > 1 or launcher != "local":
        raise NotImplementedError(
            f"--launcher {launcher} --nodes {nodes}: multi-host training is "
            "not ported to the PyTorch package yet (ROADMAP queue 1 item 7b)")
    if args.restart_on_failure and args.in_process:
        raise CommandError("--restart-on-failure needs the subprocess "
                           "launcher (drop --in-process)")
    if args.restart_on_failure and args.no_resume:
        raise CommandError(
            "--restart-on-failure recovers by RESUMING from the latest "
            "checkpoint; combining it with --no-resume would retrain from "
            "step 0 on every restart")
    procs = _ranks(args)
    if procs > 1 and args.in_process:
        raise CommandError(
            f"the parallel config trains on {procs} ranks, each a process of "
            "its own: drop --in-process")
    if procs == 1 and (args.in_process
                       or not (args.dry_run or args.restart_on_failure)):
        from ...runtime.train_entry import main as train_main
        config = ["--config", args.config_file] if args.config_file else []
        return train_main(config + entry_args(args, root.device))

    cfg = LaunchConfig(
        num_hosts=nodes, launcher=launcher, config_file=args.config_file,
        deterministic=root.deterministic,
        mixed_precision=root.mixed_precision, seed=root.seed,
        dry_run=args.dry_run, extra_args=entry_args(args, root.device),
        procs=procs)
    orch = ProcessOrchestrator(cfg)
    if args.dry_run:
        print(orch.launcher.describe())
        print("dry-run: nothing launched")
        return 0
    return orch.run_with_restarts(max_restarts=args.restart_on_failure)


def status(config_file: str) -> int:
    """Show checkpoint/run status for a training config."""
    from ...config.loader import load_run_config
    from ...io.checkpoint import CheckpointManager

    cfg = load_run_config(config_file)
    ckpt = CheckpointManager(cfg.checkpoint.path,
                             keep_latest=cfg.checkpoint.keep_latest)
    steps = ckpt.all_steps()
    if not steps:
        print("no checkpoints yet")
        return 0
    print(f"checkpoints at steps: {steps} (latest {steps[-1]} of "
          f"max {cfg.training.max_steps})")
    return 0
