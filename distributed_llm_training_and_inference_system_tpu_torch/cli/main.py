"""llmctl-torch — the port's command line (the JAX package's ``llmctl``),
on ``argparse``.

    llmctl-torch [global options] <command> <subcommand> [options]
    python -m distributed_llm_training_and_inference_system_tpu_torch.cli ...

Global options keep the JAX CLI's names and defaults (``--backend``,
``--launcher``, ``--nodes``, ``--chips-per-node``, ``--mixed-precision``,
``--seed``, ``--deterministic``, ``--log-level``, ``--otlp-endpoint``); in
place of its ``--platform``/``--fake-devices`` there is ``--device
cuda|cpu`` (default ``cuda``: every command that touches a device raises
without a card unless given ``--device cpu``). A multi-host or multi-GPU
value (``--nodes > 1``, ``--chips-per-node > 1``, a cluster launcher)
raises naming ROADMAP queue 1 item 7b.

Each command's module is imported only when it runs, so ``--help`` stays
fast. Every command of the JAX CLI is ported; what still waits for a
ROADMAP item (the multi-host options above, cluster launchers) exits 2
with a message naming it.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys

from .. import __version__

PROG = "llmctl-torch"

# command -> (module under .commands, one-line summary)
COMMANDS = {
    "init": ("init", "Project scaffolding."),
    "hw": ("hw", "Hardware probing and benchmarking."),
    "train": ("train", "Training workflows."),
    "eval": ("eval_cmd", "Evaluation suites."),
    "export": ("export", "Model export and conversion."),
    "serve": ("serve", "Inference serving."),
    "health": ("health", "System health."),
    "bench": ("bench", "Benchmarks (kernels, end-to-end, dataloader)."),
    "trace": ("trace", "Profiler traces."),
    "replay": ("replay", "Deterministic replay."),
    "tune": ("tune", "Autotuning."),
    "admin": ("admin", "Maintenance utilities."),
    "fleet": ("fleet", "Serve-fleet operations, workers and fronts."),
    "plan": ("plan", "Parallelism planning."),
}

MULTI_HOST = "ROADMAP queue 1 item 7b"


class CommandError(Exception):
    """A user error a command reports as ``Error: ...`` with exit code 1."""


def _epilog() -> str:
    lines = ["commands:"]
    lines += [f"  {name:<8} {summary}"
              for name, (_, summary) in COMMANDS.items()]
    return "\n".join(lines)


def root_parser() -> argparse.ArgumentParser:
    """The global options, the command and the rest of the line."""
    ap = argparse.ArgumentParser(
        prog=PROG, epilog=_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="llmctl-torch — distributed LLM training and inference "
                    "control on NVIDIA GPUs (PyTorch/CUDA).")
    ap.add_argument("--version", action="version",
                    version=f"{PROG}, version {__version__}")
    ap.add_argument("--backend", default="xla",
                    help="Communication backend (one card: unused).")
    ap.add_argument("--launcher", default="local",
                    choices=["local", "slurm", "mpi", "k8s", "gke"],
                    help="Multi-host launcher (only local is ported).")
    ap.add_argument("--nodes", default=1, type=int, help="Number of hosts.")
    ap.add_argument("--chips-per-node", "--gpus-per-node",
                    dest="chips_per_node", default=None, type=int,
                    help="Cards per host (one is ported).")
    ap.add_argument("--mixed-precision", default="bf16",
                    choices=["bf16", "fp32", "no"])
    ap.add_argument("--seed", default=42, type=int)
    ap.add_argument("--deterministic", action="store_true", default=False,
                    help="Reproducible mode (fixed seeds, cuBLAS workspace "
                         "config; see runtime/launcher.py).")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--otlp-endpoint", default=None,
                    help="OTLP collector endpoint (needs opentelemetry).")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Where commands run: the card (default; raises "
                         "without one) or the CPU.")
    ap.add_argument("command", nargs="?", help="the command to run")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="its subcommand and options")
    return ap


def _check_single_host(root: argparse.Namespace) -> None:
    if root.nodes > 1 or root.launcher != "local" or (
            root.chips_per_node or 1) > 1:
        raise NotImplementedError(
            f"--nodes {root.nodes} --launcher {root.launcher} "
            f"--chips-per-node {root.chips_per_node}: multi-host and "
            f"multi-GPU runs are not ported to the PyTorch package yet "
            f"({MULTI_HOST})")


def command_module(name: str):
    return importlib.import_module(f".commands.{COMMANDS[name][0]}",
                                   package=__package__)


def parse(argv: list[str]) -> argparse.Namespace:
    """The namespace of one command line: the command's own options, with
    the global options under ``.root`` and the command under
    ``.command``. Raises NotImplementedError (naming the ROADMAP item) for
    what is not ported: a multi-host global option, an option a command's
    ``refuse_unknown`` names."""
    root = root_parser().parse_args(argv)
    if root.command is None:
        raise CommandError("no command given (see --help)")
    if root.command not in COMMANDS:
        raise CommandError(f"no such command {root.command!r} (see --help)")
    _check_single_host(root)
    mod = command_module(root.command)
    parser = mod.build_parser(f"{PROG} {root.command}")
    args, unknown = parser.parse_known_args(root.args)
    if unknown:
        refuse = getattr(mod, "refuse_unknown", None)
        if refuse is not None:
            refuse(unknown)      # raises for what waits on a ROADMAP item
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    args.root = root
    args.argv = list(argv)
    args.command = root.command
    args.module = mod
    return args


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        root_parser().print_help()
        return 0
    try:
        args = parse(argv)
        logging.basicConfig(
            level=args.root.log_level.upper(),
            format="%(asctime)s %(name)s %(levelname)s %(message)s")
        return int(args.module.run(args) or 0)
    except CommandError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except NotImplementedError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
