"""Training launchers (the JAX package's ``runtime/launcher.py``) for one
host.

``LocalLauncher`` runs the port's ``runtime/train_entry.py`` (or another
``module``: ``serve start --tensor-parallel N`` starts its follower ranks
1..N-1 as ``cli`` children, rank 0 being the serving process itself) in a
child process and adds no ``XLA_FLAGS``. A parallel config (``procs > 1``: the
product of its degrees) gets one child per rank on this host, each told
its place by the environment ``torch.distributed`` reads (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``: a TCP rendezvous on a free local port); rank 0's output
is the job's, and a rank that fails stops the others. ``ProcessOrchestrator`` streams its
output, stops it, and with ``run_with_restarts`` relaunches a child that
failed (counted in ``restarts``); each relaunch resumes from the latest
committed checkpoint.

The child's environment carries the global options as config overrides
(``config.loader`` reads ``LLMCTL_<SECTION>__<FIELD>``):
``LLMCTL_TRAINING__SEED`` (the trainer's weight and data seed) and
``LLMCTL_TRAINING__MIXED_PRECISION``. ``deterministic=True`` also sets
``LLMCTL_TRAINING__DETERMINISTIC=true`` (recorded in the run manifest's
config), ``PYTHONHASHSEED`` to the seed and
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, the cuBLAS setting that makes its
matmuls reproducible run to run; the port's own kernels reduce in a fixed
order already. ``PYTHONPATH`` leads with the directory holding this
package, so the child runs the same copy of the port as the parent.

Multi-host jobs (``num_hosts > 1``) and the SLURM, MPI and k8s/GKE
launchers wait for ROADMAP queue 1 item 7b: they raise.
"""

from __future__ import annotations

import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

ENTRY = "distributed_llm_training_and_inference_system_tpu_torch.runtime.train_entry"
# the directory holding this package: the child imports the same copy
PACKAGE_ROOT = Path(__file__).resolve().parents[2]
_MULTI_HOST = "ROADMAP queue 1 item 7b"


@dataclass
class LaunchConfig:
    """What to launch where: the JAX package's fields but those only its
    cluster launchers read (item 7b). ``extra_args`` go to train_entry
    (``--device cpu`` among them for a CPU run); ``procs`` is the number of
    ranks on this host."""
    num_hosts: int = 1
    procs: int = 1
    launcher: str = "local"            # local | slurm | mpi | k8s | gke
    config_file: Optional[str] = None
    extra_args: list[str] = field(default_factory=list)
    deterministic: bool = False
    mixed_precision: str = "bf16"
    seed: int = 42
    dry_run: bool = False
    module: str = ENTRY                # what each child runs (python -m)


def _require_one_host(cfg: LaunchConfig) -> None:
    if cfg.num_hosts > 1:
        raise NotImplementedError(
            f"multi-host training ({cfg.num_hosts} hosts) is not ported to "
            f"the PyTorch package yet ({_MULTI_HOST})")


def _train_env(cfg: LaunchConfig) -> dict[str, str]:
    """The child's environment: this process's, plus the config overrides
    of the module docstring."""
    _require_one_host(cfg)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if cfg.deterministic:
        env["LLMCTL_TRAINING__DETERMINISTIC"] = "true"
        env["PYTHONHASHSEED"] = str(cfg.seed)
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    env["LLMCTL_TRAINING__SEED"] = str(cfg.seed)
    env["LLMCTL_TRAINING__MIXED_PRECISION"] = cfg.mixed_precision
    return env


def _train_cmd(cfg: LaunchConfig, python: Optional[str] = None) -> list[str]:
    """The child's command line: the port's train_entry under *python*
    (default this interpreter)."""
    cmd = [python or sys.executable, "-m", cfg.module]
    if cfg.config_file:
        cmd += ["--config", str(cfg.config_file)]
    cmd += cfg.extra_args
    return cmd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalLauncher:
    """The training processes of this host: one, or one per rank."""

    def __init__(self, cfg: LaunchConfig):
        _require_one_host(cfg)
        self.cfg = cfg
        self.children: list[subprocess.Popen] = []

    def launch(self, capture_output: bool = True,
               ranks=None) -> Optional[subprocess.Popen]:
        """Start the children (None for a dry run) and return the first's.
        With nothing draining a pipe a chatty child would block on a full
        OS pipe buffer, so output is inherited unless captured (rank 0's
        only: the other ranks log at debug level). ``ranks`` (default
        all) are the ranks to start as children; ``self.rendezvous`` is
        the environment every rank of the job shares."""
        if self.cfg.dry_run:
            self.children = []
            return None
        env = _train_env(self.cfg)
        procs = max(self.cfg.procs, 1)
        self.rendezvous = {}
        if procs > 1:
            self.rendezvous = {"WORLD_SIZE": str(procs),
                               "LOCAL_WORLD_SIZE": str(procs),
                               "MASTER_ADDR": "127.0.0.1",
                               "MASTER_PORT": str(_free_port())}
            env.update(self.rendezvous)
        self.children = []
        for rank in (range(procs) if ranks is None else ranks):
            if procs > 1:
                env = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}
            pipe = capture_output and rank == 0
            self.children.append(subprocess.Popen(
                _train_cmd(self.cfg), env=env,
                stdout=subprocess.PIPE if pipe else None,
                stderr=subprocess.STDOUT if pipe else None, text=True))
        return self.children[0] if self.children else None

    def wait(self, poll_s: float = 0.1) -> int:
        """Wait for every child; the first failure stops the rest. Returns
        0, or the exit code of the first rank that failed."""
        while True:
            rcs = [p.poll() for p in self.children]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                self.stop_children()
                return failed[0]
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(poll_s)

    def stop_children(self, grace_seconds: float = 5.0) -> None:
        """SIGTERM (then SIGKILL) the children that still run."""
        for p in self.children:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace_seconds
        for p in self.children:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()
                p.wait()

    def describe(self) -> str:
        cmd = shlex.join(_train_cmd(self.cfg))
        return cmd if self.cfg.procs <= 1 else f"{self.cfg.procs} x {cmd}"


CLI_MODULE = "distributed_llm_training_and_inference_system_tpu_torch.cli"


def this_rank() -> Optional[int]:
    """This process's rank when a launcher started it as one of a job's
    ranks (``RANK`` and ``WORLD_SIZE`` set), else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"])
    return None


def launch_ranks(argv: list[str], procs: int) -> int:
    """Run ``procs`` ranks of the ``llmctl-torch`` command line ``argv``,
    a child each (``LocalLauncher``; each sees ``this_rank()``), relaying
    rank 0's output. Returns 0, or the first failed rank's exit code (the
    others are stopped)."""
    launcher = LocalLauncher(LaunchConfig(procs=procs, module=CLI_MODULE,
                                          extra_args=list(argv)))
    first = launcher.launch(capture_output=True)
    try:
        for line in first.stdout:
            print(line, end="", flush=True)
        return launcher.wait()
    finally:
        launcher.stop_children()


def lead_ranks(argv: list[str], procs: int) -> LocalLauncher:
    """This process as rank 0 of ``procs`` ranks of the ``llmctl-torch``
    command line ``argv``: ranks 1..procs-1 start as its children, and its
    environment takes the job's rendezvous and ``RANK`` 0. Returns the
    launcher holding the children."""
    launcher = LocalLauncher(LaunchConfig(procs=procs, module=CLI_MODULE,
                                          extra_args=list(argv)))
    launcher.launch(capture_output=False, ranks=range(1, procs))
    os.environ.update({**launcher.rendezvous, "RANK": "0",
                       "LOCAL_RANK": "0"})
    return launcher


def create_launcher(cfg: LaunchConfig) -> LocalLauncher:
    """The launcher for ``cfg.launcher``: ``local``; the cluster launchers
    raise."""
    if cfg.launcher in ("slurm", "mpi", "k8s", "gke"):
        raise NotImplementedError(
            f"launcher {cfg.launcher!r} is not ported to the PyTorch package "
            f"yet ({_MULTI_HOST})")
    if cfg.launcher != "local":
        raise ValueError(f"unknown launcher {cfg.launcher!r}; choose from "
                         "['gke', 'k8s', 'local', 'mpi', 'slurm']")
    return LocalLauncher(cfg)


class ProcessOrchestrator:
    """Start/stream/stop the training job, with restarts on failure."""

    def __init__(self, cfg: LaunchConfig):
        self.cfg = cfg
        self.launcher = create_launcher(cfg)
        self.process: Optional[subprocess.Popen] = None
        self.restarts = 0

    def start(self, stream_output: bool = True) -> int:
        self.process = self.launcher.launch(capture_output=stream_output)
        if self.process is None:     # dry run
            return 0
        pump = None
        if stream_output and self.process.stdout is not None:
            def copy(out=self.process.stdout):
                for line in out:
                    print(line, end="", flush=True)
            pump = threading.Thread(target=copy, daemon=True)
            pump.start()
        rc = self.launcher.wait()
        if pump is not None:
            pump.join(timeout=10)
        return rc

    def run_with_restarts(self, max_restarts: int = 0,
                          backoff_seconds: float = 5.0,
                          stream_output: bool = True) -> int:
        """Run the job, relaunching it up to ``max_restarts`` times after a
        non-zero exit (``self.restarts`` counts them); the entry point
        resumes params, optimizer and data cursor from the latest committed
        checkpoint. Exit code 0, SIGINT or the budget spent ends it."""
        while True:
            rc = self.start(stream_output=stream_output)
            if rc == 0:
                return 0
            if rc == -signal.SIGINT or self.restarts >= max_restarts:
                return rc
            self.restarts += 1
            print(f"[orchestrator] job exited rc={rc}; restart "
                  f"{self.restarts}/{max_restarts} in {backoff_seconds:.0f}s "
                  "(resume from latest checkpoint)", flush=True)
            time.sleep(backoff_seconds)

    def stop(self, grace_seconds: float = 5.0) -> None:
        self.launcher.stop_children(grace_seconds)

    def status(self) -> dict:
        if self.process is None:
            return {"state": "not_started"}
        rc = self.process.poll()
        return {"state": "running" if rc is None else "exited",
                "returncode": rc, "pid": self.process.pid}
