"""HA front tier: N stateless fleet fronts as their own OS processes.

The port's copy of the JAX package's ``serve/fleet/front.py``; its fronts
are `llmctl-torch fleet front` processes serving the stdlib
:class:`~.http.FleetServer`, and a front never initialises CUDA (its
replicas are all remote, so it holds no model).

One **front** is a :class:`~.http.FleetServer` whose replicas are all
remote (``llmctl fleet worker`` processes) and whose stream logs +
router ledger live in a shared :class:`~.state.SharedFileStateStore` —
so the front's heap holds nothing a client's stream depends on. Kill a
front mid-SSE and:

- the workers keep decoding (they never needed the front alive);
- any surviving front folds the workers' outbox entries into the shared
  log (the outbox drains to whichever front polls first — with the
  journal as the single log of record, the split is harmless);
- the client reconnects to any other front with ``Last-Event-ID`` and
  replays exactly the unacked tail, then follows live — zero gaps,
  zero duplicates, token-identical (the kill-the-front chaos bar).

:func:`run_front` is the ``llmctl-torch fleet front`` entrypoint (one front,
ephemeral-port discovery via a single ``LLMCTL_FRONT_READY`` line,
mirroring ``llmctl-torch fleet worker``). :class:`FleetFrontTier` is the
parent-side babysitter: it spawns N fronts, watches their liveness,
**fences** dead ones in the store (a stalled zombie cannot scribble
over its successor), counts failovers, optionally respawns, and
delivers the :class:`~.faults.FaultInjector`'s seeded front-kill /
front-stall faults (SIGKILL / SIGSTOP+SIGCONT) for chaos runs.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Optional

from ...analysis.annotations import supervisor_thread, thread_seam
from .faults import FaultInjector
from .state import SharedFileStateStore

logger = logging.getLogger("llmctl.serve.fleet.front")

READY_PREFIX = "LLMCTL_FRONT_READY"


def run_front(model_cfg, serve_cfg, fleet_cfg, front_id: str,
              fault_plan=None) -> None:
    """Serve ONE stateless fleet front until SIGTERM. Prints exactly one
    machine-readable ready line (``LLMCTL_FRONT_READY port=N front=ID``)
    once /health would answer 200, so a spawning tier can discover an
    ephemeral port; everything else logs to stderr."""
    from .http import FleetServer
    from .worker import wait_for_sigterm

    server = FleetServer(model_cfg, serve_cfg, fleet_cfg,
                         fault_plan=fault_plan, front_id=front_id)
    server.start()
    print(f"{READY_PREFIX} port={server.bound_port} "
          f"front={server.fleet.front_id}", flush=True)
    try:
        wait_for_sigterm()
    finally:
        server.stop()


class FrontHandle:
    """One spawned front process + what the tier knows about it."""

    __slots__ = ("index", "front_id", "proc", "port", "stalled_until")

    def __init__(self, index: int, front_id: str,
                 proc: subprocess.Popen):
        self.index = index
        self.front_id = front_id
        self.proc = proc
        self.port: Optional[int] = None
        self.stalled_until: Optional[float] = None


class FleetFrontTier:
    """Spawn, watch, fence, and (optionally) respawn N front processes.

    ``spawn_cmd`` builds the argv for front ``i`` with id ``front_id``
    — the CLI path (`llmctl serve start --fleet-fronts N`) builds it
    from the operator's flags, tests build it directly. The tier owns the chaos seams: it consumes the
    injector's seeded front faults and it is the actor that fences a
    dead front in the store before counting the failover.
    """

    def __init__(self, store: SharedFileStateStore,
                 spawn_cmd: Callable[[int, str], list],
                 fronts: int = 2,
                 injector: Optional[FaultInjector] = None,
                 respawn: bool = True,
                 ready_timeout_s: float = 120.0):
        self.store = store
        self.spawn_cmd = spawn_cmd
        self.n = int(fronts)
        self.injector = injector
        self.respawn = respawn
        self.ready_timeout_s = float(ready_timeout_s)
        self.handles: list[FrontHandle] = []
        self.total_front_failovers = 0
        self.total_front_respawns = 0
        self._incarnation = 0
        self._t0: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------

    def _spawn_one(self, index: int) -> FrontHandle:
        self._incarnation += 1
        front_id = f"front-{index}.{self._incarnation}"
        proc = subprocess.Popen(
            self.spawn_cmd(index, front_id), stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, start_new_session=True)
        return FrontHandle(index, front_id, proc)

    def _wait_ready(self, h: FrontHandle) -> int:
        deadline = time.monotonic() + self.ready_timeout_s
        import select
        while time.monotonic() < deadline:
            if h.proc.poll() is not None:
                raise RuntimeError(
                    f"front {h.front_id} died during startup "
                    f"(rc={h.proc.returncode})")
            rd, _, _ = select.select([h.proc.stdout], [], [], 1.0)
            if rd:
                line = h.proc.stdout.readline()
                if line.startswith(READY_PREFIX):
                    h.port = int(line.strip().split("port=")[1]
                                 .split()[0])
                    return h.port
        raise RuntimeError(f"front {h.front_id} never became ready")

    @thread_seam
    def start(self) -> list[int]:
        """Spawn every front and wait for its ready line. Returns the
        bound ports, index-aligned."""
        self.handles = [self._spawn_one(i) for i in range(self.n)]
        ports = [self._wait_ready(h) for h in self.handles]
        self._t0 = time.monotonic()
        return ports

    @thread_seam
    def ports(self) -> list:
        return [h.port for h in self.handles]

    @thread_seam
    def endpoints(self, host: str = "127.0.0.1") -> list[str]:
        return [f"http://{host}:{h.port}" for h in self.handles]

    @thread_seam
    def stop(self) -> None:
        for h in self.handles:
            if h.proc.poll() is None:
                try:
                    if h.stalled_until is not None:
                        os.kill(h.proc.pid, signal.SIGCONT)
                    h.proc.terminate()
                    h.proc.wait(timeout=5)
                except (subprocess.TimeoutExpired, OSError):
                    h.proc.kill()
                    h.proc.wait()

    # -- chaos verbs ---------------------------------------------------------

    @thread_seam
    def kill(self, index: int) -> None:
        """SIGKILL front ``index`` — the chaos headline. The next poll
        notices, fences it, and counts the failover."""
        h = self.handles[index]
        logger.warning("front tier: SIGKILL front %s (pid %d)",
                       h.front_id, h.proc.pid)
        h.proc.kill()
        h.proc.wait()

    @thread_seam
    def stall(self, index: int, stall_ms: float) -> None:
        """SIGSTOP front ``index``; the babysit loop SIGCONTs it after
        ``stall_ms``. Models a GC-paused / wedged front whose sockets
        are alive but dark — heartbeats go stale, clients reconnect
        elsewhere, and the woken zombie finds itself fenced only if the
        stall outlived the heartbeat expiry and someone fenced it."""
        h = self.handles[index]
        if h.proc.poll() is not None:
            return
        logger.warning("front tier: SIGSTOP front %s for %.0f ms",
                       h.front_id, stall_ms)
        os.kill(h.proc.pid, signal.SIGSTOP)
        h.stalled_until = time.monotonic() + stall_ms / 1e3

    # -- babysitting ---------------------------------------------------------

    @supervisor_thread
    def poll(self, now: Optional[float] = None) -> dict:
        """One babysit pass: deliver due injector faults, wake finished
        stalls, fence + count dead fronts, respawn if configured."""
        now = time.monotonic() if now is None else now
        if self.injector is not None and self._t0 is not None:
            for fault in self.injector.front_faults_due(now - self._t0):
                if fault[0] == "kill" and fault[1] < len(self.handles):
                    self.kill(fault[1])
                elif fault[0] == "stall" \
                        and fault[1] < len(self.handles):
                    self.stall(fault[1], fault[2])
        for h in self.handles:
            if h.stalled_until is not None and now >= h.stalled_until:
                try:
                    os.kill(h.proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                h.stalled_until = None
            if h.proc.poll() is None:
                continue
            # dead front: fence FIRST (a zombie must not out-write its
            # successor), then count, then optionally respawn under a
            # fresh front id + epoch
            self.store.fence(h.front_id)
            self.total_front_failovers += 1
            self.store.incr("failovers")
            logger.warning("front tier: front %s died (rc=%s) — fenced, "
                           "failover #%d", h.front_id, h.proc.returncode,
                           self.total_front_failovers)
            if self.respawn:
                idx = h.index
                self.handles[idx] = self._spawn_one(idx)
                self._wait_ready(self.handles[idx])
                self.total_front_respawns += 1
                logger.info("front tier: respawned index %d as %s on "
                            "port %s", idx, self.handles[idx].front_id,
                            self.handles[idx].port)
        return self.snapshot()

    @supervisor_thread
    def snapshot(self) -> dict:
        """Tier status: per-front liveness + the failover ledger (the
        counter-wiring registry pins these keys)."""
        return {
            "fronts": [{
                "index": h.index, "front_id": h.front_id,
                "port": h.port, "pid": h.proc.pid,
                "alive": h.proc.poll() is None,
                "stalled": h.stalled_until is not None,
            } for h in self.handles],
            "failovers": self.total_front_failovers,
            "respawns": self.total_front_respawns,
            "store": self.store.fronts_view(),
        }

    def run_forever(self, poll_interval_s: float = 0.25) -> None:
        try:
            while True:
                self.poll()
                time.sleep(poll_interval_s)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def default_spawn_cmd(*, model: str, store_dir: str, replicas: int,
                      endpoints: dict, remote_replicas: str,
                      host: str = "127.0.0.1", artifact: str = "",
                      extra: Optional[list] = None
                      ) -> Callable[[int, str], list]:
    """argv builder for `llmctl-torch fleet front` children, the CLI
    path's spawn_cmd. A front holds no model, so it runs with ``--device
    cpu`` and never initialises CUDA. Tests usually build their own to
    pin serve/courier knobs."""
    pkg = __name__.split(".")[0]

    def cmd(index: int, front_id: str) -> list:
        argv = [sys.executable, "-m", f"{pkg}.cli", "--device", "cpu",
                "fleet", "front", "--model", model, "--front-id", front_id,
                "--host", host, "--port", "0",
                "--replicas", str(replicas),
                "--remote-replicas", remote_replicas,
                "--state-store-dir", store_dir]
        if artifact:
            argv += ["--artifact", artifact]
        for rid, url in sorted(endpoints.items()):
            argv += ["--fleet-endpoint", f"{rid}={url}"]
        return argv + list(extra or [])

    return cmd
