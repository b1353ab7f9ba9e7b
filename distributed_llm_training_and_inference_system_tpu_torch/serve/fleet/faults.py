"""Deterministic fault injection for the serve fleet.

The control plane's hard paths — crash-requeue, probe-driven drain,
straggler rebalancing — only execute when a replica misbehaves, which on
healthy hardware is never. This module makes those paths testable on CPU:
a ``FaultPlan`` declares WHAT goes wrong (one replica crashes, probes time
out, decode drags) and the ``FaultInjector`` fires it at a deterministic
point (an exact per-replica step count, or one drawn from a seeded RNG),
so a fleet test replays bit-identically run over run.

Faults are injected at the same seams real failures enter:
- crash      — raised from the replica's engine loop between steps, so the
               replica thread dies exactly like an uncaught device error
- probe loss — raised from the supervisor's health probe, modelling a hung
               or partitioned replica whose engine thread still runs
- straggler  — a fixed per-step delay, modelling a thermally throttled or
               noisy-neighbour chip that is slow but not dead
- transport  — per-chunk drop / corrupt / delay / duplicate plus
               dest-unreachable, drawn per courier chunk send from a
               dedicated seeded RNG stream (serve/fleet/transport.py), so
               the KV courier's whole failure matrix replays from a seed
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np


class InjectedCrash(RuntimeError):
    """Raised inside a replica's engine loop to simulate a process crash."""


class ProbeTimeout(RuntimeError):
    """Raised from a health probe to simulate a hung/partitioned replica."""


class DestUnreachable(RuntimeError):
    """Raised at courier transfer open to simulate a partitioned or
    connection-refused destination host."""


class RpcBlackhole(RuntimeError):
    """Raised before a remote-replica control RPC (submit/probe/outbox/
    ship) to simulate a black-holed worker endpoint: the process may be
    alive, but nothing reaches it. A finite count models a partition
    that heals; -1 models a dead route (the supervisor's probe-miss
    teardown then fires exactly as for a SIGKILLed worker)."""


@dataclass
class FaultPlan:
    """Declarative fault schedule. All fields optional; the default plan
    injects nothing. ``seed`` only matters when ``crash_after_steps`` is 0:
    the crash step is then drawn once from ``default_rng(seed)`` in
    [crash_step_lo, crash_step_hi), keeping "crash at a random-but-
    reproducible point" a one-liner for soak tests."""
    seed: int = 0
    # crash: replica `crash_replica` raises InjectedCrash before its
    # `crash_after_steps`-th engine step (fires once, ever — the restarted
    # replica is healthy)
    crash_replica: Optional[int] = None
    crash_after_steps: int = 0
    crash_step_lo: int = 1
    crash_step_hi: int = 8
    # request-keyed crash: the replica CURRENTLY serving a request whose
    # id contains `crash_request_substr` crashes after
    # `crash_request_after_steps` engine steps with such a request
    # active (fires once, ever). Unlike `crash_replica` this follows the
    # request, not the hardware — the bench's pipeline chaos arm keys on
    # "::stage" so the injected crash deterministically lands on a
    # pipelined-prefill stage request wherever the planner placed it,
    # exercising the collapse path instead of whichever replica happened
    # to be id 0.
    crash_request_substr: str = ""
    crash_request_after_steps: int = 1
    # probe timeouts: the next `probe_timeout_count` health probes of
    # `probe_timeout_replica` raise ProbeTimeout
    probe_timeout_replica: Optional[int] = None
    probe_timeout_count: int = 0
    # straggler: every engine step of `slow_replica` is delayed `slow_ms`
    slow_replica: Optional[int] = None
    slow_ms: float = 0.0
    # transport (courier chunk) faults: each chunk send draws once from a
    # seeded RNG stream; at most one fault kind fires per chunk (drop
    # beats corrupt beats delay beats duplicate, in that order). Rates
    # are probabilities in [0, 1]; rate 1.0 makes EVERY chunk fail that
    # way (the abort-path test). `chunk_fault_budget` caps how many
    # chunk faults fire in total (0 = unlimited) so a lossy link can be
    # modelled as transiently bad rather than forever-broken.
    chunk_drop_rate: float = 0.0
    chunk_corrupt_rate: float = 0.0
    chunk_delay_rate: float = 0.0
    chunk_delay_ms: float = 0.0      # stall applied when a delay fires
    chunk_duplicate_rate: float = 0.0
    chunk_fault_budget: int = 0
    # dest unreachable: the next `dest_unreachable_count` TRANSFERS whose
    # destination is `dest_unreachable_replica` fail before any chunk
    # moves (connection refused / network partition at transfer open)
    dest_unreachable_replica: Optional[int] = None
    dest_unreachable_count: int = 0
    # process-level faults (cross-host fleet, serve/fleet/remote.py):
    # black-hole every control RPC to `rpc_blackhole_replica` for the
    # next `rpc_blackhole_count` calls (-1 = forever — the parent's
    # probe-miss teardown must fire exactly like a SIGKILL; a finite
    # count is a partition that heals before the miss budget runs out)
    rpc_blackhole_replica: Optional[int] = None
    rpc_blackhole_count: int = 0
    # HA front tier faults (serve/fleet/front.py FleetFrontTier): kill
    # (SIGKILL) or stall (SIGSTOP, SIGCONT after `front_stall_ms`) the
    # front process at `front_*_front` once, `front_*_after_s` seconds
    # after the tier starts. after_s <= 0 draws the time from the
    # seeded RNG in [front_fault_lo_s, front_fault_hi_s) — "kill a
    # front at a random-but-reproducible moment" stays a one-liner.
    front_kill_front: Optional[int] = None
    front_kill_after_s: float = 0.0
    front_stall_front: Optional[int] = None
    front_stall_after_s: float = 0.0
    front_stall_ms: float = 200.0
    front_fault_lo_s: float = 0.5
    front_fault_hi_s: float = 3.0
    # HA store tier faults (serve/fleet/store_tier.py): kill (SIGKILL)
    # or stall (SIGSTOP, SIGCONT after `store_stall_ms`) the store
    # member process at `store_*_member` once, `store_*_after_s`
    # seconds after the tier starts — delivered by whoever babysits the
    # member processes via ``store_faults_due``, exactly the front-tier
    # pattern. after_s <= 0 draws from the seeded stream (seed+3) in
    # [store_fault_lo_s, store_fault_hi_s). `store_partition_member`
    # black-holes a member from THIS process's store clients:
    # ``on_store_rpc`` passes the first `store_partition_after_calls`
    # RPCs to that member through, then blocks the next
    # `store_partition_count` (-1 = forever) — the client sees
    # connection-refused, exercising retry/rotation without any real
    # process dying.
    store_kill_member: Optional[int] = None
    store_kill_after_s: float = 0.0
    store_stall_member: Optional[int] = None
    store_stall_after_s: float = 0.0
    store_stall_ms: float = 200.0
    store_partition_member: Optional[int] = None
    store_partition_count: int = 0
    store_partition_after_calls: int = 0
    store_fault_lo_s: float = 0.5
    store_fault_hi_s: float = 3.0


class FaultInjector:
    """Runtime counterpart of a FaultPlan. Thread-safe: replica engine
    threads call ``before_step``/``step_delay_s``; the supervisor thread
    calls ``on_probe``."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self._steps: dict[int, int] = {}
        # request-keyed crash: steps each replica has taken WITH a
        # matching request active (the countdown is per replica — the
        # crash must land where the request is)
        self._req_match_steps: dict[int, int] = {}
        self._crash_fired = False
        self._probe_timeouts_left = self.plan.probe_timeout_count
        p = self.plan
        self._crash_step = p.crash_after_steps
        if p.crash_replica is not None and p.crash_after_steps <= 0:
            self._crash_step = int(np.random.default_rng(p.seed).integers(
                p.crash_step_lo, max(p.crash_step_hi, p.crash_step_lo + 1)))
        # transport-fault state: a dedicated RNG stream (seed+1 so chunk
        # draws never alias the crash-step draw) + remaining budgets
        self._chunk_rng = np.random.default_rng(p.seed + 1)
        self._chunk_faults_left = (p.chunk_fault_budget
                                   if p.chunk_fault_budget > 0 else None)
        self._unreachable_left = p.dest_unreachable_count
        self._blackhole_left = p.rpc_blackhole_count
        # front-fault state: times drawn once from a dedicated stream
        # (seed+2) when the plan leaves them unpinned; each fires once
        front_rng = np.random.default_rng(p.seed + 2)

        def _front_at(after_s: float) -> float:
            if after_s > 0:
                return after_s
            return float(front_rng.uniform(
                p.front_fault_lo_s,
                max(p.front_fault_hi_s, p.front_fault_lo_s + 1e-3)))

        self._front_kill_at = (_front_at(p.front_kill_after_s)
                               if p.front_kill_front is not None
                               else None)
        self._front_stall_at = (_front_at(p.front_stall_after_s)
                                if p.front_stall_front is not None
                                else None)
        # store-fault state: its own stream (seed+3) so store draws
        # never alias front draws; partition consumption mirrors the
        # RPC blackhole
        store_rng = np.random.default_rng(p.seed + 3)

        def _store_at(after_s: float) -> float:
            if after_s > 0:
                return after_s
            return float(store_rng.uniform(
                p.store_fault_lo_s,
                max(p.store_fault_hi_s, p.store_fault_lo_s + 1e-3)))

        self._store_kill_at = (_store_at(p.store_kill_after_s)
                               if p.store_kill_member is not None
                               else None)
        self._store_stall_at = (_store_at(p.store_stall_after_s)
                                if p.store_stall_member is not None
                                else None)
        self._store_calls: dict[int, int] = {}
        self._store_partition_left = p.store_partition_count

    @property
    def wants_request_ids(self) -> bool:
        """True when the plan needs to see the active request ids each
        step (request-keyed crash) — replicas skip collecting them
        otherwise."""
        return bool(self.plan.crash_request_substr)

    def before_step(self, replica_id: int,
                    active: Optional[list] = None) -> None:
        """Called by the replica loop before each engine step; raises
        InjectedCrash exactly once at the planned (replica, step) — or,
        for request-keyed plans, once the replica serving a matching
        request has taken ``crash_request_after_steps`` steps with it
        active (``active`` is that replica's current request ids)."""
        sub = self.plan.crash_request_substr
        with self._lock:
            step = self._steps.get(replica_id, 0)
            self._steps[replica_id] = step + 1
            fire = (not self._crash_fired
                    and self.plan.crash_replica == replica_id
                    and step >= self._crash_step)
            matched = None
            if not fire and not self._crash_fired and sub and active:
                matched = next((rid for rid in active if sub in rid),
                               None)
                if matched is not None:
                    n = self._req_match_steps.get(replica_id, 0) + 1
                    self._req_match_steps[replica_id] = n
                    fire = n >= self.plan.crash_request_after_steps
            if fire:
                self._crash_fired = True
        if fire:
            if matched is not None:
                raise InjectedCrash(
                    f"injected crash: replica {replica_id} serving "
                    f"{matched} at step {step}")
            raise InjectedCrash(
                f"injected crash: replica {replica_id} at step {step}")

    def step_delay_s(self, replica_id: int) -> float:
        if self.plan.slow_replica == replica_id and self.plan.slow_ms > 0:
            return self.plan.slow_ms / 1e3
        return 0.0

    def on_probe(self, replica_id: int) -> None:
        """Called by the supervisor before each health probe; raises
        ProbeTimeout for the planned number of probes."""
        with self._lock:
            fire = (self.plan.probe_timeout_replica == replica_id
                    and self._probe_timeouts_left > 0)
            if fire:
                self._probe_timeouts_left -= 1
        if fire:
            raise ProbeTimeout(
                f"injected probe timeout: replica {replica_id}")

    def on_transfer(self, dest) -> None:
        """Called by the courier before each send round; raises
        DestUnreachable for the planned number of rounds to the planned
        destination (the sender retries the whole round under its normal
        backoff schedule, so a healed partition resumes the transfer)."""
        with self._lock:
            fire = (self.plan.dest_unreachable_replica is not None
                    and dest == self.plan.dest_unreachable_replica
                    and self._unreachable_left > 0)
            if fire:
                self._unreachable_left -= 1
        if fire:
            raise DestUnreachable(
                f"injected unreachable destination: replica {dest}")

    def on_rpc(self, replica_id) -> None:
        """Called before each remote-replica control RPC; raises
        RpcBlackhole while the planned black-hole is in effect
        (count -1 = forever; a positive count is consumed per call, so
        the partition heals and subsequent RPCs go through)."""
        with self._lock:
            fire = (self.plan.rpc_blackhole_replica is not None
                    and replica_id == self.plan.rpc_blackhole_replica
                    and self._blackhole_left != 0)
            if fire and self._blackhole_left > 0:
                self._blackhole_left -= 1
        if fire:
            raise RpcBlackhole(
                f"injected black-holed endpoint: replica {replica_id}")

    def on_chunk(self, src, dest, ticket: str, seq: int) -> Optional[dict]:
        """Called by the courier transport per chunk send attempt.
        Returns None (no fault) or one of {"drop": True},
        {"corrupt": True}, {"delay_ms": X}, {"duplicate": True}. Draws
        come from a seeded stream under the lock, so a single-courier
        scenario replays bit-identically from the plan's seed."""
        p = self.plan
        if not (p.chunk_drop_rate or p.chunk_corrupt_rate
                or p.chunk_delay_rate or p.chunk_duplicate_rate):
            return None
        with self._lock:
            if self._chunk_faults_left is not None \
                    and self._chunk_faults_left <= 0:
                return None
            u = float(self._chunk_rng.random())
            edge = p.chunk_drop_rate
            fault = None
            if u < edge:
                fault = {"drop": True}
            elif u < (edge := edge + p.chunk_corrupt_rate):
                fault = {"corrupt": True}
            elif u < (edge := edge + p.chunk_delay_rate):
                fault = {"delay_ms": p.chunk_delay_ms}
            elif u < edge + p.chunk_duplicate_rate:
                fault = {"duplicate": True}
            if fault is not None and self._chunk_faults_left is not None:
                self._chunk_faults_left -= 1
        return fault

    def front_faults_due(self, elapsed_s: float) -> list[tuple]:
        """Called by the FleetFrontTier babysit loop with the seconds
        since the tier started. Returns the front faults now due, each
        at most once, as ``("kill", front_index)`` /
        ``("stall", front_index, stall_ms)`` tuples — the tier delivers
        the signals (SIGKILL / SIGSTOP+SIGCONT)."""
        due: list[tuple] = []
        p = self.plan
        with self._lock:
            if self._front_kill_at is not None \
                    and elapsed_s >= self._front_kill_at:
                due.append(("kill", int(p.front_kill_front)))
                self._front_kill_at = None
            if self._front_stall_at is not None \
                    and elapsed_s >= self._front_stall_at:
                due.append(("stall", int(p.front_stall_front),
                            float(p.front_stall_ms)))
                self._front_stall_at = None
        return due

    def store_faults_due(self, elapsed_s: float) -> list[tuple]:
        """Called by whoever babysits the store member processes with
        the seconds since the tier started. Returns the store faults
        now due, each at most once, as ``("kill", member_index)`` /
        ``("stall", member_index, stall_ms)`` tuples — the babysitter
        delivers the signals (SIGKILL / SIGSTOP+SIGCONT)."""
        due: list[tuple] = []
        p = self.plan
        with self._lock:
            if self._store_kill_at is not None \
                    and elapsed_s >= self._store_kill_at:
                due.append(("kill", int(p.store_kill_member)))
                self._store_kill_at = None
            if self._store_stall_at is not None \
                    and elapsed_s >= self._store_stall_at:
                due.append(("stall", int(p.store_stall_member),
                            float(p.store_stall_ms)))
                self._store_stall_at = None
        return due

    def on_store_rpc(self, member_index: int) -> bool:
        """Called by StoreClient/WeightCourier before each RPC to store
        member ``member_index``. Returns True when the injected
        partition blocks this call (the client treats it as connection
        refused). The first `store_partition_after_calls` RPCs to the
        member pass through — a partition that begins MID-transfer —
        then `store_partition_count` calls block (-1 = forever)."""
        p = self.plan
        if p.store_partition_member is None \
                or member_index != p.store_partition_member:
            return False
        with self._lock:
            n = self._store_calls.get(member_index, 0)
            self._store_calls[member_index] = n + 1
            if n < p.store_partition_after_calls:
                return False
            if self._store_partition_left == 0:
                return False
            if self._store_partition_left > 0:
                self._store_partition_left -= 1
            return True

    def steps_taken(self, replica_id: int) -> int:
        with self._lock:
            return self._steps.get(replica_id, 0)
