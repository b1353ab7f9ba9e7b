"""Replicated store tier: N `llmctl-torch fleet store` members behind the
one logical ``KV_STORE_OWNER``.

The port's copy of the JAX package's ``serve/fleet/store_tier.py``:

- :class:`StoreMembership` — the epoch-fenced member registry: one
  flock-serialised, atomically rewritten JSON file under a directory every
  member shares. ``attach`` bumps the tier epoch and records this member's
  endpoint; a fenced or stale-epoch member's writes are refused with a
  FATAL ack at the service (``guard_write``).
- :class:`EndpointSet` — the client's health view: ordered member URLs with
  per-endpoint down cooldowns. ``StoreClient`` and ``WeightCourier`` rotate
  through ``live()`` on transient errors.
- :func:`wait_store_ready` — poll each member's ``/health`` until it leaves
  503 ``{"status": "starting"}``.

Replication is client fan-out (write-ack floor synchronously, the rest
mirrored) plus the service's anti-entropy, both in
serve/fleet/store_service.py.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
from contextlib import contextmanager
from typing import Optional

from ...analysis.annotations import thread_seam

__all__ = ["EndpointSet", "StoreMembership", "parse_endpoint_spec",
           "wait_store_ready"]

logger = logging.getLogger("llmctl.serve.fleet.store_tier")


def parse_endpoint_spec(value) -> list:
    """Comma-separated endpoint spec -> ordered, slash-stripped URLs.
    Accepts a list/tuple (already split) for convenience."""
    if isinstance(value, (list, tuple)):
        parts = [str(v) for v in value]
    else:
        parts = str(value or "").split(",")
    return [p.strip().rstrip("/") for p in parts if p.strip()]


class StoreMembership:
    """The store tier's fenced member registry: one flock-serialized
    JSON file (``members.json``) under a directory every member shares,
    exactly the ``SharedFileStateStore`` front-registry idiom.

    ``attach`` bumps the tier-wide epoch, records this member's entry
    (endpoint, pid, heartbeat time) under that epoch, and clears any
    old fence on the id — a NEW incarnation re-using a member id is a
    fresh member. ``guard_write`` is the zombie rule: a write is
    refused when this member is fenced OR when the registry's entry for
    this id carries a different epoch (someone re-attached the id; this
    process is a stale incarnation that missed its own replacement).
    """

    def __init__(self, root: str, member_id: str,
                 expiry_s: float = 2.0):
        self.root = str(root)
        self.member_id = str(member_id)
        self.expiry_s = float(expiry_s)
        os.makedirs(self.root, exist_ok=True)
        self._registry = os.path.join(self.root, "members.json")
        self._lockfile = os.path.join(self.root, ".members.lock")
        # this incarnation's attach epoch (0 = never attached)
        self.epoch = 0

    @contextmanager
    def _locked(self):
        import fcntl
        with open(self._lockfile, "a+") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def _load_registry(self) -> dict:
        try:
            with open(self._registry) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {"epoch": 0, "members": {}, "fenced": []}

    def _save_registry(self, reg: dict) -> None:
        # atomic rewrite: a reader (or a member SIGKILLed mid-save)
        # never sees a torn registry
        tmp = self._registry + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(reg, fh)
        os.replace(tmp, self._registry)

    @thread_seam
    def attach(self, info: Optional[dict] = None) -> int:
        with self._locked():
            reg = self._load_registry()
            reg["epoch"] = int(reg.get("epoch", 0)) + 1
            entry = {"epoch": reg["epoch"], "pid": os.getpid(),
                     "t": time.time(), "started": time.time()}
            entry.update(info or {})
            reg.setdefault("members", {})[self.member_id] = entry
            # re-attaching under the same id clears an old fence (a NEW
            # incarnation re-using the id has a fresh epoch)
            reg["fenced"] = [m for m in reg.get("fenced", [])
                             if m != self.member_id]
            self._save_registry(reg)
            self.epoch = int(reg["epoch"])
            return self.epoch

    @thread_seam
    def heartbeat(self, info: Optional[dict] = None) -> None:
        with self._locked():
            reg = self._load_registry()
            entry = reg.setdefault("members", {}).setdefault(
                self.member_id, {"epoch": self.epoch,
                                 "pid": os.getpid(),
                                 "started": time.time()})
            entry["t"] = time.time()
            if info:
                entry.update(info)
            self._save_registry(reg)

    @thread_seam
    def members_view(self) -> dict:
        with self._locked():
            reg = self._load_registry()
        now = time.time()
        fenced = set(reg.get("fenced", ()))
        out = {}
        for mid, entry in sorted(reg.get("members", {}).items()):
            age = now - float(entry.get("t", 0.0))
            out[mid] = {**entry, "age_s": round(age, 3),
                        "fenced": mid in fenced,
                        "alive": (age < self.expiry_s
                                  and mid not in fenced)}
        return out

    @thread_seam
    def peer_endpoints(self) -> list:
        """Alive peers' advertised endpoints (everyone but me) — the
        anti-entropy pull targets. Members discover each other purely
        through the registry, so a tier needs no static peer list."""
        return [str(e.get("endpoint"))
                for mid, e in self.members_view().items()
                if mid != self.member_id and e["alive"]
                and e.get("endpoint")]

    @thread_seam
    def fence(self, member_id: str) -> bool:
        with self._locked():
            reg = self._load_registry()
            if member_id in reg.get("fenced", ()):
                return False
            reg.setdefault("fenced", []).append(member_id)
            self._save_registry(reg)
        logger.warning("store member %s fenced", member_id)
        return True

    @thread_seam
    def is_fenced(self, member_id: Optional[str] = None) -> bool:
        with self._locked():
            reg = self._load_registry()
        return (member_id or self.member_id) in reg.get("fenced", ())

    @thread_seam
    def guard_write(self) -> Optional[str]:
        """None when this incarnation may admit writes; else the FATAL
        refusal reason (fenced, or a newer incarnation of this id has
        attached and this process is a zombie that missed its own
        replacement)."""
        with self._locked():
            reg = self._load_registry()
        if self.member_id in reg.get("fenced", ()):
            return (f"store member {self.member_id} is fenced; "
                    f"write refused")
        entry = reg.get("members", {}).get(self.member_id)
        if entry is not None and int(entry.get("epoch", 0)) != self.epoch:
            return (f"store member {self.member_id} epoch {self.epoch} "
                    f"is stale (registry holds epoch "
                    f"{int(entry.get('epoch', 0))}); write refused")
        return None


class EndpointSet:
    """Ordered store-tier member URLs with per-endpoint down-cooldowns
    — the client half of health-gated rotation. ``live()`` returns the
    members worth trying, in preference order; a member that exhausted
    its retry budget is ``mark_down``-ed for ``cooldown_s`` so the next
    RPC skips straight to a survivor instead of re-paying the connect
    timeout. When EVERY member is cooling down the full list returns
    (desperation beats refusing to try)."""

    def __init__(self, endpoints, cooldown_s: float = 1.0):
        self.endpoints = parse_endpoint_spec(endpoints)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._down_until: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self.endpoints)

    def live(self) -> list:
        now = time.monotonic()
        with self._lock:
            up = [ep for ep in self.endpoints
                  if self._down_until.get(ep, 0.0) <= now]
        return up or list(self.endpoints)

    def mark_down(self, endpoint: str) -> None:
        with self._lock:
            self._down_until[endpoint] = (time.monotonic()
                                          + self.cooldown_s)

    def mark_up(self, endpoint: str) -> None:
        with self._lock:
            self._down_until.pop(endpoint, None)

    def reachable_map(self) -> dict:
        """{endpoint: not-cooling-down} for status surfaces."""
        now = time.monotonic()
        with self._lock:
            return {ep: self._down_until.get(ep, 0.0) <= now
                    for ep in self.endpoints}


def wait_store_ready(endpoints, timeout_s: float = 10.0,
                     interval_s: float = 0.05) -> bool:
    """Block until every endpoint's ``/health`` answers 200 (the
    readiness gate: disk tier scanned, frame index warm, not fenced) or
    the deadline passes. Returns True when all members are ready —
    spawners gate worker launches on this instead of sleeping."""
    pending = set(parse_endpoint_spec(endpoints))
    deadline = time.monotonic() + float(timeout_s)
    while pending and time.monotonic() < deadline:
        for ep in sorted(pending):
            try:
                with urllib.request.urlopen(f"{ep}/health",
                                            timeout=1.0) as resp:
                    json.loads(resp.read().decode())
                pending.discard(ep)
            except Exception:
                pass              # 503 starting / refused: keep polling
        if pending:
            time.sleep(interval_s)
    return not pending
