"""Replicable fleet state: the store behind stream logs and the ledger.

The port's copy of the JAX package's ``serve/fleet/state.py``, with the
single-front store only. :class:`FleetStateStore` is the interface the
stream hub (serve/fleet/streams.py) and the router's ledger
(serve/fleet/router.py) write through; :class:`InMemoryStateStore`, the
default, makes journal writes no-ops and folds nothing, so their own
dicts stay the only copy.

The shared file store of several HA fronts (``state_store = "file"``)
is not ported: it comes with the fronts, ROADMAP queue 1 item 9 step 9c,
and must not copy the JAX store's ``os.replace`` heartbeat (ROADMAP
queue 3 item 8). ``build_state_store`` refuses it.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Callable, Optional

from ...analysis.annotations import thread_seam

logger = logging.getLogger("llmctl.serve.fleet.state")


class StoreFenced(RuntimeError):
    """This front was fenced (declared dead and superseded): its writes
    must not reach the shared state anymore."""


class FleetStateStore:
    """Interface + the in-memory single-front implementation.

    The base class IS the in-memory store: journal writes vanish,
    ``sync`` folds nothing, and the registry knows only this front.
    Subclasses override the journal/registry verbs; the hub and router
    only ever talk to this surface.
    """

    shared = False

    def __init__(self, front_id: Optional[str] = None):
        self.front_id = front_id or f"front-{uuid.uuid4().hex[:12]}"
        self._handlers: dict[str, Callable[[dict], None]] = {}
        # serializes fold passes so two threads can't race the cursor
        self._sync_lock = threading.Lock()

    # -- journal -------------------------------------------------------------

    @thread_seam
    def on(self, namespace: str, handler: Callable[[dict], None]) -> None:
        """Register the fold handler for one record namespace
        (``"stream"`` -> FleetStreamHub.apply_record, ``"ledger"`` ->
        FleetRouter.apply_record)."""
        self._handlers[namespace] = handler

    @thread_seam
    def record(self, rec: dict) -> None:
        """Append one mutation record. No-op in memory: the caller's own
        data structure already holds the only copy."""

    @thread_seam
    def poll(self) -> list[dict]:
        """New journal records from OTHER fronts since the last poll."""
        return []

    @thread_seam
    def sync(self) -> int:
        """Fold the journal tail into the local working views via the
        registered handlers. Returns how many records were applied."""
        with self._sync_lock:
            records = self.poll()
            for rec in records:
                handler = self._handlers.get(rec.get("ns", ""))
                if handler is None:
                    continue
                try:
                    handler(rec)
                except Exception:
                    logger.exception("state fold failed for %r", rec)
        return len(records)

    # -- front registry ------------------------------------------------------

    @thread_seam
    def attach(self, info: Optional[dict] = None) -> int:
        """Register this front (port, pid) and return its fencing epoch."""
        return 0

    @thread_seam
    def heartbeat(self, info: Optional[dict] = None) -> None:
        """Refresh this front's liveness stamp (+ optional live info like
        its active subscriber count)."""

    @thread_seam
    def fronts_view(self) -> dict:
        """{front_id: {port, pid, epoch, alive, fenced, age_s, ...}} —
        the `fleet status` / snapshot surface. Empty in memory (a
        single-front fleet has nothing to coordinate)."""
        return {}

    @thread_seam
    def fence(self, front_id: str) -> bool:
        """Mark ``front_id`` dead-and-superseded; its next write raises
        StoreFenced. Returns True when newly fenced."""
        return False

    @thread_seam
    def is_fenced(self, front_id: Optional[str] = None) -> bool:
        return False

    @thread_seam
    def front_alive(self, front_id: str) -> bool:
        """Heartbeat-fresh and not fenced. The in-memory store only ever
        hosts this front, which is trivially alive."""
        return front_id == self.front_id

    @thread_seam
    def is_adopter(self) -> bool:
        """Whether THIS front is the deterministic adopter (smallest
        alive front id) for dead fronts' parked work — a leader chosen
        without consensus machinery, safe because adoption is advisory
        (the dedupe/idempotency layers absorb a double-adopt)."""
        return True

    # -- tier counters -------------------------------------------------------

    @thread_seam
    def incr(self, key: str, n: int = 1) -> int:
        return 0

    @thread_seam
    def counters_view(self) -> dict:
        return {}


class InMemoryStateStore(FleetStateStore):
    """Alias of the base store, named for configs and tests."""


def build_state_store(cfg, front_id: Optional[str] = None
                      ) -> FleetStateStore:
    """Store from FleetConfig: ``state_store = "memory"``; ``"file"``
    raises ``NotImplementedError``."""
    kind = getattr(cfg, "state_store", "memory")
    if kind == "file":
        raise NotImplementedError(
            "state_store='file' (the shared store of several fleet "
            "fronts) is not ported to the PyTorch fleet yet: ROADMAP "
            "queue 1 item 9, step 9c (queue 3 item 8: without the "
            "os.replace heartbeat)")
    return InMemoryStateStore(front_id)
