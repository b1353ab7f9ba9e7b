"""Cross-replica KV migration: move a sequence WITH its pages.

PR 2 shipped re-prefill-on-requeue: every drained or rebalanced sequence
paid an O(context) recompute on the survivor before emitting its next
token. This module is the Llumnix-style alternative (PAPERS.md): the
source replica extracts the victim's paged KV at an engine-step boundary
and the destination restores the pages through the engine's existing
swap-in path (``engine._restore_swapped``), so decode resumes
token-identically with ZERO prefill compute — the assigned_seed +
position-folded PRNG already guarantees the stream continues bit-exactly.

The pause is bounded with a **two-phase copy**:

- *pre-copy* (``precopy_slot``): every FULL page of the victim is copied
  to host memory while the source keeps decoding. Full pages are
  immutable — decode only ever appends to the partial tail page — so
  nothing pre-copied can go stale.
- *stop-and-copy* (``stop_and_copy``): at the next step boundary the
  sequence is frozen and only the pages written since the pre-copy (the
  old partial tail plus whatever decode filled in between — at most one
  dispatch of tokens) cross; the payloads merge into one restore-shaped
  dict and the sequence leaves the source.

Payloads are host numpy arrays in exactly the ``Request.swapped_kv``
schema the intra-engine preemption=swap path defined, so the destination
needs NO new restore code — and because they are plain serializable
arrays, the courier transport (serve/fleet/transport.py) frames them
into checksummed, retryable chunks at placement time: every payload this
module extracts crosses that link (in-proc today, HTTP cross-host) and
a transfer that fails end-to-end degrades to re-prefill, never to wrong
tokens.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ...analysis.annotations import engine_thread_only
from ..kv_cache import concat_page_payloads, payload_numpy


@dataclass
class MigrationTicket:
    """One in-flight migration, owned by the SOURCE replica's engine
    thread (phases advance only at its step boundaries)."""
    request_id: str
    dest: Optional[int] = None          # preferred replica; None = router
    reason: str = "operator"            # operator | drain | rebalance
    phase: str = "precopy"              # precopy -> stop
    pre: Optional[dict] = None          # phase-1 result
    detail: dict = field(default_factory=dict)


def payload_nbytes(payload: Optional[dict]) -> int:
    """Host bytes a courier transfer moves for this payload (the chunk
    count is ceil(nbytes / courier_chunk_bytes)) — sizing input for the
    transport layer and the per-move log detail."""
    if not payload:
        return 0

    def walk(node) -> int:
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.nbytes if isinstance(node, np.ndarray) else 0
    return walk(payload)


@engine_thread_only
def handoff_slot(engine, slot: int) -> tuple[dict, dict]:
    """Post-prefill prefill->decode handoff: the degenerate ONE-phase
    migration. At prefill completion every written page is full and
    immutable (nothing has decoded yet), so there is no tail to chase —
    a single stop-and-copy over an empty pre-copy moves the whole
    sequence. Caller is the engine thread, holding ``engine.lock``, at
    the prefill-complete boundary (before any decode dispatch touched
    the slot)."""
    pos = int(engine.positions[slot])
    return stop_and_copy(engine, slot,
                         {"pages": None, "full_pages": 0, "positions": pos})


@engine_thread_only
def precopy_slot(engine, slot: int) -> dict:
    """Phase 1: copy the slot's FULL pages to host. Caller is the engine
    thread at a step boundary (pipelined dispatch drained), holding
    ``engine.lock``."""
    pos = int(engine.positions[slot])
    full = pos // engine.kv.page_size
    # host arrays now, outside the stop phase's pause: payload_numpy waits
    # for the extract's copies to land
    return {
        "pages": (payload_numpy(engine.kv.extract_slot_pages(slot, 0, full))
                  if full > 0 else None),
        "full_pages": full,
        "positions": pos,
    }


@engine_thread_only
def stop_and_copy(engine, slot: int, pre: dict) -> tuple[dict, dict]:
    """Phase 2: freeze the sequence and copy only what phase 1 could not —
    pages [full_pages, pages(written)) — then merge into one
    ``swapped_kv``-shaped payload. Returns (payload, detail); ``detail``
    carries the pause/page accounting the metrics and tests assert.

    Caller is the engine thread, holding ``engine.lock``; the slot must
    still be RUNNING and un-preempted since phase 1 (same request id)."""
    t0 = time.perf_counter()
    pos = int(engine.positions[slot])
    total = engine.kv.pages_needed(pos)
    lo = pre["full_pages"]
    # the extract fills pinned host tensors asynchronously: payload_numpy
    # waits for the card before it reads them
    delta = payload_numpy(engine.kv.extract_slot_pages(slot, lo, total))
    pages = (concat_page_payloads(pre["pages"], delta)
             if pre["pages"] is not None else delta)
    payload = {
        "pages": pages,
        "positions": pos,
        "last_token": int(engine.last_tokens[slot]),
    }
    # courier-aware speculation: the slot's SpecState (acceptance EWMA,
    # adaptive window, proposer warmup) rides the payload MANIFEST as
    # plain scalars — tiny, CRC-covered, and restored by the destination
    # engine's swap-in path so the sequence resumes speculating at its
    # tuned window instead of cold-starting the proposer
    spec = getattr(engine, "spec_state_of", lambda s: None)(slot)
    if spec is not None:
        payload["spec"] = spec
    pause_ms = (time.perf_counter() - t0) * 1e3
    detail = {
        "pause_ms": pause_ms,
        "precopy_pages": lo,
        "stop_pages": total - lo,
        "total_pages": total,
        "positions_precopy": pre["positions"],
        "positions_stop": pos,
    }
    return payload, detail
