"""Replicable fleet state: the store behind stream logs and the ledger.

The port's copy of the JAX package's ``serve/fleet/state.py``.
:class:`FleetStateStore` is the interface the stream hub
(serve/fleet/streams.py) and the router's ledger (serve/fleet/router.py)
write through:

- :class:`InMemoryStateStore`, the single-front default: journal writes
  are no-ops and folds never happen, so the hub's and router's own dicts
  stay the only copy;
- :class:`SharedFileStateStore`, the HA fronts' host-local durable store:
  an append-only JSONL journal (every stream-log and ledger mutation, one
  record per line, ``flock``-serialized), a small atomically rewritten
  registry ``fronts.json`` (attached fronts, fencing, tier counters,
  journal generation) and one beat file per front. Each front folds the
  journal's tail into its local views via :meth:`sync`; a front's death
  loses nothing because the log of record is on disk.

Write/fold contract (the hub and router both follow it):

1. every local mutation first applies to the in-process working view,
   then appends one journal record (``record()``);
2. ``sync()`` reads the journal tail and dispatches records from other
   fronts to the registered per-namespace handler, which applies them
   through the same dedupe paths a local mutation takes (stream appends
   dedupe by seq, ledger folds are upserts);
3. records a front folds are never re-recorded, so the journal holds each
   fact once per originating front.

Fencing: a front presumed dead is fenced before any other actor adopts
its work, and a fenced front's next journal write raises
:class:`StoreFenced`.

Heartbeats differ from the JAX store's in form, not in meaning. JAX's
``heartbeat`` rewrites the whole registry through ``os.replace`` each
supervisor pass, and so does its throttled fold-frontier publish in
``poll``. Here a front's liveness stamp, fold cursor and live info live in
its own fixed-size beat file ``beat.<front>``, overwritten in place by one
``pwrite`` under the same ``flock``; the atomic registry rewrite is kept
for the rare changes (attach, fence, counters, compaction).
``profile_state_store.py`` times both. ``fronts_view`` merges the two.

Locking: the journal file lock is never held while a component lock
(hub/router) is wanted: ``poll`` reads and releases the file lock before
dispatching, and ``record`` (called under component locks) only ever
takes the file lock last.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Callable, Optional
from urllib.parse import quote

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


def _compact_records(records: list[dict]) -> list[dict]:
    """Prune a fully-folded record sequence to its replay-equivalent
    core (see :meth:`SharedFileStateStore.compact` for the contract):

    - ``ledger``/``count`` records merge per (front, key, replica);
    - ledger groups whose request reached a terminal ``pop`` collapse
      into aggregated completed/failed/rejected count records stamped
      with the POP's originating front (the front whose counters the
      others must fold);
    - finished/discarded stream groups drop wholesale;
    - live groups (in-flight requests, streaming logs) keep every
      record in order.
    """
    counts: dict = {}           # (f, key, replica) -> n, insertion-ordered
    ledger: dict = {}           # rid -> [records]
    stream: dict = {}           # rid -> [records]
    ordered: list = []          # (kind, payload) preserving first-seen order

    for rec in records:
        ns = rec.get("ns")
        if ns == "ledger" and rec.get("op") == "count":
            key = (rec.get("f"), rec.get("key"), rec.get("replica"))
            counts[key] = counts.get(key, 0) + int(rec.get("n", 1))
            continue
        rid = str(rec.get("rid", ""))
        if ns == "ledger" and rid:
            group = ledger.setdefault(rid, [])
            if not group:
                ordered.append(("ledger", rid))
            group.append(rec)
        elif ns == "stream" and rid:
            group = stream.setdefault(rid, [])
            if not group:
                ordered.append(("stream", rid))
            group.append(rec)
        else:
            ordered.append(("raw", rec))

    _TERMINAL_COUNT = {"completed": "completed", "failed": "failed",
                       "rejected": "rejected"}
    kept: list = []
    for kind, item in ordered:
        if kind == "raw":
            kept.append(item)
        elif kind == "ledger":
            group = ledger[item]
            last_pop = -1
            for idx, r in enumerate(group):
                if r.get("op") != "pop":
                    continue
                last_pop = idx
                # EVERY pop is one finished lifecycle — a client-chosen
                # request id may be reused, so one rid can hold several
                key = _TERMINAL_COUNT.get(r.get("outcome"))
                if key is not None:
                    ck = (r.get("f"), key, r.get("replica")
                          if key == "completed" else None)
                    counts[ck] = counts.get(ck, 0) + 1
                # cancelled outcomes increment nothing: drop silently
            # anything after the last pop is a LIVE lifecycle (or the
            # whole group, when no pop ever landed): keep it verbatim
            kept.extend(group[last_pop + 1:])
        else:
            group = stream[item]
            if any(r.get("op") in ("finish", "discard") for r in group):
                continue                      # finished: drop wholesale
            kept.extend(group)                # live stream: keep all
    for (f, key, replica), n in counts.items():
        rec = {"f": f, "ns": "ledger", "op": "count", "key": key, "n": n}
        if replica is not None:
            rec["replica"] = replica
        kept.append(rec)
    return kept


class SharedFileStateStore(FleetStateStore):
    """File-backed shared store: journal + registry under one directory.

    ``expiry_s`` is the heartbeat freshness window — a front silent for
    longer reads as dead in :meth:`fronts_view` and stops being the
    adopter. Fencing is explicit (the tier or a sibling front calls
    :meth:`fence`), never implied by staleness alone: a stalled front
    that wakes up may still write UNTIL someone fences it, and the
    dedupe layers make those writes harmless.
    """

    shared = True

    def __init__(self, root: str, front_id: Optional[str] = None,
                 expiry_s: float = 2.0, compact_every: int = 0):
        super().__init__(front_id)
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._fronts = os.path.join(self.root, "fronts.json")
        self._lockfile = os.path.join(self.root, ".lock")
        self.expiry_s = float(expiry_s)
        # LOGICAL journal offset (bytes since the journal's beginning of
        # time): compaction trims the physical file and advances
        # ``journal_base`` in the registry, so physical offset =
        # _cursor - base. A cursor behind the base means records this
        # front never folded were compacted into the snapshot — it
        # reads snapshot.jsonl first, then the journal tail.
        self._cursor = 0
        # snapshot+truncate compaction (bounds the journal's growth):
        # every `compact_every` records written, the prefix that EVERY
        # attached, unfenced front has already folded is folded into
        # snapshot.jsonl — terminal request groups collapsed to
        # aggregated count records, finished stream groups dropped —
        # and the journal file is replaced by its tail under a fresh
        # generation number (one atomic registry flip switches readers
        # over). 0 disables.
        self.compact_every = int(compact_every)
        self._since_compact = 0
        # poll() fast path: (gen, base, journal path, snapshot path)
        # cached so the hot fold loop reads ONLY the journal file. A
        # compaction flip invalidates it naturally — the old journal
        # file is unlinked under the same flock, so the next open
        # fails and the registry is re-read.
        self._reg_cache: Optional[tuple] = None
        self.compactions = 0
        self.records_pruned = 0
        self.records_written = 0
        self.records_folded = 0
        # this front's beat record ({"t", "cursor", live info}) as last
        # written; None until attach or the first heartbeat registered it
        self._beat: Optional[dict] = None

    # -- beat files ----------------------------------------------------------

    BEAT_BYTES = 512

    def _beat_path(self, front_id: str) -> str:
        return os.path.join(self.root, "beat." + quote(front_id, safe=""))

    def _write_beat(self, rec: dict) -> None:
        """Overwrite this front's beat file in place: one ``pwrite`` of a
        space-padded JSON object. Caller holds the flock, so no reader
        sees it half written."""
        data = json.dumps(rec, separators=(",", ":")).encode()
        fd = os.open(self._beat_path(self.front_id),
                     os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            os.pwrite(fd, data.ljust(self.BEAT_BYTES), 0)
        finally:
            os.close(fd)
        self._beat = rec

    def _read_beat(self, front_id: str) -> dict:
        """A front's beat record; {} when it has none (or it is torn by a
        crash mid-write, which reads as no beat: stale, never fresh).
        Trailing padding, or the tail of a longer earlier record, is
        ignored."""
        try:
            with open(self._beat_path(front_id), "rb") as fh:
                raw = fh.read().decode()
            rec, _end = json.JSONDecoder().raw_decode(raw)
        except (OSError, ValueError):
            return {}
        return rec if isinstance(rec, dict) else {}

    # journal/snapshot filenames are GENERATION-suffixed: compaction
    # writes the new generation's files completely, then flips the
    # registry (atomic rewrite) — a crash mid-compaction leaves orphan
    # files, never a torn journal. Generation 0 keeps the legacy name.
    def _journal_path(self, reg: dict) -> str:
        gen = int(reg.get("journal_gen", 0))
        name = "journal.jsonl" if gen == 0 else f"journal.{gen}.jsonl"
        return os.path.join(self.root, name)

    def _snapshot_path(self, reg: dict) -> Optional[str]:
        name = reg.get("journal_snapshot")
        return os.path.join(self.root, name) if name else None

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
            with open(self._fronts) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {"epoch": 0, "fronts": {}, "fenced": [],
                    "counters": {}}

    def _save_registry(self, reg: dict) -> None:
        # atomic rewrite: a reader (or a front SIGKILLed mid-save) never
        # sees a torn registry
        tmp = self._fronts + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(reg, fh)
        os.replace(tmp, self._fronts)

    # -- journal -------------------------------------------------------------

    @thread_seam
    def record(self, rec: dict) -> None:
        line = json.dumps({"f": self.front_id, **rec},
                          separators=(",", ":"))
        with self._locked():
            reg = self._load_registry()
            if self.front_id in reg.get("fenced", ()):
                raise StoreFenced(
                    f"front {self.front_id} is fenced; write refused")
            with open(self._journal_path(reg), "a") as fh:
                fh.write(line + "\n")
        self.records_written += 1
        self._since_compact += 1
        if self.compact_every > 0 \
                and self._since_compact >= self.compact_every:
            # outside the flock (it is not reentrant across fds);
            # compaction takes its own
            self._since_compact = 0
            try:
                self.compact()
            except Exception:
                logger.exception("journal compaction failed (journal "
                                 "keeps growing until the next attempt)")

    def _cache_paths(self) -> tuple:
        """(gen, base, journal path, snapshot path) from a fresh
        registry read. Caller holds the flock."""
        reg = self._load_registry()
        self._reg_cache = (int(reg.get("journal_gen", 0)),
                           int(reg.get("journal_base", 0)),
                           self._journal_path(reg),
                           self._snapshot_path(reg))
        return self._reg_cache

    @thread_seam
    def poll(self) -> list[dict]:
        # read under the file lock (complete lines only), dispatch after
        # release — the file lock is never held while a component lock
        # is wanted (see the module docstring's lock-order contract).
        # The hot path touches ONLY the journal file: the registry view
        # (generation/base/paths) is cached, and a compaction flip
        # surfaces as the old journal's unlink (done under the same
        # flock), which forces a re-read here.
        raw: list[bytes] = []
        with self._locked():
            gen, base, jpath, spath = (self._reg_cache
                                       or self._cache_paths())
            blob = b""
            try:
                if self._cursor < base:
                    raise OSError       # fell behind: slow branch
                with open(jpath, "rb") as fh:
                    fh.seek(self._cursor - base)
                    blob = fh.read()
            except OSError:
                # slow branch (rare): the journal rotated under us, was
                # never created, or a compaction moved past our cursor.
                # Refresh the registry view FIRST so the snapshot we
                # load is exactly the one the current base describes.
                gen, base, jpath, spath = self._cache_paths()
                if self._cursor < base:
                    # records we never folded were compacted away: the
                    # snapshot holds their replay-equivalent form
                    if spath:
                        try:
                            with open(spath, "rb") as fh:
                                raw.extend(fh.read().splitlines())
                        except OSError:
                            pass
                    self._cursor = base
                try:
                    with open(jpath, "rb") as fh:
                        fh.seek(self._cursor - base)
                        blob = fh.read()
                except OSError:
                    blob = b""
            end = blob.rfind(b"\n")
            if end >= 0:
                self._cursor += end + 1
                raw.extend(blob[:end + 1].splitlines())
            # publish the fold frontier so the compactor never trims
            # records some live front still needs (trim bound = min
            # cursor over attached, unfenced fronts)
            if end >= 0 and self._beat is not None:
                # one in-place beat write, so no throttle is needed
                self._write_beat({**self._beat, "cursor": self._cursor})
        out = []
        for line in raw:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("f") != self.front_id:
                out.append(rec)
        self.records_folded += len(out)
        return out

    # -- snapshot + truncate compaction --------------------------------------

    @thread_seam
    def compact(self) -> int:
        """Fold the journal prefix every attached, unfenced front has
        already consumed into ``snapshot.jsonl`` and truncate the
        journal to its tail. Returns how many records were pruned
        (0 = nothing to do). Fenced fronts must not compact — their
        successor owns the log now.

        Replay contract: a FRESH front folding snapshot + journal tail
        reaches the same live state (ledger entries, counters, live
        stream logs) as one folding the original journal. Terminal
        request groups collapse to aggregated ``count`` records
        (completed/failed/rejected — same net counter effect), counter
        records merge per (front, key, replica), and finished stream
        groups are dropped (every live front already folded them; a
        front attaching later cannot replay a stream that finished
        before it existed, which the TTL would have GC'd anyway)."""
        with self._locked():
            reg = self._load_registry()
            fenced = set(reg.get("fenced", ()))
            if self.front_id in fenced:
                return 0
            base = int(reg.get("journal_base", 0))
            gen = int(reg.get("journal_gen", 0))
            cursors = [self._cursor]
            for fid, ent in reg.get("fronts", {}).items():
                if fid in fenced or fid == self.front_id:
                    continue
                # fronts with no cursor yet have folded nothing — the
                # snapshot covers them completely, so they don't bound
                # the trim; fronts WITH one must keep their tail
                beat = self._read_beat(fid)
                if "cursor" in beat:
                    cursors.append(int(beat["cursor"]))
            lo = min(cursors)
            trim = lo - base
            if trim <= 0:
                return 0
            jpath = self._journal_path(reg)
            try:
                with open(jpath, "rb") as fh:
                    blob = fh.read()
            except OSError:
                return 0
            trim = min(trim, len(blob))
            head, tail = blob[:trim], blob[trim:]
            raw = []
            spath = self._snapshot_path(reg)
            if spath:
                try:
                    with open(spath, "rb") as fh:
                        raw.extend(fh.read().splitlines())
                except OSError:
                    pass
            raw.extend(head.splitlines())
            records = []
            for line in raw:
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
            kept = _compact_records(records)
            new_gen = gen + 1
            snap_name = f"snapshot.{new_gen}.jsonl"
            new_snap = os.path.join(self.root, snap_name)
            new_journal = os.path.join(self.root,
                                       f"journal.{new_gen}.jsonl")
            tmp = new_snap + ".tmp"
            with open(tmp, "wb") as fh:
                for rec in kept:
                    fh.write(json.dumps(
                        rec, separators=(",", ":")).encode() + b"\n")
            os.replace(tmp, new_snap)
            tmp = new_journal + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(tail)
            os.replace(tmp, new_journal)
            # the atomic flip: readers resolve paths from the registry,
            # so one rewrite switches every front over consistently
            reg["journal_gen"] = new_gen
            reg["journal_base"] = base + trim
            reg["journal_snapshot"] = snap_name
            self._save_registry(reg)
            self._reg_cache = None      # our own poll view rotated too
            for stale in (jpath, spath):
                if stale and stale != new_journal:
                    try:
                        os.unlink(stale)
                    except OSError:
                        pass
            pruned = len(records) - len(kept)
            self.compactions += 1
            self.records_pruned += pruned
            logger.info(
                "journal compacted (gen %d): %d records -> %d snapshot "
                "records + %d journal bytes", new_gen, len(records),
                len(kept), len(tail))
            return pruned

    # -- front registry ------------------------------------------------------

    @thread_seam
    def attach(self, info: Optional[dict] = None) -> int:
        with self._locked():
            reg = self._load_registry()
            reg["epoch"] = int(reg.get("epoch", 0)) + 1
            entry = {"epoch": reg["epoch"], "pid": os.getpid(),
                     "t": time.time(), "started": time.time()}
            entry.update(info or {})
            reg.setdefault("fronts", {})[self.front_id] = entry
            # re-attaching under the same id clears an old fence (a NEW
            # incarnation re-using the id has a fresh epoch)
            reg["fenced"] = [f for f in reg.get("fenced", [])
                             if f != self.front_id]
            self._save_registry(reg)
            self._write_beat({"t": entry["t"]})
            return int(reg["epoch"])

    @thread_seam
    def heartbeat(self, info: Optional[dict] = None) -> None:
        with self._locked():
            if self._beat is None:
                # first beat of a front that never attached: register it
                # once, as the JAX store's heartbeat does on every beat
                reg = self._load_registry()
                if self.front_id not in reg.get("fronts", {}):
                    reg.setdefault("fronts", {})[self.front_id] = {
                        "epoch": 0, "pid": os.getpid(),
                        "started": time.time(), "t": time.time()}
                    self._save_registry(reg)
            # the stamp, the fold frontier and the live info: one
            # in-place write of this front's beat file
            self._write_beat({**(self._beat or {}), **(info or {}),
                              "t": time.time(), "cursor": self._cursor})

    @thread_seam
    def fronts_view(self) -> dict:
        with self._locked():
            reg = self._load_registry()
            beats = {fid: self._read_beat(fid)
                     for fid in reg.get("fronts", {})}
        now = time.time()
        fenced = set(reg.get("fenced", ()))
        out = {}
        for fid, entry in sorted(reg.get("fronts", {}).items()):
            entry = {**entry, **beats[fid]}
            age = now - float(entry.get("t", 0.0))
            out[fid] = {**entry, "age_s": round(age, 3),
                        "fenced": fid in fenced,
                        "alive": (age < self.expiry_s
                                  and fid not in fenced)}
        return out

    @thread_seam
    def fence(self, front_id: str) -> bool:
        with self._locked():
            reg = self._load_registry()
            if front_id in reg.get("fenced", ()):
                return False
            reg.setdefault("fenced", []).append(front_id)
            self._save_registry(reg)
        logger.warning("front %s fenced", front_id)
        return True

    @thread_seam
    def is_fenced(self, front_id: Optional[str] = None) -> bool:
        with self._locked():
            reg = self._load_registry()
        return (front_id or self.front_id) in reg.get("fenced", ())

    @thread_seam
    def front_alive(self, front_id: str) -> bool:
        view = self.fronts_view()
        entry = view.get(front_id)
        return bool(entry and entry["alive"])

    @thread_seam
    def is_adopter(self) -> bool:
        view = self.fronts_view()
        alive = sorted(fid for fid, e in view.items() if e["alive"])
        return bool(alive) and alive[0] == self.front_id

    # -- tier counters -------------------------------------------------------

    @thread_seam
    def incr(self, key: str, n: int = 1) -> int:
        with self._locked():
            reg = self._load_registry()
            counters = reg.setdefault("counters", {})
            counters[key] = int(counters.get(key, 0)) + int(n)
            self._save_registry(reg)
            return counters[key]

    @thread_seam
    def counters_view(self) -> dict:
        with self._locked():
            reg = self._load_registry()
        return dict(reg.get("counters", {}))


def build_state_store(cfg, front_id: Optional[str] = None
                      ) -> FleetStateStore:
    """Store from FleetConfig: ``state_store`` = memory | file (the
    latter rooted at ``state_store_dir``, which multi-front deployments
    must share). Validation already refused file-without-dir."""
    kind = getattr(cfg, "state_store", "memory")
    if kind == "file":
        expiry = max(3.0 * float(getattr(cfg, "probe_interval_s", 0.5)),
                     0.25)
        return SharedFileStateStore(
            cfg.state_store_dir, front_id=front_id, expiry_s=expiry,
            compact_every=int(getattr(cfg, "state_compact_every", 0)
                              or 0))
    return InMemoryStateStore(front_id)
