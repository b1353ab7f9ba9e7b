"""Tiered fleet KV store: a host DRAM/disk cache behind the prefix
inventory.

The port's copy of the JAX package's ``serve/fleet/kv_store.py``:

- **Demotion** (``demote`` / ``demote_async``): a replica evicting a hashed
  prefix page (``PagedKVCache.demote_hook``) or flushing its whole
  inventory at drain or retire hands the page content here. Each page is
  encoded once into courier frames (``encode_payload`` + per-chunk
  deflate) and only the frames are kept, so storing costs no later
  recompression. A payload of torch tensors (``PagedKVCache.extract_pages``
  fills pinned tensors asynchronously) goes through
  ``kv_cache.payload_numpy`` first, which synchronises the card, so the
  frames and their CRCs cover the bytes the pages held.
- **Tiering**: a bounded DRAM ring (LRU, capacity in bytes of wire frames);
  overflow spills to ``{hash}.kvf`` files under a directory when one is
  configured (a JSON header line, then the frame bytes), else the oldest
  entry is dropped. An optional TTL expires entries.
- **Advertising**: ``inventory()`` feeds the router's prefix-hint path as a
  replica's probe inventory does; the router falls back to the store hint
  (``KV_STORE_OWNER``) only when the store covers more of the prompt than
  any live replica.
- **Fetch** (``fetch``): the stored frames are replayed byte for byte
  through the shared ``CourierReceiver`` (frame CRC, end-to-end raw CRC,
  decode). Any failure is a counted miss and the destination prefills
  plainly.

Threading: ``demote`` runs on engine threads, ``inventory`` wherever
requests are placed, ``fetch`` on the destination's engine thread and
``snapshot`` on the supervisor. One lock covers the index; frame bytes
are taken under it and replayed outside it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np

from ...analysis.annotations import thread_seam
from ..kv_cache import concat_page_payloads, payload_numpy
from .transport import (CODEC_NONE, CODEC_ZLIB, CourierChunk,
                        KV_STORE_OWNER, encode_payload, make_chunks)

__all__ = ["FleetKVStore", "KV_STORE_OWNER", "host_payload"]

logger = logging.getLogger("llmctl.serve.fleet.kv_store")


class _Entry:
    """One demoted prefix page: its compressed courier frames + manifest.

    ``frames`` is a list of (seq, total, crc32, data) tuples — the wire
    form minus the ticket, which is stamped fresh per replay (the frame
    CRC covers the data bytes only, so re-ticketing never recompresses).
    A spilled entry drops ``frames`` and carries ``path`` instead."""

    __slots__ = ("frames", "manifest", "wire_bytes", "raw_bytes", "born",
                 "path")

    def __init__(self, frames, manifest, wire_bytes, raw_bytes, born,
                 path=None):
        self.frames = frames
        self.manifest = manifest
        self.wire_bytes = wire_bytes
        self.raw_bytes = raw_bytes
        self.born = born
        self.path = path


def host_payload(content: dict) -> dict:
    """``content`` with numpy leaves: a payload holding torch tensors goes
    through ``payload_numpy`` (which synchronises the card first), a numpy
    one is returned as it is."""
    leaf = content["k"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if isinstance(leaf, np.ndarray):
        return content
    return payload_numpy(content)


def _page_slice(content: dict, i: int) -> dict:
    """Page column ``i`` of an ``extract_pages``-schema payload as a
    standalone one-page payload (page axis is 1)."""

    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return np.ascontiguousarray(np.asarray(node)[:, i:i + 1])
    return {"k": cut(content["k"]), "v": cut(content["v"]),
            "num_pages": 1}


class FleetKVStore:
    """Host-tier page store. Capacities are configured via FleetConfig
    (``kv_store_dram_mb`` / ``kv_store_dir`` + ``kv_store_disk_mb`` /
    ``kv_store_ttl_ms``); codec and zlib level follow the courier's so
    the stored frames are the same bytes a live transfer would have
    sent — except a fleet running codec "none" stores under plain zlib
    (at-rest compression is free; every receiver accepts all known
    codecs by default)."""

    def __init__(self, cfg=None):
        self.dram_capacity = int(float(getattr(
            cfg, "kv_store_dram_mb", 256.0) or 0.0) * 1e6)
        self.disk_dir = str(getattr(cfg, "kv_store_dir", "") or "")
        self.disk_capacity = int(float(getattr(
            cfg, "kv_store_disk_mb", 1024.0) or 0.0) * 1e6)
        self.ttl_s = float(getattr(cfg, "kv_store_ttl_ms", 0.0)
                           or 0.0) / 1e3
        codec = str(getattr(cfg, "courier_codec", CODEC_NONE)
                    or CODEC_NONE)
        self.codec = CODEC_ZLIB if codec == CODEC_NONE else codec
        self.zlib_level = int(getattr(cfg, "courier_zlib_level", -1))
        self.chunk_bytes = int(getattr(cfg, "courier_chunk_bytes",
                                       256 * 1024))
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
        self._lock = threading.Lock()
        # eviction-path demotions encode on THIS daemon worker, not the
        # engine thread: deflating a page costs milliseconds, and an
        # engine evicting under pool pressure must not pay it inline in
        # the decode loop (zlib releases the GIL, so encoding genuinely
        # overlaps stepping). Queue entries hold a REFERENCE into the
        # batched extract payload plus a column index — the per-page
        # copy happens on the worker too, so the engine thread pays
        # only the one batched device gather per allocation. Bounded:
        # overflow drops the oldest queued page (counted as an eviction
        # — it never made it down a tier).
        self._pending: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._pending_max = 256
        # pages popped off the queue and not yet stored: flush_pending
        # waits for these too (the JAX store's barrier returns as soon as
        # the queue is empty, while its last page may still be encoding)
        self._inflight = 0
        self._work = threading.Event()
        self._encoder: Optional[threading.Thread] = None
        self._dram: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._disk: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self.dram_bytes = 0
        self.disk_bytes = 0
        # running totals (the Prometheus pump deltas the mapped ones)
        self.total_hits = 0          # pages served on fetch
        self.total_misses = 0        # fetches that served zero pages
        self.total_demotions = 0     # pages accepted (duplicates skipped)
        self.total_duplicates = 0    # demotions skipped as already held
        self.total_evictions = 0     # entries dropped from the store
        self.total_expired = 0       # of those, dropped by TTL
        self.total_spills = 0        # DRAM entries moved to disk
        self.total_corrupt = 0       # replays rejected by frame/raw CRC
        self.total_bytes_served = 0  # wire bytes replayed on hits
        self.total_bytes_stored = 0  # wire bytes accepted at demotion

    # -- demotion ------------------------------------------------------------

    @thread_seam
    def demote_async(self, hashes: list, content: dict) -> int:
        """Queue demoted pages for background encoding and return
        immediately — the HOT eviction seam (engine thread, mid-
        allocation). Pages sit as host numpy until the encoder worker
        deflates them; a fetch racing the queue is a counted miss
        (degrade, never block). Returns how many pages were queued."""
        queued = 0
        try:
            content = host_payload(content)
            n = int(content.get("num_pages", 0))
            with self._lock:
                for i, h in enumerate(hashes[:n]):
                    h = bytes(h)
                    if h in self._dram or h in self._disk \
                            or h in self._pending:
                        self.total_duplicates += 1
                        continue
                    self._pending[h] = (content, i)
                    queued += 1
                while len(self._pending) > self._pending_max:
                    self._pending.popitem(last=False)
                    self.total_evictions += 1
                if queued and (self._encoder is None
                               or not self._encoder.is_alive()):
                    self._encoder = threading.Thread(
                        target=self._encode_loop, daemon=True,
                        name="llmctl-kvstore-encode")
                    self._encoder.start()
            if queued:
                self._work.set()
        except Exception:
            logger.exception("kv store async demotion failed; "
                             "pages dropped")
        return queued

    def _encode_loop(self) -> None:
        while True:
            if not self._work.wait(timeout=5.0):
                return                        # idle: let the thread die
            self._work.clear()
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    h, (batch, col) = self._pending.popitem(last=False)
                    self._inflight += 1
                try:
                    self._demote_page(h, _page_slice(batch, col))
                finally:
                    with self._lock:
                        self._inflight -= 1

    def flush_pending(self, timeout_s: float = 10.0) -> None:
        """Wait until the background encoder has stored every queued page
        (tests, drain/retire barriers)."""
        deadline = time.monotonic() + timeout_s
        self._work.set()
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._pending) or self._inflight > 0
            if not busy:
                return
            time.sleep(0.002)

    @thread_seam
    def demote(self, hashes: list, content: dict) -> int:
        """Accept demoted prefix pages: ``content`` is the
        ``extract_pages``-schema payload whose page column *i* belongs
        to ``hashes[i]``. Each page is encoded once into courier frames
        and stored; a hash already held (either tier) is skipped
        idempotently. Returns how many pages were newly stored. Never
        raises into the engine thread — a failed demotion only costs a
        future recompute."""
        stored = 0
        try:
            content = host_payload(content)
            n = int(content.get("num_pages", 0))
            for i, h in enumerate(hashes[:n]):
                if self._demote_page(bytes(h), _page_slice(content, i)):
                    stored += 1
        except Exception:
            logger.exception("kv store demotion failed; pages dropped")
        return stored

    def _demote_page(self, h: bytes, page: dict) -> bool:
        now = time.monotonic()
        with self._lock:
            self._gc_locked(now)
            if h in self._dram or h in self._disk:
                self.total_duplicates += 1
                return False
        # encode OUTSIDE the lock: deflate is the expensive half and
        # concurrent demoters must not serialize on it
        payload = {"prefix": True, "hashes": [h.hex()], "pages": page}
        manifest, blob = encode_payload(payload, codec=self.codec,
                                        zlib_level=self.zlib_level)
        chunks = make_chunks("store", manifest, blob, self.chunk_bytes)
        frames = [(c.seq, c.total, c.crc32, c.data) for c in chunks]
        wire = sum(len(c.data) for c in chunks)
        entry = _Entry(frames, manifest, wire, int(manifest["nbytes"]),
                       now)
        with self._lock:
            if h in self._dram or h in self._disk:   # raced a twin
                self.total_duplicates += 1
                return False
            self._dram[h] = entry
            self.dram_bytes += wire
            self.total_demotions += 1
            self.total_bytes_stored += wire
            self._enforce_caps_locked()
        return True

    # -- networked-store seams (serve/fleet/store_service.py) ----------------

    @thread_seam
    def admit_frames(self, h: bytes, frames: list, manifest: dict,
                     raw_bytes: int) -> bool:
        """Admit one page's ALREADY-ENCODED courier frames — the store
        service's demote path. The frames were encoded once by the
        demoting front/worker; admitting them verifies each frame CRC
        (a frame corrupted on the upload wire is a counted rejection,
        never stored) and never recompresses. Returns True when newly
        stored, False for duplicates/corruption."""
        for _seq, _total, crc, data in frames:
            if zlib.crc32(data) != crc:
                with self._lock:
                    self.total_corrupt += 1
                logger.warning("kv store admit %s rejected: frame CRC "
                               "mismatch on upload", h.hex())
                return False
        wire = sum(len(data) for _s, _t, _c, data in frames)
        entry = _Entry(list(frames), manifest, wire, int(raw_bytes),
                       time.monotonic())
        with self._lock:
            self._gc_locked(entry.born)
            if h in self._dram or h in self._disk:
                self.total_duplicates += 1
                return False
            self._dram[h] = entry
            self.dram_bytes += wire
            self.total_demotions += 1
            self.total_bytes_stored += wire
            self._enforce_caps_locked()
        return True

    @thread_seam
    def export_frames(self, hashes: list, count: bool = True) -> list:
        """The store service's fetch path: the longest held prefix of
        ``hashes`` as ``(hex_hash, manifest, frames, wire_bytes)`` rows,
        frames byte-identical to what was admitted — the FETCHER replays
        them through its own CourierReceiver, so verification happens at
        the destination exactly like a live transfer. Hits and served
        bytes are counted here (the serving side); an empty result is a
        counted miss. ``count=False`` is the anti-entropy path — a peer
        reconciling its holdings must not pollute the client-traffic
        hit/miss ledger."""
        out = []
        for h in hashes:
            h = bytes(h)
            now = time.monotonic()
            with self._lock:
                self._gc_locked(now)
                entry = self._dram.get(h)
                if entry is not None:
                    self._dram.move_to_end(h)
                    frames = list(entry.frames)
                else:
                    entry = self._disk.get(h)
                    if entry is None:
                        break
                    self._disk.move_to_end(h)
                    frames = self._load_disk_frames(entry)
                    if frames is None:
                        self._disk.pop(h, None)
                        self.disk_bytes -= entry.wire_bytes
                        self._unlink(entry.path)
                        self.total_corrupt += 1
                        self.total_evictions += 1
                        break
                if count:
                    self.total_hits += 1
                    self.total_bytes_served += entry.wire_bytes
                out.append((h.hex(), entry.manifest, frames,
                            entry.wire_bytes))
        if not out and count:
            with self._lock:
                self.total_misses += 1
        return out

    @thread_seam
    def scan_disk(self) -> int:
        """Index pre-existing spill files (``{hash}.kvf``) under
        ``kv_store_dir`` — the store service's warm-up: a member
        restarted over its old directory re-advertises everything it
        spilled before dying, and anti-entropy only has to pull the
        DRAM-tier delta. Headers are parsed (a torn header file is
        unlinked, counted corrupt); frame DATA stays on disk and is
        CRC-checked at replay like any spilled entry. Returns how many
        entries were newly indexed."""
        if not self.disk_dir:
            return 0
        try:
            names = sorted(os.listdir(self.disk_dir))
        except OSError:
            return 0
        indexed = 0
        for fname in names:
            if not fname.endswith(".kvf"):
                continue
            path = os.path.join(self.disk_dir, fname)
            try:
                h = bytes.fromhex(fname[:-4])
            except ValueError:
                continue
            try:
                with open(path, "rb") as fh:
                    header = json.loads(fh.readline())
                manifest = dict(header["manifest"])
                wire = int(header["wire_bytes"])
                raw = int(header.get("raw_bytes", 0))
            except (OSError, ValueError, KeyError, TypeError):
                self._unlink(path)
                with self._lock:
                    self.total_corrupt += 1
                continue
            with self._lock:
                if h in self._dram or h in self._disk:
                    continue
                self._disk[h] = _Entry(None, manifest, wire, raw,
                                       time.monotonic(), path=path)
                self.disk_bytes += wire
                self._enforce_caps_locked()
                indexed += 1
        if indexed:
            logger.info("kv store disk scan: %d spilled entries "
                        "re-indexed from %s", indexed, self.disk_dir)
        return indexed

    # -- capacity / tiering --------------------------------------------------

    def _enforce_caps_locked(self) -> None:
        while self.dram_bytes > self.dram_capacity and len(self._dram) > 1:
            h, entry = self._dram.popitem(last=False)      # LRU first
            self.dram_bytes -= entry.wire_bytes
            if self.disk_dir and self.disk_capacity > 0:
                self._spill_locked(h, entry)
            else:
                self.total_evictions += 1
        while self.disk_bytes > self.disk_capacity and self._disk:
            h, entry = self._disk.popitem(last=False)
            self.disk_bytes -= entry.wire_bytes
            self._unlink(entry.path)
            self.total_evictions += 1

    def _spill_locked(self, h: bytes, entry: _Entry) -> None:
        path = os.path.join(self.disk_dir, f"{h.hex()}.kvf")
        header = {"manifest": entry.manifest,
                  "frames": [[seq, total, crc, len(data)]
                             for seq, total, crc, data in entry.frames],
                  "wire_bytes": entry.wire_bytes,
                  "raw_bytes": entry.raw_bytes}
        try:
            with open(path, "wb") as fh:
                fh.write(json.dumps(header).encode() + b"\n")
                for _seq, _total, _crc, data in entry.frames:
                    fh.write(data)
        except OSError:
            logger.warning("kv store spill to %s failed; page dropped",
                           path)
            self.total_evictions += 1
            return
        self._disk[h] = _Entry(None, entry.manifest, entry.wire_bytes,
                               entry.raw_bytes, entry.born, path=path)
        self.disk_bytes += entry.wire_bytes
        self.total_spills += 1

    @staticmethod
    def _unlink(path) -> None:
        try:
            if path:
                os.unlink(path)
        except OSError:
            pass

    def _load_disk_frames(self, entry: _Entry) -> Optional[list]:
        """Read a spilled entry's frames back into memory (called under
        the lock; spill files are small). A torn/corrupt HEADER is
        detected here; corrupt frame DATA is detected downstream by the
        receiver's frame CRC."""
        try:
            with open(entry.path, "rb") as fh:
                header = json.loads(fh.readline())
                metas = header["frames"]
                blob = fh.read()
            out, off = [], 0
            for seq, total, crc, size in metas:
                # a truncated file yields SHORT data here — the frame
                # then fails its CRC at the receiver (counted corrupt,
                # degrades to a miss) instead of raising
                out.append((int(seq), int(total), int(crc),
                            blob[off:off + int(size)]))
                off += int(size)
            return out
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # -- TTL / wipe ----------------------------------------------------------

    def _gc_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        for tier, dec in ((self._dram, "dram_bytes"),
                          (self._disk, "disk_bytes")):
            stale = [h for h, e in tier.items()
                     if now - e.born > self.ttl_s]
            for h in stale:
                entry = tier.pop(h)
                setattr(self, dec, getattr(self, dec) - entry.wire_bytes)
                if entry.path:
                    self._unlink(entry.path)
                self.total_expired += 1
                self.total_evictions += 1

    @thread_seam
    def clear(self) -> None:
        """Wipe both tiers (tests / operator reset). Counted as
        evictions so the ledger stays balanced."""
        with self._lock:
            n = len(self._dram) + len(self._disk) + len(self._pending)
            for entry in self._disk.values():
                self._unlink(entry.path)
            self._dram.clear()
            self._disk.clear()
            self._pending.clear()
            self.dram_bytes = self.disk_bytes = 0
            self.total_evictions += n

    # -- advertising ---------------------------------------------------------

    @thread_seam
    def inventory(self, max_entries: int = 0) -> list:
        """Hashes currently held (both tiers, insertion order) — the
        router's store-hint input, shaped exactly like a replica's
        ``prefix_inventory``. ``max_entries > 0`` keeps the newest."""
        with self._lock:
            self._gc_locked(time.monotonic())
            keys = list(self._dram.keys()) + list(self._disk.keys())
        if max_entries > 0:
            keys = keys[-max_entries:]
        return keys

    @thread_seam
    def holds(self, h: bytes) -> bool:
        with self._lock:
            return h in self._dram or h in self._disk

    # -- fetch ---------------------------------------------------------------

    @thread_seam
    def fetch(self, hashes: list, receiver) -> Optional[dict]:
        """Serve a prefix fetch: replay the cached frames for the
        longest held prefix of ``hashes`` through ``receiver`` (the
        standard courier reassembly path — frame CRC, end-to-end raw
        CRC, decode) and return ``{"hashes": [hex], "pages": payload}``.
        Returns None — a counted miss — when the first requested hash
        is absent, expired, or its frames fail verification. Frames are
        retransmitted byte-identical; nothing is recompressed."""
        served: list = []
        pages = None
        for h in hashes:
            h = bytes(h)
            now = time.monotonic()
            with self._lock:
                self._gc_locked(now)
                entry = self._dram.get(h)
                if entry is not None:
                    self._dram.move_to_end(h)
                    frames = list(entry.frames)
                else:
                    entry = self._disk.get(h)
                    if entry is None:
                        break
                    self._disk.move_to_end(h)
                    frames = self._load_disk_frames(entry)
                    if frames is None:
                        # torn spill file: drop the entry, count it as
                        # a corrupt rejection -> miss for this chain
                        self._disk.pop(h, None)
                        self.disk_bytes -= entry.wire_bytes
                        self._unlink(entry.path)
                        self.total_corrupt += 1
                        self.total_evictions += 1
                        break
                manifest = entry.manifest
                wire = entry.wire_bytes
            payload = self._replay(h, frames, manifest, receiver)
            if payload is None:
                break
            got = payload.get("pages")
            if not isinstance(got, dict):
                break
            try:
                merged = got if pages is None else \
                    concat_page_payloads(pages, got)
            except (ValueError, KeyError, TypeError):
                break    # mixed-kind entries (pool rebuilt between
                #          demotions): serve the consistent prefix only
            pages = merged
            served.append(h.hex())
            with self._lock:
                self.total_hits += 1
                self.total_bytes_served += wire
        if not served:
            with self._lock:
                self.total_misses += 1
            return None
        return {"hashes": served, "pages": pages}

    def _replay(self, h: bytes, frames, manifest, receiver):
        """Push one entry's frames (fresh ticket, byte-identical data)
        into the receiver and claim the decoded payload. Any rejected
        frame — disk rot, a tampered DRAM buffer — is a counted corrupt
        rejection; the entry is dropped so the next placement stops
        being hinted at it."""
        ticket = f"kvstore-{uuid.uuid4().hex[:16]}"
        ok = True
        for seq, total, crc, data in frames:
            ack = receiver.add_chunk(CourierChunk(
                ticket=ticket, seq=seq, total=total, crc32=crc,
                data=data, manifest=manifest if seq == 0 else None))
            if not ack.get("ok"):
                ok = False
                break
        payload = receiver.take_payload(ticket) if ok else None
        if payload is None:
            with self._lock:
                self.total_corrupt += 1
                entry = self._dram.pop(h, None)
                if entry is not None:
                    self.dram_bytes -= entry.wire_bytes
                entry = self._disk.pop(h, None)
                if entry is not None:
                    self.disk_bytes -= entry.wire_bytes
                    self._unlink(entry.path)
                self.total_evictions += 1
            logger.warning(
                "kv store entry %s failed replay verification; dropped "
                "(fetch degrades to plain prefill)", h.hex())
        return payload

    # -- introspection -------------------------------------------------------

    @thread_seam
    def snapshot(self) -> dict:
        """Counters + tier occupancy for the supervisor snapshot,
        `fleet status`, and the Prometheus pump (running totals; the
        pump deltas them)."""
        with self._lock:
            return {
                "hits": self.total_hits,
                "misses": self.total_misses,
                "demotions": self.total_demotions,
                "duplicates": self.total_duplicates,
                "evictions": self.total_evictions,
                "expired": self.total_expired,
                "spills": self.total_spills,
                "corrupt": self.total_corrupt,
                "bytes_served": self.total_bytes_served,
                "bytes_stored": self.total_bytes_stored,
                "pending": len(self._pending),
                "dram_entries": len(self._dram),
                "dram_bytes": self.dram_bytes,
                "dram_capacity_bytes": self.dram_capacity,
                "disk_entries": len(self._disk),
                "disk_bytes": self.disk_bytes,
                "codec": self.codec,
            }
