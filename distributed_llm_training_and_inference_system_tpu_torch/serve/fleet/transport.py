"""Fault-tolerant courier transport: chunked KV payload movement.

A copy of the JAX package's ``serve/fleet/transport.py`` (which imports no
JAX), frame for frame: a manifest and its chunks are byte-identical to the
JAX package's for the same payload. One difference of form: the port's
host payloads hold bf16 pages as ``uint16`` arrays of the dtype
``kv_cache.BF16_HOST``, which the manifest names ``"bfloat16"`` as JAX's
``str(arr.dtype)`` does; decoding maps ``"bfloat16"`` back to that dtype
without ``ml_dtypes``.

PRs 3-4 move sequences between replicas WITH their paged KV, but the
payload "transport" was a Python reference handed across threads — fine
in-proc, meaningless across hosts. A production fleet (DistServe /
Splitwise, PAPERS.md) moves KV over links that drop, corrupt, stall,
and duplicate data, and disaggregation only pays off when that transfer
is reliable with bounded tail latency. This module is that link layer:

- ``encode_payload``/``decode_payload`` — flatten a ``swapped_kv``-shaped
  payload (fp pages, int8 QuantPages / packed-int4 Int4Pages dicts,
  partial crash-salvage payloads, SpecState scalars) into one byte blob
  plus a JSON-able manifest; decode is the exact inverse (byte-for-byte
  round trip, property-tested). The manifest negotiates a **wire
  codec** (``none`` | ``zlib`` | ``delta-zlib``): delta-zlib
  delta-encodes quantized page planes along the token axis (CacheGen's
  observation — adjacent tokens' KV is strongly correlated) and
  deflates each chunk, pipelined behind the send (``FramePipeline``),
  for 2-4x fewer wire bytes on quantized KV with chaos semantics and
  end-to-end verification unchanged.
- ``CourierChunk`` — a bounded-size frame carrying (ticket, seq, total,
  CRC32, bytes); chunk 0 additionally carries the manifest.
- ``CourierReceiver`` — destination half: per-ticket reassembly that is
  idempotent under duplicates, rejects corrupt chunks by checksum, and
  reports which sequence numbers are still missing so a retry sends ONLY
  those (resumable transfer). A completed transfer is verified end-to-end
  (whole-blob CRC), decoded, and **attached by ticket** in a host-local
  ready store: the destination replica claims it locally at submit time
  (``take_payload``), with no sender round-trip. Abandoned tickets —
  reassembly buffers whose sender died, attached payloads whose
  placement never landed — expire after ``courier_ticket_ttl_ms``.
- ``CourierTransport`` — sender half: per-chunk deadline, retry with
  doubling backoff, abort after ``courier_max_retries`` resend rounds.
  The transfer is **push-based and destination-terminated**: chunks flow
  TO the destination host and the sender only ever sees acks.
  :class:`InProcTransport` delivers to the host-local receiver (threaded
  fleet replicas — behavior byte-for-byte identical, now with the whole
  failure matrix injectable); :class:`HTTPCourierTransport` POSTs each
  chunk to the *destination's* ``/fleet/courier/chunk`` endpoint,
  resolved from the per-replica ``fleet_endpoints`` map — real
  cross-host movement over the same framing.
- ``KVCourier`` — the fleet-facing facade the router calls: ships a
  request's ``swapped_kv`` src->dest and replaces it with a **ticket
  stub** (``{"courier_ticket": ..., "at": <where the bytes now live>}``)
  that the destination resolves locally; payloads already parked on a
  remote worker are moved worker-to-worker with a ``/worker/ship``
  command (the router moves control messages, never KV bytes). A
  transfer that exhausts its retry budget DROPS the payload so the
  destination re-prefills from tokens — degraded, never wrong, never a
  stuck ticket.

Failure semantics, in one line: corruption is detected (CRC per chunk +
whole-blob), loss is retried (missing chunks only), duplication is
idempotent, stalls are bounded (per-chunk deadline), abandoned state is
garbage-collected (ticket TTL), and total failure degrades to the
existing re-prefill fallback.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import uuid
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..kv_cache import BF16_HOST, host_dtype_name

logger = logging.getLogger("llmctl.serve.fleet.transport")


class TransportError(RuntimeError):
    """Base for courier transport failures."""


class ChunkCorrupt(TransportError):
    """A chunk's bytes do not match its CRC32."""


class TransferAborted(TransportError):
    """The transfer exhausted its retry budget or failed end-to-end
    verification; the payload must be considered lost."""


# -- payload <-> (manifest, blob) -------------------------------------------
#
# A courier payload is the ``Request.swapped_kv`` schema: scalars
# (positions, last_token, partial, the SpecState "spec" sub-dict) plus a
# ``pages`` dict whose "k"/"v" entries are plain ndarrays
# [L, NP, Nkv, PS, D], int8 QuantPages dicts {"values": int8
# [L,NP,Nkv,PS,D], "scale": fp32 [L,NP,Nkv,PS]}, or packed-int4
# Int4Pages dicts (values uint8 with the page-slot axis halved, same
# scale tile). Arrays are walked in sorted-key order so encode is
# deterministic; dtypes ride the manifest, so uint8 nibbles round-trip
# bit-exactly with no int4-specific code here.
#
# -- wire codecs (CacheGen-style, SIGCOMM '24 — PAPERS.md) --
#
# The manifest additionally declares a ``codec`` the chunk frames are
# encoded with:
#
# - ``none``       — raw bytes (wire-compatible with every prior PR);
# - ``zlib``       — each chunk's data is deflate-compressed;
# - ``delta-zlib`` — quantized page VALUE planes are first
#   delta-encoded along the page-slot (token) axis (mod-256 byte deltas
#   for int8, mod-16 nibble deltas for packed int4 — the shared
#   ops/quantization.py helpers, so the codec, the write path, and the
#   gather fallback agree on the nibble/byte layout), then chunks
#   deflate. Adjacent tokens' quantized KV is strongly correlated, so
#   the deltas concentrate near zero and compress 2-4x where raw int8
#   pages barely deflate at all; fp payloads and fp32 scale tiles skip
#   the delta (it has no structure to expose there) and take plain
#   per-chunk zlib.
#
# Layering, so a codec bug can never produce silently-wrong KV: the
# manifest's ``crc32`` covers the RAW (pre-filter, pre-compression)
# bytes and is verified after full decode, while each chunk's frame CRC
# covers the COMPRESSED bytes actually on the wire — chaos semantics
# (drop/corrupt/duplicate/resend) operate on opaque frames exactly as
# before. A receiver that does not know a manifest's codec rejects the
# transfer loudly (fatal ack -> sender aborts -> re-prefill).

CODEC_NONE = "none"
CODEC_ZLIB = "zlib"
CODEC_DELTA_ZLIB = "delta-zlib"
KNOWN_CODECS = (CODEC_NONE, CODEC_ZLIB, CODEC_DELTA_ZLIB)

# delta filters recorded per array spec under delta-zlib. Selection is
# by dtype: int8 arrays are quantized KV value planes (byte deltas along
# the page-slot axis, -2); uint8 arrays are packed-int4 planes (nibble
# deltas along the packed page-slot axis, -2). Both are bijective, so a
# misclassified array costs ratio, never correctness.
_FILTER_DELTA8 = "delta8"
_FILTER_DELTA4 = "delta4"


def _filter_for(arr: np.ndarray) -> Optional[str]:
    if arr.ndim < 2:
        return None
    if arr.dtype == np.int8:
        return _FILTER_DELTA8
    if arr.dtype == np.uint8:
        return _FILTER_DELTA4
    return None


def _filter_encode(arr: np.ndarray, filt: str) -> np.ndarray:
    from ...ops.quantization import (delta_encode_planes_np,
                                     nibble_delta_encode_np)
    if filt == _FILTER_DELTA8:
        return delta_encode_planes_np(arr, axis=-2)
    if filt == _FILTER_DELTA4:
        return nibble_delta_encode_np(arr, axis=-2)
    raise TransferAborted(f"unknown array filter {filt!r}")


def _filter_decode(arr: np.ndarray, filt: str) -> np.ndarray:
    from ...ops.quantization import (delta_decode_planes_np,
                                     nibble_delta_decode_np)
    if filt == _FILTER_DELTA8:
        return delta_decode_planes_np(arr, axis=-2)
    if filt == _FILTER_DELTA4:
        return nibble_delta_decode_np(arr, axis=-2)
    raise TransferAborted(f"unknown array filter {filt!r}")


def _walk_arrays(node, prefix, out):
    if isinstance(node, dict):
        for k in sorted(node):
            v = node[k]
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, (dict, np.ndarray)):
                _walk_arrays(v, path, out)
    else:
        out.append((prefix, np.ascontiguousarray(node)))


def _scalars(node, prefix, out):
    if isinstance(node, dict):
        for k in sorted(node):
            v = node[k]
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                _scalars(v, path, out)
            elif not isinstance(v, np.ndarray):
                # numpy scalar ints (np.int64 etc.) JSON-serialize poorly
                out[path] = v.item() if hasattr(v, "item") else v


def _host_only(node, prefix: str = "") -> None:
    """Refuse a torch tensor anywhere in a payload: an extract fills its
    pinned host tensors asynchronously, so the courier encodes only the
    numpy arrays that ``kv_cache.payload_numpy`` makes after waiting for
    the card."""
    if isinstance(node, dict):
        for k, v in node.items():
            _host_only(v, f"{prefix}.{k}" if prefix else k)
    elif type(node).__module__.split(".")[0] == "torch":
        raise TypeError(
            f"courier payload entry {prefix!r} is a torch tensor; encode "
            "the host arrays of kv_cache.payload_numpy instead")


def encode_payload(payload: dict, codec: str = CODEC_NONE,
                   zlib_level: int = -1) -> tuple[dict, bytes]:
    """Flatten a courier payload into (manifest, blob). The manifest is
    JSON-able (the HTTP transport sends it verbatim) and carries the
    whole-payload CRC32 over the RAW bytes, used for end-to-end
    verification after reassembly (and, under a codec, after
    decompression + inverse filtering — so a codec bug aborts the
    transfer instead of restoring wrong KV). Under ``delta-zlib`` the
    returned blob holds the delta-FILTERED bytes (size-preserving); the
    per-chunk deflate happens at framing time.

    ``zlib_level`` (-1 = zlib's default, the pre-PR-13 behavior) is
    recorded in the manifest under a compressing codec so the SENDER
    side frames deterministically at that level; receivers stay
    agnostic — inflate never needs the level, so mixed-level fleets
    interoperate freely."""
    if codec not in KNOWN_CODECS:
        raise ValueError(f"unknown courier codec {codec!r} "
                         f"({'|'.join(KNOWN_CODECS)})")
    if not -1 <= int(zlib_level) <= 9:
        raise ValueError(
            f"courier zlib level {zlib_level!r} outside [-1, 9]")
    _host_only(payload)
    arrays: list[tuple[str, np.ndarray]] = []
    _walk_arrays(payload, "", arrays)
    scalars: dict = {}
    _scalars(payload, "", scalars)
    parts = []
    specs = []
    offset = 0
    raw_crc = 0
    for path, arr in arrays:
        raw = arr.tobytes()
        raw_crc = zlib.crc32(raw, raw_crc)
        spec = {"path": path, "dtype": host_dtype_name(arr.dtype),
                "shape": list(arr.shape), "offset": offset,
                "nbytes": len(raw)}
        if codec == CODEC_DELTA_ZLIB:
            filt = _filter_for(arr)
            if filt is not None:
                raw = _filter_encode(arr, filt).tobytes()
                spec["filter"] = filt
        specs.append(spec)
        parts.append(raw)
        offset += len(raw)
    blob = b"".join(parts)
    manifest = {"scalars": scalars, "arrays": specs,
                "nbytes": len(blob), "crc32": raw_crc, "codec": codec}
    if codec != CODEC_NONE:
        manifest["zlib_level"] = int(zlib_level)
    return manifest, blob


def _set_path(root: dict, path: str, value) -> None:
    keys = path.split(".")
    node = root
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def decode_payload(manifest: dict, blob: bytes) -> dict:
    """Inverse of :func:`encode_payload`. Verifies the end-to-end CRC
    over the RAW bytes (after undoing any delta filter) — a payload
    that does not match aborts the transfer rather than restoring
    corrupt KV (wrong tokens are the one unacceptable failure mode),
    and that check covers codec bugs too: a broken filter inverse
    produces a CRC mismatch, never silently-wrong pages."""
    codec = manifest.get("codec", CODEC_NONE)
    if codec not in KNOWN_CODECS:
        raise TransferAborted(
            f"payload declares codec {codec!r} this receiver does not "
            f"speak ({'|'.join(KNOWN_CODECS)})")
    if len(blob) != manifest["nbytes"]:
        raise TransferAborted(
            f"end-to-end verification failed: {len(blob)} bytes != "
            f"declared {manifest['nbytes']}")
    out: dict = {}
    for path, value in manifest["scalars"].items():
        _set_path(out, path, value)
    raw_crc = 0
    for spec in manifest["arrays"]:
        raw = blob[spec["offset"]:spec["offset"] + spec["nbytes"]]
        dtype = (BF16_HOST if spec["dtype"] == "bfloat16"
                 else np.dtype(spec["dtype"]))
        arr = np.frombuffer(raw, dtype=dtype).reshape(
            spec["shape"]).copy()    # writable, owns its memory
        filt = spec.get("filter")
        if filt is not None:
            arr = np.ascontiguousarray(_filter_decode(arr, filt))
        raw_crc = zlib.crc32(arr.tobytes(), raw_crc)
        _set_path(out, spec["path"], arr)
    if raw_crc != manifest["crc32"]:
        raise TransferAborted(
            f"end-to-end verification failed: raw crc {raw_crc} != "
            f"{manifest['crc32']}")
    return out


# -- chunk framing -----------------------------------------------------------


@dataclass
class CourierChunk:
    """One bounded-size frame. ``crc32`` covers ``data`` only; chunk 0
    carries the transfer manifest so a receiver can be built from any
    arriving copy of it."""
    ticket: str
    seq: int
    total: int
    crc32: int
    data: bytes
    manifest: Optional[dict] = None

    def to_wire(self) -> dict:
        """JSON-able form for the HTTP transport (data base64-encoded)."""
        wire = {"ticket": self.ticket, "seq": self.seq, "total": self.total,
                "crc32": self.crc32,
                "data": base64.b64encode(self.data).decode()}
        if self.manifest is not None:
            wire["manifest"] = self.manifest
        return wire

    @classmethod
    def from_wire(cls, wire: dict) -> "CourierChunk":
        return cls(ticket=str(wire["ticket"]), seq=int(wire["seq"]),
                   total=int(wire["total"]), crc32=int(wire["crc32"]),
                   data=base64.b64decode(wire["data"]),
                   manifest=wire.get("manifest"))


def _frame_chunk(ticket: str, manifest: dict, blob: bytes, seq: int,
                 total: int, chunk_bytes: int, codec: str,
                 level: int = -1) -> CourierChunk:
    """Build ONE wire frame: slice [seq*chunk_bytes, ...) of the blob,
    deflate it under a compressing codec (at the manifest's recorded
    zlib level), CRC the bytes that actually travel. Deterministic, so
    a retransmitted frame is byte-identical."""
    data = blob[seq * chunk_bytes:(seq + 1) * chunk_bytes]
    if codec != CODEC_NONE:
        data = zlib.compress(data, level)
    return CourierChunk(
        ticket=ticket, seq=seq, total=total, crc32=zlib.crc32(data),
        data=data, manifest=manifest if seq == 0 else None)


def make_chunks(ticket: str, manifest: dict, blob: bytes,
                chunk_bytes: int) -> list[CourierChunk]:
    """Split a blob into CRC-framed chunks (compressed per chunk when the
    manifest declares a codec). A zero-length blob (a payload of pure
    scalars) still produces one chunk so the manifest travels."""
    codec = manifest.get("codec", CODEC_NONE)
    level = int(manifest.get("zlib_level", -1))
    n = max((len(blob) + chunk_bytes - 1) // chunk_bytes, 1)
    return [_frame_chunk(ticket, manifest, blob, i, n, chunk_bytes, codec,
                         level)
            for i in range(n)]


class FramePipeline:
    """Sender-side lazy framer with a bounded TWO-SLOT compression
    pipeline: while frame *k* is in flight on the wire, frame *k+1*
    deflates on a background thread — compression latency hides behind
    the send instead of adding to the transfer (and therefore to the
    migration stop-and-copy pause the transfer sits inside). Frames are
    cached by seq, so resend rounds retransmit byte-identical frames
    without recompressing. Single-consumer: ``frame`` is called from the
    transfer loop only; the one background slot is always joined before
    its frame is read."""

    def __init__(self, ticket: str, manifest: dict, blob: bytes,
                 chunk_bytes: int, codec: str):
        self.ticket = ticket
        self.manifest = manifest
        self.blob = blob
        self.chunk_bytes = chunk_bytes
        self.codec = codec
        self.level = int(manifest.get("zlib_level", -1))
        self.total = max((len(blob) + chunk_bytes - 1) // chunk_bytes, 1)
        self._frames: dict[int, CourierChunk] = {}
        self._ahead: Optional[tuple[int, threading.Thread]] = None

    def raw_len(self, seq: int) -> int:
        """Pre-compression bytes frame ``seq`` covers (the bytes_raw
        side of the wire/raw ledger)."""
        lo = seq * self.chunk_bytes
        return max(min(len(self.blob) - lo, self.chunk_bytes), 0)

    def _build(self, seq: int) -> None:
        if seq not in self._frames:
            self._frames[seq] = _frame_chunk(
                self.ticket, self.manifest, self.blob, seq, self.total,
                self.chunk_bytes, self.codec, self.level)

    def frame(self, seq: int,
              prefetch: Optional[int] = None) -> CourierChunk:
        """The frame for ``seq`` (compressing inline unless the
        background slot already built it), kicking off background
        compression of ``prefetch`` for the next send."""
        if self._ahead is not None and (
                self._ahead[0] == seq or not self._ahead[1].is_alive()):
            self._ahead[1].join()
            self._ahead = None
        self._build(seq)
        if prefetch is not None and self._ahead is None \
                and prefetch not in self._frames:
            th = threading.Thread(target=self._build, args=(prefetch,),
                                  daemon=True,
                                  name="llmctl-courier-compress")
            th.start()
            self._ahead = (prefetch, th)
        return self._frames[seq]


class ChunkReassembler:
    """Destination-side state for ONE transfer: accepts chunks in any
    order, drops duplicates idempotently, rejects corrupt frames, and
    reports what is still missing."""

    def __init__(self, total: int):
        self.total = total
        self.manifest: Optional[dict] = None
        self._data: dict[int, bytes] = {}
        self.duplicates = 0

    def add(self, chunk: CourierChunk) -> bool:
        """Accept one chunk. Returns False for an (idempotent) duplicate;
        raises :class:`ChunkCorrupt` when the CRC does not match — the
        caller treats that exactly like a dropped chunk (retransmit)."""
        if not 0 <= chunk.seq < self.total:
            raise ChunkCorrupt(
                f"chunk seq {chunk.seq} outside [0, {self.total})")
        if zlib.crc32(chunk.data) != chunk.crc32:
            raise ChunkCorrupt(
                f"chunk {chunk.seq}/{self.total} failed CRC32")
        if chunk.manifest is not None and self.manifest is None:
            self.manifest = chunk.manifest
        if chunk.seq in self._data:
            self.duplicates += 1
            return False
        self._data[chunk.seq] = chunk.data
        return True

    def missing(self) -> list[int]:
        return [i for i in range(self.total) if i not in self._data]

    def complete(self) -> bool:
        return self.manifest is not None and len(self._data) == self.total

    def payload(self) -> dict:
        """Reassemble + decode: per-chunk decompression under the
        manifest's codec, then the end-to-end RAW CRC inside
        decode_payload. Every frame already passed its wire CRC, so a
        decompression failure here is a sender-side bug — fatal, not
        retryable."""
        if not self.complete():
            raise TransferAborted(
                f"reassembly incomplete: missing {self.missing()}")
        codec = self.manifest.get("codec", CODEC_NONE)
        parts = [self._data[i] for i in range(self.total)]
        if codec not in KNOWN_CODECS:
            raise TransferAborted(
                f"transfer declares codec {codec!r} this receiver does "
                f"not speak ({'|'.join(KNOWN_CODECS)})")
        if codec != CODEC_NONE:
            try:
                parts = [zlib.decompress(p) for p in parts]
            except zlib.error as e:
                raise TransferAborted(
                    f"chunk decompression failed under codec "
                    f"{codec!r}: {e}")
        return decode_payload(self.manifest, b"".join(parts))


class CourierReceiver:
    """Destination half shared by every transport: per-ticket reassembly
    behind a lock (chunks may arrive from any thread / HTTP worker).
    The same object backs the in-proc delivery path AND the
    ``/fleet/courier/chunk`` endpoint, so both are the same tested code.

    A transfer that completes is immediately verified end-to-end,
    decoded, and moved to the **ready store**: the destination replica
    attaches it locally by ticket at submit time (:meth:`take_payload`)
    — the remote restorer. ``put_payload`` parks a locally-extracted
    payload in the same store (a worker stashing a drain victim's pages
    until the control plane decides where they go). Both stores are
    TTL-bounded: a ticket nobody finishes or claims within ``ttl_ms`` is
    evicted (counted in ``expired``, logged) instead of leaking host
    memory forever."""

    def __init__(self, max_tickets: int = 64, ttl_ms: float = 0.0,
                 codecs=None):
        self._lock = threading.Lock()
        # codecs this receiver ACCEPTS (the negotiation surface): a
        # manifest declaring anything else is rejected with a fatal ack
        # at the first manifest-carrying chunk, so the sender aborts
        # without pushing the rest of the payload
        self.codecs = frozenset(codecs) if codecs else \
            frozenset(KNOWN_CODECS)
        self._tickets: "dict[str, ChunkReassembler]" = {}
        self._born: dict[str, float] = {}           # reassembly birth
        self._order: deque = deque()
        self._ready: "dict[str, tuple[float, dict]]" = {}
        self._max = max_tickets
        self.ttl_s = float(ttl_ms) / 1e3
        self.expired = 0          # tickets evicted by TTL or cap pressure
        self.attached = 0         # payloads handed to a local restore

    def _gc_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        stale = [t for t, born in self._born.items()
                 if now - born > self.ttl_s]
        for t in stale:
            self._tickets.pop(t, None)
            self._born.pop(t, None)
            if t in self._order:
                self._order.remove(t)
            self.expired += 1
            logger.warning("courier ticket %s expired mid-reassembly "
                           "(ttl %.3gs)", t, self.ttl_s)
        stale = [t for t, (born, _p) in self._ready.items()
                 if now - born > self.ttl_s]
        for t in stale:
            self._ready.pop(t, None)
            self.expired += 1
            logger.warning("courier ticket %s expired unclaimed "
                           "(ttl %.3gs)", t, self.ttl_s)

    def add_chunk(self, chunk: CourierChunk) -> dict:
        """Idempotent chunk ingestion. Returns the ack the sender's retry
        loop consumes: {ok, duplicate, complete, missing}. Corrupt chunks
        return ok=False (the sender counts + retransmits). On the chunk
        that completes the transfer, the blob is CRC-verified end-to-end
        and decoded into the ready store; a verification failure is fatal
        (every per-chunk CRC passed, so resending cannot fix it) and acks
        ``{"ok": False, "fatal": True}`` so the sender aborts."""
        now = time.monotonic()
        with self._lock:
            self._gc_locked(now)
            if chunk.ticket in self._ready:
                # full retransmit of an already-attached transfer
                return {"ok": True, "duplicate": True, "complete": True,
                        "missing": []}
            if chunk.manifest is not None:
                codec = chunk.manifest.get("codec", CODEC_NONE)
                if codec not in self.codecs:
                    # undeclared codec: reject LOUDLY and drop any
                    # partial reassembly — resending cannot fix a codec
                    # this build does not speak
                    self._tickets.pop(chunk.ticket, None)
                    self._born.pop(chunk.ticket, None)
                    if chunk.ticket in self._order:
                        self._order.remove(chunk.ticket)
                    logger.error(
                        "courier ticket %s rejected: codec %r not in "
                        "accepted set %s", chunk.ticket, codec,
                        sorted(self.codecs))
                    return {"ok": False, "fatal": True,
                            "error": f"receiver does not accept courier "
                                     f"codec {codec!r}",
                            "complete": False, "missing": []}
            r = self._tickets.get(chunk.ticket)
            if r is None:
                r = ChunkReassembler(chunk.total)
                self._tickets[chunk.ticket] = r
                self._born[chunk.ticket] = now
                self._order.append(chunk.ticket)
                while len(self._order) > self._max:
                    dropped = self._order.popleft()
                    self._tickets.pop(dropped, None)
                    self._born.pop(dropped, None)
                    self.expired += 1
            try:
                fresh = r.add(chunk)
            except ChunkCorrupt as e:
                return {"ok": False, "error": str(e),
                        "missing": r.missing(), "complete": False}
            if not r.complete():
                return {"ok": True, "duplicate": not fresh,
                        "complete": False, "missing": r.missing()}
            # completion: verify + decode + attach, then drop reassembly
            self._tickets.pop(chunk.ticket, None)
            self._born.pop(chunk.ticket, None)
            if chunk.ticket in self._order:
                self._order.remove(chunk.ticket)
            try:
                payload = r.payload()       # end-to-end CRC inside
            except TransportError as e:
                return {"ok": False, "fatal": True, "error": str(e),
                        "complete": False, "missing": []}
            self._ready[chunk.ticket] = (now, payload)
            self._cap_ready_locked()
            return {"ok": True, "duplicate": not fresh, "complete": True,
                    "missing": []}

    def _cap_ready_locked(self) -> None:
        while len(self._ready) > self._max:
            oldest = min(self._ready, key=lambda t: self._ready[t][0])
            self._ready.pop(oldest)
            self.expired += 1
            logger.warning("courier ticket %s evicted (ready store over "
                           "%d tickets)", oldest, self._max)

    def put_payload(self, ticket: str, payload: dict) -> None:
        """Park an already-materialized payload in the ready store (a
        worker stashing extracted pages until the router places them).
        Subject to the same TTL as pushed transfers."""
        now = time.monotonic()
        with self._lock:
            self._gc_locked(now)
            self._ready[ticket] = (now, payload)
            self._cap_ready_locked()

    def take_payload(self, ticket: str) -> Optional[dict]:
        """Attach a completed transfer to a local restore: pop and return
        the decoded payload, or None when the ticket is unknown, still
        incomplete, or expired — the caller falls back to re-prefill."""
        with self._lock:
            self._gc_locked(time.monotonic())
            entry = self._ready.pop(ticket, None)
            if entry is not None:
                self.attached += 1
                return entry[1]
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"expired": self.expired, "attached": self.attached,
                    "reassembling": len(self._tickets),
                    "ready": len(self._ready)}


# -- transport stats ---------------------------------------------------------


@dataclass
class TransportStats:
    """Thread-safe running totals; snapshot() follows the supervisor's
    delta-on-running-totals Prometheus contract (transfer_ms is a bounded
    recent window + cumulative count, like migration pauses)."""
    chunks: int = 0           # chunk send attempts (incl. retransmits)
    retries: int = 0          # chunk retransmissions
    corruptions: int = 0      # CRC rejections observed
    duplicates: int = 0       # duplicate deliveries absorbed
    resumes: int = 0          # resend rounds (only missing chunks resent)
    aborts: int = 0           # transfers that gave up (payload dropped)
    transfers: int = 0        # completed transfers
    bytes_moved: int = 0
    # wire-vs-raw codec ledger, counted per send ATTEMPT (retransmits
    # included — they cost wire bytes too): bytes_raw is what the chunk
    # covered before compression, bytes_wire what actually traveled.
    # raw/wire is the effective compression ratio; under codec "none"
    # the two are equal.
    bytes_raw: int = 0
    bytes_wire: int = 0
    in_flight: int = 0
    transfer_ms: deque = field(default_factory=lambda: deque(maxlen=64))
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def bump(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def note_transfer(self, ms: float, nbytes: int) -> None:
        with self._lock:
            self.transfers += 1
            self.bytes_moved += nbytes
            self.transfer_ms.append(float(ms))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "chunks": self.chunks, "retries": self.retries,
                "corruptions": self.corruptions,
                "duplicates": self.duplicates, "resumes": self.resumes,
                "aborts": self.aborts, "transfers": self.transfers,
                "bytes_moved": self.bytes_moved,
                "bytes_raw": self.bytes_raw,
                "bytes_wire": self.bytes_wire,
                "compression_ratio": round(
                    self.bytes_raw / self.bytes_wire, 3)
                if self.bytes_wire else 1.0,
                "in_flight": self.in_flight,
                "transfer_ms": list(self.transfer_ms),
                "transfer_count": self.transfers,
            }


# -- sender half -------------------------------------------------------------


class CourierTransport:
    """Sender-side framing + retry/deadline/backoff loop. Subclasses
    implement ``_send_chunk`` (one delivery attempt -> ack dict or None
    for loss/timeout). The transfer is destination-terminated: on
    success the payload sits ATTACHED BY TICKET in the destination
    host's receiver ready store — the sender never sees the bytes
    again."""

    def __init__(self, cfg=None, injector=None,
                 stats: Optional[TransportStats] = None):
        # duck-typed FleetConfig: tests pass a SimpleNamespace
        self.chunk_bytes = int(getattr(cfg, "courier_chunk_bytes",
                                       256 * 1024))
        self.max_retries = int(getattr(cfg, "courier_max_retries", 4))
        self.backoff_ms = float(getattr(cfg, "courier_retry_backoff_ms",
                                        2.0))
        self.backoff_max_ms = float(getattr(
            cfg, "courier_retry_backoff_max_ms", 100.0))
        self.deadline_ms = float(getattr(cfg, "courier_chunk_deadline_ms",
                                         100.0))
        self.codec = str(getattr(cfg, "courier_codec", CODEC_NONE)
                         or CODEC_NONE)
        if self.codec not in KNOWN_CODECS:
            raise ValueError(f"unknown courier codec {self.codec!r} "
                             f"({'|'.join(KNOWN_CODECS)})")
        self.zlib_level = int(getattr(cfg, "courier_zlib_level", -1))
        if not -1 <= self.zlib_level <= 9:
            raise ValueError(
                f"courier zlib level {self.zlib_level} outside [-1, 9]")
        self.injector = injector
        self.stats = stats or TransportStats()

    # subclass surface ------------------------------------------------------

    def _send_chunk(self, chunk: CourierChunk, src: Optional[int],
                    dest: Optional[int]) -> Optional[dict]:
        raise NotImplementedError

    # the transfer loop -----------------------------------------------------

    def transfer(self, payload: dict, src: Optional[int] = None,
                 dest: Optional[int] = None,
                 ticket: Optional[str] = None) -> str:
        """Push one payload to the destination's receiver. Returns the
        ticket under which the (verified, decoded) payload is now
        attached there; raises TransferAborted after ``max_retries``
        resend rounds or a fatal end-to-end verification failure. Safe
        from any thread; each ticket's state is independent."""
        from .faults import DestUnreachable
        ticket = ticket or f"courier-{uuid.uuid4().hex[:16]}"
        t0 = time.perf_counter()
        self.stats.bump(in_flight=1)
        try:
            manifest, blob = encode_payload(payload, codec=self.codec,
                                            zlib_level=self.zlib_level)
            frames = FramePipeline(ticket, manifest, blob,
                                   self.chunk_bytes, self.codec)
            pending = list(range(frames.total))
            backoff_s = self.backoff_ms / 1e3
            rounds = 0
            while True:
                failed: list[int] = []
                try:
                    if self.injector is not None:
                        self.injector.on_transfer(dest)
                    for i, seq in enumerate(pending):
                        # two-slot pipeline: frame `seq` (compressed on
                        # the background slot while the PREVIOUS frame
                        # was on the wire) goes out now; the next
                        # pending frame starts compressing behind it
                        chunk = frames.frame(
                            seq, prefetch=pending[i + 1]
                            if i + 1 < len(pending) else None)
                        self.stats.bump(chunks=1,
                                        bytes_wire=len(chunk.data),
                                        bytes_raw=frames.raw_len(seq))
                        ack = self._send_chunk(chunk, src, dest)
                        if ack is None:      # lost or past its deadline
                            failed.append(seq)
                            continue
                        if not ack.get("ok"):
                            if ack.get("fatal"):
                                # completion-time e2e verification
                                # failed: every per-chunk CRC passed, so
                                # a resend cannot fix it
                                self.stats.bump(aborts=1)
                                raise TransferAborted(
                                    f"courier {ticket}: "
                                    f"{ack.get('error', 'fatal')}")
                            # receiver CRC rejection: retransmit
                            self.stats.bump(corruptions=1)
                            failed.append(seq)
                            continue
                        if ack.get("duplicate"):
                            self.stats.bump(duplicates=1)
                except DestUnreachable:
                    # nothing moved this round; retry the whole set under
                    # the same backoff schedule (a partition heals, or the
                    # budget runs out and the transfer aborts cleanly)
                    failed = list(pending)
                if not failed:
                    break
                rounds += 1
                if rounds > self.max_retries:
                    self.stats.bump(aborts=1)
                    raise TransferAborted(
                        f"courier {ticket}: {len(failed)} chunk(s) still "
                        f"undelivered after {self.max_retries} retry "
                        f"rounds")
                # resume: ONLY the missing/corrupt chunks are resent,
                # after a doubling backoff (loss is often congestion)
                self.stats.bump(retries=len(failed), resumes=1)
                time.sleep(backoff_s)
                backoff_s = min(backoff_s * 2, self.backoff_max_ms / 1e3)
                pending = failed
            self.stats.note_transfer((time.perf_counter() - t0) * 1e3,
                                     len(blob))
            return ticket
        except TransportError:
            raise
        except Exception as e:               # wire-level surprises
            self.stats.bump(aborts=1)
            raise TransferAborted(f"courier {ticket}: {e}") from e
        finally:
            self.stats.bump(in_flight=-1)


class InProcTransport(CourierTransport):
    """Same-process delivery (threaded fleet replicas). Every payload
    still crosses the full frame->checksum->reassemble->verify path, so
    today's behavior is preserved byte-for-byte while the injector can
    exercise the entire failure matrix deterministically on CPU."""

    def __init__(self, cfg=None, injector=None, stats=None, receiver=None):
        super().__init__(cfg, injector=injector, stats=stats)
        self.receiver = receiver if receiver is not None else \
            CourierReceiver(ttl_ms=float(getattr(
                cfg, "courier_ticket_ttl_ms", 0.0)))

    def _send_chunk(self, chunk, src, dest):
        fault = (self.injector.on_chunk(src, dest, chunk.ticket, chunk.seq)
                 if self.injector is not None else None)
        if fault:
            if fault.get("drop"):
                return None                       # never delivered
            if fault.get("corrupt"):
                bad = bytes([chunk.data[0] ^ 0xFF]) + chunk.data[1:] \
                    if chunk.data else b"\xff"
                return self.receiver.add_chunk(CourierChunk(
                    chunk.ticket, chunk.seq, chunk.total, chunk.crc32,
                    bad, manifest=chunk.manifest))
            delay_ms = fault.get("delay_ms", 0.0)
            if delay_ms > 0:
                # model the stall the sender actually experiences: wait
                # out min(delay, deadline). Past the deadline the sender
                # reports a timeout, but the chunk DID land — the
                # retransmit then exercises duplicate handling, exactly
                # like a real late packet.
                time.sleep(min(delay_ms, self.deadline_ms) / 1e3)
                ack = self.receiver.add_chunk(chunk)
                if delay_ms >= self.deadline_ms:
                    return None
                return ack
            if fault.get("duplicate"):
                self.receiver.add_chunk(chunk)    # the duplicate copy
        return self.receiver.add_chunk(chunk)


class HTTPCourierTransport(CourierTransport):
    """POSTs each chunk to the *destination's* ``/fleet/courier/chunk``
    endpoint — the cross-host push path. The destination is resolved per
    transfer from ``endpoints`` (the per-replica ``fleet_endpoints``
    map), falling back to ``endpoint``/``cfg.courier_endpoint`` for
    single-destination setups. Reassembly, verification, and attachment
    all happen ON the destination host; the sender only sees acks.
    Uses stdlib urllib so the sender side has no extra deps. The
    injector's seeded chunk faults (drop/corrupt/delay/duplicate) apply
    here exactly as in-proc, so chaos runs over real sockets too."""

    def __init__(self, cfg=None, injector=None, stats=None,
                 endpoint: str = "", endpoints: Optional[dict] = None):
        super().__init__(cfg, injector=injector, stats=stats)
        self.endpoint = (endpoint
                         or getattr(cfg, "courier_endpoint", "")
                         or "").rstrip("/")
        eps = endpoints
        if eps is None:
            eps = getattr(cfg, "fleet_endpoints", None) or {}
            if callable(getattr(cfg, "endpoint_map", None)):
                eps = cfg.endpoint_map()
        self.endpoints = {int(k): str(v).rstrip("/")
                          for k, v in dict(eps).items()}
        if not self.endpoint and not self.endpoints:
            raise ValueError(
                "HTTPCourierTransport needs a destination: either "
                "courier_endpoint or a fleet_endpoints map")

    def _endpoint_for(self, dest) -> str:
        ep = self.endpoints.get(dest) if dest is not None else None
        ep = ep or self.endpoint
        if not ep:
            raise TransferAborted(
                f"no courier endpoint configured for replica {dest}")
        return ep

    def _post(self, endpoint: str, path: str, body: dict,
              timeout_s: Optional[float] = None) -> Optional[dict]:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            f"{endpoint}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s
                    or max(self.deadline_ms / 1e3, 0.05)) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode())
            except Exception:
                return {"ok": False, "error": f"HTTP {e.code}"}
        except Exception as e:               # timeout / refused / reset
            logger.debug("courier chunk POST failed: %s", e)
            return None

    def _send_chunk(self, chunk, src, dest):
        endpoint = self._endpoint_for(dest)
        wire = chunk.to_wire()
        fault = (self.injector.on_chunk(src, dest, chunk.ticket, chunk.seq)
                 if self.injector is not None else None)
        if fault:
            if fault.get("drop"):
                return None                  # never sent
            if fault.get("corrupt"):
                bad = bytes([chunk.data[0] ^ 0xFF]) + chunk.data[1:] \
                    if chunk.data else b"\xff"
                wire = dict(wire, data=base64.b64encode(bad).decode())
            delay_ms = fault.get("delay_ms", 0.0)
            if delay_ms > 0:
                time.sleep(min(delay_ms, self.deadline_ms) / 1e3)
                ack = self._post(endpoint, "/fleet/courier/chunk", wire)
                if delay_ms >= self.deadline_ms:
                    return None              # landed, but the sender
                return ack                   # already called it lost
            if fault.get("duplicate"):
                self._post(endpoint, "/fleet/courier/chunk", wire)
        return self._post(endpoint, "/fleet/courier/chunk", wire)


def build_transport(cfg, injector=None,
                    stats: Optional[TransportStats] = None,
                    receiver=None):
    """FleetConfig.courier_transport -> transport instance."""
    kind = getattr(cfg, "courier_transport", "inproc") or "inproc"
    if kind == "inproc":
        return InProcTransport(cfg, injector=injector, stats=stats,
                               receiver=receiver)
    if kind == "http":
        return HTTPCourierTransport(cfg, injector=injector, stats=stats)
    raise ValueError(f"unknown courier transport {kind!r} (inproc|http)")


# -- ticket stubs ------------------------------------------------------------
#
# After a ship, the request no longer carries KV bytes: it carries a
# ticket STUB naming where the payload is attached — "local" (this
# process's receiver ready store) or a remote replica id (that worker's
# receiver). The destination resolves the stub at submit time
# (EngineReplica.submit -> receiver.take_payload; RemoteReplica.submit
# sends the ticket over the wire and the worker attaches it). The
# "partial" flag is mirrored onto the stub so routing (_needs_prefill)
# keeps working without materializing the payload.

TICKET_KEY = "courier_ticket"

# sentinel `prefix_owner` id naming the host-tier fleet KV store
# (serve/fleet/kv_store.py) instead of a live replica: the router stamps
# it when no live replica's inventory beats the store's, and
# KVCourier.fetch_prefix answers it by replaying the store's cached
# frames through the local receiver. Negative so it can never collide
# with a real replica id.
KV_STORE_OWNER = -1


def ticket_stub(ticket: str, at, partial=False) -> dict:
    return {TICKET_KEY: ticket, "at": at, "partial": bool(partial)}


def is_ticket_stub(payload) -> bool:
    return isinstance(payload, dict) and TICKET_KEY in payload


# -- fleet-facing facade -----------------------------------------------------


class KVCourier:
    """What the router actually calls: move ``req.swapped_kv`` src->dest
    before the request is submitted to the destination, leaving a ticket
    stub behind. Three physical paths, one contract:

    - bytes local, dest in-proc: push through :class:`InProcTransport`
      into the host-local receiver (full frame->verify path, injectable
      chaos), stub ``at="local"``;
    - bytes local, dest remote: push chunks to the destination worker's
      ``/fleet/courier/chunk`` (HTTP), stub ``at=dest``;
    - bytes parked on a remote worker (stub already points there): issue
      a ``/worker/ship`` command so the WORKER pushes directly to the
      destination's endpoint — the control plane never relays KV bytes.

    On abort the payload is DROPPED (degrade to the re-prefill fallback —
    correct tokens, extra compute) rather than ever handing over
    unverified bytes. Tracks a per-source breakdown for `llmctl fleet
    status` columns."""

    def __init__(self, cfg=None, injector=None, receiver=None):
        self.cfg = cfg
        self.injector = injector
        self.stats = TransportStats()
        ttl = float(getattr(cfg, "courier_ticket_ttl_ms", 0.0) or 0.0)
        self.receiver = receiver if receiver is not None else \
            CourierReceiver(ttl_ms=ttl)
        eps = getattr(cfg, "fleet_endpoints", None) or {}
        if callable(getattr(cfg, "endpoint_map", None)):
            eps = cfg.endpoint_map()
        self.endpoints = {int(k): str(v).rstrip("/")
                          for k, v in dict(eps).items()}
        remote = getattr(cfg, "remote_replica_ids", None)
        self.remote_ids: set = remote() if callable(remote) else \
            set(remote or ())
        self.force_http = (getattr(cfg, "courier_transport", "inproc")
                           == "http")
        self.ship_timeout_s = float(getattr(cfg, "courier_ship_timeout_s",
                                            30.0))
        # fleet-global prefix cache: per-replica owner-side extractors
        # for IN-PROC replicas (replica_id -> request_prefix_extract);
        # remote owners are reached over /fleet/courier/fetch instead.
        self.prefix_providers: dict[int, object] = {}
        # host-tier KV store (serve/fleet/kv_store.py): set by ServeFleet
        # when FleetConfig.kv_store is on. A fetch hinted at
        # KV_STORE_OWNER replays the store's cached frames through the
        # local receiver — the same CRC/verify path a live transfer
        # rides, so a corrupt stored frame is a counted miss, never
        # wrong KV.
        self.kv_store = None
        self.fetch_timeout_s = float(getattr(
            cfg, "prefix_fetch_timeout_s", 5.0) or 5.0)
        self.local_transport = InProcTransport(
            cfg, injector=injector, stats=self.stats,
            receiver=self.receiver)
        self._http: Optional[HTTPCourierTransport] = None
        self._lock = threading.Lock()
        self.per_src: dict[int, dict] = {}

    # kept for callers/tests that address the old attribute
    @property
    def transport(self) -> CourierTransport:
        return self.local_transport

    def _http_transport(self) -> HTTPCourierTransport:
        if self._http is None:
            self._http = HTTPCourierTransport(
                self.cfg, injector=self.injector, stats=self.stats,
                endpoints=self.endpoints)
        return self._http

    def _slot(self, src) -> dict:
        with self._lock:
            return self.per_src.setdefault(
                src, {"transfers": 0, "aborts": 0})

    def _abort(self, req, src, why) -> bool:
        logger.warning(
            "courier ship -> aborted for %s (%s); payload dropped, "
            "falling back to re-prefill",
            getattr(req, "request_id", "?"), why)
        req.swapped_kv = None
        slot = self._slot(src)
        with self._lock:
            slot["aborts"] += 1
        return False

    def ship(self, req, src: Optional[int], dest: Optional[int]) -> bool:
        """Returns True when the request is ready to submit to ``dest``
        (payload attached at the destination, or there was nothing to
        ship). False = the transfer aborted and the payload is gone; the
        caller must re-plan placement (the request now needs prefill)."""
        payload = getattr(req, "swapped_kv", None)
        if payload is None or dest is None:
            return True
        if is_ticket_stub(payload):
            at = payload.get("at", "local")
            if at == dest or (at == "local"
                              and dest not in self.remote_ids
                              and not self.force_http):
                return True        # already attached where it's needed
            ticket = payload[TICKET_KEY]
            if at != "local":      # bytes parked on a remote worker
                return self._ship_remote_held(req, payload, at, dest)
            real = self.receiver.take_payload(ticket)
            if real is None:
                return self._abort(req, src,
                                   f"ticket {ticket} missing/expired")
            payload = real          # re-ship the materialized bytes
        elif src is not None and src == dest \
                and dest not in self.remote_ids:
            # intra-replica restore (preemption=swap): the engine reads
            # the bytes straight off the request, no movement needed
            return True
        ticket = f"courier-{uuid.uuid4().hex[:16]}"
        remote_dest = dest in self.remote_ids
        try:
            if remote_dest or (self.force_http
                               and (dest in self.endpoints
                                    or getattr(self.cfg,
                                               "courier_endpoint", ""))):
                self._http_transport().transfer(
                    payload, src=src, dest=dest, ticket=ticket)
                at = dest if remote_dest else "local"
            else:
                self.local_transport.transfer(
                    payload, src=src, dest=dest, ticket=ticket)
                at = "local"
        except TransportError as e:
            logger.warning(
                "courier transfer %s -> %s aborted for %s (%s); payload "
                "dropped, falling back to re-prefill", src, dest,
                getattr(req, "request_id", "?"), e)
            req.swapped_kv = None
            slot = self._slot(src)
            with self._lock:
                slot["aborts"] += 1
            return False
        req.swapped_kv = ticket_stub(
            ticket, at, partial=bool(payload.get("partial"))
            if isinstance(payload, dict) else False)
        slot = self._slot(src)
        with self._lock:
            slot["transfers"] += 1
        return True

    # -- fleet-global prefix fetch -------------------------------------------

    def fetch_prefix(self, fetcher_id: int, owner_id,
                     owner_endpoint: Optional[str],
                     hashes: list) -> Optional[dict]:
        """Fetch the prefix pages for ``hashes`` from their owning
        replica on behalf of in-proc replica ``fetcher_id`` — the fetch
        verb of the courier. Two physical paths, one contract:

        - owner in-proc: its registered provider extracts on the owner's
          engine thread, then the payload crosses the SAME chunked
          frame->verify path every other payload rides (in-proc
          transport, injector chaos applies) and is claimed from the
          local ready store;
        - owner remote: POST ``/fleet/courier/fetch`` commands the owner
          worker to extract and PUSH the chunks to this process's own
          courier endpoint (``fleet_endpoints[fetcher_id]`` — an in-proc
          fetcher must be reachable, same rule as worker-to-worker
          ships), then the payload is claimed locally by ticket.

        Returns the decoded {"hashes": [hex], "pages": {...}} payload,
        None on a miss (owner has nothing / no endpoint / expired
        ticket), and raises TransferAborted when the transfer itself
        failed — the caller counts it and re-prefills either way.

        A hint naming ``KV_STORE_OWNER`` is the tiered-store fall-back:
        the pages live in no replica's HBM anymore, only as compressed
        frames in the host-tier store — replay them locally."""
        if owner_id == KV_STORE_OWNER:
            if self.kv_store is None:
                return None
            return self.kv_store.fetch(hashes, self.receiver)
        ticket = f"courier-{uuid.uuid4().hex[:16]}"
        provider = self.prefix_providers.get(owner_id)
        if provider is not None:
            payload = provider(hashes, self.fetch_timeout_s)
            if not payload:
                return None
            self.local_transport.transfer(payload, src=owner_id,
                                          dest=fetcher_id, ticket=ticket)
            return self.receiver.take_payload(ticket)
        ep = (owner_endpoint or self.endpoints.get(owner_id)
              or "").rstrip("/")
        dest_ep = self.endpoints.get(fetcher_id)
        if not ep or not dest_ep:
            logger.info(
                "prefix fetch %s -> %s skipped: no courier endpoint "
                "(owner %r, fetcher %r)", owner_id, fetcher_id,
                ep or None, dest_ep)
            return None
        body = {"replica": owner_id,
                "hashes": [h.hex() if isinstance(h, bytes) else str(h)
                           for h in hashes],
                "ticket": ticket, "dest": fetcher_id,
                "dest_endpoint": dest_ep}
        try:
            if self.injector is not None:
                self.injector.on_rpc(owner_id)
            import urllib.request
            wire = urllib.request.Request(
                f"{ep}/fleet/courier/fetch",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(
                    wire, timeout=self.fetch_timeout_s) as resp:
                out = json.loads(resp.read().decode())
        except Exception as e:
            raise TransferAborted(
                f"prefix fetch command to replica {owner_id} failed: "
                f"{e}") from e
        if not out.get("ok"):
            return None
        return self.receiver.take_payload(ticket)

    def _ship_remote_held(self, req, stub: dict, at: int,
                          dest: int) -> bool:
        """The payload sits in worker ``at``'s receiver; command that
        worker to push it straight to ``dest``'s courier endpoint
        (worker-to-worker, no relay through this process)."""
        src_ep = self.endpoints.get(at)
        if src_ep is None:
            return self._abort(req, at, f"no endpoint for holder {at}")
        dest_ep = self.endpoints.get(dest)
        if dest_ep is None:
            return self._abort(
                req, at,
                f"no endpoint for destination {dest} (in-proc replicas "
                f"receiving remote payloads need a fleet_endpoints entry "
                f"pointing at this front)")
        ticket = stub[TICKET_KEY]
        body = {"ticket": ticket, "dest": dest, "dest_endpoint": dest_ep}
        try:
            if self.injector is not None:
                self.injector.on_rpc(at)
            import urllib.request
            wire = urllib.request.Request(
                f"{src_ep}/worker/ship",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(
                    wire, timeout=self.ship_timeout_s) as resp:
                out = json.loads(resp.read().decode())
        except Exception as e:
            return self._abort(req, at, f"ship command failed: {e}")
        if not out.get("ok"):
            return self._abort(req, at, out.get("error", "ship refused"))
        stub["at"] = dest if dest in self.remote_ids else "local"
        slot = self._slot(at)
        with self._lock:
            slot["transfers"] += 1
        return True

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out.update(self.receiver.stats())
        with self._lock:
            # string keys: this dict crosses the JSON /fleet/status
            # surface, where int keys would silently become strings
            out["per_src"] = {str(k): dict(v)
                              for k, v in self.per_src.items()}
        return out
