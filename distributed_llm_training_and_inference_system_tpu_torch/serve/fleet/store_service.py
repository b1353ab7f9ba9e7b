"""`llmctl-torch fleet store`: the tiered fleet KV store as its own service.

The port's copy of the JAX package's ``serve/fleet/store_service.py``,
served on ``http.server.ThreadingHTTPServer`` through the worker's JSON
router (the JAX service is aiohttp); its anti-entropy and heartbeat loops
are threads. The process holds no tensor and never initialises CUDA.

- :class:`StoreService` — one :class:`FleetKVStore` and one weight ledger
  behind the routes ``/store/demote``, ``/store/fetch``,
  ``/store/inventory``, ``/store/clear``, ``/store/status``,
  ``/store/weights/{begin,chunk,status,names,fetch,sync}`` and ``/health``.
  A demote uploads courier frames that the client encoded once (each
  frame's CRC checked at admission, never recompressed); a fetch returns
  them byte for byte for the fetcher to replay through its own
  :class:`CourierReceiver`. With ``--member-id`` and ``--membership-dir``
  the process is one member of a replicated tier: writes from a fenced or
  superseded incarnation get a FATAL ack (``{"ok": false, "fatal":
  true}``), and anti-entropy pulls what peers hold and this member lacks,
  uncounted. ``/health`` answers 503 ``{"status": "starting"}`` until the
  disk tier is scanned, and 503 ``{"status": "fenced"}`` once fenced.
- :class:`StoreClient` — the front's and worker's half, a duck pair of
  ``FleetKVStore``: writes fan out to the write-ack floor of live members
  (the rest mirrored on the encode thread), fetches retry with doubling
  backoff, rotate past dead members and may be hedged. An unreachable tier
  is a counted remote miss and the destination prefills plainly.

The request bodies, acks and frame rows are the JAX service's, key for
key (frames as base64 ``[seq, total, crc, data]`` rows), so either
package's client works against either package's service.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid
import zlib
from base64 import b64decode, b64encode
from collections import OrderedDict
from typing import Optional

from ...analysis.annotations import aiohttp_handler, thread_seam
from ..kv_cache import concat_page_payloads
from .kv_store import FleetKVStore, _page_slice, host_payload
from .store_tier import EndpointSet, StoreMembership, parse_endpoint_spec
from .transport import (CODEC_NONE, CODEC_ZLIB, CourierChunk,
                        encode_payload, make_chunks)

__all__ = ["StoreClient", "StoreService"]

logger = logging.getLogger("llmctl.serve.fleet.store_service")


def _frames_to_wire(frames: list) -> list:
    """(seq, total, crc, data) rows -> JSON-able [seq, total, crc, b64]."""
    return [[seq, total, crc, b64encode(data).decode()]
            for seq, total, crc, data in frames]


def _frames_from_wire(rows: list) -> list:
    return [(int(seq), int(total), int(crc), b64decode(data))
            for seq, total, crc, data in rows]


def _post_json(url: str, body: dict,
               timeout_s: float = 5.0) -> Optional[dict]:
    """POST JSON, parse JSON. None = unreachable/timeout (the caller
    degrades); HTTP error bodies are surfaced as answers when they
    parse."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode())
        except Exception:
            return {"ok": False, "error": f"HTTP {e.code}"}
    except Exception as e:            # refused / reset / timeout
        logger.debug("store POST %s failed: %s", url, e)
        return None


def _get_json(url: str, timeout_s: float = 5.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except Exception as e:
        logger.debug("store GET %s failed: %s", url, e)
        return None


class _WeightLedger:
    """The service-side registry of named, immutable, chunked weight
    payloads. Uploads resume (``begin`` answers which seqs are already
    held and verified); every served chunk is counted per seq, so a
    killed-and-resumed download can prove its ledger balanced — each
    chunk travelled exactly once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._names: dict[str, dict] = {}

    @thread_seam
    def begin(self, name: str, manifest: dict, total: int,
              nbytes: int, shards: Optional[dict] = None,
              chunk_bytes: int = 0) -> dict:
        """``shards`` is the optional per-shard chunk manifest
        ({top-level param name: {"seq_lo", "seq_hi", "byte_lo",
        "byte_hi"}}) the shipper computed from the payload's
        sorted-path layout — a tp>1 bootstrap fetches only its shards'
        seq ranges instead of the whole checkpoint."""
        with self._lock:
            rec = self._names.get(name)
            if rec is None:
                rec = {"manifest": manifest, "total": int(total),
                       "nbytes": int(nbytes), "chunks": {},
                       "served": {}, "born": time.monotonic(),
                       "shards": dict(shards or {}),
                       "chunk_bytes": int(chunk_bytes)}
                self._names[name] = rec
            elif shards and not rec.get("shards"):
                # a re-ship from a newer courier backfills the shard
                # map on a payload begun without one
                rec["shards"] = dict(shards)
                rec["chunk_bytes"] = int(chunk_bytes)
            return {"ok": True, "have": sorted(rec["chunks"]),
                    "total": rec["total"]}

    @thread_seam
    def put_chunk(self, name: str, chunk: CourierChunk) -> dict:
        if zlib.crc32(chunk.data) != chunk.crc32:
            return {"ok": False, "error": "frame CRC mismatch"}
        with self._lock:
            rec = self._names.get(name)
            if rec is None:
                return {"ok": False,
                        "error": f"unknown weights name {name!r} "
                                 f"(begin first)"}
            duplicate = chunk.seq in rec["chunks"]
            if not duplicate:
                rec["chunks"][chunk.seq] = (chunk.crc32, chunk.data)
            return {"ok": True, "duplicate": duplicate,
                    "have": len(rec["chunks"]), "total": rec["total"],
                    "complete": len(rec["chunks"]) >= rec["total"]}

    @thread_seam
    def status(self, name: str) -> dict:
        with self._lock:
            rec = self._names.get(name)
            if rec is None:
                return {"ok": False,
                        "error": f"unknown weights name {name!r}"}
            return {"ok": True, "name": name,
                    "manifest": rec["manifest"], "total": rec["total"],
                    "nbytes": rec["nbytes"],
                    "have": sorted(rec["chunks"]),
                    "complete": len(rec["chunks"]) >= rec["total"],
                    "shards": rec.get("shards") or {},
                    "chunk_bytes": int(rec.get("chunk_bytes", 0)),
                    "served": {str(k): v
                               for k, v in sorted(rec["served"].items())}}

    @thread_seam
    def take_chunks(self, name: str, seqs: list) -> dict:
        with self._lock:
            rec = self._names.get(name)
            if rec is None:
                return {"ok": False,
                        "error": f"unknown weights name {name!r}"}
            if len(rec["chunks"]) < rec["total"]:
                return {"ok": False,
                        "error": f"weights {name!r} incomplete "
                                 f"({len(rec['chunks'])}/{rec['total']} "
                                 f"chunks uploaded)"}
            out = []
            for seq in seqs:
                seq = int(seq)
                held = rec["chunks"].get(seq)
                if held is None:
                    return {"ok": False,
                            "error": f"weights {name!r} has no chunk "
                                     f"{seq}"}
                crc, data = held
                rec["served"][seq] = rec["served"].get(seq, 0) + 1
                out.append(CourierChunk(
                    ticket=f"weights-{name}", seq=seq,
                    total=rec["total"], crc32=crc, data=data,
                    manifest=rec["manifest"] if seq == 0 else None
                ).to_wire())
            return {"ok": True, "chunks": out}

    @thread_seam
    def names(self) -> dict:
        """{name: {"total", "have", "complete"}} — the anti-entropy
        diff surface (what a rejoining peer compares before pulling)."""
        with self._lock:
            return {name: {"total": rec["total"],
                           "have": sorted(rec["chunks"]),
                           "complete": (len(rec["chunks"])
                                        >= rec["total"])}
                    for name, rec in self._names.items()}

    @thread_seam
    def peek_chunks(self, name: str, seqs: list) -> dict:
        """Anti-entropy chunk export: like :meth:`take_chunks` but
        UN-COUNTED (the per-seq serve ledger must stay a record of
        client downloads only) and tolerant of an incomplete payload —
        a peer reconciles whatever verified chunks this member holds."""
        with self._lock:
            rec = self._names.get(name)
            if rec is None:
                return {"ok": False,
                        "error": f"unknown weights name {name!r}"}
            out = []
            for seq in seqs:
                held = rec["chunks"].get(int(seq))
                if held is None:
                    continue
                crc, data = held
                out.append(CourierChunk(
                    ticket=f"weights-{name}", seq=int(seq),
                    total=rec["total"], crc32=crc, data=data,
                    manifest=rec["manifest"] if int(seq) == 0 else None
                ).to_wire())
            return {"ok": True, "chunks": out}

    @thread_seam
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "names": len(self._names),
                "chunks_held": sum(len(r["chunks"])
                                   for r in self._names.values()),
                "chunks_served": sum(sum(r["served"].values())
                                     for r in self._names.values()),
                "bytes_held": sum(len(d) for r in self._names.values()
                                  for _c, d in r["chunks"].values()),
            }


class StoreService:
    """The standalone store process: one :class:`FleetKVStore` + one
    :class:`_WeightLedger` behind a small HTTP front. All handlers
    are thin — the store's own lock is the concurrency story, exactly
    as when it lived inside a front.

    With a ``member_id`` + ``membership_dir`` the process is one member
    of a REPLICATED tier: it attaches to the epoch-fenced registry
    (recording its endpoint, so peers discover each other with no
    static list), heartbeats it, refuses writes with a FATAL ack once
    fenced or superseded, and runs background anti-entropy — pulling
    entries it lacks (by digest) and weight chunks it lacks (by seq)
    from live peers over the ordinary frame contract, un-counted."""

    def __init__(self, cfg=None, member_id: str = "",
                 membership_dir: str = "", peers=(),
                 sync_interval_s: float = 1.0, warm: bool = True):
        self.cfg = cfg
        self.store = FleetKVStore(cfg)
        self.weights = _WeightLedger()
        self.member_id = str(member_id or "")
        self.peers = parse_endpoint_spec(peers)
        self.sync_interval_s = float(sync_interval_s)
        self.endpoint = ""         # advertised after bind (run_forever)
        self.membership: Optional[StoreMembership] = None
        if self.member_id and membership_dir:
            self.membership = StoreMembership(membership_dir,
                                              self.member_id)
        self._tier_lock = threading.Lock()
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._httpd = None
        # tier counters (snapshotted by status_dict; they ride the
        # kv_store section so the client merge / supervisor snapshot /
        # Prometheus pump read them like any store counter)
        self.total_fenced_rejects = 0  # writes refused w/ a FATAL ack
        self.total_sync_pulls = 0      # entries+chunks anti-entropy
        #                                pulled from peers
        self.total_sync_rounds = 0     # completed anti-entropy rounds
        if warm:
            self.warm()

    # -- readiness / fencing -------------------------------------------------

    def warm(self) -> None:
        """Scan the disk tier into the frame index, then open the
        readiness gate (``/health`` 200). A restarted member re-serves
        everything it spilled before dying; anti-entropy only has to
        pull the DRAM-tier delta."""
        self.store.scan_disk()
        self._ready.set()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def _write_guard(self) -> Optional[str]:
        """None = admit; else the FATAL refusal reason (fenced zombie /
        stale incarnation). Counted — a zombie whose uploads vanish
        silently is exactly the bug fencing exists to prevent."""
        if self.membership is None:
            return None
        reason = self.membership.guard_write()
        if reason is not None:
            with self._tier_lock:
                self.total_fenced_rejects += 1
            logger.warning("store write refused: %s", reason)
        return reason

    # -- anti-entropy --------------------------------------------------------

    def _sync_peers(self) -> list:
        peers = list(self.peers)
        if self.membership is not None:
            for ep in self.membership.peer_endpoints():
                if ep and ep != self.endpoint and ep not in peers:
                    peers.append(ep)
        return [p for p in peers if p != self.endpoint]

    @thread_seam
    def sync_once(self, timeout_s: float = 5.0) -> dict:
        """One anti-entropy round: for each live peer, diff its KV
        inventory and weight-chunk holdings against ours and pull what
        we lack — single-hash un-counted fetches (``count: false``)
        admitted through the same CRC-verified path as a client upload,
        and ``/store/weights/sync`` chunk peeks that leave the per-seq
        serve ledger untouched. A fenced member does not sync (its
        admissions would be writes)."""
        stats = {"peers": 0, "kv_pulled": 0, "chunks_pulled": 0}
        if self.membership is not None \
                and self.membership.guard_write() is not None:
            return stats
        for peer in self._sync_peers():
            inv = _post_json(f"{peer}/store/inventory",
                             {"max_entries": 0}, timeout_s=timeout_s)
            if inv is None or not inv.get("ok"):
                continue
            stats["peers"] += 1
            try:
                theirs = [bytes.fromhex(h)
                          for h in inv.get("hashes", [])]
            except (TypeError, ValueError):
                theirs = []
            for h in theirs:
                if self.store.holds(h):
                    continue
                out = _post_json(f"{peer}/store/fetch",
                                 {"hashes": [h.hex()], "count": False},
                                 timeout_s=timeout_s)
                for row in (out or {}).get("pages", []):
                    try:
                        got_h = bytes.fromhex(str(row["hash"]))
                        frames = _frames_from_wire(row["frames"])
                        manifest = dict(row["manifest"])
                    except (KeyError, TypeError, ValueError):
                        continue
                    raw = int(manifest.get("nbytes", 0))
                    if self.store.admit_frames(got_h, frames, manifest,
                                               raw):
                        stats["kv_pulled"] += 1
            stats["chunks_pulled"] += self._sync_weights(peer,
                                                         timeout_s)
        with self._tier_lock:
            self.total_sync_pulls += (stats["kv_pulled"]
                                      + stats["chunks_pulled"])
            self.total_sync_rounds += 1
        if stats["kv_pulled"] or stats["chunks_pulled"]:
            logger.info("anti-entropy: pulled %d kv entries, %d weight "
                        "chunks from %d peers", stats["kv_pulled"],
                        stats["chunks_pulled"], stats["peers"])
        return stats

    def _sync_weights(self, peer: str, timeout_s: float) -> int:
        names = _get_json(f"{peer}/store/weights/names",
                          timeout_s=timeout_s)
        if names is None or not names.get("ok"):
            return 0
        pulled = 0
        mine = self.weights.names()
        for name, info in (names.get("names") or {}).items():
            their_have = set(int(s) for s in info.get("have", []))
            local = mine.get(name)
            my_have = set(int(s) for s in (local or {}).get("have", []))
            want = sorted(their_have - my_have)
            if not want:
                continue
            if local is None:
                st = _get_json(
                    f"{peer}/store/weights/status?name={name}",
                    timeout_s=timeout_s)
                if st is None or not st.get("ok"):
                    continue
                self.weights.begin(
                    name, dict(st["manifest"]), int(st["total"]),
                    int(st.get("nbytes", 0)),
                    shards=st.get("shards") or None,
                    chunk_bytes=int(st.get("chunk_bytes", 0)))
            for i in range(0, len(want), 64):
                out = _post_json(f"{peer}/store/weights/sync",
                                 {"name": name,
                                  "seqs": want[i:i + 64]},
                                 timeout_s=timeout_s)
                for wire in (out or {}).get("chunks", []):
                    try:
                        chunk = CourierChunk.from_wire(wire)
                    except Exception:
                        continue
                    ack = self.weights.put_chunk(name, chunk)
                    if ack.get("ok") and not ack.get("duplicate"):
                        pulled += 1
        return pulled

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_interval_s):
            if not self._ready.is_set():
                continue
            try:
                self.sync_once()
            except Exception:
                logger.exception("anti-entropy round failed (retried "
                                 "next interval)")

    def _heartbeat_loop(self) -> None:
        assert self.membership is not None
        interval = max(self.membership.expiry_s / 3.0, 0.05)
        while not self._stop.wait(interval):
            try:
                self.membership.heartbeat(
                    {"endpoint": self.endpoint,
                     "ready": self._ready.is_set()})
            except Exception:
                logger.exception("membership heartbeat failed")

    # -- RPC bodies (also driven directly by tests) --------------------------

    @aiohttp_handler
    def demote_wire(self, body: dict) -> dict:
        guard = self._write_guard()
        if guard is not None:
            return {"ok": False, "fatal": True, "error": guard}
        try:
            h = bytes.fromhex(str(body["hash"]))
            frames = _frames_from_wire(body["frames"])
            manifest = dict(body["manifest"])
            raw_bytes = int(body.get("raw_bytes", 0))
        except (KeyError, TypeError, ValueError):
            return {"ok": False,
                    "error": "body must be {hash, manifest, frames, "
                             "raw_bytes}"}
        stored = self.store.admit_frames(h, frames, manifest, raw_bytes)
        return {"ok": True, "stored": bool(stored)}

    @aiohttp_handler
    def fetch_wire(self, body: dict) -> dict:
        try:
            hashes = [bytes.fromhex(h) for h in body.get("hashes", [])]
        except (TypeError, ValueError):
            return {"ok": False, "error": "malformed hashes"}
        if not hashes:
            return {"ok": False, "error": "body must be {hashes}"}
        rows = self.store.export_frames(
            hashes, count=bool(body.get("count", True)))
        return {"ok": True,
                "pages": [{"hash": hx, "manifest": manifest,
                           "frames": _frames_to_wire(frames)}
                          for hx, manifest, frames, _w in rows]}

    @aiohttp_handler
    def inventory_wire(self, body: dict) -> dict:
        held = self.store.inventory(int(body.get("max_entries", 0) or 0))
        return {"ok": True, "hashes": [h.hex() for h in held]}

    @aiohttp_handler
    def status_dict(self) -> dict:
        snap = self.store.snapshot()
        with self._tier_lock:
            snap["fenced_rejects"] = self.total_fenced_rejects
            snap["sync_pulls"] = self.total_sync_pulls
            snap["sync_rounds"] = self.total_sync_rounds
        out = {"ok": True, "kv_store": snap,
               "weights": self.weights.snapshot()}
        if self.membership is not None:
            out["member"] = {
                "id": self.member_id, "epoch": self.membership.epoch,
                "fenced": self.membership.is_fenced(),
                "ready": self._ready.is_set()}
            out["members"] = self.membership.members_view()
        return out

    # -- HTTP front ----------------------------------------------------------

    def _guarded(self, fn):
        """A write route: a FATAL ack while fenced or superseded."""
        def route(_h, body):
            guard = self._write_guard()
            if guard is not None:
                return {"ok": False, "fatal": True, "error": guard}
            return fn(body)
        return route

    def _clear(self, _body) -> dict:
        self.store.clear()
        return {"ok": True}

    def _weights_begin(self, body: dict):
        from .worker import Reply
        try:
            name = str(body["name"])
            manifest = dict(body["manifest"])
            total = int(body["total"])
            nbytes = int(body.get("nbytes", 0))
        except (KeyError, TypeError, ValueError):
            return Reply({"ok": False, "error": "body must be {name, "
                                                "manifest, total, nbytes}"},
                         400)
        return self.weights.begin(
            name, manifest, total, nbytes,
            shards=body.get("shards") or None,
            chunk_bytes=int(body.get("chunk_bytes", 0) or 0))

    def _weights_chunk(self, body: dict):
        from .worker import Reply
        name = str(body.get("name", ""))
        try:
            chunk = CourierChunk.from_wire(body.get("chunk") or {})
        except Exception:
            return Reply({"ok": False,
                          "error": "body must be {name, chunk: courier "
                                   "chunk frame}"}, 400)
        return self.weights.put_chunk(name, chunk)

    def health_reply(self):
        """The readiness gate: a member still scanning its disk tier, or a
        fenced one, answers 503 so gated clients and spawners skip it."""
        from .worker import Reply
        if not self._ready.is_set():
            return Reply({"status": "starting"}, 503)
        if self.membership is not None and self.membership.is_fenced():
            return Reply({"status": "fenced"}, 503)
        return Reply({"status": "healthy", "member": self.member_id,
                      "epoch": (self.membership.epoch
                                if self.membership is not None else 0)})

    def routes(self) -> dict:
        """(method, path) -> route: the JAX service's ``build_app``."""
        from urllib.parse import parse_qs

        def query_name(query: str) -> str:
            return (parse_qs(query).get("name") or [""])[0]

        return {
            ("POST", "/store/demote"): lambda _h, b: self.demote_wire(b),
            ("POST", "/store/fetch"): lambda _h, b: self.fetch_wire(b),
            ("POST", "/store/inventory"):
            lambda _h, b: self.inventory_wire(b),
            ("POST", "/store/clear"): self._guarded(self._clear),
            ("GET", "/store/status"): lambda _h, _q: self.status_dict(),
            ("POST", "/store/weights/begin"):
            self._guarded(self._weights_begin),
            ("POST", "/store/weights/chunk"):
            self._guarded(self._weights_chunk),
            ("GET", "/store/weights/status"):
            lambda _h, q: self.weights.status(query_name(q)),
            ("GET", "/store/weights/names"):
            lambda _h, _q: {"ok": True, "names": self.weights.names()},
            ("POST", "/store/weights/fetch"):
            lambda _h, b: self.weights.take_chunks(
                str(b.get("name", "")), b.get("seqs") or []),
            ("POST", "/store/weights/sync"):
            lambda _h, b: self.weights.peek_chunks(
                str(b.get("name", "")), b.get("seqs") or []),
            ("GET", "/health"): lambda _h, _q: self.health_reply(),
        }

    def serve_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind the HTTP front, attach to the membership registry, and
        start the heartbeat, anti-entropy and warm threads; the bound
        port. ``/health`` stays 503 "starting" until the warm thread has
        scanned the disk tier."""
        from .worker import serve
        self._httpd = serve(host, port, self.routes())
        bound = self._httpd.server_address[1]
        self.endpoint = f"http://{host}:{bound}"
        if self.membership is not None:
            self.membership.attach({"endpoint": self.endpoint})
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="llmctl-store-heartbeat").start()
        if self.membership is not None or self.peers:
            threading.Thread(target=self._sync_loop, daemon=True,
                             name="llmctl-store-sync").start()
        if not self._ready.is_set():
            threading.Thread(target=self.warm, daemon=True,
                             name="llmctl-store-warm").start()
        return bound

    def stop(self) -> None:
        from .worker import stop_server
        self._stop.set()
        stop_server(self._httpd)
        self._httpd = None

    def run_forever(self, host: str = "127.0.0.1", port: int = 0,
                    stop: Optional[threading.Event] = None) -> None:
        """Serve until SIGTERM/SIGINT. Prints exactly one ready line
        (``LLMCTL_STORE_READY port=N``) on stdout; everything else logs to
        stderr."""
        from .worker import wait_for_sigterm
        bound = self.serve_http(host, port)
        print(f"LLMCTL_STORE_READY port={bound}", flush=True)
        logger.info("fleet store service on %s:%d (dram %.0f MB, disk %r, "
                    "member %r)", host, bound, self.store.dram_capacity / 1e6,
                    self.store.disk_dir or None, self.member_id or None)
        try:
            wait_for_sigterm(stop)
        finally:
            self.stop()


class StoreClient:
    """The front/worker half of the networked store: duck pair of
    :class:`FleetKVStore`, so everything above it (router hints, the
    eviction demote seam, drain-flush barriers, the returning-
    conversation fetch, the supervisor snapshot) is backend-agnostic.

    Demotion mirrors the in-proc store's split: ``demote_async`` queues
    page REFERENCES and a background worker pays the deflate + the
    upload POST (the engine thread never blocks on either); ``demote``
    is the synchronous drain/retire barrier. Pages are encoded ONCE
    here — the service admits the frames verbatim and every later fetch
    replays them byte-identical.

    Fetch is pull-mode: the response carries the held frames and THIS
    process replays them through its own ``CourierReceiver`` — frame
    CRC, end-to-end raw CRC, decode — so a corrupt or torn answer is a
    counted miss, never wrong KV. An unreachable service degrades the
    same way (counted ``remote_misses``; demotions are dropped and cost
    only a future recompute)."""

    def __init__(self, cfg=None, endpoint: str = "", injector=None):
        eps = parse_endpoint_spec(endpoint)
        if not eps and cfg is not None:
            lister = getattr(cfg, "kv_store_endpoint_list", None)
            eps = (list(lister()) if callable(lister)
                   else parse_endpoint_spec(
                       getattr(cfg, "kv_store_endpoint", "")))
        self._eps = EndpointSet(eps)
        self.endpoint = eps[0] if eps else ""
        codec = str(getattr(cfg, "courier_codec", CODEC_NONE)
                    or CODEC_NONE)
        self.codec = CODEC_ZLIB if codec == CODEC_NONE else codec
        self.zlib_level = int(getattr(cfg, "courier_zlib_level", -1))
        self.chunk_bytes = int(getattr(cfg, "courier_chunk_bytes",
                                       256 * 1024))
        self.timeout_s = float(getattr(cfg, "prefix_fetch_timeout_s",
                                       5.0) or 5.0)
        # transient-error budget: each member gets retry_max retries
        # with doubling backoff before the client rotates past it
        self.retry_max = int(getattr(cfg, "kv_store_retry_max", 2))
        self.retry_backoff_s = float(getattr(
            cfg, "kv_store_retry_backoff_ms", 10.0) or 0.0) / 1e3
        self.write_ack = int(getattr(cfg, "kv_store_write_ack", 1))
        self.hedge_s = float(getattr(cfg, "kv_store_hedge_ms", 0.0)
                             or 0.0) / 1e3
        # seeded store partition verbs (FaultPlan.store_partition_*)
        # enter here: a partitioned member looks connection-refused
        self.injector = injector
        self._lock = threading.Lock()
        self._pending: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._pending_max = 256
        self._inflight = 0       # pages popped but not yet POSTed
        # async mirror backlog: (endpoint, path, body) uploads owed to
        # members beyond the write-ack floor, paid on the encode thread
        self._mirror: list = []
        self._work = threading.Event()
        self._encoder: Optional[threading.Thread] = None
        # client-side counters (everything else is served by the
        # service's own FleetKVStore counters, merged in snapshot())
        self.total_remote_hits = 0    # pages replayed from the service
        self.total_remote_misses = 0  # fetches that served zero pages
        #                               after every member was tried
        self.total_retries = 0        # transient-error RPC retries
        self.total_failovers = 0      # RPCs answered by a non-first
        #                               member after rotation
        self.total_hedges = 0         # hedged fetches fired

    @property
    def endpoints(self) -> list:
        """Ordered member URLs this client rotates through."""
        return list(self._eps.endpoints)

    # -- tier transport ------------------------------------------------------

    def _post_member(self, ep: str, path: str,
                     body: dict) -> Optional[dict]:
        if self.injector is not None:
            try:
                idx = self._eps.endpoints.index(ep)
            except ValueError:
                idx = -1
            if idx >= 0 and self.injector.on_store_rpc(idx):
                return None          # injected partition: looks refused
        return _post_json(f"{ep}{path}", body, timeout_s=self.timeout_s)

    def _attempt(self, ep: str, path: str,
                 body: dict) -> Optional[dict]:
        """One member, full transient budget: up to ``retry_max``
        retries with doubling backoff (counted) before giving up on
        this endpoint."""
        backoff = self.retry_backoff_s
        for attempt in range(self.retry_max + 1):
            if attempt:
                with self._lock:
                    self.total_retries += 1
                time.sleep(backoff)
                backoff *= 2
            out = self._post_member(ep, path, body)
            if out is not None:
                return out
        return None

    def _rpc(self, path: str, body: dict) -> tuple:
        """Health-gated rotation: try each live member with its full
        retry budget; a member that exhausts it (or answers a FATAL
        fenced ack) is cooled down and the next member tried. Returns
        ``(answer, endpoint)`` — ``(None, "")`` only after EVERY member
        failed."""
        rotated = False
        for ep in self._eps.live():
            out = self._attempt(ep, path, body)
            if out is None:
                self._eps.mark_down(ep)
                rotated = True
                continue
            if out.get("fatal"):
                # fenced member: rotate past it, never retry the write
                self._eps.mark_down(ep)
                rotated = True
                continue
            self._eps.mark_up(ep)
            if rotated:
                with self._lock:
                    self.total_failovers += 1
            return out, ep
        return None, ""

    def _hedged_fetch_rpc(self, body: dict) -> tuple:
        """Race two members when the first is slow: fire the preferred
        member, wait ``hedge_s``, then fire the next live member and
        take whichever answers first. Falls back to the ordinary
        retry/rotation path when hedging is off, only one member is
        live, or both racers lose."""
        live = self._eps.live()
        if self.hedge_s <= 0 or len(live) < 2:
            return self._rpc("/store/fetch", body)
        box: dict = {"done": 0}
        cond = threading.Condition()

        def race(ep):
            out = self._post_member(ep, "/store/fetch", body)
            with cond:
                if out is not None and not out.get("fatal") \
                        and "out" not in box:
                    box["out"], box["ep"] = out, ep
                box["done"] += 1
                cond.notify_all()

        threading.Thread(target=race, args=(live[0],),
                         daemon=True).start()
        with cond:
            cond.wait_for(lambda: "out" in box or box["done"] >= 1,
                          timeout=self.hedge_s)
            slow = "out" not in box and box["done"] < 1
        if slow:
            with self._lock:
                self.total_hedges += 1
            threading.Thread(target=race, args=(live[1],),
                             daemon=True).start()
            with cond:
                cond.wait_for(lambda: "out" in box or box["done"] >= 2,
                              timeout=self.timeout_s)
        if "out" in box:
            self._eps.mark_up(box["ep"])
            if box["ep"] != live[0]:
                with self._lock:
                    self.total_failovers += 1
            return box["out"], box["ep"]
        return self._rpc("/store/fetch", body)

    # -- demotion ------------------------------------------------------------

    @thread_seam
    def demote_async(self, hashes: list, content: dict) -> int:
        """Queue demoted pages for background encode + upload; the HOT
        eviction seam (engine thread). Mirrors FleetKVStore.demote_async
        bound and overflow semantics."""
        queued = 0
        try:
            content = host_payload(content)
            n = int(content.get("num_pages", 0))
            with self._lock:
                for i, h in enumerate(hashes[:n]):
                    h = bytes(h)
                    if h in self._pending:
                        continue
                    self._pending[h] = (content, i)
                    queued += 1
                while len(self._pending) > self._pending_max:
                    self._pending.popitem(last=False)
                if queued and (self._encoder is None
                               or not self._encoder.is_alive()):
                    self._encoder = threading.Thread(
                        target=self._encode_loop, daemon=True,
                        name="llmctl-storeclient-encode")
                    self._encoder.start()
            if queued:
                self._work.set()
        except Exception:
            logger.exception("store client async demotion failed; "
                             "pages dropped")
        return queued

    def _encode_loop(self) -> None:
        while True:
            if not self._work.wait(timeout=5.0):
                return                        # idle: let the thread die
            self._work.clear()
            while True:
                with self._lock:
                    if self._pending:
                        job = ("page",
                               *self._pending.popitem(last=False))
                    elif self._mirror:
                        job = ("mirror", self._mirror.pop(0))
                    else:
                        break
                    self._inflight += 1
                try:
                    if job[0] == "page":
                        _kind, h, (batch, col) = job
                        self._demote_page(h, _page_slice(batch, col))
                    else:
                        # async mirror beyond the write-ack floor:
                        # best-effort — a dropped mirror upload is
                        # healed by the tier's anti-entropy
                        ep, path, body = job[1]
                        self._attempt(ep, path, body)
                finally:
                    with self._lock:
                        self._inflight -= 1

    def _queue_mirror(self, ep: str, path: str, body: dict) -> None:
        with self._lock:
            self._mirror.append((ep, path, body))
            if self._encoder is None or not self._encoder.is_alive():
                self._encoder = threading.Thread(
                    target=self._encode_loop, daemon=True,
                    name="llmctl-storeclient-encode")
                self._encoder.start()
        self._work.set()

    def flush_pending(self, timeout_s: float = 10.0) -> None:
        """The drain/retire barrier. Unlike the in-proc store, a popped
        page is still a network POST away from durable — the barrier
        must also wait out in-flight uploads AND the async mirror
        backlog (a retire immediately followed by a member kill must
        find every live member holding the flushed pages)."""
        deadline = time.monotonic() + timeout_s
        self._work.set()
        while time.monotonic() < deadline:
            with self._lock:
                busy = (bool(self._pending) or bool(self._mirror)
                        or self._inflight > 0)
            if not busy:
                return
            self._work.set()
            time.sleep(0.002)

    @thread_seam
    def demote(self, hashes: list, content: dict) -> int:
        """Synchronous demote — the drain/retire barrier: a retiring
        replica's inventory must be durably AT THE SERVICE before it
        leaves rotation. Returns pages newly stored remotely."""
        stored = 0
        try:
            content = host_payload(content)
            n = int(content.get("num_pages", 0))
            for i, h in enumerate(hashes[:n]):
                if self._demote_page(bytes(h), _page_slice(content, i)):
                    stored += 1
        except Exception:
            logger.exception("store client demotion failed; "
                             "pages dropped")
        return stored

    def _demote_page(self, h: bytes, page: dict) -> bool:
        payload = {"prefix": True, "hashes": [h.hex()], "pages": page}
        manifest, blob = encode_payload(payload, codec=self.codec,
                                        zlib_level=self.zlib_level)
        chunks = make_chunks("store", manifest, blob, self.chunk_bytes)
        body = {"hash": h.hex(), "manifest": manifest,
                "frames": _frames_to_wire(
                    [(c.seq, c.total, c.crc32, c.data) for c in chunks]),
                "raw_bytes": int(manifest["nbytes"])}
        # fan-out: the write-ack floor synchronously, the remaining
        # live members async-mirrored; a FATAL (fenced) ack skips that
        # member entirely — its admission would be a zombie write
        live = self._eps.live()
        want = max(1, min(self.write_ack, len(live)))
        acks = 0
        stored = False
        for ep in live:
            if acks >= want:
                self._queue_mirror(ep, "/store/demote", body)
                continue
            out = self._attempt(ep, "/store/demote", body)
            if out is None:
                self._eps.mark_down(ep)
                logger.warning("store member %s unreachable; demoted "
                               "page %s not mirrored there", ep,
                               h.hex())
                continue
            if out.get("fatal"):
                logger.warning("store member %s refused page %s with a "
                               "FATAL ack: %s", ep, h.hex(),
                               out.get("error"))
                continue
            if out.get("ok"):
                acks += 1
                self._eps.mark_up(ep)
                stored = stored or bool(out.get("stored"))
        if acks == 0:
            logger.warning("no store member acknowledged demoted page "
                           "%s; dropped", h.hex())
        return stored and acks > 0

    # -- advertising ---------------------------------------------------------

    @thread_seam
    def inventory(self, max_entries: int = 0) -> list:
        """Union of the live members' holdings (any member holding an
        entry can serve the fetch, so the router's hint surface is the
        tier's union, not one member's view)."""
        seen: "OrderedDict[bytes, bool]" = OrderedDict()
        answered = False
        for ep in self._eps.live():
            out = self._attempt(ep, "/store/inventory",
                                {"max_entries": int(max_entries)})
            if out is None:
                self._eps.mark_down(ep)
                continue
            if not out.get("ok"):
                continue
            answered = True
            self._eps.mark_up(ep)
            try:
                for hx in out.get("hashes", []):
                    seen.setdefault(bytes.fromhex(hx), True)
            except (TypeError, ValueError):
                continue
        if not answered:
            return []
        keys = list(seen)
        if max_entries > 0:
            keys = keys[-max_entries:]
        return keys

    @thread_seam
    def holds(self, h: bytes) -> bool:
        return bytes(h) in set(self.inventory())

    # -- fetch ---------------------------------------------------------------

    @thread_seam
    def fetch(self, hashes: list, receiver) -> Optional[dict]:
        """Pull the longest held prefix of ``hashes`` from the service
        and replay the returned frames through ``receiver`` — the
        fetcher-local courier path, so all verification happens HERE.
        None (counted remote miss) only after EVERY live member was
        tried — transient errors retry with backoff, a dead member
        rotates to a survivor, and (``kv_store_hedge_ms``) a slow
        member races a second one."""
        body = {"hashes": [bytes(h).hex() for h in hashes]}
        out, ep = self._hedged_fetch_rpc(body)
        # an ANSWERING member that holds nothing is not the end of the
        # story in a tier: another member may hold the pages (e.g. a
        # freshly rejoined member that has not finished anti-entropy)
        if out is not None and not (out.get("pages") or []) \
                and len(self._eps) > 1:
            for alt in self._eps.live():
                if alt == ep:
                    continue
                alt_out = self._attempt(alt, "/store/fetch", body)
                if alt_out is None:
                    self._eps.mark_down(alt)
                    continue
                if alt_out.get("pages"):
                    out = alt_out
                    with self._lock:
                        self.total_failovers += 1
                    break
        served: list = []
        pages = None
        for row in (out or {}).get("pages", []):
            try:
                hx = str(row["hash"])
                manifest = dict(row["manifest"])
                frames = _frames_from_wire(row["frames"])
            except (KeyError, TypeError, ValueError):
                break
            payload = self._replay(hx, frames, manifest, receiver)
            if payload is None:
                break
            got = payload.get("pages")
            if not isinstance(got, dict):
                break
            try:
                merged = got if pages is None else \
                    concat_page_payloads(pages, got)
            except (ValueError, KeyError, TypeError):
                break
            pages = merged
            served.append(hx)
            with self._lock:
                self.total_remote_hits += 1
        if not served:
            with self._lock:
                self.total_remote_misses += 1
            return None
        return {"hashes": served, "pages": pages}

    def _replay(self, hx: str, frames, manifest, receiver):
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
            logger.warning(
                "store service entry %s failed replay verification; "
                "fetch degrades to plain prefill", hx)
        return payload

    # -- wipe / introspection ------------------------------------------------

    @thread_seam
    def clear(self) -> None:
        for ep in self._eps.live():
            self._attempt(ep, "/store/clear", {})

    @thread_seam
    def snapshot(self) -> dict:
        """The first answering member's counters merged with the
        client-side tier counters — one section, same keys as the
        in-proc store, so `fleet status` and the Prometheus pump read
        both backends identically. ``members`` maps every configured
        endpoint to its health-gate view."""
        out = {}
        for ep in self._eps.live():
            got = _get_json(f"{ep}/store/status",
                            timeout_s=self.timeout_s)
            if got:
                out = got
                self._eps.mark_up(ep)
                break
            self._eps.mark_down(ep)
        snap = dict(out.get("kv_store") or {})
        snap["endpoint"] = self.endpoint
        snap["endpoints"] = list(self._eps.endpoints)
        snap["members"] = self._eps.reachable_map()
        snap["reachable"] = bool(out)
        if "weights" in out:
            snap["service_weights"] = out["weights"]
        with self._lock:
            snap["remote_hits"] = self.total_remote_hits
            snap["remote_misses"] = self.total_remote_misses
            snap["retries"] = self.total_retries
            snap["failovers"] = self.total_failovers
            snap["hedges"] = self.total_hedges
        return snap
