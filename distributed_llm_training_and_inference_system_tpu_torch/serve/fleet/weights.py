"""Weight distribution over the store service (`llmctl-torch fleet store`).

The port's copy of the JAX package's ``serve/fleet/weights.py``:

- :meth:`WeightCourier.ship` registers a checkpoint under a name as one
  immutable payload: the parameter tree is flattened by ``encode_payload``
  (manifest and end-to-end raw CRC) and split by ``make_chunks`` into the
  per-frame CRC'd chunks every KV transfer uses, then uploaded chunk by
  chunk. Upload resumes (``/store/weights/begin`` answers which seqs the
  member already holds). The ship fans out to every live member and
  succeeds once the write-ack floor of them hold the whole payload; the
  begin body records a per-shard chunk manifest (``_shard_ranges``).
- :meth:`WeightCourier.fetch` bootstraps a bare host: chunks are pulled in
  batches of 16, CRC-checked and appended to an fsync'd spool, so a worker
  killed mid-download and respawned with the same spool resumes; a member
  that dies mid-download is failed over to the next live one, and
  reassembly (``ChunkReassembler``) checks the end-to-end CRC.
  ``shards=[...]`` pulls only the chunks covering those top-level params.

What crosses is the JAX package's parameter tree as numpy (block leaves
stacked ``[L, ...]``, kernels ``[in, out]``, norm scales ``s``): a port
model ships through ``weights.params_to_tree`` and boots through
``weights.params_from_jax``, so a checkpoint shipped by either package
boots a worker of either. bf16 leaves cross as ``kv_cache.BF16_HOST``
arrays, named ``"bfloat16"`` in the manifest, without ml_dtypes.

A missing prefix page degrades to a re-prefill, but a host without weights
has nothing to degrade to: fetch failures raise :class:`WeightShipError`
naming the endpoint, and the worker refuses to start.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ...analysis.annotations import thread_seam
from ..kv_cache import BF16_HOST
from .store_service import _get_json, _post_json
from .store_tier import EndpointSet, parse_endpoint_spec
from .transport import (CODEC_NONE, CODEC_ZLIB, ChunkCorrupt,
                        ChunkReassembler, CourierChunk, TransferAborted,
                        _filter_decode, encode_payload, make_chunks)

__all__ = ["WeightCourier", "WeightShipError"]

logger = logging.getLogger("llmctl.serve.fleet.weights")

_FETCH_BATCH = 16      # chunks per /store/weights/fetch POST


class WeightShipError(RuntimeError):
    """A weight ship/fetch against the store service failed terminally
    (unreachable endpoint, incomplete upload, verification failure).
    The message always names the endpoint — a worker boot surfacing
    this tells the operator WHICH store it could not reach."""


def _numpy_tree(node):
    """Params -> nested dict of host numpy arrays in the JAX package's
    layout (the courier payload schema): a port ``GPT`` through
    ``weights.params_to_tree``, torch tensors copied to the host once
    (bf16 as ``BF16_HOST``)."""
    if isinstance(node, torch.nn.Module):
        from ...weights import params_to_tree
        node = params_to_tree(node)
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(BF16_HOST)
        return t.numpy()
    return np.asarray(node)


def _shard_ranges(manifest: dict, blob: bytes,
                  chunk_bytes: int) -> dict:
    """Per-shard chunk manifest from the encoded payload's layout.
    ``encode_payload`` walks arrays in sorted-path order, so every
    array under one top-level params key occupies a CONTIGUOUS byte
    span of the blob — each shard is exactly a byte range, a covering
    chunk seq range [seq_lo, seq_hi), and a CRC of the blob slice (the
    shard fetch's end-to-end check; offsets are identical under
    delta-zlib because the filter is size-preserving)."""
    spans: dict = {}
    for spec in manifest.get("arrays") or []:
        parts = str(spec.get("path", "")).split(".")
        top = parts[1] if len(parts) > 1 else parts[0]
        off = int(spec["offset"])
        end = off + int(spec["nbytes"])
        lo, hi = spans.get(top, (off, end))
        spans[top] = (min(lo, off), max(hi, end))
    out = {}
    for top, (lo, hi) in sorted(spans.items()):
        out[top] = {"byte_lo": lo, "byte_hi": hi,
                    "seq_lo": lo // chunk_bytes,
                    "seq_hi": max((hi + chunk_bytes - 1) // chunk_bytes,
                                  lo // chunk_bytes + 1),
                    "crc32": zlib.crc32(blob[lo:hi])}
    return out


class WeightCourier:
    """Both halves of checkpoint movement through the store service.
    One instance per process; counters are running totals the
    supervisor snapshot embeds (``weights`` section) and the
    Prometheus pump deltas. ``endpoint`` may be a comma-separated
    member list — ship fans out, fetch fails over."""

    def __init__(self, cfg=None, endpoint: str = "",
                 spool_dir: str = "", injector=None,
                 write_ack: Optional[int] = None):
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
        self.timeout_s = float(getattr(cfg, "courier_ship_timeout_s",
                                       30.0) or 30.0)
        self.retry_max = int(getattr(cfg, "kv_store_retry_max", 2))
        self.retry_backoff_s = float(getattr(
            cfg, "kv_store_retry_backoff_ms", 10.0) or 0.0) / 1e3
        if write_ack is None:
            write_ack = int(getattr(cfg, "kv_store_write_ack", 1))
        # 0 = every live member must take the full payload (the
        # operator `ship-weights` default: a ship that silently leaves
        # a member bare should be loud)
        self.write_ack = int(write_ack)
        self.injector = injector
        self.spool_dir = str(spool_dir or "")
        self._lock = threading.Lock()
        self.total_chunks = 0     # chunks moved (shipped + fetched)
        self.total_resumes = 0    # ships/fetches that resumed partials
        self.total_bytes = 0      # wire bytes moved
        self.total_failovers = 0  # member rotations mid-ship/fetch

    def _bump(self, chunks: int = 0, resumes: int = 0,
              nbytes: int = 0, failovers: int = 0) -> None:
        with self._lock:
            self.total_chunks += chunks
            self.total_resumes += resumes
            self.total_bytes += nbytes
            self.total_failovers += failovers

    # -- tier transport ------------------------------------------------------

    def _gate(self, ep: str) -> bool:
        """True when the injected store partition blocks this member."""
        if self.injector is None:
            return False
        try:
            idx = self._eps.endpoints.index(ep)
        except ValueError:
            return False
        return bool(self.injector.on_store_rpc(idx))

    def _post(self, ep: str, path: str, body: dict) -> Optional[dict]:
        """POST with the bounded transient budget: retry_max retries,
        doubling backoff, before this member is given up on."""
        backoff = self.retry_backoff_s
        for attempt in range(self.retry_max + 1):
            if attempt:
                time.sleep(backoff)
                backoff *= 2
            if self._gate(ep):
                continue
            out = _post_json(f"{ep}{path}", body,
                             timeout_s=self.timeout_s)
            if out is not None:
                return out
        return None

    def _get(self, ep: str, path: str) -> Optional[dict]:
        if self._gate(ep):
            return None
        return _get_json(f"{ep}{path}", timeout_s=self.timeout_s)

    # -- ship (checkpoint -> service) ----------------------------------------

    @thread_seam
    def ship(self, name: str, params: dict) -> dict:
        """Register ``params`` under ``name`` on the store tier.
        Encoded once; chunks a member already verified are skipped
        (upload resume). Idempotent: re-shipping a registered name
        uploads nothing. Every live member is attempted; raises
        :class:`WeightShipError` unless at least the write-ack floor
        of them hold the complete payload (``write_ack=0`` = all)."""
        payload = {"params": _numpy_tree(params)}
        manifest, blob = encode_payload(payload, codec=self.codec,
                                        zlib_level=self.zlib_level)
        chunks = make_chunks(f"weights-{name}", manifest, blob,
                             self.chunk_bytes)
        shards = _shard_ranges(manifest, blob, self.chunk_bytes)
        eps = self._eps.live()
        floor = (len(eps) if self.write_ack <= 0
                 else min(self.write_ack, len(eps)))
        acked, sent, skipped = 0, 0, 0
        errors = []
        for ep in eps:
            try:
                one_sent, one_skipped = self._ship_one(
                    ep, name, manifest, chunks, shards)
            except WeightShipError as e:
                errors.append(str(e))
                self._eps.mark_down(ep)
                self._bump(failovers=1)
                continue
            acked += 1
            sent += one_sent
            skipped += one_skipped
        if acked < max(floor, 1):
            raise WeightShipError(
                f"weight ship {name!r}: only {acked}/{len(eps)} store "
                f"members took the payload (write-ack floor "
                f"{max(floor, 1)}): " + "; ".join(errors))
        logger.info("weights %r shipped to %d/%d members: %d chunks "
                    "sent (%d resumed)", name, acked, len(eps), sent,
                    skipped)
        return {"name": name, "total": len(chunks), "sent": sent,
                "skipped": skipped, "members": acked}

    def _ship_one(self, ep: str, name: str, manifest: dict,
                  chunks: list, shards: dict) -> tuple:
        begin = self._post(
            ep, "/store/weights/begin",
            {"name": name, "manifest": manifest, "total": len(chunks),
             "nbytes": int(manifest["nbytes"]), "shards": shards,
             "chunk_bytes": self.chunk_bytes})
        if begin is None or not begin.get("ok"):
            raise WeightShipError(
                f"weight ship {name!r}: store service at {ep} "
                + ("refused begin"
                   if begin else "unreachable")
                + (f" ({begin.get('error')})" if begin else ""))
        have = set(int(s) for s in begin.get("have", []))
        if have:
            self._bump(resumes=1)
        sent = 0
        for c in chunks:
            if c.seq in have:
                continue
            ack = self._post(ep, "/store/weights/chunk",
                             {"name": name, "chunk": c.to_wire()})
            if ack is None or not ack.get("ok"):
                raise WeightShipError(
                    f"weight ship {name!r}: chunk {c.seq}/{len(chunks)}"
                    f" refused by store service at {ep}"
                    + (f" ({ack.get('error')})" if ack else ""))
            sent += 1
            self._bump(chunks=1, nbytes=len(c.data))
        return sent, len(have)

    # -- fetch (service -> bare host) ----------------------------------------

    def _spool_path(self, name: str) -> str:
        return os.path.join(self.spool_dir, f"{name}.wspool")

    def _spool_load(self, name: str) -> dict[int, bytes]:
        """Verified chunks from a previous, killed fetch. The spool is
        a sequence of ``<json header line>\\n<raw bytes>`` records; a
        torn tail (killed mid-write) is truncated away silently — those
        chunks simply re-fetch."""
        out: dict[int, bytes] = {}
        if not self.spool_dir:
            return out
        try:
            with open(self._spool_path(name), "rb") as fh:
                while True:
                    line = fh.readline()
                    if not line:
                        break
                    try:
                        head = json.loads(line)
                        seq, crc, size = (int(head["seq"]),
                                          int(head["crc"]),
                                          int(head["len"]))
                    except (ValueError, KeyError, TypeError):
                        break                      # torn header
                    data = fh.read(size)
                    if len(data) != size or zlib.crc32(data) != crc:
                        break                      # torn/corrupt tail
                    out[seq] = data
        except OSError:
            return {}
        return out

    def _spool_append(self, fh, chunk: CourierChunk) -> None:
        if fh is None:
            return
        fh.write(json.dumps({"seq": chunk.seq, "crc": chunk.crc32,
                             "len": len(chunk.data)}).encode() + b"\n")
        fh.write(chunk.data)
        fh.flush()
        os.fsync(fh.fileno())

    def _complete_status(self, name: str) -> tuple:
        """(status, endpoint) from the first live member holding the
        COMPLETE payload — an answering member that lacks the name (or
        holds a partial upload) rotates to the next, because a freshly
        rejoined member may simply not have anti-entropied yet."""
        last_err = "unreachable"
        answered = False
        for ep in self._eps.live():
            st = self._get(ep, f"/store/weights/status?name={name}")
            if st is None:
                self._eps.mark_down(ep)
                continue
            answered = True
            if st.get("ok") and st.get("complete"):
                self._eps.mark_up(ep)
                return st, ep
            last_err = str(st.get("error") or "incomplete upload")
        if not answered:
            raise WeightShipError(
                f"weights fetch {name!r}: store service at "
                f"{self.endpoint} unreachable")
        raise WeightShipError(
            f"weights fetch {name!r}: no store member at "
            f"{','.join(self._eps.endpoints)} holds a complete "
            f"payload ({last_err})")

    def _pull_batch(self, eps_order: list, start_i: int, name: str,
                    seqs: list) -> tuple:
        """One /store/weights/fetch batch with member failover: the
        current member gets the full transient budget, then the pull
        rotates to the next live member (counted) and the SAME batch
        retries there — the spool/reassembler state carries over, so
        the combined per-seq serve ledger still sums to one."""
        i = start_i
        while i < len(eps_order):
            ep = eps_order[i]
            out = self._post(ep, "/store/weights/fetch",
                             {"name": name, "seqs": seqs})
            if out is not None and out.get("ok"):
                if i != start_i:
                    self._bump(failovers=1)
                    logger.warning(
                        "weights fetch %r: failed over to store "
                        "member %s for chunks %s..%s", name, ep,
                        seqs[0], seqs[-1])
                return out, i
            self._eps.mark_down(ep)
            i += 1
        raise WeightShipError(
            f"weights fetch {name!r}: every store member at "
            f"{','.join(self._eps.endpoints)} failed serving chunks "
            f"{seqs[0]}..{seqs[-1]}")

    @thread_seam
    def fetch(self, name: str, shards: Optional[list] = None) -> dict:
        """Pull checkpoint ``name`` from the tier and return the
        decoded param tree. With a spool directory, chunks persist as
        they arrive and a respawned fetch RESUMES from the verified
        spool (counted) — including ACROSS members when the one serving
        the first half died. ``shards`` names top-level param subtrees
        to fetch exclusively (the tp>1 path — only the covering chunk
        range travels; not spooled). Raises :class:`WeightShipError` —
        naming the endpoint — when no member holds a complete payload
        or verification fails."""
        status, ep = self._complete_status(name)
        if shards:
            return self._fetch_shards(name, status, ep, shards)
        total = int(status["total"])
        manifest = dict(status["manifest"])
        asm = ChunkReassembler(total)
        asm.manifest = manifest
        spooled = self._spool_load(name)
        for seq, data in spooled.items():
            if 0 <= seq < total:
                asm.add(CourierChunk(ticket=f"weights-{name}", seq=seq,
                                     total=total, crc32=zlib.crc32(data),
                                     data=data))
        if spooled:
            self._bump(resumes=1)
            logger.info("weights %r fetch resuming: %d/%d chunks "
                        "already spooled", name, len(spooled), total)
        fh = None
        if self.spool_dir:
            os.makedirs(self.spool_dir, exist_ok=True)
            fh = open(self._spool_path(name), "ab")
        eps_order = [ep] + [e for e in self._eps.live() if e != ep]
        ep_i = 0
        try:
            missing = asm.missing()
            for i in range(0, len(missing), _FETCH_BATCH):
                batch = missing[i:i + _FETCH_BATCH]
                out, ep_i = self._pull_batch(eps_order, ep_i, name,
                                             batch)
                for wire in out.get("chunks", []):
                    chunk = CourierChunk.from_wire(wire)
                    try:
                        fresh = asm.add(chunk)
                    except ChunkCorrupt as e:
                        raise WeightShipError(
                            f"weights fetch {name!r}: corrupt chunk "
                            f"from store service at "
                            f"{eps_order[ep_i]}: {e}") from e
                    if fresh:
                        self._spool_append(fh, chunk)
                        self._bump(chunks=1, nbytes=len(chunk.data))
        finally:
            if fh is not None:
                fh.close()
        try:
            payload = asm.payload()          # end-to-end raw CRC here
        except TransferAborted as e:
            # a torn spool or lying service must abort the BOOT, not
            # produce wrong weights; wipe the spool so the next attempt
            # starts clean
            if self.spool_dir:
                try:
                    os.unlink(self._spool_path(name))
                except OSError:
                    pass
            raise WeightShipError(
                f"weights fetch {name!r}: payload from store service "
                f"at {eps_order[ep_i]} failed verification: {e}") from e
        params = payload.get("params")
        if not isinstance(params, dict):
            raise WeightShipError(
                f"weights fetch {name!r}: store service at "
                f"{eps_order[ep_i]} returned a non-checkpoint payload")
        return params

    def _fetch_shards(self, name: str, status: dict, ep: str,
                      shards: list) -> dict:
        """The tp>1 partial path: pull only the chunks covering the
        requested top-level params. Each shard's reassembled blob
        slice is verified against the CRC the shipper recorded before
        any array is decoded."""
        shard_map = dict(status.get("shards") or {})
        chunk_bytes = int(status.get("chunk_bytes", 0))
        missing_shards = [s for s in shards if s not in shard_map]
        if missing_shards or chunk_bytes <= 0:
            raise WeightShipError(
                f"weights fetch {name!r}: store service at {ep} has "
                f"no shard manifest for {missing_shards or shards} "
                f"(shipped by a pre-shard-manifest courier?)")
        total = int(status["total"])
        manifest = dict(status["manifest"])
        codec = str(manifest.get("codec", CODEC_NONE))
        want: set = set()
        for s in shards:
            sm = shard_map[s]
            want.update(range(int(sm["seq_lo"]),
                              min(int(sm["seq_hi"]), total)))
        seqs = sorted(want)
        inflated: dict[int, bytes] = {}
        eps_order = [ep] + [e for e in self._eps.live() if e != ep]
        ep_i = 0
        for i in range(0, len(seqs), _FETCH_BATCH):
            batch = seqs[i:i + _FETCH_BATCH]
            out, ep_i = self._pull_batch(eps_order, ep_i, name, batch)
            for wire in out.get("chunks", []):
                chunk = CourierChunk.from_wire(wire)
                if zlib.crc32(chunk.data) != chunk.crc32:
                    raise WeightShipError(
                        f"weights fetch {name!r}: corrupt chunk "
                        f"{chunk.seq} from store service at "
                        f"{eps_order[ep_i]}")
                data = (zlib.decompress(chunk.data)
                        if codec != CODEC_NONE else chunk.data)
                inflated[chunk.seq] = data
                self._bump(chunks=1, nbytes=len(chunk.data))
        params: dict = {}
        for s in shards:
            sm = shard_map[s]
            seq_lo, byte_lo = int(sm["seq_lo"]), int(sm["byte_lo"])
            byte_hi = int(sm["byte_hi"])
            try:
                buf = b"".join(inflated[q]
                               for q in range(seq_lo,
                                              min(int(sm["seq_hi"]),
                                                  total)))
            except KeyError as e:
                raise WeightShipError(
                    f"weights fetch {name!r}: shard {s!r} chunk {e} "
                    f"never arrived from {eps_order[ep_i]}") from e
            lo = byte_lo - seq_lo * chunk_bytes
            blob_slice = buf[lo:lo + (byte_hi - byte_lo)]
            if zlib.crc32(blob_slice) != int(sm.get("crc32", -1)):
                raise WeightShipError(
                    f"weights fetch {name!r}: shard {s!r} blob slice "
                    f"failed its shipped CRC (store at "
                    f"{eps_order[ep_i]})")
            self._decode_shard_into(params, manifest, s, blob_slice,
                                    byte_lo)
        return params

    @staticmethod
    def _decode_shard_into(params: dict, manifest: dict, top: str,
                           blob_slice: bytes, byte_lo: int) -> None:
        """Decode every array spec under ``params.<top>`` out of the
        shard's blob slice (offsets rebased by ``byte_lo``), nesting
        the result under ``params[top]`` — the per-spec half of
        ``decode_payload``, including the size-preserving delta-filter
        inverse."""
        for spec in manifest.get("arrays") or []:
            parts = str(spec.get("path", "")).split(".")
            if len(parts) < 2 or parts[1] != top:
                continue
            off = int(spec["offset"]) - byte_lo
            raw = blob_slice[off:off + int(spec["nbytes"])]
            dtype = (BF16_HOST if spec["dtype"] == "bfloat16"
                     else np.dtype(spec["dtype"]))
            arr = np.frombuffer(raw, dtype=dtype).reshape(
                spec["shape"]).copy()
            filt = spec.get("filter")
            if filt is not None:
                arr = np.ascontiguousarray(_filter_decode(arr, filt))
            node = params
            for key in parts[1:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = arr

    # -- introspection -------------------------------------------------------

    @thread_seam
    def snapshot(self) -> dict:
        with self._lock:
            return {"chunks": self.total_chunks,
                    "resumes": self.total_resumes,
                    "bytes": self.total_bytes,
                    "failovers": self.total_failovers,
                    "endpoint": self.endpoint}
