"""Dataset streaming: tokenized memmap shards, remote shards, a synthetic
stream and a background prefetch loader.

The port's own copy of the JAX package's ``io/data.py``; for the same seed
the batches are byte-identical to the JAX package's:

- ``.bin`` shards of little-endian uint16/uint32 token ids with a sidecar
  ``<name>.idx.json`` recording dtype and document boundaries
  (``write_token_shard``), memory-mapped by ``MemmapDataset``;
- sequence packing: documents back to back in fixed [B, S] rows with
  segment ids (1-based per document, 0 = pad) and positions that restart
  per document. ``MemmapDataset`` packs in the C++ packer
  (``native/dataloader.cpp`` through ``io/native.py``), which raises if
  it cannot be built; ``LLMCTL_NO_NATIVE=1`` chooses the numpy packer
  (``_Packer``) instead. ``RemoteShardDataset`` packs with ``_Packer``;
- ``RemoteShardDataset``: ``scheme://`` shards (``io/remote.py``) fetched
  ahead of the reader into a local cache, shard order and document order
  within a shard shuffled per epoch;
- ``PrefetchLoader``: a background thread packs ahead of the consumer;
  its ``state_dict`` is the state after the last batch consumed, so a
  resume regenerates exactly the batches the consumer never saw;
- deterministic order: a pure function of (seed, epoch), with
  ``state_dict()``/``load_state_dict()`` for exact resume;
- ``SyntheticDataset``, a learnable stream for benchmarks and tests.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from . import native


def write_token_shard(path: str | Path, docs: list[np.ndarray],
                      dtype=np.uint16) -> Path:
    """Write documents as a .bin + .idx.json shard pair."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = np.concatenate([np.asarray(d, dtype=dtype) for d in docs])
    flat.tofile(path)
    bounds = np.cumsum([0] + [len(d) for d in docs]).tolist()
    idx = {"dtype": np.dtype(dtype).name, "num_tokens": int(flat.size),
           "doc_bounds": bounds}
    Path(str(path) + ".idx.json").write_text(json.dumps(idx))
    return path


@dataclass
class _Shard:
    path: Path
    dtype: np.dtype
    num_tokens: int
    doc_bounds: np.ndarray  # [ndocs+1]

    def tokens(self) -> np.memmap:
        return np.memmap(self.path, dtype=self.dtype, mode="r")


def _discover_shards(root: str | Path) -> list[_Shard]:
    root = Path(root)
    candidates = [root] if root.is_file() else sorted(root.glob("**/*.bin"))
    shards = []
    for p in candidates:
        idx_path = Path(str(p) + ".idx.json")
        if idx_path.exists():
            idx = json.loads(idx_path.read_text())
            shards.append(_Shard(p, np.dtype(idx["dtype"]), idx["num_tokens"],
                                 np.asarray(idx["doc_bounds"], np.int64)))
        else:  # raw bin: the whole file is one document of uint16
            n = p.stat().st_size // 2
            shards.append(_Shard(p, np.dtype(np.uint16), n,
                                 np.asarray([0, n], np.int64)))
    return shards


class DatasetIterator:
    """Common interface: __next__ -> {"tokens","segment_ids","positions"}."""

    def state_dict(self) -> dict: ...
    def load_state_dict(self, state: dict) -> None: ...


class SyntheticDataset(DatasetIterator):
    """Deterministic learnable synthetic LM stream: arithmetic progressions
    with a random start and stride per row."""

    def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self._step) * self.num_hosts
            + self.host_id)
        self._step += 1
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        start = rng.integers(1, V, size=(B, 1))
        stride = rng.integers(1, 7, size=(B, 1))
        tokens = (start + stride * np.arange(S)[None, :]) % (V - 1) + 1
        return {
            "tokens": tokens.astype(np.int32),
            "segment_ids": np.ones((B, S), np.int32),
            "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
        }

    def state_dict(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self._step = int(state["step"])
        self.seed = int(state["seed"])


class _Packer:
    """The greedy pack/carry/segment loop."""

    @staticmethod
    def pack(next_doc, carry: Optional[np.ndarray], B: int, S: int,
             pack: bool, drop_tail_docs: bool):
        """Fill a [B,S] batch from ``next_doc()``; returns (batch, carry)."""
        tokens = np.zeros((B, S), np.int32)
        segs = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        for b in range(B):
            fill, seg = 0, 1
            while fill < S:
                if carry is not None:
                    doc, carry = carry, None
                else:
                    doc = next_doc()
                    if not pack and fill > 0:
                        carry = doc
                        break
                take = min(len(doc), S - fill)
                tokens[b, fill:fill + take] = doc[:take]
                segs[b, fill:fill + take] = seg
                pos[b, fill:fill + take] = np.arange(take)
                if take < len(doc) and not drop_tail_docs:
                    carry = doc[take:]
                fill += take
                seg += 1
        return ({"tokens": tokens, "segment_ids": segs, "positions": pos},
                carry)


class MemmapDataset(DatasetIterator):
    """Streams packed [B,S] batches from .bin token shards.

    Document order is a seeded permutation per epoch; each host consumes a
    disjoint stripe of documents; overflow documents continue into the
    next row."""

    def __init__(self, root: str | Path, batch_size: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 pack: bool = True, drop_tail_docs: bool = False):
        self.shards = _discover_shards(root)
        if not self.shards:
            raise FileNotFoundError(f"no .bin token shards under {root}")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.pack = pack
        self.drop_tail_docs = drop_tail_docs
        docs = []
        for si, sh in enumerate(self.shards):
            for d in range(len(sh.doc_bounds) - 1):
                docs.append((si, int(sh.doc_bounds[d]),
                             int(sh.doc_bounds[d + 1])))
        self._docs = docs
        self._epoch = 0
        self._cursor = 0          # index into this host's permuted doc list
        self._carry: Optional[np.ndarray] = None
        self._perm = self._make_perm()
        self._native = None
        if not native.disabled():
            self._native = native.NativePacker(
                self.shards, np.asarray(docs, np.int64), pack,
                drop_tail_docs)

    @property
    def num_documents(self) -> int:
        return len(self._docs)

    def _make_perm(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        perm = rng.permutation(len(self._docs))
        return perm[self.host_id::self.num_hosts]

    def _next_doc(self) -> np.ndarray:
        if self._cursor >= len(self._perm):
            self._epoch += 1
            self._cursor = 0
            self._perm = self._make_perm()
        si, s, e = self._docs[self._perm[self._cursor]]
        self._cursor += 1
        return np.asarray(self.shards[si].tokens()[s:e], dtype=np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._native is not None:
            def next_perm(increments):
                self._epoch += 1
                self._cursor = 0
                self._perm = self._make_perm()
                return self._perm

            self._native.carry = self._carry
            batch, self._cursor, _ = self._native.pack_batch(
                self._perm, self._cursor, self.batch_size, self.seq_len,
                next_perm)
            self._carry = self._native.carry
            return batch
        batch, self._carry = _Packer.pack(
            self._next_doc, self._carry, self.batch_size, self.seq_len,
            self.pack, self.drop_tail_docs)
        return batch

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "cursor": self._cursor,
                "seed": self.seed,
                "carry": None if self._carry is None else self._carry.tolist()}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self.seed = int(state["seed"])
        self._carry = (None if state.get("carry") is None
                       else np.asarray(state["carry"], np.int32))
        self._perm = self._make_perm()




class RemoteShardDataset(DatasetIterator):
    """Streams packed batches from ``scheme://`` shard URIs (io/remote.py).

    Locality-preserving shuffle: shard ORDER is a seeded permutation per
    epoch and document order is permuted WITHIN each shard, so reads stay
    sequential per shard and the download-ahead cache (``ShardCache``)
    can hide fetch latency behind packing. Hosts stripe over shards.
    Resume state is (epoch, shard_cursor, doc_cursor, carry).
    """

    def __init__(self, uri: str, batch_size: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 pack: bool = True, cache_dir: str | Path | None = None,
                 num_workers: int = 2, prefetch: int = 2,
                 drop_tail_docs: bool = False,
                 max_cached_shards: Optional[int] = None):
        from .remote import ShardCache, get_store
        self.uri = uri
        self.batch_size, self.seq_len = batch_size, seq_len
        self.seed, self.pack = seed, pack
        self.drop_tail_docs = drop_tail_docs
        store = get_store(uri)
        all_uris = store.list_shards(uri)
        if not all_uris:
            raise FileNotFoundError(f"no .bin shards under {uri}")
        self.uris = all_uris[host_id::num_hosts] or all_uris[:1]
        self._owns_cache_dir = cache_dir is None
        if cache_dir is None:
            import tempfile
            cache_dir = Path(tempfile.mkdtemp(prefix="llmctl-shards-"))
        self.cache = ShardCache(self.uris, store, cache_dir,
                                num_workers=num_workers,
                                prefetch_depth=prefetch,
                                max_cached=max_cached_shards)
        self._prefetch = prefetch
        self._epoch = 0
        self._shard_cursor = 0
        self._doc_cursor = 0
        self._carry: Optional[np.ndarray] = None
        self._cur: Optional[tuple[int, _Shard, np.ndarray]] = None

    def _shard_order(self, epoch: Optional[int] = None) -> np.ndarray:
        rng = np.random.default_rng(
            self.seed * 7919 + (self._epoch if epoch is None else epoch))
        return rng.permutation(len(self.uris))

    def _upcoming(self, slot: int) -> list[int]:
        """The next ``prefetch`` shard indices in ACCESS order (this
        epoch's permutation, wrapping into the next epoch's): download-
        ahead follows the shuffle, not URI order."""
        order = list(self._shard_order()) + list(
            self._shard_order(self._epoch + 1))
        return [int(i) for i in order[slot + 1: slot + 1 + self._prefetch]]

    def _open_shard(self, slot: int) -> tuple[_Shard, np.ndarray]:
        idx = int(self._shard_order()[slot])
        path = self.cache.local_path(idx, upcoming=self._upcoming(slot))
        [shard] = _discover_shards(path)
        rng = np.random.default_rng(
            (self.seed + 31337) * 1_000_003 + self._epoch * 997 + idx)
        perm = rng.permutation(len(shard.doc_bounds) - 1)
        return shard, perm

    def _next_doc(self) -> np.ndarray:
        while True:
            if self._cur is None or self._cur[0] != self._shard_cursor:
                self._cur = (self._shard_cursor,
                             *self._open_shard(self._shard_cursor))
            _, shard, perm = self._cur
            if self._doc_cursor < len(perm):
                d = int(perm[self._doc_cursor])
                self._doc_cursor += 1
                s, e = int(shard.doc_bounds[d]), int(shard.doc_bounds[d + 1])
                return np.asarray(shard.tokens()[s:e], dtype=np.int32)
            self._doc_cursor = 0
            self._shard_cursor += 1
            if self._shard_cursor >= len(self.uris):
                self._shard_cursor = 0
                self._epoch += 1
            self._cur = None

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch, self._carry = _Packer.pack(
            self._next_doc, self._carry, self.batch_size, self.seq_len,
            self.pack, self.drop_tail_docs)
        return batch

    def close(self) -> None:
        """Shut the download pool; delete the cache directory if this
        dataset made it (a default temporary cache would otherwise keep a
        full copy of the dataset after every run)."""
        self.cache.close()
        if self._owns_cache_dir:
            import shutil
            shutil.rmtree(self.cache.cache_dir, ignore_errors=True)

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "shard_cursor": self._shard_cursor,
                "doc_cursor": self._doc_cursor, "seed": self.seed,
                "carry": None if self._carry is None
                else self._carry.tolist()}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._shard_cursor = int(state["shard_cursor"])
        self._doc_cursor = int(state["doc_cursor"])
        self.seed = int(state["seed"])
        self._carry = (None if state.get("carry") is None
                       else np.asarray(state["carry"], np.int32))
        self._cur = None


class PrefetchLoader(DatasetIterator):
    """Background-thread batch prefetch: overlaps host-side packing (and
    remote shard downloads) with the device step.

    The consumer's ``state_dict()`` is exact-resume correct despite the
    buffer: each queued batch is paired with the producer state captured
    AFTER generating it, and ``state_dict`` returns the state paired with
    the LAST CONSUMED batch; restoring it regenerates exactly the batches
    the consumer never saw (buffered ones are dropped).
    ``stall_seconds`` is the time the consumer waited on the queue.
    """

    def __init__(self, inner: DatasetIterator, depth: int = 2):
        self.inner = inner
        self.depth = max(depth, 1)
        self._resume_state = inner.state_dict()
        self.stall_seconds = 0.0
        self._failed: Optional[Exception] = None
        self._start_worker()

    def _start_worker(self) -> None:
        # the queue and stop event are captured by the worker, not read
        # through self: a stale worker that outlives close() can only
        # touch its own abandoned queue, never a successor's
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._q, self._stop), daemon=True,
            name="batch-prefetch")
        self._thread.start()

    def _worker(self, q, stop) -> None:
        while not stop.is_set():
            try:
                batch = next(self.inner)
                item = (batch, self.inner.state_dict())
            except Exception as e:          # handed to the consumer
                item = (e, None)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item[0], Exception):
                return

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        # the worker exits after delivering an exception; a retried next()
        # re-raises it instead of blocking on a queue nobody fills
        if self._failed is not None and self._q.empty():
            raise self._failed
        t0 = time.perf_counter()
        batch, state = self._q.get()
        self.stall_seconds += time.perf_counter() - t0
        if isinstance(batch, Exception):
            self._failed = batch
            raise batch
        self._resume_state = state
        return batch

    def state_dict(self) -> dict:
        return self._resume_state

    def load_state_dict(self, state: dict) -> None:
        # the old worker must be dead before the producer state is reset:
        # a surviving thread would race its successor on next(self.inner)
        self._shutdown_worker(timeout=30.0, must_die=True)
        self.inner.load_state_dict(state)
        self._resume_state = self.inner.state_dict()
        self._failed = None
        self._start_worker()

    def _shutdown_worker(self, timeout: float, must_die: bool = False) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive() and must_die:
            raise RuntimeError(
                "prefetch worker did not stop within "
                f"{timeout:.0f}s (blocked in a shard fetch?); cannot "
                "safely reset the dataset cursor")
        while not self._q.empty():
            self._q.get_nowait()

    def close(self) -> None:
        self._shutdown_worker(timeout=2.0)
        if hasattr(self.inner, "close"):
            self.inner.close()


def make_dataset(path: str, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 pack: bool = True, num_workers: int = 0,
                 prefetch: int = 0,
                 cache_dir: str | Path | None = None) -> DatasetIterator:
    """Dataset factory: 'synthetic', a local shard path (``file://``
    accepted), or a remote ``scheme://`` URI (io/remote.py). ``prefetch >
    0`` wraps the source in a PrefetchLoader of that depth;
    ``num_workers`` sizes the remote download pool."""
    from .remote import is_remote_uri
    path = "" if path is None else str(path)
    if path in ("", "synthetic"):
        ds: DatasetIterator = SyntheticDataset(
            batch_size, seq_len, vocab_size, seed, host_id, num_hosts)
    elif is_remote_uri(path):
        ds = RemoteShardDataset(
            path, batch_size, seq_len, seed, host_id, num_hosts,
            pack=pack, cache_dir=cache_dir,
            num_workers=max(num_workers, 1), prefetch=max(prefetch, 2))
    else:
        if path.startswith("file://"):
            from urllib.parse import urlparse
            p = urlparse(path)
            path = p.netloc + p.path
        ds = MemmapDataset(path, batch_size, seq_len, seed, host_id,
                           num_hosts, pack=pack)
    if prefetch > 0:
        ds = PrefetchLoader(ds, depth=prefetch)
    return ds
