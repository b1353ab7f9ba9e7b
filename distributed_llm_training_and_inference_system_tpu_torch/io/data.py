"""Dataset streaming: tokenized memmap shards + a synthetic stream.

The port's own copy of the JAX package's ``io/data.py`` (numpy only; for
the same seed the batches are byte-identical to the JAX package's):

- ``.bin`` shards of little-endian uint16/uint32 token ids with a sidecar
  ``<name>.idx.json`` recording dtype and document boundaries
  (``write_token_shard``), memory-mapped by ``MemmapDataset``;
- sequence packing (``_Packer``): documents back to back in fixed [B, S]
  rows with segment ids (1-based per document, 0 = pad) and positions that
  restart per document;
- deterministic order: a pure function of (seed, epoch), with
  ``state_dict()``/``load_state_dict()`` for exact resume;
- ``SyntheticDataset``, a learnable stream for benchmarks and tests.

Remote ``scheme://`` shards and the background prefetch loader are not
ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np


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


def make_dataset(path: str, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 pack: bool = True) -> DatasetIterator:
    """Dataset factory: 'synthetic' or a local shard path (``file://``
    accepted). Remote URIs are not ported yet."""
    path = "" if path is None else str(path)
    if path in ("", "synthetic"):
        return SyntheticDataset(batch_size, seq_len, vocab_size, seed,
                                host_id, num_hosts)
    if "://" in path and not path.startswith("file://"):
        raise NotImplementedError(
            f"remote dataset {path!r} is not ported yet (ROADMAP queue 1 "
            f"item 8)")
    if path.startswith("file://"):
        from urllib.parse import urlparse
        p = urlparse(path)
        path = p.netloc + p.path
    return MemmapDataset(path, batch_size, seq_len, seed, host_id, num_hosts,
                         pack=pack)
