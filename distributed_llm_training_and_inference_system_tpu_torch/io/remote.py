"""Remote shard stores: pluggable ``scheme://`` readers with a local cache.

The port's own copy of the JAX package's ``io/remote.py`` (no JAX in
either; the same classes and behaviour):

- A ``ShardStore`` lists remote ``.bin`` shards and fetches them into a
  local cache directory; once local they are memory-mapped like any other
  shard (download, then mmap: the sequential GET fills the link, the mmap
  serves random access).
- Stores register by scheme (``register_store``). ``file://`` works;
  ``gs://`` and ``s3://`` resolve through their optional client libraries
  (``gcsfs``, ``boto3``) and raise a clear error naming the library when
  it is absent. Tests register an in-process ``mock://`` store with
  injected latency to drive the whole remote path offline.
- ``ShardCache`` downloads ahead of the reader on a thread pool
  (``num_workers``), so shards N+1..N+prefetch land while N is packed.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import threading
from pathlib import Path
from typing import Callable, Optional
from urllib.parse import urlparse

_REGISTRY: dict[str, Callable[[], "ShardStore"]] = {}


def register_store(scheme: str, factory: Callable[[], "ShardStore"]) -> None:
    _REGISTRY[scheme] = factory


def is_remote_uri(path: str) -> bool:
    return "://" in str(path) and not str(path).startswith("file://")


def get_store(uri: str) -> "ShardStore":
    scheme = urlparse(uri).scheme
    if scheme not in _REGISTRY:
        raise ValueError(
            f"no shard store registered for scheme {scheme!r} "
            f"(have: {sorted(_REGISTRY)}); register one via "
            "io.remote.register_store")
    return _REGISTRY[scheme]()


class ShardStore:
    """Interface: list .bin shards under a URI prefix and fetch files."""

    def list_shards(self, uri: str) -> list[str]:
        """URIs of every ``.bin`` shard under the prefix, sorted."""
        raise NotImplementedError

    def fetch(self, uri: str, dest: Path) -> None:
        """Download one object to ``dest`` (atomic: tmp + rename)."""
        raise NotImplementedError


class FileStore(ShardStore):
    """file:// — local paths through the same interface (and the base class
    for the test mock, which adds latency injection)."""

    def _root(self, uri: str) -> Path:
        p = urlparse(uri)
        return Path(p.netloc + p.path)

    def list_shards(self, uri: str) -> list[str]:
        root = self._root(uri)
        if root.is_file():
            return [uri]
        return [f"file://{p}" for p in sorted(root.glob("**/*.bin"))]

    def fetch(self, uri: str, dest: Path) -> None:
        src = self._root(uri)
        tmp = dest.with_suffix(dest.suffix + ".tmp")
        shutil.copyfile(src, tmp)
        # sidecar index travels with the shard when present
        idx = Path(str(src) + ".idx.json")
        if idx.exists():
            shutil.copyfile(idx, Path(str(dest) + ".idx.json"))
        tmp.replace(dest)


class _CloudStoreStub(ShardStore):
    def __init__(self, scheme: str, lib: str):
        self.scheme, self.lib = scheme, lib

    def _fail(self):
        raise RuntimeError(
            f"{self.scheme}:// shard streaming needs the optional "
            f"'{self.lib}' client library, which is not installed. Mirror "
            "the shards locally and point data.train at the directory, or "
            "register a custom store via io.remote.register_store.")

    def list_shards(self, uri):   # pragma: no cover - stub
        self._fail()

    def fetch(self, uri, dest):   # pragma: no cover - stub
        self._fail()


def _try_import(name: str) -> bool:
    try:
        __import__(name)
        return True
    except ImportError:
        return False


def _gcs_factory() -> ShardStore:
    if _try_import("gcsfs"):      # pragma: no cover - optional library
        import gcsfs

        class GCSStore(ShardStore):
            def __init__(self):
                self.fs = gcsfs.GCSFileSystem()

            def list_shards(self, uri):
                pre = uri[len("gs://"):]
                return [f"gs://{p}" for p in sorted(self.fs.glob(
                    pre.rstrip("/") + "/**/*.bin"))]

            def fetch(self, uri, dest):
                tmp = dest.with_suffix(dest.suffix + ".tmp")
                self.fs.get(uri[len("gs://"):], str(tmp))
                idx = uri + ".idx.json"
                if self.fs.exists(idx[len("gs://"):]):
                    self.fs.get(idx[len("gs://"):],
                                str(dest) + ".idx.json")
                tmp.replace(dest)
        return GCSStore()
    return _CloudStoreStub("gs", "gcsfs")


def _s3_factory() -> ShardStore:
    if _try_import("boto3"):      # pragma: no cover - optional library
        import boto3

        class S3Store(ShardStore):
            def __init__(self):
                self.s3 = boto3.client("s3")

            def list_shards(self, uri):
                p = urlparse(uri)
                out = []
                paginator = self.s3.get_paginator("list_objects_v2")
                for page in paginator.paginate(Bucket=p.netloc,
                                               Prefix=p.path.lstrip("/")):
                    for o in page.get("Contents", []):
                        if o["Key"].endswith(".bin"):
                            out.append(f"s3://{p.netloc}/{o['Key']}")
                return sorted(out)

            def fetch(self, uri, dest):
                p = urlparse(uri)
                tmp = dest.with_suffix(dest.suffix + ".tmp")
                self.s3.download_file(p.netloc, p.path.lstrip("/"),
                                      str(tmp))
                tmp.replace(dest)
        return S3Store()
    return _CloudStoreStub("s3", "boto3")


register_store("file", FileStore)
register_store("gs", _gcs_factory)
register_store("s3", _s3_factory)


class ShardCache:
    """Download-ahead cache: shard URIs resolve to local paths, with a
    thread pool fetching ``prefetch_depth`` shards past the last request.

    ``local_path(i)`` blocks only if shard *i* hasn't landed yet — with a
    warm pipeline the wait is ~0 (asserted against the mock store's
    injected latency in tests/test_torch_remote_data.py).
    """

    def __init__(self, uris: list[str], store: ShardStore,
                 cache_dir: str | Path, num_workers: int = 2,
                 prefetch_depth: int = 2,
                 max_cached: Optional[int] = None):
        self.uris = uris
        self.store = store
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.prefetch_depth = max(prefetch_depth, 0)
        # disk bound: keep at most this many shards local, evicting the
        # least recently ACCESSED (None = unbounded — fine when the
        # dataset fits the disk; a multi-hundred-GB corpus should set it)
        self.max_cached = max_cached
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(num_workers, 1),
            thread_name_prefix="shard-fetch")
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._access: dict[int, int] = {}     # shard -> last access tick
        self._tick = 0
        self._lock = threading.Lock()
        self.stall_seconds = 0.0      # time local_path() spent blocking

    def _dest(self, i: int) -> Path:
        name = Path(urlparse(self.uris[i]).path).name
        return self.cache_dir / f"{i:06d}-{name}"

    def _ensure_submitted(self, i: int) -> concurrent.futures.Future:
        with self._lock:
            fut = self._futures.get(i)
            if fut is None:
                dest = self._dest(i)
                if dest.exists():
                    fut = concurrent.futures.Future()
                    fut.set_result(dest)
                else:
                    fut = self._pool.submit(self._fetch, i, dest)
                self._futures[i] = fut
            return fut

    def _fetch(self, i: int, dest: Path) -> Path:
        self.store.fetch(self.uris[i], dest)
        return dest

    def local_path(self, i: int, upcoming: Optional[list[int]] = None) -> Path:
        """Local path of shard i (blocking if not yet fetched); kicks off
        download-ahead for ``upcoming`` — the caller's actual future
        access order (a shuffled dataset must pass its permutation here;
        URI order would prefetch the wrong shards). Falls back to
        sequential order when ``upcoming`` is None."""
        import time
        fut = self._ensure_submitted(i)
        if upcoming is None:
            upcoming = list(range(i + 1, min(i + 1 + self.prefetch_depth,
                                             len(self.uris))))
        for j in upcoming[:self.prefetch_depth]:
            self._ensure_submitted(j)
        t0 = time.perf_counter()
        path = fut.result()
        self.stall_seconds += time.perf_counter() - t0
        with self._lock:
            self._tick += 1
            self._access[i] = self._tick
            self._evict_locked(keep={i, *upcoming[:self.prefetch_depth]})
        return path

    def _evict_locked(self, keep: set) -> None:
        if self.max_cached is None:
            return
        cached = [j for j, f in self._futures.items()
                  if f.done() and not f.cancelled() and j not in keep]
        excess = len(cached) + len(keep & set(self._futures)) \
            - self.max_cached
        if excess <= 0:
            return
        cached.sort(key=lambda j: self._access.get(j, 0))
        for j in cached[:excess]:
            self._futures.pop(j, None)
            self._access.pop(j, None)
            self._dest(j).unlink(missing_ok=True)
            Path(str(self._dest(j)) + ".idx.json").unlink(missing_ok=True)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
