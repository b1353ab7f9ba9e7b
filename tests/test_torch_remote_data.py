"""The port's remote shard streaming and prefetch loader (``io/remote.py``,
``io/data.py``) against the JAX package's, on the CPU.

A ``mock://`` store (``file://`` semantics plus injected latency, as the
JAX package's tests/test_remote_data.py builds it) is registered in both
packages, so both stream the same shards through their whole remote path:

- ``RemoteShardDataset`` gives byte-identical batches to JAX's (packing on
  and off, tails dropped, host stripes, several epochs), the same
  ``state_dict`` and the same batches after a resume from either
  package's state;
- ``PrefetchLoader`` gives the synchronous stream's batches and JAX's
  loader's, its ``state_dict`` is JAX's after the same batches consumed,
  and a resume from it replays exactly the batches not consumed;
- ``make_dataset`` routes ``mock://``, ``file://`` and local paths as JAX's
  does, wrapping in a ``PrefetchLoader`` when ``prefetch > 0``;
- ``ShardCache`` hides fetch latency behind the reader, reuses its disk
  cache and bounds it; a worker's exception reaches the consumer (also on
  a retry); ``close`` removes a cache directory the dataset made;
- the training engine passes ``data.num_workers`` and
  ``data.prefetch_factor`` to ``make_dataset`` as the JAX engine does.
"""

import time
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import pytest

from distributed_llm_training_and_inference_system_tpu.io import (
    data as jdata, remote as jremote)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    data as tdata, remote as tremote)


def _slow_store(base):
    class SlowStore(base):
        """file:// semantics with injected per-fetch latency and a fetch
        count."""

        latency_s = 0.05
        fetches = 0

        def _root(self, uri):
            p = urlparse(uri)
            return Path(p.netloc + p.path)

        def list_shards(self, uri):
            return [u.replace("file://", "mock://")
                    for u in super().list_shards(
                        uri.replace("mock://", "file://"))]

        def fetch(self, uri, dest):
            time.sleep(type(self).latency_s)
            type(self).fetches += 1
            super().fetch(uri.replace("mock://", "file://"), dest)
    return SlowStore


TStore = _slow_store(tremote.FileStore)
JStore = _slow_store(jremote.FileStore)
tremote.register_store("mock", TStore)
jremote.register_store("mock", JStore)


@pytest.fixture()
def shard_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "shards"
    for i in range(4):
        docs = [rng.integers(1, 250, size=rng.integers(20, 60))
                for _ in range(6)]
        tdata.write_token_shard(d / f"part-{i}.bin", docs)
    return d


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("uri,want", [
    ("gs://bucket/x", True), ("mock://x/y", True), ("s3://b/k", True),
    ("/local/path", False), ("file:///local/path", False),
    ("synthetic", False)])
def test_is_remote_uri_as_jax(uri, want):
    assert tremote.is_remote_uri(uri) is want
    assert jremote.is_remote_uri(uri) is want


def test_unknown_scheme_and_missing_client_library():
    with pytest.raises(ValueError, match="no shard store registered"):
        tremote.get_store("carrier-pigeon://x")
    stub = tremote._CloudStoreStub("gs", "gcsfs")
    with pytest.raises(RuntimeError, match="gcsfs"):
        stub.list_shards("gs://bucket/prefix")
    with pytest.raises(RuntimeError, match="boto3"):
        tremote._CloudStoreStub("s3", "boto3").fetch("s3://b/k", Path("x"))
    assert sorted(tremote._REGISTRY) == sorted(jremote._REGISTRY)


def test_file_store_lists_and_fetches_with_its_index(shard_dir, tmp_path):
    store = tremote.get_store("file://x")
    uris = store.list_shards(f"file://{shard_dir}")
    assert uris == jremote.get_store("file://x").list_shards(
        f"file://{shard_dir}")
    dest = tmp_path / "one.bin"
    store.fetch(uris[0], dest)
    assert dest.read_bytes() == (shard_dir / "part-0.bin").read_bytes()
    assert Path(str(dest) + ".idx.json").exists()
    assert not dest.with_suffix(".bin.tmp").exists()


@pytest.mark.parametrize("kw", [
    dict(), dict(pack=False), dict(drop_tail_docs=True),
    dict(host_id=1, num_hosts=2), dict(seed=11, seq_len=24)],
    ids=["packed", "unpacked", "drop_tail", "host_stripe", "short_rows"])
def test_remote_batches_equal_jax(shard_dir, tmp_path, kw):
    args = dict(batch_size=2, seq_len=48, seed=7, num_workers=2, prefetch=2)
    args.update(kw)
    t = tdata.RemoteShardDataset(f"mock://{shard_dir}",
                                 cache_dir=tmp_path / "t", **args)
    j = jdata.RemoteShardDataset(f"mock://{shard_dir}",
                                 cache_dir=tmp_path / "j", **args)
    try:
        assert t.uris == j.uris
        for _ in range(12):                  # several epochs of one stripe
            _equal(next(t), next(j))
        assert t.state_dict() == j.state_dict()
    finally:
        t.close()
        j.close()


def test_remote_resume_from_either_package(shard_dir, tmp_path):
    kw = dict(batch_size=2, seq_len=48, seed=7, num_workers=1, prefetch=0)
    j = jdata.RemoteShardDataset(f"mock://{shard_dir}",
                                 cache_dir=tmp_path / "a", **kw)
    for _ in range(3):
        next(j)
    state = j.state_dict()
    want = [next(j) for _ in range(3)]
    t = tdata.RemoteShardDataset(f"mock://{shard_dir}",
                                 cache_dir=tmp_path / "b", **kw)
    t.load_state_dict(state)
    for w in want:
        _equal(next(t), w)
    # and the port's own state resumes the JAX dataset
    state = t.state_dict()
    want = [next(t) for _ in range(2)]
    j.load_state_dict(state)
    for w in want:
        _equal(next(j), w)
    t.close()
    j.close()


def test_shard_cache_hides_fetch_latency(shard_dir, tmp_path):
    store = tremote.get_store("mock://x")
    uris = store.list_shards(f"mock://{shard_dir}")
    assert len(uris) == 4
    cache = tremote.ShardCache(uris, store, tmp_path / "cache",
                               num_workers=2, prefetch_depth=3)
    cache.local_path(0)
    stall_after_first = cache.stall_seconds
    time.sleep(TStore.latency_s * 6)          # the reader's packing time
    for i in (1, 2, 3):
        cache.local_path(i)
    tail_stall = cache.stall_seconds - stall_after_first
    assert tail_stall < TStore.latency_s, \
        f"prefetch did not hide fetch latency (stall {tail_stall:.3f}s)"
    cache.close()


def test_shard_cache_reuses_its_disk_and_bounds_it(shard_dir, tmp_path):
    store = tremote.get_store("mock://x")
    uris = store.list_shards(f"mock://{shard_dir}")
    cache = tremote.ShardCache(uris, store, tmp_path / "c2", num_workers=1,
                               prefetch_depth=0)
    p0 = cache.local_path(0)
    TStore.fetches = 0
    cache2 = tremote.ShardCache(uris, store, tmp_path / "c2", num_workers=1,
                                prefetch_depth=0)
    assert cache2.local_path(0) == p0 and TStore.fetches == 0
    cache.close()
    cache2.close()
    ds = tdata.RemoteShardDataset(f"mock://{shard_dir}", batch_size=1,
                                  seq_len=32, cache_dir=tmp_path / "ev",
                                  num_workers=1, prefetch=0,
                                  max_cached_shards=2)
    for slot in range(4):
        ds._open_shard(slot)
    assert len(list((tmp_path / "ev").glob("*.bin"))) <= 2
    ds.close()


def test_download_ahead_follows_the_shuffle(shard_dir, tmp_path):
    ds = tdata.RemoteShardDataset(f"mock://{shard_dir}", batch_size=1,
                                  seq_len=32, seed=11,
                                  cache_dir=tmp_path / "pf", num_workers=2,
                                  prefetch=2)
    order = list(ds._shard_order())
    ds._open_shard(0)
    time.sleep(TStore.latency_s * 5)
    for slot in (1, 2):
        assert ds.cache._dest(int(order[slot])).exists(), slot
    ds.close()


def test_close_removes_a_cache_dir_it_made(shard_dir):
    ds = tdata.RemoteShardDataset(f"mock://{shard_dir}", batch_size=1,
                                  seq_len=32)
    next(ds)
    cache_dir = ds.cache.cache_dir
    assert cache_dir.exists()
    ds.close()
    assert not cache_dir.exists()


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_loader_equals_sync_and_jax(shard_dir, depth):
    kw = dict(batch_size=2, seq_len=40, seed=3)
    sync = tdata.MemmapDataset(shard_dir, **kw)
    want = [next(sync) for _ in range(6)]
    t = tdata.PrefetchLoader(tdata.MemmapDataset(shard_dir, **kw),
                             depth=depth)
    j = jdata.PrefetchLoader(jdata.MemmapDataset(shard_dir, **kw),
                             depth=depth)
    try:
        for w in want:
            got, ref = next(t), next(j)
            _equal(got, w)
            _equal(got, ref)
        assert t.state_dict() == j.state_dict() == sync.state_dict()
    finally:
        t.close()
        j.close()


def test_prefetch_resume_replays_what_was_not_consumed(shard_dir):
    kw = dict(batch_size=2, seq_len=40, seed=3)
    pre = tdata.PrefetchLoader(tdata.MemmapDataset(shard_dir, **kw),
                               depth=4)
    for _ in range(2):
        next(pre)
    time.sleep(0.1)                            # the buffer fills
    state = pre.state_dict()
    want = [next(pre) for _ in range(3)]
    fresh = jdata.MemmapDataset(shard_dir, **kw)   # JAX reads it too
    fresh.load_state_dict(state)
    for w in want:
        _equal(next(fresh), w)
    pre.load_state_dict(state)                 # in place: worker restarted
    for w in want:
        _equal(next(pre), w)
    pre.close()
    assert not pre._thread.is_alive()


def test_prefetch_worker_exception_reaches_the_consumer():
    class Boom:
        def state_dict(self):
            return {}

        def __next__(self):
            raise RuntimeError("shard corrupted")
    pre = tdata.PrefetchLoader(Boom(), depth=2)
    for _ in range(3):                         # every retry re-raises
        with pytest.raises(RuntimeError, match="shard corrupted"):
            next(pre)
    pre.close()


def test_prefetch_overlaps_a_slow_producer():
    class Slow:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": self.n}

        def __next__(self):
            time.sleep(0.03)
            self.n += 1
            return {"tokens": np.zeros((1, 8), np.int32)}
    pre = tdata.PrefetchLoader(Slow(), depth=4)
    next(pre)
    time.sleep(0.3)
    t0 = time.perf_counter()
    for _ in range(4):
        next(pre)
    assert time.perf_counter() - t0 < 0.09, "prefetch buffer was empty"
    assert pre.stall_seconds >= 0.0
    pre.close()


@pytest.mark.parametrize("scheme,prefetch", [
    ("mock", 2), ("mock", 0), ("file", 2), ("local", 0), ("synthetic", 3)])
def test_make_dataset_routes_as_jax(shard_dir, tmp_path, scheme, prefetch):
    path = {"mock": f"mock://{shard_dir}", "file": f"file://{shard_dir}",
            "local": str(shard_dir), "synthetic": "synthetic"}[scheme]
    kw = dict(seed=0, num_workers=1, prefetch=prefetch)
    t = tdata.make_dataset(path, 2, 32, 300, cache_dir=tmp_path / "t", **kw)
    j = jdata.make_dataset(path, 2, 32, 300, cache_dir=tmp_path / "j", **kw)
    try:
        assert type(t).__name__ == type(j).__name__
        if prefetch:
            assert isinstance(t, tdata.PrefetchLoader) and t.depth == prefetch
            assert type(t.inner).__name__ == type(j.inner).__name__
        for _ in range(4):
            _equal(next(t), next(j))
    finally:
        for ds in (t, j):
            if hasattr(ds, "close"):
                ds.close()


def test_engine_passes_workers_and_prefetch_to_make_dataset(shard_dir,
                                                            tmp_path):
    """The training dataset is wrapped in a PrefetchLoader of depth
    data.prefetch_factor and a remote one downloads on data.num_workers
    threads, as in the JAX engine; the validation set is not prefetched."""
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import get_model_config, loader
    from distributed_llm_training_and_inference_system_tpu_torch.runtime \
        .engine import TrainingEngine
    cfg = loader.load_run_config(None, cli_overrides={
        "data": {"train": f"mock://{shard_dir}", "num_workers": 3,
                 "prefetch_factor": 5, "max_length": 32},
        "parallel": {"micro_batch_size": 2, "global_batch_size": 2},
        "checkpoint": {"path": str(tmp_path / "ck")}})
    cfg.model = get_model_config("gpt-test")
    eng = TrainingEngine(cfg, device="cpu")
    try:
        assert isinstance(eng.train_data, tdata.PrefetchLoader)
        assert eng.train_data.depth == 5
        inner = eng.train_data.inner
        assert isinstance(inner, tdata.RemoteShardDataset)
        assert inner.cache._pool._max_workers == 3
        assert inner._prefetch == 5
        assert isinstance(eng.val_data, tdata.SyntheticDataset)
        ref = jdata.make_dataset(f"mock://{shard_dir}", 2, 32,
                                 cfg.model.vocab_size,
                                 seed=cfg.data.seed, num_workers=3,
                                 prefetch=5, cache_dir=tmp_path / "j")
        for _ in range(3):
            _equal(next(eng.train_data), next(ref))
        ref.close()
    finally:
        eng.close()
    assert not eng.train_data._thread.is_alive()
