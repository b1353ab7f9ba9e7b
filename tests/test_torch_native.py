"""The port's C++ sequence packer (``native/dataloader.cpp`` through
``io/native.py``) against the JAX package's ``NativePacker`` and the port's
numpy packer, on the CPU.

- ``MemmapDataset`` packs natively unless ``LLMCTL_NO_NATIVE=1``; its
  batches are byte for byte JAX's (which packs in its own native packer)
  and the numpy packer's, with packing on and off, tails dropped, uint16
  and uint32 shards, host stripes and several epochs;
- a resume from a state saved by either packer continues identically;
- the library is built into ``build/native/`` (never beside the source),
  named by a hash of source, flags and compiler version, and the port's
  copy of the C++ source is the JAX package's, apart from its header
  comment;
- a build that fails raises with the compiler's output (a missing
  compiler, one that exits non-zero) instead of falling back to numpy.
"""

import os
import stat
from pathlib import Path

import numpy as np
import pytest

from distributed_llm_training_and_inference_system_tpu.io import (
    data as jdata)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    data as tdata, native)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def shard_dir(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "shards"
    for i in range(3):
        docs = [rng.integers(1, 60000, size=rng.integers(3, 150))
                for _ in range(9)]
        tdata.write_token_shard(d / f"a-{i}.bin", docs)
    big = [rng.integers(1, 2**20, size=rng.integers(5, 70))
           for _ in range(5)]
    tdata.write_token_shard(d / "b-wide.bin", big, dtype=np.uint32)
    return d


def _numpy(root, **kw):
    os.environ["LLMCTL_NO_NATIVE"] = "1"
    try:
        return tdata.MemmapDataset(root, **kw)
    finally:
        del os.environ["LLMCTL_NO_NATIVE"]


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


CASES = [dict(), dict(pack=False), dict(drop_tail_docs=True),
         dict(host_id=1, num_hosts=2), dict(seq_len=7, batch_size=5),
         dict(seq_len=300, batch_size=1)]


@pytest.mark.parametrize("kw", CASES, ids=["packed", "unpacked", "drop_tail",
                                           "host_stripe", "short_rows",
                                           "long_rows"])
def test_native_batches_equal_jax_and_numpy(shard_dir, kw):
    args = dict(batch_size=3, seq_len=64, seed=5)
    args.update(kw)
    t = tdata.MemmapDataset(shard_dir, **args)
    j = jdata.MemmapDataset(shard_dir, **args)
    n = _numpy(shard_dir, **args)
    assert t._native is not None and n._native is None
    before = native.NativePacker.batches
    for _ in range(25):                      # crosses several epochs
        got = next(t)
        _equal(got, next(j))
        _equal(got, next(n))
    assert native.NativePacker.batches - before == 25
    assert t.state_dict() == n.state_dict() == j.state_dict()


def test_resume_across_packers(shard_dir):
    kw = dict(batch_size=2, seq_len=50, seed=9)
    n = _numpy(shard_dir, **kw)
    for _ in range(4):
        next(n)
    state = n.state_dict()
    want = [next(n) for _ in range(6)]
    t = tdata.MemmapDataset(shard_dir, **kw)
    t.load_state_dict(state)
    for w in want:
        _equal(next(t), w)
    n2 = _numpy(shard_dir, **kw)
    n2.load_state_dict(t.state_dict())
    t_next = [next(t) for _ in range(3)]
    for w in t_next:
        _equal(next(n2), w)


def test_library_lives_under_build_and_source_is_jax(shard_dir):
    tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
    path = native.library_path()
    assert path.is_file() and path.parent == ROOT / "build" / "native"
    assert not list(native.SOURCE.parent.glob("*.so"))
    jax_src = (ROOT / "distributed_llm_training_and_inference_system_tpu"
               / "native" / "dataloader.cpp").read_text()
    body = jax_src[jax_src.index("#include <cstdint>"):]
    port = native.SOURCE.read_text()
    assert port[port.index("#include <cstdint>"):] == body
    assert native.library_path("g++") == path
    assert native.library_path("gcc") != path        # another toolchain


def test_llmctl_no_native_is_the_explicit_choice(shard_dir, monkeypatch):
    for value, want_native in (("1", False), ("0", True), ("", True)):
        monkeypatch.setenv("LLMCTL_NO_NATIVE", value)
        ds = tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
        assert (ds._native is not None) is want_native, value


def _fresh_build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native-build")
    monkeypatch.setattr(native, "_libs", {})


def test_missing_compiler_raises(shard_dir, tmp_path, monkeypatch):
    _fresh_build_dir(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("LLMCTL_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
    assert not (tmp_path / "native-build").exists() or not list(
        (tmp_path / "native-build").glob("*.so"))


def test_failing_compiler_raises_with_its_stderr(shard_dir, tmp_path,
                                                 monkeypatch):
    _fresh_build_dir(monkeypatch, tmp_path)
    bad = tmp_path / "bad-cxx"
    bad.write_text("#!/bin/sh\necho 'dataloader.cpp:1: error: broken' >&2\n"
                   "exit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.delenv("LLMCTL_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match=r"exit 3(.|\n)*error: broken"):
        tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
    assert not list((tmp_path / "native-build").glob("*.so"))
    assert not list((tmp_path / "native-build").glob("*.tmp"))
    # the numpy packer stays the explicit way out
    monkeypatch.setenv("LLMCTL_NO_NATIVE", "1")
    ds = tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
    assert ds._native is None and next(ds)["tokens"].shape == (1, 16)


def test_carry_longer_than_any_document_is_refused(shard_dir):
    ds = tdata.MemmapDataset(shard_dir, batch_size=1, seq_len=16)
    with pytest.raises(ValueError, match="longest document"):
        ds._native.carry = np.zeros(10_000, np.int32)
