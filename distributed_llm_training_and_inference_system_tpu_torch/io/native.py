"""ctypes bridge to the C++ sequence packer (``native/dataloader.cpp``).

The port's counterpart of the JAX package's ``io/native.py``. The packer
is a plain C ABI loaded with ``ctypes``; ``NativePacker`` fills one [B, S]
batch per call with exactly the numpy packer's tokens, segment ids and
positions (``io/data.py``), so ``MemmapDataset`` gives the same bytes
either way.

- The shared library is compiled with ``g++`` (``$CXX`` when set) at first
  use into ``build/native/`` at the root of the checkout, named by a hash
  of the source, the flags and the compiler's version; nothing is written
  beside the source and nothing is built when this module is imported.
- ``LLMCTL_NO_NATIVE=1`` is the explicit way to choose the numpy packer.
- **Unlike the JAX package, a failed build raises** (``RuntimeError``
  carrying the compiler's stderr) instead of falling back to numpy in
  silence: a dataloader that quietly became several times slower would
  show up only as an unexplained drop in training throughput.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


class PackState(ctypes.Structure):
    _fields_ = [("row", ctypes.c_int64), ("fill", ctypes.c_int64),
                ("seg", ctypes.c_int32), ("cursor", ctypes.c_int64)]


def disabled() -> bool:
    """Whether ``LLMCTL_NO_NATIVE`` asks for the numpy packer."""
    return os.environ.get("LLMCTL_NO_NATIVE", "") not in ("", "0")


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native packer build failed: {' '.join(cmd)}: "
                           f"{e} (set LLMCTL_NO_NATIVE=1 for the numpy "
                           f"packer)") from e


def library_path(cxx: Optional[str] = None) -> Path:
    """The library's path, named by a hash of the source, the flags and
    the compiler's ``--version`` (another toolchain builds its own)."""
    cxx = cxx or compiler()
    version = _run([cxx, "--version"]).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (cxx, version, *CXX_FLAGS)).encode()).hexdigest()
    return BUILD_DIR / f"dataloader-{digest[:16]}.so"


def build(cxx: Optional[str] = None) -> Path:
    """Compile the packer (unless already built) and return its path.
    Raises RuntimeError with the compiler's output if it cannot."""
    cxx = cxx or compiler()
    out = library_path(cxx)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = _run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)])
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native packer build failed ({cxx} exit {res.returncode}; set "
            f"LLMCTL_NO_NATIVE=1 for the numpy packer):\n{res.stderr}"
            f"{res.stdout}")
    os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded packer library, building it on first use."""
    with _lock:
        path = build()
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            fn = lib.llmctl_pack_continue
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),   # shard_ptrs
                ctypes.POINTER(ctypes.c_int32),    # shard_itemsize
                ctypes.POINTER(ctypes.c_int64),    # doc_table
                ctypes.POINTER(ctypes.c_int64),    # order
                ctypes.c_int64,                    # order_len
                ctypes.POINTER(ctypes.c_int32),    # tokens
                ctypes.POINTER(ctypes.c_int32),    # segs
                ctypes.POINTER(ctypes.c_int32),    # pos
                ctypes.c_int64, ctypes.c_int64,    # B, S
                ctypes.c_int32, ctypes.c_int32,    # pack, drop_tail
                ctypes.POINTER(ctypes.c_int32),    # carry
                ctypes.c_int64,                    # carry_cap
                ctypes.POINTER(ctypes.c_int64),    # carry_len
                ctypes.POINTER(PackState),         # state
            ]
            _libs[path] = lib
        return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativePacker:
    """Stateful wrapper owning the C-side buffers for one MemmapDataset.
    ``NativePacker.batches`` counts the batches packed in C++ (a plain
    integer callers may reset)."""

    batches = 0

    def __init__(self, shards, doc_table: np.ndarray, pack: bool,
                 drop_tail: bool):
        self.lib = get_lib()
        self._maps = [sh.tokens() for sh in shards]   # hold memmaps alive
        for m in self._maps:
            if m.dtype.itemsize not in (2, 4):
                raise ValueError(f"native packer: token dtype {m.dtype} "
                                 "(uint16 or uint32 only)")
        self._ptrs = np.asarray(
            [m.ctypes.data for m in self._maps], np.uint64)
        self._itemsize = np.asarray([m.dtype.itemsize for m in self._maps],
                                    np.int32)
        self.doc_table = np.ascontiguousarray(doc_table, np.int64)
        lens = self.doc_table[:, 2] - self.doc_table[:, 1]
        self._carry = np.zeros(max(int(lens.max()), 1), np.int32)
        self._carry_len = ctypes.c_int64(0)
        self.pack = pack
        self.drop_tail = drop_tail

    @property
    def carry(self) -> Optional[np.ndarray]:
        n = self._carry_len.value
        return None if n == 0 else self._carry[:n].copy()

    @carry.setter
    def carry(self, value: Optional[np.ndarray]) -> None:
        if value is None:
            self._carry_len.value = 0
        else:
            v = np.asarray(value, np.int32)
            if len(v) > len(self._carry):
                raise ValueError(f"carry of {len(v)} tokens exceeds the "
                                 f"longest document ({len(self._carry)})")
            self._carry[:len(v)] = v
            self._carry_len.value = len(v)

    def pack_batch(self, order: np.ndarray, cursor: int, B: int, S: int,
                   next_perm) -> tuple[dict, int, int]:
        """Pack one [B, S] batch starting at ``cursor`` into ``order``.

        ``next_perm(epoch_increments) -> new order`` is called when the
        order is exhausted mid-batch (the Python-side seeded re-permute).
        Returns (batch dict, cursor, epochs_advanced).
        """
        tokens = np.zeros((B, S), np.int32)
        segs = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        st = PackState(0, 0, 1, int(cursor))
        order = np.ascontiguousarray(order, np.int64)
        epochs = 0
        while True:
            if len(order) == 0:
                raise ValueError("native packer: no documents to pack")
            rc = self.lib.llmctl_pack_continue(
                self._ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                self._itemsize.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)),
                _i64p(self.doc_table), _i64p(order), len(order),
                _i32p(tokens), _i32p(segs), _i32p(pos),
                B, S, int(self.pack), int(self.drop_tail),
                _i32p(self._carry), len(self._carry),
                ctypes.byref(self._carry_len), ctypes.byref(st))
            if rc == 0:
                break
            if rc == 1:
                epochs += 1
                order = np.ascontiguousarray(next_perm(epochs), np.int64)
                st.cursor = 0
                continue
            raise RuntimeError(f"native packer error {rc}")
        NativePacker.batches += 1
        return ({"tokens": tokens, "segment_ids": segs, "positions": pos},
                int(st.cursor), epochs)
