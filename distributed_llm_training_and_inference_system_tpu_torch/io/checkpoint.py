"""Atomic checkpoints of the full train state on one process.

Counterpart of the JAX package's ``io/checkpoint.py`` for a single card:

- **complete**: model parameters, optimizer state (every field of the
  configured optimizer's state), step, the data cursor and user metadata
  round-trip exactly;
- **atomic**: data lands in ``step_N.tmp/`` and is renamed and
  COMMIT-marked; restore ignores uncommitted directories;
- **async**: tensors are copied to host memory at ``save`` (so training
  may go on updating them), the file is written on a background thread;
  ``wait()`` flushes;
- **GC**: ``keep_latest`` is enforced after every commit.

The on-disk layout is the port's own (``state.pt``, a ``torch.save`` of
host tensors, beside ``index.json``). ``restore`` also reads the JAX
package's checkpoints (``host_<i>.npz`` files of slice-keyed blobs, bf16
stored as its uint16 bits, the leaves' shapes and dtypes in
``index.json``): ``read_jax_checkpoint`` assembles every leaf from its
slices into a flat ``{dotted path: host tensor}`` dict, which
``weights.state_dict_from_flat`` turns into the port's state dict.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_COMMIT = "COMMIT"


def _save(obj: Any, path: Path) -> None:
    """``torch.save`` without the CRC-32 of each zip record: ``torch.load``
    never checks it (a flipped byte loads as it is), and computing it is
    most of the time a large state takes to write."""
    try:
        from torch.utils.serialization import config
    except ImportError:         # PyTorch before 2.6 always computes it
        config = None
    if config is None or not hasattr(config.save, "compute_crc32"):
        torch.save(obj, path)
        return
    with config.patch({"save.compute_crc32": False}):
        torch.save(obj, path)


def _to_host(obj: Any) -> Any:
    """A host copy of every tensor in a nested dict/list structure."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_to_dict(state) -> dict:
    """A ``TrainState`` as plain tensors: params by name; each optimizer
    state field by parameter name (a count as it is); the step."""
    names = [n for n, _ in state.model.named_parameters()]
    opt = {}
    for f in dataclasses.fields(state.opt_state):
        v = getattr(state.opt_state, f.name)
        opt[f.name] = v if isinstance(v, torch.Tensor) else dict(
            zip(names, v, strict=True))
    return {"step": int(state.step),
            "params": dict(state.model.state_dict()), "opt_state": opt}


@torch.no_grad()
def load_state_dict_into(state, d: dict) -> None:
    """Copy a ``state_to_dict`` result into ``state`` in place (on its
    devices, in its dtypes). The saved optimizer state must have every
    field of ``state``'s; a params-only checkpoint (``io.hf_import``)
    keeps ``state``'s fresh optimizer state."""
    names = [n for n, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    for n in names:
        params[n].copy_(d["params"][n])
    state.step = int(d["step"])
    if "opt_state" not in d:
        return
    for f in dataclasses.fields(state.opt_state):
        if f.name not in d["opt_state"]:
            raise ValueError(
                f"checkpoint has no optimizer field {f.name!r} (saved "
                f"fields: {sorted(d['opt_state'])})")
        dst, src = getattr(state.opt_state, f.name), d["opt_state"][f.name]
        if isinstance(dst, torch.Tensor):
            dst.copy_(src)
            continue
        for n, t in zip(names, dst, strict=True):
            if tuple(t.shape) != tuple(src[n].shape):
                raise ValueError(f"optimizer {f.name}[{n}]: shape "
                                 f"{tuple(src[n].shape)} != {tuple(t.shape)}")
            t.copy_(src[n])


def _parse_slice_key(key: str, shape: tuple) -> tuple:
    """A JAX checkpoint blob's slice key ("0_2/0_64", "" for a whole leaf)
    -> the slices of the leaf it holds."""
    if not key:
        return tuple(slice(0, n) for n in shape)
    return tuple(slice(int(a), int(b))
                 for a, b in (p.split("_") for p in key.split("/")))


def _from_saved(blob: np.ndarray, dtype: str) -> torch.Tensor:
    """A saved blob as a host tensor of its recorded dtype (bf16 was saved
    as its uint16 bits)."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(blob).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(blob))


def read_jax_checkpoint(d: Path) -> dict:
    """The leaves of a JAX package checkpoint directory as {dotted path:
    host tensor}, each assembled from the slices every host saved; a leaf
    whose slices do not cover it is refused (a torn save)."""
    index = json.loads((d / "index.json").read_text())
    pieces: dict[str, list] = {}
    for host_file in sorted(d.glob("host_*.npz")):
        with np.load(host_file) as z:
            for key in z.files:
                path, _, skey = key.partition("@")
                pieces.setdefault(path, []).append((skey, z[key]))
    out = {}
    for path, info in index["leaves"].items():
        shape, dtype = tuple(info["shape"]), info["dtype"]
        if path not in pieces:
            raise ValueError(f"checkpoint missing leaf {path}")
        blobs = pieces[path]
        if len(blobs) == 1 and blobs[0][0] == "":
            out[path] = _from_saved(blobs[0][1], dtype).reshape(shape)
            continue
        first = _from_saved(blobs[0][1], dtype)
        full = torch.zeros(shape, dtype=first.dtype)
        covered = torch.zeros(shape, dtype=torch.bool)
        for skey, blob in blobs:
            idx = _parse_slice_key(skey, shape)
            full[idx] = _from_saved(blob, dtype)
            covered[idx] = True
        if not bool(covered.all()):
            missing = covered.numel() - int(covered.sum())
            raise ValueError(
                f"checkpoint leaf {path}: {missing}/{covered.numel()} "
                f"elements missing from saved shards (torn checkpoint?)")
        out[path] = full
    return out


def subtree(flat: dict, prefix: str) -> dict:
    """The nested tree under ``prefix`` of a flat {dotted path: leaf}
    dict (``opt_state.0.mu`` -> {"embed": {"embedding": ...}, ...})."""
    nested: dict = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix + "."):
            continue
        parts = key[len(prefix) + 1:].split(".")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return nested


def params_from_flat(flat: dict) -> dict:
    """The nested ``params`` tree of a flat JAX checkpoint (dotted paths
    ``params.<...>``), as the JAX ``params_from_flat``."""
    return subtree(flat, "params")


def apply_ckpt_model_overrides(cfg, extra: dict):
    """The model config aligned with architecture facts a checkpoint's
    metadata records (``config.tie_word_embeddings``), as the JAX
    function does."""
    rec = (extra or {}).get("config", {})
    tied = rec.get("tie_word_embeddings")
    if tied is not None and tied != cfg.tie_word_embeddings:
        cfg = dataclasses.replace(cfg, tie_word_embeddings=bool(tied))
    return cfg


class CheckpointManager:
    """Manages a directory of step checkpoints for one training run."""

    def __init__(self, directory: str | Path, keep_latest: int = 5,
                 async_save: bool = True):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_latest = keep_latest
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: dict, extra: Optional[dict] = None
             ) -> Path:
        """Snapshot ``state`` (a nested dict of tensors and numbers) at
        ``step``. Returns the final path (still being written when async;
        ``wait()`` flushes)."""
        self.wait()          # one save in flight at a time
        host = _to_host(state)
        index = {"step": int(step), "extra": extra or {}}
        tmp = self.directory / f"step_{step}.tmp"
        final = self.directory / f"step_{step}"

        def write():
            try:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                _save(host, tmp / "state.pt")
                (tmp / "index.json").write_text(json.dumps(index))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                (final / _COMMIT).write_text("ok")
                self._gc()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        if self.async_save:
            self._pending = threading.Thread(target=write, daemon=True,
                                             name="checkpoint-write")
            self._pending.start()
        else:
            write()
            self._raise_pending_error()
        return final

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_pending_error()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_latest] if self.keep_latest > 0 else []:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for p in self.directory.glob("step_*"):
            if p.is_dir() and (p / _COMMIT).exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def is_jax(self, step: Optional[int] = None) -> bool:
        """Whether the checkpoint of ``step`` (default the latest) was
        written by the JAX package (``host_*.npz`` in place of
        ``state.pt``)."""
        return not (self._step_dir(step) / "state.pt").exists()

    def _step_dir(self, step: Optional[int]) -> Path:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoints in {self.directory}")
        return self.directory / f"step_{step}"

    def restore(self, step: Optional[int] = None) -> tuple[dict, dict]:
        """Load a committed checkpoint: (state, extra metadata). The state
        is the port's state dict of host tensors, or for a checkpoint the
        JAX package wrote, its flat {dotted path: host tensor} dict
        (``weights.state_dict_from_flat`` converts it). The port's file is
        memory-mapped (copy on write), so a reader that takes the params
        alone (serving, export, eval) never reads the optimizer's
        moments."""
        d = self._step_dir(step)
        index = json.loads((d / "index.json").read_text())
        if self.is_jax(step):
            return read_jax_checkpoint(d), index.get("extra", {})
        state = torch.load(d / "state.pt", map_location="cpu",
                           weights_only=True, mmap=True)
        return state, index.get("extra", {})
