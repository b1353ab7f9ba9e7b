"""Atomic checkpoints of the full train state on one process.

Counterpart of the JAX package's ``io/checkpoint.py`` for a single card:

- **complete**: model parameters, optimizer state (mu, nu, count), step,
  the data cursor and user metadata round-trip exactly;
- **atomic**: data lands in ``step_N.tmp/`` and is renamed and
  COMMIT-marked; restore ignores uncommitted directories;
- **async**: tensors are copied to host memory at ``save`` (so training
  may go on updating them), the file is written on a background thread;
  ``wait()`` flushes;
- **GC**: ``keep_latest`` is enforced after every commit.

The on-disk layout is the port's own (``state.pt``, a ``torch.save`` of
host tensors, beside ``index.json``); it does not read the JAX package's
sharded ``.npz`` checkpoints yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

_COMMIT = "COMMIT"


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
    """A ``TrainState`` as plain tensors: params by name, moments in
    parameter order, count and step."""
    opt = state.opt_state
    return {"step": int(state.step),
            "params": dict(state.model.state_dict()),
            "mu": list(opt.mu), "nu": list(opt.nu), "count": opt.count}


@torch.no_grad()
def load_state_dict_into(state, d: dict) -> None:
    """Copy a ``state_to_dict`` result into ``state`` in place (on its
    devices, in its dtypes)."""
    state.model.load_state_dict(d["params"])
    opt = state.opt_state
    for dst, src in zip(opt.mu + opt.nu, d["mu"] + d["nu"], strict=True):
        dst.copy_(src)
    opt.count.copy_(d["count"])
    state.step = int(d["step"])


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
                torch.save(host, tmp / "state.pt")
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

    def restore(self, step: Optional[int] = None) -> tuple[dict, dict]:
        """Load a committed checkpoint: (state dict of host tensors,
        extra metadata)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoints in {self.directory}")
        d = self.directory / f"step_{step}"
        index = json.loads((d / "index.json").read_text())
        state = torch.load(d / "state.pt", map_location="cpu",
                           weights_only=True)
        return state, index.get("extra", {})
