"""TrainingEngine: config -> model and optimizer state -> data -> step loop
-> metrics, eval and checkpoints, on one device.

The port's counterpart of the JAX package's ``runtime/engine.py``
``TrainingEngine`` together with the single-device role of
``parallel/api.py`` ``ShardedTrainer``: the same loop, logging, eval, save
and run manifest. ``attn_impl="auto"`` resolves to the flash kernels on a
card and to the plain attention on the CPU. MFU is taken against
``HardwareConfig.peak_bf16_tflops`` (an H100's 989 by default).
Multi-device training waits for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..exec.train_step import TrainState, make_eval_step, make_train_step
from ..io.checkpoint import CheckpointManager, load_state_dict_into, \
    state_to_dict
from ..io.data import make_dataset
from ..models import gpt
from ..models.gpt import flops_per_token

logger = logging.getLogger("llmctl.engine")


class TrainingEngine:
    def __init__(self, cfg, device=None,
                 observer: Optional[Callable[[str, dict], None]] = None):
        """``observer(event, payload)`` receives 'train_step', 'eval' and
        'save' events."""
        self.cfg = cfg
        cfg.parallel.require_single_device()
        self.device = resolve_device(device)
        self.par = cfg.parallel
        attn_impl = cfg.training.attn_impl
        if attn_impl == "auto":
            attn_impl = "flash" if self.device.type == "cuda" else "xla"
        self.attn_impl = attn_impl
        self.train_step, self._opt_init, self.schedule = make_train_step(
            cfg.model, cfg.optimizer, self.par, attn_impl=attn_impl)
        self.eval_step = make_eval_step(cfg.model, attn_impl=attn_impl)
        self.observer = observer or (lambda event, payload: None)
        self.state: Optional[TrainState] = None
        self._start_step = 0

        batch = self.par.global_batch_size
        self.train_data = make_dataset(
            cfg.data.train, batch, cfg.data.max_length, cfg.model.vocab_size,
            seed=cfg.data.seed, pack=cfg.data.pack_sequences)
        self.val_data = make_dataset(
            cfg.data.val, batch, cfg.data.max_length, cfg.model.vocab_size,
            seed=cfg.data.seed + 1, pack=cfg.data.pack_sequences)
        self.ckpt = CheckpointManager(
            cfg.checkpoint.path, keep_latest=cfg.checkpoint.keep_latest,
            async_save=cfg.checkpoint.async_save)
        self._flops_per_token = flops_per_token(cfg.model,
                                                cfg.data.max_length)

    # -- lifecycle -----------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh fp32 master parameters (random, from ``seed``) and zero
        optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = gpt.init(self.cfg.model, gen, device=self.device)
        self.state = TrainState.create(model, self._opt_init)
        return self.state

    def initialize(self, resume: bool = True) -> int:
        """Init or restore state; returns the starting step."""
        self.init_state(seed=self.cfg.training.seed)
        self._start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            saved, extra = self.ckpt.restore()
            load_state_dict_into(self.state, saved)
            if "train_data" in extra:
                self.train_data.load_state_dict(extra["train_data"])
            start = int(extra.get("step", self.state.step))
            logger.info("resumed from checkpoint step %d (params + "
                        "optimizer + data cursor)", start)
            self._start_step = start
        return self._start_step

    def close(self) -> None:
        """Flush a checkpoint still being written."""
        self.ckpt.wait()

    def save(self, step: int) -> None:
        self.ckpt.save(step, state_to_dict(self.state), extra={
            "step": step,
            "train_data": self.train_data.state_dict(),
            "config": {"model": self.cfg.model.name},
        })
        self.observer("save", {"step": step})

    def _device_batch(self, batch: dict) -> dict:
        out = {k: to_device(v, self.device) for k, v in batch.items()}
        out["tokens"] = out["tokens"].long()
        return out

    # -- loops ----------------------------------------------------------------

    def train(self, max_steps: Optional[int] = None,
              resume: bool = True) -> dict:
        t_cfg = self.cfg.training
        max_steps = max_steps or t_cfg.max_steps
        if self.state is None:
            start = self.initialize(resume=resume)
        else:
            start = self._start_step
        window_t0, window_tokens = time.perf_counter(), 0.0
        last_metrics: dict = {}
        last_saved: Optional[int] = None

        for step in range(start, max_steps):
            batch = self._device_batch(next(self.train_data))
            self.state, metrics = self.train_step(self.state, batch)
            window_tokens += metrics["tokens"]

            if (step + 1) % t_cfg.log_interval == 0 or step + 1 == max_steps:
                # read the device only at log boundaries: the queue stays
                # full between them
                loss = float(metrics["loss"])
                dt = time.perf_counter() - window_t0
                tokens_per_sec = window_tokens / dt
                # MFU is a card's figure: none for a CPU run
                mfu = (tokens_per_sec * self._flops_per_token
                       / (self.cfg.hardware.peak_bf16_tflops * 1e12)
                       if self.device.type == "cuda" else None)
                last_metrics = {
                    "step": step + 1, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "tokens_per_sec": tokens_per_sec,
                    "tokens_per_sec_per_chip": tokens_per_sec,
                    "mfu": mfu,
                }
                self.observer("train_step", last_metrics)
                logger.info(
                    "step %d | loss %.4f | grad %.3f | lr %.2e | %.0f tok/s "
                    "| mfu %s", step + 1, loss, last_metrics["grad_norm"],
                    last_metrics["lr"], tokens_per_sec,
                    "n/a (cpu)" if mfu is None else f"{100 * mfu:.1f}%")
                window_t0, window_tokens = time.perf_counter(), 0.0

            if (step + 1) % t_cfg.eval_interval == 0 and step + 1 < max_steps:
                ev = self.evaluate()
                self.observer("eval", ev)
                logger.info("eval @ %d | loss %.4f | ppl %.2f", step + 1,
                            ev["loss"], ev["perplexity"])
                window_t0, window_tokens = time.perf_counter(), 0.0

            if (step + 1) % self.cfg.checkpoint.interval_steps == 0:
                self.save(step + 1)
                last_saved = step + 1

        if last_saved != max_steps:
            self.save(max_steps)
        self.ckpt.wait()
        self._write_manifest(start, max_steps, last_metrics)
        return last_metrics

    def _write_manifest(self, start_step: int, end_step: int,
                        final_metrics: dict) -> None:
        """Everything needed to re-run this training deterministically."""
        manifest = {
            "run_id": f"{self.cfg.model.name}-s{self.cfg.training.seed}"
                      f"-{start_step}to{end_step}",
            "config": self.cfg.to_dict(),
            "seed": self.cfg.training.seed,
            "data_seed": self.cfg.data.seed,
            "start_step": start_step,
            "end_step": end_step,
            "num_hosts": 1,
            "num_devices": 1,
            "device": str(self.device),
            "final_metrics": {k: v for k, v in final_metrics.items()
                              if isinstance(v, (int, float))},
        }
        path = Path(self.cfg.checkpoint.path) / "run_manifest.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(manifest, indent=2))

    def evaluate(self, num_batches: Optional[int] = None) -> dict:
        num_batches = num_batches or self.cfg.training.eval_steps
        losses, counts = [], []
        for _ in range(num_batches):
            out = self.eval_step(self.state.model,
                                 self._device_batch(next(self.val_data)))
            losses.append(float(out["loss"]))
            counts.append(float(out["tokens"]))
        total = float(np.sum(counts))
        loss = float(np.sum([l * c for l, c in zip(losses, counts)])) \
            / max(total, 1)
        return {"loss": loss, "perplexity": float(np.exp(min(loss, 30.0))),
                "tokens": total}
