"""TrainingEngine: config -> model and optimizer state -> data -> step loop
-> metrics, eval and checkpoints, on one device or on one rank of a mesh.

The port's counterpart of the JAX package's ``runtime/engine.py``
``TrainingEngine``: the same loop, logging, eval, save and run manifest.
``attn_impl="auto"`` resolves to the flash kernels on a card and to the
plain attention on the CPU; with sequence_parallel > 1 to ring or Ulysses
by ``parallel.planner.choose_sp_scheme``, as JAX's engine.

A parallel config (any degree > 1) runs one engine per rank, as
``runtime/launcher.py`` ``LocalLauncher`` spawns them: the engine joins
the process group the launcher described (``parallel.mesh.
init_distributed``; NCCL when each rank has its own card, else gloo: the
backend is logged), fills in data_parallel from the world size as JAX's
engine does from its device count, and trains through
``parallel.api.ShardedTrainer``. The dataset stripes the global batch by
the data rank (dp x fsdp): the tp, sp, pp and ep ranks of one data index
read the same rows (a pipeline cuts them into its microbatches). A checkpoint is the single-device format: every rank gathers
the state, rank 0 writes it; a restore slices each rank's shards (from the
port's checkpoints or the JAX package's). Only rank 0 logs, observes and
writes the manifest. MFU is taken against
``HardwareConfig.peak_bf16_tflops`` (an H100's 989 by default).
``data.num_workers`` and ``data.prefetch_factor`` size the training
dataset's download pool and prefetch depth, as in the JAX engine.
``training.profile`` records the step loop with ``torch.profiler`` (CPU
and, on a card, CUDA activity) and writes a Chrome trace into
``training.profile_dir``: the counterpart of the JAX engine's
``jax.profiler`` trace.

The engine holds one trainer and does not ask which: ``SingleDeviceTrainer``
(below) on one device, ``parallel.api.ShardedTrainer`` on a rank of a
mesh. Both give ``state``, ``train_step``, ``init_state``, ``step``,
``evaluate``, ``full_state_dict``/``load_full_state_dict`` (the
single-device checkpoint format), ``rank``, ``world``, ``shape`` and the
data rank (``data_index``/``data_size``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, to_device
from ..exec.train_step import TrainState, make_eval_step, make_train_step
from ..io.checkpoint import CheckpointManager, load_state_dict_into, \
    state_to_dict
from ..io.data import make_dataset
from ..models import gpt
from ..models.gpt import flops_per_token
from ..parallel.api import ShardedTrainer
from ..parallel.mesh import infer_data_parallel, init_distributed
from ..parallel.planner import choose_sp_scheme
from ..weights import state_dict_from_flat

logger = logging.getLogger("llmctl.engine")


class SingleDeviceTrainer:
    """The train state of one device and its step, behind the interface
    of ``parallel.api.ShardedTrainer``."""

    rank, world, shape = 0, 1, None
    data_index, data_size = 0, 1

    def __init__(self, model_cfg, opt_cfg, par_cfg, device,
                 attn_impl: str = "xla"):
        self.model_cfg, self.device = model_cfg, device
        self.train_step, self._opt_init, _ = make_train_step(
            model_cfg, opt_cfg, par_cfg, attn_impl=attn_impl)
        self.eval_step = make_eval_step(model_cfg, attn_impl=attn_impl)
        self.state: Optional[TrainState] = None

    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = gpt.init(self.model_cfg, gen, device=self.device)
        self.state = TrainState.create(model, self._opt_init)
        return self.state

    def step(self, batch: dict) -> dict:
        self.state, metrics = self.train_step(self.state, batch)
        return metrics

    def evaluate(self, batch: dict) -> dict:
        return self.eval_step(self.state.model, batch)

    def full_state_dict(self) -> dict:
        return state_to_dict(self.state)

    def load_full_state_dict(self, d: dict) -> None:
        load_state_dict_into(self.state, d)


class TrainingEngine:
    def __init__(self, cfg, device=None,
                 observer: Optional[Callable[[str, dict], None]] = None):
        """``observer(event, payload)`` receives 'train_step', 'eval' and
        'save' events."""
        self.cfg = cfg
        self.device = resolve_device(device)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        sharded = world > 1 or cfg.parallel.total_devices > 1
        self.backend = None
        cfg.parallel.require_supported(cfg.model)
        if sharded:
            if world == 1:
                raise ValueError(
                    f"the parallel config needs {cfg.parallel.total_devices} "
                    f"ranks: launch it with `llmctl-torch train launch` "
                    f"(runtime/launcher.py LocalLauncher)")
            self.backend = init_distributed(self.device)
            self.par = infer_data_parallel(cfg.parallel, world)
        else:
            self.par = cfg.parallel
        attn_impl = cfg.training.attn_impl
        if attn_impl == "auto":
            if self.par.sequence_parallel > 1:
                # ring vs ulysses by the planner's priced selection rule
                attn_impl, _ = choose_sp_scheme(
                    cfg.model, self.par.sequence_parallel,
                    cfg.data.max_length, self.par.micro_batch_size,
                    hw=cfg.hardware)
            else:
                attn_impl = "flash" if self.device.type == "cuda" else "xla"
        self.attn_impl = attn_impl
        trainer = ShardedTrainer if sharded else SingleDeviceTrainer
        self.trainer = trainer(cfg.model, cfg.optimizer, self.par,
                               self.device, attn_impl=attn_impl)
        self.rank = self.trainer.rank
        if sharded and self.rank == 0:
            logger.info("rank %d: %s; attn_impl %s", self.rank,
                        self.trainer.describe(), attn_impl)
        self.observer = observer or (lambda event, payload: None)
        if self.rank != 0:
            self.observer = lambda event, payload: None
        self._start_step = 0
        self.profile_trace: Optional[Path] = None

        # the data rank's stripe of the global batch
        host_id, num_hosts = self.trainer.data_index, self.trainer.data_size
        batch = self.par.global_batch_size // num_hosts
        self.train_data = make_dataset(
            cfg.data.train, batch, cfg.data.max_length, cfg.model.vocab_size,
            seed=cfg.data.seed, host_id=host_id, num_hosts=num_hosts,
            pack=cfg.data.pack_sequences,
            num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch_factor)
        self.val_data = make_dataset(
            cfg.data.val, batch, cfg.data.max_length, cfg.model.vocab_size,
            seed=cfg.data.seed + 1, host_id=host_id, num_hosts=num_hosts,
            pack=cfg.data.pack_sequences)
        self.ckpt = CheckpointManager(
            cfg.checkpoint.path, keep_latest=cfg.checkpoint.keep_latest,
            async_save=cfg.checkpoint.async_save)
        self._flops_per_token = flops_per_token(cfg.model,
                                                cfg.data.max_length)

    # -- the trainer's state and step ------------------------------------------

    @property
    def state(self):
        return self.trainer.state

    @state.setter
    def state(self, value) -> None:
        self.trainer.state = value

    @property
    def train_step(self):
        """``train_step(state, batch) -> (state, metrics)``."""
        return self.trainer.train_step

    # -- lifecycle -----------------------------------------------------------

    def init_state(self, seed: int = 0):
        """Fresh fp32 master parameters (random, from ``seed``) and zero
        optimizer state (this rank's shards of them on a mesh)."""
        return self.trainer.init_state(seed)

    def initialize(self, resume: bool = True) -> int:
        """Init or restore state; returns the starting step."""
        t0 = time.perf_counter()
        self.init_state(seed=self.cfg.training.seed)
        if self.rank == 0:
            logger.info("state initialised in %.1f s",
                        time.perf_counter() - t0)
        self._start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            jax_written = self.ckpt.is_jax()
            saved, extra = self.ckpt.restore()
            if jax_written:      # the JAX package's flat checkpoint
                names = [n for n, _ in gpt.GPT(
                    self.cfg.model, device="meta").named_parameters()]
                saved = state_dict_from_flat(saved, names,
                                             self.cfg.optimizer.type)
            self.trainer.load_full_state_dict(saved)   # a rank slices
            if "train_data" in extra:
                self.train_data.load_state_dict(extra["train_data"])
            start = int(extra.get("step", self.state.step))
            logger.info("resumed from checkpoint step %d (params + "
                        "optimizer + data cursor)", start)
            self._start_step = start
        return self._start_step

    def close(self) -> None:
        """Flush a checkpoint still being written and release the
        datasets' threads (the prefetch worker, a remote dataset's
        download pool and its temporary cache). Idempotent; the engine is
        not reusable after it."""
        try:
            self.ckpt.wait()
        finally:
            for ds in (self.train_data, self.val_data):
                if hasattr(ds, "close"):
                    ds.close()
            if self.backend is not None and dist.is_initialized():
                dist.destroy_process_group()

    def save(self, step: int) -> None:
        # on a mesh every rank gathers (a collective); rank 0 writes
        state = self.trainer.full_state_dict()
        if self.rank != 0:
            return
        self.ckpt.save(step, state, extra={
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

        prof = self._start_profile() if t_cfg.profile else None
        for step in range(start, max_steps):
            batch = self._device_batch(next(self.train_data))
            metrics = self.trainer.step(batch)
            window_tokens += metrics["tokens"]

            if (step + 1) % t_cfg.log_interval == 0 or step + 1 == max_steps:
                # read the device only at log boundaries: the queue stays
                # full between them
                loss = float(metrics["loss"])
                dt = time.perf_counter() - window_t0
                tokens_per_sec = window_tokens / dt
                world = self.trainer.world
                # MFU is a card's figure: none for a CPU run
                mfu = (tokens_per_sec / world * self._flops_per_token
                       / (self.cfg.hardware.peak_bf16_tflops * 1e12)
                       if self.device.type == "cuda" else None)
                last_metrics = {
                    "step": step + 1, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "tokens_per_sec": tokens_per_sec,
                    "tokens_per_sec_per_chip": tokens_per_sec / world,
                    "mfu": mfu,
                }
                self.observer("train_step", last_metrics)
                log = logger.info if self.rank == 0 else logger.debug
                log(
                    "step %d | loss %.4f | grad %.3f | lr %.2e | %.0f tok/s "
                    "| mfu %s", step + 1, loss, last_metrics["grad_norm"],
                    last_metrics["lr"], tokens_per_sec,
                    "n/a (cpu)" if mfu is None else f"{100 * mfu:.1f}%")
                window_t0, window_tokens = time.perf_counter(), 0.0

            if (step + 1) % t_cfg.eval_interval == 0 and step + 1 < max_steps:
                ev = self.evaluate()
                self.observer("eval", ev)
                (logger.info if self.rank == 0 else logger.debug)("eval @ %d | loss %.4f | ppl %.2f", step + 1,
                            ev["loss"], ev["perplexity"])
                window_t0, window_tokens = time.perf_counter(), 0.0

            if (step + 1) % self.cfg.checkpoint.interval_steps == 0:
                self.save(step + 1)
                last_saved = step + 1

        if prof is not None:
            self._stop_profile(prof)
        if last_saved != max_steps:
            self.save(max_steps)
        self.ckpt.wait()
        if self.rank == 0:
            self._write_manifest(start, max_steps, last_metrics)
        return last_metrics

    def _start_profile(self):
        """A started torch.profiler session over CPU and, on a card, CUDA
        activity."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> Path:
        """Stop the session and write its Chrome trace (open it in
        Perfetto or chrome://tracing) into ``training.profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.cfg.training.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / (f"{self.cfg.model.name}-{os.getpid()}-"
                      f"{time.strftime('%Y%m%d-%H%M%S')}.trace.json")
        prof.export_chrome_trace(str(path))
        self.profile_trace = path
        logger.info("profiler trace written to %s", path)
        return path

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
            "num_devices": self.trainer.world,
            "parallel": self.trainer.shape,
            "backend": self.backend,
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
            batch = self._device_batch(next(self.val_data))
            out = self.trainer.evaluate(batch)
            losses.append(float(out["loss"]))
            counts.append(float(out["tokens"]))
        total = float(np.sum(counts))
        loss = float(np.sum([l * c for l, c in zip(losses, counts)])) \
            / max(total, 1)
        return {"loss": loss, "perplexity": float(np.exp(min(loss, 30.0))),
                "tokens": total}
