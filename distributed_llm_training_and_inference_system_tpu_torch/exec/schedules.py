"""Learning-rate schedules (the JAX package's ``exec/schedules.py``):
cosine, linear or constant after a linear warmup, as a function of the
step computed in fp32 on the step's device."""

from __future__ import annotations

import math

import torch


def make_schedule(cfg, base_lr: float):
    """Return ``schedule(step) -> lr``: ``step`` an int or an integer
    tensor; the result is a 0-dim fp32 tensor on the step's device."""
    warmup = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps, warmup + 1)
    floor = base_lr * cfg.min_lr_ratio

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / warmup, max=1.0)
        frac = torch.clamp((step - warmup) / (total - warmup), 0.0, 1.0)
        if cfg.type == "cosine":
            decay = floor + (base_lr - floor) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        elif cfg.type == "linear":
            decay = floor + (base_lr - floor) * (1.0 - frac)
        else:  # constant (after warmup)
            decay = torch.full_like(step, base_lr)
        return torch.where(step < warmup, warm, decay)

    return schedule
