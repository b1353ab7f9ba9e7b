"""Optimizer factory (the JAX package's ``exec/optimizer.py``).

AdamW/Adam with fp32 master parameters: the state is mu (in
``moment_dtype``), nu (in ``nu_dtype``) and a step count, per parameter;
the update itself is ``exec.fused_update``. Weight decay is masked: no
decay on norm scales, biases or the embedding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .schedules import make_schedule

_NO_DECAY = ("embed", "norm", "bias")


def _decay_mask(model: nn.Module) -> dict[str, bool]:
    """True where weight decay applies: matrices (ndim >= 2) other than the
    embedding (an untied ``lm_head`` decays). Keyed by parameter name."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = p.dim() >= 2 and not any(k in leaf for k in _NO_DECAY)
    return out


@dataclass
class AdamState:
    """Per-parameter first/second moments (ordered as
    ``model.named_parameters()``) and the step count (int32, on the
    parameters' device)."""
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: torch.Tensor


def make_optimizer(cfg):
    """Returns (init, schedule): ``init(model) -> AdamState`` with zero
    moments, and ``schedule(step) -> lr``."""
    schedule = make_schedule(cfg.scheduler, cfg.lr)
    if cfg.type not in ("adamw", "adam"):
        raise NotImplementedError(
            f"optimizer {cfg.type!r} is not ported yet: the port trains "
            f"with adamw/adam (ROADMAP queue 1 item 4: adafactor, lion, "
            f"sgd)")
    mu_dtype = getattr(torch, cfg.moment_dtype)
    nu_dtype = getattr(torch, cfg.nu_dtype)

    def init(model: nn.Module) -> AdamState:
        ps = [p for _, p in model.named_parameters()]
        return AdamState(
            mu=[torch.zeros(p.shape, dtype=mu_dtype, device=p.device)
                for p in ps],
            nu=[torch.zeros(p.shape, dtype=nu_dtype, device=p.device)
                for p in ps],
            count=torch.zeros((), dtype=torch.int32,
                              device=ps[0].device))

    return init, schedule
