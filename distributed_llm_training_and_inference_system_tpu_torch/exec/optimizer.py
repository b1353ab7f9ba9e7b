"""Optimizer factory (the JAX package's ``exec/optimizer.py``): AdamW,
Lion, Adafactor and SGD over fp32 master parameters.

Each optimizer's state holds the fields of the optax chain the JAX package
builds, per parameter, in ``model.named_parameters()`` order:

- ``adamw``/``adam``: ``scale_by_adam`` (mu in ``moment_dtype``, nu in
  ``nu_dtype``, count), decoupled decay, lr; the update itself is
  ``exec.fused_update``.
- ``lion``: ``scale_by_lion(b1, b2)`` (mu, count), decayed weights under
  the decay mask, lr.
- ``adafactor``: ``optax.adafactor(learning_rate=schedule)`` with optax's
  defaults: second moments factored over the two largest dims when the
  second largest is >= 128 (v_row, v_col; else a full v), decay
  ``1 - (t + 1)^-0.8``, eps 1e-30, updates clipped to block RMS 1.0,
  scaled by lr and by the parameter's block RMS (floor 1e-3); no
  momentum, no decay.
- ``sgd``: ``trace(decay=betas[0])`` (trace), lr; ``count`` is the
  schedule's own step count.

The JAX package keeps every block leaf stacked on a leading [L, ...] axis;
a port parameter is one layer of it. Where optax's arithmetic sees the
whole stacked leaf (adafactor's factored dims and its two block RMS), the
port takes the stacked leaf's shape and the layers' sums together; every
other step is elementwise or per layer. Weight decay is masked: no decay
on norm scales, biases or the embedding.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from .schedules import make_schedule

_NO_DECAY = ("embed", "norm", "bias")
KINDS = ("adamw", "adam", "lion", "adafactor", "sgd")


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


@dataclass
class LionState:
    """optax ``ScaleByLionState``: the momentum per parameter, count."""
    mu: list[torch.Tensor]
    count: torch.Tensor


@dataclass
class FactoredState:
    """optax ``FactoredState`` per parameter: row and column statistics
    of a factored leaf, the full statistic of another ((1,)-shaped
    placeholders where unused, as optax keeps them), count."""
    v_row: list[torch.Tensor]
    v_col: list[torch.Tensor]
    v: list[torch.Tensor]
    count: torch.Tensor


@dataclass
class TraceState:
    """optax ``TraceState`` per parameter, and the schedule's count."""
    trace: list[torch.Tensor]
    count: torch.Tensor


_STATES = {"adamw": AdamState, "adam": AdamState, "lion": LionState,
           "adafactor": FactoredState, "sgd": TraceState}

_LAYER = re.compile(r"^blocks\.\d+\.")


def _group(name: str) -> str:
    """The stacked JAX leaf a parameter is one layer of (its name without
    the layer index)."""
    return _LAYER.sub("blocks.", name)


def _group_sizes(names: list[str]) -> dict[str, int]:
    sizes: dict[str, int] = {}
    for n in names:
        sizes[_group(n)] = sizes.get(_group(n), 0) + 1
    return sizes


def factored_dims(shape: tuple, layers: int = 0,
                  min_dim: int = 128) -> Optional[tuple[int, int]]:
    """optax ``_factored_dims`` of the stacked leaf ([layers, *shape], or
    ``shape`` itself when ``layers`` is 0), as dims of ``shape``: (d1, d0),
    the second largest and the largest, or None when the second largest
    is below ``min_dim``."""
    full = (layers, *shape) if layers else tuple(shape)
    if len(full) < 2:
        return None
    order = np.argsort(full)
    if full[order[-2]] < min_dim:
        return None
    d1, d0 = int(order[-2]), int(order[-1])
    if layers:
        if 0 in (d1, d0):
            raise NotImplementedError(
                f"adafactor would factor the layer axis of [{layers}, "
                f"{', '.join(map(str, shape))}]")
        d1, d0 = d1 - 1, d0 - 1
    return d1, d0


def make_optimizer(cfg):
    """Returns (init, schedule): ``init(model)`` makes the zero state of
    ``cfg.type``, and ``schedule(step) -> lr``."""
    schedule = make_schedule(cfg.scheduler, cfg.lr)
    if cfg.type not in KINDS:
        raise ValueError(f"unknown optimizer {cfg.type!r}")

    def init(model: nn.Module):
        named = list(model.named_parameters())
        dev = named[0][1].device
        count = torch.zeros((), dtype=torch.int32, device=dev)

        def zeros(dtype=None):
            return [torch.zeros(p.shape, dtype=dtype or p.dtype,
                                device=p.device) for _, p in named]
        if cfg.type in ("adamw", "adam"):
            return AdamState(mu=zeros(getattr(torch, cfg.moment_dtype)),
                             nu=zeros(getattr(torch, cfg.nu_dtype)),
                             count=count)
        if cfg.type == "lion":
            return LionState(mu=zeros(), count=count)
        if cfg.type == "sgd":
            return TraceState(trace=zeros(), count=count)
        sizes = _group_sizes([n for n, _ in named])
        rows, cols, full = [], [], []
        for name, p in named:
            layers = sizes[_group(name)] if _LAYER.match(name) else 0
            dims = factored_dims(tuple(p.shape), layers)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                rows.append(one)
                cols.append(one.clone())
                full.append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            rows.append(torch.zeros(np.delete(p.shape, d0).tolist(),
                                    dtype=p.dtype, device=p.device))
            cols.append(torch.zeros(np.delete(p.shape, d1).tolist(),
                                    dtype=p.dtype, device=p.device))
            full.append(one.clone())
        return FactoredState(v_row=rows, v_col=cols, v=full, count=count)

    return init, schedule


def state_from_fields(kind: str, fields: dict, names: list[str], device):
    """An optimizer state of ``kind`` from {field: {name: tensor} or a
    count} (``weights.opt_state_from_jax``, a checkpoint), on
    ``device``."""
    values = {}
    for f in dataclasses.fields(_STATES[kind]):
        v = fields[f.name]
        values[f.name] = (v.to(device) if f.name == "count"
                          else [v[n].to(device) for n in names])
    return _STATES[kind](**values)


def _block_rms_sums(tensors: list[torch.Tensor], names: list[str]
                    ) -> list[torch.Tensor]:
    """For each tensor, the RMS of the stacked leaf it is one layer of:
    sqrt(sum of squares over the layers / elements), in fp32."""
    sums: dict[str, torch.Tensor] = {}
    counts: dict[str, int] = {}
    for t, n in zip(tensors, names):
        g = _group(n)
        s = (t.float() * t.float()).sum()
        sums[g] = s if g not in sums else sums[g] + s
        counts[g] = counts.get(g, 0) + t.numel()
    return [torch.sqrt(sums[_group(n)] / counts[_group(n)]) for n in names]


@torch.no_grad()
def apply_update(kind: str, cfg, params: list[torch.Tensor],
                 grads: list[torch.Tensor], state, names: list[str],
                 decay_mask: list[bool], lr: torch.Tensor) -> None:
    """One step of lion, adafactor or sgd, in place, from grads already
    scaled by the clip factor; ``lr`` is the schedule at the step count
    before this update (a 0-dim fp32 tensor on the parameters' device).
    The arithmetic is optax's, op for op, with fp32 parameters."""
    b1, b2 = cfg.betas
    neg_lr = -lr
    if kind == "lion":
        for p, g, m, decayed in zip(params, grads, state.mu, decay_mask,
                                    strict=True):
            u = torch.sign((1.0 - b1) * g + b1 * m)
            m.copy_((1.0 - b2) * g + b2 * m)
            if decayed and cfg.weight_decay:
                u = u + cfg.weight_decay * p
            p.add_(neg_lr.to(u.dtype) * u)
    elif kind == "sgd":
        for p, g, t in zip(params, grads, state.trace, strict=True):
            t.copy_(g + b1 * t)
            p.add_(neg_lr.to(t.dtype) * t)
    elif kind == "adafactor":
        _adafactor(params, grads, state, names, lr)
    else:
        raise ValueError(f"apply_update does not run {kind!r}")
    state.count += 1


def _adafactor(params, grads, state, names, lr, eps: float = 1e-30,
               clip: float = 1.0, min_scale: float = 1e-3) -> None:
    t = (state.count + 1).float()
    decay = 1.0 - t ** -0.8
    sizes = _group_sizes(names)
    updates = []
    for p, g, vr, vc, v, name in zip(params, grads, state.v_row,
                                     state.v_col, state.v, names,
                                     strict=True):
        layers = sizes[_group(name)] if _LAYER.match(name) else 0
        dims = factored_dims(tuple(p.shape), layers)
        g2 = g * g + eps
        if dims is None:
            v.copy_(decay * v + (1.0 - decay) * g2)
            updates.append(g * v ** -0.5)
            continue
        d1, d0 = dims
        vr.copy_(decay * vr + (1.0 - decay) * g2.mean(dim=d0))
        vc.copy_(decay * vc + (1.0 - decay) * g2.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = vr.mean(dim=reduced_d1, keepdim=True)
        row_factor = (vr / row_col_mean) ** -0.5
        col_factor = vc ** -0.5
        updates.append(g * row_factor.unsqueeze(d0)
                       * col_factor.unsqueeze(d1))
    # clip_by_block_rms, scale by lr, scale_by_param_block_rms, scale(-1)
    u_rms = _block_rms_sums(updates, names)
    p_rms = _block_rms_sums(params, names)
    for p, u, ur, pr in zip(params, updates, u_rms, p_rms):
        u = u / torch.clamp(ur / clip, min=1.0)
        u = lr.to(u.dtype) * u
        u = u * torch.where(pr <= min_scale,
                            torch.full_like(pr, min_scale), pr)
        p.add_(u * -1.0)
