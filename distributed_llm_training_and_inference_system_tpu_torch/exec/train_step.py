"""The training step: loss -> grad -> clip -> update, with gradient
accumulation (the JAX package's ``exec/train_step.py``).

One step runs eagerly on the parameters' device: the micro-batches'
gradients are summed in an ``accum_dtype`` carry and averaged in fp32, the
pre-clip global norm gives ``clip_scale = min(1, clip / (gnorm + 1e-9))``,
and the optimizer updates parameters and its state in place: AdamW through
the fused kernel (``OptimizerConfig.fused``) or the plain per-leaf update,
Lion, Adafactor and SGD (``exec.optimizer.apply_update``) from the
gradients scaled by ``clip_scale``, as the JAX step feeds optax. Nothing in
the step waits for the host; the metrics are device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config.schema import ParallelConfig
from ..models.gpt import GPT, forward
from ..models.loss import chunked_next_token_loss, next_token_loss
from ..utils.tree import global_norm
from .fused_update import fused_adamw_apply
from .optimizer import _decay_mask, apply_update, make_optimizer


@dataclass
class TrainState:
    """Carried training state: the model (fp32 master parameters), the
    optimizer state and the step (a host int; the optimizer's count is
    its device twin)."""
    step: int
    model: GPT
    opt_state: object      # exec.optimizer's state of the configured type

    @classmethod
    def create(cls, model: GPT, init: Callable) -> "TrainState":
        return cls(step=0, model=model, opt_state=init(model))


def _loss_fn(model, batch, model_cfg, attn_impl: str, remat: str,
             loss_chunk: int = 512):
    """Training objective and what is reported: (loss + the MoE aux loss
    summed over layers, (loss, token count)), as the JAX ``_loss_fn``; a
    dense model's aux is 0. With ``loss_chunk > 0`` the LM head and
    cross-entropy run chunked over the sequence, so the [B, S, V] fp32
    logits never exist whole."""
    out = forward(model, batch["tokens"], model_cfg,
                  positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"),
                  attn_impl=attn_impl, remat=remat,
                  return_aux=model_cfg.is_moe,
                  return_hidden=loss_chunk > 0)
    head_in, aux = out if model_cfg.is_moe else (out, None)
    if loss_chunk > 0:
        tied = model_cfg.tie_word_embeddings
        w = model.embed if tied else model.lm_head
        loss, count = chunked_next_token_loss(
            head_in, w, batch["tokens"], batch.get("segment_ids"),
            chunk=loss_chunk, tied=tied)
    else:
        loss, count = next_token_loss(head_in, batch["tokens"],
                                      batch.get("segment_ids"))
    total = loss if aux is None else loss + aux
    return total, (loss, count)


def make_train_step(model_cfg, opt_cfg, par_cfg=None, attn_impl: str = "xla",
                    loss_chunk: int = 512):
    """Build (train_step, init, schedule).

    ``train_step(state, batch) -> (state, metrics)`` updates ``state`` in
    place. ``batch["tokens"]`` is [accum * mb, S]; with
    ``gradient_accumulation_steps > 1`` the leading dim is split into
    micro-batches whose gradients are averaged. ``init(model)`` makes the
    optimizer state; ``schedule(step)`` is the learning rate."""
    par_cfg = par_cfg or ParallelConfig()
    par_cfg.require_single_device()
    init, schedule = make_optimizer(opt_cfg)
    accum = max(par_cfg.gradient_accumulation_steps, 1)
    remat = par_cfg.activation_checkpoint
    acc_dtype = getattr(torch, opt_cfg.accum_dtype)
    wd = opt_cfg.weight_decay if opt_cfg.type == "adamw" else 0.0

    def grads_of(model, params, batch):
        total, (loss, count) = _loss_fn(model, batch, model_cfg, attn_impl,
                                        remat, loss_chunk)
        grads = torch.autograd.grad(total, params)
        return loss.detach(), count.detach(), grads

    def train_step(state: TrainState, batch: dict):
        model = state.model
        names, params = zip(*model.named_parameters())
        if accum == 1:
            loss, count, grads = grads_of(model, params, batch)
        else:
            n = batch["tokens"].shape[0]
            if n % accum:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{accum} micro-batches")
            mb = n // accum
            acc, loss_sum = None, 0.0
            count_sum = 0.0
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, count, grads = grads_of(model, params, part)
                grads = [g.to(acc_dtype) for g in grads]
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                loss_sum = loss_sum + loss * count
                count_sum = count_sum + count
            # the mean in fp32: clip and update compute in fp32 whatever
            # the carry's dtype
            grads = [a.float() / accum for a in acc]
            loss = loss_sum / torch.clamp(count_sum, min=1.0)

        gnorm = global_norm(grads)
        if opt_cfg.grad_clip > 0:
            clip_scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9),
                                     max=1.0)
        else:
            clip_scale = torch.ones((), device=gnorm.device)
        opt = state.opt_state
        mask = _decay_mask(model)
        if opt_cfg.type in ("adamw", "adam"):
            fused_adamw_apply(
                [p.data for p in params], grads, opt.mu, opt.nu, opt.count,
                lr=schedule(opt.count), b1=opt_cfg.betas[0],
                b2=opt_cfg.betas[1], eps=opt_cfg.eps, weight_decay=wd,
                decay_mask=[mask[n] for n in names], clip_scale=clip_scale,
                use_kernel=opt_cfg.fused)
            opt.count += 1
        else:
            apply_update(opt_cfg.type, opt_cfg, [p.data for p in params],
                         [g.float() * clip_scale for g in grads], opt,
                         list(names), [mask[n] for n in names],
                         schedule(opt.count))
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": schedule(state.step),
            "tokens": float(batch["tokens"].numel()),
        }
        state.step += 1
        return state, metrics

    return train_step, init, schedule


def make_eval_step(model_cfg, attn_impl: str = "xla") -> Callable:
    """eval_step(model, batch) -> {loss, tokens}."""
    @torch.no_grad()
    def eval_step(model, batch):
        logits = forward(model, batch["tokens"], model_cfg,
                         positions=batch.get("positions"),
                         segment_ids=batch.get("segment_ids"),
                         attn_impl=attn_impl)
        loss, count = next_token_loss(logits, batch["tokens"],
                                      batch.get("segment_ids"))
        return {"loss": loss, "tokens": count}
    return eval_step
