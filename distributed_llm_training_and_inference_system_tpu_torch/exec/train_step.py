"""The training step: loss -> grad -> clip -> update, with gradient
accumulation (the JAX package's ``exec/train_step.py``), on one card or
on one rank of a mesh (``make_sharded_train_step``).

One step runs eagerly on the parameters' device: the micro-batches'
gradients are summed in an ``accum_dtype`` carry and averaged in fp32, the
pre-clip global norm gives ``clip_scale = min(1, clip / (gnorm + 1e-9))``,
and the optimizer updates parameters and its state in place: AdamW through
the fused kernel (``OptimizerConfig.fused``) or the plain per-leaf update,
Lion, Adafactor and SGD (``exec.optimizer.apply_update``) from the
gradients scaled by ``clip_scale``, as the JAX step feeds optax. Nothing in
the step waits for the host; the metrics are device tensors.

The sharded step is the same step on one rank's shards
(``parallel/api.py`` ``ShardedTrainer`` builds it): the forward of
``models/gpt.forward_sharded``, the loss as the global token-weighted mean
(each rank's sum over the global count; for MoE plus the aux), every
gradient summed over the data, sequence and pipeline axes its leaf is not
cut over, the clip norm summing each distinct shard's squares once, and
the AdamW update (the fused kernel on this rank's shard) on the ZeRO
slice each rank owns, gathered back. A pipeline (``parallel/pipeline.py``)
gives the step its own gradient function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

import torch

from ..config.schema import ParallelConfig
from ..models.gpt import GPT, forward
from ..models.loss import (chunked_next_token_loss, chunked_target_loss,
                           next_token_loss, shifted_targets)
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


# ---------------------------------------------------------------------------
# The sharded step (one rank of a mesh)
# ---------------------------------------------------------------------------

# the axes a rank's rows and sequence chunk are cut over: a gradient is
# summed over those of them its leaf is not cut over
DATA_AXES = ("dp", "fsdp", "sp")


@dataclass
class ShardedTrainState:
    """One rank's shard of the train state, by JAX path (block leaves
    stacked [L, ...]): fp32 master params, AdamW's moments (cut by their
    ZeRO specs), the count and the step."""
    step: int
    params: dict
    mu: dict
    nu: dict
    count: torch.Tensor


def _local_inputs(batch: dict, mesh):
    """This rank's sequence chunk of its rows: (tokens, positions,
    segment ids, targets, weights), all [B_local, S / sp]."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    sp, c = mesh.axis_size("sp"), mesh.axis_index("sp")
    if S % sp:
        raise ValueError(f"sequence {S} does not split over sp={sp}")
    n = S // sp
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    segs = batch.get("segment_ids")
    targets, weights = shifted_targets(tokens, segs)

    def part(t):
        return None if t is None else t[:, c * n:(c + 1) * n]
    return (part(tokens), part(positions), part(segs), part(targets),
            part(weights))


def stage_params(state, layout) -> tuple[dict, dict]:
    """(stacked, top) of ``forward_sharded`` from this rank's shards."""
    stacked, top = {}, {}
    for path, t in state.params.items():
        spec = layout.p_specs[path]
        if layout.stacked(path):
            stacked[layout.names[path]] = (t, spec[1:])
        else:
            top[layout.names[path]] = (t, spec)
    return stacked, top


def _forward_loss(state, layout, batch, model_cfg, mesh, attn_impl, remat):
    """(this rank's sum of token losses, its token count, the MoE aux
    loss summed over the layers or None): the LM head and cross-entropy
    chunked over the sequence, as the single-card step."""
    from ..models.gpt import forward_sharded
    tokens, positions, segs, targets, weights = _local_inputs(batch, mesh)
    stacked, top = stage_params(state, layout)
    hidden, head, aux = forward_sharded(
        stacked, top, tokens, model_cfg, mesh, positions=positions,
        segment_ids=segs, attn_impl=attn_impl, remat=remat)
    total, count = chunked_target_loss(hidden, head, targets, weights,
                                       tied=model_cfg.tie_word_embeddings)
    return total, count, aux


def grad_sum_axes(layout, mesh) -> dict:
    """{axes: paths}: each leaf's gradient is summed over the data and
    sequence axes and the pipeline axis that it is not cut over (a
    replicated top leaf's over pp: the embedding's from the first stage
    and, tied, the last; the final norm's and head's from the last)."""
    from ..parallel.sharding import spec_axes
    buckets: dict = {}
    for path in layout.paths:
        axes = tuple(a for a in ("pp",) + DATA_AXES
                     if a not in spec_axes(layout.p_specs[path])
                     and mesh.shape[a] > 1)
        if axes:
            buckets.setdefault(axes, []).append(path)
    return buckets


def _sum_grads_over_data(grads: dict, layout, mesh) -> None:
    """Sum each gradient over ``grad_sum_axes``, one all-reduce of a flat
    buffer per axis set."""
    from ..comms.collectives import allreduce_sum
    for axes, paths in grad_sum_axes(layout, mesh).items():
        flat = torch.cat([grads[p].reshape(-1) for p in paths])
        flat = allreduce_sum(flat, axes, mesh)
        for p, part in zip(paths, flat.split([grads[p].numel()
                                              for p in paths])):
            grads[p] = part.view_as(grads[p])


def _global_grad_norm(grads: dict, layout, mesh) -> torch.Tensor:
    """The norm of the whole gradient: each rank's squares of a leaf
    divided by the number of ranks holding the same shard, summed over
    every rank, so each distinct shard counts once."""
    from ..comms.collectives import allreduce_sum
    from ..parallel.mesh import AXES
    from ..parallel.sharding import spec_axes
    total = None
    for path in layout.paths:
        cut = int(np.prod([mesh.shape[a]
                           for a in spec_axes(layout.p_specs[path])]))
        sq = grads[path].float().square().sum() / (mesh.world // cut)
        total = sq if total is None else total + sq
    return torch.sqrt(allreduce_sum(total, AXES, mesh))


@torch.no_grad()
def _zero_update(state, grads, layout, mesh, opt_cfg, schedule,
                 clip_scale) -> None:
    """AdamW on each rank's ZeRO slice of its param shards (the whole shard
    where the moments cut like the param), then the slices all-gathered
    back. The fused kernel takes the leaves whose GLOBAL leaf it would."""
    from ..comms.collectives import all_gather
    from ..parallel.zero import zero_slice
    works, subs = [], []
    for path in layout.paths:
        p, g = state.params[path], grads[path]
        zs = zero_slice(layout.p_specs[path], layout.o_specs[path])
        if zs is not None:
            dim, axes = zs
            n = mesh.axis_size(axes)
            size = p.shape[dim] // n
            start = mesh.axis_index(axes) * size
            p_sub, g = p.narrow(dim, start, size), g.narrow(dim, start, size)
        else:
            p_sub = p
        work = p_sub if p_sub.is_contiguous() else p_sub.contiguous()
        works.append(work)
        subs.append((path, p_sub, zs))
        grads[path] = g.contiguous()
    paths = layout.paths
    fused_adamw_apply(
        works, [grads[p] for p in paths], [state.mu[p] for p in paths],
        [state.nu[p] for p in paths], state.count,
        lr=schedule(state.count), b1=opt_cfg.betas[0], b2=opt_cfg.betas[1],
        eps=opt_cfg.eps,
        weight_decay=opt_cfg.weight_decay if opt_cfg.type == "adamw" else 0.0,
        decay_mask=[layout.decay[p] for p in paths], clip_scale=clip_scale,
        use_kernel=opt_cfg.fused,
        kernel_mask=[layout.kernel[p] for p in paths])
    for work, (path, p_sub, zs) in zip(works, subs):
        if zs is None:
            if work is not p_sub:
                p_sub.copy_(work)
            continue
        dim, axes = zs
        state.params[path].copy_(all_gather(work, axes, gather_dim=dim,
                                            mesh=mesh))


def make_data_grad_fn(model_cfg, opt_cfg, par_cfg, mesh, layout,
                      attn_impl: str = "xla"):
    """``grad_fn(state, batch) -> (loss, aux, grads)`` of the step without
    a pipeline: this rank's rows (its dp x fsdp index), whole sequences,
    ``batch["tokens"]`` [accum * mb_local, S]. The objective of each
    micro-batch is the global token-weighted mean (this rank's sum over
    the global count) plus, for MoE, the aux over the data ranks that
    each compute it whole; the gradients are their average, this rank's
    share before the sums over the data axes. ``loss`` is the global
    mean and ``aux`` the aux (0 for a dense model)."""
    from ..comms.collectives import allreduce_sum
    accum = max(par_cfg.gradient_accumulation_steps, 1)
    remat = par_cfg.activation_checkpoint
    acc_dtype = getattr(torch, opt_cfg.accum_dtype)
    data_seq = tuple(a for a in DATA_AXES if mesh.shape[a] > 1)
    n_data = mesh.axis_size(data_seq)

    def grad_fn(state: ShardedTrainState, batch: dict):
        n = batch["tokens"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{accum} micro-batches")
        mb = n // accum
        params = [state.params[p] for p in layout.paths]
        acc = None
        loss_sum = count_sum = aux_sum = 0.0
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            total, count, aux = _forward_loss(state, layout, part,
                                              model_cfg, mesh, attn_impl,
                                              remat)
            g_count = torch.clamp(allreduce_sum(count.detach(), data_seq,
                                                mesh), min=1.0)
            objective = total / g_count
            if aux is not None:
                objective = objective + aux / n_data
                aux_sum = aux_sum + aux.detach()
            grads = torch.autograd.grad(objective, params)
            loss = allreduce_sum(total.detach(), data_seq, mesh) / g_count
            if accum == 1:
                acc = list(grads)
            else:
                grads = [g.to(acc_dtype) for g in grads]
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
            loss_sum = loss_sum + loss * g_count
            count_sum = count_sum + g_count
        grads = dict(zip(layout.paths, (a.float() / accum if accum > 1
                                        else a for a in acc)))
        loss = loss_sum / count_sum if accum > 1 else loss
        return loss, aux_sum / accum, grads

    return grad_fn


def make_sharded_train_step(model_cfg, opt_cfg, par_cfg, mesh, layout,
                            attn_impl: str = "xla", grad_fn=None):
    """Build (train_step, schedule, gradients) for one rank of ``mesh``.

    ``train_step(state, batch) -> (state, metrics)`` runs ``grad_fn``
    (default ``make_data_grad_fn``; a pipeline's from
    ``parallel/pipeline.py``, which then takes the whole step's
    microbatches: accumulation is 1, as JAX forces it for a custom
    function), sums the gradients over the axes their leaves are not cut
    over, clips by the global norm and updates this rank's ZeRO slices.
    The metrics are the global ones on every rank. ``gradients(state,
    batch) -> (loss, aux, grads)`` is the step's summed gradient shards,
    before the clip, without an update."""
    _, schedule = make_optimizer(opt_cfg)
    if grad_fn is None:
        grad_fn = make_data_grad_fn(model_cfg, opt_cfg, par_cfg, mesh,
                                    layout, attn_impl)

    def gradients(state: ShardedTrainState, batch: dict):
        loss, aux, grads = grad_fn(state, batch)
        _sum_grads_over_data(grads, layout, mesh)
        return loss, aux, grads

    def train_step(state: ShardedTrainState, batch: dict):
        loss, _, grads = gradients(state, batch)
        gnorm = _global_grad_norm(grads, layout, mesh)
        if opt_cfg.grad_clip > 0:
            clip_scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9),
                                     max=1.0)
        else:
            clip_scale = torch.ones((), device=gnorm.device)
        _zero_update(state, grads, layout, mesh, opt_cfg, schedule,
                     clip_scale)
        state.count += 1
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": schedule(state.step),
            "tokens": float(batch["tokens"].numel()
                            * mesh.axis_size(("dp", "fsdp"))),
        }
        state.step += 1
        return state, metrics

    return train_step, schedule, gradients


def make_sharded_eval_step(model_cfg, mesh, layout,
                           attn_impl: str = "xla") -> Callable:
    """eval_step(state, batch) -> {loss, tokens}: the global token-weighted
    mean over every rank's rows and chunk."""
    from ..comms.collectives import allreduce_sum
    data_seq = tuple(a for a in DATA_AXES if mesh.shape[a] > 1)

    @torch.no_grad()
    def eval_step(state: ShardedTrainState, batch: dict):
        total, count, _ = _forward_loss(state, layout, batch, model_cfg,
                                        mesh, attn_impl, "none")
        count = allreduce_sum(count, data_seq, mesh)
        loss = allreduce_sum(total, data_seq, mesh) / torch.clamp(count,
                                                                 min=1.0)
        return {"loss": loss, "tokens": count}
    return eval_step
