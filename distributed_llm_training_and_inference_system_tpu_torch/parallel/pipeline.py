"""Pipeline parallelism, one rank a stage: GPipe and 1F1B (the JAX
package's ``parallel/pipeline.py``).

JAX writes the pipeline as one SPMD program: the stage is an array axis
sharded on ``pp``, a scan of ticks runs every stage at once and rolls the
activations to the next stage, and autodiff through the scan (GPipe) or
a manual backward inside it (1F1B) makes the reverse pipeline. The port
runs one process a rank, so each rank of the mesh's ``pp`` axis is one
stage and runs its own order of microbatches:

- stage s holds layers [s·L/pp, (s+1)·L/pp): the pp shard of every
  stacked leaf, which is JAX's [pp, L/pp, ...] reshape and its ("pp", ...)
  stacked spec (``sharding.PARAM_RULES``); stage 0 embeds, the last stage
  runs the final norm and the chunked loss; the top leaves are whole on
  every stage and their gradients summed over pp by the step;
- activations go to the next stage and cotangents come back by p2p
  (``comms.collectives.send_recv``), in each stage's order of steps
  (``gpipe_order``, ``one_f_one_b_order``): a send is posted together
  with the receive that follows it, so that no two stages wait on each
  other under NCCL, where a rank's p2p calls run in order;
- inside a stage, the FSDP gathers, tp all-reduces, the MoE dispatch and
  ``activation_checkpoint`` are the non-pipelined forward's
  (``models/gpt.forward_sharded`` in its stage form), so pp composes with
  dp, fsdp, tp, ep and ZeRO-1.

The objective is JAX's, ``loss_sum / max(cnt_sum, 1) + aux_sum / M``, with
both sums over every microbatch and every data rank: the global
token-weighted mean. The count comes from the tokens alone (the shifted
targets' weights), so every stage knows it before any forward.

- **GPipe** (``make_pipeline_loss_fn``): every stage runs all M forwards,
  then the backwards in reverse. A stage holds the graphs of all M
  microbatches: activation memory grows with M.
- **1F1B** (``make_pipeline_grad_fn``, dense models only, as JAX's): each
  stage runs pp − s − 1 warm-up forwards, then one forward and one
  backward at a time, then the cool-down backwards. A stage holds at most
  pp − s microbatches' graphs, whatever M (JAX's lockstep form holds
  2(pp − 1) + 1 stage inputs and recomputes; both are constant in M). The
  backward takes the sum-loss and the gradients are scaled by
  1 / cnt_total at the end, as JAX's. Its gradients are GPipe's sum in
  another order.

Both give the step's ``grad_fn(state, batch) -> (loss, aux, grads)``
(``exec/train_step.make_sharded_train_step``); ``batch["tokens"]`` is
this rank's [M, mb, S] (``reshape_batch_for_pipeline`` of its [B, S]
rows). ``make_pipeline_eval_fn`` runs the forward alone through the
stages, and the last stage's loss reaches every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comms.collectives import allreduce_sum, send_recv
from ..exec.train_step import (DATA_AXES, _local_inputs, stage_params)
from ..models.gpt import compute_dtype, forward_sharded
from ..models.loss import chunked_target_loss
from .sharding import _shrink_to_fit


def reshape_batch_for_pipeline(batch: dict, num_microbatches: int) -> dict:
    """[B, S] rows -> [M, B/M, S], microbatch m being rows m·mb … (m+1)·mb
    − 1."""
    def split(x):
        B = x.shape[0]
        assert B % num_microbatches == 0, (B, num_microbatches)
        return x.reshape(num_microbatches, B // num_microbatches,
                         *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def pipeline_batch_specs(batch: dict, mesh_shape: dict) -> dict:
    """Specs of [M, mb, S, ...] batches: the microbatch axis replicated,
    the rows over (dp, fsdp), the sequence over sp."""
    def spec(x):
        nd = np.ndim(x)
        if nd >= 3:
            s = (None, ("dp", "fsdp"), "sp", *(None,) * (nd - 3))
        elif nd == 2:
            s = (None, ("dp", "fsdp"))
        else:
            s = ()
        return _shrink_to_fit(s, np.shape(x), mesh_shape)
    return {k: spec(v) for k, v in batch.items()}


class _Stage:
    """This rank's stage: its place on pp, its forward of one microbatch
    and its hops to the neighbouring stages."""

    def __init__(self, model_cfg, par, mesh, layout, attn_impl: str):
        pp = mesh.axis_size("pp")
        if model_cfg.num_layers % pp:
            raise ValueError(f"layers {model_cfg.num_layers} not divisible "
                             f"by pp {pp}")
        self.cfg, self.mesh, self.layout = model_cfg, mesh, layout
        self.attn_impl, self.remat = attn_impl, par.activation_checkpoint
        self.M = par.num_microbatches
        self.s = mesh.axis_index("pp")
        self.first, self.last = self.s == 0, self.s == pp - 1
        self.data_seq = tuple(a for a in DATA_AXES if mesh.shape[a] > 1)
        self.n_data = mesh.axis_size(self.data_seq)
        self.dt = compute_dtype(model_cfg)
        self.joined = False

    def microbatches(self, batch: dict, M=None) -> list[dict]:
        M = self.M if M is None else M
        if batch["tokens"].ndim == 2:
            batch = reshape_batch_for_pipeline(batch, M)
        if batch["tokens"].shape[0] != M:
            raise ValueError(f"{batch['tokens'].shape[0]} microbatches, "
                             f"the pipeline runs {M}")
        return [{k: v[m] for k, v in batch.items()} for m in range(M)]

    def count(self, mbs: list[dict]) -> torch.Tensor:
        """The tokens scored over every microbatch and data rank (>= 1)."""
        local = sum(_local_inputs(mb, self.mesh)[4].sum() for mb in mbs)
        return torch.clamp(allreduce_sum(local.float(), self.data_seq,
                                         self.mesh), min=1.0)

    def forward(self, state, mb: dict, x_in):
        """(out, the sum of token losses on the last stage else None, the
        stage's MoE aux or None) of one microbatch."""
        tokens, positions, segs, targets, weights = _local_inputs(
            mb, self.mesh)
        stacked, top = stage_params(state, self.layout)
        out, head, aux = forward_sharded(
            stacked, top, tokens, self.cfg, self.mesh, positions=positions,
            segment_ids=segs, attn_impl=self.attn_impl, remat=self.remat,
            x=x_in, first=self.first, last=self.last)
        if not self.last:
            return out, None, aux
        loss, _ = chunked_target_loss(out, head, targets, weights,
                                      tied=self.cfg.tie_word_embeddings)
        return out, loss, aux

    def act_shape(self, mb: dict) -> tuple:
        B, S = mb["tokens"].shape
        return (B, S // self.mesh.axis_size("sp"), self.cfg.hidden_size)

    def hop(self, x, send, recv, mbs: list[dict]):
        """One step's ("X", send, recv) of an order: ``x`` to the stage it
        goes to and the tensor it names from the stage it comes from, as
        one pair (``send_recv``); returns the received tensor or None."""
        if not self.joined:     # NCCL: a group's first batched p2p must
            allreduce_sum(_zero(self.mesh.device), "pp", self.mesh)
            self.joined = True  # follow a call of all its ranks
        up = {"act": 1, "cot": -1}
        return send_recv(
            x, "pp", to=self.s + up[send[0]] if send else None,
            frm=self.s - up[recv[0]] if recv else None,
            shape=self.act_shape(mbs[recv[1]]) if recv else None,
            dtype=self.dt, mesh=self.mesh, device=self.mesh.device)

    def results(self, state, loss_sum, aux_sum, count, M):
        """(loss, aux, this rank's gradients) once the backwards ran: the
        loss from the last stage and the aux from every stage, on every
        rank; each param's accumulated ``.grad`` (zeros for a leaf this
        stage does not use), taken off it."""
        loss = allreduce_sum(loss_sum, ("pp",) + DATA_AXES,
                             self.mesh) / count
        aux = allreduce_sum(aux_sum, "pp", self.mesh) / M
        grads = {}
        for path in self.layout.paths:
            p = state.params[path]
            grads[path] = (torch.zeros_like(p) if p.grad is None
                           else p.grad)
            p.grad = None
        return loss, aux, grads


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _hop(stage: int, pp: int, send=None, recv=None) -> list:
    """The step ("X", send, recv) of ``stage``'s order, each of ``send``
    and ``recv`` ("act" | "cot", microbatch) or None, without the hops
    that have no stage at their other end: ``[]`` if none is left. An
    activation goes to stage + 1 and comes from stage - 1; a cotangent
    the other way."""
    if send and stage == (pp - 1 if send[0] == "act" else 0):
        send = None
    if recv and stage == (0 if recv[0] == "act" else pp - 1):
        recv = None
    return [("X", send, recv)] if send or recv else []


def gpipe_order(stage: int, pp: int, M: int) -> list[tuple]:
    """Stage ``stage``'s GPipe order: each microbatch's forward between
    receiving its input and sending its output, then the backwards in
    reverse between receiving the output's cotangent and sending the
    input's. Steps are ("F" | "B", microbatch) and ("X", send, recv)
    (``_hop``)."""
    order = []
    for m in range(M):
        order += (_hop(stage, pp, recv=("act", m)) + [("F", m)]
                  + _hop(stage, pp, send=("act", m)))
    for m in reversed(range(M)):
        order += (_hop(stage, pp, recv=("cot", m)) + [("B", m)]
                  + _hop(stage, pp, send=("cot", m)))
    return order


def one_f_one_b_order(stage: int, pp: int, M: int) -> list[tuple]:
    """Stage ``stage``'s 1F1B order (steps as ``gpipe_order``'s): pp −
    stage − 1 warm-up forwards, then a forward and a backward at a time,
    then the cool-down backwards. In the steady state each output goes
    out paired with the receive of the cotangent the next backward needs,
    and each input's cotangent with the receive of the next forward's
    input, so a stage posts no send its neighbour takes only after a
    receive of its own (Megatron-LM's schedule)."""
    warm = min(pp - stage - 1, M)
    rest = M - warm
    order = []
    for m in range(warm):
        order += (_hop(stage, pp, recv=("act", m)) + [("F", m)]
                  + _hop(stage, pp, send=("act", m)))
    if rest:
        order += _hop(stage, pp, recv=("act", warm))
    for i in range(rest):
        f = warm + i
        order += ([("F", f)]
                  + _hop(stage, pp, send=("act", f), recv=("cot", i))
                  + [("B", i)]
                  + _hop(stage, pp, send=("cot", i),
                         recv=("act", f + 1) if i + 1 < rest else None))
    for m in range(rest, M):
        order += (_hop(stage, pp, recv=("cot", m)) + [("B", m)]
                  + _hop(stage, pp, send=("cot", m)))
    return order


def _run(st: _Stage, state, order: list, mbs: list[dict], divisor):
    """Runs a stage's ``order`` over the microbatches ``mbs``: a forward's
    objective is its loss over ``divisor`` plus its MoE aux's share;
    the gradients accumulate on the params. Returns (the sum of the token
    losses on the last stage, the sum of the stage's aux)."""
    dev = st.mesh.device
    loss_sum, aux_sum = _zero(dev), _zero(dev)
    got, live, out_cot = {}, {}, {}     # received, forward graphs, sent
    for step in order:
        if step[0] == "X":
            _, send, recv = step
            x = None
            if send:
                x = (live[send[1]][1] if send[0] == "act"
                     else out_cot.pop(send[1]))
            r = st.hop(x, send, recv, mbs)
            if recv:
                got[recv] = r
            continue
        kind, m = step
        if kind == "F":
            x_in = got.pop(("act", m), None)
            if x_in is not None:
                x_in.requires_grad_(True)
            out, loss, aux = st.forward(state, mbs[m], x_in)
            obj = None
            if loss is not None:
                obj = loss / divisor
                loss_sum = loss_sum + loss.detach()
            if aux is not None:
                part = aux / (st.M * st.n_data)
                obj = part if obj is None else obj + part
                aux_sum = aux_sum + aux.detach()
            live[m] = (x_in, out, obj)
            continue
        x_in, out, obj = live.pop(m)
        if st.last:
            torch.autograd.backward(obj)
        else:
            outs, cots = [out], [got.pop(("cot", m))]
            if obj is not None:
                outs.append(obj)
                cots.append(torch.ones_like(obj))
            torch.autograd.backward(outs, cots)
        if not st.first:
            out_cot[m] = x_in.grad
        del x_in, out, obj
    return loss_sum, aux_sum


def make_pipeline_loss_fn(model_cfg, par, mesh, layout,
                          attn_impl: str = "xla"):
    """GPipe: ``grad_fn(state, batch) -> (loss, aux, grads)`` in this
    stage's ``gpipe_order``, each loss divided by the step's token count
    before its backward."""
    st = _Stage(model_cfg, par, mesh, layout, attn_impl)
    order = gpipe_order(st.s, mesh.axis_size("pp"), st.M)

    def grad_fn(state, batch: dict):
        mbs = st.microbatches(batch)
        count = st.count(mbs)
        loss_sum, aux_sum = _run(st, state, order, mbs, count)
        return st.results(state, loss_sum, aux_sum, count, st.M)

    return grad_fn


def make_pipeline_grad_fn(model_cfg, par, mesh, layout,
                          attn_impl: str = "xla"):
    """1F1B: ``grad_fn(state, batch) -> (loss, aux, grads)`` in this
    stage's ``one_f_one_b_order``; dense models only (JAX's). The backward
    takes the sum-loss and the gradients are scaled by 1 / count at the
    end."""
    if model_cfg.is_moe:
        raise ValueError("1f1b schedule: dense models only (use gpipe)")
    st = _Stage(model_cfg, par, mesh, layout, attn_impl)
    order = one_f_one_b_order(st.s, mesh.axis_size("pp"), st.M)

    def grad_fn(state, batch: dict):
        mbs = st.microbatches(batch)
        count = st.count(mbs)
        loss_sum, aux_sum = _run(st, state, order, mbs, 1.0)
        loss, aux, grads = st.results(state, loss_sum, aux_sum, count, st.M)
        inv = 1.0 / count
        return loss, aux, {p: g.mul_(inv) for p, g in grads.items()}

    return grad_fn


def make_pipeline_eval_fn(model_cfg, par, mesh, layout,
                          attn_impl: str = "xla"):
    """``eval_fn(state, batch) -> {loss, tokens}``: this rank's rows (a
    [B, S] batch, or [M, mb, S] taken whole) forward through the stages
    as one microbatch, no remat; the last stage's token-weighted mean
    over every data rank on every rank."""
    st = _Stage(model_cfg, par, mesh, layout, attn_impl)
    st.remat = "none"

    @torch.no_grad()
    def eval_fn(state, batch: dict):
        if batch["tokens"].ndim == 3:
            batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in
                     batch.items()}
        mbs = st.microbatches(batch, 1)
        count = st.count(mbs)
        x_in = None
        if not st.first:
            x_in = st.hop(None, None, ("act", 0), mbs)
        out, loss, _ = st.forward(state, mbs[0], x_in)
        if not st.last:
            st.hop(out, ("act", 0), None, mbs)
            loss = _zero(mesh.device)
        loss = allreduce_sum(loss.float(), ("pp",) + DATA_AXES,
                             mesh) / count
        return {"loss": loss, "tokens": count}

    return eval_fn
