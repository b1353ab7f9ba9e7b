"""Ring attention: context-parallel causal attention over the ``sp`` axis.

The port's counterpart of the JAX package's ``ops/ring_attention.py``,
on the flash kernels of ``ops/attention.py``:

- the sequence is cut over ``sp`` ranks; each holds q/k/v of its S/sp
  tokens with their GLOBAL positions and segments;
- forward: sp steps of the flash forward ``_fwd`` of the local q against
  the kv chunk held, masked by that chunk's global positions/segments,
  each giving a chunk-normalised output and its lse; the outputs merge in
  fp32 by running max (``_merge``, also for bf16 rings); between steps kv,
  positions and segments hop to the ring neighbour (``ring_shift``);
- backward (one ``torch.autograd.Function`` for the whole ring): a second
  ring calls ``_bwd_impl`` per chunk with the GLOBAL lse and
  delta = rowsum(dO * O), so each chunk's recomputed softmax is its slice
  of the whole row's; dq accumulates at home in fp32 while the fp32 dk/dv
  accumulators travel with their kv chunk and arrive home after sp hops.

The forward saves only (q, k, v, positions, segments, out, global lse):
O(S/sp) a rank, never a score matrix. A fully-future chunk still rotates
and still counts its step: the kernel's causal block skip makes its
launch cheap, not absent. A rank launches the forward kernel sp times, the
dq and dk/dv kernels sp times each.

Where the JAX ring is a ``lax.scan`` of ``ppermute``s that XLA may
overlap with the chunk's compute, each hop here is a blocking batched
isend/irecv between two kernels; under gloo on one card (``parallel/
mesh.py``) it passes through host memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comms.collectives import ring_shift
from .attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, NEG_INF,
                        _bwd_impl, _fwd, flash_attention, fold_gqa)


def _merge(acc, w, m_run, r, lse):
    """Online merge of a chunk-normalised output (r, lse) into the running
    (acc, w, m_run): invariant out_so_far = acc / w, weights rescaled by
    exp(-m_run). All fp32."""
    m_new = torch.maximum(m_run, lse)
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    alpha = torch.where(m_run <= NEG_INF / 2, 0.0, torch.exp(m_run - m_safe))
    beta = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(lse - m_safe))
    return acc + (r * beta - acc * (1.0 - alpha)), w * alpha + beta, m_new


def _ring_fwd_impl(q, k, v, qseg, kseg, qpos, kpos, axis, scale, block_q,
                   block_k, mesh):
    """Folded layout: q [BH, Sq, D]; k/v [BH, Skv, D]; seg/pos [BH, 1, S].
    Returns (out [BH, Sq, D], global lse [BH, Sq, 1])."""
    sp = mesh.axis_size(axis)
    BH, Sq, D = q.shape
    acc = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)
    w = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=q.device)
    m_run = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    k_c, v_c, ks_c, kp_c = k, v, kseg, kpos
    for step in range(sp):
        r, lse = _fwd(q, k_c, v_c, qseg, ks_c, qpos, kp_c, True, block_q,
                      block_k, scale)
        acc, w, m_run = _merge(acc, w, m_run, r.float(), lse)
        if step + 1 < sp:       # the last hop would only bring kv home
            k_c, v_c, ks_c, kp_c = (ring_shift(t, axis, mesh=mesh)
                                    for t in (k_c, v_c, ks_c, kp_c))
    safe_w = torch.clamp(w, min=1e-30)
    out = (acc / safe_w).to(q.dtype)
    lse = torch.where(w > 0, m_run + torch.log(safe_w), NEG_INF)
    return out, lse


def _ring_bwd_impl(q, k, v, qseg, kseg, qpos, kpos, out, lse, dout, axis,
                   scale, block_q, block_k, mesh):
    sp = mesh.axis_size(axis)
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_c, v_c, ks_c, kp_c = k, v, kseg, kpos
    for step in range(sp):
        # the chunk's flash backward with the GLOBAL lse/delta: p
        # recomputed as exp(s - lse_global) is this chunk's true slice
        dq_inc, dk_inc, dv_inc = _bwd_impl(
            q, k_c, v_c, qseg, ks_c, qpos, kp_c, dout, lse, delta, True,
            block_q, block_k, scale)
        dq += dq_inc.float()
        dk_c = dk_c + dk_inc.float()
        dv_c = dv_c + dv_inc.float()
        # the accumulators travel with their chunk: after sp hops each
        # dk/dv is home, on the rank that owns that kv shard
        dk_c, dv_c = (ring_shift(t, axis, mesh=mesh) for t in (dk_c, dv_c))
        if step + 1 < sp:
            k_c, v_c, ks_c, kp_c = (ring_shift(t, axis, mesh=mesh)
                                    for t in (k_c, v_c, ks_c, kp_c))
    return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype)


class _Ring(torch.autograd.Function):
    """The whole ring as one differentiable op on the folded layout."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, qpos, kpos, axis, scale, block_q,
                block_k, mesh):
        out, lse = _ring_fwd_impl(q, k, v, qseg, kseg, qpos, kpos, axis,
                                  scale, block_q, block_k, mesh)
        ctx.save_for_backward(q, k, v, qseg, kseg, qpos, kpos, out, lse)
        ctx.args = (axis, scale, block_q, block_k, mesh)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qseg, kseg, qpos, kpos, out, lse = ctx.saved_tensors
        axis, scale, block_q, block_k, mesh = ctx.args
        dq, dk, dv = _ring_bwd_impl(q, k, v, qseg, kseg, qpos, kpos, out,
                                    lse, dout.contiguous(), axis, scale,
                                    block_q, block_k, mesh)
        return (dq, dk, dv) + (None,) * 9


def ring_attention(
    q: torch.Tensor,                       # [B, S_local, Nq, D] (seq on sp)
    k: torch.Tensor,
    v: torch.Tensor,
    positions: Optional[torch.Tensor] = None,     # [B, S_local] GLOBAL
    segment_ids: Optional[torch.Tensor] = None,
    *,
    mesh,
    axis_name: str = "sp",
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Causal ring attention over ``mesh``'s ``axis_name``. ``mesh`` is
    required: None says the whole sequence is on this rank (one device's
    forward), and so does an axis of size 1; then it is single-chunk flash
    attention. GQA through ``fold_gqa``; the flash kernels for CUDA
    tensors, their plain versions on the CPU."""
    B, S, Nq, D = q.shape
    dev = q.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev)[None, :].expand(B, S)
    if segment_ids is None:
        segment_ids = torch.ones((B, S), dtype=torch.int32, device=dev)
    positions = positions.to(torch.int32)
    segment_ids = segment_ids.to(torch.int32)
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return flash_attention(q, k, v, segment_ids=segment_ids,
                               positions=positions, causal=True,
                               block_q=block_q, block_k=block_k)
    scale = 1.0 / float(D) ** 0.5
    qf, kf, vf, segs_q, pos_q, segs_kv, pos_kv, unfold = fold_gqa(
        q, k, v, segment_ids, positions)
    out = _Ring.apply(qf, kf, vf, segs_q, segs_kv, pos_q, pos_kv, axis_name,
                      scale, block_q, block_k, mesh)
    return unfold(out).to(q.dtype)
