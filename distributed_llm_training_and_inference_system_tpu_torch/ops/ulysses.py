"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head scatter.

The port's counterpart of the JAX package's ``ops/ulysses.py``. One
all-to-all re-partitions each of q, k, v from [B, S/sp, N, D] (sequence
on ``sp``) into [B, S, N/sp, D] (heads on ``sp``); each rank runs ONE
flash attention (the kernels of ``ops/attention.py``) over the whole
sequence with its 1/sp of the heads, and a second all-to-all restores
the sequence sharding. Positions and segments for the whole sequence are
all-gathered over ``sp`` (small [B, S] int32 arrays). Needs Nq % sp ==
0 and Nkv % sp == 0 (query group j of the heads then reads kv group j,
GQA's head-major grouping). The all-to-all is differentiable
(``comms.collectives.all_to_all``: its gradient is the inverse
all-to-all), and the flash attention brings its own backward, so there is
no hand-written backward here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comms.collectives import all_gather, all_to_all
from .attention import flash_attention


def _ulysses_body(q, k, v, pos, seg, axis_name, block_q, block_k, mesh):
    """q/k/v: [B, S_local, N, D]; pos/seg: [B, S_local]."""
    sp = mesh.axis_size(axis_name)
    B, S_local, _, D = q.shape

    def scatter_heads(x):
        # [B, s, n, D] -> [B, s*sp, n/sp, D]: every rank's sequence chunk,
        # 1/sp of the heads
        n_local = x.shape[2] // sp
        xg = x.reshape(B, S_local, sp, n_local, D)
        xg = all_to_all(xg, axis_name, split_dim=2, concat_dim=1, mesh=mesh)
        return xg.reshape(B, S_local * sp, n_local, D)

    def gather_heads(x):
        # the inverse: [B, S, n/sp, D] -> [B, S/sp, n, D]
        S = x.shape[1]
        xg = x.reshape(B, sp, S // sp, x.shape[2], D)
        xg = all_to_all(xg, axis_name, split_dim=1, concat_dim=3, mesh=mesh)
        return xg.reshape(B, S // sp, x.shape[2] * sp, D)

    qf, kf, vf = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    pos_full = all_gather(pos, axis_name, gather_dim=1, mesh=mesh)
    seg_full = all_gather(seg, axis_name, gather_dim=1, mesh=mesh)
    out = flash_attention(qf, kf, vf, segment_ids=seg_full,
                          positions=pos_full, causal=True, block_q=block_q,
                          block_k=block_k)
    return gather_heads(out)


def ulysses_attention(
    q: torch.Tensor,                       # [B, S_local, Nq, D] (seq on sp)
    k: torch.Tensor,
    v: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    mesh,
    axis_name: str = "sp",
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Causal Ulysses attention over ``mesh``'s ``axis_name``. ``mesh``
    is required: None (the whole sequence on this rank) or an axis of size
    1 gives plain flash attention."""
    B, S, Nq, D = q.shape
    Nkv = k.shape[2]
    dev = q.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev)[None, :].expand(B, S)
    if segment_ids is None:
        segment_ids = torch.ones((B, S), dtype=torch.int32, device=dev)
    positions = positions.to(torch.int32).contiguous()
    segment_ids = segment_ids.to(torch.int32).contiguous()
    sp = 1 if mesh is None else mesh.axis_size(axis_name)
    if sp == 1:
        return flash_attention(q, k, v, segment_ids=segment_ids,
                               positions=positions, causal=True,
                               block_q=block_q, block_k=block_k)
    if Nq % sp or Nkv % sp:
        raise ValueError(
            f"ulysses needs heads divisible by sp={sp} (got Nq={Nq}, "
            f"Nkv={Nkv}); use attn_impl='ring' for this mesh")
    return _ulysses_body(q, k, v, positions, segment_ids, axis_name,
                         block_q, block_k, mesh)
