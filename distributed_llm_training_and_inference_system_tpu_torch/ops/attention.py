"""Flash (block-streaming) attention: forward, two-pass backward, GQA fold.

Counterpart of the JAX package's ``ops/attention.py``, with its public and
raw entry points: ``flash_attention``, ``fold_gqa``, ``_fwd`` and
``_bwd_impl`` (ring attention drives the raw pair per chunk). Masking
comes from explicit segment and position arrays, so one kernel serves
plain causal attention, packed rows whose positions restart per document,
and GQA with the query groups folded into the q-row axis.

Each raw entry point has two implementations of the same function:

- the hand-written CUDA kernels (``ops/attention_cuda.py``), for tensors
  on a card: a CUDA tensor goes to the kernel or raises;
- the plain PyTorch version (``_fwd_plain``, ``_bwd_dq_plain`` and
  ``_bwd_dkv_plain`` beside the three kernels; ``_bwd_plain`` does both
  backward halves), for tensors on the CPU, and on request
  (``impl="plain"``) as the reference the kernels are checked against. It
  computes the whole score matrix at once; the kernels' online softmax
  gives the same result up to rounding.

Numerics are the TPU kernels': scores from the operands with fp32
accumulation, masked scores NEG_INF, fp32 softmax, the probabilities (and
in the backward ``ds``) rounded to the input dtype before the products
that consume them, lse = NEG_INF on rows with no key.

Gradients go through ``_Flash`` (a ``torch.autograd.Function``): the
forward saves (q, k, v, segments, positions, out, lse) and the backward
computes ``delta = rowsum(dO * O)`` in fp32 and calls ``_bwd_impl``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512


def _use_kernel(t: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"impl must be kernel|plain, got {impl!r}")
    if impl is None:
        return t.is_cuda
    if impl == "kernel" and not t.is_cuda:
        raise ValueError("the flash-attention kernels need CUDA tensors")
    return impl == "kernel"


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _mask(q_segments, kv_segments, q_positions, kv_positions, causal):
    """[BH, Sq, Skv] bool from [BH, 1, S] segment/position arrays."""
    qs = q_segments[:, 0, :, None]
    ks = kv_segments[:, 0, None, :]
    mask = (qs == ks) & (ks != 0)
    if causal:
        mask = mask & (q_positions[:, 0, :, None]
                       >= kv_positions[:, 0, None, :])
    return mask


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [BH, M, K] @ b [BH, K, N] with fp32 accumulation (the operands
    widened to fp32: products of bf16 values are exact in fp32)."""
    return torch.bmm(a.float(), b.float())


def _fwd_plain(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
               causal, scale):
    s = _dot(q, k.transpose(1, 2)) * scale
    mask = _mask(q_segments, kv_segments, q_positions, kv_positions, causal)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    live = m > NEG_INF / 2
    p = torch.exp(torch.where(live, s - m, NEG_INF))
    l = p.sum(dim=-1, keepdim=True)
    acc = _dot(p.to(v.dtype), v)
    safe_l = torch.where(l > 0, l, 1.0)
    out = (acc / safe_l).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return out, lse


def _bwd_p_ds(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
              do, lse, delta, causal, scale):
    """The probabilities p (fp32) and ds (in q's dtype) both backward
    kernels recompute."""
    s = _dot(q, k.transpose(1, 2)) * scale
    mask = _mask(q_segments, kv_segments, q_positions, kv_positions, causal)
    # where() before exp: an empty row's lse is NEG_INF and s - lse would
    # overflow for its (masked) entries; exp(NEG_INF) is 0
    p = torch.exp(torch.where(mask, s - lse, NEG_INF))
    dp = _dot(do, v.transpose(1, 2))
    return p, (p * (dp - delta) * scale).to(q.dtype)


def _bwd_dq_plain(q, k, v, q_segments, kv_segments, q_positions,
                  kv_positions, do, lse, delta, causal, scale):
    """The plain version of the dq kernel."""
    _, ds = _bwd_p_ds(q, k, v, q_segments, kv_segments, q_positions,
                      kv_positions, do, lse, delta, causal, scale)
    return _dot(ds, k).to(q.dtype)


def _dkv_from(q, do, p, ds, k_dtype, v_dtype):
    dv = _dot(p.to(do.dtype).transpose(1, 2), do).to(v_dtype)
    dk = _dot(ds.transpose(1, 2), q).to(k_dtype)
    return dk, dv


def _bwd_dkv_plain(q, k, v, q_segments, kv_segments, q_positions,
                   kv_positions, do, lse, delta, causal, scale):
    """The plain version of the dk/dv kernel."""
    p, ds = _bwd_p_ds(q, k, v, q_segments, kv_segments, q_positions,
                      kv_positions, do, lse, delta, causal, scale)
    return _dkv_from(q, do, p, ds, k.dtype, v.dtype)


def _bwd_plain(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
               do, lse, delta, causal, scale):
    p, ds = _bwd_p_ds(q, k, v, q_segments, kv_segments, q_positions,
                      kv_positions, do, lse, delta, causal, scale)
    dq = _dot(ds, k).to(q.dtype)
    return (dq, *_dkv_from(q, do, p, ds, k.dtype, v.dtype))


# ---------------------------------------------------------------------------
# Raw entry points
# ---------------------------------------------------------------------------

def _fwd(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
         causal, block_q, block_k, scale, impl: Optional[str] = None):
    """q: [BH, Sq, D] (heads folded into batch); segments/positions:
    [BH, 1, S] int32. Returns (out [BH, Sq, D], lse [BH, Sq, 1] fp32).
    ``block_q``/``block_k`` are the TPU kernel's tiles and are accepted for
    the JAX signature; the kernels tile for the card themselves."""
    del block_q, block_k
    if _use_kernel(q, impl):
        from .attention_cuda import flash_fwd
        return flash_fwd(q, k, v, q_segments, kv_segments, q_positions,
                         kv_positions, causal, scale)
    return _fwd_plain(q, k, v, q_segments, kv_segments, q_positions,
                      kv_positions, causal, scale)


def _bwd_impl(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
              do, lse, delta, causal, block_q, block_k, scale,
              impl: Optional[str] = None):
    """Raw flash backward given (possibly global) lse/delta per q row.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    del block_q, block_k
    do = do.to(q.dtype)
    if _use_kernel(q, impl):
        from .attention_cuda import flash_bwd_dkv, flash_bwd_dq
        lse, delta = lse.contiguous(), delta.contiguous()
        do = do.contiguous()
        dq = flash_bwd_dq(q, k, v, q_segments, kv_segments, q_positions,
                          kv_positions, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv(q, k, v, q_segments, kv_segments,
                               q_positions, kv_positions, do, lse, delta,
                               causal, scale)
        return dq, dk, dv
    return _bwd_plain(q, k, v, q_segments, kv_segments, q_positions,
                      kv_positions, do, lse, delta, causal, scale)


class _Flash(torch.autograd.Function):
    """Flash attention on the folded layout with its two-pass backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_segments, kv_segments, q_positions,
                kv_positions, causal, block_q, block_k, scale, impl):
        out, lse = _fwd(q, k, v, q_segments, kv_segments, q_positions,
                        kv_positions, causal, block_q, block_k, scale, impl)
        ctx.save_for_backward(q, k, v, q_segments, kv_segments, q_positions,
                              kv_positions, out, lse)
        ctx.args = (causal, block_q, block_k, scale, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qseg, kseg, qpos, kpos, out, lse = ctx.saved_tensors
        causal, block_q, block_k, scale, impl = ctx.args
        delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
        dq, dk, dv = _bwd_impl(q, k, v, qseg, kseg, qpos, kpos, dout, lse,
                               delta, causal, block_q, block_k, scale, impl)
        return dq, dk, dv, None, None, None, None, None, None, None, None, \
            None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def fold_gqa(q, k, v, segs, pos):
    """Fold [B, S, N, D] tensors into the kernel's head-in-batch layout,
    stacking GQA query-head groups along the q-row axis so each KV head is
    read once per query group (not once per query head).

    Returns (qf [B*Nkv, G*S, D], kf, vf [B*Nkv, Skv, D],
    segs_q/pos_q [B*Nkv, 1, G*S], segs_kv/pos_kv [B*Nkv, 1, Skv],
    unfold(out) -> [B, S, Nq, D])."""
    B, S, Nq, D = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    groups = Nq // Nkv
    # q head n = h*G + g (the kv-repeat convention)
    qf = q.reshape(B, S, Nkv, groups, D).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(B * Nkv, groups * S, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * Nkv, Skv, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * Nkv, Skv, D).contiguous()
    segs_q = segs.repeat(1, groups).repeat_interleave(Nkv, 0)[:, None, :]
    pos_q = pos.repeat(1, groups).repeat_interleave(Nkv, 0)[:, None, :]
    segs_kv = segs.repeat_interleave(Nkv, 0)[:, None, :]
    pos_kv = pos.repeat_interleave(Nkv, 0)[:, None, :]

    def unfold(out):
        out = out.reshape(B, Nkv, groups, S, D).permute(0, 3, 1, 2, 4)
        return out.reshape(B, S, Nq, D)

    return (qf, kf, vf, segs_q.contiguous(), pos_q.contiguous(),
            segs_kv.contiguous(), pos_kv.contiguous(), unfold)


def flash_attention(
    q: torch.Tensor,                           # [B, S, Nq, D]
    k: torch.Tensor,                           # [B, Skv, Nkv, D]
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,   # [B, S]
    positions: Optional[torch.Tensor] = None,     # [B, S] global positions
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Flash attention with GQA-folded KV streaming and packed segments;
    differentiable. ``impl`` None takes the kernels for CUDA tensors and
    the plain version for CPU tensors; "plain" forces the plain version."""
    B, S, Nq, D = q.shape
    if k.shape[1] != S:
        raise ValueError("flash_attention is for self-attention (Skv == S)")
    dev = q.device
    if segment_ids is None:
        segs = torch.ones(B, S, dtype=torch.int32, device=dev)
    else:
        segs = segment_ids.to(torch.int32)
    if positions is None:
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        pos = pos.expand(B, S)
    else:
        pos = positions.to(torch.int32)
    scale = 1.0 / float(D) ** 0.5
    qf, kf, vf, segs_q, pos_q, segs_kv, pos_kv, unfold = fold_gqa(
        q, k, v, segs, pos)
    out = _Flash.apply(qf, kf, vf, segs_q, segs_kv, pos_q, pos_kv, causal,
                       block_q, block_k, scale, impl)
    return unfold(out).to(q.dtype)
