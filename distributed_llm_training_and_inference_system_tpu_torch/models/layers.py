"""Transformer building blocks on PyTorch tensors.

Counterpart of the JAX package's ``models/layers.py``, function for
function: RMSNorm applied as ``(1 + scale)``, RoPE that rotates split halves
(not interleaved pairs), GQA attention with kv-head-major grouping
(``q.reshape(B, S, Nkv, G, D)``) and fp32 softmax, the gated FFN, and the
mixture of experts (token-choice top-K with GShard capacity and sort-based
dispatch; plain PyTorch ops, as the JAX package's is plain XLA). Weights
keep the JAX ``[in, out]`` layout, so every projection is ``x @ w``.
``layer`` arguments are ``models.gpt.Block`` modules.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# the JAX package's masking constant, bit for bit: large enough to zero a
# softmax entry, finite so that (NEG_INF - m) never overflows to -inf - inf
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, without a copy when it already is."""
    return t if t.dtype == dtype else t.to(dtype)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5, impl: str = "xla") -> torch.Tensor:
    """RMSNorm with the reduction in fp32 whatever the activation dtype.
    ``impl``: "xla" is the plain version below; "cuda" is
    ``ops.rmsnorm.rms_norm_fused`` (the hand-written kernel on a card,
    forward only; this plain version for a CPU tensor)."""
    if impl == "cuda":
        from ..ops.rmsnorm import rms_norm_fused
        return rms_norm_fused(x, scale, eps)
    if impl != "xla":
        raise ValueError(f"unknown norm impl {impl!r} (xla|cuda)")
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, base: float = 10000.0,
                     scaling: str = "none", factor: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for RoPE [head_dim // 2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # scalar ** tensor: no host-to-device copy (which would stall the
    # stream on a card)
    inv_freq = 1.0 / (float(base) ** exponent)
    if scaling == "linear" and factor != 1.0:
        inv_freq = inv_freq / factor
    elif scaling == "ntk" and factor != 1.0:
        # NTK-aware: stretch the base instead of the positions
        adjusted = base * (factor ** (head_dim / max(head_dim - 2, 1)))
        inv_freq = 1.0 / (float(adjusted) ** exponent)
    return inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, N, D] by position (positions [..., S]): the first
    and second halves of D form the rotated pairs."""
    angles = positions[..., :, None].float() * inv_freq      # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]                  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   q_segments: Optional[torch.Tensor] = None,
                   kv_segments: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """Boolean [B, Sq, Skv] mask, True = attend. Tokens attend only within
    their own segment; segment id 0 is padding and is never attended."""
    shape = q_positions.shape + (kv_positions.shape[-1],)
    mask = torch.ones(shape, dtype=torch.bool, device=q_positions.device)
    if causal:
        mask = q_positions[..., :, None] >= kv_positions[..., None, :]
    if q_segments is not None and kv_segments is not None:
        same = q_segments[..., :, None] == kv_segments[..., None, :]
        valid = kv_segments[..., None, :] != 0
        mask = mask & same & valid
    return mask


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q [B, Sq, Nq, D], k/v [B, Skv, Nkv, D] -> [B, Sq, Nq, D].

    GQA: q head ``h`` reads kv head ``h // G``. Scores are computed from
    the operands widened to fp32 (products of bf16 values are exact in
    fp32, so this is the fp32-accumulated product of the JAX einsum with
    ``preferred_element_type=float32``); softmax in fp32; the
    probabilities are cast to v's dtype for the value product."""
    B, Sq, Nq, D = q.shape
    Nkv = k.shape[2]
    groups = Nq // Nkv
    qg = q.reshape(B, Sq, Nkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Nq, D).to(q.dtype)


def attention_block(
    x: torch.Tensor,
    layer,
    cfg,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    inv_freq: torch.Tensor,
    kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    cache_offset: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
) -> tuple[torch.Tensor, Optional[tuple[torch.Tensor, torch.Tensor]]]:
    """Self-attention sublayer (pre-norm residual outside).

    ``attn_impl``: "xla" is the plain masked attention below; "flash" is
    ``ops.attention.flash_attention`` (the kernels on a card, their plain
    version on the CPU), called without positions exactly as the JAX
    package calls it (packed rows are kept apart by the segment ids).

    With ``kv_cache=(k_cache, v_cache)`` of shape [B, S_max, Nkv, D] and
    ``cache_offset`` [B], the new K/V are written at each row's offset —
    IN PLACE into the given cache tensors, which are also returned — and
    attention runs over the whole cache under the causal/length mask.
    Without a cache it is plain causal (segment-aware) attention."""
    B, S, _ = x.shape
    D, Nq, Nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype

    q = (x @ cast(layer.q, dt)).reshape(B, S, Nq, D)
    k = (x @ cast(layer.k, dt)).reshape(B, S, Nkv, D)
    v = (x @ cast(layer.v, dt)).reshape(B, S, Nkv, D)
    if cfg.attention_bias:
        q = q + cast(layer.q_bias, dt).reshape(Nq, D)
        k = k + cast(layer.k_bias, dt).reshape(Nkv, D)
        v = v + cast(layer.v_bias, dt).reshape(Nkv, D)

    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)

    new_cache = None
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S_max = k_cache.shape[1]
        dev = x.device
        write_idx = cache_offset[:, None] + torch.arange(S, device=dev)
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, S)
        k_cache[b_idx, write_idx] = k.to(k_cache.dtype)
        v_cache[b_idx, write_idx] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        kv_positions = torch.arange(S_max, device=dev)[None, :].expand(B, -1)
        valid = kv_positions < (cache_offset[:, None] + S)
        mask = ((positions[..., :, None] >= kv_positions[..., None, :])
                & valid[:, None, :])
        out = dot_product_attention(q, k_cache.to(dt), v_cache.to(dt), mask)
    elif attn_impl == "flash":
        from ..ops.attention import flash_attention
        out = flash_attention(q, k, v, segment_ids=segment_ids, causal=True)
    elif attn_impl != "xla":
        raise NotImplementedError(
            f"attn_impl {attn_impl!r} is not ported (xla|flash; ring and "
            f"ulysses wait for ROADMAP queue 1 item 7)")
    else:
        mask = attention_mask(positions, positions, segment_ids, segment_ids)
        out = dot_product_attention(q, k, v, mask)

    out = out.reshape(B, S, Nq * D) @ cast(layer.o, dt)
    return out.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------

def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.relu(x)


def mlp_block(x: torch.Tensor, layer, cfg, matmul=None) -> torch.Tensor:
    """Gated FFN (SwiGLU for silu). ``matmul(a, w)`` overrides the kernel
    contraction, as in the JAX package (the hook quantized decode uses)."""
    if matmul is None:
        def matmul(a, w):
            return a @ cast(w, a.dtype)
    gate = matmul(x, layer.gate)
    up = matmul(x, layer.up)
    h = _activate(gate, cfg.activation) * up
    return matmul(h, layer.down).to(x.dtype)


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens (GShard
    capacity, in Python float arithmetic as the JAX package computes it):
    pad tokens and idle slots count, so C depends on the call's shape."""
    m = cfg.moe
    return max(int(m.capacity_factor * m.experts_per_token * n_tokens
                   / m.num_experts), 1)


def moe_dispatch(probs: torch.Tensor, cfg) -> SimpleNamespace:
    """Token-choice top-K routing with capacity, sort-based, from the
    router's probabilities ``probs`` [N, E] (fp32): each token's K most
    probable experts (the lower expert id first among equal ones, as
    ``jax.lax.top_k``: a stable descending sort's first K), their weights
    renormalised to sum to 1, placed by ``moe_assign``."""
    K = cfg.moe.experts_per_token
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_w = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return moe_assign(top_e, top_w, cfg)


def moe_assign(top_e: torch.Tensor, top_w: torch.Tensor,
               cfg) -> SimpleNamespace:
    """Places the choices ``top_e`` [N, K] (weights ``top_w``) into the
    experts' capacity buffers. Returns a namespace:

    - ``top_e``, ``top_w`` [N, K]: as given;
    - ``counts`` [E]: choices routed to each expert, kept or not;
    - ``tok``, ``valid``, ``w`` [E, C]: expert e's buffer slot c holds
      token ``tok`` with weight ``w`` while ``valid`` (else it is padding,
      its weight 0);
    - ``slot`` [N, K]: where choice (n, k) sits in the flattened [E * C]
      buffers, -1 where it was dropped.

    The choices are sorted by expert with a stable sort of the flat
    token-major order, and each expert keeps its first C: of two tokens
    routed to a full expert, the lower index (an earlier token, an earlier
    slot of the batch) keeps its place, exactly as the JAX ``moe_block``
    and the one-hot GShard formulation decide."""
    N, K = top_e.shape
    E = cfg.moe.num_experts
    C = moe_capacity(cfg, N)
    dev = top_e.device
    flat_e = top_e.reshape(N * K)
    order = torch.sort(flat_e, stable=True).indices               # [NK]
    counts = torch.bincount(flat_e, minlength=E)                  # [E]
    starts = torch.cumsum(counts, 0) - counts                     # [E]
    c_idx = torch.arange(C, device=dev)
    gather_pos = (starts[:, None] + c_idx[None, :]).clamp(max=N * K - 1)
    valid = c_idx[None, :] < counts[:, None]                      # [E, C]
    choice = order[gather_pos]                                    # [E, C]
    tok = choice // K                                             # [E, C]
    w = torch.where(valid, top_w.reshape(N * K)[choice],
                    torch.zeros((), dtype=top_w.dtype, device=dev))

    # each choice's rank inside its expert: position in the sorted order
    # less the expert's start
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N * K, device=dev)
    c_of = rank - starts[flat_e]
    slot = torch.where(c_of < C, flat_e * C + c_of,
                       torch.full_like(c_of, -1)).reshape(N, K)
    return SimpleNamespace(top_e=top_e, top_w=top_w, counts=counts,
                           capacity=C, tok=tok, valid=valid, w=w, slot=slot)


def moe_block(x: torch.Tensor, layer, cfg) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Token-choice top-K mixture of experts with GShard capacity and
    sort-based dispatch (the JAX ``moe_block``). Returns (out [B, S, H] in
    x's dtype, the Switch load-balancing aux loss, fp32 scalar).

    ``layer`` holds ``moe_router`` [H, E] and the experts ``moe_gate`` /
    ``moe_up`` [E, H, F] and ``moe_down`` [E, F, H], in x's dtype. The
    router product is fp32 (TF32 must stay off on a card, PyTorch's
    default, or near-tie routing parts from the CPU's). The expert FFNs
    are one ``torch.bmm`` each over the [E, C, H] buffers, whose padding
    slots are zeroed first. The combine gathers each token's kept rows
    and adds them to zero in ascending buffer position, the order of the
    JAX scatter-add, with no atomics: the same bits every run."""
    B, S, H = x.shape
    E = cfg.moe.num_experts
    K = cfg.moe.experts_per_token
    N = B * S
    dt = x.dtype
    xt = x.reshape(N, H)
    logits = xt.float() @ layer.moe_router.float()               # [N, E]
    probs = torch.softmax(logits, dim=-1)
    d = moe_dispatch(probs, cfg)
    C = d.capacity

    xe = xt[d.tok] * d.valid[..., None].to(dt)                    # [E, C, H]
    g = torch.bmm(xe, layer.moe_gate)
    u = torch.bmm(xe, layer.moe_up)
    he = torch.bmm(_activate(g, cfg.activation) * u, layer.moe_down)
    rows = (he * d.w.to(dt)[..., None]).reshape(E * C, H)

    # each token's kept rows in ascending buffer position (its dropped
    # choices, -1, add zeros first, which changes no sum)
    slots = torch.sort(d.slot, dim=-1).values                     # [N, K]
    out = torch.zeros((N, H), dtype=dt, device=x.device)
    for k in range(K):
        s = slots[:, k]
        got = rows[s.clamp(min=0)]
        out = out + torch.where((s >= 0)[:, None], got,
                                torch.zeros((), dtype=dt, device=x.device))

    f = d.counts.float() / N
    p = probs.mean(dim=0)
    aux = E * (f * p).sum() * cfg.moe.router_aux_loss_weight
    return out.reshape(B, S, H), aux
