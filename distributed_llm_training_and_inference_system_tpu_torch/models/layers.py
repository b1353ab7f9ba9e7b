"""Transformer building blocks on PyTorch tensors.

Counterpart of the JAX package's ``models/layers.py``, function for
function: RMSNorm applied as ``(1 + scale)``, RoPE that rotates split halves
(not interleaved pairs), GQA attention with kv-head-major grouping
(``q.reshape(B, S, Nkv, G, D)``) and fp32 softmax, and the gated FFN.
Weights keep the JAX ``[in, out]`` layout, so every projection is
``x @ w``. ``layer`` arguments are ``models.gpt.Block`` modules.
"""

from __future__ import annotations

import math
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
