"""Loss functions for causal LM training and eval (the JAX package's
``models/loss.py``): shifted next-token cross-entropy in fp32 with padding
masks and optional z-loss, and a chunked form that never holds the whole
[B, S, V] fp32 logits."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gpt import matmul_f32


def cross_entropy(
    logits: torch.Tensor,                    # [B, S, V] fp32
    targets: torch.Tensor,                   # [B, S] int
    weights: Optional[torch.Tensor] = None,  # [B, S] 0/1 mask
    z_loss_weight: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy. Returns (loss, token_count)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1,
                                targets.long()[..., None]).squeeze(-1)
    nll = logz - target_logit
    if z_loss_weight > 0.0:
        nll = nll + z_loss_weight * logz.square()
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    total = (nll * weights).sum()
    count = torch.clamp(weights.sum(), min=1.0)
    return total / count, count


def _shift_weights(segment_ids: Optional[torch.Tensor]):
    """1 where the target continues its segment and is not padding."""
    if segment_ids is None:
        return None
    same = segment_ids[:, 1:] == segment_ids[:, :-1]
    not_pad = segment_ids[:, 1:] != 0
    return (same & not_pad).float()


def next_token_loss(
    logits: torch.Tensor,                    # [B, S, V]
    tokens: torch.Tensor,                    # [B, S] the input tokens
    segment_ids: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted LM loss: predict tokens[:, 1:] from logits[:, :-1]; with
    packed rows, targets that start a new segment (or are padding) are
    masked out."""
    weights = _shift_weights(segment_ids)
    return cross_entropy(logits[:, :-1], tokens[:, 1:], weights,
                         z_loss_weight)


def _chunk_nll(h, t, w, unembed_w, tied, z_loss_weight):
    # the cast inside the chunk, as JAX's: each chunk's head gradient
    # returns to the fp32 master and is summed across chunks in fp32
    head = unembed_w.to(h.dtype)
    logits = matmul_f32(h, head.t() if tied else head)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t[..., None]).squeeze(-1)
    nll = logz - tgt
    if z_loss_weight > 0.0:
        nll = nll + z_loss_weight * logz.square()
    return (nll * w).sum(), w.sum()


def chunked_target_loss(
    hidden: torch.Tensor,            # [B, T, H] final-normed hidden
    unembed_w: torch.Tensor,         # [V, H] (tied embedding) or [H, V]
    targets: torch.Tensor,           # [B, T] the token each position predicts
    weights: torch.Tensor,           # [B, T] 0/1 (fp32)
    z_loss_weight: float = 0.0,
    chunk: int = 512,
    tied: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the weighted token cross-entropies, sum of the weights),
    chunk by chunk: each chunk's head product (fp32 accumulator) and
    cross-entropy run under ``torch.utils.checkpoint``, so the forward keeps
    no [B, chunk, V] logits and the backward recomputes each chunk's when
    it needs them, accumulating the head's gradient across chunks."""
    n = hidden.shape[1]
    chunk = max(min(chunk, n), 1)
    pad = (-n) % chunk
    targets = targets.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        weights = F.pad(weights, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, n + pad, chunk):
        s, c = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk],
                          targets[:, c0:c0 + chunk],
                          weights[:, c0:c0 + chunk], unembed_w, tied,
                          z_loss_weight, use_reentrant=False)
        total = total + s
        count = count + c
    return total, count


def chunked_next_token_loss(
    hidden: torch.Tensor,            # [B, S, H] final-normed hidden
    unembed_w: torch.Tensor,         # [V, H] (tied embedding) or [H, V]
    tokens: torch.Tensor,            # [B, S] the input tokens
    segment_ids: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    chunk: int = 512,
    tied: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted LM loss without materialising [B, S, V] logits
    (``chunked_target_loss`` over positions 0..S-2 predicting tokens
    1..S-1). Same masking as ``next_token_loss``; the sums are taken
    chunk by chunk (another order)."""
    B, S, H = hidden.shape
    weights = _shift_weights(segment_ids)
    if weights is None:
        weights = torch.ones((B, S - 1), dtype=torch.float32,
                             device=hidden.device)
    total, count = chunked_target_loss(
        hidden[:, :-1], unembed_w, tokens[:, 1:], weights, z_loss_weight,
        chunk, tied)
    count = torch.clamp(count, min=1.0)
    return total / count, count


def shifted_targets(tokens: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(targets, weights) [B, S] of whole rows: position t predicts token
    t + 1 under ``_shift_weights``'s mask; the last position predicts
    nothing (weight 0). A sequence-parallel rank slices its chunk."""
    B, S = tokens.shape
    weights = _shift_weights(segment_ids)
    if weights is None:
        weights = torch.ones((B, S - 1), dtype=torch.float32,
                             device=tokens.device)
    return (F.pad(tokens[:, 1:].long(), (0, 1)), F.pad(weights, (0, 1)))


def perplexity(loss: torch.Tensor) -> torch.Tensor:
    return torch.exp(loss)
