"""Speculative decoding: host n-gram drafts, device verification.

Counterpart of the JAX package's ``serve/speculative.py``. The draft
source is prompt lookup: the most recent earlier occurrence of the
context's trailing n-gram proposes the tokens that followed it. No draft
model and no extra weights; it pays on traffic whose output repeats spans
of its prompt (summaries, code edits, retrieval).

Correctness does not depend on the drafts: draft j is accepted iff it
equals the argmax of the verify logits at its position, so every greedy
stream is a chain of argmaxes of logits conditioned on the accepted
prefix. In fp32 on the CPU the verify window and the decode step give the
same bits, and greedy output is bit-identical with speculation on and off.
In bf16 on a card the [B, T] verify projections round differently from the
[B, 1] decode ones, so an argmax may flip at a near-tie; the chain stays
self-consistent either way. A sampled (temperature > 0) row takes one
token a dispatch from the verify window's first position, keyed as the
decode step keys it, so its stream is that of plain decode. Rejected drafts
leave K/V past the accepted position: reads are length-masked and the slot
overwrites them as it advances.

The verify window has B * T rows: at the defaults (8 slots, T = 8) 64, so
quantized weights go to the W8/W4 kernels; a wider window goes to the
dequant route (``decode.KERNEL_MAX_ROWS``). Pages are updated in place; the
functions return device tensors and never synchronise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .decode import decode_scan, extend_step_forward
from .sampling import gumbel_noise, sample_tokens
from ..device import to_device

# SpecState tuning constants (the JAX package's): the EWMA weights recent
# dispatches, the warmup keeps one lucky or unlucky first window from
# moving the window, and the grow/shrink thresholds bracket the ~50%
# acceptance at which a verify window pays for itself.
SPEC_EWMA_ALPHA = 0.25
SPEC_WARMUP_DISPATCHES = 4
SPEC_GROW_AT = 0.5
SPEC_SHRINK_AT = 0.15
SPEC_MIN_WINDOW = 2


@dataclass
class SpecState:
    """Per-sequence speculative state, carried through preemption (and,
    later, migration) as a plain-scalar dict.

    - ``window``: the adaptive verify window (its first position is the
      root token, so ``window - 1`` drafts are proposed a dispatch), in
      [SPEC_MIN_WINDOW, ServeConfig.speculative_tokens];
    - ``ewma``: recent draft acceptance, which moves the window;
    - ``warmup``: dispatches observed (the window holds until a few);
    - ``drafts`` / ``accepted``: the sequence's lifetime totals."""
    window: int
    ewma: float = 0.0
    warmup: int = 0
    drafts: int = 0
    accepted: int = 0

    def observe(self, accepted: int, drafted: int, max_window: int) -> None:
        """Fold one dispatch's acceptance into the EWMA and adapt the
        window (the same observations give the same window anywhere)."""
        drafted = max(int(drafted), 1)
        accepted = min(max(int(accepted), 0), drafted)
        self.drafts += drafted
        self.accepted += accepted
        rate = accepted / drafted
        if self.warmup == 0:
            self.ewma = rate
        else:
            self.ewma = ((1.0 - SPEC_EWMA_ALPHA) * self.ewma
                         + SPEC_EWMA_ALPHA * rate)
        self.warmup += 1
        if self.warmup >= SPEC_WARMUP_DISPATCHES:
            if self.ewma >= SPEC_GROW_AT:
                self.window = min(self.window + 1, max_window)
            elif self.ewma <= SPEC_SHRINK_AT:
                self.window = max(self.window - 1, SPEC_MIN_WINDOW)

    def to_dict(self) -> dict:
        return {"window": int(self.window), "ewma": float(self.ewma),
                "warmup": int(self.warmup), "drafts": int(self.drafts),
                "accepted": int(self.accepted)}

    @classmethod
    def from_dict(cls, d: dict, max_window: int) -> "SpecState":
        """Rebuild from a carried dict; malformed values clamp into range
        (the window bounds the draft writes)."""
        try:
            window = int(d.get("window", max_window))
        except (TypeError, ValueError):
            window = max_window
        window = max(SPEC_MIN_WINDOW, min(window, max_window))
        try:
            ewma = float(d.get("ewma", 0.0))
        except (TypeError, ValueError):
            ewma = 0.0

        def _i(key):
            try:
                return max(int(d.get(key, 0)), 0)
            except (TypeError, ValueError):
                return 0
        return cls(window=window, ewma=min(max(ewma, 0.0), 1.0),
                   warmup=_i("warmup"), drafts=_i("drafts"),
                   accepted=_i("accepted"))


def propose_ngram_draft(context: np.ndarray, num_draft: int,
                        max_ngram: int = 3) -> Optional[np.ndarray]:
    """Prompt lookup: the ``num_draft`` tokens that followed the most
    recent earlier occurrence of the context's trailing n-gram (longest n
    first), padded by repeating the last; None when nothing matches."""
    context = np.asarray(context)
    L = len(context)
    if L < 2 or num_draft < 1:
        return None
    for n in range(min(max_ngram, L - 1), 0, -1):
        tail = context[L - n:]
        # windows[i] == context[i : i+n]; the latest i < L - n
        windows = np.lib.stride_tricks.sliding_window_view(context, n)
        hits = np.flatnonzero((windows[: L - n] == tail).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n          # first token after the match
        draft = context[start:start + num_draft]
        if draft.size == 0:
            continue
        if draft.size < num_draft:
            draft = np.concatenate(
                [draft, np.full(num_draft - draft.size, draft[-1],
                                draft.dtype)])
        return draft.astype(np.int32)
    return None


@torch.inference_mode()
def speculative_verify(model, tokens, positions, k_pages, v_pages,
                       block_tables, stop_positions, seeds, temperature,
                       top_k, top_p, cfg, w4_kernel_ok: bool = True,
                       w8_kernel_ok: bool = False, attn_impl: str = "auto"):
    """One verification pass over ``tokens`` [B, T] = [last token, draft_1
    .. draft_{T-1}] at ``positions`` [B] (device tensors; ``seeds`` [B] on
    the device, the sampling knobs host arrays). Returns (emitted [B, T],
    n_emit [B], nonfinite):

    - a greedy row emits its argmax chain, n_emit = accepted drafts + 1
      (the token after the last accepted one);
    - a sampled row emits one token sampled from the first position's
      logits with the decode step's key, n_emit = 1.

    The host must advance a slot by the tokens it records, so its length
    matches the K/V the device wrote."""
    B, T = tokens.shape
    dev = tokens.device
    positions = positions.long()
    write_ok = ((positions[:, None] + torch.arange(T, device=dev))
                < stop_positions.long()[:, None])
    logits, _, _ = extend_step_forward(
        model, tokens, positions, k_pages, v_pages, block_tables, cfg,
        write_ok=write_ok, w4_kernel_ok=w4_kernel_ok,
        w8_kernel_ok=w8_kernel_ok, attn_impl=attn_impl)
    nonfinite = (~torch.isfinite(logits).all()).long()
    greedy = logits.argmax(dim=-1)                               # [B, T]
    is_greedy = to_device(np.asarray(temperature) <= 0.0, dev)
    match = (tokens[:, 1:] == greedy[:, :-1]) & is_greedy[:, None]
    n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)        # [B]
    sampled0 = sample_tokens(
        logits[:, 0], temperature, top_k, top_p,
        noise=lambda: gumbel_noise(seeds, positions + 1, cfg.vocab_size))
    emitted = torch.where(is_greedy[:, None], greedy,
                          sampled0[:, None].expand(B, T))
    n_emit = torch.where(is_greedy, n_acc + 1, torch.ones_like(n_acc))
    return emitted, n_emit, nonfinite


@torch.inference_mode()
def verify_and_decode(model, tokens, positions, k_pages, v_pages,
                      block_tables, stop_positions, seeds, temperature,
                      top_k, top_p, cfg, num_decode_steps: int,
                      w4_kernel_ok: bool = True, w8_kernel_ok: bool = False,
                      attn_impl: str = "auto"):
    """The fused dispatch: one verify window, then ``num_decode_steps``
    plain decode steps chained on the device from each row's last emitted
    token, so a dispatch yields n_emit + R tokens for 1 + R forward passes
    and one host fetch. Returns (emitted [B, T], n_emit [B], decode_seq
    [R, B], nonfinite); the host applies emitted[:n_emit], then the rows of
    decode_seq."""
    emitted, n_emit, nonfinite = speculative_verify(
        model, tokens, positions, k_pages, v_pages, block_tables,
        stop_positions, seeds, temperature, top_k, top_p, cfg,
        w4_kernel_ok=w4_kernel_ok, w8_kernel_ok=w8_kernel_ok,
        attn_impl=attn_impl)
    if num_decode_steps < 1:
        return (emitted, n_emit,
                torch.zeros((0, tokens.shape[0]), dtype=torch.int64,
                            device=tokens.device), nonfinite)
    last = emitted.gather(1, (n_emit - 1)[:, None])[:, 0]
    _, decode_seq, nf = decode_scan(
        model, last, positions.long() + n_emit, k_pages, v_pages,
        block_tables, stop_positions, seeds, temperature, top_k, top_p, cfg,
        num_decode_steps, w4_kernel_ok=w4_kernel_ok,
        w8_kernel_ok=w8_kernel_ok)
    return emitted, n_emit, decode_seq, nonfinite + nf
