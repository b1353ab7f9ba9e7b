"""Paged forward over the KV cache: decode steps and cached-suffix prefill.

Counterpart of the JAX package's ``serve/decode.py``. One layer body
(``extend_step_forward``) serves T new tokens per slot; the T = 1 case is
the decode step. Each layer writes the new tokens' K/V into the pages
first (in place), then attends through ``ops.paged_attention_multi``:
on a card that is the hand-written kernel, on the CPU its plain version.
``decode_scan`` is a Python loop of decode+sample steps whose tokens and
positions stay on the device, so a dispatch of K steps needs one host fetch
at its end.

Block kernels may be quantized (``ops.quantization``): every projection
goes through ``mm``, which sends a W4 weight, and a W8 weight when the
engine opts in, to the in-kernel-dequant matmuls (``ops.int4_matmul``,
``ops.int8_matmul``) where the shapes allow it, and otherwise dequantizes
the weight and takes the plain product. That choice is made from shapes
and the tensor's device before any launch; a kernel that fails raises.
An MoE block's router and experts are dequantized to the compute dtype for
the layer and contracted by ``models.layers.moe_block``, never by the
W4/W8 kernels (the JAX decode's rule); its attention projections keep
their kernels. Routing makes each row's output depend on the whole call,
so the engine gives every forward the JAX engine's shape and pad rows.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from ..models.gpt import compute_dtype, embed_tokens, tp_blocks, unembed
from ..models.layers import apply_rope, cast, mlp_block, moe_block, \
    rms_norm, rope_frequencies
from ..ops.int4_matmul import matmul_w4
from ..ops.int8_matmul import matmul_w8
from ..ops.paged_attention import (paged_attention_multi,
                                   write_token_to_pages,
                                   write_window_to_pages)
from ..ops.quantization import QuantTensor, Quant4Tensor
from .sampling import gumbel_noise, sample_tokens


KERNEL_MAX_ROWS = 64      # decode and verify windows; longer goes dequant
_MOE_NAMES = ("moe_router", "moe_gate", "moe_up", "moe_down")


def mm(a: torch.Tensor, w, dtype: torch.dtype, w4_kernel_ok: bool = True,
       w8_kernel_ok: bool = False) -> torch.Tensor:
    """``a @ w`` for a plain or quantized ``w`` [in, out], as the JAX
    package's decode routes it. A quantized weight goes to its kernel when
    the activations lie on a card, ``rows <= 64`` and ``out % 128 == 0``
    (W4 also ``in % group == 0``; W8 only with ``w8_kernel_ok``, the
    engine's ``int8_pallas_matmul``); every other case (suffix prefill,
    odd shapes, a CPU tensor) dequantizes to ``dtype`` and multiplies."""
    rows = math.prod(a.shape[:-1])
    if isinstance(w, QuantTensor):
        if (w8_kernel_ok and a.is_cuda and rows <= KERNEL_MAX_ROWS
                and w.shape[-1] % 128 == 0):
            y = matmul_w8(a.reshape(rows, a.shape[-1]), w.values, w.scale)
            return y.reshape(*a.shape[:-1], y.shape[-1])
        w = w.dequant(dtype)
    elif isinstance(w, Quant4Tensor):
        n_in, n_out = w.shape[-2], w.shape[-1]
        if (w4_kernel_ok and a.is_cuda and rows <= KERNEL_MAX_ROWS
                and n_out % 128 == 0 and n_in % w.group == 0):
            y = matmul_w4(a.reshape(rows, a.shape[-1]), w.packed, w.scale,
                          w.chan, group=w.group)
            return y.reshape(*a.shape[:-1], y.shape[-1])
        w = w.dequant(dtype)
    return a @ cast(w, dtype)


def _moe_leaves(blk, dtype: torch.dtype) -> SimpleNamespace:
    """A block's router and experts in the compute dtype, quantized ones
    dequantized (this layer only), as the JAX decode casts the whole MoE
    subtree: ``moe_block`` contracts them itself, so they never reach the
    W4/W8 kernels."""
    def full(w):
        return (w.dequant(dtype) if isinstance(w, (QuantTensor, Quant4Tensor))
                else cast(w, dtype))
    return SimpleNamespace(**{n: full(getattr(blk, n)) for n in _MOE_NAMES})


@torch.inference_mode()
def extend_step_forward(
    model,
    tokens: torch.Tensor,           # [B, T] — T new tokens per slot
    start_positions: torch.Tensor,  # [B] — position of tokens[:, 0]
    k_pages,                        # [L, NP, Nkv, PS, D] — updated in place
    v_pages,                        # (tensors, QuantPages or Int4Pages)
    block_tables: torch.Tensor,     # [B, maxP]
    cfg,
    write_ok=None,                  # [B, T] bool — False rows write nowhere
    w4_kernel_ok: bool = True,
    w8_kernel_ok: bool = False,     # opt-in: ServeConfig.int8_pallas_matmul
    attn_impl: str = "auto",        # ops.paged_attention: auto|cuda|gather
    logits: bool = True,            # False: skip the head, logits is None
):
    """Returns (logits [B, T, V] fp32, k_pages, v_pages).

    Token j sits at position ``start + j`` and attends causally over the
    paged prefix, including the earlier tokens of this call: all T tokens'
    K/V are written first, then attention runs with per-query length
    ``start + j + 1``. A window of T <= page_size tokens takes the window
    write; a longer one (a suffix prefill) scatters B*T rows, whose masked
    rows land in scratch page 0. With ``logits=False`` (an intermediate
    chunk of a chunked prefill, whose product is pages) the final norm and
    the [B, T, V] head are not computed.

    A window of more than ``KERNEL_MAX_ROWS`` rows (B * T: a suffix or
    chunk prefill, a wide verify window) sends quantized weights to the
    dequant route, as the JAX package's decode does.

    On a tensor-parallel serving rank (``weights.rank_model``) the pages
    hold this rank's kv heads: the paged kernel attends over its Nq/tp
    query heads, the W8/W4 kernels multiply by its column and row shards,
    and the partial sums after o and down are all-reduced
    (``models.gpt.TPSums``)."""
    dt = compute_dtype(cfg)
    B, T = tokens.shape
    block_cfg, sums = tp_blocks(model, cfg)
    D, Nq, Nkv = (block_cfg.head_dim, block_cfg.num_heads,
                  block_cfg.num_kv_heads)
    dev = tokens.device

    start = start_positions.long()
    positions = start[:, None] + torch.arange(T, device=dev)     # [B, T]
    # int32 once for every layer (the kernel's table/start types)
    tables = block_tables.to(torch.int32).contiguous()
    starts = start.to(torch.int32)
    use_window_write = T <= k_pages.shape[-2]

    def proj(a, w):
        return mm(a, w, dt, w4_kernel_ok, w8_kernel_ok)
    if not use_window_write:
        flat_pos = positions.reshape(B * T)
        flat_tables = tables.repeat_interleave(T, dim=0)
        flat_ok = None if write_ok is None else write_ok.reshape(B * T)

    x = embed_tokens(model, tokens, dt)                           # [B, T, H]
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope.base,
                                cfg.rope.scaling, cfg.rope.scaling_factor,
                                device=dev)
    for i, blk in enumerate(model.blocks):
        kp, vp = k_pages[i], v_pages[i]
        h = rms_norm(x, cast(blk.attn_norm, dt), cfg.norm_eps)
        q = proj(h, blk.q).reshape(B, T, Nq, D)
        k = proj(h, blk.k).reshape(B, T, Nkv, D)
        v = proj(h, blk.v).reshape(B, T, Nkv, D)
        if cfg.attention_bias:
            q = q + cast(blk.q_bias, dt).reshape(Nq, D)
            k = k + cast(blk.k_bias, dt).reshape(Nkv, D)
            v = v + cast(blk.v_bias, dt).reshape(Nkv, D)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)

        if use_window_write:
            write_window_to_pages(kp, k, tables, starts, write_ok)
            write_window_to_pages(vp, v, tables, starts, write_ok)
        else:
            write_token_to_pages(kp, k.reshape(B * T, Nkv, D), flat_tables,
                                 flat_pos, flat_ok)
            write_token_to_pages(vp, v.reshape(B * T, Nkv, D), flat_tables,
                                 flat_pos, flat_ok)
        attn = paged_attention_multi(q, kp, vp, tables, starts,
                                     impl=attn_impl)
        attn = proj(attn.reshape(B, T, Nq * D), blk.o)
        x = x + (attn if sums is None else sums.attn(attn)).to(x.dtype)
        h = rms_norm(x, cast(blk.mlp_norm, dt), cfg.norm_eps)
        if cfg.is_moe:
            ffn, _ = moe_block(h, _moe_leaves(blk, dt), cfg)
        else:
            ffn = mlp_block(h, blk, block_cfg, matmul=proj)
            if sums is not None:
                ffn = sums.ffn(ffn)
        x = x + ffn.to(x.dtype)

    if not logits:
        return None, k_pages, v_pages
    return unembed(model, x, cfg), k_pages, v_pages


def decode_step_forward(model, tokens, positions, k_pages, v_pages,
                        block_tables, cfg, active=None, w4_kernel_ok=True,
                        w8_kernel_ok=False, attn_impl="auto"):
    """One token per slot (tokens, positions [B]); inactive rows write
    nowhere. Returns (logits [B, V], k_pages, v_pages): the T = 1 case of
    ``extend_step_forward``."""
    write_ok = None if active is None else active[:, None]
    logits, k_pages, v_pages = extend_step_forward(
        model, tokens[:, None], positions, k_pages, v_pages, block_tables,
        cfg, write_ok=write_ok, w4_kernel_ok=w4_kernel_ok,
        w8_kernel_ok=w8_kernel_ok, attn_impl=attn_impl)
    return logits[:, 0], k_pages, v_pages


@torch.inference_mode()
def decode_scan(model, tokens, positions, k_pages, v_pages, block_tables,
                stop_positions, seeds, temperature, top_k, top_p, cfg,
                num_steps: int, w4_kernel_ok: bool = True,
                w8_kernel_ok: bool = False):
    """``num_steps`` decode+sample iterations, with tokens and positions
    kept on the device between steps. Rows at or past ``stop_positions``
    write nowhere and re-emit their previous token. The Gumbel noise of a
    step is keyed on (seed, position of the sampled token), so splitting
    or chaining dispatches never changes a request's stream.

    ``seeds`` [B] is a device tensor; ``temperature``/``top_k``/``top_p``
    are host arrays. Returns ((tokens, positions), tokens_seq [K, B],
    nonfinite): ``nonfinite`` is a device count of the steps whose logits
    held a NaN or inf (read it when the tokens are fetched)."""
    toks, pos = tokens.long(), positions.long()
    vocab = cfg.vocab_size
    out = []
    nonfinite = torch.zeros((), dtype=torch.int64, device=toks.device)
    for _ in range(num_steps):
        act = pos < stop_positions
        logits, _, _ = decode_step_forward(
            model, toks, pos, k_pages, v_pages, block_tables, cfg,
            active=act, w4_kernel_ok=w4_kernel_ok,
            w8_kernel_ok=w8_kernel_ok)
        nonfinite = nonfinite + (~torch.isfinite(logits).all()).long()
        nxt = sample_tokens(
            logits, temperature, top_k, top_p,
            noise=lambda p=pos: gumbel_noise(seeds, p + 1, vocab))
        nxt = torch.where(act, nxt, toks)
        out.append(nxt)
        toks, pos = nxt, pos + 1
    return (toks, pos), torch.stack(out), nonfinite


def decode_multi_step(model, tokens, positions, k_pages, v_pages,
                      block_tables, stop_positions, seeds, temperature,
                      top_k, top_p, cfg, num_steps: int):
    """``decode_scan`` returning ([K, B] sampled tokens, k_pages,
    v_pages)."""
    _, toks_seq, _ = decode_scan(model, tokens, positions, k_pages, v_pages,
                                 block_tables, stop_positions, seeds,
                                 temperature, top_k, top_p, cfg, num_steps)
    return toks_seq, k_pages, v_pages
