"""Decoder-only GPT/Llama model as ``nn.Module``s.

Counterpart of the JAX package's ``models/gpt.py``. The JAX model is one
pytree whose layer leaves are stacked on a leading ``[L, ...]`` axis; here
each layer is a ``Block`` module in ``GPT.blocks`` (``weights.params_from_
jax`` unstacks the JAX tree). Parameter conventions are the JAX ones:
projection weights are ``[in, out]`` (``x @ w``) and a norm scale ``s`` is
applied as ``1 + s``.

Parameters are trainable fp32 masters (or bf16 for a serving model).
``forward`` casts every block leaf to the compute dtype once, outside the
layer loop (``precast_params``), so autograd returns fp32 gradients to the
masters; ``remat`` wraps each block in ``torch.utils.checkpoint``. Serving
calls ``forward`` under ``torch.inference_mode()``.

An MoE config's blocks hold a router and stacked experts in place of the
dense FFN (``moe_block``); ``forward(return_aux=True)`` also returns the
load-balancing aux loss summed over the layers, which training adds to the
loss.

A serving model's block kernels may be quantized: ``with_block_leaves``
builds a model whose blocks hold ``ops.quantization`` ``QuantTensor`` /
``Quant4Tensor`` leaves in place of parameters. ``forward`` dequantizes
those one layer at a time, so only one layer's full-precision weights
exist at once.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..ops.quantization import QuantTensor, Quant4Tensor
from .layers import attention_block, cast, mlp_block, moe_block, \
    rms_norm, rope_frequencies

_QUANT = (QuantTensor, Quant4Tensor)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))


class Block(nn.Module):
    """One pre-norm transformer block's parameters (a dense FFN, or for an
    MoE config the router [H, E] and the stacked experts); the block itself
    is ``_block_fn`` over these or their precast copies."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Nq, Nkv, Fs = cfg.num_heads, cfg.num_kv_heads, cfg.ffn_size
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _param(H, **kw)
        self.q = _param(H, Nq * D, **kw)
        self.k = _param(H, Nkv * D, **kw)
        self.v = _param(H, Nkv * D, **kw)
        self.o = _param(Nq * D, H, **kw)
        if cfg.attention_bias:
            self.q_bias = _param(Nq * D, **kw)
            self.k_bias = _param(Nkv * D, **kw)
            self.v_bias = _param(Nkv * D, **kw)
        self.mlp_norm = _param(H, **kw)
        if cfg.is_moe:
            E = cfg.moe.num_experts
            self.moe_router = _param(H, E, **kw)
            self.moe_gate = _param(E, H, Fs, **kw)
            self.moe_up = _param(E, H, Fs, **kw)
            self.moe_down = _param(E, Fs, H, **kw)
        else:
            self.gate = _param(H, Fs, **kw)
            self.up = _param(H, Fs, **kw)
            self.down = _param(Fs, H, **kw)

    # the JAX tree's blocks/mlp/{gate,up,down} and blocks/moe/{router,gate,
    # up,down}: a block holds one FFN or the other
    LEAF_NAMES = ("attn_norm", "q", "k", "v", "o", "q_bias", "k_bias",
                  "v_bias", "mlp_norm", "gate", "up", "down", "moe_router",
                  "moe_gate", "moe_up", "moe_down")

    def leaves(self) -> dict:
        """name -> leaf: a parameter, or a quantized weight."""
        return {n: getattr(self, n) for n in self.LEAF_NAMES
                if hasattr(self, n)}

    @classmethod
    def from_leaves(cls, leaves: dict) -> "Block":
        """A block over existing leaves, allocating nothing: parameters
        are shared with their owner, quantized weights are plain
        attributes."""
        blk = cls.__new__(cls)
        nn.Module.__init__(blk)
        for name, leaf in leaves.items():
            setattr(blk, name, leaf)
        return blk


def _block_fn(layer, x, cfg, positions, segment_ids, inv_freq,
              kv_cache=None, cache_offset=None, attn_impl="xla",
              norm_impl="xla"):
    """One pre-norm block over ``layer`` (a ``Block`` or its precast
    leaves). Returns (x, updated kv_cache or None, the MoE aux loss or
    None for a dense block)."""
    h = rms_norm(x, cast(layer.attn_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    attn_out, new_cache = attention_block(
        h, layer, cfg, positions, segment_ids, inv_freq,
        kv_cache=kv_cache, cache_offset=cache_offset, attn_impl=attn_impl)
    x = x + attn_out
    h = rms_norm(x, cast(layer.mlp_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    if cfg.is_moe:
        ffn, aux = moe_block(h, layer, cfg)
    else:
        ffn, aux = mlp_block(h, layer, cfg), None
    return x + ffn, new_cache, aux


class GPT(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and LM head."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        kw = dict(device=device, dtype=dtype)
        self.embed = _param(V, H, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _param(H, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _param(H, V, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def with_block_leaves(self, blocks: list) -> "GPT":
        """A model over this one's embedding, final norm and LM head (the
        same parameters, not copies) and ``blocks``: one ``{name: leaf}``
        dict per layer, whose kernels may be quantized."""
        model = GPT.__new__(GPT)
        nn.Module.__init__(model)
        model.cfg = self.cfg
        model.embed = self.embed
        model.blocks = nn.ModuleList(Block.from_leaves(b) for b in blocks)
        model.final_norm = self.final_norm
        model.lm_head = self.lm_head
        return model

    def weight_bytes(self) -> int:
        """Device bytes of the weights (a quantized leaf counts its stored
        values and scales)."""
        tensors = list(self.parameters())
        for blk in self.blocks:
            for leaf in blk.leaves().values():
                if isinstance(leaf, _QUANT):
                    tensors += leaf.tensors()
        return sum(t.numel() * t.element_size() for t in tensors)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

@torch.no_grad()
def init(cfg, generator: Optional[torch.Generator] = None, device=None,
         dtype=torch.float32) -> GPT:
    """A randomly initialised model with the JAX ``init`` distributions:
    truncated normal (+-3 sigma) with std 0.02, output projections scaled
    to 0.02 / sqrt(2L), norm scales 0 (applied as 1 + 0). Draws are made
    in fp32 on ``device`` and cast to ``dtype``. The numbers differ from
    JAX's for the same seed (another generator); tests that compare the
    two packages bridge the JAX params with ``weights.params_from_jax``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    std = 0.02
    resid_std = std / math.sqrt(2.0 * cfg.num_layers)

    def fill(p: nn.Parameter, scale: float = std) -> None:
        t = torch.empty(p.shape, dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
        p.copy_(t.mul_(scale))

    model = GPT(cfg, device=dev, dtype=dtype)
    for blk in model.blocks:
        fill(blk.q)
        fill(blk.k)
        fill(blk.v)
        fill(blk.o, resid_std)
        if cfg.is_moe:
            fill(blk.moe_router)
            fill(blk.moe_gate)
            fill(blk.moe_up)
            fill(blk.moe_down, resid_std)
        else:
            fill(blk.gate)
            fill(blk.up)
            fill(blk.down, resid_std)
    fill(model.embed)
    if model.lm_head is not None:
        fill(model.lm_head)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with an fp32 result accumulated in fp32 from
    operands of one dtype. On a card, bf16 operands go to the tensor cores
    with an fp32 output (``torch.mm(out_dtype=float32)``); on the CPU the
    operands are widened first (products of bf16 values are exact in fp32,
    so this is the same sum up to its order)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` -> fp32, as the JAX einsum with
    ``preferred_element_type=float32``. The backward products take the
    fp32 cotangent rounded to the operands' dtype, with fp32
    accumulation, and return gradients in the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g.to(w.dtype), w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), g.to(x.dtype)).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, N] -> [..., N] fp32 with an fp32 accumulator
    (differentiable)."""
    lead = x.shape[:-1]
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def head_weight(model: GPT, dtype: torch.dtype) -> torch.Tensor:
    """The LM head as [H, V] in ``dtype`` (the embedding transposed when
    tied)."""
    if model.cfg.tie_word_embeddings:
        return cast(model.embed, dtype).t()
    return cast(model.lm_head, dtype)


def unembed(model: GPT, x: torch.Tensor, cfg,
            norm_impl: str = "xla") -> torch.Tensor:
    """Final RMSNorm + LM head (tied or untied); fp32 logits from the fp32
    accumulator of the head product, as the JAX ``unembed``."""
    x = rms_norm(x, cast(model.final_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    return matmul_f32(x, head_weight(model, x.dtype))


def _dequantized(layer: SimpleNamespace, dtype) -> SimpleNamespace:
    """``layer`` with its quantized leaves dequantized to ``dtype`` (the
    same object when it has none)."""
    if not any(isinstance(v, _QUANT) for v in vars(layer).values()):
        return layer
    return SimpleNamespace(**{
        n: v.dequant(dtype) if isinstance(v, _QUANT) else v
        for n, v in vars(layer).items()})


def precast_params(model: GPT, dtype: torch.dtype) -> list[SimpleNamespace]:
    """Every block's plain leaves in ``dtype``, cast once (a no-op for
    leaves already in it); quantized leaves stay quantized. Casting inside
    the layer loop would read the fp32 masters again at every recompute."""
    return [SimpleNamespace(**{
        n: leaf if isinstance(leaf, _QUANT) else cast(leaf, dtype)
        for n, leaf in blk.leaves().items()}) for blk in model.blocks]


# matmul outputs: what "selective" keeps resident (the JAX policy
# dots_with_no_batch_dims_saveable); everything else is recomputed
_SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def _selective_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """Wrap the block per the activation-checkpoint policy: "none",
    "full" (recompute everything in backward) or "selective" (keep the
    matmul outputs, recompute the rest, the flash forward included)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "selective":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _selective_policy))
    raise NotImplementedError(
        f"remat {policy!r} is not ported yet (none|selective|full; "
        f"selective_attn waits in ROADMAP queue 1 item 4)")


def forward(
    model: GPT,
    tokens: torch.Tensor,
    cfg=None,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    cache_offset: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    norm_impl: str = "xla",
    remat: str = "none",
    return_aux: bool = False,
    unembed_positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """Logits [B, S, V] (fp32), or with ``return_hidden`` the final-normed
    hidden states [B, S, H] in the compute dtype (for the chunked loss).

    - ``segment_ids`` [B, S] packs several documents per row (0 = pad).
    - ``attn_impl`` "xla" (plain masked attention) or "flash"
      (``ops.attention.flash_attention``: the kernels on a card).
    - ``norm_impl`` "xla" (plain RMSNorm) or "cuda" (``ops.rmsnorm``: the
      kernel on a card; forward only, so not for training).
    - ``remat`` "none" | "selective" | "full" (training only).
    - ``kv_cache`` ([L, B, Smax, Nkv, D], [L, B, Smax, Nkv, D]) with
      ``cache_offset`` [B] runs incremental attention; the cache is
      updated in place and returned as ``(logits, kv_cache)``.
    - ``unembed_positions`` [B] keeps one position per row for the LM
      head, returning [B, 1, V].
    - ``return_aux`` appends the MoE aux loss summed over the layers (an
      fp32 scalar; 0 for a dense model), as the JAX forward does:
      ``(out, [kv_cache,] aux)``."""
    cfg = cfg or model.cfg
    dt = compute_dtype(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
        positions = positions.expand(B, S)
        if cache_offset is not None:
            positions = positions + cache_offset[:, None]

    x = cast(model.embed[tokens], dt)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope.base,
                                cfg.rope.scaling, cfg.rope.scaling_factor,
                                device=dev)
    layers = precast_params(model, dt)
    new_cache = None
    aux_total = None                     # summed over MoE layers only
    if kv_cache is None:
        block = _remat_wrap(_block_fn, remat)
        for layer in layers:
            layer = _dequantized(layer, dt)      # this layer only
            x, _, aux = block(layer, x, cfg, positions, segment_ids,
                              inv_freq, None, None, attn_impl, norm_impl)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    else:
        k_cache, v_cache = kv_cache
        for i, layer in enumerate(layers):
            layer = _dequantized(layer, dt)      # this layer only
            x, _, aux = _block_fn(layer, x, cfg, positions, segment_ids,
                                  inv_freq, (k_cache[i], v_cache[i]),
                                  cache_offset, norm_impl=norm_impl)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        new_cache = (k_cache, v_cache)

    if unembed_positions is not None:
        idx = unembed_positions.long()[:, None, None].expand(-1, 1,
                                                             x.shape[-1])
        x = torch.gather(x, 1, idx)
    if return_hidden:
        out = rms_norm(x, cast(model.final_norm, x.dtype), cfg.norm_eps,
                       impl=norm_impl)
    else:
        out = unembed(model, x, cfg, norm_impl=norm_impl)
    result = [out]
    if kv_cache is not None:
        result.append(new_cache)
    if return_aux:
        result.append(aux_total if aux_total is not None else torch.zeros(
            (), dtype=torch.float32, device=dev))
    return tuple(result) if len(result) > 1 else result[0]


def entry(device=None, norm_impl: str = "xla"):
    """(fn, example_args): a gpt-1b forward of one [1, 1024] row in bf16
    with flash attention, the port's counterpart of the JAX package's
    ``__graft_entry__.entry``. Weights are random (seed 0), made on
    ``device`` (the card unless the caller asks for the CPU);
    ``norm_impl="cuda"`` sends every RMSNorm through the kernel."""
    from ..config import get_model_config
    cfg = get_model_config("gpt-1b")
    dev = resolve_device(device)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0),
                 device=dev, dtype=torch.bfloat16)

    def fn(model, tokens):
        with torch.inference_mode():
            return forward(model, tokens, cfg, attn_impl="flash",
                           norm_impl=norm_impl)

    tokens = torch.ones((1, 1024), dtype=torch.int64, device=dev)
    return fn, (model, tokens)


# ---------------------------------------------------------------------------
# Dense KV cache helper and FLOP accounting
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs per token: 6 * matmul params + the attention term."""
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    D, Nq, Nkv, F = (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.ffn_size)
    attn_proj = H * Nq * D + 2 * H * Nkv * D + Nq * D * H
    if cfg.is_moe:
        ffn = 3 * H * F * cfg.moe.experts_per_token
    else:
        ffn = 3 * H * F if cfg.activation in ("silu", "gelu") else 2 * H * F
    head = H * V
    matmul_params = L * (attn_proj + ffn) + head
    dense_flops = 6.0 * matmul_params
    attn_flops = 12.0 * L * Nq * D * seq_len
    return dense_flops + attn_flops
